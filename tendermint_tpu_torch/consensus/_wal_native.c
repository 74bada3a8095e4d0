/* The port's native WAL record scanner: the framing loop of WAL decode
 * (crc32 + uvarint-length + bounds), mirroring consensus/wal.py
 * _iter_records byte-for-byte (same accept/reject rules, same error
 * strings) so the two paths cannot drift.  The per-record Python overhead
 * (BytesIO + read_uvarint + slicing bookkeeping) dominated WAL decode
 * throughput at small record sizes; here one call scans the whole chunk
 * and returns payload spans.
 *
 * scan(buf: bytes, max_len: int) -> (spans, err)
 *   spans: list of (payload_offset, payload_len) for every valid record
 *          prefix (records BEFORE any corruption point);
 *   err:   None, or the DataCorruptionError message for the first bad
 *          record ("truncated crc", "bad length varint: ...",
 *          "length N too big", "truncated payload", "crc mismatch").
 *
 * CRC is IEEE reflected (zlib.crc32), little-endian stored — identical to
 * the writer in consensus/wal.py (struct.pack("<I", zlib.crc32(payload))).
 * It is computed by zlib itself (linked with -lz), whose crc32 is faster
 * than a byte-at-a-time table; the CRC dominates the scan of multi-KB
 * records.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>
#include <zlib.h>

static uint32_t crc32_ieee(const uint8_t *p, Py_ssize_t n) {
    return (uint32_t)crc32(0L, (const Bytef *)p, (uInt)n);
}

static PyObject *scan(PyObject *self, PyObject *args) {
    Py_buffer buf;
    unsigned long long max_len;
    if (!PyArg_ParseTuple(args, "y*K", &buf, &max_len))
        return NULL;
    const uint8_t *p = (const uint8_t *)buf.buf;
    Py_ssize_t n = buf.len;
    Py_ssize_t pos = 0;
    const char *err = NULL;
    char errbuf[64];

    PyObject *spans = PyList_New(0);
    if (spans == NULL) {
        PyBuffer_Release(&buf);
        return NULL;
    }

    while (pos < n) {
        if (n - pos < 4) {
            err = "truncated crc";
            break;
        }
        uint32_t crc = (uint32_t)p[pos] | ((uint32_t)p[pos + 1] << 8) |
                       ((uint32_t)p[pos + 2] << 16) |
                       ((uint32_t)p[pos + 3] << 24);
        pos += 4;
        /* uvarint over a window of at most 10 bytes (wal.py reads
         * buf[pos:pos+10] into BytesIO) with the codec's strict rules:
         * uint64 range, minimal encoding. */
        Py_ssize_t window = n - pos < 10 ? n - pos : 10;
        uint64_t length = 0;
        int shift = 0, consumed = 0, done = 0;
        for (;;) {
            if (consumed >= window) {
                err = "bad length varint: truncated uvarint";
                break;
            }
            uint8_t b = p[pos + consumed];
            consumed++;
            if (shift == 63 && b > 1) {
                err = "bad length varint: uvarint overflows uint64";
                break;
            }
            if (shift > 0 && b == 0) {
                err = "bad length varint: non-minimal uvarint";
                break;
            }
            length |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) {
                done = 1;
                break;
            }
            shift += 7;
            if (shift > 63) {
                err = "bad length varint: uvarint too long";
                break;
            }
        }
        if (!done)
            break;
        pos += consumed;
        if (length > max_len) {
            snprintf(errbuf, sizeof(errbuf), "length %llu too big",
                     (unsigned long long)length);
            err = errbuf;
            break;
        }
        if ((uint64_t)(n - pos) < length) {
            err = "truncated payload";
            break;
        }
        if (crc32_ieee(p + pos, (Py_ssize_t)length) != crc) {
            err = "crc mismatch";
            break;
        }
        PyObject *span = Py_BuildValue("(nn)", pos, (Py_ssize_t)length);
        if (span == NULL || PyList_Append(spans, span) < 0) {
            Py_XDECREF(span);
            Py_DECREF(spans);
            PyBuffer_Release(&buf);
            return NULL;
        }
        Py_DECREF(span);
        pos += (Py_ssize_t)length;
    }

    PyBuffer_Release(&buf);
    PyObject *errobj = err ? PyUnicode_FromString(err) : Py_NewRef(Py_None);
    if (errobj == NULL) {
        Py_DECREF(spans);
        return NULL;
    }
    PyObject *out = PyTuple_Pack(2, spans, errobj);
    Py_DECREF(spans);
    Py_DECREF(errobj);
    return out;
}

static PyMethodDef methods[] = {
    {"scan", scan, METH_VARARGS,
     "scan(buf, max_len) -> (list[(payload_off, payload_len)], err|None)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_wal_native", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit__wal_native(void) {
    return PyModule_Create(&moduledef);
}
