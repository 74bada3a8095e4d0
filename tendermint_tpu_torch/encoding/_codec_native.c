/* The port's native codec writer and reader: the hot serialization path
 * of block application (state saves, and the vote, validator and commit
 * encodes that run on every block of fast sync, block execution and
 * consensus).
 *
 * Mirrors encoding/codec.py's _PyWriter and _PyReader byte for byte:
 * LEB128 uvarint, zig-zag svarint, little-endian fixed64, length-prefixed
 * bytes and strings, one-byte bools. The reader raises the same exception
 * classes with the same messages as _PyReader on every malformed input.
 * codec.py binds Writer and Reader to these types when encoding/native.py
 * could build this file, and to the Python classes otherwise.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* growable byte buffer                                               */
/* ------------------------------------------------------------------ */

typedef struct {
    PyObject_HEAD
    uint8_t *buf;
    Py_ssize_t len;
    Py_ssize_t cap;
} WriterObject;

static int writer_reserve(WriterObject *self, Py_ssize_t extra)
{
    if (self->len + extra <= self->cap)
        return 0;
    Py_ssize_t ncap = self->cap ? self->cap : 128;
    while (ncap < self->len + extra)
        ncap *= 2;
    uint8_t *nbuf = PyMem_Realloc(self->buf, (size_t)ncap);
    if (!nbuf) {
        PyErr_NoMemory();
        return -1;
    }
    self->buf = nbuf;
    self->cap = ncap;
    return 0;
}

static inline int writer_put_uvarint(WriterObject *self, uint64_t v)
{
    if (writer_reserve(self, 10) < 0)
        return -1;
    uint8_t *p = self->buf + self->len;
    while (v >= 0x80) {
        *p++ = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    *p++ = (uint8_t)v;
    self->len = p - self->buf;
    return 0;
}

/* ------------------------------------------------------------------ */
/* Writer methods                                                     */
/* ------------------------------------------------------------------ */

static PyObject *writer_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    WriterObject *self = (WriterObject *)type->tp_alloc(type, 0);
    if (!self)
        return NULL;
    self->buf = NULL;
    self->len = 0;
    self->cap = 0;
    return (PyObject *)self;
}

static void writer_dealloc(WriterObject *self)
{
    PyMem_Free(self->buf);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *writer_uvarint(WriterObject *self, PyObject *arg)
{
    /* Accept the FULL uint64 domain [0, 2^64): wire uvarints are uint64 and
     * the pure-Python writer must accept exactly the same range — divergent
     * writer acceptance between codec backends is a network-split hazard. */
    uint64_t v = PyLong_AsUnsignedLongLong(arg);
    if (v == (uint64_t)-1 && PyErr_Occurred()) {
        if (PyErr_ExceptionMatches(PyExc_OverflowError) ||
            PyErr_ExceptionMatches(PyExc_TypeError)) {
            PyErr_Clear();
            PyErr_SetString(PyExc_ValueError,
                            "uvarint must be in [0, 2^64)");
        }
        return NULL;
    }
    if (writer_put_uvarint(self, v) < 0)
        return NULL;
    Py_INCREF(self);
    return (PyObject *)self;
}

static PyObject *writer_svarint(WriterObject *self, PyObject *arg)
{
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(arg, &overflow);
    if (v == -1 && PyErr_Occurred())
        return NULL;
    if (overflow) {
        PyErr_SetString(PyExc_OverflowError, "svarint out of int64 range");
        return NULL;
    }
    /* zig-zag, matching codec.py: (n << 1) ^ (n >> 63) */
    uint64_t z = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
    if (writer_put_uvarint(self, z) < 0)
        return NULL;
    Py_INCREF(self);
    return (PyObject *)self;
}

static PyObject *writer_fixed64(WriterObject *self, PyObject *arg)
{
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(arg, &overflow);
    if (v == -1 && PyErr_Occurred())
        return NULL;
    if (overflow) {
        PyErr_SetString(PyExc_OverflowError, "fixed64 out of int64 range");
        return NULL;
    }
    if (writer_reserve(self, 8) < 0)
        return NULL;
    uint64_t u = (uint64_t)v;
    for (int i = 0; i < 8; i++)
        self->buf[self->len + i] = (uint8_t)(u >> (8 * i));
    self->len += 8;
    Py_INCREF(self);
    return (PyObject *)self;
}

static PyObject *writer_bytes(WriterObject *self, PyObject *arg)
{
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0)
        return NULL;
    if (writer_put_uvarint(self, (uint64_t)view.len) < 0 ||
        writer_reserve(self, view.len) < 0) {
        PyBuffer_Release(&view);
        return NULL;
    }
    memcpy(self->buf + self->len, view.buf, (size_t)view.len);
    self->len += view.len;
    PyBuffer_Release(&view);
    Py_INCREF(self);
    return (PyObject *)self;
}

static PyObject *writer_string(WriterObject *self, PyObject *arg)
{
    Py_ssize_t n;
    const char *s = PyUnicode_AsUTF8AndSize(arg, &n);
    if (!s)
        return NULL;
    if (writer_put_uvarint(self, (uint64_t)n) < 0 ||
        writer_reserve(self, n) < 0)
        return NULL;
    memcpy(self->buf + self->len, s, (size_t)n);
    self->len += n;
    Py_INCREF(self);
    return (PyObject *)self;
}

static PyObject *writer_bool(WriterObject *self, PyObject *arg)
{
    int truth = PyObject_IsTrue(arg);
    if (truth < 0)
        return NULL;
    if (writer_reserve(self, 1) < 0)
        return NULL;
    self->buf[self->len++] = truth ? 1 : 0;
    Py_INCREF(self);
    return (PyObject *)self;
}

static PyObject *writer_raw(WriterObject *self, PyObject *arg)
{
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0)
        return NULL;
    if (writer_reserve(self, view.len) < 0) {
        PyBuffer_Release(&view);
        return NULL;
    }
    memcpy(self->buf + self->len, view.buf, (size_t)view.len);
    self->len += view.len;
    PyBuffer_Release(&view);
    Py_INCREF(self);
    return (PyObject *)self;
}

static PyObject *writer_build(WriterObject *self, PyObject *noarg)
{
    return PyBytes_FromStringAndSize((const char *)self->buf, self->len);
}

static PyMethodDef writer_methods[] = {
    {"uvarint", (PyCFunction)writer_uvarint, METH_O, NULL},
    {"svarint", (PyCFunction)writer_svarint, METH_O, NULL},
    {"fixed64", (PyCFunction)writer_fixed64, METH_O, NULL},
    {"bytes", (PyCFunction)writer_bytes, METH_O, NULL},
    {"string", (PyCFunction)writer_string, METH_O, NULL},
    {"bool", (PyCFunction)writer_bool, METH_O, NULL},
    {"raw", (PyCFunction)writer_raw, METH_O, NULL},
    {"build", (PyCFunction)writer_build, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject WriterType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "tendermint_tpu_torch.encoding._codec_native.Writer",
    .tp_basicsize = sizeof(WriterObject),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = writer_new,
    .tp_dealloc = (destructor)writer_dealloc,
    .tp_methods = writer_methods,
};

/* ------------------------------------------------------------------ */
/* Reader                                                             */
/* ------------------------------------------------------------------ */

typedef struct {
    PyObject_HEAD
    PyObject *owner; /* bytes object keeping the data alive */
    const uint8_t *data;
    Py_ssize_t len;
    Py_ssize_t pos;
} ReaderObject;

static PyObject *reader_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    PyObject *data;
    if (!PyArg_ParseTuple(args, "O", &data))
        return NULL;
    ReaderObject *self = (ReaderObject *)type->tp_alloc(type, 0);
    if (!self)
        return NULL;
    Py_buffer view;
    if (PyObject_GetBuffer(data, &view, PyBUF_SIMPLE) < 0) {
        Py_TYPE(self)->tp_free((PyObject *)self);
        return NULL;
    }
    /* keep a bytes copy-or-ref so the pointer stays valid */
    self->owner = PyBytes_FromStringAndSize(view.buf, view.len);
    PyBuffer_Release(&view);
    if (!self->owner) {
        Py_TYPE(self)->tp_free((PyObject *)self);
        return NULL;
    }
    self->data = (const uint8_t *)PyBytes_AS_STRING(self->owner);
    self->len = PyBytes_GET_SIZE(self->owner);
    self->pos = 0;
    return (PyObject *)self;
}

static void reader_dealloc(ReaderObject *self)
{
    Py_XDECREF(self->owner);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static int reader_get_uvarint(ReaderObject *self, uint64_t *out)
{
    /* wire uvarints are uint64; larger is malformed and must be rejected
     * exactly like the pure-Python reader, with its messages: at shift 63
     * any byte above 1 overflows, a continuation bit included (and
     * shifting by >= 64 is UB).
     * Non-minimal encodings (trailing zero continuation bytes) are also
     * rejected: decode-time wire-span hash caching means two encodings of
     * one value would hash one logical structure two ways. */
    uint64_t v = 0;
    int shift = 0;
    while (1) {
        if (self->pos >= self->len) {
            PyErr_SetString(PyExc_EOFError, "truncated uvarint");
            return -1;
        }
        uint8_t b = self->data[self->pos++];
        if (shift == 63 && b > 1) {
            PyErr_SetString(PyExc_ValueError, "uvarint overflows uint64");
            return -1;
        }
        if (shift > 0 && b == 0) {
            PyErr_SetString(PyExc_ValueError, "non-minimal uvarint");
            return -1;
        }
        v |= ((uint64_t)(b & 0x7F)) << shift;
        if (!(b & 0x80))
            break;
        shift += 7;
        if (shift > 63) {
            PyErr_SetString(PyExc_ValueError, "uvarint too long");
            return -1;
        }
    }
    *out = v;
    return 0;
}

static PyObject *reader_uvarint(ReaderObject *self, PyObject *noarg)
{
    uint64_t v;
    if (reader_get_uvarint(self, &v) < 0)
        return NULL;
    return PyLong_FromUnsignedLongLong(v);
}

static PyObject *reader_svarint(ReaderObject *self, PyObject *noarg)
{
    uint64_t u;
    if (reader_get_uvarint(self, &u) < 0)
        return NULL;
    int64_t v = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
    return PyLong_FromLongLong(v);
}

static PyObject *reader_fixed64(ReaderObject *self, PyObject *noarg)
{
    if (self->pos + 8 > self->len) {
        PyErr_SetString(PyExc_EOFError, "truncated fixed64");
        return NULL;
    }
    uint64_t u = 0;
    for (int i = 0; i < 8; i++)
        u |= ((uint64_t)self->data[self->pos + i]) << (8 * i);
    self->pos += 8;
    return PyLong_FromLongLong((int64_t)u);
}

static PyObject *reader_bytes(ReaderObject *self, PyObject *noarg)
{
    uint64_t n;
    if (reader_get_uvarint(self, &n) < 0)
        return NULL;
    if ((uint64_t)(self->len - self->pos) < n) {
        PyErr_SetString(PyExc_EOFError, "truncated bytes");
        return NULL;
    }
    PyObject *out =
        PyBytes_FromStringAndSize((const char *)self->data + self->pos, (Py_ssize_t)n);
    self->pos += (Py_ssize_t)n;
    return out;
}

static PyObject *reader_string(ReaderObject *self, PyObject *noarg)
{
    uint64_t n;
    if (reader_get_uvarint(self, &n) < 0)
        return NULL;
    if ((uint64_t)(self->len - self->pos) < n) {
        PyErr_SetString(PyExc_EOFError, "truncated bytes");
        return NULL;
    }
    PyObject *out = PyUnicode_DecodeUTF8(
        (const char *)self->data + self->pos, (Py_ssize_t)n, NULL);
    self->pos += (Py_ssize_t)n;
    return out;
}

static PyObject *reader_bool(ReaderObject *self, PyObject *noarg)
{
    if (self->pos >= self->len) {
        PyErr_SetString(PyExc_EOFError, "truncated bool");
        return NULL;
    }
    return PyBool_FromLong(self->data[self->pos++] != 0);
}

static PyObject *reader_raw(ReaderObject *self, PyObject *arg)
{
    Py_ssize_t n = PyLong_AsSsize_t(arg);
    if (n == -1 && PyErr_Occurred())
        return NULL;
    if (n < 0 || self->len - self->pos < n) {
        PyErr_SetString(PyExc_EOFError, "truncated raw read");
        return NULL;
    }
    PyObject *out =
        PyBytes_FromStringAndSize((const char *)self->data + self->pos, n);
    self->pos += n;
    return out;
}

static PyObject *reader_remaining(ReaderObject *self, PyObject *noarg)
{
    return PyLong_FromSsize_t(self->len - self->pos);
}

static PyObject *reader_at_end(ReaderObject *self, PyObject *noarg)
{
    return PyBool_FromLong(self->pos >= self->len);
}

static PyObject *reader_tell(ReaderObject *self, PyObject *noarg)
{
    return PyLong_FromSsize_t(self->pos);
}

static PyObject *reader_span(ReaderObject *self, PyObject *arg)
{
    /* bytes from a previously tell()'d offset up to the current position —
     * lets decoders capture the exact wire span of a sub-structure without
     * re-encoding it (vote/commit hash caching on the fast-sync hot path) */
    Py_ssize_t start = PyLong_AsSsize_t(arg);
    if (start == -1 && PyErr_Occurred())
        return NULL;
    if (start < 0 || start > self->pos) {
        PyErr_SetString(PyExc_ValueError, "span start out of range");
        return NULL;
    }
    return PyBytes_FromStringAndSize((const char *)self->data + start,
                                     self->pos - start);
}

static PyMethodDef reader_methods[] = {
    {"uvarint", (PyCFunction)reader_uvarint, METH_NOARGS, NULL},
    {"svarint", (PyCFunction)reader_svarint, METH_NOARGS, NULL},
    {"fixed64", (PyCFunction)reader_fixed64, METH_NOARGS, NULL},
    {"bytes", (PyCFunction)reader_bytes, METH_NOARGS, NULL},
    {"string", (PyCFunction)reader_string, METH_NOARGS, NULL},
    {"bool", (PyCFunction)reader_bool, METH_NOARGS, NULL},
    {"raw", (PyCFunction)reader_raw, METH_O, NULL},
    {"remaining", (PyCFunction)reader_remaining, METH_NOARGS, NULL},
    {"at_end", (PyCFunction)reader_at_end, METH_NOARGS, NULL},
    {"tell", (PyCFunction)reader_tell, METH_NOARGS, NULL},
    {"span", (PyCFunction)reader_span, METH_O, NULL},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject ReaderType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "tendermint_tpu_torch.encoding._codec_native.Reader",
    .tp_basicsize = sizeof(ReaderObject),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = reader_new,
    .tp_dealloc = (destructor)reader_dealloc,
    .tp_methods = reader_methods,
};

/* ------------------------------------------------------------------ */

static struct PyModuleDef codec_module = {
    PyModuleDef_HEAD_INIT,
    "_codec_native",
    "The port's native codec writer and reader (encoding/codec.py holds the spec).",
    -1,
    NULL,
};

PyMODINIT_FUNC PyInit__codec_native(void)
{
    if (PyType_Ready(&WriterType) < 0 || PyType_Ready(&ReaderType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&codec_module);
    if (!m)
        return NULL;
    if (PyModule_AddObjectRef(m, "Writer", (PyObject *)&WriterType) < 0 ||
        PyModule_AddObjectRef(m, "Reader", (PyObject *)&ReaderType) < 0) {
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
