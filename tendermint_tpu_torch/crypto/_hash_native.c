/* The port's native SHA-256 and Merkle tree: the host-side hashing of
 * block application (the part set rebuilt from every block of fast sync,
 * and the header, commit and validator-set roots). Mirrors
 * crypto/merkle.py's tree exactly: 0x00 leaf prefix, 0x01 inner prefix,
 * a split at the largest power of two strictly below n, the empty tree
 * SHA256("").
 *
 * Uses x86 SHA-NI when the CPU has it (detected at module init; the
 * environment variable TM_NO_SHANI forces the portable block function),
 * with a portable C block function otherwise; both give the FIPS 180-4
 * digests. have_shani() says which one runs.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define HAVE_X86 1
#endif

/* ------------------------------------------------------------------ */
/* portable SHA-256                                                   */
/* ------------------------------------------------------------------ */

static const uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

#define ROR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_block_portable(uint32_t st[8], const uint8_t *p)
{
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
        w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
               ((uint32_t)p[4 * i + 2] << 8) | p[4 * i + 3];
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = ROR(w[i - 15], 7) ^ ROR(w[i - 15], 18) ^ (w[i - 15] >> 3);
        uint32_t s1 = ROR(w[i - 2], 17) ^ ROR(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
    for (int i = 0; i < 64; i++) {
        uint32_t S1 = ROR(e, 6) ^ ROR(e, 11) ^ ROR(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = h + S1 + ch + K256[i] + w[i];
        uint32_t S0 = ROR(a, 2) ^ ROR(a, 13) ^ ROR(a, 22);
        uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
        uint32_t t2 = S0 + mj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

/* ------------------------------------------------------------------ */
/* SHA-NI block function (x86)                                        */
/* ------------------------------------------------------------------ */

#ifdef HAVE_X86
__attribute__((target("sha,sse4.1")))
static void sha256_block_shani(uint32_t st[8], const uint8_t *p)
{
    const __m128i MASK =
        _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
    /* load state: st = {a,b,c,d,e,f,g,h}; SHA-NI wants {abef, cdgh} */
    __m128i tmp = _mm_loadu_si128((const __m128i *)&st[0]); /* a b c d */
    __m128i s1 = _mm_loadu_si128((const __m128i *)&st[4]);  /* e f g h */
    tmp = _mm_shuffle_epi32(tmp, 0xB1);  /* b a d c */
    s1 = _mm_shuffle_epi32(s1, 0x1B);    /* h g f e */
    __m128i state0 = _mm_alignr_epi8(tmp, s1, 8);   /* abef */
    __m128i state1 = _mm_blend_epi16(s1, tmp, 0xF0); /* cdgh */

    __m128i abef_save = state0, cdgh_save = state1;
    __m128i msg, msg0, msg1, msg2, msg3;

#define QROUND(m, k0, k1)                                                 \
    msg = _mm_add_epi32(m, _mm_set_epi64x(k1, k0));                       \
    state1 = _mm_sha256rnds2_epu32(state1, state0, msg);                  \
    msg = _mm_shuffle_epi32(msg, 0x0E);                                   \
    state0 = _mm_sha256rnds2_epu32(state0, state1, msg);

    msg0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(p + 0)), MASK);
    QROUND(msg0, 0x71374491428A2F98ULL, 0xE9B5DBA5B5C0FBCFULL);
    msg1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(p + 16)), MASK);
    QROUND(msg1, 0x59F111F13956C25BULL, 0xAB1C5ED5923F82A4ULL);
    msg0 = _mm_sha256msg1_epu32(msg0, msg1);
    msg2 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(p + 32)), MASK);
    QROUND(msg2, 0x12835B01D807AA98ULL, 0x550C7DC3243185BEULL);
    msg1 = _mm_sha256msg1_epu32(msg1, msg2);
    msg3 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(p + 48)), MASK);
    QROUND(msg3, 0x80DEB1FE72BE5D74ULL, 0xC19BF1749BDC06A7ULL);

    /* Schedule step for the group rebuilding m0 as w[i..i+3]: m3 holds the
     * previous w-block (w[i-4..i-1]) and m2 the one before it — m2 must
     * still be RAW for the alignr (it supplies w[i-7..i-5]); only after
     * that may m2 take its msg1 step (whose input is its successor m3). */
#define SCHED(m0, m1, m2, m3, k0, k1)                                     \
    m0 = _mm_add_epi32(m0, _mm_alignr_epi8(m3, m2, 4));                   \
    m0 = _mm_sha256msg2_epu32(m0, m3);                                    \
    m2 = _mm_sha256msg1_epu32(m2, m3);                                    \
    QROUND(m0, k0, k1);

    SCHED(msg0, msg1, msg2, msg3, 0xEFBE4786E49B69C1ULL, 0x240CA1CC0FC19DC6ULL);
    SCHED(msg1, msg2, msg3, msg0, 0x4A7484AA2DE92C6FULL, 0x76F988DA5CB0A9DCULL);
    SCHED(msg2, msg3, msg0, msg1, 0xA831C66D983E5152ULL, 0xBF597FC7B00327C8ULL);
    SCHED(msg3, msg0, msg1, msg2, 0xD5A79147C6E00BF3ULL, 0x1429296706CA6351ULL);
    SCHED(msg0, msg1, msg2, msg3, 0x2E1B213827B70A85ULL, 0x53380D134D2C6DFCULL);
    SCHED(msg1, msg2, msg3, msg0, 0x766A0ABB650A7354ULL, 0x92722C8581C2C92EULL);
    SCHED(msg2, msg3, msg0, msg1, 0xA81A664BA2BFE8A1ULL, 0xC76C51A3C24B8B70ULL);
    SCHED(msg3, msg0, msg1, msg2, 0xD6990624D192E819ULL, 0x106AA070F40E3585ULL);
    SCHED(msg0, msg1, msg2, msg3, 0x1E376C0819A4C116ULL, 0x34B0BCB52748774CULL);
    SCHED(msg1, msg2, msg3, msg0, 0x4ED8AA4A391C0CB3ULL, 0x682E6FF35B9CCA4FULL);

    /* rounds 48-63: no more msg1 scheduling needed */
    msg2 = _mm_add_epi32(msg2, _mm_alignr_epi8(msg1, msg0, 4));
    msg2 = _mm_sha256msg2_epu32(msg2, msg1);
    QROUND(msg2, 0x78A5636F748F82EEULL, 0x8CC7020884C87814ULL);
    msg3 = _mm_add_epi32(msg3, _mm_alignr_epi8(msg2, msg1, 4));
    msg3 = _mm_sha256msg2_epu32(msg3, msg2);
    QROUND(msg3, 0xA4506CEB90BEFFFAULL, 0xC67178F2BEF9A3F7ULL);

#undef SCHED
#undef QROUND

    state0 = _mm_add_epi32(state0, abef_save);
    state1 = _mm_add_epi32(state1, cdgh_save);

    /* unpack {abef, cdgh} back to {a..h} */
    tmp = _mm_shuffle_epi32(state0, 0x1B); /* feba */
    s1 = _mm_shuffle_epi32(state1, 0xB1);  /* dchg */
    __m128i abcd = _mm_blend_epi16(tmp, s1, 0xF0);
    __m128i efgh = _mm_alignr_epi8(s1, tmp, 8);
    _mm_storeu_si128((__m128i *)&st[0], abcd);
    _mm_storeu_si128((__m128i *)&st[4], efgh);
}

static int g_have_shani = -1;
#endif

static void (*sha256_block)(uint32_t st[8], const uint8_t *p) =
    sha256_block_portable;

/* incremental context */
typedef struct {
    uint32_t st[8];
    uint8_t buf[64];
    size_t buflen;
    uint64_t total;
} sha256_ctx;

static void sha256_init(sha256_ctx *c)
{
    static const uint32_t IV[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                   0xa54ff53a, 0x510e527f, 0x9b05688c,
                                   0x1f83d9ab, 0x5be0cd19};
    memcpy(c->st, IV, sizeof(IV));
    c->buflen = 0;
    c->total = 0;
}

static void sha256_update(sha256_ctx *c, const uint8_t *p, size_t n)
{
    c->total += n;
    if (c->buflen) {
        size_t take = 64 - c->buflen;
        if (take > n)
            take = n;
        memcpy(c->buf + c->buflen, p, take);
        c->buflen += take;
        p += take;
        n -= take;
        if (c->buflen == 64) {
            sha256_block(c->st, c->buf);
            c->buflen = 0;
        }
    }
    while (n >= 64) {
        sha256_block(c->st, p);
        p += 64;
        n -= 64;
    }
    if (n) {
        memcpy(c->buf, p, n);
        c->buflen = n;
    }
}

static void sha256_final(sha256_ctx *c, uint8_t out[32])
{
    uint64_t bits = c->total * 8;
    uint8_t pad = 0x80;
    sha256_update(c, &pad, 1);
    uint8_t zero[64] = {0};
    size_t padlen = (c->buflen <= 56) ? 56 - c->buflen : 120 - c->buflen;
    sha256_update(c, zero, padlen);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++)
        lenb[i] = (uint8_t)(bits >> (8 * (7 - i)));
    sha256_update(c, lenb, 8);
    for (int i = 0; i < 8; i++) {
        out[4 * i] = (uint8_t)(c->st[i] >> 24);
        out[4 * i + 1] = (uint8_t)(c->st[i] >> 16);
        out[4 * i + 2] = (uint8_t)(c->st[i] >> 8);
        out[4 * i + 3] = (uint8_t)(c->st[i]);
    }
}

static void sha256_oneshot(const uint8_t *p, size_t n, uint8_t out[32])
{
    sha256_ctx c;
    sha256_init(&c);
    sha256_update(&c, p, n);
    sha256_final(&c, out);
}

/* prefix-domain digest: SHA256(prefix || data) */
static void sha256_prefixed(uint8_t prefix, const uint8_t *p, size_t n,
                            uint8_t out[32])
{
    sha256_ctx c;
    sha256_init(&c);
    sha256_update(&c, &prefix, 1);
    sha256_update(&c, p, n);
    sha256_final(&c, out);
}

/* inner node: SHA256(0x01 || left32 || right32) */
static void merkle_inner(const uint8_t *l, const uint8_t *r, uint8_t out[32])
{
    uint8_t buf[65];
    buf[0] = 0x01;
    memcpy(buf + 1, l, 32);
    memcpy(buf + 33, r, 32);
    sha256_oneshot(buf, 65, out);
}

static size_t split_point(size_t n)
{
    size_t k = 1;
    while (k * 2 < n)
        k *= 2;
    return k;
}

/* root over contiguous leaf-hash array [lo, hi) */
static void merkle_root_of_hashes(const uint8_t *lh, size_t lo, size_t hi,
                                  uint8_t out[32])
{
    size_t cnt = hi - lo;
    if (cnt == 1) {
        memcpy(out, lh + 32 * lo, 32);
        return;
    }
    size_t k = split_point(cnt);
    uint8_t left[32], right[32];
    merkle_root_of_hashes(lh, lo, lo + k, left);
    merkle_root_of_hashes(lh, lo + k, hi, right);
    merkle_inner(left, right, out);
}

/* ------------------------------------------------------------------ */
/* Python bindings                                                    */
/* ------------------------------------------------------------------ */

static PyObject *py_sha256(PyObject *mod, PyObject *arg)
{
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0)
        return NULL;
    uint8_t out[32];
    sha256_oneshot((const uint8_t *)view.buf, (size_t)view.len, out);
    PyBuffer_Release(&view);
    return PyBytes_FromStringAndSize((const char *)out, 32);
}

static PyObject *py_leaf_hash(PyObject *mod, PyObject *arg)
{
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0)
        return NULL;
    uint8_t out[32];
    sha256_prefixed(0x00, (const uint8_t *)view.buf, (size_t)view.len, out);
    PyBuffer_Release(&view);
    return PyBytes_FromStringAndSize((const char *)out, 32);
}

static PyObject *py_inner_hash(PyObject *mod, PyObject *args)
{
    Py_buffer l, r;
    if (!PyArg_ParseTuple(args, "y*y*", &l, &r))
        return NULL;
    if (l.len != 32 || r.len != 32) {
        PyBuffer_Release(&l);
        PyBuffer_Release(&r);
        PyErr_SetString(PyExc_ValueError, "inner_hash wants two 32-byte digests");
        return NULL;
    }
    uint8_t out[32];
    merkle_inner((const uint8_t *)l.buf, (const uint8_t *)r.buf, out);
    PyBuffer_Release(&l);
    PyBuffer_Release(&r);
    return PyBytes_FromStringAndSize((const char *)out, 32);
}

/* merkle_root(items: sequence[bytes]) -> bytes32 */
static PyObject *py_merkle_root(PyObject *mod, PyObject *arg)
{
    PyObject *seq = PySequence_Fast(arg, "merkle_root wants a sequence");
    if (!seq)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    uint8_t out[32];
    if (n == 0) {
        sha256_oneshot((const uint8_t *)"", 0, out);
        Py_DECREF(seq);
        return PyBytes_FromStringAndSize((const char *)out, 32);
    }
    uint8_t *lh = PyMem_Malloc((size_t)n * 32);
    if (!lh) {
        Py_DECREF(seq);
        return PyErr_NoMemory();
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *it = PySequence_Fast_GET_ITEM(seq, i);
        Py_buffer view;
        if (PyObject_GetBuffer(it, &view, PyBUF_SIMPLE) < 0) {
            PyMem_Free(lh);
            Py_DECREF(seq);
            return NULL;
        }
        sha256_prefixed(0x00, (const uint8_t *)view.buf, (size_t)view.len,
                        lh + 32 * i);
        PyBuffer_Release(&view);
    }
    merkle_root_of_hashes(lh, 0, (size_t)n, out);
    PyMem_Free(lh);
    Py_DECREF(seq);
    return PyBytes_FromStringAndSize((const char *)out, 32);
}

/* leaf_hashes(items) -> list[bytes32] (for the proofs) */
static PyObject *py_leaf_hashes(PyObject *mod, PyObject *arg)
{
    PyObject *seq = PySequence_Fast(arg, "leaf_hashes wants a sequence");
    if (!seq)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject *out = PyList_New(n);
    if (!out) {
        Py_DECREF(seq);
        return NULL;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *it = PySequence_Fast_GET_ITEM(seq, i);
        Py_buffer view;
        if (PyObject_GetBuffer(it, &view, PyBUF_SIMPLE) < 0) {
            Py_DECREF(out);
            Py_DECREF(seq);
            return NULL;
        }
        uint8_t h[32];
        sha256_prefixed(0x00, (const uint8_t *)view.buf, (size_t)view.len, h);
        PyBuffer_Release(&view);
        PyObject *b = PyBytes_FromStringAndSize((const char *)h, 32);
        if (!b) {
            Py_DECREF(out);
            Py_DECREF(seq);
            return NULL;
        }
        PyList_SET_ITEM(out, i, b);
    }
    Py_DECREF(seq);
    return out;
}

/* part_leaf_hashes(data: bytes, part_size: int) -> list[bytes32]
 * leaf hashes of the 64kB chunks of a block's marshaled bytes — the
 * part-set construction hot loop in one native call. */
static PyObject *py_part_leaf_hashes(PyObject *mod, PyObject *args)
{
    Py_buffer view;
    Py_ssize_t part_size;
    if (!PyArg_ParseTuple(args, "y*n", &view, &part_size))
        return NULL;
    if (part_size <= 0) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "part_size must be positive");
        return NULL;
    }
    /* no view.len + part_size - 1: it overflows for a part_size near
     * PY_SSIZE_T_MAX */
    Py_ssize_t total = view.len / part_size + (view.len % part_size != 0);
    if (total == 0)
        total = 1;
    PyObject *out = PyList_New(total);
    if (!out) {
        PyBuffer_Release(&view);
        return NULL;
    }
    const uint8_t *p = (const uint8_t *)view.buf;
    for (Py_ssize_t i = 0; i < total; i++) {
        Py_ssize_t off = i * part_size;
        Py_ssize_t len = view.len - off;
        if (len > part_size)
            len = part_size;
        if (len < 0)
            len = 0;
        uint8_t h[32];
        sha256_prefixed(0x00, p + off, (size_t)len, h);
        PyObject *b = PyBytes_FromStringAndSize((const char *)h, 32);
        if (!b) {
            Py_DECREF(out);
            PyBuffer_Release(&view);
            return NULL;
        }
        PyList_SET_ITEM(out, i, b);
    }
    PyBuffer_Release(&view);
    return out;
}

static PyObject *py_have_shani(PyObject *mod, PyObject *noarg)
{
#ifdef HAVE_X86
    return PyBool_FromLong(g_have_shani == 1);
#else
    Py_RETURN_FALSE;
#endif
}

static PyMethodDef hash_methods[] = {
    {"sha256", (PyCFunction)py_sha256, METH_O, NULL},
    {"leaf_hash", (PyCFunction)py_leaf_hash, METH_O, NULL},
    {"inner_hash", (PyCFunction)py_inner_hash, METH_VARARGS, NULL},
    {"merkle_root", (PyCFunction)py_merkle_root, METH_O, NULL},
    {"leaf_hashes", (PyCFunction)py_leaf_hashes, METH_O, NULL},
    {"part_leaf_hashes", (PyCFunction)py_part_leaf_hashes, METH_VARARGS, NULL},
    {"have_shani", (PyCFunction)py_have_shani, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef hash_module = {
    PyModuleDef_HEAD_INIT,
    "_hash_native",
    "The port's native SHA-256 and Merkle tree (crypto/merkle.py holds the spec).",
    -1,
    hash_methods,
};

PyMODINIT_FUNC PyInit__hash_native(void)
{
#ifdef HAVE_X86
    /* TM_NO_SHANI forces the portable block fn (tests cover both paths) */
    if (!getenv("TM_NO_SHANI") && __builtin_cpu_supports("sha") &&
        __builtin_cpu_supports("sse4.1")) {
        g_have_shani = 1;
        sha256_block = sha256_block_shani;
    } else {
        g_have_shani = 0;
    }
#endif
    return PyModule_Create(&hash_module);
}
