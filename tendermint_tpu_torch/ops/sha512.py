"""SHA-512 for the port: round constants, the padding rule, and a plain
batched SHA-512 on tensors (the plain version of the prologue kernel's hash).

torch has no general uint64 arithmetic and ``>>`` on int64 is arithmetic, so
the plain version works on 32-bit halves held in int64 tensors (values in
[0, 2^32)), masking after every shift and add, as the TPU kernel does in
u32 pairs. The CUDA kernel uses native 64-bit words and the same constants.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.device import DeviceLike, resolve_device

# FIPS 180-4 round constants and initial state
K = (
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
)
H0 = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

M32 = 0xFFFFFFFF


def nblocks(length: int) -> int:
    """128-byte blocks of a padded message: data, 0x80, zeros, 16-byte
    big-endian bit length."""
    return (length + 1 + 16 + 127) // 128


def pad(data: np.ndarray) -> np.ndarray:
    """(n, length) uint8 -> (n, nblocks*128) uint8 padded messages."""
    n, length = data.shape
    out = np.zeros((n, nblocks(length) * 128), dtype=np.uint8)
    out[:, :length] = data
    out[:, length] = 0x80
    out[:, -16:] = np.frombuffer((length * 8).to_bytes(16, "big"), np.uint8)
    return out


def be_words(padded: np.ndarray) -> np.ndarray:
    """(n, 4m) uint8 -> (n, m) uint32 big-endian words."""
    n = padded.shape[0]
    return np.ascontiguousarray(
        padded.reshape(n, -1, 4)[:, :, ::-1].reshape(n, -1)
    ).view("<u4").astype(np.uint32)


Pair = Tuple[torch.Tensor, torch.Tensor]  # (hi, lo) 32-bit halves


def _add(*vs: Pair) -> Pair:
    lo = vs[0][1]
    hi = vs[0][0]
    for v in vs[1:]:
        lo = lo + v[1]
        hi = hi + v[0]
    return ((hi + (lo >> 32)) & M32, lo & M32)


def _rotr(a: Pair, n: int) -> Pair:
    hi, lo = a
    if n == 32:
        return (lo, hi)
    if n > 32:
        hi, lo, n = lo, hi, n - 32
    return (((hi >> n) | (lo << (32 - n))) & M32,
            ((lo >> n) | (hi << (32 - n))) & M32)


def _shr(a: Pair, n: int) -> Pair:
    hi, lo = a
    return (hi >> n, ((lo >> n) | (hi << (32 - n))) & M32)


def _xor(*vs: Pair) -> Pair:
    hi, lo = vs[0]
    for v in vs[1:]:
        hi = hi ^ v[0]
        lo = lo ^ v[1]
    return (hi, lo)


def _const(v: int, like: torch.Tensor) -> Pair:
    return (torch.full_like(like, v >> 32), torch.full_like(like, v & M32))


def sha512_words(words: torch.Tensor) -> List[Pair]:
    """Plain SHA-512 of padded messages given as (n, nblocks*32) big-endian
    32-bit words (any integer dtype holding the bit patterns). Returns the 8
    state words as (hi, lo) int64 pairs of shape (n,)."""
    words = words.to(torch.int64) & M32
    zero = words[:, 0] * 0
    state = [_const(v, zero) for v in H0]
    for blk in range(words.shape[1] // 32):
        w = [(words[:, blk * 32 + 2 * t], words[:, blk * 32 + 2 * t + 1])
             for t in range(16)]
        for t in range(16, 80):
            s0 = _xor(_rotr(w[t - 15], 1), _rotr(w[t - 15], 8), _shr(w[t - 15], 7))
            s1 = _xor(_rotr(w[t - 2], 19), _rotr(w[t - 2], 61), _shr(w[t - 2], 6))
            w.append(_add(w[t - 16], s0, w[t - 7], s1))
        a, b, c, d, e, f, g, h = state
        for t in range(80):
            S1 = _xor(_rotr(e, 14), _rotr(e, 18), _rotr(e, 41))
            ch = ((e[0] & f[0]) ^ ((e[0] ^ M32) & g[0]),
                  (e[1] & f[1]) ^ ((e[1] ^ M32) & g[1]))
            t1 = _add(h, S1, ch, _const(K[t], zero), w[t])
            S0 = _xor(_rotr(a, 28), _rotr(a, 34), _rotr(a, 39))
            maj = ((a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
                   (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]))
            h, g, f, e, d, c, b, a = g, f, e, _add(d, t1), c, b, a, _add(t1, S0, maj)
        state = [_add(s, v) for s, v in zip(state, (a, b, c, d, e, f, g, h))]
    return state


def digest_bytes(state: List[Pair]) -> np.ndarray:
    """8 (hi, lo) pairs -> (n, 64) uint8 big-endian digests."""
    words = torch.stack([x for pair in state for x in pair], dim=1).cpu().numpy()
    return np.ascontiguousarray(
        words.astype(">u4")).view(np.uint8).reshape(words.shape[0], 64)


def sha512_batch(data: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """SHA-512 of n equal-length messages: (n, length) uint8 -> (n, 64),
    on ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    words = torch.from_numpy(be_words(pad(data)).astype(np.int64)).to(
        resolve_device(device))
    return digest_bytes(sha512_words(words))
