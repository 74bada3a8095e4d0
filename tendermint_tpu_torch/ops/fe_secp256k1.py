"""GF(p), p = 2^256 - 2^32 - 977, for the port's secp256k1 path: layout,
plain version and overflow-bound certificate.

Counterpart of the secp256k1 half of the JAX package's ``ops/fe_common.py``
and of ``ops/secp256k1_verify.py``'s field. Layout (shared by the CUDA
ladder kernel ``csrc/secp256k1_ladder.cu`` and the plain version below),
libsecp256k1's ``field_10x26``: ten limbs of weight 2^(26 i), nine 26 bits
wide and the top one 22 bits (26 * 9 + 22 = 256). The kernel holds limbs in
``uint32`` and ``mul``'s columns and folded limbs in ``uint64`` (the rest of
``mul`` fits 32 bits by the bounds below); the plain version
holds both in ``int64`` tensors with the limbs on the last axis. The two run
the same schedule, so every intermediate is the same integer:

  * ``carry``: one parallel pass, c_i = t_i >> width_i, limb i keeps its
    width and takes c_(i-1); the carry out of limb 9 weighs 2^256 =
    0x1000003D1 (mod p) and adds 0x3D1 c at limb 0 and 0x40 c at limb 1
    (2^32 = 2^6 * 2^26).
  * ``add`` / ``sub`` / ``mul_small``: limb-wise a + b, a + K - b (K = 2p
    spread over the limbs, no underflow for carried b) or k * a, in 32
    bits, then one ``carry``.
  * ``mul``: the 19 product columns c_k = sum_(i+j=k) a_i b_j (100 products
    of 32x32 -> 64 bits), one parallel 26-bit carry pass over 20 columns
    that brings the high columns down to limb width, then the fold of
    column k >= 10 by 2^260 = 0x1000003D10 (mod p) in two parts: 0x3D10 d_k
    at limb k - 10 and 0x400 d_k at limb k - 9 (2^36 = 2^10 * 2^26). Column
    19's 0x400 part lands on 2^260 again and is folded once more (0xF44000
    at limb 0, 0x100000 at limb 1). Two ``carry`` passes follow.
  * ``canonical``: three sequential carry-and-fold passes, then one
    conditional subtraction of p.

Every op takes and returns values of the carried class ``closed_set()``: the
per-limb maxima that ``certify()`` proves closed under add, sub, mul and
mul_small(21), with every ``mul`` intermediate below 2^63 (plain int64, and
so below the kernel's 2^64) and every 32-bit intermediate below 2^32. The
JAX package's radix-2^13 layout, lazy-carry plan and matrix-unit multipliers
schedule carries for the TPU and are not ported.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

P = 2**256 - 2**32 - 977
NLIMB = 10
RADIX = 26  # weight of limb i is 2^(26 i); product columns share it
WIDTHS = (26,) * 9 + (22,)
OFFS = tuple(RADIX * i for i in range(NLIMB))
MASKS = tuple((1 << w) - 1 for w in WIDTHS)
M26 = (1 << RADIX) - 1
NCOLS = 2 * NLIMB - 1  # product columns 0..18

# 2^256 = 0x1000003D1 (mod p): carry out of limb 9 -> 0x3D1 at 0, 0x40 at 1
TOP_LO, TOP_HI = 0x3D1, 0x40
# 2^260 = 0x1000003D10 (mod p): column k >= 10 -> 0x3D10 at k-10, 0x400 at k-9
FOLD_LO, FOLD_HI = 0x3D10, 0x400
# column 19's 0x400 part (at 2^260 once more) -> limbs 0 and 1
FOLD19_LO, FOLD19_HI = FOLD_HI * FOLD_LO, FOLD_HI * FOLD_HI
B3 = 21  # 3 b for the curve's b = 7


def int_to_limbs(x: int) -> List[int]:
    """0 <= x < 2^256 -> ten exact-width limbs."""
    return [(x >> OFFS[i]) & MASKS[i] for i in range(NLIMB)]


def limbs_to_int(limbs: Sequence[int]) -> int:
    """Value of a limb vector (any limb sizes)."""
    return sum(int(v) << OFFS[i] for i, v in enumerate(limbs))


assert limbs_to_int([TOP_LO, TOP_HI]) == 2**256 % P
assert limbs_to_int([FOLD_LO, FOLD_HI]) == 2**260 % P
assert (limbs_to_int([FOLD19_LO, FOLD19_HI]) - FOLD_HI * 2**260) % P == 0

# 2p spread over the limbs: a + K_SUB - b never goes negative for carried b
K_SUB = tuple(2 * m for m in int_to_limbs(P))
assert limbs_to_int(K_SUB) == 2 * P

# ---------------------------------------------------------------------------
# Overflow-bound certificate over Python ints (per-limb maxima). Each bound
# function mirrors its op's schedule step for step; x & m is bounded by
# min(x, m), and every step is monotone in its inputs.
# ---------------------------------------------------------------------------


def bound_carry(t: Sequence[int]) -> List[int]:
    c = [t[i] >> WIDTHS[i] for i in range(NLIMB)]
    cin = [TOP_LO * c[9], c[0] + TOP_HI * c[9]] + c[1:9]
    return [min(t[i], MASKS[i]) + cin[i] for i in range(NLIMB)]


def bound_mul_cols(a: Sequence[int], b: Sequence[int]) -> List[int]:
    cols = [0] * NCOLS
    for i in range(NLIMB):
        for j in range(NLIMB):
            cols[i + j] += a[i] * b[j]
    return cols


def bound_mul_steps(a: Sequence[int], b: Sequence[int]) -> tuple:
    """(output maxima, largest intermediate) through mul's schedule."""
    cols = bound_mul_cols(a, b) + [0]
    d = [min(cols[k], M26) + (cols[k - 1] >> RADIX if k else 0)
         for k in range(NCOLS + 1)]
    r = [d[k] + FOLD_LO * d[k + 10] + (FOLD_HI * d[k + 9] if k else 0)
         for k in range(NLIMB)]
    r[0] += FOLD19_LO * d[19]
    r[1] += FOLD19_HI * d[19]
    once = bound_carry(r)
    out = bound_carry(once)
    return out, max(max(cols), max(d), max(r), max(once), max(out))


def bound_mul(a, b) -> List[int]:
    return bound_mul_steps(a, b)[0]


def bound_add(a, b) -> List[int]:
    return bound_carry([a[i] + b[i] for i in range(NLIMB)])


def bound_sub(a, b) -> List[int]:
    if any(b[i] > K_SUB[i] for i in range(NLIMB)):
        raise ValueError("subtrahend exceeds K_SUB: a + K - b may underflow")
    return bound_carry([a[i] + K_SUB[i] for i in range(NLIMB)])


def bound_mul_small(a, k: int = B3) -> List[int]:
    return bound_carry([k * v for v in a])


def closed_set(max_iter: int = 32) -> List[int]:
    """Least per-limb bound S containing exact-width limbs and closed under
    add, sub, mul and mul_small(B3) of members of S (fixed point)."""
    s = list(MASKS)
    for _ in range(max_iter):
        nxt = [max(v) for v in zip(s, bound_add(s, s), bound_sub(s, s),
                                    bound_mul(s, s), bound_mul_small(s))]
        if nxt == s:
            return s
        s = nxt
    raise ValueError("carried class does not close")


def bound_seq_carry(x: Sequence[int], fold: bool) -> tuple:
    """(maxima, largest intermediate) through one sequential pass."""
    x = list(x)
    peak = max(x)
    for i in range(NLIMB - 1):
        c = x[i] >> WIDTHS[i]
        x[i] = min(x[i], MASKS[i])
        x[i + 1] += c
        peak = max(peak, x[i + 1])
    if fold:
        c = x[9] >> WIDTHS[9]
        x[9] = min(x[9], MASKS[9])
        x[0] += TOP_LO * c
        x[1] += TOP_HI * c
        peak = max(peak, x[0], x[1])
    return x, peak


def certify() -> dict:
    """Check the overflow bounds of the layout; returns the figures."""
    s = closed_set()
    _, mul_peak = bound_mul_steps(s, s)
    narrow = max(max(2 * v for v in s), max(s[i] + K_SUB[i] for i in range(NLIMB)),
                 max(B3 * v for v in s))
    # canonical: the top carry of pass 1 is at most c1; pass 2 leaves at most
    # one more, and pass 3 none, if c1 * 0x1000003D1 < 2^256
    c1 = limbs_to_int(s) >> 256
    x, canon_peak = list(s), 0
    for _ in range(3):
        x, pk = bound_seq_carry(x, fold=True)
        canon_peak = max(canon_peak, pk)
    out = {
        "closed_set": s,
        "max_column": max(bound_mul_cols(s, s)),
        "max_mul_intermediate": mul_peak,
        "max_narrow_intermediate": max(narrow, canon_peak),
        "canonical_top_carry": c1,
    }
    if mul_peak >= 1 << 63:
        raise ValueError(f"plain int64 overflow in mul: {mul_peak} >= 2^63")
    if max(s) >= 1 << 32 or out["max_narrow_intermediate"] >= 1 << 32:
        raise ValueError("kernel uint32 overflow outside mul")
    if any(s[i] > K_SUB[i] for i in range(NLIMB)):
        raise ValueError("K_SUB does not dominate the carried class")
    if c1 * (2**256 - P) >= 2**256:
        raise ValueError("canonical needs more than three passes")
    return out


# ---------------------------------------------------------------------------
# Plain version on int64 tensors (..., 10)
# ---------------------------------------------------------------------------

# column k of the product gathers flat index i*10 + (k-i); 100 is a zero slot
_COL_IDX = torch.tensor(
    [[i * NLIMB + (k - i) if 0 <= k - i < NLIMB else NLIMB * NLIMB
      for i in range(NLIMB)] for k in range(NCOLS)]
)
_SHIFT = torch.tensor(WIDTHS, dtype=torch.int64)
_MASK = torch.tensor(MASKS, dtype=torch.int64)
_KSUB = torch.tensor(K_SUB, dtype=torch.int64)
_FOLD19 = torch.tensor([FOLD19_LO, FOLD19_HI] + [0] * (NLIMB - 2), dtype=torch.int64)

_consts_by_device: dict = {}


def _consts(device: torch.device):
    c = _consts_by_device.get(device)
    if c is None:
        c = tuple(t.to(device) for t in (_COL_IDX, _SHIFT, _MASK, _KSUB, _FOLD19))
        _consts_by_device[device] = c
    return c


def const(value: int, like: torch.Tensor) -> torch.Tensor:
    """The constant ``value`` broadcast to ``like``'s shape."""
    t = torch.tensor(int_to_limbs(value), dtype=torch.int64, device=like.device)
    return t.expand_as(like).clone()


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """Move every column one up; column 0 becomes 0 (the top one drops)."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def carry(t: torch.Tensor) -> torch.Tensor:
    _, shift, mask, _, _ = _consts(t.device)
    c = t >> shift
    c9 = c[..., 9:]
    cin = torch.cat([TOP_LO * c9, c[..., :1] + TOP_HI * c9, c[..., 1:9]], dim=-1)
    return (t & mask) + cin


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + _consts(a.device)[3] - b)


def mul_small(a: torch.Tensor, k: int = B3) -> torch.Tensor:
    return carry(a * k)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    col_idx, _, _, _, fold19 = _consts(a.device)
    a, b = torch.broadcast_tensors(a, b)
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2)
    prod = torch.cat([prod, torch.zeros_like(prod[..., :1])], dim=-1)
    cols = prod[..., col_idx].sum(-1)  # (..., 19)
    cols = torch.cat([cols, torch.zeros_like(cols[..., :1])], dim=-1)  # (..., 20)
    d = (cols & M26) + _shift_up(cols >> RADIX)
    hi = d[..., NLIMB:]  # columns 10..19
    r = (d[..., :NLIMB] + FOLD_LO * hi + _shift_up(FOLD_HI * hi)
         + fold19 * d[..., 2 * NLIMB - 1:])
    return carry(carry(r))


def sq(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def _seq_carry(cols: List[torch.Tensor], fold: bool) -> List[torch.Tensor]:
    for i in range(NLIMB - 1):
        c = cols[i] >> WIDTHS[i]
        cols[i] = cols[i] & MASKS[i]
        cols[i + 1] = cols[i + 1] + c
    if fold:
        c = cols[9] >> WIDTHS[9]
        cols[9] = cols[9] & MASKS[9]
        cols[0] = cols[0] + TOP_LO * c
        cols[1] = cols[1] + TOP_HI * c
    return cols


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Carried x -> the exact-width limbs of x mod p."""
    cols = list(x.unbind(-1))
    for _ in range(3):
        cols = _seq_carry(cols, fold=True)
    # now exact-width limbs, value < 2^256; subtract p iff x + 2^256 - p >= 2^256
    t = list(cols)
    t[0] = t[0] + TOP_LO
    t[1] = t[1] + TOP_HI
    t = _seq_carry(t, fold=False)
    ge = (t[9] >> WIDTHS[9]) > 0
    t[9] = t[9] & MASKS[9]
    return torch.where(ge.unsqueeze(-1), torch.stack(t, -1), torch.stack(cols, -1))
