"""GF(2^255 - 19) field layer of the port: radix 2^25.5, plain version and
overflow-bound certificate.

Layout (shared by the CUDA ladder kernel and the plain version below): ten
limbs, alternately 26 and 25 bits wide, limb i weighing 2^ceil(25.5 i)
(ref10's layout). The kernel holds limbs in ``uint32`` and column sums in
``uint64``; the plain version holds both in ``int64`` tensors with the limbs
on the last axis. The two run the same schedule, so every intermediate is
the same integer:

  * ``mul``: h_k = sum_i a_i * b_{(k-i) mod 10} * W[i][(k-i) mod 10], where
    W is 2 when both indices are odd (the half bits of the radix) and 19
    more when i + j >= 10 (2^255 = 19 mod p); then one sequential carry
    0..9, the carry out of limb 9 folded into limb 0 times 19, and one more
    carry 0 -> 1. The kernel forms 19*b_j and 2*a_i in 32 bits first and
    multiplies 32x32 -> 64 (IMAD.WIDE).
  * ``add`` / ``sub``: limb-wise a + b, or a + K - b with K = 2p spread over
    the limbs (no underflow for carried b), then one parallel carry pass.
  * ``canonical``: three sequential carry-and-fold passes, then one
    conditional subtraction of p.

Every op takes and returns values of the carried class ``closed_set()``: the
per-limb maxima that ``certify()`` proves closed under add, sub and mul,
with every column sum below 2^63 (plain int64) and 2^64 (kernel uint64),
every limb and every premultiplied operand below 2^32. The JAX package's
lazy-carry plan and matrix-unit multipliers schedule carries for the TPU's
vector and matrix units and are not ported.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

P = 2**255 - 19
NLIMB = 10
WIDTHS = tuple(26 if i % 2 == 0 else 25 for i in range(NLIMB))
OFFS = tuple(sum(WIDTHS[:i]) for i in range(NLIMB))
MASKS = tuple((1 << w) - 1 for w in WIDTHS)


def int_to_limbs(x: int) -> List[int]:
    """0 <= x < 2^255 -> ten exact-width limbs."""
    return [(x >> OFFS[i]) & MASKS[i] for i in range(NLIMB)]


def limbs_to_int(limbs: Sequence[int]) -> int:
    """Value of a limb vector (any limb sizes)."""
    return sum(int(v) << OFFS[i] for i, v in enumerate(limbs))


# 2p spread over the limbs: a + K_SUB - b never goes negative for carried b
K_SUB = tuple(2 * m for m in int_to_limbs(P))
assert limbs_to_int(K_SUB) == 2 * P

# product coefficient W[i][j] for a_i * b_j landing in column (i + j) mod 10
W = tuple(
    tuple(
        (2 if i % 2 and j % 2 else 1) * (19 if i + j >= NLIMB else 1)
        for j in range(NLIMB)
    )
    for i in range(NLIMB)
)

# ---------------------------------------------------------------------------
# Overflow-bound certificate over Python ints (per-limb maxima)
# ---------------------------------------------------------------------------


def bound_carry_seq(cols: Sequence[int]) -> tuple:
    """Maxima through mul's carry: returns (out maxima, largest intermediate)."""
    x = list(cols)
    peak = max(x)
    for i in range(NLIMB - 1):
        c = x[i] >> WIDTHS[i]
        x[i] = min(x[i], MASKS[i])
        x[i + 1] += c
        peak = max(peak, x[i + 1])
    c = x[9] >> WIDTHS[9]
    x[9] = min(x[9], MASKS[9])
    x[0] += 19 * c
    peak = max(peak, x[0])
    c = x[0] >> WIDTHS[0]
    x[0] = min(x[0], MASKS[0])
    x[1] += c
    return x, max(peak, x[1])


def bound_carry_par(x: Sequence[int]) -> List[int]:
    c = [x[i] >> WIDTHS[i] for i in range(NLIMB)]
    return [min(x[i], MASKS[i]) + (19 * c[9] if i == 0 else c[i - 1])
            for i in range(NLIMB)]


def bound_mul_cols(a: Sequence[int], b: Sequence[int]) -> List[int]:
    cols = [0] * NLIMB
    for i in range(NLIMB):
        for j in range(NLIMB):
            cols[(i + j) % NLIMB] += a[i] * b[j] * W[i][j]
    return cols


def bound_mul(a, b) -> List[int]:
    return bound_carry_seq(bound_mul_cols(a, b))[0]


def bound_add(a, b) -> List[int]:
    return bound_carry_par([a[i] + b[i] for i in range(NLIMB)])


def bound_sub(a, b) -> List[int]:
    if any(b[i] > K_SUB[i] for i in range(NLIMB)):
        raise ValueError("subtrahend exceeds K_SUB: a + K - b may underflow")
    return bound_carry_par([a[i] + K_SUB[i] for i in range(NLIMB)])


def closed_set(max_iter: int = 16) -> List[int]:
    """Least per-limb bound S containing exact-width limbs and closed under
    add, sub and mul of members of S (fixed point by iteration)."""
    s = list(MASKS)
    for _ in range(max_iter):
        nxt = [max(v) for v in zip(s, bound_add(s, s), bound_sub(s, s),
                                    bound_mul(s, s))]
        if nxt == s:
            return s
        s = nxt
    raise ValueError("carried class does not close")


def certify() -> dict:
    """Check the overflow bounds of the layout; returns the figures."""
    s = closed_set()
    cols = bound_mul_cols(s, s)
    _, carry_peak = bound_carry_seq(cols)
    add_peak = max(s[i] + K_SUB[i] for i in range(NLIMB))
    peak = max(max(cols), carry_peak, add_peak)
    prem = max(max(19 * v for v in s), max(2 * v for v in s))
    out = {
        "closed_set": s,
        "max_column": max(cols),
        "max_intermediate": peak,
        "max_premultiplied": prem,
    }
    if peak >= 1 << 63:
        raise ValueError(f"plain int64 overflow: {peak} >= 2^63")
    if prem >= 1 << 32 or max(s) >= 1 << 32:
        raise ValueError("kernel uint32 operand overflow")
    if any(s[i] > K_SUB[i] for i in range(NLIMB)):
        raise ValueError("K_SUB does not dominate the carried class")
    return out


# ---------------------------------------------------------------------------
# Plain version on int64 tensors (..., 10)
# ---------------------------------------------------------------------------

_IDX = torch.tensor([[(k - i) % NLIMB for i in range(NLIMB)] for k in range(NLIMB)])
_WK = torch.tensor(
    [[W[i][(k - i) % NLIMB] for i in range(NLIMB)] for k in range(NLIMB)],
    dtype=torch.int64,
)
_SHIFT = torch.tensor(WIDTHS, dtype=torch.int64)
_MASK = torch.tensor(MASKS, dtype=torch.int64)
_KSUB = torch.tensor(K_SUB, dtype=torch.int64)

_consts_by_device: dict = {}


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` through ``index_select``. Advanced indexing of the last
    dimension takes torch's CPU thread pool on every call at these shapes,
    which on a loaded host turns a plain field multiply of microseconds into
    milliseconds; ``index_select`` runs on the calling thread."""
    return torch.index_select(x, -1, idx.reshape(-1)).unflatten(-1, idx.shape)


def _consts(device: torch.device):
    c = _consts_by_device.get(device)
    if c is None:
        c = tuple(t.to(device) for t in (_IDX, _WK, _SHIFT, _MASK, _KSUB))
        _consts_by_device[device] = c
    return c


def const(value: int, like: torch.Tensor) -> torch.Tensor:
    """The constant ``value`` broadcast to ``like``'s shape."""
    t = torch.tensor(int_to_limbs(value), dtype=torch.int64, device=like.device)
    return t.expand_as(like).clone()


def _seq_carry(cols: List[torch.Tensor], fold: bool) -> List[torch.Tensor]:
    for i in range(NLIMB - 1):
        c = cols[i] >> WIDTHS[i]
        cols[i] = cols[i] & MASKS[i]
        cols[i + 1] = cols[i + 1] + c
    if fold:
        c = cols[9] >> WIDTHS[9]
        cols[9] = cols[9] & MASKS[9]
        cols[0] = cols[0] + 19 * c
    return cols


def carry_par(x: torch.Tensor) -> torch.Tensor:
    _, _, shift, mask, _ = _consts(x.device)
    c = x >> shift
    cin = torch.cat([c[..., 9:] * 19, c[..., :9]], dim=-1)
    return (x & mask) + cin


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry_par(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry_par(a + _consts(a.device)[4] - b)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    idx, wk, _, _, _ = _consts(a.device)
    a, b = torch.broadcast_tensors(a, b)
    cols = (a.unsqueeze(-2) * gather_last(b, idx) * wk).sum(-1)
    out = _seq_carry(list(cols.unbind(-1)), fold=True)
    c = out[0] >> WIDTHS[0]
    out[0] = out[0] & MASKS[0]
    out[1] = out[1] + c
    return torch.stack(out, dim=-1)


def sq(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def stacked(mul_fn, *pairs):
    """Independent products (a, b) in one call of a field's ``mul_fn`` (this
    module's ``mul`` or ``fe_secp256k1.mul``) over a new leading axis, the
    operands broadcast to one shape: each result is the same integer as its
    own call, in a fraction of the plain version's per-op overhead."""
    shape = torch.broadcast_shapes(*(t.shape for pair in pairs for t in pair))
    a = torch.stack([x.expand(shape) for x, _ in pairs])
    b = torch.stack([y.expand(shape) for _, y in pairs])
    return mul_fn(a, b).unbind(0)


def _sqn(a: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        a = sq(a)
    return a


def inv(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2) by ref10's chain: 254 squarings, 11 multiplications."""
    t0 = sq(z)
    t1 = mul(z, _sqn(t0, 2))
    t0 = mul(t0, t1)
    t1 = mul(t1, sq(t0))  # 2^5 - 1
    t1 = mul(_sqn(t1, 5), t1)  # 2^10 - 1
    t2 = mul(_sqn(t1, 10), t1)  # 2^20 - 1
    t2 = mul(_sqn(t2, 20), t2)  # 2^40 - 1
    t1 = mul(_sqn(t2, 10), t1)  # 2^50 - 1
    t2 = mul(_sqn(t1, 50), t1)  # 2^100 - 1
    t2 = mul(_sqn(t2, 100), t2)  # 2^200 - 1
    t1 = mul(_sqn(t2, 50), t1)  # 2^250 - 1
    return mul(_sqn(t1, 5), t0)  # 2^255 - 21


INV_MULS, INV_SQUARINGS = 11, 254  # field operations in inv()


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Carried x -> the exact-width limbs of x mod p."""
    cols = list(x.unbind(-1))
    for _ in range(3):
        cols = _seq_carry(cols, fold=True)
    # now exact-width limbs, value < 2^255; subtract p iff x + 19 >= 2^255
    t = list(cols)
    t[0] = t[0] + 19
    t = _seq_carry(t, fold=False)
    ge = (t[9] >> WIDTHS[9]) > 0
    t[9] = t[9] & MASKS[9]
    return torch.where(ge.unsqueeze(-1), torch.stack(t, -1), torch.stack(cols, -1))
