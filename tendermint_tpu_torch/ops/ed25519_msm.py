"""One MSM per window: the random-linear-combination (RLC) verify path on the
H100 — the host schedule, K4's plain versions and its wrapper, and the
window's host side with its localization.

Counterpart of the JAX package's ``ops/ed25519_msm.py``. A batch of parsed
rows (-A_i, -R_i, h_i, s_i) is accepted at once iff

    [sum z_i s_i]B + sum_i [(z_i h_i) mod L](-A_i) + sum_i [z_i](-R_i)
        == identity

with 128-bit z_i drawn from ``random.Random(seed)`` in row order. The host
resolves Pippenger's data-dependent bucket sums into index schedules
(``_build_schedule``, numpy, equal to the reference's): a pool of extended
points (row 0 the identity, rows 1..2n the -A_i / -R_i columns), one list
of pair indices a tree level, and a bucket grid of global rows. K4
(``csrc/ed25519_msm.cu``) runs the levels, the bucket fold, [s_b]B off a
fixed-base comb, Horner over the windows, and answers one verdict. It has
two plain versions. ``msm_ref`` is the reference's ``_msm_kernel`` step by
step over this port's ten-limb field (``ops/fe.py``) and point formulas
(``ed25519_cuda._pt_add`` / ``_pt_double`` / ``_pt_madd``): its serial
bucket fold and [s_b]B off the 16-entry niels table. ``msm_plain`` is the
kernel's own schedule (the fold as a suffix scan and a tree, [s_b]B as the
comb's tree), so every intermediate is the kernel's integer and the
kernel is held to it limb for limb; it reaches the same group element as
``msm_ref`` through other projective representatives, and the same verdict.
Both return the final point's canonical limbs.

A rejected window resolves (``rlc_resolve``) to the reference's verdicts
with the reference's draws: one call of the exact per-row path
(``ladder_fn``: K1 + K2) over every parsed row, and the seeded host chunk
RLC of ``crypto.ed25519._CHUNK`` rows only where a chunk holds a row that
call rejects.
"""

from __future__ import annotations

import ctypes
import functools
import random
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.crypto import ed25519 as _ed
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.ops import ed25519_cuda as _ec
from tendermint_tpu_torch.ops import fe

P = _ed.P
L = _ed.L
NLIMB = fe.NLIMB

# MSB-first 4-bit digit count of s_b (s_b < L < 2^253; 64 digits = 256 bits)
_SB_WIN = 64

_IDENT_LIMBS = np.zeros((4, NLIMB), dtype=np.uint32)
_IDENT_LIMBS[1, 0] = 1  # (X, Y, Z, T) = (0, 1, 1, 0)
_IDENT_LIMBS[2, 0] = 1


# ---------------------------------------------------------------------------
# The host schedule (numpy; equal to the reference's)
# ---------------------------------------------------------------------------


def _pad_width(x: int, cap: int = 1024, floor: int = 8) -> int:
    """Power-of-two up to ``cap`` then cap-multiples: the reference's level
    width ladder, kept so that the schedules are equal."""
    b = floor
    while b < x and b < cap:
        b *= 2
    if x <= b:
        return b
    return ((x + cap - 1) // cap) * cap


def _digit_matrix(scalars: Sequence[int], c: int, nwin: int) -> np.ndarray:
    """(m, nwin) c-bit digit matrix, LSB window first, vectorized."""
    m = len(scalars)
    nbytes = (nwin * c + 7) // 8
    buf = np.frombuffer(
        b"".join(int(k).to_bytes(nbytes, "little") for k in scalars), np.uint8
    ).reshape(m, nbytes)
    bits = np.unpackbits(buf, axis=1, bitorder="little")[:, : nwin * c]
    w = 1 << np.arange(c, dtype=np.uint32)
    return bits.reshape(m, nwin, c).astype(np.uint32) @ w


def _bucket_c(m: int) -> int:
    """Pippenger window width from the pair count (the host ``_msm``'s)."""
    return 4 if m < 32 else 5 if m < 128 else 6 if m < 512 else 7 if m < 2048 else 8


class _Schedule:
    """Index schedules for one MSM (all host numpy)."""

    __slots__ = ("c", "nwin", "ias", "ibs", "bkt")

    def __init__(self, c, nwin, ias, ibs, bkt):
        self.c = c
        self.nwin = nwin
        self.ias = ias  # [(M_l,) int32] per tree level, indices into level l-1
        self.ibs = ibs
        self.bkt = bkt  # (nwin, 2^c - 1) int32 into [pool, lvl1..lvlT]


def _build_schedule(digits: np.ndarray, pool_rows: int, c: int) -> _Schedule:
    """Resolve the bucket segmented reduction into per-level pair indices.

    ``digits`` is the (m, nwin) matrix of pair digits; pair j's point lives
    at pool row j+1 (row 0 is the identity). Entries of one bucket pair up
    level by level, an odd leftover rides through paired with row 0, and a
    bucket reduced to one row stays in that level. Every level's row 0 is
    the (0, 0) identity anchor that odd leftovers and pad rows pair
    against."""
    m, nwin = digits.shape
    nb = (1 << c) - 1
    pj, pw = np.nonzero(digits)
    dg = digits[pj, pw].astype(np.int64)
    bucket = pw.astype(np.int64) * nb + (dg - 1)
    order = np.argsort(bucket, kind="stable")
    bucket = bucket[order]
    src = (pj[order] + 1).astype(np.int64)
    ub, seg_start = np.unique(bucket, return_index=True)
    seg_sizes = np.diff(np.append(seg_start, len(bucket)))

    finalized: dict = {}
    active: List[Tuple[int, List[int]]] = []
    for si in range(len(ub)):
        mem = src[seg_start[si]: seg_start[si] + seg_sizes[si]].tolist()
        if len(mem) == 1:
            finalized[si] = (0, mem[0])  # lives in the pool
        else:
            active.append((si, mem))

    ias: List[np.ndarray] = []
    ibs: List[np.ndarray] = []
    lvl = 0
    while active:
        lvl += 1
        ia = [0]
        ib = [0]
        nxt = []
        for si, mem in active:
            new_rows = []
            for k in range(0, len(mem) - 1, 2):
                new_rows.append(len(ia))
                ia.append(mem[k])
                ib.append(mem[k + 1])
            if len(mem) % 2:
                new_rows.append(len(ia))
                ia.append(mem[-1])
                ib.append(0)
            if len(new_rows) == 1:
                finalized[si] = (lvl, new_rows[0])
            else:
                nxt.append((si, new_rows))
        width = _pad_width(len(ia))
        ia += [0] * (width - len(ia))
        ib += [0] * (width - len(ib))
        ias.append(np.asarray(ia, np.int32))
        ibs.append(np.asarray(ib, np.int32))
        active = nxt

    # global row offsets of each level inside the concatenated row buffer
    offs = [pool_rows]
    for a in ias[:-1]:
        offs.append(offs[-1] + len(a))
    bkt = np.zeros((nwin, nb), np.int64)  # 0 = identity (empty bucket)
    for si, b in enumerate(ub):
        w, dm1 = divmod(int(b), nb)
        flvl, frow = finalized[si]
        bkt[w, dm1] = frow if flvl == 0 else offs[flvl - 1] + frow
    return _Schedule(c, nwin, ias, ibs, bkt.astype(np.int32))


def schedule_adds(sched: _Schedule) -> Tuple[int, int]:
    """(point additions the tree needs, the fold's): one a paired or
    odd-leftover entry of a level (its anchor row 0 and pad rows are not
    needed work), and 2 (2^c - 1) a window."""
    tree = sum(int(np.count_nonzero(a)) for a in sched.ias)
    nwin, nb = sched.bkt.shape
    return tree, 2 * nb * nwin


# ---------------------------------------------------------------------------
# Plain versions of K4
# ---------------------------------------------------------------------------


def _unpack(a: torch.Tensor):
    return tuple(a[..., k, :] for k in range(4))


def _pack(p) -> torch.Tensor:
    return torch.stack(p, dim=-2)


def _ident(device: torch.device, *lead: int) -> torch.Tensor:
    """The identity (0 : 1 : 1 : 0), int64 limbs, shaped (*lead, 4, 10)."""
    ident = torch.from_numpy(_IDENT_LIMBS.astype(np.int64)).to(device)
    return ident.expand(*lead, 4, NLIMB)


def _tree_levels(pool, ias, ibs, d2) -> torch.Tensor:
    """The segmented pairwise-reduction tree, one batched add a level: the
    pool and every level's rows, in the order the bucket grid addresses."""
    prev = _ec._u32(pool)
    levels = [prev]
    for ia, ib in zip(ias, ibs):
        ia, ib = ia.to(torch.int64), ib.to(torch.int64)
        prev = _pack(_ec._pt_add(_unpack(prev[ia]), _unpack(prev[ib]), d2))
        levels.append(prev)
    return torch.cat(levels, dim=0)


def _finish(tot, sb, d2, device):
    """tot + sb, canonical; (int32 ok (1,), int32 limbs (4, 10))."""
    final = _pack(tuple(fe.canonical(v) for v in _ec._pt_add(tot, sb, d2)))[0]
    X, Y, Z, _ = final
    ok = bool((X == 0).all()) and bool((Y == Z).all())
    return (torch.tensor([int(ok)], dtype=torch.int32, device=device),
            final.to(torch.int32))


def _horner(acc, c: int, d2):
    """Horner over the window sums (nwin, 4, 10), top first: c doublings
    and one add a step."""
    nwin = acc.shape[0]
    tot = _unpack(acc[nwin - 1: nwin])
    for t in range(nwin - 1):
        for _ in range(c):
            tot = _ec._pt_double(tot)
        tot = _ec._pt_add(tot, _unpack(acc[nwin - 2 - t: nwin - 1 - t]), d2)
    return tot


def msm_ref(pool, ias, ibs, bkt, sb_digs):
    """Plain version of the reference's ``_msm_kernel``, step by step:
    pool (R0, 4, 10), ias / ibs lists of (M_l,), bkt (nwin, 2^c - 1),
    sb_digs (64,), all int32 (u32 bit patterns). Returns int32 ok (1,) and
    the final point's canonical limbs (4, 10)."""
    consts = _ec._u32(_ec._consts_on(pool.device))
    niels = consts[: 16 * 3 * NLIMB].reshape(16, 3, NLIMB)
    d2 = consts[16 * 3 * NLIMB:]
    nwin, nb = bkt.shape
    c = (nb + 1).bit_length() - 1
    grid = _tree_levels(pool, ias, ibs, d2)[bkt.to(torch.int64)]  # (nwin, nb, 4, 10)

    # bucket-weighted fold at width nwin: descending run/acc accumulation
    run = acc = _unpack(_ident(pool.device, nwin))
    for t in range(nb):
        run = _ec._pt_add(run, _unpack(grid[:, nb - 1 - t]), d2)
        acc = _ec._pt_add(acc, run, d2)
    tot = _horner(_pack(acc), c, d2)

    # [s_b]B off the niels table: 4 doublings + 1 mixed add a digit
    sb = _unpack(_ident(pool.device, 1))
    digs = _ec._u32(sb_digs).tolist()
    for t in range(_SB_WIN):
        for _ in range(4):
            sb = _ec._pt_double(sb)
        ent = niels[digs[t] & 15][None]
        sb = _ec._pt_madd(sb, ent[:, 0], ent[:, 1], ent[:, 2])
    return _finish(tot, sb, d2, pool.device)


_dev_comb: Dict[torch.device, torch.Tensor] = {}


@functools.lru_cache(maxsize=None)
def comb_table() -> np.ndarray:
    """K4's comb for [s_b]B, (64, 16, 3, 10) uint32 limbs: position i holds
    the niels entries (y+x, y-x, 2dxy) of [d 16^i]B, d = 0..15 (the
    identity at d = 0; position 0 is the ladder's niels table). Built at
    first use from the bigints of ``crypto.ed25519``: [16^i]B and its
    multiples by additions, each made affine."""
    out = np.zeros((_SB_WIN, 16, 3, NLIMB), np.uint32)
    base = _ed.B_EXT
    for i in range(_SB_WIN):
        acc = _ed.IDENT
        for d in range(16):
            x, y = _ed.pt_affine(acc)
            out[i, d] = (fe.int_to_limbs((y + x) % P), fe.int_to_limbs((y - x) % P),
                         fe.int_to_limbs(2 * _ed.D * x * y % P))
            acc = _ed.pt_add(acc, base)
        base = acc  # [16 * 16^i]B
    return out


def _comb_on(device: torch.device) -> torch.Tensor:
    t = _dev_comb.get(device)
    if t is None:
        t = _dev_comb[device] = _ec._put(comb_table().reshape(-1), device)
    return t


def tree_sum(x, d2):
    """Sum of the points along dim -3 of ``x`` (..., n, 4, 10) as K4 takes
    it: pairs (2j, 2j + 1) a level, an odd last point carried as it is."""
    while x.shape[-3] > 1:
        h = x.shape[-3] // 2
        pairs = _pack(_ec._pt_add(_unpack(x[..., 0: 2 * h: 2, :, :]),
                                  _unpack(x[..., 1: 2 * h: 2, :, :]), d2))
        x = torch.cat([pairs, x[..., 2 * h:, :, :]], dim=-3)
    return x[..., 0, :, :]


def fold_plain(grid, d2):
    """K4's bucket fold of the grid (nwin, nb, 4, 10), bucket d at column
    d - 1: the suffix sums S_t = sum_{d >= t} B_d by doubling steps
    (x[t] += x[t + o] for o = 1, 2, 4, ...), then their tree sum, which is
    sum_d d B_d. Returns (nwin, 4, 10)."""
    nb = grid.shape[1]
    x, o = grid, 1
    while o < nb:
        head = _pack(_ec._pt_add(_unpack(x[:, : nb - o]), _unpack(x[:, o:]), d2))
        x = torch.cat([head, x[:, nb - o:]], dim=1)
        o *= 2
    return tree_sum(x, d2)


def comb_plain(sb_digs, d2):
    """K4's [s_b]B: the identity plus [d_i 16^i]B at each of the 64
    positions (one mixed add each), then their tree sum. Returns (4, 10)."""
    comb = _ec._u32(_comb_on(sb_digs.device)).reshape(_SB_WIN, 16, 3, NLIMB)
    digs = _ec._u32(sb_digs).flip(0) & 15  # position i weighs 16^i
    ent = comb[torch.arange(_SB_WIN, device=sb_digs.device), digs]  # (64, 3, 10)
    pts = _ec._pt_madd(_unpack(_ident(sb_digs.device, _SB_WIN)), ent[:, 0], ent[:, 1], ent[:, 2])
    return tree_sum(_pack(pts), d2)


def msm_plain(pool, ias, ibs, bkt, sb_digs):
    """Plain version of K4 on the kernel's own schedule: the reference's
    tree, ``fold_plain``, ``comb_plain``, Horner and the final add. Inputs
    and outputs as ``msm_ref``'s; the verdict is its verdict and the point
    its point as a group element."""
    d2 = _ec._u32(_ec._consts_on(pool.device))[16 * 3 * NLIMB:]
    nwin, nb = bkt.shape
    c = (nb + 1).bit_length() - 1
    grid = _tree_levels(pool, ias, ibs, d2)[bkt.to(torch.int64)]
    tot = _horner(fold_plain(grid, d2), c, d2)
    return _finish(tot, _unpack(comb_plain(sb_digs, d2)[None]), d2, pool.device)


def fold_adds(nb: int) -> Tuple[int, int]:
    """(additions of K4's suffix scan, of its tree sum) for one window of
    nb buckets; the reference's run/acc fold takes 2 nb."""
    scan, o = 0, 1
    while o < nb:
        scan += nb - o
        o *= 2
    return scan, nb - 1


def chain_ops(sched: _Schedule) -> Dict[str, int]:
    """The longest chain of dependent point operations in K4, by part, and
    the reference schedule's: a tree level is one addition deep; the fold
    log2(nb + 1) scan steps and as many tree levels (the reference's 2 nb);
    [s_b]B one mixed add and 6 tree levels beside the fold (the reference's
    64 x (4 doublings + 1 mixed add) beside Horner); Horner (nwin - 1)
    (c + 1); then the final addition."""
    nwin, nb = sched.bkt.shape
    steps = (nb + 1).bit_length() - 1
    levels, horner = len(sched.ias), (nwin - 1) * (sched.c + 1)
    fold, comb = 2 * steps, 1 + (_SB_WIN - 1).bit_length()
    return {"levels": levels, "fold": fold, "comb": comb, "horner": horner,
            "total": levels + max(fold, comb) + horner + 1,
            "reference_total": levels + 2 * nb + max(horner, 5 * _SB_WIN) + 1}


def same_point(pt, want) -> bool:
    """Canonical (4, 10) limbs ``pt`` and ``want`` (canonical limbs too, or
    an extended point of ints) are one group element: their affine
    coordinates cross-multiplied. K4's schedule reaches the reference's
    element through other projective representatives."""
    if isinstance(want, torch.Tensor):
        want = tuple(fe.limbs_to_int(want[k].tolist()) for k in range(3))
    X, Y, Z = (fe.limbs_to_int(pt[k].tolist()) for k in range(3))
    x, y, z = want[:3]
    return (X * z - x * Z) % P == 0 and (Y * z - y * Z) % P == 0


# ---------------------------------------------------------------------------
# K4's wrapper
# ---------------------------------------------------------------------------

# launches of K4, one a MSM dispatch; its sub-launches are counted beside it
launches: Dict[str, int] = {"ed25519_msm": 0}
sub_launches: Dict[str, int] = {"msm_level": 0, "msm_fold": 0, "msm_finish": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # rows, ia, ib, consts, src, dst, m, stream
    "msm_level": [_P, _P, _P, _P, _LL, _LL, _I, _P],
    # rows, bkt, sb_digs, consts, comb, acc, sb, nwin, nb, stream
    "msm_fold": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # acc, sb, consts, ok, pt, nwin, c, stream
    "msm_finish": [_P, _P, _P, _P, _P, _I, _I, _P],
}


def reset_launches() -> None:
    for d in (launches, sub_launches):
        for k in d:
            d[k] = 0


def _sub_launch(name: str, dev: torch.device, *args) -> None:
    _ec.launch_kernel(name, _SIGNATURES[name], sub_launches, dev, *args,
                      lib="ed25519_msm")


def _check_inputs(pool, ias, ibs, bkt, sb_digs) -> None:
    r0 = pool.shape[0]
    _ec._check("pool", pool, (r0, 4, NLIMB))
    if len(ias) != len(ibs):
        raise ValueError(f"{len(ias)} ia levels, {len(ibs)} ib levels")
    for l, (ia, ib) in enumerate(zip(ias, ibs)):
        _ec._check(f"ia[{l}]", ia, (ia.shape[0],))
        _ec._check(f"ib[{l}]", ib, (ia.shape[0],))
    nwin, nb = bkt.shape
    if nwin < 1 or nb < 1 or (nb + 1) & nb:
        raise ValueError(f"bad bucket grid {tuple(bkt.shape)}")
    if nb > 255:
        raise ValueError(f"K4 takes windows of at most 8 bits, not {nb + 1}")
    _ec._check("bkt", bkt, (nwin, nb))
    _ec._check("sb_digs", sb_digs, (_SB_WIN,))


def level_spans(ias, r0: int) -> List[Tuple[int, int]]:
    """(first row read, first row written) of each tree level in the row
    buffer: level 1 reads the pool, level l + 1 the rows level l wrote."""
    spans, src, dst = [], 0, r0
    for ia in ias:
        spans.append((src, dst))
        src, dst = dst, dst + int(ia.shape[0])
    return spans


def msm_level(rows, ia, ib, src: int, dst: int) -> None:
    """One tree level of K4: rows[dst + r] = rows[src + ia[r]] + rows[src + ib[r]]."""
    _sub_launch("msm_level", rows.device, rows.data_ptr(), ia.data_ptr(), ib.data_ptr(),
                _ec._consts_on(rows.device).data_ptr(), src, dst, ia.shape[0])


def msm_levels(rows, ias, ibs, r0: int) -> None:
    """K4's tree into ``rows`` (the pool in its first r0 rows): one
    ``msm_level`` launch a level."""
    for ia, ib, (src, dst) in zip(ias, ibs, level_spans(ias, r0)):
        msm_level(rows, ia, ib, src, dst)


def msm_fold(rows, bkt, sb_digs):
    """K4's bucket folds and [s_b]B: (nwin, 40) int32 window sums, (40,)
    int32 [s_b]B."""
    nwin, nb = bkt.shape
    dev = rows.device
    acc = torch.empty((nwin, 4 * NLIMB), dtype=torch.int32, device=dev)
    sb = torch.empty((4 * NLIMB,), dtype=torch.int32, device=dev)
    _sub_launch("msm_fold", dev, rows.data_ptr(), bkt.data_ptr(), sb_digs.data_ptr(),
                _ec._consts_on(dev).data_ptr(), _comb_on(dev).data_ptr(), acc.data_ptr(),
                sb.data_ptr(), nwin, nb)
    return acc, sb


def msm_finish(acc, sb, c: int):
    """K4's Horner, the final addition and check: int32 ok (1,), point (4, 10)."""
    ok = torch.empty((1,), dtype=torch.int32, device=acc.device)
    pt = torch.empty((4, NLIMB), dtype=torch.int32, device=acc.device)
    _sub_launch("msm_finish", acc.device, acc.data_ptr(), sb.data_ptr(),
                _ec._consts_on(acc.device).data_ptr(), ok.data_ptr(), pt.data_ptr(),
                acc.shape[0], c)
    return ok, pt


def msm_rows(pool, ias) -> torch.Tensor:
    """The row buffer K4's levels write: the pool, then every level."""
    r0 = pool.shape[0]
    rows = torch.empty((r0 + sum(int(a.shape[0]) for a in ias), 4 * NLIMB),
                       dtype=torch.int32, device=pool.device)
    rows[:r0].copy_(pool.reshape(r0, 4 * NLIMB))
    return rows


def msm(pool, ias, ibs, bkt, sb_digs):
    """K4. CPU tensors take ``msm_plain``; CUDA tensors launch the kernel's
    parts on the current stream (no synchronisation) and count one launch.
    Returns int32 ok (1,) and the final point's canonical limbs."""
    ins = (pool, *ias, *ibs, bkt, sb_digs)
    if _ec._on_cpu(ins):
        return msm_plain(pool, ias, ibs, bkt, sb_digs)
    _check_inputs(pool, ias, ibs, bkt, sb_digs)
    rows = msm_rows(pool, ias)
    msm_levels(rows, ias, ibs, pool.shape[0])
    acc, sb = msm_fold(rows, bkt, sb_digs)
    out = msm_finish(acc, sb, (bkt.shape[1] + 1).bit_length() - 1)
    launches["ed25519_msm"] += 1
    return out


# ---------------------------------------------------------------------------
# Host side: one window RLC + chunk/ladder localization
# ---------------------------------------------------------------------------


def _limbs(values: Sequence[int]) -> np.ndarray:
    """Field values < 2^255 -> (n, 10) exact-width uint32 limbs."""
    buf = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in values),
                        np.uint8).reshape(len(values), 32)
    return _ec._bytes_to_raw_limbs(buf)


def _pack_pool(pts, pool_rows: int) -> np.ndarray:
    """(pool_rows, 4, 10) uint32: row 0 the identity, row j + 1 the point
    pts[j] (affine, Z = 1), the pad rows zero."""
    pool = np.zeros((pool_rows, 4, NLIMB), np.uint32)
    pool[0] = _IDENT_LIMBS
    m = len(pts)
    if m:
        pool[1: m + 1, 0] = _limbs([p[0] for p in pts])
        pool[1: m + 1, 1] = _limbs([p[1] for p in pts])
        pool[1: m + 1, 2, 0] = 1
        pool[1: m + 1, 3] = _limbs([p[3] for p in pts])
    return pool


def _sb_digits(s_b: int) -> np.ndarray:
    """The 64 MSB-first 4-bit digits of s_b."""
    return np.asarray([(s_b >> (4 * (_SB_WIN - 1 - t))) & 15 for t in range(_SB_WIN)],
                      np.uint32)


def rlc_inputs(rows, rng: random.Random):
    """One RLC over parsed rows [(neg_a, neg_r, h, s), ...]: the z draws
    from ``rng`` (one ``getrandbits(128) or 1`` a row, in row order), the
    schedule and the pool. Returns (schedule, pool, sb_digs) as numpy."""
    n = len(rows)
    m = 2 * n
    c = _bucket_c(m)
    nwin = (253 + c - 1) // c
    s_b = 0
    scalars: List[int] = []
    pts = []
    for neg_a, neg_r, h, s in rows:
        z = rng.getrandbits(128) or 1
        s_b = (s_b + z * s) % L
        scalars.append((z * h) % L)
        pts.append(neg_a)
        scalars.append(z)
        pts.append(neg_r)
    with trace.span("msm.schedule", m=m, c=c):
        digits = _digit_matrix(scalars, c, nwin)
        pool_rows = _pad_width(m + 1)
        sched = _build_schedule(digits, pool_rows, c)
    with trace.span("msm.pool", rows=pool_rows):
        pool = _pack_pool(pts, pool_rows)
    return sched, pool, _sb_digits(s_b)


def device_inputs(sched: _Schedule, pool: np.ndarray, sb_digs: np.ndarray,
                  device: torch.device):
    """``msm``'s five inputs on ``device``."""
    return (_ec._put(pool, device), [_ec._put(a, device) for a in sched.ias],
            [_ec._put(b, device) for b in sched.ibs], _ec._put(sched.bkt, device),
            _ec._put(sb_digs, device))


def _device_rlc(rows, rng: random.Random, device: torch.device) -> bool:
    """One RLC over parsed rows as a single K4 dispatch on ``device``."""
    sched, pool, sb_digs = rlc_inputs(rows, rng)
    with trace.span("msm.k4", rows=pool.shape[0], levels=len(sched.ias)):
        ok, _ = msm(*device_inputs(sched, pool, sb_digs, device))
        return bool(ok[0].item())


def _chunk_rlc_holds(chunk, rng: random.Random) -> bool:
    """Seeded host chunk RLC (``crypto.ed25519._rlc_holds`` with this rng):
    a 32-row Pippenger on the host, deterministic under the window seed."""
    s_b = 0
    pairs = []
    for _, neg_a, neg_r, h, s in chunk:
        z = rng.getrandbits(128) or 1
        s_b = (s_b + z * s) % L
        pairs.append(((z * h) % L, neg_a))
        pairs.append((z, neg_r))
    acc = _ed._msm(pairs)
    return _ed._is_identity(_ed.pt_add(acc, _ed._mul_b(s_b)))


def rlc_resolve(parsed: list, out: list, ladder_fn: Callable[[List[int]], np.ndarray],
                *, seed: int, device: DeviceLike = None) -> None:
    """Verdicts for one window: a K4 accept sets every parsed row; on a
    reject, ``ladder_fn`` (the exact per-row path) checks every parsed row
    in one call, and chunks of ``_CHUNK`` rows resolve as the reference's
    host chunk RLCs do: a chunk whose RLC holds is accepted, any other
    takes the ladder's verdicts. The RLC runs only on a chunk with a row
    the ladder rejects; a chunk the ladder accepts whole ends accepted
    either way and only draws its coefficients, so the draws, and every
    later chunk's RLC, stay the reference's. ``parsed`` / ``out`` as
    ``crypto.ed25519._parse_batch``; mutates ``out`` in place."""
    if not parsed:
        return
    dev = resolve_device(device)
    rng = random.Random(seed)
    rows = [(na, nr, h, s) for (_, na, nr, h, s) in parsed]
    if _device_rlc(rows, rng, dev):
        for item in parsed:
            out[item[0]] = True
        return
    with trace.span("msm.localize", n=len(parsed)):
        ok = np.asarray(ladder_fn([item[0] for item in parsed]), dtype=bool)
        for lo in range(0, len(parsed), _ed._CHUNK):
            chunk = parsed[lo: lo + _ed._CHUNK]
            if len(chunk) > 4 and ok[lo: lo + len(chunk)].all():
                for _ in chunk:  # the draws of _chunk_rlc_holds
                    rng.getrandbits(128)
                held = True
            else:
                held = len(chunk) > 4 and _chunk_rlc_holds(chunk, rng)
            for j, item in enumerate(chunk):
                out[item[0]] = held or bool(ok[lo + j])
