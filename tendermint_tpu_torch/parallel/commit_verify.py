"""The commit window: a window of heights packed into (heights x validators)
columns, verified in one guarded dispatch, with the per-height int64 quorum
tally on the device.

Counterpart of the JAX package's ``parallel/commit_verify.py`` (state
sync's backfill verifies through it). ``pack_commit_window`` runs the host
prechecks once (lengths, Go's top-bits check on s, key decompression,
cached per key) and scatters the port's K1 + K2 inputs into (H, V)
columns: the keys in the ten-limb layout of ``ops/fe.py``, the raw key,
signature and message bytes. ``verify_commit_window`` dispatches behind the
fault guard (``libs/breaker.py``). The device step (``_verify_window_device``,
the reference's K8 ``_step``) runs K1 -> K2 over the present cells, one
launch each a message-length group, scatters the verdicts into (H, V),
masks them by ``present`` and tallies on the card in torch int64:
``tally = where(ok, power, 0).sum(-1)``, ``committed = 3 tally > 2
total_power``. With ``ed25519_path="msm"`` the window's signatures fold
into one MSM instead (``_verify_window_device_msm``).

Off the card a failed, quarantined or mis-auditing dispatch completes on
the host oracle (``_verify_window_host``) as in the reference; on the card
it raises ``DeviceDispatchError`` (``DeviceAuditMismatch`` after a
quarantine).

With a ``DeviceMesh`` of (height, val) axes (``parallel/mesh.py``) H and V
pad to multiples of the mesh's shape, each (height-block, val-block) shard
runs one K1 + K2 over its present cells and its own int64 tally on its
device, and each height's tally is summed over the val shards on the
mesh's first device (the reference's psum over its ``val`` axis); the
dispatch is labelled "window_mesh". The MSM path does not consult the mesh.
"""

from __future__ import annotations

import math
import random
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.crypto import ed25519 as _ed
from tendermint_tpu_torch.crypto.batch import _resolve_ed25519_path
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.libs import breaker as _brk
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.metrics import get_verify_metrics
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.ops import ed25519_cuda as _k

SigTuple = Tuple[bytes, bytes, bytes]  # (pubkey32, msg, sig64)

# the labels the dispatch metrics carry (the JAX package's default names)
FE_BACKEND, CARRY_MODE = "vpu", "lazy"

@dataclass
class CommitWindow:
    """Packed (H, V) columns of the port's K1 + K2 inputs + the host
    validity mask."""

    neg_ax: np.ndarray  # (H, V, 10) uint32: -x of A
    ay: np.ndarray  # (H, V, 10) uint32: y of A
    pub_bytes: np.ndarray  # (H, V, 32) uint8
    sig_bytes: np.ndarray  # (H, V, 64) uint8
    msg_bytes: np.ndarray  # (H, V, M) uint8, zero past msg_len
    msg_len: np.ndarray  # (H, V) int64
    present: np.ndarray  # (H, V) bool: vote present AND host prechecks ok
    power: np.ndarray  # (H, V) int64 voting power (0 where not present)
    pack_seconds: float = 0.0  # host pack wall time
    # raw signature columns (coords (n, 2) int64, pubs, msgs, sigs): what a
    # failed dispatch completes from off the card and what the audit checks
    # against; references into the caller's vote tuples, not copies
    raw: Optional[tuple] = None

    @property
    def shape(self):
        return self.present.shape


def pack_commit_window(
    votes: Sequence[Sequence[Optional[SigTuple]]],
    powers: Sequence[Sequence[int]],
) -> CommitWindow:
    """votes[h][v] = (pub, msg, sig) or None (absent/nil); powers[h][v] int."""
    t_pack = time.perf_counter()
    H = len(votes)
    V = max((len(row) for row in votes), default=0)
    coords, pubs_l, msgs_l, sigs_l, pows_l = [], [], [], [], []
    for h, row in enumerate(votes):
        for v, item in enumerate(row):
            if item is None:
                continue
            pub, msg, sig = item
            if len(sig) != 64 or len(pub) != 32:
                continue
            coords.append((h, v))
            pubs_l.append(bytes(pub))
            msgs_l.append(bytes(msg))
            sigs_l.append(bytes(sig))
            pows_l.append(powers[h][v])
    M = max((len(m) for m in msgs_l), default=0)
    z = np.zeros
    win = CommitWindow(
        neg_ax=z((H, V, _k.NLIMB), np.uint32),
        ay=z((H, V, _k.NLIMB), np.uint32),
        pub_bytes=z((H, V, 32), np.uint8),
        sig_bytes=z((H, V, 64), np.uint8),
        msg_bytes=z((H, V, M), np.uint8),
        msg_len=z((H, V), np.int64),
        present=z((H, V), bool),
        power=z((H, V), np.int64),
    )
    if coords:
        n = len(coords)
        pubs = np.frombuffer(b"".join(pubs_l), np.uint8).reshape(n, 32)
        sigs = np.frombuffer(b"".join(sigs_l), np.uint8).reshape(n, 64)
        neg_ax, ay, valid = _k._decompress_valset(pubs)
        valid = valid & ((sigs[:, 63] & 224) == 0)  # Go's only s range check
        lens = np.fromiter((len(m) for m in msgs_l), np.int64, n)
        mb = np.zeros((n, M), np.uint8)
        for ln in np.unique(lens):
            g = np.flatnonzero(lens == ln)
            if ln:
                mb[g, :ln] = np.frombuffer(
                    b"".join(msgs_l[i] for i in g), np.uint8).reshape(g.size, ln)
        hv = np.asarray(coords, dtype=np.int64)
        hs, vs = hv[:, 0], hv[:, 1]
        win.neg_ax[hs, vs] = neg_ax
        win.ay[hs, vs] = ay
        win.pub_bytes[hs, vs] = pubs
        win.sig_bytes[hs, vs] = sigs
        win.msg_bytes[hs, vs] = mb
        win.msg_len[hs, vs] = lens
        win.present[hs, vs] = valid
        win.power[hs, vs] = np.where(valid, np.asarray(pows_l, dtype=np.int64), 0)
        win.raw = (hv, pubs_l, msgs_l, sigs_l)
    win.pack_seconds = time.perf_counter() - t_pack
    return win


# device launches of the window tally (torch int64 ops, not a hand-written
# kernel): one a device dispatch on the ladder route
tally_launches = {"window_tally": 0}


def window_tally(ok: torch.Tensor, power: torch.Tensor, total_power: int):
    """The reference's K8 tally on any device, in int64: (H,) tally of the
    power of valid votes and committed = 3 tally > 2 total_power."""
    tally = torch.where(ok, power, torch.zeros_like(power)).sum(-1)
    if ok.is_cuda:
        tally_launches["window_tally"] += 1
    return tally, tally * 3 > 2 * int(total_power)


def _block_verdicts(win: CommitWindow, hs: slice, vs: slice, device: torch.device):
    """K1 -> K2 over the present cells of the block (heights ``hs``, vals
    ``vs``) of the window, one launch each a message-length group, the
    verdicts scattered into the block and masked by ``present``; cells
    past (H, V) (a mesh's padding) are absent. Returns ok (bh, bv) bool and
    power (bh, bv) int64 on ``device``, unsynchronised."""
    H, V = win.shape
    bh, bv = hs.stop - hs.start, vs.stop - vs.start
    h1, v1 = min(hs.stop, H), min(vs.stop, V)
    present = np.zeros((bh, bv), bool)
    power = np.zeros((bh, bv), np.int64)
    present[: h1 - hs.start, : v1 - vs.start] = win.present[hs.start:h1, vs.start:v1]
    power[: h1 - hs.start, : v1 - vs.start] = win.power[hs.start:h1, vs.start:v1]
    cells = np.flatnonzero(present)
    gh, gv = hs.start + cells // bv, vs.start + cells % bv
    lens = win.msg_len[gh, gv]
    ok_d = torch.zeros((bh * bv,), dtype=torch.bool, device=device)
    for ln in np.unique(lens):
        g = lens == ln
        ch, cv = gh[g], gv[g]
        msgs = win.msg_bytes[ch, cv, :ln]
        inputs, _ = _k.packed_inputs(
            win.pub_bytes[ch, cv], [m.tobytes() for m in msgs], win.sig_bytes[ch, cv],
            win.neg_ax[ch, cv], win.ay[ch, cv], win.present[ch, cv], int(ln), device)
        ok_d[torch.from_numpy(cells[g]).to(device)] = \
            _k._device_verify_packed(*inputs)[:ch.size] != 0
    ok = ok_d.view(bh, bv) & torch.from_numpy(present).to(device)
    return ok, torch.from_numpy(power).to(device)


def _read_back(ok: torch.Tensor, tally: torch.Tensor, committed: torch.Tensor, H: int,
               V: int):
    """One synchronisation: the (H, V) verdicts, (H,) int64 tally and (H,)
    committed of a (ph, pv) grid's results."""
    ph, pv = ok.shape
    out = torch.cat([ok.reshape(-1).to(torch.int64), tally,
                     committed.to(torch.int64)]).cpu().numpy()
    return (out[: ph * pv].reshape(ph, pv)[:H, :V] != 0,
            out[ph * pv: ph * pv + H].astype(np.int64), out[ph * pv + ph: ph * pv + ph + H] != 0)


def _window_step(win: CommitWindow, total_power: int, device: torch.device):
    """The whole window as one block (``_block_verdicts``), then
    ``window_tally``; read back with one synchronisation."""
    H, V = win.shape
    ok, power = _block_verdicts(win, slice(0, H), slice(0, V), device)
    return _read_back(ok, *window_tally(ok, power, total_power), H, V)


def _window_step_mesh(win: CommitWindow, total_power: int, mesh):
    """The window padded to multiples of the mesh's (height, val) shape and
    split into one block a mesh device (``DeviceMesh.split_window``): each
    block's K1 -> K2 and its int64 ``window_tally`` over its val columns,
    launched on its own device with no synchronisation between blocks;
    then, on the mesh's first device, each height's tally summed over its
    val blocks (the reference's psum over the val axis) and the strict
    +2/3 compare; read back with one synchronisation."""
    H, V = win.shape
    mh, mv = mesh.window_shape()
    dev = mesh.flat[0]
    blocks = [_block_verdicts(win, hs, vs, d) for d, hs, vs in mesh.split_window(H, V)]
    oks, tallies = [], []
    for ok, power in blocks:
        oks.append(ok)
        tallies.append(window_tally(ok, power, total_power)[0])
    ok = torch.cat([torch.cat([oks[i * mv + j].to(dev) for j in range(mv)], dim=1)
                    for i in range(mh)])
    tally = torch.cat([torch.stack([tallies[i * mv + j].to(dev) for j in range(mv)]).sum(0)
                       for i in range(mh)])
    return _read_back(ok, tally, tally * 3 > 2 * int(total_power), H, V)


def _verify_window_host(
    win: CommitWindow, total_power: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bit-identical host completion of a packed window from the retained
    raw columns, on the port's Go-exact oracle (``_verify_pure``)."""
    H, V = win.shape
    ok = np.zeros((H, V), dtype=bool)
    if win.raw is not None:
        coords, pubs_l, msgs_l, sigs_l = win.raw
        if len(pubs_l):
            res = np.fromiter(
                (_ed._verify_pure(p, m, s) for p, m, s in zip(pubs_l, msgs_l, sigs_l)),
                dtype=bool, count=len(pubs_l),
            )
            ok[coords[:, 0], coords[:, 1]] = res
    ok &= win.present
    tally = np.sum(np.where(ok, win.power, 0), axis=-1).astype(np.int64)
    committed = tally * 3 > np.int64(total_power) * 2
    return ok, tally, committed


_audit_mtx = threading.Lock()
_audit_seq = 0


def _audit_window_verdict(win: CommitWindow, ok: np.ndarray) -> bool:
    """Silent-corruption audit over a window verdict: k seeded-sampled
    present lanes re-verified on the host oracle, the reference's sampling
    (rate, seed ``(audit_seed << 20) ^ seq``, ``rng.sample``). True iff any
    disagrees."""
    cfg = _brk.guard_config()
    rate = cfg.audit_sample_rate
    if rate <= 0 or win.raw is None:
        return False
    coords, pubs_l, msgs_l, sigs_l = win.raw
    cand = [i for i in range(len(pubs_l)) if win.present[coords[i, 0], coords[i, 1]]]
    if not cand:
        return False
    global _audit_seq
    with _audit_mtx:
        seq = _audit_seq
        _audit_seq += 1
    k = min(len(cand), max(1, int(math.ceil(len(cand) * rate))))
    rng = random.Random((cfg.audit_seed << 20) ^ seq)
    lanes = rng.sample(cand, k)
    with trace.span("verify.audit", algo="ed25519", lanes=k):
        bad = [i for i in lanes
               if _ed._verify_pure(pubs_l[i], msgs_l[i], sigs_l[i])
               != bool(ok[coords[i, 0], coords[i, 1]])]
    try:
        m = get_verify_metrics()
        if k - len(bad):
            m.device_audit.add(float(k - len(bad)), ("ok",))
        if bad:
            m.device_audit.add(float(len(bad)), ("mismatch",))
    except Exception:
        pass
    if bad:
        try:
            get_profiler().record_event(
                "audit_mismatch", backend="window", sampled=k,
                mismatches=len(bad), lanes=bad[:8],
            )
        except Exception:
            pass
    return bool(bad)


def _without_device(reason: str, win: CommitWindow, total_power: int, card: bool,
                    cause=None):
    """The window has no device verdict: off the card it completes on the
    host oracle and counts as a fallback; on the card it raises
    ``DeviceDispatchError`` (``DeviceAuditMismatch`` after a quarantine)."""
    if not card:
        try:
            get_verify_metrics().device_fallback.add(1.0, (reason,))
        except Exception:
            pass
    try:
        get_profiler().record_event(
            "device_failure" if card else "device_fallback", reason=reason,
            backend="window", heights=win.shape[0],
        )
    except Exception:
        pass
    if card:
        err = (_brk.DeviceAuditMismatch if reason == "audit_mismatch"
               else _brk.DeviceDispatchError)
        raise err(reason, f"commit window of {win.shape[0]} heights") from cause
    return _verify_window_host(win, total_power)


def verify_commit_window(
    win: CommitWindow, total_power: int, mesh=None, *, device: DeviceLike = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Verify a packed window on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``, which runs the plain versions); returns (ok (H, V)
    bool, tally (H,) int64, committed (H,) bool).

    The dispatch runs behind the fault guard: breaker gate, supervised
    deadline, one bounded retry and the seeded audit, whose mismatch
    quarantines the device path. Where the reference then completes on
    the host oracle, the port does so off the card and raises on it. A
    window without raw columns (built by hand) dispatches unguarded.

    With a ``DeviceMesh`` of (height, val) axes the window splits into one
    block a mesh device (``_window_step_mesh``; ``device`` is then the
    mesh's first) and is labelled "window_mesh"; the MSM path does not
    consult the mesh."""
    dev = mesh.flat[0] if mesh is not None and device is None else resolve_device(device)
    card = dev.type == "cuda" or (mesh is not None and mesh.on_card())
    br = _brk.get_device_breaker()
    cfg = _brk.guard_config()
    if win.raw is None:
        return _verify_window_device(win, total_power, mesh, device=dev)
    if not br.allow():
        reason = "quarantined" if br.state == _brk.QUARANTINED else "breaker_open"
        return _without_device(reason, win, total_power, card)
    attempts = 0
    while True:
        try:
            out = _brk.supervised_call(
                lambda: _verify_window_device(win, total_power, mesh, device=dev),
                cfg.dispatch_deadline, name="commit-window",
            )
        except Exception as e:
            reason = "timeout" if isinstance(e, _brk.DispatchTimeout) else "error"
            br.record_failure(reason)
            attempts += 1
            if attempts <= cfg.retries and br.allow():
                try:
                    get_verify_metrics().device_retries.add(1.0)
                except Exception:
                    pass
                continue
            return _without_device(reason, win, total_power, card, e)
        if _audit_window_verdict(win, out[0]):
            br.quarantine("audit_mismatch:window")
            return _without_device("audit_mismatch", win, total_power, card)
        br.record_success()
        return out


# devices whose MSM route dispatched once: the first pays the warm-up
_msm_warm = set()


def _verify_window_device_msm(
    win: CommitWindow, total_power: int, mesh=None, *, device: torch.device
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One MSM per commit window (``[verify] ed25519_path = "msm"``): the
    raw signature columns fold into one random-linear-combination check
    (``ed25519_cuda.rlc_verify_batch``: K1, K4, and on a reject K1 + K2
    over the window's rows with host chunk RLCs where a row fails); the tally folds on the host, as in the
    reference. The verdicts equal the ladder route's."""
    H, V = win.shape
    coords, pubs_l, msgs_l, sigs_l = win.raw
    n = len(pubs_l)
    first = device not in _msm_warm
    _msm_warm.add(device)
    ok = np.zeros((H, V), dtype=bool)
    t0 = time.perf_counter()
    with trace.span("verify.window_dispatch", backend="window_msm", H=H, V=V, n=n):
        if n:
            pubs = np.frombuffer(b"".join(pubs_l), np.uint8).reshape(n, 32)
            sigs = np.frombuffer(b"".join(sigs_l), np.uint8).reshape(n, 64)
            ok[coords[:, 0], coords[:, 1]] = _k.rlc_verify_batch(
                pubs, msgs_l, sigs, device=device)
    ok &= win.present
    tally = np.sum(np.where(ok, win.power, 0), axis=-1).astype(np.int64)
    committed = tally * 3 > np.int64(total_power) * 2
    dt = time.perf_counter() - t0
    try:
        m = get_verify_metrics()
        m.record_dispatch(
            "window_msm", "ed25519", n, dt,
            rejects=int(np.count_nonzero(win.present & ~ok)), first=first,
            fe_backend=FE_BACKEND, carry_mode=CARRY_MODE, ed25519_path="msm",
        )
        get_profiler().record(
            "window_msm",
            bucket=(H, V),
            lanes_present=n,
            lanes_dispatched=n,
            heights=H,
            pack_seconds=win.pack_seconds,
            run_seconds=dt,
            compiled=first,
            # the upload is about the extended-point pool: two points a
            # signature, 4 coordinates of 10 u32 limbs
            bytes_to_device=n * 2 * 4 * _k.NLIMB * 4,
            fe_backend=FE_BACKEND,
            carry_mode=CARRY_MODE,
            ed25519_path="msm",
            n_windows=1,
            n_devices=1,
        )
    except Exception:
        pass
    return ok, tally, committed


# (mesh, shape, fe backend, carry mode) keys that dispatched once: a new
# shape's first dispatch pays the key upload and the launch warm-up, and
# is recorded as the reference records a compile
_compiled_shapes = set()


def _verify_window_device(
    win: CommitWindow, total_power: int, mesh=None, *, device: torch.device
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The raw (unguarded) device dispatch: the K8 step (over a mesh's
    blocks when one is given), or the MSM route."""
    if win.raw is not None and _resolve_ed25519_path(None) == "msm":
        return _verify_window_device_msm(win, total_power, mesh, device=device)
    H, V = win.shape
    ph, pv = (H, V) if mesh is None else mesh.pad_window(H, V)
    backend = "window" if mesh is None else "window_mesh"
    n_devices = 1 if mesh is None else mesh.size
    shape_key = (mesh, (ph, pv), FE_BACKEND, CARRY_MODE)
    first = shape_key not in _compiled_shapes
    _compiled_shapes.add(shape_key)
    n = int(np.count_nonzero(win.present))
    t0 = time.perf_counter()
    with trace.span("verify.window_dispatch", backend=backend, H=H, V=V, n=n):
        if mesh is None:
            ok, tally, committed = _window_step(win, total_power, device)
        else:
            ok, tally, committed = _window_step_mesh(win, total_power, mesh)
    dt = time.perf_counter() - t0
    try:
        # rejects = votes that passed the host prechecks but failed the
        # device verify
        m = get_verify_metrics()
        m.record_dispatch(
            backend, "ed25519", n, dt,
            rejects=int(np.count_nonzero(win.present & ~ok)), first=first,
            fe_backend=FE_BACKEND, carry_mode=CARRY_MODE, ed25519_path="ladder",
        )
        if mesh is None:
            m.record_device_shards(
                (device.index if device.index is not None else device.type,), H * V)
        else:
            m.record_device_shards(mesh.labels(), ph * pv // n_devices)
        get_profiler().record(
            backend,
            bucket=(ph, pv),
            lanes_present=n,
            lanes_dispatched=ph * pv,
            heights=H,
            pack_seconds=win.pack_seconds,
            run_seconds=dt,
            compiled=first,
            bytes_to_device=sum(a.nbytes for a in (
                win.neg_ax, win.ay, win.pub_bytes, win.sig_bytes, win.msg_bytes,
                win.present, win.power)),
            fe_backend=FE_BACKEND,
            carry_mode=CARRY_MODE,
            ed25519_path="ladder",
            n_windows=1,
            n_devices=n_devices,
        )
    except Exception:
        pass
    return ok, tally, committed
