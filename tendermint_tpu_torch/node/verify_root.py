"""The configuration root of the verify path.

Counterpart of the ``[verify]`` wiring in the JAX package's node
(``node/node.py:172-191``): one call takes a ``VerifyConfig`` and

  1. resolves the device (``cuda`` unless the caller passes ``"cpu"``;
     with no device given and no CUDA present it raises
     ``NoCudaDeviceError``) and validates the knobs (``ed25519_path`` is
     "ladder" or "msm");
  2. builds every kernel the path launches (K1, K2, K3, and K4 for the
     MSM path, whichever path is configured: ``TM_ED25519_PATH`` can
     switch it later) with
     ``ops/_build.build_all`` before any guarded call, so that no first
     dispatch pays ``nvcc`` under the dispatch deadline (a build that ran
     into the deadline would become a timeout and a host fallback hiding
     the kernel); a build error raises out of here;
  3. configures the process-wide guard (``configure_device_guard``), the
     planner (``configure_planner``) and the process-wide verify path
     (``set_default_ed25519_path``, which the planner's executor and the
     commit window read);
  4. installs ``GuardedBatchVerifier(TorchBatchVerifier(device))`` as the
     default verifier (with the fe backend, carry schedule and verify path
     it records) and the planner's device executor on the same device.
     On the card both raise ``DeviceDispatchError`` where the reference
     would complete a failed dispatch on the host.

``vote_feed(cfg)`` builds the live-vote micro-batcher the reference's node
wires when ``[verify] vote_batch_window_ms > 0`` (``node/node.py:254-262``),
``mempool(cfg, proxy_app, app)`` the mempool of the ``[mempool]``
section with its batched CheckTx signature hook (``node/node.py:200-219``
and ``:263-283``), and ``block_executor(...)`` the evidence pool and the
block executor that owns that mempool (``node/node.py:220-230``), whose
``apply_block`` verifies each LastCommit through the installed verifier.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, NamedTuple, Optional

import torch

from tendermint_tpu_torch.config.mempool import MempoolConfig
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import batch as _batch
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.libs import breaker as _brk
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.mempool.tx_verify import BatchTxVerifier
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.state.execution import BlockExecutor

# the kernels of the verify path: K1 and K2 (ed25519), K3 (secp256k1), K4
# (the ed25519 MSM path)
PATH_KERNELS = ("ed25519_prologue", "ed25519_ladder", "secp256k1_ladder", "ed25519_msm")


@dataclass
class VerifyRoot:
    device: torch.device
    verifier: _batch.GuardedBatchVerifier
    executor: Callable
    build_seconds: Dict[str, float] = field(default_factory=dict)


def configure_verify(cfg: Optional[VerifyConfig] = None,
                     device: DeviceLike = None) -> VerifyRoot:
    """Apply the ``[verify]`` section and install the guarded verify path;
    returns what was installed."""
    cfg = cfg if cfg is not None else VerifyConfig()
    dev = resolve_device(device)
    _batch._resolve_ed25519_path(cfg.ed25519_path)  # a bad value raises here
    _batch._choice(cfg.fe_backend, "vpu", _batch.FE_BACKENDS, "fe_backend")
    if str(cfg.planner_reduce or "device").lower() not in planner.REDUCE_MODES:
        raise ValueError(
            f"planner_reduce must be one of {planner.REDUCE_MODES}, "
            f"got {cfg.planner_reduce!r}")
    build_seconds = {}
    if dev.type == "cuda":
        build_seconds = _build.build_all(PATH_KERNELS)
        for name in PATH_KERNELS:
            _build.load(name)
    _brk.configure_device_guard(cfg)
    planner.configure_planner(cfg)
    _batch.set_default_ed25519_path(cfg.ed25519_path)
    # the verify path resolves as in the reference: TM_ED25519_PATH, then
    # the [verify] value just installed
    verifier = _batch.GuardedBatchVerifier(
        _batch.TorchBatchVerifier(dev, fe_backend=cfg.fe_backend))
    executor = planner.device_executor(dev)
    _batch.set_batch_verifier(verifier)
    planner.set_device_executor(executor)
    return VerifyRoot(dev, verifier, executor, build_seconds)


def reset_verify() -> None:
    """Uninstall what ``configure_verify`` installed and restore the
    guard's and the planner's defaults."""
    _batch.set_batch_verifier(None)
    planner.set_device_executor(None)
    _brk.reset_device_guard()
    planner.configure_planner(None)
    _batch.set_default_ed25519_path(None)


def vote_feed(cfg: Optional[VerifyConfig] = None,
              device: DeviceLike = None) -> Optional[planner.VoteFeed]:
    """The live-vote feed of the ``[verify]`` section: None when
    ``vote_batch_window_ms`` is 0, else ``VoteFeed(window_s=ms / 1000,
    max_rows=vote_batch_rows)``. On the card with no verifier given, its
    flushes run the installed verifier (the root's guarded one)."""
    cfg = cfg if cfg is not None else VerifyConfig()
    ms = float(cfg.vote_batch_window_ms or 0.0)
    if ms <= 0:
        return None
    return planner.VoteFeed(window_s=ms / 1000.0, max_rows=cfg.vote_batch_rows,
                            device=device)


class MempoolRoot(NamedTuple):
    mempool: Mempool
    feed: Optional[planner.TxFeed]  # None: the app verifies serially
    verifier: Optional[BatchTxVerifier]


def mempool(cfg: Optional[MempoolConfig], proxy_app, app, metrics=None, *,
            height: int = 0, checktx_batch_wait: float = 0.005,
            device: DeviceLike = None) -> MempoolRoot:
    """The node's mempool from the ``[mempool]`` section: ``Mempool`` on
    ``proxy_app.mempool`` (a started ``proxy/app_conn.MultiAppConn``) at
    ``height``; and when ``tx_batch_window_ms > 0`` and ``app`` publishes a
    ``tx_sig_extractor``, a ``planner.TxFeed(window_s=ms / 1000,
    max_rows=tx_batch_rows, device=device)`` behind a ``BatchTxVerifier``
    keyed by the mempool's height, installed as the verdict-bearing hook.
    On the card with no verifier given, the feed's flushes run the
    installed verifier (the root's guarded one). ``checktx_batch_wait`` is
    the Mempool's own knob (the reference's node leaves it at its default).
    The mempool WAL is not ported: a ``wal_path`` raises."""
    cfg = cfg if cfg is not None else MempoolConfig()
    if cfg.wal_path:
        raise NotImplementedError("the mempool WAL is not ported (wal_path must be empty)")
    mp = Mempool(
        proxy_app.mempool,
        height=height,
        size=cfg.size,
        cache_size=cfg.cache_size,
        recheck=cfg.recheck,
        metrics=metrics,
        lane_bounds=cfg.lane_bounds,
        checktx_batch=cfg.checktx_batch,
        checktx_batch_wait=checktx_batch_wait,
        recheck_batch=cfg.recheck_batch,
    )
    extractor = getattr(app, "tx_sig_extractor", None)
    if float(cfg.tx_batch_window_ms or 0.0) <= 0 or extractor is None:
        return MempoolRoot(mp, None, None)
    feed = planner.TxFeed(window_s=cfg.tx_batch_window_ms / 1000.0,
                          max_rows=cfg.tx_batch_rows, device=device)
    ver = BatchTxVerifier(feed, extractor, height_fn=mp.height)
    mp.set_batch_check_hook(ver, verdicts=True)
    return MempoolRoot(mp, feed, ver)


class ExecutorRoot(NamedTuple):
    evidence_pool: EvidencePool
    block_executor: BlockExecutor


def block_executor(state_db, evidence_db, proxy_app, mempool, state, event_bus=None,
                   metrics=None) -> ExecutorRoot:
    """The node's evidence pool over ``evidence_db`` and its
    ``BlockExecutor`` on ``proxy_app.consensus`` (a started
    ``MultiAppConn``), owning ``mempool`` (``mempool(...).mempool``) and
    publishing to ``event_bus``. The executor's verifier is None: each
    block's LastCommit goes to the installed verifier, on the card the
    configuration root's guarded one (K1 + K2, K3). ``metrics`` is a
    ``libs/metrics.StateMetrics``."""
    evpool = EvidencePool(state_db, evidence_db, state)
    return ExecutorRoot(evpool, BlockExecutor(state_db, proxy_app.consensus, mempool, evpool,
                                              event_bus, verifier=None, metrics=metrics))
