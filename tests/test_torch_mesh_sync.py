"""The mesh paths of the commit window (2-D), fast sync and state sync's
backfill on the port against the JAX package's, on the CPU, with
``tests/test_torch_mesh.py``'s meshes and package fixtures: the reference
on its 8 forced host devices as a (2, 4) ``("height", "val")`` mesh, the
port on ``DeviceMesh(["cpu"] * 8, (2, 4), ("height", "val"))``.

Restated on both packages: ``tests/test_parallel.py::TestCommitWindow::
test_sharded_2d_mesh`` and ``tests/test_fastsync.py::
TestVerifyBlockWindowSharded`` (its chain widened to 10 validators over 9
heights, so that the window's 80 lanes land in the superdispatch matrix's
(128, 8) bucket: the reference compiles its mesh step once here, and its
2-D commit window once); then the port's backfill over a mesh. Every
verdict grid and int64 tally is compared exactly."""

from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.parallel import commit_verify as rcv
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config.statesync import StateSyncConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.lite.provider import NodeProvider
from tendermint_tpu_torch.parallel import commit_verify as tcv
from tendermint_tpu_torch.statesync.syncer import StateSyncer, _SnapshotRejected
from tendermint_tpu_torch.testutil import chain as tchain

from tests.test_torch_mesh import (  # noqa: F401  (fixtures)
    _guards,
    _one_torch_thread,
    _signed,
    pkg,
    rmesh,
    tmesh,
)


# ---------------------------------------------------------------------------
# The 2-D commit window (tests/test_parallel.py), on both packages
# ---------------------------------------------------------------------------


def _cw_window(H, V):
    """tests/test_parallel.py's TestCommitWindow._window: every 7th cell
    from 3 absent, from 5 forged; power v + 1."""
    triples = _signed(H * V, tag=40)
    votes, powers = [], []
    for h in range(H):
        vrow, prow = [], []
        for v in range(V):
            pub, msg, sig = triples[h * V + v]
            if (h * V + v) % 7 == 3:
                vrow.append(None)
            elif (h * V + v) % 7 == 5:
                bad = bytearray(sig)
                bad[3] ^= 1
                vrow.append((pub, msg, bytes(bad)))
            else:
                vrow.append((pub, msg, sig))
            prow.append(v + 1)
        votes.append(vrow)
        powers.append(prow)
    return votes, powers


def test_sharded_2d_mesh(pkg):
    votes, powers = _cw_window(4, 6)
    win = pkg.cv.pack_commit_window(votes, powers)
    total = sum(powers[0])
    kw = {} if pkg.name == "reference" else {"device": "cpu"}
    ok, tally, committed = pkg.cv.verify_commit_window(win, total, mesh=pkg.mesh)
    ok0, tally0, committed0 = pkg.cv.verify_commit_window(win, total, **kw)
    assert (ok == ok0).all() and (tally == tally0).all() and (committed == committed0).all()
    assert tally.dtype == np.int64 and 0 < ok.sum() < ok.size


def test_2d_mesh_equals_the_reference(rmesh, tmesh):
    """The port's (height, val) split against the reference's, cell for
    cell and height for height, on the same window (padded from 4 x 6 to
    4 x 8 by the mesh's shape)."""
    votes, powers = _cw_window(4, 6)
    total = sum(powers[0])
    got = tcv.verify_commit_window(tcv.pack_commit_window(votes, powers), total, mesh=tmesh)
    want = rcv.verify_commit_window(rcv.pack_commit_window(votes, powers), total, mesh=rmesh)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w))
    assert get_profiler().entries()[-1]["kind"] == "window_mesh"


# ---------------------------------------------------------------------------
# TestVerifyBlockWindowSharded (tests/test_fastsync.py), on both packages
# ---------------------------------------------------------------------------

_CHAINS = {}


def _chain(pkg):
    """10 validators over 9 heights: a window of 8 commits, 80 lanes, in
    the (128, 8) bucket."""
    if pkg.name not in _CHAINS:
        _CHAINS[pkg.name] = pkg.chain.build_chain(n_vals=10, n_heights=9,
                                                  chain_id="vbw-mesh", **pkg.build_kw)
    return _CHAINS[pkg.name]


def _blocks(pkg, fx):
    return [fx.block_store.load_block(h) for h in range(1, 10)]


def test_matches_flat_path_on_valid_chain(pkg):
    fx = _chain(pkg)
    st = pkg.st.state_from_genesis(fx.genesis)
    blocks = _blocks(pkg, fx)
    parts_flat, parts_mesh = [], []
    flat = pkg.reactor.verify_block_window(st, blocks, parts_out=parts_flat)
    sharded = pkg.reactor.verify_block_window(st, blocks, parts_out=parts_mesh, mesh=pkg.mesh)
    assert flat[0] == sharded[0] == 8
    assert flat[1] is None and sharded[1] is None
    assert [p.header() for p in parts_flat] == [p.header() for p in parts_mesh]


def test_detects_tamper_like_flat_path(pkg):
    import dataclasses

    fx = _chain(pkg)
    st = pkg.st.state_from_genesis(fx.genesis)
    blocks = _blocks(pkg, fx)
    pc = blocks[4].last_commit.precommits[1]
    blocks[4].last_commit.precommits[1] = dataclasses.replace(pc, signature=b"\x00" * 64)
    n_ok, err = pkg.reactor.verify_block_window(st, blocks, mesh=pkg.mesh)
    assert n_ok == 3 and err is not None and err.bad_index == 3
    assert pkg.reactor.verify_block_window(st, blocks)[0] == 3
    blocks[4].last_commit.precommits[1] = pc


def test_quorum_failure_detected(pkg):
    fx = _chain(pkg)
    st = pkg.st.state_from_genesis(fx.genesis)
    blocks = _blocks(pkg, fx)
    pcs = blocks[6].last_commit.precommits
    saved = list(pcs)
    for i in range(4):  # 6 of 10 equal voters: 18 > 20 is false
        pcs[i] = None
    try:
        n_ok, err = pkg.reactor.verify_block_window(st, blocks, mesh=pkg.mesh)
        assert n_ok == 5 and err is not None and "voting power" in str(err)
    finally:
        pcs[:] = saved


# ---------------------------------------------------------------------------
# State sync's backfill over a mesh (the port; the reference's flat
# backfill decides the same windows)
# ---------------------------------------------------------------------------


def test_syncer_backfill_with_a_mesh(tmesh):
    import dataclasses

    fx = _chain(SimpleNamespace(name="port", chain=tchain,
                                build_kw={"verifier": tbatch.HostBatchVerifier()}))
    provider = NodeProvider(fx.block_store, fx.state_db)
    fcs = [provider.full_commit_at(fx.chain_id, h) for h in range(2, 9)]
    syncer = StateSyncer(StateSyncConfig(backfill_blocks=4), fx.chain_id, fx.genesis, None,
                         MemDB(), BlockStore(MemDB()), mesh=tmesh)
    get_profiler().reset()
    syncer._verify_backfill_window(fcs)  # no raise
    kinds = {e["kind"] for e in get_profiler().entries()}
    assert kinds == {"planner_mesh"}
    pc = fcs[3].signed_header.commit.precommits[2]
    fcs[3].signed_header.commit.precommits[2] = dataclasses.replace(pc, signature=b"\x11" * 64)
    with pytest.raises(_SnapshotRejected, match="invalid signature"):
        syncer._verify_backfill_window(fcs)
    sh = fcs[3].signed_header
    with pytest.raises(Exception, match="invalid signature"):
        fcs[3].validators.verify_commit(fx.chain_id, sh.commit.block_id, fcs[3].height,
                                        sh.commit)
