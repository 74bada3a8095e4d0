"""The port's host RLC batch verify (tendermint_tpu_torch/crypto/ed25519.py:
``_msm``, ``_rlc_holds``, ``_leaf_verify``, ``_resolve_batch``,
``_parse_batch``, ``verify_batch``) and ``RLCHostVerifier`` against the
reference's, exactly.

The reference's ``verify_batch`` goes serial where the ``cryptography``
package is installed, so its RLC route is held with ``_HAVE_CRYPTOGRAPHY``
patched to False. ``os.urandom`` is patched to one seeded byte stream for
each side, so both draw the same coefficients z in the same order: the
verdicts and the number of draws (the localization path taken) must be
equal. Without the patch, the verdicts equal ``_verify_pure`` on rows with
no small-order component (the RLC omits the cofactor, so it is not an exact
per-lane oracle on the others)."""

import os
import random

import numpy as np
import pytest

from tendermint_tpu.crypto import ed25519 as red
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.libs.metrics import get_verify_metrics
from tendermint_tpu_torch.testutil import commit as tc

ORDER8_ROW = 19  # the Go-edge window's order-8 key (a small-order component)


def _signed(n, seed, bad=()):
    rng = np.random.default_rng(9000 + seed)
    items = []
    for j in range(n):
        priv = ted.gen_privkey(rng.bytes(32))
        msg = b"rlc-%d-%d-" % (seed, j) + rng.bytes(int(rng.integers(0, 120)))
        sig = bytearray(ted.sign(priv, msg))
        if j in bad:
            sig[33 + j % 28] ^= 1 << (j % 8)  # inside s: the shape stays
        items.append((priv[32:], msg, bytes(sig)))
    return items


def _edge_items():
    pubs, msgs, sigs, _ = tc.go_edge_window(seed=5)
    return list(zip(pubs, msgs, sigs))


BATCHES = {
    "clean": lambda: _signed(40, 1),
    "one_bad": lambda: _signed(40, 2, bad={17}),
    "bad_across_chunks": lambda: _signed(75, 3, bad={0, 31, 32, 33, 64, 74}),
    "go_edge_window": _edge_items,
    "go_edge_window_x3": lambda: _edge_items() * 3,
    "tiny": lambda: _signed(3, 4, bad={1}),
    "empty": lambda: [],
}


class _Stream:
    """A seeded ``os.urandom`` that counts its draws."""

    def __init__(self, seed):
        self.rng = random.Random(seed)
        self.draws = 0

    def __call__(self, n):
        self.draws += 1
        return bytes(self.rng.getrandbits(8) for _ in range(n))


def _run(module, items, monkeypatch, seed):
    stream = _Stream(seed)
    with monkeypatch.context() as m:
        m.setattr(os, "urandom", stream)
        out = module.verify_batch(items)
    return out, stream.draws


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_verify_batch_equals_the_reference_rlc_route(name, monkeypatch):
    items = BATCHES[name]()
    monkeypatch.setattr(red, "_HAVE_CRYPTOGRAPHY", False)
    want, want_draws = _run(red, items, monkeypatch, seed=len(items))
    got, got_draws = _run(ted, items, monkeypatch, seed=len(items))
    assert got == want
    assert got_draws == want_draws
    if items:
        assert got_draws >= len([v for v in want if v])  # one z a parsed row
    # the parse is the reference's, row for row
    rp, rout = red._parse_batch(items)
    tp, tout = ted._parse_batch(items)
    assert tp == rp and tout == rout


def test_chunk_localization_pays_leaf_checks_only_in_dirty_chunks(monkeypatch):
    items = _signed(96, 6, bad={40})  # one bad row, in the second chunk
    calls = []
    real = ted._leaf_verify
    monkeypatch.setattr(ted, "_leaf_verify", lambda it: calls.append(it[0]) or real(it))
    out = ted.verify_batch(items)
    assert out == [j != 40 for j in range(96)]
    assert sorted(calls) == list(range(32, 64))


@pytest.mark.parametrize("name", ["clean", "one_bad", "bad_across_chunks", "go_edge_window"])
def test_verdicts_equal_the_oracle_without_small_order_rows(name):
    items = BATCHES[name]()
    if name == "go_edge_window":
        items = [it for j, it in enumerate(items) if j != ORDER8_ROW]
    want = [ted._verify_pure(p, m, s) for p, m, s in items]
    assert ted.verify_batch(items) == want
    assert want.count(False) > 0 or name == "clean"


def _naive(pairs):
    acc = ted.IDENT
    for k, p in pairs:
        acc = ted.pt_add(acc, ted.pt_scalar_mult(p, k))
    return acc


@pytest.mark.parametrize("n", [0, 1, 5, 31, 32, 130])
def test_msm_equals_a_naive_sum(n):
    rng = random.Random(700 + n)
    pairs = []
    for i in range(n):
        pt = ted._mul_b(rng.randrange(1, ted.L))
        width = (0, 1, 8, 128, 252)[i % 5]
        pairs.append((rng.getrandbits(width) if width else 0, pt))
    got = ted._msm(pairs)
    assert ted.pt_affine(got) == ted.pt_affine(_naive(pairs))
    assert ted.pt_affine(got) == ted.pt_affine(red._msm(pairs))
    assert ted._is_identity(ted._msm([])) and ted._is_identity(ted.IDENT)


def test_leaf_verify_and_rlc_holds_equal_the_reference():
    items = _signed(12, 7, bad={4})
    parsed, _ = ted._parse_batch(items)
    assert [ted._leaf_verify(it) for it in parsed] == [red._leaf_verify(it) for it in parsed]
    assert [ted._leaf_verify(it) for it in parsed] == [j != 4 for j in range(12)]
    clean = [it for it in parsed if it[0] != 4]
    assert ted._rlc_holds(clean) and red._rlc_holds(clean)
    assert not ted._rlc_holds(parsed)


def test_a_neg_cache_is_bounded(monkeypatch):
    monkeypatch.setattr(ted, "_A_NEG_CACHE", {b"k%d" % i: None for i in range(5)})
    monkeypatch.setattr(ted, "_A_NEG_CACHE_MAX", 4)
    items = _signed(2, 8)
    ted._parse_batch(items)
    assert set(ted._A_NEG_CACHE) == {p for p, _, _ in items}
    assert ted._CHUNK == red._CHUNK == 32


def _calls(backend):
    return get_verify_metrics().calls._values.get((backend, "ed25519"), 0.0)


def test_rlc_host_verifier_records_backend_host_rlc():
    v = tbatch.RLCHostVerifier()
    assert v.name == "host_rlc" and isinstance(v, tbatch.HostBatchVerifier)
    items = BATCHES["one_bad"]()
    before = _calls("host_rlc")
    ok = v.verify_ed25519([tbatch.SigItem(*it) for it in items])
    ok_raw = v.verify_ed25519_raw(*map(list, zip(*items)))
    assert ok.dtype == bool and list(ok) == list(ok_raw) == [j != 17 for j in range(40)]
    assert _calls("host_rlc") == before + 2
    assert v.verify_ed25519([]).shape == (0,) and v.verify_ed25519_raw([], [], []).shape == (0,)
    assert _calls("host_rlc") == before + 4
