"""The CUDA kernels against their plain versions on the card. CUDA kernels
have no interpret mode, so these tests carry the ``cuda`` marker and skip
where no CUDA device is present (run them on the GPU with
``python -m pytest tests/test_torch_cuda.py -q``; ``chip_smoke.py`` runs the
same checks at full size)."""

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.testutil import commit as tc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the GPU")
    return torch.device("cuda", 0)


def _window():
    pubs, msgs, sigs, _ = tc.go_edge_window(seed=2)
    n = len(pubs)
    pa = np.frombuffer(b"".join(pubs), np.uint8).reshape(n, 32)
    sa = np.frombuffer(b"".join(sigs), np.uint8).reshape(n, 64)
    return pa, msgs, sa


@pytest.mark.parametrize("length", [0, 104, 111, 112, 200])
def test_prologue_kernel_vs_plain(cuda, length):
    rng = np.random.default_rng(length)
    n = 256
    pubs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sigs = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    m = rng.integers(0, 256, (n, length), dtype=np.uint8)
    msgs = [m[i].tobytes() for i in range(n)]
    tmpl, vrows, vwords = ec.pack_variable_words(pubs, msgs, sigs, length, n)
    args = [ec._put(a, cuda) for a in (
        tmpl, vrows, vwords, np.ascontiguousarray(pubs).view("<u4"),
        np.ascontiguousarray(sigs).view("<u4"))]
    before = ec.launches["ed25519_prologue"]
    got = ec.prologue(*args)
    torch.cuda.synchronize()
    assert ec.launches["ed25519_prologue"] == before + 1
    for g, w in zip(got, ec.prologue_ref(*args)):
        assert torch.equal(g, w)


def test_ladder_kernel_vs_plain(cuda):
    pa, msgs, sa = _window()
    lens = np.array([len(m) for m in msgs])
    for ln in np.unique(lens):
        idx = np.nonzero(lens == ln)[0]
        neg, ay, valid = ec._decompress_valset(pa[idx])
        inputs, _ = ec.packed_inputs(pa[idx], [msgs[i] for i in idx], sa[idx],
                                     neg, ay, valid, int(ln), cuda)
        consts, negax, ayd, pubw, sigw, tmpl, vidx, vwords = inputs
        k1 = ec.prologue(tmpl, vidx, vwords, pubw, sigw)
        got = ec.ladder(consts, negax, ayd, *k1)
        torch.cuda.synchronize()
        for g, w in zip(got, ec.ladder_ref(consts, negax, ayd, *k1)):
            assert torch.equal(g, w)


def test_verify_batch_on_cuda_vs_oracle(cuda):
    pa, msgs, sa = _window()
    got = ec.verify_batch(pa, msgs, sa, device=cuda)
    want = [ted._verify_pure(pa[i].tobytes(), msgs[i], sa[i].tobytes()) for i in range(len(msgs))]
    assert got.tolist() == want
