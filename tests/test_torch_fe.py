"""The port's field layer (tendermint_tpu_torch/ops/fe.py) against Python
bigints, and its overflow-bound certificate.

Every value is an integer: comparisons are exact."""

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.ops import fe


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One core for the plain versions: the suite runs timing-sensitive node
    tests in parallel workers beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P = fe.P
S = fe.closed_set()  # per-limb maxima of the carried class

EDGE_INTS = [0, 1, P - 1, P, P + 1, 2**255 - 1, 2**255 - 20, 19, 2**254]


def _edge_limbs():
    rows = [fe.int_to_limbs(v) for v in EDGE_INTS]
    rows.append(list(fe.MASKS))  # all-max exact-width limbs
    rows.append(list(S))  # the certificate's extremes
    rows.append([S[i] if i % 2 else 0 for i in range(fe.NLIMB)])
    rng = np.random.default_rng(11)
    for _ in range(6):
        rows.append([int(rng.integers(0, s + 1)) for s in S])
    return torch.tensor(rows, dtype=torch.int64)


def _in_class(t: torch.Tensor) -> bool:
    return bool((t >= 0).all()) and bool((t <= torch.tensor(S)).all())


@pytest.fixture(scope="module")
def limbs():
    return _edge_limbs()


def _vals(t):
    return [fe.limbs_to_int(r) for r in t.tolist()]


def test_layout():
    assert fe.OFFS == (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)
    assert sum(fe.WIDTHS) == 255
    assert fe.limbs_to_int(fe.K_SUB) == 2 * P
    for v in (0, 1, P - 1, 2**255 - 1):
        assert fe.limbs_to_int(fe.int_to_limbs(v)) == v


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_vs_bigint(limbs, op):
    n = limbs.shape[0]
    a = limbs.repeat_interleave(n, dim=0)
    b = limbs.repeat(n, 1)
    got = getattr(fe, op)(a, b)
    assert _in_class(got)
    av, bv = _vals(a), _vals(b)
    want = {
        "add": [(x + y) % P for x, y in zip(av, bv)],
        "sub": [(x - y) % P for x, y in zip(av, bv)],
        "mul": [(x * y) % P for x, y in zip(av, bv)],
    }[op]
    assert [v % P for v in _vals(got)] == want


def test_canonical_and_inv(limbs):
    c = fe.canonical(limbs)
    assert [fe.limbs_to_int(r) for r in c.tolist()] == [v % P for v in _vals(limbs)]
    assert bool((c <= torch.tensor(fe.MASKS)).all())  # exact-width limbs
    inv = fe.canonical(fe.inv(limbs))
    for v, iv in zip(_vals(limbs), _vals(inv)):
        assert iv == (pow(v, P - 2, P) if v % P else 0)


def test_certificate_bounds():
    cert = fe.certify()
    s = cert["closed_set"]
    assert s == S
    # closed: add, sub and mul of class members stay in the class
    for out in (fe.bound_add(s, s), fe.bound_sub(s, s), fe.bound_mul(s, s)):
        assert all(o <= m for o, m in zip(out, s))
    assert cert["max_intermediate"] < 2**63  # plain version: int64
    assert cert["max_intermediate"] < 2**64  # kernel: uint64 columns
    assert cert["max_premultiplied"] < 2**32  # kernel: 19*b, 2*a in uint32
    assert all(k >= m for k, m in zip(fe.K_SUB, s))  # sub never underflows


def test_plain_mul_at_the_certificate_extremes():
    """int64 holds the largest columns: the all-S product is exact."""
    a = torch.tensor([S], dtype=torch.int64)
    got = fe.mul(a, a)
    v = fe.limbs_to_int(S)
    assert fe.limbs_to_int(got[0].tolist()) % P == v * v % P


class _BoundFe:
    """fe's interface over per-limb maxima: every op asserts its operands
    lie in the carried class and records the largest column sum."""

    def __init__(self):
        self.peak = 0

    def _arg(self, x):
        assert all(0 <= v <= m for v, m in zip(x, S)), x
        return x

    def add(self, a, b):
        return fe.bound_add(self._arg(a), self._arg(b))

    def sub(self, a, b):
        return fe.bound_sub(self._arg(a), self._arg(b))

    def mul(self, a, b):
        cols = fe.bound_mul_cols(self._arg(a), self._arg(b))
        out, peak = fe.bound_carry_seq(cols)
        self.peak = max(self.peak, max(cols), peak)
        return out

    def sq(self, a):
        return self.mul(a, a)


def test_point_formulas_stay_in_bounds(monkeypatch):
    """Run the ladder's point formulas (the code the kernel mirrors) on
    bounds: no intermediate reaches 2^63 (plain) or 2^64 (kernel)."""
    bfe = _BoundFe()
    monkeypatch.setattr(ec, "fe", bfe)
    exact = list(fe.MASKS)
    pt = (S, S, S, S)
    for out in (ec._pt_double(pt), ec._pt_add(pt, pt, exact),
                ec._pt_madd(pt, exact, exact, exact),
                ec._pt_add_cached(pt, (S, S, S, S))):
        for coord in out:
            assert all(v <= m for v, m in zip(coord, S))
    assert 0 < bfe.peak < 2**63


class _AtenOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Records each aten op a block of code dispatches."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(func)
        return func(*args, **(kwargs or {}))


def test_the_plain_multiply_stays_off_the_cpu_thread_pool():
    """The plain field multiply gathers its column operands with
    ``index_select``, never with advanced indexing (``aten.index``), which
    takes torch's CPU thread pool on every call: on a host whose cores are
    busy, that made a 20-row plain window verify take ~30 s instead of ~1 s.
    ``gather_last`` is ``x[..., idx]``."""
    a = _edge_limbs()
    idx = fe._consts(a.device)[0]
    assert torch.equal(fe.gather_last(a, idx), a[..., idx])
    with _AtenOps() as rec:
        fe.mul(a, a.flip(0))
        fe.sq(a)
    assert torch.ops.aten.index.Tensor not in rec.ops
    assert torch.ops.aten.index_select.default in rec.ops
