"""The port's secp256k1 field (tendermint_tpu_torch/ops/fe_secp256k1.py)
against Python bigints and the JAX package's field (ops/secp256k1_verify.py),
and its overflow-bound certificate.

Every value is an integer: comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tendermint_tpu.ops import secp256k1_verify as jsv
from tendermint_tpu_torch.ops import fe_secp256k1 as F
from tendermint_tpu_torch.ops import secp256k1_cuda as sc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One core for the plain versions: the suite runs timing-sensitive node
    tests in parallel workers beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P = F.P
S = F.closed_set()  # per-limb maxima of the carried class

EDGE_INTS = [0, 1, 2, P - 1, P, P + 1, 2**256 - 1, 2**256 - 2**32, 2**255,
             0x1000003D1, 2**26 - 1, 2**234]


def _edge_limbs():
    rows = [F.int_to_limbs(v % 2**256) for v in EDGE_INTS]
    rows.append(list(F.MASKS))  # all-max exact-width limbs
    rows.append(list(S))  # the certificate's extremes
    rows.append([S[i] if i % 2 else 0 for i in range(F.NLIMB)])
    rows.append([0 if i % 2 else S[i] for i in range(F.NLIMB)])
    rng = np.random.default_rng(11)
    for _ in range(8):
        rows.append([int(rng.integers(0, s + 1)) for s in S])
    return torch.tensor(rows, dtype=torch.int64)


@pytest.fixture(scope="module")
def limbs():
    return _edge_limbs()


def _vals(t):
    return [F.limbs_to_int(r) for r in t.tolist()]


def _in_class(t: torch.Tensor) -> bool:
    return bool((t >= 0).all()) and bool((t <= torch.tensor(S)).all())


def test_layout():
    assert F.OFFS == tuple(26 * i for i in range(10))
    assert sum(F.WIDTHS) == 256 and F.WIDTHS[9] == 22
    assert F.limbs_to_int(F.K_SUB) == 2 * P
    assert F.limbs_to_int([F.TOP_LO, F.TOP_HI]) == 2**256 - P  # 0x1000003D1
    assert F.FOLD_LO + (F.FOLD_HI << 26) == 0x1000003D10 == 2**260 % P
    for v in (0, 1, P - 1, 2**256 - 1):
        assert F.limbs_to_int(F.int_to_limbs(v)) == v


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_vs_bigint(limbs, op):
    n = limbs.shape[0]
    a = limbs.repeat_interleave(n, dim=0)
    b = limbs.repeat(n, 1)
    got = getattr(F, op)(a, b)
    assert _in_class(got)
    ref = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
           "mul": lambda x, y: x * y % P}[op]
    assert [v % P for v in _vals(got)] == [ref(x, y) for x, y in zip(_vals(a), _vals(b))]


def test_mul_small_and_canonical(limbs):
    got = F.mul_small(limbs)
    assert _in_class(got)
    assert [v % P for v in _vals(got)] == [21 * v % P for v in _vals(limbs)]
    c = F.canonical(limbs)
    assert _vals(c) == [v % P for v in _vals(limbs)]
    assert bool((c <= torch.tensor(F.MASKS)).all())  # exact-width limbs


def _to_jax(vals):
    """Integers below 2^260 -> the JAX package's (n, 20) radix-2^13 limbs."""
    return jnp.asarray(np.stack([jsv.int_to_limbs(v) for v in vals]))


def test_mul_and_sub_vs_jax_field(limbs):
    """The same values through the JAX package's fe_mul / fe_sub agree mod p
    (each package in its own layout, up to its own carried bound)."""
    rng = np.random.default_rng(3)
    n = limbs.shape[0]
    ia = rng.integers(0, n, 48)
    ib = rng.integers(0, n, 48)
    a, b = limbs[ia], limbs[ib]
    av, bv = _vals(a), _vals(b)
    jm = np.asarray(jsv.fe_mul(_to_jax(av), _to_jax(bv)))
    js = np.asarray(jsv.fe_sub(_to_jax(av), _to_jax(bv)))
    tm, ts = _vals(F.mul(a, b)), _vals(F.sub(a, b))
    for i in range(len(av)):
        assert tm[i] % P == jsv.limbs_to_int(jm[i]) % P == av[i] * bv[i] % P
        assert ts[i] % P == jsv.limbs_to_int(js[i]) % P == (av[i] - bv[i]) % P


def test_certificate_bounds():
    cert = F.certify()
    s = cert["closed_set"]
    assert s == S
    for out in (F.bound_add(s, s), F.bound_sub(s, s), F.bound_mul(s, s),
                F.bound_mul_small(s)):
        assert all(o <= m for o, m in zip(out, s))
    assert cert["max_mul_intermediate"] < 2**63  # plain version: int64
    assert cert["max_mul_intermediate"] < 2**64  # kernel: uint64 inside mul
    assert cert["max_narrow_intermediate"] < 2**32  # kernel: uint32 elsewhere
    assert all(k >= m for k, m in zip(F.K_SUB, s))  # sub never underflows
    assert cert["canonical_top_carry"] * (2**256 - P) < 2**256


def test_plain_mul_at_the_certificate_extremes():
    """int64 holds the largest columns: the all-S product is exact."""
    a = torch.tensor([S], dtype=torch.int64)
    got = F.mul(a, a)
    v = F.limbs_to_int(S)
    assert F.limbs_to_int(got[0].tolist()) % P == v * v % P


class _BoundFe:
    """The field's interface over per-limb maxima: every op asserts its
    operands lie in the carried class and records mul's largest
    intermediate."""

    def __init__(self):
        self.peak = 0

    def _arg(self, x):
        assert all(0 <= v <= m for v, m in zip(x, S)), x
        return x

    def add(self, a, b):
        return F.bound_add(self._arg(a), self._arg(b))

    def sub(self, a, b):
        return F.bound_sub(self._arg(a), self._arg(b))

    def mul(self, a, b):
        out, peak = F.bound_mul_steps(self._arg(a), self._arg(b))
        self.peak = max(self.peak, peak)
        return out

    def sq(self, a):
        return self.mul(a, a)

    def mul_small(self, a, k=F.B3):
        return F.bound_mul_small(self._arg(a), k)


def test_point_formulas_stay_in_bounds(monkeypatch):
    """Run the ladder's point formulas (the code the kernel mirrors) on
    bounds: every operand stays in the class, no intermediate reaches 2^63."""
    bfe = _BoundFe()
    monkeypatch.setattr(sc, "F", bfe)
    pt = (S, S, S)
    for out in (sc._pt_add(pt, pt), sc._pt_double(pt)):
        for coord in out:
            assert all(v <= m for v, m in zip(coord, S))
    assert 0 < bfe.peak < 2**63


def test_the_plain_multiply_stays_off_the_cpu_thread_pool():
    """As the ed25519 field's: the column gather is ``index_select``, not
    advanced indexing, which takes torch's CPU thread pool on every call."""
    from tests.test_torch_fe import _AtenOps

    a = _edge_limbs()
    with _AtenOps() as rec:
        F.mul(a, a.flip(0))
    assert torch.ops.aten.index.Tensor not in rec.ops
    assert torch.ops.aten.index_select.default in rec.ops
