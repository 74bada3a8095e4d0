"""The port's plain SHA-512 and the prologue's mod-L/digit stages against
hashlib, bigints and the JAX package's stages; and the constants the CUDA
prologue kernel carries in its source against the Python ones."""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tendermint_tpu.ops import ed25519_pallas as jep
from tendermint_tpu.ops import sha512_batch as jsha
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.ops import sha512 as tsha


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One core for the plain versions: the suite runs timing-sensitive node
    tests in parallel workers beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LENGTHS = (0, 104, 111, 112, 200, 239)


@pytest.mark.parametrize("length", LENGTHS)
def test_sha512_vs_hashlib_and_jax(length):
    rng = np.random.default_rng(100 + length)
    data = rng.integers(0, 256, (7, length), dtype=np.uint8)
    got = tsha.sha512_batch(data, device="cpu")
    assert np.array_equal(got, jsha.sha512_batch(data, length))
    for i in range(data.shape[0]):
        assert got[i].tobytes() == hashlib.sha512(data[i].tobytes()).digest()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only default")
def test_sha512_batch_defaults_to_the_card():
    """No device given means ``cuda``: without a card it raises rather
    than hashing on the CPU."""
    from tendermint_tpu_torch.device import NoCudaDeviceError

    with pytest.raises(NoCudaDeviceError):
        tsha.sha512_batch(np.zeros((1, 8), np.uint8))


def test_padding_rule():
    for length, blocks in ((0, 1), (111, 1), (112, 2), (239, 2), (240, 3)):
        assert tsha.nblocks(length) == blocks
        assert tsha.pad(np.zeros((1, length), np.uint8)).shape == (1, 128 * blocks)


def _synthetic_states(n, seed=82):
    """The digests and 8 (hi, lo) state pairs of tests/test_pallas_interpret's
    prologue-stage test: rows of big-endian 64-bit digest words."""
    rng = np.random.default_rng(seed)
    digests = [rng.bytes(64) for _ in range(n)]
    words = np.array([[int.from_bytes(d[8 * w: 8 * w + 8], "big") for w in range(8)]
                      for d in digests], dtype=np.uint64)
    hi = (words >> np.uint64(32)).astype(np.uint32)
    lo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return digests, hi, lo


def test_mod_l_and_digits_vs_jax_stages():
    import jax.numpy as jnp

    n = 8
    digests, hi, lo = _synthetic_states(n)
    jstate = [(jnp.asarray(hi[:, w][None, :]), jnp.asarray(lo[:, w][None, :]))
              for w in range(8)]
    jwords = [np.asarray(w)[0] for w in jep._limbs_to_words8(jep._mod_l_device(jstate))]
    tstate = [(torch.from_numpy(hi[:, w].astype(np.int64)),
               torch.from_numpy(lo[:, w].astype(np.int64))) for w in range(8)]
    h16 = ec._mod_l16(ec._digest_limbs16(tstate))
    for i in range(n):
        want = int.from_bytes(digests[i], "little") % ed.L
        got = sum(int(h16[k][i]) << (16 * k) for k in range(16))
        assert got == want
        assert sum(int(jwords[j][i]) << (32 * j) for j in range(8)) == want


def test_prologue_digits_match_jax_layout():
    """prologue_ref's digit rows equal the JAX kernel's extraction
    (digh[t] = nibble 63 - t of h's LE words) applied to hashlib's h."""
    rng = np.random.default_rng(5)
    n, ln = 16, 104
    pubs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sigs = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    m = np.tile(rng.integers(0, 256, ln, dtype=np.uint8), (n, 1))
    m[:, 17:25] = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    msgs = [m[i].tobytes() for i in range(n)]
    tmpl, vrows, vwords = ec.pack_variable_words(pubs, msgs, sigs, ln, n)
    args = [ec._put(a, "cpu") for a in (
        tmpl, vrows, vwords, np.ascontiguousarray(pubs).view("<u4"),
        np.ascontiguousarray(sigs).view("<u4"))]
    digs, digh, rlimb, rsign = (t.numpy() for t in ec.prologue_ref(*args))
    for i in range(n):
        h = int.from_bytes(hashlib.sha512(
            sigs[i, :32].tobytes() + pubs[i].tobytes() + msgs[i]).digest(), "little") % ed.L
        s = int.from_bytes(sigs[i, 32:].tobytes(), "little")
        for t in range(64):
            k = 63 - t
            assert digh[t, i] == (h >> (4 * k)) & 15
            assert digs[t, i] == (s >> (4 * k)) & 15
        r = int.from_bytes(sigs[i, :32].tobytes(), "little")
        assert sum(int(v) << off for v, off in zip(rlimb[:, i], ec.fe.OFFS)) == r % 2**255
        assert rsign[0, i] == r >> 255


def _c_array(src: str, name: str):
    body = re.search(name + r"\[\d+\]\s*=\s*\{(.*?)\};", src, re.S).group(1)
    return [int(v.rstrip("ull"), 16) for v in re.findall(r"0x[0-9a-fA-F]+(?:ull)?", body)]


def test_kernel_source_constants():
    src = (Path(ec.__file__).parent / "csrc" / "ed25519_prologue.cu").read_text()
    assert tuple(_c_array(src, "K512")) == tsha.K
    assert tuple(_c_array(src, "H0")) == tsha.H0
    assert _c_array(src, "MU16") == ec._MU16
    assert _c_array(src, "L16") == ec._L16
    assert _c_array(src, "LC16") == ec._LC16
    assert tuple(int(v) for v in jsha._K) == tsha.K
