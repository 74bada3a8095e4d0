"""``tools/bench_native.py``, which chip_smoke.py's phase 30 runs, on a
small chain: the natives here and the Python paths in a fresh child
interpreter give equal digests of every workload, the WAL holds the asked
records and the truncated copy stops at its last record; the
10,000-validator set hashes as the reference package's does."""

import numpy as np
import pytest

from tendermint_tpu.crypto.keys import PubKeyEd25519 as RPubKeyEd25519
from tendermint_tpu.types.validator_set import Validator as RValidator
from tendermint_tpu.types.validator_set import ValidatorSet as RValidatorSet
from tendermint_tpu_torch.crypto.batch import HostBatchVerifier
from tendermint_tpu_torch.testutil.chain import build_chain
from tendermint_tpu_torch.tools import bench_native as bn


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    fx = build_chain(n_vals=6, n_heights=9, verifier=HostBatchVerifier(), check_votes=False)
    blocks = [fx.block_store.load_block(h) for h in range(1, 10)]
    d = tmp_path_factory.mktemp("bench_native")
    return d, bn.write_inputs(d, blocks, min_records=300), blocks


def test_write_inputs_lays_out_the_chain_and_its_wal(inputs):
    d, sizes, blocks = inputs
    assert sizes["blocks"] == 9 and sizes["records"] >= 300
    assert bn.read_blocks(d) == [b.marshal() for b in blocks]
    assert (d / "truncated" / "wal").stat().st_size == sizes["wal_bytes"] - 7


def test_both_paths_give_equal_digests(inputs):
    d, sizes, _ = inputs
    with bn.PythonChild(d) as child:
        child.wait_ready()
        nat = bn.run(d)
        py = child.result()
    assert (nat["path"], py["path"]) == ("native", "python")
    assert nat["digest"] == py["digest"]
    assert nat["counts"] == py["counts"] == {"blocks": 9, "records": sizes["records"],
                                             "validators": bn.VALSET_SIZE, "parts": 9}
    assert nat["digest"]["truncated"] == f"{sizes['records'] - 1} truncated payload"
    assert set(nat["seconds"]) == set(py["seconds"]) == {
        "decode", "encode", "part_set", "header_hash", "valset_hash", "wal"}


def test_a_child_that_cannot_start_raises(tmp_path):
    with bn.PythonChild(tmp_path / "missing") as child:
        with pytest.raises(RuntimeError, match="did not start"):
            child.result()


def test_the_valset_hashes_as_the_references():
    vs = bn.valset()
    rng = np.random.default_rng(bn.VALSET_SEED)
    keys = rng.bytes(32 * bn.VALSET_SIZE)
    powers = rng.integers(1, 1000, size=bn.VALSET_SIZE)
    ref = RValidatorSet([RValidator(RPubKeyEd25519(keys[32 * i: 32 * i + 32]), int(powers[i]))
                         for i in range(bn.VALSET_SIZE)])
    assert vs.hash() == ref.hash()
