"""Time K5 and K6 sources against each other on one card, in turns, on the
10,000-validator commits' rows and on a mesh shard's.

    python3 -m tendermint_tpu_torch.tools.k56_compare [k5:name=path.cu ...] [k6:name=path.cu ...]

Each ``k5:name=path.cu`` / ``k6:name=path.cu`` names another K5 or K6
source with the tree's launcher (the constant table first, then the
inputs, the verdicts, b and the tree's geometry), for example a variant
under test, with the headers it includes beside it; the tree's kernels
(``ops/csrc/ed25519_verify.cu``, ``secp256k1_verify.cu``) are ``new``. Every
source is built (one ``nvcc`` each), held equal to the plain version
(``verify_ref``) on every row of the 10k commit padded to N = 10,240, and
timed in turns (in the order given, then reversed) there and at b = 2,560
and 3,072 (the first rows of the same inputs). Prints the card's name and
power limit and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.ops import ed25519_verify as k5v
from tendermint_tpu_torch.ops import secp256k1_cuda as sc
from tendermint_tpu_torch.ops import secp256k1_verify as k6v
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.tools import k3_compare

N_ROWS = 10_000
SHARD_ROWS = (2_560, 3_072)
OUT = k3_compare.OUT


def ed_inputs(dev: torch.device) -> tuple:
    """K5's six inputs for the 10k ed25519 commit, padded to N = 10,240."""
    sc_ = tc.build_commit(N_ROWS)
    pubs = np.frombuffer(b"".join(v.pub_key.bytes() for v in sc_.valset.validators),
                         np.uint8).reshape(N_ROWS, 32)
    sigs = np.frombuffer(b"".join(pc.signature for pc in sc_.commit.precommits),
                         np.uint8).reshape(N_ROWS, 64)
    msgs = [pc.sign_bytes(sc_.chain_id) for pc in sc_.commit.precommits]
    *host, valid = k5v.host_prologue(pubs, msgs, sigs)
    if not valid.all():
        raise SystemExit("an ed25519 commit row is invalid on the host")
    b = ec._bucket(N_ROWS)
    return k5v.upload([ec._pad_rows(np.asarray(a), b) for a in host], dev)


def secp_inputs(dev: torch.device) -> tuple:
    """K6's seven inputs for the 10k secp256k1 commit, padded to N = 10,240."""
    sc_ = tc.build_commit(N_ROWS, key_type="secp256k1")
    pks, msgs, sigs, _ = sc_.valset.collect_commit_sigs(
        sc_.chain_id, sc_.block_id, sc_.height, sc_.commit)
    host, forced = k6v.pack_rows([pk.bytes() for pk in pks], [sha256(m) for m in msgs],
                                 list(sigs), ec._bucket(N_ROWS))
    if not (forced[:N_ROWS] == -1).all():
        raise SystemExit("a secp256k1 commit row was decided on the host")
    return k6v.upload(host, dev)


KERNELS = {  # name -> (library, inputs, plain version, tree geometry, constant input)
    "k5": (k5v.NAME, ed_inputs, k5v.verify_ref, k5v.k5_geometry, ec._consts_on),
    "k6": (k6v.NAME, secp_inputs, k6v.verify_ref, k6v.k6_geometry, sc._consts_on),
}


def compare(argv: List[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k56 compare: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    extra: Dict[str, Dict[str, Path]] = {key: {} for key in KERNELS}
    for arg in argv:
        key, rest = arg.split(":", 1)
        name, path = rest.split("=", 1)
        extra[key][name] = Path(path)
    report: Dict[str, dict] = {}
    for key, (lib_name, inputs, ref, geometry, consts_on) in KERNELS.items():
        srcs = {**extra[key], "new": _build.SRC_DIR / _build.SOURCES[lib_name]}
        built = k3_compare.build(srcs, OUT / lib_name, lambda sass: None)
        ins = inputs(dev)
        fns = {}
        for name, (lib, lines, _) in built.items():
            fn = getattr(lib, lib_name + "_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * (len(ins) + 2) + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fns[name] = fn
            print(f"  {key} {name}: {'; '.join(lines)}", flush=True)

        def launch(name, ins_):
            b = ins_[0].shape[1]
            ok = torch.empty((b,), dtype=torch.int32, device=dev)
            rc = fns[name](consts_on(dev).data_ptr(), *(t.data_ptr() for t in ins_),
                           ok.data_ptr(), b, *geometry(b),
                           torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"{key} {name}: cudaError {rc}")
            return ok

        want = ref(*ins)
        times: Dict[int, Dict[str, List[float]]] = {}
        for b in (ins[0].shape[1], *SHARD_ROWS):
            sub = tuple(t[:, :b].contiguous() for t in ins)
            for name in fns:
                if not torch.equal(launch(name, sub), want[:b]):
                    raise SystemExit(f"{key} {name} differs from the plain version at b = {b}")
            times[b] = {name: [] for name in fns}
            for name in list(fns) + list(fns)[::-1]:
                times[b][name].append(k3_compare.cuda_ms(lambda: launch(name, sub)))
            print(f"  {key} b = {b}, every source == verify_ref: " + ", ".join(
                f"{name} " + " / ".join(f"{t:.4f}" for t in ts) for name, ts in times[b].items()),
                flush=True)
        report[key] = {"times_ms": times, "ptxas": {n: built[n][1] for n in fns}}
    print(card)
    print(json.dumps({"card": card, **report}))
    return 0


if __name__ == "__main__":
    sys.exit(compare(sys.argv[1:]))
