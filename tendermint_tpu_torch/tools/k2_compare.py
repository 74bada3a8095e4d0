"""Time K2 sources against each other on one card, in turns, on the
10,240-row ed25519 main-path input, and count their window loops'
instructions.

    python3 -m tendermint_tpu_torch.tools.k2_compare [name=path.cu ...]

Each ``name=path.cu`` names a K2 source, for example an earlier one from
git (``git show <commit>:tendermint_tpu_torch/ops/csrc/ed25519_ladder.cu``);
``new``, the tree's kernel (``ops/csrc/ed25519_ladder.cu``), comes last.
The input is a 10,000-validator ed25519 commit's rows, packed and run
through K1 on the card. ``k3_compare.compare`` does the work: it builds,
checks against ``ladder_ref`` on ok and the encoding, times in turns and at
a few batch sizes, and counts the window loop's instructions.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.tools import k3_compare


def packed_main_path(dev: torch.device) -> tuple:
    """The 10,000-validator ed25519 commit's rows, packed and uploaded:
    ``ec.packed_inputs``'s eight device inputs, before K1."""
    n = k3_compare.N_ROWS
    sc_ = tc.build_commit(n)
    pubs = np.frombuffer(b"".join(v.pub_key.bytes() for v in sc_.valset.validators),
                         np.uint8).reshape(n, 32)
    sigs = np.frombuffer(b"".join(pc.signature for pc in sc_.commit.precommits),
                         np.uint8).reshape(n, 64)
    msgs = [pc.sign_bytes(sc_.chain_id) for pc in sc_.commit.precommits]
    neg_ax, ay, valid = ec._decompress_valset(pubs)
    if not valid.all():
        raise SystemExit("a validator key did not decompress")
    return ec.packed_inputs(pubs, msgs, sigs, neg_ax, ay, valid, len(msgs[0]), dev)[0]


def main_path_inputs(dev: torch.device) -> tuple:
    """The main-path rows run through K1: K2's seven inputs."""
    consts, negax, ay, pubw, sigw, tmpl, vidx, vwords = packed_main_path(dev)
    return (consts, negax, ay, *ec.prologue(tmpl, vidx, vwords, pubw, sigw))


# the window loop's inner loops: 4 doublings, then 2 adds (the tree's
# kernel); 4 doublings and the adds inline (one thread a row)
K2 = k3_compare.Ladder("ed25519_ladder", 7, (0, 8), ec.k2_geometry, ec.ladder_ref,
                       main_path_inputs, ((4, 2), (4,)))


if __name__ == "__main__":
    sys.exit(k3_compare.compare(K2, sys.argv[1:]))
