"""A seeded k-of-n multisig validator set for the port's tests and
``chip_smoke.py``.

``build`` makes the configuration of the reference's
``scripts/bench_multisig.py`` (BASELINE.json config 5, "1k multisig
validators"), byte for byte: seed 7; for each of 1,000 validators, five
ed25519 sub-keys from the seed, a 3-of-5 ``PubKeyMultisigThreshold`` over
them, one message ``b"multisig-bench|%08d|"`` followed by 89 seeded bytes,
and a ``Multisignature`` of the first three sub-keys over it. Smaller
sizes serve the tests. ``flip_sub_signature`` and ``below_threshold``
plant a bad sub-signature and a structurally bad aggregate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519
from tendermint_tpu_torch.crypto.multisig import Multisignature, PubKeyMultisigThreshold

N_VALS, K, N_KEYS, SEED = 1000, 3, 5, 7
MSG_TAIL = 89  # seeded bytes after the message's prefix
FLIP_BIT = 300  # inside s: the sub-signature keeps its shape and fails


@dataclass
class MultisigSet:
    pubkeys: List[PubKeyMultisigThreshold]
    msgs: List[bytes]
    sigs: List[bytes]  # marshalled Multisignatures


def build(n_vals: int = N_VALS, k: int = K, n_keys: int = N_KEYS,
          seed: int = SEED) -> MultisigSet:
    """n_vals validators, each a k-of-n_keys ed25519 threshold key whose
    first k sub-keys sign the validator's message."""
    rng = np.random.default_rng(seed)
    pubkeys, msgs, sigs = [], [], []
    for v in range(n_vals):
        privs = [ed.gen_privkey(rng.bytes(32)) for _ in range(n_keys)]
        subkeys = tuple(PubKeyEd25519(p[32:]) for p in privs)
        msg = b"multisig-bench|%08d|" % v + rng.bytes(MSG_TAIL)
        ms = Multisignature.new(n_keys)
        for j in range(k):
            ms.add_signature_from_pubkey(ed.sign(privs[j], msg), subkeys[j], subkeys)
        pubkeys.append(PubKeyMultisigThreshold(k, subkeys))
        msgs.append(msg)
        sigs.append(ms.marshal())
    return MultisigSet(pubkeys, msgs, sigs)


def flip_sub_signature(blob: bytes, j: int = 0) -> bytes:
    """The aggregate with a bit inside s of its j-th sub-signature flipped:
    it stays well-formed and must fail."""
    ms = Multisignature.unmarshal(blob)
    sub = bytearray(ms.sigs[j])
    sub[FLIP_BIT // 8] ^= 1 << (FLIP_BIT % 8)
    ms.sigs[j] = bytes(sub)
    return ms.marshal()


def below_threshold(blob: bytes) -> bytes:
    """The aggregate without its last flagged signer: one signature fewer
    than k, which ``flatten`` refuses (the host's ``verify_bytes`` decides
    it, False)."""
    ms = Multisignature.unmarshal(blob)
    last = max(i for i in range(ms.bitarray.bits) if ms.bitarray.get_index(i))
    ms.bitarray.set_index(last, False)
    ms.sigs.pop()
    return ms.marshal()
