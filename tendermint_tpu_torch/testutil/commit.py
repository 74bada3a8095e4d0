"""Seeded inputs for the port's tests and ``chip_smoke.py``.

``build_commit`` makes a signed N-validator ``Commit`` the way the
repository's headline bench does (``bench.py:_build_commit``): every
precommit votes one block id, and the canonical sign-bytes differ only in
the fixed64 timestamp. Validators hold ed25519 keys, secp256k1 keys, or a
seeded mix. ``go_edge_window`` makes a 20-row batch that holds every Go
verification edge the ed25519 kernels must honour; ``secp_edge_window``
the corruption matrix the secp256k1 path must honour.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto import secp256k1 as secp
from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519, PubKeySecp256k1
from tendermint_tpu_torch.testutil import secp_signer
from tendermint_tpu_torch.types.block import Commit
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote

CHAIN_ID = "bench-chain"
HEIGHT = 500
TIMESTAMP0 = 1_700_000_000_000_000_000


@dataclass
class SignedCommit:
    valset: ValidatorSet
    block_id: BlockID
    commit: Commit
    privs: List[bytes]  # in validator-set order; 64 bytes ed25519, 32 secp256k1
    chain_id: str = CHAIN_ID
    height: int = HEIGHT


KEY_TYPES = ("ed25519", "secp256k1", "mixed")


def pub_key(priv: bytes):
    """The public key object of a fixture private key."""
    if len(priv) == 64:
        return PubKeyEd25519(priv[32:])
    return PubKeySecp256k1(secp_signer.pubkey_compressed(priv))


def sign(priv: bytes, msg: bytes) -> bytes:
    """Sign as the key's type signs: ed25519 over msg, secp256k1 DER over
    SHA-256(msg)."""
    if len(priv) == 64:
        return ed.sign(priv, msg)
    return secp_signer.sign(priv, sha256(msg))


def build_commit(n: int, seed: int = 42, power: int = 10,
                 key_type: str = "ed25519") -> SignedCommit:
    """A commit signed by all n validators of a seeded set. ``key_type``
    "mixed" draws each validator's key type from the seed."""
    if key_type not in KEY_TYPES:
        raise ValueError(f"key_type must be one of {KEY_TYPES}, got {key_type!r}")
    rng = np.random.default_rng(seed)
    raw = rng.bytes(32 * n)
    seeds = [raw[32 * i: 32 * (i + 1)] for i in range(n)]
    block_id = BlockID(b"\xaa" * 32, PartSetHeader(1, b"\xbb" * 32))
    if key_type == "mixed":
        is_secp = rng.integers(0, 2, n).astype(bool)
    else:
        is_secp = np.full(n, key_type == "secp256k1")
    privs = [secp.gen_privkey(s) if k else ed.gen_privkey(s)
             for s, k in zip(seeds, is_secp)]
    pubs = [pub_key(p) for p in privs]
    by_addr = {pk.address(): p for pk, p in zip(pubs, privs)}
    valset = ValidatorSet([Validator(pk, power) for pk in pubs])
    ordered = [by_addr[v.address] for v in valset.validators]
    votes = []
    for i, (val, priv) in enumerate(zip(valset.validators, ordered)):
        vote = Vote(
            vote_type=SignedMsgType.PRECOMMIT,
            height=HEIGHT,
            round=0,
            timestamp_ns=TIMESTAMP0 + i * 1_000,
            block_id=block_id,
            validator_address=val.address,
            validator_index=i,
        )
        votes.append(vote.with_signature(sign(priv, vote.sign_bytes(CHAIN_ID))))
    return SignedCommit(valset, block_id, Commit(block_id, votes), ordered)


def flip_signature_bit(commit: Commit, index: int, bit: int = 0) -> Commit:
    """The commit with one bit of precommit ``index``'s signature flipped."""
    pcs = list(commit.precommits)
    sig = bytearray(pcs[index].signature)
    sig[bit // 8] ^= 1 << (bit % 8)
    pcs[index] = pcs[index].with_signature(bytes(sig))
    return Commit(commit.block_id, pcs)


def drop_precommits(commit: Commit, keep: int) -> Commit:
    """The commit with every precommit after the first ``keep`` set to nil."""
    pcs = [pc if i < keep else None for i, pc in enumerate(commit.precommits)]
    return Commit(commit.block_id, pcs)


def stray_vote(sc: SignedCommit, index: int) -> Commit:
    """The commit with precommit ``index`` re-signed for another block id:
    it counts for availability but not for power."""
    other = BlockID(b"\xcc" * 32, PartSetHeader(1, b"\xdd" * 32))
    pcs = list(sc.commit.precommits)
    vote = replace(pcs[index], block_id=other, signature=b"")
    pcs[index] = vote.with_signature(
        sign(sc.privs[index], vote.sign_bytes(sc.chain_id)))
    return Commit(sc.commit.block_id, pcs)


# ---------------------------------------------------------------------------
# The Go-edge window
# ---------------------------------------------------------------------------

IDENTITY_KEY = (1).to_bytes(32, "little")  # y = 1, x = 0


# Two message lengths on either side of the one-block limit: R || A || M
# fits one SHA-512 block up to 111 bytes, so M of 47 bytes takes one block
# and M of 48 takes two.
EDGE_LENGTHS = (47, 48)


def _msg(rng, tag: bytes, i: int) -> bytes:
    ln = EDGE_LENGTHS[i % 2]
    return (tag + b"-" + rng.bytes(ln))[:ln]


def _signed(rng, n: int) -> Tuple[List[bytes], List[bytes], List[bytes]]:
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        priv = ed.gen_privkey(rng.bytes(32))
        msg = _msg(rng, b"edge-%d" % i, i)
        pubs.append(priv[32:])
        msgs.append(msg)
        sigs.append(ed.sign(priv, msg))
    return pubs, msgs, sigs


def _sig_for_identity_key(rng, pub: bytes) -> Tuple[bytes, bytes]:
    """A message and signature that Go accepts under a key whose point is
    the identity: [h](-A) vanishes, so R = enc([s]B) verifies for any h."""
    s = int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) % ed.L
    R = ed.pt_encode(ed._mul_b(s))
    return _msg(rng, b"identity-key", 0), R + s.to_bytes(32, "little")


def _undecompressable_key() -> bytes:
    y = 2
    while ed._decompress_xy(y.to_bytes(32, "little")) is not None:
        y += 1
    return y.to_bytes(32, "little")


def _order8_key() -> bytes:
    """A key of order exactly 8: [L]Q for a decompressed Q lies in the
    torsion subgroup; keep the first whose [4]-multiple is not the identity."""
    y = 2
    while True:
        q = ed._decompress_xy(y.to_bytes(32, "little"))
        y += 1
        if q is None:
            continue
        a = ed.pt_scalar_mult(ed._to_extended(q), ed.L)
        four = ed.pt_scalar_mult(a, 4)
        eight = ed.pt_double(four)
        if ed.pt_affine(eight) == (0, 1) and ed.pt_affine(four) != (0, 1):
            return ed.pt_encode(a)


def _sig_for_order8_key(rng, pub: bytes) -> Tuple[bytes, bytes]:
    """R = enc([s]B) with the message chosen so that h = 0 (mod 8): then
    [h](-A) is the identity and Go accepts; this holds only if h is
    reduced exactly mod L before the ladder."""
    import hashlib

    s = int(rng.integers(1, 1 << 62)) % ed.L
    R = ed.pt_encode(ed._mul_b(s))
    for i in range(256):
        msg = _msg(rng, b"order-8-%d" % i, 1)
        h = int.from_bytes(hashlib.sha512(R + pub + msg).digest(), "little") % ed.L
        if h % 8 == 0:
            return msg, R + s.to_bytes(32, "little")
    raise RuntimeError("no message with h = 0 mod 8")


EDGE_ROWS = {  # row -> (what it is, Go's verdict where fixed by construction)
    10: ("forged s", False),
    11: ("mutant R", False),
    12: ("s + L (malleability zone)", True),
    13: ("sig[63] |= 0xE0", False),
    14: ("R = enc(p + 1), non-canonical", False),
    15: ("signed under another key", False),
    16: ("identity key, R = enc([s]B)", True),
    17: ("non-canonical identity key y = p + 1", True),
    18: ("key that fails decompression", False),
    19: ("order-8 key, h = 0 mod 8", None),
}


def go_edge_window(seed: int = 0) -> Tuple[List[bytes], List[bytes], List[bytes], Dict[int, Optional[bool]]]:
    """20 rows: 10 clean signatures and the edges of ``EDGE_ROWS``. Returns
    (pubs, msgs, sigs, verdicts) where verdicts maps each row to Go's
    verdict when it is fixed by construction (None: ask the oracle)."""
    rng = np.random.default_rng(seed)
    pubs, msgs, sigs = _signed(rng, 16)
    sigs = [bytearray(s) for s in sigs]
    sigs[10][40] ^= 1
    sigs[11][3] ^= 1
    s12 = int.from_bytes(bytes(sigs[12][32:]), "little")
    sigs[12][32:] = (s12 + ed.L).to_bytes(32, "little")  # < 2^253: top bits clear
    sigs[13][63] |= 0xE0
    sigs[14][:32] = (ed.P + 1).to_bytes(32, "little")
    pubs[15] = pubs[0]
    sigs = [bytes(s) for s in sigs]

    for pub in (IDENTITY_KEY, (ed.P + 1).to_bytes(32, "little")):
        msg, sig = _sig_for_identity_key(rng, pub)
        pubs.append(pub)
        msgs.append(msg)
        sigs.append(sig)
    pubs.append(_undecompressable_key())
    msgs.append(_msg(rng, b"bad-key", 1))
    sigs.append(sigs[0])
    pub8 = _order8_key()
    msg, sig = _sig_for_order8_key(rng, pub8)
    pubs.append(pub8)
    msgs.append(msg)
    sigs.append(sig)

    verdicts: Dict[int, Optional[bool]] = {i: True for i in range(10)}
    verdicts.update({i: v for i, (_, v) in EDGE_ROWS.items()})
    return pubs, msgs, sigs, verdicts


def go_edge_window_spec(seed: int = 3):
    """``go_edge_window``'s 20 rows as one planner window of 4 heights x 5
    validators with seeded powers: (votes, powers, totals, verdicts), the
    verdicts keyed by row-major lane."""
    pubs, msgs, sigs, verdicts = go_edge_window(seed=seed)
    votes = [[(pubs[5 * h + v], msgs[5 * h + v], sigs[5 * h + v]) for v in range(5)]
             for h in range(4)]
    powers = [[(h + v) % 9 + 1 for v in range(5)] for h in range(4)]
    return votes, powers, [sum(p) for p in powers], verdicts


# ---------------------------------------------------------------------------
# The secp256k1 edge window
# ---------------------------------------------------------------------------

SECP_EDGE_ROWS = {  # row -> (what it is, the oracle's verdict)
    10: ("s xor 1", False),
    11: ("wrong digest", False),
    12: ("signed under another key", False),
    13: ("malformed DER", False),
    14: ("high s (n - s)", False),
    15: ("r = 0", False),
    16: ("r = n", False),
    17: ("s = 0", False),
    18: ("key x = 0, off the curve", False),
    19: ("key with the wrong parity prefix", False),
    20: ("zero digest: u1 = 0, the host oracle decides", True),
    21: ("r with a redundant leading zero byte (lenient DER)", True),
    22: ("truncated DER", False),
}


def secp_edge_window(seed: int = 0) -> Tuple[List[bytes], List[bytes], List[bytes], Dict[int, bool]]:
    """23 rows at the digest level: 10 clean signatures and the edges of
    ``SECP_EDGE_ROWS`` (the corruption matrix of the JAX package's
    secp256k1 tests and the range, parity and DER edges). Returns (pubs,
    digests, sigs, verdicts), verdicts mapping every row to the verdict of
    ``crypto.secp256k1.verify``."""
    rng = np.random.default_rng(seed)
    privs = [secp.gen_privkey(rng.bytes(32)) for _ in range(22)]
    pubs = [secp_signer.pubkey_compressed(p) for p in privs]
    digs = [sha256(b"secp-edge-%d-" % i + rng.bytes(16)) for i in range(22)]
    digs[20] = bytes(32)
    sigs = [secp_signer.sign(p, d) for p, d in zip(privs, digs)]
    parsed = [secp.der_decode_sig(s) for s in sigs]

    r, s = parsed[10]
    sigs[10] = secp.der_encode_sig(r, s ^ 1)
    digs[11] = sha256(b"not the signed digest")
    pubs[12] = pubs[0]
    sigs[13] = b"\x30\x02\x01\x01"
    r, s = parsed[14]
    sigs[14] = secp.der_encode_sig(r, secp.N - s)
    sigs[15] = secp.der_encode_sig(0, parsed[15][1])
    sigs[16] = secp.der_encode_sig(secp.N, parsed[16][1])
    sigs[17] = secp.der_encode_sig(parsed[17][0], 0)
    pubs[18] = b"\x02" + bytes(32)
    pubs[19] = bytes([pubs[19][0] ^ 1]) + pubs[19][1:]
    r, s = parsed[21]
    rb = secp._der_int(r)[2:]
    body = b"\x02" + bytes([len(rb) + 1]) + b"\x00" + rb + secp._der_int(s)
    sigs[21] = b"\x30" + bytes([len(body)]) + body
    pubs.append(pubs[1])
    digs.append(digs[1])
    sigs.append(sigs[1][:-1])

    verdicts = {i: True for i in range(10)}
    verdicts.update({i: v for i, (_, v) in SECP_EDGE_ROWS.items()})
    return pubs, digs, sigs, verdicts
