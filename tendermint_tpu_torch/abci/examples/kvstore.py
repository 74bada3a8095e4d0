"""The signed-transaction codec of the example kvstore (the port's copy of
the signed-tx part of the reference package's ``abci/examples/kvstore.py``):
every tx carries a sender key (ed25519 or secp256k1), a per-sender nonce
and a signature over canonical sign-bytes. ``extract_signed_tx_sig`` is the
mempool's signature extractor, which ``mempool/tx_verify.BatchTxVerifier``
feeds to ``parallel/planner.TxFeed``. ``SignedKVStoreApp`` and the mempool
are not ported yet (ROADMAP queue 1 item 13 (ii)).

Wire format (integers big-endian):

    tx         = MAGIC | algo(1) | publen(1) | pub | nonce(8) |
                 siglen(2) | sig | payload
    sign_bytes = MAGIC | algo(1) | publen(1) | pub | nonce(8) | payload

so the sign-bytes are the tx without its signature field, and any payload
or nonce mutation invalidates the signature.
"""

from __future__ import annotations

import struct
from typing import Optional

from tendermint_tpu_torch.crypto.keys import (
    PrivKeySecp256k1,
    PubKeyEd25519,
    PubKeySecp256k1,
)

SIGNED_TX_MAGIC = b"stx1"
ALGO_ED25519 = 0
ALGO_SECP256K1 = 1

# CheckTx / DeliverTx reject codes (any nonzero code rejects; the split is
# for tests and operators)
CODE_BAD_TX = 0x51  # undecodable, wrong magic, bad lengths
CODE_BAD_SIG = 0x52  # the signature does not verify over the sign-bytes
CODE_BAD_NONCE = 0x53  # the nonce is not the sender's last one + 1


class SignedTx:
    """A decoded signed transaction."""

    __slots__ = ("algo", "pub", "nonce", "sig", "payload", "sign_bytes")

    def __init__(self, algo, pub, nonce, sig, payload, sign_bytes):
        self.algo = algo
        self.pub = pub
        self.nonce = nonce
        self.sig = sig
        self.payload = payload
        self.sign_bytes = sign_bytes


def signed_tx_sign_bytes(algo: int, pub: bytes, nonce: int,
                         payload: bytes) -> bytes:
    """The canonical sign-bytes: the encoded tx without its signature."""
    return (SIGNED_TX_MAGIC + bytes([algo, len(pub)]) + pub
            + struct.pack(">Q", nonce) + payload)


def encode_signed_tx(algo: int, pub: bytes, nonce: int, sig: bytes,
                     payload: bytes) -> bytes:
    return (SIGNED_TX_MAGIC + bytes([algo, len(pub)]) + pub
            + struct.pack(">Q", nonce) + struct.pack(">H", len(sig)) + sig
            + payload)


def make_signed_tx(priv, nonce: int, payload: bytes) -> bytes:
    """Sign ``payload`` with a ``PrivKeyEd25519`` or ``PrivKeySecp256k1``."""
    algo = (ALGO_SECP256K1 if isinstance(priv, PrivKeySecp256k1)
            else ALGO_ED25519)
    pub = priv.pub_key().bytes()
    sig = priv.sign(signed_tx_sign_bytes(algo, pub, nonce, payload))
    return encode_signed_tx(algo, pub, nonce, sig, payload)


def decode_signed_tx(tx: bytes) -> Optional[SignedTx]:
    """None on any structural defect (the app answers CODE_BAD_TX)."""
    if len(tx) < len(SIGNED_TX_MAGIC) + 2 or not tx.startswith(SIGNED_TX_MAGIC):
        return None
    off = len(SIGNED_TX_MAGIC)
    algo = tx[off]
    publen = tx[off + 1]
    off += 2
    if algo == ALGO_ED25519:
        if publen != 32:
            return None
    elif algo == ALGO_SECP256K1:
        if publen != 33:
            return None
    else:
        return None
    if len(tx) < off + publen + 8 + 2:
        return None
    pub = tx[off:off + publen]
    off += publen
    (nonce,) = struct.unpack_from(">Q", tx, off)
    off += 8
    (siglen,) = struct.unpack_from(">H", tx, off)
    off += 2
    if len(tx) < off + siglen:
        return None
    sig = tx[off:off + siglen]
    payload = tx[off + siglen:]
    return SignedTx(
        algo, pub, nonce, sig, payload,
        signed_tx_sign_bytes(algo, pub, nonce, payload),
    )


def extract_signed_tx_sig(tx: bytes):
    """The mempool's signature extractor: ``tx -> (PubKey, sign_bytes,
    sig)``, or None when the tx is not a well-formed signed tx (the app
    then decides its verdict serially). Key objects let ``verify_generic``
    route each algorithm to its kernel."""
    stx = decode_signed_tx(tx)
    if stx is None:
        return None
    if stx.algo == ALGO_ED25519:
        pk = PubKeyEd25519(stx.pub)
    else:
        pk = PubKeySecp256k1(stx.pub)
    return pk, stx.sign_bytes, stx.sig
