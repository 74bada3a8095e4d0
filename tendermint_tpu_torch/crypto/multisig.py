"""k-of-n threshold multisig public key and compact bit array.

The port's copy of the JAX package's ``crypto/multisig.py``, which mirrors
crypto/multisig/threshold_pubkey.go:34 (VerifyBytes walks the
sub-signatures in pubkey order, guided by a compact bit array) and
crypto/multisig/bitarray/compact_bit_array.go.

A batch of multisig aggregates decomposes into the flat (pubkey, msg, sig)
rows the ed25519 kernels take: ``PubKeyMultisigThreshold.flatten`` gives
them, and ``crypto/batch.verify_generic`` sends every flagged signer's
sub-signature through the same ed25519 call.

The verdicts are the reference's, including where it differs from Go: a
multisignature that carries more signatures than the key has sub-keys
(size 3, k 2, five signatures, two bits set) is accepted by
``verify_bytes`` and ``flatten`` here, as in the reference, where Go's
``VerifyBytes`` (threshold_pubkey.go:46) rejects ``len(sigs) > size``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from tendermint_tpu_torch.crypto.hashing import tmhash_truncated
from tendermint_tpu_torch.crypto.keys import PubKey

ED25519_TYPE = "tendermint/PubKeyEd25519"


class CompactBitArray:
    """Bit array with minimal byte storage (cf. compact_bit_array.go)."""

    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative size")
        self.bits = bits
        self.elems = bytearray((bits + 7) // 8)

    def get_index(self, i: int) -> bool:
        if i < 0 or i >= self.bits:
            return False
        return bool(self.elems[i >> 3] & (1 << (7 - (i % 8))))

    def set_index(self, i: int, v: bool) -> bool:
        if i < 0 or i >= self.bits:
            return False
        if v:
            self.elems[i >> 3] |= 1 << (7 - (i % 8))
        else:
            self.elems[i >> 3] &= ~(1 << (7 - (i % 8))) & 0xFF
        return True

    def num_true_bits_before(self, index: int) -> int:
        return sum(1 for i in range(index) if self.get_index(i))

    def count(self) -> int:
        return self.num_true_bits_before(self.bits)

    def __eq__(self, other):
        return (
            isinstance(other, CompactBitArray)
            and self.bits == other.bits
            and self.elems == other.elems
        )

    def to_bytes(self) -> bytes:
        return self.bits.to_bytes(4, "big") + bytes(self.elems)

    @staticmethod
    def from_bytes(data: bytes) -> "CompactBitArray":
        bits = int.from_bytes(data[:4], "big")
        ba = CompactBitArray(bits)
        ba.elems = bytearray(data[4: 4 + (bits + 7) // 8])
        return ba


@dataclass
class Multisignature:
    """Ordered sub-signatures and the signers' bitmap (cf. multisignature.go)."""

    bitarray: CompactBitArray
    sigs: List[bytes] = field(default_factory=list)

    @staticmethod
    def new(n: int) -> "Multisignature":
        return Multisignature(CompactBitArray(n))

    def add_signature_from_pubkey(
        self, sig: bytes, pubkey: PubKey, keys: Sequence[PubKey]
    ) -> None:
        index = next((i for i, k in enumerate(keys) if k.equals(pubkey)), -1)
        if index < 0:
            raise ValueError("pubkey not in multisig key set")
        new_sig_index = self.bitarray.num_true_bits_before(index)
        if self.bitarray.get_index(index):
            self.sigs[new_sig_index] = sig  # replace
            return
        self.bitarray.set_index(index, True)
        self.sigs.insert(new_sig_index, sig)

    def marshal(self) -> bytes:
        out = self.bitarray.to_bytes()
        out += len(self.sigs).to_bytes(2, "big")
        for s in self.sigs:
            out += len(s).to_bytes(2, "big") + s
        return out

    @staticmethod
    def unmarshal(data: bytes) -> "Multisignature":
        ba = CompactBitArray.from_bytes(data)
        off = 4 + (ba.bits + 7) // 8
        nsigs = int.from_bytes(data[off: off + 2], "big")
        off += 2
        sigs = []
        for _ in range(nsigs):
            ln = int.from_bytes(data[off: off + 2], "big")
            off += 2
            sigs.append(data[off: off + ln])
            off += ln
        return Multisignature(ba, sigs)


@dataclass(frozen=True)
class PubKeyMultisigThreshold(PubKey):
    """k-of-n threshold key (cf. threshold_pubkey.go:11)."""

    k: int
    pubkeys: Tuple[PubKey, ...]
    type_name = "tendermint/PubKeyMultisigThreshold"

    def __post_init__(self):
        if self.k <= 0:
            raise ValueError("threshold k must be positive")
        if len(self.pubkeys) < self.k:
            raise ValueError("threshold k cannot exceed number of keys")

    def address(self) -> bytes:
        return tmhash_truncated(self.bytes())

    def bytes(self) -> bytes:
        out = self.k.to_bytes(4, "big") + len(self.pubkeys).to_bytes(4, "big")
        for pk in self.pubkeys:
            tb = pk.type_name.encode()
            out += len(tb).to_bytes(1, "big") + tb
            kb = pk.bytes()
            out += len(kb).to_bytes(2, "big") + kb
        return out

    def verify_bytes(self, msg: bytes, sig: bytes) -> bool:
        try:
            multisig = Multisignature.unmarshal(sig)
        except Exception:
            return False
        size = multisig.bitarray.bits
        if len(self.pubkeys) != size:
            return False
        if len(multisig.sigs) < self.k:
            return False
        # adversarial bytes can flag more signers than signatures supplied:
        # reject instead of indexing out of range. count < len(sigs)
        # (unused trailing signatures) stays accepted, as in the reference
        if multisig.bitarray.count() > len(multisig.sigs):
            return False
        # each flagged signer must verify (threshold_pubkey.go:41-55)
        sig_index = 0
        for i in range(size):
            if multisig.bitarray.get_index(i):
                if not self.pubkeys[i].verify_bytes(msg, multisig.sigs[sig_index]):
                    return False
                sig_index += 1
        return sig_index >= self.k

    def flatten(
        self, msg: bytes, sig: bytes
    ) -> Optional[List[Tuple[bytes, bytes, bytes]]]:
        """(pubkey32, msg, sig64) rows for the ed25519 batch path; None if
        the aggregate is structurally invalid or a flagged sub-key is not
        ed25519."""
        try:
            multisig = Multisignature.unmarshal(sig)
        except Exception:
            return None
        if multisig.bitarray.bits != len(self.pubkeys):
            return None
        if len(multisig.sigs) < self.k:
            return None
        if multisig.bitarray.count() > len(multisig.sigs):
            return None  # as verify_bytes' out-of-range rejection
        out = []
        sig_index = 0
        for i in range(len(self.pubkeys)):
            if multisig.bitarray.get_index(i):
                pk = self.pubkeys[i]
                if pk.type_name != ED25519_TYPE:
                    return None
                if sig_index >= len(multisig.sigs):
                    return None
                sub = multisig.sigs[sig_index]
                if len(sub) != 64:
                    # a short sub-signature would not pack into the batch's
                    # (n, 64) rows: the host path decides it (False)
                    return None
                out.append((pk.bytes(), msg, sub))
                sig_index += 1
        return out

    def __hash__(self):
        return hash((self.k, self.pubkeys))
