"""FilePV — disk-backed validator signer with double-sign protection
(ref: privval/priv_validator.go; the port's copy of the reference package's
``privval/file_pv.py``: a file written by either package loads in the
other).

Persists the key and the last-signed height/round/step (+ last signature and
sign bytes).  Signing regresses are refused; re-signing at the SAME HRS is
allowed only when the payload differs solely by timestamp (the reference's
checkVotesOnlyDifferByTimestamp, :315-338) — then the previous timestamp and
signature are reused.
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519, PubKey
from tendermint_tpu_torch.types.priv_validator import PrivValidator
from tendermint_tpu_torch.types.proposal import Heartbeat, Proposal
from tendermint_tpu_torch.types.vote import Vote

STEP_NONE = 0
STEP_PROPOSE = 1  # the proposal precedes votes within a round
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_VOTE_TO_STEP = {0x01: STEP_PREVOTE, 0x02: STEP_PRECOMMIT}


class DoubleSignError(Exception):
    pass


def _atomic_write(path: str, data: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _timestamp_offset(sign_bytes: bytes) -> int:
    t = sign_bytes[0]
    n_before = 3 if t == 0x20 else 2  # fixed64s before the timestamp
    return 1 + 8 * n_before


def _extract_timestamp(sign_bytes: bytes) -> int:
    import struct

    off = _timestamp_offset(sign_bytes)
    return struct.unpack("<q", sign_bytes[off : off + 8])[0]


def _strip_timestamp(sign_bytes: bytes) -> bytes:
    """Zero the fixed64 timestamp in canonical vote/proposal sign bytes so
    payloads can be compared net of time.

    Layout (types/core.py): uvarint(type) fixed64(height) fixed64(round)
    [fixed64(pol_round) for proposals] fixed64(timestamp) ...
    The timestamp is the LAST fixed64 before the block id: for votes it is the
    3rd fixed64, for proposals the 4th.  Type byte 0x20 = proposal.
    """
    if not sign_bytes:
        return sign_bytes
    # uvarint type is a single byte for all our msg types (< 0x80)
    off = _timestamp_offset(sign_bytes)
    return sign_bytes[:off] + b"\x00" * 8 + sign_bytes[off + 8 :]


class FilePV(PrivValidator):
    def __init__(self, priv_key: PrivKeyEd25519, file_path: str):
        self._priv = priv_key
        self.file_path = file_path
        self.last_height = 0
        self.last_round = 0
        self.last_step = STEP_NONE
        self.last_signature: bytes = b""
        self.last_sign_bytes: bytes = b""
        self._mtx = threading.Lock()

    # persistence ----------------------------------------------------------
    @classmethod
    def generate(cls, file_path: str, seed: Optional[bytes] = None) -> "FilePV":
        pv = cls(PrivKeyEd25519.generate(seed), file_path)
        pv.save()
        return pv

    @classmethod
    def load(cls, file_path: str) -> "FilePV":
        with open(file_path) as f:
            obj = json.load(f)
        priv = PrivKeyEd25519(base64.b64decode(obj["priv_key"]))
        pv = cls(priv, file_path)
        pv.last_height = obj.get("last_height", 0)
        pv.last_round = obj.get("last_round", 0)
        pv.last_step = obj.get("last_step", STEP_NONE)
        pv.last_signature = base64.b64decode(obj.get("last_signature", ""))
        pv.last_sign_bytes = base64.b64decode(obj.get("last_signbytes", ""))
        return pv

    @classmethod
    def load_or_generate(cls, file_path: str, seed: Optional[bytes] = None) -> "FilePV":
        if os.path.exists(file_path):
            return cls.load(file_path)
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
        return cls.generate(file_path, seed)

    def save(self) -> None:
        obj = {
            "address": self.get_pub_key().address().hex(),
            "pub_key": base64.b64encode(self.get_pub_key().bytes()).decode(),
            "priv_key": base64.b64encode(self._priv.bytes()).decode(),
            "last_height": self.last_height,
            "last_round": self.last_round,
            "last_step": self.last_step,
            "last_signature": base64.b64encode(self.last_signature).decode(),
            "last_signbytes": base64.b64encode(self.last_sign_bytes).decode(),
        }
        _atomic_write(self.file_path, json.dumps(obj, indent=2))

    def reset(self) -> None:
        """Danger: forget last-sign state (reset_priv_validator CLI)."""
        self.last_height = 0
        self.last_round = 0
        self.last_step = STEP_NONE
        self.last_signature = b""
        self.last_sign_bytes = b""
        self.save()

    # PrivValidator --------------------------------------------------------
    def get_pub_key(self) -> PubKey:
        return self._priv.pub_key()

    def _check_hrs(self, height: int, round: int, step: int) -> bool:
        """Returns True if this is the SAME HRS as last signed (caller applies
        the timestamp-only rule); raises on regression
        (priv_validator.go:176)."""
        if self.last_height > height:
            raise DoubleSignError("height regression")
        if self.last_height == height:
            if self.last_round > round:
                raise DoubleSignError("round regression")
            if self.last_round == round:
                if self.last_step > step:
                    raise DoubleSignError("step regression")
                if self.last_step == step:
                    if not self.last_sign_bytes:
                        raise DoubleSignError("no last_sign_bytes at same HRS")
                    return True
        return False

    def _sign_checked(
        self, height: int, round: int, step: int, sign_bytes: bytes
    ) -> Tuple[bytes, bytes]:
        """Returns (sign_bytes_actually_signed, signature)."""
        with self._mtx:
            same_hrs = self._check_hrs(height, round, step)
            if same_hrs:
                if sign_bytes == self.last_sign_bytes:
                    return self.last_sign_bytes, self.last_signature
                if _strip_timestamp(sign_bytes) == _strip_timestamp(self.last_sign_bytes):
                    # differs only by timestamp: reuse previous sig + bytes
                    return self.last_sign_bytes, self.last_signature
                raise DoubleSignError(
                    f"conflicting data at H/R/S {height}/{round}/{step}"
                )
            sig = self._priv.sign(sign_bytes)
            self.last_height = height
            self.last_round = round
            self.last_step = step
            self.last_signature = sig
            self.last_sign_bytes = sign_bytes
            self.save()
            return sign_bytes, sig

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        step = _VOTE_TO_STEP[int(vote.vote_type)]
        sb = vote.sign_bytes(chain_id)
        signed_bytes, sig = self._sign_checked(vote.height, vote.round, step, sb)
        if signed_bytes != sb:
            # timestamp-only re-sign: the wire vote must carry the ORIGINAL
            # timestamp the signature covers
            import dataclasses

            vote = dataclasses.replace(
                vote, timestamp_ns=_extract_timestamp(signed_bytes)
            )
        return vote.with_signature(sig)

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        sb = proposal.sign_bytes(chain_id)
        signed_bytes, sig = self._sign_checked(
            proposal.height, proposal.round, STEP_PROPOSE, sb
        )
        if signed_bytes != sb:
            import dataclasses

            proposal = dataclasses.replace(
                proposal, timestamp_ns=_extract_timestamp(signed_bytes)
            )
        return proposal.with_signature(sig)

    def sign_heartbeat(self, chain_id: str, heartbeat: Heartbeat) -> Heartbeat:
        with self._mtx:
            sig = self._priv.sign(heartbeat.sign_bytes(chain_id))
        return heartbeat.with_signature(sig)
