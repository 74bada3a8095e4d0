"""The example apps and the signed-transaction codec (ref
abci/example/kvstore/kvstore.go, counter/counter.go): the port's copy of
the reference package's ``abci/examples/kvstore.py``:

  * ``KVStoreApp``: an in-memory key=value store whose app hash is the
    merkle root over its sorted pairs;
  * ``PersistentKVStoreApp``: the store persisted in a key-value store
    with validator-set changes: InitChain seeds the validators, a
    ``val:PUBKEY!POWER`` DeliverTx stages an update, EndBlock returns
    them; with ``configure_snapshots`` it produces state-sync snapshots
    of its committed blob every N heights on a worker thread, and it
    serves and restores them through the four snapshot calls;
  * ``PriorityKVStoreApp``: a ``pri<N>:`` payload prefix is its CheckTx
    priority (the mempool's lanes);
  * ``SignedKVStoreApp``: every tx carries a sender key (ed25519 or
    secp256k1), a per-sender nonce and a signature over canonical
    sign-bytes, checked on CheckTx and DeliverTx. CheckTx trusts
    ``RequestCheckTx.sig_verified`` when the mempool's batched hook
    verified the signature, and counts every serial verify it pays in
    ``serial_verifies``;
  * ``CounterApp``: serial-number txs (the CheckTx/DeliverTx split).

``extract_signed_tx_sig`` is the mempool's signature extractor, which
``mempool/tx_verify.BatchTxVerifier`` feeds to ``parallel/planner.TxFeed``.

Wire format (integers big-endian):

    tx         = MAGIC | algo(1) | publen(1) | pub | nonce(8) |
                 siglen(2) | sig | payload
    sign_bytes = MAGIC | algo(1) | publen(1) | pub | nonce(8) | payload

so the sign-bytes are the tx without its signature field, and any payload
or nonce mutation invalidates the signature.
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import struct
import threading
from typing import Dict, List, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.crypto import ed25519 as _ed
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto import secp256k1 as _secp
from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.crypto.keys import (
    PrivKeySecp256k1,
    PubKeyEd25519,
    PubKeySecp256k1,
)
from tendermint_tpu_torch.libs.db.kv import MemDB

VALIDATOR_TX_PREFIX = b"val:"

class KVStoreApp(abci.Application):
    """tx ``key=value`` (or ``v`` alone: v=v); the app hash is the merkle
    root over the sorted ``key=value`` pairs."""

    def __init__(self):
        self.state: Dict[bytes, bytes] = {}
        self.height = 0
        self.size = 0

    def _app_hash(self) -> bytes:
        items = [k + b"=" + v for k, v in sorted(self.state.items())]
        return merkle.hash_from_byte_slices(items)

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return abci.ResponseInfo(
            data=json.dumps({"size": self.size}),
            version="0.1.0",
            last_block_height=self.height,
            last_block_app_hash=self._app_hash() if self.height else b"",
        )

    @staticmethod
    def _split(tx: bytes):
        if b"=" in tx:
            return tx.split(b"=", 1)
        return tx, tx

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        k, v = self._split(req.tx)
        self.state[k] = v
        self.size += 1
        return abci.ResponseDeliverTx(
            code=abci.CODE_TYPE_OK,
            tags=[abci.KVPair(key=b"app.key", value=k),
                  abci.KVPair(key=b"app.creator", value=b"kvstore")],
        )

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK)

    def commit(self, req: abci.RequestCommit) -> abci.ResponseCommit:
        self.height += 1
        return abci.ResponseCommit(data=self._app_hash())

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        if req.path == "/store" or req.path == "":
            value = self.state.get(req.data, b"")
            return abci.ResponseQuery(
                code=abci.CODE_TYPE_OK, key=req.data, value=value, height=self.height,
                log="exists" if value else "does not exist",
            )
        if req.path.startswith("/p2p/filter/"):
            return abci.ResponseQuery(code=abci.CODE_TYPE_OK)  # admit every peer
        return abci.ResponseQuery(code=1, log=f"unknown path {req.path}")


PRIORITY_TX_PREFIX = b"pri"


class PriorityKVStoreApp(KVStoreApp):
    """KVStore whose CheckTx reports a mempool priority: a tx shaped
    ``pri<N>:key=value`` carries priority N (any other tx is priority 0),
    the stand-in for a real app's gas price."""

    @staticmethod
    def tx_priority(tx: bytes) -> int:
        if tx.startswith(PRIORITY_TX_PREFIX):
            head, _, _ = tx.partition(b":")
            try:
                return int(head[len(PRIORITY_TX_PREFIX):])
            except ValueError:
                return 0
        return 0

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK, priority=self.tx_priority(req.tx))


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


class SignedKVStoreApp(KVStoreApp):
    """KVStore over signed transactions: CheckTx and DeliverTx verify the
    sender's signature and enforce strictly sequential per-sender nonces.

    ``RequestCheckTx.sig_verified`` is the batched verdict: when the
    mempool's hook already verified the signature in a batched dispatch
    (the same accept set as ``_verify_sig``), CheckTx trusts it and skips
    its own check; None (no hook, an unsigned or odd tx) keeps the serial
    check. DeliverTx always verifies. Payloads are the kvstore's
    ``key=value`` form with PriorityKVStoreApp's ``pri<N>:`` prefix."""

    def __init__(self):
        super().__init__()
        self.nonces: Dict[bytes, int] = {}  # committed per-sender nonce
        # CheckTx overlay: nonces admitted this block, reset at commit so the
        # post-commit recheck replays the survivors against committed state
        self._check_nonces: Dict[bytes, int] = {}
        self.serial_verifies = 0  # serial signature checks actually paid

    tx_sig_extractor = staticmethod(extract_signed_tx_sig)
    tx_priority = staticmethod(PriorityKVStoreApp.tx_priority)

    def _verify_sig(self, stx: SignedTx) -> bool:
        self.serial_verifies += 1
        if stx.algo == ALGO_ED25519:
            # Go's single verify (the reference's ed25519.verify has the
            # same accept set; the port has no OpenSSL fast path)
            return _ed._verify_pure(stx.pub, stx.sign_bytes, stx.sig)
        # the secp256k1 premix: sign and verify over SHA-256 of the message
        # (secp256k1.go:140)
        return _secp.verify(stx.pub, sha256(stx.sign_bytes), stx.sig)

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        stx = decode_signed_tx(req.tx)
        if stx is None:
            return abci.ResponseCheckTx(code=CODE_BAD_TX, log="malformed signed tx")
        verified = getattr(req, "sig_verified", None)
        ok = verified if verified is not None else self._verify_sig(stx)
        if not ok:
            return abci.ResponseCheckTx(code=CODE_BAD_SIG, log="invalid signature")
        expected = self._check_nonces.get(stx.pub, self.nonces.get(stx.pub, 0)) + 1
        if stx.nonce != expected:
            return abci.ResponseCheckTx(
                code=CODE_BAD_NONCE, log=f"bad nonce {stx.nonce}, want {expected}")
        self._check_nonces[stx.pub] = stx.nonce
        return abci.ResponseCheckTx(
            code=abci.CODE_TYPE_OK, priority=self.tx_priority(stx.payload))

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        stx = decode_signed_tx(req.tx)
        if stx is None:
            return abci.ResponseDeliverTx(code=CODE_BAD_TX, log="malformed signed tx")
        if not self._verify_sig(stx):
            return abci.ResponseDeliverTx(code=CODE_BAD_SIG, log="invalid signature")
        expected = self.nonces.get(stx.pub, 0) + 1
        if stx.nonce != expected:
            return abci.ResponseDeliverTx(
                code=CODE_BAD_NONCE, log=f"bad nonce {stx.nonce}, want {expected}")
        self.nonces[stx.pub] = stx.nonce
        return super().deliver_tx(abci.RequestDeliverTx(tx=stx.payload))

    def commit(self, req: abci.RequestCommit) -> abci.ResponseCommit:
        self._check_nonces = {}
        return super().commit(req)


class PersistentKVStoreApp(KVStoreApp):
    """KVStore with height persistence and validator-set changes (ref
    persistent_kvstore.go:199): InitChain seeds the validators, a DeliverTx
    of ``val:<base64 pubkey>!<power>`` stages an ed25519 update (power 0
    removes), EndBlock returns the block's updates, Commit persists."""

    def __init__(self, db=None):
        super().__init__()
        self._db = db or MemDB()
        self._val_updates: List[abci.ValidatorUpdate] = []
        self.validators: Dict[bytes, int] = {}  # raw pubkey -> power
        # state-sync snapshots (off until configure_snapshots)
        self._snapshot_store = None
        self._snapshot_interval = 0
        self._snapshot_chunk_size = 65536
        self._snapshot_keep_recent = 3
        self._snapshot_format = 1
        # production runs on a worker thread, so that commit() (the
        # consensus thread) never pays for chunking and store writes
        self._snap_queue: Optional[queue.Queue] = None
        self._snap_thread: Optional[threading.Thread] = None
        # each failed production is logged and counted here
        self.snapshot_failures = 0
        # a restore in progress: (Snapshot, expected chunk hashes, chunks so far)
        self._restoring: Optional[tuple] = None
        self._load()

    def _load(self) -> None:
        raw = self._db.get(b"kvstore:state")
        if raw:
            obj = json.loads(raw.decode())
            self.height = obj["height"]
            self.size = obj["size"]
            self.state = {base64.b64decode(k): base64.b64decode(v)
                          for k, v in obj["kv"].items()}
            self.validators = {base64.b64decode(k): p for k, p in obj["vals"].items()}

    def _save(self) -> None:
        obj = {
            "height": self.height,
            "size": self.size,
            "kv": {base64.b64encode(k).decode(): base64.b64encode(v).decode()
                   for k, v in self.state.items()},
            "vals": {base64.b64encode(k).decode(): p for k, p in self.validators.items()},
        }
        self._db.set_sync(b"kvstore:state", json.dumps(obj, sort_keys=True).encode())

    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        for vu in req.validators:
            self.validators[vu.pub_key] = vu.power
        self._save()
        return abci.ResponseInitChain()

    def begin_block(self, req: abci.RequestBeginBlock) -> abci.ResponseBeginBlock:
        self._val_updates = []
        return abci.ResponseBeginBlock()

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        if req.tx.startswith(VALIDATOR_TX_PREFIX):
            try:
                pub_b64, power_s = req.tx[len(VALIDATOR_TX_PREFIX):].split(b"!", 1)
                pub = base64.b64decode(pub_b64)
                power = int(power_s)
            except Exception:
                return abci.ResponseDeliverTx(code=1, log="bad validator tx")
            self._val_updates.append(
                abci.ValidatorUpdate(pub_key_type="ed25519", pub_key=pub, power=power))
            if power == 0:
                self.validators.pop(pub, None)
            else:
                self.validators[pub] = power
            return abci.ResponseDeliverTx(code=abci.CODE_TYPE_OK)
        return super().deliver_tx(req)

    def end_block(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        return abci.ResponseEndBlock(validator_updates=list(self._val_updates))

    def commit(self, req: abci.RequestCommit) -> abci.ResponseCommit:
        res = super().commit(req)
        self._save()
        self._maybe_snapshot()
        return res

    # -- state-sync snapshots ------------------------------------------------------
    def configure_snapshots(self, store, interval: int, chunk_size: int = 65536,
                            keep_recent: int = 3, snapshot_format: int = 1) -> None:
        """Enable snapshot production: every ``interval`` heights, chunk the
        persisted state blob into ``store`` (a ``statesync.SnapshotStore``)
        in ``snapshot_format`` (``chunker.SUPPORTED_FORMATS``; 2 = per-chunk
        zlib). Chunking and store writes run on a daemon worker thread;
        commit() only enqueues the (height, blob) pair."""
        self._snapshot_store = store
        self._snapshot_interval = interval
        self._snapshot_chunk_size = chunk_size
        self._snapshot_keep_recent = keep_recent
        self._snapshot_format = snapshot_format
        if self._snap_thread is None:
            self._snap_queue = queue.Queue()
            self._snap_thread = threading.Thread(
                target=self._snapshot_worker, name="kvstore-snapshot", daemon=True)
            self._snap_thread.start()

    def _snapshot_worker(self) -> None:
        from tendermint_tpu_torch.libs import trace
        from tendermint_tpu_torch.statesync import chunker

        while True:
            height, blob = self._snap_queue.get()
            try:
                with trace.span("statesync.snapshot_produce", height=height, size=len(blob)):
                    snap, chunks = chunker.make_snapshot(
                        height, blob, self._snapshot_chunk_size, format=self._snapshot_format)
                    self._snapshot_store.save(snap, chunks)
                    self._snapshot_store.prune(self._snapshot_keep_recent)
            except Exception:
                # a failed snapshot must not wedge the worker, nor pass
                # silently
                self.snapshot_failures += 1
                logging.getLogger(__name__).exception(
                    "snapshot production failed at height %d", height)
            finally:
                self._snap_queue.task_done()

    def wait_snapshots(self) -> None:
        """Block until every enqueued snapshot has been produced."""
        if self._snap_queue is not None:
            self._snap_queue.join()

    def _state_blob(self) -> bytes:
        # the bytes _save persists: a restore round-trips through _load
        return self._db.get(b"kvstore:state") or b"{}"

    def _maybe_snapshot(self) -> None:
        if (self._snapshot_store is None or self._snapshot_interval <= 0
                or self.height % self._snapshot_interval != 0):
            return
        # take the committed blob now (later commits overwrite it); the
        # worker chunks and stores it
        self._snap_queue.put((self.height, self._state_blob()))

    def list_snapshots(self, req: abci.RequestListSnapshots) -> abci.ResponseListSnapshots:
        if self._snapshot_store is None:
            return abci.ResponseListSnapshots()
        return abci.ResponseListSnapshots(snapshots=self._snapshot_store.list())

    def offer_snapshot(self, req: abci.RequestOfferSnapshot) -> abci.ResponseOfferSnapshot:
        from tendermint_tpu_torch.statesync.chunker import (
            SUPPORTED_FORMATS,
            chunk_hashes_from_metadata,
        )

        snap = req.snapshot
        if snap is None or snap.height <= 0:
            return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_REJECT)
        if snap.format not in SUPPORTED_FORMATS:
            return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_REJECT_FORMAT)
        try:
            hashes = chunk_hashes_from_metadata(snap)
        except ValueError:
            return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_REJECT)
        self._restoring = (snap, hashes, [])
        return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_ACCEPT)

    def load_snapshot_chunk(
            self, req: abci.RequestLoadSnapshotChunk) -> abci.ResponseLoadSnapshotChunk:
        if self._snapshot_store is None:
            return abci.ResponseLoadSnapshotChunk()
        chunk = self._snapshot_store.load_chunk(req.height, req.format, req.chunk)
        return abci.ResponseLoadSnapshotChunk(chunk=chunk or b"")

    def apply_snapshot_chunk(
            self, req: abci.RequestApplySnapshotChunk) -> abci.ResponseApplySnapshotChunk:
        from tendermint_tpu_torch.statesync.chunker import decode_chunk

        if self._restoring is None:
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_ABORT)
        snap, hashes, chunks = self._restoring
        if req.index != len(chunks):
            # chunks apply strictly in order for these formats
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_RETRY)
        if merkle.leaf_hash(req.chunk) != hashes[req.index]:
            return abci.ResponseApplySnapshotChunk(
                result=abci.APPLY_CHUNK_RETRY,
                refetch_chunks=[req.index],
                reject_senders=[req.sender] if req.sender else [],
            )
        chunks.append(req.chunk)
        if len(chunks) < snap.chunks:
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_ACCEPT)
        # the last chunk: decode per the negotiated format, then swap in the
        # restored state (the manifest covered the wire bytes, so a chunk
        # that does not decode means the producer was corrupt)
        self._restoring = None
        try:
            blob = b"".join(decode_chunk(c, snap.format) for c in chunks)
            obj = json.loads(blob.decode())
            _ = (obj["height"], obj["size"], obj["kv"], obj["vals"])
        except Exception:
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_REJECT_SNAPSHOT)
        self._db.set_sync(b"kvstore:state", blob)
        self.state = {}
        self.validators = {}
        self._load()
        return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_ACCEPT)

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        if req.path == "/val":
            power = self.validators.get(req.data, 0)
            return abci.ResponseQuery(code=abci.CODE_TYPE_OK, key=req.data,
                                      value=str(power).encode(), height=self.height)
        return super().query(req)


class CounterApp(abci.Application):
    """Txs must be big-endian serial numbers when serial is on
    (ref counter.go)."""

    def __init__(self, serial: bool = True):
        self.serial = serial
        self.tx_count = 0
        self.height = 0

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return abci.ResponseInfo(
            data=json.dumps({"txs": self.tx_count}),
            last_block_height=self.height,
            last_block_app_hash=struct.pack(">Q", self.tx_count) if self.height else b"",
        )

    def set_option(self, req: abci.RequestSetOption) -> abci.ResponseSetOption:
        if req.key == "serial":
            self.serial = req.value == "on"
        return abci.ResponseSetOption()

    def _check(self, tx: bytes, expected: int) -> Optional[str]:
        if not self.serial:
            return None
        if len(tx) > 8:
            return f"tx too long: {len(tx)}"
        val = int.from_bytes(tx, "big")
        if val != expected:
            return f"invalid nonce: got {val}, expected {expected}"
        return None

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        err = self._check(req.tx, self.tx_count)
        if err:
            return abci.ResponseCheckTx(code=2, log=err)
        return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK)

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        err = self._check(req.tx, self.tx_count)
        if err:
            return abci.ResponseDeliverTx(code=2, log=err)
        self.tx_count += 1
        return abci.ResponseDeliverTx(code=abci.CODE_TYPE_OK)

    def commit(self, req: abci.RequestCommit) -> abci.ResponseCommit:
        self.height += 1
        if self.tx_count == 0:
            return abci.ResponseCommit()
        return abci.ResponseCommit(data=struct.pack(">Q", self.tx_count))

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        if req.path == "tx":
            return abci.ResponseQuery(value=str(self.tx_count).encode())
        if req.path == "hash":
            return abci.ResponseQuery(value=str(self.height).encode())
        return abci.ResponseQuery(log=f"invalid query path {req.path}")
