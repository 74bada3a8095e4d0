"""ABCI, the application interface (ref abci/types/application.go:11): the
port's copy of the messages of the reference package's ``abci/types.py``
that the mempool's CheckTx path and the block executor's calls use.

Ten methods over three logical connections (consensus / mempool / query):
  consensus: InitChain, BeginBlock, DeliverTx, EndBlock, Commit
  mempool:   CheckTx
  query:     Echo, Info, SetOption, Query
  (+ Flush on every connection)

Plain dataclasses: an in-proc app (the local client) takes them as they
are. ``msg_to_json`` / ``msg_from_json`` are the reference's JSON form,
which ``state/store.ABCIResponses`` persists and the socket and gRPC
transports carry (``abci/client.py``, ``abci/server.py``,
``abci/grpc.py``); its type table holds every dataclass here, the
state-sync snapshot messages included (``Snapshot``, the four snapshot
requests and responses and their result codes).
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, Type

CODE_TYPE_OK = 0

# OfferSnapshot results (ref v0.34 abci.ResponseOfferSnapshot_Result)
OFFER_SNAPSHOT_UNKNOWN = 0
OFFER_SNAPSHOT_ACCEPT = 1
OFFER_SNAPSHOT_ABORT = 2
OFFER_SNAPSHOT_REJECT = 3
OFFER_SNAPSHOT_REJECT_FORMAT = 4
OFFER_SNAPSHOT_REJECT_SENDER = 5

# ApplySnapshotChunk results (ref v0.34 abci.ResponseApplySnapshotChunk_Result)
APPLY_CHUNK_UNKNOWN = 0
APPLY_CHUNK_ACCEPT = 1
APPLY_CHUNK_ABORT = 2
APPLY_CHUNK_RETRY = 3
APPLY_CHUNK_RETRY_SNAPSHOT = 4
APPLY_CHUNK_REJECT_SNAPSHOT = 5


# -- support types ---------------------------------------------------------------


@dataclass
class ValidatorUpdate:
    """EndBlock validator set delta: pub_key (type, raw bytes) + power
    (power 0 removes)."""

    pub_key_type: str = "ed25519"
    pub_key: bytes = b""
    power: int = 0


@dataclass
class BlockSizeParams:
    max_bytes: int = 0
    max_gas: int = 0


@dataclass
class EvidenceParams:
    max_age: int = 0


@dataclass
class ValidatorParams:
    pub_key_types: List[str] = field(default_factory=list)


@dataclass
class ConsensusParams:
    block_size: Optional[BlockSizeParams] = None
    evidence: Optional[EvidenceParams] = None
    validator: Optional[ValidatorParams] = None


@dataclass
class LastCommitInfo:
    round: int = 0
    votes: List["VoteInfo"] = field(default_factory=list)


@dataclass
class VoteInfo:
    address: bytes = b""
    power: int = 0
    signed_last_block: bool = False


@dataclass
class ABCIHeader:
    """Block header fields the app sees in BeginBlock."""

    chain_id: str = ""
    height: int = 0
    time_ns: int = 0
    num_txs: int = 0
    total_txs: int = 0
    app_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class ABCIEvidence:
    type: str = ""
    validator_address: bytes = b""
    validator_power: int = 0
    height: int = 0
    total_voting_power: int = 0


@dataclass
class KVPair:
    key: bytes = b""
    value: bytes = b""


# -- requests ----------------------------------------------------------------------


@dataclass
class RequestEcho:
    message: str = ""


@dataclass
class RequestFlush:
    pass


@dataclass
class RequestInfo:
    version: str = ""


@dataclass
class RequestSetOption:
    key: str = ""
    value: str = ""


@dataclass
class RequestInitChain:
    time_ns: int = 0
    chain_id: str = ""
    consensus_params: Optional[ConsensusParams] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class RequestBeginBlock:
    hash: bytes = b""
    header: ABCIHeader = field(default_factory=ABCIHeader)
    last_commit_info: LastCommitInfo = field(default_factory=LastCommitInfo)
    byzantine_validators: List[ABCIEvidence] = field(default_factory=list)


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    # the batched-ingest verdict (mempool/tx_verify.py): True/False = the
    # mempool already verified this tx's signature in a batched dispatch
    # (the same accept set as the app's own check), None = unknown, the app
    # verifies serially. Apps without signatures ignore it.
    sig_verified: Optional[bool] = None


@dataclass
class RequestDeliverTx:
    tx: bytes = b""


@dataclass
class RequestEndBlock:
    height: int = 0


@dataclass
class RequestCommit:
    pass


# -- responses ---------------------------------------------------------------------


@dataclass
class ResponseException:
    """An app's failure, as a remote transport carries it (the socket and
    gRPC servers answer with it; their clients raise ``ABCIClientError``)."""

    error: str = ""


@dataclass
class ResponseEcho:
    message: str = ""


@dataclass
class ResponseFlush:
    pass


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class ResponseSetOption:
    code: int = 0
    log: str = ""
    info: str = ""


@dataclass
class ResponseInitChain:
    consensus_params: Optional[ConsensusParams] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)


@dataclass
class ResponseQuery:
    code: int = 0
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof: bytes = b""
    height: int = 0


@dataclass
class ResponseBeginBlock:
    tags: List[KVPair] = field(default_factory=list)


@dataclass
class ResponseCheckTx:
    code: int = 0
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    tags: List[KVPair] = field(default_factory=list)
    # the mempool's ordering hint: higher values ride higher lanes; an app
    # that leaves it 0 falls back to gas_wanted as a gas-price proxy
    priority: int = 0

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseDeliverTx:
    code: int = 0
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    tags: List[KVPair] = field(default_factory=list)

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseEndBlock:
    validator_updates: List[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: Optional[ConsensusParams] = None
    tags: List[KVPair] = field(default_factory=list)


@dataclass
class ResponseCommit:
    data: bytes = b""  # the app hash


# -- the state-sync snapshot handshake (v0.34 lineage) ---------------------------------


@dataclass
class Snapshot:
    """One offered application snapshot (ref v0.34 abci.Snapshot).

    ``hash`` is the Merkle root over the chunk hashes; ``metadata`` is
    app/producer-defined: the statesync chunker stores the concatenated
    32-byte chunk leaf hashes there so every chunk verifies on arrival."""

    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


@dataclass
class RequestListSnapshots:
    pass


@dataclass
class RequestOfferSnapshot:
    snapshot: Optional[Snapshot] = None
    app_hash: bytes = b""  # light-client-verified app hash at snapshot height


@dataclass
class RequestLoadSnapshotChunk:
    height: int = 0
    format: int = 0
    chunk: int = 0


@dataclass
class RequestApplySnapshotChunk:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""  # p2p ID of the supplying peer (for reject_senders)


@dataclass
class ResponseListSnapshots:
    snapshots: List[Snapshot] = field(default_factory=list)


@dataclass
class ResponseOfferSnapshot:
    result: int = OFFER_SNAPSHOT_UNKNOWN


@dataclass
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""


@dataclass
class ResponseApplySnapshotChunk:
    result: int = APPLY_CHUNK_UNKNOWN
    refetch_chunks: List[int] = field(default_factory=list)
    reject_senders: List[str] = field(default_factory=list)


# -- the JSON form --------------------------------------------------------------------

_MSG_TYPES: Dict[str, Type] = {
    c.__name__: c for c in list(globals().values()) if is_dataclass(c) and isinstance(c, type)
}


def _to_jsonable(obj: Any) -> Any:
    if is_dataclass(obj) and not isinstance(obj, type):
        out = {"_t": type(obj).__name__}
        for f in fields(obj):
            out[f.name] = _to_jsonable(getattr(obj, f.name))
        return out
    if isinstance(obj, bytes):
        return {"_b": base64.b64encode(obj).decode()}
    if isinstance(obj, list):
        return [_to_jsonable(x) for x in obj]
    return obj


def _from_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "_b" in obj:
            return base64.b64decode(obj["_b"])
        if "_t" in obj:
            return _MSG_TYPES[obj["_t"]](
                **{k: _from_jsonable(v) for k, v in obj.items() if k != "_t"})
    if isinstance(obj, list):
        return [_from_jsonable(x) for x in obj]
    return obj


def msg_to_json(msg: Any) -> bytes:
    return json.dumps(_to_jsonable(msg), separators=(",", ":")).encode()


def msg_from_json(data: bytes) -> Any:
    return _from_jsonable(json.loads(data.decode()))


# -- the application base class: apps override what they need ---------------------
# (ref abci/types/application.go:11-29 + BaseApplication :31)


class Application:
    def echo(self, req: RequestEcho) -> ResponseEcho:
        return ResponseEcho(message=req.message)

    def info(self, req: RequestInfo) -> ResponseInfo:
        return ResponseInfo()

    def set_option(self, req: RequestSetOption) -> ResponseSetOption:
        return ResponseSetOption()

    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        return ResponseInitChain()

    def query(self, req: RequestQuery) -> ResponseQuery:
        return ResponseQuery(code=CODE_TYPE_OK)

    def begin_block(self, req: RequestBeginBlock) -> ResponseBeginBlock:
        return ResponseBeginBlock()

    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        return ResponseCheckTx(code=CODE_TYPE_OK)

    def deliver_tx(self, req: RequestDeliverTx) -> ResponseDeliverTx:
        return ResponseDeliverTx(code=CODE_TYPE_OK)

    def end_block(self, req: RequestEndBlock) -> ResponseEndBlock:
        return ResponseEndBlock()

    def commit(self, req: RequestCommit) -> ResponseCommit:
        return ResponseCommit()

    # state-sync snapshot handshake (v0.34 lineage); the defaults advertise
    # "no snapshot support": empty list, and offers are rejected outright
    def list_snapshots(self, req: RequestListSnapshots) -> ResponseListSnapshots:
        return ResponseListSnapshots()

    def offer_snapshot(self, req: RequestOfferSnapshot) -> ResponseOfferSnapshot:
        return ResponseOfferSnapshot(result=OFFER_SNAPSHOT_REJECT)

    def load_snapshot_chunk(self, req: RequestLoadSnapshotChunk) -> ResponseLoadSnapshotChunk:
        return ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(
            self, req: RequestApplySnapshotChunk) -> ResponseApplySnapshotChunk:
        return ResponseApplySnapshotChunk(result=APPLY_CHUNK_ABORT)
