"""Remote signer — keep the validator key in a separate process
(ref: privval/tcp.go TCPVal, ipc.go IPCVal, remote_signer.go protocol,
wired at node/node.go:225-242).

Topology per the reference: the NODE listens on ``priv_validator_laddr``;
the SIGNER process (which holds the key, e.g. an HSM front) dials in. For
tcp:// addresses the connection is upgraded to a SecretConnection — the
node authenticates itself with an ed25519 conn key and the channel is
AEAD-encrypted; unix:// sockets rely on filesystem permissions (ipc.go).

Protocol: length-prefixed codec frames, request/response:
PubKeyRequest/Response, SignVoteRequest/SignedVoteResponse,
SignProposalRequest/SignedProposalResponse, SignHeartbeatRequest/
SignedHeartbeatResponse, PingRequest/Response. Errors (e.g. the signer's
double-sign protection refusing) travel as RemoteSignerError responses.

The port's copy of the reference package's ``privval/remote_signer.py``:
the same frames byte for byte both ways, over the port's
``SecretConnection`` (``cryptography`` where the host has it,
``crypto/sts_fallback.py`` where it does not). A node whose
``[base] priv_validator_laddr`` is set listens there and signs through
the signer that dials in (``node/node.py``).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional, Tuple

from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519, PubKey, _PUBKEY_TYPES
from tendermint_tpu_torch.encoding.codec import Reader, Writer, length_prefix
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.p2p.conn.secret_connection import (
    RawConn,
    SecretConnection,
    read_length_prefixed_stream,
)
from tendermint_tpu_torch.types.proposal import Heartbeat, Proposal
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.types.priv_validator import PrivValidator

MAX_MSG = 1 << 20
ACCEPT_DEADLINE = 30.0  # tcp.go defaultAcceptDeadlineSeconds
CONN_TIMEOUT = 5.0  # per-request read deadline

# message tags
_PUBKEY_REQ = 1
_PUBKEY_RESP = 2
_SIGN_VOTE_REQ = 3
_SIGNED_VOTE_RESP = 4
_SIGN_PROPOSAL_REQ = 5
_SIGNED_PROPOSAL_RESP = 6
_SIGN_HEARTBEAT_REQ = 7
_SIGNED_HEARTBEAT_RESP = 8
_PING_REQ = 9
_PING_RESP = 10
_ERROR_RESP = 11


class RemoteSignerError(Exception):
    pass


def _parse_addr(addr: str) -> Tuple[str, object]:
    if addr.startswith("unix://"):
        return "unix", addr[len("unix://"):]
    if addr.startswith("tcp://"):
        host, _, port = addr[len("tcp://"):].rpartition(":")
        return "tcp", (host or "127.0.0.1", int(port))
    raise ValueError(f"unsupported privval address {addr!r}")


class _Conn:
    """One framed connection (SecretConnection for tcp, raw for unix)."""

    def __init__(
        self,
        sock,
        conn_key: Optional[PrivKeyEd25519],
        is_tcp: bool,
        handshake_timeout: Optional[float] = None,
    ):
        self._raw = RawConn(sock)
        if handshake_timeout is not None:
            # bound the handshake: accept() returns BLOCKING sockets, and an
            # inbound client that sends nothing would wedge the accept loop
            self._raw.set_deadline(time.monotonic() + handshake_timeout)
        try:
            if is_tcp:
                self._io = SecretConnection(
                    self._raw, conn_key or PrivKeyEd25519.generate()
                )
            else:
                self._io = self._raw
        finally:
            self._raw.set_deadline(None)
        self._mtx = threading.Lock()

    def send(self, payload: bytes) -> None:
        self._io.write(length_prefix(payload))

    def recv(self) -> bytes:
        return read_length_prefixed_stream(self._io.read_exactly, MAX_MSG)

    def request(self, payload: bytes, timeout: Optional[float] = None) -> bytes:
        """Round trip under an absolute deadline: a stalled signer must not
        hang the consensus thread forever (tcp.go connTimeout)."""
        with self._mtx:
            if timeout is not None:
                self._raw.set_deadline(time.monotonic() + timeout)
            try:
                self.send(payload)
                return self.recv()
            finally:
                if timeout is not None:
                    self._raw.set_deadline(None)

    def close(self) -> None:
        self._raw.close()


# -- wire helpers -------------------------------------------------------------


def _enc_error(msg: str) -> bytes:
    w = Writer()
    w.uvarint(_ERROR_RESP).string(msg)
    return w.build()


class SignerServiceEndpoint(BaseService):
    """The SIGNER side (holds the key): dials the node and serves sign
    requests forever (remote_signer.go RemoteSigner)."""

    def __init__(self, addr: str, privval: PrivValidator, conn_key: Optional[PrivKeyEd25519] = None):
        super().__init__(name="SignerService")
        self.addr = addr
        self.privval = privval
        self.conn_key = conn_key or PrivKeyEd25519.generate()
        self._conn: Optional[_Conn] = None

    def _connect(self) -> "_Conn":
        scheme, target = _parse_addr(self.addr)
        if scheme == "unix":
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.connect(target)
        else:
            sock = socket.create_connection(target, timeout=ACCEPT_DEADLINE)
            # clear the connect timeout: the serve loop must block on recv
            # indefinitely (idle gaps between sign requests are normal)
            sock.settimeout(None)
        return _Conn(sock, self.conn_key, is_tcp=(scheme == "tcp"))

    def on_start(self) -> None:
        self._conn = self._connect()
        threading.Thread(target=self._serve, name="signer-serve", daemon=True).start()

    def on_stop(self) -> None:
        if self._conn is not None:
            self._conn.close()

    def _serve(self) -> None:
        """Serve forever; when the node drops the connection (timeout reset,
        restart), redial — the validator must not lose its signer permanently
        (remote_signer.go reconnects the same way)."""
        conn = self._conn
        while not self._quit.is_set():
            try:
                req = conn.recv()
            except Exception:
                conn.close()
                conn = None
                while conn is None and not self._quit.is_set():
                    time.sleep(0.2)
                    try:
                        conn = self._connect()
                    except Exception:
                        conn = None
                self._conn = conn
                continue
            try:
                resp = self._handle(req)
            except Exception as e:  # double-sign refusal etc.
                resp = _enc_error(str(e))
            try:
                conn.send(resp)
            except Exception:
                continue  # recv will fail next and trigger the redial path

    def _handle(self, data: bytes) -> bytes:
        r = Reader(data)
        tag = r.uvarint()
        if tag == _PUBKEY_REQ:
            pk = self.privval.get_pub_key()
            w = Writer()
            w.uvarint(_PUBKEY_RESP).string(pk.type_name).bytes(pk.bytes())
            return w.build()
        if tag == _PING_REQ:
            w = Writer()
            w.uvarint(_PING_RESP)
            return w.build()
        chain_id = r.string()
        if tag == _SIGN_VOTE_REQ:
            vote = Vote.decode(r)
            signed = self.privval.sign_vote(chain_id, vote)
            w = Writer()
            w.uvarint(_SIGNED_VOTE_RESP)
            signed.encode(w)
            return w.build()
        if tag == _SIGN_PROPOSAL_REQ:
            prop = Proposal.decode(r)
            signed = self.privval.sign_proposal(chain_id, prop)
            w = Writer()
            w.uvarint(_SIGNED_PROPOSAL_RESP)
            signed.encode(w)
            return w.build()
        if tag == _SIGN_HEARTBEAT_REQ:
            hb = Heartbeat.decode(r)
            signed = self.privval.sign_heartbeat(chain_id, hb)
            w = Writer()
            w.uvarint(_SIGNED_HEARTBEAT_RESP)
            signed.encode(w)
            return w.build()
        raise RemoteSignerError(f"unknown request tag {tag}")


class SignerValidatorEndpoint(BaseService, PrivValidator):
    """The NODE side: listens for the signer's dial-in, then IS the node's
    PrivValidator — every sign call becomes a request over the wire
    (tcp.go TCPVal / ipc.go IPCVal)."""

    def __init__(
        self,
        addr: str,
        conn_key: Optional[PrivKeyEd25519] = None,
        expected_signer_pubkey: Optional[PubKey] = None,
    ):
        """expected_signer_pubkey: pin the signer's SecretConnection identity
        (tcp only). Without it, ANY dialer that completes the handshake
        replaces the active signer — matching the reference's TCPVal, but a
        known weakness there: anyone who can reach priv_validator_laddr can
        evict the real signer or serve a chosen pubkey."""
        BaseService.__init__(self, name="SignerValidator")
        self.addr = addr
        self.conn_key = conn_key or PrivKeyEd25519.generate()
        self.expected_signer_pubkey = expected_signer_pubkey
        self._listener: Optional[socket.socket] = None
        self._conn: Optional[_Conn] = None
        self._connected = threading.Event()
        self._pubkey: Optional[PubKey] = None

    # -- lifecycle -------------------------------------------------------------
    def on_start(self) -> None:
        scheme, target = _parse_addr(self.addr)
        if scheme == "unix":
            import os

            try:
                os.unlink(target)
            except OSError:
                pass
            ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            ls.bind(target)
        else:
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind(target)
        ls.listen(1)
        ls.settimeout(ACCEPT_DEADLINE)
        self._listener = ls
        self._scheme = scheme
        threading.Thread(target=self._accept_loop, name="privval-accept", daemon=True).start()

    def on_stop(self) -> None:
        for closer in (self._conn, ):
            if closer is not None:
                closer.close()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    @property
    def listen_port(self) -> int:
        return self._listener.getsockname()[1]

    def _accept_loop(self) -> None:
        while not self._quit.is_set():
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                conn = _Conn(
                    sock, self.conn_key, is_tcp=(self._scheme == "tcp"),
                    handshake_timeout=CONN_TIMEOUT,
                )
            except Exception as e:
                self.logger.error("signer connection upgrade failed: %s", e)
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            if self.expected_signer_pubkey is not None:
                remote = getattr(conn._io, "remote_pubkey", None)
                if remote is None or remote.bytes() != self.expected_signer_pubkey.bytes():
                    self.logger.error(
                        "rejecting signer connection: authenticated key %s "
                        "does not match the pinned signer pubkey",
                        remote.address().hex() if remote is not None else "<none>",
                    )
                    conn.close()
                    continue
            old, self._conn = self._conn, conn
            if old is not None:
                # matches the reference's accept-any TCPVal behavior, but an
                # eviction is worth an operator's attention: a dialer just
                # displaced the live signer (pin expected_signer_pubkey to
                # prevent untrusted dialers doing this)
                self.logger.warning(
                    "active remote signer connection displaced by a new dial-in"
                )
                old.close()
            self._pubkey = None  # re-fetch from the (possibly new) signer
            self._connected.set()
            self.logger.info("remote signer connected")

    def wait_for_signer(self, timeout: float = ACCEPT_DEADLINE) -> bool:
        return self._connected.wait(timeout)

    # -- PrivValidator over the wire ---------------------------------------------
    def _request(self, payload: bytes) -> Reader:
        if not self._connected.wait(CONN_TIMEOUT):
            raise RemoteSignerError("no signer connected")
        conn = self._conn
        if conn is None:
            raise RemoteSignerError("signer reconnecting")
        try:
            resp = conn.request(payload, timeout=CONN_TIMEOUT)
        except Exception as e:
            # a timed-out/failed round trip leaves the stream (and with a
            # SecretConnection, the AEAD framing) desynced: drop the conn so
            # the signer redials a fresh one instead of serving stale replies
            if self._conn is conn:
                self._connected.clear()
                self._conn = None
            conn.close()
            raise RemoteSignerError(f"signer connection failed: {e}") from e
        r = Reader(resp)
        tag = r.uvarint()
        if tag == _ERROR_RESP:
            raise RemoteSignerError(r.string())
        return Reader(resp)  # fresh reader incl. tag for callers

    def get_pub_key(self) -> PubKey:
        if self._pubkey is None:
            w = Writer()
            w.uvarint(_PUBKEY_REQ)
            r = self._request(w.build())
            tag = r.uvarint()
            if tag != _PUBKEY_RESP:
                raise RemoteSignerError(f"unexpected response tag {tag}")
            self._pubkey = _PUBKEY_TYPES[r.string()](r.bytes())
        return self._pubkey

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        w = Writer()
        w.uvarint(_SIGN_VOTE_REQ).string(chain_id)
        vote.encode(w)
        r = self._request(w.build())
        if r.uvarint() != _SIGNED_VOTE_RESP:
            raise RemoteSignerError("unexpected response")
        return Vote.decode(r)

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        w = Writer()
        w.uvarint(_SIGN_PROPOSAL_REQ).string(chain_id)
        proposal.encode(w)
        r = self._request(w.build())
        if r.uvarint() != _SIGNED_PROPOSAL_RESP:
            raise RemoteSignerError("unexpected response")
        return Proposal.decode(r)

    def sign_heartbeat(self, chain_id: str, heartbeat: Heartbeat) -> Heartbeat:
        w = Writer()
        w.uvarint(_SIGN_HEARTBEAT_REQ).string(chain_id)
        heartbeat.encode(w)
        r = self._request(w.build())
        if r.uvarint() != _SIGNED_HEARTBEAT_RESP:
            raise RemoteSignerError("unexpected response")
        return Heartbeat.decode(r)

    def ping(self) -> bool:
        try:
            w = Writer()
            w.uvarint(_PING_REQ)
            return self._request(w.build()).uvarint() == _PING_RESP
        except Exception:
            return False
