"""Light-client verifying proxy (ref lite/proxy/proxy.go and wrapper.go;
the port's copy of the reference package's ``lite/proxy.py``).

``RPCProvider`` feeds the verifier FullCommits fetched from an UNTRUSTED
full node over RPC (codec-exact bytes via ``lite_full_commit``), with a
timeout on every attempt and bounded retries: a hung upstream surfaces as
``ProviderError``, so the frontend sheds load instead of queueing behind a
dead socket.

``LiteProxy`` is the multi-client server: certification is delegated to a
shared ``frontend.LiteFrontend`` (verified-header cache, single-flight
dedup, cross-client lane aggregation). ``serve_proxy`` serves /status,
/commit, /verify_commit, /light_block and /frontend_stats, whose responses
are only ever derived from headers the frontend certified: a caller needs
no trust in the backing node. A full node's own stores serve as the source
in process (``block_store`` + ``state_db``: ``NodeProvider``);
``run_lite_proxy`` and the ``lite`` command wait for the command-line
tools (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import base64
import http.client
import json
import logging
import socket
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from tendermint_tpu_torch.encoding.codec import Reader
from tendermint_tpu_torch.frontend.frontend import LiteFrontend
from tendermint_tpu_torch.lite.provider import NodeProvider, Provider, ProviderError
from tendermint_tpu_torch.lite.types import FullCommit, LiteError, SignedHeader
from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError
from tendermint_tpu_torch.types.block import Commit, Header
from tendermint_tpu_torch.types.validator_set import ValidatorSet

# transport failures worth a bounded retry; an RPC-level error
# (RPCClientError) is the upstream answering "no" and is never retried
_TRANSIENT = (OSError, socket.timeout, http.client.HTTPException)


class RPCProvider(Provider):
    """Source provider over an untrusted node's RPC (lite/client/provider.go):
    ``timeout`` seconds an attempt, at most ``retries`` retries with linear
    backoff on transport failures."""

    def __init__(self, addr: str, timeout: float = 5.0, retries: int = 2,
                 backoff: float = 0.05):
        self._client = HTTPClient(addr, timeout=timeout)
        self.retries = max(0, int(retries))
        self.backoff = max(0.0, float(backoff))

    def _call(self, what: str, fn):
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except RPCClientError as e:
                raise ProviderError(f"{what}: {e}") from e
            except _TRANSIENT as e:
                last = e
                if attempt < self.retries:
                    time.sleep(self.backoff * (attempt + 1))
        raise ProviderError(
            f"{what}: upstream unreachable after {self.retries + 1} attempts: {last}"
        ) from last

    def latest_full_commit(self, chain_id: str, min_height: int,
                           max_height: int) -> FullCommit:
        status = self._call("status", self._client.status)
        top = min(max_height, int(status["sync_info"]["latest_block_height"]))
        for h in range(top, min_height - 1, -1):
            try:
                return self.full_commit_at(chain_id, h)
            except ProviderError:
                continue
        raise ProviderError(f"no full commit in [{min_height},{max_height}]")

    def full_commit_at(self, chain_id: str, height: int) -> FullCommit:
        raw = self._call(
            f"lite_full_commit({height})",
            lambda: self._client.call("lite_full_commit", height=height),
        )
        header = Header.decode(Reader(base64.b64decode(raw["header"])))
        commit = Commit.unmarshal(base64.b64decode(raw["commit"]))
        vals = ValidatorSet.unmarshal(base64.b64decode(raw["validators"]))
        next_vals = ValidatorSet.unmarshal(base64.b64decode(raw["next_validators"]))
        return FullCommit(SignedHeader(header, commit), vals, next_vals)


class LiteProxy:
    """Multi-client certification server (lite/proxy/proxy.go) over the
    shared frontend: N concurrent callers of ``certified_commit`` share a
    verified-header cache, per-height single flight, and lane-aggregated
    dispatches."""

    def __init__(
        self,
        chain_id: str,
        node_addr: Optional[str] = None,
        trust_db=None,
        trusted_height: Optional[int] = None,
        trusted_hash: Optional[bytes] = None,
        *,
        block_store=None,
        state_db=None,
        source: Optional[Provider] = None,
        provider_timeout: float = 5.0,
        provider_retries: int = 2,
        batch_window_s: float = 0.002,
        batch_max_rows: int = 64,
        cache_size: int = 4096,
        mesh=None,
        use_device: Optional[bool] = None,
    ):
        """trusted_height / trusted_hash: an explicit root of trust, the
        header hash the operator verified out of band. Without it, the
        first run trusts on first use: the UNTRUSTED backing node's height-1
        FullCommit defines the chain for good (the trust DB keeps it).

        The source: an explicit ``source`` wins, else a full node's own
        ``block_store`` + ``state_db`` in process (``NodeProvider``, no RPC
        hop), else ``node_addr`` over RPC."""
        self.chain_id = chain_id
        if source is not None:
            self.source = source
        elif block_store is not None and state_db is not None:
            self.source = NodeProvider(block_store, state_db)
        elif node_addr:
            self.source = RPCProvider(node_addr, timeout=provider_timeout,
                                      retries=provider_retries)
        else:
            raise ValueError("need a source: node_addr, block_store+state_db, or source")
        if (trusted_height is None) != (trusted_hash is None):
            # a height without its hash would trust the untrusted node's
            # header at that height; a hash without its height is a dropped pin
            raise ValueError("trusted_height and trusted_hash must be given together")
        self.frontend = LiteFrontend(
            chain_id,
            self.source,
            trust_db=trust_db,
            mesh=mesh,
            use_device=use_device,
            batch_window_s=batch_window_s,
            batch_max_rows=batch_max_rows,
            cache_size=cache_size,
        )
        self.trusted = self.frontend.trusted  # the shared trust store
        self.trusted_height = trusted_height
        self.trusted_hash = trusted_hash
        self._seeded = False

    def _ensure_seed(self) -> None:
        if self._seeded:
            return
        if self.frontend.has_trust():
            # the store already holds a chain: a pin must still be honoured,
            # or a store seeded on first use by a malicious node would win
            if self.trusted_height is not None:
                try:
                    at_pin = self.trusted.latest_full_commit(
                        self.chain_id, self.trusted_height, self.trusted_height)
                except ProviderError:
                    raise ProviderError(
                        f"trust store has no entry at pinned height "
                        f"{self.trusted_height}, so the pin cannot be verified "
                        f"against it — reset the lite trust DB to re-anchor from "
                        f"the pin"
                    ) from None
                if at_pin.signed_header.header.hash() != self.trusted_hash:
                    raise ProviderError(
                        f"trust store conflicts with the pinned hash at height "
                        f"{self.trusted_height} — reset the lite trust DB (it may "
                        f"have been seeded on first use by a malicious node)"
                    )
            self._seeded = True
            return

        if self.trusted_height is not None:
            # the operator's root of trust: fetch that height and check the
            # header hash before anchoring on it
            fc = self.source.full_commit_at(self.chain_id, self.trusted_height)
            got = fc.signed_header.header.hash()
            if got != self.trusted_hash:
                raise ProviderError(
                    f"trusted header mismatch at height {self.trusted_height}: "
                    f"node serves {got.hex()}, operator pinned "
                    f"{self.trusted_hash.hex()}"
                )
        else:
            logging.getLogger("lite.proxy").warning(
                "TRUST-ON-FIRST-USE: seeding the light-client trust store from "
                "the UNTRUSTED node at height 1 — a malicious first contact "
                "defines the chain permanently; pass trusted_height/trusted_hash "
                "to pin a verified root of trust"
            )
            fc = self.source.full_commit_at(self.chain_id, 1)
        self.frontend.init_trust(fc)
        self._seeded = True

    def certified_commit(self, height: Optional[int] = None) -> FullCommit:
        """The FullCommit at ``height`` (default: one below the source's
        tip, whose canonical commit may not be stored yet), verified
        through the shared frontend."""
        self._ensure_seed()
        if height is None:
            tip = self.source.latest_full_commit(self.chain_id, 1, 1 << 60).height
            height = max(1, tip - 1)
        return self.frontend.certified_commit(height)

    def status(self) -> dict:
        h = self.certified_commit().signed_header.header
        return {
            "verified": True,
            "chain_id": h.chain_id,
            "latest_block_height": h.height,
            "latest_app_hash": h.app_hash.hex().upper(),
            "latest_block_time_ns": h.time_ns,
        }

    def commit(self, height: Optional[int] = None) -> dict:
        fc = self.certified_commit(height)
        h = fc.signed_header.header
        return {
            "verified": True,
            "header": {
                "chain_id": h.chain_id,
                "height": h.height,
                "app_hash": h.app_hash.hex().upper(),
                "validators_hash": h.validators_hash.hex().upper(),
                "time_ns": h.time_ns,
            },
            "commit": {
                "block_id_hash": fc.signed_header.commit.block_id.hash.hex().upper(),
                "precommits": sum(1 for pc in fc.signed_header.commit.precommits if pc),
            },
        }

    def verify_commit(self, height: Optional[int] = None) -> dict:
        """The certification verdict for ``height``: the block id, the
        set's hashes and the power a thin client can anchor on."""
        fc = self.certified_commit(height)
        h = fc.signed_header.header
        return {
            "verified": True,
            "height": h.height,
            "block_id_hash": fc.signed_header.commit.block_id.hash.hex().upper(),
            "validators_hash": h.validators_hash.hex().upper(),
            "next_validators_hash": h.next_validators_hash.hex().upper(),
            "total_voting_power": fc.validators.total_voting_power(),
        }

    def light_block(self, height: Optional[int] = None) -> dict:
        """The certified FullCommit's codec bytes, base64."""
        self._ensure_seed()
        raw = self.frontend.light_block(height)
        return {"verified": True, "full_commit": base64.b64encode(raw).decode()}

    def stats(self) -> dict:
        return self.frontend.stats()

    def close(self) -> None:
        self.frontend.close()


class _ProxyServer(ThreadingHTTPServer):
    # light clients arrive in bursts (a fleet polling the tip): the stdlib's
    # listen backlog of 5 would drop the rest of a burst's connections,
    # which the clients' TCP then retries a second or more later
    request_queue_size = 128


def serve_proxy(proxy: LiteProxy, laddr: str) -> ThreadingHTTPServer:
    """The HTTP server of a LiteProxy; the caller runs ``serve_forever``
    and, when done, ``shutdown()`` and ``server_close()``."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            parsed = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            height = None
            if "height" in q:
                try:
                    height = int(q["height"])
                except ValueError:
                    self.send_response(400)
                    self._finish(json.dumps({"error": "bad height"}).encode())
                    return
            routes = {
                "/status": lambda: proxy.status(),
                "/commit": lambda: proxy.commit(height),
                "/verify_commit": lambda: proxy.verify_commit(height),
                "/light_block": lambda: proxy.light_block(height),
                "/frontend_stats": lambda: proxy.stats(),
            }
            route = routes.get(parsed.path)
            if route is None:
                self.send_response(404)
                self.end_headers()
                return
            try:
                body = json.dumps({"result": route()}).encode()
                self.send_response(200)
            except Exception as e:
                # a failed certification, a shed upstream or anything else:
                # the caller gets an HTTP error, never a reset connection
                body = json.dumps({"error": str(e)}).encode()
                self.send_response(502)
            self._finish(body)

        def _finish(self, body: bytes) -> None:
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    host, _, port = laddr.replace("tcp://", "").rpartition(":")
    return _ProxyServer((host or "127.0.0.1", int(port)), Handler)
