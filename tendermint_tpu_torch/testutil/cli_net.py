"""A localnet of ``tendermint node`` processes (BASELINE.json config 1, the
four containers of ``docker-compose.yml``), driven from the command line.

``CLINet`` writes a testnet with ``testnet`` into a directory, then starts
one ``node`` process a validator with ``subprocess.Popen`` (never a fork of
a process that may hold a CUDA context), each on ports picked free at run
time. A process's output goes to a file under the net's ``logs/``, never to
an unread pipe; ``tails()`` gives their ends for a failure's message. The
helpers read the nodes over RPC (height, peers, any route), wait for a
height, and kill, restart and stop processes; ``spawn_lite`` starts a
``lite`` proxy process against a node.

On the card the processes run the default ``--device cuda``; the CPU tests
pass ``device="cpu"`` with ``TM_BATCH_VERIFIER=host`` in ``env``.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.cmd import tendermint as cli

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLI = [sys.executable, "-m", "tendermint_tpu_torch.cmd.tendermint"]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bindable(port: int) -> bool:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        try:
            s.bind(("127.0.0.1", port))
            return True
        except OSError:
            return False


def free_port_block(n: int, tries: int = 200) -> int:
    """The first of ``n`` consecutive ports free now (from the kernel's
    ephemeral picks, so that concurrent nets rarely meet)."""
    for _ in range(tries):
        base = free_port()
        if base + n < 65536 and all(_bindable(base + k) for k in range(1, n)):
            return base
    raise OSError(f"no block of {n} free ports found")


def rpc_get(port: int, path: str, timeout: float = 5.0):
    """GET ``path`` on the RPC at ``port``; the JSON-RPC ``result`` (an
    ``error`` raises ``RuntimeError``)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        body = conn.getresponse().read()
    finally:
        conn.close()
    out = json.loads(body)
    if "error" in out and out["error"]:
        raise RuntimeError(f"{path}: {out['error']}")
    return out.get("result", out)


def wait_for(pred: Callable[[], bool], timeout: float, step: float = 0.1) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if pred():
                return True
        except Exception:
            pass
        time.sleep(step)
    return False


class CLIProcess:
    """One process of the net: its command, its log file, when it was
    spawned and when its RPC first answered."""

    def __init__(self, name: str, argv: List[str], log_path: str, env: Dict[str, str],
                 port: Optional[int] = None):
        self.name, self.argv, self.log_path, self.port = name, argv, log_path, port
        self._log = open(log_path, "ab")
        self.t_spawn = time.perf_counter()
        self.popen = subprocess.Popen(argv, cwd=REPO_ROOT, env=env, stdin=subprocess.DEVNULL,
                                      stdout=self._log, stderr=subprocess.STDOUT)
        self.first_answer_s: Optional[float] = None
        self.exit_s: Optional[float] = None
        self._termed = False

    @property
    def pid(self) -> int:
        return self.popen.pid

    def alive(self) -> bool:
        return self.popen.poll() is None

    def wait_answer(self, path: str, timeout: float) -> bool:
        """Wait until the RPC at ``port`` answers ``path``; records the
        seconds from the spawn."""
        def answered():
            if not self.alive():
                raise RuntimeError(f"{self.name} exited with {self.popen.returncode}")
            rpc_get(self.port, path, timeout=1.0)
            return True

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if answered():
                    if self.first_answer_s is None:
                        self.first_answer_s = time.perf_counter() - self.t_spawn
                    return True
            except RuntimeError:
                return False
            except Exception:
                pass
            time.sleep(0.05)
        return False

    def signal(self, sig: int) -> None:
        if self.alive():
            self.popen.send_signal(sig)

    def terminate(self) -> None:
        """SIGTERM once: a second one could land after the interpreter
        restored the default handler on its way out."""
        if not self._termed:
            self._termed = True
            self._t_term = time.perf_counter()
            self.signal(signal.SIGTERM)

    def stop(self, timeout: float = 10.0) -> Optional[int]:
        """SIGTERM, then the exit code within ``timeout`` (None: it did not
        exit, and was killed); ``exit_s`` gets the seconds from the signal
        to the exit."""
        self.terminate()
        try:
            rc = self.popen.wait(max(0.0, self._t_term + timeout - time.perf_counter()))
            self.exit_s = time.perf_counter() - self._t_term
        except subprocess.TimeoutExpired:
            self.popen.kill()
            self.popen.wait(10)
            rc = None
        self._log.close()
        return rc

    def kill(self) -> None:
        self.signal(signal.SIGKILL)
        self.popen.wait(10)
        self._log.close()

    def tail(self, n: int = 2000) -> str:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n))
                return f.read().decode(errors="replace")
        except OSError:
            return ""


class CLINet:
    """``n`` validators from ``testnet`` under ``root``: node i listens for
    p2p at ``base + 2 i`` (the testnet's peers) and for RPC at
    ``base + 2 i + 1``, as the reference's multi-process test lays them out,
    with ``base`` picked free at run time."""

    def __init__(self, root: str, n: int = 4, chain_id: str = "cli-localnet",
                 device: str = "cuda", env: Optional[Dict[str, str]] = None,
                 timeout_commit: float = 0.3, node_flags: Optional[List[str]] = None):
        self.root, self.n, self.chain_id, self.device = root, n, chain_id, device
        self.timeout_commit = timeout_commit
        self.node_flags = list(node_flags or [])
        self.env = dict(os.environ if env is None else env)
        self.env["PYTHONPATH"] = os.pathsep.join(
            [REPO_ROOT] + [p for p in self.env.get("PYTHONPATH", "").split(os.pathsep) if p])
        self.logs = os.path.join(root, "logs")
        os.makedirs(self.logs, exist_ok=True)
        self.base = free_port_block(2 * n)
        self.procs: Dict[str, CLIProcess] = {}
        self._spawns: Dict[str, int] = {}
        self.proxy_apps: Dict[int, str] = {}
        rc = cli.main(["testnet", "--v", str(n), "--output-dir", root, "--chain-id", chain_id,
                       "--starting-port", str(self.base)])
        if rc != 0:
            raise RuntimeError(f"testnet exited with {rc}")
        with open(os.path.join(root, "node0", "config", "peers.txt")) as f:
            self.peers = f.read().strip()

    def home(self, i: int) -> str:
        return os.path.join(self.root, f"node{i}")

    def p2p_port(self, i: int) -> int:
        return self.base + 2 * i

    def rpc_port(self, i: int) -> int:
        return self.base + 2 * i + 1

    def _spawn(self, name: str, argv: List[str], port: int) -> CLIProcess:
        k = self._spawns.get(name, 0)
        self._spawns[name] = k + 1
        log = os.path.join(self.logs, f"{name}.log" if k == 0 else f"{name}.{k}.log")
        proc = CLIProcess(name, argv, log, self.env, port)
        self.procs[name] = proc
        return proc

    def node_argv(self, i: int, proxy_app: str = "kvstore") -> List[str]:
        return CLI + [
            "--home", self.home(i), "node",
            "--proxy_app", proxy_app,
            "--rpc.laddr", f"tcp://127.0.0.1:{self.rpc_port(i)}",
            "--p2p.laddr", f"tcp://127.0.0.1:{self.p2p_port(i)}",
            "--p2p.persistent_peers", self.peers,
            "--consensus.timeout_commit", str(self.timeout_commit),
            "--p2p.allow_duplicate_ip", "true",
            "--log_level", "error",
            "--device", self.device,
        ] + self.node_flags

    def spawn_node(self, i: int, proxy_app: str = "kvstore") -> CLIProcess:
        """Start node i (again: the same command, the same home)."""
        self.proxy_apps[i] = proxy_app
        return self._spawn(f"node{i}", self.node_argv(i, proxy_app), self.rpc_port(i))

    def restart_node(self, i: int) -> CLIProcess:
        return self.spawn_node(i, self.proxy_apps.get(i, "kvstore"))

    def spawn_lite(self, i: int) -> CLIProcess:
        """A ``lite`` proxy process verifying node i, listening at a free
        port, its trust store under ``<root>/lite``."""
        port = free_port()
        argv = CLI + ["--home", os.path.join(self.root, "lite"), "lite", "--chain-id",
                      self.chain_id, "--node", f"tcp://127.0.0.1:{self.rpc_port(i)}",
                      "--laddr", f"tcp://127.0.0.1:{port}", "--device", self.device]
        return self._spawn("lite", argv, port)

    def node(self, i: int) -> CLIProcess:
        return self.procs[f"node{i}"]

    def rpc(self, i: int, path: str, timeout: float = 5.0):
        return rpc_get(self.rpc_port(i), path, timeout)

    def height(self, i: int) -> int:
        try:
            return int(self.rpc(i, "/status", 2.0)["sync_info"]["latest_block_height"])
        except Exception:
            return -1

    def n_peers(self, i: int) -> int:
        try:
            return int(self.rpc(i, "/net_info", 2.0)["n_peers"])
        except Exception:
            return -1

    def wait_height(self, h: int, nodes=None, timeout: float = 60.0) -> bool:
        nodes = range(self.n) if nodes is None else nodes
        return wait_for(lambda: all(self.height(i) >= h for i in nodes), timeout)

    def kill(self, i: int) -> None:
        self.node(i).kill()

    def stop_all(self, timeout: float = 10.0) -> Dict[str, Optional[int]]:
        """SIGTERM every live process at once; each one's exit code (None:
        it did not exit within ``timeout`` and was killed)."""
        live = [p for p in self.procs.values() if p.alive()]
        for p in live:
            p.terminate()
        return {p.name: p.stop(timeout) for p in live}

    def tails(self, n: int = 1500) -> str:
        return "\n".join(f"--- {p.name} (pid {p.pid}, rc {p.popen.poll()}) ---\n{p.tail(n)}"
                         for p in self.procs.values())
