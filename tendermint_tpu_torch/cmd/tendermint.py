"""The ``tendermint`` command line (ref cmd/tendermint, the cobra commands
of commands/; the port's copy of the reference package's
``cmd/tendermint.py``, with its commands and flags).

Commands: init, node, version, gen_validator, show_validator, gen_node_key,
show_node_id, unsafe_reset_all, unsafe_reset_priv_validator, replay,
replay_console, lite, testnet and probe_upnp. The files each writes (a home
directory's ``config/`` and ``data/``, a testnet's tree) are the reference's:
either package's commands read the other's.

``node``, ``lite``, ``replay`` and ``replay_console`` take ``--device``
(default ``cuda``): their process's ``[verify]`` root runs there, and with
no card they exit non-zero naming ``NoCudaDeviceError``. With ``--device
cpu``, ``TM_BATCH_VERIFIER=host`` (as the reference's multi-process test
sets it) installs the host verifier; with the card it is refused at start.

Differences from the reference's command line: ``node`` takes three more
of the configuration's fields as flags, ``--rpc.unsafe`` and
``--instrumentation.prometheus`` (Go tendermint's names) and
``--verify.vote_batch_window_ms``. ``node`` runs the reference's ``[p2p]``
default, the peer exchange on; ``probe_upnp`` runs ``p2p/upnp.probe``.

Run: python -m tendermint_tpu_torch.cmd.tendermint <command> [--home DIR] ...
"""

from __future__ import annotations

import argparse
import base64
import ipaddress
import json
import os
import shutil
import signal
import sys
import threading
import time

VERSION = "tpu-0.1.0 (capabilities of reference v0.26.2)"

class CommandError(Exception):
    """A command's refusal: its message goes to stderr, the exit code is 1."""


def _home(args) -> str:
    return os.path.abspath(args.home)


def _config(args):
    from tendermint_tpu_torch.config.config import default_config

    cfg = default_config()
    cfg.set_root(_home(args))
    if getattr(args, "proxy_app", None):
        cfg.base.proxy_app = args.proxy_app
    if getattr(args, "rpc_laddr", None):
        cfg.rpc.laddr = args.rpc_laddr
    if getattr(args, "p2p_laddr", None):
        # the literal "none" turns p2p off (one node alone)
        cfg.p2p.laddr = "" if args.p2p_laddr == "none" else args.p2p_laddr
    if getattr(args, "persistent_peers", None):
        cfg.p2p.persistent_peers = args.persistent_peers
    if getattr(args, "timeout_commit", None) is not None:
        cfg.consensus.timeout_commit = args.timeout_commit
    if getattr(args, "allow_duplicate_ip", None) is not None:
        cfg.p2p.allow_duplicate_ip = args.allow_duplicate_ip == "true"
    if getattr(args, "fast_sync", None) is not None:
        cfg.base.fast_sync = args.fast_sync == "true"
    if getattr(args, "rpc_unsafe", None) is not None:
        cfg.rpc.unsafe = args.rpc_unsafe == "true"
    if getattr(args, "prometheus", None) is not None:
        cfg.instrumentation.prometheus = args.prometheus == "true"
    if getattr(args, "vote_batch_window_ms", None) is not None:
        cfg.verify.vote_batch_window_ms = args.vote_batch_window_ms
    return cfg


def _device(args) -> str:
    """``--device``, refused at start with ``TM_BATCH_VERIFIER=host`` unless
    it is the CPU (``verify_root.host_verify_requested``)."""
    from tendermint_tpu_torch.node import verify_root

    verify_root.host_verify_requested(args.device)
    return args.device


def cmd_init(args) -> int:
    """A home directory: priv validator, node key, genesis (commands/init.go)."""
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    home = _home(args)
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)
    cfg = _config(args)

    pv_path = cfg.base.priv_validator_path()
    if os.path.exists(pv_path):
        pv = FilePV.load(pv_path)
        print(f"Found private validator: {pv_path}")
    else:
        pv = FilePV.generate(pv_path)
        print(f"Generated private validator: {pv_path}")

    genesis_path = cfg.base.genesis_path()
    if os.path.exists(genesis_path):
        print(f"Found genesis file: {genesis_path}")
    else:
        doc = GenesisDoc(
            chain_id=args.chain_id or f"test-chain-{int(time.time())}",
            genesis_time_ns=time.time_ns(),
            validators=[GenesisValidator(pv.get_pub_key(), 10, "")],
        )
        doc.validate_and_complete()
        doc.save_as(genesis_path)
        print(f"Generated genesis file: {genesis_path}")
    return 0


def cmd_node(args) -> int:
    """Run the node (commands/run_node.go) on ``--device`` until SIGINT or
    SIGTERM, then ``Node.stop()`` and exit 0."""
    from tendermint_tpu_torch.libs.log import parse_log_level, setup

    stop = threading.Event()
    # before anything starts: a signal during the build stops the node as well
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    dev = _device(args)
    cfg = _config(args)
    default, mods = parse_log_level(args.log_level)
    setup(default, mods)
    from tendermint_tpu_torch.node import verify_root
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.privval.file_pv import FilePV

    pv = FilePV.load_or_generate(cfg.base.priv_validator_path())
    node = Node(cfg, priv_validator=pv, device=dev)
    verify_root.host_verify_from_env(dev)
    node.start()
    try:
        rpc = (f"tcp://127.0.0.1:{node.rpc_server.bound_port}"
               if node.rpc_server is not None else "off")
        print(f"Node started. RPC: {rpc} device: {node.device}", flush=True)
        while not stop.wait(0.2):
            pass
    finally:
        node.stop()
    return 0


def cmd_version(args) -> int:
    print(VERSION)
    return 0


def cmd_probe_upnp(args) -> int:
    """Probe for a UPnP gateway (commands/probe_upnp.go)."""
    from tendermint_tpu_torch.p2p.upnp import probe

    caps = probe()
    print(json.dumps(caps.__dict__, indent=2))
    return 0


def cmd_replay(args, console: bool = False) -> int:
    """Replay the WAL through a fresh consensus state (commands/replay.go)."""
    from tendermint_tpu_torch.consensus.replay_file import run_replay_file

    dev = _device(args)
    cfg = _config(args)
    return 0 if run_replay_file(cfg, console=console, device=dev) >= 0 else 1


def cmd_replay_console(args) -> int:
    return cmd_replay(args, console=True)


def cmd_lite(args) -> int:
    """The light-client verifying proxy: certify headers from an untrusted
    node through the DynamicVerifier and serve verified /status /commit
    locally (commands/lite.go + lite/proxy)."""
    from tendermint_tpu_torch.lite.proxy import run_lite_proxy

    dev = _device(args)
    if (args.trusted_height is None) != (not args.trusted_hash):
        print("error: --trusted-height and --trusted-hash must be given together",
              file=sys.stderr)
        return 1
    trusted_hash = None
    if args.trusted_hash:
        try:
            trusted_hash = bytes.fromhex(args.trusted_hash.removeprefix("0x"))
        except ValueError:
            print("error: --trusted-hash is not valid hex", file=sys.stderr)
            return 1
        if len(trusted_hash) != 32:
            print("error: --trusted-hash must be 32 bytes of hex", file=sys.stderr)
            return 1
    return run_lite_proxy(chain_id=args.chain_id, node_addr=args.node, laddr=args.laddr,
                          home=_home(args), trusted_height=args.trusted_height,
                          trusted_hash=trusted_hash, device=dev)


def cmd_gen_validator(args) -> int:
    from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519

    pk = PrivKeyEd25519.generate()
    print(json.dumps({
        "address": pk.pub_key().address().hex().upper(),
        "pub_key": pk.pub_key().to_json_obj(),
        "priv_key": {"type": "ed25519", "value": base64.b64encode(pk.bytes()).decode()},
    }, indent=2))
    return 0


def cmd_show_validator(args) -> int:
    from tendermint_tpu_torch.privval.file_pv import FilePV

    cfg = _config(args)
    pv = FilePV.load(cfg.base.priv_validator_path())
    print(json.dumps(pv.get_pub_key().to_json_obj()))
    return 0


def cmd_gen_node_key(args) -> int:
    from tendermint_tpu_torch.p2p.key import NodeKey

    cfg = _config(args)
    os.makedirs(os.path.dirname(cfg.base.node_key_path()), exist_ok=True)
    nk = NodeKey.load_or_generate(cfg.base.node_key_path())
    print(nk.id())
    return 0


def cmd_show_node_id(args) -> int:
    from tendermint_tpu_torch.p2p.key import NodeKey

    cfg = _config(args)
    print(NodeKey.load(cfg.base.node_key_path()).id())
    return 0


def cmd_reset_all(args) -> int:
    """Danger: wipe the data and reset the priv validator
    (commands/reset_priv_validator.go)."""
    from tendermint_tpu_torch.privval.file_pv import FilePV

    cfg = _config(args)
    data = cfg.base.db_path()
    if os.path.isdir(data):
        shutil.rmtree(data)
        os.makedirs(data)
        print(f"Removed all data in {data}")
    pv_path = cfg.base.priv_validator_path()
    if os.path.exists(pv_path):
        FilePV.load(pv_path).reset()
        print(f"Reset private validator to genesis state: {pv_path}")
    return 0


def cmd_reset_priv_validator(args) -> int:
    from tendermint_tpu_torch.privval.file_pv import FilePV

    cfg = _config(args)
    FilePV.load(cfg.base.priv_validator_path()).reset()
    print(f"Reset private validator: {cfg.base.priv_validator_path()}")
    return 0


def cmd_testnet(args) -> int:
    """An N-validator testnet tree with node keys and the persistent-peers
    string of a localnet (commands/testnet.go + docker-compose.yml's
    localnet)."""
    from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    out = os.path.abspath(args.output_dir)
    n = args.v
    pvs, node_keys = [], []
    for i in range(n):
        node_dir = os.path.join(out, f"node{i}")
        os.makedirs(os.path.join(node_dir, "config"), exist_ok=True)
        os.makedirs(os.path.join(node_dir, "data"), exist_ok=True)
        pvs.append(FilePV.generate(os.path.join(node_dir, "config", "priv_validator.json")))
        nk = NodeKey(PrivKeyEd25519.generate())
        nk.save_as(os.path.join(node_dir, "config", "node_key.json"))
        node_keys.append(nk)
    doc = GenesisDoc(
        chain_id=args.chain_id or f"chain-{int(time.time())}",
        genesis_time_ns=time.time_ns(),
        validators=[GenesisValidator(pv.get_pub_key(), 1, f"node{i}")
                    for i, pv in enumerate(pvs)],
    )
    doc.validate_and_complete()
    if args.hostname_prefix:
        # kubernetes StatefulSet: pod i at <prefix>-<i>.<prefix> through the
        # headless service (testnet.go --hostname-prefix; networks/kubernetes/)
        peers = ",".join(f"{nk.id()}@{args.hostname_prefix}-{i}.{args.hostname_prefix}:26656"
                         for i, nk in enumerate(node_keys))
    elif args.starting_ip_address:
        # a docker network: node i at consecutive IPs, one p2p port
        # (testnet.go --starting-ip-address)
        base_ip = ipaddress.ip_address(args.starting_ip_address)
        peers = ",".join(f"{nk.id()}@{base_ip + i}:26656" for i, nk in enumerate(node_keys))
    else:
        peers = ",".join(f"{nk.id()}@127.0.0.1:{args.starting_port + 2 * i}"
                         for i, nk in enumerate(node_keys))
    for i in range(n):
        doc.save_as(os.path.join(out, f"node{i}", "config", "genesis.json"))
        with open(os.path.join(out, f"node{i}", "config", "peers.txt"), "w") as f:
            f.write(peers + "\n")
    print(f"Successfully initialized {n} node directories in {out}")
    print(f"persistent_peers: {peers}")
    return 0


def _device_flag(sp) -> None:
    sp.add_argument("--device", default="cuda",
                    help="where the process's [verify] root runs: cuda (the default) or cpu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tendermint", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--home", default=os.path.expanduser("~/.tendermint_tpu"))
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("init", help="initialize a home directory")
    sp.add_argument("--chain-id", default="")
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("node", help="run the node")
    sp.add_argument("--proxy_app", default="kvstore")
    sp.add_argument("--rpc.laddr", dest="rpc_laddr", default="tcp://127.0.0.1:26657")
    sp.add_argument("--p2p.laddr", dest="p2p_laddr", default="")
    sp.add_argument("--p2p.persistent_peers", dest="persistent_peers", default="")
    sp.add_argument("--consensus.timeout_commit", dest="timeout_commit", type=float,
                    default=None)
    sp.add_argument("--fast_sync", choices=["true", "false"], default=None)
    sp.add_argument("--p2p.allow_duplicate_ip", dest="allow_duplicate_ip",
                    choices=["true", "false"], default=None)
    sp.add_argument("--log_level", default="info")
    sp.add_argument("--rpc.unsafe", dest="rpc_unsafe", choices=["true", "false"], default=None)
    sp.add_argument("--instrumentation.prometheus", dest="prometheus",
                    choices=["true", "false"], default=None)
    sp.add_argument("--verify.vote_batch_window_ms", dest="vote_batch_window_ms", type=float,
                    default=None)
    _device_flag(sp)
    sp.set_defaults(fn=cmd_node)

    for name, fn in [
        ("version", cmd_version),
        ("gen_validator", cmd_gen_validator),
        ("show_validator", cmd_show_validator),
        ("gen_node_key", cmd_gen_node_key),
        ("show_node_id", cmd_show_node_id),
        ("probe_upnp", cmd_probe_upnp),
        ("unsafe_reset_all", cmd_reset_all),
        ("unsafe_reset_priv_validator", cmd_reset_priv_validator),
    ]:
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)

    for name, fn, what in (("replay", cmd_replay, "replay the consensus WAL"),
                           ("replay_console", cmd_replay_console, "interactive WAL replay")):
        sp = sub.add_parser(name, help=what)
        sp.add_argument("--proxy_app", default="kvstore")
        _device_flag(sp)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("lite", help="light-client verifying proxy")
    sp.add_argument("--chain-id", required=True)
    sp.add_argument("--node", default="tcp://127.0.0.1:26657")
    sp.add_argument("--laddr", default="tcp://127.0.0.1:8888")
    sp.add_argument("--trusted-height", type=int, default=None,
                    help="root-of-trust height verified out of band (skips TOFU seeding)")
    sp.add_argument("--trusted-hash", default="",
                    help="hex header hash at --trusted-height; mismatch aborts")
    _device_flag(sp)
    sp.set_defaults(fn=cmd_lite)

    sp = sub.add_parser("testnet", help="generate a testnet config tree")
    sp.add_argument("--v", type=int, default=4)
    sp.add_argument("--output-dir", default="./mytestnet")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--starting-port", dest="starting_port", type=int, default=26656)
    sp.add_argument("--hostname-prefix", dest="hostname_prefix", default="",
                    help="peer addresses become <prefix>-<i>.<prefix>:26656 "
                         "(kubernetes StatefulSet DNS; see networks/kubernetes/)")
    sp.add_argument("--starting-ip-address", dest="starting_ip_address", default="",
                    help="peer nodes at consecutive IPs on port 26656 (docker networks)")
    sp.set_defaults(fn=cmd_testnet)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except CommandError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001 - a command's failure is its exit code
        if args.command not in ("node", "lite", "replay", "replay_console"):
            raise
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
