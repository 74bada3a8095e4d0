"""abci-cli: talk to an ABCI application directly (ref
abci/cmd/abci-cli/abci-cli.go; the port's copy of the reference package's
``cmd/abci_cli.py``, with its commands and output).

Commands: echo, info, set_option, deliver_tx, check_tx, commit, query,
console (a REPL), batch (commands from stdin). The app is a running server
(``--address``: a socket address, or ``grpc://host:port``) or an in-process
example (``--app kvstore|persistent_kvstore|counter``).

Run: python -m tendermint_tpu_torch.cmd.abci_cli [--address tcp://...] <command> [args]
"""

from __future__ import annotations

import argparse
import shlex
import sys

from tendermint_tpu_torch.abci import types as abci


def _make_client(args):
    if args.address:
        from tendermint_tpu_torch.proxy.app_conn import RemoteClientCreator

        client = RemoteClientCreator(args.address).new_abci_client()
        client.start()
        return client
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.examples.kvstore import (
        CounterApp,
        KVStoreApp,
        PersistentKVStoreApp,
    )

    app = {
        "kvstore": KVStoreApp,
        "persistent_kvstore": PersistentKVStoreApp,
        "counter": CounterApp,
    }[args.app]()
    client = LocalClient(app)
    client.start()
    return client


def _parse_bytes(arg: str) -> bytes:
    """abci-cli conventions: 0x-prefixed hex or a quoted/plain string."""
    if arg.startswith("0x"):
        return bytes.fromhex(arg[2:])
    if len(arg) >= 2 and arg[0] == arg[-1] == '"':
        arg = arg[1:-1]
    return arg.encode()


def _print_response(res) -> None:
    out = {}
    for name in ("code", "log", "data", "value", "key", "info", "height",
                 "gas_wanted", "gas_used", "last_block_height", "version"):
        v = getattr(res, name, None)
        if v in (None, "", b"", 0) and name != "code":
            continue
        if isinstance(v, bytes):
            out[name] = "0x" + v.hex().upper() if v else ""
        else:
            out[name] = v
    print("-> " + " ".join(f"{k}: {v}" for k, v in out.items()))


def run_command(client, cmd: str, cmd_args) -> int:
    if cmd == "echo":
        res = client.echo_sync(abci.RequestEcho(message=cmd_args[0] if cmd_args else ""))
    elif cmd == "info":
        res = client.info_sync(abci.RequestInfo())
    elif cmd == "set_option":
        if len(cmd_args) != 2:
            print("usage: set_option <key> <value>")
            return 1
        res = client.set_option_sync(
            abci.RequestSetOption(key=cmd_args[0], value=cmd_args[1])
        )
    elif cmd == "deliver_tx":
        res = client.deliver_tx_sync(abci.RequestDeliverTx(tx=_parse_bytes(cmd_args[0])))
    elif cmd == "check_tx":
        res = client.check_tx_sync(abci.RequestCheckTx(tx=_parse_bytes(cmd_args[0])))
    elif cmd == "commit":
        res = client.commit_sync(abci.RequestCommit())
    elif cmd == "query":
        res = client.query_sync(
            abci.RequestQuery(
                data=_parse_bytes(cmd_args[0]) if cmd_args else b"",
                path=cmd_args[1] if len(cmd_args) > 1 else "/store",
            )
        )
    else:
        print(f"unknown command {cmd!r}")
        return 1
    _print_response(res)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="abci-cli", description=__doc__)
    p.add_argument("--address", default="",
                   help="a served app (tcp://host:port, unix://path or grpc://host:port)")
    p.add_argument(
        "--app", default="kvstore",
        choices=["kvstore", "persistent_kvstore", "counter"],
        help="in-process example app when no --address",
    )
    p.add_argument("command", help="echo|info|set_option|deliver_tx|check_tx|"
                                   "commit|query|console|batch")
    p.add_argument("args", nargs="*")
    args = p.parse_args(argv)

    client = _make_client(args)
    try:
        if args.command == "console":
            print("abci-cli console; 'quit' exits")
            while True:
                try:
                    line = input("> ").strip()
                except EOFError:
                    return 0
                if line in ("q", "quit", "exit"):
                    return 0
                if not line:
                    continue
                parts = shlex.split(line)
                run_command(client, parts[0], parts[1:])
        elif args.command == "batch":
            rc = 0
            for line in sys.stdin:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = shlex.split(line)
                print(f"> {line}")
                rc |= run_command(client, parts[0], parts[1:])
            return rc
        else:
            return run_command(client, args.command, args.args)
    finally:
        try:
            client.stop()
        except Exception:
            pass


if __name__ == "__main__":
    sys.exit(main())
