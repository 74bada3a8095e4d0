"""Structured leveled logging with per-module filtering (ref libs/log/,
go-kit's logger and filter.go; the port's copy of the reference package's
``libs/log.py``).

A thin layer over stdlib logging: key=value suffixes, per-module level
overrides (``filter.go``'s AllowLevelWith), the reference's ``log_level``
syntax (``consensus:debug,*:error``).
"""

from __future__ import annotations

import logging
import sys
from typing import Any, Dict, Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def _kv(kwargs: Dict[str, Any]) -> str:
    if not kwargs:
        return ""
    return " " + " ".join(f"{k}={v}" for k, v in kwargs.items())


class Logger:
    def __init__(self, name: str = "tm", base: Optional[logging.Logger] = None):
        self._log = base or logging.getLogger(name)

    def with_module(self, module: str) -> "Logger":
        return Logger(base=self._log.getChild(module))

    def debug(self, msg: str, **kw) -> None:
        self._log.debug("%s%s", msg, _kv(kw))

    def info(self, msg: str, **kw) -> None:
        self._log.info("%s%s", msg, _kv(kw))

    def error(self, msg: str, **kw) -> None:
        self._log.error("%s%s", msg, _kv(kw))


def setup(level: str = "info", module_levels: Optional[Dict[str, str]] = None,
          stream=None) -> Logger:
    """Configure the root logger at ``level``; ``module_levels`` maps a
    module to its level, e.g. ``{'consensus': 'debug'}`` (the reference's
    ``consensus:debug,*:error`` filter). The real root is configured:
    services log under many top-level names ("tm.*", "Switch",
    "consensus.State", "MConn-...")."""
    root = logging.getLogger()
    root.setLevel(getattr(logging, level.upper()))
    if not root.handlers:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(h)
    for mod, lvl in (module_levels or {}).items():
        logging.getLogger(f"tm.{mod}").setLevel(getattr(logging, lvl.upper()))
    return Logger()


def parse_log_level(spec: str) -> tuple:
    """'consensus:debug,state:info,*:error' -> (default, {module: level})."""
    default = "info"
    mods: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            mod, lvl = part.split(":", 1)
            if mod == "*":
                default = lvl
            else:
                mods[mod] = lvl
        else:
            default = part
    return default, mods
