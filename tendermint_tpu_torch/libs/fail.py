"""Crash injection indexed by an environment variable (ref
libs/fail/fail.go), the port's copy of the reference package's
``libs/fail.py``.

``fail_point()`` marks a crash-consistency site (``state/execution``'s
``apply_block``); a process run with ``FAIL_TEST_INDEX=k`` exits at the
k-th call, so a persistence test can kill it at each site in turn and
check the recovery.
"""

from __future__ import annotations

import os
import sys
import threading

_mtx = threading.Lock()
_call_index = -1
_fail_index = None
_initialized = False


def _init() -> None:
    global _fail_index, _initialized
    v = os.environ.get("FAIL_TEST_INDEX")
    _fail_index = int(v) if v is not None else None
    _initialized = True


def reset(index=None) -> None:
    """Set the index to fail at (None: never) and restart the count."""
    global _call_index, _fail_index, _initialized
    with _mtx:
        _call_index = -1
        _fail_index = index
        _initialized = True


def fail_point() -> None:
    """Exit the process (code 1) if this is the FAIL_TEST_INDEX-th call."""
    global _call_index
    with _mtx:
        if not _initialized:
            _init()
        if _fail_index is None:
            return
        _call_index += 1
        if _call_index == _fail_index:
            sys.stderr.write(f"fail_point: exiting at index {_call_index}\n")
            sys.stderr.flush()
            os._exit(1)
