"""BaseService: the start/stop/reset lifecycle of every long-running
component (ref libs/common/service.go), the port's copy of the reference
package's ``libs/service.py``. The local ABCI client and ``MultiAppConn``
use it.

Idempotent start/stop with ``threading.Event`` quit signaling; subclasses
override on_start/on_stop/on_reset.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional


class ServiceError(Exception):
    pass


class AlreadyStartedError(ServiceError):
    pass


class AlreadyStoppedError(ServiceError):
    pass


class NotStartedError(ServiceError):
    pass


class BaseService:
    def __init__(self, name: str = "", logger: Optional[logging.Logger] = None):
        self.name = name or type(self).__name__
        self.logger = logger or logging.getLogger(self.name)
        self._started = False
        self._stopped = False
        self._mtx = threading.Lock()
        self._quit = threading.Event()

    # lifecycle ------------------------------------------------------------
    def start(self) -> None:
        with self._mtx:
            if self._started:
                raise AlreadyStartedError(self.name)
            if self._stopped:
                raise AlreadyStoppedError(
                    f"{self.name}: cannot start a stopped service; use reset()"
                )
            self._started = True
        self.logger.debug("starting %s", self.name)
        try:
            self.on_start()
        except Exception:
            with self._mtx:
                self._started = False
            raise

    def stop(self) -> None:
        with self._mtx:
            if self._stopped:
                raise AlreadyStoppedError(self.name)
            if not self._started:
                raise NotStartedError(self.name)
            self._stopped = True
        self.logger.debug("stopping %s", self.name)
        self._quit.set()
        self.on_stop()

    def reset(self) -> None:
        with self._mtx:
            if not self._stopped:
                raise ServiceError(f"{self.name}: can only reset a stopped service")
            self._started = False
            self._stopped = False
            self._quit = threading.Event()
        self.on_reset()

    # state ----------------------------------------------------------------
    @property
    def is_running(self) -> bool:
        with self._mtx:
            return self._started and not self._stopped

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until stop() is called."""
        self._quit.wait(timeout)

    @property
    def quit_event(self) -> threading.Event:
        return self._quit

    # overridables ---------------------------------------------------------
    def on_start(self) -> None: ...

    def on_stop(self) -> None: ...

    def on_reset(self) -> None: ...
