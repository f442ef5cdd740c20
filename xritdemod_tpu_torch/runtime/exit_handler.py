"""SIGINT/Ctrl-C -> callback shim (reference ExitHandler equivalent).

The port's own copy of `xritdemod_tpu/runtime/exit_handler.py` (host code, no device
work); `tests/test_torch_imports.py` pins that the two agree.

Mirrors demodulator/src/ExitHandler.cpp (duplicated in
decoder/src): first signal invokes the registered callback for a graceful
stop; the reference exits hard on a second signal, reproduced here.
"""

from __future__ import annotations

import signal
import sys
from typing import Callable

__all__ = ["ExitHandler"]


class ExitHandler:
    _callback: Callable[[int], None] | None = None
    _fired: bool = False

    @classmethod
    def set_callback(cls, cb: Callable[[int], None]) -> None:
        cls._callback = cb
        cls._fired = False

    @classmethod
    def register_signal(cls) -> None:
        signal.signal(signal.SIGINT, cls._handle)
        if hasattr(signal, "SIGTERM"):
            signal.signal(signal.SIGTERM, cls._handle)

    @classmethod
    def _handle(cls, signum, frame) -> None:
        if cls._fired:
            sys.exit(1)
        cls._fired = True
        if cls._callback is not None:
            cls._callback(signum)
