"""Constellation diagnostics tap: int8 symbols over UDP to 127.0.0.1:9000.

The port's own copy of `xritdemod_tpu/runtime/diag.py` (host code, no device
work); `tests/test_torch_imports.py` pins that the two agree.

Replaces the reference DiagManager
(demodulator/src/DiagManager.cpp): buffers recovered
symbols, and at most every `interval` seconds sends one 1024-symbol
int8-quantized datagram to the constellation viewer port, dropping on
overflow (60-64).  Binds :9001 locally like the reference (47).
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque

import numpy as np

__all__ = ["DiagManager"]


class DiagManager:
    BUFFER = 2048
    SEND = 1024

    def __init__(
        self,
        interval: float = 0.01,
        target: tuple[str, int] = ("127.0.0.1", 9000),
        bind_port: int = 9001,
    ):
        self.interval = interval
        self.target = target
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self._sock.bind(("0.0.0.0", bind_port))
        except OSError:
            pass  # port in use; sending still works
        self._buf: deque[float] = deque(maxlen=self.BUFFER)
        self._lock = threading.Lock()
        self._running = False
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=2)
        self._sock.close()

    def add_samples(self, symbols: np.ndarray) -> None:
        """Complex or real symbols; interleaved I/Q int8 goes on the wire."""
        with self._lock:
            if np.iscomplexobj(symbols):
                for s in symbols[: self.SEND // 2]:
                    self._buf.append(float(s.real))
                    self._buf.append(float(s.imag))
            else:
                self._buf.extend(float(s) for s in symbols[: self.SEND])

    def _loop(self) -> None:
        while self._running:
            time.sleep(self.interval)
            with self._lock:
                if len(self._buf) < self.SEND:
                    continue
                chunk = [self._buf.popleft() for _ in range(self.SEND)]
            q = np.clip(np.asarray(chunk) * 128.0, -128, 127).astype(np.int8)
            try:
                self._sock.sendto(q.tobytes(), self.target)
            except OSError:
                pass
