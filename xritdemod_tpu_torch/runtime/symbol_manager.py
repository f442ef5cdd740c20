"""Soft-symbol egress: int8 stream over TCP with reconnect, and the ingest
FIFO that feeds the demod device blocks.

The port's own copy of `xritdemod_tpu/runtime/symbol_manager.py` (host code, no device
work); `tests/test_torch_imports.py` pins that the two agree.

`SymbolSender` replaces the reference SymbolManager
(demodulator/src/SymbolManager.cpp): thread-safe queue
capped at 1M symbols with drop-and-warn (94-106), 16384-byte sends, 1 s
connect-retry backoff (24-34), queue flush while disconnected (78-83).
Quantization (float x127 clamped int8, 43-46) runs on device in the demod
model; this class moves bytes.

`SampleFifo` replaces the CircularBuffer ingest ring
(demodulator.cpp:38,54-74): frontends push interleaved float IQ from their
receive thread; the demod loop pops fixed-size complex blocks.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque

import numpy as np

__all__ = ["SymbolSender", "SampleFifo"]


class SymbolSender:
    MAX_QUEUE = 1024 * 1024     # symbols (SymbolManager.cpp:97)
    CHUNK = 16384               # bytes per send (SymbolManager.cpp:38)

    def __init__(self, address: str = "127.0.0.1", port: int = 5000):
        self.address = address
        self.port = port
        self._q: deque[np.ndarray] = deque()
        self._qlen = 0
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._last_retry = 0.0
        self.dropped = 0

    def add(self, symbols: np.ndarray) -> None:
        """Queue int8 symbols (drops with a warning when over cap)."""
        symbols = np.asarray(symbols, np.int8)
        with self._lock:
            if self._qlen + len(symbols) > self.MAX_QUEUE:
                self.dropped += len(symbols)
                return
            self._q.append(symbols)
            self._qlen += len(symbols)

    def _connect(self) -> bool:
        now = time.monotonic()
        if now - self._last_retry < 1.0:     # 1 s backoff
            return False
        self._last_retry = now
        try:
            self._sock = socket.create_connection(
                (self.address, self.port), timeout=2.0
            )
            self._sock.settimeout(2.0)
            return True
        except OSError:
            self._sock = None
            return False

    def process(self) -> None:
        """One pump iteration (reference main-loop body, demodulator.cpp:484)."""
        if self._sock is None:
            if not self._connect():
                # flush queue while disconnected (SymbolManager.cpp:78-83)
                with self._lock:
                    self._q.clear()
                    self._qlen = 0
                return
        buf = []
        n = 0
        with self._lock:
            while self._q and n < self.CHUNK:
                a = self._q.popleft()
                take = min(len(a), self.CHUNK - n)
                buf.append(a[:take])
                if take < len(a):
                    self._q.appendleft(a[take:])
                n += take
            self._qlen -= n
        if not buf:
            return
        data = np.concatenate(buf).tobytes()
        try:
            self._sock.sendall(data)
        except OSError:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def drain(self) -> None:
        """Pump until the queue empties or stops making progress (link
        down -> process() flushes, reference disconnect semantics).  The
        reference's main loop calls process() far more often than once
        per demod block (demodulator.cpp:484); a block-loop caller must
        drain, or the ~2 chunks/block it would otherwise send caps the
        queue and silently drops the stream's tail."""
        while self._qlen > 0:
            before = self._qlen
            self.process()
            if self._qlen >= before:
                break

    def close(self) -> None:
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class SampleFifo:
    """Bounded interleaved-IQ float FIFO between receive threads and the
    demod block loop (CircularBuffer replacement, FIFO_SIZE semantics).

    Uses the native C++ SPSC ring (runtime/native.py) when the toolchain is
    available — the reference's ingest ring is C++ too (SatHelper
    CircularBuffer) — with a pure-Python fallback.
    """

    def __init__(
        self,
        capacity: int = 1024 * 1024,
        blocking: bool = False,
        use_native: bool | None = None,
    ):
        """`blocking=True` applies backpressure to the producer instead of
        dropping on overflow — right for faster-than-realtime file playback
        (the reference instead paces files by wall clock,
        CFileFrontend.cpp:33-62); live SDR sources keep the reference's
        drop-and-warn policy (demodulator.cpp:104-106)."""
        self.capacity = capacity
        self.blocking = blocking
        self._ring = None
        if use_native is not False:
            from xritdemod_tpu_torch.runtime import native

            if native.available():
                try:
                    self._ring = native.NativeRing(capacity)
                except RuntimeError:
                    self._ring = None
        self._chunks: deque[np.ndarray] = deque()
        self._len = 0
        self._lock = threading.Lock()
        self._data_ready = threading.Condition(self._lock)
        self._space_ready = threading.Condition(self._lock)
        self.overflows = 0
        self.closed = False

    def close(self) -> None:
        """Release any producer blocked in push (app teardown)."""
        if self._ring is not None:
            self.closed = True
            self._ring.close()
            return
        with self._lock:
            self.closed = True
            self._space_ready.notify_all()

    def push(self, iq: np.ndarray) -> None:
        if self._ring is not None:
            got = self._ring.push(
                np.asarray(iq, np.float32), blocking=self.blocking
            )
            if got == 0 and not self.blocking:
                self.overflows += 1
            return
        with self._data_ready:
            if self._len + len(iq) > self.capacity:
                if not self.blocking:
                    self.overflows += 1
                    return
                while self._len + len(iq) > self.capacity and not self.closed:
                    self._space_ready.wait(0.1)
                if self.closed:
                    return
            self._chunks.append(np.asarray(iq, np.float32))
            self._len += len(iq)
            self._data_ready.notify()

    def size(self) -> int:
        if self._ring is not None:
            return self._ring.size()
        with self._lock:
            return self._len

    def usage(self) -> float:
        return self.size() / self.capacity

    def pop_block(self, nsamples: int, timeout: float | None = None):
        """Pop `nsamples` complex samples as a `(n,) complex64` array, or
        None on timeout.  `nsamples` complex = 2*nsamples floats."""
        need = 2 * nsamples
        if self._ring is not None:
            ms = -1 if timeout is None else int(timeout * 1000)
            out = self._ring.pop(need, timeout_ms=ms)
            if out is None:
                return None
            return out[0::2] + 1j * out[1::2]
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._data_ready:
            while self._len < need:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._data_ready.wait(remaining if remaining else 0.1)
            out = np.empty(need, np.float32)
            n = 0
            while n < need:
                a = self._chunks.popleft()
                take = min(len(a), need - n)
                out[n : n + take] = a[:take]
                if take < len(a):
                    self._chunks.appendleft(a[take:])
                n += take
            self._len -= need
            self._space_ready.notify_all()
        return out[0::2] + 1j * out[1::2]
