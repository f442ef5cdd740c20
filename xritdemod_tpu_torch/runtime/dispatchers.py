"""TCP broadcast servers for decoded VCDUs and statistics.

The port's own copy of `xritdemod_tpu/runtime/dispatchers.py` (host code, no device
work); `tests/test_torch_imports.py` pins that the two agree but for the
sending loop: the port sends everything queued each turn (`_take`), where
the JAX package's sends one payload a turn and so tops out at 20 a second,
and it ends only at the `stop` sentinel, having sent all queued before.

Wire-compatible replacements for the reference's ChannelDispatcher (VCDU
payload broadcast on :5001, decoder/src/ChannelDispatcher.cpp)
and StatisticsDispatcher (raw Statistics_st on :5002,
StatisticsDispatcher.cpp:39-86): nonblocking accept, send to every client,
prune dead connections.  One implementation serves both (the reference's two
classes differ only in threading detail).
"""

from __future__ import annotations

import queue
import socket
import threading

__all__ = ["BroadcastServer", "ChannelDispatcher", "StatisticsDispatcher"]


class BroadcastServer:
    """Threaded TCP fan-out: `add(data)` enqueues, every client receives."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        self.port = port
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self._srv.settimeout(0.05)
        self._clients: list[socket.socket] = []
        self._q: queue.Queue[bytes | None] = queue.Queue()
        self._running = False
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    @property
    def bound_port(self) -> int:
        return self._srv.getsockname()[1]

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._q.put(None)
        if self._thread:
            self._thread.join(timeout=2)
        with self._lock:
            for c in self._clients:
                try:
                    c.close()
                except OSError:
                    pass
            self._clients.clear()
        self._srv.close()

    def add(self, data: bytes) -> None:
        self._q.put(bytes(data))

    def add_many(self, items) -> None:
        """Enqueue a batch of payloads (one queue op per item is fine; the
        copy is what the per-frame reference loop pays too,
        ChannelPacket.cpp:11-15)."""
        for data in items:
            self._q.put(bytes(data))

    def num_clients(self) -> int:
        with self._lock:
            return len(self._clients)

    def _accept(self) -> None:
        try:
            c, _ = self._srv.accept()
            c.settimeout(2.0)
            with self._lock:
                self._clients.append(c)
        except (socket.timeout, OSError):
            pass

    def _take(self) -> tuple[bytes | None, bool]:
        """Everything queued, joined (the wire is a byte stream), waiting up
        to 0.05 s for the first payload; and whether `stop` was queued.
        The JAX package's loop sends one payload a turn, and each turn
        waits 0.05 s in `accept`: 20 payloads a second, below HRIT's ~57
        frames a second."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return None, False
        parts: list[bytes] = []
        item = first
        while item is not None:
            parts.append(item)
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return b"".join(parts), False
        return (b"".join(parts) if parts else None), True

    def _loop(self) -> None:
        # Runs until the `stop` sentinel, so everything queued before it is
        # sent (the JAX package's loop ends at its next turn after `stop`,
        # dropping what its queue still holds).
        while True:
            self._accept()
            data, stopping = self._take()
            if data is not None:
                self._send(data)
            if stopping:
                break

    def _send(self, data: bytes) -> None:
        dead = []
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            try:
                c.sendall(data)
            except OSError:
                dead.append(c)
        if dead:
            with self._lock:
                for c in dead:
                    try:
                        c.close()
                    except OSError:
                        pass
                    if c in self._clients:
                        self._clients.remove(c)


class ChannelDispatcher(BroadcastServer):
    """VCDU payload broadcast, reference port 5001."""


class StatisticsDispatcher(BroadcastServer):
    """Statistics_st broadcast, reference port 5002."""

    def update(self, statistics) -> None:
        self.add(statistics.pack())
