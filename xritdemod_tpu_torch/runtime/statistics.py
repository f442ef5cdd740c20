"""Receive statistics, wire-compatible with the reference's Statistics_st.

The port's own copy of `xritdemod_tpu/runtime/statistics.py` (host code, no device
work); `tests/test_torch_imports.py` pins that the two agree.

The reference broadcasts a packed C struct on TCP :5002 every frame
(decoder/src/Statistics.h:13-37, StatisticsDispatcher.cpp).
External GUIs parse those raw bytes, so `pack()` here reproduces the exact
`#pragma pack(1)` little-endian layout (STRUCT_SIZE = 4167 bytes).
"""

from __future__ import annotations

import dataclasses
import struct
import time

import numpy as np

__all__ = ["Statistics", "STRUCT_SIZE"]

_FMT = "<BBQHH4iBBBQHBQ256q256qQI4sBBB"
STRUCT_SIZE = struct.calcsize(_FMT)


@dataclasses.dataclass
class Statistics:
    """Mirror of Statistics_st plus the update bookkeeping the decoder main
    loop keeps around it (newdecoder.cpp:60-74, 361-383)."""

    scid: int = 0
    vcid: int = 0
    packet_number: int = 0
    vit_errors: int = 0
    frame_bits: int = 8192
    rs_errors: tuple = (0, 0, 0, 0)
    signal_quality: int = 0
    sync_correlation: int = 0
    phase_correction: int = 0
    lost_packets: int = 0
    average_vit_corrections: int = 0
    average_rs_corrections: int = 0
    dropped_packets: int = 0
    received_packets_per_channel: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(256, -1, np.int64)
    )
    lost_packets_per_channel: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(256, np.int64)
    )
    total_packets: int = 0
    start_time: int = dataclasses.field(default_factory=lambda: int(time.time()))
    sync_word: bytes = b"\x00\x00\x00\x00"
    frame_lock: bool = False
    demodulator_fifo_usage: int = 0
    decoder_fifo_usage: int = 0

    # -- aggregation state (not on the wire) ------------------------------
    _sum_vit: int = 0
    _sum_rs: int = 0
    _last_counter: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(256, -1, np.int64)
    )

    def update_frame(
        self,
        *,
        scid: int,
        vcid: int,
        counter: int,
        vit_errors: int,
        rs_errors,
        sync_correlation: int,
        phase_correction: int,
        frame_ok: bool,
    ) -> None:
        """Per-frame bookkeeping exactly as newdecoder.cpp:286-383."""
        self.total_packets += 1
        self.vit_errors = int(vit_errors)
        self._sum_vit += int(vit_errors)
        rs = tuple(int(r) for r in rs_errors)
        self.rs_errors = rs
        self.sync_correlation = int(sync_correlation)
        pct = 100.0 - (100.0 * vit_errors / self.frame_bits) * 10.0
        self.signal_quality = int(max(pct, 0.0))
        self.average_vit_corrections = self._sum_vit // self.total_packets

        if not frame_ok:
            self.dropped_packets += 1
            self.frame_lock = False
            self.scid = 0
            self.vcid = 0
            self.packet_number = 0
            self.phase_correction = 0
        else:
            self._sum_rs += sum(r for r in rs if r > 0)
            self.frame_lock = True
            self.scid = int(scid)
            self.vcid = int(vcid)
            self.packet_number = int(counter)
            self.phase_correction = int(phase_correction)
            last = int(self._last_counter[vcid])
            if last > -1 and last + 1 != counter:
                lost = int(counter - last - 1)
                if lost > 0:
                    self.lost_packets += lost
                    self.lost_packets_per_channel[vcid] += lost
            self._last_counter[vcid] = counter
            if self.received_packets_per_channel[vcid] == -1:
                self.received_packets_per_channel[vcid] = 1
            else:
                self.received_packets_per_channel[vcid] += 1
        self.average_rs_corrections = (
            self._sum_rs // self.total_packets if self.total_packets else 0
        )

    def update_batch(
        self,
        *,
        scid,
        vcid,
        counter,
        vit_errors,
        rs_errors,
        sync_correlation,
        phase_correction,
        frame_ok,
    ) -> None:
        """Vectorized equivalent of calling `update_frame` once per frame
        in stream order (arrays of length B).  The per-frame Python loop
        is the reference's cadence (newdecoder.cpp:370-395, one frame per
        socket read); at the device's 20k+ frames/s it becomes the host
        bottleneck, so the bookkeeping runs as numpy batch ops — final
        state is identical (pinned by tests/test_runtime.py)."""
        ok = np.asarray(frame_ok, bool)
        vcid = np.asarray(vcid, np.int64)
        counter = np.asarray(counter, np.int64)
        vit = np.asarray(vit_errors, np.int64)
        B = len(ok)
        if B == 0:
            return
        self.total_packets += B
        self._sum_vit += int(vit.sum())
        self.average_vit_corrections = self._sum_vit // self.total_packets
        self.dropped_packets += int((~ok).sum())

        rs = np.asarray(rs_errors, np.int64).reshape(B, 4)
        self._sum_rs += int(np.where(rs[ok] > 0, rs[ok], 0).sum())
        self.average_rs_corrections = self._sum_rs // self.total_packets

        # Per-VCID received / lost accounting over the ok frames, in order.
        okv = vcid[ok]
        okc = counter[ok]
        for v in np.unique(okv):
            idx = okv == v
            ctrs = okc[idx]
            seq = np.concatenate([[self._last_counter[v]], ctrs])
            d = np.diff(seq) - 1
            if seq[0] == -1:
                d[0] = 0
            lost = int(d[d > 0].sum())
            if lost:
                self.lost_packets += lost
                self.lost_packets_per_channel[v] += lost
            n = int(idx.sum())
            if self.received_packets_per_channel[v] == -1:
                self.received_packets_per_channel[v] = n
            else:
                self.received_packets_per_channel[v] += n
            self._last_counter[v] = ctrs[-1]

        # Scalar wire fields reflect the LAST frame, exactly as the
        # sequential loop leaves them.
        k = B - 1
        self.vit_errors = int(vit[k])
        self.rs_errors = tuple(int(r) for r in rs[k])
        self.sync_correlation = int(np.asarray(sync_correlation)[k])
        pct = 100.0 - (100.0 * vit[k] / self.frame_bits) * 10.0
        self.signal_quality = int(max(pct, 0.0))
        if not ok[k]:
            self.frame_lock = False
            self.scid = 0
            self.vcid = 0
            self.packet_number = 0
            self.phase_correction = 0
        else:
            self.frame_lock = True
            self.scid = int(np.asarray(scid)[k])
            self.vcid = int(vcid[k])
            self.packet_number = int(counter[k])
            self.phase_correction = int(np.asarray(phase_correction)[k])

    def pack(self) -> bytes:
        """Serialize to the exact Statistics_st wire bytes."""
        return struct.pack(
            _FMT,
            self.scid & 0xFF,
            self.vcid & 0xFF,
            self.packet_number,
            min(self.vit_errors, 0xFFFF),
            self.frame_bits,
            *[int(r) for r in self.rs_errors],
            self.signal_quality & 0xFF,
            int(self.sync_correlation) & 0xFF,
            self.phase_correction & 0xFF,
            self.lost_packets,
            min(self.average_vit_corrections, 0xFFFF),
            min(self.average_rs_corrections, 0xFF),
            self.dropped_packets,
            *[int(v) for v in self.received_packets_per_channel],
            *[int(v) for v in self.lost_packets_per_channel],
            self.total_packets,
            self.start_time & 0xFFFFFFFF,
            bytes(self.sync_word[:4]).ljust(4, b"\x00"),
            1 if self.frame_lock else 0,
            self.demodulator_fifo_usage & 0xFF,
            self.decoder_fifo_usage & 0xFF,
        )
