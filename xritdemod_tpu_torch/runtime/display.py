"""Terminal receive dashboard (ANSI), mirroring the reference Display.

The port's own copy of `xritdemod_tpu/runtime/display.py` (host code, no device
work); `tests/test_torch_imports.py` pins that the two agree.

The reference draws a box-drawing dashboard with frame data, totals, and a
top-8 per-channel received/lost table, repositioning the cursor each frame
(decoder/src/Display.cpp:46-128 over SatHelper
ScreenManager).  Same content here with ANSI escapes.
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["Display"]

_CLEAR = "\x1b[2J"
_HOME = "\x1b[H"
_W = 58  # inner width; rows pad/truncate so borders stay aligned


def _row(text: str) -> str:
    if len(text) > _W:
        text = text[: _W - 1] + "…"
    return "│" + text.ljust(_W) + "│"


def _bar(title: str = "") -> str:
    pad = _W - len(title)
    left = pad // 2
    return "├" + "─" * left + title + "─" * (pad - left) + "┤"


class Display:
    def __init__(self, out=None):
        self.out = out or sys.stdout
        self._first = True

    def show(self, stats) -> None:
        s = stats
        top = "┌" + "─" * ((_W - 18) // 2) + " xRIT GPU Decoder " + "─" * (
            _W - 18 - (_W - 18) // 2
        ) + "┐"
        lines = [top]
        sw = " ".join(f"{b:02X}" for b in bytes(s.sync_word[:4]))
        lines.append(_row(
            f" SCID {s.scid:3d}  VCID {s.vcid:3d}  Counter {s.packet_number:8d}"
            f"  Lock {'YES' if s.frame_lock else ' NO'}"
        ))
        lines.append(_row(
            f" Viterbi {s.vit_errors:5d}/{s.frame_bits} bits   "
            f"Quality {s.signal_quality:3d}%   Corr {s.sync_correlation:2d}"
        ))
        rs = " ".join(f"{e:3d}" for e in s.rs_errors)
        lines.append(_row(f" RS [{rs}]   Phase {s.phase_correction:3d}°"))
        lines.append(_row(
            f" Frames {s.total_packets:8d}   Dropped {s.dropped_packets:6d}"
            f"   Lost {s.lost_packets:6d}"
        ))
        lines.append(_row(
            f" Avg Vit {s.average_vit_corrections:5d}   Avg RS "
            f"{s.average_rs_corrections:3d}   Sync {sw}"
        ))
        lines.append(_bar(" Channels (top 8 by received) "))
        recv = np.asarray(s.received_packets_per_channel)
        order = np.argsort(-recv)[:8]
        for vcid in order:
            if recv[vcid] <= 0:
                continue
            lost = int(np.asarray(s.lost_packets_per_channel)[vcid])
            lines.append(_row(
                f"  VCID {vcid:3d}: received {int(recv[vcid]):10d}  "
                f"lost {lost:8d}"
            ))
        lines.append("└" + "─" * _W + "┘")
        prefix = _CLEAR + _HOME if self._first else _HOME
        self._first = False
        self.out.write(prefix + "\n".join(lines) + "\n")
        self.out.flush()
