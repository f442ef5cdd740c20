"""Per-VCID channel files and corrupted-frame forensics.

The port's own copy of `xritdemod_tpu/runtime/channel_writer.py` (host code, no device
work); `tests/test_torch_imports.py` pins that the two agree.

Replaces the reference ChannelWriter
(decoder/src/ChannelWriter.cpp): append VCDU payloads to
`channels/channel_{vcid}.bin` (16-23) and dump corrupted frames plus a
statistics text file under `channels/errors/` for offline analysis (25-65).
"""

from __future__ import annotations

import os

__all__ = ["ChannelWriter"]


class ChannelWriter:
    def __init__(self, folder: str = "channels"):
        self.folder = folder
        os.makedirs(folder, exist_ok=True)
        self._count = 0

    def write_channel(self, data: bytes, vcid: int) -> None:
        path = os.path.join(self.folder, f"channel_{int(vcid)}.bin")
        with open(path, "ab") as f:
            f.write(bytes(data))

    def dump_corrupted_packet(self, data: bytes, stage: int) -> None:
        """stage 0 = coded frame, 1 = viterbi out, 2 = RS out
        (newdecoder.cpp:323-327)."""
        err = os.path.join(self.folder, "errors")
        os.makedirs(err, exist_ok=True)
        path = os.path.join(err, f"frame_{self._count}_{stage}.bin")
        with open(path, "wb") as f:
            f.write(bytes(data))

    def dump_corrupted_packet_statistics(
        self, vit_errors: int, corr: int, rs_errors
    ) -> None:
        err = os.path.join(self.folder, "errors")
        os.makedirs(err, exist_ok=True)
        path = os.path.join(err, f"frame_{self._count}_stats.txt")
        with open(path, "w") as f:
            f.write(f"viterbiErrors={int(vit_errors)}\n")
            f.write(f"syncCorrelation={int(corr)}\n")
            f.write(
                "rsErrors="
                + ",".join(str(int(r)) for r in rs_errors)
                + "\n"
            )
        self._count += 1
