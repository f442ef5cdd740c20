"""SpyServer network IQ client — the framework's network sample source.

The port's own copy of `xritdemod_tpu/runtime/spyserver.py` (host code, no device
work); `tests/test_torch_imports.py` pins that the two agree.

Speaks the Airspy SpyServer binary protocol v2 (protocol constants and wire
structs per the published spec, mirrored by the reference's
demodulator/src/{SpyServerProtocol.h,SpyServerFrontend.cpp}):
HELLO handshake, SET_SETTING commands, 20-byte message headers, device-info
/ client-sync state, and u8/s16/float IQ body decoding with sequence-gap
detection.  This is the only network sample source worth keeping on an
accelerator host (SURVEY.md §7 layer 4); it exposes the same FrontendDevice interface
as the file frontend.
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np

from xritdemod_tpu_torch.runtime.frontends import FrontendDevice, SampleType

__all__ = ["SpyServerFrontend"]

PROTOCOL_VERSION = (2 << 24) | (0 << 16) | 1558

CMD_HELLO = 0
CMD_SET_SETTING = 2

SETTING_STREAMING_MODE = 0
SETTING_STREAMING_ENABLED = 1
SETTING_GAIN = 2
SETTING_IQ_FORMAT = 100
SETTING_IQ_FREQUENCY = 101
SETTING_IQ_DECIMATION = 102

STREAM_TYPE_IQ = 1
STREAM_MODE_IQ_ONLY = STREAM_TYPE_IQ

STREAM_FORMAT_UINT8 = 1
STREAM_FORMAT_INT16 = 2
STREAM_FORMAT_FLOAT = 4

MSG_TYPE_DEVICE_INFO = 0
MSG_TYPE_CLIENT_SYNC = 1
MSG_TYPE_UINT8_IQ = 100
MSG_TYPE_INT16_IQ = 101
MSG_TYPE_FLOAT_IQ = 103

_HEADER_FMT = "<5I"        # ProtocolID, MessageType, StreamType, Seq, BodySize
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
_DEVICE_INFO_FMT = "<9I"
_CLIENT_SYNC_FMT = "<9I"


class SpyServerFrontend(FrontendDevice):
    """Network IQ source with the FrontendDevice push-callback contract."""

    def __init__(self, host: str, port: int, name: str = "xritdemod_tpu"):
        self.host = host
        self.port = port
        self.client_name = name
        self._sock: socket.socket | None = None
        self._cb = None
        self._thread: threading.Thread | None = None
        self._running = False
        self._streaming = False
        self.device_info: dict | None = None
        self.sync_info: dict | None = None
        self.dropped_buffers = 0
        self._last_seq = 0
        self._got_sync = threading.Event()
        self.sample_rate = 0
        self.center_frequency = 0
        self._decimation_stages: list[int] = []
        self.gain = 0

    # -- connection --------------------------------------------------------
    def connect(self, timeout: float = 5.0) -> None:
        self._sock = socket.create_connection((self.host, self.port), timeout)
        self._sock.settimeout(1.0)
        self._say_hello()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        if not self._got_sync.wait(timeout):
            raise TimeoutError("SpyServer handshake: no device info / sync")

    def disconnect(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=3)
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _say_hello(self) -> None:
        name = self.client_name.encode()
        body = struct.pack("<II", PROTOCOL_VERSION, len(name)) + name
        self._send_command(CMD_HELLO, body)

    def _send_command(self, cmd: int, body: bytes) -> None:
        assert self._sock is not None
        self._sock.sendall(struct.pack("<II", cmd, len(body)) + body)

    def set_setting(self, setting: int, value: int) -> None:
        self._send_command(
            CMD_SET_SETTING, struct.pack("<II", setting, value)
        )

    # -- FrontendDevice interface -----------------------------------------
    def get_name(self) -> str:
        return f"SpyServer ({self.host}:{self.port})"

    def set_sample_rate(self, rate: int) -> int:
        """Pick the decimation stage matching `rate`
        (SpyServerFrontend.cpp:445-459 semantics)."""
        if self.device_info is None:
            self.sample_rate = rate
            return rate
        max_rate = self.device_info["MaximumSampleRate"]
        for stage in range(self.device_info["DecimationStageCount"]):
            if max_rate // (1 << stage) == rate:
                self.sample_rate = rate
                self._decimation = stage
                self.set_setting(SETTING_IQ_DECIMATION, stage)
                return rate
        raise ValueError(
            f"sample rate {rate} not reachable from device max {max_rate}"
        )

    def set_center_frequency(self, freq: int) -> int:
        self.center_frequency = freq
        self.set_setting(SETTING_IQ_FREQUENCY, freq)
        return freq

    def get_center_frequency(self) -> int:
        return self.center_frequency

    def set_lna_gain(self, gain: int) -> None:
        self.gain = gain
        self.set_setting(SETTING_GAIN, gain)

    def start(self) -> None:
        self.set_setting(SETTING_STREAMING_MODE, STREAM_MODE_IQ_ONLY)
        self.set_setting(SETTING_IQ_FORMAT, STREAM_FORMAT_FLOAT)
        self.set_setting(SETTING_STREAMING_ENABLED, 1)
        self._streaming = True

    def stop(self) -> None:
        if self._streaming:
            try:
                self.set_setting(SETTING_STREAMING_ENABLED, 0)
            except OSError:
                pass
            self._streaming = False
        self.disconnect()

    # -- receive loop ------------------------------------------------------
    def _recv_exact(self, n: int) -> bytes | None:
        assert self._sock is not None
        buf = b""
        while len(buf) < n and self._running:
            try:
                chunk = self._sock.recv(n - len(buf))
            except socket.timeout:
                continue
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf if len(buf) == n else None

    def _loop(self) -> None:
        while self._running:
            hdr = self._recv_exact(_HEADER_SIZE)
            if hdr is None:
                break
            proto, mtype, stype, seq, body_size = struct.unpack(_HEADER_FMT, hdr)
            if (proto >> 24) != (PROTOCOL_VERSION >> 24):
                break  # protocol major mismatch
            body = self._recv_exact(body_size) if body_size else b""
            if body is None:
                break
            self._handle(mtype, seq, body)
        self._running = False

    def _handle(self, mtype: int, seq: int, body: bytes) -> None:
        if mtype == MSG_TYPE_DEVICE_INFO:
            vals = struct.unpack(_DEVICE_INFO_FMT, body[: 4 * 9])
            keys = (
                "DeviceType", "DeviceSerial", "MaximumSampleRate",
                "MaximumBandwidth", "DecimationStageCount", "GainStageCount",
                "MaximumGainIndex", "MinimumFrequency", "MaximumFrequency",
            )
            self.device_info = dict(zip(keys, vals))
            return
        if mtype == MSG_TYPE_CLIENT_SYNC:
            vals = struct.unpack(_CLIENT_SYNC_FMT, body[: 4 * 9])
            keys = (
                "CanControl", "Gain", "DeviceCenterFrequency",
                "IQCenterFrequency", "FFTCenterFrequency",
                "MinimumIQCenterFrequency", "MaximumIQCenterFrequency",
                "MinimumFFTCenterFrequency", "MaximumFFTCenterFrequency",
            )
            self.sync_info = dict(zip(keys, vals))
            self._got_sync.set()
            return
        if mtype in (MSG_TYPE_UINT8_IQ, MSG_TYPE_INT16_IQ, MSG_TYPE_FLOAT_IQ):
            # Sequence-gap detection (SpyServerFrontend.cpp:242-249).
            if self._last_seq and seq != self._last_seq + 1:
                self.dropped_buffers += seq - self._last_seq - 1
            self._last_seq = seq
            if self._cb is None:
                return
            if mtype == MSG_TYPE_UINT8_IQ:
                # recentre (x - 128) / 128 (SpyServerFrontend.cpp:396-424)
                iq = (
                    np.frombuffer(body, np.uint8).astype(np.float32) - 128.0
                ) / 128.0
                self._cb(iq, SampleType.FLOAT_IQ)
            elif mtype == MSG_TYPE_INT16_IQ:
                iq = np.frombuffer(body, np.int16).astype(np.float32) / 32768.0
                self._cb(iq, SampleType.FLOAT_IQ)
            else:
                self._cb(np.frombuffer(body, np.float32), SampleType.FLOAT_IQ)
