"""Sample sources: the FrontendDevice interface and the file frontend.

The port's own copy of `xritdemod_tpu/runtime/frontends.py` (host code, no device
work); `tests/test_torch_imports.py` pins that the two agree.

Mirrors the reference's frontend abstraction
(demodulator/src/FrontendDevice.h:19-38): rate/frequency/
gain control plus push-callback sample delivery in one of three wire types.
`CFileFrontend` (recorded-capture playback, CFileFrontend.cpp:33-62 — the
reference's de facto integration test), `RtlFrontend` (u8 playback + live
USB) live here; the SpyServer network client is runtime/spyserver.py and
the other hardware-USB frontends (Airspy/HackRF/SDRPlay, ctypes bindings
with the same raise-only-when-library-absent contract) are
runtime/usb_frontends.py.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

import numpy as np

__all__ = [
    "SampleType",
    "FrontendDevice",
    "CFileFrontend",
    "RtlFrontend",
    "DcBlocker",
    "normalize_samples",
    "rtl_u8_lut",
    "make_frontend",
]


class SampleType:
    FLOAT_IQ = 0
    S16_IQ = 1
    S8_IQ = 2


def normalize_samples(data: np.ndarray, sample_type: int) -> np.ndarray:
    """Wire-type -> float32 normalization (demodulator.cpp:54-74):
    s16 / 32768, s8 / 128, float passthrough."""
    if sample_type == SampleType.FLOAT_IQ:
        return np.asarray(data, np.float32)
    if sample_type == SampleType.S16_IQ:
        return np.asarray(data, np.int16).astype(np.float32) / 32768.0
    if sample_type == SampleType.S8_IQ:
        return np.asarray(data, np.int8).astype(np.float32) / 128.0
    raise ValueError(f"unknown sample type {sample_type}")


def rtl_u8_lut() -> np.ndarray:
    """RTL-SDR u8 -> float LUT `(i - 128) / 127` (RtlFrontend.cpp:26-28)."""
    return ((np.arange(256) - 128) * (1.0 / 127.0)).astype(np.float32)


class DcBlocker:
    """Single-pole DC-removal IIR for interleaved IQ (RtlFrontend.cpp:57,
    102-118): avg += alpha * (x - avg); x -= avg, with
    alpha = 1 - exp(-1 / (sample_rate * 0.05)).

    Unlike the reference (whose `if (i % 1)` branch condition is always
    false, so the Q average never runs and both rails share one average —
    RtlFrontend.cpp:107, a known bug this build deliberately fixes), I and
    Q carry separate averages.  The recursion is an EMA — linear in the
    carried average — so it is evaluated vectorized per chunk:
    within a chunk, avg_n = d^n * avg_0 + alpha * sum_i d^(n-1-i) x_i with
    d = 1 - alpha, computed as cumsum(x_i / d^i) scaled back by d^n
    (chunks are sized so d^-n stays comfortably in float64 range).
    """

    CHUNK = 4096  # per rail; alpha ~1e-5..1e-4 -> d^-4096 <~ 1.5

    def __init__(self, sample_rate: float):
        self.alpha = float(1.0 - np.exp(-1.0 / (sample_rate * 0.05)))
        self.iavg = 0.0
        self.qavg = 0.0

    def _rail(self, x: np.ndarray, avg: float) -> tuple[np.ndarray, float]:
        d = 1.0 - self.alpha
        out = np.empty_like(x, np.float32)
        for s in range(0, len(x), self.CHUNK):
            c = x[s : s + self.CHUNK].astype(np.float64)
            n = len(c)
            pows = d ** np.arange(1, n + 1)
            avgs = pows * avg + self.alpha * pows * np.cumsum(c / pows)
            out[s : s + n] = (c - avgs).astype(np.float32)
            avg = float(avgs[-1])
        return out, avg

    def process(self, iq: np.ndarray) -> np.ndarray:
        """Interleaved IQ float32 in -> DC-blocked out (stateful)."""
        out = np.empty_like(iq, np.float32)
        out[0::2], self.iavg = self._rail(iq[0::2], self.iavg)
        out[1::2], self.qavg = self._rail(iq[1::2], self.qavg)
        return out


Callback = Callable[[np.ndarray, int], None]  # (interleaved samples, type)


class FrontendDevice:
    """Abstract SDR source (FrontendDevice.h contract)."""

    def set_sample_rate(self, rate: int) -> int:
        raise NotImplementedError

    def set_center_frequency(self, freq: int) -> int:
        raise NotImplementedError

    def get_center_frequency(self) -> int:
        raise NotImplementedError

    def get_name(self) -> str:
        raise NotImplementedError

    def set_agc(self, enabled: bool) -> None:
        pass

    def set_lna_gain(self, gain: int) -> None:
        pass

    def set_vga_gain(self, gain: int) -> None:
        pass

    def set_mixer_gain(self, gain: int) -> None:
        pass

    def set_biast(self, enabled: bool) -> None:
        pass

    def set_samples_available_callback(self, cb: Callback) -> None:
        self._cb = cb

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError


class CFileFrontend(FrontendDevice):
    """Recorded complex64 capture playback (CFileFrontend.cpp:33-62).

    Reads BUFFERSIZE-sample chunks; with `realtime=True` paces delivery to
    the configured sample rate by wall clock like the reference
    (fPeriod = BUFFERSIZE/sampleRate); stops at EOF.
    """

    BUFFER_SIZE = 65536

    def __init__(self, filename: str, realtime: bool = False):
        self.filename = filename
        self.realtime = realtime
        self.sample_rate = 0
        self.center_frequency = 0
        self._cb: Callback | None = None
        self._thread: threading.Thread | None = None
        self._running = False

    def set_sample_rate(self, rate: int) -> int:
        self.sample_rate = rate
        return rate

    def set_center_frequency(self, freq: int) -> int:
        self.center_frequency = freq
        return freq

    def get_center_frequency(self) -> int:
        return self.center_frequency

    def get_name(self) -> str:
        return f"CFileFrontend ({os.path.basename(self.filename)})"

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)

    def join(self) -> None:
        if self._thread:
            self._thread.join()

    @property
    def running(self) -> bool:
        return self._running

    def _loop(self) -> None:
        period = (
            self.BUFFER_SIZE / self.sample_rate
            if (self.realtime and self.sample_rate)
            else 0.0
        )
        with open(self.filename, "rb") as f:
            while self._running:
                t0 = time.monotonic()
                raw = f.read(self.BUFFER_SIZE * 8)  # complex64
                if not raw:
                    break
                data = np.frombuffer(raw, np.complex64)
                iq = np.empty(2 * len(data), np.float32)
                iq[0::2] = data.real
                iq[1::2] = data.imag
                if self._cb is not None:
                    self._cb(iq, SampleType.FLOAT_IQ)
                if period:
                    dt = period - (time.monotonic() - t0)
                    if dt > 0:
                        time.sleep(dt)
        self._running = False


def load_librtlsdr():
    """ctypes-load librtlsdr, or None when absent on this host."""
    import ctypes
    import ctypes.util

    name = ctypes.util.find_library("rtlsdr")
    for cand in ([name] if name else []) + [
        "librtlsdr.so.0", "librtlsdr.so", "librtlsdr.dylib"
    ]:
        try:
            return ctypes.CDLL(cand)
        except OSError:
            continue
    return None


class RtlFrontend(FrontendDevice):
    """RTL-SDR-class frontend (RtlFrontend.{h,cpp}): u8 LUT normalization
    `(i-128)/127` plus the single-pole DC blocker, delivering FLOAT_IQ.

    Two sources:
      - `filename=`: recorded raw u8 interleaved-IQ capture playback (the
        rtl_sdr(1) output format) — the testable path on this host;
      - live USB via ctypes-loaded librtlsdr (the reference's async-read
        loop, RtlFrontend.cpp:98-118, as a sync-read thread): open device
        `device_index`, program rate/frequency/gain, stream BUFFER_SIZE-
        byte chunks through the same LUT + DC blocker.  `start()` raises
        only when the shared library is actually absent.  A library handle
        can be injected for tests (`library=`).

    The reference's `if (i % 1)` DC-blocker bug (Q average never updates,
    RtlFrontend.cpp:107) is deliberately fixed — see DcBlocker.
    """

    BUFFER_SIZE = 16384  # u8 values per read, as rtlsdr_read_async

    def __init__(self, filename: str | None = None, device_index: int = 0,
                 realtime: bool = False, library=None,
                 signed_input: bool = False):
        self.filename = filename
        self.device_index = device_index
        self.realtime = realtime
        # signed_input: the capture file holds SIGNED 8-bit IQ (s8);
        # XOR 0x80 recenters it to the u8 convention before the LUT
        # (exactly (v + 128), so s8 value x -> x/127 like the wire).
        self.signed_input = signed_input
        self.sample_rate = 2_560_000   # reference default RtlFrontend.cpp:16
        self.center_frequency = 106_300_000
        self.lna_gain = 0
        self.agc = False
        self.bias_tee = False
        self._lib = library
        self._dev = None
        self._lut = rtl_u8_lut()
        self._dc: DcBlocker | None = None
        self._cb: Callback | None = None
        self._thread: threading.Thread | None = None
        self._running = False

    def set_sample_rate(self, rate: int) -> int:
        self.sample_rate = rate
        self._dc = None   # re-derive alpha on next start
        return rate

    def set_center_frequency(self, freq: int) -> int:
        self.center_frequency = freq
        return freq

    def get_center_frequency(self) -> int:
        return self.center_frequency

    def get_name(self) -> str:
        return "RtlFrontend"

    def set_lna_gain(self, gain: int) -> None:
        self.lna_gain = gain

    def set_agc(self, agc: bool) -> None:
        self.agc = bool(agc)

    def set_bias_t(self, bias: bool) -> None:
        self.bias_tee = bool(bias)

    def _open_usb(self):
        """Open + program the device (RtlFrontend.cpp startup sequence)."""
        import ctypes

        lib = self._lib if self._lib is not None else load_librtlsdr()
        if lib is None:
            raise NotImplementedError(
                "live RTL-SDR USB capture requires librtlsdr, which was "
                "not found on this host; pass filename= for recorded u8 "
                "IQ playback"
            )
        self._lib = lib
        dev = ctypes.c_void_p()
        if lib.rtlsdr_open(ctypes.byref(dev), int(self.device_index)):
            raise RuntimeError(
                f"rtlsdr_open({self.device_index}) failed — no device?"
            )
        self._dev = dev
        lib.rtlsdr_set_sample_rate(dev, int(self.sample_rate))
        lib.rtlsdr_set_center_freq(dev, int(self.center_frequency))
        if self.agc:
            lib.rtlsdr_set_tuner_gain_mode(dev, 0)
            lib.rtlsdr_set_agc_mode(dev, 1)
        else:
            lib.rtlsdr_set_tuner_gain_mode(dev, 1)
            lib.rtlsdr_set_tuner_gain(dev, int(self.lna_gain * 10))
        if self.bias_tee and hasattr(lib, "rtlsdr_set_bias_tee"):
            lib.rtlsdr_set_bias_tee(dev, 1)
        lib.rtlsdr_reset_buffer(dev)

    def start(self) -> None:
        if self.filename is None:
            self._open_usb()
        self._dc = DcBlocker(self.sample_rate)
        self._running = True
        target = self._loop if self.filename is not None else self._usb_loop
        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)
        if self._dev is not None and self._lib is not None:
            self._lib.rtlsdr_close(self._dev)
            self._dev = None

    def join(self) -> None:
        if self._thread:
            self._thread.join()

    @property
    def running(self) -> bool:
        return self._running

    def _loop(self) -> None:
        period = (
            self.BUFFER_SIZE / 2 / self.sample_rate
            if (self.realtime and self.sample_rate)
            else 0.0
        )
        with open(self.filename, "rb") as f:
            while self._running:
                t0 = time.monotonic()
                raw = f.read(self.BUFFER_SIZE)
                if not raw:
                    break
                u8 = np.frombuffer(raw, np.uint8)
                if self.signed_input:
                    u8 = u8 ^ 0x80
                iq = self._lut[u8]
                iq = self._dc.process(iq)
                if self._cb is not None:
                    self._cb(iq, SampleType.FLOAT_IQ)
                if period:
                    dt = period - (time.monotonic() - t0)
                    if dt > 0:
                        time.sleep(dt)
        self._running = False

    def _usb_loop(self) -> None:
        """Blocking sync-read loop over librtlsdr (the thread equivalent
        of the reference's rtlsdr_read_async callback)."""
        import ctypes

        buf = (ctypes.c_ubyte * self.BUFFER_SIZE)()
        n_read = ctypes.c_int(0)
        while self._running:
            r = self._lib.rtlsdr_read_sync(
                self._dev, buf, self.BUFFER_SIZE, ctypes.byref(n_read)
            )
            n = int(n_read.value)
            if r or n <= 0:
                break
            raw = np.frombuffer(
                bytes(memoryview(buf)[:n]), np.uint8
            )
            iq = self._dc.process(self._lut[raw])
            if self._cb is not None:
                self._cb(iq, SampleType.FLOAT_IQ)
        self._running = False


def make_frontend(device_type: str, cfg) -> FrontendDevice:
    """Frontend construction by config string (demodulator.cpp:340-428)."""
    device_type = device_type.lower()
    if device_type == "cfile":
        return CFileFrontend(cfg.get("filename"))
    if device_type == "spyserver":
        from xritdemod_tpu_torch.runtime.spyserver import SpyServerFrontend

        return SpyServerFrontend(
            cfg.get("spyserverHost"), int(cfg.get("spyserverPort"))
        )
    if device_type == "rtlsdr":
        return RtlFrontend(filename=cfg.get("filename") or None)
    if device_type == "airspy":
        from xritdemod_tpu_torch.runtime.usb_frontends import AirspyFrontend

        return AirspyFrontend()
    if device_type == "hackrf":
        from xritdemod_tpu_torch.runtime.usb_frontends import HackRFFrontend

        return HackRFFrontend()
    if device_type == "sdrplay":
        from xritdemod_tpu_torch.runtime.usb_frontends import SDRPlayFrontend

        return SDRPlayFrontend()
    raise ValueError(f"unknown deviceType '{device_type}'")
