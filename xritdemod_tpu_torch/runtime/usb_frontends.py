"""Hardware-USB frontends: Airspy, HackRF, SDRPlay — via ctypes bindings.

The port's own copy of `xritdemod_tpu/runtime/usb_frontends.py` (host code, no device
work); `tests/test_torch_imports.py` pins that the two agree.

Behavioral equivalents of the reference's three remaining SDR sources:

- AirspyFrontend   <- demodulator/src/AirspyDevice.cpp
  (libairspy: device probe 42-128, float32-IQ native sample type 245-251,
  start_rx callback 197-209, stop/start sample-rate dance 219-242, center-
  frequency clamp 24 MHz..1.75 GHz 244-254, dropped-sample warning 256-259)
- HackRFFrontend   <- demodulator/src/HackRFFrontend.cpp
  (libhackrf: the reference ships the whole file `#if 0`-disabled at :8;
  this is a working implementation of the same contract: LUT-normalized
  8-bit IQ + single-pole DC blocker -> FLOAT_IQ callback 33-58)
- SDRPlayFrontend  <- demodulator/src/SDRPlayFrontend.cpp
  (mirsdrapi-rsp, reference compiles it only under NON_FREE: StreamInit
  112-143, split-rail s16 -> interleaved float /32768 18-37, 1st-LO +
  decimation setup 49-71, AgcControl 152-154)

All three follow the RtlFrontend live-USB pattern (runtime/frontends.py):
the shared library is ctypes-loaded lazily, `start()` raises
NotImplementedError only when the library is genuinely absent on the host,
and a library handle can be injected (`library=`) so the full device
programming + sample delivery path is unit-testable without hardware
(tests/test_usb_frontends.py).

Deliberate fixes over the reference (documented, mirroring the RtlFrontend
DC-blocker fix):
- HackRF samples are SIGNED 8-bit (libhackrf contract); the reference's
  disabled code indexes them through the unsigned RTL LUT `(b-128)/127`
  (HackRFFrontend.cpp:45), which maps +1 -> -1.0.  Here the LUT decodes the
  byte as int8: `int8(b)/128`.
- The `if (i % 1)` DC-blocker bug (always false, Q rail never updates —
  HackRFFrontend.cpp:46) is fixed by reusing the two-rail DcBlocker.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from ctypes import (
    CFUNCTYPE,
    POINTER,
    byref,
    c_char,
    c_double,
    c_float,
    c_int,
    c_short,
    c_ubyte,
    c_uint,
    c_uint8,
    c_uint32,
    c_uint64,
    c_void_p,
)

import numpy as np

from xritdemod_tpu_torch.runtime.frontends import (
    DcBlocker,
    FrontendDevice,
    SampleType,
)

__all__ = [
    "AirspyFrontend",
    "HackRFFrontend",
    "SDRPlayFrontend",
    "AirspyTransfer",
    "HackRFTransfer",
    "hackrf_s8_lut",
    "load_libairspy",
    "load_libhackrf",
    "load_libmirsdr",
]


def _load(*names: str):
    """ctypes-load the first available of `names`, or None when absent."""
    found = ctypes.util.find_library(names[0].split("lib", 1)[-1].split(".")[0])
    for cand in ([found] if found else []) + list(names):
        try:
            return ctypes.CDLL(cand)
        except OSError:
            continue
    return None


def load_libairspy():
    return _load("libairspy.so.0", "libairspy.so", "libairspy.dylib")


def load_libhackrf():
    return _load("libhackrf.so.0", "libhackrf.so", "libhackrf.dylib")


def load_libmirsdr():
    return _load(
        "libmirsdrapi-rsp.so.2", "libmirsdrapi-rsp.so", "libmirsdrapi-rsp.dylib"
    )


# ---------------------------------------------------------------------------
# Airspy
# ---------------------------------------------------------------------------

AIRSPY_SAMPLE_FLOAT32_IQ = 0  # enum airspy_sample_type (libairspy airspy.h)


class AirspyPartIdSerial(ctypes.Structure):
    """airspy_read_partid_serialno_t (libairspy airspy.h)."""

    _fields_ = [("part_id", c_uint32 * 2), ("serial_no", c_uint32 * 4)]


class AirspyTransfer(ctypes.Structure):
    """struct airspy_transfer (libairspy airspy.h)."""

    _fields_ = [
        ("device", c_void_p),
        ("ctx", c_void_p),
        ("samples", c_void_p),
        ("sample_count", c_int),
        ("dropped_samples", c_uint64),
        ("sample_type", c_int),
    ]


AIRSPY_RX_CALLBACK = CFUNCTYPE(c_int, POINTER(AirspyTransfer))


class AirspyFrontend(FrontendDevice):
    """Airspy R2/Mini via ctypes libairspy (AirspyDevice.cpp).

    Device probe on start (board id, firmware version, part/serial, rate
    list — AirspyDevice.cpp:42-128), native FLOAT32-IQ delivery (no LUT or
    DC blocker needed, :245-251), reference defaults LNA 8 / mixer 5 /
    VGA 5 (:125-127), frequency clamp [24 MHz, 1.75 GHz] (:244-254),
    stop/start dance when the rate changes mid-stream (:219-242), and a
    dropped-sample warning counter (:256-259).
    """

    FREQ_MIN = 24_000_000
    FREQ_MAX = 1_750_000_000

    def __init__(self, library=None):
        self._lib = library
        self._dev = None
        self._streaming = False
        self._cb = None
        self._c_cb = None  # keep the CFUNCTYPE alive while streaming
        self.sample_rate = 0
        self.center_frequency = 106_300_000  # AirspyDevice.cpp:114
        self.lna_gain = 8
        self.mixer_gain = 5
        self.vga_gain = 5
        self.agc = False
        self.available_sample_rates: list[int] = []
        self.board_id = -1
        self.firmware_version = ""
        self.serial_number = ""
        self.dropped_samples = 0
        self.name = "AirSpy"

    # -- FrontendDevice surface -------------------------------------------
    def get_name(self) -> str:
        return self.name

    def get_center_frequency(self) -> int:
        return self.center_frequency

    def set_center_frequency(self, freq: int) -> int:
        freq = min(max(int(freq), self.FREQ_MIN), self.FREQ_MAX)
        if self._dev is not None:
            self._lib.airspy_set_freq(self._dev, c_uint32(freq))
        self.center_frequency = freq
        return freq

    def set_sample_rate(self, rate: int) -> int:
        """Rate change restarts streaming when live (AirspyDevice.cpp:219)."""
        if self._dev is not None and rate != self.sample_rate:
            if self._streaming:
                self._lib.airspy_stop_rx(self._dev)
                self._lib.airspy_set_samplerate(self._dev, c_uint32(int(rate)))
                self._start_rx()
            else:
                self._lib.airspy_set_samplerate(self._dev, c_uint32(int(rate)))
        self.sample_rate = int(rate)
        return self.sample_rate

    def set_agc(self, agc: bool) -> None:
        self.agc = bool(agc)
        if self._dev is None:
            return
        if agc:  # AirspyDevice.cpp:158-166
            self._lib.airspy_set_lna_agc(self._dev, 1)
            self._lib.airspy_set_mixer_agc(self._dev, 1)
        else:
            self._lib.airspy_set_lna_agc(self._dev, 0)
            self._lib.airspy_set_mixer_agc(self._dev, 0)
            self.set_lna_gain(self.lna_gain)
            self.set_mixer_gain(self.mixer_gain)

    def set_lna_gain(self, gain: int) -> None:
        self.lna_gain = int(gain)
        if self._dev is not None:
            self._lib.airspy_set_lna_gain(self._dev, c_uint8(self.lna_gain))

    def set_vga_gain(self, gain: int) -> None:
        self.vga_gain = int(gain)
        if self._dev is not None:
            self._lib.airspy_set_vga_gain(self._dev, c_uint8(self.vga_gain))

    def set_mixer_gain(self, gain: int) -> None:
        self.mixer_gain = int(gain)
        if self._dev is not None:
            self._lib.airspy_set_mixer_gain(self._dev, c_uint8(self.mixer_gain))

    def set_biast(self, enabled: bool) -> None:
        if self._dev is not None:
            self._lib.airspy_set_rf_bias(self._dev, 1 if enabled else 0)

    # -- lifecycle ---------------------------------------------------------
    def _open(self) -> None:
        lib = self._lib if self._lib is not None else load_libairspy()
        if lib is None:
            raise NotImplementedError(
                "Airspy capture requires libairspy, not found on this host; "
                "use 'cfile' playback or 'spyserver' network IQ instead"
            )
        self._lib = lib
        dev = c_void_p()
        if lib.airspy_open(byref(dev)):
            raise RuntimeError("airspy_open failed — no device?")
        self._dev = dev
        # Device probe (AirspyDevice.cpp:49-112)
        bid = c_uint8(0)
        lib.airspy_board_id_read(dev, byref(bid))
        self.board_id = int(bid.value)
        ver = (c_char * 256)()
        lib.airspy_version_string_read(dev, ver, 255)
        self.firmware_version = bytes(ver.value).decode(errors="replace")
        ser = AirspyPartIdSerial()
        lib.airspy_board_partid_serialno_read(dev, byref(ser))
        self.serial_number = f"0x{ser.serial_no[2]:x}{ser.serial_no[3]:x}"
        n = c_uint32(0)
        lib.airspy_get_samplerates(dev, byref(n), 0)
        if n.value:
            rates = (c_uint32 * n.value)()
            lib.airspy_get_samplerates(dev, rates, n)
            self.available_sample_rates = [int(r) for r in rates]
        self.name = f"AirSpy({self.board_id}) - {self.serial_number}"
        lib.airspy_set_sample_type(dev, AIRSPY_SAMPLE_FLOAT32_IQ)
        # Program the configured (or default-first) operating point
        rate = self.sample_rate or (
            self.available_sample_rates[0] if self.available_sample_rates else 0
        )
        if rate:
            lib.airspy_set_samplerate(dev, c_uint32(int(rate)))
            self.sample_rate = int(rate)
        self.set_center_frequency(self.center_frequency)
        if self.agc:
            self.set_agc(True)
        else:
            self.set_lna_gain(self.lna_gain)
            self.set_mixer_gain(self.mixer_gain)
            self.set_vga_gain(self.vga_gain)

    def _on_transfer(self, tptr) -> int:
        t = tptr.contents
        if t.dropped_samples:
            self.dropped_samples += int(t.dropped_samples)
        if self._cb is not None and t.sample_count > 0:
            buf = ctypes.cast(t.samples, POINTER(c_float))
            iq = np.ctypeslib.as_array(buf, shape=(2 * t.sample_count,))
            self._cb(np.array(iq, np.float32), SampleType.FLOAT_IQ)
        return 0

    def _start_rx(self) -> None:
        self._c_cb = AIRSPY_RX_CALLBACK(lambda tptr: self._on_transfer(tptr))
        if self._lib.airspy_start_rx(self._dev, self._c_cb, None):
            raise RuntimeError("airspy_start_rx failed")
        self._streaming = True

    def start(self) -> None:
        if self._dev is None:
            self._open()
        self._start_rx()

    def stop(self) -> None:
        if self._dev is not None:
            if self._streaming:
                self._lib.airspy_stop_rx(self._dev)
                self._streaming = False
            self._lib.airspy_close(self._dev)
            self._dev = None

    @property
    def running(self) -> bool:
        return self._streaming


# ---------------------------------------------------------------------------
# HackRF
# ---------------------------------------------------------------------------


def hackrf_s8_lut() -> np.ndarray:
    """Byte -> float LUT decoding the raw byte as int8/128 (libhackrf
    delivers signed 8-bit IQ; fixes HackRFFrontend.cpp:45's unsigned LUT)."""
    return (np.arange(256, dtype=np.uint8).view(np.int8).astype(np.float32)
            / 128.0)


class HackRFTransfer(ctypes.Structure):
    """struct hackrf_transfer (libhackrf hackrf.h)."""

    _fields_ = [
        ("device", c_void_p),
        ("buffer", POINTER(c_ubyte)),
        ("buffer_length", c_int),
        ("valid_length", c_int),
        ("rx_ctx", c_void_p),
        ("tx_ctx", c_void_p),
    ]


HACKRF_RX_CALLBACK = CFUNCTYPE(c_int, POINTER(HackRFTransfer))

HACKRF_SAMPLE_RATES = (8_000_000, 10_000_000, 12_500_000, 16_000_000,
                       20_000_000)  # HackRFFrontend.cpp:16-18


class HackRFFrontend(FrontendDevice):
    """HackRF One via ctypes libhackrf (HackRFFrontend.cpp, which the
    reference ships `#if 0`-disabled — this is the working equivalent).

    8-bit IQ -> LUT normalize -> two-rail DC blocker -> FLOAT_IQ callback
    (the :33-58 pattern with the signedness and `i % 1` bugs fixed, see
    module docstring)."""

    def __init__(self, device_index: int = 0, library=None):
        self.device_index = int(device_index)
        self._lib = library
        self._dev = None
        self._streaming = False
        self._cb = None
        self._c_cb = None
        self.sample_rate = 8_000_000  # HackRFFrontend.cpp:76
        self.center_frequency = 106_300_000
        self.lna_gain = 0
        self.vga_gain = 0
        self.amp = False
        self._lut = hackrf_s8_lut()
        self._dc: DcBlocker | None = None

    def get_name(self) -> str:
        return "HackRF OSP Plugin"  # HackRFFrontend.cpp:15

    def get_center_frequency(self) -> int:
        return self.center_frequency

    def set_center_frequency(self, freq: int) -> int:
        if self._dev is not None:
            self._lib.hackrf_set_freq(self._dev, c_uint64(int(freq)))
        self.center_frequency = int(freq)
        return self.center_frequency

    def set_sample_rate(self, rate: int) -> int:
        if self._dev is not None:  # MHz double, HackRFFrontend.cpp:93-95
            self._lib.hackrf_set_sample_rate(self._dev, c_double(rate / 1e6))
        self.sample_rate = int(rate)
        self._dc = None
        return self.sample_rate

    def set_lna_gain(self, gain: int) -> None:
        self.lna_gain = int(gain)
        if self._dev is not None:
            self._lib.hackrf_set_lna_gain(self._dev, c_uint32(self.lna_gain))

    def set_vga_gain(self, gain: int) -> None:
        self.vga_gain = int(gain)
        if self._dev is not None:
            self._lib.hackrf_set_vga_gain(self._dev, c_uint32(self.vga_gain))

    def set_mixer_gain(self, gain: int) -> None:
        """HackRF has no mixer gain stage; RF amp on/off is the analog."""
        self.amp = bool(gain)
        if self._dev is not None:
            self._lib.hackrf_set_amp_enable(self._dev, 1 if self.amp else 0)

    def set_biast(self, enabled: bool) -> None:
        if self._dev is not None:
            self._lib.hackrf_set_antenna_enable(self._dev, 1 if enabled else 0)

    def _open(self) -> None:
        lib = self._lib if self._lib is not None else load_libhackrf()
        if lib is None:
            raise NotImplementedError(
                "HackRF capture requires libhackrf, not found on this host; "
                "use 'cfile' playback or 'spyserver' network IQ instead"
            )
        self._lib = lib
        lib.hackrf_init()
        dev = c_void_p()
        if lib.hackrf_open(byref(dev)):
            raise RuntimeError("hackrf_open failed — no device?")
        self._dev = dev
        self.set_sample_rate(self.sample_rate)
        self.set_center_frequency(self.center_frequency)
        self.set_lna_gain(self.lna_gain)
        self.set_vga_gain(self.vga_gain)

    def _on_transfer(self, tptr) -> int:
        t = tptr.contents
        n = int(t.valid_length)
        if self._cb is not None and n > 0:
            raw = np.ctypeslib.as_array(t.buffer, shape=(n,))
            iq = self._dc.process(self._lut[raw])
            self._cb(iq, SampleType.FLOAT_IQ)
        return 0

    def start(self) -> None:
        if self._dev is None:
            self._open()
        self._dc = DcBlocker(self.sample_rate)
        self._c_cb = HACKRF_RX_CALLBACK(lambda tptr: self._on_transfer(tptr))
        if self._lib.hackrf_start_rx(self._dev, self._c_cb, None):
            raise RuntimeError("hackrf_start_rx failed")
        self._streaming = True

    def stop(self) -> None:
        if self._dev is not None:
            if self._streaming:
                self._lib.hackrf_stop_rx(self._dev)
                self._streaming = False
            self._lib.hackrf_close(self._dev)
            self._dev = None

    @property
    def running(self) -> bool:
        return self._streaming


# ---------------------------------------------------------------------------
# SDRPlay
# ---------------------------------------------------------------------------

MIR_SDR_BW_5_000 = 5000   # mir_sdr_Bw_MHzT (SDRPlayFrontend.cpp:117)
MIR_SDR_IF_ZERO = 0       # mir_sdr_If_kHzT
MIR_SDR_USE_RSP_SET_GR = 1  # mir_sdr_SetGrModeT
MIR_SDR_AGC_DISABLE = 0
MIR_SDR_AGC_100HZ = 1     # mir_sdr_AgcControlT (SDRPlayFrontend.cpp:153)

MIR_STREAM_CALLBACK = CFUNCTYPE(
    None, POINTER(c_short), POINTER(c_short), c_uint,
    c_int, c_int, c_int, c_uint, c_uint, c_void_p,
)
MIR_GC_CALLBACK = CFUNCTYPE(None, c_uint, c_uint, c_void_p)

SDRPLAY_SAMPLE_RATES = tuple(
    r * 1_000_000 for r in (2, 2.5, 3, 4, 5, 6, 7, 8, 9, 10)
)  # SDRPlayFrontend.cpp:14-16


class SDRPlayFrontend(FrontendDevice):
    """SDRPlay RSP via ctypes mirsdrapi-rsp (SDRPlayFrontend.cpp, the
    reference's NON_FREE-gated frontend).

    StreamInit with BW 5 MHz / zero-IF / LNA state 4 (:117), split-rail
    s16 -> interleaved float /32768 FLOAT_IQ delivery (:29-36), 1st LO +
    decimation-off setup (:60-71), AgcControl 100 Hz @ -30 dBFS (:152-154).
    The gain-reduction knob rides set_lna_gain (gRdB, :156-158)."""

    def __init__(self, library=None):
        self._lib = library
        self._streaming = False
        self._cb = None
        self._c_stream = None
        self._c_gc = None
        self.sample_rate = 10_000_000   # SDRPlayFrontend.cpp:83
        self.center_frequency = 106_300_000
        self.gr_db = 40                 # gain reduction, :82
        self.gr_db_system = 83          # :82
        self.samples_per_packet = 0
        self.antenna = 0

    def get_name(self) -> str:
        return "SDRPlay OSP Plugin v0.1"  # SDRPlayFrontend.cpp:13

    def get_center_frequency(self) -> int:
        return self.center_frequency

    def set_center_frequency(self, freq: int) -> int:
        self.center_frequency = int(freq)
        return self.center_frequency

    def set_sample_rate(self, rate: int) -> int:
        self.sample_rate = int(rate)
        return self.sample_rate

    def set_lna_gain(self, gain: int) -> None:
        self.gr_db = int(gain)  # SDRPlayFrontend.cpp:156-158

    def set_agc(self, agc: bool) -> None:
        if self._lib is not None:
            self._lib.mir_sdr_AgcControl(
                MIR_SDR_AGC_100HZ if agc else MIR_SDR_AGC_DISABLE,
                -30, 0, 0, 0, 0, 1,
            )

    def set_antenna(self, antenna: int) -> None:
        self.antenna = int(antenna)
        if self._lib is not None:
            self._lib.mir_sdr_AmPortSelect(self.antenna)

    def set_biast(self, enabled: bool) -> None:
        pass  # "BiasT on SDRPlay is not supported" (SDRPlayFrontend.cpp:40)

    def _require_lib(self):
        lib = self._lib if self._lib is not None else load_libmirsdr()
        if lib is None:
            raise NotImplementedError(
                "SDRPlay capture requires the non-free mirsdrapi-rsp "
                "library, not found on this host; use 'cfile' playback or "
                "'spyserver' network IQ instead"
            )
        self._lib = lib
        return lib

    def initialize(self) -> None:
        """1st-LO + decimation setup (SDRPlayFrontend.cpp:49-71)."""
        lib = self._require_lib()
        lib.mir_sdr_SetParam(101, 24_576_000)   # 1st LO 120 MHz
        lib.mir_sdr_DecimateControl(0, 1, 0)    # decimation off

    def _on_stream(self, xi, xq, first, gr_ch, rf_ch, fs_ch, n, reset, _ctx):
        n = int(n)
        if self._cb is None or n <= 0:
            return
        i = np.ctypeslib.as_array(xi, shape=(n,)).astype(np.float32)
        q = np.ctypeslib.as_array(xq, shape=(n,)).astype(np.float32)
        iq = np.empty(2 * n, np.float32)
        iq[0::2] = i / 32768.0
        iq[1::2] = q / 32768.0
        self._cb(iq, SampleType.FLOAT_IQ)

    def start(self) -> None:
        lib = self._require_lib()
        self._c_stream = MIR_STREAM_CALLBACK(self._on_stream)
        self._c_gc = MIR_GC_CALLBACK(lambda gr, lna, ctx: None)
        gr = c_int(self.gr_db)
        gr_sys = c_int(self.gr_db_system)
        spp = c_int(0)
        err = lib.mir_sdr_StreamInit(
            byref(gr),
            c_double(self.sample_rate / 1e6),
            c_double(self.center_frequency / 1e6),
            MIR_SDR_BW_5_000,
            MIR_SDR_IF_ZERO,
            4,                       # LNA state, SDRPlayFrontend.cpp:117
            byref(gr_sys),
            MIR_SDR_USE_RSP_SET_GR,
            byref(spp),
            self._c_stream,
            self._c_gc,
            None,
        )
        if err:
            raise RuntimeError(f"mir_sdr_StreamInit failed: {err}")
        self.gr_db = int(gr.value)
        self.gr_db_system = int(gr_sys.value)
        self.samples_per_packet = int(spp.value)
        self._streaming = True

    def stop(self) -> None:
        if self._streaming and self._lib is not None:
            self._lib.mir_sdr_StreamUninit()
            self._streaming = False

    @property
    def running(self) -> bool:
        return self._streaming
