"""ctypes bindings for the native host-runtime core (`native/xrit_io.cpp`).

The port's own loader of the host library that both packages share: SPSC
ring buffer, sample normalization, symbol quantization.  It reads the C++
source at the repo root and never writes beside it: the library is built
with `g++` into the port's git-ignored build directory (`build/` inside the
package, or `XRITDEMOD_TORCH_BUILD`, where the CUDA kernels go), again when
the source is newer than the library.

Processes that start together (test workers, the two apps of the
interop) may all want the library at once.  The build runs under an
exclusive file lock, to a private name that is renamed into place, so every
process loads a whole library and none gives up because another was halfway
through.  Everything has a pure-Python fallback (`available()` gates
callers): without `g++` the rings are Python's.  Why the library is not
there is kept: `last_error()` names the missing compiler, or gives the
compiler's exit code and the end of its messages, or the loader's error.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["load", "available", "last_error", "library_path", "NativeRing",
           "quantize_symbols_native"]

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "xrit_io.cpp"
# No -march=native: a library built on one host must load on another that
# shares the checkout's files.  The source calls std::min without including
# <algorithm>, which some libstdc++ versions bring in through the other
# headers it includes and others do not (the GCC of the GPU machines refuses
# it): the header is included by flag, the shared source left as it is.
_CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-include", "algorithm"]

_lib = None
_lock = threading.Lock()
_tried = False
_error: str | None = None


def library_path() -> Path:
    d = os.environ.get("XRITDEMOD_TORCH_BUILD")
    base = Path(d) if d else Path(__file__).resolve().parents[1] / "build"
    return base / "libxrit_io.so"


def _stale(lib: Path) -> bool:
    return not lib.exists() or lib.stat().st_mtime < _SOURCE.stat().st_mtime


@contextlib.contextmanager
def _file_lock(path: Path):
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build(lib: Path) -> None:
    """Compile the library to `lib` unless another process has already; the
    caller holds the build lock."""
    if not _stale(lib):
        return
    cxx = os.environ.get("CXX") or "g++"
    exe = shutil.which(cxx)
    if exe is None:
        raise RuntimeError(f"{cxx} not found: the native host library cannot be built")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        done = subprocess.run(
            [exe, *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE), "-lpthread"],
            capture_output=True, text=True, timeout=120,
        )
        if done.returncode != 0:
            tail = "\n".join((done.stderr or done.stdout).strip().splitlines()[-8:])
            raise RuntimeError(f"{cxx} exited with {done.returncode}: {tail}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    P = ctypes.POINTER
    lib.xrit_ring_create.restype = ctypes.c_void_p
    lib.xrit_ring_create.argtypes = [ctypes.c_size_t]
    lib.xrit_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.xrit_ring_size.restype = ctypes.c_size_t
    lib.xrit_ring_size.argtypes = [ctypes.c_void_p]
    lib.xrit_ring_capacity.restype = ctypes.c_size_t
    lib.xrit_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.xrit_ring_overflows.restype = ctypes.c_uint64
    lib.xrit_ring_overflows.argtypes = [ctypes.c_void_p]
    lib.xrit_ring_close.argtypes = [ctypes.c_void_p]
    lib.xrit_ring_push.restype = ctypes.c_size_t
    lib.xrit_ring_push.argtypes = [
        ctypes.c_void_p, P(ctypes.c_float), ctypes.c_size_t, ctypes.c_int,
    ]
    lib.xrit_ring_pop.restype = ctypes.c_size_t
    lib.xrit_ring_pop.argtypes = [
        ctypes.c_void_p, P(ctypes.c_float), ctypes.c_size_t, ctypes.c_long,
    ]
    lib.xrit_quantize_symbols.argtypes = [
        P(ctypes.c_float), P(ctypes.c_int8), ctypes.c_size_t,
    ]
    lib.xrit_u8_to_f32.argtypes = [
        P(ctypes.c_uint8), P(ctypes.c_float), ctypes.c_size_t,
    ]
    lib.xrit_s16_to_f32.argtypes = [
        P(ctypes.c_int16), P(ctypes.c_float), ctypes.c_size_t,
    ]
    lib.xrit_deinterleave.argtypes = [
        P(ctypes.c_float), P(ctypes.c_float), P(ctypes.c_float), ctypes.c_size_t,
    ]
    lib.xrit_io_abi_version.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable,
    and then `last_error()` says why."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib_path = library_path()
        try:
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            with _file_lock(lib_path.with_suffix(".lock")):
                _build(lib_path)
            lib = ctypes.CDLL(str(lib_path))
            version = lib.xrit_io_abi_version()
            if version != 1:
                _error = f"{lib_path} has ABI version {version}, not 1"
                return None
            _lib = _configure(lib)
            _error = None
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _lib = None
            _error = f"{type(exc).__name__}: {exc}"
        return _lib


def available() -> bool:
    return load() is not None


def last_error() -> str | None:
    """Why the last `load()` found no library (None after a success, or
    before any attempt)."""
    return _error


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeRing:
    """SPSC float ring backed by the C++ implementation."""

    def __init__(self, capacity: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native xrit_io unavailable")
        self._lib = lib
        self._h = lib.xrit_ring_create(capacity)
        self.capacity = lib.xrit_ring_capacity(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.xrit_ring_destroy(h)
            self._h = None

    def push(self, data: np.ndarray, blocking: bool = False) -> int:
        data = np.ascontiguousarray(data, np.float32)
        return self._lib.xrit_ring_push(
            self._h, _fptr(data), len(data), 1 if blocking else 0
        )

    def pop(self, n: int, timeout_ms: int = -1) -> np.ndarray | None:
        out = np.empty(n, np.float32)
        got = self._lib.xrit_ring_pop(self._h, _fptr(out), n, timeout_ms)
        return out if got == n else None

    def size(self) -> int:
        return self._lib.xrit_ring_size(self._h)

    @property
    def overflows(self) -> int:
        return self._lib.xrit_ring_overflows(self._h)

    def close(self) -> None:
        self._lib.xrit_ring_close(self._h)


def quantize_symbols_native(soft: np.ndarray) -> np.ndarray:
    """float soft symbols -> int8 wire bytes via the native kernel."""
    lib = load()
    soft = np.ascontiguousarray(soft, np.float32)
    out = np.empty(len(soft), np.int8)
    lib.xrit_quantize_symbols(
        _fptr(soft), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(soft)
    )
    return out
