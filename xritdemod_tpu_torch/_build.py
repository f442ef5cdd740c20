"""Build and load the CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for sm_90a into its own shared library, loaded with `ctypes`.  Nothing here
runs at import time: `load(name)` builds at first use (and again when the
source, or any shared header `csrc/*.cuh`, is newer than the library),
`build_all()` starts one `nvcc` per source together.  Libraries go to
`XRITDEMOD_TORCH_BUILD` or, by default, `build/` inside the package
(git-ignored).

`-fmad=false` keeps the float recursions rounding as the plain PyTorch
versions do (no contraction of `a*b + c` into one fused operation); no
fast-math, so `sinf`/`cosf`/`sqrtf` are the accurate forms.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNELS", "build_all", "load", "build_dir", "build_variant", "using",
           "stage_clocks", "check", "launch_on"]

KERNELS = ("frontend", "clock", "viterbi", "ring", "stream", "roll", "rs", "acquire")

_CSRC = Path(__file__).resolve().parent / "csrc"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    d = os.environ.get("XRITDEMOD_TORCH_BUILD")
    return Path(d) if d else Path(__file__).resolve().parent / "build"


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and Path("/usr/local/cuda/bin/nvcc").exists():
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _paths(name: str) -> tuple[Path, Path]:
    return _CSRC / f"{name}.cu", build_dir() / f"libxrit_{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (src, *_CSRC.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def _start(name: str, verbose: bool) -> subprocess.Popen:
    src, lib = _paths(name)
    cmd = [_nvcc(), *_NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    # Build to a private name and rename, so a concurrent loader never maps
    # a half-written library.
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd += ["-o", str(tmp), str(src)]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish(name: str, proc: subprocess.Popen) -> tuple[bool, str]:
    out, _ = proc.communicate()
    _, lib = _paths(name)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False, f"nvcc failed for csrc/{name}.cu:\n{out}"
    os.replace(tmp, lib)
    return True, out


def build_all(names=KERNELS, verbose: bool = False, force: bool = False) -> dict:
    """Build every stale kernel library, all `nvcc` processes in parallel.

    Returns `{"seconds": wall time, "built": [names], "log": compiler text}`.
    """
    t0 = time.perf_counter()
    build_dir().mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if force or _stale(n)]
    procs = [(n, _start(n, verbose)) for n in todo]
    done = [_finish(n, p) for n, p in procs]     # waits for every compiler
    failed = [text for ok, text in done if not ok]
    if failed:
        raise RuntimeError("\n".join(failed))
    log = "".join(text for _, text in done)
    return {"seconds": time.perf_counter() - t0, "built": todo, "log": log}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build_all((name,))
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _libs[name] = lib
    return lib


def build_variant(name: str, tag: str, defines=(), edits=()) -> ctypes.CDLL:
    """A build of `csrc/<name>.cu` that differs from the shipped one: compiled
    with `-D<define>` for each of `defines`, from a copy of `csrc/` in which
    each `(old, new)` of `edits` has replaced text in whatever file holds
    `old`.  For measurements and debug builds; the library goes to
    `build_dir()/variants/<tag>/` and is loaded, not cached."""
    work = build_dir() / "variants" / tag
    work.mkdir(parents=True, exist_ok=True)
    missing = [old for old, _ in edits]
    for src in [*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")]:
        text = src.read_text()
        for old, new in edits:
            if old in text:
                text = text.replace(old, new)
                missing = [m for m in missing if m != old]
        (work / src.name).write_text(text)
    if missing:
        raise ValueError(f"variant {tag}: no source holds {missing[0]!r}")
    lib = work / f"libxrit_{name}.so"
    done = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, *[f"-D{d}" for d in defines], "-o", str(lib),
         str(work / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {tag} of csrc/{name}.cu:\n{done.stdout}")
    return ctypes.CDLL(str(lib))


@contextlib.contextmanager
def using(name: str, lib: ctypes.CDLL):
    """Inside the block, `load(name)` gives `lib` (a `build_variant`)."""
    shipped = load(name)
    _libs[name] = lib
    try:
        yield lib
    finally:
        _libs[name] = shipped


@contextlib.contextmanager
def stage_clocks(name: str):
    """Inside the block, `load(name)` gives a debug build of `csrc/<name>.cu`
    with `-DXRIT_STAGE_CLOCKS` (see `csrc/sync.cuh`).  Yields `read()`, which
    returns, for the launches since the last read, two lists indexed by warp
    of block 0: cycles spent waiting on barriers (summed over the launches)
    and cycles of the whole role (of the last launch)."""
    debug = build_variant(name, "stage_clocks", defines=("XRIT_STAGE_CLOCKS",))
    debug.xrit_stage_clocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    debug.xrit_stage_clocks.restype = ctypes.c_int

    def read() -> tuple[list[int], list[int]]:
        wait, role = (ctypes.c_ulonglong * 32)(), (ctypes.c_ulonglong * 32)()
        check(debug.xrit_stage_clocks(wait, role), "xrit_stage_clocks")
        return list(wait), list(role)

    with using(name, debug):
        yield read


@contextlib.contextmanager
def launch_on(t):
    """The launch rule of every kernel wrapper: inside the block the device
    of `t` (the launch's input) is current, and the block gets the handle of
    that device's current stream.  So a launch on the data of `cuda:1` runs
    on `cuda:1`'s stream whichever device the caller made current."""
    import torch

    with torch.cuda.device(t.device):
        yield torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
