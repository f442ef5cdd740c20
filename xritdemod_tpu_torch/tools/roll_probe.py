"""Probe: per-row cyclic roll of a `(C, L)` array of 32-bit words, timed by
dtype (float32 / int32 / uint32).

    python -m xritdemod_tpu_torch.tools.roll_probe

Replaces `tools/roll_probe.py` of the JAX package (`barrel` / `_kernel`):
`out[c] = roll(x[c], amt[c])`, i.e. `out[c, j] = x[c, (j - amt[c]) mod L]`.
That kernel composes log2(L) stages of roll-by-2^b and select; on a GPU the
same function is a copy at a per-row offset (`csrc/roll.cu`), one kernel on
the words' bits for all three dtypes.  It is bound by bytes: the array once
in, once out.  The probe still times the three dtypes and prints what this
card gives, beside the one PyTorch call that computes the same function
(`torch.gather` with a per-row index).

The plain version rolls row by row with `torch.roll`; a CPU tensor takes it,
a CUDA tensor takes the kernel.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

from xritdemod_tpu_torch import _build

__all__ = ["barrel", "barrel_plain", "barrel_gather", "launches", "main"]

launches = 0

C, L = 1024, 36864
N = 8

_WORDS = (torch.float32, torch.int32, torch.uint32)


def _fn():
    fn = _build.load("roll").xrit_roll
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, amt: torch.Tensor) -> None:
    if x.ndim != 2 or 0 in x.shape or x.dtype not in _WORDS:
        raise ValueError(f"need a non-empty (C, L) array of 32-bit words, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if amt.shape != (x.shape[0],) or amt.dtype != torch.int32 or amt.device != x.device:
        raise ValueError(f"amt must be ({x.shape[0]},) int32 on {x.device}")


@torch.no_grad()
def barrel_plain(x: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `barrel`: `torch.roll` row by row."""
    _check(x, amt)
    bits = x.view(torch.int32)
    out = torch.stack([torch.roll(row, a) for row, a in zip(bits, amt.tolist())])
    return out.view(x.dtype)


@torch.no_grad()
def barrel_gather(x: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """The same function as one `torch.gather` with a per-row index: the
    library call the probe times beside the kernel (nothing else uses it)."""
    _check(x, amt)
    n = x.shape[1]
    idx = (torch.arange(n, device=x.device)[None, :] - amt[:, None].to(torch.int64)) % n
    return torch.gather(x.view(torch.int32), 1, idx).view(x.dtype)


@torch.no_grad()
def barrel(x: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """Roll row `c` of the `(C, L)` array `x` (float32, int32 or uint32) by
    `amt[c]` (int32, any sign), like `numpy.roll` per row."""
    global launches
    _check(x, amt)
    if not x.is_cuda:
        return barrel_plain(x, amt)
    x, amt = x.contiguous(), amt.contiguous()
    out = torch.empty_like(x)
    with _build.launch_on(x) as stream:
        err = _fn()(
            x.data_ptr(), amt.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            stream,
        )
    _build.check(err, "xrit_roll")
    launches += 1
    return out


def _time_ms(fn, x, reps: int) -> float:
    """Mean device time of `reps` chained calls `x = fn(x)`, after three:
    the chain alternates between output buffers, and the allocator has to
    have handed out all of them before the clock starts."""
    for _ in range(3):
        x = fn(x)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        x = fn(x)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(device="cuda") -> list[dict]:
    """Time the roll at `(C, L)` for the three dtypes; prints and returns one
    record per dtype (kernel ms, `torch.gather` ms, the byte bound)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("roll_probe times a CUDA device; none is available")
    rng = np.random.default_rng(0)
    amt = torch.from_numpy(rng.integers(0, L, C).astype(np.int32)).to(dev)
    arrays = (
        ("f32", rng.normal(size=(C, L)).astype(np.float32), torch.float32),
        ("i32", rng.integers(0, 1 << 30, (C, L)).astype(np.int32), torch.int32),
        ("u32", rng.integers(0, 1 << 30, (C, L)).astype(np.int32), torch.uint32),
    )
    rows = []
    for name, a, dtype in arrays:
        x = torch.from_numpy(a).to(dev).view(dtype)
        row = dict(
            dtype=name, shape=[C, L], card=torch.cuda.get_device_name(dev),
            kernel_ms=_time_ms(lambda v: barrel(v, amt), x, N),
            gather_ms=_time_ms(lambda v: barrel_gather(v, amt), x, N),
            bound_ms=2 * C * L * 4 / 3.35e12 * 1e3,
        )
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
