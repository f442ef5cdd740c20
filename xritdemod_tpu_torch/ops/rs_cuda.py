"""CUDA Reed-Solomon (255,223) decoder (K8): wrapper and tables.

Replaces no Pallas kernel: the JAX package decodes in one XLA program,
`rs_decode` with `_rs_correct` (`xritdemod_tpu/ops/reed_solomon.py:313-518`),
GF(2) bit-matrix products, a `lax.scan` of 32 Berlekamp-Massey steps and
`lax.cond`s on device counts that choose a branch.  Its port kept that
program as plain PyTorch, which issues the 32 steps from Python (a dozen ops
each) and reads a count to the host to choose its branch.  The kernel
(`csrc/rs.cu`) decodes every codeword of a batch in one launch, one warp a
codeword, and reads nothing back: a clean codeword comes out as it came,
every other one is corrected (every branch of the reference gives the same
rows, so none is chosen).  A clean batch is bound by its 32 x 255 table
multiplies a codeword, close to its bytes; an errored codeword by its chain
of 32 dependent Berlekamp-Massey steps.

The plain version is `ops/reed_solomon.py::rs_decode_plain`; the kernel equals
it bit for bit at every `sparse_max`.  `reed_solomon.rs_decode` routes: a CPU
tensor takes the plain version, a CUDA tensor this kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from xritdemod_tpu_torch import _build

__all__ = ["rs_decode_kernel", "launches", "TABLE_BYTES"]

launches = 0

TABLE_BYTES = 1280       # exp[512], log[256], tal[256], tal1[256], uint8


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    """The kernel's `(1280,)` uint8 tables on `device` (built once a device)."""
    from xritdemod_tpu_torch.ops.reed_solomon import _gf_tables

    bexp, blog, taltab, tal1tab, _ = _gf_tables()
    packed = np.concatenate([bexp, blog, taltab, tal1tab]).astype(np.uint8)
    assert packed.shape == (TABLE_BYTES,)
    return torch.from_numpy(packed).to(device)


def _fn():
    fn = _build.load("rs").xrit_rs_decode
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def rs_decode_kernel(received: torch.Tensor):
    """`(B, 255)` dual-basis codewords -> `(corrected (B, 255) uint8,
    nerrors (B,) int32)`, the contract of `reed_solomon.rs_decode`: every
    errored codeword corrected, -1 where that fails (the codeword returned as
    received), 0 for a clean one.  One launch; no host read."""
    global launches
    if received.ndim != 2 or received.shape[1] != 255 or not received.is_cuda:
        raise ValueError(f"need (B, 255) codewords on a CUDA device, got "
                         f"{tuple(received.shape)} on {received.device}")
    x = received.to(torch.uint8).contiguous()
    B = x.shape[0]
    out = torch.empty_like(x)
    nerr = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return out, nerr
    tables = _tables(x.device)
    with _build.launch_on(x) as stream:
        err = _fn()(x.data_ptr(), out.data_ptr(), nerr.data_ptr(), tables.data_ptr(), B,
                    stream)
    _build.check(err, "xrit_rs_decode")
    launches += 1
    return out, nerr
