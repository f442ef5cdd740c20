"""CUDA frame-sync acquisition of the fused receive (K9): wrapper.

Replaces no Pallas kernel: the JAX package decides each channel's
extraction position inside its jitted step
(`xritdemod_tpu/models/receiver.py:164-191`: `lax.cond(any(~locked))` over
the correlation and `best_correlation`, then the threshold and the lock
select), an XLA program around a convolution.  Its port ran that as plain
PyTorch and read the lock flags back to the host to skip it.  The kernel
(`csrc/acquire.cu`) gives every channel's position in one launch and reads
nothing back: a locked channel reads its flag and writes 0; an unlocked one
counts the matches of its ring's first `window` hard signs with every word
at every lag as popcounts and keeps the first maximum.  Bound by the
unlocked channels' window bytes, and at steady state (all locked) by the
flags alone.

The plain version is `ops/correlator.py::acquire_positions_plain`; the
counts are integers, so the kernel equals it bit for bit.  A CPU tensor
takes the plain version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from xritdemod_tpu_torch import _build
from xritdemod_tpu_torch.ops.correlator import UW_BITS, acquire_positions_plain

__all__ = ["acquire_positions", "launches", "MAX_WORDS"]

launches = 0

MAX_WORDS = 4            # words a launch correlates (`ACQ_MAX_WORDS`)


def _fn(ring: torch.Tensor):
    name = "xrit_acquire_bf16" if ring.dtype == torch.bfloat16 else "xrit_acquire"
    fn = getattr(_build.load("acquire"), name)
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def acquire_positions(ring: torch.Tensor, locked: torch.Tensor, templates: torch.Tensor,
                      window: int, threshold: int) -> torch.Tensor:
    """Each channel's extraction position: 0 where `locked`, else the lag of
    the first best match of the ring's first `window` symbols with a word,
    or 0 where that match has fewer than `threshold` bits.

    Args:
      ring: `(C, L)` float32 or bfloat16 soft symbols, `L >= window`.
      locked: `(C,)` bool.
      templates: `(W, 64)` float32 +-1 templates (`make_templates`), W <= 4.
      window: symbols searched (lags + 63).
      threshold: least matching bits of a sync.

    Returns `(C,)` int32.
    """
    global launches
    C, L = ring.shape
    P = int(window) - UW_BITS + 1
    W = templates.shape[0]
    if ring.dtype not in (torch.float32, torch.bfloat16) or ring.ndim != 2:
        raise ValueError(f"ring must be (C, L) float32 or bfloat16, got {ring.dtype}")
    if locked.shape != (C,) or locked.dtype != torch.bool or locked.device != ring.device:
        raise ValueError(f"locked must be ({C},) bool on {ring.device}")
    if templates.shape != (W, UW_BITS) or not 1 <= W <= MAX_WORDS or P < 1 or window > L:
        raise ValueError(f"need 1..{MAX_WORDS} words of {UW_BITS} bits and 64 <= window "
                         f"<= {L}, got {tuple(templates.shape)} and {window}")
    if not ring.is_cuda:
        return acquire_positions_plain(ring, locked, templates, window, threshold)
    ring, locked = ring.contiguous(), locked.contiguous()
    tpl = templates.to(device=ring.device, dtype=torch.float32).contiguous()
    pos = torch.empty((C,), dtype=torch.int32, device=ring.device)
    if C == 0:
        return pos
    with _build.launch_on(ring) as stream:
        err = _fn(ring)(ring.data_ptr(), locked.data_ptr(), tpl.data_ptr(), pos.data_ptr(),
                        C, L, P, W, int(threshold), stream)
    _build.check(err, "xrit_acquire")
    launches += 1
    return pos
