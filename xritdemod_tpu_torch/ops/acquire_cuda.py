"""CUDA frame-sync acquisition of the fused receive (K9): wrapper.

Replaces no Pallas kernel: the JAX package decides each channel's
extraction position inside its jitted step
(`xritdemod_tpu/models/receiver.py:164-191`: `lax.cond(any(~locked))` over
the correlation and `best_correlation`, then the threshold and the lock
select), an XLA program around a convolution.  Its port ran that as plain
PyTorch and read the lock flags back to the host to skip it.  The kernel
(`csrc/acquire.cu`) gives every channel's position in one launch and reads
nothing back: a block (16 warps and 8 channels on a float32 ring, 8 and 2
on a bf16 one) writes 0 for its locked channels and ends when all are; each
unlocked channel is shared by the block's warps, which pack its window's
signs with 16-byte loads (the next channel's in flight while this one is
counted) and split its lags, counting the mismatches with every word as
popcounts and keeping the first best.  The words come as sign masks
(`pack_masks`), kernel arguments, packed once by the caller
(`FusedReceiver` at construction).  Bound by the unlocked channels' window
bytes, and at steady state (all locked) by the flags alone.

The plain version is `ops/correlator.py::acquire_positions_plain`; the
counts are integers, so the kernel equals it bit for bit.  A CPU tensor
takes the plain version (on the templates the masks stand for,
`unpack_masks`), a CUDA tensor the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from xritdemod_tpu_torch import _build
from xritdemod_tpu_torch.ops.correlator import UW_BITS, acquire_positions_plain

__all__ = ["acquire_positions", "launches", "MAX_WORDS", "bound_work", "pack_masks",
           "unpack_masks"]

launches = 0

MAX_WORDS = 4            # words a launch correlates (`ACQ_MAX_WORDS`)


def bound_work(C: int, unlocked: int, window: int, words: int,
               itemsize: int) -> tuple[float, float]:
    """`(bytes, operations)` the least work of one launch: the unlocked
    channels' windows read once and every channel's flag read and position
    written; four operations (xor, popcount, add, compare) a lag, word and
    unlocked channel."""
    lags = window - UW_BITS + 1
    return unlocked * window * itemsize + 5 * C, 4.0 * unlocked * lags * words


def pack_masks(templates: torch.Tensor) -> tuple[tuple[int, int], ...]:
    """`(W, 64)` +-1 templates (`correlator.make_templates`) -> each word's
    `(lo, hi)` sign masks: bit i of lo (of hi) set where the word expects a
    negative symbol at offset i (32 + i).  Reads the templates to the host:
    pack once, where the words are chosen."""
    neg = (templates.detach().to("cpu", torch.float32).numpy() < 0).astype(np.uint64)
    if neg.ndim != 2 or neg.shape[1] != UW_BITS:
        raise ValueError(f"need (W, {UW_BITS}) templates, got {tuple(neg.shape)}")
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return tuple((int((row[:32] * weights).sum()), int((row[32:] * weights).sum()))
                 for row in neg)


def unpack_masks(masks, device="cpu") -> torch.Tensor:
    """The `(W, 64)` float32 +-1 templates that `pack_masks` packed."""
    bits = np.array([[(lo >> i) & 1 for i in range(32)] + [(hi >> i) & 1 for i in range(32)]
                     for lo, hi in masks], np.float32)
    return torch.from_numpy(1.0 - 2.0 * bits).to(device)


@functools.lru_cache(maxsize=None)
def _mask_words(masks: tuple) -> ctypes.Array:
    return (ctypes.c_uint32 * (2 * len(masks)))(*[m for pair in masks for m in pair])


def _fn(ring: torch.Tensor):
    name = "xrit_acquire_bf16" if ring.dtype == torch.bfloat16 else "xrit_acquire"
    fn = getattr(_build.load("acquire"), name)
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def acquire_positions(ring: torch.Tensor, locked: torch.Tensor, words, window: int,
                      threshold: int) -> torch.Tensor:
    """Each channel's extraction position: 0 where `locked`, else the lag of
    the first best match of the ring's first `window` symbols with a word,
    or 0 where that match has fewer than `threshold` bits.

    Args:
      ring: `(C, L)` float32 or bfloat16 soft symbols, `L >= window`.
      locked: `(C,)` bool.
      words: the words' sign masks, `(lo, hi)` a word (`pack_masks`);
        W <= 4.
      window: symbols searched (lags + 63).
      threshold: least matching bits of a sync.

    Returns `(C,)` int32.
    """
    global launches
    masks = tuple(tuple(int(m) for m in pair) for pair in words)
    C, L = ring.shape
    P = int(window) - UW_BITS + 1
    W = len(masks)
    if ring.dtype not in (torch.float32, torch.bfloat16) or ring.ndim != 2:
        raise ValueError(f"ring must be (C, L) float32 or bfloat16, got {ring.dtype}")
    if locked.shape != (C,) or locked.dtype != torch.bool or locked.device != ring.device:
        raise ValueError(f"locked must be ({C},) bool on {ring.device}")
    if any(len(pair) != 2 or not all(0 <= m < 1 << 32 for m in pair) for pair in masks):
        raise ValueError("words must be (lo, hi) 32-bit sign masks (pack_masks)")
    if not 1 <= W <= MAX_WORDS or P < 1 or window > L:
        raise ValueError(f"need 1..{MAX_WORDS} words and 64 <= window <= {L}, got {W} "
                         f"words and {window}")
    if not ring.is_cuda:
        return acquire_positions_plain(ring, locked, unpack_masks(masks), window, threshold)
    ring, locked = ring.contiguous(), locked.contiguous()
    pos = torch.empty((C,), dtype=torch.int32, device=ring.device)
    if C == 0:
        return pos
    with _build.launch_on(ring) as stream:
        err = _fn(ring)(ring.data_ptr(), locked.data_ptr(), pos.data_ptr(), _mask_words(masks),
                        C, L, P, W, int(threshold), stream)
    _build.check(err, "xrit_acquire")
    launches += 1
    return pos
