"""CUDA Viterbi decoder (K=7, r=1/2): wrapper, windowing and plain version.

Replaces `xritdemod_tpu/ops/viterbi_pallas.py` (`_decode_bits` with its
`_fwd_kernel`, `_fwd_kernel_reg` and `_back_kernel`).  The kernel is
`csrc/viterbi.cu`: the forward add-compare-select over all steps and then
the traceback, in one launch, with LPW lanes per window.  The windowing of
`viterbi_decode_segmented` and the corrected-bit count stay plain torch.

What bounds it on an H100: bytes are small (8 B of soft symbols in, 8 B of
decisions out and back, 1 B of bits per step per window), so the trellis
itself does: 64 add-compare-selects per step per window, and per window a
chain of T dependent steps.  Few lanes per window spend the fewest
instructions on a window-step; many lanes per window shorten a step's
latency, which is what counts when there are too few windows to fill the
card.  So the wrapper picks LPW from the window count (`lanes_per_window`).

The plain version is `ops/viterbi.viterbi_bits`; the kernel equals it bit
for bit.  A CPU tensor takes the plain version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from xritdemod_tpu_torch import _build
from xritdemod_tpu_torch.ops.viterbi import corrected_bits, viterbi_bits

__all__ = [
    "LANES",
    "lanes_per_window",
    "decode_bits",
    "decode_bits_plain",
    "viterbi_decode_kernel",
    "viterbi_decode_segmented",
    "launches",
]

launches = 0

decode_bits_plain = viterbi_bits

# Lanes per window that `csrc/viterbi.cu` instantiates (`viterbi_kernel<LPW>`).
LANES = (4, 32)
# (least window count, LPW): the first row whose count a launch reaches.  One
# threshold, set from `tools/kernel_probe.py viterbi` (its sweep over window
# counts): the decoder launches 16 or 128 windows (`StreamDecoder`) and 8192
# (2048 frames a fused step).
_LANES_RULE = ((4096, 4), (0, 32))


def lanes_per_window(nw: int) -> int:
    """Lanes of one warp that share a window, for a launch of `nw` windows:
    the fewest that still give the card's schedulers warps enough."""
    for least, lanes in _LANES_RULE:
        if nw >= least:
            return lanes
    raise ValueError(f"no lanes for {nw} windows")


def _lib():
    lib = _build.load("viterbi")
    fn = lib.xrit_viterbi
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def decode_bits(soft: torch.Tensor, lanes: int | None = None) -> torch.Tensor:
    """`(NW, 2T)` float32 soft windows -> `(NW, T)` uint8 survivor bits.

    `lanes` overrides `lanes_per_window(NW)` (for measurements)."""
    global launches
    if soft.dtype != torch.float32 or soft.ndim != 2 or soft.shape[1] % 2:
        raise ValueError(f"need (NW, 2T) float32, got {tuple(soft.shape)} {soft.dtype}")
    if lanes is not None and lanes not in LANES:
        raise ValueError(f"lanes {lanes} not one of {LANES}")
    if not soft.is_cuda:
        return decode_bits_plain(soft)
    soft = soft.contiguous()
    NW, T = soft.shape[0], soft.shape[1] // 2
    lanes = lanes_per_window(NW) if lanes is None else lanes
    bits = torch.empty((NW, T), dtype=torch.uint8, device=soft.device)
    if NW * T == 0:
        return bits
    dec = torch.empty((T, NW), dtype=torch.int64, device=soft.device)   # decision words
    with _build.launch_on(soft) as stream:
        err = _lib()(
            soft.data_ptr(), dec.data_ptr(), bits.data_ptr(), NW, T, lanes,
            stream,
        )
    _build.check(err, "xrit_viterbi")
    launches += 1
    return bits


def _errors(soft: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    return corrected_bits(bits, (soft < 0).to(torch.uint8))


@torch.no_grad()
def viterbi_decode_kernel(soft: torch.Tensor):
    """Drop-in for `viterbi.viterbi_decode`: `(B, 2T)` soft -> bits, errors,
    one window per frame."""
    soft = soft.to(torch.float32)
    bits = decode_bits(soft)
    return bits, _errors(soft, bits)


def segment_windows(soft: torch.Tensor, segments: int, overlap: int):
    """`(B, 2T)` -> `(B*S, 2*Lw)` overlapped windows and (Tseg, Lw)."""
    B, T2 = soft.shape
    T = T2 // 2
    S, W = segments, overlap
    Tseg = -(-T // S)
    pad_t = S * Tseg - T
    Lw = W + Tseg + W
    xp = torch.nn.functional.pad(soft.reshape(B, T, 2), (0, 0, W, W + pad_t))
    wins = torch.stack(
        [xp[:, s * Tseg : s * Tseg + Lw] for s in range(S)], dim=1
    )                                                  # (B, S, Lw, 2)
    return wins.reshape(B * S, 2 * Lw), Tseg, Lw


@torch.no_grad()
def viterbi_decode_segmented(soft: torch.Tensor, segments: int = 8, overlap: int = 128):
    """Segment-parallel Viterbi: same contract as `viterbi_decode_kernel`.

    Each frame's T steps split into `segments` windows decoded concurrently;
    every window is extended by `overlap` warm-up steps before its kept
    region and `overlap` tail steps after it (so traceback enters the kept
    region converged).  With overlap=128 (~21 constraint lengths) the
    output equals the exact decoder's at any usable SNR.
    """
    soft = soft.to(torch.float32)
    B, T = soft.shape[0], soft.shape[1] // 2
    flat, Tseg, _ = segment_windows(soft, segments, overlap)
    bits_all = decode_bits(flat)                       # (B*S, Lw)
    bits = bits_all[:, overlap : overlap + Tseg].reshape(B, segments * Tseg)[:, :T]
    return bits, _errors(soft, bits)
