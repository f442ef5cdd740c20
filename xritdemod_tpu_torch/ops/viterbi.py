"""Soft-decision Viterbi decoder for the CCSDS rate-1/2 K=7 code (plain form).

Counterpart of `xritdemod_tpu/ops/viterbi.py`: path metrics live as a
`(B, 64)` float32 tensor, the two predecessors of next state n are n>>1 and
(n>>1)+32, time is a Python loop over the T trellis steps vectorised over
B x 64, and traceback is a second loop over the stored decisions.  This is
the CPU path and the golden model of the CUDA kernel
(`ops/viterbi_cuda.py`), which must equal it bit for bit: same branch-metric
expression `a*g1 + b*g2`, strict `cand1 > cand0` (ties take pred n>>1),
first-index argmax for the end state.

Soft symbols: float32, negative = coded bit 1.  The corrected-bit count is
the Hamming distance between the hard-decided input and the re-encoded
decoded bits.
"""

from __future__ import annotations

import numpy as np
import torch

from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch.ops import conv_code
from xritdemod_tpu_torch.ops.correlator import first_argmax

__all__ = ["viterbi_decode", "viterbi_bits", "reencode_bits", "corrected_bits"]

_NS = conv_code.NUM_STATES  # 64


def viterbi_bits(soft: torch.Tensor) -> torch.Tensor:
    """`(B, 2T)` float32 soft symbols -> `(B, T)` uint8 survivor bits."""
    soft = soft.to(torch.float32)
    B, T2 = soft.shape
    T = T2 // 2
    dev = soft.device
    g1_0, g2_0, g1_1, g2_1 = (
        torch.from_numpy(g).to(dev) for g in conv_code.branch_signs()
    )
    s0 = soft[:, 0::2].t().contiguous()   # (T, B) first coded bit of each pair
    s1 = soft[:, 1::2].t().contiguous()

    pm = torch.zeros((B, _NS), dtype=torch.float32, device=dev)
    decisions = torch.empty((T, B, _NS), dtype=torch.bool, device=dev)
    for t in range(T):
        a = s0[t][:, None]
        b = s1[t][:, None]
        bm0 = a * g1_0 + b * g2_0                       # (B, 64)
        bm1 = a * g1_1 + b * g2_1
        cand0 = pm[:, : _NS // 2].repeat_interleave(2, dim=-1) + bm0
        cand1 = pm[:, _NS // 2 :].repeat_interleave(2, dim=-1) + bm1
        dec = cand1 > cand0
        decisions[t] = dec
        pm = torch.where(dec, cand1, cand0)

    state = first_argmax(pm)                            # (B,) int64
    bits = torch.empty((T, B), dtype=torch.uint8, device=dev)
    for t in range(T - 1, -1, -1):
        bits[t] = (state & 1).to(torch.uint8)
        took_high = torch.gather(decisions[t], 1, state[:, None])[:, 0]
        state = (state >> 1) + took_high.to(torch.int64) * (_NS // 2)
    return bits.t().contiguous()


def viterbi_decode(soft: torch.Tensor):
    """Decode `(B, 2T)` soft symbols -> (`(B, T)` uint8 bits, `(B,)` errors).

    `errors` is the corrected-bit count: Hamming distance between the
    received hard decisions and the re-encoded survivor path.
    """
    soft = soft.to(torch.float32)
    bits = viterbi_bits(soft)
    hard = (soft < 0).to(torch.uint8)
    return bits, corrected_bits(bits, hard)


def reencode_bits(bits: torch.Tensor) -> torch.Tensor:
    """Re-encode `(B, T)` decoded bits -> `(B, 2T)` coded bits (sr0 = 0)."""
    B, T = bits.shape
    K = C.CONV_K
    b = bits.to(torch.uint8)
    ext = torch.cat([b.new_zeros((B, K - 1)), b], dim=-1)
    c1 = b.new_zeros((B, T))
    c2 = b.new_zeros((B, T))
    # Window tap k is input bit t-6+k, which sits at register bit (6-k).
    for k in range(K):
        w = ext[:, k : k + T]
        if (C.CONV_POLY_A >> (K - 1 - k)) & 1:
            c1 = c1 ^ w
        if (C.CONV_POLY_B >> (K - 1 - k)) & 1:
            c2 = c2 ^ w
    return torch.stack([c1 ^ 1, c2 ^ 1], dim=-1).reshape(B, 2 * T)


def corrected_bits(bits: torch.Tensor, hard_received: torch.Tensor) -> torch.Tensor:
    """Hamming distance between re-encoded `bits` and received hard bits."""
    re = reencode_bits(bits)
    return (re != hard_received).sum(-1).to(torch.int32)
