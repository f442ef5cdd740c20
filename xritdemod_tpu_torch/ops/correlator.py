"""Frame-sync correlation against 64-bit coded-domain unique words.

Counterpart of `xritdemod_tpu/ops/correlator.py`: hard signs (+1 for bit 0 /
non-negative symbol, -1 for bit 1 / negative symbol) correlated against +-1
word templates at every lag in one batched pass; the decoder flywheel of the
reference (decoder/src/newdecoder.cpp:218-247) collapses into an argmax.
The products are +-1 and the sums at most 64, so the result is exact in any
float format the convolution backend picks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from xritdemod_tpu_torch.utils.bits import bits_of_u64

__all__ = ["make_templates", "correlate", "best_correlation", "correlate_at", "phase_fix",
           "acquire_positions_plain", "UW_BITS"]

UW_BITS = 64


def make_templates(words: list[int], device="cpu") -> torch.Tensor:
    """64-bit unique words -> `(W, 64)` float32 +-1 templates.

    Bit 1 expects a negative soft symbol (template -1); bit 0 positive.
    """
    t = np.stack([1.0 - 2.0 * bits_of_u64(w).astype(np.float32) for w in words])
    return torch.from_numpy(t).to(device)


def _hard_signs(soft: torch.Tensor) -> torch.Tensor:
    """Soft symbols -> +-1 hard-decision signs (0 decides as bit 0 / +1)."""
    one = torch.ones((), dtype=torch.float32, device=soft.device)
    return torch.where(soft < 0, -one, one)


def correlate(soft: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """Count matching bits for every word at every lag.

    Args:
      soft: `(..., L)` soft symbols (only signs are used).
      templates: `(W, 64)` +-1 word templates from `make_templates`.

    Returns:
      `(..., W, L-63)` float32 match counts in [0, 64].
    """
    lead = soft.shape[:-1]
    L = soft.shape[-1]
    s = _hard_signs(soft).reshape(-1, 1, L)
    dot = F.conv1d(s, templates[:, None, :])              # (B, W, P)
    counts = (UW_BITS + dot) * 0.5
    return counts.reshape(lead + counts.shape[1:])


def best_correlation(counts: torch.Tensor):
    """`(..., W, P)` counts -> (corr, word, pos), each `(...)`.

    The highest match count wins; ties resolve to the lowest word then the
    lowest position (newdecoder.cpp:239-241).  `torch.argmax` does not
    promise the first index among ties, so the first maximum is found by
    comparing against the maximum.
    """
    W, P = counts.shape[-2], counts.shape[-1]
    flat = counts.reshape(counts.shape[:-2] + (W * P,))
    idx = first_argmax(flat)
    corr = torch.gather(flat, -1, idx[..., None])[..., 0]
    return corr, (idx // P).to(torch.int32), (idx % P).to(torch.int32)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the FIRST maximum along the last axis (int64)."""
    n = x.shape[-1]
    mx = x.max(dim=-1, keepdim=True).values
    iota = torch.arange(n, device=x.device)
    return torch.where(x == mx, iota, n).min(dim=-1).values


@torch.no_grad()
def acquire_positions_plain(ring: torch.Tensor, locked: torch.Tensor, templates: torch.Tensor,
                            window: int, threshold: int) -> torch.Tensor:
    """Plain PyTorch version of `acquire_cuda.acquire_positions` (the
    kernel's golden model): each channel's extraction position.

    A locked channel takes 0.  An unlocked one correlates the hard signs of
    its ring's first `window` symbols with every word at every lag and keeps
    the first maximum (`best_correlation`); below `threshold` matching bits
    it takes 0 too (the reference flywheel's blind drop of one frame).

    Args:
      ring: `(C, L)` float32 or bfloat16 soft symbols, `L >= window`.
      locked: `(C,)` bool frame lock.
      templates: `(W, 64)` +-1 word templates.
      window: symbols searched, `lags + 63`.
      threshold: least matching bits of a sync.

    Returns `(C,)` int32 positions.
    """
    counts = correlate(ring[:, :window].float(), templates)
    corr, _, p = best_correlation(counts)
    zero = torch.zeros_like(p)
    return torch.where(locked | (corr < threshold), zero, p)


def correlate_at(soft: torch.Tensor, templates: torch.Tensor, positions: torch.Tensor):
    """Match counts at given start positions only (per-frame sync re-check).

    Args:
      soft: `(L,)` soft symbols.
      templates: `(W, 64)`.
      positions: `(B,)` int starts, each at most `L - 64`.

    Returns:
      `(corr, word)` each `(B,)`: the best count over words at each position
      and the first word that reaches it.
    """
    idx = positions.to(torch.int64)[:, None] + torch.arange(UW_BITS, device=soft.device)
    counts = (UW_BITS + _hard_signs(soft[idx]) @ templates.t()) * 0.5      # (B, W)
    return counts.max(dim=-1).values, first_argmax(counts).to(torch.int32)


def phase_fix(soft: torch.Tensor, word) -> torch.Tensor:
    """Resolve the BPSK 180-degree ambiguity: negate when `word` is odd
    (word 0 is the 0-degree pattern, word 1 the 180-degree one, in the
    reference's registration order).  `word` broadcasts against `soft`'s
    leading dimensions."""
    word = torch.as_tensor(word, device=soft.device)
    one = torch.ones((), dtype=soft.dtype, device=soft.device)
    return soft * torch.where(word % 2 == 1, -one, one)
