"""Per-channel symbol ring on the device: the demod -> decode coupling buffer.

Replaces `xritdemod_tpu/ops/ring_pallas.py` (`ring_append` / `_append_kernel`
and `ring_extract` / `_extract_kernel`).  Each channel keeps a
fixed-capacity symbol FIFO; new demod output is appended at the
per-channel fill offset, and frame-aligned chunks are popped at the
per-channel sync position, so soft symbols never visit the host.  The
kernels are in `csrc/ring.cu`; both are bound by bytes and move only the
slots their function must touch, with 16-byte accesses realigned by
funnel shifts (append: the new symbols once, in a grid sized by the
block's length; extract: `[pos, fill)` read, `[0, fill)` written).

  - `ring_append(ring, fill, new, n_new)`: place `new[c, :n_new[c]]` at
    `ring[c, fill[c]:]`.  A channel that would overflow drops the incoming
    block and reports it.  **The ring is updated in place** and returned.
  - `ring_extract(ring, fill, pos, extract=E)`: pop `ring[c, pos[c]:pos[c]+E]`
    (everything before `pos` is pre-sync junk and is dropped with it) and
    shift the rest of the channel to its front.  **The ring is updated in
    place** and returned (the JAX function returns a new ring; the port
    allocates no second one): only `[0, fill[c])` of each channel is
    touched, and slots at and past `fill` are left as they are, which the
    invariant below keeps at zero.  A channel with fewer than `pos+E`
    symbols is left untouched, reports not-ok and hands back `ring[c, :E]`.

Invariant maintained (and relied on by the extract): `ring[c, fill[c]:] ==
0`.  The ring is float32 or bfloat16 (the Pallas kernels' narrow ring: half
the bytes): the append rounds the float32 symbols to the ring's type, to
nearest even, and the extract hands out float32 (a bf16 value widens
exactly), as the Pallas kernels convert at the edge.  The plain versions
below serve CPU tensors; a CUDA tensor takes the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from xritdemod_tpu_torch import _build

__all__ = [
    "ring_append",
    "ring_extract",
    "ring_append_plain",
    "ring_extract_plain",
    "launches_append",
    "launches_extract",
    "launches_append_bf16",
    "launches_extract_bf16",
    "RING_DTYPES",
]

launches_append = 0
launches_extract = 0
launches_append_bf16 = 0      # on a bfloat16 ring
launches_extract_bf16 = 0

RING_DTYPES = (torch.float32, torch.bfloat16)


@torch.no_grad()
def ring_append_plain(ring, fill, new, n_new):
    """Plain PyTorch version of `ring_append` (in place, same contract)."""
    C, L = ring.shape
    S = new.shape[1]
    ok = (fill + n_new) <= L
    # Slot l of the ring takes lane l - fill of the new block, where that
    # lane is one of the channel's n_new valid symbols.
    src = torch.arange(L, device=ring.device)[None, :] - fill[:, None].to(torch.int64)
    take = (src >= 0) & (src < n_new[:, None]) & ok[:, None]
    vals = torch.gather(new.to(ring.dtype), 1, src.clamp(0, S - 1))
    ring.copy_(torch.where(take, vals, ring))
    return ring, torch.where(ok, fill + n_new, fill), ~ok


@torch.no_grad()
def ring_extract_plain(ring, fill, pos, extract: int):
    """Plain PyTorch version of `ring_extract` (in place, same contract):
    the JAX function's whole-row formula, written into `ring` after `out`
    is taken from it."""
    C, L = ring.shape
    E = extract
    ok = fill >= (pos + E)
    start = torch.where(ok, pos, 0).to(torch.int64)
    drop = torch.where(ok, pos + E, 0).to(torch.int64)
    new_fill = fill - drop.to(fill.dtype)
    out = torch.gather(ring, 1, start[:, None] + torch.arange(E, device=ring.device))
    lane = torch.arange(L, device=ring.device)[None, :]
    shifted = torch.gather(ring, 1, (drop[:, None] + lane).clamp(max=L - 1))
    ring.copy_(torch.where(lane < new_fill[:, None], shifted, 0.0))
    return ring, new_fill, out.to(torch.float32), ok


def _fn(name: str, nptr: int, ring: torch.Tensor):
    if ring.dtype == torch.bfloat16:
        name += "_bf16"
    fn = getattr(_build.load("ring"), name)
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(ring, fill, *others):
    if ring.dtype not in RING_DTYPES or ring.ndim != 2 or not ring.is_contiguous():
        raise ValueError("ring must be a contiguous (C, L) float32 or bfloat16 tensor")
    for t in (fill, *others):
        if t.dtype != torch.int32 or t.shape != (ring.shape[0],) or t.device != ring.device:
            raise ValueError("fill/pos/n_new must be (C,) int32 on the ring's device")


@torch.no_grad()
def ring_append(ring, fill, new, n_new):
    """Append `new[c, :n_new[c]]` at each channel's fill offset, in place.

    Args:
      ring: `(C, L)` float32 or bfloat16 symbol buffer (slots >= fill zero).
      fill: `(C,)` int32 symbol counts.
      new: `(C, S)` float32 dense new symbols (past `n_new` is ignored).
      n_new: `(C,)` int32 valid counts, `n_new <= S`.

    Returns `(ring, fill', overflowed (C,) bool)`; an overflowing channel
    drops the entire incoming block.
    """
    global launches_append, launches_append_bf16
    if not ring.is_cuda:
        return ring_append_plain(ring, fill, new, n_new)
    _check(ring, fill, n_new)
    C, L = ring.shape
    if new.dtype != torch.float32 or new.ndim != 2 or new.shape[0] != C:
        raise ValueError("new must be (C, S) float32")
    new, fill, n_new = new.contiguous(), fill.contiguous(), n_new.contiguous()
    fill_out = torch.empty_like(fill)
    ovf = torch.empty_like(fill)
    with _build.launch_on(ring) as stream:
        err = _fn("xrit_ring_append", 6, ring)(
            ring.data_ptr(), new.data_ptr(), fill.data_ptr(),
            n_new.data_ptr(), fill_out.data_ptr(), ovf.data_ptr(),
            C, L, new.shape[1], stream,
        )
    _build.check(err, "xrit_ring_append")
    if ring.dtype == torch.bfloat16:
        launches_append_bf16 += 1
    else:
        launches_append += 1
    return ring, fill_out, ovf.bool()


@torch.no_grad()
def ring_extract(ring, fill, pos, extract: int):
    """Pop `extract` symbols starting at each channel's `pos`, in place.

    Args:
      ring: `(C, L)` float32 or bfloat16 symbol buffer, `ring[c, fill[c]:]`
        zero (every `ring_append` keeps that; the kernel relies on it and
        does not touch those slots).
      fill: `(C,)` int32 symbol counts (read as at most L).
      pos: `(C,)` int32 frame starts, `>= 0`.
      extract: the number of symbols E to pop per channel, `<= L`.

    Returns `(ring, fill', out (C, E) float32, ok (C,) bool)`, where `ring`
    is the tensor given, updated: a popping channel's `[pos+E, fill)` moved
    to its front and the slots that vacates, up to the old fill, zeroed.
    A channel with fewer than `pos+E` symbols is untouched (`ok=False`,
    `out = ring[c, :E]`).
    """
    global launches_extract, launches_extract_bf16
    if not ring.is_cuda:
        return ring_extract_plain(ring, fill, pos, extract)
    _check(ring, fill, pos)
    C, L = ring.shape
    E = int(extract)
    if E > L:
        raise ValueError(f"extract {E} exceeds ring length {L}")
    fill, pos = fill.contiguous(), pos.contiguous()
    out = torch.empty((C, E), dtype=torch.float32, device=ring.device)
    fill_out = torch.empty_like(fill)
    ok = torch.empty_like(fill)
    with _build.launch_on(ring) as stream:
        err = _fn("xrit_ring_extract", 6, ring)(
            ring.data_ptr(), fill.data_ptr(), pos.data_ptr(),
            out.data_ptr(), fill_out.data_ptr(), ok.data_ptr(),
            C, L, E, stream,
        )
    _build.check(err, "xrit_ring_extract")
    if ring.dtype == torch.bfloat16:
        launches_extract_bf16 += 1
    else:
        launches_extract += 1
    return ring, fill_out, out, ok.bool()
