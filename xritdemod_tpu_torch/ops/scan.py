"""The time loop of the plain recurrences: `carry = scan(step, carry, xs, ys)`.

The plain versions of the recurrent kernels (the AGC and Costas loops, the
clock) step one sample or one symbol at a time: a few dozen small ops a
step over the channels.  On the CPU, and on a CUDA device for a short loop,
`scan` runs them eagerly.  On a CUDA device a long loop runs in chunks of
`CHUNK` steps: one chunk's ops are recorded once as a CUDA graph, which is
replayed over the rest, each chunk's inputs and outputs copied through the
graph's buffers.  The same ops in the same order, so the same kernels and
the same bits, without the host's launch cost a kernel, which otherwise
sets the time (~0.3-0.5 ms a step).  On the CPU a long loop runs through
the same chunks eagerly.  `CHUNK` is read at each call; 0 makes every loop
one plain loop.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["scan", "CHUNK"]

CHUNK = 256   # steps a graph records


def scan(step: Callable, carry: tuple, xs: tuple, ys: tuple) -> tuple:
    """For t in range(len(ys[0])): `carry, y = step(carry, tuple(x[t] for x
    in xs))`, then `ys[k][t] = y[k]`.  `carry` is a tuple of tensors, `xs`
    and `ys` tuples of time-major tensors (`ys` preallocated).  Returns the
    last carry.  Chunks run once the loop is long enough to pay for
    recording one (as a graph where `carry` lies on a CUDA device)."""
    n, chunk = ys[0].shape[0], CHUNK
    t = 0
    if chunk and n >= 1 + 2 * chunk:
        # The first step eagerly: it builds whatever the step caches (tap
        # tables) outside any recording.
        carry = _steps(step, carry, xs, ys, 0, 1)
        carry, t = _chunks(step, carry, xs, ys, 1, chunk, carry[0].is_cuda)
    return _steps(step, carry, xs, ys, t, n)


def _steps(step, carry, xs, ys, t0: int, t1: int) -> tuple:
    for t in range(t0, t1):
        carry, y = step(carry, tuple(x[t] for x in xs))
        for o, v in zip(ys, y):
            o[t] = v
    return carry


def _chunks(step, carry, xs, ys, t0: int, chunk: int, graph: bool):
    """Whole chunks from step t0 -> (carry, the first step not run)."""
    reps = (ys[0].shape[0] - t0) // chunk
    sx = tuple(x.new_empty((chunk,) + x.shape[1:]) for x in xs)
    sy = tuple(y.new_empty((chunk,) + y.shape[1:]) for y in ys)
    sc = tuple(c.clone() for c in carry)

    def load(a: int) -> None:
        for s, x in zip(sx, xs):
            s.copy_(x[a : a + chunk])

    def run() -> None:
        for d, s in zip(sc, _steps(step, sc, sx, sy, 0, chunk)):
            d.copy_(s)

    if graph:
        dev = sc[0].device
        load(t0)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _steps(step, sc, sx, sy, 0, chunk)      # a warm-up, outside the recording
        torch.cuda.current_stream(dev).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
    for r in range(reps):
        a = t0 + r * chunk
        load(a)
        run()
        for y, s in zip(ys, sy):
            y[a : a + chunk].copy_(s)
    return tuple(c.clone() for c in sc), t0 + reps * chunk
