"""`xritdemod_tpu_torch/ops/scan.py`: the time loop of the plain recurrences.

On a CUDA device `scan` records one chunk of steps as a CUDA graph and
replays it; on the CPU the same chunked bookkeeping runs eagerly, which is
what these tests hold bit for bit against one plain loop.
The graph itself is held against the eager loop on the card by
`chip_smoke.py` (`check_scan`), and, through the plain versions, against
every recurrent kernel.
"""

import numpy as np
import pytest
import torch

from xritdemod_tpu_torch.ops import agc, costas
from xritdemod_tpu_torch.ops import scan as scan_mod


def _step(carry, x):
    """A step with every kind of state the plain loops carry: float, int64,
    and a bool output."""
    (a, i), (u, w) = carry, x
    a2 = a * 0.75 + u * w
    i2 = i + (a2 > 0).to(torch.int64)
    return (a2, i2), (a2 - a, a2 > 0.1)


def _reference(carry, xs, n):
    ys = (torch.empty((n, 5)), torch.empty((n, 5), dtype=torch.bool))
    for t in range(n):
        carry, y = _step(carry, tuple(x[t] for x in xs))
        for o, v in zip(ys, y):
            o[t] = v
    return carry, ys


@pytest.mark.parametrize("n", [0, 1, 8, 9, 10, 23, 43])
def test_chunks_are_one_loop(n, monkeypatch):
    """Chunks of 4 steps (the first step alone, then whole chunks, then the
    rest) against one loop: every carry and output bit-equal."""
    g = torch.Generator().manual_seed(n)
    xs = (torch.randn((n, 5), generator=g), torch.randn((n, 5), generator=g))
    carry = (torch.randn(5, generator=g), torch.zeros(5, dtype=torch.int64))
    want_c, want_y = _reference(carry, xs, n)
    for chunk in (0, 4):
        monkeypatch.setattr(scan_mod, "CHUNK", chunk)
        ys = (torch.empty((n, 5)), torch.empty((n, 5), dtype=torch.bool))
        got = scan_mod.scan(_step, carry, xs, ys)
        for a, b in zip(got + ys, want_c + want_y):
            assert torch.equal(a, b), chunk


def _costas_before(xr_t, xi_t, state, params):
    """`costas_steps`'s recursion as one Python loop: the reference for its
    chunked form."""
    alpha, beta = float(np.float32(params.alpha)), float(np.float32(params.beta))
    two_pi = costas._TWO_PI
    phase, freq = state.phase, state.freq
    yr_t, yi_t = torch.empty_like(xr_t), torch.empty_like(xi_t)
    zero = torch.zeros(())
    for n in range(xr_t.shape[0]):
        xr, xi = xr_t[n], xi_t[n]
        c, s = torch.cos(phase), torch.sin(phase)
        yr = xr * c + xi * s
        yi = xi * c - xr * s
        err = torch.clamp(yr * yi, -1.0, 1.0)
        freq = torch.clamp(freq + beta * err, params.freq_min, params.freq_max)
        phase = phase + freq + alpha * err
        phase = phase - torch.where(phase > two_pi, two_pi, zero)
        phase = phase + torch.where(phase < -two_pi, two_pi, zero)
        yr_t[n], yi_t[n] = yr, yi
    return yr_t, yi_t, phase, freq


def test_costas_and_agc_are_the_loops_they_were():
    """The two plain recurrences on `scan` (chunked past 2 * CHUNK steps)
    against their former loops, bit for bit, over 1200 steps of 3 channels."""
    rng = np.random.default_rng(7)
    xr, xi = (torch.from_numpy(rng.standard_normal((1200, 3)).astype(np.float32))
              for _ in range(2))
    params = costas.costas_gains(0.02)
    st = costas.CostasState(torch.tensor([0.1, -3.0, 6.2]), torch.tensor([0.0, 0.01, -0.02]))
    got = costas.costas_steps(xr, xi, st, params)
    want = _costas_before(xr, xi, st, params)
    for a, b in zip((*got[:2], *got[2]), want):
        assert torch.equal(a, b)

    p = agc.AgcParams(max_gain=3.0)
    mag = xr.abs() * 2.0
    gains, g = agc.agc_gains(mag, torch.tensor([1.0, 0.5, 2.9]), p)
    wg = torch.tensor([1.0, 0.5, 2.9])
    for n in range(mag.shape[0]):
        assert torch.equal(gains[n], wg)
        wg = torch.clamp(wg + p.rate * (p.reference - mag[n] * wg), max=p.max_gain)
    assert torch.equal(g, wg)
