"""K2's mmse block update (`csrc/clock.cu`, `clock_bu_kernel`) on the CPU:
what of its contract a CPU can hold.

  - The kernel's shared ring (its rows read from the source) against the
    rows the plain version's chunks really span (each chunk's carry
    recorded as the plain `clock_recovery_block_update_batch` steps): C = 3
    with omega at both ends of its limit, K in {1, 4, 16, 64}, at the LRIT
    and HRIT rates.
  - The plain block update at K = 64 against the JAX package's XLA form,
    as `test_clock_block_update_matches_xla_k16` does at K = 16, with
    limits set just above the gaps read at K = 64 (`_assert_close_at_k64`).
  - The `(C, T)` entry, whose mmse block update the kernel reads as it is,
    and the `(T, C)` entry equal, across a segment boundary.

The kernel itself runs only on the card: `chip_smoke.py` holds it bit for
bit against the plain version through both entries.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_block_update import (
    CLOCK_RATES,
    _clock_input,
    _clock_params,
    _jcf,
    _leaves,
    _row_step,
    _tcf,
)
from xritdemod_tpu.ops import clock_recovery as jcr
from xritdemod_tpu_torch.ops import clock_cuda
from xritdemod_tpu_torch.ops import clock_recovery as tcr
from xritdemod_tpu_torch.utils.cplx import CF32 as TCF


def _chunk_spans(monkeypatch, x, st, params, S, K):
    """Each chunk of the plain block update: the rows from its first row
    (the channel's ii, at least 0) to the end of its last valid window, per
    channel; from the carry at every step of the plain version's loop."""
    seen = []
    scan = tcr.scan

    def spy(step, carry, xs, ys):
        def recorded(c, x_):
            seen.append(tuple(t.clone() for t in c[:4]))
            return step(c, x_)
        return scan(recorded, carry, xs, ys)

    monkeypatch.setattr(tcr, "scan", spy)
    tcr.clock_recovery_block_update_batch(x, st, params, S, K, "mmse")
    monkeypatch.undo()
    jf = torch.arange(K, dtype=torch.float32)[:, None]
    spans = []
    for mu, omega, ii, lim in seen:
        pj = mu[None] + jf * omega[None]
        base = ii[None] + torch.floor(pj).to(torch.int64)
        valid = base < lim[None]
        last = torch.where(valid, base.clamp(min=0) + tcr.INTERP_TAPS, 0).amax(0)
        spans.append(torch.where(valid.any(0), last - ii.clamp(min=0), 0))
    return torch.stack(spans)


def _ring_rows() -> tuple[int, int]:
    """The mmse block update's ring rows and chunk rows, from csrc/clock.cu."""
    src = (Path(clock_cuda.__file__).parents[1] / "csrc" / "clock.cu").read_text()
    shift = int(re.search(r"constexpr int BU_SHIFT = (\d+);", src).group(1))
    chunk = int(re.search(r"#define CHUNK (\d+)", src).group(1))
    assert "constexpr int BU_ROWS = BU_NCHUNK * CHUNK;" in src
    return (1 << shift) * chunk, chunk


@pytest.mark.parametrize("rate", sorted(CLOCK_RATES))
@pytest.mark.parametrize("K", [1, 4, 16, 64])
def test_ring_holds_the_plain_chunks(monkeypatch, rate, K):
    """The ring holds twice every chunk's windows, from the chunk of rows
    the chunk's first row falls in, so the chain's windows stay in shared
    memory while the loader fills the next chunk's rows; with omega pinned
    at either end of its limit."""
    cfg = CLOCK_RATES[rate]
    C, T = 3, 1600
    re_, im = _clock_input(cfg, T, C, 5)
    params = tcr.ClockRecoveryParams(**_clock_params(cfg))
    st = tcr.clock_recovery_init(params, cfg.clock_mu, C)
    lim = params.omega * params.omega_relative_limit
    st = st._replace(omega=torch.tensor([params.omega - lim, params.omega + lim, params.omega],
                                        dtype=torch.float32))
    S = tcr.max_symbols(T, params)
    spans = _chunk_spans(monkeypatch, _tcf(re_, im), st, params, S, K)
    rows, chunk = _ring_rows()
    assert rows == 1024
    assert int(spans.max()) >= K * 3      # the chunks did run: ~K x sps rows
    assert 2 * (int(spans.max()) + chunk) <= rows


@pytest.fixture(scope="module")
def k64_refs():
    """The JAX XLA block update at K = 64 over two chained blocks, each
    interpolator and rate (C = 32, T = 1024)."""
    out = {}
    C, T = 32, 1024
    for rate, cfg in CLOCK_RATES.items():
        re, im = _clock_input(cfg, 2 * T, C, 13)
        jp = jcr.ClockRecoveryParams(**_clock_params(cfg))
        ns = jcr.max_symbols(T, jp)
        init = jax.tree.map(lambda a: jnp.broadcast_to(a, (C,) + a.shape),
                            jcr.clock_recovery_init(jp, cfg.clock_mu))
        for interp in ("mmse", "sinc"):
            st, blocks = init, []
            for b in range(2):
                x = _jcf(re[:, b * T:(b + 1) * T], im[:, b * T:(b + 1) * T])
                s, v, st = jcr.clock_recovery_block_update_batch(x, st, jp, ns, chunk=64,
                                                                 interp=interp)
                blocks.append((np.asarray(s.re), np.asarray(v), _leaves(st)))
            out[rate, interp] = blocks
        out[rate] = re, im, ns
    return out


@pytest.mark.parametrize("rate", sorted(CLOCK_RATES))
@pytest.mark.parametrize("interp", ["mmse", "sinc"])
def test_clock_block_update_matches_xla_k64(k64_refs, rate, interp):
    cfg = CLOCK_RATES[rate]
    re, im, ns = k64_refs[rate]
    C, T = re.shape[0], re.shape[1] // 2
    params = tcr.ClockRecoveryParams(**_clock_params(cfg))
    st = tcr.clock_recovery_init(params, cfg.clock_mu, C)
    port = []
    for b in range(2):
        x = _tcf(re[:, b * T:(b + 1) * T], im[:, b * T:(b + 1) * T])
        s, v, st = tcr.clock_recovery_block_update_batch(x, st, params, ns, 64, interp)
        port.append((s.re.numpy(), v.numpy(), [np.asarray(a) for a in _state_leaves(st)]))
    _assert_close_at_k64(port, k64_refs[rate, interp], interp)


def _assert_close_at_k64(port, ref, interp):
    """`_assert_clock_close`'s checks, with limits set just above what these
    inputs show at K = 64 (over both blocks and rates): symbols 8.6e-4 apart
    at most (mmse; within a table row step) and 1.6e-4 (sinc), mu 2.1e-3,
    omega 7.2e-7.  A chunk's position sums run at 64 x sps samples (272 at
    LRIT), where a float32 ulp is 3.1e-5, four times K = 16's, and the loop
    carries the two orders' rounding from chunk to chunk.  Symbol counts and
    sample positions stay exact; at most 2 % of the symbols lie past the
    symbol limit (none do here)."""
    tol = 1e-3 if interp == "mmse" else 2e-4
    for (ts, tv, tst), (js, jv, jst) in zip(port, ref):
        np.testing.assert_array_equal(tv.sum(-1), jv.sum(-1))
        d = np.concatenate([np.abs(ts[c][tv[c]] - js[c][jv[c]]) for c in range(tv.shape[0])])
        assert d.max() <= max(tol, _row_step(interp)), d.max()
        assert (d > tol).mean() <= 0.02, (d > tol).mean()
        np.testing.assert_array_equal(tst[2], jst[2])
        np.testing.assert_allclose(tst[0], jst[0], atol=2.5e-3)
        np.testing.assert_allclose(tst[1], jst[1], atol=1e-6)


def _state_leaves(st):
    return [st.mu, st.omega, st.ii, st.p.re, st.p.im, st.c.re, st.c.im, st.tail.re, st.tail.im]


@pytest.mark.parametrize("interp", ["mmse", "sinc"])
@pytest.mark.parametrize("K", [1, 16])
def test_entries_agree_across_a_segment_boundary(interp, K):
    """`clock_recovery_block_kernel_batch` on `(C, T)` and
    `clock_recovery_block_kernel_batch_cl` on its transpose give the same
    symbols, mask and state (the new tail in the state's `(C, NTAIL)`
    layout) over two chained blocks of two segments each."""
    cfg = CLOCK_RATES["lrit"]
    C, T = 3, 512
    re, im = _clock_input(cfg, 2 * T, C, 9)
    params = tcr.ClockRecoveryParams(**_clock_params(cfg))
    S = 2 * tcr.max_symbols(T // 2, params)
    a = b = tcr.clock_recovery_init(params, cfg.clock_mu, C)
    for blk in range(2):
        x = _tcf(re[:, blk * T:(blk + 1) * T], im[:, blk * T:(blk + 1) * T])
        xt = TCF(x.re.t().contiguous(), x.im.t().contiguous())
        ka = clock_cuda.clock_recovery_block_kernel_batch(x, a, params, S, interp, K, 2)
        kb = clock_cuda.clock_recovery_block_kernel_batch_cl(xt, b, params, S, interp, K, 2)
        assert bool(ka[1].any())
        for u, v in zip([ka[0].re, ka[0].im, ka[1], *_state_leaves(ka[2])],
                        [kb[0].re, kb[0].im, kb[1], *_state_leaves(kb[2])]):
            assert u.shape == v.shape and torch.equal(u, v)
        a, b = ka[2], kb[2]
