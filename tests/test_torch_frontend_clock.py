"""What the Hopper front end (K1) and clock (K2) kernels lean on, pinned on
the CPU against the JAX package.

The CUDA kernels cannot run here.  Their arithmetic is the plain versions'
(`chip_smoke.py` holds the two equal on the card), so these tests hold the
plain versions to the JAX functions at the shapes and states the kernels'
tiling makes delicate: block lengths that are no multiple of any tile, the
AGC written as "gains from magnitudes, then products", clocks at both ends
of their range, the shortest block, a channel without a symbol.  Inputs come
from numpy seeds; tolerances are stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jnp_tree
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.demodulator import Demodulator as JDemodulator
from xritdemod_tpu.ops import agc as jagc
from xritdemod_tpu.ops import clock_recovery as jcr
from xritdemod_tpu.ops import costas as jcostas
from xritdemod_tpu.ops import filters as jfilters
from xritdemod_tpu.ops import fir as jfir
from xritdemod_tpu.utils import cplx as jcplx
from xritdemod_tpu_torch import convert, tx
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.ops import agc as tagc
from xritdemod_tpu_torch.ops import clock_cuda, frontend_cuda
from xritdemod_tpu_torch.ops import clock_recovery as tcr
from xritdemod_tpu_torch.ops import costas as tcostas
from xritdemod_tpu_torch.utils import cplx as tcplx

JCF = jcplx.CF32
TCF = tcplx.CF32
NTAIL = tcr.NTAIL


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestFrontEndChained:
    """(a) The plain front end over three chained blocks whose lengths are no
    multiple of 32 or 48, against the JAX package's exact stages composed
    (`agc_block_exact` -> `fir_block` -> `costas_block`; the Pallas kernel
    itself takes only T % 256 == 0).  atol 5e-5 on the output, 1e-5 on gain
    and history, 1e-4 / 1e-5 on phase / freq: tap accumulation order and the
    libm behind sin/cos differ by ulps."""

    LENGTHS = (1003, 64, 2050)

    @pytest.mark.parametrize("gain0, scale", [(1.0, 0.3), (3990.0, 1e-5)],
                             ids=["steady", "max_gain_clamp"])
    def test_three_blocks_against_jax(self, gain0, scale):
        rng = np.random.default_rng(311)
        C = 3
        taps = jfilters.rrc_taps(1.0, 1_250_000, 293_883, 0.5, 63)
        n = np.arange(sum(self.LENGTHS))
        sig = scale * np.exp(1j * (0.004 * n + 0.3))[:, None] * np.sign(
            np.sin(1.4771 * n[:, None] + np.arange(C)))
        sig = sig + scale * 0.1 * (rng.normal(size=sig.shape) + 1j * rng.normal(size=sig.shape))
        re = sig.real.astype(np.float32)            # (T, C), channels-last
        im = sig.imag.astype(np.float32)
        hre = (0.1 * scale * rng.normal(size=(C, 62))).astype(np.float32)
        him = (0.1 * scale * rng.normal(size=(C, 62))).astype(np.float32)
        g0 = np.full(C, gain0, np.float32)

        jgain, jhist = jnp.asarray(g0), JCF(jnp.asarray(hre), jnp.asarray(him))
        jcs = jcostas.costas_init((C,))
        tstate = (_t(g0), TCF(_t(hre), _t(him)), tcostas.costas_init((C,)))
        params = (tagc.AgcParams(), _t(taps), tcostas.costas_gains(0.0037))
        lo = 0
        for T in self.LENGTHS:
            xr, xi = re[lo:lo + T], im[lo:lo + T]
            lo += T
            jx = JCF(jnp.asarray(xr.T), jnp.asarray(xi.T))          # (C, T)
            ja, jgain = jagc.agc_block_exact(jx, jgain, jagc.AgcParams())
            jf, jhist = jfir.fir_block(ja, jnp.asarray(taps), jhist, 1)
            jy, jcs = jcostas.costas_block(jf, jcs, jcostas.costas_gains(0.0037))
            ty, *tstate = frontend_cuda.demod_frontend(TCF(_t(xr), _t(xi)), *tstate, *params)
            assert ty.re.shape == (T, C) and tstate[1].re.shape == (C, 62)
            tol = 5e-5 * max(1.0, gain0 * scale)
            np.testing.assert_allclose(ty.re.numpy().T, np.asarray(jy.re), atol=tol)
            np.testing.assert_allclose(ty.im.numpy().T, np.asarray(jy.im), atol=tol)
            np.testing.assert_allclose(tstate[0].numpy(), np.asarray(jgain), rtol=1e-6)
            np.testing.assert_allclose(tstate[1].re.numpy(), np.asarray(jhist.re), atol=1e-5)
            np.testing.assert_allclose(tstate[1].im.numpy(), np.asarray(jhist.im), atol=1e-5)
            np.testing.assert_allclose(tstate[2].phase.numpy(), np.asarray(jcs.phase), atol=1e-4)
            np.testing.assert_allclose(tstate[2].freq.numpy(), np.asarray(jcs.freq), atol=1e-5)
        if scale < 1e-3:
            assert float(tstate[0].max()) == 4000.0

    def test_short_blocks_equal_one_long_block(self):
        """Blocks of 47, 49 and 64 samples (around one 48-sample tile, barely
        above the 62-row history) chained give exactly the one 160-sample
        block: the history hand-over loses nothing."""
        rng = np.random.default_rng(312)
        C = 2
        re = rng.normal(0, 0.3, (160, C)).astype(np.float32)
        im = rng.normal(0, 0.3, (160, C)).astype(np.float32)
        taps = _t(jfilters.rrc_taps(1.0, 1_250_000, 293_883, 0.5, 63))
        params = (tagc.AgcParams(), taps, tcostas.costas_gains(0.0037))
        st0 = (tagc.agc_init(tagc.AgcParams(), (C,)),
               TCF(_t(rng.normal(0, 0.1, (C, 62)).astype(np.float32)),
                   _t(rng.normal(0, 0.1, (C, 62)).astype(np.float32))),
               tcostas.costas_init((C,)))
        full = frontend_cuda.demod_frontend(TCF(_t(re), _t(im)), *st0, *params)
        st, lo, parts = st0, 0, []
        for T in (47, 49, 64):
            y, *st = frontend_cuda.demod_frontend(
                TCF(_t(re[lo:lo + T]), _t(im[lo:lo + T])), *st, *params)
            parts.append(y.re.numpy())
            lo += T
        np.testing.assert_array_equal(np.concatenate(parts), full[0].re.numpy())
        np.testing.assert_array_equal(st[0].numpy(), full[1].numpy())
        np.testing.assert_array_equal(st[1].re.numpy(), full[2].re.numpy())
        np.testing.assert_array_equal(st[2].phase.numpy(), full[3].phase.numpy())


class TestAgcSplit:
    """(b) The kernels compute |x| for a whole tile in one warp, walk the
    gain recursion over the magnitudes in another and form x * gain in a
    third.  That is `agc_gains(x.abs())` then `x * gains`; it must equal the
    per-sample step (magnitude, products and gain update of one sample
    together, as `csrc/loops.cuh::agc_step` has it) bit for bit.  Layout
    "tc" is the fused front end's `(T, C)` block; "ct" is the standalone
    AGC's `(C, T)` block (`csrc/stream.cu`), whose split must also be
    `agc.agc_block` bit for bit, at ragged sizes."""

    @staticmethod
    def _per_sample(re, im, mag_of, g, p):
        """`mag_of(re, im)` is the magnitude function under test's own (torch's
        CPU sqrt is not numpy's in every last bit; the point here is the
        order of the work, not the square root)."""
        rate, ref, mx = (np.float32(v) for v in (p.rate, p.reference, p.max_gain))
        yr, yi = np.empty_like(re), np.empty_like(im)
        for n in range(re.shape[0]):
            mag = mag_of(re[n], im[n])
            yr[n] = re[n] * g
            yi[n] = im[n] * g
            g = g + rate * (ref - mag * g)
            if mx > 0:
                g = np.minimum(g, mx)
        return yr, yi, g

    @pytest.mark.parametrize("layout, T, C, scale, gain0", [
        pytest.param("tc", 1500, 4, 0.3, 1.0, id="random"),
        pytest.param("tc", 1500, 4, 1e-5, 3999.0, id="clamped_to_max_gain"),
        pytest.param("tc", 1500, 4, 30.0, 2.5, id="strong_input"),
        pytest.param("ct", 47, 5, 0.3, 1.0, id="ct_5x47"),
        pytest.param("ct", 1003, 33, 0.3, 1.0, id="ct_33x1003"),
        pytest.param("ct", 1003, 33, 1e-5, 3999.0, id="ct_33x1003_clamped_to_max_gain"),
    ])
    def test_split_form_is_the_per_sample_step(self, layout, T, C, scale, gain0):
        rng = np.random.default_rng(321)
        shape = (T, C) if layout == "tc" else (C, T)
        re = rng.normal(0, scale, shape).astype(np.float32)
        im = rng.normal(0, scale, shape).astype(np.float32)
        g0 = np.full(C, gain0, np.float32)
        p = tagc.AgcParams()
        x = TCF(_t(re), _t(im))
        mag = x.abs()
        if layout == "tc":
            mag_of = lambda r, i: TCF(_t(r), _t(i)).abs().numpy()
            gains, tg = tagc.agc_gains(mag, _t(g0), p)
            yr, yi, g = self._per_sample(re, im, mag_of, g0.copy(), p)
        else:
            # The kernel's order: magnitudes of the (C, T) tile, the gain
            # recursion along time, the products in (C, T).  Sample n's
            # magnitudes are the block's (see `_per_sample`).
            mag_of = lambda r, i, cols=iter(mag.t().numpy()): next(cols)
            gains_tc, tg = tagc.agc_gains(mag.t(), _t(g0), p)
            gains = gains_tc.t()
            yr, yi, g = (a.T if a.ndim == 2 else a for a in
                         self._per_sample(re.T, im.T, mag_of, g0.copy(), p))
            want, wg = tagc.agc_block(x, _t(g0), p)
            np.testing.assert_array_equal((x.re * gains).numpy(), want.re.numpy())
            np.testing.assert_array_equal((x.im * gains).numpy(), want.im.numpy())
            np.testing.assert_array_equal(tg.numpy(), wg.numpy())
        np.testing.assert_array_equal((x.re * gains).numpy(), yr)
        np.testing.assert_array_equal((x.im * gains).numpy(), yi)
        np.testing.assert_array_equal(tg.numpy(), g)
        if scale < 1e-3:
            assert float(tg.max()) == 4000.0


def _shaped(cfg, ppm, n, seed):
    """`(C, n)` complex baseband, RRC-shaped BPSK without carrier: channel c
    runs `ppm[c]` parts per million off the nominal symbol rate."""
    out = []
    for c, off in enumerate(ppm):
        rng = np.random.default_rng(seed + c)
        sym = 1.0 - 2.0 * rng.integers(0, 2, int(n / cfg.sps) + 64).astype(np.float32)
        iq = tx.modulate(sym, cfg, rng, freq_offset=0.0, phase=0.1 * c, amp=0.5,
                         noise=0.02, clock_ppm=off)
        out.append(iq[:n])
    return np.stack(out)


def _assert_clock_equal(tout, jout, atol=1e-4):
    (ts, tv, tst), (js, jv, jst) = tout, jout
    jn = jnp_tree(jst)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tst.ii.numpy(), jn.ii)
    np.testing.assert_allclose(ts.re.numpy(), np.asarray(js.re), atol=atol)
    np.testing.assert_allclose(ts.im.numpy(), np.asarray(js.im), atol=atol)
    np.testing.assert_allclose(tst.mu.numpy(), jn.mu, atol=atol)
    np.testing.assert_allclose(tst.omega.numpy(), jn.omega, atol=1e-5)
    np.testing.assert_allclose(tst.p.re.numpy(), jn.p.re, atol=atol)
    np.testing.assert_array_equal(tst.c.re.numpy(), jn.c.re)
    np.testing.assert_array_equal(tst.tail.re.numpy(), jn.tail.re)


class TestClockEnds:
    """(c) Channels of one group whose clocks run at opposite ends of the
    +-0.5 % limit drift apart inside a block: the kernel's ring follows the
    slowest and serves the fastest from device memory.  The plain clock on
    such channels against `clock_recovery_block_batch(interp="mmse")`: equal
    counts and sample positions, atol 1e-4, two chained blocks, the second
    started from the JAX state through `convert.py`."""

    @pytest.mark.parametrize("ppm", [(4500.0, -4500.0, 4500.0, -4500.0),
                                     (-4900.0, 0.0, 4900.0, 2000.0)],
                             ids=["alternating_ends", "spread"])
    def test_opposite_ends_two_blocks(self, ppm):
        cfg = DemodConfig.lrit()
        C, T = len(ppm), 4096
        x = _shaped(cfg, ppm, 2 * T, seed=40)
        jd = JDemodulator(JDemodConfig.lrit(), T)
        td = Demodulator(cfg, T, device="cpu")
        lim = td._clock.omega_relative_limit
        jst = jd.init_state_batch(C)
        # Each loop starts at the end of the range its channel will sit at.
        omega = np.asarray(jst.clock.omega) * (
            1.0 + lim * np.sign(np.asarray(ppm, np.float32))).astype(np.float32)
        jst = jst._replace(clock=jst.clock._replace(omega=jnp.asarray(omega.astype(np.float32))))
        jck = jst.clock
        tck = convert.demod_state_from_numpy(jnp_tree(jst), "cpu").clock
        counts = []
        for blk in range(2):
            xb = x[:, blk * T:(blk + 1) * T]
            jout = jcr.clock_recovery_block_batch(
                jcplx.from_complex(xb), jck, jd._clock, jd.num_slots, interp="mmse")
            tout = clock_cuda.clock_recovery_block_kernel_batch_cl(
                tcplx.from_complex(xb.T), tck, td._clock, td.num_slots)
            _assert_clock_equal(tout, jout)
            counts.append(tout[1].numpy().sum(-1))
            jck = jout[2]
            # The next block starts from the JAX package's state.
            tck = convert.demod_state_from_numpy(
                jnp_tree(jst._replace(clock=jck)), "cpu").clock
            np.testing.assert_array_equal(tck.ii.numpy(), np.asarray(jck.ii))
        total = np.sum(counts, axis=0)
        hi, lo = int(np.argmax(ppm)), int(np.argmin(ppm))
        # More samples per symbol at +ppm: fewer symbols in the same samples,
        # by about the relative rate difference of the two channels.
        assert total[lo] - total[hi] >= 2 * T / cfg.sps * (ppm[hi] - ppm[lo]) * 1e-6 - 3

    def test_positions_set_apart_by_hand(self):
        """`ii` states hundreds of samples apart, more than the kernel's
        256-row ring (the JAX clock does not take such states: its windows
        assume a position inside the tail).  A channel that starts k samples
        into the block must give exactly what a block cut k samples shorter
        at the front gives from the nominal position: symbols, count, state."""
        cfg = DemodConfig.lrit()
        T, S = 2048, 520
        offsets = (0, 700, 350, 1200)
        x = _shaped(cfg, (0.0, 0.0, 300.0, -300.0), T, seed=44)
        td = Demodulator(cfg, T, device="cpu")
        st = td.init_state_batch(len(offsets)).clock
        moved = st._replace(ii=st.ii + torch.tensor(offsets, dtype=torch.int32))
        sym, valid, new = clock_cuda.clock_recovery_block_kernel_batch_cl(
            tcplx.from_complex(x.T), moved, td._clock, S)
        n = valid.sum(-1).numpy()
        assert n[0] > n[2] > n[1] > n[3] > 100
        for c, k in enumerate(offsets):
            one = td.init_state_batch(1).clock
            s1, v1, n1 = clock_cuda.clock_recovery_block_kernel_batch_cl(
                tcplx.from_complex(x[c:c + 1, k:].T), one, td._clock, S)
            np.testing.assert_array_equal(valid[c].numpy(), v1[0].numpy())
            np.testing.assert_array_equal(sym.re[c].numpy(), s1.re[0].numpy())
            np.testing.assert_array_equal(sym.im[c].numpy(), s1.im[0].numpy())
            assert int(new.ii[c]) == int(n1.ii[0])
            assert float(new.mu[c]) == float(n1.mu[0])
            assert float(new.omega[c]) == float(n1.omega[0])
            np.testing.assert_array_equal(new.tail.re[c].numpy(), n1.tail.re[0].numpy())


class TestClockEdges:
    """(d) The shortest legal block and a channel without a symbol."""

    def test_shortest_block(self):
        """T = NTAIL + 9: the ring's first fill is the tail and one short
        chunk.  Two chained blocks against the JAX clock."""
        cfg = DemodConfig.lrit()
        C, T = 3, NTAIL + 9
        x = _shaped(cfg, (0.0, 2000.0, -2000.0), 2 * T, seed=50)
        jd = JDemodulator(JDemodConfig.lrit(), T)
        td = Demodulator(cfg, T, device="cpu")
        assert jd.num_slots == td.num_slots
        jck = jd.init_state_batch(C).clock
        tck = td.init_state_batch(C).clock
        for blk in range(2):
            xb = x[:, blk * T:(blk + 1) * T]
            jout = jcr.clock_recovery_block_batch(
                jcplx.from_complex(xb), jck, jd._clock, jd.num_slots, interp="mmse")
            tout = clock_cuda.clock_recovery_block_kernel_batch_cl(
                tcplx.from_complex(xb.T), tck, td._clock, td.num_slots)
            _assert_clock_equal(tout, jout)
            assert 0 < int(tout[1].sum()) <= C * td.num_slots
            jck, tck = jout[2], tout[2]

    def test_channel_without_a_symbol(self):
        """A channel whose position lies beyond this block emits nothing, keeps
        its loop state, and its position is re-based by the block length."""
        cfg = DemodConfig.lrit()
        C, T = 3, 512
        x = _shaped(cfg, (0.0, 0.0, 0.0), T, seed=60)
        jd = JDemodulator(JDemodConfig.lrit(), T)
        td = Demodulator(cfg, T, device="cpu")
        jst = jd.init_state_batch(C)
        ii = np.asarray(jst.clock.ii).copy()
        ii[1] = T + NTAIL + 40
        jst = jst._replace(clock=jst.clock._replace(ii=jnp.asarray(ii.astype(np.int32))))
        tck = convert.demod_state_from_numpy(jnp_tree(jst), "cpu").clock
        jout = jcr.clock_recovery_block_batch(
            jcplx.from_complex(x), jst.clock, jd._clock, jd.num_slots, interp="mmse")
        tout = clock_cuda.clock_recovery_block_kernel_batch_cl(
            tcplx.from_complex(x.T), tck, td._clock, td.num_slots)
        _assert_clock_equal(tout, jout)
        ts, tv, tst = tout
        assert int(tv[1].sum()) == 0 and int(tv[0].sum()) > 100
        assert float(ts.re[1].abs().max()) == 0.0
        assert int(tst.ii[1]) == NTAIL + 40
        assert float(tst.mu[1]) == float(tck.mu[1]) and float(tst.omega[1]) == float(tck.omega[1])


class TestWrappers:
    def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(self):
        """On the CPU the wrappers hand over to the plain versions: no launch
        is counted and no symbol is read outside a ring that does not exist."""
        cfg = DemodConfig.lrit()
        td = Demodulator(cfg, 256, device="cpu")
        st = td.init_state_batch(2)
        rng = np.random.default_rng(70)
        x = TCF(_t(rng.normal(0, 0.3, (256, 2)).astype(np.float32)),
                _t(rng.normal(0, 0.3, (256, 2)).astype(np.float32)))
        before = (frontend_cuda.launches, clock_cuda.launches)
        y, *_ = frontend_cuda.demod_frontend(
            x, st.agc_gain, st.rrc_hist, st.costas, td._agc, td._rrc_taps, td._costas)
        clock_cuda.clock_recovery_block_kernel_batch_cl(y, st.clock, td._clock, td.num_slots)
        assert (frontend_cuda.launches, clock_cuda.launches) == before
        assert clock_cuda.out_of_ring_symbols("cpu") == 0
        # One name per warp of each kernel, for the stage-clock read.
        assert len(frontend_cuda.ROLES) == 13 and frontend_cuda.ROLES[3] == "costas"
        assert clock_cuda.ROLES["clock"] == ("chain", "loader", "store")
