"""Demod half of the PyTorch port held against the JAX package on the CPU.

The port's plain versions (the arithmetic its CUDA kernels repeat) against:
the exact JAX recursions, the fused Pallas front end in interpret mode (K1)
and the batched JAX clock recovery with the mmse interpolator (K2).  Float
tolerances are stated per test: tap accumulation order and the libm behind
sin/cos differ by ulps between the frameworks; the loops are contracting, so
the differences stay bounded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jnp_tree, make_capture, tnp
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.demodulator import Demodulator as JDemodulator
from xritdemod_tpu.models.demodulator import quantize_symbols as jquantize_symbols
from xritdemod_tpu.ops import agc as jagc
from xritdemod_tpu.ops import clock_recovery as jcr
from xritdemod_tpu.ops import costas as jcostas
from xritdemod_tpu.ops import filters as jfilters
from xritdemod_tpu.ops import fir as jfir
from xritdemod_tpu.utils import cplx as jcplx
from xritdemod_tpu_torch import convert
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator, quantize_symbols
from xritdemod_tpu_torch.ops import agc as tagc
from xritdemod_tpu_torch.ops import clock_cuda, frontend_cuda
from xritdemod_tpu_torch.ops import clock_recovery as tcr
from xritdemod_tpu_torch.ops import costas as tcostas
from xritdemod_tpu_torch.ops import fir as tfir
from xritdemod_tpu_torch.utils import cplx as tcplx

JCF = jcplx.CF32
TCF = tcplx.CF32


def _pair(rng, shape, scale=0.3):
    re = rng.normal(0, scale, shape).astype(np.float32)
    im = rng.normal(0, scale, shape).astype(np.float32)
    return re, im


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestStages:
    def test_decimating_fir(self, rng):
        """Decimation 2 with carried history, two chained blocks
        (atol 1e-6: tap accumulation order differs)."""
        taps = jfilters.lowpass_taps(1.0, 2_500_000, 625_000, 100e3)
        re, im = _pair(rng, (3, 2048))
        jh = jfir.fir_init(len(taps), (3,))
        th = tfir.fir_init(len(taps), (3,))
        for lo in (0, 1024):
            jy, jh = jfir.fir_block(
                JCF(jnp.asarray(re[:, lo:lo + 1024]), jnp.asarray(im[:, lo:lo + 1024])),
                jnp.asarray(taps), jh, 2,
            )
            ty, th = tfir.fir_block(
                TCF(_t(re[:, lo:lo + 1024]), _t(im[:, lo:lo + 1024])), _t(taps), th, 2
            )
            assert ty.re.shape == (3, 512)
            np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=1e-6)
            np.testing.assert_allclose(ty.im.numpy(), np.asarray(jy.im), atol=1e-6)
            np.testing.assert_array_equal(th.re.numpy(), np.asarray(jh.re))

    def test_banded_matmul_fir(self, rng):
        """`fir_block(method="matmul")` and `fir_block_real_matmul` against the
        JAX package's, two chained blocks of the RRC at LRIT: reduction order
        only.  Each output y[n] = sum_k t_k x_{n+k} of each side lies within
        gamma_N = N * 2^-24 times sum_k |t_k x_{n+k}| of its float64 value
        (the float32 bound for N products summed in any order), so the two
        sides within twice that; the histories bit-equal."""
        cfg = JDemodConfig.lrit()
        taps = jfilters.rrc_taps(1.0, cfg.circuit_sample_rate, cfg.symbol_rate, cfg.rrc_alpha,
                                 63).astype(np.float32)
        N, T = len(taps), 1024
        re, im = _pair(rng, (3, 2 * T))
        jh, th = jfir.fir_init(N, (3,)), tfir.fir_init(N, (3,))
        gamma = N * 2.0 ** -24
        for lo in (0, T):
            xs = (re[:, lo:lo + T], im[:, lo:lo + T])
            ext = [np.concatenate([np.asarray(h), x], -1).astype(np.float64)
                   for h, x in zip((jh.re, jh.im), xs)]
            jy, jh = jfir.fir_block(JCF(*map(jnp.asarray, xs)), jnp.asarray(taps), jh,
                                    method="matmul")
            cy, _ = tfir.fir_block(TCF(*map(_t, xs)), _t(taps), th)
            ty, th = tfir.fir_block(TCF(*map(_t, xs)), _t(taps), th, method="matmul")
            for e, t_, j_, c_ in zip(ext, (ty.re, ty.im), (jy.re, jy.im), (cy.re, cy.im)):
                win = np.lib.stride_tricks.sliding_window_view(e, N, axis=-1)[:, :T]
                exact = win @ taps.astype(np.float64)
                scale = np.abs(win) @ np.abs(taps.astype(np.float64))
                assert (np.abs(t_.numpy() - exact) <= gamma * scale).all()
                assert (np.abs(np.asarray(j_) - exact) <= gamma * scale).all()
                assert (np.abs(t_.numpy() - np.asarray(j_)) <= 2 * gamma * scale).all()
                assert (np.abs(t_.numpy() - c_.numpy()) <= 2 * gamma * scale).all()
            np.testing.assert_array_equal(th.re.numpy(), np.asarray(jh.re))
            np.testing.assert_array_equal(th.im.numpy(), np.asarray(jh.im))
        yr, hr = tfir.fir_block_real_matmul(_t(re[:, :T]), _t(taps), th.re, block=128)
        jyr, jhr = jfir.fir_block_real_matmul(jnp.asarray(re[:, :T]), jnp.asarray(taps),
                                              jh.re, block=128)
        np.testing.assert_allclose(yr.numpy(), np.asarray(jyr), atol=1e-6)
        np.testing.assert_array_equal(hr.numpy(), np.asarray(jhr))
        x = TCF(_t(re[:, :T]), _t(im[:, :T]))
        with pytest.raises(ValueError):
            tfir.fir_block(x, _t(taps), th, 2, method="matmul")
        with pytest.raises(ValueError):
            tfir.fir_block(TCF(x.re[:, :1000], x.im[:, :1000]), _t(taps), th, method="matmul")
        with pytest.raises(ValueError):
            tfir.fir_block(x, _t(taps), th, method="banded")

    @pytest.mark.parametrize("scale", [0.3, 1e-5])
    def test_agc_is_the_exact_recursion(self, rng, scale):
        """Against `agc_block_exact`, also where the max-gain clamp binds
        (tiny input), in three parts that do not depend on the host:

        - each side's magnitudes `|x|` lie within 2 ulp of the float64
          magnitude (one rounding of `re*re + im*im`, fused or not, and one
          of a square root that need not be correctly rounded);
        - the port's recursion is bit-equal to the float32 recursion written
          out in numpy, one rounding per operation, on its own magnitudes;
        - the two packages' recursions on the same magnitudes agree at rtol
          1e-6.  The same magnitudes are inputs `(m, 0)` with `m` cut to 12
          significant bits: `m * m` is then exact and every square root
          gives `m` back, fused or not.  XLA's compiled recursion may fuse
          its two multiply-adds (it does on x86 hosts with FMA), which moves
          it by up to ~2e-7 from the unfused one over these 3000 steps.
        """
        re, im = _pair(rng, (4, 3000), scale)
        p = jagc.AgcParams()
        tp = tagc.AgcParams()
        g0 = np.full(4, 1.0 if scale > 1e-3 else 3990.0, np.float32)
        exact = np.sqrt(re.astype(np.float64) ** 2 + im.astype(np.float64) ** 2)
        ulp = np.spacing(exact.astype(np.float32)).astype(np.float64)
        tm = TCF(_t(re), _t(im)).abs().numpy()
        jm = np.asarray(jax.jit(lambda a, b: JCF(a, b).abs())(jnp.asarray(re), jnp.asarray(im)))
        assert (np.abs(tm - exact) <= 2 * ulp).all()
        assert (np.abs(jm - exact) <= 2 * ulp).all()

        ty, tg = tagc.agc_block(TCF(_t(re), _t(im)), _t(g0), tp)
        f32 = np.float32
        g, gains = g0.copy(), np.empty_like(tm)
        for n in range(tm.shape[1]):
            gains[:, n] = g
            g = np.minimum(g + f32(tp.rate) * (f32(tp.reference) - tm[:, n] * g), f32(tp.max_gain))
        np.testing.assert_array_equal(tg.numpy(), g)
        np.testing.assert_array_equal(ty.re.numpy(), re * gains)
        if scale < 1e-3:
            assert float(tg.max()) == 4000.0

        e = np.floor(np.log2(exact.astype(np.float32)))
        m = (np.round(exact / 2.0 ** (e - 11)) * 2.0 ** (e - 11)).astype(np.float32)
        zero = np.zeros_like(m)
        jy, jg = jagc.agc_block_exact(JCF(jnp.asarray(m), jnp.asarray(zero)), jnp.asarray(g0), p)
        ty, tg = tagc.agc_block(TCF(_t(m), _t(zero)), _t(g0), tp)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
        np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), rtol=1e-6, atol=1e-9)
        if scale < 1e-3:
            assert float(tg.max()) == 4000.0

    def test_costas(self, rng):
        """atol 2e-5 on y, 1e-4 on phase, 1e-5 on freq (sin/cos differ by
        ulps between the two libraries)."""
        n = np.arange(4000)
        re = (0.5 * np.cos(0.01 * n + 0.3))[None, :] + rng.normal(0, 0.05, (3, 4000))
        im = (0.5 * np.sin(0.01 * n + 0.3))[None, :] + rng.normal(0, 0.05, (3, 4000))
        re, im = re.astype(np.float32), im.astype(np.float32)
        jp = jcostas.costas_gains(0.0037)
        tp = tcostas.costas_gains(0.0037)
        assert tuple(jp) == tuple(tp)
        jy, js = jcostas.costas_block(
            JCF(jnp.asarray(re), jnp.asarray(im)), jcostas.costas_init((3,)), jp
        )
        ty, ts = tcostas.costas_block(TCF(_t(re), _t(im)), tcostas.costas_init((3,)), tp)
        np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=2e-5)
        np.testing.assert_allclose(ty.im.numpy(), np.asarray(jy.im), atol=2e-5)
        np.testing.assert_allclose(ts.phase.numpy(), np.asarray(js.phase), atol=1e-4)
        np.testing.assert_allclose(ts.freq.numpy(), np.asarray(js.freq), atol=1e-5)


class TestFrontEnd:
    """K1 against the fused Pallas front end in interpret mode, exact
    per-sample forms, at C=128, T=1024."""

    def _run(self, rng, T=1024, C=128):
        from xritdemod_tpu.ops.frontend_pallas import demod_frontend_pallas

        re, im = _pair(rng, (T, C))
        taps = jfilters.rrc_taps(1.0, 1_250_000, 293_883, 0.5, 63)
        hre, him = _pair(rng, (C, 62), 0.1)
        g0 = rng.uniform(0.5, 2.0, C).astype(np.float32)
        ph0 = rng.uniform(-1, 1, C).astype(np.float32)
        fr0 = rng.uniform(-0.01, 0.01, C).astype(np.float32)
        jout = demod_frontend_pallas(
            JCF(jnp.asarray(re), jnp.asarray(im)), jnp.asarray(g0),
            JCF(jnp.asarray(hre), jnp.asarray(him)),
            jcostas.CostasState(jnp.asarray(ph0), jnp.asarray(fr0)),
            jagc.AgcParams(), tuple(float(v) for v in taps), jcostas.costas_gains(0.0037),
            rows=256, interpret=True, block_k=0, precision="highest",
        )
        tout = frontend_cuda.demod_frontend(
            TCF(_t(re), _t(im)), _t(g0), TCF(_t(hre), _t(him)),
            tcostas.CostasState(_t(ph0), _t(fr0)),
            tagc.AgcParams(), _t(taps), tcostas.costas_gains(0.0037),
        )
        return jout, tout

    def test_matches_pallas_interpret(self, rng):
        (jy, jg, jh, jcs), (ty, tg, th, tcs) = self._run(rng)
        np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=5e-5)
        np.testing.assert_allclose(ty.im.numpy(), np.asarray(jy.im), atol=5e-5)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)
        np.testing.assert_allclose(th.re.numpy(), np.asarray(jh.re), atol=1e-5)
        np.testing.assert_allclose(th.im.numpy(), np.asarray(jh.im), atol=1e-5)
        np.testing.assert_allclose(tcs.phase.numpy(), np.asarray(jcs.phase), atol=1e-4)
        np.testing.assert_allclose(tcs.freq.numpy(), np.asarray(jcs.freq), atol=1e-5)
        assert ty.re.shape == (1024, 128) and th.re.shape == (128, 62)

    def test_state_chains(self, rng):
        """Two consecutive blocks equal one double-length block exactly."""
        T, C = 512, 8
        re, im = _pair(rng, (T, C))
        taps = _t(jfilters.rrc_taps(1.0, 1_250_000, 293_883, 0.5, 63))
        args = (tagc.AgcParams(), taps, tcostas.costas_gains(0.0037))
        st = (tagc.agc_init(tagc.AgcParams(), (C,)), tfir.fir_init(63, (C,)),
              tcostas.costas_init((C,)))
        full = frontend_cuda.demod_frontend(TCF(_t(re), _t(im)), *st, *args)
        a = frontend_cuda.demod_frontend(TCF(_t(re[:256]), _t(im[:256])), *st, *args)
        b = frontend_cuda.demod_frontend(TCF(_t(re[256:]), _t(im[256:])), *a[1:], *args)
        np.testing.assert_array_equal(full[0].re[256:].numpy(), b[0].re.numpy())
        for x, y in zip(tnp(full[1:]), tnp(b[1:])):
            np.testing.assert_array_equal(x, y)


def _shaped(cfg, C, n, seed):
    """`(C, n)` complex baseband: RRC-shaped BPSK already carrier-free (the
    clock's input), each channel with its own data and a slight rate skew."""
    from xritdemod_tpu_torch import tx

    out = []
    for c in range(C):
        rng = np.random.default_rng(seed + c)
        sym = 1.0 - 2.0 * rng.integers(0, 2, int(n / cfg.sps) + 64).astype(np.float32)
        iq = tx.modulate(sym, cfg, rng, freq_offset=0.0, phase=0.1 * c, amp=0.5,
                         noise=0.02, clock_ppm=300.0 * c)
        out.append(iq[:n])
    return np.stack(out)


class TestClock:
    """K2 against `clock_recovery_block_batch(interp="mmse")`: atol 1e-4 on
    symbols and state, identical symbol counts, two chained blocks."""

    def test_matches_batch_clock(self):
        cfg = DemodConfig.lrit()
        C, T = 4, 4096
        x = _shaped(cfg, C, 2 * T, seed=20)
        jd = JDemodulator(JDemodConfig.lrit(), T)
        td = Demodulator(cfg, T, device="cpu")
        assert jd.num_slots == td.num_slots
        jst = jd.init_state_batch(C).clock
        tst = td.init_state_batch(C).clock
        for blk in range(2):
            xb = x[:, blk * T:(blk + 1) * T]
            js, jv, jst = jcr.clock_recovery_block_batch(
                jcplx.from_complex(xb), jst, jd._clock, jd.num_slots, interp="mmse"
            )
            # channels-last entry, as the receiver calls it
            ts, tv, tst = clock_cuda.clock_recovery_block_kernel_batch_cl(
                tcplx.from_complex(xb.T), tst, td._clock, td.num_slots
            )
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            assert tv.numpy().sum() > C * (T / cfg.sps - 4)
            np.testing.assert_allclose(ts.re.numpy(), np.asarray(js.re), atol=1e-4)
            np.testing.assert_allclose(ts.im.numpy(), np.asarray(js.im), atol=1e-4)
            jn = jnp_tree(jst)
            np.testing.assert_array_equal(tst.ii.numpy(), jn.ii)
            np.testing.assert_allclose(tst.mu.numpy(), jn.mu, atol=1e-4)
            np.testing.assert_allclose(tst.omega.numpy(), jn.omega, atol=1e-5)
            np.testing.assert_allclose(tst.p.re.numpy(), jn.p.re, atol=1e-4)
            np.testing.assert_array_equal(tst.c.re.numpy(), jn.c.re)
            np.testing.assert_array_equal(tst.tail.re.numpy(), jn.tail.re)
            # valid is a prefix, invalid slots are zero
            v = tv.numpy()
            assert (np.diff(v.astype(np.int8), axis=1) <= 0).all()
            assert (ts.re.numpy()[~v] == 0).all()

    def test_both_entries_agree(self):
        cfg = DemodConfig.lrit()
        td = Demodulator(cfg, 1024, device="cpu")
        x = _shaped(cfg, 2, 1024, seed=30)
        st = td.init_state_batch(2).clock
        a = clock_cuda.clock_recovery_block_kernel_batch(
            tcplx.from_complex(x), st, td._clock, td.num_slots)
        b = clock_cuda.clock_recovery_block_kernel_batch_cl(
            tcplx.from_complex(x.T), st, td._clock, td.num_slots)
        np.testing.assert_array_equal(a[0].re.numpy(), b[0].re.numpy())
        np.testing.assert_array_equal(a[2].mu.numpy(), b[2].mu.numpy())

    def test_mmse_row_is_floor_of_x_plus_half(self):
        mu = torch.tensor([0.0, 0.5 / 128, 1.5 / 128, 2.5 / 128, 0.999, 1.0])
        rows = tcr._mmse_rows(mu)
        jrows = np.asarray(jcr._mmse_rows(jnp.asarray(mu.numpy())))
        np.testing.assert_array_equal(rows.numpy(), jrows)
        from xritdemod_tpu_torch.ops.interp_taps import mmse_taps_table

        tab = mmse_taps_table()
        np.testing.assert_array_equal(rows.numpy()[[1, 2, 3]], tab[[1, 2, 3]])


class TestDemodulator:
    def _capture(self):
        cfg = DemodConfig.lrit()
        sig, _ = make_capture(cfg, 2, 1)
        return cfg, sig

    def test_init_state_agrees(self):
        cfg, _ = self._capture()
        jst = jnp_tree(JDemodulator(JDemodConfig.lrit(), 4096).init_state_batch(3))
        tst = Demodulator(cfg, 4096, device="cpu").init_state_batch(3)
        conv = convert.demod_state_from_numpy(jst, "cpu")
        ja, ta, ca = jax.tree.leaves(jst), jax.tree.leaves(tnp(tst)), jax.tree.leaves(tnp(conv))
        assert len(ja) == len(ta) == len(ca) == 16
        for a, b, c in zip(ja, ta, ca):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)

    def test_block_batch_and_mid_stream_start(self):
        """Soft symbols within atol 2e-4 at |soft|~0.5 with equal counts,
        over two chained blocks; then the port started from the JAX state
        after block 0 gives the same block 1.  (The JAX CPU path runs its
        scan AGC, which differs from the exact recursion by rounding.)"""
        cfg, sig = self._capture()
        T = 8192
        jd = JDemodulator(JDemodConfig.lrit(), T)
        td = Demodulator(cfg, T, device="cpu")
        jst, tst = jd.init_state_batch(2), td.init_state_batch(2)
        x0, x1 = sig[:, :T], sig[:, T:2 * T]
        jsoft0, jv0, jst1 = jd.block_batch(jcplx.from_complex(x0), jst)
        tsoft0, tv0, tst1 = td.block_batch(x0, tst)
        jsoft1, jv1, _ = jd.block_batch(jcplx.from_complex(x1), jst1)
        tsoft1, tv1, _ = td.block_batch(x1, tst1)
        for ts, tv, js, jv in ((tsoft0, tv0, jsoft0, jv0), (tsoft1, tv1, jsoft1, jv1)):
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-4)
        assert 0.3 < float(tsoft1[tv1].abs().mean()) < 0.7
        mid = convert.demod_state_from_numpy(jnp_tree(jst1), "cpu")
        msoft1, mv1, _ = td.block_batch(x1, mid)
        np.testing.assert_array_equal(mv1.numpy(), np.asarray(jv1))
        np.testing.assert_allclose(msoft1.numpy(), np.asarray(jsoft1), atol=2e-4)

    def test_rejects_wrong_block_and_interp(self):
        cfg, sig = self._capture()
        td = Demodulator(cfg, 4096, device="cpu")
        with pytest.raises(ValueError):
            td.block_batch(sig[:, :1000], td.init_state_batch(2))
        with pytest.raises(ValueError):
            Demodulator(DemodConfig.lrit(clock_interp="linear"), 4096, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                Demodulator(cfg, 4096)


class TestWires:
    def test_symbol_quantizer(self, rng):
        """clip(soft*127, -128, 127), then a truncating cast."""
        soft = np.concatenate([
            rng.normal(0, 0.6, 500), [1.5, -1.5, 1.0, -1.0, 0.999, -1.004, 0.0039, -0.0039]
        ]).astype(np.float32)
        np.testing.assert_array_equal(
            quantize_symbols(_t(soft)).numpy(), np.asarray(jquantize_symbols(jnp.asarray(soft)))
        )

    def test_iq_s8(self, rng):
        """IQ wire: +-127 with rint on the way out, 1/127 on the way in."""
        x = (rng.normal(0, 0.5, (2, 300)) + 1j * rng.normal(0, 0.5, (2, 300))).astype(np.complex64)
        q = tcplx.quantize_iq_s8(x)
        np.testing.assert_array_equal(q, jcplx.quantize_iq_s8(x))
        d, jd = tcplx.dequantize_iq_s8(_t(q)), jcplx.dequantize_iq_s8(jnp.asarray(q))
        np.testing.assert_array_equal(d.re.numpy(), np.asarray(jd.re))
        np.testing.assert_array_equal(d.im.numpy(), np.asarray(jd.im))

    def test_complex_round_trip(self, rng):
        x = (rng.normal(size=(2, 9)) + 1j * rng.normal(size=(2, 9))).astype(np.complex64)
        np.testing.assert_array_equal(tcplx.to_complex(tcplx.from_complex(x)), x)
