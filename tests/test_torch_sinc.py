"""The sinc form of the clock recovery (K2's second instance), pinned on the
CPU against the JAX package.

The port's plain sinc clock (`ops/clock_recovery.py`, interp="sinc": the
angle-addition taps of the reference's Pallas kernel, in the CUDA kernel's
order of operations) against the reference's two sinc forms: the XLA form
(`clock_recovery_block_batch(..., interp="sinc")`, `jnp.sinc(u) * w`) and the
Pallas kernel in interpret mode (`interp_mode="sinc"`).  Two chained blocks
each; equal symbol counts and sample positions, symbols and state within the
tolerance each test states.  Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jnp_tree
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.demodulator import Demodulator as JDemodulator
from xritdemod_tpu.ops import clock_recovery as jcr
from xritdemod_tpu.ops.clock_pallas import clock_recovery_block_pallas_batch
from xritdemod_tpu.utils import cplx as jcplx
from xritdemod_tpu_torch import tx
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.ops import clock_cuda
from xritdemod_tpu_torch.ops import clock_recovery as tcr
from xritdemod_tpu_torch.utils import cplx as tcplx


def _shaped(cfg, C, n, seed):
    """`(C, n)` carrier-free RRC-shaped BPSK, each channel with its own data
    and clock offset (the clock's input)."""
    out = []
    for c in range(C):
        rng = np.random.default_rng(seed + c)
        sym = 1.0 - 2.0 * rng.integers(0, 2, int(n / cfg.sps) + 64).astype(np.float32)
        iq = tx.modulate(sym, cfg, rng, freq_offset=0.0, phase=0.1 * c, amp=0.5,
                         noise=0.03, clock_ppm=(-400.0, 0.0, 250.0, 500.0)[c % 4])
        out.append(iq[:n])
    return np.stack(out)


def _assert_close(tout, jout, atol):
    (ts, tv, tst), (js, jv, jst) = tout, jout
    jn = jnp_tree(jst)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tst.ii.numpy(), jn.ii)
    np.testing.assert_allclose(ts.re.numpy(), np.asarray(js.re), atol=atol)
    np.testing.assert_allclose(ts.im.numpy(), np.asarray(js.im), atol=atol)
    np.testing.assert_allclose(tst.mu.numpy(), jn.mu, atol=atol)
    np.testing.assert_allclose(tst.omega.numpy(), jn.omega, atol=1e-5)
    np.testing.assert_allclose(tst.p.re.numpy(), jn.p.re, atol=atol)
    np.testing.assert_allclose(tst.p.im.numpy(), jn.p.im, atol=atol)
    np.testing.assert_array_equal(tst.c.re.numpy(), jn.c.re)
    np.testing.assert_array_equal(tst.tail.re.numpy(), jn.tail.re)


class TestSincTaps:
    def test_taps_match_the_reference_formula(self):
        """The angle-addition taps equal the reference's `_interp_taps`
        (`jnp.sinc(u) * w / sum`) to 2e-7, at mu = 0 (where one tap is the
        exact sinc(0) = 1), near 1, and between; each row sums to 1."""
        mu = np.array([0.0, 1e-7, 0.25, 0.5, 0.731, 0.999999], np.float32)
        got = tcr._sinc_rows(torch.from_numpy(mu)).numpy()
        want = np.stack([np.asarray(jcr._interp_taps(jnp.float32(m))) for m in mu])
        np.testing.assert_allclose(got, want, atol=2e-7)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
        np.testing.assert_array_equal(got[0], np.eye(8, dtype=np.float32)[3])

    def test_unknown_interpolator_is_refused(self):
        cfg = DemodConfig.lrit()
        td = Demodulator(cfg, 1024, device="cpu")
        x = tcplx.from_complex(_shaped(cfg, 2, 1024, seed=5))
        st = td.init_state_batch(2).clock
        for fn in (tcr.clock_recovery_block_batch, clock_cuda.clock_recovery_block_kernel_batch):
            with pytest.raises(ValueError):
                fn(x, st, td._clock, td.num_slots, interp="linear")
        with pytest.raises(ValueError):
            Demodulator(DemodConfig.lrit(clock_interp="linear"), 1024, device="cpu")


class TestSincClock:
    def test_against_the_xla_form(self):
        """Plain sinc clock vs `clock_recovery_block_batch(interp="sinc")`
        over two chained blocks of C = 4 channels, T = 4096, clocks from
        -400 to +500 ppm: equal counts and positions; symbols, mu and the
        history at atol 1e-4 (the XLA form's taps take `cos` of each tap's
        own angle and `jnp.sinc`; the port's the angle-addition identities:
        equal to float rounding), omega at 1e-5."""
        cfg = DemodConfig.lrit(clock_interp="sinc")
        C, T = 4, 4096
        x = _shaped(cfg, C, 2 * T, seed=40)
        jd = JDemodulator(JDemodConfig.lrit(clock_interp="sinc"), T)
        td = Demodulator(cfg, T, device="cpu")
        assert jd.num_slots == td.num_slots
        jst, tst = jd.init_state_batch(C).clock, td.init_state_batch(C).clock
        for blk in range(2):
            xb = x[:, blk * T:(blk + 1) * T]
            jout = jcr.clock_recovery_block_batch(
                jcplx.from_complex(xb), jst, jd._clock, jd.num_slots, interp="sinc")
            # the channels-last entry, as the fused receiver calls it
            tout = clock_cuda.clock_recovery_block_kernel_batch_cl(
                tcplx.from_complex(xb.T), tst, td._clock, td.num_slots, interp="sinc")
            _assert_close(tout, jout, atol=1e-4)
            assert tout[1].numpy().sum() > C * (T / cfg.sps - 4)
            jst, tst = jout[2], tout[2]

    def test_against_the_pallas_kernel_in_interpret_mode(self):
        """Plain sinc clock vs the reference's Pallas kernel itself,
        `interp_mode="sinc"`, interpret mode (its angle-addition branch, the
        one K2's sinc instance replaces), two chained blocks of C = 128,
        T = 1024 (channels tiled from four captures): equal counts and
        positions; symbols, mu and history at atol 1e-4, omega at 1e-5."""
        cfg = DemodConfig.lrit()
        C, T = 128, 1024
        x = np.tile(_shaped(cfg, 4, 2 * T, seed=60), (C // 4, 1))
        params = tcr.ClockRecoveryParams(
            cfg.sps, cfg.clock_alpha ** 2 / 4, cfg.clock_alpha, cfg.clock_omega_limit)
        jparams = jcr.ClockRecoveryParams(*params)
        ns = tcr.max_symbols(T, params)
        jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (C,) + a.shape),
                           jcr.clock_recovery_init(jparams, cfg.clock_mu))
        tst = tcr.clock_recovery_init(params, cfg.clock_mu, C)
        for blk in range(2):
            xb = x[:, blk * T:(blk + 1) * T]
            jout = clock_recovery_block_pallas_batch(
                jcplx.from_complex(xb), jst, jparams, ns, chunk=4, superchunks=2, ct=128,
                interpret=True, interp_mode="sinc")
            tout = tcr.clock_recovery_block_batch(
                tcplx.from_complex(xb), tst, params, ns, interp="sinc")
            _assert_close(tout, jout, atol=1e-4)
            jst, tst = jout[2], tout[2]

    def test_interpolators_differ_by_little(self):
        """mmse and sinc on the same block: equal counts, symbols within 2e-2
        of each other (two interpolators of the same band-limited signal;
        the KAT's literals differ by ~1e-3), so neither entry is the other
        relabelled (they differ somewhere)."""
        cfg = DemodConfig.lrit()
        td = Demodulator(cfg, 4096, device="cpu")
        x = tcplx.from_complex(_shaped(cfg, 2, 4096, seed=80))
        st = td.init_state_batch(2).clock
        a = tcr.clock_recovery_block_batch(x, st, td._clock, td.num_slots, interp="mmse")
        b = tcr.clock_recovery_block_batch(x, st, td._clock, td.num_slots, interp="sinc")
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
        np.testing.assert_allclose(a[0].re.numpy(), b[0].re.numpy(), atol=2e-2)
        assert not torch.equal(a[0].re, b[0].re)


# The mu values the sinc kernel's range argument rests on: a step leaves mu in
# [0, 1] (1.0 only by rounding a tiny negative fraction), where pi mu and
# pi mu / 4 lie far below the sine's large-argument threshold.  0 and 1.0 put
# u = 0 on taps 3 and 4.
MU_EDGES = (0.0, 2.0 ** -24, 0.5, 1.0 - 2.0 ** -24, 1.0)
# The XLA sinc form, compiled once for every edge value (same shapes).
_jax_clock = jax.jit(jcr.clock_recovery_block_batch, static_argnums=(2, 3),
                     static_argnames=("interp",))


@pytest.mark.parametrize("mu", MU_EDGES)
def test_sinc_forms_at_the_mu_edges(mu):
    """At each edge value: `_sinc_rows` against the reference's
    `_interp_taps` to 2e-7, the row summing to 1 within 1e-6 (at mu = 0,
    where sin(pi mu) is 0, the unit row; at 1.0 the float pi leaves the
    other taps ~1e-8); and one block of the plain sinc clock, C = 2, T = 512,
    from a state whose mu is that value, against the XLA sinc form: equal
    counts and positions, symbols, mu and history at atol 1e-4, omega at
    1e-5 (the tolerances of the tests above)."""
    got = tcr._sinc_rows(torch.tensor([mu], dtype=torch.float32)).numpy()[0]
    want = np.asarray(jcr._interp_taps(jnp.float32(mu)))
    np.testing.assert_allclose(got, want, atol=2e-7)
    np.testing.assert_allclose(got.sum(), 1.0, atol=1e-6)
    if mu == 0.0:
        np.testing.assert_array_equal(got, np.eye(8, dtype=np.float32)[3])

    cfg = DemodConfig.lrit(clock_interp="sinc")
    C, T = 2, 512
    x = _shaped(cfg, C, T, seed=90)
    jd = JDemodulator(JDemodConfig.lrit(clock_interp="sinc"), T)
    td = Demodulator(cfg, T, device="cpu")
    jst, tst = jd.init_state_batch(C).clock, td.init_state_batch(C).clock
    jst = jst._replace(mu=jnp.full((C,), mu, jnp.float32))
    tst = tst._replace(mu=torch.full((C,), mu, dtype=torch.float32))
    jout = _jax_clock(jcplx.from_complex(x), jst, jd._clock, jd.num_slots, interp="sinc")
    tout = tcr.clock_recovery_block_batch(
        tcplx.from_complex(x), tst, td._clock, td.num_slots, interp="sinc")
    _assert_close(tout, jout, atol=1e-4)

