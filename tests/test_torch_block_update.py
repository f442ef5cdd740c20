"""The block-update and bf16 forms: the port's plain versions (which the CUDA
kernels repeat step for step on the card) against the JAX package's forms.

  - `costas_block_update` (K6's slab form, K1's slab Costas loop) against the
    JAX `costas_block_update`; K = 1 the exact loop bit for bit.
  - The fused front end with `block_k` (the slab AGC and Costas loop; with
    `block_stages` "agc" or "costas" the slab on that loop alone) and with
    `precision="bf16"` against `demod_frontend_pallas(interpret=True)` at
    C = 128, rows 256.
  - `clock_recovery_block_update_batch` (K2's block update), mmse and sinc,
    at the LRIT and HRIT sample rates, against the JAX XLA form at K = 16 and
    the Pallas kernel in interpret mode at K = 4 (the JAX package's
    interpret path shrinks its chunk to 4); K = 1 the exact clock bit for bit.
  - The rings on a bfloat16 ring against `ring_pallas` with one.
  - `block_batch`, fused and split, with `frontend_block_update=8` and
    `clock_block_update=4`, against JAX `Demodulator.block_batch` with the
    same config, two chained blocks.
  - The JAX package's two chain tests on the port: every VCDU bit-exact.

Tolerances: where both sides compute the same float32 operations in another
order (XLA on the CPU fuses multiply-adds, sums trees where the port sums in
order) the JAX package's own bounds between its forms: symbols 1e-5, phase
1e-4, freq 1e-5, and valid masks and sample positions exact.  Each JAX
reference is computed once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import tnp
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.demodulator import Demodulator as JDemodulator
from xritdemod_tpu.ops import agc as jagc
from xritdemod_tpu.ops import clock_recovery as jcr
from xritdemod_tpu.ops import costas as jcostas
from xritdemod_tpu.ops import filters as jfilters
from xritdemod_tpu.ops.clock_pallas import clock_recovery_block_pallas_batch
from xritdemod_tpu.ops.frontend_pallas import demod_frontend_pallas
from xritdemod_tpu.ops.ring_pallas import ring_append as jring_append
from xritdemod_tpu.ops.ring_pallas import ring_extract as jring_extract
from xritdemod_tpu.utils.cplx import CF32 as JCF
from xritdemod_tpu_torch import convert, tx
from xritdemod_tpu_torch.models.decoder import DecoderConfig, StreamDecoder
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.models.receiver import FusedReceiver
from xritdemod_tpu_torch.ops import agc as tagc
from xritdemod_tpu_torch.ops import clock_recovery as tcr
from xritdemod_tpu_torch.ops import costas as tcostas
from xritdemod_tpu_torch.ops import filters as tfilters
from xritdemod_tpu_torch.ops import frontend_cuda, ring_cuda, stream_cuda
from xritdemod_tpu_torch.parallel.channels import ChannelDemodulator
from xritdemod_tpu_torch.utils.cplx import CF32 as TCF


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tcf(re, im):
    return TCF(_t(re), _t(im))


def _jcf(re, im):
    return JCF(jnp.asarray(re), jnp.asarray(im))


def _leaves(st):
    return [np.asarray(a) for a in jax.tree.leaves(st)]


# --------------------------------------------------------------------------
# the Costas slab form
# --------------------------------------------------------------------------

def _costas_input(C=4, T=1024, seed=7):
    rng = np.random.default_rng(seed)
    n = np.arange(T)
    ph = 0.3 + 0.002 * n
    bits = 1.0 - 2.0 * rng.integers(0, 2, (C, T))
    re = (0.5 * bits * np.cos(ph) + rng.normal(0, 0.05, (C, T))).astype(np.float32)
    im = (0.5 * bits * np.sin(ph) + rng.normal(0, 0.05, (C, T))).astype(np.float32)
    phase = np.array([0.1, 6.2, -6.2, 3.0], np.float32)[:C]
    freq = np.array([0.01, -0.02, 0.0, 0.003], np.float32)[:C]
    return re, im, phase, freq


@pytest.mark.parametrize("K", [4, 8, 16])
def test_costas_block_update_matches_jax(K):
    re, im, phase, freq = _costas_input()
    cp = tcostas.costas_gains(0.0037)
    jy, js = jcostas.costas_block_update(
        _jcf(re, im), jcostas.CostasState(jnp.asarray(phase), jnp.asarray(freq)),
        jcostas.costas_gains(0.0037), chunk=K)
    ty, ts = tcostas.costas_block_update(
        _tcf(re, im), tcostas.CostasState(_t(phase), _t(freq)), cp, K)
    np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=1e-5)
    np.testing.assert_allclose(ty.im.numpy(), np.asarray(jy.im), atol=1e-5)
    np.testing.assert_allclose(ts.phase.numpy(), np.asarray(js.phase), atol=1e-4)
    np.testing.assert_allclose(ts.freq.numpy(), np.asarray(js.freq), atol=1e-5)


@pytest.mark.parametrize("T", [1024, 1000])
def test_costas_block_update_k1_is_the_exact_loop(T):
    """Bit for bit, wraps included (phases start near +-2 pi)."""
    re, im, phase, freq = _costas_input(T=T)
    cp = tcostas.costas_gains(0.0037)
    st = tcostas.CostasState(_t(phase), _t(freq))
    y1, s1 = tcostas.costas_block(_tcf(re, im), st, cp)
    y2, s2 = tcostas.costas_block_update(_tcf(re, im), st, cp, 1)
    for a, b in ((y1.re, y2.re), (y1.im, y2.im), (s1.phase, s2.phase), (s1.freq, s2.freq)):
        assert torch.equal(a, b)
    # The standalone kernel's wrapper takes the same plain form on the CPU.
    y3, s3 = stream_cuda.costas_block_kernel(_tcf(re, im), st, cp, chunk=1)
    assert torch.equal(y3.re, y1.re) and torch.equal(s3.phase, s1.phase)


def test_costas_block_update_rejects_a_ragged_block():
    re, im, phase, freq = _costas_input(T=1000)
    with pytest.raises(ValueError):
        tcostas.costas_block_update(_tcf(re, im), tcostas.CostasState(_t(phase), _t(freq)),
                                    tcostas.costas_gains(0.0037), 16)


# --------------------------------------------------------------------------
# the fused front end's slab and bf16 forms
# --------------------------------------------------------------------------

FE_C = 128


def _fe_setup(T, seed):
    rng = np.random.default_rng(seed)
    n = np.arange(T)
    bits = 1.0 - 2.0 * rng.integers(0, 2, (FE_C, T))
    amp = rng.uniform(0.05, 0.6, (FE_C, 1))
    re = (amp * bits * np.cos(0.003 * n + 0.2) + rng.normal(0, 0.03, (FE_C, T)))
    im = (amp * bits * np.sin(0.003 * n + 0.2) + rng.normal(0, 0.03, (FE_C, T)))
    re, im = re.astype(np.float32), im.astype(np.float32)
    cfg = DemodConfig.lrit()
    taps = tfilters.rrc_taps(1.0, cfg.circuit_sample_rate, cfg.symbol_rate, cfg.rrc_alpha,
                             cfg.rrc_taps)
    nh = len(taps) - 1
    gain = rng.uniform(0.8, 3.0, FE_C).astype(np.float32)
    gain[:8] = 3999.0                                 # the max-gain clamp binds
    re[:8] *= 1e-4
    im[:8] *= 1e-4
    hr = rng.normal(0, 0.2, (FE_C, nh)).astype(np.float32)
    hi = rng.normal(0, 0.2, (FE_C, nh)).astype(np.float32)
    phase = rng.uniform(-3, 3, FE_C).astype(np.float32)
    freq = rng.uniform(-0.004, 0.004, FE_C).astype(np.float32)
    return re, im, taps, gain, hr, hi, phase, freq


# (T, block_k, precision, AGC rate, block_stages).  With bf16 a float32 AGC
# output one ulp apart on the two sides (XLA on the CPU fuses the gain
# update's multiply-add) can round to neighbouring bfloat16 values, a jump of
# a bf16 ulp; so the bf16 cases hold the gain still (rate 0: the AGC output
# is one product, the same on both sides) and test the filter's rounding
# exactly, while the slab AGC is held in the float32 cases and in float64
# below.
FE_CASES = [(1024, 4, "highest", 0.01, "both"), (1024, 0, "bf16", 0.0, "both"),
            (2048, 8, "bf16", 0.0, "both"),
            (1024, 8, "highest", 0.01, "agc"), (1024, 8, "highest", 0.01, "costas"),
            (1024, 8, "bf16", 0.0, "agc"), (1024, 8, "bf16", 0.0, "costas")]


@pytest.fixture(scope="module")
def frontend_runs():
    """Each case through the Pallas kernel (interpret) and the port's plain
    form, from the same inputs."""
    out = {}
    for T, K, prec, rate, stages in FE_CASES:
        re, im, taps, gain, hr, hi, phase, freq = _fe_setup(T, 100 + K)
        jy, jg, jh, js = demod_frontend_pallas(
            _jcf(re.T.copy(), im.T.copy()), jnp.asarray(gain), _jcf(hr, hi),
            jcostas.CostasState(jnp.asarray(phase), jnp.asarray(freq)),
            jagc.AgcParams(rate=rate), tuple(float(v) for v in taps),
            jcostas.costas_gains(0.0037), rows=256, interpret=True, block_k=K, precision=prec,
            block_stages=stages)
        ty, tg, th, ts = frontend_cuda.demod_frontend(
            _tcf(re.T.copy(), im.T.copy()), _t(gain), _tcf(hr, hi),
            tcostas.CostasState(_t(phase), _t(freq)), tagc.AgcParams(rate=rate), _t(taps),
            tcostas.costas_gains(0.0037), block_k=K, precision=prec, block_stages=stages)
        out[T, K, prec, rate, stages] = (jy, jg, jh, js), (ty, tg, th, ts)
    return out


@pytest.mark.parametrize("case", FE_CASES)
def test_frontend_forms_match_pallas_interpret(frontend_runs, case):
    """The gains and history to 1e-6 relative (the slab prefix's products
    round apart, where XLA fuses multiply-adds); the Costas state 1e-4 /
    1e-5 (the JAX package's bounds), and the rotated output within what that
    phase bound allows, |y| x 1e-4 (its slab sums run in another order).
    With bf16 the filter's operands are the same bf16 values on both sides
    and each product is exact; only the order of the float32 sums differs."""
    (jy, jg, jh, js), (ty, tg, th, ts) = frontend_runs[case]
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(th.re.numpy(), np.asarray(jh.re), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(th.im.numpy(), np.asarray(jh.im), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ts.phase.numpy(), np.asarray(js.phase), atol=1e-4)
    np.testing.assert_allclose(ts.freq.numpy(), np.asarray(js.freq), atol=1e-5)
    mag = np.hypot(np.asarray(jy.re), np.asarray(jy.im))
    for t, j in ((ty.re, jy.re), (ty.im, jy.im)):
        assert (np.abs(t.numpy() - np.asarray(j)) <= 2e-6 + 1e-4 * mag).all()


def test_agc_slab_is_its_own_recursion_in_float64():
    """The slab gains against a float64 evaluation of the same slab formula
    (an affine map per row, composed in order; the clamp through the running
    minimum), host-independent: within a float32 drift bound of 1e-6
    relative per slab over 16 slabs."""
    T, K = 256, 16
    re, im, _, gain, *_ = _fe_setup(T, 5)
    mag = np.hypot(re.astype(np.float64), im.astype(np.float64)).T          # (T, C)
    p = tagc.AgcParams()
    got, g_out = tagc.agc_slab_gains(_t(mag.astype(np.float32)), _t(gain), p, K)
    rate, ref, M = np.float64(np.float32(p.rate)), np.float64(np.float32(p.reference)), \
        np.float64(np.float32(p.max_gain))
    g = gain.astype(np.float64)
    want = np.empty_like(mag)
    for s0 in range(0, T, K):
        a, b = np.ones_like(g), np.zeros_like(g)
        cm = np.full_like(g, np.inf)
        g0 = g
        for k in range(K):
            want[s0 + k] = g
            ak, bk = 1.0 - rate * mag[s0 + k], rate * ref
            a, b = ak * a, ak * b + bk
            cm = np.minimum(cm, (M - b) / a)
            g = np.minimum(a * np.minimum(g0, cm) + b, M)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    np.testing.assert_allclose(g_out.numpy(), g, rtol=2e-5)


def test_frontend_form_arguments():
    re, im, taps, gain, hr, hi, phase, freq = _fe_setup(96, 1)
    args = (_tcf(re.T.copy(), im.T.copy()), _t(gain), _tcf(hr, hi),
            tcostas.CostasState(_t(phase), _t(freq)), tagc.AgcParams(), _t(taps),
            tcostas.costas_gains(0.0037))
    with pytest.raises(ValueError):
        frontend_cuda.demod_frontend(*args, precision="default")
    with pytest.raises(ValueError):
        frontend_cuda.demod_frontend(*args, block_k=64)        # 96 % 64
    assert [frontend_cuda.tile_rows(k) for k in (0, 1, 4, 8, 16, 32, 64)] == \
        [48, 48, 48, 48, 48, 64, 64]
    with pytest.raises(ValueError):
        frontend_cuda.tile_rows(128)
    # Beside an exact Costas chain (the exact form, block_stages "agc") the
    # Costas warp has scheduler 3 to itself and the AGC warp sits among the
    # FIR warps; beside the Costas slab walk the gain chain (warp 7) and two
    # of the three magnitude warps join scheduler 3.
    assert frontend_cuda.roles(0).index("agc") % 4 != 3
    assert frontend_cuda.roles(64)[3] == "costas" and frontend_cuda.roles(64)[7] == "agc"
    for K in (8, 64):
        r = frontend_cuda.roles(K, "agc")
        assert r[3] == "costas" and r.index("agc") % 4 != 3
        assert [w for w, name in enumerate(r) if w % 4 == 3 and name] == [3]
        for stages in ("both", "costas"):
            r = frontend_cuda.roles(K, stages)
            assert r[3] == "costas" and r[7] == "agc" and r.count("mag") == 3
            assert {r[w] for w in range(3, len(r), 4)} == {"costas", "agc", "mag"}
    assert frontend_cuda.roles(8, "agc") == frontend_cuda.roles(0)
    assert frontend_cuda.roles(8, "costas") == frontend_cuda.roles(8)
    with pytest.raises(ValueError):
        frontend_cuda.demod_frontend(*args, block_k=8, block_stages="costa")
    with pytest.raises(ValueError):
        frontend_cuda.demod_frontend_plain(*args, block_k=8, block_stages="all")
    with pytest.raises(ValueError):
        frontend_cuda.roles(8, "none")


# Edge states of the slab forms, the ones the CUDA kernels' fast paths rely
# on (`csrc/loops.cuh`): Costas phases at and just past +-2 pi (the wraps),
# freq at its clip bounds with errors pushing it outward (the clip binds;
# small inputs, so that the JAX form's deferred clip, which the port applies
# at the slab's end, moves the phase by less than the tolerance), and a
# phase above the kernels' large-argument threshold 105615 (an input of
# zero errors: both forms only wrap such a phase, by the same steps); the AGC with the
# max-gain clamp binding at a slab's first row and in mid-slab (gains
# climbing from just below it), and with max_gain 0 (no clamp).
_TWO_PI32 = float(np.float32(2 * np.pi))
EDGE_PHASE = [_TWO_PI32, -_TWO_PI32, float(np.nextafter(np.float32(_TWO_PI32), np.float32(9))),
              -float(np.nextafter(np.float32(_TWO_PI32), np.float32(9))), 0.0, 3.1, 2.0e5, -1.5e5]
EDGE_FREQ = [0.01, -0.01, 0.01, -0.01, 0.004, -0.004, 0.0, 0.0]
SLAB_EDGE_CASES = [("costas", 8), ("costas", 16), ("agc", 8, 2.0), ("agc", 8, 0.0)]


@pytest.mark.parametrize("case", SLAB_EDGE_CASES)
def test_slab_forms_match_jax_at_edge_states(case):
    """`costas_slab_steps` against the JAX `costas_block_update`, and
    `agc_slab_gains` against the JAX slab AGC (`demod_frontend_pallas`
    with `block_stages="agc"`, interpret mode: its gain and FIR history,
    the block's last AGC outputs), from the edge states above, with the
    file's tolerances: symbols 1e-5, phase 1e-4, freq 1e-5, gains and
    history 1e-6 relative."""
    rng = np.random.default_rng(23)
    if case[0] == "costas":
        K, T = case[1], 512
        C = len(EDGE_PHASE)
        amp = np.array([0.02, 0.02, 0.02, 0.02, 0.5, 0.5, 0.0, 0.0], np.float32)[:, None]
        bits = 1.0 - 2.0 * rng.integers(0, 2, (C, T))
        n = np.arange(T)
        re = (amp * bits * np.cos(0.01 * n)).astype(np.float32)
        im = (amp * np.abs(bits) * np.sin(0.01 * n + 0.4)).astype(np.float32)
        phase = np.array(EDGE_PHASE, np.float32)
        freq = np.array(EDGE_FREQ, np.float32)
        jp = jcostas.costas_gains(0.0037)._replace(freq_min=-0.01, freq_max=0.01)
        tp = tcostas.costas_gains(0.0037)._replace(freq_min=-0.01, freq_max=0.01)
        jy, js = jcostas.costas_block_update(
            _jcf(re, im), jcostas.CostasState(jnp.asarray(phase), jnp.asarray(freq)), jp, chunk=K)
        ty, ts = tcostas.costas_block_update(
            _tcf(re, im), tcostas.CostasState(_t(phase), _t(freq)), tp, K)
        np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=1e-5)
        np.testing.assert_allclose(ty.im.numpy(), np.asarray(jy.im), atol=1e-5)
        np.testing.assert_allclose(ts.phase.numpy(), np.asarray(js.phase), atol=1e-4)
        np.testing.assert_allclose(ts.freq.numpy(), np.asarray(js.freq), atol=1e-5)
        # The clip bound: without it the first four channels' freq ends elsewhere.
        _, free = tcostas.costas_block_update(
            _tcf(re, im), tcostas.CostasState(_t(phase), _t(freq)), tcostas.costas_gains(0.0037), K)
        assert (free.freq.numpy()[:4] != ts.freq.numpy()[:4]).all()
        assert (np.abs(ts.phase.numpy()[6:]) > 105615.0).all()   # large all along
        return
    _, K, M = case
    T = 256
    re, im, taps, gain, hr, hi, phase, freq = _fe_setup(T, 31)
    gain[:16] = M if M else 3.0                     # at the clamp in a slab's first row
    gain[16:48] = M - 0.05 if M else 1.5            # climbing into it mid-slab
    re[:48] *= 1e-3
    im[:48] *= 1e-3
    agc_j, agc_t = jagc.AgcParams(max_gain=M), tagc.AgcParams(max_gain=M)
    _, jg, jh, _ = demod_frontend_pallas(
        _jcf(re.T.copy(), im.T.copy()), jnp.asarray(gain), _jcf(hr, hi),
        jcostas.CostasState(jnp.asarray(phase), jnp.asarray(freq)), agc_j,
        tuple(float(v) for v in taps), jcostas.costas_gains(0.0037), rows=256, interpret=True,
        block_k=K, block_stages="agc")
    mag = torch.hypot(_t(re.T.copy()), _t(im.T.copy()))
    gains, g = tagc.agc_slab_gains(mag, _t(gain), agc_t, K)
    nh = len(taps) - 1
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose((_t(re.T.copy()) * gains)[-nh:].T.numpy(), np.asarray(jh.re),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose((_t(im.T.copy()) * gains)[-nh:].T.numpy(), np.asarray(jh.im),
                               rtol=1e-6, atol=1e-7)
    if M:
        assert (gains.numpy()[:, :16] == np.float32(M)).all()             # bound in row 0
        met = gains.numpy()[:, 16:48]
        assert (met[0] < M).all() and (met[-1] == np.float32(M)).any()    # and mid-slab


# --------------------------------------------------------------------------
# the block-update clock
# --------------------------------------------------------------------------

def _clock_input(cfg, T, C, seed):
    rng = np.random.default_rng(seed)
    sps = cfg.sps
    nsym = int(T / sps) + 40
    syms = 1.0 - 2.0 * rng.integers(0, 2, nsym)
    taps = jfilters.rrc_taps(1.0, cfg.circuit_sample_rate * 8, cfg.symbol_rate,
                             cfg.rrc_alpha, 127 * 8)
    fine = np.zeros(int(nsym * sps * 8) + 2000)
    fine[(np.arange(nsym) * sps * 8).astype(np.int64)] = syms
    shaped = np.convolve(fine, taps, mode="same")[::8][:T]
    sig = np.stack([np.roll(shaped, 3 * c) for c in range(C)]) * 0.5
    sig = sig + rng.normal(0, 0.02, sig.shape)
    return sig.astype(np.float32), (0.3 * rng.normal(0, 0.05, sig.shape)).astype(np.float32)


def _clock_params(cfg):
    return dict(omega=cfg.sps, gain_omega=cfg.clock_alpha**2 / 4, gain_mu=cfg.clock_alpha,
                omega_relative_limit=cfg.clock_omega_limit)


CLOCK_RATES = {"lrit": JDemodConfig.lrit(sample_rate=1_250_000),
               "hrit": JDemodConfig.hrit(sample_rate=3_000_000)}
CLK_C, CLK_T = 128, 1024


@pytest.fixture(scope="module")
def clock_refs():
    """The JAX forms once: XLA at K = 16 (2 chained blocks) and the Pallas
    kernel at K = 4 (interpret), each interpolator and rate."""
    out = {}
    for rate, cfg in CLOCK_RATES.items():
        re, im = _clock_input(cfg, 2 * CLK_T, CLK_C, 11)
        jp = jcr.ClockRecoveryParams(**_clock_params(cfg))
        ns = jcr.max_symbols(CLK_T, jp)
        init = jax.tree.map(lambda a: jnp.broadcast_to(a, (CLK_C,) + a.shape),
                            jcr.clock_recovery_init(jp, cfg.clock_mu))
        for interp in ("mmse", "sinc"):
            st, blocks = init, []
            for b in range(2):
                x = _jcf(re[:, b * CLK_T:(b + 1) * CLK_T], im[:, b * CLK_T:(b + 1) * CLK_T])
                s, v, st = jcr.clock_recovery_block_update_batch(
                    x, st, jp, ns, chunk=16, interp=interp)
                blocks.append((np.asarray(s.re), np.asarray(v), _leaves(st)))
            out[rate, interp, "xla"] = blocks
            s, v, st = clock_recovery_block_pallas_batch(
                _jcf(re[:, :CLK_T], im[:, :CLK_T]), init, jp, ns, chunk=4, superchunks=2,
                ct=128, interpret=True, block_update=True, interp_mode=interp)
            out[rate, interp, "pallas"] = [(np.asarray(s.re), np.asarray(v), _leaves(st))]
        out[rate, "input"] = re, im, ns
    return out


def _port_clock(rate, clock_refs, interp, K, blocks):
    cfg = CLOCK_RATES[rate]
    re, im, ns = clock_refs[rate, "input"]
    params = tcr.ClockRecoveryParams(**_clock_params(cfg))
    st = tcr.clock_recovery_init(params, cfg.clock_mu, CLK_C)
    out = []
    for b in range(blocks):
        x = _tcf(re[:, b * CLK_T:(b + 1) * CLK_T], im[:, b * CLK_T:(b + 1) * CLK_T])
        s, v, st = tcr.clock_recovery_block_update_batch(x, st, params, ns, K, interp)
        out.append((s.re.numpy(), v.numpy(), [np.asarray(a) for a in tnp(st)]))
    return out


def _row_step(interp) -> float:
    """How far one step of the MMSE table's row index (mu rounded to 1/128)
    can move a symbol: the largest L1 distance of two neighbouring rows,
    times the largest sample the tests feed (1.2)."""
    if interp != "mmse":
        return 0.0
    tab = tcr.mmse_table("cpu").numpy().astype(np.float64)
    return float(np.abs(np.diff(tab, axis=0)).sum(1).max()) * 1.2


def _assert_clock_close(port, ref, interp):
    """Symbol counts and sample positions exact, omega 1e-6 (the JAX
    package's bounds); symbols compared in order (a chunk cut short may
    leave a gap in either valid mask).  A chunk's position sums run at K x
    sps samples (68 at LRIT, K = 16), where a float32 ulp is 7.6e-6; the
    JAX XLA form also takes each symbol's fraction after adding its offset
    in a window of hundreds of samples.  The two orders round apart and the
    loop carries the differences: mu within 1e-3 of a sample, sinc symbols
    1e-4.  mmse: a mu a little apart at an edge of the table's 1/128 grid
    takes the neighbouring row, so a symbol may differ by one row step
    (`_row_step`); at most 2 % of them differ beyond 1e-5."""
    tol = 1e-5 if interp == "mmse" else 1e-4
    for (ts, tv, tst), (js, jv, jst) in zip(port, ref):
        np.testing.assert_array_equal(tv.sum(-1), jv.sum(-1))
        d = np.concatenate([np.abs(ts[c][tv[c]] - js[c][jv[c]]) for c in range(tv.shape[0])])
        assert d.max() <= max(tol, _row_step(interp)), d.max()
        assert (d > tol).mean() <= 0.02, (d > tol).mean()
        np.testing.assert_array_equal(tst[2], jst[2])
        np.testing.assert_allclose(tst[0], jst[0], atol=1e-3)
        np.testing.assert_allclose(tst[1], jst[1], atol=1e-6)


@pytest.mark.parametrize("rate", sorted(CLOCK_RATES))
@pytest.mark.parametrize("interp", ["mmse", "sinc"])
def test_clock_block_update_matches_xla_k16(clock_refs, rate, interp):
    port = _port_clock(rate, clock_refs, interp, 16, 2)
    _assert_clock_close(port, clock_refs[rate, interp, "xla"], interp)


@pytest.mark.parametrize("rate", sorted(CLOCK_RATES))
@pytest.mark.parametrize("interp", ["mmse", "sinc"])
def test_clock_block_update_matches_pallas_k4(clock_refs, rate, interp):
    port = _port_clock(rate, clock_refs, interp, 4, 1)
    _assert_clock_close(port, clock_refs[rate, interp, "pallas"], interp)


@pytest.mark.parametrize("interp", ["mmse", "sinc"])
def test_clock_block_update_k1_is_the_exact_clock(interp):
    cfg = CLOCK_RATES["lrit"]
    re, im = _clock_input(cfg, 900, 6, 3)
    params = tcr.ClockRecoveryParams(**_clock_params(cfg))
    st = tcr.clock_recovery_init(params, cfg.clock_mu, 6)
    x = _tcf(re, im)
    ns = tcr.max_symbols(900, params)
    a = tcr.clock_recovery_block_batch(x, st, params, ns, interp)
    b = tcr.clock_recovery_block_update_batch(x, st, params, ns, 1, interp)
    assert torch.equal(a[0].re, b[0].re) and torch.equal(a[0].im, b[0].im)
    assert torch.equal(a[1], b[1])
    for u, v in zip(tnp(a[2]), tnp(b[2])):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_clock_block_update_segments():
    """Two segments: a chunk counts symbols only below its segment's end and
    the next segment's chunks start afresh; one segment of the same block is
    the whole-block form.  Both give the same symbol count within one."""
    cfg = CLOCK_RATES["lrit"]
    re, im = _clock_input(cfg, 2048, 3, 4)
    params = tcr.ClockRecoveryParams(**_clock_params(cfg))
    st = tcr.clock_recovery_init(params, cfg.clock_mu, 3)
    ns = 2 * tcr.max_symbols(1024, params)
    x = _tcf(re, im)
    one = tcr.clock_recovery_block_update_batch(x, st, params, ns, 16, "mmse", 1)
    two = tcr.clock_recovery_block_update_batch(x, st, params, ns, 16, "mmse", 2)
    assert (one[1].sum(-1) - two[1].sum(-1)).abs().max() <= 1
    # The segmented form is one launch of the reference's chained segments:
    # the first segment's symbols are those of a block of its own.
    s1, v1, _ = tcr.clock_recovery_block_update_batch(
        _tcf(re[:, :1024], im[:, :1024]), st, params, ns, 16, "mmse", 1)
    for c in range(3):
        first = s1.re[c][v1[c]]
        np.testing.assert_array_equal(two[0].re[c][two[1][c]][: len(first)].numpy(),
                                      first.numpy())
    with pytest.raises(ValueError):
        tcr.clock_recovery_block_update_batch(x, st, params, ns, 16, "mmse", 3)


# --------------------------------------------------------------------------
# the bfloat16 ring
# --------------------------------------------------------------------------

def test_rings_on_bf16_match_ring_pallas():
    rng = np.random.default_rng(9)
    C, L, S, E = 8, 512, 96, 160
    fill = np.array([0, 10, 150, 300, 410, 500, 7, 64], np.int32)
    base = rng.normal(0, 0.7, (C, L)).astype(np.float32)
    base = np.where(np.arange(L)[None] < fill[:, None], base, 0.0).astype(np.float32)
    ring16 = torch.from_numpy(base).to(torch.bfloat16)
    new = rng.normal(0, 0.7, (C, S)).astype(np.float32)
    n_new = np.array([96, 0, 33, 96, 5, 96, 50, 1], np.int32)
    pos = rng.integers(0, 40, C).astype(np.int32)
    jring = jnp.asarray(tnp(ring16))                   # ml_dtypes bfloat16
    jr, jf, jo = jring_append(jring, jnp.asarray(fill), jnp.asarray(new),
                              jnp.asarray(n_new), interpret=True)
    jr2, jf2, jout, jok = jring_extract(jr, jf, jnp.asarray(pos), E, interpret=True)
    tr, tf, to = ring_cuda.ring_append(ring16.clone(), _t(fill), _t(new), _t(n_new))
    tr2, tf2, tout, tok = ring_cuda.ring_extract(tr.clone(), tf, _t(pos), E)   # in place
    assert tr.dtype == tr2.dtype == torch.bfloat16 and tout.dtype == torch.float32
    np.testing.assert_array_equal(tr.float().numpy(), np.asarray(jr, np.float32))
    np.testing.assert_array_equal(tr2.float().numpy(), np.asarray(jr2, np.float32))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout, np.float32))
    for a, b in ((tf, jf), (to, jo), (tf2, jf2), (tok, jok)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ring_cuda._check(tr2, tf2)                         # a bf16 ring is admitted


# --------------------------------------------------------------------------
# block_batch with the forms, fused and split
# --------------------------------------------------------------------------

BB_C, BB_T = 128, 2048


def _bb_signal(cfg, seed):
    from tests.test_demod_chain import make_lrit_signal

    sig, _ = make_lrit_signal(np.random.default_rng(seed), 2000, cfg)
    return sig


@pytest.fixture(scope="module")
def block_batch_runs():
    """Two chained blocks of the same capture tiled over 128 channels, per
    front end, through both packages."""
    out = {}
    forms = dict(frontend_block_update=8, clock_block_update=4)
    for kind in ("fused", "split"):
        jextra = dict(frontend_kernel="fused", clock_kernel="pallas") if kind == "fused" else {}
        jcfg = JDemodConfig.lrit(sample_rate=1_250_000, **forms, **jextra)
        tcfg = DemodConfig.lrit(sample_rate=1_250_000, frontend_kernel=kind, **forms)
        sig = _bb_signal(jcfg, 31)
        jd, td = JDemodulator(jcfg, block_len=BB_T), Demodulator(tcfg, BB_T, device="cpu")
        jst, tst = jd.init_state_batch(BB_C), td.init_state_batch(BB_C)
        runs = []
        for b in range(2):
            x = np.tile(sig[b * BB_T:(b + 1) * BB_T], (BB_C, 1))
            re, im = x.real.astype(np.float32), x.imag.astype(np.float32)
            js, jv, jst = jd.block_batch(_jcf(re, im), jst)
            ts, tv, tst = td.block_batch(_tcf(re, im), tst)
            runs.append((np.asarray(js), np.asarray(jv), ts.numpy(), tv.numpy(),
                         np.asarray(jst.clock.ii), tst.clock.ii.numpy()))
        out[kind] = runs
    return out


@pytest.mark.parametrize("kind", ["fused", "split"])
def test_block_batch_forms_match_jax(block_batch_runs, kind):
    """Valid masks and positions exact; soft symbols 2e-3, the JAX package's
    bound between its blocked fused and split paths (its split path's AGC is
    the associative scan, the port's the exact recursion, ROADMAP §C)."""
    for js, jv, ts, tv, jii, tii in block_batch_runs[kind]:
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_allclose(ts, js, atol=2e-3)
        np.testing.assert_array_equal(tii, jii)


def test_config_forms_resolve_and_validate():
    d = Demodulator(DemodConfig.lrit(), 4096, device="cpu")
    assert (d.block_k, d.precision) == (0, "highest")
    for prec in ("auto", "default", "highest"):
        assert Demodulator(DemodConfig.lrit(frontend_precision=prec), 4096,
                           device="cpu").precision == "highest"
    d = Demodulator(DemodConfig.lrit(frontend_block_update=8, frontend_precision="bf16",
                                     clock_block_update=16), 4096, device="cpu")
    assert (d.block_k, d.precision) == (8, "bf16")
    for bad in (dict(frontend_block_update=-2), dict(clock_block_update=-1),
                dict(frontend_precision="fp8"), dict(frontend_block_update=3)):
        with pytest.raises(ValueError):
            Demodulator(DemodConfig.lrit(**bad), 4096, device="cpu")


# --------------------------------------------------------------------------
# the JAX package's chain tests, on the port
# --------------------------------------------------------------------------

def _chain(cfg, seed, nframes):
    """`tests/test_demod_chain.py`'s capture (LRIT, 1e-4 carrier offset)
    through `ChannelDemodulator` (2 channels, 65536-sample blocks) and a
    `StreamDecoder` on channel 0."""
    rng = np.random.default_rng(seed)
    vcdus = tx.make_vcdus(nframes, scid=13, vcid=5, rng=rng)
    symbols = tx.encode_stream(vcdus, lrit=True)
    sps, os_factor, ntaps = cfg.sps, 4, 127
    nsym = len(symbols)
    impulses = np.zeros(int(nsym * sps * os_factor) + ntaps * os_factor)
    impulses[(np.arange(nsym) * sps * os_factor).astype(np.int64)] = symbols
    rc = tfilters.rrc_taps(1.0, cfg.circuit_sample_rate * os_factor, cfg.symbol_rate,
                           cfg.rrc_alpha, ntaps * os_factor)
    sig = np.convolve(impulses, rc.astype(np.float64) * os_factor, mode="same")[::os_factor]
    n = np.arange(len(sig))
    sig = sig * np.exp(1j * (2 * np.pi * 1e-4 * n + 0.4)) * 0.3
    sig = (sig + (rng.normal(size=len(sig)) + 1j * rng.normal(size=len(sig))) * 0.01)
    sig = sig.astype(np.complex64)
    C, T = 2, 1 << 16
    demod = ChannelDemodulator(cfg, channels=C, block_len=T, device="cpu")
    dec = StreamDecoder(DecoderConfig(mode="lrit", frames_per_block=2), device="cpu")
    got = []
    with torch.inference_mode():
        state = demod.init_state()
        for b in range(len(sig) // T):
            x = np.tile(sig[b * T:(b + 1) * T], (C, 1))
            soft, valid, state = demod.process(x, state)
            for batch in dec.push(soft[0][valid[0]].numpy()):
                got.extend(batch.vcdu[batch.frame_ok].numpy())
        for batch in dec.flush():
            got.extend(batch.vcdu[batch.frame_ok].numpy())
    return got, vcdus


@pytest.mark.parametrize("forms", [dict(clock_block_update=16),
                                   dict(frontend_block_update=8)],
                         ids=["k16_chain", "frontend_k8_chain"])
def test_chain_decodes_bit_exact(forms):
    """`test_k16_chain_decodes_bit_exact` and
    `test_frontend_k8_chain_decodes_bit_exact` of the JAX package, at 4
    frames where those send 6 (the port's plain loops step per sample in
    Python): the acquisition may lose two leading frames, every decoded
    frame is a transmitted VCDU bit for bit."""
    got, vcdus = _chain(DemodConfig.lrit(sample_rate=1_250_000, **forms), 3, 4)
    assert len(got) >= len(vcdus) - 2
    sent = {bytes(v) for v in vcdus}
    assert all(bytes(v) in sent for v in got)


# --------------------------------------------------------------------------
# the receiver's ring type, and the configs between the packages
# --------------------------------------------------------------------------

def _frames(batch, ok):
    keep = (batch.frame_ok & ok).numpy()
    return [(int(c), bytes(v)) for c, v in zip(batch.counter.numpy()[keep],
                                                 batch.vcdu.numpy()[keep])]


def test_receiver_bf16_ring_delivers_the_f32_frames():
    """The decode half of `FusedReceiver` on the same soft symbols (coded
    frames with noise, as the demod half hands them over), once with a
    float32 ring and once with a bfloat16 one: the same frames, and the bf16
    ring holds the symbols rounded to bf16."""
    rng = np.random.default_rng(21)
    C, nframes = 2, 4
    syms = []
    for c in range(C):
        v = tx.make_vcdus(nframes, scid=13, vcid=c + 1, counter0=10 * c,
                          rng=np.random.default_rng(40 + c))
        s = tx.encode_stream(v, lrit=True, noise=0.5, rng=np.random.default_rng(60 + c))
        syms.append(np.concatenate([rng.normal(0, 0.3, 777 * (c + 1)), s]).astype(np.float32))
    n = min(len(s) for s in syms)
    soft_all = np.stack([s[:n] for s in syms])
    cfg = DemodConfig.lrit()
    out = {}
    for dtype in ("float32", "bfloat16"):
        rx = FusedReceiver(cfg, DecoderConfig(mode="lrit"), channels=C, block_len=1 << 16,
                           ring_dtype=dtype, device="cpu")
        st = rx.init_state()
        S = rx._demod.num_slots
        frames = []
        with torch.inference_mode():
            for b in range(0, n - S, S):
                soft = torch.from_numpy(soft_all[:, b:b + S].copy())
                valid = torch.ones_like(soft, dtype=torch.bool)
                batch, ok, _, st = rx._after_demod((soft, valid, st.demod), st)
                frames += _frames(batch, ok)
        assert st.ring.dtype == getattr(torch, dtype)
        out[dtype] = frames
    assert len(out["float32"]) >= C * (nframes - 2)
    assert out["bfloat16"] == out["float32"]
    with pytest.raises(ValueError):
        FusedReceiver(cfg, DecoderConfig(), channels=2, ring_dtype="float16", device="cpu")


def test_demod_config_from_the_jax_package():
    j = JDemodConfig.hrit(sample_rate=2_000_000, clock_block_update=16,
                          frontend_block_update=8, frontend_precision="bf16",
                          clock_interp="sinc", frontend_kernel="split", clock_tile=256)
    t = convert.demod_config_from(j)
    assert t == DemodConfig.hrit(sample_rate=2_000_000, clock_block_update=16,
                                 frontend_block_update=8, frontend_precision="bf16",
                                 clock_interp="sinc", frontend_kernel="split")
    assert convert.demod_config_from(dataclasses.asdict(j)) == t
