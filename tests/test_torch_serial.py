"""The serial demodulator (`init_state` / `process`) and the SNR tap
(`snr_estimate`) of the port, held against the JAX package's on the CPU.

The same numpy captures (the port's `tx.py`, from seeds) go through the JAX
package's `Demodulator.process` and the port's, two chained blocks, the
second from the JAX package's state carried over by `convert`: LRIT and HRIT
at decimation 1, LRIT at decimation 2 (the decimating FIR, which the KAT
does not reach), and LRIT with the sinc interpolator.  The port runs the
exact AGC where the reference's `process` runs the associative-scan form;
they agree to ~1e-6 relative, and the loops after the AGC carry that into
soft symbols equal within atol 5e-4 (measured below 1e-4) with equal symbol
counts.  The SNR estimate agrees within 1e-3 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jnp_tree, tnp
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.demodulator import Demodulator as JDemodulator
from xritdemod_tpu_torch import convert, tx
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator

# name: (port config, JAX config, capture rate, LRIT?, block_len)
CASES = {
    "lrit": (DemodConfig.lrit(), JDemodConfig.lrit(), 1_250_000, True, 2048),
    "hrit": (DemodConfig.hrit(), JDemodConfig.hrit(), 3_000_000, False, 2048),
    "lrit_decimation_2": (DemodConfig.lrit(sample_rate=2_500_000, decimation=2),
                          JDemodConfig.lrit(sample_rate=2_500_000, decimation=2),
                          2_500_000, True, 4096),
    "lrit_sinc": (DemodConfig.lrit(clock_interp="sinc"), JDemodConfig.lrit(clock_interp="sinc"),
                  1_250_000, True, 2048),
}


def _capture(rate, lrit, n, seed):
    cfg = DemodConfig.lrit(sample_rate=rate) if lrit else DemodConfig.hrit(sample_rate=rate)
    v = tx.make_vcdus(1, rng=np.random.default_rng(seed))
    sym = tx.encode_stream(v, lrit=lrit, rng=np.random.default_rng(seed + 1))
    iq = tx.modulate(sym, cfg, np.random.default_rng(seed + 2), freq_offset=2e-4,
                     phase=0.7, amp=0.4, noise=0.04)
    return iq[:n]


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    cfg, jcfg, rate, lrit, T = CASES[request.param]
    x = _capture(rate, lrit, 2 * T, seed=len(request.param))
    jd, td = JDemodulator(jcfg, T), Demodulator(cfg, T, device="cpu")
    jst0 = jd.init_state()
    jsoft0, jv0, jst1 = jd.process(x[:T], jst0)
    jsoft1, jv1, _ = jd.process(x[T:], jst1)
    tst0 = td.init_state()
    tsoft0, tv0, tst1 = td.process(x[:T], tst0)
    mid = convert.demod_state_from_numpy(jnp_tree(jst1), "cpu")
    mid_before = tnp(mid)
    tsnr = td.snr_estimate(x[T:], mid)
    tsoft1, tv1, _ = td.process(x[T:], mid)
    return dict(
        name=request.param, x=x, T=T, jd=jd, td=td, jst=(jst0, jst1), tst=(tst0, tst1),
        j=((jsoft0, jv0), (jsoft1, jv1)), t=((tsoft0, tv0), (tsoft1, tv1)),
        mid=mid, mid_before=mid_before, tsnr=tsnr, jsnr=jd.snr_estimate(x[T:], jst1),
    )


def _leaves(a):
    if isinstance(a, (tuple, list)):
        return [y for b in a for y in _leaves(b)]
    return [np.asarray(a)]


def test_state_has_the_reference_shapes(run):
    """`init_state` equals the JAX package's (values, shapes, dtypes), and
    the state after a block has its shapes: unbatched, scalar gain, mu,
    omega, ii, phase and freq."""
    for got, want in ((run["tst"][0], run["jst"][0]), (run["tst"][1], run["jst"][1])):
        g, w = _leaves(tnp(got)), _leaves(jnp_tree(want))
        assert [a.shape for a in g] == [b.shape for b in w]
        assert [a.dtype for a in g] == [b.dtype for b in w]
    for a, b in zip(_leaves(tnp(run["tst"][0])), _leaves(jnp_tree(run["jst"][0]))):
        np.testing.assert_array_equal(a, b)
    assert run["tst"][1].agc_gain.shape == () and run["tst"][1].clock.ii.shape == ()


def test_soft_symbols_match_over_two_blocks(run):
    """Both blocks, the second from the JAX state carried over: equal valid
    masks (so equal symbol counts, about one per `sps` samples), soft
    symbols within atol 5e-4.  (The loops are still pulling in over these
    short blocks; the KAT holds a locked stream.)"""
    for (ts, tv), (js, jv) in zip(run["t"], run["j"]):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=5e-4)
    ts, tv = run["t"][1]
    assert tv.numpy().sum() > run["T"] / run["td"].config.decimation / run["td"].config.sps - 8


def test_carried_state_after_the_first_block(run):
    """The port's own state after block 0 against the JAX package's: gain
    rtol 1e-5, histories 1e-5, phase 1e-4, freq 1e-5, ii exact, mu 2e-3."""
    t, j = run["tst"][1], jnp_tree(run["jst"][1])
    np.testing.assert_allclose(t.agc_gain.numpy(), j.agc_gain, rtol=1e-5)
    np.testing.assert_allclose(t.rrc_hist.re.numpy(), j.rrc_hist.re, atol=1e-5)
    np.testing.assert_allclose(t.dec_hist.re.numpy(), j.dec_hist.re, atol=1e-5)
    np.testing.assert_allclose(t.costas.phase.numpy(), j.costas.phase, atol=1e-4)
    np.testing.assert_allclose(t.costas.freq.numpy(), j.costas.freq, atol=1e-5)
    assert int(t.clock.ii) == int(j.clock.ii)
    np.testing.assert_allclose(t.clock.mu.numpy(), j.clock.mu, atol=2e-3)


def test_snr_estimate(run):
    """`snr_estimate` within 1e-3 dB of the JAX package's on the same block
    and state, a 0-d result, and the state untouched."""
    assert run["tsnr"].shape == ()
    np.testing.assert_allclose(float(run["tsnr"]), float(run["jsnr"]), atol=1e-3)
    assert float(run["tsnr"]) > 3.0
    for a, b in zip(_leaves(tnp(run["mid"])), _leaves(run["mid_before"])):
        np.testing.assert_array_equal(a, b)


def test_snr_estimate_batched():
    """`snr_estimate` of a `(C, T)` block with `(C,)`-leading state is the
    per-channel serial estimate, channel for channel (atol 1e-4 dB)."""
    cfg, _, rate, lrit, T = CASES["lrit"]
    td = Demodulator(cfg, T, device="cpu")
    x = np.stack([_capture(rate, lrit, T, seed=s) for s in (1, 2)])
    batch = td.snr_estimate(x, td.init_state_batch(2))
    one = [float(td.snr_estimate(x[c], td.init_state())) for c in range(2)]
    assert batch.shape == (2,)
    np.testing.assert_allclose(batch.numpy(), one, atol=1e-4)


def test_process_rejects_a_wrong_block():
    td = Demodulator(DemodConfig.lrit(), 2048, device="cpu")
    with pytest.raises(ValueError):
        td.process(np.zeros(1000, np.complex64), td.init_state())
