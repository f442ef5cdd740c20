"""The whole slice: the port's `FusedReceiver` against the JAX package's on a
synthesised capture, both on the CPU (JAX with its ring kernels in interpret
mode).  The frame lists — `(vcid, counter, vcdu)` per channel, in order — and
the `ok` / `overflow` flags must be identical; the soft symbols in between
differ by float rounding only, which the FEC absorbs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import frames_of, jnp_tree, make_capture, present, tnp
from xritdemod_tpu.models.decoder import CaduDecoder as JCaduDecoder
from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.receiver import FusedReceiver as JFusedReceiver
from xritdemod_tpu_torch import convert, tx
from xritdemod_tpu_torch.models.decoder import CaduDecoder, DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig
from xritdemod_tpu_torch.models.receiver import FusedReceiver
from xritdemod_tpu_torch.utils.cplx import quantize_iq_s8

CHANNELS, T = 2, 1 << 15


@pytest.fixture(scope="module")
def runs():
    """One capture through both receivers, block by block; keeps per-block
    outputs and the JAX state after every block (as numpy)."""
    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    sig, vcdus = make_capture(cfg, CHANNELS, 3)
    nblocks = sig.shape[1] // T
    jrx = JFusedReceiver(
        JDemodConfig.lrit(sample_rate=1_250_000), JDecoderConfig(mode="lrit"),
        channels=CHANNELS, block_len=T,
    )
    trx = FusedReceiver(cfg, DecoderConfig(mode="lrit"), channels=CHANNELS,
                        block_len=T, device="cpu")
    assert (jrx.k, jrx.ring_len) == (trx.k, trx.ring_len)
    jst, tst = jrx.init_state(), trx.init_state()
    jouts, touts, jstates = [], [], [jnp_tree(jst)]
    for b in range(nblocks):
        x = sig[:, b * T:(b + 1) * T]
        jbatch, jok, jovf, jst = jrx.step(x, jst)
        tbatch, tok, tovf, tst = trx.step(x, tst)
        jouts.append((jnp_tree(jbatch), np.asarray(jok), np.asarray(jovf)))
        touts.append((tbatch, tok.numpy(), tovf.numpy()))
        jstates.append(jnp_tree(jst))
    return dict(sig=sig, vcdus=vcdus, trx=trx, jouts=jouts, touts=touts,
                jstates=jstates, tstate=tst, nblocks=nblocks)


def _frame_lists(outs):
    lists = [[] for _ in range(CHANNELS)]
    for batch, _, _ in outs:
        for c, fr in enumerate(frames_of(batch)):
            lists[c] += fr
    return lists


def test_init_state_agrees(runs):
    trx = runs["trx"]
    ja = jax.tree.leaves(runs["jstates"][0])
    ta = jax.tree.leaves(tnp(trx.init_state()))
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_frame_lists_identical(runs):
    jl, tl = _frame_lists(runs["jouts"]), _frame_lists(runs["touts"])
    assert jl == tl
    for c in range(CHANNELS):
        assert len(tl[c]) >= 2
        for vcid, ctr, vc in tl[c]:
            assert vcid == c + 1
            assert vc == runs["vcdus"][c][ctr - 100 * c].tobytes()


def test_ok_and_overflow_identical(runs):
    for (jb, jok, jovf), (tb, tok, tovf) in zip(runs["jouts"], runs["touts"]):
        np.testing.assert_array_equal(tok, jok)
        np.testing.assert_array_equal(tovf, jovf)
        assert tok.shape == (CHANNELS, 1) and not tovf.any()


def test_batch_fields_identical_on_popped_frames(runs):
    """Every integer/bool FrameBatch field agrees wherever a frame was
    popped; shapes and dtypes agree everywhere."""
    for (jb, jok, _), (tb, tok, _) in zip(runs["jouts"], runs["touts"]):
        for f in present(tb, jb):
            a, b = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
            assert a.shape == b.shape and a.dtype == b.dtype, f
            if f != "vit_errors":       # counts hard decisions of the soft symbols
                np.testing.assert_array_equal(a[tok], b[jok], err_msg=f)


def test_final_state_close(runs):
    """Carried state after the last block: integer parts equal; the ring's
    symbols within the demod tolerance (atol 2e-4) on all but a handful and
    within 5e-3 everywhere (the JAX CPU path runs its scan form of the AGC,
    the port the exact recursion, and the loops carry that difference)."""
    jst, tst = runs["jstates"][-1], tnp(runs["tstate"])
    np.testing.assert_array_equal(tst[2], jst.fill)
    np.testing.assert_array_equal(tst[3], jst.locked)
    assert tst[3].all()
    jring = np.asarray(jst.ring, np.float32)
    np.testing.assert_allclose(tst[1], jring, atol=5e-3)
    assert np.mean(np.abs(tst[1] - jring) > 2e-4) < 1e-3
    np.testing.assert_array_equal(tst[0][4][2], jst.demod.clock.ii)


def test_mid_stream_start_from_jax_state(runs):
    """The port started from the JAX receiver's state after block 1 returns
    the same frames for the remaining blocks."""
    trx, sig = runs["trx"], runs["sig"]
    start = 2
    st = convert.rx_state_from_numpy(runs["jstates"][start], "cpu")
    outs = []
    for b in range(start, runs["nblocks"]):
        batch, ok, ovf, st = trx.step(sig[:, b * T:(b + 1) * T], st)
        outs.append((batch, ok.numpy(), ovf.numpy()))
        np.testing.assert_array_equal(ok.numpy(), runs["jouts"][b][1])
    assert _frame_lists(outs) == _frame_lists(runs["jouts"][start:])
    assert sum(len(l) for l in _frame_lists(outs)) >= CHANNELS


def test_step_int8_matches_step_on_dequantized():
    """`step_int8` is `step` on the dequantized wire block."""
    cfg = DemodConfig.lrit()
    sig, _ = make_capture(cfg, 2, 1)
    Ts = 4096
    rx = FusedReceiver(cfg, DecoderConfig(), channels=2, block_len=Ts,
                       ring_len=2 * 16384 + 2048, device="cpu")
    q = quantize_iq_s8(sig[:, :Ts] * 2.0)
    deq = q[:, 0::2].astype(np.float32) / 127.0 + 1j * (q[:, 1::2].astype(np.float32) / 127.0)
    a = rx.step_int8(q, rx.init_state())
    b = rx.step(deq.astype(np.complex64), rx.init_state())
    np.testing.assert_allclose(a[3].ring.numpy(), b[3].ring.numpy(), atol=1e-6)
    np.testing.assert_array_equal(a[3].fill.numpy(), b[3].fill.numpy())
    assert int(a[3].fill.min()) > 900 and not a[1].any()


def test_hrit_decode_only():
    """HRIT, decode half only: a noisy symbol stream framed on the host,
    decoded in two chained calls by both packages."""
    v = tx.make_vcdus(4, vcid=5, counter0=40, rng=np.random.default_rng(7))
    soft = tx.encode_stream(v, lrit=False, noise=0.6, rng=np.random.default_rng(8))
    frames = soft.reshape(4, 16384)
    tdec = CaduDecoder(DecoderConfig(mode="hrit"), device="cpu")
    jdec = JCaduDecoder(JDecoderConfig(mode="hrit"))
    ttail = torch.zeros((2, 64))
    jtail = jnp.zeros((2, 64), jnp.float32)
    for half in (frames[0::2], frames[1::2]):      # two streams of two frames
        tb, ttail = tdec.decode_frames(half, ttail)
        jb, jtail = jdec.decode_frames(jnp.asarray(half), jtail)
        for f in present(tb, jb):
            np.testing.assert_array_equal(
                getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)
        np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))
    assert tb.frame_ok.all()


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        FusedReceiver(DemodConfig.lrit(), DecoderConfig(), channels=2, block_len=4096)


def test_ring_sizing_rule():
    rx = FusedReceiver(DemodConfig.lrit(), DecoderConfig(), channels=2,
                       block_len=1 << 17, device="cpu")
    assert rx.k == 2 and rx.ring_len % 128 == 0
    assert rx.ring_len >= 2 * 16384 + rx._demod.num_slots
    with pytest.raises(ValueError):
        FusedReceiver(DemodConfig.lrit(), DecoderConfig(), channels=2,
                      block_len=1 << 17, ring_len=4096, device="cpu")
