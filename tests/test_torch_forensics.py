"""The decoder's last pieces, held against the JAX package bit for bit on the
CPU: the forensics fields of `FrameBatch` (`DecoderConfig.forensics`) and
`CaduDecoder.decode_multi`.

Same numpy soft symbols through both, the port's plain Viterbi on one side
and the JAX ops on the other.  Everything downstream of the symbols is
integer or sign logic (and the int8 wire form `clip(frames * 127, -128,
127)` of the phase-fixed frames), so every comparison is exact.  Frames come
from the port's `tx.py` from seeds, in three Reed-Solomon regimes: clean,
a few corrections, uncorrectable.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import present
from xritdemod_tpu.models.decoder import CaduDecoder as JCaduDecoder
from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch import convert, tx
from xritdemod_tpu_torch.models.decoder import CaduDecoder, DecoderConfig, StreamDecoder

CODED = C.CODED_FRAME_SIZE
FORENSICS = ("coded", "vit_frame", "rs_frame")


def _frames(mode, regime, n=4, seed=0):
    """`(n, 16384)` consecutive aligned soft frames of one stream (frame 1
    flipped 180 degrees, which LRIT's phase fix undoes) in a Reed-Solomon
    regime, and the VCDUs sent."""
    rng = np.random.default_rng(seed)
    v = tx.make_vcdus(n, vcid=3, counter0=11, rng=rng)
    noise = 0.3 if regime == "clean" else 0.6
    s = tx.encode_stream(v, lrit=mode == "lrit", noise=noise,
                         rng=np.random.default_rng(seed + 1)).reshape(n, CODED).copy()
    if mode == "lrit":
        s[1] = -s[1]
    if regime == "few":
        s[2, 3000:3300] = rng.normal(0, 1, 300)
    if regime == "uncorrectable":
        s[2] = rng.normal(0, 1, CODED)
        s[3, 5000:9000] = rng.normal(0, 1, 4000)
    return s.astype(np.float32), v


def _check_regime(batch, regime):
    rs = batch.rs_errors.numpy().reshape(-1, 4)
    if regime == "clean":
        assert (rs == 0).all()
    if regime == "few":
        assert rs.max() > 0 and rs.min() >= 0
    if regime == "uncorrectable":
        assert (rs == -1).any() and (rs == 0).any()


def _same(tb, jb, stack=None):
    """Every field present in both, equal in dtype, shape and value."""
    for f in present(tb, jb):
        a = getattr(tb, f).numpy()
        b = np.asarray(getattr(jb, f)) if stack is None else np.stack(
            [getattr(x, f).numpy() for x in stack], axis=1)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("regime", ["clean", "few", "uncorrectable"])
@pytest.mark.parametrize("mode", ["lrit", "hrit"])
def test_decode_frames_with_forensics(mode, regime):
    """`decode_frames(forensics=True)`: all 14 fields bit-identical to the
    JAX package's, the forensics ones of the right dtype and shape; without
    `forensics` the same 11 fields and None for the other three."""
    frames, _ = _frames(mode, regime, seed=7)
    tails = np.random.default_rng(3).normal(0, 0.5, (4, 64)).astype(np.float32)
    dec = CaduDecoder(DecoderConfig(mode=mode, forensics=True), device="cpu")
    tb, tt = dec.decode_frames(frames, tails)
    jb, jt = JCaduDecoder(JDecoderConfig(mode=mode, forensics=True)).decode_frames(
        jnp.asarray(frames), jnp.asarray(tails))
    assert present(tb, jb) == list(tb._fields)
    _same(tb, jb)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tb.coded.dtype == torch.int8 and tb.coded.shape == (4, CODED)
    assert tb.vit_frame.dtype == torch.uint8 and tb.vit_frame.shape == (4, 1024)
    assert tb.rs_frame.dtype == torch.uint8 and tb.rs_frame.shape == (4, 1020)
    _check_regime(tb, regime)
    plain, _ = CaduDecoder(DecoderConfig(mode=mode), device="cpu").decode_frames(frames, tails)
    assert all(getattr(plain, f) is None for f in FORENSICS)
    for f in present(plain):
        assert torch.equal(getattr(plain, f), getattr(tb, f)), f


@pytest.mark.parametrize("regime", ["clean", "few", "uncorrectable"])
@pytest.mark.parametrize("mode", ["lrit", "hrit"])
def test_decode_block_with_forensics(mode, regime):
    """`decode_block(forensics=True)` on four consecutive frames of one
    stream: every field bit-identical to the JAX package's, and the tail."""
    frames, _ = _frames(mode, regime, seed=11)
    dec = CaduDecoder(DecoderConfig(mode=mode, forensics=True), device="cpu")
    tb, tt = dec.decode_block(frames.reshape(-1), dec.init_tail())
    jdec = JCaduDecoder(JDecoderConfig(mode=mode, frames_per_block=4, forensics=True))
    jb, jt = jdec.decode_block(jnp.asarray(frames.reshape(-1)), jdec.init_tail())
    assert present(tb, jb) == list(tb._fields)
    _same(tb, jb)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _check_regime(tb, regime)


@pytest.mark.parametrize("forensics", [False, True])
def test_decode_multi(forensics):
    """`decode_multi` at (B, F) = (3, 4), tails chained inside each stream:
    field for field equal to the JAX package's `decode_multi` and to F
    sequential `decode_frames` calls of the port, with the per-frame tails
    and the last one equal to the sequence's carried tail.  The three
    streams are in the three RS regimes."""
    B, F = 3, 4
    frames = np.stack([_frames("lrit", r, n=F, seed=20 + b)[0]
                       for b, r in enumerate(("clean", "few", "uncorrectable"))])
    tails = np.random.default_rng(5).normal(0, 0.5, (B, 64)).astype(np.float32)
    dec = CaduDecoder(DecoderConfig(forensics=forensics), device="cpu")
    mb, mt = dec.decode_multi(frames, tails)
    assert mb.vcdu.shape == (B, F, C.VCDU_SIZE) and mt.shape == (B, F, 64)
    jb, jt = JCaduDecoder(JDecoderConfig(forensics=forensics))._decode_multi(
        jnp.asarray(frames), jnp.asarray(tails))
    assert present(mb, jb) == [f for f in mb._fields if forensics or f not in FORENSICS]
    _same(mb, jb)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(jt))
    t = torch.from_numpy(tails)
    seq = []
    for f in range(F):
        b1, t = dec.decode_frames(frames[:, f], t)
        seq.append(b1)
    _same(mb, None, stack=seq)
    np.testing.assert_array_equal(mt[:, -1].numpy(), t.numpy())
    rs = mb.rs_errors.numpy()
    assert (rs[0] == 0).all() and rs[1].max() > 0 and (rs[2] == -1).any()
    with pytest.raises(ValueError):
        dec.decode_multi(frames[0], tails)


def test_stream_decoder_carries_forensics():
    """A `StreamDecoder` built from the JAX package's config with
    `forensics=True` (through `convert.decoder_config_from`) emits batches
    whose forensics fields equal the JAX StreamDecoder's, bit for bit."""
    from xritdemod_tpu.models.decoder import StreamDecoder as JStreamDecoder

    v = tx.make_vcdus(3, vcid=4, rng=np.random.default_rng(30))
    soft = tx.encode_stream(v, noise=0.5, lead=700, rng=np.random.default_rng(31))
    jcfg = JDecoderConfig(frames_per_block=2, forensics=True)
    cfg = convert.decoder_config_from(jcfg)
    assert cfg == DecoderConfig(frames_per_block=2, forensics=True)
    sd, jsd = StreamDecoder(cfg, device="cpu"), JStreamDecoder(jcfg)
    tbs = sd.push(soft) + sd.flush()
    jbs = jsd.push(soft) + jsd.flush()
    assert [b.vcdu.shape[0] for b in tbs] == [np.asarray(b.vcdu).shape[0] for b in jbs]
    for tb, jb in zip(tbs, jbs):
        assert present(tb, jb) == list(tb._fields)
        _same(tb, jb)
    assert sum(int(b.frame_ok.sum()) for b in tbs) == 3


def test_fused_receiver_frame_lists_carry_forensics():
    """`FusedReceiver` with `forensics=True` stacks the three fields into
    its `(C, k)` frame lists like the others: the same frames, every other
    field equal to a run without forensics, the three of the right shapes,
    and each decoded frame's `rs_frame` starting with its VCDU.  Soft
    symbols go straight into the step's ring (`_after_demod`), two channels
    of two LRIT frames."""
    from xritdemod_tpu_torch.models.demodulator import DemodConfig
    from xritdemod_tpu_torch.models.receiver import FusedReceiver

    soft = np.stack([_frames("lrit", "clean", n=2, seed=40 + c)[0].reshape(-1)
                     for c in range(2)])
    outs = []
    for forensics in (False, True):
        rx = FusedReceiver(DemodConfig.lrit(), DecoderConfig(forensics=forensics),
                           channels=2, device="cpu")
        st = rx.init_state()
        valid = torch.ones(soft.shape, dtype=torch.bool)
        outs.append(rx._after_demod((torch.from_numpy(soft), valid, st.demod), st)[:2])
    (plain, pok), (tb, tok) = outs
    assert torch.equal(pok, tok) and int(tok.sum()) >= 2
    assert all(getattr(plain, f) is None for f in FORENSICS)
    for f in present(plain):
        assert torch.equal(getattr(plain, f), getattr(tb, f)), f
    k = tok.shape[1]
    assert tb.coded.shape == (2, k, CODED) and tb.vit_frame.shape == (2, k, 1024)
    assert tb.rs_frame.shape == (2, k, 1020)
    for c, i in zip(*np.nonzero(tok.numpy() & tb.frame_ok.numpy())):
        np.testing.assert_array_equal(tb.rs_frame[c, i, : C.VCDU_SIZE].numpy(),
                                      tb.vcdu[c, i].numpy())
