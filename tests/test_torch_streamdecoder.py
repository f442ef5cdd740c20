"""`CaduDecoder.decode_block` and the host `StreamDecoder` of the PyTorch port
held against the JAX package's, bit for bit, on the CPU.

The same int8 / float symbol streams (made by the port's `tx.py` from a
seed) go through both.  Everything downstream of the symbols is integer or
sign logic, so every `FrameBatch` field, the carried tail and the stream
statistics are compared exactly.  Sizes are small (`frames_per_block` 2, a
few frames): the port's plain Viterbi loops 8 224 steps in Python per call.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import present
from xritdemod_tpu.models.decoder import CaduDecoder as JCaduDecoder
from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
from xritdemod_tpu.models.decoder import StreamDecoder as JStreamDecoder
from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch import convert, tx
from xritdemod_tpu_torch.models.decoder import CaduDecoder, DecoderConfig, StreamDecoder

CODED = C.CODED_FRAME_SIZE


def _same_batch(tb, jb):
    for f in present(tb, jb):
        a, b = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("mode", ["lrit", "hrit"])
@pytest.mark.parametrize("B", [1, 3])
def test_decode_block_every_field(rng, mode, B):
    """B consecutive frames of one stream and one carried tail: frame 1 is
    flipped by 180 degrees, frame 2 carries a burst that Reed-Solomon has to
    repair."""
    v = tx.make_vcdus(B, vcid=11, counter0=7, rng=rng)
    soft = tx.encode_stream(v, lrit=mode == "lrit", noise=0.6, rng=np.random.default_rng(3))
    if B > 1:
        soft[CODED:2 * CODED] *= -1.0
        soft[2 * CODED + 3000:2 * CODED + 3500] = rng.normal(0, 1, 500)
    tail = rng.normal(0, 0.5, 64).astype(np.float32)
    tb, ttail = CaduDecoder(DecoderConfig(mode=mode), device="cpu").decode_block(soft, tail)
    jb, jtail = JCaduDecoder(JDecoderConfig(mode=mode, frames_per_block=B)).decode_block(
        jnp.asarray(soft), jnp.asarray(tail))
    _same_batch(tb, jb)
    np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))
    assert tb.vcdu.shape == (B, C.VCDU_SIZE) and tb.frame_ok.all()
    np.testing.assert_array_equal(tb.vcdu.numpy(), v)
    if B > 1:
        assert (tb.rs_errors.numpy()[2] > 0).any()
        if mode == "lrit":
            assert tb.word.numpy()[1] % 2 == 1        # the flipped frame's sync word


def test_decode_block_chains_like_decode_frames(rng):
    """A block of two frames equals two `decode_frames` calls chained by the
    tail: each frame's history is the frame before it."""
    v = tx.make_vcdus(2, rng=rng)
    soft = tx.encode_stream(v, noise=0.5, rng=np.random.default_rng(4))
    dec = CaduDecoder(DecoderConfig(), device="cpu")
    tail = dec.init_tail()
    block, btail = dec.decode_block(soft, tail)
    one, t1 = dec.decode_frames(soft[None, :CODED], tail[None])
    two, t2 = dec.decode_frames(soft[None, CODED:], t1)
    for f in present(block):
        np.testing.assert_array_equal(
            getattr(block, f).numpy(),
            np.concatenate([getattr(one, f).numpy(), getattr(two, f).numpy()]), err_msg=f)
    np.testing.assert_array_equal(btail.numpy(), t2[0].numpy())


def test_decode_block_rejects_a_partial_frame():
    dec = CaduDecoder(DecoderConfig(), device="cpu")
    for n in (0, CODED - 1, CODED + 5):
        with pytest.raises(ValueError):
            dec.decode_block(np.zeros(n, np.float32), dec.init_tail())


def _wire_stream(mode, frames=7, cut=5000, burst_frame=3, seed=21):
    """An int8 symbol stream as the demodulator sends it: `frames` CADUs, the
    first `cut` symbols missing (the decoder connects mid-frame), and (unless
    `burst_frame` is None) a burst of noise over the head of one frame that
    wipes out its sync marker and forces a re-acquisition."""
    rng = np.random.default_rng(seed)
    v = tx.make_vcdus(frames, vcid=5, counter0=300, rng=rng)
    soft = tx.encode_stream(v, lrit=mode == "lrit", amp=0.5, noise=0.25, rng=rng)
    if burst_frame is not None:
        lo = burst_frame * CODED - 40
        soft[lo:lo + 400] = rng.normal(0, 0.5, 400)
    return tx.soft_to_int8(soft)[cut:], v


def _pushes(stream, sizes):
    """Cut the stream into pushes of the given sizes, cycled to its end."""
    out, at, i = [], 0, 0
    while at < len(stream):
        n = sizes[i % len(sizes)]
        out.append(stream[at:at + n])
        at, i = at + n, i + 1
    return out


# Pushes smaller than a frame, a 16 KB wire chunk, and larger than a frame.
SIZES = [16384, 700, 1, 23000, 4096, 16384, 9000, 40000]


@pytest.fixture(scope="module", params=["lrit", "hrit"])
def streamed(request):
    """One wire stream pushed through both decoders in uneven pieces, then
    flushed; keeps every batch, the statistics and the backlog after each
    push."""
    mode = request.param
    stream, v = _wire_stream(mode)
    tsd = StreamDecoder(DecoderConfig(mode=mode, frames_per_block=2), device="cpu")
    jsd = JStreamDecoder(JDecoderConfig(mode=mode, frames_per_block=2))
    tout, jout, backlog = [], [], []
    for piece in _pushes(stream, SIZES):
        tout += tsd.push(piece)
        jout += jsd.push(piece)
        backlog.append((tsd.buffered, jsd.buffered))
    tout += tsd.flush()
    jout += jsd.flush()
    return dict(mode=mode, v=v, tsd=tsd, jsd=jsd, tout=tout, jout=jout, backlog=backlog)


def test_stream_batches_identical(streamed):
    tout, jout = streamed["tout"], streamed["jout"]
    assert len(tout) == len(jout) >= 4
    for tb, jb in zip(tout, jout):
        _same_batch(tb, jb)
    assert {len(tb.frame_ok) for tb in tout} == {1, 2}     # both batch sizes ran


def test_stream_stats_and_backlog_identical(streamed):
    tsd, jsd = streamed["tsd"], streamed["jsd"]
    assert dataclasses.asdict(tsd.stats) == dataclasses.asdict(jsd.stats)
    assert tsd.stats.resyncs >= 2 and tsd.stats.frames >= 4
    for t, j in streamed["backlog"]:
        assert t == j
    assert tsd.buffered == jsd.buffered < CODED + 64


def test_stream_delivers_what_was_transmitted(streamed):
    v = streamed["v"]
    got = {}
    for tb in streamed["tout"]:
        ok = tb.frame_ok.numpy() & (tb.rs_errors.numpy() >= 0).all(-1)
        for ctr, vc in zip(tb.counter.numpy()[ok], tb.vcdu.numpy()[ok]):
            got[int(ctr)] = vc
    assert len(got) >= 4
    for ctr, vc in got.items():
        np.testing.assert_array_equal(vc, v[ctr - 300])


@pytest.mark.parametrize("mode", ["lrit", "hrit"])
def test_switch_decoders_mid_stream(mode):
    """The JAX decoder takes the first pushes, its host state crosses through
    `convert.stream_decoder_from_numpy`, and the port carries on: together
    they return what the JAX decoder alone returns."""
    stream, _ = _wire_stream(mode, frames=5, burst_frame=None)
    pieces = _pushes(stream, [30000, 5000, 30000])
    cfg = dict(mode=mode, frames_per_block=2)
    whole = JStreamDecoder(JDecoderConfig(**cfg))
    ref = [b for p in pieces for b in whole.push(p)] + whole.flush()

    first = JStreamDecoder(JDecoderConfig(**cfg))
    out = [b for p in pieces[:2] for b in first.push(p)]
    state = dict(
        tail=np.asarray(first._tail), locked=first._locked, verified=first._verified,
        pos=first._pos, buffer=np.concatenate([first._buf] + first._pending),
        stats=(first.stats.frames, first.stats.dropped, first.stats.resyncs),
    )
    second = convert.stream_decoder_from_numpy(state, DecoderConfig(**cfg), "cpu")
    assert second.buffered == first.buffered
    tail = [b for p in pieces[2:] for b in second.push(p)] + second.flush()
    assert len(out) + len(tail) == len(ref) and len(out) >= 1 and len(tail) >= 2
    for jb, rb in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(jb.vcdu), np.asarray(rb.vcdu))
    for tb, rb in zip(tail, ref[len(out):]):
        _same_batch(tb, rb)
    assert dataclasses.asdict(second.stats) == dataclasses.asdict(whole.stats)


def test_sliding_over_noise_keeps_a_read_offset():
    """While no sync is found the decoder steps over the buffer a frame at a
    time without copying it: the buffer object stays, the offset moves, and
    the backlog counts from the offset."""
    sd = StreamDecoder(DecoderConfig(frames_per_block=2), device="cpu")
    noise = np.random.default_rng(9).normal(0, 0.3, 5 * CODED).astype(np.float32)
    # Alternating signs match no 64-symbol sync word anywhere near the threshold.
    noise = (np.abs(noise) * np.where(np.arange(noise.size) % 2, 1.0, -1.0)).astype(np.float32)
    assert sd.push(noise) == []
    buf = sd._buf
    assert sd._off == 4 * CODED and not sd._locked
    assert sd.buffered == CODED
    assert sd.push(np.zeros(10, np.float32)) == []
    assert sd._buf is buf and sd.buffered == CODED + 10
    jsd = JStreamDecoder(JDecoderConfig(frames_per_block=2))
    jsd.push(noise)
    jsd.push(np.zeros(10, np.float32))
    assert jsd.buffered == sd.buffered
    assert dataclasses.asdict(jsd.stats) == dataclasses.asdict(sd.stats)


def test_warm_up_and_default_device():
    sd = StreamDecoder(DecoderConfig(frames_per_block=2), device="cpu")
    assert sd.warm_jit() > 0.0
    assert sd.buffered == 0 and dataclasses.asdict(sd.stats) == dict(
        frames=0, dropped=0, resyncs=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            StreamDecoder(DecoderConfig())
