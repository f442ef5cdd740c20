"""`FoldedCaptureReceiver` (`xritdemod_tpu_torch/parallel/timeblocks.py`) and
`cli reprocess` held against the JAX package's on the CPU.

One capture (4 LRIT frames at 600 ksps, sps ~2.04, from the port's `tx.py`)
is reprocessed at 2 folds and 131072 / 4 = 32768 samples a block by:

- the JAX package's `cli reprocess`, its `FoldedCaptureReceiver.process`
  spied for the frame list (the reference's default CPU path, non-fused);
- the port's `cli reprocess --device cpu`, spied the same way (the
  non-fused path: `block_batch` over the folds, a `StreamDecoder` per fold);
- the port's fused path (`use_fused=True`: one `FusedReceiver(channels=2)`
  on the CPU, with the plain versions of the kernels).

Both frame lists and the channel file's bytes must equal the reference's,
bit for bit, and every transmitted frame must be there.  The plain chains
loop per sample in Python (~0.3 ms a sample at 2 channels), so this file
runs ~3 minutes of plain loops and the reference's eager batch path.

Over one coded-frame span after each fold's last real sample (past the
capture's end, or in the first flush step) the port's folds see seeded noise
where the reference's see zeros (a sync marker followed by zeros decodes as
a good frame in both packages: the last tests here pin that); on this
capture the two give the same frames.
"""

import numpy as np
import pytest
import torch

from xritdemod_tpu import cli as jcli
from xritdemod_tpu.parallel import timeblocks as jtimeblocks
from xritdemod_tpu_torch import cli, tx
from xritdemod_tpu_torch.models.demodulator import DemodConfig
from xritdemod_tpu_torch.parallel import timeblocks
from xritdemod_tpu_torch.parallel.timeblocks import FoldedCaptureReceiver

RATE, FOLDS, BLOCK, NFRAMES, VCID = 600_000, 2, 1 << 15, 4, 9


def _spied(mp, cls):
    """Record what `cls.process` returns."""
    got = []
    process = cls.process

    def spy(self, x):
        out = process(self, x)
        got.append(out)
        return out

    mp.setattr(cls, "process", spy)
    return got


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reprocess")
    cfg = DemodConfig.lrit(sample_rate=RATE)
    vcdus = tx.make_vcdus(NFRAMES, scid=13, vcid=VCID, rng=np.random.default_rng(81))
    symbols = tx.encode_stream(vcdus, lrit=True, amp=1.0, rng=np.random.default_rng(82))
    sig = tx.modulate(symbols, cfg, np.random.default_rng(83), freq_offset=1e-4, noise=0.02)
    cap = tmp / "cap.c64"
    sig.tofile(cap)
    cfgfile = tmp / "xritdemod.cfg"
    cfgfile.write_text(f"mode=lrit\nsampleRate={RATE}\ndecimation=1\n")
    args = ["reprocess", str(cap), "--config", str(cfgfile), "--folds", str(FOLDS),
            "--block-len", str(BLOCK)]
    with pytest.MonkeyPatch.context() as mp:
        jframes = _spied(mp, jtimeblocks.FoldedCaptureReceiver)
        assert jcli.main(args + ["--out", str(tmp / "jax")]) == 0
        tframes = _spied(mp, timeblocks.FoldedCaptureReceiver)
        with torch.inference_mode():
            assert cli.main(args + ["--out", str(tmp / "port"), "--device", "cpu"]) == 0

    # The fused path, each step's outputs copied as they come out.
    fused = FoldedCaptureReceiver(cfg, folds=FOLDS, block_len=BLOCK, use_fused=True,
                                  device="cpu")
    rx = fused._get_rx()
    step, copies = rx.step, []

    def copying_step(x, st):
        out = step(x, st)
        b = out[0]
        copies.append([a.clone() for a in (b.frame_ok, b.scid, b.vcid, b.counter, b.vcdu)])
        return out

    rx.step = copying_step
    with torch.inference_mode():
        fframes = fused.process(sig)
    return dict(vcdus=vcdus, tmp=tmp, jax=jframes[0], port=tframes[0], fused=fframes,
                copies=copies, timings=fused.last_timings, starts=fused._fold_starts(len(sig)))


def test_every_frame_recovered_by_the_reference(run):
    """The capture itself: the reference recovers all frames in order."""
    assert [(v, c, b) for _, v, c, b in run["jax"]] == [
        (VCID, i, bytes(v)) for i, v in enumerate(run["vcdus"])]


def test_non_fused_frames_are_the_reference(run):
    assert run["port"] == run["jax"]


def test_fused_frames_are_the_reference(run):
    assert run["fused"] == run["jax"]


def test_fused_results_outlive_later_steps(run):
    """The frames read from the stacked per-block results at the end equal
    those of copies taken right after each step: no saved result aliases
    state that a later step overwrites."""
    per_fold = [[] for _ in range(FOLDS)]
    for okh, scid, vcid, ctr, vcdu in run["copies"]:
        for f, k in zip(*np.nonzero(okh.numpy())):
            per_fold[f].append((int(scid[f, k]), int(vcid[f, k]), int(ctr[f, k]),
                                bytes(vcdu[f, k].numpy())))
    assert FoldedCaptureReceiver._dedup(per_fold) == run["fused"]
    nblocks = run["starts"][1]
    assert len(run["copies"]) == nblocks + 2          # + the two flush steps
    t = run["timings"]
    assert t["blocks"] == nblocks and t["wire"] == "f32"
    assert set(t) == {"assemble_s", "stream_and_pull_s", "blocks", "wire"}


def test_channel_file_is_the_reference(run):
    want = (run["tmp"] / "jax" / f"channel_{VCID}.bin").read_bytes()
    got = (run["tmp"] / "port" / f"channel_{VCID}.bin").read_bytes()
    assert got == want == b"".join(bytes(v) for v in run["vcdus"])
    assert sorted(p.name for p in (run["tmp"] / "port").iterdir()) == sorted(
        p.name for p in (run["tmp"] / "jax").iterdir())


def test_reprocess_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cap = tmp_path / "cap.c64"
    np.zeros(16, np.complex64).tofile(cap)
    with pytest.raises(SystemExit):
        cli.main(["reprocess", str(cap), "--config", str(tmp_path / "x.cfg")])


@pytest.mark.parametrize("mode", ["lrit", "hrit"])
def test_a_marker_then_zeros_decodes_as_a_good_frame_in_both_packages(mode):
    """Why the folds see noise, not zeros, just after their last real sample:
    a coded frame of a sync marker and zeros passes sync and RS in both
    packages (the all-PN frame: scid 253, vcid 8, counter 966810), so a fold
    whose stream stopped just after a marker would deliver it.  With noise in
    place of the zeros the frame fails."""
    from xritdemod_tpu.models.decoder import CaduDecoder as JCaduDecoder
    from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
    from xritdemod_tpu_torch.models.decoder import CaduDecoder, DecoderConfig

    v = tx.make_vcdus(1, rng=np.random.default_rng(84))
    marker = tx.encode_stream(v, lrit=mode == "lrit", amp=1.0)[:64]
    frames = np.zeros((2, 16384), np.float32)
    frames[:, :64] = marker
    frames[1, 64:] = np.random.default_rng(85).standard_normal(16384 - 64)
    tails = np.zeros((2, 64), np.float32)
    with torch.inference_mode():
        batch, _ = CaduDecoder(DecoderConfig(mode=mode), device="cpu").decode_frames(
            torch.from_numpy(frames), torch.from_numpy(tails))
    jbatch, _ = JCaduDecoder(JDecoderConfig(mode=mode))._decode_frames(frames, tails)
    for f in ("frame_ok", "sync_ok", "scid", "vcid", "counter", "rs_errors", "vcdu"):
        np.testing.assert_array_equal(getattr(batch, f).numpy(), np.asarray(getattr(jbatch, f)))
    assert batch.frame_ok.tolist() == [True, False]
    assert (int(batch.scid[0]), int(batch.vcid[0]), int(batch.counter[0])) == (253, 8, 966810)


@pytest.mark.parametrize("width", [1, 2])
def test_noise_past_the_end_and_in_the_flush(width):
    """`_block` is `_fold_block` up to each fold's last real sample (the
    capture's end, or the last block before the flush), the seeded noise
    over the coded-frame span after it, and zeros after that."""
    T = 32768
    rx = FoldedCaptureReceiver(DemodConfig.lrit(sample_rate=RATE), folds=3, block_len=T,
                               warmup=2048, device="cpu")
    N = 150_001
    rng = np.random.default_rng(86)
    if width == 1:
        x = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(np.complex64)
        buf, ref = np.zeros((3, T), np.complex64), np.zeros((3, T), np.complex64)
    else:
        x = rng.integers(-127, 128, 2 * N).astype(np.int8)
        buf, ref = np.zeros((3, 2 * T), np.int8), np.zeros((3, 2 * T), np.int8)
    noise = rx._noise(width == 2)
    span = noise.shape[1] // width
    assert span == rx._frame_span and noise.any()
    np.testing.assert_array_equal(noise, rx._noise(width == 2))
    starts, nblocks = rx._fold_starts(N)
    ends = np.minimum(N - starts, nblocks * T)            # fold-relative
    # One fold ends at the capture's end, one at the flush; a span runs out
    # inside the flush.
    assert (ends < nblocks * T).any() and (ends == nblocks * T).any()
    assert (ends + span < (nblocks + 2) * T).all()
    seen = set()
    for j in range(nblocks + 2):
        got = rx._block(x, starts, j, nblocks, buf, noise, width)
        if j < nblocks:
            rx._fold_block(x, starts, j, ref, width)
        else:
            ref[:] = 0
        for f in range(3):
            rel = np.repeat(j * T + np.arange(T), width)          # fold-relative sample
            tail = (rel >= ends[f]) & (rel < ends[f] + span)
            k = width * (rel[tail] - ends[f]) + np.tile(np.arange(width), tail.sum() // width)
            np.testing.assert_array_equal(got[f, tail], noise[f, k])
            np.testing.assert_array_equal(got[f, ~tail], ref[f, ~tail])
            seen |= {("noise", bool(tail.any())), ("zeros", bool((rel >= ends[f] + span).any()))}
    assert {("noise", True), ("zeros", True)} <= seen


def test_long_soak_accounts_for_every_frame():
    from xritdemod_tpu_torch.tools import long_soak

    v = tx.make_vcdus(4, scid=13, vcid=5, rng=np.random.default_rng(87))
    f = lambda c, b=None: (13, 5, c, bytes(v[c]) if b is None else b)
    comp = (63, 58, 3, bytes(255 - v[3]))
    odd = (253, 8, 966810, bytes(892))
    got = long_soak.account([f(0), f(2), comp, f(1, bytes(892)), f(2), odd], v)
    assert got == dict(frames_sent=4, frames_recovered=2, frames_missing=1, missing_counters=[3],
                       payload_mismatches=1, complements=1, unexplained=1,
                       unexplained_frames=[(253, 8, 966810)], duplicates=1,
                       counters_ascending=False)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            long_soak.main(["1"])
