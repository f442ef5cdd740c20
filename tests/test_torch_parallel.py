"""The port's parallel layer (`xritdemod_tpu_torch/parallel/channels.py`,
`timeblocks.py`) held against the JAX package's on the CPU.

The JAX classes run on the 8 virtual CPU devices of `tests/conftest.py`; the
port's on a mesh of repeated `"cpu"` entries, the counterpart of those
virtual devices.  The same numpy captures (the port's `tx.py`, from seeds)
go to both.  Tolerances, each with its reason:

- channel axis: `valid` equal, soft within 1e-5 of the unsharded batch and of
  the JAX package's `ChannelDemodulator` (the plain chains of the two
  packages agree to ~1e-5 over 8192 samples);
- `ChannelReceiver.decode_block`: every `FrameBatch` field and the tails
  bit-identical to the JAX package's vmapped one-stream decode;
- time blocks: shape and `valid` equal; soft within the serial path's 5e-4
  (`tests/test_torch_serial.py`) on all but at most 0.5 % of a row's valid
  symbols, those within 1e-2, every decision equal (`assert_soft_close`:
  the port runs the exact AGC and its own decimating FIR where the
  reference runs the associative-scan AGC and XLA's, and now and then such
  a rounding moves the clock's mu across a row of the MMSE table; measured:
  at most 10 of ~3850 symbols a row, 2.4e-3).  The locked-eye and >= 0.98
  decision-agreement checks of `tests/test_parallel.py` hold as there;
- `FoldedCaptureReceiver`'s helpers: equal to the JAX package's.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_port import assert_soft_close, make_capture, present
from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.demodulator import Demodulator as JDemodulator
from xritdemod_tpu.parallel.channels import ChannelDemodulator as JChannelDemodulator
from xritdemod_tpu.parallel.channels import ChannelReceiver as JChannelReceiver
from xritdemod_tpu.parallel.channels import make_channel_mesh as jmake_channel_mesh
from xritdemod_tpu.parallel.timeblocks import FoldedCaptureReceiver as JFolded
from xritdemod_tpu.parallel.timeblocks import TimeBlockDemodulator as JTimeBlock
from xritdemod_tpu.utils.cplx import from_complex as jfrom_complex
from xritdemod_tpu_torch import tx
from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig
from xritdemod_tpu_torch.parallel.channels import (
    ChannelDemodulator, ChannelReceiver, make_channel_mesh,
)
from xritdemod_tpu_torch.parallel.timeblocks import FoldedCaptureReceiver, TimeBlockDemodulator

sys.path.insert(0, os.path.dirname(__file__))


def cpu_mesh(n, axis="ch"):
    return make_channel_mesh(["cpu"] * n, axis)


def _signals(C, T, cfg):
    sig, _ = make_capture(cfg, C, int(T / cfg.sps / 16384) + 2)
    return sig[:, :T]


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.inference_mode():
        yield


class TestMesh:
    def test_default_mesh_is_every_cuda_device(self):
        if torch.cuda.is_available():
            mesh = make_channel_mesh()
            assert mesh.devices == tuple(torch.device("cuda", i)
                                         for i in range(torch.cuda.device_count()))
        else:
            with pytest.raises(RuntimeError):
                make_channel_mesh()
            with pytest.raises(RuntimeError):
                ChannelDemodulator(DemodConfig.lrit(), 4, 1024)

    def test_entries_may_repeat(self):
        mesh = make_channel_mesh(["cpu"] * 8, "ch")
        assert len(mesh) == 8 and mesh.axis == "ch"
        assert set(mesh.devices) == {torch.device("cpu")}

    def test_channels_must_split_evenly(self):
        with pytest.raises(ValueError):
            ChannelDemodulator(DemodConfig.lrit(), 6, 1024, mesh=cpu_mesh(4))


class TestChannelDemod:
    @pytest.fixture(scope="class")
    def run(self):
        C, T = 8, 8192
        cfg = DemodConfig.lrit(sample_rate=1_250_000)
        sig = _signals(C, T, cfg)
        with torch.inference_mode():
            sharded = ChannelDemodulator(cfg, C, T, mesh=cpu_mesh(4))
            state = sharded.init_state()
            s_soft, s_valid, s_state = sharded.process(sig, state)
            plain = ChannelDemodulator(cfg, C, T, device="cpu")
            p_soft, p_valid, _ = plain.process(sig, plain.init_state())
            sig2 = sig.copy()
            sig2[3] = 0
            z_soft, _, _ = sharded.process(sig2, sharded.init_state())
        jd = JChannelDemodulator(JDemodConfig.lrit(sample_rate=1_250_000), C, T,
                                 mesh=jmake_channel_mesh(jax.devices()[:4]))
        j_soft, j_valid, _ = jd.process(jfrom_complex(sig), jd.init_state())
        return dict(s=(s_soft, s_valid), p=(p_soft, p_valid), j=(j_soft, j_valid),
                    z=z_soft, state=state, new=s_state, C=C, n=sharded.num_slots)

    def test_sharded_matches_unsharded(self, run):
        (s_soft, s_valid), (p_soft, p_valid) = run["s"], run["p"]
        assert s_soft.shape == (run["C"], run["n"])
        assert torch.equal(s_valid, p_valid)
        np.testing.assert_allclose(s_soft.numpy(), p_soft.numpy(), atol=1e-5)

    def test_matches_the_reference(self, run):
        (s_soft, s_valid), (j_soft, j_valid) = run["s"], run["j"]
        np.testing.assert_array_equal(s_valid.numpy(), np.asarray(j_valid))
        np.testing.assert_allclose(s_soft.numpy(), np.asarray(j_soft), atol=1e-5)

    def test_state_is_one_per_slab(self, run):
        assert len(run["state"]) == 4 and len(run["new"]) == 4
        assert all(st.agc_gain.shape == (2,) for st in run["new"])

    def test_channels_are_independent(self, run):
        """Zeroing one channel's input must not change another's output."""
        s_soft, z_soft = run["s"][0], run["z"]
        np.testing.assert_allclose(s_soft[0].numpy(), z_soft[0].numpy(), atol=1e-6)
        assert not np.allclose(s_soft[3].numpy(), z_soft[3].numpy())


class TestChannelReceiver:
    def test_decode_block_is_the_reference_bit_for_bit(self):
        """8 streams x 2 real frames: every FrameBatch field and the tails
        equal the JAX package's vmapped one-stream decode."""
        C, B = 8, 2
        vcdus = tx.make_vcdus(C * B, rng=np.random.default_rng(31))
        frames = np.stack([
            tx.encode_stream(vcdus[B * c : B * (c + 1)], amp=0.8, noise=0.1,
                             rng=np.random.default_rng(40 + c))
            for c in range(C)
        ])
        cfg = DemodConfig.lrit(sample_rate=1_250_000)
        rx = ChannelReceiver(cfg, DecoderConfig(mode="lrit", frames_per_block=B), C,
                             block_len=1 << 13, mesh=cpu_mesh(4))
        batch, tails = rx.decode_block(frames, rx.init_tails())
        jrx = JChannelReceiver(JDemodConfig.lrit(sample_rate=1_250_000),
                               JDecoderConfig(mode="lrit", frames_per_block=B), C,
                               block_len=1 << 13, mesh=jmake_channel_mesh(jax.devices()[:8]))
        jbatch, jtails = jrx.decode_block(frames, jrx.init_tails())
        for f in present(batch, jbatch):
            np.testing.assert_array_equal(getattr(batch, f).numpy(), np.asarray(getattr(jbatch, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(tails.numpy(), np.asarray(jtails))
        assert batch.frame_ok.all()
        np.testing.assert_array_equal(batch.vcdu.numpy().reshape(C * B, -1), vcdus)

    def test_decode_block_checks_its_shape(self):
        rx = ChannelReceiver(DemodConfig.lrit(), DecoderConfig(frames_per_block=2), 4,
                             block_len=1 << 13, mesh=cpu_mesh(2))
        with pytest.raises(ValueError):
            rx.decode_block(np.zeros((4, 16384), np.float32), rx.init_tails())


# name: (port config, JAX config, capture rate, block)
TB_CASES = {
    "lrit": (DemodConfig.lrit(), JDemodConfig.lrit(), 1_250_000, 1 << 14),
    "decimation_2": (DemodConfig.lrit(sample_rate=2_500_000, decimation=2),
                     JDemodConfig.lrit(sample_rate=2_500_000, decimation=2), 2_500_000, 1 << 15),
}


class TestTimeBlocks:
    @pytest.fixture(scope="class", params=list(TB_CASES))
    def run(self, request):
        cfg, jcfg, rate, block = TB_CASES[request.param]
        D, warm = 4, 8192
        total = D * block
        txcfg = DemodConfig.lrit(sample_rate=rate)
        vcdus = tx.make_vcdus(int(total / txcfg.sps / 16384) + 2,
                              rng=np.random.default_rng(61))
        symbols = tx.encode_stream(vcdus, lrit=True, amp=1.0, rng=np.random.default_rng(62))
        sig = np.resize(tx.modulate(symbols, txcfg, np.random.default_rng(63)), total)
        with torch.inference_mode():
            tb = TimeBlockDemodulator(cfg, cpu_mesh(D, "t"), block_len=block, warmup=warm)
            soft, valid = tb.process(sig)
        jtb = JTimeBlock(jcfg, Mesh(np.asarray(jax.devices()[:D]), ("t",)), block_len=block,
                         warmup=warm)
        jsoft, jvalid = (np.asarray(a) for a in jtb.process(jfrom_complex(sig)))
        # The JAX package's serial chain over the same blocks.
        jd = JDemodulator(jcfg, block_len=block)
        st, serial = jd.init_state(), []
        for d in range(D):
            s, v, st = jd.process(sig[d * block : (d + 1) * block], st)
            serial.append(np.asarray(s)[np.asarray(v)])
        return dict(cfg=cfg, D=D, block=block, tb=tb, jtb=jtb, soft=soft.numpy(),
                    valid=valid.numpy(), jsoft=jsoft, jvalid=jvalid,
                    serial=np.concatenate(serial))

    def test_shape_and_valid_are_the_reference(self, run):
        assert run["tb"].num_slots == run["jtb"].num_slots
        assert run["soft"].shape == run["jsoft"].shape == (run["D"], run["tb"].num_slots)
        np.testing.assert_array_equal(run["valid"], run["jvalid"])

    def test_soft_within_the_serial_tolerance(self, run):
        for d in range(run["D"]):
            assert_soft_close(run["soft"][d], run["jsoft"][d], run["valid"][d])

    def test_warmup_symbols_are_masked(self, run):
        n = run["tb"].nwarm
        assert not run["valid"][:, :n].any()
        assert not run["soft"][:, :n].any()

    def test_locked_eye_after_the_first_block(self, run):
        soft, valid = run["soft"], run["valid"]
        for d in range(1, run["D"]):
            tail = soft[d][valid[d]]
            tail = tail[len(tail) // 2 :]
            eye = np.abs(tail).mean() / (np.abs(tail).std() + 1e-9)
            assert eye > 3.0, f"block {d} eye {eye}"

    def test_decisions_agree_with_the_serial_chain(self, run):
        """Block 1's decisions against the serial chain's over the same
        samples (alignment searched), as `tests/test_parallel.py` holds the
        reference's."""
        cfg, block = run["cfg"], run["block"]
        s1 = run["soft"][1][run["valid"][1]]
        got = (s1[200:1200] < 0).astype(int)
        base = int(block / cfg.decimation / cfg.sps)
        serial = run["serial"]
        best = 0.0
        for off in range(-40, 41):
            w = (serial[base + 200 + off : base + 200 + off + len(got)] < 0).astype(int)
            n = min(len(w), len(got))
            best = max(best, (got[:n] == w[:n]).mean(), (got[:n] != w[:n]).mean())
        assert best > 0.98, f"agreement {best}"


def test_timeblocks_check_like_the_reference():
    cfg = DemodConfig.lrit(sample_rate=2_500_000, decimation=2)
    with pytest.raises(ValueError):
        TimeBlockDemodulator(cfg, cpu_mesh(2, "t"), block_len=1001, warmup=8192)
    with pytest.raises(ValueError):
        TimeBlockDemodulator(cfg, cpu_mesh(2, "t"), block_len=4096, warmup=8192)
    tb = TimeBlockDemodulator(DemodConfig.lrit(), cpu_mesh(2, "t"), block_len=4096, warmup=1024)
    with pytest.raises(ValueError):
        tb.process(np.zeros(4096, np.complex64))


class TestFoldHelpers:
    """`_fold_starts`, `_fold_block` (both widths) and `_dedup` equal the
    JAX package's on random inputs."""

    @pytest.fixture(scope="class")
    def pair(self):
        cfg = DemodConfig.lrit(sample_rate=600_000)
        kw = dict(folds=5, block_len=4096, warmup=2048)
        return (FoldedCaptureReceiver(cfg, device="cpu", **kw),
                JFolded(JDemodConfig.lrit(sample_rate=600_000), **kw))

    def test_defaults_are_the_reference(self):
        for rate, dec, ppm in ((1_250_000, 1, 100.0), (2_500_000, 2, 30.0), (3_000_000, 1, 0.0)):
            t = FoldedCaptureReceiver(DemodConfig.lrit(sample_rate=rate, decimation=dec),
                                      max_clock_ppm=ppm, device="cpu")
            j = JFolded(JDemodConfig.lrit(sample_rate=rate, decimation=dec), max_clock_ppm=ppm)
            assert (t.warmup, t.overlap, t.mode) == (j.warmup, j.overlap, j.mode)
            assert not t.use_fused

    @pytest.mark.parametrize("N", [1, 4096, 99_999, 250_000])
    def test_fold_starts(self, pair, N):
        t, j = pair
        ts, tn = t._fold_starts(N)
        js, jn = j._fold_starts(N)
        np.testing.assert_array_equal(ts, js)
        assert tn == jn

    @pytest.mark.parametrize("width", [1, 2])
    def test_fold_block(self, pair, width):
        t, j = pair
        rng = np.random.default_rng(70 + width)
        N = 30_011
        if width == 1:
            x = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(np.complex64)
            bufs = [np.full((5, 4096), 7, np.complex64) for _ in range(2)]
        else:
            x = rng.integers(-127, 128, 2 * N).astype(np.int8)
            bufs = [np.full((5, 2 * 4096), 7, np.int8) for _ in range(2)]
        starts, nblocks = t._fold_starts(N)
        for blk in range(nblocks):
            a = t._fold_block(x, starts, blk, bufs[0], width)
            b = j._fold_block(x, starts, blk, bufs[1], width)
            np.testing.assert_array_equal(a, b)

    def test_dedup(self, pair):
        t, j = pair
        rng = np.random.default_rng(77)
        per_fold = [[(13, int(rng.integers(0, 3)), int(rng.integers(0, 9)),
                      bytes(rng.integers(0, 256, 4, dtype=np.uint8)))
                     for _ in range(int(rng.integers(0, 12)))] for _ in range(6)]
        assert t._dedup(per_fold) == j._dedup(per_fold)
