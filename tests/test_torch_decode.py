"""Decode half of the PyTorch port held against the JAX package, bit for bit.

Same numpy inputs through both on the CPU: the plain PyTorch versions on one
side; on the other the JAX ops, with the Pallas Viterbi kernel in interpret
mode.  Everything here is integer or sign logic, so every comparison is
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import present, tnp
from xritdemod_tpu import constants as C
from xritdemod_tpu import tx as jtx
from xritdemod_tpu.models.decoder import CaduDecoder as JCaduDecoder
from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
from xritdemod_tpu.ops import correlator as jcorr
from xritdemod_tpu.ops import derandomizer as jder
from xritdemod_tpu.ops import nrzm as jnrzm
from xritdemod_tpu.ops import reed_solomon as jrs
from xritdemod_tpu.ops import viterbi as jvit
from xritdemod_tpu.utils import bits as jbits
from xritdemod_tpu_torch import tx
from xritdemod_tpu_torch.models.decoder import CaduDecoder, DecoderConfig
from xritdemod_tpu_torch.ops import correlator as tcorr
from xritdemod_tpu_torch.ops import derandomizer as tder
from xritdemod_tpu_torch.ops import nrzm as tnrzm
from xritdemod_tpu_torch.ops import reed_solomon as trs
from xritdemod_tpu_torch.ops import viterbi as tvit
from xritdemod_tpu_torch.ops import viterbi_cuda
from xritdemod_tpu_torch.utils import bits as tbits


def _noisy_coded(rng, B, nbits, noise):
    """B convolutionally coded random bit streams as noisy soft symbols."""
    from xritdemod_tpu_torch.ops import conv_code

    out = []
    for _ in range(B):
        coded, _ = conv_code.conv_encode_bits(rng.integers(0, 2, nbits).astype(np.uint8))
        out.append(1.0 - 2.0 * coded.astype(np.float32))
    soft = np.stack(out) + rng.normal(0, noise, (B, 2 * nbits)).astype(np.float32)
    return soft.astype(np.float32)


class TestBitsAndSmallOps:
    def test_pack_unpack(self, rng):
        data = rng.integers(0, 256, (3, 40)).astype(np.uint8)
        bits = tbits.unpack_bits(torch.from_numpy(data))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits.unpack_bits(jnp.asarray(data))))
        np.testing.assert_array_equal(tbits.pack_bits(bits).numpy(), data)
        np.testing.assert_array_equal(
            tbits.pack_bits(bits).numpy(), np.asarray(jbits.pack_bits(jnp.asarray(bits.numpy())))
        )

    def test_nrzm(self, rng):
        data = rng.integers(0, 256, (4, 1028)).astype(np.uint8)
        np.testing.assert_array_equal(
            tnrzm.nrzm_decode_bytes(torch.from_numpy(data)).numpy(),
            np.asarray(jnrzm.nrzm_decode_bytes(jnp.asarray(data))),
        )

    def test_derandomizer(self, rng):
        np.testing.assert_array_equal(
            tder.pn_sequence(1020).numpy(), np.asarray(jder.pn_sequence(1020))
        )
        data = rng.integers(0, 256, (2, 1020)).astype(np.uint8)
        np.testing.assert_array_equal(
            tder.derandomize(torch.from_numpy(data)).numpy(),
            np.asarray(jder.derandomize(jnp.asarray(data))),
        )


class TestCorrelator:
    def test_counts_and_best(self, rng):
        soft = rng.normal(0, 40, (3, 2048)).astype(np.float32)
        signs = 1.0 - 2.0 * jbits.bits_of_u64(C.LRIT_UW2).astype(np.float32)
        soft[1, 777 : 777 + 64] = signs * 100
        soft[2, 5] = 0.0                      # zero decides as bit 0
        words = [C.LRIT_UW0, C.LRIT_UW2]
        tc = tcorr.correlate(torch.from_numpy(soft), tcorr.make_templates(words))
        jc = jcorr.correlate(jnp.asarray(soft), jcorr.make_templates(words))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        for a, b in zip(tcorr.best_correlation(tc), jcorr.best_correlation(jc)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_ties_take_first_index(self):
        counts = np.zeros((2, 2, 50), np.float32)
        counts[0, 1, 7] = counts[0, 1, 30] = counts[0, 0, 40] = 33.0
        counts[1, :, :] = 12.0
        t = tcorr.best_correlation(torch.from_numpy(counts))
        j = jcorr.best_correlation(jnp.asarray(counts))
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert t[1].tolist() == [0, 0] and t[2].tolist() == [40, 0]


class TestViterbi:
    """K3: the plain version (what the CUDA kernel must equal bit for bit)
    against the JAX scan form and the Pallas kernel in interpret mode."""

    @pytest.mark.parametrize("inputs", ["noisy", "int8-quantized", "constant"])
    def test_plain_matches_scan(self, rng, inputs):
        soft = _noisy_coded(rng, 8, 1500, 0.8)
        soft[0, 100:140] = 0.0               # ties in the ACS
        if inputs == "int8-quantized":       # as `quantize_symbols` makes them
            soft = np.clip(soft * 0.5 * 127, -128, 127).astype(np.int8).astype(np.float32) / 127
        elif inputs == "constant":
            soft = np.full_like(soft, 0.25)
        bits, err = tvit.viterbi_decode(torch.from_numpy(soft))
        jb, je = jvit.viterbi_decode(jnp.asarray(soft))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(err.numpy(), np.asarray(je))
        assert err.dtype == torch.int32 and bits.dtype == torch.uint8

    def test_all_zero_input_ties(self):
        soft = np.zeros((2, 256), np.float32)
        bits, err = tvit.viterbi_decode(torch.from_numpy(soft))
        jb, je = jvit.viterbi_decode(jnp.asarray(soft))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(err.numpy(), np.asarray(je))

    @pytest.mark.parametrize("segments,overlap", [(4, 128), (2, 64)])
    def test_segmented_matches_pallas_interpret(self, rng, segments, overlap):
        from xritdemod_tpu.ops.viterbi_pallas import viterbi_decode_segmented

        soft = _noisy_coded(rng, 8, 1030, 0.7)
        bits, err = viterbi_cuda.viterbi_decode_segmented(
            torch.from_numpy(soft), segments=segments, overlap=overlap
        )
        jb, je = viterbi_decode_segmented(
            jnp.asarray(soft), segments=segments, overlap=overlap, interpret=True
        )
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(err.numpy(), np.asarray(je))

    def test_unsegmented_wrapper_matches_pallas_interpret(self, rng):
        from xritdemod_tpu.ops.viterbi_pallas import viterbi_decode_pallas

        soft = _noisy_coded(rng, 8, 600, 0.7)
        bits, err = viterbi_cuda.viterbi_decode_kernel(torch.from_numpy(soft))
        jb, je = viterbi_decode_pallas(jnp.asarray(soft), interpret=True)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(err.numpy(), np.asarray(je))

    def test_windows_match_reference_layout(self, rng):
        soft = rng.normal(size=(2, 2 * 101)).astype(np.float32)
        flat, Tseg, Lw = viterbi_cuda.segment_windows(torch.from_numpy(soft), 4, 16)
        assert (Tseg, Lw) == (26, 58) and flat.shape == (8, 116)
        x = np.pad(soft.reshape(2, 101, 2), ((0, 0), (16, 16 + 3), (0, 0)))
        np.testing.assert_array_equal(flat[5].numpy(), x[1, 26 : 26 + 58].reshape(-1))

    def test_reencode(self, rng):
        bits = rng.integers(0, 2, (3, 200)).astype(np.uint8)
        np.testing.assert_array_equal(
            tvit.reencode_bits(torch.from_numpy(bits)).numpy(),
            np.asarray(jvit.reencode_bits(jnp.asarray(bits))),
        )


def _rs_frames(rng, regime, B=6):
    """`(B, 1020)` derandomized frame bodies in one error regime."""
    data = rng.integers(0, 256, (B, 4, 223)).astype(np.uint8)
    cw = trs.rs_encode_np(data)                                  # (B, 4, 255)
    frames = np.transpose(cw, (0, 2, 1)).reshape(B, 1020).copy()
    if regime == "few":
        for b in range(B):
            for pos in rng.choice(1020, size=3 * b, replace=False):
                frames[b, pos] ^= rng.integers(1, 256)
    elif regime == "uncorrectable":
        for b in range(1, B):
            blk = b % 4                       # > 16 errors in one block
            idx = rng.choice(255, size=17 + b, replace=False) * 4 + blk
            frames[b, idx] ^= rng.integers(1, 256, size=len(idx)).astype(np.uint8)
        frames[0, 8::4] ^= 0x55               # block 0 of frame 0 wrecked
    return frames


def _rs_codewords(rng, B, nbad, uncorrectable=False):
    """`(B, 255)` dual-basis codewords, `nbad` of them (spread over the batch)
    with 1-16 symbol errors; with `uncorrectable`, every third of those with
    17-24 instead."""
    cw = trs.rs_encode_np(rng.integers(0, 256, (B, 223)).astype(np.uint8))
    for i, b in enumerate(np.sort(rng.choice(B, size=nbad, replace=False))):
        n = int(rng.integers(17, 25)) if uncorrectable and i % 3 == 0 else \
            int(rng.integers(1, 17))
        pos = rng.choice(255, size=n, replace=False)
        cw[b, pos] ^= rng.integers(1, 256, size=n).astype(np.uint8)
    return cw


class TestReedSolomon:
    def test_encoder_matches(self, rng):
        data = rng.integers(0, 256, (5, 223)).astype(np.uint8)
        np.testing.assert_array_equal(trs.rs_encode_np(data), jrs.rs_encode_np(data))

    def test_basis_maps(self):
        data = np.arange(256, dtype=np.uint8)
        t = torch.from_numpy(data)
        np.testing.assert_array_equal(
            trs.to_conventional(t).numpy(), np.asarray(jrs.to_conventional(jnp.asarray(data)))
        )
        np.testing.assert_array_equal(
            trs.to_dual(t).numpy(), np.asarray(jrs.to_dual(jnp.asarray(data)))
        )

    @pytest.mark.parametrize("regime", ["clean", "few", "uncorrectable"])
    def test_decode_frame_matches(self, rng, regime):
        frames = _rs_frames(rng, regime)
        corr, nerr = trs.rs_decode_frame(torch.from_numpy(frames))
        jcorr_, jnerr = jrs.rs_decode_frame(jnp.asarray(frames))
        np.testing.assert_array_equal(nerr.numpy(), np.asarray(jnerr))
        np.testing.assert_array_equal(corr.numpy(), np.asarray(jcorr_))
        assert corr.dtype == torch.uint8 and nerr.dtype == torch.int32
        if regime == "clean":
            assert (nerr == 0).all()
        if regime == "few":
            assert int(nerr.max()) > 0 and int(nerr.min()) >= 0
        if regime == "uncorrectable":
            assert (nerr == -1).any() and (nerr == 0).any()

    @pytest.mark.parametrize("regime", ["few", "more", "clean", "uncorrectable",
                                        "uncorrectable_more"])
    @pytest.mark.parametrize("B,sparse_max", [(16, 4), (1024, None)])
    def test_sparse_path_matches(self, rng, monkeypatch, regime, B, sparse_max):
        """`rs_decode(sparse_max=)` bit-identical to the JAX one at the same
        Kmax (None: the automatic rule, 128 at 1024 rows) in every regime:
        at most Kmax rows in error (the sparse branch, clean rows among the
        Kmax), more than Kmax (every row corrected), none, and uncorrectable
        rows among few or many; and the branch each takes."""
        monkeypatch.delenv("XRIT_RS_SPARSE", raising=False)
        kmax = sparse_max or trs._default_sparse_max(B)
        assert kmax == (4 if B == 16 else 128)
        nbad = {"few": kmax // 2 + 1, "more": kmax + 3, "clean": 0,
                "uncorrectable": kmax - 1, "uncorrectable_more": 2 * kmax}[regime]
        cw = _rs_codewords(rng, B, nbad, uncorrectable=regime.startswith("uncorrectable"))
        before = dict(trs.branches)
        corr, nerr = trs.rs_decode(torch.from_numpy(cw), sparse_max=sparse_max)
        jc, jn = jrs.rs_decode(jnp.asarray(cw), sparse_max=sparse_max)
        np.testing.assert_array_equal(nerr.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(corr.numpy(), np.asarray(jc))
        assert int((nerr != 0).sum()) == nbad
        took = {k for k in trs.branches if trs.branches[k] != before[k]}
        assert took == {"clean" if nbad == 0 else "sparse" if nbad <= kmax else "full"}
        if regime.startswith("uncorrectable"):
            assert (nerr == -1).any() and (nerr > 0).any()

    def test_sparse_path_off(self, rng, monkeypatch):
        """XRIT_RS_SPARSE=0 (read at the call) and `sparse_max=0` both take
        the errored rows alone; the results are the JAX full path's."""
        cw = _rs_codewords(rng, 1024, 20)
        monkeypatch.setenv("XRIT_RS_SPARSE", "0")
        assert trs._default_sparse_max(1024) == 0
        jc, jn = jrs.rs_decode(jnp.asarray(cw), sparse_max=0)
        for kw in ({}, {"sparse_max": 0}, {"sparse_max": 1024}):
            before = trs.branches["rows"]
            corr, nerr = trs.rs_decode(torch.from_numpy(cw), **kw)
            assert trs.branches["rows"] == before + 1, kw
            np.testing.assert_array_equal(nerr.numpy(), np.asarray(jn))
            np.testing.assert_array_equal(corr.numpy(), np.asarray(jc))
        monkeypatch.setenv("XRIT_RS_SPARSE", "1")
        assert trs._default_sparse_max(1024) == 128
        assert [trs._default_sparse_max(b) for b in (512, 2048, 8192, 65536)] == \
            [0, 128, 512, 4096]

    def test_interleave_round_trip(self, rng):
        frames = torch.from_numpy(rng.integers(0, 256, (2, 1020)).astype(np.uint8))
        blocks = trs.deinterleave(frames)
        np.testing.assert_array_equal(
            blocks.numpy(), np.asarray(jrs.deinterleave(jnp.asarray(frames.numpy())))
        )
        np.testing.assert_array_equal(trs.interleave(blocks).numpy(), frames.numpy())


def _soft_frames(rng, mode, B=8):
    v = tx.make_vcdus(B, vcid=9, counter0=70, rng=rng)
    s = tx.encode_stream(v, lrit=mode == "lrit", noise=0.7, rng=np.random.default_rng(1))
    frames = s.reshape(B, C.CODED_FRAME_SIZE).copy()
    frames[3] = -frames[3]                                    # 180-degree flip
    frames[5, 2000:2600] = rng.normal(0, 1, 600)              # burst -> RS work
    frames[6, :] = rng.normal(0, 1, C.CODED_FRAME_SIZE)       # no frame at all
    tails = rng.normal(0, 0.5, (B, 64)).astype(np.float32)
    return frames.astype(np.float32), tails, v


class TestCaduDecoder:
    @pytest.mark.parametrize("mode", ["lrit", "hrit"])
    def test_decode_frames_every_field(self, rng, mode):
        frames, tails, _ = _soft_frames(rng, mode)
        dec = CaduDecoder(DecoderConfig(mode=mode), device="cpu")
        batch, ntails = dec.decode_frames(frames, tails)
        jbatch, jtails = JCaduDecoder(JDecoderConfig(mode=mode)).decode_frames(
            jnp.asarray(frames), jnp.asarray(tails)
        )
        for f in present(batch, jbatch):
            a, b = getattr(batch, f).numpy(), np.asarray(getattr(jbatch, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        np.testing.assert_array_equal(ntails.numpy(), np.asarray(jtails))
        ok = batch.frame_ok.numpy()
        assert ok[:3].all() and not ok[6]
        assert (batch.rs_errors.numpy()[5] > 0).any()

    def test_recovers_transmitted_vcdus(self, rng):
        frames, tails, v = _soft_frames(rng, "lrit")
        batch, _ = CaduDecoder(DecoderConfig(), device="cpu").decode_frames(frames, tails)
        ok = batch.frame_ok.numpy()
        np.testing.assert_array_equal(batch.vcdu.numpy()[ok], v[ok])
        np.testing.assert_array_equal(batch.counter.numpy()[ok], 70 + np.nonzero(ok)[0])

    @pytest.mark.parametrize("mode", ["lrit", "hrit"])
    def test_sync(self, rng, mode):
        v = tx.make_vcdus(2, rng=rng)
        s = tx.encode_stream(v, lrit=mode == "lrit", noise=0.4, lead=3000,
                             phase180=True, rng=np.random.default_rng(5))
        got = CaduDecoder(DecoderConfig(mode=mode), device="cpu").sync(s)
        want = JCaduDecoder(JDecoderConfig(mode=mode)).sync(s)
        assert got == want and got[2] == 3000 and got[1] == 1

    def test_default_device_is_the_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        with pytest.raises(RuntimeError):
            CaduDecoder(DecoderConfig())

    def test_segment_rule(self):
        dec = CaduDecoder(DecoderConfig(), device="cpu")
        assert [dec._segments(b) for b in (8, 256, 2048, 4096)] == [16, 4, 4, 2]
        assert CaduDecoder(DecoderConfig(viterbi_segments=0), device="cpu")._segments(64) == 0
