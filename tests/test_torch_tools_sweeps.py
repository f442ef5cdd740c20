"""The port's correctness sweeps against the JAX package's tools, on the CPU.

`tools/ber_sweep.py`, `tools/viterbi_margin_sweep.py` and the per-point
accounting of `tools/interp_margin.py` are scripts, loaded here from their
files; both sides get the same seeds and draw the same inputs.  On the CPU
both packages decode with the exact Viterbi whatever `viterbi_segments`
says, so `frame_success_seg` equals the exact one's on both; `bit_mismatch`
comes from the segmented decoder called directly on both sides.  Every
result must be equal, row for row, with no tolerance.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.receiver import FusedReceiver as JFusedReceiver
from xritdemod_tpu.utils.cplx import quantize_iq_s8 as j_quantize_iq_s8
from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig
from xritdemod_tpu_torch.models.receiver import FusedReceiver
from xritdemod_tpu_torch.tools import ber_sweep, interp_margin, viterbi_margin_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name):
    """The JAX package's tool `tools/<name>.py`, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode, snrs", [("lrit", [-2.0, 4.0]), ("hrit", [0.0])])
def test_ber_sweep_equals_the_jax_tool(mode, snrs):
    want = jax_tool("ber_sweep").run_sweep(mode, 8, snrs)
    got = ber_sweep.run_sweep(mode, 8, snrs, device="cpu")
    assert got == want
    assert [r["snr_db"] for r in got] == snrs
    # The points span the margin: none decoded at -2 dB, every frame above it.
    if mode == "lrit":
        assert got[0]["frames_ok"] == 0 and got[1]["frame_success"] == 1.0
    assert got[-1]["post_fec_ber"] == 0.0


def test_viterbi_margin_sweep_equals_the_jax_tool():
    want = jax_tool("viterbi_margin_sweep").run(8, [-1.0], [4], [64])
    got = viterbi_margin_sweep.run(8, [-1.0], [4], [64], device="cpu", log=None)
    assert got == want
    assert got[0]["frame_success_exact"] == 1.0 and got[0]["frames_diverged"] == 0


# A capture small enough for the plain loops: LRIT at 625 ksps (2.13 samples
# a symbol), 9 blocks of 8192 samples, one coded frame of the tool's rule.
RATE, T, BLOCKS, CHANNELS, SIGMA = 625_000, 8192, 9, 2, 0.01


def _jax_point(clean, want, interp):
    """The JAX tool's per-point loop (`tools/interp_margin.py`, its draws and
    accounting) through the JAX package's `FusedReceiver.step_int8`."""
    rx = JFusedReceiver(JDemodConfig.lrit(sample_rate=RATE, clock_interp=interp),
                        JDecoderConfig(mode="lrit"), channels=CHANNELS, block_len=T)
    C = CHANNELS
    rng_n = np.random.default_rng(77)
    st = rx.init_state()
    per_ch = [set() for _ in range(C)]
    for b in range(BLOCKS + 2):
        if b < BLOCKS:
            x = np.tile(clean[b * T:(b + 1) * T], (C, 1))
            x = x + SIGMA * (rng_n.standard_normal((C, T))
                             + 1j * rng_n.standard_normal((C, T))).astype(np.complex64)
        else:
            x = np.zeros((C, T), np.complex64)
        batch, ok, ovf, st = rx.step_int8(j_quantize_iq_s8(x).reshape(C, 2 * T), st)
        fok = np.asarray(batch.frame_ok) & np.asarray(ok)
        vcid, ctr, vc = np.asarray(batch.vcid), np.asarray(batch.counter), np.asarray(batch.vcdu)
        for c, j in zip(*np.nonzero(fok)):
            key = (int(vcid[c, j]), int(ctr[c, j]))
            if want.get(key) == bytes(vc[c, j]):
                per_ch[c].add(key)
    return per_ch


def test_interp_margin_point_equals_the_jax_receiver():
    """The port's point loop (`draw_blocks`, then `run_point`: the tool's
    draws, `step_int8`, frames counted per channel against what was sent)
    gives the JAX receiver's per-channel frame sets under the JAX tool's
    accounting."""
    cfg = DemodConfig.lrit(sample_rate=RATE)
    clean, nframes, want, _ = interp_margin.make_capture(BLOCKS, T, cfg)
    assert nframes == 1
    rx = FusedReceiver(cfg, DecoderConfig(mode="lrit"), channels=CHANNELS, block_len=T,
                       device="cpu")
    wire = interp_margin.draw_blocks(clean, SIGMA, BLOCKS, T, CHANNELS)
    assert len(wire) == BLOCKS + 2 and not wire[-1].any()
    with torch.inference_mode():
        got, step_s = interp_margin.run_point(rx, wire, want)
    assert got == _jax_point(clean, want, "mmse")
    assert got == [{(interp_margin.VCID, 0)}] * CHANNELS
    assert step_s > 0


def test_interp_margin_noise_is_the_jax_tools_draw():
    """`noisy_block` draws what the JAX tool's loop draws (seed 77, complex
    cast after the sum) and quantises it as the JAX package does."""
    clean = (np.random.default_rng(1).normal(size=3 * 64)
             + 1j * np.random.default_rng(2).normal(size=3 * 64)).astype(np.complex64) * 0.3
    a, b = np.random.default_rng(77), np.random.default_rng(77)
    for k in range(3 + 1):
        got = interp_margin.noisy_block(clean, k, 3, 64, 2, 0.05, a)
        if k < 3:
            x = np.tile(clean[k * 64:(k + 1) * 64], (2, 1))
            x = x + 0.05 * (b.standard_normal((2, 64))
                            + 1j * b.standard_normal((2, 64))).astype(np.complex64)
        else:
            x = np.zeros((2, 64), np.complex64)
        np.testing.assert_array_equal(got, j_quantize_iq_s8(x).reshape(2, 128))


@pytest.mark.parametrize("mmse, sinc, fails", [(128, 128, False), (103, 104, False),
                                               (100, 112, False), (100, 113, True)])
def test_interp_margin_gate_is_the_jax_tools(mmse, sinc, fails):
    """Full channels of the two interpolators within max(4, C/10) at C = 128."""
    points = [dict(sigma=0.05, interp="mmse", channels_full=mmse),
              dict(sigma=0.05, interp="sinc", channels_full=sinc)]
    assert bool(interp_margin.margin_failures(points, 128)) == fails
