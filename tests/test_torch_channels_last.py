"""Channels-last ingest on the port: `Demodulator.block_batch_cl` and
`FusedReceiver.step_cl` take a `(T, C)` block and return what `block_batch`
and `step` return on its transpose, bit for bit (soft symbols, valid masks,
every `FrameBatch` field and every leaf of the carried state); and they stay
within the existing tolerances of the JAX package's channels-last entries on
the same numpy inputs.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import frames_of, make_capture, tnp
from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.receiver import FusedReceiver as JFusedReceiver
from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.models.receiver import FusedReceiver


def _equal(a, b):
    la, lb = jax.tree.leaves(tnp(a)), jax.tree.leaves(tnp(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


_CASES = {
    "fused": dict(sample_rate=1_250_000),
    "split": dict(sample_rate=1_250_000, frontend_kernel="split"),
    "fused_decimating": dict(sample_rate=2_500_000, decimation=2),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_block_batch_cl_is_block_batch(case):
    """Two chained blocks at C = 2: identical soft, valid and state whether
    the block comes `(C, T)` or `(T, C)`, as a CF32 or as complex numpy."""
    cfg = DemodConfig.lrit(**_CASES[case])
    sig, _ = make_capture(cfg, 2, 1)
    T = 4096 * cfg.decimation
    demod = Demodulator(cfg, T, device="cpu")
    st_a = st_b = demod.init_state_batch(2)
    for b in range(2):
        x = sig[:, b * T:(b + 1) * T]
        soft_a, valid_a, st_a = demod.block_batch(x, st_a)
        soft_b, valid_b, st_b = demod.block_batch_cl(np.ascontiguousarray(x.T), st_b)
        assert torch.equal(soft_a, soft_b) and torch.equal(valid_a, valid_b)
        _equal(st_a, st_b)
    assert int(valid_a.sum()) > 1000


def test_block_batch_cl_rejects_a_wrong_block():
    demod = Demodulator(DemodConfig.lrit(), 4096, device="cpu")
    with pytest.raises(ValueError, match="block_len"):
        demod.block_batch_cl(np.zeros((2048, 2), np.complex64), demod.init_state_batch(2))


def test_step_cl_is_step_and_matches_jax():
    """LRIT at 625 ksps, three 16384-sample blocks (acquisition, then the
    first frame of each channel) through `step` and `step_cl` side by side,
    from the same state: every output and the carried state bit-equal block
    by block, a frame decoded on both channels; and the JAX package's
    `step_cl` on the same `(T, C)` blocks returns the same frame lists and
    `ok` flags (the receiver's tolerance: soft symbols differ by float
    rounding, which the FEC absorbs)."""
    cfg = DemodConfig.lrit(sample_rate=625_000)
    sig, vcdus = make_capture(cfg, 2, 2)
    T = 1 << 14
    rx = FusedReceiver(cfg, DecoderConfig(mode="lrit"), channels=2, block_len=T, device="cpu")
    jrx = JFusedReceiver(JDemodConfig.lrit(sample_rate=625_000), JDecoderConfig(mode="lrit"),
                         channels=2, block_len=T)
    st_a, st_b = rx.init_state(), rx.init_state()     # a step updates its state's ring in place
    jst = jrx.init_state()
    frames = [[], []]
    for b in range(3):
        x = sig[:, b * T:(b + 1) * T]
        xT = np.ascontiguousarray(x.T)
        out_a = rx.step(x, st_a)
        out_b = rx.step_cl(xT, st_b)
        _equal(out_a[:3], out_b[:3])
        st_a, st_b = out_a[3], out_b[3]
        _equal(st_a, st_b)
        jbatch, jok, _, jst = jrx.step_cl(xT, jst)
        np.testing.assert_array_equal(out_b[1].numpy(), np.asarray(jok))
        tf = frames_of(out_b[0])
        assert tf == frames_of(jax.tree.map(np.asarray, jbatch))
        for c in range(2):
            frames[c] += tf[c]
    for c in range(2):
        assert frames[c], c
        for vcid, ctr, vc in frames[c]:
            assert vc == vcdus[c][ctr - 100 * c].tobytes()
