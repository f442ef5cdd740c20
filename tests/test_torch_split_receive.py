"""The split receive as a whole slice, in both packages on the CPU: two
channels' IQ -> `Demodulator` on its split path -> `quantize_symbols` -> int8
symbols, valid prefix only -> one `StreamDecoder` per channel -> VCDUs.

The soft symbols of the two packages differ by float rounding (the JAX CPU
path runs its scan form of the AGC, the port the exact recursion); what must
be equal are the symbol counts per block, the delivered VCDUs bit for bit,
and the stream statistics, and every VCDU must be one that was transmitted.
"""

import numpy as np
import pytest

from _torch_port import make_capture
from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
from xritdemod_tpu.models.decoder import StreamDecoder as JStreamDecoder
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.demodulator import Demodulator as JDemodulator
from xritdemod_tpu.models.demodulator import quantize_symbols as jquantize_symbols
from xritdemod_tpu.utils import cplx as jcplx
from xritdemod_tpu_torch.models.decoder import DecoderConfig, StreamDecoder
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator, quantize_symbols

T = 1 << 15
FRAMES = 2


@pytest.fixture(scope="module")
def runs():
    """One capture through both packages, block by block, then flushed."""
    cfg = DemodConfig.lrit(frontend_kernel="split")
    sig, vcdus = make_capture(cfg, 2, FRAMES)
    # Whole blocks only: pad the capture's end with silence.
    pad = -sig.shape[1] % T
    sig = np.concatenate([sig, np.zeros((2, pad), np.complex64)], axis=1)
    jd = JDemodulator(JDemodConfig.lrit(frontend_kernel="split"), T)
    td = Demodulator(cfg, T, device="cpu")
    jst, tst = jd.init_state_batch(2), td.init_state_batch(2)
    dcfg = dict(mode="lrit", frames_per_block=2)
    jsds = [JStreamDecoder(JDecoderConfig(**dcfg)) for _ in range(2)]
    tsds = [StreamDecoder(DecoderConfig(**dcfg), device="cpu") for _ in range(2)]
    jout, tout = [[], []], [[], []]
    for b in range(sig.shape[1] // T):
        xb = sig[:, b * T:(b + 1) * T]
        jsoft, jv, jst = jd.block_batch(jcplx.from_complex(xb), jst)
        tsoft, tv, tst = td.block_batch(xb, tst)
        jq, jv = np.asarray(jquantize_symbols(jsoft)), np.asarray(jv)
        tq, tv = quantize_symbols(tsoft).numpy(), tv.numpy()
        np.testing.assert_array_equal(tv, jv)
        for c in range(2):
            jout[c] += jsds[c].push(jq[c][jv[c]])
            tout[c] += tsds[c].push(tq[c][tv[c]])
    for c in range(2):
        jout[c] += jsds[c].flush()
        tout[c] += tsds[c].flush()
    return dict(vcdus=vcdus, jout=jout, tout=tout, jsds=jsds, tsds=tsds)


def _frames(batches, as_numpy):
    out = []
    for b in batches:
        ok = as_numpy(b.frame_ok)
        out += [(int(v), int(n), bytes(p)) for v, n, p in zip(
            as_numpy(b.vcid)[ok], as_numpy(b.counter)[ok], as_numpy(b.vcdu)[ok])]
    return out


@pytest.mark.parametrize("channel", [0, 1])
def test_vcdus_identical_and_as_transmitted(runs, channel):
    tl = _frames(runs["tout"][channel], lambda a: a.numpy())
    jl = _frames(runs["jout"][channel], np.asarray)
    assert tl == jl and len(tl) >= 2
    for vcid, ctr, vc in tl:
        assert vcid == channel + 1
        assert vc == runs["vcdus"][channel][ctr - 100 * channel].tobytes()


def test_stream_statistics_identical(runs):
    for t, j in zip(runs["tsds"], runs["jsds"]):
        assert (t.stats.frames, t.stats.dropped, t.stats.resyncs) == (
            j.stats.frames, j.stats.dropped, j.stats.resyncs)
        assert t._locked and t.stats.frames >= 2
