"""`Demodulator.num_slots` follows the reference's slot budget past 2^17
post-decimation samples, so the port's outputs and `valid` masks have the JAX
package's shapes there (before, the port budgeted `max_symbols(T)` for any
block and its `(C, slots)` outputs were shorter).

`num_slots` is compared with the JAX package's over block lengths 2^17,
2^17 + 8192 and 2^20 + 8192, at decimation 1 and 2, and a length whose
segment count needs the "smallest divisible count" rule.  The chains run at
2^17 + 8192 (decimation 1) and 2^18 + 16384 (decimation 2, 139264 samples
after it): the port's `process` and `block_batch` against the JAX package's
`process`, which runs one clock over the whole block on the CPU, as the port
does everywhere.  Shapes and `valid` equal; soft within the serial path's
tolerance (`assert_soft_close`).  The plain chain costs ~0.2 ms a sample on
this CPU, so 2^20 + 8192 is left to the card (`chip_smoke.py`'s time-block
axis runs blocks of 2^20 + halo samples).

`DemodConfig.clock_max_block` sets the cap in place of 2^17: `num_slots` at
2^15 with a 2^17 block and at caps that do not divide the block (the
"smallest divisible count" rule), and `demod_config_from` carries the field.
Its chains run at a cap of 4096 (and 6000, which does not divide the block)
on a 2^14 block, four segments as 2^15 makes of 2^17: exact, the port's
`process` and `block_batch` against the JAX `process` (shapes and `valid`
equal, soft within the serial tolerance); with `clock_block_update=16`, the
port's `block_batch` against the JAX `block_batch` over the four segments
as four chained blocks (a segment boundary is a block boundary: the chunk
grid starts again there), the symbols in order, counts equal, within the
block-update tolerance of `tests/test_torch_block_update.py` (1e-5 but for a
neighbouring MMSE row on at most 2 % of them).
"""

import numpy as np
import pytest
import torch

from _torch_port import assert_soft_close
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.demodulator import Demodulator as JDemodulator
from xritdemod_tpu.utils.cplx import from_complex as jfrom_complex
from xritdemod_tpu_torch import convert, tx
from xritdemod_tpu_torch.models.demodulator import CLOCK_MAX_BLOCK, DemodConfig, Demodulator
from xritdemod_tpu_torch.ops.clock_recovery import mmse_table


@pytest.mark.parametrize("block_len", [1 << 17, (1 << 17) + 8192, (1 << 20) + 8192,
                                       655_370, 3 * (1 << 17) + 2])
@pytest.mark.parametrize("decimation", [1, 2])
def test_num_slots_is_the_reference(block_len, decimation):
    rate = 1_250_000 * decimation
    t = Demodulator(DemodConfig.lrit(sample_rate=rate, decimation=decimation), block_len,
                    device="cpu")
    j = JDemodulator(JDemodConfig.lrit(sample_rate=rate, decimation=decimation), block_len)
    assert t.num_slots == j.num_slots


def test_the_cap_is_the_reference_default():
    assert CLOCK_MAX_BLOCK == 1 << 17 and JDemodConfig().clock_max_block == 0


# name: (block_len, decimation)
CASES = {"2^17+8192": ((1 << 17) + 8192, 1), "2^18+16384_decimation_2": ((1 << 18) + 16384, 2)}


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    T, dec = CASES[request.param]
    rate = 1_250_000 * dec
    cfg = DemodConfig.lrit(sample_rate=rate, decimation=dec)
    txcfg = DemodConfig.lrit(sample_rate=rate)
    v = tx.make_vcdus(int(T / txcfg.sps / 16384) + 2, rng=np.random.default_rng(91))
    sym = tx.encode_stream(v, lrit=True, rng=np.random.default_rng(92))
    x = tx.modulate(sym, txcfg, np.random.default_rng(93), phase=0.7, amp=0.4, noise=0.04)[:T]
    assert len(x) == T
    jd = JDemodulator(JDemodConfig.lrit(sample_rate=rate, decimation=dec), T)
    jsoft, jvalid, _ = jd.process(x, jd.init_state())
    td = Demodulator(cfg, T, device="cpu")
    with torch.inference_mode():
        tsoft, tvalid, _ = td.process(x, td.init_state())
        out = dict(process=(tsoft.numpy(), tvalid.numpy()))
        if dec == 1:
            bsoft, bvalid, _ = td.block_batch(x[None], td.init_state_batch(1))
            out["block_batch"] = (bsoft.numpy()[0], bvalid.numpy()[0])
    return dict(T=T, dec=dec, num_slots=(td.num_slots, jd.num_slots), j=(np.asarray(jsoft),
                np.asarray(jvalid)), t=out)


def test_segmented_budget_applies(run):
    td_slots, jd_slots = run["num_slots"]
    assert run["T"] // run["dec"] > CLOCK_MAX_BLOCK
    assert td_slots == jd_slots


def test_shapes_and_valid_are_the_reference(run):
    jsoft, jvalid = run["j"]
    for path, (soft, valid) in run["t"].items():
        assert soft.shape == valid.shape == jsoft.shape, path
        np.testing.assert_array_equal(valid, jvalid, err_msg=path)
        # Every symbol of the block, not a truncated budget.
        assert valid.sum() > 0.99 * run["T"] / run["dec"] / DemodConfig.lrit().sps, path


def test_soft_within_the_serial_tolerance(run):
    jsoft, jvalid = run["j"]
    for path, (soft, _) in run["t"].items():
        assert_soft_close(soft, jsoft, jvalid)


# -- clock_max_block ------------------------------------------------------------------

@pytest.mark.parametrize("cap,block_len", [(1 << 15, 1 << 17), (1 << 15, (1 << 17) + 8192),
                                           (50_000, 1 << 17), (3000, 10_000), (6000, 1 << 14),
                                           (1 << 18, (1 << 17) + 8192)])
@pytest.mark.parametrize("decimation", [1, 2])
def test_num_slots_at_a_cap_is_the_reference(cap, block_len, decimation):
    rate = 1_250_000 * decimation
    t = Demodulator(DemodConfig.lrit(sample_rate=rate, decimation=decimation,
                                     clock_max_block=cap), block_len, device="cpu")
    j = JDemodulator(JDemodConfig.lrit(sample_rate=rate, decimation=decimation,
                                       clock_max_block=cap), block_len)
    assert t.num_slots == j.num_slots
    assert t.clock_segments == j._clock_segs


def test_the_cap_is_carried_and_checked():
    j = JDemodConfig.lrit(clock_max_block=1 << 15)
    assert convert.demod_config_from(j).clock_max_block == 1 << 15
    assert convert.demod_config_from(JDemodConfig()).clock_max_block == 0
    with pytest.raises(ValueError):
        Demodulator(DemodConfig(clock_max_block=-1), 1 << 14, device="cpu")


CAP_T, CAP_SEGS = 1 << 14, 4


def _row_step() -> float:
    """How far one step of the MMSE table's row index can move a symbol (the
    largest L1 distance of two neighbouring rows, times a sample of 1.2)."""
    tab = mmse_table("cpu").numpy().astype(np.float64)
    return float(np.abs(np.diff(tab, axis=0)).sum(1).max()) * 1.2


@pytest.fixture(scope="module")
def capped():
    v = tx.make_vcdus(3, rng=np.random.default_rng(91))
    sym = tx.encode_stream(v, lrit=True, rng=np.random.default_rng(92))
    x = tx.modulate(sym, DemodConfig.lrit(), np.random.default_rng(93), phase=0.7, amp=0.4,
                    noise=0.04)[:CAP_T]
    jd = JDemodulator(JDemodConfig.lrit(clock_max_block=4096), CAP_T)
    js, jv, _ = jd.process(x, jd.init_state())
    # The block-update clock's reference: the four segments as chained blocks.
    L = CAP_T // CAP_SEGS
    jb = JDemodulator(JDemodConfig.lrit(clock_block_update=16), L)
    st, parts = jb.init_state_batch(1), []
    for b in range(CAP_SEGS):
        s, vb, st = jb.block_batch(jfrom_complex(x[None, b * L:(b + 1) * L]), st)
        parts.append(np.asarray(s)[0][np.asarray(vb)[0]])
    out = dict(j=(np.asarray(js), np.asarray(jv), jd.num_slots), j_bu=np.concatenate(parts))
    with torch.inference_mode():
        for cap in (4096, 6000):
            td = Demodulator(DemodConfig.lrit(clock_max_block=cap), CAP_T, device="cpu")
            ts, tv, _ = td.process(x, td.init_state())
            bs, bv, _ = td.block_batch(x[None], td.init_state_batch(1))
            tu = Demodulator(DemodConfig.lrit(clock_max_block=cap, clock_block_update=16),
                             CAP_T, device="cpu")
            us, uv, _ = tu.block_batch(x[None], tu.init_state_batch(1))
            out[cap] = dict(segments=(td.clock_segments, tu.clock_segments),
                            process=(ts.numpy(), tv.numpy()),
                            block_batch=(bs.numpy()[0], bv.numpy()[0]),
                            bu=(us.numpy()[0], uv.numpy()[0]))
    return out


@pytest.mark.parametrize("cap", [4096, 6000])
def test_capped_exact_chain_is_the_reference(capped, cap):
    js, jv, jslots = capped["j"]
    got = capped[cap]
    assert got["segments"] == (CAP_SEGS, CAP_SEGS)
    for path in ("process", "block_batch"):
        soft, valid = got[path]
        assert soft.shape == valid.shape == js.shape == (jslots,), path
        np.testing.assert_array_equal(valid, jv, err_msg=path)
        assert_soft_close(soft, js, jv)


@pytest.mark.parametrize("cap", [4096, 6000])
def test_capped_block_update_restarts_at_each_segment(capped, cap):
    js, _, jslots = capped["j"]
    want = capped["j_bu"]
    soft, valid = capped[cap]["bu"]
    assert soft.shape == valid.shape == js.shape == (jslots,)
    got = soft[valid]
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= _row_step(), d.max()
    assert (d > 1e-5).mean() <= 0.02, (d > 1e-5).mean()
