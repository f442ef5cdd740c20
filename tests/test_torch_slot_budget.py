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
"""

import numpy as np
import pytest
import torch

from _torch_port import assert_soft_close
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.demodulator import Demodulator as JDemodulator
from xritdemod_tpu_torch import tx
from xritdemod_tpu_torch.models.demodulator import CLOCK_MAX_BLOCK, DemodConfig, Demodulator


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
