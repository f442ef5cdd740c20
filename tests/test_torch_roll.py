"""K7: the port's per-row roll (`xritdemod_tpu_torch/tools/roll_probe.py`)
against `numpy.roll` and against the arithmetic of the Pallas probe kernel it
replaces (`tools/roll_probe.py::_kernel`: log2(L) stages of roll-by-2^b and
select, written out here with `numpy.roll`).  On the CPU `barrel` takes its
plain version; everything is a permutation of 32-bit words, so every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from xritdemod_tpu_torch.tools import roll_probe

DTYPES = {"f32": (np.float32, torch.float32), "i32": (np.int32, torch.int32),
          "u32": (np.uint32, torch.uint32)}


def _staged(x, amt):
    """The Pallas probe kernel's arithmetic: for each bit b of the amount,
    roll every row by 2^b (mod L) and keep the rolled row where the bit is
    set."""
    L = x.shape[1]
    stages = max(1, (L - 1).bit_length())
    x = x.copy()
    for b in range(stages):
        r = np.roll(x, (1 << b) % L, axis=1)
        bit = ((amt[:, None] >> b) & 1) > 0
        x = np.where(bit, r, x)
    return x


def _array(rng, name, shape):
    npt, _ = DTYPES[name]
    if name == "f32":
        return rng.normal(size=shape).astype(npt)
    return rng.integers(0, 1 << 30, shape).astype(npt)


def _to_torch(a, name):
    # torch.from_numpy has no uint32: carry the bits as int32 and view.
    return torch.from_numpy(a.view(np.int32)).view(DTYPES[name][1])


def _to_numpy(t, name):
    return t.view(torch.int32).numpy().view(DTYPES[name][0])


@pytest.mark.parametrize("name", ["f32", "i32", "u32"])
@pytest.mark.parametrize("shape", [(8, 64), (5, 37), (3, 1000)])
def test_barrel_matches_numpy_roll_and_the_staged_form(rng, name, shape):
    """Power-of-two and ragged lengths; amounts 0, 1, L-1 and random."""
    C, L = shape
    x = _array(rng, name, shape)
    amt = rng.integers(0, L, C).astype(np.int32)
    amt[:3] = [0, 1, L - 1]
    want = np.stack([np.roll(x[c], amt[c]) for c in range(C)])
    np.testing.assert_array_equal(_staged(x, amt), want)
    tx, tamt = _to_torch(x, name), torch.from_numpy(amt)
    for fn in (roll_probe.barrel, roll_probe.barrel_plain, roll_probe.barrel_gather):
        got = fn(tx, tamt)
        assert got.dtype == DTYPES[name][1] and got.shape == shape
        np.testing.assert_array_equal(_to_numpy(got, name), want, err_msg=fn.__name__)


def test_amounts_outside_one_turn_roll_like_numpy(rng):
    x = _array(rng, "i32", (4, 50))
    amt = np.array([-1, -73, 50, 123], np.int32)
    want = np.stack([np.roll(x[c], amt[c]) for c in range(4)])
    got = roll_probe.barrel(_to_torch(x, "i32"), torch.from_numpy(amt))
    np.testing.assert_array_equal(_to_numpy(got, "i32"), want)
    got = roll_probe.barrel_gather(_to_torch(x, "i32"), torch.from_numpy(amt))
    np.testing.assert_array_equal(_to_numpy(got, "i32"), want)


def test_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        roll_probe.barrel(x.to(torch.float64), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        roll_probe.barrel(x, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        roll_probe.barrel(x, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        roll_probe.barrel(x[0], torch.zeros(2, dtype=torch.int32))


def test_cpu_run_counts_no_launch_and_the_probe_needs_a_gpu(rng):
    before = roll_probe.launches
    roll_probe.barrel(torch.zeros((2, 8)), torch.ones(2, dtype=torch.int32))
    assert roll_probe.launches == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            roll_probe.main()
