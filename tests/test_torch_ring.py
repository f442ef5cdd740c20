"""K4, the per-channel symbol ring: the port's `ring_append` / `ring_extract`
(plain versions on the CPU, the arithmetic the CUDA kernels repeat) against
the JAX package's Pallas kernels in interpret mode.  Exact: the whole ring,
the popped chunk, the fill counts and the flags."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xritdemod_tpu.ops import ring_pallas as jring
from xritdemod_tpu_torch.ops import ring_cuda as tring


def _both_append(ring, fill, new, n):
    r, f, o = tring.ring_append(
        torch.from_numpy(ring.copy()), torch.from_numpy(fill),
        torch.from_numpy(new), torch.from_numpy(n),
    )
    jr, jf, jo = jring.ring_append(
        jnp.asarray(ring), jnp.asarray(fill), jnp.asarray(new), jnp.asarray(n),
        interpret=True,
    )
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    assert f.dtype == torch.int32 and o.dtype == torch.bool
    return r.numpy(), f.numpy(), o.numpy()


def _both_extract(ring, fill, pos, E):
    r, f, out, ok = tring.ring_extract(
        torch.from_numpy(ring.copy()), torch.from_numpy(fill), torch.from_numpy(pos), E
    )
    jr, jf, jout, jok = jring.ring_extract(
        jnp.asarray(ring), jnp.asarray(fill), jnp.asarray(pos), E, interpret=True
    )
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    return r.numpy(), f.numpy(), out.numpy(), ok.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_of_appends_and_extracts(seed):
    """Random traffic: ragged appends, pops at random positions, some
    channels short of a full chunk (not-ok) and some overflowing."""
    rng = np.random.default_rng(seed)
    C, L, S, E = 8, 640, 300, 256
    ring = np.zeros((C, L), np.float32)
    fill = np.zeros((C,), np.int32)
    seen_ovf = seen_notok = seen_ok = False
    for it in range(8):
        new = rng.normal(size=(C, S)).astype(np.float32)
        n = rng.integers(0, S + 1, size=C).astype(np.int32)
        n[it % C] = S
        ring, fill, ovf = _both_append(ring, fill, new, n)
        seen_ovf |= bool(ovf.any())
        for c in range(C):
            assert (ring[c, fill[c]:] == 0).all()
        if it % 2 == 1:                      # pop every other round so rings fill up
            pos = rng.integers(0, 60, size=C).astype(np.int32)
            ring, fill, out, ok = _both_extract(ring, fill, pos, E)
            seen_notok |= bool((~ok).any())
            seen_ok |= bool(ok.any())
    assert seen_ovf and seen_notok and seen_ok


def test_append_overflow_drops_block():
    rng = np.random.default_rng(5)
    C, L, S = 8, 512, 200
    ring = np.concatenate(
        [np.ones((C, L - 50), np.float32), np.zeros((C, 50), np.float32)], axis=1
    )
    fill = np.full((C,), L - 50, np.int32)
    fill[3] = L - S                          # fits exactly: not an overflow
    ring[3, L - S:] = 0
    new = rng.normal(size=(C, S)).astype(np.float32)
    r, f, ovf = _both_append(ring, fill, new, np.full((C,), S, np.int32))
    assert ovf.tolist() == [True, True, True, False, True, True, True, True]
    np.testing.assert_array_equal(r[0], ring[0])
    np.testing.assert_array_equal(r[3, L - S:], new[3])
    assert f[3] == L and f[0] == L - 50


def test_extract_not_ok_rows_hand_back_ring_head():
    rng = np.random.default_rng(6)
    C, L, E = 8, 512, 128
    fill = np.array([0, 100, 127, 128, 200, 300, 512, 130], np.int32)
    ring = rng.normal(size=(C, L)).astype(np.float32)
    for c in range(C):
        ring[c, fill[c]:] = 0
    pos = np.array([0, 0, 0, 0, 80, 50, 384, 3], np.int32)
    r, f, out, ok = _both_extract(ring, fill, pos, E)
    assert ok.tolist() == [False, False, False, True, False, True, True, False]
    for c in range(C):
        if ok[c]:
            np.testing.assert_array_equal(out[c], ring[c, pos[c]:pos[c] + E])
            assert f[c] == fill[c] - pos[c] - E
        else:
            np.testing.assert_array_equal(out[c], ring[c, :E])
            np.testing.assert_array_equal(r[c], ring[c])
            assert f[c] == fill[c]


def test_append_is_in_place():
    ring = torch.zeros((2, 64))
    fill = torch.tensor([3, 0], dtype=torch.int32)
    new = torch.arange(20, dtype=torch.float32).reshape(2, 10) + 1
    r, f, _ = tring.ring_append(ring, fill, new, torch.tensor([4, 10], dtype=torch.int32))
    assert r is ring and f.tolist() == [7, 10]
    assert ring[0, 3:8].tolist() == [1, 2, 3, 4, 0]


def test_wrappers_reject_what_the_kernels_do_not_take():
    ring = torch.zeros((2, 64), dtype=torch.float64)
    fill = torch.zeros((2,), dtype=torch.int32)
    if not torch.cuda.is_available():
        # On a CPU tensor the plain version runs; the checks guard the launch.
        with pytest.raises(ValueError):
            tring._check(ring, fill)
        with pytest.raises(ValueError):
            tring._check(ring.float(), fill.long())
