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


# --------------------------------------------------------------------------
# the in-place extract: the ring handed back is the ring given
# --------------------------------------------------------------------------

def _ring(fill, L, dtype, rng):
    """A (C, L) ring of `dtype` holding random symbols below `fill`, zeros past."""
    vals = rng.normal(size=(len(fill), L)).astype(np.float32)
    vals = np.where(np.arange(L)[None] < np.asarray(fill)[:, None], vals, 0.0).astype(np.float32)
    return torch.from_numpy(vals).to(dtype)


def _extract_in_place(ring, fill, pos, E):
    """The port's extract on `ring` itself against the JAX kernel on a copy:
    the same tensor comes back, its bits, fill, pop and flags equal to JAX's."""
    before = ring.clone()
    ptr = ring.data_ptr()
    fill, pos = np.asarray(fill, np.int32), np.asarray(pos, np.int32)
    r, f, out, ok = tring.ring_extract(ring, torch.from_numpy(fill), torch.from_numpy(pos), E)
    assert r is ring and r.data_ptr() == ptr
    jring_in = jnp.asarray(before.float().numpy()).astype(
        jnp.bfloat16 if ring.dtype == torch.bfloat16 else jnp.float32)
    jr, jf, jout, jok = jring.ring_extract(
        jring_in, jnp.asarray(fill), jnp.asarray(pos), E, interpret=True)
    np.testing.assert_array_equal(r.float().numpy(), np.asarray(jr, np.float32))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout, np.float32))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert out.dtype == torch.float32
    return before, f.numpy(), out, ok.numpy()


@pytest.mark.parametrize("dtype", tring.RING_DTYPES)
def test_extract_is_in_place_and_equals_jax(dtype):
    rng = np.random.default_rng(11)
    C, L, E = 8, 640, 128
    fill = np.array([0, 127, 128, 300, 500, 640, 129, 260], np.int32)
    pos = np.array([0, 0, 0, 17, 100, 3, 1, 132], np.int32)
    ring = _ring(fill, L, dtype, rng)
    before, f, out, ok = _extract_in_place(ring, fill, pos, E)
    assert ok.tolist() == [False, False, True, True, True, True, True, True]
    for c in range(C):           # a channel short of a frame: its row as it was
        if not ok[c]:
            assert torch.equal(ring[c], before[c])


@pytest.mark.parametrize("dtype", tring.RING_DTYPES)
def test_extract_pop_overwritten_by_the_kept_symbols(dtype):
    """The kept symbols land on the slots of the pop (nf > pos): `out` holds
    the symbols as they were before the shift."""
    rng = np.random.default_rng(12)
    C, L, E = 4, 512, 64
    pos = np.array([10, 3, 0, 37], np.int32)
    fill = pos + E + np.array([200, 90, 300, 60], np.int32)      # nf > pos
    ring = _ring(fill, L, dtype, rng)
    before, f, out, ok = _extract_in_place(ring, fill, pos, E)
    assert ok.all() and (f > pos).all()
    for c in range(C):
        np.testing.assert_array_equal(out[c].numpy(),
                                      before[c, pos[c]:pos[c] + E].float().numpy())
        assert torch.equal(ring[c, :f[c]], before[c, pos[c] + E:fill[c]])
        assert not ring[c, f[c]:].float().any()


@pytest.mark.parametrize("dtype", tring.RING_DTYPES)
def test_extract_at_pos_0_with_exactly_a_frame(dtype):
    """pos 0 and fill == E: the whole ring is popped, nothing kept."""
    rng = np.random.default_rng(13)
    C, L, E = 3, 300, 96
    fill = np.full(C, E, np.int32)
    ring = _ring(fill, L, dtype, rng)
    before, f, out, ok = _extract_in_place(ring, fill, np.zeros(C, np.int32), E)
    assert ok.all() and not f.any() and not ring.float().any()
    np.testing.assert_array_equal(out.numpy(), before[:, :E].float().numpy())


@pytest.mark.parametrize("dtype", tring.RING_DTYPES)
def test_extract_from_a_full_ring(dtype):
    """fill == L, at pos 0 and past it."""
    rng = np.random.default_rng(14)
    C, L, E = 4, 301, 100
    fill = np.full(C, L, np.int32)
    pos = np.array([0, 1, 7, L - E], np.int32)
    ring = _ring(fill, L, dtype, rng)
    before, f, out, ok = _extract_in_place(ring, fill, pos, E)
    assert ok.all() and f.tolist() == (L - pos - E).tolist()


@pytest.mark.parametrize("dtype", tring.RING_DTYPES)
def test_tail_past_fill_stays_zero_through_a_stream(dtype):
    """Ragged appends and in-place pops, one ring throughout, against the JAX
    kernels' chain: after every call the slots past the fill are zero."""
    rng = np.random.default_rng(15)
    C, L, S, E = 6, 700, 257, 200
    ring = torch.zeros((C, L), dtype=dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jr = jnp.zeros((C, L), jdt)
    fill = np.zeros(C, np.int32)
    jf = jnp.asarray(fill)
    pops = 0
    for it in range(10):
        new = rng.normal(size=(C, S)).astype(np.float32)
        n = rng.integers(0, S + 1, C).astype(np.int32)
        r, f, _ = tring.ring_append(ring, torch.from_numpy(fill), torch.from_numpy(new),
                                    torch.from_numpy(n))
        jr, jf, _ = jring.ring_append(jr, jf, jnp.asarray(new), jnp.asarray(n), interpret=True)
        assert r is ring
        fill = f.numpy()
        pos = rng.integers(0, 50, C).astype(np.int32)
        r, f, out, ok = tring.ring_extract(ring, f, torch.from_numpy(pos), E)
        jr, jf, jout, jok = jring.ring_extract(jr, jf, jnp.asarray(pos), E, interpret=True)
        assert r is ring
        fill = f.numpy()
        pops += int(ok.sum())
        np.testing.assert_array_equal(ring.float().numpy(), np.asarray(jr, np.float32))
        np.testing.assert_array_equal(fill, np.asarray(jf))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout, np.float32))
        for c in range(C):
            assert not ring[c, fill[c]:].float().any()
    assert pops > 0
