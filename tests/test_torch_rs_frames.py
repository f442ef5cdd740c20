"""K8's frame entry and its tables, K9's sign masks: the plain versions the
kernels are held to on the card, against the JAX package on the CPU.

- The frame route (`rs_decode_frame` on a CPU tensor, and
  `rs_decode_frame_plain` at every Kmax) against JAX `rs_decode_frame`
  (`xritdemod_tpu/ops/reed_solomon.py:521-535`), with the RS edge words of
  `tools/edge_cases.py` in each of the four interleave slots and clean,
  errored and random codewords beside them in every frame.
- The port's numpy copy of the syndrome bit matrix (`rs_cuda.syndrome_matrix`,
  which the kernel reads as MMA fragments): equal to the JAX package's
  `msyn`; applied to seeded words (bits, mod 2) equal to the port's table
  syndromes; and its fragments, multiplied as `mma.m16n8k256` b1 AND+POPC
  lays them out (the layout checked on the card), give the same syndromes.
- K9's sign masks (`acquire_cuda.pack_masks`) against `make_templates` for
  the LRIT and HRIT words, bit for bit, and the acquisition fed from the
  masks (the kernel's arguments) against the JAX `do_acq` -> `where` chain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xritdemod_tpu.ops import correlator as jcorr
from xritdemod_tpu.ops import reed_solomon as jrs
from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch.ops import acquire_cuda, reed_solomon, rs_cuda
from xritdemod_tpu_torch.ops import correlator as tcorr
from xritdemod_tpu_torch.tools import edge_cases

CASES = edge_cases.rs_edge_cases(18)
FRAMES = edge_cases.rs_frames(CASES, 19)
N_EDGE = FRAMES.shape[0] // 4


@pytest.fixture(scope="module")
def jax_frames():
    corr, nerr = jrs.rs_decode_frame(jnp.asarray(FRAMES))
    return np.asarray(corr), np.asarray(nerr)


@pytest.mark.parametrize("slot", range(4))
def test_frame_route_matches_jax(slot, jax_frames):
    """The edge words in interleave slot `slot` (frames slot*n ... ), every
    other slot a clean, an errored or a random codeword; the JAX decode of
    all 4n frames at once (one compile), the port's per slot at every Kmax
    of its plain route and through `rs_decode_frame`'s CPU route."""
    rows = slice(slot * N_EDGE, (slot + 1) * N_EDGE)
    want_c, want_n = jax_frames[0][rows], jax_frames[1][rows]
    f = torch.from_numpy(FRAMES[rows].copy())
    got = [reed_solomon.rs_decode_frame(f)] + [
        reed_solomon.rs_decode_frame_plain(f, sm) for sm in (0, 4, None)]
    for corr, nerr in got:
        assert corr.dtype == torch.uint8 and nerr.dtype == torch.int32
        np.testing.assert_array_equal(corr.numpy(), want_c)
        np.testing.assert_array_equal(nerr.numpy(), want_n)
    # The slot holds every edge regime: corrected, failed, and the rest too.
    assert (want_n[:, slot] > 0).any() and (want_n[:, slot] < 0).any()
    assert (want_n != 0).any(axis=1).all() and (want_n == 0).any()


def test_syndrome_matrix_is_the_jax_one():
    np.testing.assert_array_equal(rs_cuda.syndrome_matrix(), jrs._bit_matrices()[0])


def _table_syndromes(words: np.ndarray) -> np.ndarray:
    tb = reed_solomon._tables("cpu")
    r = tb["tal1"][torch.from_numpy(words).long()]
    return reed_solomon._syndromes(r, tb).numpy()


def test_syndrome_matrix_gives_the_table_syndromes():
    rng = np.random.default_rng(20)
    words = np.concatenate([rng.integers(0, 256, (40, 255), dtype=np.int64).astype(np.uint8),
                            edge_cases.rs_batch(CASES, 64, 21)])
    bits = ((words[..., None] >> np.arange(8)) & 1).reshape(words.shape[0], 2040)
    s = (bits.astype(np.int64) @ rs_cuda.syndrome_matrix().astype(np.int64)) & 1
    syn = (s.reshape(-1, 32, 8) << np.arange(8)).sum(-1)
    np.testing.assert_array_equal(syn, _table_syndromes(words))


def _popcount32(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.astype("<u4").view(np.uint8).reshape(x.shape + (4,)), axis=-1).sum(-1)


def test_syndrome_fragments_multiply_as_the_kernel_reads_them():
    """A tile of 16 words as the kernel lays it out (rows of 64 little-endian
    words, byte 255 zero), its A fragments (row g: words 8c + t and
    8c + 4 + t) against the B fragments, D[m][n] the sum of popcounts of the
    ANDs; the syndrome byte k the parities of D[m][8k:8k+8]."""
    rng = np.random.default_rng(22)
    words = np.concatenate([rng.integers(0, 256, (8, 255), dtype=np.int64).astype(np.uint8),
                            edge_cases.rs_batch(CASES, 64, 23)[::8]])
    rows = np.zeros((16, 256), np.uint8)
    rows[:, :255] = words
    a = rows.view("<u4").reshape(16, 8, 2, 4)                     # (m, c, h, t)
    frag = rs_cuda.syndrome_fragments()                           # (nt, c, lane, h)
    b = frag.reshape(32, 8, 8, 4, 2).transpose(0, 2, 1, 4, 3).reshape(256, 8, 2, 4)
    d = _popcount32(a[:, None] & b[None]).sum((2, 3, 4)).astype(np.int64)   # (16, 256)
    syn = ((d & 1).reshape(16, 32, 8) << np.arange(8)).sum(-1)
    np.testing.assert_array_equal(syn, _table_syndromes(words))
    assert frag.shape == (32, 8, 32, 2) and frag.dtype == np.uint32
    assert rs_cuda._tables(torch.device("cpu")).numel() == rs_cuda.TABLE_BYTES


WORDS = {"lrit": [C.LRIT_UW0, C.LRIT_UW2], "hrit": [C.HRIT_UW0, C.HRIT_UW2]}


@pytest.mark.parametrize("mode", ["lrit", "hrit"])
def test_sign_masks_are_the_templates(mode):
    """Bit i of a word's (lo, hi) masks is set where `make_templates` puts -1
    at offset i (32 + i): the word's bit 63 - i, MSB first."""
    words = WORDS[mode]
    tpl = tcorr.make_templates(words)
    masks = acquire_cuda.pack_masks(tpl)
    for (lo, hi), word in zip(masks, words):
        msb_first = [(word >> (63 - i)) & 1 for i in range(64)]
        assert [(lo >> i) & 1 for i in range(32)] + [(hi >> i) & 1 for i in range(32)] \
            == msb_first
    assert torch.equal(acquire_cuda.unpack_masks(masks), tpl)
    np.testing.assert_array_equal(tpl.numpy(), np.asarray(jcorr.make_templates(words)))
    # LRIT's 180-degree word is the complement of its 0-degree one (the
    # kernel counts it as 64 minus word 0's matches); HRIT's is not.
    comp = masks[1] == tuple(~m & 0xFFFFFFFF for m in masks[0])
    assert comp == (mode == "lrit")


LAGS = C.CODED_FRAME_SIZE
WINDOW = LAGS + tcorr.UW_BITS - 1


@pytest.mark.parametrize("mode", ["lrit", "hrit"])
def test_acquisition_from_masks_matches_jax(mode):
    words = WORDS[mode]
    ring = edge_cases.acquire_ring(edge_cases.EDGE_CHANNELS + 2, words, LAGS,
                                   seed=24 if mode == "lrit" else 25)
    locked = np.zeros(ring.shape[0], bool)
    locked[3] = True
    masks = acquire_cuda.pack_masks(tcorr.make_templates(words))
    got = acquire_cuda.acquire_positions(torch.from_numpy(ring), torch.from_numpy(locked),
                                         masks, WINDOW, C.MIN_CORRELATION_BITS)
    r = jnp.asarray(ring)
    corr, _, p = jcorr.best_correlation(jcorr.correlate(r[:, :WINDOW],
                                                        jcorr.make_templates(words)))
    acq = jnp.where(corr >= C.MIN_CORRELATION_BITS, p.astype(jnp.int32), 0)
    want = np.asarray(jnp.where(jnp.asarray(locked), 0, acq).astype(jnp.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[3]) == 0 and (got.numpy() != 0).sum() >= 5


def test_acquisition_takes_masks_only():
    """A templates tensor is not a set of sign masks: refused, not packed."""
    ring = torch.zeros((2, WINDOW))
    with pytest.raises(ValueError):
        acquire_cuda.acquire_positions(ring, torch.zeros(2, dtype=torch.bool),
                                       tcorr.make_templates(WORDS["lrit"]), WINDOW,
                                       C.MIN_CORRELATION_BITS)


@pytest.mark.parametrize("mode", ["lrit", "hrit"])
def test_the_k9_load_family_holds_both_word_sets(mode):
    """`hazard_check`'s K9 family runs LRIT's words (the complement pair's
    instance) and HRIT's (words that tie) on both ring dtypes; each case's
    launch equals its plain version (here both the plain route)."""
    from xritdemod_tpu_torch.tools import hazard_check

    cases = [c for c in hazard_check._acquire_cases(torch.device("cpu"))
             if c[0].startswith(f"k9_acquire/{mode} ")]
    assert len(cases) == 4 and {"float32", "bfloat16"} <= {c[0].split()[1] for c in cases}
    for _, launch, plain in cases:
        got, want = launch(), plain()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert (got[0] != 0).sum() >= 5


@pytest.mark.parametrize("nerr, ops", [
    ([0] * 16, 0.0),                                       # clean: bytes alone
    ([-1, 0, 0], 2.0 * (2112 + 255 * 17)),                 # failed: BM and Chien at L = 16
    ([3], 2.0 * (2112 + 255 * 4 + 528 + 32 * 3)),          # corrected: also Omega, Forney
    ([16, -1], 2.0 * (2 * 2112 + 255 * 34 + 528 + 32 * 16)),
], ids=["clean", "failed", "corrected", "mixed"])
def test_the_rs_bound_counts_the_design(nerr, ops):
    """K8's bound counts the redesigned kernel's work on the rows' results;
    the table algorithm's count (the earlier kernel's) stays beside it."""
    nbytes, got = rs_cuda.bound_work(torch.tensor(nerr, dtype=torch.int32))
    assert nbytes == len(nerr) * 514 + rs_cuda.TABLE_BYTES and got == ops
    errored = sum(n != 0 for n in nerr)
    tbytes, tops = rs_cuda.table_work(len(nerr), errored)
    assert tbytes == len(nerr) * 514 + 1280
    assert tops == 2.0 * (len(nerr) * 32 * 255 + errored * (2112 + 528 + 255 * 81))
