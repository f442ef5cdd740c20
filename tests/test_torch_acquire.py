"""The acquisition's plain version (K9's golden model) against the JAX fused
step's `do_acq` -> `where` chain (`xritdemod_tpu/models/receiver.py:164-191`:
`correlate` over the ring's first frame of lags, `best_correlation`, the
threshold, the lock select), and the fused step's extraction free of host
reads.

The rings come from `xritdemod_tpu_torch/tools/edge_cases.py::acquire_ring`,
which `chip_smoke.py` also feeds to the kernel: a sync at lag 0 and at the
last lag, each word, a tie between words and one between lags, -0.0
symbols, a word below the threshold, rings of one sign; float32 and bfloat16
rings, the LRIT and the HRIT words, every channel unlocked or a third of
them locked.  The counts are integers: the positions must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xritdemod_tpu.ops import correlator as jcorr
from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig
from xritdemod_tpu_torch.models.receiver import FusedReceiver
from xritdemod_tpu_torch.ops import acquire_cuda
from xritdemod_tpu_torch.ops import correlator as tcorr
from xritdemod_tpu_torch.ops import reed_solomon
from xritdemod_tpu_torch.tools.edge_cases import EDGE_CHANNELS, acquire_ring

LAGS = C.CODED_FRAME_SIZE
WINDOW = LAGS + tcorr.UW_BITS - 1
THRESH = C.MIN_CORRELATION_BITS
WORDS = {"lrit": [C.LRIT_UW0, C.LRIT_UW2], "hrit": [C.HRIT_UW0, C.HRIT_UW2]}
CHANNELS = EDGE_CHANNELS + 6
# What the edge channels must give when unlocked (None: noise, no claim).
EXPECTED = [None, 0, LAGS - 1, LAGS // 2 + 17, 5000, 300, 40, 0, 0, 1]


def _jax_positions(ring: np.ndarray, locked: np.ndarray, words, dtype) -> np.ndarray:
    """The JAX fused step's chain, as `_after_demod` runs it."""
    r = jnp.asarray(ring, dtype)
    counts = jcorr.correlate(r[:, :WINDOW], jcorr.make_templates(words))
    corr, _, p = jcorr.best_correlation(counts)
    acq_pos = jnp.where(corr >= THRESH, p.astype(jnp.int32), 0)
    return np.asarray(jnp.where(jnp.asarray(locked), 0, acq_pos).astype(jnp.int32))


@pytest.mark.parametrize("locked_every", [0, 3], ids=["unlocked", "third_locked"])
@pytest.mark.parametrize("mode", ["lrit", "hrit"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_acquisition_matches_jax(dtype, mode, locked_every):
    words = WORDS[mode]
    ring = acquire_ring(CHANNELS, words, LAGS, seed=5 if mode == "lrit" else 6)
    locked = np.zeros(CHANNELS, bool)
    if locked_every:
        locked[1::locked_every] = True
    tdt = getattr(torch, dtype)
    t_ring = torch.from_numpy(ring).to(tdt)
    masks = acquire_cuda.pack_masks(tcorr.make_templates(words))
    got = acquire_cuda.acquire_positions(t_ring, torch.from_numpy(locked), masks,
                                         WINDOW, THRESH)
    want = _jax_positions(ring, locked, words, getattr(jnp, dtype))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for c, pos in enumerate(EXPECTED):
        if pos is not None:
            assert int(got[c]) == (0 if locked[c] else pos), c
    assert (got.numpy()[locked] == 0).all()


def test_acquisition_checks_its_inputs():
    ring = torch.zeros((2, WINDOW))
    masks = acquire_cuda.pack_masks(tcorr.make_templates(WORDS["lrit"]))
    with pytest.raises(ValueError):
        acquire_cuda.acquire_positions(ring, torch.zeros(2, dtype=torch.int32), masks,
                                       WINDOW, THRESH)
    with pytest.raises(ValueError):
        acquire_cuda.acquire_positions(ring, torch.zeros(2, dtype=torch.bool), masks,
                                       WINDOW + 1, THRESH)
    pos = acquire_cuda.acquire_positions(ring, torch.zeros(2, dtype=torch.bool), masks,
                                         WINDOW, THRESH)
    assert pos.tolist() == [0, 0]


GUARDED = ("__bool__", "item", "tolist", "__int__", "__float__", "numpy")


def test_the_fused_extraction_reads_nothing_back(monkeypatch):
    """`FusedReceiver._after_demod` (append, k acquisitions, extractions and
    decodes) makes no host read of a tensor but inside the plain RS route,
    which chooses its branch on the host: on the card the RS kernel reads
    nothing, and the acquisition decides on the device as the reference's
    `lax.cond` does."""
    rx = FusedReceiver(DemodConfig.lrit(sample_rate=1_250_000), DecoderConfig(mode="lrit"),
                       channels=2, block_len=1 << 14, device="cpu")
    st = rx.init_state()
    rng = np.random.default_rng(3)
    S = rx._demod.num_slots
    ring = st.ring.clone()
    ring[:, :40000] = torch.from_numpy(rng.normal(0, 1, (2, 40000)).astype(np.float32))
    st = st._replace(ring=ring, fill=torch.full((2,), 40000, dtype=torch.int32),
                     locked=torch.tensor([True, False]))
    soft = torch.from_numpy(rng.normal(0, 1, (2, S)).astype(np.float32))
    valid = torch.ones((2, S), dtype=torch.bool)
    reads = []
    plain_rs = [0]

    def guard(name, orig):
        def read(self, *a, **k):
            if not plain_rs[0]:
                reads.append(name)
            return orig(self, *a, **k)
        return read

    for name in GUARDED:
        monkeypatch.setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor, name)))
    rs_decode = reed_solomon.rs_decode

    def rs_inside(*a, **k):
        plain_rs[0] += 1
        try:
            return rs_decode(*a, **k)
        finally:
            plain_rs[0] -= 1

    monkeypatch.setattr(reed_solomon, "rs_decode", rs_inside)
    batch, ok, ovf, _ = rx._after_demod((soft, valid, st.demod), st)
    monkeypatch.undo()
    assert reads == []
    assert ok.shape == (2, rx.k) and bool(ok[:, 0].all()) and not bool(ovf.any())
