"""The torch transmitter's frames, decoded by the plain reference."""

import numpy as np
import pytest
import torch

from benchmark.reference import decode as D
from benchmark.reference import receiver as R
from benchmark.reference.demod import DemodParams, DemodState
from benchmark.source import tx


@pytest.mark.parametrize("mode", ["lrit", "hrit"])
def test_coded_symbols_decode_to_the_vcdus(mode):
    gen = torch.Generator().manual_seed(4)
    vc = tx.make_vcdus(3, 13, 2, 0xFFFFFE, gen, "cpu")
    sym = tx.coded_symbols(vc, mode).numpy().astype(np.float64)
    tmpl = D.templates(mode)
    tail = np.zeros(D.HIST)
    for f in range(3):
        fields = D.decode_frame(sym[f * D.CODED:(f + 1) * D.CODED], tail, mode, tmpl)
        tail = fields["tail"]
        assert fields["frame_ok"] and fields["rs_errors"] == [0, 0, 0, 0]
        assert fields["sync_ok"]
        assert np.array_equal(fields["vcdu"], vc[f].numpy())
        assert fields["counter"] == (0xFFFFFE + f) & 0xFFFFFF and fields["vcid"] == 2


def test_rs_encoder_matches_the_reference():
    data = np.random.default_rng(3).integers(0, 256, (5, 223)).astype(np.uint8)
    assert np.array_equal(tx.rs_encode(torch.from_numpy(data)).numpy(), D.rs_encode(data))


def test_modulated_stream_demodulates_and_decodes():
    """An LRIT stream through the transmitter and the reference receiver:
    the reference locks and decodes the sent frames."""
    demod = dict(symbol_rate=293883, sample_rate=1250000, decimation=1, rrc_alpha=0.5,
                 pll_alpha=0.0037, rrc_taps=63, agc_rate=0.01, agc_reference=0.5, agc_gain=1.0,
                 agc_max_gain=4000.0, clock_alpha=0.0037, clock_mu=0.5, clock_omega_limit=0.005)
    sps = 1250000 / 293883
    gen = torch.Generator().manual_seed(8)
    vc = tx.make_vcdus(5, 13, 1, 100, gen, "cpu")
    n = 4 * 65536
    iq = tx.modulate(tx.coded_symbols(vc, "lrit"), n, sps, 0.5, 293883, freq=1e-4, phase=0.4,
                     amp=0.3, sigma=0.03, gen=gen).numpy()
    p = DemodParams.from_config(demod)
    L = R.ring_len(demod, 65536)
    st = R.ChannelState(DemodState.initial(p, demod), np.zeros(L), 0, False, np.zeros(D.HIST))
    synced = []
    for b in range(4):
        block = iq[2 * b * 65536:2 * (b + 1) * 65536]
        synced += [a for a in R.step(block, st, p, "lrit", 2, D.templates("lrit")) if a]
    decoded = D.fec_frames([s for s, _ in synced], [t for _, t in synced], "lrit")
    got = [a for a in decoded if a["frame_ok"] and min(a["rs_errors"]) >= 0]
    assert len(got) >= 2
    for a in got:
        assert np.array_equal(a["vcdu"], vc[a["counter"] - 100].numpy())
