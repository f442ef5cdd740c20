"""One recorded capture for an archive job, made on the device from the seed.

A single downlink (`tx.py`) of `capture_s` seconds, with the repository's
soak impairments: a carrier offset, a sinusoidal carrier drift, a
sinusoidal symbol-clock drift of `clock_ppm`, and noise; int8 I/Q
interleaved on the host, as `cli reprocess` reads it from a file.  Its
frames all lie inside the capture.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import decode as D
from benchmark.source import tx

SCID, VCID = 13, 5


class ArchiveCapture:
    def __init__(self, demod: dict, mode: str, traffic: dict, seed: int, device):
        dev = torch.device(device)
        self.sps = demod["sample_rate"] / demod["decimation"] / demod["symbol_rate"]
        self.n = int(traffic["capture_s"] * demod["sample_rate"])
        self.nframes = int(traffic["capture_s"] * demod["symbol_rate"]) // D.CODED - 1
        rng = np.random.default_rng([seed, 13])
        self.counter0 = int(rng.integers(0, 1 << 23))
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 62)))
        vc = tx.make_vcdus(self.nframes, SCID, VCID, self.counter0, gen, dev)
        iq = tx.modulate(tx.coded_symbols(vc, mode), self.n, self.sps, demod["rrc_alpha"],
                         demod["symbol_rate"], freq=traffic["freq"], phase=traffic["phase"],
                         amp=traffic["amp"], sigma=traffic["noise"], gen=gen,
                         clock_ppm=traffic["clock_ppm"], freq_drift=traffic["freq_drift"])
        self.iq = iq.cpu().numpy()
        self.sent = vc.cpu().numpy()
        del iq, vc
