"""The captures of a multi-channel site, made on the device from the seed.

`streams` downlinks are transmitted (`tx.py`), each with its own virtual
channel id (s + 1), counter base, carrier offset and phase, and noise at the
traffic's Es/N0.  Channel c receives stream `c % streams`, delayed by
`(c // streams) * delay_step` samples, so a block of all channels is one
strided view of each stream: `block(b)` copies them into one `(C, 2T)` int8
tensor on the card, as a capture front end that writes into the card's
memory would leave it.  Each channel's samples run on without a break from
block to block; a stream that the window outruns starts again from its
beginning at the same block for every channel (a seam), and the frames the
seam cuts are not counted (`laps`).

With `bursts`, each channel meets one block of interference every `period`
blocks, at a phase of its own drawn from the seed, from the window's first
block on: that block of the channel is noise with the power of the
channel's signal and noise together.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import decode as D
from benchmark.source import tx

SCID = 13


class SiteCapture:
    def __init__(self, demod: dict, mode: str, traffic: dict, seed: int, seconds: float,
                 device):
        self.device = torch.device(device)
        self.C, self.T, self.S = traffic["channels"], traffic["block_len"], traffic["streams"]
        if self.C % self.S:
            raise ValueError("channels must be a multiple of streams")
        self.sps = demod["sample_rate"] / demod["decimation"] / demod["symbol_rate"]
        self.frame_len = D.CODED * self.sps
        self.delay_step = traffic["delay_step"]
        self.warmup = traffic["warmup_blocks"]
        c = np.arange(self.C)
        self.stream_of = c % self.S
        self.delay = (c // self.S) * self.delay_step
        # Enough blocks for the window at the traffic's fastest block time.
        self.cap = self.warmup + int(math.ceil(seconds * 1000.0 / traffic["fastest_block_ms"]))
        n = self.cap * self.T + int(self.delay.max()) + self.T
        rng = np.random.default_rng([seed, 7])
        self.counter0 = rng.integers(0, 1 << 23, self.S)
        gen = torch.Generator(device=self.device).manual_seed(int(rng.integers(1 << 62)))
        nframes = tx.frames_needed(n, self.sps)
        amp = traffic["amp"]
        # Noise per component for the traffic's Es/N0, from the shaped
        # signal's power (measured on a stretch of stream 0's pulses).
        vc0 = tx.make_vcdus(nframes, SCID, 1, int(self.counter0[0]), gen, self.device)
        sym0 = tx.coded_symbols(vc0, mode)
        pos0 = tx.positions(sym0.numel(), self.sps, self.device)
        p_sig = float((tx.shaped(sym0, pos0, 0, 1 << 16, self.sps, demod["rrc_alpha"],
                                 demod["symbol_rate"]) ** 2).mean()) * amp * amp
        del pos0
        self.sigma = math.sqrt(p_sig * self.sps / (2.0 * 10 ** (traffic["es_n0_db"] / 10.0)))
        self.esn0_db = 10 * math.log10(p_sig * self.sps / (2 * self.sigma ** 2))
        self.burst_sigma = math.sqrt((p_sig + 2 * self.sigma ** 2) / 2.0) * tx.IQ_SCALE
        self.streams, sent = [], []
        for s in range(self.S):
            vc = vc0 if s == 0 else tx.make_vcdus(nframes, SCID, s + 1, int(self.counter0[s]),
                                                  gen, self.device)
            sym = sym0 if s == 0 else tx.coded_symbols(vc, mode)
            self.streams.append(tx.modulate(
                sym, n, self.sps, demod["rrc_alpha"], demod["symbol_rate"],
                freq=traffic["freq_step"] * (s - (self.S - 1) / 2.0),
                phase=0.4 + 0.9 * s, amp=amp, sigma=self.sigma, gen=gen))
            sent.append(vc.cpu().numpy())
            del sym
        del sym0
        self.sent = np.stack(sent)                        # (S, F, 892)
        self.nframes = nframes
        bursts = traffic.get("bursts")
        self.period = bursts["period"] if bursts else 0
        self.phase = (rng.permutation(self.C) % self.period) if bursts else None
        self._burst_gen = torch.Generator(device=self.device).manual_seed(
            int(rng.integers(1 << 62)))
        self._burst_rows = ({r: torch.from_numpy(np.nonzero(self.phase == r)[0]).to(self.device)
                             for r in range(self.period)} if bursts else {})

    def lap(self, b: int) -> tuple[int, int]:
        """(lap, block within the streams) of block b."""
        return divmod(b, self.cap)

    def bursting(self, b: int) -> np.ndarray:
        """Channels that meet interference in block b (none before the window)."""
        if not self.period or b < self.warmup:
            return np.zeros(0, np.int64)
        return np.nonzero(self.phase == (-b) % self.period)[0]

    def block(self, b: int) -> torch.Tensor:
        """Block b of every channel, `(C, 2T)` int8 on the device."""
        _, e = self.lap(b)
        T, J = self.T, self.C // self.S
        views = [torch.as_strided(st, (J, 2 * T), (2 * self.delay_step, 1), 2 * e * T)
                 for st in self.streams]
        x = torch.stack(views, dim=1).reshape(self.C, 2 * T)
        if self.period and b >= self.warmup:
            rows = self._burst_rows[(-b) % self.period]
            noise = torch.randn((rows.numel(), 2 * T), generator=self._burst_gen,
                                device=self.device) * self.burst_sigma
            x[rows] = torch.clamp(torch.round(noise), -127, 127).to(torch.int8)
        return x

    def frame_range(self, c: int, e0: int, e1: int, margin: int,
                    lo: int | None = None) -> tuple[int, int]:
        """Frames [f0, f1) of channel c's stream whose samples lie inside
        blocks e0 .. e1 of the streams, `margin` samples clear of the end
        and `lo` (default `margin`) of the start."""
        lo = e0 * self.T + self.delay[c] + (margin if lo is None else lo)
        hi = e1 * self.T + self.delay[c] - margin
        return int(math.ceil(lo / self.frame_len)), int(math.floor(hi / self.frame_len))

    def frames_over(self, c: int, e: int, margin: int) -> tuple[int, int]:
        """Frames [f0, f1) that overlap block e of channel c, widened by `margin`."""
        lo = e * self.T + self.delay[c] - margin
        hi = (e + 1) * self.T + self.delay[c] + margin
        return int(math.floor(lo / self.frame_len)), int(math.ceil(hi / self.frame_len))
