"""The satellite side of a GOES xRIT downlink, in torch, on the device.

VCDUs with the header fields the decoder parses -> Reed-Solomon (255, 223)
x 4 interleaved, in the dual basis -> the CCSDS pseudo-random sequence ->
the attached sync marker -> [NRZ-M, HRIT] -> the rate 1/2, K = 7
convolutional code from a zero register, carried across frames -> BPSK
(coded bit 1 -> -1) through a root-raised-cosine pulse at the fractional
samples per symbol -> carrier offset and phase, Gaussian noise -> int8 I/Q
interleaved, `round(127 x)` clamped to +-127.

The pulse is shaped as a 4x oversampled impulse train through a 509-tap
RRC at the fine rate and taken every 4th fine sample: symbol k sits at fine
position floor(4 k sps) (or, with a drifting symbol clock, floor(4 x its
centre)), so frame f of a stream starts near sample f * 16384 * sps.  Everything is generated from a `torch.Generator` on the
stream's device, in chunks, so a stream of hundreds of millions of samples
takes well under a second on the card.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import decode as D
from benchmark.reference.filters import rrc_taps

OS = 4                         # fine grid per sample
PULSE_TAPS = 127 * OS + 1      # 509 taps at the fine rate
IQ_SCALE = 127.0
CHUNK = 1 << 21                # output samples a shaping pass


def make_vcdus(n: int, scid: int, vcid: int, counter0: int, gen: torch.Generator,
               device) -> torch.Tensor:
    """`(n, 892)` uint8 payloads: random bytes under a version-1 header."""
    v = torch.randint(0, 256, (n, D.VCDU_BYTES), generator=gen, device=device,
                      dtype=torch.int64)
    ctr = (counter0 + torch.arange(n, device=device)) & 0xFFFFFF
    v[:, 0] = (1 << 6) | ((scid >> 2) & 0x3F)
    v[:, 1] = ((scid & 0x3) << 6) | (vcid & 0x3F)
    v[:, 2] = (ctr >> 16) & 0xFF
    v[:, 3] = (ctr >> 8) & 0xFF
    v[:, 4] = ctr & 0xFF
    return v.to(torch.uint8)


def rs_encode(data: torch.Tensor) -> torch.Tensor:
    """`(R, 223)` dual-basis bytes -> `(R, 255)` codewords, every row at once."""
    alpha_to, index_of, to_conv, to_dual, gen = (torch.from_numpy(a).to(data.device)
                                                 for a in D.gf())
    msg = to_conv[data.to(torch.int64)]
    R = msg.shape[0]
    bb = torch.zeros((R, D.NROOTS), dtype=torch.int64, device=data.device)
    taps = gen[D.NROOTS - torch.arange(1, D.NROOTS, device=data.device)]
    zero = torch.zeros((), dtype=torch.int64, device=data.device)
    for i in range(D.NN - D.NROOTS):
        fb = index_of[msg[:, i] ^ bb[:, 0]]
        live = fb != D.NN
        upd = torch.where(live[:, None], alpha_to[(fb[:, None] + taps[None, :]) % D.NN], zero)
        bb = torch.cat([bb[:, 1:] ^ upd, torch.where(live, alpha_to[(fb + gen[0]) % D.NN],
                                                     zero)[:, None]], dim=1)
    return torch.cat([data.to(torch.int64), to_dual[bb]], dim=1).to(torch.uint8)


def cadus(vcdus: torch.Tensor) -> torch.Tensor:
    """`(F, 892)` payloads -> `(F, 1024)` CADUs (sync marker, then the
    randomised interleave of the four codewords)."""
    F = vcdus.shape[0]
    dev = vcdus.device
    blocks = vcdus.reshape(F, 223, 4).transpose(1, 2).reshape(F * 4, 223)
    cw = rs_encode(blocks).reshape(F, 4, 255)
    body = cw.transpose(1, 2).reshape(F, 1020) ^ torch.from_numpy(D.pn()).to(dev)
    sync = torch.tensor([(D.SYNC_MARKER >> s) & 0xFF for s in (24, 16, 8, 0)],
                        dtype=torch.uint8, device=dev)
    return torch.cat([sync.expand(F, 4), body], dim=1)


def coded_symbols(vcdus: torch.Tensor, mode: str) -> torch.Tensor:
    """The stream's BPSK symbols, +-1 int8, 16384 a frame."""
    dev = vcdus.device
    frames = cadus(vcdus).to(torch.int64)
    shifts = torch.arange(7, -1, -1, device=dev)
    bits = ((frames[..., None] >> shifts) & 1).reshape(-1)
    if mode == "hrit":
        bits = torch.cumsum(bits, 0) & 1             # NRZ-M: a 1 is a level change
    ext = torch.cat([torch.zeros(D.K - 1, dtype=torch.int64, device=dev), bits])
    n = bits.numel()
    c1 = torch.zeros(n, dtype=torch.int64, device=dev)
    c2 = torch.zeros(n, dtype=torch.int64, device=dev)
    for k in range(D.K):
        w = ext[k:k + n]
        if (D.POLY_A >> (D.K - 1 - k)) & 1:
            c1 = c1 ^ w
        if (D.POLY_B >> (D.K - 1 - k)) & 1:
            c2 = c2 ^ w
    coded = torch.stack([c1 ^ 1, c2 ^ 1], dim=1).reshape(-1)
    return (1 - 2 * coded).to(torch.int8)


def positions(nsym: int, sps: float, device, clock_ppm: float = 0.0) -> torch.Tensor:
    """Each symbol's fine-grid position, int64: floor(OS x its centre in
    samples).  With `clock_ppm`, the symbol period swings sinusoidally by
    that many ppm, four cycles over the stream (a drifting symbol clock)."""
    k = torch.arange(nsym, device=device, dtype=torch.float64)
    if clock_ppm:
        per = sps * (1.0 + clock_ppm * 1e-6 * torch.sin(2 * math.pi * 4 * k / nsym))
        centres = torch.cat([torch.zeros(1, dtype=torch.float64, device=device),
                             torch.cumsum(per[:-1], 0)])
    else:
        centres = k * sps
    return torch.floor(centres * OS).long()


def shaped(symbols: torch.Tensor, pos: torch.Tensor, n0: int, n1: int, sps: float,
           alpha: float, symbol_rate: float, min_sps: float | None = None) -> torch.Tensor:
    """Samples n0 .. n1 of the baseband pulse train, float32."""
    dev = symbols.device
    pulse = torch.from_numpy(
        rrc_taps(1.0, OS * symbol_rate * sps, symbol_rate, alpha, PULSE_TAPS) * OS
    ).to(dev, torch.float32)
    half = PULSE_TAPS // 2
    jj = torch.arange(int(math.ceil(PULSE_TAPS / (OS * (min_sps or sps)))) + 2, device=dev)
    nsym = symbols.numel()
    n = torch.arange(n0, n1, device=dev, dtype=torch.int64)
    k = torch.searchsorted(pos, OS * n - half)[:, None] + jj
    kc = k.clamp(max=nsym - 1)
    d = OS * n[:, None] + half - pos[kc]
    live = (d >= 0) & (d < PULSE_TAPS) & (k < nsym)
    return (symbols[kc].to(torch.float32) * pulse[d.clamp(0, PULSE_TAPS - 1)] * live).sum(1)


def modulate(symbols: torch.Tensor, n_samples: int, sps: float, alpha: float,
             symbol_rate: float, freq: float, phase: float, amp: float, sigma: float,
             gen: torch.Generator, clock_ppm: float = 0.0, freq_drift: float = 0.0,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """`n_samples` of the shaped carrier, int8 I/Q interleaved `(2 n,)`.
    `freq` in cycles a sample, `sigma` the noise per component; with
    `freq_drift`, the carrier swings sinusoidally by that many cycles a
    sample, two cycles over the stream."""
    dev = symbols.device
    pos = positions(symbols.numel(), sps, dev, clock_ppm)
    min_sps = sps * (1.0 - clock_ppm * 1e-6)
    if out is None:
        out = torch.empty(2 * n_samples, dtype=torch.int8, device=dev)
    for n0 in range(0, n_samples, CHUNK):
        n1 = min(n0 + CHUNK, n_samples)
        s = shaped(symbols, pos, n0, n1, sps, alpha, symbol_rate, min_sps)
        n = torch.arange(n0, n1, device=dev, dtype=torch.float64)
        ph = 2 * math.pi * freq * n + phase
        if freq_drift:
            ph = ph + freq_drift * n_samples / 2.0 * (1.0 - torch.cos(2 * math.pi * 2 * n / n_samples))
        ph = torch.remainder(ph, 2 * math.pi).float()
        re = s * torch.cos(ph) * amp + sigma * torch.randn(s.shape, generator=gen, device=dev)
        im = s * torch.sin(ph) * amp + sigma * torch.randn(s.shape, generator=gen, device=dev)
        iq = torch.stack([re, im], dim=1).reshape(-1)
        out[2 * n0:2 * n1] = torch.clamp(torch.round(iq * IQ_SCALE), -127, 127).to(torch.int8)
    return out


def frames_needed(n_samples: int, sps: float) -> int:
    return int(math.ceil((n_samples + PULSE_TAPS) / sps / D.CODED)) + 1

