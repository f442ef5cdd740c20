"""Drive the batched demod chain with a real RRC-shaped LRIT signal.

    python -m xritdemod_tpu_torch.tools.drive_demod [C] [nblocks] [--block 131072]
        [--device cuda]

The port's counterpart of `tools/drive_demod.py` (C = 512 channels, 3 blocks
of 131072 samples, LRIT at 1.25 Msps, numpy seed 3): carrier-offset BPSK
shaped by an RRC filter (`make_lrit_signal`, the port's own copy of the
reference test's synthesiser, `tests/test_demod_chain.py`, numpy only, its
convolution through the FFT), one channel copied to all C on the device,
through `ChannelDemodulator.process` (the front-end kernel K1 and the clock
kernel K2).  On channels 0, C/2 and C-1 it checks the symbol count against
consumed samples / sps (within 1 %), the eye ratio after convergence (> 4)
and the mean |soft| (between 0.3 and 0.7: the AGC's reference 0.5), and
exits non-zero when one fails.  The last line is one JSON object with the
card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from xritdemod_tpu_torch.tools.timing import card, require_device


def _convolve_same(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`np.convolve(a, b, mode="same")` for len(a) >= len(b), by the FFT."""
    n = len(a) + len(b) - 1
    size = 1 << (n - 1).bit_length()
    full = np.fft.irfft(np.fft.rfft(a, size) * np.fft.rfft(b, size), size)[:n]
    start = (len(b) - 1) // 2
    return full[start:start + len(a)]


def make_lrit_signal(rng, nsym, cfg, f_off=2e-4, phase=0.7, amp=0.25, noise=0.02):
    """RRC-shaped BPSK at `cfg`'s rate with a carrier offset and AWGN ->
    (complex64 signal, the sent bits)."""
    from xritdemod_tpu_torch.ops import filters

    sps = cfg.sps
    os_factor = 8
    ntaps = 127
    bits = rng.integers(0, 2, nsym)
    syms = 1.0 - 2.0 * bits.astype(np.float64)
    fine_len = int(nsym * sps * os_factor) + ntaps * os_factor
    impulses = np.zeros(fine_len)
    pos = (np.arange(nsym) * sps * os_factor).astype(np.int64)
    impulses[pos] = syms
    fine_rate = cfg.circuit_sample_rate * os_factor
    rc = filters.rrc_taps(1.0, fine_rate, cfg.symbol_rate, cfg.rrc_alpha, ntaps * os_factor)
    shaped = _convolve_same(impulses, rc.astype(np.float64) * os_factor)
    sig = shaped[::os_factor].astype(np.complex128)
    n = np.arange(len(sig))
    sig = sig * np.exp(1j * (2 * np.pi * f_off * n + phase)) * amp
    sig = sig + (rng.normal(size=len(sig)) + 1j * rng.normal(size=len(sig))) * noise
    return sig.astype(np.complex64), bits


def drive(C: int = 512, NB: int = 3, T: int = 1 << 17, device="cuda") -> dict:
    """The chain over NB blocks; per probe channel its symbols, eye ratio,
    mean |soft| and the three checks."""
    from xritdemod_tpu_torch.models.demodulator import DemodConfig
    from xritdemod_tpu_torch.parallel.channels import ChannelDemodulator
    from xritdemod_tpu_torch.utils.cplx import CF32

    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    demod = ChannelDemodulator(cfg, channels=C, block_len=T, device=device)
    rng = np.random.default_rng(3)
    nsym = int(NB * T / cfg.sps) + 400
    sig, _ = make_lrit_signal(rng, nsym, cfg)
    sig = sig[:NB * T]
    if len(sig) != NB * T:
        raise SystemExit(f"drive_demod: signal too short: {len(sig)}")
    probe = (0, C // 2, C - 1)
    state = demod.init_state()
    softs, valids = [], []
    for b in range(NB):
        blk = sig[b * T:(b + 1) * T]
        one = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        x = CF32(one(blk.real).expand(C, T).contiguous(), one(blk.imag).expand(C, T).contiguous())
        soft, valid, state = demod.process(x, state)
        softs.append(soft[list(probe)].cpu().numpy())
        valids.append(valid[list(probe)].cpu().numpy())
    soft, valid = np.concatenate(softs, axis=1), np.concatenate(valids, axis=1)
    nexp = NB * T / cfg.sps
    channels = []
    for pc, c in enumerate(probe):
        s = soft[pc][valid[pc]]
        tail = s[len(s) // 2:]                    # the half after convergence
        eye = float(np.abs(tail).mean()
                    / (np.abs(np.abs(tail) - np.abs(tail).mean()).mean() + 1e-9))
        mag = float(np.abs(tail).mean())
        channels.append(dict(channel=c, symbols=int(len(s)), expected=nexp, eye=eye,
                             mean_abs_soft=mag,
                             count_ok=abs(len(s) - nexp) < 0.01 * nexp,
                             eye_ok=eye > 4.0, magnitude_ok=0.3 < mag < 0.7))
    ok = all(ch["count_ok"] and ch["eye_ok"] and ch["magnitude_ok"] for ch in channels)
    return {"C": C, "blocks": NB, "T": T, "channels": channels, "ok": ok}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="drive_demod")
    p.add_argument("C", nargs="?", type=int, default=512)
    p.add_argument("nblocks", nargs="?", type=int, default=3)
    p.add_argument("--block", type=int, default=1 << 17)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, "drive_demod")
    res = drive(args.C, args.nblocks, args.block, dev)
    for ch in res["channels"]:
        print(f"ch{ch['channel']}: syms={ch['symbols']} (expect ~{ch['expected']:.0f}) "
              f"eye={ch['eye']:.2f} |soft|={ch['mean_abs_soft']:.3f}")
    print(json.dumps({"card": card(dev), "device": str(dev), **res}))
    if not res["ok"]:
        raise SystemExit("drive_demod: a check failed")
    print("DRIVE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
