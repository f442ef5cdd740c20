"""K1, the fused front end (AGC, the RRC matched filter, Costas loop) of a
`(C, T)` block: each sample's two float32 planes read and written once, the
state read and written (AGC gain, N - 1 filter history samples, Costas
phase and frequency); per sample the filter's N complex taps (4 N float
operations) and ~40 for the AGC and the loop.  Frozen from the program's
own count (`chip_smoke.py`'s `kernels` line, PR 8)."""


def work(C: int, T: int, rrc_taps: int, **_) -> tuple[float, float]:
    N = rrc_taps
    return 4.0 * (4 * T * C + 4 * C * (N - 1) + 6 * C), float(T * C * (4 * N + 40))
