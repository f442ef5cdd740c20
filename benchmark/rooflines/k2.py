"""K2, the M&M clock with the 8-tap MMSE interpolator, on a `(C, T)` block:
the front end's two float32 planes and the 32-sample tails read once, the
symbol slots' real part and valid flags written, ~30 words of state a
channel; ~70 float operations a symbol (two 8-tap dot products, the error
and the loop), on the C T / sps symbols the block holds.  Frozen from the
program's own count (`chip_smoke.py`'s `kernels` line, PR 8); the symbol
count is what the inputs carry, not the slot budget."""

import math


def work(C: int, T: int, sps: float, omega_limit: float = 0.005, **_) -> tuple[float, float]:
    slots = int(math.ceil((T + 32) / (sps * (1.0 - omega_limit)))) + 4
    return 4.0 * (2 * (T + 32) * C + 2 * C * slots + 30 * C), C * T / sps * 70.0
