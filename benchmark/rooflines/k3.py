"""K3, the Viterbi decoder, on one extraction's C frames of 8224 trellis
steps (64 history symbols and 16384 frame symbols, two a step): 9 bytes a
step (two float32 symbols in, a decision bit out, rounded up), 64 states x
4 operations (two branch metrics, add, compare-select) + 12 a step.  The
count of what the frames need: the overlap of segmented windows is the
design's own extra work, and is left out.  Frozen from `chip_smoke.py`'s
`kernels` line (PR 5)."""

STEPS = (16384 + 64) // 2


def work(C: int, **_) -> tuple[float, float]:
    return C * STEPS * 9.0, C * STEPS * (64 * 4 + 12.0)
