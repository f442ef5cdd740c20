"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit): HBM3 bytes a second and float32 operations a second outside
the tensor cores."""

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def bound_s(nbytes: float, nops: float) -> float:
    """The least time of a call: the larger of its bytes and operations over
    the peaks."""
    return max(nbytes / PEAK_BYTES, nops / PEAK_F32)
