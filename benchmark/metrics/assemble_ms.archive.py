"""Host milliseconds a fold step that `FoldedCaptureReceiver` spends
assembling fold blocks (its own `last_timings["assemble_s"]` over the
steps of a call), over the window's calls."""

import numpy as np


def read(res):
    a = res["counters"].get("assemble_ms")
    return float(np.mean(a)) if a else None
