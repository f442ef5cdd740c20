"""Host milliseconds a block in the call of `FusedReceiver.step_int8`,
which only queues the step's work: the mean over the window's blocks
outside the profiler's window (where the profiler's own recording of each
host operation would inflate it)."""

import numpy as np


def read(res):
    d = res["counters"].get("issue_ms")
    return float(np.mean(d)) if d else None
