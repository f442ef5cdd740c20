"""What the per-layer readers under `benchmark/metrics/` share.

A reader takes the run's result (`res`: its `trace`, `counters`, `shape`)
and returns a number, or None where the traced window holds nothing to
read, so that the metric is left out of the line.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from benchmark.harness.peaks import bound_s

ROOFLINES = Path(__file__).resolve().parent.parent / "rooflines"


def layer_ms(res: dict, layer: str) -> float | None:
    """Device milliseconds a block in the kernels of `layer`."""
    tr = res["trace"]
    if tr is None or not tr.blocks or not tr.matching(tr.layers[layer]):
        return None
    return tr.per_block_ms(tr.layer_s(layer))


def roofline_pct(res: dict, kernel: str) -> float | None:
    """The least time of one launch of `kernel` by its frozen count
    (`rooflines/<kernel>.py`) over its mean time in the trace, in %."""
    tr = res["trace"]
    if tr is None:
        return None
    n, mean_s = tr.kernel(tr.layers[kernel])
    if not n or mean_s <= 0:
        return None
    spec = importlib.util.spec_from_file_location(f"roofline_{kernel}", ROOFLINES / f"{kernel}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return 100.0 * bound_s(*mod.work(**res["shape"])) / mean_s
