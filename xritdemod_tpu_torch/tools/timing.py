"""The timing rule of the port's measuring tools, and what they print beside
their numbers.

One rule for every tool: one warm-up call, left out; then N calls queued
back to back, each given the previous call's output (the carried state), so
that the N are really serialised through a data dependency; CUDA events
around the N and one synchronisation at the end; the time divided by N.  On
the CPU the host clock takes the events' place.  A tool that times calls one
at a time (`decode_bench`) runs the rule with N = 1, once per reading.

`graph_ms` is the rule for a kernel's device time apart from its wrapper's
host time (a short kernel's eager calls are timed at the host's pace): N
calls captured once as a CUDA graph, replayed between two events.

`noise_block` is the profilers' input, N(0, 0.3) noise from numpy seed 0,
as the JAX tools draw it.  `device_kernels` / `device_busy_ms` read the
device time of the kernels of
one run under `torch.profiler`; `Launches` counts the kernel launches the
port's wrappers (`ops/*_cuda.py`, `tools/roll_probe.py`) make inside a
`with` block; `card` is `nvidia-smi`'s name and power limit of the card,
which every tool prints beside its result; `require_device` refuses a CUDA
device where there is none, as the CLI does.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

__all__ = ["card", "require_device", "sync", "timed", "graph_ms", "noise_block",
           "device_kernels", "device_busy_ms",
           "FRONTEND_FORMS", "launch_counts", "reset_launches", "Launches"]


def card(device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of the
    card (its first line); "cpu" for the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "unknown"


def require_device(device: str, tool: str) -> torch.device:
    """`device` as a torch device; exits with an error for a CUDA device when
    there is none (no fall-back to the CPU: pass `--device cpu` for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: --device {device} but no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return dev


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, carry, n: int, device, launches: dict | None = None):
    """-> (ms per call, last output): `carry = fn(carry)` once as a warm-up,
    then N times under the rule of this module.  `launches`, where given,
    receives the kernel launches of the warm-up call (those of one call)."""
    with Launches() as warm:
        carry = fn(carry)
    if launches is not None:
        launches.update(warm.counts)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            carry = fn(carry)
        return (time.perf_counter() - t0) * 1e3 / n, carry
    torch.cuda.synchronize(device)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        carry = fn(carry)
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / n, carry


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time (ms) of one call of `fn()`, its host time left out: one
    eager warm-up, `calls` calls captured once as a CUDA graph (the wrapper's
    Python runs at capture only), one replay to warm, then `replays` replays
    between two events; the time over `calls * replays`.  `fn` must make no
    synchronising call (a capture refuses one)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / (calls * replays)
    del g
    return ms


def noise_block(C: int, T: int, device):
    """`(C, T)` CF32 of N(0, 0.3) from numpy seed 0 (the real part drawn
    first)."""
    from xritdemod_tpu_torch.utils.cplx import CF32

    rng = np.random.default_rng(0)
    return CF32(torch.from_numpy(rng.normal(0, 0.3, (C, T)).astype(np.float32)).to(device),
                torch.from_numpy(rng.normal(0, 0.3, (C, T)).astype(np.float32)).to(device))


def device_kernels(fn) -> tuple[float, list]:
    """Summed device time (ms) of the kernels of one run of `fn`
    (torch.profiler), and its rows (name, ms, calls), largest first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_time_total > 0 and e.device_type.name == "CUDA"),
                  key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def device_busy_ms(fn) -> float:
    """Summed device time (ms) of the kernels of one run of `fn` (torch.profiler)."""
    return device_kernels(fn)[0]


# The front end's forms by name: (block_k, block_stages, precision).
FRONTEND_FORMS = {"frontend_bk8_bf16": (8, "both", "bf16"), "frontend_bk8": (8, "both", "highest"),
                  "frontend_bf16": (0, "both", "bf16"),
                  "frontend_bk8_agc": (8, "agc", "highest"),
                  "frontend_bk8_costas": (8, "costas", "highest"),
                  "frontend_bk8_agc_bf16": (8, "agc", "bf16"),
                  "frontend_bk8_costas_bf16": (8, "costas", "bf16")}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count since its last reset, by kernel."""
    from xritdemod_tpu_torch.ops import (
        acquire_cuda, clock_cuda, frontend_cuda, ring_cuda, rs_cuda, stream_cuda, viterbi_cuda,
    )
    from xritdemod_tpu_torch.tools import roll_probe

    forms = dict(frontend_cuda.launches_form)
    out = dict(
        frontend=frontend_cuda.launches, clock=clock_cuda.launches,
        clock_sinc=clock_cuda.launches_sinc, viterbi=viterbi_cuda.launches,
        ring_append=ring_cuda.launches_append, ring_extract=ring_cuda.launches_extract,
        agc_block=stream_cuda.launches_agc, costas_block=stream_cuda.launches_costas,
        roll=roll_probe.launches,
        clock_bu=clock_cuda.launches_bu, clock_bu_sinc=clock_cuda.launches_bu_sinc,
        costas_slab=stream_cuda.launches_costas_slab,
        ring_append_bf16=ring_cuda.launches_append_bf16,
        ring_extract_bf16=ring_cuda.launches_extract_bf16,
        rs=rs_cuda.launches, acquire=acquire_cuda.launches,
    )
    for name, key in FRONTEND_FORMS.items():
        out[name] = forms.pop(key, 0)
    out["frontend_other_forms"] = sum(forms.values())
    return out


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from xritdemod_tpu_torch.ops import (
        acquire_cuda, clock_cuda, frontend_cuda, ring_cuda, rs_cuda, stream_cuda, viterbi_cuda,
    )
    from xritdemod_tpu_torch.tools import roll_probe

    frontend_cuda.launches = 0
    frontend_cuda.launches_form.clear()
    clock_cuda.launches = clock_cuda.launches_sinc = 0
    clock_cuda.launches_bu = clock_cuda.launches_bu_sinc = 0
    viterbi_cuda.launches = 0
    ring_cuda.launches_append = ring_cuda.launches_extract = 0
    ring_cuda.launches_append_bf16 = ring_cuda.launches_extract_bf16 = 0
    stream_cuda.launches_agc = stream_cuda.launches_costas = 0
    stream_cuda.launches_costas_slab = 0
    roll_probe.launches = 0
    rs_cuda.launches = acquire_cuda.launches = 0


class Launches:
    """The kernel launches made inside a `with` block, by kernel (the ones
    launched at least once), read from the wrappers' counts before and after
    it; the counts themselves are left as they are."""

    def __init__(self):
        self.counts: dict = {}

    def __enter__(self) -> "Launches":
        self._before = launch_counts()
        return self

    def __exit__(self, *exc) -> None:
        after = launch_counts()
        self.counts = {k: n - self._before[k] for k, n in after.items()
                       if n != self._before[k]}
