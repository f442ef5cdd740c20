"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (`BENCHMARK.json`'s `workloads`)
names a configuration (`benchmark/configs/<config>.json`) and a traffic
mix (`benchmark/traffic/<traffic>.json`), whose `entry` names the driver
(`benchmark/entries/<entry>.py`).  With `--trace 0` the result carries the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, each read
by `benchmark/metrics/<name>.py` from the traced window.  The last line of
standard output is one JSON object; the numbers that decided `correct` are
the last lines of standard error and the result's last key, `checks`.
`attempted` and `failed` count the operations the window handed the
program (a site's blocks, an archive's whole calls) and those whose results
were not whole (the entries say what that is); frames lost to the traffic's
noise and interference are held by the check `lost_share`.

Without a CUDA card (or with fewer than the cell asks for) it exits with 3
and prints no result.  `--device cpu`, `--blocks`, `--set` and `--fault`
are for the benchmark's own tests: a run on the CPU through the program's
plain versions at a tiny size, which reports no device metric.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "xritdemod_tpu")


def load_json(path: Path):
    return json.loads(path.read_text())


def set_key(tree: dict, dotted: str, value: str) -> None:
    *head, last = dotted.split(".")
    for k in head:
        tree = tree[k]
    tree[last] = json.loads(value)


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def load_file(path: Path):
    spec = importlib.util.spec_from_file_location("bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--blocks", type=int, default=0, help="a window of this many blocks")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                    help="override config.<key> or traffic.<key>")
    ap.add_argument("--fault", default=None)
    a = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_of(bench, a.workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    parts = {"config": load_json(ROOT / conf["file"]),
             "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json")}
    for kv in a.set:
        key, value = kv.split("=", 1)
        where, dotted = key.split(".", 1)
        set_key(parts[where], dotted, value)

    # Every cache of the program inside the checkout, at fixed paths.
    cache = ROOT / ".bench_cache"
    os.environ["XRITDEMOD_TORCH_BUILD"] = str(cache / "torch_build")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"

    import torch

    if a.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            sys.stderr.write(f"run.py: the cell needs {cell['chips']} CUDA card(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                             " found\n")
            return 3
        torch.cuda.set_device(0)
    entry = importlib.import_module(f"benchmark.entries.{parts['traffic']['entry']}")
    ctx = SimpleNamespace(config=parts["config"], traffic=parts["traffic"], seed=a.seed,
                          seconds=a.seconds, trace=bool(a.trace), device=a.device,
                          blocks=a.blocks, fault=a.fault, cell=cell)
    res = entry.run(ctx)

    found = forbidden_modules()
    if found:
        sys.stderr.write(f"run.py: the process loaded {', '.join(found)}\n")
        return 4

    metrics = {}
    if a.device == "cuda":
        setup_s = res["t_window"] - T_START
        for m in metrics_for(bench, a.workload, bool(a.trace)):
            if a.trace:
                v = load_file(BENCH / "metrics" / f"{m['name']}.py").read(res) \
                    if res["trace"] is not None else None
            else:
                v = setup_s if m["name"] == "setup_s" else res["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = res["checks"]
    correct = all(v <= lim for v, lim in checks.values())
    device = {"platform": "gpu" if a.device == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if a.device == "cuda" else "cpu",
              "count": cell["chips"] if a.device == "cuda" else 0,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if a.trace and res["trace"] is not None:
        tr = res["trace"]
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    info = dict(res["info"], power_limit=power_limit())
    sys.stderr.write(json.dumps({"info": info}, default=str) + "\n")
    line["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    for n, (v, lim) in checks.items():
        sys.stderr.write(f"{n} {v} limit {lim}\n")
    print(json.dumps(line), flush=True)
    return 0


def power_limit() -> str | None:
    """The card's name and power limit as `nvidia-smi` reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


if __name__ == "__main__":
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != BENCH]
    sys.exit(main())
