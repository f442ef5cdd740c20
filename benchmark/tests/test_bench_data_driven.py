"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files and entries only, and the harness finds them; names and units
keep to the benchmark's alphabet."""

import json
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_run(root: Path):
    import importlib.util
    spec = importlib.util.spec_from_file_location("bench_run_copy", root / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_names_and_units():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]
    metrics = b["end_to_end"] + b["per_layer"]
    names += [m["name"] for m in metrics] + [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for w in b["workloads"]:
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists()
    for m in b["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()


def test_new_files_and_entries_are_found(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "goes_lrit_1m25.json").read_text())
    cfg["name"] = "goes_lrit_2m5"
    cfg["demod"]["sample_rate"] = 2500000
    (bench / "configs" / "goes_lrit_2m5.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "site_steady.json").read_text())
    mix["channels"] = 1024
    (bench / "traffic" / "site_half.json").write_text(json.dumps(mix))
    (bench / "metrics" / "blocks_traced.py").write_text(
        "def read(res):\n    return res['trace'].blocks if res['trace'] else None\n")
    b["configs"].append(dict(b["configs"][0], name="goes_lrit_2m5",
                             file="benchmark/configs/goes_lrit_2m5.json"))
    b["workloads"].append(dict(b["workloads"][0], name="lrit2m5_site_half",
                               config="goes_lrit_2m5", traffic="site_half"))
    for m in b["end_to_end"]:
        if m["name"] in ("msamples_per_s", "block_p95_ms"):
            m["workloads"].append("lrit2m5_site_half")
    b["per_layer"].append({"name": "blocks_traced", "unit": "blocks", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": "msamples_per_s", "workloads": ["lrit2m5_site_half"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    after = {p.relative_to(tmp_path): p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()
             and p.name != "BENCHMARK.json"}
    assert all(after[k] == v for k, v in before.items())     # nothing edited, only added

    run = load_run(tmp_path)
    assert run.ROOT == tmp_path
    nb = run.load_json(tmp_path / "BENCHMARK.json")
    cell = run.cell_of(nb, "lrit2m5_site_half")
    conf = next(c for c in nb["configs"] if c["name"] == cell["config"])
    assert run.load_json(tmp_path / conf["file"])["demod"]["sample_rate"] == 2500000
    assert run.load_json(bench / "traffic" / f"{cell['traffic']}.json")["channels"] == 1024
    per_layer = [m["name"] for m in run.metrics_for(nb, "lrit2m5_site_half", True)]
    assert per_layer == ["blocks_traced"]
    e2e = [m["name"] for m in run.metrics_for(nb, "lrit2m5_site_half", False)]
    assert "setup_s" in e2e and "msamples_per_s" in e2e
    reader = run.load_file(bench / "metrics" / "blocks_traced.py")
    assert reader.read({"trace": None}) is None
    sys.modules.pop("bench_run_copy", None)
