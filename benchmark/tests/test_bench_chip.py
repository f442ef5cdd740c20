"""On the chip: a sound run of the cell is correct, and the lower-precision
control is not.  The control is the program's own lower-precision path
switched on: the bf16 matched filter (`frontend_precision="bf16"`) and the
bf16 symbol FIFO (`ring_dtype="bfloat16"`), where the configuration states
float32.  Run with `python -m pytest benchmark/tests -m chip` on a machine
with a card; each run is the cell at its own size with a short window."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CONTROL = ["--set", 'config.demod.frontend_precision="bf16"',
           "--set", 'config.receiver.ring_dtype="bfloat16"']


def run_cell(workload, seed, *extra):
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(seed),
           "--seconds", "2", "--trace", "0", *extra]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["lrit_site_steady", "hrit_site_steady"])
def test_a_sound_run_is_correct(card, workload):
    line = run_cell(workload, 4_100_000_001)
    assert line["correct"], line["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("seed", [4_100_000_011, 4_100_000_012, 4_100_000_013])
@pytest.mark.parametrize("workload", ["lrit_site_steady", "hrit_site_steady"])
def test_the_lower_precision_control_is_not_correct(card, workload, seed):
    line = run_cell(workload, seed, *CONTROL)
    assert not line["correct"]
    assert line["checks"]["soft_gap"]["value"] > line["checks"]["soft_gap"]["limit"]
