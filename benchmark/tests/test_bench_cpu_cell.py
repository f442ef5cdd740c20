"""A tiny site cell end to end on the CPU (the program's plain versions):
the whole run, gate and reference check included, through the test-only
`--device cpu` path, which reports no device metric.  Then the same run
with the timed path broken underneath: each fault must turn `correct`
false.  About two minutes a run; the four runs are independent."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
TINY = ["--set", "traffic.channels=2", "--set", "traffic.streams=2",
        "--set", "traffic.block_len=16384", "--set", "traffic.warmup_blocks=8",
        "--set", "traffic.check_span=6", "--set", "traffic.check_pairs=5"]


def run_cell(*extra, workload="hrit_site_steady", seed=2718281828, blocks=8):
    tiny = TINY if workload.endswith("steady") else []
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(seed),
           "--seconds", "1", "--device", "cpu", "--blocks", str(blocks), *tiny, *extra]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_tiny_site_cell_is_correct_on_the_cpu():
    line, err = run_cell()
    assert line["correct"], err[-3000:]
    assert line["attempted"] == 8 and line["failed"] == 0           # blocks
    assert line["metrics"] == {} and line["device"]["platform"] == "cpu"
    assert list(line["checks"]) == ["wrong_frames", "lost_share", "unlocked_at_window",
                                    "soft_gap", "mismatches"]
    assert list(line)[-1] == "checks"


def test_a_window_across_the_streams_seam_is_counted():
    """Streams 8 blocks longer than the warm-up and a window of 10 blocks:
    the window crosses the seam where every channel's stream starts again.
    At this size the frames after the seam lie inside its re-lock margin,
    so the accounting and the checks are held, not the lost share."""
    line, err = run_cell("--set", "traffic.fastest_block_ms=125", blocks=10)
    info = json.loads(err.splitlines()[0])["info"]
    assert info["laps"] == 2 and line["attempted"] > 0
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert checks["wrong_frames"] == 0 and checks["mismatches"] == 0
    assert checks["soft_gap"] <= line["checks"]["soft_gap"]["limit"]


@pytest.mark.parametrize("fault", ["stale_state", "half_batch", "altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    line, err = run_cell("--fault", fault)
    assert not line["correct"], err[-3000:]
    if fault == "altered":                  # a block that delivers a wrong frame fails
        assert line["failed"] > 0


def test_tiny_archive_cell_is_correct_on_the_cpu():
    line, err = run_cell("--set", "traffic.capture_s=0.4", "--set", "traffic.folds=2",
                         "--set", "traffic.block_len=16384", "--set", "traffic.check_pairs=4",
                         workload="lrit_archive_128", blocks=1)
    assert line["correct"], err[-3000:]
    assert line["attempted"] == 1 and line["failed"] == 0           # whole calls
    assert line["metrics"] == {}
