"""The launch geometry of the Viterbi kernel (K3), on the CPU.

`csrc/viterbi.cu` compiles `viterbi_kernel<LPW>` for a few lanes-per-window
counts and the wrapper picks one from the window count
(`viterbi_cuda.lanes_per_window`).  The kernel itself runs only on a GPU
(`chip_smoke.py` holds every instance bit-equal to the plain version there);
here: the rule names an instance the source has, covers every window of a
ragged count, and never asks for more lanes as the window count grows.
"""

import re
from pathlib import Path

import pytest
import torch

from xritdemod_tpu_torch.ops import viterbi_cuda

SRC = Path(viterbi_cuda.__file__).parents[1] / "csrc" / "viterbi.cu"


def test_lanes_match_the_kernel_source():
    """`LANES` is the set of instances the entry dispatches to."""
    src = SRC.read_text()
    cases = re.findall(r"case (\d+): return launch<(\d+)>", src)
    assert all(a == b for a, b in cases)
    assert tuple(sorted(int(a) for a, _ in cases)) == viterbi_cuda.LANES


@pytest.mark.parametrize("nw", [1, 2, 15, 16, 17, 127, 128, 1024, 2047, 2048, 2049,
                                4096, 8191, 8192, 8193, 16383, 16384, 32768])
def test_rule_picks_an_instance_and_covers_every_window(nw):
    lanes = viterbi_cuda.lanes_per_window(nw)
    assert lanes in viterbi_cuda.LANES
    # The kernel gives each warp 32 / LPW windows: enough warps for all.
    per_warp = 32 // lanes
    warps = -(-nw // per_warp)
    assert warps * per_warp >= nw > (warps - 1) * per_warp


def test_rule_does_not_rise_as_windows_grow():
    picks = [viterbi_cuda.lanes_per_window(nw) for nw in range(1, 20000, 7)]
    assert all(a >= b for a, b in zip(picks, picks[1:]))
    # Each threshold is a row of the rule, and both neighbours are instances.
    for least, lanes in viterbi_cuda._LANES_RULE:
        assert viterbi_cuda.lanes_per_window(least) == lanes


def test_every_instance_divides_the_states_and_the_warp():
    for lanes in viterbi_cuda.LANES:
        assert 64 % lanes == 0 and 32 % lanes == 0


def test_cpu_tensor_takes_the_plain_version_at_any_lanes():
    soft = torch.randn((3, 2 * 40), generator=torch.Generator().manual_seed(0))
    want = viterbi_cuda.decode_bits_plain(soft)
    for lanes in (None, *viterbi_cuda.LANES):
        assert torch.equal(viterbi_cuda.decode_bits(soft, lanes=lanes), want)


def test_unknown_lanes_are_refused_before_any_launch():
    """Refused on a CPU tensor too, before the plain version runs."""
    soft = torch.zeros((2, 2 * 40))
    for lanes in [n for n in (0, 1, 2, 3, 4, 8, 16, 64) if n not in viterbi_cuda.LANES]:
        with pytest.raises(ValueError):
            viterbi_cuda.decode_bits(soft, lanes=lanes)


def test_negative_window_count_has_no_lanes():
    with pytest.raises(ValueError):
        viterbi_cuda.lanes_per_window(-1)
