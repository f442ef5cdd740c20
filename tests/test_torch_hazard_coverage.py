"""No kernel of the port escapes the check under load.

Every `__global__` kernel of `xritdemod_tpu_torch/csrc/*.cu` is either held
under load by `chip_smoke.py::check_under_load` (it launches a case family
of `tools/hazard_check.py`: FAMILIES names the kernel each family launches)
or named in `chip_smoke.py`'s HAZARD_EXEMPT with a reason.  An exemption is taken only by a check kernel
(by name) or by a kernel bound to one warp (`__launch_bounds__(32)`: a
launch with more threads is refused), whose threads hand nothing to another
warp.  The sources and both files are parsed, never imported (chip_smoke.py
exits without a card); the check runs in well under a second.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "xritdemod_tpu_torch" / "csrc"
CHECK_KERNELS = frozenset({"trig_check_kernel", "large_trig_check_kernel",
                           "sinc_tap_check_kernel", "probe"})

_COMMENTS = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\((?P<bounds>(?:[^()]|\([^()]*\))*)\)\s*)?"
    r"(?P<name>\w+)\s*\(")


def kernels_of(sources: dict[str, str]) -> dict[str, str | None]:
    """`{kernel name: its __launch_bounds__ arguments or None}` over the
    sources' `__global__` functions (comments left out)."""
    out = {}
    for text in sources.values():
        for m in _GLOBAL.finditer(_COMMENTS.sub("", text)):
            out[m.group("name")] = m.group("bounds")
    return out


def _literal(path: Path, name: str):
    """The literal value of module-level `name = ...` in `path`."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path.name} has no module-level {name}")


def problems(kernels: dict, families: dict, exempt: dict) -> list[str]:
    """What keeps the tables from covering `kernels`; empty when they do."""
    under_load = set(families.values())
    out = []
    for k, bounds in sorted(kernels.items()):
        if k in under_load and k in exempt:
            out.append(f"{k}: both held under load and exempt")
        elif k not in under_load and k not in exempt:
            out.append(f"{k}: launched by no FAMILIES entry and not in HAZARD_EXEMPT")
        elif k in exempt:
            if not isinstance(exempt[k], str) or not exempt[k].strip():
                out.append(f"{k}: exempt without a reason")
            one_warp = bounds is not None and bounds.split(",")[0].strip() == "32"
            if k not in CHECK_KERNELS and not one_warp:
                out.append(f"{k}: exempt, but not bound to one warp (__launch_bounds__: "
                           f"{bounds})")
    for k in sorted(under_load | set(exempt)):
        if k not in kernels:
            out.append(f"{k}: named in a table but no __global__ kernel of csrc/")
    return out


def _tables():
    return (_literal(ROOT / "xritdemod_tpu_torch" / "tools" / "hazard_check.py", "FAMILIES"),
            _literal(ROOT / "chip_smoke.py", "HAZARD_EXEMPT"))


def _sources() -> dict[str, str]:
    return {p.name: p.read_text() for p in sorted(CSRC.glob("*.cu"))}


def test_every_kernel_is_held_under_load_or_exempt():
    assert problems(kernels_of(_sources()), *_tables()) == []


def test_the_parser_finds_every_kernel():
    """Declarations with and without launch bounds, templated, with the
    name on the line after the bounds."""
    found = kernels_of(_sources())
    assert {"frontend_kernel", "frontend_slab_kernel", "clock_kernel", "clock_sinc_kernel",
            "clock_bu_kernel", "stream_kernel", "costas_spread_kernel", "ring_append_kernel",
            "ring_extract_kernel", "viterbi_kernel", "roll_kernel"} <= set(found)
    assert CHECK_KERNELS <= set(found)
    assert found["viterbi_kernel"] == "32" and found["roll_kernel"] is None


@pytest.mark.parametrize("kernel", ["rs_decode_kernel", "acquire_kernel"])
def test_the_decision_kernels_are_held_under_load(kernel):
    """K8 and K9 hand work between their warps (a shared table, a queue of
    errored rows, a block-level maximum): each has a case family, no
    exemption, and more than one warp a block."""
    families, exempt = _tables()
    assert kernel in families.values() and kernel not in exempt
    bounds = kernels_of(_sources())[kernel]
    assert bounds is not None and bounds.split(",")[0].strip() != "32"


MULTI_WARP = "template <int N>\n__global__ void __launch_bounds__(4 * 32, 1)\nnew_kernel(int* x) {}\n"
ONE_WARP = "__global__ void __launch_bounds__(32) new_kernel(int* x) {}\n"


@pytest.mark.parametrize("source, exempt, flagged", [
    (MULTI_WARP, None, True),                          # a new multi-warp kernel, no load case
    (MULTI_WARP, "its warps share nothing", True),     # exempted, but more than one warp
    (ONE_WARP, None, True),                            # one warp, but in neither table
    (ONE_WARP, "one warp", False),                     # one warp, exempt with a reason
    ("// __global__ void commented_out(int* x) {}\n", None, False),
], ids=["multi-warp-uncovered", "multi-warp-exempt", "one-warp-unlisted", "one-warp-exempt",
        "comment"])
def test_a_new_kernel_needs_a_load_case(source, exempt, flagged):
    families, exempts = _tables()
    if exempt is not None:
        exempts = {**exempts, "new_kernel": exempt}
    found = problems(kernels_of({**_sources(), "new.cu": source}), families, exempts)
    assert bool(found) == flagged, found
    if flagged:
        assert all("new_kernel" in p for p in found), found
