"""The port stands alone: importing `xritdemod_tpu_torch` pulls in neither
JAX nor the JAX package nor a GPU toolchain, and the shared configuration
fields and constants agree with the JAX package's."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import xritdemod_tpu.constants as jconst
import xritdemod_tpu_torch.constants as tconst
from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import xritdemod_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "xritdemod_tpu", "triton")
    or m == "torch.utils.cpp_extension"
)
sdr = sorted({
    line.split()[-1].rsplit("/", 1)[-1] for line in open("/proc/self/maps")
    if any(k in line for k in ("rtlsdr", "airspy", "hackrf", "sdrplay", "mirsdr"))
})
print("MODULES", len(names))
print("SDR", sdr)
print("NAMES", " ".join(names))
print("BAD", bad)
"""


@pytest.fixture(scope="module")
def probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_every_submodule_imports(probe):
    n = int(probe.split("MODULES")[1].split()[0])
    assert n >= 67


def test_importing_the_frontends_loads_no_sdr_library(probe):
    """`runtime/frontends.py`, `usb_frontends.py` and `spyserver.py` open a
    device library only when a frontend is started."""
    assert "SDR []" in probe, probe


@pytest.mark.parametrize("module", [
    "ops.stream_cuda", "ops.frontend_cuda", "ops.clock_cuda", "ops.viterbi_cuda",
    "ops.ring_cuda", "tools.roll_probe", "tools.kernel_probe", "models.decoder",
    "models.demodulator", "convert", "ops.snr", "ops.clock_recovery", "cli",
    "runtime.apps", "runtime.config", "runtime.native", "runtime.checkpoint",
    "runtime.metrics", "runtime.frontends", "runtime.usb_frontends", "runtime.spyserver",
    "tools.interop_run", "parallel.channels", "parallel.timeblocks", "parallel.distributed",
    "tools.dist_worker", "tools.long_soak", "ops.scan",
    "tools.timing", "tools.ber_sweep", "tools.viterbi_margin_sweep", "tools.interp_margin",
    "tools.scaling_sweep", "tools.decode_profile", "tools.decode_bench", "tools.chain_bench",
    "tools.stage_profile", "tools.rx_profile", "tools.clock_bench", "tools.frontend_bench",
    "tools.host_budget_profile", "tools.drive_demod", "tools.seeconstellation",
    "tools.make_frozen_fixture", "tools.hazard_check",
])
def test_kernel_and_entry_modules_import_without_a_gpu_toolchain(probe, module):
    """Each was imported by a process that ends with no `jax`, `jaxlib`,
    `xritdemod_tpu`, `triton` or `torch.utils.cpp_extension` loaded (the BAD
    list above) and on a box without a CUDA device."""
    names = probe.split("NAMES")[1].splitlines()[0].split()
    assert f"xritdemod_tpu_torch.{module}" in names
    assert "BAD []" in probe, probe


def test_import_leaves_jax_and_jax_package_out(probe):
    assert "BAD []" in probe, probe


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "xritdemod_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    return files


def test_sources_name_no_jax_import():
    for path in _port_sources():
        roots = _imported_roots(path)
        assert not roots & {"jax", "jaxlib", "xritdemod_tpu"}, path


def test_chip_smoke_refuses_to_run_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


_DEMOD_SHARED = [f.name for f in dataclasses.fields(DemodConfig)]
_DECODER_SHARED = [f.name for f in dataclasses.fields(DecoderConfig)]


@pytest.mark.parametrize("field", _DEMOD_SHARED)
def test_demod_config_default_matches(field):
    assert getattr(DemodConfig(), field) == getattr(JDemodConfig(), field)


def test_frontend_kernel_is_a_shared_field():
    assert "frontend_kernel" in _DEMOD_SHARED
    assert DemodConfig().frontend_kernel == JDemodConfig().frontend_kernel == "auto"
    for kind in ("auto", "fused", "split"):
        assert DemodConfig.lrit(frontend_kernel=kind).frontend_kernel == kind


@pytest.mark.parametrize("field", _DECODER_SHARED)
def test_decoder_config_default_matches(field):
    assert getattr(DecoderConfig(), field) == getattr(JDecoderConfig(), field)


@pytest.mark.parametrize("mode", ["lrit", "hrit"])
def test_config_presets_match(mode):
    a, b = getattr(DemodConfig, mode)(), getattr(JDemodConfig, mode)()
    for f in _DEMOD_SHARED:
        assert getattr(a, f) == getattr(b, f)
    assert a.sps == b.sps
    assert DecoderConfig(mode=mode).uws == JDecoderConfig(mode=mode).uws


def test_constants_match():
    names = [n for n in dir(jconst) if n.isupper()]
    assert len(names) > 40
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


def test_numpy_copies_match():
    from xritdemod_tpu.ops import conv_code as jcc, filters as jf, interp_taps as jit_
    from xritdemod_tpu_torch.ops import conv_code as tcc, filters as tf, interp_taps as tit

    np.testing.assert_array_equal(tit.mmse_taps_table(), jit_.mmse_taps_table())
    np.testing.assert_array_equal(
        tf.rrc_taps(1.0, 1_250_000, 293_883, 0.5, 63),
        jf.rrc_taps(1.0, 1_250_000, 293_883, 0.5, 63),
    )
    np.testing.assert_array_equal(
        tf.lowpass_taps(1.0, 2_500_000, 625_000, 100e3),
        jf.lowpass_taps(1.0, 2_500_000, 625_000, 100e3),
    )
    for a, b in zip(tcc.branch_signs(), jcc.branch_signs()):
        np.testing.assert_array_equal(a, b)
    bits = np.random.default_rng(3).integers(0, 2, 500).astype(np.uint8)
    np.testing.assert_array_equal(tcc.conv_encode_bits(bits)[0], jcc.conv_encode_bits(bits)[0])
    np.testing.assert_array_equal(tcc.nrzm_encode_bits(bits)[0], jcc.nrzm_encode_bits(bits)[0])


def test_tx_matches():
    from xritdemod_tpu import tx as jtx
    from xritdemod_tpu_torch import tx as ttx

    v = ttx.make_vcdus(3, vcid=7, counter0=5, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(
        v, jtx.make_vcdus(3, vcid=7, counter0=5, rng=np.random.default_rng(1))
    )
    for lrit in (True, False):
        s = ttx.encode_stream(v, lrit=lrit, noise=0.2, lead=100, rng=np.random.default_rng(2))
        np.testing.assert_array_equal(
            s, jtx.encode_stream(v, lrit=lrit, noise=0.2, lead=100, rng=np.random.default_rng(2))
        )
    cfg = DemodConfig.lrit()
    np.testing.assert_array_equal(
        ttx.modulate(s[:4000], cfg, np.random.default_rng(4)),
        jtx.modulate(s[:4000], JDemodConfig.lrit(), np.random.default_rng(4)),
    )


# The runtime modules the port copies from the JAX package, and what may
# differ beyond docstrings, comments and the package name: a user-visible
# title (the port runs on a GPU); the broadcast server's sending loop, which
# the port rewrote to send all it has queued each turn (its own test is in
# test_torch_runtime.py), dropped from both sides.
_RUNTIME_COPIES = {
    "statistics": {}, "channel_writer": {}, "exit_handler": {},
    "diag": {}, "frontends": {}, "spyserver": {}, "usb_frontends": {},
    "symbol_manager": {}, "config": {},
    "display": {"edits": [(" xRIT TPU Decoder ", " xRIT GPU Decoder ")]},
    "dispatchers": {"drop": {"_loop", "_take", "_send"}},
}


def _code_of(path, edits=(), drop=()):
    """The module's code as an AST dump, docstrings and the methods named in
    `drop` removed and the JAX package's name mapped to the port's."""
    text = open(path).read()
    for old, new in edits:
        assert old in text, (path, old)
        text = text.replace(old, new)
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            node.body = [b for b in node.body
                         if not (isinstance(b, ast.FunctionDef) and b.name in drop)]
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module:
            root, _, rest = node.module.partition(".")
            if root == "xritdemod_tpu":
                node.module = "xritdemod_tpu_torch" + ("." + rest if rest else "")
    return ast.dump(tree)


@pytest.mark.parametrize("name", sorted(_RUNTIME_COPIES))
def test_runtime_copies_match(name):
    """Each copied runtime module is its original line for line in code (the
    docstrings are rewritten for the port; `config` builds the port's
    configs through the same names)."""
    ref = os.path.join(ROOT, "xritdemod_tpu", "runtime", f"{name}.py")
    port = os.path.join(ROOT, "xritdemod_tpu_torch", "runtime", f"{name}.py")
    how = _RUNTIME_COPIES[name]
    drop = how.get("drop", ())
    assert _code_of(port, drop=drop) == _code_of(ref, how.get("edits", ()), drop)


# Every module that launches a kernel, and its launches.
_LAUNCHERS = {
    "ops/frontend_cuda.py": 3, "ops/clock_cuda.py": 2, "ops/viterbi_cuda.py": 1,
    "ops/ring_cuda.py": 2, "ops/stream_cuda.py": 2, "tools/roll_probe.py": 1,
    "tools/kernel_probe.py": 4, "ops/rs_cuda.py": 1, "ops/acquire_cuda.py": 1,
}


@pytest.mark.parametrize("path", sorted(_LAUNCHERS))
def test_wrappers_launch_on_their_inputs_device(path):
    """Each kernel launch runs inside `with _build.launch_on(t) as stream:`
    for one of its input tensors `t` and passes that `stream` to the kernel;
    no wrapper reads the current device's stream itself (which would put a
    launch on `cuda:1` data on `cuda:0`'s stream)."""
    tree = ast.parse(open(os.path.join(ROOT, "xritdemod_tpu_torch", path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr != "current_stream", (path, node.lineno)
    launches = 0
    for node in ast.walk(tree):
        if not isinstance(node, ast.With):
            continue
        ctx = node.items[0].context_expr
        if not (isinstance(ctx, ast.Call) and ast.unparse(ctx.func) == "_build.launch_on"):
            assert "cuda.device" not in ast.unparse(ctx), (path, node.lineno)
            continue
        launches += 1
        assert isinstance(ctx.args[0], ast.Name) and node.items[0].optional_vars.id == "stream"
        calls = [c for b in node.body for c in ast.walk(b) if isinstance(c, ast.Call)]
        assert any(c.args and ast.unparse(c.args[-1]) == "stream" for c in calls), (
            path, node.lineno)
    checks = sum(1 for n in ast.walk(tree) if isinstance(n, ast.Call)
                 and ast.unparse(n.func) == "_build.check")
    assert launches == checks == _LAUNCHERS[path]


def test_launch_on_takes_the_device_and_stream_of_its_input(monkeypatch):
    """`_build.launch_on` makes the input's device current and hands out the
    current stream of that device (stubbed: this box has no CUDA)."""
    import torch

    from xritdemod_tpu_torch import _build

    seen = []

    class Device:
        def __init__(self, d):
            seen.append(("device", d))

        def __enter__(self):
            seen.append("enter")

        def __exit__(self, *exc):
            seen.append("exit")
            return False

    class Stream:
        cuda_stream = 0x5EED

    def current_stream(device=None):
        seen.append(("stream", device))
        return Stream

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)

    class OnCuda1:
        device = torch.device("cuda", 1)

    with _build.launch_on(OnCuda1()) as stream:
        assert stream == 0x5EED
        assert seen == [("device", OnCuda1.device), "enter", ("stream", OnCuda1.device)]
    assert seen[-1] == "exit"


# -- the public surface: parameter names ------------------------------------------------

# The JAX package's parameters that pick TPU layouts, not functions: ROADMAP's
# "Deliberately not ported" list (the ops' and `parallel/` classes' `unroll`,
# `chunk`, `superchunks`, `staging` and mesh `axis` arguments, and the JAX
# `DemodConfig`'s TPU tuning fields).  Any other parameter of a public
# function or method must exist in the port's counterpart.
NOT_PORTED = frozenset({
    "unroll", "chunk", "superchunks", "staging", "axis",
    "agc_kernel", "costas_kernel", "fir_kernel", "clock_tile", "clock_superchunks",
    "clock_chunk", "frontend_rows", "frontend_fir_inplace", "clock_kernel",
})


def _is_record(cls: ast.ClassDef) -> bool:
    """A dataclass or NamedTuple: its fields are its constructor's parameters."""
    names = {getattr(d, "id", getattr(d, "attr", None)) for d in cls.decorator_list}
    names |= {getattr(d.func, "id", getattr(d.func, "attr", None))
              for d in cls.decorator_list if isinstance(d, ast.Call)}
    return "dataclass" in names or any(
        getattr(b, "id", getattr(b, "attr", None)) == "NamedTuple" for b in cls.bases)


def _public_signatures(path: str) -> dict:
    """`{name: [parameter names in order]}` of a module's public functions
    (and module-level aliases of them), its public classes' public methods
    and `__init__` (`Class.method`), and its records' fields (`Class`)."""
    tree = ast.parse(open(path).read())

    def params(fn):
        a = fn.args
        return ([x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
                + [v.arg for v in (a.vararg, a.kwarg) if v is not None])

    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out[node.name] = params(node)
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Name):
            for t in node.targets:
                if isinstance(t, ast.Name) and node.value.id in out:
                    out[t.id] = out[node.value.id]
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            if _is_record(node):
                out[node.name] = [s.target.id for s in node.body
                                  if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)]
            for s in node.body:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        not s.name.startswith("_") or s.name == "__init__"):
                    out[f"{node.name}.{s.name}"] = params(s)
    return out


def _reference_modules() -> list:
    """The JAX package's modules without Pallas kernels, as relative paths."""
    base = os.path.join(ROOT, "xritdemod_tpu")
    return sorted(
        os.path.relpath(os.path.join(d, f), base)
        for d, _, files in os.walk(base) for f in files
        if f.endswith(".py") and not f.endswith("_pallas.py")
    )


@pytest.mark.parametrize("rel", _reference_modules())
def test_every_public_parameter_has_its_counterpart(rel):
    """Every public function, method and record of the JAX module exists in
    the port's module of the same path, with every parameter name but the
    TPU layout ones (NOT_PORTED)."""
    ref = _public_signatures(os.path.join(ROOT, "xritdemod_tpu", rel))
    if not ref:
        return
    port_path = os.path.join(ROOT, "xritdemod_tpu_torch", rel)
    assert os.path.exists(port_path), rel
    port = _public_signatures(port_path)
    gaps = {name: [p for p in ps if p not in port.get(name, ()) and p not in NOT_PORTED]
            for name, ps in ref.items()}
    assert not [n for n in ref if n not in port], rel
    assert not {n: g for n, g in gaps.items() if g}, rel


# The repairs of the reference's surface pinned by place: the port's
# parameters begin with the reference's, in the reference's order.
PINNED = [("runtime/apps.py", "DemodulatorApp.__init__"), ("runtime/metrics.py", "trace"),
          ("parallel/distributed.py", "initialize"), ("ops/reed_solomon.py", "rs_decode"),
          ("ops/fir.py", "fir_block"), ("ops/fir.py", "fir_block_real_matmul")]


@pytest.mark.parametrize("rel,name", PINNED)
def test_repaired_parameters_keep_the_reference_places(rel, name):
    ref = _public_signatures(os.path.join(ROOT, "xritdemod_tpu", rel))[name]
    port = _public_signatures(os.path.join(ROOT, "xritdemod_tpu_torch", rel))[name]
    assert port[:len(ref)] == ref, (rel, name, port)


def test_the_walk_sees_the_repairs():
    """The walk reads what it should: these parameters were missing before."""
    sig = lambda rel, name: _public_signatures(os.path.join(ROOT, "xritdemod_tpu_torch", rel))[name]
    assert sig("runtime/apps.py", "DemodulatorApp.__init__").index("realtime") == 7
    assert sig("runtime/metrics.py", "trace")[0] == "log_dir"
    assert sig("parallel/distributed.py", "initialize")[3] == "local_device_ids"
    assert sig("ops/reed_solomon.py", "rs_decode") == ["received", "sparse_max"]
    assert "clock_max_block" in sig("models/demodulator.py", "DemodConfig")
    assert sig("ops/agc.py", "agc_block_exact") == sig("ops/agc.py", "agc_block")
