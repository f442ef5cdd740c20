"""Nothing the harness runs loads JAX or the JAX package, and the plain
reference loads nothing of the program.  Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "xritdemod_tpu"}
PROGRAM = "xritdemod_tpu_torch"


def imports_of(path: Path) -> set:
    """Every module `path` imports, by its full dotted name."""
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            found.add(node.module)
            found |= {f"{node.module}.{a.name}" for a in node.names}
    return found


def closure(files) -> set:
    """Modules imported by `files` and, through the benchmark's own modules,
    by everything they import."""
    seen, todo, mods = set(), list(files), set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for m in imports_of(f):
            mods.add(m)
            if m.split(".")[0] == "benchmark":
                p = ROOT / Path(*m.split("."))
                for cand in (p.with_suffix(".py"), p / "__init__.py"):
                    if cand.exists():
                        todo.append(cand)
    return mods


def harness_files():
    # run.py loads the entries and readers by name, so all of them count.
    return [BENCH / "run.py", *BENCH.glob("entries/*.py"), *BENCH.glob("metrics/*.py"),
            *BENCH.glob("rooflines/*.py"), *BENCH.glob("harness/*.py"),
            *BENCH.glob("source/*.py"), *BENCH.glob("reference/*.py")]


def test_the_harness_imports_neither_jax_nor_the_jax_package():
    tops = {m.split(".")[0] for m in closure(harness_files())}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert PROGRAM in tops           # it does drive the port


def test_the_reference_imports_nothing_of_the_program():
    mods = closure(list(BENCH.glob("reference/*.py")))
    tops = {m.split(".")[0] for m in mods}
    assert not tops & (FORBIDDEN | {PROGRAM, "torch"}), tops
    assert all(m.startswith("benchmark.reference") for m in mods if m.startswith("benchmark"))


def test_a_loaded_harness_holds_no_jax_module():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.entries.site, "
            "xritdemod_tpu_torch.models.receiver, xritdemod_tpu_torch.parallel.timeblocks; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (str(ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
