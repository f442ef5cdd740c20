"""xritdemod_tpu_torch — the PyTorch/CUDA port of the GOES xRIT receive chain.

Same `ops/ models/ utils/ tools/` layout and the same module and function
names as the JAX package `xritdemod_tpu`, so a reader finds each counterpart.
This package imports `torch` and `numpy` only — never `jax`, never
`xritdemod_tpu`.  Entry points (`Demodulator`, `CaduDecoder`, `StreamDecoder`,
`FusedReceiver`) run on the GPU unless the caller passes `device="cpu"`.

The kernels are hand-written CUDA C++ under `csrc/`, built at first use by
`_build.py` and wrapped by `ops/{frontend,clock,viterbi,ring,stream}_cuda.py`
and `tools/roll_probe.py`; each wrapper keeps a plain PyTorch version of the
same function beside it, which is what runs for a CPU tensor.
"""

__version__ = "0.1.0"


def version_info() -> str:
    """Library and version introspection (the reference's SatHelper `Info`):
    the package version, the commit where the package lies in a git checkout,
    and the torch and CUDA versions."""
    import subprocess

    import torch

    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=__path__[0],
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        sha = "unknown"
    return (f"xritdemod_tpu_torch {__version__} ({sha}) on torch {torch.__version__}"
            f" (CUDA {torch.version.cuda})")
