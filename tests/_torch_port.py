"""Shared helpers for the tests of the PyTorch port (`tests/test_torch_*.py`).

Every test makes its inputs with numpy from a fixed seed and hands the same
arrays to the JAX package and to the port, both on the CPU.
"""

import socket
import time

import jax
import numpy as np
import torch

from xritdemod_tpu_torch import convert, tx


def tnp(t):
    """Port output (tensor / CF32 / nested tuples) -> numpy, same nesting."""
    return convert.to_numpy(t)


def jnp_tree(tree):
    """JAX pytree -> same pytree with numpy leaves."""
    return jax.tree.map(np.asarray, tree)


def make_capture(cfg, channels, frames_per_channel, lrit=True, noise=0.05):
    """Per-channel IQ captures carrying real CADU streams (distinct VCIDs),
    made by the port's own synthesiser; returns (`(C, n)` complex64, vcdus)."""
    sigs, vcdus = [], []
    for c in range(channels):
        v = tx.make_vcdus(
            frames_per_channel, scid=13, vcid=c + 1, counter0=100 * c,
            rng=np.random.default_rng(50 + c),
        )
        symbols = tx.encode_stream(v, lrit=lrit, rng=np.random.default_rng(90 + c))
        sigs.append(
            tx.modulate(
                symbols, cfg, np.random.default_rng(10 + c),
                freq_offset=1e-4, phase=0.4 + 0.3 * c, noise=noise,
            )
        )
        vcdus.append(v)
    n = min(len(s) for s in sigs)
    return np.stack([s[:n] for s in sigs]), vcdus


def present(tb, jb=None):
    """Names of the FrameBatch fields present in `tb` (forensics fields are
    None without `DecoderConfig.forensics`); with `jb`, also asserts that the
    same fields are absent from both."""
    if jb is not None:
        for f in tb._fields:
            assert (getattr(tb, f) is None) == (getattr(jb, f) is None), f
    return [f for f in tb._fields if getattr(tb, f) is not None]


def frames_of(batch, ok=None):
    """Per channel, the `(vcid, counter, vcdu bytes)` of every good frame of a
    `(C, k)`-leading FrameBatch (numpy or tensor fields), in order."""
    get = lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    fok, vcid, ctr, vc = (get(getattr(batch, f)) for f in ("frame_ok", "vcid", "counter", "vcdu"))
    out = []
    for c in range(fok.shape[0]):
        out.append(
            [
                (int(vcid[c, i]), int(ctr[c, i]), bytes(vc[c, i]))
                for i in range(fok.shape[1])
                if fok[c, i]
            ]
        )
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def until(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def quiet(collectors, settle=0.3):
    """Wait until nothing has arrived on any collector for `settle` s."""
    last = None
    while True:
        cur = sum(len(c.data) for c in collectors)
        if cur == last:
            return
        last = cur
        time.sleep(settle)


def assert_soft_close(got, want, valid, atol=5e-4):
    """Soft symbols of two demodulators that agree to a rounding: within
    `atol` (the serial path's 5e-4) on all but at most 0.5 % of the valid
    symbols, those within 1e-2, and every decision equal.  Over long blocks
    a rounding difference (the exact AGC against the reference's
    associative scan, or the decimating FIR's order of sums) now and then
    moves the clock's mu across one of the MMSE table's 128 rows: that
    symbol moves by up to ~3e-3 and the next few by less, until the loop
    pulls them back."""
    got, want, valid = (np.asarray(a) for a in (got, want, valid))
    g, w = got[valid], want[valid]
    err = np.abs(g - w)
    assert (err > atol).sum() <= 0.005 * valid.sum(), int((err > atol).sum())
    assert err.max(initial=0.0) < 1e-2, float(err.max())
    np.testing.assert_array_equal(g < 0, w < 0)
