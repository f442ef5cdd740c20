"""CUDA Reed-Solomon (255,223) decoder (K8): wrappers and tables.

Replaces no Pallas kernel: the JAX package decodes in one XLA program,
`rs_decode` with `_rs_correct` (`xritdemod_tpu/ops/reed_solomon.py:313-518`),
GF(2) bit-matrix products, a `lax.scan` of 32 Berlekamp-Massey steps and
`lax.cond`s on device counts that choose a branch.  Its port kept that
program as plain PyTorch, which issues the 32 steps from Python (a dozen ops
each) and reads a count to the host to choose its branch.  The kernel
(`csrc/rs.cu`) decodes every codeword of a batch in one launch and reads
nothing back: a clean codeword comes out as it came, every other one is
corrected (every branch of the reference gives the same rows, so none is
chosen).  Its syndromes are the JAX package's GF(2) product, the received
bits times `syndrome_matrix()`, on the tensor cores; its errored codewords
are corrected one warp a codeword, Berlekamp-Massey as the plain version
steps it.  A clean batch is bound by its bytes; an errored codeword's time
is set by its chain of 32 dependent Berlekamp-Massey steps, which no
roofline counts (`bound_work`).

Two entries: `rs_decode_kernel((B, 255) codewords)` and
`rs_decode_frames_kernel((F, 1020) frames)`, which reads and writes the
4-way interleave in place (codeword i of a frame is bytes i, i + 4, ...).

The plain version is `ops/reed_solomon.py::rs_decode_plain`; the kernel equals
it bit for bit at every `sparse_max`.  `reed_solomon.rs_decode` and
`rs_decode_frame` route: a CPU tensor takes the plain version, a CUDA tensor
this kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from xritdemod_tpu_torch import _build

__all__ = ["rs_decode_kernel", "rs_decode_frames_kernel", "launches", "TABLE_BYTES",
           "syndrome_matrix", "syndrome_fragments", "bound_work", "table_work"]

launches = 0

FRAG_BYTES = 65536       # the syndrome map as the MMA's B fragments (`RS_FRAG_BYTES`)
GF_BYTES = 1024          # exp[512], log[256], tal[256], uint8 (`RS_GF_BYTES`)
TABLE_BYTES = FRAG_BYTES + GF_BYTES
GF_TABLE_BYTES = 1280    # the table algorithm's GF(2^8) tables (`table_work`)


def bound_work(nerr) -> tuple[float, float]:
    """`(bytes, operations)` the least work of this kernel's design on the
    rows whose results are `nerr` (0 clean, L corrected, -1 failed): each
    codeword in and out, its nerr word and the tables once; table
    multiply-adds (two operations each) on the CUDA cores for each errored
    row: Berlekamp-Massey (32 x 33 x 2) and Chien over the 255 positions
    (L + 1 coefficients; a failed row's L taken as 16, as for random
    syndromes but one in 256, which skip Chien at L > 16); for a corrected
    row also Omega (528) and Forney at its L roots (32 each).  The syndromes
    are a b1 product on the tensor cores (2040 x 256 AND + POPC a codeword),
    for which the rate table gives no peak; they are left out (at the int8
    rate, a byte's 8 bits one operand, 8192 codewords take 0.54 us, under
    their 1.28 us of bytes), so a clean batch is bound by its bytes."""
    n = torch.as_tensor(nerr).reshape(-1).to("cpu", torch.int64)
    L = n[n > 0]
    failed = int((n < 0).sum())
    errored = failed + L.numel()
    chien = 255 * (int(L.sum()) + L.numel() + failed * 17)
    ops = 2.0 * (errored * 32 * 33 * 2 + chien + L.numel() * 528 + 32 * int(L.sum()))
    return n.numel() * (2 * 255 + 4) + TABLE_BYTES, ops


def table_work(rows: int, errored: int) -> tuple[float, float]:
    """`(bytes, operations)` of `rows` codewords of which `errored` are
    corrected, as the one-warp table algorithm before the tensor-core design
    counted it (the yardstick both designs are read against): each codeword
    in and out, its nerr word and the GF tables once; table multiply-adds
    (two operations each) of the syndromes (32 x 255 a codeword) and, for an
    errored codeword, Berlekamp-Massey (32 x 33 x 2), Omega (528), Chien
    with Lambda' and Forney (255 x 81)."""
    ops = 2.0 * (rows * 32 * 255 + errored * (32 * 33 * 2 + 528 + 255 * 81))
    return rows * (2 * 255 + 4) + GF_TABLE_BYTES, ops


@functools.lru_cache(maxsize=None)
def syndrome_matrix() -> np.ndarray:
    """`(2040, 256)` uint8 0/1: the syndromes as a GF(2)-linear map of the
    received bits, the dual -> conventional basis map folded in (the JAX
    package's `msyn`, `xritdemod_tpu/ops/reed_solomon.py::_bit_matrices`).
    Row 8 i + j: bit j of received byte i; column 8 k + b: bit b of S_k,
    S_k = XOR_i tal1(r_i) beta^((FCR + k)(254 - i))."""
    from xritdemod_tpu_torch.ops.reed_solomon import _gf_tables, _power_matrices

    bexp, blog, _, tal1tab, _ = _gf_tables()
    syn_pw = _power_matrices()[0]                              # (32, 255)
    conv = tal1tab[1 << np.arange(8)].astype(np.int64)         # bit j's conventional image
    power = bexp[syn_pw].astype(np.int64)                      # (32, 255)
    prod = bexp[(blog[conv][None, None, :] + blog[power][:, :, None]) % 255]
    prod = np.where((conv[None, None, :] == 0) | (power[:, :, None] == 0), 0, prod)
    bits = (prod[..., None] >> np.arange(8)) & 1               # (32 k, 255 i, 8 j, 8 b)
    return np.ascontiguousarray(bits.transpose(1, 2, 0, 3).reshape(255 * 8, 32 * 8),
                                dtype=np.uint8)


def syndrome_fragments(m: np.ndarray | None = None) -> np.ndarray:
    """`syndrome_matrix()` (K padded to 2048) as the kernel reads it: the B
    fragments of `mma.m16n8k256` b1, `(32 n-tiles, 8 k-steps, 32 lanes, 2)`
    uint32.  Lane 4 g + t's two words hold column 8 n + g, rows
    256 c + 32 t + [0, 32) and 256 c + 128 + 32 t + [0, 32), row 32 t + i
    at bit i."""
    m = syndrome_matrix() if m is None else m
    full = np.zeros((2048, 256), np.uint64)
    full[: m.shape[0]] = m
    # k = 256 c + 128 h + 32 t + i, n = 8 nt + g -> (nt, c, g, t, h, i)
    parts = full.reshape(8, 2, 4, 32, 32, 8).transpose(4, 0, 5, 2, 1, 3)
    words = (parts << np.arange(32, dtype=np.uint64)).sum(-1)
    return words.reshape(32, 8, 32, 2).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    """The kernel's `(TABLE_BYTES,)` uint8 tables on `device` (built once a
    device): the syndrome fragments, then exp[512], log[256], tal[256]."""
    from xritdemod_tpu_torch.ops.reed_solomon import _gf_tables

    bexp, blog, taltab, _, _ = _gf_tables()
    packed = np.concatenate([syndrome_fragments().astype("<u4").view(np.uint8).ravel(),
                             bexp.astype(np.uint8), blog.astype(np.uint8),
                             taltab.astype(np.uint8)])
    assert packed.shape == (TABLE_BYTES,)
    return torch.from_numpy(packed).to(device)


def _fn(name: str):
    fn = getattr(_build.load("rs"), name)
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, x: torch.Tensor, n: int, nerr_shape: tuple):
    global launches
    x = x.to(torch.uint8).contiguous()
    out = torch.empty_like(x)
    nerr = torch.empty(nerr_shape, dtype=torch.int32, device=x.device)
    if n == 0:
        return out, nerr
    tables = _tables(x.device)
    with _build.launch_on(x) as stream:
        err = _fn(entry)(x.data_ptr(), out.data_ptr(), nerr.data_ptr(), tables.data_ptr(), n,
                         stream)
    _build.check(err, entry)
    launches += 1
    return out, nerr


@torch.no_grad()
def rs_decode_kernel(received: torch.Tensor):
    """`(B, 255)` dual-basis codewords -> `(corrected (B, 255) uint8,
    nerrors (B,) int32)`, the contract of `reed_solomon.rs_decode`: every
    errored codeword corrected, -1 where that fails (the codeword returned as
    received), 0 for a clean one.  One launch; no host read."""
    if received.ndim != 2 or received.shape[1] != 255 or not received.is_cuda:
        raise ValueError(f"need (B, 255) codewords on a CUDA device, got "
                         f"{tuple(received.shape)} on {received.device}")
    B = received.shape[0]
    return _launch("xrit_rs_decode", received, B, (B,))


@torch.no_grad()
def rs_decode_frames_kernel(frames: torch.Tensor):
    """`(F, 1020)` derandomized frame bytes (codeword i: bytes i, i + 4, ...)
    -> `(corrected (F, 1020) uint8, nerrors (F, 4) int32)`, the contract of
    `reed_solomon.rs_decode_frame`.  One launch, the interleave read and
    written in place: no copy; no host read."""
    if frames.ndim != 2 or frames.shape[1] != 1020 or not frames.is_cuda:
        raise ValueError(f"need (F, 1020) frames on a CUDA device, got "
                         f"{tuple(frames.shape)} on {frames.device}")
    F = frames.shape[0]
    return _launch("xrit_rs_decode_frames", frames, F, (F, 4))
