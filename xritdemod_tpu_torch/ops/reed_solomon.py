"""CCSDS Reed-Solomon (255,223) dual-basis codec, batched.

Counterpart of `xritdemod_tpu/ops/reed_solomon.py`.  All four interleaved
blocks of a whole batch of frames decode together: syndromes, Berlekamp-
Massey (a fixed 32 iterations with masked updates), Chien search and Forney
evaluation.  A CUDA tensor takes the kernel (`ops/rs_cuda.py`, `csrc/rs.cu`):
every codeword of the batch in one launch, nothing read back to the host,
frames through its frame entry, which reads the interleave in place.
A CPU tensor takes the plain version, `rs_decode_plain`: GF(2^8) arithmetic
as integer log/exp table lookups by tensor indexing (the JAX package's GF(2)
bit-matrix matmuls and one-hot row compaction exist because gathers
serialise on its device, and are not carried over), its correction stages
on a batch's errored codewords only where the batch has some: the
reference's sparse path (`sparse_max`), rows gathered and scattered by
index, or every row when more err; one count read to the host chooses.
The results of both, and of every branch, are identical to correcting every
row.

Code parameters (CCSDS 131.0-B): field polynomial x^8+x^7+x^2+x+1 (0x187),
generator roots alpha^(11*112)..alpha^(11*143) (fcr=112, prim=11).  Working
base beta = alpha^11 absorbs `prim`, so the code is a conventional fcr=112
RS code in beta-logs.  Symbols travel in the Berlekamp dual basis.

Returns per-codeword corrected-symbol counts with -1 marking decode failure,
and the corrected output including parity.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch.ops import rs_cuda

__all__ = [
    "branches",
    "deinterleave",
    "interleave",
    "rs_decode",
    "rs_decode_plain",
    "rs_decode_frame",
    "rs_decode_frame_plain",
    "rs_encode_np",
    "to_conventional",
    "to_dual",
]

_N = C.RS_N            # 255
_K = C.RS_K            # 223
_T2 = _N - _K          # 32 parity symbols
_NPOLY = _T2 + 1       # error-locator capacity (deg <= 32)
_FCR = C.RS_FCR        # 112
_PRIM = C.RS_PRIM      # 11

# Dual (Berlekamp) basis images of the conventional basis elements; bit j of
# a conventional byte contributes tal[7-j].  Values are the CCSDS standard's.
_TAL = np.array([0x8D, 0xEF, 0xEC, 0x86, 0xFA, 0x99, 0xAF, 0x7B], np.uint8)


@functools.lru_cache(maxsize=None)
def _gf_tables():
    """(bexp, blog, taltab, tal1tab, genpoly) numpy tables, beta = alpha^11."""
    aexp = np.zeros(255, np.int32)
    x = 1
    for i in range(255):
        aexp[i] = x
        x <<= 1
        if x & 0x100:
            x ^= C.RS_GF_POLY
    # beta = alpha^prim tables (double length to skip the mod in lookups).
    bexp = np.zeros(512, np.int32)
    for i in range(255):
        bexp[i] = aexp[(i * _PRIM) % 255]
        bexp[i + 255] = bexp[i]
    blog = np.zeros(256, np.int32)
    for i in range(255):
        blog[bexp[i]] = i
    blog[0] = 0  # callers must mask zero operands

    taltab = np.zeros(256, np.uint8)
    for i in range(256):
        v = 0
        for j in range(8):
            if i & (1 << j):
                v ^= _TAL[7 - j]
        taltab[i] = v
    tal1tab = np.zeros(256, np.uint8)
    tal1tab[taltab] = np.arange(256, dtype=np.uint8)
    assert len(set(taltab.tolist())) == 256, "dual-basis map must be bijective"

    # Generator polynomial: g(x) = prod_j (x - beta^(FCR+j)).
    def mul(a, b):
        if a == 0 or b == 0:
            return 0
        return int(bexp[blog[a] + blog[b]])

    g = np.zeros(_T2 + 1, np.int32)
    g[0] = 1
    for j in range(_T2):
        root = int(bexp[_FCR + j])
        ng = np.zeros_like(g)
        for d in range(j + 1, -1, -1):
            ng[d] = (g[d - 1] if d > 0 else 0) ^ mul(g[d], root)
        g = ng
    return bexp, blog, taltab, tal1tab, g


@functools.lru_cache(maxsize=None)
def _power_matrices():
    """Static exponent matrices for the syndrome/Chien/Forney sweeps."""
    i = np.arange(_N)
    k = np.arange(_T2)
    # Syndrome: S_k = XOR_i c_i * beta^((FCR+k)*(254-i))
    syn_pw = ((_FCR + k)[:, None] * (254 - i)[None, :]) % 255       # (32, 255)
    p = np.arange(_N)
    kk = np.arange(_NPOLY)
    chien_pw = ((255 - p)[:, None] * kk[None, :]) % 255              # (255, 33)
    xpow = (p * (1 - _FCR)) % 255                                    # (255,)
    return syn_pw.astype(np.int32), chien_pw.astype(np.int32), xpow.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    bexp, blog, taltab, tal1tab, _ = _gf_tables()
    syn_pw, chien_pw, xpow = _power_matrices()
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32).copy()).to(device)
    return dict(
        bexp=t(bexp), blog=t(blog), tal=t(taltab), tal1=t(tal1tab),
        syn_pw=t(syn_pw), chien_pw=t(chien_pw), xpow=t(xpow),
    )


def _tables(device) -> dict:
    return _device_tables(torch.device(device))


# --------------------------------------------------------------------------
# GF helpers (int32 lanes, table lookups)
# --------------------------------------------------------------------------

def _gfmul(a, b, tb):
    prod = tb["bexp"][tb["blog"][a] + tb["blog"][b]]
    return torch.where((a == 0) | (b == 0), 0, prod)


def _gfmul_pow(a, pw, tb):
    """a * beta^pw for a data tensor `a` and a tensor of exponents < 255."""
    prod = tb["bexp"][tb["blog"][a] + pw]
    return torch.where(a == 0, 0, prod)


def _gfinv(a, tb):
    """GF inverse (0 -> 0)."""
    inv = tb["bexp"][255 - tb["blog"][a]]
    return torch.where(a == 0, 0, inv)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (torch has no xor reduction): halving folds."""
    n = x.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = torch.nn.functional.pad(x, (0, size - n))
    while size > 1:
        size //= 2
        x = x[..., :size] ^ x[..., size:]
    return x[..., 0]


def to_conventional(data: torch.Tensor) -> torch.Tensor:
    return _tables(data.device)["tal1"][data.to(torch.int32)]


def to_dual(data: torch.Tensor) -> torch.Tensor:
    return _tables(data.device)["tal"][data.to(torch.int32)]


# --------------------------------------------------------------------------
# Interleaving (block i = bytes i::4, newdecoder.cpp:315-318)
# --------------------------------------------------------------------------

def deinterleave(frame: torch.Tensor, nblocks: int = C.RS_BLOCKS) -> torch.Tensor:
    """`(..., nblocks*255)` -> `(..., nblocks, 255)`."""
    lead = frame.shape[:-1]
    return frame.reshape(lead + (_N, nblocks)).transpose(-1, -2)


def interleave(blocks: torch.Tensor) -> torch.Tensor:
    """`(..., nblocks, 255)` -> `(..., nblocks*255)`."""
    lead = blocks.shape[:-2]
    nblocks = blocks.shape[-2]
    return blocks.transpose(-1, -2).reshape(lead + (nblocks * _N,))


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------

# Rows per syndrome sweep: bounds the (rows, 32, 255) int32 temporaries.
_SYN_CHUNK = 2048

# Calls of `rs_decode_plain` by the branch they took: "clean" (no codeword
# erred), "sparse" (at most Kmax erred: Kmax rows corrected), "full" (more
# than Kmax erred: every row corrected) and "rows" (`sparse_max` 0 or >= B:
# the errored rows, found by one variable-length read).  The kernel takes no
# branch.
branches = {"clean": 0, "sparse": 0, "full": 0, "rows": 0}


def rs_decode(received: torch.Tensor, sparse_max: int | None = None):
    """Decode `(B, 255)` dual-basis codewords.

    Returns `(corrected, nerrors)`: corrected `(B, 255)` dual-basis uint8
    bytes (parity included) and `(B,)` int32 corrected-symbol counts, -1 on
    decode failure (uncorrectable; the row is returned as received).

    On a CUDA tensor the kernel (`rs_cuda.rs_decode_kernel`) corrects every
    errored row in one launch and reads nothing back to the host, whatever
    `sparse_max` says; on a CPU tensor `rs_decode_plain` takes the branch
    `sparse_max` chooses.  Both give the same results.
    """
    if received.is_cuda:
        return rs_cuda.rs_decode_kernel(received)
    return rs_decode_plain(received, sparse_max)


def rs_decode_plain(received: torch.Tensor, sparse_max: int | None = None):
    """Plain PyTorch version of `rs_decode` (the kernel's golden model), on
    any device.

    `sparse_max` Kmax (None: `_default_sparse_max(B)`, which reads
    XRIT_RS_SPARSE at the call): with 0 < Kmax < B one count of errored rows
    is read to the host; none erred, the batch is returned as it came; at
    most Kmax, the first Kmax rows of a stable sort that puts the errored
    ones first (the reference's order) are corrected, gathered and scattered
    back by index, at shapes that do not depend on the data; more, every row
    is corrected.  Kmax 0 (or >= B) corrects the errored rows alone, found
    by one variable-length read.  Every branch gives the same results.
    """
    tb = _tables(received.device)
    r = tb["tal1"][received.to(torch.int32)]              # conventional basis
    B = r.shape[0]
    S = _syndromes(r, tb)                                 # (B, 32)
    has_err = (S != 0).any(-1)
    nerr = torch.zeros((B,), dtype=torch.int32, device=r.device)
    if sparse_max is None:
        sparse_max = _default_sparse_max(B)

    if not (0 < sparse_max < B):
        rows = torch.nonzero(has_err)[:, 0]     # host read: which rows to fix
        branches["rows"] += 1
        if rows.numel():
            fixed, n = _rs_correct(S[rows], r[rows], tb)
            r = r.index_copy(0, rows, fixed)
            nerr = nerr.index_copy(0, rows, n)
        return tb["tal"][r].to(torch.uint8), nerr

    nerrored = int(has_err.sum())               # host read: which branch
    if nerrored == 0:
        branches["clean"] += 1
        return tb["tal"][r].to(torch.uint8), nerr
    if nerrored <= sparse_max:
        branches["sparse"] += 1
        sel = torch.argsort((~has_err).to(torch.uint8), stable=True)[:sparse_max]
        he = has_err[sel]
        fixed, n = _rs_correct(S[sel], r[sel], tb)
        # A clean row among the Kmax (padding) is no failure: kept as it came.
        r = r.index_copy(0, sel, torch.where(he[:, None], fixed, r[sel]))
        nerr = nerr.index_copy(0, sel, torch.where(he, n, 0))
    else:
        branches["full"] += 1
        fixed, n = _rs_correct(S, r, tb)
        r = torch.where(has_err[:, None], fixed, r)
        nerr = torch.where(has_err, n, 0)
    return tb["tal"][r].to(torch.uint8), nerr


def _default_sparse_max(B: int) -> int:
    """The reference's automatic Kmax: ~B/16 rounded up to a multiple of 128,
    at most B/2, for batches of 1024 rows or more; 0 below, or when the
    environment variable XRIT_RS_SPARSE is "0" (read at each call)."""
    if B < 1024 or os.environ.get("XRIT_RS_SPARSE", "1") == "0":
        return 0
    return min(B // 2, -(-max(128, B // 16) // 128) * 128)


def _syndromes(r, tb):
    """`(B, 255)` conventional-basis words -> `(B, 32)` syndromes,
    S_k = XOR_i r_i * beta^((FCR+k)*(254-i))."""
    return torch.cat(
        [
            _xor_reduce(_gfmul_pow(r[i : i + _SYN_CHUNK, None, :], tb["syn_pw"], tb))
            for i in range(0, r.shape[0], _SYN_CHUNK)
        ]
    )


def _rs_correct(S, r, tb):
    """BM + Chien + Forney on `(B, 32)` non-zero syndromes, correcting
    `(B, 255)` conventional-basis codewords."""
    B = S.shape[0]
    dev = S.device
    i32 = torch.int32

    # ---- Berlekamp-Massey: 32 masked iterations --------------------------
    Szp = torch.cat([torch.zeros((B, _NPOLY), dtype=i32, device=dev), S], -1)
    Lam = torch.zeros((B, _NPOLY), dtype=i32, device=dev)
    Lam[:, 0] = 1
    Bp = Lam.clone()
    L = torch.zeros((B,), dtype=i32, device=dev)
    binv = torch.ones((B,), dtype=i32, device=dev)   # 1/b, kept incrementally
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    for rr in range(_T2):
        Sg = torch.flip(Szp[:, rr + 1 : rr + 1 + _NPOLY], (-1,))   # S_{rr-k}
        d = _xor_reduce(_gfmul(Lam, Sg, tb))                       # (B,)
        Bx = torch.cat([zcol, Bp[:, :-1]], -1)
        frac = _gfmul(d, binv, tb)
        adj = _gfmul(frac[:, None], Bx, tb)
        nz = d != 0
        newLam = torch.where(nz[:, None], Lam ^ adj, Lam)
        grow = nz & (2 * L <= rr)
        Bp = torch.where(grow[:, None], Lam, Bx)
        binv = torch.where(grow, _gfinv(d, tb), binv)
        L = torch.where(grow, rr + 1 - L, L)
        Lam = newLam

    # ---- Chien search: Lambda at every beta^-p ---------------------------
    lam_eval = _xor_reduce(_gfmul_pow(Lam[:, None, :], tb["chien_pw"], tb))
    root = lam_eval == 0                                           # (B, 255)
    nroots = root.sum(-1).to(i32)

    # ---- Omega = S(x)*Lambda(x) mod x^32 ---------------------------------
    LamP = torch.cat(
        [torch.zeros((B, _T2 - 1), dtype=i32, device=dev), Lam[:, :_T2]], -1
    )                                                              # (B, 63)
    W = torch.flip(LamP.unfold(-1, _T2, 1), (-1,))                 # (B, 32, 32)
    Om = _xor_reduce(_gfmul(S[:, None, :], W, tb))                 # (B, 32)

    # ---- Forney ----------------------------------------------------------
    num = _xor_reduce(
        _gfmul_pow(Om[:, None, :], tb["chien_pw"][:, :_T2], tb)
    )
    num = _gfmul_pow(num, tb["xpow"], tb)                 # X^(1-FCR) factor
    # Lambda' (formal derivative = odd coefficients, at even powers).
    dl = Lam[:, 1::2]                                              # (B, 16)
    dlam_eval = _xor_reduce(
        _gfmul_pow(dl[:, None, :], tb["chien_pw"][:, 0:_T2:2], tb)
    )                                                              # (B, 255)
    e = _gfmul(num, _gfinv(dlam_eval, tb), tb)
    e = torch.where(root & (dlam_eval != 0), e, 0)

    # Error at power p sits at byte index 254 - p.
    corrected = r ^ torch.flip(e, (-1,))
    ok = (nroots == L) & (L > 0) & (L <= C.RS_T)
    nerr = torch.where(ok, L, -1).to(i32)
    return torch.where(ok[:, None], corrected, r), nerr


def rs_decode_frame(frames: torch.Tensor):
    """Decode `(B, 1020)` derandomized frame bytes (4-way interleave).

    Returns `(corrected (B, 1020) uint8, nerrors (B, 4) int32)`.  On a CUDA
    tensor one launch of the kernel's frame entry
    (`rs_cuda.rs_decode_frames_kernel`), which reads the interleave in place;
    on a CPU tensor the codewords are taken apart and `rs_decode` decodes
    them.
    """
    if frames.is_cuda:
        return rs_cuda.rs_decode_frames_kernel(frames)
    return _frame_route(frames, rs_decode)


def rs_decode_frame_plain(frames: torch.Tensor, sparse_max: int | None = None):
    """Plain PyTorch version of `rs_decode_frame` (the frame entry's golden
    model), on any device: the codewords taken apart, `rs_decode_plain` at
    `sparse_max`, the interleave put back."""
    return _frame_route(frames, lambda blocks: rs_decode_plain(blocks, sparse_max))


def _frame_route(frames: torch.Tensor, decode):
    B = frames.shape[0]
    blocks = deinterleave(frames).reshape(B * C.RS_BLOCKS, _N)
    corr, nerr = decode(blocks)
    corr = interleave(corr.reshape(B, C.RS_BLOCKS, _N))
    return corr, nerr.reshape(B, C.RS_BLOCKS)


# --------------------------------------------------------------------------
# Host-side encoder (fixtures/tests; the satellite is the real encoder)
# --------------------------------------------------------------------------

def rs_encode_np(data: np.ndarray) -> np.ndarray:
    """Encode `(..., 223)` dual-basis data -> `(..., 255)` dual codewords.

    Vectorized over rows: the LFSR division steps through the 223 message
    positions sequentially, each step's feedback multiply one table lookup
    across all rows and the 32 parity lanes."""
    bexp, blog, taltab, tal1tab, g = _gf_tables()
    data = np.asarray(data, np.uint8)
    flat = data.reshape(-1, _K)
    R = flat.shape[0]
    msg = tal1tab[flat].astype(np.int32)                 # (R, 223) conv basis
    gr = np.asarray([int(g[_T2 - 1 - d]) for d in range(_T2)], np.int32)
    glog = blog[gr]                                       # (32,)
    gzero = gr == 0
    par = np.zeros((R, _T2), np.int32)
    for i in range(_K):
        fb = msg[:, i] ^ par[:, 0]                        # (R,)
        par[:, :-1] = par[:, 1:]
        par[:, -1] = 0
        nz = fb != 0
        if nz.any():
            prod = bexp[blog[fb[nz]][:, None] + glog[None, :]]
            prod = np.where(gzero[None, :], 0, prod)
            par[nz] ^= prod
    out = np.zeros((R, _N), np.uint8)
    out[:, :_K] = flat
    out[:, _K:] = taltab[par.astype(np.uint8)]
    return out.reshape(data.shape[:-1] + (_N,))
