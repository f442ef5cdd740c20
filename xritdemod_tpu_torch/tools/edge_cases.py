"""Seeded inputs for the RS decoder (K8) and the acquisition (K9).

One generator for both checks: the CPU tests hold the plain versions against
the JAX package on these inputs, and `chip_smoke.py` holds each kernel
against its plain version on the same inputs (and on the full-size ones
built here).  numpy only, from a seed.

  - `rs_edge_cases(seed)`: `{name: (received, sent)}` of `(n, 255)` uint8
    dual-basis words that the RS regimes of the decode tests do not reach:
    exactly 16 and exactly 17 symbol errors; errors in the parity bytes
    only; errors at bytes 0 and 254; the all-zero and all-0xFF words (both
    codewords) with and without errors; 17 errors placed 16 symbols from
    another codeword (the decoder returns that wrong codeword); random words
    (L = 16, no valid locator); words whose Berlekamp-Massey length is 18.
  - `rs_batch(cases, rows, seed)`: every case's words in one `(rows, 255)`
    batch, the rest clean codewords.
  - `acquire_ring(C, lags, words, seed)`: a `(C, lags + 63 + 64)` float32
    ring whose first channels hold the acquisition's edges (a sync at lag 0
    and at the last lag, each word, a tie between words and one between
    lags, -0.0 symbols, a word below the threshold, no sync at all) and the
    rest a sync at a random lag or noise; EDGE_CHANNELS is the count of edge
    channels.
"""

from __future__ import annotations

import numpy as np

from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch.ops.correlator import UW_BITS
from xritdemod_tpu_torch.ops.reed_solomon import _gf_tables, rs_encode_np
from xritdemod_tpu_torch.utils.bits import bits_of_u64

__all__ = ["rs_edge_cases", "rs_batch", "acquire_ring", "EDGE_CHANNELS", "BELOW_FLIPS"]

_N, _K = 255, 223


def _codewords(rng, n: int) -> np.ndarray:
    return rs_encode_np(rng.integers(0, 256, (n, _K), dtype=np.int64).astype(np.uint8))


def _hit(rng, words: np.ndarray, positions) -> np.ndarray:
    """`words` with a non-zero error added at each row's `positions`."""
    out = words.copy()
    for row, pos in zip(out, positions):
        pos = np.asarray(pos, np.int64)
        row[pos] ^= rng.integers(1, 256, pos.size).astype(np.uint8)
    return out


def rs_edge_cases(seed: int = 0) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """`{name: (received (n, 255) uint8, sent (n, 255) uint8)}`, dual basis."""
    rng = np.random.default_rng(seed)
    pick = lambda lo, hi, k: rng.choice(np.arange(lo, hi), size=k, replace=False)
    cases = {}
    sent = _codewords(rng, 6)
    cases["errors16"] = (_hit(rng, sent, [pick(0, _N, 16) for _ in sent]), sent)
    sent = _codewords(rng, 6)
    cases["errors17"] = (_hit(rng, sent, [pick(0, _N, 17) for _ in sent]), sent)
    sent = _codewords(rng, 6)
    cases["parity_only"] = (_hit(rng, sent, [pick(_K, _N, k) for k in (1, 2, 8, 15, 16, 17)]),
                            sent)
    sent = _codewords(rng, 4)
    ends = [[0], [_N - 1], [0, _N - 1], np.r_[0, _N - 1, pick(1, _N - 1, 14)]]
    cases["ends"] = (_hit(rng, sent, ends), sent)
    for name, byte in (("zeros", 0x00), ("ones", 0xFF)):
        sent = np.full((4, _N), byte, np.uint8)
        cases[name] = (_hit(rng, sent, [[], [0, _N - 1], pick(0, _N, 16), pick(0, _N, 17)]),
                       sent)
    # A codeword of the least weight, 33: one message byte and the parity.
    msg = np.zeros((1, _K), np.uint8)
    msg[0, -1] = 1 + rng.integers(0, 255)
    light = rs_encode_np(msg)[0]
    support = np.flatnonzero(light)
    assert support.size == 33
    sent = _codewords(rng, 4)
    recv = sent.copy()
    for row in recv:
        part = rng.choice(support, size=17, replace=False)
        row[part] ^= light[part]          # 17 from `sent`, 16 from sent ^ light
    cases["miscorrect"] = (recv, sent)
    words = rng.integers(0, 256, (8, _N), dtype=np.int64).astype(np.uint8)
    cases["random"] = (words, words.copy())
    words = _length18(rng, 4)
    cases["length18"] = (words, words.copy())
    return cases


def _length18(rng, n: int) -> np.ndarray:
    """Words whose first 17 syndromes vanish (multiples of the product of
    the first 17 roots' factors) and the rest do not: Berlekamp-Massey
    meets its first discrepancy at step 17 and ends with L = 18 > 16."""
    bexp, blog, taltab, _, _ = _gf_tables()
    mul = lambda a, b: 0 if a == 0 or b == 0 else int(bexp[blog[a] + blog[b]])
    g = [1]
    for j in range(17):
        root = int(bexp[(C.RS_FCR + j) % 255])
        g = [(g[d - 1] if d else 0) ^ (mul(g[d], root) if d < len(g) else 0)
             for d in range(len(g) + 1)]
    out = np.zeros((n, _N), np.uint8)
    for row in out:
        w = [0] * _N
        for a, m in enumerate(rng.integers(1, 256, _N - 17)):
            for d, gd in enumerate(g):
                w[a + d] ^= mul(int(m), gd)
        row[:] = taltab[np.array(w[::-1], np.uint8)]     # byte i: the power 254 - i
    return out


def rs_batch(cases: dict, rows: int, seed: int = 1) -> np.ndarray:
    """Every case's received words, then clean codewords up to `rows`."""
    words = np.concatenate([recv for recv, _ in cases.values()])
    if words.shape[0] > rows:
        raise ValueError(f"{words.shape[0]} edge words do not fit in {rows} rows")
    pad = _codewords(np.random.default_rng(seed), rows - words.shape[0])
    return np.concatenate([words, pad])


EDGE_CHANNELS = 10
BELOW_FLIPS = 20          # bits flipped in the below-threshold word: 44 of 64 match


def _signs(word: int) -> np.ndarray:
    """The +-1 pattern a 64-bit word expects (bit 1: a negative symbol)."""
    return 1.0 - 2.0 * bits_of_u64(word).astype(np.float32)


def acquire_ring(C: int, words: list[int], lags: int = 16384, seed: int = 0) -> np.ndarray:
    """`(C, lags + 63 + 64)` float32 soft symbols (see the module docstring);
    the first EDGE_CHANNELS channels are the edges, in this order:
    noise; word 0 at lag 0; word 1 at the last lag; word 0 at a middle lag;
    word 1 at lag 100 and word 0 at 5000 (the words tie: word 0's wins);
    word 0 at lags 300 and 9000 (the lags tie: 300 wins); -0.0 everywhere
    but a word 0 whose +1 symbols are -0.0 ones (bit 0, so it matches);
    +1 everywhere but a word 0 with BELOW_FLIPS bits flipped (below the
    threshold); +1 everywhere (every lag ties); word 1 at lag 1 on a ring of
    -0.0."""
    rng = np.random.default_rng(seed)
    L = lags + UW_BITS - 1 + 64
    if C < EDGE_CHANNELS or lags < 9000 + 64:
        raise ValueError(f"need C >= {EDGE_CHANNELS} and lags >= 9064")
    ring = rng.normal(0.0, 1.0, (C, L)).astype(np.float32)
    w0, w1 = _signs(words[0]), _signs(words[1])

    def put(c: int, lag: int, pattern: np.ndarray) -> None:
        ring[c, lag : lag + UW_BITS] = 0.5 * pattern

    put(1, 0, w0)
    put(2, lags - 1, w1)
    put(3, lags // 2 + 17, w0)
    put(4, 100, w1)
    put(4, 5000, w0)
    put(5, 300, w0)
    put(5, 9000, w0)
    ring[6] = -0.0
    ring[6, 40:104] = np.where(w0 < 0, -0.5, -0.0)
    ring[7] = 1.0
    flipped = w0.copy()
    flipped[rng.choice(UW_BITS, BELOW_FLIPS, replace=False)] *= -1
    put(7, 2000, flipped)
    ring[8] = 1.0
    ring[9] = -0.0
    put(9, 1, w1)
    for c in range(EDGE_CHANNELS, C):
        if rng.random() < 0.75:
            put(c, int(rng.integers(0, lags)), w0 if rng.random() < 0.5 else w1)
    return ring
