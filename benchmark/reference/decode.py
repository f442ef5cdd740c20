"""The CADU decoder of the GOES xRIT downlinks, plain numpy.

The reference decoder's frame chain (opensatelliteproject/xritdemod,
decoder/src/newdecoder.cpp) with the published codes:

- sync words: the coded 64-bit unique words (newdecoder.cpp:21-24), soft
  symbol < 0 is bit 1; a word's count is the number of matching bits; the
  LRIT frame matched by the second word (180 degrees) is negated.
- Viterbi: CCSDS rate 1/2, K = 7 (polynomials 0x4F, 0x6D, coded bits
  inverted), soft decisions, 64 symbols of the previous frame prepended as
  warm-up history; the corrected-bit count is the Hamming distance between
  the received hard decisions and the re-encoded survivor path.
- NRZ-M (HRIT only) over the decoded bytes, the CCSDS pseudo-random sequence
  (x^8 + x^7 + x^5 + x^3 + 1, all ones) over the 1020 bytes after the sync
  marker, and Reed-Solomon (255, 223), E = 16, interleave 4, Berlekamp's
  dual basis, field x^8 + x^7 + x^2 + x + 1, first root 112, primitive 11
  (CCSDS 131.0-B), decoded per codeword as Phil Karn's `decode_rs`.
- VCDU header: spacecraft id, virtual channel id, 24-bit counter (:342-349).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

CODED = 16384                 # soft symbols of a coded frame
HIST = 64                     # symbols of Viterbi history
UW_BITS = 64
FRAME_BYTES = 1024
VCDU_BYTES = 892
MIN_CORRELATION = 46
SYNC_MARKER = 0x1ACFFC1D
WORDS = {
    "lrit": (0xFCA2B63DB00D9794, 0x035D49C24FF2686B),
    "hrit": (0xFC4EF4FD0CC2DF89, 0x25010B02F33D2076),
}
POLY_A, POLY_B, K = 0x4F, 0x6D, 7

NN, NROOTS, FCR, PRIM, IPRIM = 255, 32, 112, 11, 116
_TAL = (0x8D, 0xEF, 0xEC, 0x86, 0xFA, 0x99, 0xAF, 0x7B)


def templates(mode: str) -> np.ndarray:
    """`(2, 64)` +-1 templates of the mode's words (bit 1 -> -1)."""
    return np.array([[1.0 - 2.0 * ((w >> (63 - i)) & 1) for i in range(UW_BITS)]
                     for w in WORDS[mode]])


def signs(soft: np.ndarray) -> np.ndarray:
    return np.where(soft < 0, -1.0, 1.0)


def word_counts(soft64: np.ndarray, tmpl: np.ndarray) -> np.ndarray:
    """Matching bits of each word against 64 soft symbols."""
    return (UW_BITS + tmpl @ signs(soft64)) / 2


def acquire(window: np.ndarray, tmpl: np.ndarray, threshold: int = MIN_CORRELATION) -> int:
    """Lag of the best match over every lag of `window` (ties: lower word,
    then lower lag); 0 below the threshold."""
    s = signs(window)
    lags = len(window) - UW_BITS + 1
    view = np.lib.stride_tricks.sliding_window_view(s, UW_BITS)[:lags]
    counts = (UW_BITS + view @ tmpl.T) / 2                  # (lags, W)
    flat = counts.T.reshape(-1)
    best = int(np.argmax(flat))                             # first maximum
    return best % lags if flat[best] >= threshold else 0


@lru_cache(maxsize=None)
def _branch_signs():
    """For next state n: the expected +-1 symbols of both coded bits from
    predecessor n >> 1 (register n) and (n >> 1) + 32 (register n + 64)."""
    par = lambda v: bin(v).count("1") & 1
    n = np.arange(64)
    g = lambda sr, poly: np.array([1.0 - 2.0 * (par(int(r) & poly) ^ 1) for r in sr])
    return g(n, POLY_A), g(n, POLY_B), g(n + 64, POLY_A), g(n + 64, POLY_B)


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """`(..., T)` bits from a zero register -> `(..., 2T)` coded bits."""
    lead = bits.shape[:-1]
    ext = np.concatenate([np.zeros(lead + (K - 1,), np.uint8), bits.astype(np.uint8)], -1)
    T = bits.shape[-1]
    c1 = np.zeros(lead + (T,), np.uint8)
    c2 = np.zeros(lead + (T,), np.uint8)
    for k in range(K):
        w = ext[..., k:k + T]
        if (POLY_A >> (K - 1 - k)) & 1:
            c1 ^= w
        if (POLY_B >> (K - 1 - k)) & 1:
            c2 ^= w
    return np.stack([c1 ^ 1, c2 ^ 1], -1).reshape(lead + (2 * T,))


def viterbi(soft: np.ndarray):
    """`(F, 2T)` soft symbols -> (`(F, T)` bits, `(F,)` corrected-bit counts).
    Path metrics sum the symbols' agreement; of two equal candidates the
    predecessor n >> 1 is kept, and the first best end state is traced."""
    soft = np.asarray(soft, np.float64)
    F, T2 = soft.shape
    T = T2 // 2
    g10, g20, g11, g21 = _branch_signs()
    pred0 = np.arange(64) >> 1
    pm = np.zeros((F, 64))
    dec = np.empty((T, F, 64), bool)
    a_all, b_all = soft[:, 0::2], soft[:, 1::2]
    for t in range(T):
        a, b = a_all[:, t:t + 1], b_all[:, t:t + 1]
        c0 = pm[:, pred0] + (a * g10 + b * g20)
        c1 = pm[:, pred0 + 32] + (a * g11 + b * g21)
        d = c1 > c0
        dec[t] = d
        pm = np.where(d, c1, c0)
    state = np.argmax(pm, axis=1)
    bits = np.empty((T, F), np.uint8)
    rows = np.arange(F)
    for t in range(T - 1, -1, -1):
        bits[t] = state & 1
        state = (state >> 1) + dec[t, rows, state] * 32
    bits = bits.T.copy()
    errors = (conv_encode(bits) != (soft < 0)).sum(-1)
    return bits, errors


def nrzm_decode(data: np.ndarray) -> np.ndarray:
    """Differential decoding of packed MSB-first bytes, previous bit 0."""
    bits = np.unpackbits(data, axis=-1)
    prev = np.concatenate([np.zeros(bits.shape[:-1] + (1,), np.uint8), bits[..., :-1]], -1)
    return np.packbits(bits ^ prev, axis=-1)


@lru_cache(maxsize=None)
def pn(nbytes: int = FRAME_BYTES - 4) -> np.ndarray:
    """The CCSDS pseudo-random sequence, from the all-ones register."""
    state, out = 0xFF, np.empty(nbytes, np.uint8)
    for i in range(nbytes):
        v = 0
        for _ in range(8):
            v = (v << 1) | (state >> 7)
            fb = ((state >> 7) ^ (state >> 4) ^ (state >> 2) ^ state) & 1
            state = ((state << 1) | fb) & 0xFF
        out[i] = v
    return out


@lru_cache(maxsize=None)
def gf():
    """(alpha_to, index_of, dual->conventional, conventional->dual, generator
    in index form) of the CCSDS field; index_of[0] = NN (A0)."""
    alpha_to = np.zeros(NN + 1, np.int64)
    index_of = np.zeros(NN + 1, np.int64)
    x = 1
    for i in range(NN):
        alpha_to[i] = x
        index_of[x] = i
        x <<= 1
        if x & 0x100:
            x ^= 0x187
    index_of[0] = NN
    alpha_to[NN] = 0
    to_dual = np.zeros(256, np.int64)
    for i in range(256):
        v = 0
        for j in range(8):
            if i & (1 << j):
                v ^= _TAL[7 - j]
        to_dual[i] = v
    to_conv = np.zeros(256, np.int64)
    to_conv[to_dual] = np.arange(256)
    genpoly = [1] + [0] * NROOTS
    root = FCR * PRIM
    for i in range(NROOTS):
        genpoly[i + 1] = 1
        for j in range(i, 0, -1):
            genpoly[j] = genpoly[j - 1] ^ (
                alpha_to[(index_of[genpoly[j]] + root) % NN] if genpoly[j] else 0)
        genpoly[0] = alpha_to[(index_of[genpoly[0]] + root) % NN]
        root += PRIM
    return alpha_to, index_of, to_conv, to_dual, np.array([index_of[g] for g in genpoly])


def rs_encode(data: np.ndarray) -> np.ndarray:
    """`(R, 223)` dual-basis bytes -> `(R, 255)` dual-basis codewords (the
    systematic LFSR, every row at once)."""
    alpha_to, index_of, to_conv, to_dual, gen = gf()
    msg = to_conv[np.asarray(data, np.int64)]
    R = msg.shape[0]
    bb = np.zeros((R, NROOTS), np.int64)
    taps = gen[NROOTS - np.arange(1, NROOTS)]                # GENPOLY[NROOTS - j], j = 1..31
    for i in range(NN - NROOTS):
        fb = index_of[msg[:, i] ^ bb[:, 0]]                  # (R,)
        live = fb != NN
        upd = np.where(live[:, None], alpha_to[(fb[:, None] + taps[None, :]) % NN], 0)
        bb[:, 1:] ^= upd
        bb[:, :-1] = bb[:, 1:].copy()
        bb[:, -1] = np.where(live, alpha_to[(fb + gen[0]) % NN], 0)
    out = np.concatenate([np.asarray(data, np.int64), to_dual[bb]], 1)
    return out.astype(np.uint8)


def rs_decode(codeword: np.ndarray):
    """One `(255,)` dual-basis codeword -> (corrected codeword, corrected
    symbols or -1).  Berlekamp-Massey, Chien search, Forney, at most 16."""
    alpha_to, index_of, to_conv, to_dual, _ = gf()
    A0 = NN
    data = [int(v) for v in to_conv[np.asarray(codeword, np.int64)]]
    pw = ((FCR + np.arange(NROOTS))[:, None] * PRIM * (NN - 1 - np.arange(NN))[None, :]) % NN
    dl = index_of[np.asarray(data)]
    terms = np.where(dl[None, :] == A0, 0, alpha_to[(dl[None, :] + pw) % NN])
    synd = np.bitwise_xor.reduce(terms, axis=1)
    if not synd.any():
        return np.asarray(codeword, np.uint8).copy(), 0
    s = [int(index_of[v]) for v in synd]
    lam = [1] + [0] * NROOTS
    b = [int(index_of[v]) for v in lam]
    el = 0
    for r in range(1, NROOTS + 1):
        discr = 0
        for i in range(r):
            if lam[i] != 0 and s[r - i - 1] != A0:
                discr ^= int(alpha_to[(index_of[lam[i]] + s[r - i - 1]) % NN])
        discr = int(index_of[discr])
        if discr == A0:
            b = [A0] + b[:-1]
            continue
        t = [lam[0]] + [lam[i + 1] ^ (int(alpha_to[(discr + b[i]) % NN]) if b[i] != A0 else 0)
                        for i in range(NROOTS)]
        if 2 * el <= r - 1:
            el = r - el
            b = [A0 if lam[i] == 0 else (int(index_of[lam[i]]) - discr + NN) % NN
                 for i in range(NROOTS + 1)]
        else:
            b = [A0] + b[:-1]
        lam = t
    lam = [int(index_of[v]) for v in lam]
    deg = max(i for i in range(NROOTS + 1) if lam[i] != A0)
    reg = lam[:]
    roots, locs = [], []
    k = IPRIM - 1
    for i in range(1, NN + 1):
        q = 1
        for j in range(deg, 0, -1):
            if reg[j] != A0:
                reg[j] = (reg[j] + j) % NN
                q ^= int(alpha_to[reg[j]])
        if q == 0:
            roots.append(i)
            locs.append(k)
            if len(roots) == deg:
                break
        k = (k + IPRIM) % NN
    if deg != len(roots) or deg > NROOTS // 2:
        return np.asarray(codeword, np.uint8).copy(), -1
    omega = []
    for i in range(deg):
        tmp = 0
        for j in range(i, -1, -1):
            if s[i - j] != A0 and lam[j] != A0:
                tmp ^= int(alpha_to[(s[i - j] + lam[j]) % NN])
        omega.append(int(index_of[tmp]))
    for j in range(len(roots) - 1, -1, -1):
        num1 = 0
        for i in range(deg - 1, -1, -1):
            if omega[i] != A0:
                num1 ^= int(alpha_to[(omega[i] + i * roots[j]) % NN])
        num2 = int(alpha_to[(roots[j] * (FCR - 1) + NN) % NN])
        den = 0
        for i in range(min(deg, NROOTS - 1) & ~1, -1, -2):
            if lam[i + 1] != A0:
                den ^= int(alpha_to[(lam[i + 1] + i * roots[j]) % NN])
        if num1 != 0:
            data[locs[j]] ^= int(alpha_to[(index_of[num1] + index_of[num2] + NN
                                          - index_of[den]) % NN])
    return to_dual[np.asarray(data)].astype(np.uint8), len(roots)


def sync_frame(frame: np.ndarray, mode: str, tmpl: np.ndarray) -> dict:
    """The sync recheck of one aligned `(16384,)` soft frame: the best word
    and its count, the lock it gives, the frame with LRIT's 180 degrees
    undone, and the history the next frame takes."""
    counts = word_counts(frame[:UW_BITS], tmpl)
    word = int(np.argmax(counts))
    corr = float(counts[word])
    fixed = -frame if (mode == "lrit" and word % 2 == 1) else frame
    return dict(word=word, corr=corr, sync_ok=bool(corr >= MIN_CORRELATION), fixed=fixed,
                tail=fixed[-HIST:].copy())


def fec_frames(synced: list, tails: list, mode: str) -> list:
    """The FEC stack of frames after `sync_frame`, each with the history
    before it: Viterbi (all frames at once), NRZ-M, the PN sequence, RS,
    the header.  Returns each frame's fields."""
    if not synced:
        return []
    ext = np.stack([np.concatenate([t, s["fixed"]]) for s, t in zip(synced, tails)])
    bits, errors = viterbi(ext)
    decoded = np.packbits(bits, axis=-1)
    if mode == "hrit":
        decoded = nrzm_decode(decoded)
    out = []
    for n, s in enumerate(synced):
        body = decoded[n, 4:4 + FRAME_BYTES]
        rand = body[4:] ^ pn()
        fixed_body = rand.copy()
        rs = []
        for i in range(4):
            cw, k = rs_decode(rand[i::4])
            fixed_body[i::4] = cw
            rs.append(k)
        h = fixed_body[:5].astype(np.int64)
        out.append(dict(
            vcdu=fixed_body[:VCDU_BYTES], frame_ok=bool(any(k != -1 for k in rs) and s["sync_ok"]),
            sync_ok=s["sync_ok"], scid=int(((h[0] & 0x3F) << 2) | ((h[1] & 0xC0) >> 6)),
            vcid=int(h[1] & 0x3F), counter=int((h[2] << 16) | (h[3] << 8) | h[4]),
            vit_errors=int(errors[n]), rs_errors=rs, corr=s["corr"], word=s["word"],
            sync_word=body[:4].copy()))
    return out


def decode_frame(frame: np.ndarray, tail: np.ndarray, mode: str, tmpl: np.ndarray) -> dict:
    """One aligned `(16384,)` soft frame with the `(64,)` history before it
    -> its fields, and the history the next frame takes (`tail`)."""
    s = sync_frame(frame, mode, tmpl)
    return dict(fec_frames([s], [tail], mode)[0], tail=s["tail"])
