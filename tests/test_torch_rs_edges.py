"""The RS decoder's plain version (the kernel's golden model) against the JAX
`rs_decode` on the words the decode tests' regimes do not reach.

The words come from `xritdemod_tpu_torch/tools/edge_cases.py`, which
`chip_smoke.py` also feeds to the kernel: exactly 16 and 17 symbol errors,
errors in the parity bytes only, at bytes 0 and 254, the all-zero and
all-0xFF words, 17 errors that sit 16 symbols from another codeword (a
miscorrection), random words, words whose Berlekamp-Massey length is 18 (no
locator of 16 or fewer errors).  Each case goes through both decoders inside a
batch of 1024 rows (the rest clean codewords) at `sparse_max` 0 (the
errored rows alone), 4 (the sparse branch up to 4 errored rows, every row
beyond) and the automatic Kmax (128 at 1024 rows): outputs and counts equal
byte for byte.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xritdemod_tpu.ops import reed_solomon as jrs
from xritdemod_tpu_torch.ops import reed_solomon as trs
from xritdemod_tpu_torch.tools.edge_cases import rs_batch, rs_edge_cases

ROWS = 1024
CASES = rs_edge_cases(seed=17)


def _bm_length(word: np.ndarray) -> int:
    """The final Berlekamp-Massey length L of one dual-basis word, on plain
    integers (independent of both decoders' vectorised forms)."""
    bexp, blog, _, tal1, _ = trs._gf_tables()
    mul = lambda a, b: 0 if a == 0 or b == 0 else int(bexp[blog[a] + blog[b]])
    r = [int(v) for v in tal1[word]]
    S = []
    for k in range(32):
        x, s = int(bexp[(trs._FCR + k) % 255]), 0
        for v in r:
            s = mul(s, x) ^ v
        S.append(s)
    lam, b, L, binv = [1] + [0] * 32, [1] + [0] * 32, 0, 1
    for rr in range(32):
        d = 0
        for k in range(rr + 1):
            d ^= mul(lam[k], S[rr - k])
        bx = [0] + b[:-1]
        if d:
            frac = mul(d, binv)
            new = [lam[j] ^ mul(frac, bx[j]) for j in range(33)]
            if 2 * L <= rr:
                b, binv, L = lam, int(bexp[255 - blog[d]]), rr + 1 - L
            else:
                b = bx
            lam = new
        else:
            b = bx
    return L


def test_the_cases_reach_their_edges():
    """The generator gives what the cases are named for: a miscorrection
    (L = 16, a codeword other than the one sent) and words with L > 16."""
    recv, sent = CASES["miscorrect"]
    assert all(int((a != b).sum()) == 17 for a, b in zip(recv, sent))
    assert all(_bm_length(w) == 16 for w in recv)
    assert all(_bm_length(w) == 18 for w in CASES["length18"][0])
    for name in ("zeros", "ones"):
        assert (trs.rs_encode_np(CASES[name][1][:, :223]) == CASES[name][1]).all()


@pytest.mark.parametrize("sparse_max", [0, 4, None], ids=["sparse0", "sparse4", "auto"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rs_edge_case_matches_jax(monkeypatch, case, sparse_max):
    monkeypatch.delenv("XRIT_RS_SPARSE", raising=False)
    recv, sent = CASES[case]
    batch = rs_batch({case: CASES[case]}, ROWS)
    corr, nerr = trs.rs_decode(torch.from_numpy(batch), sparse_max=sparse_max)
    jc, jn = jrs.rs_decode(jnp.asarray(batch), sparse_max=sparse_max)
    np.testing.assert_array_equal(nerr.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(corr.numpy(), np.asarray(jc))
    n = recv.shape[0]
    got, count = corr.numpy()[:n], nerr.numpy()[:n]
    assert (nerr.numpy()[n:] == 0).all()
    wrong = (recv != sent).sum(-1)
    fixable = (wrong <= 16) & (case not in ("random", "length18"))
    np.testing.assert_array_equal(got[fixable], sent[fixable])
    np.testing.assert_array_equal(count[fixable], wrong[fixable])
    fixed = count > 0
    # A row decoded is a codeword; a row that failed comes out as it came.
    np.testing.assert_array_equal(trs.rs_encode_np(got[fixed][:, :223]), got[fixed])
    np.testing.assert_array_equal(got[count == -1], recv[count == -1])
    if case == "miscorrect":
        assert (count == 16).all() and (got != sent).any(-1).all()
    if case in ("random", "length18"):
        assert (count == -1).all()
