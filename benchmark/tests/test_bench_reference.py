"""The plain reference's decoder against the repository's frozen fixtures
(read as files, SHA-pinned) and against its own encoder."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.reference import decode as D

FIXDIR = Path(__file__).resolve().parents[2] / "tests" / "fixtures"
SHA = {
    "lrit_soft_int8.bin": "364f75e80b8ac713befe86618f5edd4bdbf4e006f0ff1ed842584657ee2aee51",
    "lrit_vcdus.bin": "72cf52a6060384a91ea6406846635fcc6a09f7144e59a2b09ba0f8ac3124620d",
    "hrit_soft_int8.bin": "884ca8f7f2b824020b7016b11b907bccec4a10cb5ef29964f7ccaac7adb7642e",
    "hrit_vcdus.bin": "c41a915decd626afea31f295a2d8af7ce807eac34a5b13d54213dad7b46bc607",
}


def _load(name: str) -> bytes:
    data = (FIXDIR / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == SHA[name]
    return data


@pytest.mark.parametrize("mode", ["lrit", "hrit"])
def test_frozen_streams_decode_bit_exact(mode):
    meta = json.loads((FIXDIR / "meta.json").read_text())[mode]
    soft = np.frombuffer(_load(f"{mode}_soft_int8.bin"), np.int8).astype(np.float64) / 127.0
    want = np.frombuffer(_load(f"{mode}_vcdus.bin"), np.uint8).reshape(meta["n_vcdus"], 892)
    tmpl = D.templates(mode)
    pos = D.acquire(soft[:D.CODED + D.UW_BITS - 1], tmpl)
    assert pos == meta["lead"]
    tail = np.zeros(D.HIST)
    got = []
    for f in range(meta["n_vcdus"]):
        fields = D.decode_frame(soft[pos + f * D.CODED:pos + (f + 1) * D.CODED], tail, mode, tmpl)
        tail = fields["tail"]
        assert fields["sync_ok"] and fields["frame_ok"]
        if mode == "lrit":                    # HRIT's NRZ-M makes either word right
            assert fields["word"] == (1 if meta["phase180"] else 0)
        assert fields["vcid"] == meta["vcid"] and fields["counter"] == meta["counter0"] + f
        got.append(fields["vcdu"])
    assert np.array_equal(np.stack(got), want)


def test_rs_corrects_sixteen_and_refuses_seventeen():
    rng = np.random.default_rng(5)
    cw = D.rs_encode(rng.integers(0, 256, (3, 223)).astype(np.uint8))
    for row in cw:
        assert D.rs_decode(row)[1] == 0
        for nerr, want in ((1, 1), (16, 16), (17, -1)):
            bad = row.copy()
            pos = rng.choice(255, nerr, replace=False)
            bad[pos] ^= rng.integers(1, 256, nerr).astype(np.uint8)
            fixed, n = D.rs_decode(bad)
            assert n == want
            if want > 0:
                assert np.array_equal(fixed, row)


def test_pn_sequence_head():
    assert D.pn(4).tolist() == [0xFF, 0x48, 0x0E, 0xC0]


def test_viterbi_counts_flipped_symbols():
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, (2, 600)).astype(np.uint8)
    soft = 1.0 - 2.0 * D.conv_encode(bits)
    flips = rng.choice(1200, 9, replace=False)
    soft[0, flips] *= -1
    got, errors = D.viterbi(soft)
    assert np.array_equal(got, bits)
    assert errors.tolist() == [9, 0]
