"""Rebuild the frozen end-to-end decode fixtures with the port's `tx.py`.

    python -m xritdemod_tpu_torch.tools.make_frozen_fixture OUT_DIR [--device cuda]

The port's counterpart of `tools/make_frozen_fixture.py`, with its `SPECS`
(an LRIT stream of 12 frames, 180-degree phase, and an HRIT stream of 8, at
their seeds, amplitudes, noise and leads).  It writes `{lrit,hrit}_soft_int8.bin`,
`{lrit,hrit}_vcdus.bin` and `meta.json` into OUT_DIR only (never into
`tests/fixtures/`, whose committed files are frozen), then decodes each
written stream through `StreamDecoder` on `--device` and checks that every
frame comes back equal to its VCDU.  Equal SHA-256s in OUT_DIR's `meta.json`
and the committed one mean the port's synthesiser still makes the streams
the reference's tests decode.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

import numpy as np

from xritdemod_tpu_torch.tools.timing import card, require_device

SPECS = {
    "lrit": dict(
        n=12, scid=13, vcid=5, counter0=1000, seed=20260820,
        amp=0.82, noise=0.12, lead=2345, phase180=True, lrit=True,
    ),
    "hrit": dict(
        n=8, scid=7, vcid=21, counter0=5, seed=4242,
        amp=0.9, noise=0.1, lead=901, phase180=False, lrit=False,
    ),
}


def write(out_dir) -> dict:
    """Writes the fixtures into `out_dir` (created); returns the meta."""
    from xritdemod_tpu_torch import tx

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    meta = {}
    for name, s in SPECS.items():
        rng = np.random.default_rng(s["seed"])
        vcdus = tx.make_vcdus(s["n"], scid=s["scid"], vcid=s["vcid"],
                              counter0=s["counter0"], rng=rng)
        soft = tx.encode_stream(vcdus, lrit=s["lrit"], amp=s["amp"], noise=s["noise"],
                                lead=s["lead"], phase180=s["phase180"], rng=rng)
        wire = tx.soft_to_int8(soft)
        (out / f"{name}_soft_int8.bin").write_bytes(wire.tobytes())
        (out / f"{name}_vcdus.bin").write_bytes(vcdus.tobytes())
        meta[name] = {
            **s,
            "soft_sha256": hashlib.sha256(wire.tobytes()).hexdigest(),
            "vcdu_sha256": hashlib.sha256(vcdus.tobytes()).hexdigest(),
            "soft_len": int(wire.size),
            "n_vcdus": int(vcdus.shape[0]),
        }
    (out / "meta.json").write_text(json.dumps(meta, indent=2) + "\n")
    return meta


def decode_check(out_dir, device="cuda") -> dict:
    """Per stream: frames decoded, and how many equal their sent VCDU."""
    from xritdemod_tpu_torch.models.decoder import DecoderConfig, StreamDecoder

    out = pathlib.Path(out_dir)
    res = {}
    for name in SPECS:
        wire = np.fromfile(out / f"{name}_soft_int8.bin", np.int8)
        vcdus = np.fromfile(out / f"{name}_vcdus.bin", np.uint8).reshape(-1, 892)
        dec = StreamDecoder(DecoderConfig(mode=name), device=device)
        batches = dec.push(wire.astype(np.float32)) + dec.flush()
        got = [bytes(v) for b in batches
               for v, ok in zip(b.vcdu.cpu().numpy(), b.frame_ok.cpu().numpy()) if ok]
        sent = {bytes(v) for v in vcdus}
        res[name] = dict(frames=len(got), equal=sum(g in sent for g in got), sent=len(vcdus))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="make_frozen_fixture")
    p.add_argument("out_dir", help="directory to write into (not tests/fixtures/)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, "make_frozen_fixture")
    meta = write(args.out_dir)
    for name, m in meta.items():
        print(name, m["soft_sha256"], m["vcdu_sha256"])
    check = decode_check(args.out_dir, dev)
    print(json.dumps({"card": card(dev), "device": str(dev), "decoded": check}))
    if any(c["equal"] != c["sent"] for c in check.values()):
        raise SystemExit(f"make_frozen_fixture: the written streams do not decode: {check}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
