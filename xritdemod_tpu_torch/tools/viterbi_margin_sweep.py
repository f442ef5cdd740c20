"""The segmented Viterbi's correctness margin against the exact decoder.

    python -m xritdemod_tpu_torch.tools.viterbi_margin_sweep [--frames 64]
        [--snrs -1,0,1,2,3,5] [--segments 4,8,16] [--overlaps 64,128,256]
        [--json OUT] [--device cuda]

The port's counterpart of `tools/viterbi_margin_sweep.py`, with its
arguments, seed and keys.  The decoder's segment-parallel Viterbi
(`viterbi_cuda.viterbi_decode_segmented`) decodes each frame's 8224 trellis
steps as S overlapped windows whose `overlap`-step warm-up is an
approximation that degrades at low SNR.  Per (Es/N0, S, overlap), over real
CADU streams (the port's `tx.py`, `default_rng(seed)` anew at every Es/N0):

  - bit_mismatch: the share of survivor bits where the segmented decoder
    (`viterbi_decode_segmented`) and the exact one (`viterbi_decode_kernel`,
    one window per frame) differ, on the frames the decode chain builds;
  - frame_success_{seg,exact}: post-FEC frame success (payload equal to the
    sent VCDU) through `CaduDecoder.decode_block` with `viterbi_segments=S`
    and with 0;
  - frames_diverged: frames where the two chains' outcomes differ.

On the card both are the Viterbi kernel.  On the CPU the bits of both come
from the plain decoder, and `CaduDecoder` takes the exact decoder whatever
`viterbi_segments` says, so there `frame_success_seg` is the exact one's.
The card's name and power limit are printed with the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from xritdemod_tpu_torch.tools.timing import card, require_device


def run(nframes, snrs, seg_list, ov_list, seed=0, device="cuda", log=sys.stderr):
    """One row per (Es/N0, S, overlap) (the JAX tool's keys)."""
    from xritdemod_tpu_torch import tx
    from xritdemod_tpu_torch.models.decoder import CaduDecoder, DecoderConfig
    from xritdemod_tpu_torch.ops.viterbi_cuda import (
        viterbi_decode_kernel, viterbi_decode_segmented,
    )

    results = []
    base = DecoderConfig(mode="lrit", frames_per_block=nframes)
    dec_exact = CaduDecoder(dataclasses.replace(base, viterbi_segments=0), device=device)
    dec_seg = {
        (S, ov): CaduDecoder(dataclasses.replace(base, viterbi_segments=S, viterbi_overlap=ov),
                             device=device)
        for S in seg_list for ov in ov_list
    }

    def matches(batch, vcdus):
        ok, vc = batch.frame_ok.cpu().numpy(), batch.vcdu.cpu().numpy()
        return np.array([ok[k] and np.array_equal(vc[k], vcdus[k]) for k in range(nframes)])

    for snr_db in snrs:
        sigma = float(10 ** (-snr_db / 20) / np.sqrt(2))
        rng = np.random.default_rng(seed)
        vcdus = tx.make_vcdus(nframes, scid=13, vcid=5, rng=rng)
        soft = tx.encode_stream(vcdus, lrit=True, amp=1.0, noise=sigma, rng=rng)
        soft_dev = torch.from_numpy(soft).to(device)

        # Extended frames exactly as the decode chain builds them.
        frames = soft.reshape(nframes, 16384)
        prev = np.concatenate([np.zeros((1, 64), np.float32), frames[:-1, -64:]], axis=0)
        ext = torch.from_numpy(np.concatenate([prev, frames], axis=1)).to(device)

        bits_exact, _ = viterbi_decode_kernel(ext)
        b_ex, _ = dec_exact.decode_block(soft_dev, dec_exact.init_tail())
        match_ex = matches(b_ex, vcdus)

        for S in seg_list:
            for ov in ov_list:
                bits_seg, _ = viterbi_decode_segmented(ext, segments=S, overlap=ov)
                mism = float((bits_seg != bits_exact).double().mean())
                d = dec_seg[(S, ov)]
                b_sg, _ = d.decode_block(soft_dev, d.init_tail())
                match_sg = matches(b_sg, vcdus)
                row = {
                    "snr_db": float(snr_db),
                    "segments": S,
                    "overlap": ov,
                    "bit_mismatch": mism,
                    "frame_success_exact": float(match_ex.mean()),
                    "frame_success_seg": float(match_sg.mean()),
                    "frames_diverged": int((match_sg != match_ex).sum()),
                }
                results.append(row)
                if log is not None:
                    print(f"snr={snr_db:+.0f}dB S={S:>2} ov={ov:>3}: "
                          f"bit_mismatch={mism:.2e} "
                          f"success seg={row['frame_success_seg']:.3f} "
                          f"exact={row['frame_success_exact']:.3f} "
                          f"diverged={row['frames_diverged']}", file=log)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="viterbi_margin_sweep")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--snrs", default="-1,0,1,2,3,5")
    p.add_argument("--segments", default="4,8,16")
    p.add_argument("--overlaps", default="64,128,256")
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, "viterbi_margin_sweep")
    res = run(
        args.frames,
        [float(s) for s in args.snrs.split(",")],
        [int(s) for s in args.segments.split(",")],
        [int(s) for s in args.overlaps.split(",")],
        device=dev,
    )
    out = {"card": card(dev), "device": str(dev), "frames_per_point": args.frames,
           "results": res}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json} ({out['card']})", file=sys.stderr)
    else:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
