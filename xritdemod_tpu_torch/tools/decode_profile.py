"""Per-stage timing of the CADU decode chain.

    python -m xritdemod_tpu_torch.tools.decode_profile [B] [iters] [--device cuda]

The port's counterpart of `tools/decode_profile.py` (B = 1024 frames and 6
calls by default, numpy seed 0), with the NRZ-M stage and the segmented
decoder's windows as the decoder picks them added.  Every stage is timed
under `tools/timing.py`'s rule (one warm-up, N calls queued, CUDA events,
one synchronisation), on noise frames of N(0, 32) soft symbols:

  - `decode_frames` whole, chained through its `(B, 64)` tails, and on the
    noiseless frames of a transmitted stream (every codeword clean);
  - the Viterbi kernel (K3): segmented at S = 2, 4, 8 and at the decoder's
    own S for this B (overlap 128; at most 8192 windows a launch, as the
    decoder keeps it), at S = 4 with overlap
    64 and 96, and exact (one window per frame, B <= 2048);
  - `pack_bits`, `nrzm_decode_bytes` (HRIT's step), `derandomize`;
  - `rs_decode_frame` on errored frames (random bytes) and on clean ones
    (valid codewords, the syndromes-only path);
  - the sync recheck and phase fix (`CaduDecoder._sync_and_fix`).

The last line is one JSON object: the card, each stage's ms and kernel
launches a call, and the sum of the stages `decode_frames` runs for this B
beside its whole time.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from xritdemod_tpu_torch.tools.timing import card, require_device, timed


def stages(B: int, device):
    """-> (name -> (fn, carry) of every stage at B frames, numpy seed 0; the
    name of the Viterbi stage `decode_frames` runs at B)."""
    from xritdemod_tpu_torch import tx
    from xritdemod_tpu_torch.models.decoder import CaduDecoder, DecoderConfig
    from xritdemod_tpu_torch.ops import reed_solomon as rs_op
    from xritdemod_tpu_torch.ops.derandomizer import derandomize
    from xritdemod_tpu_torch.ops.nrzm import nrzm_decode_bytes
    from xritdemod_tpu_torch.ops.viterbi_cuda import (
        viterbi_decode_kernel, viterbi_decode_segmented,
    )
    from xritdemod_tpu_torch.utils.bits import pack_bits

    dev = torch.device(device)
    t = lambda a: torch.from_numpy(a).to(dev)
    dec = CaduDecoder(DecoderConfig(mode="lrit", frames_per_block=B), device=dev)
    rng = np.random.default_rng(0)
    frames = t(rng.normal(0, 32, (B, 16384)).astype(np.float32))
    tails = torch.zeros((B, 64), dtype=torch.float32, device=dev)
    ext = torch.cat([tails, frames], dim=1)
    out = {"full decode_frames": (lambda tl: dec.decode_frames(frames, tl)[1], tails)}
    # A transmitted stream's frames, noiseless: every codeword clean.
    sent = tx.encode_stream(tx.make_vcdus(B, vcid=1, rng=np.random.default_rng(1)), lrit=True)
    sent = t(sent[: B * 16384].reshape(B, 16384).astype(np.float32))
    out["full decode_frames (clean frames)"] = (
        lambda tl: dec.decode_frames(sent, tl)[1], tails)
    segs = dec._segments(B)
    for S in sorted({2, 4, 8, segs} - {0, 1}):
        if B * S <= 8192:
            out[f"viterbi segmented S={S}"] = (
                lambda _, S=S: viterbi_decode_segmented(ext, segments=S, overlap=128), None)
    if B * 4 <= 8192:
        for ov in (64, 96):
            out[f"viterbi segmented S=4 overlap={ov}"] = (
                lambda _, ov=ov: viterbi_decode_segmented(ext, segments=4, overlap=ov), None)
    if B <= 2048:
        out["viterbi plain (S=1)"] = (lambda _: viterbi_decode_kernel(ext), None)
    bits = t(rng.integers(0, 2, (B, 8224), dtype=np.int32).astype(np.uint8))
    out["pack_bits"] = (lambda _: pack_bits(bits), None)
    fb = t(rng.integers(0, 256, (B, 1020), dtype=np.int32).astype(np.uint8))
    out["rs_decode_frame (errored path)"] = (lambda _: rs_op.rs_decode_frame(fb), None)
    clean_cw = rs_op.rs_encode_np(rng.integers(0, 256, (4, 223), dtype=np.int64).astype(np.uint8))
    clean = rs_op.interleave(torch.from_numpy(clean_cw).reshape(1, 4, 255)).repeat(B, 1).to(dev)
    out["rs_decode_frame (clean fast path)"] = (lambda _: rs_op.rs_decode_frame(clean), None)
    out["sync_and_fix"] = (lambda _: dec._sync_and_fix(frames), None)
    by = t(rng.integers(0, 256, (B, 1020), dtype=np.int32).astype(np.uint8))
    out["derandomize"] = (lambda _: derandomize(by), None)
    coded = t(rng.integers(0, 256, (B, 1028), dtype=np.int32).astype(np.uint8))
    out["nrzm_decode_bytes"] = (lambda _: nrzm_decode_bytes(coded), None)
    # The Viterbi `decode_frames` runs: the exact plain decoder on the CPU.
    whole_vit = ("viterbi plain (S=1)" if segs < 2 or dev.type != "cuda"
                 else f"viterbi segmented S={segs}")
    return out, whole_vit


def profile(B: int = 1024, iters: int = 6, device="cuda", log=None) -> dict:
    """Every stage's ms and launches a call; the stages `decode_frames` runs
    (LRIT: no NRZ-M) summed beside its whole."""
    todo, vit = stages(B, device)
    ms, launches = {}, {}
    for name, (fn, carry) in todo.items():
        launches[name] = {}
        ms[name], _ = timed(fn, carry, iters, device, launches[name])
        if log is not None:
            print(f"{name:44s} {ms[name]:8.2f} ms", file=log, flush=True)
    parts = ["sync_and_fix", vit, "pack_bits", "derandomize", "rs_decode_frame (errored path)"]
    parts = [p for p in parts if p in ms]
    return {"B": B, "iters": iters, "ms": ms, "launches": launches,
            "whole": "full decode_frames", "whole_ms": ms["full decode_frames"],
            "stages_of_whole": parts, "stage_sum_ms": sum(ms[p] for p in parts),
            "all_finite": all(math.isfinite(v) and v > 0 for v in ms.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="decode_profile")
    p.add_argument("B", nargs="?", type=int, default=1024)
    p.add_argument("iters", nargs="?", type=int, default=6)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, "decode_profile")
    smi = card(dev)
    print(f"card={smi} device={dev} B={args.B} iters={args.iters}", flush=True)
    res = profile(args.B, args.iters, dev, log=sys.stdout)
    print(json.dumps({"card": smi, "device": str(dev), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
