"""Per-stage timing of the CADU decode chain, one call at a time.

    python -m xritdemod_tpu_torch.tools.decode_bench [B] [--iters 5] [--device cuda]

The port's counterpart of `tools/decode_bench.py` (B = 256 frames): the
whole `decode_block` on B real coded frames (the port's `tx.py`, VCDUs from
seed 1, noise 0.1), the exact Viterbi kernel on B windows of N(0, 64) soft
symbols, `rs_decode_frame` on B errored frames, and `correlate_at` at every
frame start of the coded stream.  Each reading is one call under
`tools/timing.py`'s rule with N = 1 (a warm-up first, CUDA events around the
call, one synchronisation); each stage prints its best reading and all of
them.  `decode_profile` times the same chain with calls queued back to back.
The last line is one JSON object with the card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from xritdemod_tpu_torch.tools.timing import card, require_device, timed


def stages(B: int, device) -> dict:
    from xritdemod_tpu_torch import constants as C
    from xritdemod_tpu_torch import tx
    from xritdemod_tpu_torch.models.decoder import CaduDecoder, DecoderConfig
    from xritdemod_tpu_torch.ops import correlator as corr_op
    from xritdemod_tpu_torch.ops import reed_solomon as rs_op
    from xritdemod_tpu_torch.ops.viterbi_cuda import viterbi_decode_kernel

    dev = torch.device(device)
    vcdus = tx.make_vcdus(B, rng=np.random.default_rng(1))
    soft = torch.from_numpy(tx.encode_stream(vcdus, lrit=True, noise=0.1)).to(dev)
    dec = CaduDecoder(DecoderConfig(mode="lrit", frames_per_block=B), device=dev)
    tail = dec.init_tail()
    ext = torch.from_numpy(np.random.default_rng(0).normal(
        0, 64, (B, 2 * (C.FRAME_BITS + 32))).astype(np.float32)).to(dev)
    fb = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (B, 1020), dtype=np.int32).astype(np.uint8)).to(dev)
    starts = torch.arange(B, dtype=torch.int32, device=dev) * C.CODED_FRAME_SIZE
    return {
        "full decode_block": lambda: dec.decode_block(soft, tail),
        f"viterbi B={B}": lambda: viterbi_decode_kernel(ext),
        f"rs frame B={B}": lambda: rs_op.rs_decode_frame(fb),
        "correlate_at": lambda: corr_op.correlate_at(soft, dec._templates, starts),
    }


def bench(B: int = 256, iters: int = 5, device="cuda", log=None) -> dict:
    """Each stage's readings (ms), its best, and its launches a call."""
    out = {}
    for name, fn in stages(B, device).items():
        launches: dict = {}
        times = []
        for _ in range(iters):
            ms, _ = timed(lambda _: fn(), None, 1, device, launches)
            times.append(ms)
        out[name] = {"best_ms": min(times), "times_ms": times, "launches": launches}
        if log is not None:
            print(f"{name:24s} best {min(times):8.2f} ms  "
                  f"times={[round(t, 2) for t in times]}", file=log, flush=True)
    return {"B": B, "iters": iters, "stages": out,
            "all_finite": all(math.isfinite(t) and t > 0
                              for s in out.values() for t in s["times_ms"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="decode_bench")
    p.add_argument("B", nargs="?", type=int, default=256)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, "decode_bench")
    smi = card(dev)
    print(f"card={smi} device={dev} B={args.B}", flush=True)
    print(json.dumps({"card": smi, "device": str(dev),
                      **bench(args.B, args.iters, dev, log=sys.stdout)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
