"""Throughput scaling: channels on one card, and entries of a channel mesh.

    python -m xritdemod_tpu_torch.tools.scaling_sweep channels [--list 32,64,128,256]
        [--block 131072] [--device cuda]
    python -m xritdemod_tpu_torch.tools.scaling_sweep mesh [--devices 1,2,4,8]
        [--block 32768] [--device cuda]

The port's counterpart of `tools/scaling_sweep.py`, with its arguments,
seed (numpy, 0) and keys.

`channels`: Msamples/s of `ChannelDemodulator.process` (the batched demod
chain, `Demodulator.block_batch`: the front-end kernel and the clock kernel)
against the channel count C at T samples a block.

`mesh`: weak scaling over a channel mesh of n entries (`make_channel_mesh`),
8 channels an entry, and the same total work as one unsharded batch.  Each
entry is the card named by `--device` (or the CPU), repeated: the machines
the port runs on hold one card.  Two efficiencies a point:
  - scaling_efficiency: rate(n) / (n * rate(1)), the naive weak-scaling
    number;
  - sharding_efficiency: t_unsharded / t_sharded, the same work as one
    batch on one entry against the slabs run one after another.  With every
    entry on one card this is only the overhead of cutting the batch into
    slabs (more, smaller launches), not a multi-card property; the output
    says so.

Every time follows `tools/timing.py` (one warm-up, N blocks through the
carried state, one synchronisation).  Each row says whether the last block's
soft symbols were all finite.  The card's name and power limit are printed
with the result.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from xritdemod_tpu_torch.tools.timing import card, require_device, timed

ITERS = 3


def _block(rng, C: int, block: int, device):
    from xritdemod_tpu_torch.utils.cplx import CF32

    return CF32(torch.from_numpy(rng.normal(0, 0.3, (C, block)).astype(np.float32)).to(device),
                torch.from_numpy(rng.normal(0, 0.3, (C, block)).astype(np.float32)).to(device))


def _timed(demod, x, device, iters: int):
    """-> (seconds a block, whether the last block's soft symbols are finite)."""
    ms, out = timed(lambda o: demod.process(x, o[2]), (None, None, demod.init_state()),
                    iters, device)
    return ms / 1e3, bool(torch.isfinite(out[0]).all())


def sweep_channels(counts, block: int = 1 << 17, iters: int = ITERS, device="cuda", log=None):
    from xritdemod_tpu_torch.models.demodulator import DemodConfig
    from xritdemod_tpu_torch.parallel.channels import ChannelDemodulator

    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    rng = np.random.default_rng(0)
    out = []
    for C in counts:
        demod = ChannelDemodulator(cfg, channels=C, block_len=block, device=device)
        x = _block(rng, C, block, device)
        s, finite = _timed(demod, x, device, iters)
        msps = C * block / s / 1e6
        out.append({"channels": C, "block": block, "s_per_block": s,
                    "msamples_per_s": round(msps, 2), "soft_finite": finite})
        if log is not None:
            print(f"C={C:4d}: {s * 1e3:8.1f} ms/block  {msps:9.2f} Msamp/s", file=log)
        del demod, x
    return out


def sweep_mesh(device_counts, channels_per_device: int = 8, block: int = 1 << 15,
               iters: int = ITERS, device="cuda", log=None):
    """Weak scaling over a mesh of n entries of `device` (see the module's
    docstring for the two efficiencies)."""
    from xritdemod_tpu_torch.models.demodulator import DemodConfig
    from xritdemod_tpu_torch.parallel.channels import ChannelDemodulator, make_channel_mesh

    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    rng = np.random.default_rng(0)
    out = []
    base_rate = None
    for n in device_counts:
        C = n * channels_per_device
        x = _block(rng, C, block, device)
        mesh = make_channel_mesh([device] * n)
        best, finite = _timed(ChannelDemodulator(cfg, channels=C, block_len=block, mesh=mesh),
                              x, device, iters)
        best_plain, finite_plain = _timed(
            ChannelDemodulator(cfg, channels=C, block_len=block, device=device), x, device, iters)
        rate = C * block / best
        if base_rate is None:
            base_rate = rate / n
        eff = rate / (n * base_rate)
        shard_eff = best_plain / best
        out.append({
            "devices": n, "channels": C, "samples_per_s": rate,
            "scaling_efficiency": round(eff, 3),
            "sharding_efficiency": round(shard_eff, 3),
            "s_sharded": best, "s_unsharded_1dev": best_plain,
            "soft_finite": finite and finite_plain,
        })
        if log is not None:
            print(f"n={n}: {rate / 1e6:9.2f} Msamp/s  weak-scaling {eff:.2f}  "
                  f"sharding {shard_eff:.2f}", file=log)
    return out


MESH_NOTE = ("every mesh entry is the same device: sharding_efficiency measures only the "
             "overhead of running the batch as slabs one after another, not scaling across cards")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scaling_sweep")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("channels")
    c.add_argument("--list", default="32,64,128,256")
    c.add_argument("--block", type=int, default=1 << 17)
    c.add_argument("--device", default="cuda")
    m = sub.add_parser("mesh")
    m.add_argument("--devices", default="1,2,4,8")
    m.add_argument("--block", type=int, default=1 << 15)
    m.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, "scaling_sweep")
    out = {"card": card(dev), "device": str(dev), "mode": args.cmd}
    if args.cmd == "channels":
        out["rows"] = sweep_channels([int(v) for v in args.list.split(",")], args.block,
                                     device=dev, log=sys.stderr)
    else:
        out["rows"] = sweep_mesh([int(v) for v in args.devices.split(",")], block=args.block,
                                 device=dev, log=sys.stderr)
        out["note"] = MESH_NOTE
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
