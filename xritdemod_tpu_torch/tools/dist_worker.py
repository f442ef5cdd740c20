"""One rank of a multi-process receive (`parallel/distributed.py`).

    python -m xritdemod_tpu_torch.tools.dist_worker RANK WORLD INIT_METHOD BACKEND DEVICE ENTRIES
        [--rate HZ] [--channels-per-device N] [--channel-block T] [--tb-block T]
        [--fused-block T] [--tb-out FILE]

Joins a `torch.distributed` group (`INIT_METHOD`: `file:///path` or
`tcp://host:port`; `BACKEND`: `gloo`, or `nccl` with one rank per card) with
ENTRIES mesh entries on DEVICE (`cuda:0`, `cpu`), and checks, exiting
non-zero on any failure and printing `ALL OK` at the end:

  1. channels: `DistributedChannelReceiver`'s demod of this rank's channels
     equals one unsharded `block_batch` of the same channels (bit for bit on
     a card, within 1e-5 on the CPU), and its decode of one real coded frame
     per channel is bit-exact;
  2. timeblocks: `DistributedTimeBlockDemodulator` with a `decode_overlap`
     of two frame spans, the halo crossing the process boundary: every
     frame this rank's kept streams fully span (its left edge one frame
     span in, rank 0's cold-start head excused) comes back bit-exact; with
     `--tb-out` the frames of each block go to a JSON file, for a caller to
     hold against the single-process `TimeBlockDemodulator`
     (`timeblock_frames`);
  3. fused: `DistributedFusedReceiver` on every local channel of one
     transmitted stream: every frame bit-exact, at most one missing.

Two ranks sharing one card run with gloo (NCCL refuses two ranks on one
GPU).  Signals come from the port's `tx.py`, made from fixed seeds, so every
rank can make any channel's stream.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from xritdemod_tpu_torch import constants as K
from xritdemod_tpu_torch import tx
from xritdemod_tpu_torch.models.decoder import DecoderConfig, StreamDecoder
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.parallel import distributed as pdist

TB_WARMUP = 8192
TB_VCID, TB_COUNTER0 = 9, 300


def log(rank: int, *a) -> None:
    print(f"[p{rank}]", *a, flush=True)


def channel_signal(chan: int, T: int, cfg: DemodConfig) -> np.ndarray:
    """Deterministic LRIT signal of global channel `chan`, `T` samples."""
    nframes = int(T / cfg.sps / K.CODED_FRAME_SIZE) + 2
    v = tx.make_vcdus(nframes, scid=13, vcid=chan % 64, rng=np.random.default_rng(1000 + chan))
    sym = tx.encode_stream(v, lrit=True, rng=np.random.default_rng(3000 + chan))
    return tx.modulate(sym, cfg, np.random.default_rng(5000 + chan), phase=0.1 * (chan % 60),
                       noise=0.02)[:T]


def tb_decode_overlap(cfg: DemodConfig) -> int:
    """Two coded-frame spans in capture samples: zero seam loss."""
    return 2 * (int(K.CODED_FRAME_SIZE * cfg.sps) + 1)


def timeblock_capture(cfg: DemodConfig, blocks: int, block_len: int, seed: int = 42):
    """One LRIT capture of `blocks * block_len` samples carrying real CADUs
    (the same on every rank) -> (complex64 samples, vcdus)."""
    total = blocks * block_len
    nframes = int(total / cfg.sps) // K.CODED_FRAME_SIZE - 1
    rng = np.random.default_rng(seed)
    vcdus = tx.make_vcdus(nframes, scid=13, vcid=TB_VCID, counter0=TB_COUNTER0, rng=rng)
    symbols = tx.encode_stream(vcdus, lrit=True, amp=1.0, rng=rng)
    sig = tx.modulate(symbols, cfg, rng=rng, freq_offset=5e-5, phase=0.3, amp=0.4, noise=0.01)
    sig = np.concatenate([sig, np.zeros(max(0, total - len(sig)), np.complex64)])[:total]
    return sig, vcdus


def timeblock_frames(soft, valid, device) -> list[list]:
    """Each row's symbols through its own `StreamDecoder` -> per row, the
    `[vcid, counter, vcdu hex]` of every good frame, in stream order."""
    soft, valid = soft.cpu().numpy(), valid.cpu().numpy()
    out = []
    for i in range(soft.shape[0]):
        dec = StreamDecoder(DecoderConfig(mode="lrit", frames_per_block=4), device=device)
        rows = []
        for b in dec.push(soft[i][valid[i]]) + dec.flush():
            ok, vcid, ctr, vc = (getattr(b, n).cpu().numpy()
                                 for n in ("frame_ok", "vcid", "counter", "vcdu"))
            rows += [[int(vcid[j]), int(ctr[j]), bytes(vc[j]).hex()] for j in np.nonzero(ok)[0]]
        out.append(rows)
    return out


def check_channels(rank: int, mesh, device, rate: int, cpd: int, T: int) -> None:
    cfg = DemodConfig.lrit(sample_rate=rate)
    rx = pdist.DistributedChannelReceiver(
        cfg, DecoderConfig(mode="lrit", frames_per_block=1), channels_per_device=cpd,
        block_len=T, mesh=mesh,
    )
    CL = rx.channels_local
    first = rank * CL
    sig = np.stack([channel_signal(first + i, T, cfg) for i in range(CL)])
    soft, valid, _ = rx.demod_block(sig, rx.init_demod_state())
    if tuple(soft.shape) != (CL, rx.num_slots):
        raise AssertionError(f"channels: soft shape {tuple(soft.shape)}")
    ref = Demodulator(cfg, block_len=T, device=device)
    rs, rv, _ = ref.block_batch(sig, ref.init_state_batch(CL))
    if not torch.equal(valid.cpu(), rv.cpu()):
        raise AssertionError("channels: valid differs from the unsharded batch")
    err = float((soft.cpu() - rs.cpu()).abs().max())
    if err > (0.0 if device.type == "cuda" else 1e-5):
        raise AssertionError(f"channels: soft differs from the unsharded batch by {err}")
    log(rank, f"channels: {CL} local channels equal the unsharded batch "
              f"(of {rx.channels}; max abs err {err})")

    vcdus_all = tx.make_vcdus(rx.channels, rng=np.random.default_rng(7))  # same on every rank
    frames = np.stack([
        tx.encode_stream(vcdus_all[c : c + 1], amp=0.8, noise=0.1,
                         rng=np.random.default_rng(2000 + c))
        for c in range(first, first + CL)
    ])
    batch, _ = rx.decode_block(frames, rx.init_tails())
    if not bool(batch.frame_ok.all()):
        raise AssertionError(f"decode dropped frames: {batch.frame_ok.cpu().numpy()}")
    if not np.array_equal(batch.vcdu.cpu().numpy().reshape(CL, -1),
                          vcdus_all[first : first + CL]):
        raise AssertionError("channels: decode not bit-exact")
    log(rank, f"decode: {CL} local frames bit-exact")


def check_timeblocks(rank: int, mesh, device, rate: int, block: int, out: str | None) -> None:
    cfg = DemodConfig.lrit(sample_rate=rate)
    dec_ov = tb_decode_overlap(cfg)
    frame_span = dec_ov // 2
    tb = pdist.DistributedTimeBlockDemodulator(cfg, block_len=block, warmup=TB_WARMUP,
                                               mesh=mesh, decode_overlap=dec_ov)
    sig, vcdus = timeblock_capture(cfg, tb.n_devices, block)
    lo = rank * tb.n_local * block
    hi = lo + tb.n_local * block
    soft, valid = tb.process_local(sig[lo:hi])
    rows = timeblock_frames(soft, valid, device)
    sent = {(TB_VCID, TB_COUNTER0 + i): bytes(v).hex() for i, v in enumerate(vcdus)}
    got = {(v, c): h for row in rows for v, c, h in row}
    bad = [k for k, h in got.items() if sent.get(k) != h]
    if bad:
        raise AssertionError(f"timeblocks: frames not sent or corrupted: {bad[:5]}")
    owe_lo = lo - dec_ov + frame_span if rank > 0 else 12000
    owed = {(TB_VCID, TB_COUNTER0 + i) for i in range(len(vcdus))
            if i * K.CODED_FRAME_SIZE * cfg.sps >= owe_lo
            and (i + 1) * K.CODED_FRAME_SIZE * cfg.sps + 1000 <= hi}
    missing = owed - set(got)
    if missing:
        raise AssertionError(f"timeblocks: seam frames lost: {sorted(missing)[:5]}")
    crossing = sum(1 for _, c in owed if (c - TB_COUNTER0) * K.CODED_FRAME_SIZE * cfg.sps < lo)
    if out:
        with open(out, "w") as f:
            json.dump({str(rank * tb.n_local + i): r for i, r in enumerate(rows)}, f)
    log(rank, f"timeblocks: {len(owed)} owed frames bit-exact incl. {crossing} spanning "
              f"the process boundary (decode_overlap {dec_ov})")


def check_fused(rank: int, mesh, rate: int, cpd: int, T: int) -> None:
    cfg = DemodConfig.lrit(sample_rate=rate)
    rx = pdist.DistributedFusedReceiver(cfg, DecoderConfig(mode="lrit"),
                                        channels_per_device=cpd, block_len=T, mesh=mesh)
    vcdus = tx.make_vcdus(3, scid=13, vcid=9, rng=np.random.default_rng(5))
    symbols = tx.encode_stream(vcdus, lrit=True, amp=1.0, rng=np.random.default_rng(6))
    sig = tx.modulate(symbols, cfg, np.random.default_rng(7))
    want = {(i, bytes(v)) for i, v in enumerate(vcdus)}
    st = rx.init_state()
    got = [set() for _ in range(rx.channels_local)]
    for b in range(len(sig) // T):
        x = np.tile(sig[b * T : (b + 1) * T], (rx.channels_local, 1))
        batch, ok, _, st = rx.step(x, st)
        fok = (batch.frame_ok & ok).cpu().numpy()
        ctr, vc = batch.counter.cpu().numpy(), batch.vcdu.cpu().numpy()
        for c, j in zip(*np.nonzero(fok)):
            got[c].add((int(ctr[c, j]), bytes(vc[c, j])))
    for c, g in enumerate(got):
        if not (g <= want and len(g) >= len(want) - 1):
            raise AssertionError(f"fused channel {c}: {len(g & want)} of {len(want)} frames, "
                                 f"{len(g - want)} not sent")
    log(rank, f"fused: {rx.channels_local} local channels' frames bit-exact "
              f"(of {rx.channels})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dist_worker")
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("init_method")
    p.add_argument("backend", choices=pdist.BACKENDS)
    p.add_argument("device")
    p.add_argument("entries", type=int)
    p.add_argument("--rate", type=int, default=600_000,
                   help="LRIT sample rate of the time-block and fused checks")
    p.add_argument("--channels-per-device", type=int, default=2)
    p.add_argument("--channel-block", type=int, default=1 << 13)
    p.add_argument("--tb-block", type=int, default=1 << 17)
    p.add_argument("--fused-block", type=int, default=1 << 15)
    p.add_argument("--tb-out", default=None)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"dist_worker: --device {args.device} but no CUDA device")
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    if not pdist.initialize(init_method=args.init_method, num_processes=args.world,
                            process_id=args.rank, backend=args.backend):
        raise SystemExit("dist_worker: no multi-process group")
    try:
        mesh = pdist.make_host_mesh([device] * args.entries)
        if mesh.shape != {"host": args.world, "chip": args.entries}:
            raise AssertionError(f"mesh shape {mesh.shape}")
        log(args.rank, f"joined: {args.world} processes x {args.entries} entries on {device} "
                       f"({args.backend})")
        with torch.inference_mode():
            check_channels(args.rank, mesh, device, 1_250_000, args.channels_per_device,
                           args.channel_block)
            check_timeblocks(args.rank, mesh, device, args.rate, args.tb_block, args.tb_out)
            check_fused(args.rank, mesh, args.rate, args.channels_per_device, args.fused_block)
    finally:
        torch.distributed.destroy_process_group()
    log(args.rank, "ALL OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
