"""Command line: `python -m xritdemod_tpu_torch.cli {demod,decode,rx,reprocess}`.

The port's counterpart of `xritdemod_tpu/cli.py`: a process-level drop-in for
the reference's `xritDemodulator` and `xritDecoder` binaries (same config
files, same ports, same wire formats), plus the fused `rx` mode running the
whole receive chain in one process, and `reprocess`, which decodes a
recorded capture fold-parallel into per-VCID channel files.  Every stage
runs on the CUDA device unless `--device cpu` is given; without a device the
command exits with an error rather than falling back to the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time


def _hook_sigint(app) -> None:
    """Ctrl-C -> graceful stop, second Ctrl-C -> hard exit
    (reference ExitHandler semantics, demodulator.cpp:477-482)."""
    from xritdemod_tpu_torch.runtime.exit_handler import ExitHandler

    ExitHandler.set_callback(lambda sig: app.stop())
    ExitHandler.register_signal()


def _check_device(device: str) -> None:
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(
            f"error: --device {device} but no CUDA device is available "
            "(pass --device cpu to run on the CPU)"
        )


def _file_frontend(path: str, fmt: str, realtime: bool):
    """Capture-file frontend by sample format: c64 via CFileFrontend
    (GQRX raw, CFileFrontend.cpp:33-62); u8/s8 8-bit interleaved IQ via
    the RTL frontend's playback path (reference LUT normalization)."""
    from xritdemod_tpu_torch.runtime.frontends import CFileFrontend, RtlFrontend

    if fmt == "auto":
        fmt = {"s8": "s8", "u8": "u8"}.get(
            path.rsplit(".", 1)[-1].lower(), "c64")
    if fmt == "c64":
        return CFileFrontend(path, realtime=realtime)
    if fmt in ("u8", "s8"):
        return RtlFrontend(filename=path, realtime=realtime,
                           signed_input=(fmt == "s8"))
    raise SystemExit(f"unknown --format {fmt!r}")


def _frontend(args, parser):
    from xritdemod_tpu_torch.runtime.frontends import make_frontend

    if args.file:
        return _file_frontend(args.file, args.format, args.realtime)
    return make_frontend(parser.get("deviceType", "cfile"), parser)


def _demod(args) -> int:
    from xritdemod_tpu_torch.runtime.apps import DemodulatorApp
    from xritdemod_tpu_torch.runtime.config import demod_config_from_file

    cfg, parser = demod_config_from_file(args.config)
    frontend = _frontend(args, parser)
    app = DemodulatorApp(
        cfg,
        frontend,
        decoder_address=parser.get("decoderAddress", "127.0.0.1"),
        decoder_port=int(parser.get("decoderPort", "5000")),
        send_constellation=parser.get("sendConstellation", "false").lower()
        == "true",
        device=args.device,
    )
    print(f"xritdemod_tpu_torch demod: {frontend.get_name()}, "
          f"{cfg.symbol_rate} sym/s, sps={cfg.sps:.3f}, device={app.device}, "
          f"ready at t={time.monotonic():.3f}", flush=True)
    _hook_sigint(app)
    app.run(max_blocks=args.max_blocks)
    print(f"symbols out: {app.symbols_out}")
    print(f"blocks: {app.blocks} in {app.block_seconds:.3f}s of demod steps")
    return 0


def _decode(args) -> int:
    from xritdemod_tpu_torch.runtime.apps import DecoderApp
    from xritdemod_tpu_torch.runtime.config import decoder_config_from_file

    cfg, parser = decoder_config_from_file(args.config)
    app = DecoderApp(
        cfg,
        demodulator_port=int(parser.get("demodulatorPort", "5000")),
        vchannel_port=int(parser.get("vChannelPort", "5001")),
        statistics_port=int(parser.get("statisticsPort", "5002")),
        display=args.display or parser.get("display", "false").lower() == "true",
        dump=parser.get("dumpPackets", "false").lower() == "true",
        device=args.device,
    )
    print(f"xritdemod_tpu_torch decode: mode={cfg.mode}, listening :"
          f"{app.demodulator_port}, device={app.device}")
    _hook_sigint(app)
    app.run()
    st = app.stats
    print(f"decoded: {st.total_packets - st.dropped_packets} frames, "
          f"{app.decode_seconds:.3f}s in the decoder")
    return 0


def _rx(args) -> int:
    from xritdemod_tpu_torch.models.decoder import DecoderConfig
    from xritdemod_tpu_torch.runtime.apps import ReceiverApp
    from xritdemod_tpu_torch.runtime.config import demod_config_from_file

    cfg, parser = demod_config_from_file(args.config)
    mode = parser.get("mode", "lrit")
    frontend = _frontend(args, parser)
    app = ReceiverApp(
        cfg,
        DecoderConfig(mode=mode),
        frontend,
        device=args.device,
        display=args.display,
        dump=args.dump,
    )
    print(f"xritdemod_tpu_torch rx: {frontend.get_name()}, mode={mode}, "
          f"device={app.demod_app.device}")
    _hook_sigint(app)
    app.run(max_blocks=args.max_blocks)
    st = app.decoder_app.stats
    print(
        f"frames={st.total_packets - st.dropped_packets} "
        f"dropped={st.dropped_packets} lost={st.lost_packets}"
    )
    return 0


def _reprocess(args) -> int:
    """Bulk-reprocess a recorded capture fold-parallel (no pacing, no
    sockets): capture file in -> per-VCID channel files out."""
    import numpy as np

    from xritdemod_tpu_torch.parallel.timeblocks import FoldedCaptureReceiver
    from xritdemod_tpu_torch.runtime.channel_writer import ChannelWriter
    from xritdemod_tpu_torch.runtime.config import demod_config_from_file

    cfg, _ = demod_config_from_file(args.config)
    fmt = args.format
    if fmt == "auto":
        fmt = {"c64": "c64", "cfile": "c64", "raw": "c64",
               "s8": "s8", "u8": "u8"}.get(
            args.file.rsplit(".", 1)[-1].lower(), "c64")
    if fmt == "c64":
        x = np.fromfile(args.file, np.complex64)
        n = len(x)
    elif fmt == "s8":
        # Interleaved signed 8-bit IQ: straight onto the int8 device wire
        # (utils/cplx.quantize_iq_s8 layout, scale 1/127).
        x = np.fromfile(args.file, np.int8)
        n = len(x) // 2
    elif fmt == "u8":
        # RTL-SDR style unsigned 8-bit IQ: (v ^ 0x80) as signed is v - 128,
        # the reference's (i - 128)/127 after the 1/127 dequantization.
        x = (np.fromfile(args.file, np.uint8) ^ 0x80).view(np.int8)
        n = len(x) // 2
    else:
        raise SystemExit(f"unknown --format {fmt!r}")
    print(f"xritdemod_tpu_torch reprocess: {n} samples "
          f"({n / cfg.sample_rate:.1f}s of capture, {fmt}), "
          f"folds={args.folds}")
    rx = FoldedCaptureReceiver(cfg, folds=args.folds, block_len=args.block_len,
                               device=args.device)
    frames = rx.process(x)
    writer = ChannelWriter(args.out)
    per_vcid: dict[int, int] = {}
    for scid, vcid, ctr, vcdu in frames:
        writer.write_channel(vcdu, vcid)
        per_vcid[vcid] = per_vcid.get(vcid, 0) + 1
    print(f"frames={len(frames)} vcids=" + ",".join(
        f"{k}:{v}" for k, v in sorted(per_vcid.items())))
    return 0


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="xritdemod_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(q):
        q.add_argument("--device", default="cuda",
                       help="torch device of every stage (default cuda; "
                       "cpu runs the plain versions of the kernels)")

    def capture(q):
        q.add_argument("--file", help="IQ capture (overrides config)")
        q.add_argument("--format", default="auto",
                       choices=["auto", "c64", "s8", "u8"],
                       help="capture sample format (auto = by extension)")
        q.add_argument("--realtime", action="store_true")
        q.add_argument("--max-blocks", type=int, default=None)

    d = sub.add_parser("demod", help="demodulate IQ -> soft symbols TCP :5000")
    d.add_argument("--config", default="xritdemod.cfg")
    capture(d)
    device(d)
    d.set_defaults(fn=_demod)

    c = sub.add_parser("decode", help="decode soft symbols -> VCDUs :5001")
    c.add_argument("--config", default="xritdecoder.cfg")
    c.add_argument("--display", action="store_true")
    device(c)
    c.set_defaults(fn=_decode)

    r = sub.add_parser("rx", help="fused demod+decode in one process")
    r.add_argument("--config", default="xritdemod.cfg")
    capture(r)
    r.add_argument("--display", action="store_true")
    r.add_argument("--dump", action="store_true")
    device(r)
    r.set_defaults(fn=_rx)

    g = sub.add_parser(
        "reprocess",
        help="bulk-reprocess a capture fold-parallel -> channel files",
    )
    g.add_argument("file", help="IQ capture (complex64, or raw 8-bit IQ "
                   "with --format s8/u8)")
    g.add_argument("--config", default="xritdemod.cfg")
    g.add_argument("--format", default="auto",
                   choices=["auto", "c64", "s8", "u8"],
                   help="sample format: c64 = complex64 (GQRX raw), s8 = "
                   "interleaved signed 8-bit IQ, u8 = unsigned 8-bit IQ "
                   "(RTL-SDR captures); auto = by file extension")
    g.add_argument("--folds", type=int, default=128)
    g.add_argument("--block-len", type=int, default=1 << 17)
    g.add_argument("--out", default="channels")
    device(g)
    g.set_defaults(fn=_reprocess)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    _check_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
