"""Command line: `python -m xritdemod_tpu_torch.cli {demod,decode,rx}`.

The port's counterpart of `xritdemod_tpu/cli.py`: a process-level drop-in for
the reference's `xritDemodulator` and `xritDecoder` binaries (same config
files, same ports, same wire formats), plus the fused `rx` mode running the
whole receive chain in one process.  Every stage runs on the CUDA device
unless `--device cpu` is given; without a device the command exits with an
error rather than falling back to the CPU.  (`reprocess`, the fold-parallel
bulk mode of the JAX package, is not ported yet.)
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
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    _check_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
