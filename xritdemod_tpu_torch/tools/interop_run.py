#!/usr/bin/env python3
"""INTEROP: the reference's two-process wire topology, live, on the port.

    demod (`python -m xritdemod_tpu_torch.cli demod`)
        --TCP :P0 int8 soft symbols-->  decode (`... cli decode`)
    decode --TCP :P1--> independent VCDU subscriber (this process)
    decode --TCP :P2--> independent Statistics_st reader (this process)

The port's copy of the JAX package's `tools/interop_run.py`.  The
demodulator streams quantized symbols over a real socket (the reference's
SymbolManager.cpp:23-84), the decoder accepts them, decodes, and broadcasts
VCDU payloads on the vchannel port and the packed Statistics_st struct on
the statistics port (newdecoder.cpp:196-406, StatisticsDispatcher.cpp).
Both apps run as separate OS processes through the CLI, on `--device`
(default cuda).  The collectors here share no code with the library's
dispatchers or statistics: the stats parser is transcribed field by field
from the reference's decoder/src/Statistics.h:14-36.  The capture is
synthesised by the port's `tx.py` into a temporary directory.

Checks (those of the JAX package's tool):
  - every TX frame arrives on the vchannel port bit-exact against the
    synthesized truth, none with a wrong payload, no duplicate mismatch,
    except at most `HEAD` = 3 frames (the JAX tool's allowance), which may
    only be the cold-start head or frames past the last whole block of
    the capture (which the demodulator never reads);
  - Statistics_st fields parse sanely (frame counts consistent, the SCID,
    8192 frame bits, a sync word of the two upright rotations);
  - at least 1x real time for the topology, excluding the one-time kernel
    build and warm-up block.

Usage: python -m xritdemod_tpu_torch.tools.interop_run [seconds]
           [--json OUT] [--keep-capture] [--ports P0,P1,P2] [--device cuda]
`main(argv)` returns the result dict (its `ok` says whether every check
passed); run as a script it prints it and exits 1 on a failed check.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HEAD = 3            # cold-start frames allowed missing (the JAX tool's bound)
BLOCK = 1 << 17     # samples a block of the CLI's demodulator

# ---------------------------------------------------------------------------
# Independent Statistics_st parser — transcribed from the C header
# (decoder/src/Statistics.h:14-36 of the reference, #pragma pack(1),
# little-endian x86), not from xritdemod_tpu_torch/runtime/statistics.py.
# ---------------------------------------------------------------------------
STAT_FMT = "<" + "".join([
    "B",      # uint8_t  scid
    "B",      # uint8_t  vcid
    "Q",      # uint64_t packetNumber
    "H",      # uint16_t vitErrors
    "H",      # uint16_t frameBits
    "4i",     # int32_t  rsErrors[4]
    "B",      # uint8_t  signalQuality
    "B",      # uint8_t  syncCorrelation
    "B",      # uint8_t  phaseCorrection
    "Q",      # uint64_t lostPackets
    "H",      # uint16_t averageVitCorrections
    "B",      # uint8_t  averageRSCorrections
    "Q",      # uint64_t droppedPackets
    "256q",   # int64_t  receivedPacketsPerChannel[256]
    "256q",   # int64_t  lostPacketsPerChannel[256]
    "Q",      # uint64_t totalPackets
    "I",      # uint32_t startTime
    "4s",     # uint8_t  syncWord[4]
    "B",      # uint8_t  frameLock
    "B",      # uint8_t  demodulatorFifoUsage
    "B",      # uint8_t  decoderFifoUsage
])
STAT_SIZE = struct.calcsize(STAT_FMT)


def parse_stats(buf: bytes) -> dict:
    v = struct.unpack(STAT_FMT, buf)
    # flat unpack indices: 0 scid, 1 vcid, 2 packetNumber, 3 vitErrors,
    # 4 frameBits, 5..8 rsErrors[4], 9 signalQuality, 10 syncCorrelation,
    # 11 phaseCorrection, 12 lostPackets, 13 averageVitCorrections,
    # 14 averageRSCorrections, 15 droppedPackets, 16..271 received[256],
    # 272..527 lost[256], 528 totalPackets, 529 startTime, 530 syncWord,
    # 531 frameLock, 532/533 fifo usages.
    return {
        "scid": v[0], "vcid": v[1], "packet_number": v[2],
        "vit_errors": v[3], "frame_bits": v[4], "rs_errors": v[5:9],
        "signal_quality": v[9], "sync_correlation": v[10],
        "phase_correction": v[11], "lost_packets": v[12],
        "avg_vit": v[13], "avg_rs": v[14],
        "dropped_packets": v[15],
        "received_per_channel": v[16:272],
        "total_packets": v[528],
        "sync_word": v[530],
        "frame_lock": v[531],
    }


class Collector(threading.Thread):
    """Connect to a dispatcher port and buffer everything it sends."""

    def __init__(self, port: int, name: str, connect_s: float = 180.0):
        super().__init__(daemon=True, name=name)
        self.port = port
        self.connect_s = connect_s
        self.chunks: list[bytes] = []
        self.connected = threading.Event()
        self._halt = False

    def run(self):
        deadline = time.monotonic() + self.connect_s
        while time.monotonic() < deadline and not self._halt:
            try:
                s = socket.create_connection(("127.0.0.1", self.port), 2)
                break
            except OSError:
                time.sleep(0.2)
        else:
            return
        self.connected.set()
        s.settimeout(1.0)
        with s:
            while not self._halt:
                try:
                    d = s.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not d:
                    break
                self.chunks.append(d)

    def stop(self):
        self._halt = True

    @property
    def data(self) -> bytes:
        return b"".join(self.chunks)


def check_vcdus(raw: bytes, want: dict) -> dict:
    """Frames on a vchannel stream against the truth `{(vcid, counter):
    bytes}`: counts of exact, missing, wrong payloads and duplicate
    mismatches, and the missing frames' keys."""
    vcdu = 892
    got: dict[tuple[int, int], bytes] = {}
    corrupt = 0
    for i in range(len(raw) // vcdu):
        v = raw[i * vcdu : (i + 1) * vcdu]
        key = (v[1] & 0x3F, int.from_bytes(v[2:5], "big"))
        if got.setdefault(key, v) != v:
            corrupt += 1
    exact = sum(1 for k, v in got.items() if want.get(k) == v)
    wrong = sum(1 for k, v in got.items() if k in want and want[k] != v)
    return {
        "torn": len(raw) % vcdu,
        "exact": exact,
        "wrong": wrong,
        "duplicate_mismatches": corrupt,
        "missing": sorted(k for k in want if got.get(k) != want[k]),
    }


def synthesize(cfg, lrit: bool, seconds: float, path: str, seed: int, vcid: int = 5,
               clock_ppm: float = 30.0) -> np.ndarray:
    """`seconds` of a synthesised LRIT or HRIT stream at `cfg`'s rates (carrier
    offset 1e-4, symbol-clock drift `clock_ppm`, noise 0.02) into a c64 file
    at `path`; returns the VCDUs sent (`seconds * symbol_rate / 16384 - 1`
    frames).  Numpy only, so it can run in a worker process."""
    from xritdemod_tpu_torch import tx

    nframes = int(seconds * cfg.symbol_rate) // 16384 - 1
    rng = np.random.default_rng(seed)
    vcdus = tx.make_vcdus(nframes, scid=13, vcid=vcid, rng=rng)
    symbols = tx.encode_stream(vcdus, lrit=lrit, amp=1.0, rng=rng)
    sig = tx.modulate(symbols, cfg, rng, freq_offset=1e-4, clock_ppm=clock_ppm, noise=0.02)
    np.asarray(sig, np.complex64).tofile(path)
    return vcdus


def frames_demodulated(nframes: int, sps: float, nsamples: int, block: int = BLOCK) -> int:
    """How many of a capture's first frames lie wholly in the samples a
    demodulator consumes in whole blocks (the rest of the file, less than
    a block, is never demodulated): frame i's symbols end near sample
    (i + 1) * 16384 * sps, plus the receive filter's delay and the clock's
    look-ahead (256 samples is more than both with the synthesised clock
    drift)."""
    consumed = (nsamples // block) * block
    return sum(1 for i in range(nframes) if (i + 1) * 16384 * sps + 256 <= consumed)


def frame_failures(check: dict, whole: int) -> list[str]:
    """What is wrong with a vchannel stream, from `check_vcdus`'s `check`:
    torn bytes, wrong payloads or duplicate mismatches, and missing frames
    beyond the allowance: at most `HEAD`, each in the cold-start head
    (counter < HEAD) or past the first `whole` frames (those the
    demodulator's whole blocks hold).  Empty when the stream passes."""
    out = []
    if check["torn"]:
        out.append(f"vchannel stream tears: {check['torn']} stray bytes")
    if check["wrong"] or check["duplicate_mismatches"]:
        out.append("payload corruption on the wire")
    unexplained = [k for k in check["missing"] if HEAD <= k[1] < whole]
    if len(check["missing"]) > HEAD or unexplained:
        out.append(f"{len(check['missing'])} frames lost, {len(unexplained)} after the "
                   "head and before the capture's last partial block")
    return out


def _kill(proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    if proc.poll() is None:
        proc.terminate()
    try:
        out, _ = proc.communicate(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return out or ""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="interop_run")
    ap.add_argument("seconds", nargs="?", type=float, default=60.0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--clock-ppm", type=float, default=30.0)
    ap.add_argument("--keep-capture", action="store_true")
    ap.add_argument("--ports", default="15000,15001,15002")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds allowed to each of the demod run and the drain")
    args = ap.parse_args(argv)
    p0, p1, p2 = (int(p) for p in args.ports.split(","))

    from xritdemod_tpu_torch.models.demodulator import DemodConfig

    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    nsym = int(args.seconds * cfg.symbol_rate)
    nframes = nsym // 16384 - 1
    print(f"synthesizing {args.seconds:.0f}s capture ({nframes} frames)...", flush=True)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="interop_")
    cap = os.path.join(tmp, "capture.c64")
    vcdus = synthesize(cfg, True, args.seconds, cap, 17, vcid=5, clock_ppm=args.clock_ppm)
    whole = frames_demodulated(nframes, cfg.sps, os.path.getsize(cap) // 8)
    t_synth = time.perf_counter() - t0
    print(f"synth {t_synth:.1f}s -> {cap} ({os.path.getsize(cap) >> 20} MB)", flush=True)

    dcfg_path = os.path.join(tmp, "xritdemod.cfg")
    with open(dcfg_path, "w") as f:
        f.write(f"mode=lrit\nsampleRate={cfg.sample_rate}\ndecimation=1\n"
                f"decoderAddress=127.0.0.1\ndecoderPort={p0}\n"
                f"deviceType=cfile\nfilename={cap}\n")
    xcfg_path = os.path.join(tmp, "xritdecoder.cfg")
    with open(xcfg_path, "w") as f:
        f.write(f"mode=lrit\ndemodulatorPort={p0}\nvChannelPort={p1}\n"
                f"statisticsPort={p2}\nframesPerBlock=32\n")

    cli = [sys.executable, "-m", "xritdemod_tpu_torch.cli"]
    env = dict(os.environ)
    dec_env = {**env, "XRIT_DECODE_TRACE": "1"}     # a timeline line per batch
    decoder = demod = None
    vcdu_rx = Collector(p1, "vcdu")
    stats_rx = Collector(p2, "stats")
    failures: list[str] = []
    demod_out = dec_out = ""
    t_demod = t_wall = float("nan")
    try:
        decoder = subprocess.Popen(
            [*cli, "decode", "--config", xcfg_path, "--device", args.device],
            cwd=REPO, env=dec_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        # The decoder builds its kernels and runs its warm-up before it opens
        # any port: wait until the symbol port listens.
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline and decoder.poll() is None:
            try:
                socket.create_connection(("127.0.0.1", p0), 1).close()
                break
            except OSError:
                time.sleep(0.5)
        else:
            raise RuntimeError(
                f"decoder never listened on the symbol port:\n{_kill(decoder)[-3000:]}")
        vcdu_rx.start()
        stats_rx.start()
        for c in (vcdu_rx, stats_rx):
            if not c.connected.wait(30):
                raise RuntimeError(f"no connection to the {c.name} port")

        print(f"starting demod ({args.device}) ...", flush=True)
        t0, t0_mono = time.perf_counter(), time.monotonic()
        demod = subprocess.Popen(
            [*cli, "demod", "--config", dcfg_path, "--file", cap, "--format", "c64",
             "--device", args.device],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        demod_out, _ = demod.communicate(timeout=args.timeout)
        t_demod = time.perf_counter() - t0
        if demod.returncode != 0:
            raise RuntimeError(f"demod failed:\n{demod_out[-3000:]}")

        # Wait for the decoder to drain everything the demod sent; the
        # topology is timed end to end through the drain.
        last, quiet = -1, 0
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline and quiet < 3:
            time.sleep(2)
            cur = len(vcdu_rx.data) + len(stats_rx.data)
            quiet = quiet + 1 if cur == last else 0
            last = cur
        t_wall = time.perf_counter() - t0 - 6.0    # minus the quiet window
    finally:
        dec_out = _kill(decoder)
        _kill(demod)
        time.sleep(0.5)
        for c in (vcdu_rx, stats_rx):
            c.stop()
            if c.is_alive():
                c.join(2)
        if not args.keep_capture:
            shutil.rmtree(tmp, ignore_errors=True)
    if os.environ.get("XRIT_DECODE_TRACE"):
        sys.stderr.write(dec_out[-8000:] + "\n")
    # The decoder's timeline (`[dec] t=<monotonic>` a batch, the clock this
    # process reads too) and its own time in the decoder.
    batch_t = [float(t) for t in re.findall(r"\[dec\] t=([0-9.]+)", dec_out)]
    m = re.search(r"decoded: (\d+) frames, ([0-9.]+)s in the decoder", dec_out)
    dec_s = float(m.group(2)) if m else None

    # ---- VCDU payload check vs TX truth --------------------------------
    want = {(5, i): bytes(vcdus[i]) for i in range(nframes)}
    v = check_vcdus(vcdu_rx.data, want)
    failures += frame_failures(v, whole)

    # ---- Statistics_st checks ------------------------------------------
    sdata = stats_rx.data
    nstats = len(sdata) // STAT_SIZE
    last = parse_stats(sdata[(nstats - 1) * STAT_SIZE : nstats * STAT_SIZE]) \
        if nstats else {}
    stats_ok = bool(
        nstats
        and len(sdata) % STAT_SIZE == 0
        and last["scid"] == 13
        and last["frame_bits"] == 8192
        and last["total_packets"] >= v["exact"]
        and last["received_per_channel"][5] >= v["exact"] - 2
        and last["frame_lock"] in (0, 1)
        and last["sync_word"] in (b"\x1a\xcf\xfc\x1d", b"\xe5\x30\x03\xe2")
    )

    m = re.search(r"demod jit warmup ([0-9.]+)s", demod_out)
    t_warm = float(m.group(1)) if m else 0.0
    m = re.search(r"blocks: (\d+) in ([0-9.]+)s", demod_out)
    blocks, step_s = (int(m.group(1)), float(m.group(2))) if m else (0, float("nan"))
    m = re.search(r"ready at t=([0-9.]+)", demod_out)
    t_ready = float(m.group(1)) - t0_mono if m else None
    m = re.search(r"demod streaming from t=([0-9.]+)", demod_out)
    t_stream = float(m.group(1)) - t0_mono if m else None
    # Streaming alone: from the demodulator's first block to the decoder's
    # last batch (process start, imports, CUDA context and warm-up left out).
    xrt_streaming = (args.seconds / (batch_t[-1] - t0_mono - t_stream)
                     if batch_t and t_stream is not None else None)
    m = re.search(r"sample ring: (\w+)", demod_out)
    xrt = args.seconds / t_wall
    xrt_stream = args.seconds / max(t_wall - t_warm, 1e-9)

    if not stats_ok:
        failures.append(f"statistics stream failed sanity: {last}")
    if not xrt_stream >= 1.0:
        failures.append(f"only {xrt_stream:.2f}x real time")
    result = {
        "ok": not failures,
        "failures": failures,
        "seconds": args.seconds,
        "device": args.device,
        "frames_sent": nframes,
        "frames_exact": v["exact"],
        "frames_missing": len(v["missing"]),
        "frames_past_the_last_whole_block": nframes - whole,
        "missing_counters": [k[1] for k in v["missing"]][:16],
        "frames_wrong_payload": v["wrong"],
        "duplicate_mismatches": v["duplicate_mismatches"],
        "synth_s": t_synth,
        "wall_s": t_wall,
        "demod_wall_s": t_demod,
        "demod_jit_warmup_s": t_warm,
        "demod_app_ready_s": t_ready,
        "demod_streaming_from_s": t_stream,
        "decoder_batches": len(batch_t),
        "decoder_last_batch_s": batch_t[-1] - t0_mono if batch_t else None,
        "decoder_busy_s": dec_s,
        "demod_blocks": blocks,
        "demod_ms_per_block": 1e3 * step_s / blocks if blocks else None,
        "sample_ring": m.group(1) if m else None,
        "x_realtime_incl_wire": xrt,
        "x_realtime_excl_warmup": xrt_stream,
        "x_realtime_streaming": xrt_streaming,
        "stats_records": nstats,
        "stats_last": {k: val for k, val in last.items()
                       if k not in ("received_per_channel",)},
        "stats_ok": stats_ok,
        "ports": [p0, p1, p2],
        "clock_ppm": args.clock_ppm,
    }
    result["stats_last"]["sync_word"] = last["sync_word"].hex() if nstats else ""
    result["stats_last"]["rs_errors"] = list(last.get("rs_errors", ()))
    print(json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print("INTEROP OK" if result["ok"] else "INTEROP FAILED", flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
