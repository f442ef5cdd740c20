"""The port's apps (`runtime/apps.py`) against the JAX package's, on the CPU,
through real loopback sockets: the decoder here, the demodulator and the
fused receiver in `test_torch_apps_demod.py`.

- `DecoderApp`: the same int8 stream (LRIT and HRIT, with injected symbol
  flips that the FEC corrects and one frame it cannot) gives the same VCDU
  bytes on the vchannel port, the same `Statistics_st` records on the
  statistics port (byte for byte) and the same channel and forensics files
  as the JAX package's app; and, fed over the symbol port by TCP, the same
  VCDUs and records (the decoder-FIFO byte aside: it reports how much the
  realign buffer holds at each push, which depends on how TCP cut the
  stream).
"""

import os
import socket
import threading

import numpy as np
import pytest

from _torch_port import free_port, quiet, until
from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
from xritdemod_tpu.runtime.apps import DecoderApp as JDecoderApp
from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch import tx
from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig
from xritdemod_tpu_torch.runtime.apps import DecoderApp, DemodulatorApp
from xritdemod_tpu_torch.runtime.frontends import CFileFrontend
from xritdemod_tpu_torch.tools.interop_run import STAT_SIZE, Collector, check_vcdus, parse_stats

START = 1_700_000_000          # both apps' Statistics start time
NFRAMES = 5
FRAMES_PER_BLOCK = 2
BAD_FRAME = 3                  # obliterated: RS cannot decode it


def _wire(mode: str) -> tuple[np.ndarray, np.ndarray]:
    """An int8 symbol stream of `NFRAMES` frames after a noise lead: 160
    flipped symbols in frame 2 (corrected) and frame `BAD_FRAME` mostly
    noise (dropped)."""
    rng = np.random.default_rng(11 if mode == "lrit" else 12)
    vcdus = tx.make_vcdus(NFRAMES, scid=13, vcid=5, counter0=20, rng=rng)
    lead = 5000
    soft = tx.encode_stream(vcdus, lrit=mode == "lrit", amp=1.0, noise=0.05, lead=lead, rng=rng)
    f2 = lead + 2 * C.CODED_FRAME_SIZE
    idx = rng.choice(C.CODED_FRAME_SIZE, 160, replace=False) + f2
    soft[idx] = -soft[idx]
    fb = lead + BAD_FRAME * C.CODED_FRAME_SIZE
    soft[fb + 2000 : fb + 14000] = rng.normal(0, 1.0, 12000).astype(np.float32)
    return tx.soft_to_int8(soft * 0.5), vcdus


def _listen(app):
    """Collectors on an app's vchannel and statistics ports, accepted by its
    (started) dispatchers before any frame is decoded."""
    cols = [
        Collector(app.channel_dispatcher.bound_port, "vcdu", connect_s=10),
        Collector(app.stats_dispatcher.bound_port, "stats", connect_s=10),
    ]
    for c in cols:
        c.start()
        assert c.connected.wait(10)
    until(lambda: app.channel_dispatcher.num_clients() == 1
           and app.stats_dispatcher.num_clients() == 1)
    return cols


def _close(cols):
    quiet(cols)
    for c in cols:
        c.stop()
        c.join(5)
    return cols[0].data, cols[1].data


def _push_run(App, cfg, wire, folder, **kw):
    """`push_symbols` in fixed 7777-symbol chunks, then `flush`; returns the
    bytes on both ports and the app."""
    app = App(cfg, vchannel_port=0, statistics_port=0, dump=True,
              channels_folder=str(folder), **kw)
    app.stats.start_time = START
    app.channel_dispatcher.start()
    app.stats_dispatcher.start()
    cols = _listen(app)
    try:
        for i in range(0, len(wire), 7777):
            app.push_symbols(wire[i : i + 7777])
        app.flush()
        return _close(cols) + (app,)
    finally:
        app.channel_dispatcher.stop()
        app.stats_dispatcher.stop()


def _files(folder) -> dict:
    out = {}
    for d, _, fs in os.walk(folder):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, folder)] = open(p, "rb").read()
    return out


@pytest.fixture(scope="module", params=["lrit", "hrit"])
def decoded(request, tmp_path_factory):
    mode = request.param
    wire, vcdus = _wire(mode)
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jv, js, japp = _push_run(
        JDecoderApp, JDecoderConfig(mode=mode, frames_per_block=FRAMES_PER_BLOCK), wire, jdir)
    tv, ts, tapp = _push_run(
        DecoderApp, DecoderConfig(mode=mode, frames_per_block=FRAMES_PER_BLOCK), wire, tdir,
        device="cpu")
    return dict(mode=mode, wire=wire, vcdus=vcdus, jax=(jv, js, japp, jdir),
                port=(tv, ts, tapp, tdir))


def test_decoder_app_vchannel_bytes_equal(decoded):
    """The vchannel stream is the JAX app's, byte for byte, and holds every
    transmitted frame but the destroyed one, exact."""
    jv, tv = decoded["jax"][0], decoded["port"][0]
    assert tv == jv
    want = {(5, 20 + i): bytes(v) for i, v in enumerate(decoded["vcdus"])}
    got = check_vcdus(tv, want)
    assert got["torn"] == 0 and got["wrong"] == 0 and got["duplicate_mismatches"] == 0
    assert got["missing"] == [(5, 20 + BAD_FRAME)]


def test_decoder_app_statistics_records_equal(decoded):
    """One `Statistics_st` record a decoded batch, byte-equal to the JAX
    app's; the last parses (independent transcription of the C header) to
    the expected counts: every frame seen, the destroyed one dropped, the
    flipped frame's Viterbi corrections counted."""
    js, ts = decoded["jax"][1], decoded["port"][1]
    assert len(ts) % STAT_SIZE == 0 and len(ts) >= 2 * STAT_SIZE
    assert ts == js
    recs = [parse_stats(ts[i : i + STAT_SIZE]) for i in range(0, len(ts), STAT_SIZE)]
    last = recs[-1]
    assert last["scid"] == 13 and last["vcid"] == 5 and last["frame_bits"] == 8192
    assert last["total_packets"] == NFRAMES and last["dropped_packets"] == 1
    assert last["received_per_channel"][5] == NFRAMES - 1
    assert max(r["vit_errors"] for r in recs) > 100
    assert decoded["port"][2].stats.decoder_fifo_usage > 0


def test_decoder_app_dump_files_equal(decoded):
    """`dump=True`: the channel file and the corrupted frame's three stage
    dumps and statistics text are the JAX app's, file for file."""
    jf, tf = _files(decoded["jax"][3]), _files(decoded["port"][3])
    assert sorted(tf) == sorted(jf)
    assert "channel_5.bin" in tf and any(n.endswith("_stats.txt") for n in tf)
    for name in jf:
        assert tf[name] == jf[name], name


def test_decoder_app_over_the_symbol_port(decoded):
    """`DecoderApp.run` fed by a TCP client on its symbol port: the same
    VCDUs and, but for the decoder-FIFO byte, the same records as the push
    runs; the decoder is only ever called from the thread running `run`."""
    mode, wire = decoded["mode"], decoded["wire"]
    app = DecoderApp(DecoderConfig(mode=mode, frames_per_block=FRAMES_PER_BLOCK),
                     demodulator_port=free_port(), vchannel_port=0, statistics_port=0,
                     device="cpu")
    app.stats.start_time = START
    runner = threading.Thread(target=app.run, daemon=True)
    cols = [Collector(app.channel_dispatcher.bound_port, "vcdu", connect_s=10),
            Collector(app.stats_dispatcher.bound_port, "stats", connect_s=10)]
    for c in cols:
        c.start()
    runner.start()
    try:
        until(lambda: app.channel_dispatcher.num_clients() == 1
               and app.stats_dispatcher.num_clients() == 1)
        conn = []

        def connect():
            try:
                conn.append(socket.create_connection(("127.0.0.1", app.demodulator_port), 10))
            except OSError:
                pass
            return bool(conn)

        until(connect)
        with conn[0] as s:
            s.sendall(wire.tobytes())
        until(lambda: len(cols[1].data) >= len(decoded["jax"][1]))
        vc, st = _close(cols)
    finally:
        app.stop()
        runner.join(10)
    assert not runner.is_alive()
    assert vc == decoded["jax"][0]
    js = decoded["jax"][1]
    assert len(st) == len(js)
    mask = lambda b: b"".join(b[i : i + STAT_SIZE - 1] for i in range(0, len(b), STAT_SIZE))
    assert mask(st) == mask(js)


@pytest.mark.parametrize("App", [DemodulatorApp, DecoderApp])
def test_apps_default_to_the_gpu(App, tmp_path):
    """Without `device`, an app asks for the CUDA device and refuses to
    start without one."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        if App is DemodulatorApp:
            App(DemodConfig.lrit(), CFileFrontend(str(tmp_path / "none.c64")))
        else:
            App(DecoderConfig(), vchannel_port=0, statistics_port=0)
