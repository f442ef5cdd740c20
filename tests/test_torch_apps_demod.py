"""The port's demodulator and fused receiver apps against the JAX package's,
on the CPU, through real loopback sockets (the decoder app is in
`test_torch_apps.py`):

- `DemodulatorApp`: the int8 symbols it sends on the symbol port against
  the JAX app's on the same capture file, and its padded batch (`batch_pad`)
  against its serial path.
- `ReceiverApp`: the frames on its vchannel port against the JAX app's and
  against the transmitted VCDUs.

The demodulator's plain loops cost ~0.3 ms a sample on the CPU, so the
captures are two frames of LRIT at 625 ksps (sps ~2.13) in 8192-sample
blocks: the symbol comparisons take the first two blocks of one, the
receiver runs the other, whose nine whole blocks hold both frames.
"""

import os
import socket
import threading

import numpy as np
import pytest

from _torch_port import until
from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.runtime.apps import DemodulatorApp as JDemodulatorApp
from xritdemod_tpu.runtime.apps import ReceiverApp as JReceiverApp
from xritdemod_tpu.runtime.frontends import CFileFrontend as JCFileFrontend
from xritdemod_tpu_torch import tx
from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig
from xritdemod_tpu_torch.runtime.apps import DemodulatorApp, ReceiverApp
from xritdemod_tpu_torch.runtime.frontends import CFileFrontend
from xritdemod_tpu_torch.tools.interop_run import Collector, check_vcdus, frames_demodulated

RATE = 625_000
BLOCKS = 9          # whole 8192-sample blocks in the capture


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """Two frames of LRIT at 625 ksps in a c64 file, and their VCDUs."""
    rng = np.random.default_rng(5)
    cfg = DemodConfig.lrit(sample_rate=RATE)
    vcdus = tx.make_vcdus(2, scid=13, vcid=5, rng=rng)
    symbols = tx.encode_stream(vcdus, lrit=True, amp=1.0, rng=rng)
    sig = tx.modulate(symbols, cfg, rng, freq_offset=1e-4, noise=0.02)
    path = str(tmp_path_factory.mktemp("cap") / "cap.c64")
    np.asarray(sig, np.complex64).tofile(path)
    return path, vcdus


@pytest.fixture(scope="module")
def whole_capture(tmp_path_factory):
    """Two frames of LRIT at 625 ksps in a c64 file of BLOCKS whole blocks,
    and their VCDUs.  A third frame is modulated and cut at the file's end,
    so that both frames lie wholly in the samples the apps demodulate and
    the second is followed by the next sync word."""
    rng = np.random.default_rng(5)
    cfg = DemodConfig.lrit(sample_rate=RATE)
    vcdus = tx.make_vcdus(3, scid=13, vcid=5, rng=rng)
    symbols = tx.encode_stream(vcdus, lrit=True, amp=1.0, rng=rng)
    sig = tx.modulate(symbols, cfg, rng, freq_offset=1e-4, noise=0.02)[: BLOCKS * 8192]
    assert len(sig) == BLOCKS * 8192
    assert frames_demodulated(3, cfg.sps, len(sig), 8192) == 2
    path = str(tmp_path_factory.mktemp("cap") / "whole.c64")
    np.asarray(sig, np.complex64).tofile(path)
    return path, vcdus[:2]


def _demod_run(App, Frontend, cfg, path, nblocks, **kw):
    """Run a demod app on the capture into a TCP sink; returns the int8
    symbols received and the app."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    chunks = []

    def serve():
        conn, _ = srv.accept()
        conn.settimeout(120)
        with conn:
            while True:
                d = conn.recv(1 << 16)
                if not d:
                    break
                chunks.append(d)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    app = App(cfg, Frontend(path), decoder_address="127.0.0.1",
              decoder_port=srv.getsockname()[1], block_len=8192, **kw)
    app.run(max_blocks=nblocks)
    t.join(30)
    srv.close()
    assert not t.is_alive()
    return np.frombuffer(b"".join(chunks), np.int8), app


@pytest.fixture(scope="module")
def demod_symbols(capture):
    path, _ = capture
    j, japp = _demod_run(JDemodulatorApp, JCFileFrontend, JDemodConfig.lrit(sample_rate=RATE),
                         path, 2, batch_pad=0)
    t, tapp = _demod_run(DemodulatorApp, CFileFrontend, DemodConfig.lrit(sample_rate=RATE),
                         path, 2, device="cpu")
    assert tapp.symbols_out == len(t) and japp.symbols_out == len(j)
    return j, t


def test_demodulator_app_symbols_against_jax(demod_symbols):
    """The same symbol count; at most 0.5 % of the int8 symbols one LSB
    apart and none further (the JAX serial path runs its scan form of the
    AGC, the port the exact recursion: a few 1e-6 on the soft symbols, which
    the x127 quantizer turns into an LSB where one sits on a rounding
    edge)."""
    j, t = demod_symbols
    assert len(t) == len(j) > 7000
    d = np.abs(t.astype(np.int16) - j.astype(np.int16))
    assert d.max() <= 1
    assert np.mean(d > 0) <= 5e-3


def test_demodulator_app_batch_pad_equals_serial(capture, demod_symbols):
    """The stream as channel 0 of a 3-channel split-path batch sends the
    serial path's int8 symbols exactly; with the constellation tap on, the
    SNR estimate of channel 0 is taken on the first block."""
    path, _ = capture
    padded, app = _demod_run(DemodulatorApp, CFileFrontend, DemodConfig.lrit(sample_rate=RATE),
                             path, 2, device="cpu", batch_pad=3, send_constellation=True)
    assert app.batch_pad == 3 and app.blocks == 2
    assert app.snr_db is not None and np.isfinite(app.snr_db)
    np.testing.assert_array_equal(padded, demod_symbols[1])


def _rx_run(App, Frontend, cfg, dcfg, path, drain=False, **kw):
    """Run a receiver app on the capture; returns every byte its vchannel
    port sent, and the app.  The collector is read once the server has
    closed its connection at `stop` (everything sent before lies in the
    socket by then).  `drain`: the app's `stop` first waits until its
    server's queue is empty (the JAX package's server ends its loop at
    `stop` and drops what the queue still holds, such as the final flush's
    frames; while it runs it sends everything queued)."""
    app = App(cfg, dcfg, Frontend(path), block_len=8192, vchannel_port=0,
              statistics_port=0, **kw)
    server = app.decoder_app.channel_dispatcher
    if drain:
        stop = server.stop

        def drained_stop():
            until(server._q.empty)
            stop()
        server.stop = drained_stop
    cols = [Collector(server.bound_port, "vcdu", connect_s=10)]
    cols[0].start()
    assert cols[0].connected.wait(10)
    server.start()
    until(lambda: server.num_clients() == 1)
    app.run()
    cols[0].join(30)
    assert not cols[0].is_alive()
    return cols[0].data, app


def test_receiver_app_frames_against_jax(whole_capture):
    """The fused app decodes both of the capture's frames onto its
    vchannel port, exact against the transmitted VCDUs, and counts as many
    frames as the JAX app; the JAX app's vchannel bytes are the same or a
    prefix of them (the JAX app stops its dispatchers right after the final
    flush, and its server can drop that flush's frames from the wire: the
    test lets its queue drain first; the port's sends all it holds before
    it stops, with no such help)."""
    path, vcdus = whole_capture
    jv, japp = _rx_run(JReceiverApp, JCFileFrontend, JDemodConfig.lrit(sample_rate=RATE),
                       JDecoderConfig(mode="lrit", frames_per_block=2), path, drain=True)
    tv, tapp = _rx_run(ReceiverApp, CFileFrontend, DemodConfig.lrit(sample_rate=RATE),
                       DecoderConfig(mode="lrit", frames_per_block=2), path, device="cpu")
    assert len(jv) >= 892 and tv[: len(jv)] == jv
    got = check_vcdus(tv, {(5, i): bytes(v) for i, v in enumerate(vcdus)})
    assert got["missing"] == [] and got["exact"] == 2
    assert got["wrong"] == got["duplicate_mismatches"] == got["torn"] == 0
    st, jst = tapp.decoder_app.stats, japp.decoder_app.stats
    assert st.total_packets == jst.total_packets == 2
    assert len(tv) == 892 * (st.total_packets - st.dropped_packets)
    assert st.scid == 13 and st.vcid == 5
    assert tapp.demod_app.blocks == BLOCKS
