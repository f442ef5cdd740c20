"""The three runnable applications: demodulator, decoder, fused receiver.

Counterpart of `xritdemod_tpu/runtime/apps.py`: the process-level
equivalents of the reference's two programs — `xritDemodulator`
(demodulator/src/demodulator.cpp:213-535) and `xritDecoder`
(decoder/src/newdecoder.cpp:196-406) — plus a fused single-process receiver.
Wire compatibility: int8 soft symbols in/out on :5000, VCDU payloads
broadcast on :5001, packed Statistics_st on :5002, constellation UDP :9000.

Every stage of the signal runs on the app's device (`device="cuda"` unless
the caller asks for the CPU): the demodulator's serial path (`Demodulator.
process`: the standalone AGC, RRC, Costas and clock kernels) and the
decoder's `StreamDecoder` (Viterbi kernel).  Frontends, the symbol sender,
the dispatchers and the constellation tap run threads that move bytes only;
the thread that calls `run` is the only one that touches the device.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time

import numpy as np
import torch

from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch import convert
from xritdemod_tpu_torch.models.decoder import DecoderConfig, FrameBatch, StreamDecoder
from xritdemod_tpu_torch.models.demodulator import (
    DemodConfig,
    Demodulator,
    _map_state,
    quantize_symbols,
)
from xritdemod_tpu_torch.runtime.channel_writer import ChannelWriter
from xritdemod_tpu_torch.runtime.diag import DiagManager
from xritdemod_tpu_torch.runtime.dispatchers import ChannelDispatcher, StatisticsDispatcher
from xritdemod_tpu_torch.runtime.display import Display
from xritdemod_tpu_torch.runtime.frontends import CFileFrontend, normalize_samples
from xritdemod_tpu_torch.runtime.statistics import Statistics
from xritdemod_tpu_torch.runtime.symbol_manager import SampleFifo, SymbolSender
from xritdemod_tpu_torch.utils.cplx import CF32, from_complex

__all__ = ["DemodulatorApp", "DecoderApp", "ReceiverApp"]


class DemodulatorApp:
    """frontend -> FIFO -> demod blocks on the device -> int8 symbols -> TCP :5000."""

    def __init__(
        self,
        config: DemodConfig,
        frontend,
        decoder_address: str = "127.0.0.1",
        decoder_port: int = C.DEFAULT_DECODER_PORT,
        block_len: int = 1 << 17,
        send_constellation: bool = False,
        realtime: bool = False,
        batch_pad: int = 0,
        device="cuda",
    ):
        self.config = config
        self.frontend = frontend
        # `batch_pad` > 0 runs the ONE live stream as channel 0 of a
        # `batch_pad`-channel `block_batch` (zero rows are dead lanes whose
        # AGC rails at max_gain) and reads channel 0 back: the reference's
        # TPU trick, where the serial path was slow at one channel.  On an
        # H100 it is faster only because the clock kernel runs slower at one
        # channel than its chain needs, and it spends the dead lanes' work on
        # the card: 0 (the serial `process`) is the default, and the clock's
        # one-channel layout is the fix (PERF.md §6).  The padded batch takes
        # the split front end, the serial path's stages, so that its channel
        # 0 is the serial stream lane for lane.
        self.batch_pad = batch_pad
        self.demod = Demodulator(
            dataclasses.replace(config, frontend_kernel="split"), block_len, device=device
        )
        self.device = self.demod.device
        # File playback gets producer backpressure; live sources keep the
        # reference's drop-on-overflow policy (demodulator.cpp:104-106).
        blocking = isinstance(frontend, CFileFrontend) and not getattr(
            frontend, "realtime", False
        )
        self.fifo = SampleFifo(C.FIFO_SIZE, blocking=blocking)
        self.sender = SymbolSender(decoder_address, decoder_port)
        self.diag = DiagManager() if send_constellation else None
        self.block_len = block_len
        self.realtime = realtime
        self._running = False
        self.symbols_out = 0
        self.blocks = 0
        self.block_seconds = 0.0     # wall time in the demod step, summed
        # RMS-ratio link-quality figure (GR golden-model display,
        # ops/snr.py), refreshed every SNR_INTERVAL blocks when the
        # constellation diagnostics tap is on.
        self.snr_db: float | None = None
        self.SNR_INTERVAL = 16

    @property
    def ring_kind(self) -> str:
        """Which sample ring the FIFO runs on: the C++ one or Python's."""
        return "native" if self.fifo._ring is not None else "python"

    def _on_samples(self, iq: np.ndarray, sample_type: int) -> None:
        # Normalize s16/s8 wire types to float at ingest, like
        # onSamplesAvailable (demodulator.cpp:54-74); the bundled frontends
        # already deliver FLOAT_IQ (passthrough).
        self.fifo.push(normalize_samples(iq, sample_type))

    def init_state(self):
        if self.batch_pad:
            return self.demod.init_state_batch(self.batch_pad)
        return self.demod.init_state()

    def step(self, x: np.ndarray, state):
        """One `(block_len,)` complex block -> (int8 wire symbols on the host,
        next state).  The block crosses to the device as float32."""
        xc = from_complex(np.asarray(x, np.complex64), self.device)
        if self.batch_pad:
            z = torch.zeros(
                (self.batch_pad - 1, self.block_len), dtype=torch.float32, device=self.device
            )
            xb = CF32(torch.cat([xc.re[None], z]), torch.cat([xc.im[None], z]))
            soft, valid, state = self.demod.block_batch(xb, state)
            soft, valid = soft[0], valid[0]
        else:
            soft, valid, state = self.demod.process(xc, state)
        return quantize_symbols(soft)[valid].cpu().numpy(), state

    def warm_jit(self) -> float:
        """Build and load the kernels and run one zero block before streaming
        starts, so the first live block is not a compile while the sender
        drops on backpressure; returns wall seconds.  A CPU app has nothing
        to build and skips it (its plain loops would take a block's time)."""
        if self.device.type != "cuda":
            return 0.0
        t0 = time.perf_counter()
        self.step(np.zeros(self.block_len, np.complex64), self.init_state())
        torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _emit(self, wire: np.ndarray, x, state) -> None:
        self.symbols_out += len(wire)
        self.sender.add(wire)
        self.sender.drain()
        if self.diag:
            self.diag.add_samples(wire.astype(np.float32) / 127.0)
            if self.blocks % self.SNR_INTERVAL == 0:
                st = _map_state(lambda a: a[0], state) if self.batch_pad else state
                self.snr_db = float(self.demod.snr_estimate(x, st))

    def run(self, max_blocks: int | None = None) -> None:
        self.frontend.set_sample_rate(self.config.sample_rate)
        self.frontend.set_samples_available_callback(self._on_samples)
        print(f"sample ring: {self.ring_kind}", flush=True)
        if self.diag:
            self.diag.start()
        t = self.warm_jit()
        print(f"demod jit warmup {t:.1f}s", flush=True)
        print(f"demod streaming from t={time.monotonic():.3f}", flush=True)
        state = self.init_state()
        self._running = True
        self.frontend.start()
        self.blocks = 0
        try:
            while self._running:
                x = self.fifo.pop_block(self.block_len, timeout=1.0)
                if x is None:
                    if not getattr(self.frontend, "running", True):
                        break
                    continue
                t0 = time.perf_counter()
                wire, state = self.step(x, state)
                self.block_seconds += time.perf_counter() - t0
                self._emit(wire, x, state)
                self.blocks += 1
                if max_blocks is not None and self.blocks >= max_blocks:
                    break
        finally:
            self._running = False
            self.fifo.close()
            self.frontend.stop()
            self.sender.drain()
            self.sender.close()
            if self.diag:
                self.diag.stop()

    def stop(self) -> None:
        self._running = False


class DecoderApp:
    """TCP :5000 int8 symbols -> StreamDecoder -> :5001/:5002/channel files."""

    def __init__(
        self,
        config: DecoderConfig,
        demodulator_port: int = C.DEFAULT_DEMODULATOR_PORT,
        vchannel_port: int = C.DEFAULT_VCHANNEL_PORT,
        statistics_port: int = C.DEFAULT_STATISTICS_PORT,
        display: bool = False,
        dump: bool = False,
        channels_folder: str = "channels",
        device="cuda",
    ):
        # Dump mode needs the corrupted-frame stage bytes on the batch
        # (ChannelWriter.cpp:25-65 semantics).
        if dump and not config.forensics:
            config = dataclasses.replace(config, forensics=True)
        self.config = config
        self.decoder = StreamDecoder(config, device=device)
        self.device = self.decoder.decoder.device
        self.stats = Statistics()
        self.channel_dispatcher = ChannelDispatcher(vchannel_port)
        self.stats_dispatcher = StatisticsDispatcher(statistics_port)
        self.writer = ChannelWriter(channels_folder) if dump else None
        self.display = Display() if display else None
        self.demodulator_port = demodulator_port
        self._running = False
        self._srv: socket.socket | None = None
        self._last_show = 0.0
        self.DISPLAY_INTERVAL = 0.1   # wall-clock display throttle (s)
        self.decode_seconds = 0.0     # wall time in push_symbols / flush, summed

    def _emit(self, batch: FrameBatch) -> None:
        """Sink one decoded batch: the whole batch to the host in one copy,
        vectorized stats bookkeeping, one dispatcher update per batch,
        display throttled by wall clock (the reference updates per frame only
        because it decodes per frame, newdecoder.cpp:370-395)."""
        b = FrameBatch(*convert.to_numpy(batch))
        ok, vcdu, vcid, word = b.frame_ok, b.vcdu, b.vcid, b.word
        self.stats.sync_word = bytes(b.sync_word[-1].tolist())
        self.stats.update_batch(
            scid=b.scid,
            vcid=vcid,
            counter=b.counter,
            vit_errors=b.vit_errors,
            rs_errors=b.rs_errors,
            sync_correlation=b.corr,
            phase_correction=np.where(word % 2, 180, 0),
            frame_ok=ok,
        )
        if ok.any():
            self.channel_dispatcher.add_many(
                [vcdu[k].tobytes() for k in np.flatnonzero(ok)]
            )
        if self.writer:
            for k in np.flatnonzero(ok):
                self.writer.write_channel(vcdu[k].tobytes(), int(vcid[k]))
            for k in np.flatnonzero(~ok):
                if b.coded is not None:
                    self.writer.dump_corrupted_packet(b.coded[k].tobytes(), 0)
                    self.writer.dump_corrupted_packet(b.vit_frame[k].tobytes(), 1)
                    self.writer.dump_corrupted_packet(b.rs_frame[k].tobytes(), 2)
                self.writer.dump_corrupted_packet_statistics(
                    int(b.vit_errors[k]), int(b.corr[k]), b.rs_errors[k]
                )
        self.stats_dispatcher.update(self.stats)
        if os.environ.get("XRIT_DECODE_TRACE"):
            print(
                f"[dec] t={time.monotonic():.2f} "
                f"frames={self.stats.total_packets} "
                f"buffered={self.decoder.buffered}",
                flush=True,
            )
        if self.display:
            now = time.monotonic()
            if now - self._last_show >= self.DISPLAY_INTERVAL:
                self._last_show = now
                self.display.show(self.stats)

    def push_symbols(self, soft_int8: np.ndarray) -> None:
        """Feed wire symbols directly (used by tests and the fused app)."""
        t0 = time.perf_counter()
        soft = np.asarray(soft_int8, np.int8).astype(np.float32)
        # Decoder-side FIFO usage on the stats wire: fraction of the
        # reference's FIFO budget pending in the realign buffer
        # (Statistics.h:36).
        pending = self.decoder.buffered + len(soft)
        self.stats.decoder_fifo_usage = min(
            100, int(100 * pending / C.FIFO_SIZE)
        )
        for batch in self.decoder.push(soft):
            self._emit(batch)
        self.decode_seconds += time.perf_counter() - t0

    def flush(self) -> None:
        """Decode remaining buffered frames (stream end / disconnect)."""
        t0 = time.perf_counter()
        for batch in self.decoder.flush():
            self._emit(batch)
        self.decode_seconds += time.perf_counter() - t0

    def warm_jit(self) -> float:
        """Build the decode kernels and run both batch sizes on zeros before
        the symbol port opens (the demodulator's sender drops on
        backpressure, as the reference's SymbolManager does, so a kernel
        build mid-stream would lose frames); 0 on the CPU."""
        if self.device.type != "cuda":
            return 0.0
        return self.decoder.warm_jit()

    def run(self) -> None:
        """Accept demodulator connections and decode until stopped."""
        t = self.warm_jit()
        print(f"decoder jit warmup {t:.1f}s", flush=True)
        self.channel_dispatcher.start()
        self.stats_dispatcher.start()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("0.0.0.0", self.demodulator_port))
        self._srv.listen(1)
        self._srv.settimeout(0.5)
        self._running = True
        try:
            while self._running:
                try:
                    client, _ = self._srv.accept()
                except socket.timeout:
                    continue
                client.settimeout(C.TIMEOUT)
                try:
                    while self._running:
                        try:
                            data = client.recv(C.CODED_FRAME_SIZE)
                        except socket.timeout:
                            continue
                        if not data:
                            break
                        self.push_symbols(np.frombuffer(data, np.int8))
                finally:
                    self.flush()
                    client.close()
        finally:
            self._running = False
            self._srv.close()
            self.channel_dispatcher.stop()
            self.stats_dispatcher.stop()

    def stop(self) -> None:
        self._running = False


class ReceiverApp:
    """Fused demod+decode in one process: frontend -> device pipeline ->
    dispatchers.  No symbol TCP hop (the reference's :5000 boundary exists
    only for CPU pipelining)."""

    def __init__(
        self,
        demod_config: DemodConfig,
        decoder_config: DecoderConfig,
        frontend,
        block_len: int = 1 << 17,
        device="cuda",
        **decoder_kwargs,
    ):
        self.demod_app = DemodulatorApp(
            demod_config, frontend, block_len=block_len, device=device
        )
        self.decoder_app = DecoderApp(decoder_config, device=device, **decoder_kwargs)
        self._running = False

    def run(self, max_blocks: int | None = None) -> None:
        demod, dec = self.demod_app, self.decoder_app
        t = demod.warm_jit() + dec.warm_jit()
        print(f"sample ring: {demod.ring_kind}", flush=True)
        print(f"rx jit warmup {t:.1f}s", flush=True)
        dec.channel_dispatcher.start()
        dec.stats_dispatcher.start()
        demod.frontend.set_sample_rate(demod.config.sample_rate)
        demod.frontend.set_samples_available_callback(demod._on_samples)
        state = demod.init_state()
        self._running = True
        demod.frontend.start()
        demod.blocks = 0
        try:
            while self._running:
                x = demod.fifo.pop_block(demod.block_len, timeout=1.0)
                if x is None:
                    if not getattr(demod.frontend, "running", True):
                        break
                    continue
                t0 = time.perf_counter()
                wire, state = demod.step(x, state)
                demod.block_seconds += time.perf_counter() - t0
                demod.symbols_out += len(wire)
                dec.stats.demodulator_fifo_usage = min(
                    100, int(100 * demod.fifo.usage())
                )
                dec.push_symbols(wire)
                demod.blocks += 1
                if max_blocks is not None and demod.blocks >= max_blocks:
                    break
            dec.flush()
        finally:
            self._running = False
            demod.fifo.close()
            demod.frontend.stop()
            dec.channel_dispatcher.stop()
            dec.stats_dispatcher.stop()

    def stop(self) -> None:
        self._running = False
