"""The CADU decode chain as batched steps.

Counterpart of `xritdemod_tpu/models/decoder.py`: its `CaduDecoder`
(`decode_frames`, `decode_block`, `decode_multi`, `sync`), the forensics
fields of `FrameBatch` and the host `StreamDecoder`.  Sync is a
vectorised correlation + argmax, the per-frame flywheel recheck is one small
matmul at every frame start, and the whole FEC stack (Viterbi -> NRZ-M ->
derandomize -> RS -> header) runs on the batch at once.

Frame-boundary state matches the reference (decoder/src/newdecoder.cpp):
  - 64 soft symbols of Viterbi warm-up history are prepended per frame
    (:272-276); the caller carries a `(B, 64)` tail across calls.
  - The decoded stream is shifted back 32 bits (:295-297) so frame bytes are
    decoded[4:1028].
  - HRIT applies NRZ-M over the decoded bytes including the history prefix
    (:282-284).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch.ops import correlator as corr_op
from xritdemod_tpu_torch.ops import nrzm as nrzm_op
from xritdemod_tpu_torch.ops import reed_solomon as rs_op
from xritdemod_tpu_torch.ops import viterbi as vit_op
from xritdemod_tpu_torch.ops import viterbi_cuda
from xritdemod_tpu_torch.ops.derandomizer import derandomize
from xritdemod_tpu_torch.runtime import metrics
from xritdemod_tpu_torch.utils.bits import pack_bits

__all__ = [
    "DecoderConfig", "FrameBatch", "CaduDecoder", "StreamDecoder", "map_batch", "stack_batches",
]

_CODED = C.CODED_FRAME_SIZE          # 16384 soft symbols per coded frame
_HIST = C.LAST_FRAME_DATA_BITS       # 64 soft symbols of Viterbi history


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Decoder operating point (mirrors xritdecoder.cfg keys)."""

    mode: str = "lrit"               # "lrit" | "hrit"
    min_correlation_bits: int = C.MIN_CORRELATION_BITS
    frames_per_block: int = 8        # B coded frames decoded per device step
    # Segment-parallel Viterbi (ops/viterbi_cuda.viterbi_decode_segmented):
    # each frame's 8224 trellis steps decode as S concurrent overlapped
    # windows.  -1 = auto on the GPU (S from the batch size, see
    # `CaduDecoder._segments`), 0 = one window per frame, >= 2 = explicit.
    # A CPU tensor always takes the exact plain decoder.
    viterbi_segments: int = -1
    # Warm-up/tail overlap (trellis steps) of each window; -1 = 128.
    viterbi_overlap: int = -1
    # Corrupted-frame forensics (newdecoder.cpp:323-328): when True, every
    # FrameBatch also carries the wire-quantized coded frame, the
    # post-Viterbi frame bytes and the RS-corrected bytes, so the host can
    # dump failed frames.
    forensics: bool = False

    @property
    def lrit(self) -> bool:
        return self.mode == "lrit"

    @property
    def uws(self) -> list[int]:
        # Registration order matches newdecoder.cpp:145-151: UW0 then UW2.
        return (
            [C.LRIT_UW0, C.LRIT_UW2] if self.lrit else [C.HRIT_UW0, C.HRIT_UW2]
        )


class FrameBatch(NamedTuple):
    """Decoded results for one batch of B frames."""

    vcdu: torch.Tensor          # (B, 892) uint8 payloads
    frame_ok: torch.Tensor      # (B,) bool — at least one RS block decoded
    sync_ok: torch.Tensor       # (B,) bool — per-frame corr >= threshold
    scid: torch.Tensor          # (B,) int32
    vcid: torch.Tensor          # (B,) int32
    counter: torch.Tensor       # (B,) int32 24-bit frame counter
    vit_errors: torch.Tensor    # (B,) int32 corrected coded bits
    rs_errors: torch.Tensor     # (B, 4) int32 per-block corrections, -1 = fail
    corr: torch.Tensor          # (B,) float32 sync-word match bits
    word: torch.Tensor          # (B,) int32 matched UW index (0 = 0 deg)
    sync_word: torch.Tensor     # (B, 4) uint8 decoded sync marker bytes
    # Forensics (DecoderConfig.forensics only, else None).
    coded: torch.Tensor | None = None      # (B, 16384) int8 wire-form input
    vit_frame: torch.Tensor | None = None  # (B, 1024) uint8 post-Viterbi frame
    rs_frame: torch.Tensor | None = None   # (B, 1020) uint8 RS-corrected bytes


def map_batch(fn, batch: FrameBatch) -> FrameBatch:
    """`fn` applied to every field of `batch` that is present."""
    return FrameBatch(*(None if a is None else fn(a) for a in batch))


def stack_batches(batches, dim: int) -> FrameBatch:
    """Batches with the same fields present, stacked field by field."""
    return FrameBatch(*(
        None if xs[0] is None else torch.stack(xs, dim=dim) for xs in zip(*batches)))


class CaduDecoder:
    """Batched CADU decode: sync readout + FEC stack.

    `decode_frames` consumes `(B, 16384)` aligned soft frames plus `(B, 64)`
    carried history tails, `decode_block` `(B * 16384,)` consecutive aligned
    symbols of one stream plus one `(64,)` tail, `decode_multi` `(B, F,
    16384)`: F consecutive frames of each of B streams plus `(B, 64)` tails.
    Each returns a `FrameBatch`.
    """

    def __init__(self, config: DecoderConfig = DecoderConfig(), device="cuda"):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CaduDecoder(device='cuda') needs a CUDA device")
        self._templates = corr_op.make_templates(config.uws, self.device)

    def init_tail(self) -> torch.Tensor:
        """Neutral Viterbi history (soft 0)."""
        return torch.zeros((_HIST,), dtype=torch.float32, device=self.device)

    # -- sync acquisition: full correlation over one coded frame ----------
    @torch.no_grad()
    def sync(self, soft) -> tuple[float, int, int]:
        """`(>=16384+63,)` soft -> (corr_bits, word, pos) over one coded
        frame of lags."""
        soft = torch.as_tensor(soft, dtype=torch.float32, device=self.device)
        window = soft[: _CODED + corr_op.UW_BITS - 1]
        corr, word, pos = corr_op.best_correlation(
            corr_op.correlate(window, self._templates)
        )
        return float(corr), int(word), int(pos)

    # -- shared sync recheck + phase fix ------------------------------------
    def _sync_and_fix(self, frames: torch.Tensor):
        """`(B, 16384)` raw soft frames -> (fixed frames, word, corr,
        sync_ok): the per-frame flywheel recheck and the LRIT 180-degree
        phase fix (HRIT's NRZ-M self-resolves)."""
        cfg = self.config
        with metrics.span("rx.decode.sync"):
            signs = corr_op._hard_signs(frames[:, : corr_op.UW_BITS])
            # +-1 times +-1 summed over 64 terms: exact in any float format
            # the matmul backend picks.
            counts = (corr_op.UW_BITS + signs @ self._templates.t()) * 0.5  # (B, W)
            word = corr_op.first_argmax(counts).to(torch.int32)
            corr = counts.max(dim=-1).values
            sync_ok = corr >= cfg.min_correlation_bits
            if cfg.lrit:
                one = torch.ones((), dtype=torch.float32, device=frames.device)
                sign = torch.where(word % 2 == 1, -one, one)
                fixed = frames * sign[:, None]
            else:
                fixed = frames
        return fixed, word, corr, sync_ok

    def _segments(self, B: int) -> int:
        """Viterbi window count per frame on the GPU: enough windows to fill
        the card at small B, fewer at large B where the overlap steps are
        pure overhead; at most 8192 windows per launch so the decision
        planes stay a few hundred MB."""
        segs = self.config.viterbi_segments
        if segs < 0:
            segs = min(16, max(4, 1024 // max(B, 1)))
            while segs > 1 and B * segs > 8192:
                segs //= 2
        return segs

    # -- the FEC stack (Viterbi -> NRZ-M -> derandomize -> RS -> header) ----
    def _fec_stack(self, frames, prev_tails, word, corr, sync_ok):
        cfg = self.config
        B = frames.shape[0]
        with metrics.span("rx.decode.viterbi"):
            ext = torch.cat([prev_tails, frames], dim=1)      # (B, 16448)
            if ext.is_cuda:
                segs = self._segments(B)
                if segs >= 2:
                    ov = cfg.viterbi_overlap if cfg.viterbi_overlap >= 0 else 128
                    bits, vit_errors = viterbi_cuda.viterbi_decode_segmented(
                        ext, segments=segs, overlap=ov
                    )
                else:
                    bits, vit_errors = viterbi_cuda.viterbi_decode_kernel(ext)
            else:
                bits, vit_errors = vit_op.viterbi_decode(ext)  # (B, 8224)
        with metrics.span("rx.decode.bytes"):
            decoded = pack_bits(bits)                         # (B, 1028)
            if not cfg.lrit:
                decoded = nrzm_op.nrzm_decode_bytes(decoded)
            # Shift back 32 bits of history: frame = decoded[4:1028], then
            # strip the 4-byte sync marker.
            h = C.LAST_FRAME_DATA // 2
            frame = decoded[:, h : h + C.FRAME_SIZE]
            sync_word = frame[:, : C.SYNC_WORD_BYTES]
            body = derandomize(frame[:, C.SYNC_WORD_BYTES :])  # (B, 1020)
        with metrics.span("rx.decode.rs"):
            corrected, rs_errors = rs_op.rs_decode_frame(body)  # (B,1020),(B,4)
            frame_ok = (rs_errors != -1).any(-1) & sync_ok

            # Header parse (newdecoder.cpp:342-349).
            hdr = corrected[:, :5].to(torch.int32)
            scid = ((hdr[:, 0] & 0x3F) << 2) | ((hdr[:, 1] & 0xC0) >> 6)
            vcid = hdr[:, 1] & 0x3F
            counter = (hdr[:, 2] << 16) | (hdr[:, 3] << 8) | hdr[:, 4]

            forensics = {}
            if cfg.forensics:
                q = torch.clamp(frames * C.SYMBOL_SCALE, -128.0, 127.0)
                forensics = dict(coded=q.to(torch.int8), vit_frame=frame, rs_frame=corrected)
        return FrameBatch(
            vcdu=corrected[:, : C.VCDU_SIZE],
            frame_ok=frame_ok,
            sync_ok=sync_ok,
            scid=scid,
            vcid=vcid,
            counter=counter,
            vit_errors=vit_errors,
            rs_errors=rs_errors,
            corr=corr,
            word=word,
            sync_word=sync_word,
            **forensics,
        )

    # -- public API ---------------------------------------------------------
    @torch.no_grad()
    def decode_frames(self, frames, tails):
        """Decode `(B, 16384)` independent frames, each with its own carried
        `(B, 64)` history tail; returns (batch, new per-frame tails) — the
        entry the fused receiver uses, where B is the channel axis and
        consecutive calls chain each channel's tail through its own stream."""
        frames = torch.as_tensor(frames, device=self.device).to(torch.float32)
        tails = torch.as_tensor(tails, device=self.device).to(torch.float32)
        fixed, word, corr, sync_ok = self._sync_and_fix(frames)
        batch = self._fec_stack(fixed, tails, word, corr, sync_ok)
        return batch, fixed[:, -_HIST:]

    @torch.no_grad()
    def decode_block(self, soft, tail):
        """Decode `(B * 16384,)` aligned soft symbols of one stream (B >= 1
        whole frames) with the carried `(64,)` history tail; each frame's
        Viterbi history is the end of the frame before it.  Returns (batch,
        new tail)."""
        soft = torch.as_tensor(soft, device=self.device).to(torch.float32)
        tail = torch.as_tensor(tail, device=self.device).to(torch.float32)
        if soft.ndim != 1 or soft.shape[0] == 0 or soft.shape[0] % _CODED:
            raise ValueError(
                f"decode_block needs a whole number of {_CODED}-symbol frames, "
                f"got shape {tuple(soft.shape)}"
            )
        frames, word, corr, sync_ok = self._sync_and_fix(soft.reshape(-1, _CODED))
        prev_tails = torch.cat([tail[None, :], frames[:-1, -_HIST:]], dim=0)
        batch = self._fec_stack(frames, prev_tails, word, corr, sync_ok)
        return batch, frames[-1, -_HIST:]

    @torch.no_grad()
    def decode_multi(self, frames, tails):
        """Decode `(B, F, 16384)`: F consecutive frames of each of B streams,
        tails chained within each stream (frame f's Viterbi history is frame
        f-1's end; frame 0 takes the carried `(B, 64)` tail).  One sync
        recheck and one FEC stack over the B*F frames, so one Viterbi launch.
        Returns a FrameBatch with `(B, F)`-leading fields and the `(B, F, 64)`
        per-frame tails (the caller carries the last valid one)."""
        frames = torch.as_tensor(frames, device=self.device).to(torch.float32)
        tails = torch.as_tensor(tails, device=self.device).to(torch.float32)
        if frames.ndim != 3 or frames.shape[2] != _CODED or tails.shape != (
                frames.shape[0], _HIST):
            raise ValueError(
                f"decode_multi needs (B, F, {_CODED}) frames and (B, {_HIST}) tails, got "
                f"{tuple(frames.shape)} and {tuple(tails.shape)}"
            )
        B, F = frames.shape[0], frames.shape[1]
        fixed, word, corr, sync_ok = self._sync_and_fix(frames.reshape(B * F, _CODED))
        fx = fixed.reshape(B, F, _CODED)
        prev = torch.cat([tails[:, None, :], fx[:, :-1, -_HIST:]], dim=1)     # (B, F, 64)
        batch = self._fec_stack(fixed, prev.reshape(B * F, _HIST), word, corr, sync_ok)
        return map_batch(lambda a: a.reshape((B, F) + a.shape[1:]), batch), fx[:, :, -_HIST:]


@dataclasses.dataclass
class _StreamStats:
    frames: int = 0
    dropped: int = 0
    resyncs: int = 0


class StreamDecoder:
    """Host streaming wrapper: unaligned soft-symbol stream -> frames.

    Replaces the reference's socket loop realign/flywheel state machine
    (newdecoder.cpp:212-263): buffers symbols, acquires sync with one
    vectorised correlation, then decodes in B-frame batches with an
    always-on per-frame recheck; any frame falling below the correlation
    threshold triggers re-acquisition, like `lastFrameOK = false`.

    The buffer is host numpy; each decode moves one chunk to the device.
    Consumed symbols are skipped by a read offset and dropped when the next
    chunks are merged in, so sliding over a stretch without sync costs no
    copy per frame.
    """

    def __init__(self, config: DecoderConfig = DecoderConfig(), device="cuda"):
        self.config = config
        # One decoder serves both batch sizes: B frames once a frame has
        # verified, one frame at a time during acquisition and stream-tail
        # flush (the 46-of-64 threshold over 16384 lags false-locks readily
        # on noise, as the reference's does, so only one frame is committed
        # until a frame actually verifies).
        self.decoder = CaduDecoder(config, device=device)
        self._buf = np.zeros(0, np.float32)
        self._off = 0                # read offset into _buf
        # Incoming chunks accumulate here and merge into _buf only when a
        # decode/acquire actually needs them: concatenating the full backlog
        # on every small push is O(backlog^2).
        self._pending: list[np.ndarray] = []
        self._plen = 0
        self._tail = self.decoder.init_tail()
        self._locked = False
        self._verified = False       # a frame passed sync since (re)acquisition
        self._pos = 0
        self.stats = _StreamStats()

    @property
    def buffered(self) -> int:
        """Symbols awaiting decode (realign buffer + pending chunks)."""
        return len(self._buf) - self._off + self._plen

    def _materialize(self) -> None:
        if self._plen:
            self._buf = np.concatenate([self._buf[self._off :]] + self._pending)
            self._off = 0
            self._pending = []
            self._plen = 0

    def _emit(self, batch: FrameBatch) -> FrameBatch:
        sync_ok, ok = torch.stack([batch.sync_ok, batch.frame_ok]).cpu().numpy()
        self.stats.frames += int(ok.sum())
        self.stats.dropped += int((~ok).sum())
        if not sync_ok.all():
            self._locked = False     # reacquire, like lastFrameOK = false
            self._verified = False
        elif sync_ok[-1]:
            self._verified = True
        return batch

    def _try_acquire(self) -> bool:
        need_sync = _CODED + corr_op.UW_BITS - 1
        while True:
            if len(self._buf) - self._off < need_sync:
                return False
            corr, _, pos = self.decoder.sync(self._buf[self._off : self._off + need_sync])
            if corr < self.config.min_correlation_bits:
                # No sync in this frame-length window: slide one frame
                # (the reference drops the chunk, newdecoder.cpp:244-247).
                self._off += _CODED
                continue
            self._locked = True
            self._verified = False
            self._pos = pos
            self.stats.resyncs += 1
            return True

    def _decode(self, nb: int) -> FrameBatch:
        """Decode `nb` frames at the sync position and step past them."""
        start = self._off + self._pos
        chunk = self._buf[start : start + nb * _CODED]
        batch, self._tail = self.decoder.decode_block(chunk, self._tail)
        self._off = start + nb * _CODED
        self._pos = 0
        return self._emit(batch)

    def push(self, soft: np.ndarray) -> list[FrameBatch]:
        """Feed soft symbols (float or int8); returns decoded batches."""
        soft = np.asarray(soft, np.float32)
        self._pending.append(soft)
        self._plen += len(soft)
        B = self.config.frames_per_block
        need_sync = _CODED + corr_op.UW_BITS - 1
        out: list[FrameBatch] = []
        while True:
            if not self._locked:
                if self.buffered < need_sync:
                    break
                self._materialize()
                if not self._try_acquire():
                    break
            nb = B if self._verified else 1
            if self.buffered < self._pos + nb * _CODED:
                break
            self._materialize()
            out.append(self._decode(nb))
        return out

    def warm_jit(self) -> float:
        """Build the Viterbi kernel and run the sync and both decode sizes
        on zero input before real symbols arrive.  The upstream symbol
        sender drops on backpressure exactly like the reference's
        SymbolManager (SymbolManager.cpp:57-84), so paying the one-time
        kernel build and first launches mid-stream would lose frames.
        Returns wall seconds spent."""
        t0 = time.perf_counter()
        self.decoder.sync(np.zeros(_CODED + corr_op.UW_BITS - 1, np.float32))
        for nb in {1, self.config.frames_per_block}:
            batch, _ = self.decoder.decode_block(
                np.zeros(nb * _CODED, np.float32), self.decoder.init_tail()
            )
            batch.corr.cpu()         # wait for the device
        return time.perf_counter() - t0

    def flush(self) -> list[FrameBatch]:
        """Decode everything still buffered (stream end / disconnect): full
        B-frame batches first (the backlog can be the better part of the
        stream when the producer outpaced us), then the remaining tail one
        frame at a time."""
        self._materialize()
        out: list[FrameBatch] = self.push(np.zeros(0, np.float32))
        while True:
            if not self._locked and not self._try_acquire():
                break
            if len(self._buf) - self._off < self._pos + _CODED:
                break
            out.append(self._decode(1))
        return out
