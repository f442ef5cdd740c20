"""The CADU decode chain as batched steps.

Counterpart of `xritdemod_tpu/models/decoder.py` (its `CaduDecoder`; the
host `StreamDecoder`, `decode_block`, `decode_multi` and the forensics
fields are not ported yet).  Sync is a vectorised correlation + argmax, the
per-frame flywheel recheck is one small matmul at every frame start, and the
whole FEC stack (Viterbi -> NRZ-M -> derandomize -> RS -> header) runs on
the batch at once.

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
from typing import NamedTuple

import torch

from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch.ops import correlator as corr_op
from xritdemod_tpu_torch.ops import nrzm as nrzm_op
from xritdemod_tpu_torch.ops import reed_solomon as rs_op
from xritdemod_tpu_torch.ops import viterbi as vit_op
from xritdemod_tpu_torch.ops import viterbi_cuda
from xritdemod_tpu_torch.ops.derandomizer import derandomize
from xritdemod_tpu_torch.utils.bits import pack_bits

__all__ = ["DecoderConfig", "FrameBatch", "CaduDecoder"]

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


class CaduDecoder:
    """Batched CADU decode: sync readout + FEC stack.

    `decode_frames` consumes `(B, 16384)` aligned soft frames plus `(B, 64)`
    carried history tails and returns a `FrameBatch`.
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
        signs = corr_op._hard_signs(frames[:, : corr_op.UW_BITS])
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
        ext = torch.cat([prev_tails, frames], dim=1)          # (B, 16448)

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
            bits, vit_errors = vit_op.viterbi_decode(ext)     # (B, 8224)
        decoded = pack_bits(bits)                             # (B, 1028)
        if not cfg.lrit:
            decoded = nrzm_op.nrzm_decode_bytes(decoded)

        # Shift back 32 bits of history: frame = decoded[4:1028], then strip
        # the 4-byte sync marker.
        h = C.LAST_FRAME_DATA // 2
        frame = decoded[:, h : h + C.FRAME_SIZE]
        sync_word = frame[:, : C.SYNC_WORD_BYTES]
        body = derandomize(frame[:, C.SYNC_WORD_BYTES :])     # (B, 1020)
        corrected, rs_errors = rs_op.rs_decode_frame(body)    # (B,1020),(B,4)
        frame_ok = (rs_errors != -1).any(-1) & sync_ok

        # Header parse (newdecoder.cpp:342-349).
        hdr = corrected[:, :5].to(torch.int32)
        scid = ((hdr[:, 0] & 0x3F) << 2) | ((hdr[:, 1] & 0xC0) >> 6)
        vcid = hdr[:, 1] & 0x3F
        counter = (hdr[:, 2] << 16) | (hdr[:, 3] << 8) | hdr[:, 4]

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
