"""The fused receive: IQ blocks -> VCDU frames, all state on the device.

Counterpart of `xritdemod_tpu/models/receiver.py` (`step`, the channels-last
`step_cl` and `step_int8`, the float32 or bfloat16 ring).  Per
`(C, T)` IQ block:

  demod chain (front-end kernel + clock kernel)
    -> per-channel symbol ring (ops/ring_cuda.py — append at the fill
       offset, frame-aligned pop at the sync position)
    -> per-channel sync acquisition (ops/acquire_cuda.py — one launch; a
       locked channel reads its flag, an unlocked one correlates its ring)
    -> k frame extractions per block, each decoded by the batched FEC stack
       (Viterbi -> NRZ-M -> derandomize -> RS) with per-channel Viterbi tails

with a small carried state (demod state, ring, fill, lock flags, tails).
Soft symbols never visit the host; the host sees decoded VCDUs and stats.
On the card a step reads nothing back to the host: the acquisition and the
RS decoder (ops/rs_cuda.py) decide on the device, as the reference's jitted
step does with its `lax.cond`s, so a step only queues work.

Lock state machine (per channel) mirrors the reference flywheel: unlocked ->
full-window correlation picks pos; a frame is popped at pos and decoded; its
per-frame sync recheck >= threshold locks the channel (pos=0 thereafter,
frames contiguous); any failed recheck unlocks.  A channel whose ring lacks
a full frame skips the extraction (ok=False) and retries next block.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch.models.decoder import CaduDecoder, DecoderConfig, stack_batches
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator, DemodState
from xritdemod_tpu_torch.ops import correlator as corr_op
from xritdemod_tpu_torch.ops.acquire_cuda import acquire_positions, pack_masks
from xritdemod_tpu_torch.ops.ring_cuda import ring_append, ring_extract
from xritdemod_tpu_torch.runtime import metrics
from xritdemod_tpu_torch.utils.cplx import CF32, dequantize_iq_s8, from_complex

__all__ = ["RxState", "FusedReceiver"]

_CODED = C.CODED_FRAME_SIZE


def _numel(t: torch.Tensor) -> int:
    return t.numel()


def _nonzero(t: torch.Tensor) -> int:
    return int((t != 0).sum())


def _unlocked(locked: torch.Tensor) -> int:
    return int((~locked).sum())


class RxState(NamedTuple):
    demod: DemodState
    ring: torch.Tensor        # (C, L) f32 or bf16 symbol FIFOs
    fill: torch.Tensor        # (C,) int32 symbol counts
    locked: torch.Tensor      # (C,) bool frame lock
    tails: torch.Tensor       # (C, 64) f32 Viterbi history (phase-fixed domain)


class FusedReceiver:
    """Channel-batched IQ -> VCDUs.

    One `step((C, T) IQ, state)` returns `(batch, ok, overflow, state)`
    where `batch` is a FrameBatch with `(C, k)`-leading fields (k frame
    extraction attempts per block), `ok (C, k)` marks attempts that popped
    a real frame, and `overflow (C,)` marks channels that dropped the
    block's symbols on a full ring.  The state's ring is reused from step
    to step (the append writes into it), so a state is consumed by the step
    it is passed to.

    `ring_dtype`: "float32", "bfloat16" (half the ring's bytes; the symbols
    are rounded to bf16 as they enter it, whose 8-bit mantissa still holds
    more than the reference's int8 symbol wire, and widened to float32 as
    they leave it for the decoder) or "auto", float32 on every device of the
    port.  The JAX package's "auto" takes bfloat16 on its TPU (when the
    channels are a multiple of 16): there the ring's bytes weigh; whether
    they weigh on the card is for a measurement to show, so the port keeps
    the exact float32 ring by default.
    """

    def __init__(
        self,
        demod_config: DemodConfig,
        decoder_config: DecoderConfig,
        channels: int,
        block_len: int = 1 << 17,
        ring_len: int | None = None,
        extracts_per_step: int | None = None,
        ring_dtype: str = "auto",
        device="cuda",
    ):
        if ring_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                f"ring_dtype must be 'auto', 'float32' or 'bfloat16', got {ring_dtype!r}")
        self.ring_dtype = torch.bfloat16 if ring_dtype == "bfloat16" else torch.float32
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FusedReceiver(device='cuda') needs a CUDA device")
        self.demod_config = demod_config
        self.decoder_config = decoder_config
        self.channels = channels
        self.block_len = block_len
        self._demod = Demodulator(demod_config, block_len, device=self.device)
        self._dec = CaduDecoder(decoder_config, device=self.device)
        # The words' sign masks, the acquisition kernel's arguments, packed once.
        self._acq_words = pack_masks(corr_op.make_templates(decoder_config.uws))

        S = self._demod.num_slots
        expected = block_len / demod_config.decimation / demod_config.sps
        self.k = extracts_per_step or max(1, math.ceil(expected / _CODED))
        # Ring capacity: worst-case leftover (< pos_max + E) + one block of
        # new symbols + margin; pos_max = one coded frame of acquisition lag.
        L = ring_len or (2 * _CODED + S + 8192)
        L = -(-L // 128) * 128
        if L < 2 * _CODED + S:
            raise ValueError(f"ring_len {L} < {2 * _CODED + S} minimum")
        self.ring_len = L
        self._acq = _CODED + corr_op.UW_BITS - 1
        # What the step's spans carry (`runtime/metrics.py`), made once.
        self._step_attrs = {"C": channels, "T": block_len, "k": self.k}
        self._extract_attrs = [{"i": i} for i in range(self.k)]

    def init_state(self) -> RxState:
        Cn, L, dev = self.channels, self.ring_len, self.device
        return RxState(
            demod=self._demod.init_state_batch(Cn),
            ring=torch.zeros((Cn, L), dtype=self.ring_dtype, device=dev),
            fill=torch.zeros((Cn,), dtype=torch.int32, device=dev),
            locked=torch.zeros((Cn,), dtype=torch.bool, device=dev),
            tails=torch.zeros((Cn, C.LAST_FRAME_DATA_BITS), dtype=torch.float32, device=dev),
        )

    def _acquire(self, ring: torch.Tensor, locked: torch.Tensor) -> torch.Tensor:
        """Each channel's extraction position: 0 for a locked channel; for
        an unlocked one the sync's lag in the ring's first frame of lags, or
        0 with no sync there (the reference flywheel's blind drop of ONE
        frame: a noise argmax would overshoot past an upcoming sync and
        swallow the head of the first real frame)."""
        return acquire_positions(ring, locked, self._acq_words, self._acq,
                                 self.decoder_config.min_correlation_bits)

    def _after_demod(self, demod_out, st: RxState):
        soft, valid, dstate = demod_out
        span, count = metrics.span, metrics.count
        with span("rx.ring.append"):
            # The exact clock's valid mask is a per-channel prefix (slots are
            # emitted in symbol order), so `soft` is already dense: the count
            # is all the append needs.  The block update's mask can have a gap
            # (a chunk cut short at a limit, the next one going on): its
            # symbols are packed to the front first, in order.  (The JAX
            # package appends the count's prefix either way, which then takes
            # a zero for the symbol after the gap.)
            if self.demod_config.clock_block_update:
                order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices
                soft = torch.gather(soft, 1, order)
            n_new = valid.sum(-1).to(torch.int32)
            ring, fill, ovf = ring_append(st.ring, st.fill, soft, n_new)
        locked, tails = st.locked, st.tails

        # k frame extractions, each decoded by one flat decode_frames call.
        # A successful unlocked extraction locks (sync verified) and leaves
        # the stream frame-aligned, so later extractions use pos 0.
        batches, oks = [], []
        for attrs in self._extract_attrs:
            # Acquisition reflects the post-pop ring; only unlocked channels
            # correlate (in steady state every channel is frame-aligned at
            # pos 0 and the launch reads the flags alone).
            with span("rx.acquire", attrs):
                count("acquire.channels", locked, _unlocked)
                pos = self._acquire(ring, locked)
            with span("rx.ring.extract", attrs):
                ring, fill, chunk, ok = ring_extract(ring, fill, pos, _CODED)
            with span("rx.decode", attrs):
                batch, ntails = self._dec.decode_frames(chunk, tails)
            with span("rx.select", attrs):
                tails = torch.where(ok[:, None], ntails, tails)
                locked = torch.where(ok, batch.sync_ok, locked)
                batch = batch._replace(
                    frame_ok=batch.frame_ok & ok, sync_ok=batch.sync_ok & ok
                )
            count("decode.rows", ok, _numel)
            count("decode.delivered", batch.frame_ok)
            count("rs.codewords", batch.rs_errors, _numel)
            count("rs.errored", batch.rs_errors, _nonzero)
            batches.append(batch)
            oks.append(ok)
        with span("rx.merge"):
            stacked = stack_batches(batches, dim=1)
            ok = torch.stack(oks, dim=1)                       # (C, k)
        return stacked, ok, ovf, RxState(dstate, ring, fill, locked, tails)

    @torch.no_grad()
    def step(self, x, state: RxState):
        """`(C, T)` IQ block (CF32 or complex numpy) -> (FrameBatch with
        `(C, k)` fields, ok `(C, k)`, overflow `(C,)`, next state)."""
        with metrics.span("rx.step", self._step_attrs):
            with metrics.span("rx.ingest"):
                if not isinstance(x, CF32):
                    x = from_complex(x, self.device)
            with metrics.span("rx.demod"):
                out = self._demod.block_batch(x, state.demod)
            return self._after_demod(out, state)

    @torch.no_grad()
    def step_cl(self, xT, state: RxState):
        """Channels-last variant: a `(T, C)` IQ block (time-major, the natural
        order of an interleaved multichannel source) -> the results of `step`
        on its transpose, bit for bit, without the device-side input
        transpose (`Demodulator.block_batch_cl`)."""
        with metrics.span("rx.step", self._step_attrs):
            with metrics.span("rx.ingest"):
                if not isinstance(xT, CF32):
                    xT = from_complex(xT, self.device)
            with metrics.span("rx.demod"):
                out = self._demod.block_batch_cl(xT, state.demod)
            return self._after_demod(out, state)

    @torch.no_grad()
    def step_int8(self, q, state: RxState):
        """Quantized-wire variant: `(C, 2T)` interleaved int8 I/Q block
        (`utils.cplx.quantize_iq_s8` layout) — same contract as `step`, a
        quarter of the host->device bytes, dequantized on the device."""
        with metrics.span("rx.step", self._step_attrs):
            with metrics.span("rx.ingest"):
                x = dequantize_iq_s8(torch.as_tensor(q, device=self.device))
            with metrics.span("rx.demod"):
                out = self._demod.block_batch(x, state.demod)
            return self._after_demod(out, state)
