"""The BPSK demodulation chain as a block-functional step, channel-batched.

Counterpart of `xritdemod_tpu/models/demodulator.py`: the batch path
`block_batch` and its channels-last entry `block_batch_cl`, the single-stream
path `init_state` / `process` and the SNR tap `snr_estimate`, with either
clock interpolator and the block-update and bf16 forms.  One
function consumes a fixed-size `(C, T)` (or, serially, `(T,)`) complex block
plus a small carried state and returns soft symbols plus the next state.

Chain: [decimating low-pass FIR] -> AGC -> RRC FIR -> Costas loop -> M&M
clock recovery -> Re{.} soft symbols.  On the GPU the middle three stages
are the fused front-end kernel (`ops/frontend_cuda.py`) or, with
`frontend_kernel="split"` and always on the serial path, the standalone AGC
and Costas kernels (`ops/stream_cuda.py`) around the RRC convolution
(`ops/fir.py`); the clock is `ops/clock_cuda.py`, its mmse or sinc instance
as `clock_interp` says.  A CPU state/block takes their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch.ops import agc as agc_op
from xritdemod_tpu_torch.ops import clock_recovery as cr_op
from xritdemod_tpu_torch.ops import costas as costas_op
from xritdemod_tpu_torch.ops import filters, fir
from xritdemod_tpu_torch.ops.snr import snr_estimate_db
from xritdemod_tpu_torch.ops.clock_cuda import (
    clock_recovery_block_kernel_batch,
    clock_recovery_block_kernel_batch_cl,
)
from xritdemod_tpu_torch.ops.frontend_cuda import demod_frontend
from xritdemod_tpu_torch.ops.stream_cuda import agc_block_kernel, costas_block_kernel
from xritdemod_tpu_torch.runtime import metrics
from xritdemod_tpu_torch.utils.cplx import CF32, from_complex, map_tree

__all__ = ["DemodConfig", "DemodState", "Demodulator", "quantize_symbols", "slot_budget"]

# The default of `DemodConfig.clock_max_block` (0): past 2^17 post-decimation
# samples the reference's TPU clock runs a block as equal segments and
# budgets output slots per segment.
CLOCK_MAX_BLOCK = 1 << 17


def _segment_count(td: int, cap: int = 0) -> int:
    """The reference's clock segments of a `td`-sample block: the smallest
    number of equal segments that fit under `cap` (0: CLOCK_MAX_BLOCK)."""
    cap = cap or CLOCK_MAX_BLOCK
    if td <= cap:
        return 1
    segs = -(-td // cap)
    while td % segs:
        segs += 1
    return segs


def slot_budget(td: int, params: cr_op.ClockRecoveryParams, cap: int = 0) -> int:
    """Output slots of a block of `td` post-decimation samples: the
    reference's `num_slots` (`xritdemod_tpu/models/demodulator.py`), so that
    outputs and `valid` masks have its shapes.  Past `cap` (the config's
    `clock_max_block`; 0: CLOCK_MAX_BLOCK) the block counts as the smallest
    number of equal segments that fit under it, each with its own budget;
    the port still runs one clock launch a block (whose block update
    restarts its chunks at each segment, as the reference's segmented
    launches do)."""
    segs = _segment_count(td, cap)
    return segs * cr_op.max_symbols(td // segs, params)


@dataclasses.dataclass(frozen=True)
class DemodConfig:
    """Demodulator operating point (mirrors xritdemod.cfg keys).

    The fields and defaults are those of the JAX package's `DemodConfig`
    minus its device tuning knobs (tile sizes, superchunks, per-stage XLA or
    Pallas selectors), which choose between TPU forms of one function and
    have no meaning here.  The block updates and the bf16 filter are kept:
    each computes a different function, which a user may select.
    """

    symbol_rate: int = C.LRIT_SYMBOL_RATE
    sample_rate: int = 1_250_000
    decimation: int = 1
    rrc_alpha: float = C.LRIT_RRC_ALPHA
    pll_alpha: float = C.CLOCK_ALPHA       # the reference's shipped default
    rrc_taps: int = C.RRC_TAPS
    agc_rate: float = C.AGC_RATE
    agc_reference: float = C.AGC_REFERENCE
    agc_gain: float = C.AGC_GAIN
    agc_max_gain: float = C.AGC_MAX_GAIN
    clock_alpha: float = C.CLOCK_ALPHA
    clock_mu: float = C.CLOCK_MU
    clock_omega_limit: float = C.CLOCK_OMEGA_LIMIT
    # Fractional interpolator of the M&M clock: the tabulated 8-tap MMSE
    # interpolator ("mmse", the shared default) or windowed-sinc taps at the
    # exact mu ("sinc").
    clock_interp: str = "mmse"
    # Front end of the batch path: "fused" runs AGC + RRC + Costas as the one
    # channels-last front-end kernel; "split" runs them as three `(C, T)`
    # stages (AGC kernel -> RRC convolution -> Costas kernel) feeding the
    # `(C, T)` clock entry, same math.  "auto" is the fused kernel, which has
    # no shape prerequisite here.
    frontend_kernel: str = "auto"
    # The block-update clock on the batch paths: 0 is the exact per-symbol
    # recursion; K > 0 freezes the clock for each chunk of K symbol slots
    # (ops/clock_recovery.clock_recovery_block_update_batch): symbols move
    # by sub-1 % timing jitter, post-FEC frames stay bit-exact.
    clock_block_update: int = 0
    # K-row slabs for the AGC and Costas loops of the batch paths: 0 is the
    # exact per-sample recursions; K > 0 runs the fused front end's AGC as an
    # affine prefix over K-row slabs and the Costas loop as the frozen-ramp
    # slab update (on the split path the Costas loop only, as the JAX
    # package's CPU split path does); -1 is auto.  The block length (after
    # decimation) must be a multiple of K, and on the card the fused front
    # end's K must divide 48 or 64 (`ops/frontend_cuda.tile_rows`).
    frontend_block_update: int = -1
    # The fused front end's matched filter: "highest" (float32) or "bf16"
    # (each AGC output and tap rounded to bfloat16, products and sums in
    # float32); "default" computes as "highest", as XLA on a CPU computes the
    # JAX package's "default"; "auto" is "highest".
    #
    # The JAX package resolves frontend_block_update=-1 to K = 8 and "auto"
    # to bf16 on its fused TPU path (faster there at the same post-FEC
    # frames), and to the exact float32 forms elsewhere.  The port resolves
    # both to the exact float32 forms on every device, the card included,
    # until a measurement of the forms on the card decides otherwise.
    frontend_precision: str = "auto"
    # Largest block (post-decimation samples) the clock counts as one
    # segment; 0 is 2^17.  A longer block is cut into the smallest number of
    # equal segments that fit under it: `num_slots` is budgeted per segment
    # (the outputs' and `valid`'s shapes), and the block-update clock
    # restarts its chunk grid at each segment's start, as the reference's
    # chained segments do.  The exact clock's symbols do not depend on it.
    clock_max_block: int = 0

    @classmethod
    def lrit(cls, sample_rate: int = 1_250_000, decimation: int = 1, **kw) -> "DemodConfig":
        return cls(
            symbol_rate=C.LRIT_SYMBOL_RATE,
            rrc_alpha=C.LRIT_RRC_ALPHA,
            sample_rate=sample_rate,
            decimation=decimation,
            **kw,
        )

    @classmethod
    def hrit(cls, sample_rate: int = 3_000_000, decimation: int = 1, **kw) -> "DemodConfig":
        return cls(
            symbol_rate=C.HRIT_SYMBOL_RATE,
            rrc_alpha=C.HRIT_RRC_ALPHA,
            sample_rate=sample_rate,
            decimation=decimation,
            **kw,
        )

    @property
    def circuit_sample_rate(self) -> float:
        return self.sample_rate / self.decimation

    @property
    def sps(self) -> float:
        return self.circuit_sample_rate / self.symbol_rate


class DemodState(NamedTuple):
    dec_hist: CF32
    agc_gain: torch.Tensor
    rrc_hist: CF32
    costas: costas_op.CostasState
    clock: cr_op.ClockRecoveryState


class Demodulator:
    """Builds taps/params for a config and exposes the batched block step.

    `block_len` is the number of complex input samples consumed per step
    (must be a multiple of `decimation`).
    """

    def __init__(self, config: DemodConfig, block_len: int = 1 << 17, device="cuda"):
        if block_len % config.decimation:
            raise ValueError("block_len must be a multiple of decimation")
        if config.clock_interp not in cr_op.INTERPS:
            raise ValueError(
                f"clock_interp must be 'sinc' or 'mmse', got {config.clock_interp!r}"
            )
        if config.frontend_kernel not in ("auto", "fused", "split"):
            raise ValueError(
                "frontend_kernel must be 'auto', 'fused' or 'split', "
                f"got {config.frontend_kernel!r}"
            )
        if config.frontend_precision not in ("auto", "highest", "default", "bf16"):
            raise ValueError(
                "frontend_precision must be 'auto', 'highest', 'default' or 'bf16', "
                f"got {config.frontend_precision!r}"
            )
        if config.clock_block_update < 0:
            raise ValueError(
                f"clock_block_update must be >= 0, got {config.clock_block_update}")
        if config.clock_max_block < 0:
            raise ValueError(f"clock_max_block must be >= 0, got {config.clock_max_block}")
        if config.frontend_block_update < -1:
            raise ValueError(
                f"frontend_block_update must be >= 0 (or -1, auto), "
                f"got {config.frontend_block_update}")
        # The forms the batch path runs (see DemodConfig).
        self.block_k = max(config.frontend_block_update, 0)
        self.precision = "bf16" if config.frontend_precision == "bf16" else "highest"
        td = block_len // config.decimation
        if self.block_k and td % self.block_k:
            raise ValueError(
                f"block length {td} (after decimation) not a multiple of "
                f"frontend_block_update {self.block_k}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Demodulator(device='cuda') needs a CUDA device")
        self.config = config
        self.block_len = block_len

        # Tap design exactly as the reference (demodulator.cpp:443-444).
        t = lambda a: torch.from_numpy(a).to(self.device)
        self._rrc_taps = t(
            filters.rrc_taps(
                1.0, config.circuit_sample_rate, config.symbol_rate,
                config.rrc_alpha, config.rrc_taps,
            )
        )
        if config.decimation > 1:
            self._dec_taps = t(
                filters.lowpass_taps(
                    1.0, config.sample_rate, config.circuit_sample_rate / 2.0, 100e3
                )
            )
        else:
            self._dec_taps = torch.ones((1,), dtype=torch.float32, device=self.device)

        self._agc = agc_op.AgcParams(
            rate=config.agc_rate,
            reference=config.agc_reference,
            gain=config.agc_gain,
            max_gain=config.agc_max_gain,
        )
        self._costas = costas_op.costas_gains(config.pll_alpha)
        self._clock = cr_op.ClockRecoveryParams(
            omega=config.sps,
            gain_omega=config.clock_alpha * config.clock_alpha / 4.0,
            gain_mu=config.clock_alpha,
            omega_relative_limit=config.clock_omega_limit,
        )
        self.num_slots = slot_budget(td, self._clock, config.clock_max_block)
        self.clock_segments = _segment_count(td, config.clock_max_block)
        self._hpf_taps = t(
            filters.highpass_taps(
                1.0, config.circuit_sample_rate, float(config.symbol_rate), 300e3
            )
        )

    # -- state ------------------------------------------------------------
    def init_state(self) -> DemodState:
        """The serial path's state: the reference's unbatched shapes (scalar
        gain, mu, omega, ii, phase and freq; `(N-1,)` histories; `(3,)` clock
        histories; `(NTAIL,)` tail)."""
        return _map_state(lambda a: a[0], self.init_state_batch(1))

    def init_state_batch(self, channels: int) -> DemodState:
        dev = self.device
        return DemodState(
            dec_hist=fir.fir_init(int(self._dec_taps.shape[0]), (channels,), dev),
            agc_gain=agc_op.agc_init(self._agc, (channels,), dev),
            rrc_hist=fir.fir_init(int(self._rrc_taps.shape[0]), (channels,), dev),
            costas=costas_op.costas_init((channels,), dev),
            clock=cr_op.clock_recovery_init(
                self._clock, self.config.clock_mu, channels, dev
            ),
        )

    # -- the batched step ---------------------------------------------------
    @torch.no_grad()
    def block_batch(self, x, state: DemodState):
        """`(C, T)` block (CF32 or complex numpy) with `(C,)`-leading state
        -> (soft `(C, num_slots)`, valid `(C, num_slots)`, next state)."""
        cfg = self.config
        fused = cfg.frontend_kernel != "split"
        with metrics.span("rx.demod.layout"):
            if not isinstance(x, CF32):
                x = from_complex(x, self.device)
            x, dec_hist = self._decimate(x, state, "block_batch")
            if fused:
                # Channels-last from here on: the layout of both kernels.
                x = _transpose(x)
        if fused:
            return self._fused_cl(x, dec_hist, state)
        syms, valid, agc_gain, rrc_hist, costas_state, clock_state = self._split(x, state)
        soft = syms.re   # the reference takes Re{.}
        return soft, valid, DemodState(dec_hist, agc_gain, rrc_hist, costas_state, clock_state)

    @torch.no_grad()
    def block_batch_cl(self, xT, state: DemodState):
        """Channels-last ingest: a `(T, C)` block (CF32 or complex numpy,
        time-major, the natural order of an interleaved multichannel source)
        -> the results of `block_batch` on its transpose, bit for bit, without
        the `(C, T) -> (T, C)` transpose in front of the fused front end.
        The split front end and the decimating FIR work on `(C, T)`, so with
        either the block is transposed once here, as the reference does."""
        with metrics.span("rx.demod.layout"):
            if not isinstance(xT, CF32):
                xT = from_complex(xT, self.device)
            channels_first = self.config.frontend_kernel == "split" or self.config.decimation > 1
            if channels_first:
                x = _transpose(xT)
            elif xT.re.shape[0] != self.block_len:
                raise ValueError(
                    f"block_batch_cl got {xT.re.shape[0]} samples; this Demodulator "
                    f"was built for block_len={self.block_len}"
                )
            else:
                xT = CF32(xT.re.contiguous(), xT.im.contiguous())
        if channels_first:
            return self.block_batch(x, state)
        return self._fused_cl(xT, state.dec_hist, state)

    def _fused_cl(self, xT: CF32, dec_hist: CF32, state: DemodState):
        """The fused front end and the `(T, C)` clock on a decimated
        channels-last block."""
        with metrics.span("rx.demod.frontend"):
            yT, agc_gain, rrc_hist, costas_state = demod_frontend(
                xT, state.agc_gain, state.rrc_hist, state.costas,
                self._agc, self._rrc_taps, self._costas,
                block_k=self.block_k, precision=self.precision,
            )
        with metrics.span("rx.demod.clock"):
            syms, valid, clock_state = clock_recovery_block_kernel_batch_cl(
                yT, state.clock, self._clock, self.num_slots, self.config.clock_interp,
                self.config.clock_block_update, self.clock_segments,
            )
        return syms.re, valid, DemodState(dec_hist, agc_gain, rrc_hist, costas_state, clock_state)

    def _decimate(self, x: CF32, state: DemodState, what: str):
        """The decimating FIR (when there is one) and the block length check."""
        cfg = self.config
        if cfg.decimation > 1:
            x, dec_hist = fir.fir_block(x, self._dec_taps, state.dec_hist, cfg.decimation)
        else:
            dec_hist = state.dec_hist
        expect = self.block_len // cfg.decimation
        if x.re.shape[-1] != expect:
            raise ValueError(
                f"{what} got {x.re.shape[-1]} post-decimation samples; this "
                f"Demodulator was built for block_len={self.block_len} (-> {expect})"
            )
        return x, dec_hist

    def _split(self, x: CF32, state: DemodState, exact: bool = False):
        """The split front end and the `(C, T)` clock on a decimated block.

        The batch path runs the forms the config names: the slab Costas loop
        with `frontend_block_update` K > 0, as the JAX package's CPU split
        path does (its TPU split path keeps the exact Pallas Costas kernel
        whatever K says; the port computes the one function the config
        names on every device), the exact AGC (the split path's AGC has no
        slab form here), and the block-update clock with
        `clock_block_update`.  `exact` (the serial path) keeps the exact
        forms, as the reference's `_block` does."""
        cfg = self.config
        fe_k = 0 if exact else self.block_k
        ck_k = 0 if exact else cfg.clock_block_update
        with metrics.span("rx.demod.frontend"):
            x, agc_gain = agc_block_kernel(x, state.agc_gain, self._agc)
            x, rrc_hist = fir.fir_block(x, self._rrc_taps, state.rrc_hist)
            x, costas_state = costas_block_kernel(x, state.costas, self._costas, fe_k)
        with metrics.span("rx.demod.clock"):
            syms, valid, clock_state = clock_recovery_block_kernel_batch(
                x, state.clock, self._clock, self.num_slots, cfg.clock_interp,
                ck_k, self.clock_segments,
            )
        return syms, valid, agc_gain, rrc_hist, costas_state, clock_state

    # -- the serial path ------------------------------------------------------
    @torch.no_grad()
    def process(self, x, state: DemodState):
        """One block of one stream: `(T,)` (CF32 or complex numpy) with the
        state of `init_state` -> (soft `(num_slots,)`, valid `(num_slots,)`,
        next state).

        The split path's stages on one channel: decimating FIR, the
        standalone AGC (K5), the RRC convolution, the standalone Costas loop
        (K6) and the `(C, T)` clock entry (K2, the instance of
        `clock_interp`), in their exact forms whatever the block updates of
        the config (as the reference's `_block`).  Its AGC is the exact per-sample recursion, as
        everywhere in this port, where the reference's `_block` runs the
        associative-scan AGC: the two agree to ~1e-6 relative, and the soft
        symbols to a few 1e-6 (`tests/test_torch_serial.py` holds them at
        5e-4; the KAT holds both against the scalar chain at 2e-3)."""
        if not isinstance(x, CF32):
            x = from_complex(x, self.device)
        x = CF32(x.re[None, :], x.im[None, :])
        batched = _map_state(lambda a: a[None], state)
        x, dec_hist = self._decimate(x, batched, "process")
        syms, valid, agc_gain, rrc_hist, costas_state, clock_state = self._split(
            x, batched, exact=True)
        new = DemodState(dec_hist, agc_gain, rrc_hist, costas_state, clock_state)
        return syms.re[0], valid[0], _map_state(lambda a: a[0], new)

    @torch.no_grad()
    def snr_estimate(self, x, state: DemodState) -> torch.Tensor:
        """RMS-ratio SNR estimate in dB of a raw `(..., T)` input block
        (`ops/snr.py`): decimated with the carried history and put through
        the AGC from the carried gain (the standalone AGC on the card), as a
        tap beside the chain; `state` is not advanced."""
        if not isinstance(x, CF32):
            x = from_complex(x, self.device)
        if self.config.decimation > 1:
            x, _ = fir.fir_block(x, self._dec_taps, state.dec_hist, self.config.decimation)
        lead, T = x.re.shape[:-1], x.re.shape[-1]
        flat = CF32(x.re.reshape(-1, T), x.im.reshape(-1, T))
        y, _ = agc_block_kernel(flat, state.agc_gain.reshape(-1), self._agc)
        y = CF32(y.re.reshape(lead + (T,)), y.im.reshape(lead + (T,)))
        return snr_estimate_db(y, self._rrc_taps, self._hpf_taps)


def _transpose(x: CF32) -> CF32:
    """`(A, B)` -> contiguous `(B, A)`."""
    return CF32(x.re.t().contiguous(), x.im.t().contiguous())


_map_state = map_tree   # `fn` applied to every tensor of a (nested) state


def quantize_symbols(soft: torch.Tensor) -> torch.Tensor:
    """float soft symbols -> int8 wire format: clip(soft*127, -128, 127),
    then a truncating cast."""
    q = torch.clamp(soft * C.SYMBOL_SCALE, -128.0, 127.0)
    return q.to(torch.int8)
