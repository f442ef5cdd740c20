"""Carry receiver state between the JAX package and this port.

The system has no trained weights: its taps and tables are derived from the
configuration in both packages, and what a running receiver owns is its
carried state.  These functions turn the JAX package's `DemodState` (channel-
batched, or the serial path's unbatched one), `RxState`, decoder tails and a
`StreamDecoder`'s host state — given as **numpy arrays** in the same nesting
(NamedTuples, plain tuples in field order, or dicts keyed by field name; the
caller does the `np.asarray`) — into the port's state on a device, and back;
and a `DecoderConfig`'s or `DemodConfig`'s fields into the port's.  Nothing
here imports JAX.

A bfloat16 ring crosses as bfloat16: the JAX package hands it as an
`ml_dtypes.bfloat16` array (or, through numpy without that package, as its
2-byte pattern, dtype `V2`), whose bits become a `torch.bfloat16` tensor; and
`to_numpy` gives a bfloat16 tensor back as `ml_dtypes.bfloat16` (`V2` where
`ml_dtypes` is not installed).

Field order (both packages):
  DemodState  (dec_hist, agc_gain, rrc_hist, costas, clock)
  CostasState (phase, freq)
  ClockRecoveryState (mu, omega, ii, p, c, tail)
  RxState     (demod, ring, fill, locked, tails)
  CF32        (re, im)
  StreamDecoder host state: a dict with `tail` (64,), `locked`, `verified`,
    `pos`, `buffer` (the symbols not yet decoded: the realign buffer followed
    by the pending chunks) and `stats` (frames, dropped, resyncs)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from xritdemod_tpu_torch.models.decoder import DecoderConfig, StreamDecoder
from xritdemod_tpu_torch.models.demodulator import DemodConfig, DemodState
from xritdemod_tpu_torch.models.receiver import RxState
from xritdemod_tpu_torch.ops.clock_recovery import ClockRecoveryState
from xritdemod_tpu_torch.ops.costas import CostasState
from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = [
    "decoder_config_from",
    "demod_config_from",
    "demod_state_from_numpy",
    "rx_state_from_numpy",
    "stream_decoder_from_numpy",
    "tails_from_numpy",
    "to_numpy",
]


def _field(obj, name: str, index: int):
    if isinstance(obj, dict):
        return obj[name]
    if hasattr(obj, name):
        return getattr(obj, name)
    return obj[index]


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dtype).to(device)


def _f32(a, device):
    return _tensor(a, torch.float32, device)


def _cf32(obj, device) -> CF32:
    return CF32(_f32(_field(obj, "re", 0), device), _f32(_field(obj, "im", 1), device))


def demod_state_from_numpy(state, device="cuda") -> DemodState:
    """`DemodState` (numpy leaves) -> the port's, on `device`, with the same
    shapes: `(C,)`-leading for `block_batch`, unbatched for `process`."""
    costas = _field(state, "costas", 3)
    clock = _field(state, "clock", 4)
    return DemodState(
        dec_hist=_cf32(_field(state, "dec_hist", 0), device),
        agc_gain=_f32(_field(state, "agc_gain", 1), device),
        rrc_hist=_cf32(_field(state, "rrc_hist", 2), device),
        costas=CostasState(
            phase=_f32(_field(costas, "phase", 0), device),
            freq=_f32(_field(costas, "freq", 1), device),
        ),
        clock=ClockRecoveryState(
            mu=_f32(_field(clock, "mu", 0), device),
            omega=_f32(_field(clock, "omega", 1), device),
            ii=_tensor(_field(clock, "ii", 2), torch.int32, device),
            p=_cf32(_field(clock, "p", 3), device),
            c=_cf32(_field(clock, "c", 4), device),
            tail=_cf32(_field(clock, "tail", 5), device),
        ),
    )


def decoder_config_from(config) -> DecoderConfig:
    """The port's `DecoderConfig` with the fields of `config` (the JAX
    package's `DecoderConfig`, or a dict keyed by field name) that it shares,
    `forensics` among them."""
    get = (lambda n: config[n]) if isinstance(config, dict) else (lambda n: getattr(config, n))
    return DecoderConfig(**{f.name: get(f.name) for f in dataclasses.fields(DecoderConfig)})


def demod_config_from(config) -> DemodConfig:
    """The port's `DemodConfig` with the fields of `config` (the JAX
    package's `DemodConfig`, or a dict keyed by field name) that it shares:
    the operating point, `clock_interp`, `frontend_kernel`, and the forms
    `clock_block_update`, `frontend_block_update` and `frontend_precision`.
    The JAX package's TPU tuning fields have no counterpart and are left."""
    get = (lambda n: config[n]) if isinstance(config, dict) else (lambda n: getattr(config, n))
    return DemodConfig(**{f.name: get(f.name) for f in dataclasses.fields(DemodConfig)})


def tails_from_numpy(tails, device="cuda") -> torch.Tensor:
    """Decoder Viterbi history tails `(B, 64)` (or `(64,)`) -> float32 tensor."""
    return _f32(tails, device)


def bf16_bits(a) -> bool:
    """Whether numpy array `a` holds bfloat16 values (`ml_dtypes.bfloat16`,
    or their bare 2-byte pattern `V2`)."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2)


def ring_from_numpy(ring, device="cuda") -> torch.Tensor:
    """A ring `(C, L)`: bfloat16 (see the module docstring) stays bfloat16,
    its bits reinterpreted; any other float type becomes float32."""
    ring = np.asarray(ring)
    if bf16_bits(ring):
        bits = torch.from_numpy(np.ascontiguousarray(ring).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return _f32(np.asarray(ring, np.float32), device)


def rx_state_from_numpy(state, device="cuda") -> RxState:
    """`RxState` (numpy leaves; the ring bfloat16 or any float type) -> the
    port's."""
    return RxState(
        demod=demod_state_from_numpy(_field(state, "demod", 0), device),
        ring=ring_from_numpy(_field(state, "ring", 1), device),
        fill=_tensor(_field(state, "fill", 2), torch.int32, device),
        locked=_tensor(_field(state, "locked", 3), torch.bool, device),
        tails=tails_from_numpy(_field(state, "tails", 4), device),
    )


def stream_decoder_from_numpy(state: dict, config: DecoderConfig, device="cuda") -> StreamDecoder:
    """A `StreamDecoder` that carries on where another left off: `state` is
    the host state listed in the module docstring (numpy and plain Python
    values), taken between two `push` calls."""
    sd = StreamDecoder(config, device=device)
    sd._tail = tails_from_numpy(state["tail"], sd.decoder.device)
    sd._locked = bool(state["locked"])
    sd._verified = bool(state["verified"])
    sd._pos = int(state["pos"])
    sd._buf = np.array(state["buffer"], np.float32)
    frames, dropped, resyncs = (int(v) for v in state["stats"])
    sd.stats.frames, sd.stats.dropped, sd.stats.resyncs = frames, dropped, resyncs
    return sd


def to_numpy(state):
    """Any of the port's states (or a tensor) -> the same nesting as plain
    tuples of numpy arrays, in field order — what the JAX package's
    NamedTuples can be rebuilt from positionally (a field that is None, as a
    `FrameBatch`'s forensics fields without `forensics`, stays None).

    The copies from a CUDA device are all queued first and waited for once,
    so a whole `FrameBatch` costs one synchronisation, not one a field."""
    streams = set()

    def start(s):
        if s is None:
            return None
        if isinstance(s, torch.Tensor):
            if s.is_cuda:
                streams.add(torch.cuda.current_stream(s.device))
                return s.detach().to("cpu", non_blocking=True)
            return s.detach()
        if isinstance(s, (tuple, list)):
            return tuple(start(x) for x in s)
        raise TypeError(f"cannot convert {type(s).__name__}")

    def finish(s):
        if s is None:
            return None
        if isinstance(s, torch.Tensor):
            if s.dtype == torch.bfloat16:
                return _bf16_numpy(s)
            return s.numpy()
        return tuple(finish(x) for x in s)

    host = start(state)
    for stream in streams:
        stream.synchronize()
    return finish(host)


def _bf16_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU bfloat16 tensor -> numpy `ml_dtypes.bfloat16` (its bits as `V2`
    without `ml_dtypes`)."""
    bits = t.contiguous().view(torch.int16).numpy()
    try:
        import ml_dtypes
    except ImportError:
        return bits.view("V2")
    return bits.view(ml_dtypes.bfloat16)
