"""Channel-parallel receive: many IQ streams batched and split over devices.

Counterpart of `xritdemod_tpu/parallel/channels.py`.  The demod chain works
on `(C, T)` blocks, so C independent streams are one batch, and a mesh of
devices holds the channel axis in equal slabs.  Every channel's feedback-loop
state stays with its slab, so this axis needs no collectives at all.

A mesh is a tuple of `torch.device`s, one per slab.  Entries may repeat
(`[torch.device("cuda", 0)] * 4`, or `"cpu"` x 8 in the tests): the
counterpart of the virtual host devices on which the reference's tests and
`dryrun_multichip` build a mesh on one host.  Each slab runs its own
`Demodulator.block_batch` (and `CaduDecoder.decode_multi`) under its device;
results are gathered onto the first entry's device, so callers see the
reference's `(C, ...)` shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from xritdemod_tpu_torch import constants as K
from xritdemod_tpu_torch.models.decoder import CaduDecoder, DecoderConfig, FrameBatch
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.utils.cplx import CF32, from_complex

__all__ = ["ChannelMesh", "ChannelDemodulator", "ChannelReceiver", "make_channel_mesh",
           "on_device"]


@dataclasses.dataclass(frozen=True)
class ChannelMesh:
    """A 1-D mesh: one device per slab of the axis `axis`."""

    devices: tuple
    axis: str = "ch"

    def __len__(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{d} requested but no CUDA device is available")
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_channel_mesh(devices=None, axis: str = "ch") -> ChannelMesh:
    """A mesh over `devices` (default: every visible CUDA device; raises when
    there is none, with no fall-back to the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_channel_mesh: no CUDA device; pass devices explicitly")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("make_channel_mesh: empty device list")
    return ChannelMesh(devices, axis)


def on_device(dev: torch.device):
    """`dev` current for the block (a no-op for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def slabs(x, devices) -> list[CF32]:
    """`(C, T)` CF32 or complex numpy -> one `(C / n, T)` CF32 per entry of
    `devices`, each on its device."""
    n = len(devices)
    C = x.re.shape[0] if isinstance(x, CF32) else np.shape(x)[0]
    if C % n:
        raise ValueError(f"{C} channels do not split evenly over {n} mesh entries")
    c = C // n
    out = []
    for i, dev in enumerate(devices):
        rows = slice(i * c, (i + 1) * c)
        if isinstance(x, CF32):
            out.append(CF32(x.re[rows].to(dev), x.im[rows].to(dev)))
        else:
            out.append(from_complex(np.asarray(x)[rows], dev))
    return out


def gather(parts, dev) -> torch.Tensor:
    """Concatenate per-slab tensors along dim 0 on `dev`."""
    return torch.cat([p.to(dev) for p in parts], dim=0)


def gather_batch(batches, dev) -> FrameBatch:
    """Per-slab FrameBatches -> one, field by field along dim 0 on `dev`."""
    return FrameBatch(*(
        None if xs[0] is None else gather(xs, dev) for xs in zip(*batches)))


def _distinct(devices):
    return list(dict.fromkeys(devices))


class ChannelDemodulator:
    """`(C, T)` block demod over a mesh of channel slabs.

    With `mesh=None` this is one `Demodulator.block_batch` on `device` (still
    batched: the single-card throughput path).  With a mesh, `channels` must
    split evenly over its entries; each entry holds one slab's state and runs
    the slab under its own device.
    """

    def __init__(
        self,
        config: DemodConfig,
        channels: int,
        block_len: int = 1 << 17,
        mesh: ChannelMesh | None = None,
        device="cuda",
    ):
        self.config = config
        self.channels = channels
        self.block_len = block_len
        self.mesh = mesh
        self.devices = (_device(device),) if mesh is None else tuple(mesh.devices)
        if channels % len(self.devices):
            raise ValueError(
                f"{channels} channels do not split evenly over {len(self.devices)} mesh entries"
            )
        self.per_slab = channels // len(self.devices)
        self._demods = {d: Demodulator(config, block_len, device=d)
                        for d in _distinct(self.devices)}
        self.num_slots = self._demods[self.devices[0]].num_slots

    def init_state(self):
        """The state of each slab: a tuple, one per mesh entry (with
        `mesh=None`, the one batch's state)."""
        states = tuple(self._demods[d].init_state_batch(self.per_slab) for d in self.devices)
        return states[0] if self.mesh is None else states

    def process(self, x, state):
        """`(C, T)` CF32 or complex numpy -> (soft `(C, S)`, valid `(C, S)`,
        state), outputs on the first entry's device."""
        states = (state,) if self.mesh is None else state
        outs = []
        for dev, xs, st in zip(self.devices, slabs(x, self.devices), states):
            with on_device(dev):
                outs.append(self._demods[dev].block_batch(xs, st))
        first = self.devices[0]
        soft = gather([o[0] for o in outs], first)
        valid = gather([o[1] for o in outs], first)
        new = tuple(o[2] for o in outs)
        return soft, valid, new[0] if self.mesh is None else new


class ChannelReceiver:
    """Channel-parallel receive: demod `(C, T)` + decode `(C, B*16384)`.

    The decode input is each channel's frame-aligned coded-symbol stream
    (frame alignment is per-channel host state, as in `StreamDecoder`); both
    stages run over the same mesh.  `decode_block` is the counterpart of the
    reference's vmapped one-stream decode: one `CaduDecoder.decode_multi`
    (one FEC stack, one Viterbi launch) per slab.
    """

    def __init__(
        self,
        demod_config: DemodConfig,
        decoder_config: DecoderConfig,
        channels: int,
        block_len: int = 1 << 17,
        mesh: ChannelMesh | None = None,
        device="cuda",
    ):
        self.demod = ChannelDemodulator(demod_config, channels, block_len, mesh=mesh,
                                        device=device)
        self.channels = channels
        self.decoder_config = decoder_config
        self.devices = self.demod.devices
        self._decoders = {d: CaduDecoder(decoder_config, device=d)
                          for d in _distinct(self.devices)}

    def init_demod_state(self):
        return self.demod.init_state()

    def init_tails(self) -> torch.Tensor:
        return torch.zeros((self.channels, K.LAST_FRAME_DATA_BITS), dtype=torch.float32,
                           device=self.devices[0])

    def demod_block(self, x, state):
        return self.demod.process(x, state)

    def decode_block(self, soft, tails):
        """`(C, B*16384)` aligned soft symbols (B = `frames_per_block`) and
        `(C, 64)` tails -> (FrameBatch with `(C, B)`-leading fields, new
        tails `(C, 64)`), on the first entry's device."""
        B = self.decoder_config.frames_per_block
        soft = torch.as_tensor(soft, dtype=torch.float32)
        tails = torch.as_tensor(tails, dtype=torch.float32)
        want = (self.channels, B * K.CODED_FRAME_SIZE)
        if tuple(soft.shape) != want:
            raise ValueError(f"decode_block needs soft of shape {want}, got {tuple(soft.shape)}")
        n = len(self.devices)
        c = self.channels // n
        batches, new = [], []
        for i, dev in enumerate(self.devices):
            rows = slice(i * c, (i + 1) * c)
            frames = soft[rows].to(dev).reshape(c, B, K.CODED_FRAME_SIZE)
            with on_device(dev):
                batch, t = self._decoders[dev].decode_multi(frames, tails[rows].to(dev))
            batches.append(batch)
            new.append(t[:, -1])
        first = self.devices[0]
        return gather_batch(batches, first), gather(new, first)
