"""Multi-process receive: a `torch.distributed` process group over a
`(hosts, local devices)` mesh.

Counterpart of `xritdemod_tpu/parallel/distributed.py`, with the same model:
one process per host drives its local devices (this is not
`torch.distributed.device_mesh`, which assumes one rank per device; a
collective-free channel axis gains nothing from SPMD tensors).

- **Channel parallelism** needs no collectives: each process feeds and reads
  only its own channels, on its local entries of the mesh.  Cross-process
  traffic: none.
- **Time-block parallelism** splits one capture over every entry of every
  process, host-major; the halo of each process's first block is its left
  neighbour's last tail, sent point to point (`isend`/`irecv`).
- **The fused receive** runs one `FusedReceiver` slab per local entry.

`backend` is explicit: `"nccl"` when every rank owns its own card, `"gloo"`
otherwise (CPU ranks, or ranks sharing one card: NCCL refuses two ranks on
one GPU).  With gloo a halo crosses as a CPU tensor and is moved back to
the device.  A single process works without a group: `initialize()` returns
False and `make_host_mesh()` gives a `(1, n_local)` mesh.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig, _map_state
from xritdemod_tpu_torch.parallel.channels import (
    ChannelDemodulator, ChannelMesh, ChannelReceiver, gather, gather_batch, make_channel_mesh,
    on_device, slabs,
)
from xritdemod_tpu_torch.parallel.timeblocks import TimeBlockDemodulator
from xritdemod_tpu_torch.utils.cplx import CF32, from_complex

__all__ = [
    "initialize",
    "HostMesh",
    "make_host_mesh",
    "DistributedChannelReceiver",
    "DistributedTimeBlockDemodulator",
    "DistributedFusedReceiver",
]

BACKENDS = ("nccl", "gloo")

# The cards named by `initialize(local_device_ids=...)`, None until then.
_local_device_ids: list | None = None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    backend: str | None = None,
    init_method: str | None = None,
) -> bool:
    """Join a `torch.distributed` process group.

    Arguments left None are read from torchrun's `MASTER_ADDR` /
    `MASTER_PORT`, `WORLD_SIZE` and `RANK`.  `init_method` (for example
    `file:///path`, a store without ports) replaces the coordinator's
    `tcp://host:port`.  Without either this is a no-op that returns False.
    `local_device_ids` name the CUDA cards this process uses (ids that do
    not exist are refused): when a group starts, the first becomes the
    current device, and `make_host_mesh` takes them as its default entries.
    Returns True when a group of more than one process is active.
    """
    global _local_device_ids
    if local_device_ids is not None:
        ids = [int(i) for i in local_device_ids]
        count = torch.cuda.device_count()
        if not ids or any(not 0 <= i < count for i in ids):
            raise ValueError(f"local_device_ids {ids} name no card of the {count} visible")
        _local_device_ids = ids
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if init_method is None:
        if coordinator_address is None:
            return False
        init_method = f"tcp://{coordinator_address}"
    if backend not in BACKENDS:
        raise ValueError(
            f"backend must be 'nccl' (one rank per card) or 'gloo' (CPU ranks, or ranks "
            f"sharing a card), got {backend!r}"
        )
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs num_processes and process_id (or WORLD_SIZE, RANK)")
    if local_device_ids is not None:
        torch.cuda.set_device(_local_device_ids[0])
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return dist.get_world_size() > 1


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """Row h holds process h's local devices; `rank` is this process's row."""

    devices: tuple
    axes: tuple = ("host", "chip")
    rank: int = 0

    @property
    def shape(self) -> dict:
        return {self.axes[0]: len(self.devices), self.axes[1]: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def local(self) -> ChannelMesh:
        return ChannelMesh(self.devices[self.rank], self.axes[1])


def make_host_mesh(devices=None, axes: tuple = ("host", "chip")) -> HostMesh:
    """`(hosts, local devices)` mesh over every process of the group.

    `devices` are this process's entries (default: the cards `initialize`
    was given, else every visible CUDA device; entries may repeat).  Every
    process must bring as many.
    """
    if devices is None and _local_device_ids is not None:
        devices = [torch.device("cuda", i) for i in _local_device_ids]
    local = make_channel_mesh(devices).devices
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return HostMesh((local,), tuple(axes), 0)
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, [str(d) for d in local])
    if any(len(r) != len(local) for r in rows):
        total = sum(len(r) for r in rows)
        raise ValueError(f"{total} devices do not split evenly over {len(rows)} processes")
    grid = tuple(tuple(torch.device(d) for d in r) for r in rows)
    return HostMesh(grid, tuple(axes), dist.get_rank())


class DistributedChannelReceiver:
    """Channel-parallel demod + CADU decode over a `(hosts, chips)` mesh.

    Every process feeds `channels_per_device * n_local` channels of
    `(C_local, T)` IQ and reads back only those channels' soft symbols and
    frames: a `ChannelReceiver` over its local entries, the same arithmetic
    as the single-process one.
    """

    def __init__(
        self,
        demod_config: DemodConfig,
        decoder_config: DecoderConfig | None = None,
        channels_per_device: int = 1,
        block_len: int = 1 << 17,
        mesh: HostMesh | None = None,
    ):
        self.mesh = mesh if mesh is not None else make_host_mesh()
        self.n_hosts, self.n_local = len(self.mesh.devices), len(self.mesh.devices[0])
        self.channels = channels_per_device * self.mesh.size
        self.channels_local = channels_per_device * self.n_local
        self.block_len = block_len
        local = self.mesh.local
        self._rx = None
        if decoder_config is not None:
            self._rx = ChannelReceiver(demod_config, decoder_config, self.channels_local,
                                       block_len, mesh=local)
            self._demod = self._rx.demod
        else:
            self._demod = ChannelDemodulator(demod_config, self.channels_local, block_len,
                                             mesh=local)
        self.num_slots = self._demod.num_slots

    def init_demod_state(self):
        return self._demod.init_state()

    def demod_block(self, x_local, state):
        """`(C_local, T)` CF32 or complex numpy IQ of THIS process -> local
        `(C_local, slots)` (soft, valid) and the state."""
        return self._demod.process(x_local, state)

    def init_tails(self):
        return self._require_decoder().init_tails()

    def decode_block(self, soft_local, tails):
        """`(C_local, B*16384)` aligned soft symbols of THIS process -> (local
        FrameBatch with `(C_local, B)` fields, new tails)."""
        return self._require_decoder().decode_block(soft_local, tails)

    def _require_decoder(self) -> ChannelReceiver:
        if self._rx is None:
            raise ValueError("constructed without a decoder_config")
        return self._rx


class DistributedTimeBlockDemodulator:
    """One long capture in time blocks over every entry of every process,
    host-major: process h owns samples
    `[h * n_local * block_len, (h+1) * n_local * block_len)`.  Within a
    process the blocks take their halos from each other; the first block's
    comes from the previous process (zeros on process 0)."""

    def __init__(
        self,
        config: DemodConfig,
        block_len: int = 1 << 17,
        warmup: int = 8192,
        mesh: HostMesh | None = None,
        decode_overlap: int = 0,
    ):
        host_mesh = mesh if mesh is not None else make_host_mesh()
        self.mesh = host_mesh
        self.n_devices = host_mesh.size
        self.n_local = len(host_mesh.devices[0])
        self.block_len = block_len
        self._tb = TimeBlockDemodulator(
            config, ChannelMesh(host_mesh.devices[host_mesh.rank], "t"), block_len=block_len,
            warmup=warmup, decode_overlap=decode_overlap,
        )
        self.num_slots = self._tb.num_slots

    def _left_halo(self, blocks: CF32) -> CF32 | None:
        """Send this process's last halo to the next, receive the previous
        one's (non-blocking pairs: no ring of blocking sends)."""
        if not (dist.is_initialized() and dist.get_world_size() > 1):
            return None
        rank, world, H = dist.get_rank(), dist.get_world_size(), self._tb.halo
        dev = blocks.re.device
        stage = torch.device("cpu") if dist.get_backend() == "gloo" else dev
        reqs, got = [], None
        if rank + 1 < world:
            tail = torch.stack([blocks.re[-1, self.block_len - H:],
                                blocks.im[-1, self.block_len - H:]]).to(stage)
            reqs.append(dist.isend(tail.contiguous(), rank + 1))
        if rank > 0:
            got = torch.empty((2, H), dtype=torch.float32, device=stage)
            reqs.append(dist.irecv(got, rank - 1))
        for r in reqs:
            r.wait()
        if got is None:
            return None
        got = got.to(dev)
        return CF32(got[0], got[1])

    def process_local(self, x_local):
        """`(n_local * block_len,)` CF32 or complex samples owned by THIS
        process -> its `(n_local, slots)` (soft, valid)."""
        if not isinstance(x_local, CF32):
            x_local = from_complex(x_local)
        shape = (self.n_local, self.block_len)
        if x_local.re.numel() != shape[0] * shape[1]:
            raise ValueError(f"process_local needs {shape[0] * shape[1]} samples")
        blocks = CF32(x_local.re.reshape(shape), x_local.im.reshape(shape))
        return self._tb.run_blocks(blocks, self._left_halo(blocks))


class DistributedFusedReceiver:
    """The fused receive (`FusedReceiver`: IQ -> symbol ring -> sync -> FEC
    on the device) channel-split over a `(hosts, chips)` mesh: one slab of
    `channels_per_device` channels per local entry, each with its own ring,
    locks and tails, so this axis needs no collectives."""

    def __init__(
        self,
        demod_config,
        decoder_config,
        channels_per_device: int = 128,
        block_len: int = 1 << 17,
        mesh: HostMesh | None = None,
        **rx_kwargs,
    ):
        from xritdemod_tpu_torch.models.receiver import FusedReceiver

        self.mesh = mesh if mesh is not None else make_host_mesh()
        self.devices = self.mesh.devices[self.mesh.rank]
        self.channels = channels_per_device * self.mesh.size
        self.channels_local = channels_per_device * len(self.devices)
        self._rx = {d: FusedReceiver(demod_config, decoder_config, channels=channels_per_device,
                                     block_len=block_len, device=d, **rx_kwargs)
                    for d in dict.fromkeys(self.devices)}
        any_rx = self._rx[self.devices[0]]
        self.k = any_rx.k
        self.ring_len = any_rx.ring_len

    def init_state(self):
        """One state per local entry, each a copy of its device's initial
        state (the ring is a real buffer that a step writes, never a view
        shared between slabs)."""
        first = {d: rx.init_state() for d, rx in self._rx.items()}
        return tuple(_map_state(torch.clone, first[d]) for d in self.devices)

    def step(self, x_local, state):
        """`(C_local, T)` CF32 or complex IQ of THIS process -> (FrameBatch
        with `(C_local, k)` fields, ok, overflow, state)."""
        outs = []
        for dev, xs, st in zip(self.devices, slabs(x_local, self.devices), state):
            with on_device(dev):
                outs.append(self._rx[dev].step(xs, st))
        first = self.devices[0]
        return (gather_batch([o[0] for o in outs], first),
                gather([o[1] for o in outs], first),
                gather([o[2] for o in outs], first),
                tuple(o[3] for o in outs))
