"""Time-block and fold-parallel demodulation of one long capture.

Counterpart of `xritdemod_tpu/parallel/timeblocks.py`.  The reference is
strictly serial in time; here a long capture is cut into pieces that run
side by side, each re-acquiring its feedback loops (AGC gain, Costas phase
and frequency, M&M mu and omega) from cold over a warm-up stretch whose
output is dropped.  The loops converge in O(1/alpha) samples, and the
frame-sync correlator recovers from the seam exactly as the reference
recovers from any stream gap.

- `TimeBlockDemodulator`: D contiguous blocks over a mesh, each with a left
  halo from its neighbour's tail (the reference's `ppermute` halo), on the
  serial path's stages.  Blocks whose mesh entries share a device run as
  the rows of one batched launch.
- `FoldedCaptureReceiver`: one card reprocesses a recorded capture at
  channel-batch speed by folding it into overlapping segments that run as
  the channels of the fused receive; frames decoded by two neighbouring
  folds are kept once, by `(vcid, counter)`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from xritdemod_tpu_torch import constants as K
from xritdemod_tpu_torch.models.decoder import DecoderConfig, StreamDecoder
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.parallel.channels import ChannelMesh, gather, on_device
from xritdemod_tpu_torch.runtime import metrics
from xritdemod_tpu_torch.utils.cplx import CF32, IQ_S8_SCALE, from_complex

__all__ = ["TimeBlockDemodulator", "FoldedCaptureReceiver"]


class TimeBlockDemodulator:
    """One `(D * block_len,)` capture as D contiguous time blocks.

    `process(x)` returns `(soft, valid)` of shape `(D, slots)`, where row d
    covers samples `[d*block_len, (d+1)*block_len)`.  Row d runs the serial
    path's stages (decimating FIR, AGC, RRC, Costas, clock) from
    `init_state` over `warmup + decode_overlap` samples of halo, taken from
    block d-1's tail (zeros for block 0: a cold start, as the reference's
    stream head), and then its block.  Symbols recovered from the warm-up
    are zeroed and marked invalid; those of the `decode_overlap` stretch are
    kept, so frames spanning a seam are decoded from both sides and survive
    a `(vcid, counter)` dedup.  Size it >= 2 coded-frame spans
    (2 * 16384 * sps * decimation samples) for zero seam loss.
    """

    def __init__(
        self,
        config: DemodConfig,
        mesh: ChannelMesh,
        block_len: int = 1 << 20,
        warmup: int = 8192,
        decode_overlap: int = 0,
    ):
        if (block_len % config.decimation or warmup % config.decimation
                or decode_overlap % config.decimation):
            raise ValueError(
                "block_len/warmup/decode_overlap must be multiples of decimation"
            )
        halo = warmup + decode_overlap
        if halo > block_len:
            raise ValueError(f"halo of {halo} samples exceeds block_len {block_len}")
        self.config = config
        self.mesh = mesh
        self.block_len = block_len
        self.warmup = warmup
        self.decode_overlap = decode_overlap
        self.n_devices = len(mesh)
        self.halo = halo
        # The serial path's stages in their exact forms, as the reference's
        # rows run `_block`, whatever block updates the config names.
        split = dataclasses.replace(config, frontend_kernel="split", clock_block_update=0,
                                    frontend_block_update=0, frontend_precision="highest")
        self._demods = {d: Demodulator(split, halo + block_len, device=d)
                        for d in dict.fromkeys(mesh.devices)}
        self.num_slots = self._demods[mesh.devices[0]].num_slots
        # The clock walks ~omega post-decimation samples a symbol.
        self.nwarm = int(warmup / config.decimation / config.sps) + 2

    def process(self, x):
        """`(n_devices * block_len,)` CF32 or complex numpy -> (soft, valid)
        `(D, slots)` on the first entry's device."""
        if not isinstance(x, CF32):
            x = from_complex(x)
        total = self.n_devices * self.block_len
        if x.re.shape != (total,):
            raise ValueError(f"process needs {total} samples, got {tuple(x.re.shape)}")
        blocks = CF32(x.re.reshape(self.n_devices, self.block_len),
                      x.im.reshape(self.n_devices, self.block_len))
        return self.run_blocks(blocks)

    def run_blocks(self, blocks: CF32, first_halo: CF32 | None = None):
        """`(n_devices, block_len)` consecutive blocks -> (soft, valid).  The
        first block's halo is `first_halo` (`(halo,)`, the tail of the block
        before it; the multi-process form passes its left neighbour's), or
        zeros."""
        D, B, H = self.n_devices, self.block_len, self.halo
        if blocks.re.shape != (D, B):
            raise ValueError(f"run_blocks needs ({D}, {B}) blocks, got {tuple(blocks.re.shape)}")

        def ext(part: torch.Tensor, first) -> torch.Tensor:
            head = torch.zeros((1, H), dtype=torch.float32) if first is None else first[None]
            halos = torch.cat([head.to(part.device), part[:-1, B - H:]], dim=0)
            return torch.cat([halos, part], dim=1)                  # (D, H + B)

        xr = ext(blocks.re, None if first_halo is None else first_halo.re)
        xi = ext(blocks.im, None if first_halo is None else first_halo.im)
        rows: dict = {}
        for d, dev in enumerate(self.mesh.devices):
            rows.setdefault(dev, []).append(d)
        soft = [None] * D
        valid = [None] * D
        for dev, idx in rows.items():
            demod = self._demods[dev]
            sel = torch.tensor(idx, device=xr.device)
            x = CF32(xr[sel].to(dev), xi[sel].to(dev))
            with on_device(dev):
                s, v, _ = demod.block_batch(x, demod.init_state_batch(len(idx)))
                keep = torch.arange(s.shape[-1], device=dev) >= self.nwarm
                s = torch.where(keep, s, torch.zeros((), device=dev))
                v = v & keep
            for r, d in enumerate(idx):
                soft[d], valid[d] = s[r : r + 1], v[r : r + 1]
        first = self.mesh.devices[0]
        return gather(soft, first), gather(valid, first)


class FoldedCaptureReceiver:
    """Bulk reprocessing of ONE recorded capture on one card at channel-batch
    speed: the fold-parallel form of `TimeBlockDemodulator`.

    The capture is folded into `folds` overlapping time segments that run
    through the batched receive as if they were independent channels.  Each
    fold after the first starts `overlap` samples inside its left
    neighbour's segment, `overlap >= warmup + 2 coded-frame spans`: the
    warm-up re-locks the loops from cold, the remaining two frame spans are
    decoded by both neighbouring folds, and the duplicates are dropped by
    `(vcid, counter)`.  So no frame is lost at a seam as long as re-lock
    succeeds within the warm-up.

    `use_fused` (default: on when `device` is CUDA) steps one
    `FusedReceiver(channels=folds)`, `step_int8` for an int8 capture, on the
    device; otherwise each block goes through `Demodulator.block_batch` and
    each fold's symbols through its own `StreamDecoder`.

    Over one coded-frame span after each fold's last real sample (past the
    capture's end, or in the fused path's first flush step) the folds see
    seeded noise where the reference feeds zeros (`_noise`: a fold cut just
    after a sync marker would otherwise deliver the all-PN frame); zeros
    follow it.  This is the one place the port's frames may differ from the
    reference's.
    """

    def __init__(
        self,
        config: DemodConfig,
        folds: int = 128,
        block_len: int = 1 << 17,
        warmup: int | None = None,
        frames_per_block: int = 32,
        mode: str | None = None,
        use_fused: bool | None = None,
        max_clock_ppm: float = 100.0,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FoldedCaptureReceiver(device='cuda') needs a CUDA device")
        if warmup is None:
            # Cold-start pull-in is set by the M&M omega loop and grows about
            # quadratically with the capture's symbol-clock offset (the
            # reference measured ~4.4k samples at 0 ppm, ~13k at 100 ppm);
            # the default covers `max_clock_ppm`.
            warmup = max(16384, int(16384 + 0.9 * max_clock_ppm**2))
            warmup = -(-warmup // config.decimation) * config.decimation
        if block_len % config.decimation or warmup % config.decimation:
            raise ValueError("block_len and warmup must be multiples of decimation")
        self.config = config
        self.folds = folds
        self.block_len = block_len
        self.warmup = warmup
        if mode is None:
            mode = "lrit" if config.symbol_rate == K.LRIT_SYMBOL_RATE else "hrit"
        self.mode = mode
        self._dec_cfg = DecoderConfig(mode=mode, frames_per_block=frames_per_block)
        self.use_fused = self.device.type == "cuda" if use_fused is None else use_fused
        # In raw capture samples: one coded frame spans sps post-decimation
        # samples a symbol times the decimation.
        self._frame_span = int(K.CODED_FRAME_SIZE * config.sps * config.decimation) + 1
        self.overlap = warmup + 2 * self._frame_span
        self._demod = Demodulator(config, block_len=block_len, device=self.device)
        self._rx = None
        self._noise_blocks: dict = {}
        self.last_timings: dict = {}   # filled by the fused path

    def _get_rx(self):
        """The FusedReceiver, built once (so `warm_jit` carries over)."""
        if self._rx is None:
            from xritdemod_tpu_torch.models.receiver import FusedReceiver

            self._rx = FusedReceiver(self.config, self._dec_cfg, channels=self.folds,
                                     block_len=self.block_len, device=self.device)
        return self._rx

    def warm_jit(self, wire: str = "s8") -> float:
        """Build the kernels, make the noise block and run one zero block of
        the production shapes through the fused step before the capture
        streams (the reference's name: there it compiled the step).  Returns
        the wall seconds spent; a no-op on the non-fused path."""
        if not self.use_fused:
            return 0.0
        t0 = time.perf_counter()
        self._noise(wire == "s8")
        rx = self._get_rx()
        st = rx.init_state()
        if wire == "s8":
            batch = rx.step_int8(np.zeros((self.folds, 2 * self.block_len), np.int8), st)[0]
        else:
            batch = rx.step(np.zeros((self.folds, self.block_len), np.complex64), st)[0]
        float(batch.corr[0, 0])                 # waits for the device
        return time.perf_counter() - t0

    def _fold_starts(self, N: int):
        F, T = self.folds, self.block_len
        seg = -(-N // F)          # segment length per fold (ceil)
        nblocks = -(-(seg + self.overlap) // T)
        starts = np.arange(F, dtype=np.int64) * seg - self.overlap
        return starts, nblocks

    def _fold_block(self, x, starts, j, buf, width: int = 1):
        """Assemble fold block j into `buf`.  `width` = elements per sample
        (1 for complex64 rows, 2 for interleaved int8 I/Q)."""
        N = len(x) // width
        T = self.block_len
        buf[:] = 0
        for f in range(self.folds):
            s0 = starts[f] + j * T
            c0, c1 = max(s0, 0), min(s0 + T, N)
            if c1 > c0:
                buf[f, width * (c0 - s0) : width * (c1 - s0)] = x[width * c0 : width * c1]
        return buf

    def _noise(self, int8_wire: bool) -> np.ndarray:
        """Seeded noise at about the captures' level, one row per fold, one
        coded-frame span long (made once, by `warm_jit` where it is called):
        what each fold sees over the first frame span after its last real
        sample.  Not zeros: a coded frame of zeros decodes to the all-PN
        frame (scid 253, vcid 8, counter 966810), which passes RS, so a fold
        whose stream stopped just after a sync marker would deliver
        [marker | zeros] as a good frame.  Noise fails RS like any junk, and
        a frame that starts after it finds no marker to sync on."""
        if int8_wire not in self._noise_blocks:
            F, W = self.folds, 2 * self._frame_span
            rng = np.random.default_rng(0)
            q = np.frombuffer(rng.bytes(F * W), np.int8).reshape(F, W) >> 2   # +-32
            if not int8_wire:
                f = q.astype(np.float32) / np.float32(IQ_S8_SCALE)
                q = (f[:, 0::2] + 1j * f[:, 1::2]).astype(np.complex64)
            self._noise_blocks[int8_wire] = q
        return self._noise_blocks[int8_wire]

    def _block(self, x, starts, j, nblocks, buf, noise, width: int = 1):
        """Fold block j (`_fold_block`; from j = nblocks on, a flush block of
        zeros), with `noise` over the first coded-frame span after each
        fold's last real sample."""
        T = self.block_len
        if j < nblocks:
            self._fold_block(x, starts, j, buf, width)
        else:
            buf[:] = 0
        span = noise.shape[1] // width
        # Fold-relative end of each fold's real samples.
        ends = np.minimum(len(x) // width - starts, nblocks * T)
        for f in np.nonzero((ends < (j + 1) * T) & (ends + span > j * T))[0]:
            e = int(ends[f])
            a, b = max(e, j * T), min(e + span, (j + 1) * T)
            lo, hi = width * (a - j * T), width * (b - j * T)
            buf[f, lo:hi] = noise[f, width * (a - e) : width * (b - e)]
        return buf

    @staticmethod
    def _dedup(per_fold) -> list[tuple[int, int, int, bytes]]:
        out: list[tuple[int, int, int, bytes]] = []
        seen: set[tuple[int, int]] = set()
        for frames in per_fold:
            for scid, vcid, ctr, vcdu in frames:
                key = (vcid, ctr)
                if key in seen:
                    continue
                seen.add(key)
                out.append((scid, vcid, ctr, vcdu))
        return out

    @torch.no_grad()
    def _process_fused(self, x, starts, nblocks):
        """Every block steps the FusedReceiver; two trailing blocks (noise,
        then zeros: `_block`) flush the last ring-buffered frames (their junk tail fails the
        per-frame sync recheck or RS).  Results stay on the device as per-block
        tensors (fresh ones: the step writes its ring in place, never its
        outputs) and come back as one stacked copy per field at the end.
        Spans (`runtime/metrics.py`), under the call's `fold.process`:
        `fold.assemble` and `fold.step` a block, then `fold.pull` and
        `fold.dedup`."""
        F, T = self.folds, self.block_len
        int8_wire = x.dtype == np.int8
        rx = self._get_rx()
        st = rx.init_state()
        saved = []
        buf = np.zeros((F, 2 * T), np.int8) if int8_wire else np.zeros((F, T), np.complex64)
        noise = self._noise(int8_wire)
        t_assemble = 0
        for j in range(nblocks + 2):
            ta = metrics.clock()
            self._block(x, starts, j, nblocks, buf, noise, 2 if int8_wire else 1)
            tb = metrics.clock()
            metrics.add("fold.assemble", ta, tb)
            t_assemble += tb - ta
            # `step_int8` and `step` copy `buf` before returning (on the
            # CPU they consume it), so it can be refilled.
            with metrics.span("fold.step"):
                if int8_wire:
                    batch, ok, ovf, st = rx.step_int8(buf, st)
                else:
                    batch, ok, ovf, st = rx.step(buf, st)
            saved.append((batch.frame_ok, batch.scid, batch.vcid, batch.counter, batch.vcdu))
        t_pull0 = time.perf_counter()
        with metrics.span("fold.pull"):
            okh, scid, vcid, ctr, vcdu = (torch.stack(xs).cpu().numpy() for xs in zip(*saved))
        self.last_timings = {
            "assemble_s": t_assemble * 1e-9,        # host-side fold copies, all blocks
            "stream_and_pull_s": time.perf_counter() - t_pull0,   # drain + one copy a field
            "blocks": nblocks,
            "wire": "s8" if int8_wire else "f32",
        }
        with metrics.span("fold.dedup"):
            per_fold: list[list] = [[] for _ in range(F)]
            # nonzero is row-major (j, f, k): within each fold the appends
            # are in stream order, which _dedup relies on.
            for j, f, k in zip(*np.nonzero(okh)):
                per_fold[f].append((int(scid[j, f, k]), int(vcid[j, f, k]), int(ctr[j, f, k]),
                                    bytes(vcdu[j, f, k])))
            return self._dedup(per_fold)

    @torch.no_grad()
    def process(self, x) -> list[tuple[int, int, int, bytes]]:
        """Capture -> deduplicated `(scid, vcid, counter, vcdu)` in stream
        order.  Takes complex64 samples or the `(2N,)` interleaved int8 I/Q
        wire format (`utils.cplx.quantize_iq_s8`); an int8 capture crosses
        to the device quantized on the fused path and is dequantized on the
        host for the other."""
        x = np.asarray(x)
        int8_wire = x.dtype == np.int8
        if int8_wire and x.ndim == 2:          # (N, 2) -> interleaved
            x = x.reshape(-1)
        if not int8_wire:
            x = np.asarray(x, np.complex64)
        N = len(x) // 2 if int8_wire else len(x)
        F, T = self.folds, self.block_len
        starts, nblocks = self._fold_starts(N)
        if self.use_fused:
            with metrics.span("fold.process"):
                return self._process_fused(x, starts, nblocks)
        if int8_wire:
            f = x.astype(np.float32) / np.float32(IQ_S8_SCALE)
            x = (f[0::2] + 1j * f[1::2]).astype(np.complex64)

        state = self._demod.init_state_batch(F)
        decoders = [StreamDecoder(self._dec_cfg, device=self.device) for _ in range(F)]
        batches: list[list] = [[] for _ in range(F)]
        buf = np.zeros((F, T), np.complex64)
        noise = self._noise(False)
        for j in range(nblocks):
            self._block(x, starts, j, nblocks, buf, noise)
            soft, valid, state = self._demod.block_batch(buf, state)
            soft_h, valid_h = soft.cpu().numpy(), valid.cpu().numpy()
            for f in range(F):
                batches[f] += decoders[f].push(soft_h[f][valid_h[f]])
        per_fold: list[list] = [[] for _ in range(F)]
        for f in range(F):
            for b in batches[f] + decoders[f].flush():
                ok, scid, vcid, ctr, vcdu = (
                    getattr(b, n).cpu().numpy()
                    for n in ("frame_ok", "scid", "vcid", "counter", "vcdu"))
                per_fold[f] += [(int(scid[i]), int(vcid[i]), int(ctr[i]), bytes(vcdu[i]))
                                for i in np.nonzero(ok)[0]]
        return self._dedup(per_fold)
