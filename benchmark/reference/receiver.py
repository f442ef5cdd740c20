"""One channel of the fused receive, plain: an int8 IQ block in, the frames
it completes out.

Per block: the demodulator (`demod.py`) appends the block's soft symbols to
the channel's symbol FIFO of `ring_len` symbols (a block that would overflow
it is dropped whole); then `k` extraction attempts each take the next coded
frame: a locked channel at lag 0, an unlocked one at the best sync lag over
one frame of lags of the FIFO (0 below the threshold: the reference
flywheel's blind drop of one frame), when the FIFO holds the lag plus a
frame.  An extracted frame's sync recheck sets the lock; it is decoded
(`decode.py`) with the channel's history.  The symbols past the fill are 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from benchmark.reference import decode as D
from benchmark.reference.demod import DemodParams, DemodState, demod_block

IQ_SCALE = 127.0


def ring_len(demod: dict, block_len: int) -> int:
    """The FIFO's length: two frames, a block's symbol budget at the clock's
    fastest rate, and 8192 spare, in whole rows of 128."""
    sps = demod["sample_rate"] / demod["decimation"] / demod["symbol_rate"]
    slots = int(math.ceil((block_len // demod["decimation"] + 32)
                          / (sps * (1.0 - demod["clock_omega_limit"])))) + 4
    n = 2 * D.CODED + slots + 8192
    return -(-n // 128) * 128


@dataclass
class ChannelState:
    demod: DemodState
    ring: np.ndarray           # (L,) float64
    fill: int
    locked: bool
    tails: np.ndarray          # (64,) float64


def dequantize(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    return (q[0::2] + 1j * q[1::2]) / IQ_SCALE


def step(q: np.ndarray, st: ChannelState, params: DemodParams, mode: str, k: int,
         tmpl: np.ndarray) -> list:
    """One `(2T,)` int8 IQ block; `st` advances.  Returns the k attempts,
    each `None` (no whole frame in the FIFO) or `(synced, history)`: the
    frame after its sync recheck (`decode.sync_frame`) and the history it
    is decoded with (`decode.fec_frames`, which can take many at once)."""
    soft = demod_block(dequantize(q), st.demod, params)
    L = len(st.ring)
    if st.fill + len(soft) <= L:
        st.ring[st.fill:st.fill + len(soft)] = soft
        st.fill += len(soft)
    window = D.CODED + D.UW_BITS - 1
    out = []
    for _ in range(k):
        pos = 0 if st.locked else D.acquire(st.ring[:window], tmpl)
        if st.fill < pos + D.CODED:
            out.append(None)
            continue
        frame = st.ring[pos:pos + D.CODED].copy()
        drop = pos + D.CODED
        st.ring = np.concatenate([st.ring[drop:], np.zeros(drop)])
        st.fill -= drop
        synced = D.sync_frame(frame, mode, tmpl)
        out.append((synced, st.tails))
        st.tails = synced["tail"]
        st.locked = synced["sync_ok"]
    return out
