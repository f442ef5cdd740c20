"""The program's channel-blocks held against the plain reference.

Sampled `(channel, block)` pairs of the timed path: the program's state of
that channel before and after the block, and the frames the block gave it.
The reference (`benchmark/reference/receiver.py`) starts from the program's
state before the block (the recurrences of a block start where the
program's own state left them: the reference cannot follow hundreds of
blocks of 2048 channels itself), takes the same int8 samples, and must end
with the same symbols in the channel's FIFO and the same frames.  Two pairs
are checked without the program's state: the first block of a channel from
the reference's own initial state (the start), and a block whose state the
reference carried itself from the block before (the carry between blocks).

Numbers:
- `soft_gap`: for each pair the median gap between the program's and the
  reference's symbols in the FIFO after the block, over the pair's
  root-mean-square symbol; the largest over the pairs (the demod layer; the
  FEC hides it).  Up to sign: a BPSK carrier loop that locks half a cycle
  away negates every symbol, which the decoder's sync words resolve, and two
  float32 loops pulling in from cold or after interference can settle on
  opposite halves.  A median and not a tail: the clock's interpolator takes
  its taps from a table at mu rounded to 1/128, so wherever the two sides'
  mu differ by ~1e-6 a symbol comes out one table row apart (~3e-3 of a
  symbol), and while the loops pull in (a cold start, a fold head, the
  block after a burst) their mu differ by ~1e-4 and a few per cent of the
  symbols do; the lower-precision control moves every symbol.
- `mismatches`: items that differ exactly: a FIFO fill or lock flag, an
  attempt that extracted a frame on one side only, or an extracted frame
  whose fields (sync, word, sync count, Viterbi corrections, RS counts,
  virtual channel, counter, bytes) differ (the decode layer).  A frame that
  fails RS on both sides (noise, as after a burst) is compared by its sync
  fields alone: in noise the Viterbi path follows the last bits of its
  input.
"""

from __future__ import annotations

import copy

import numpy as np

from benchmark.reference import decode as D
from benchmark.reference import receiver as R
from benchmark.reference.demod import DemodParams, DemodState

FIELDS = ("frame_ok", "sync_ok", "corr", "word", "vit_errors", "vcid", "counter")
SYNC_FIELDS = ("frame_ok", "sync_ok", "corr", "word")


def _c(re, im):
    return (np.asarray(re, np.float32) + 1j * np.asarray(im, np.float32)).astype(np.complex64)


def _pairs(re, im):
    return [(np.float32(r), np.float32(i)) for r, i in zip(re, im)]


def channel_state(pre: dict, j: int) -> R.ChannelState:
    """Row j of a snapshot of the program's state, as the reference's."""
    d = pre["demod"]
    return R.ChannelState(
        demod=DemodState(
            gain=np.float32(d["agc_gain"][j]), rrc_hist=_c(d["rrc_re"][j], d["rrc_im"][j]),
            phase=np.float32(d["phase"][j]), freq=np.float32(d["freq"][j]),
            mu=np.float32(d["mu"][j]), omega=np.float32(d["omega"][j]), ii=int(d["ii"][j]),
            p=_pairs(d["p_re"][j], d["p_im"][j]), c=_pairs(d["c_re"][j], d["c_im"][j]),
            tail=_c(d["tail_re"][j], d["tail_im"][j])),
        ring=np.asarray(pre["ring"][j], np.float64), fill=int(pre["fill"][j]),
        locked=bool(pre["locked"][j]), tails=np.asarray(pre["tails"][j], np.float64))


class Tally:
    def __init__(self):
        self.pairs: list = []
        self.symbols = 0
        self.frames = 0
        self.mismatches = 0
        self.detail: list = []

    def _miss(self, what: str, **kw) -> None:
        self.mismatches += 1
        if len(self.detail) < 8:
            self.detail.append(dict(what=what, **kw))

    def compare(self, tag: dict, st: R.ChannelState, attempts: list, post: dict, j: int,
                out: dict) -> None:
        fill = int(post["fill"][j])
        if fill != st.fill:
            self._miss("fill", program=fill, reference=st.fill, **tag)
        else:
            prog = np.asarray(post["ring"][j][:fill], np.float64)
            ref = st.ring[:fill]
            gap = np.minimum(np.abs(prog - ref), np.abs(prog + ref))
            self.symbols += fill
            if fill:
                rms = np.sqrt((ref ** 2).mean()) or 1.0
                self.pairs.append(dict(tag, median=float(np.median(gap) / rms),
                                       p99=float(np.quantile(gap, 0.99) / rms),
                                       max=float(gap.max() / rms), symbols=fill))
        if bool(post["locked"][j]) != st.locked:
            self._miss("locked", program=bool(post["locked"][j]), reference=st.locked, **tag)
        for a, ref in enumerate(attempts):
            ok = bool(out["ok"][j][a])
            if ok != (ref is not None):
                self._miss("extracted", attempt=a, program=ok, **tag)
                continue
            if ref is None:
                continue
            self.frames += 1
            whole = min(ref["rs_errors"]) >= 0 or min(out["rs_errors"][j][a]) >= 0
            fields = FIELDS if whole else SYNC_FIELDS
            diff = [f for f in fields if ref[f] != type(ref[f])(out[f][j][a])]
            if whole and list(out["rs_errors"][j][a]) != list(ref["rs_errors"]):
                diff.append("rs_errors")
            if whole and not np.array_equal(out["vcdu"][j][a], ref["vcdu"]):
                diff.append("vcdu")
            if diff:
                self._miss("frame", attempt=a, fields=diff, **{
                    f: [type(ref[f])(out[f][j][a]), ref[f]] for f in diff if f in FIELDS}, **tag)

    def soft_gap(self) -> float:
        """The largest over the pairs of a pair's median gap."""
        if not self.pairs:
            return float("nan")
        return max(p["median"] for p in self.pairs)


def run_pairs(pairs: list, cfg: dict, k: int, block_len: int, rows) -> Tally:
    """`pairs`: dicts with `channel`, `block`, `kind` ("state", "start" or
    "carry"), the program's `post` snapshot and `out` frames (row `j`), and
    for "state" its `pre` snapshot.  `rows(c, b)` gives the channel's int8
    samples of a block.  A "carry" pair follows the pair of the same channel
    one block before it."""
    params = DemodParams.from_config(cfg["demod"])
    mode = cfg["decoder"]["mode"]
    tmpl = D.templates(mode)
    L = R.ring_len(cfg["demod"], block_len)
    tally = Tally()
    carried: dict = {}
    done = []
    for p in sorted(pairs, key=lambda p: (p["block"], p["channel"])):
        c, b, j = p["channel"], p["block"], p["j"]
        if p["kind"] == "start":
            st = R.ChannelState(DemodState.initial(params, cfg["demod"]), np.zeros(L), 0, False,
                                np.zeros(D.HIST))
        elif p["kind"] == "carry":
            st = copy.deepcopy(carried.pop(c))
        else:
            st = channel_state(p["pre"], j)
        attempts = R.step(rows(c, b), st, params, mode, k, tmpl)
        done.append((p, st, attempts))
        carried[c] = st
    # Every extracted frame through the FEC stack at once.
    flat = [a for _, _, attempts in done for a in attempts if a is not None]
    fields = iter(D.fec_frames([a[0] for a in flat], [a[1] for a in flat], mode))
    for p, st, attempts in done:
        decoded = [None if a is None else next(fields) for a in attempts]
        tally.compare(dict(channel=p["channel"], block=p["block"], kind=p["kind"]), st, decoded,
                      p["post"], p["j"], p["out"])
    return tally
