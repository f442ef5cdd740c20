"""Every frame a site delivers, held against what its stream sent.

A delivered frame is one whose sync rechecked and whose four Reed-Solomon
codewords all decoded.  It is right when its bytes equal the VCDU of its
stream with its counter.  Two other kinds come from the receiver design
itself, as the plain reference shows from the same state and samples: the
exact complement of a sent VCDU (the BPSK ambiguity passes a transparent
code and a complemented RS codeword, when a channel acquires), and a false
lock (a sync match after interference, at a lag where RS accepts the frame
with corrections, and the frames after it while the flywheel holds that
lag), whose header names no VCDU its stream sent.  Neither is delivered
bit-exact, so both count as lost, not as wrong.  A frame whose header
names a sent VCDU and whose bytes differ from it is wrong.

`attempted` counts, channel by channel, the frames sent whole inside the
window's blocks, `MARGIN` samples clear of the window's ends and of a
burst, and `SEAM_FRAMES` frame spans clear of a seam (where every channel
re-locks); `lost` those of them not delivered bit-exact.  The run's
`attempted` and `failed` count blocks, not frames (`benchmark/run.py`).
"""

from __future__ import annotations

import numpy as np

MARGIN = 512                   # samples clear of an edge for a frame to count
SEAM_FRAMES = 3                # frame spans after a seam in which channels re-lock


def header(vcdu: np.ndarray):
    h = vcdu[..., :5].astype(np.int64)
    return h[..., 1] & 0x3F, (h[..., 2] << 16) | (h[..., 3] << 8) | h[..., 4]


class FrameGate:
    def __init__(self, capture, first_block: int):
        self.cap = capture
        self.b0 = first_block
        self.b1 = first_block
        self.delivered: dict[int, np.ndarray] = {}
        self.wrong = 0
        self.complemented = 0
        self.false_locks = 0
        self.partial = 0
        self.wrong_detail: list = []

    def _lap_mask(self, lap: int) -> np.ndarray:
        m = self.delivered.get(lap)
        if m is None:
            m = self.delivered[lap] = np.zeros((self.cap.C, self.cap.nframes), bool)
        return m

    def add(self, b: int, out: dict) -> None:
        """Block b's results: `out` holds `(C, k)` frame_ok, vcid, counter,
        vit_errors, `(C, k, 4)` rs_errors and `(C, k, 892)` vcdu, on the
        host."""
        self.b1 = max(self.b1, b + 1)
        cap = self.cap
        lap, _ = cap.lap(b)
        fok = out["frame_ok"] & (out["rs_errors"] >= 0).all(-1)
        self.partial += int((out["frame_ok"] & ~fok).sum())
        c, i = np.nonzero(fok)
        if c.size == 0:
            return
        s = cap.stream_of[c]
        vc = out["vcdu"][c, i]
        f = (out["counter"][c, i].astype(np.int64) - cap.counter0[s]) & 0xFFFFFF
        known = (out["vcid"][c, i] == s + 1) & (f < cap.nframes)
        fc = np.where(known, f, 0)
        right = known & (vc == cap.sent[s, fc]).all(-1)
        self._lap_mask(lap)[c[right], f[right]] = True
        bad = np.nonzero(~right)[0]
        if bad.size:
            inv = ~vc[bad]
            ivc, ictr = header(inv)
            fi = (ictr - cap.counter0[s[bad]]) & 0xFFFFFF
            ok_i = (ivc == s[bad] + 1) & (fi < cap.nframes)
            comp = ok_i & (inv == cap.sent[s[bad], np.where(ok_i, fi, 0)]).all(-1)
            wrong = known[bad] & ~comp
            self.complemented += int(comp.sum())
            self.false_locks += int((~known[bad] & ~comp).sum())
            self.wrong += int(wrong.sum())
            for j in bad[wrong][: 8 - len(self.wrong_detail)]:
                self.wrong_detail.append(dict(
                    block=b, channel=int(c[j]), attempt=int(i[j]),
                    vcid=int(out["vcid"][c[j], i[j]]), counter=int(out["counter"][c[j], i[j]]),
                    rs_errors=out["rs_errors"][c[j], i[j]].tolist(),
                    vit_errors=int(out["vit_errors"][c[j], i[j]]),
                    bytes_differing=int((vc[j] != cap.sent[s[j], fc[j]]).sum())))

    def counts(self) -> tuple[int, int]:
        """(attempted, lost) frames over the blocks added."""
        cap = self.cap
        attempted = delivered = 0
        for lap in range(self.b0 // cap.cap, (self.b1 - 1) // cap.cap + 1):
            e0 = max(self.b0, lap * cap.cap) - lap * cap.cap
            e1 = min(self.b1, (lap + 1) * cap.cap) - lap * cap.cap
            got = self.delivered.get(lap)
            bursts = {}
            for b in range(max(self.b0, lap * cap.cap), min(self.b1, (lap + 1) * cap.cap)):
                for ch in cap.bursting(b):
                    bursts.setdefault(int(ch), []).append(b - lap * cap.cap)
            # After a seam every channel re-locks from a broken stream.
            lo = MARGIN + (SEAM_FRAMES * cap.frame_len if lap * cap.cap >= self.b0 else 0)
            for ch in range(cap.C):
                f0, f1 = cap.frame_range(ch, e0, e1, MARGIN, lo=int(lo))
                if f1 <= f0:
                    continue
                want = np.zeros(cap.nframes, bool)
                want[max(f0, 0):min(f1, cap.nframes)] = True
                for e in bursts.get(ch, ()):
                    g0, g1 = cap.frames_over(ch, e, MARGIN)
                    want[max(g0, 0):max(min(g1, cap.nframes), 0)] = False
                attempted += int(want.sum())
                if got is not None:
                    delivered += int((want & got[ch]).sum())
        return attempted, attempted - delivered
