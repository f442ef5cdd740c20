"""Constellation viewer: a scatter plot of recovered symbols.

    python -m xritdemod_tpu_torch.tools.seeconstellation file capture.c64 [--out PNG]
    python -m xritdemod_tpu_torch.tools.seeconstellation udp [port] [--out PNG]

The port's counterpart of `tools/seeconstellation.py` (the reference's
`demodulator/seeconstelation.py`): reads a complex64 file, or listens on the
constellation tap of the port's `runtime/diag.py` (`DiagManager`: 1024 int8
I/Q symbols a datagram to 127.0.0.1:9000) for up to 32 datagrams, and plots
them to a PNG with matplotlib, or as text when matplotlib is missing.  It
does no device work; `--device` is taken, and checked, as by every tool.
"""

from __future__ import annotations

import argparse
import socket
import sys

import numpy as np

from xritdemod_tpu_torch.tools.timing import require_device


def from_file(path: str):
    data = np.fromfile(path, dtype=np.complex64)
    return data.real, data.imag


def from_udp(port: int = 9000, datagrams: int = 32, timeout: float = 5.0):
    """(I, Q) of up to `datagrams` datagrams of the diagnostics tap (int8 I/Q
    interleaved, scaled by 1/128), until `timeout` seconds pass without one."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", port))
    sock.settimeout(timeout)
    xs, ys = [], []
    try:
        for _ in range(datagrams):
            pkt, _ = sock.recvfrom(4096)
            sym = np.frombuffer(pkt, np.int8).astype(np.float32) / 128.0
            xs.append(sym[0::2])
            ys.append(sym[1::2])
    except socket.timeout:
        pass
    finally:
        sock.close()
    if not xs:
        return np.zeros(0), np.zeros(0)
    return np.concatenate(xs), np.concatenate(ys)


def ascii_plot(x, y, height: int = 21, width: int = 41) -> str:
    """The first 20000 points on a text grid over [-1.5, 1.5]^2."""
    grid = [[" "] * width for _ in range(height)]
    for xi, yi in zip(x[:20000], y[:20000]):
        c = int((xi + 1.5) / 3.0 * (width - 1))
        r = int((1.5 - yi) / 3.0 * (height - 1))
        if 0 <= r < height and 0 <= c < width:
            grid[r][c] = "*"
    return "\n".join("".join(row) for row in grid)


def plot(x, y, out: str = "constellation.png") -> str:
    """Writes the PNG (matplotlib) and returns its path; returns the text
    plot instead when matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return ascii_plot(x, y)
    plt.figure(figsize=(5, 5))
    plt.plot(x, y, ".", markersize=2, alpha=0.4)
    plt.xlim(-1.5, 1.5)
    plt.ylim(-1.5, 1.5)
    plt.grid(True)
    plt.title(f"constellation ({len(x)} symbols)")
    plt.savefig(out, dpi=120)
    plt.close()
    return f"wrote {out}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="seeconstellation")
    p.add_argument("mode", nargs="?", default="udp", choices=["file", "udp"])
    p.add_argument("source", nargs="?", default=None, help="file path, or UDP port (9000)")
    p.add_argument("--out", default="constellation.png")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    require_device(args.device, "seeconstellation")
    if args.mode == "file":
        if not args.source:
            raise SystemExit("seeconstellation: file mode needs a path")
        x, y = from_file(args.source)
    else:
        port = int(args.source) if args.source else 9000
        print(f"listening for constellation datagrams on udp:{port} ...")
        x, y = from_udp(port)
    if len(x) == 0:
        print("no symbols received")
        return 1
    print(plot(x, y, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
