"""K2's share of its roofline: its frozen count (`rooflines/k2.py`) over
the peaks, against its mean launch time in the trace."""

from benchmark.harness.readers import roofline_pct


def read(res):
    return roofline_pct(res, "k2")
