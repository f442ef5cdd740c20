"""Unlocked channels entering the acquisition (K9) a step, over its k
extractions (counter `acquire.channels`)."""

from benchmark.harness.program_spans import counter_a_step


def read(res):
    return counter_a_step("acquire.channels")
