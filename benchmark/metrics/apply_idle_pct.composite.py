"""The idle device time whose innermost program span is ``ddh.action`` (the
DDH transfer apply), in % of the traced window."""

from benchmark.program_spans import idle_pct


def read(run):
    return idle_pct(run, lambda name: name == "ddh.action")
