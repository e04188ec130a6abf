"""Training throughput: the tokens of every step completed in the window
over its seconds."""
from bench.metrics import _common


def read(run):
    return _common.per_second(run, "tokens")
