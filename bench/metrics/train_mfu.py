"""Percent of the bf16 dense peak reached by the model FLOPs of the
window's train steps."""
from bench.metrics import _common


def read(run):
    return _common.mfu(run, dtype="bfloat16")
