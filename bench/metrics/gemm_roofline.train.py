"""The train step's routed GEMM products' share of their roofline, in
percent."""
from bench.metrics import _common


def read(run):
    return _common.train_roofline(run)
