"""Host microseconds a dit_gemm call takes, launch queue not full (m4096
cells)."""
from bench.metrics import _common


def read(run):
    return _common.dispatch_us(run)
