"""Median host microseconds of `mmad`'s wrapper a call (`mmad.launch`:
checks, launch plan, geometry, scratch, tensor maps), the CUDA launch
calls inside it left out."""
from bench.metrics import _scopes


def read(run):
    return _scopes.mmad_host_us(run)
