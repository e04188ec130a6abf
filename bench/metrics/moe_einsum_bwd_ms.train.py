"""Device milliseconds a train step spends in the backward of the MoE
einsums: kernels of the autograd nodes made inside `moe.einsums`."""
from bench.metrics import _scopes


def read(run):
    return _scopes.moe_backward_ms(run)
