"""Device milliseconds a train step spends in kernels launched inside
`train.backward`, on any thread (the backward, the remat recomputation
inside it)."""
from bench.metrics import _scopes


def read(run):
    return _scopes.phase_ms(run, "backward")
