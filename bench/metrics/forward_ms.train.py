"""Device milliseconds a train step spends in kernels launched inside
`train.forward` (the forward and the chunked loss)."""
from bench.metrics import _scopes


def read(run):
    return _scopes.phase_ms(run, "forward")
