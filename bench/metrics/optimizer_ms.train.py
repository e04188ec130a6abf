"""Device milliseconds a train step spends in kernels launched inside
`optim.adamw` (the update, the global-norm clip included)."""
from bench.metrics import _scopes


def read(run):
    return _scopes.phase_ms(run, "optimizer")
