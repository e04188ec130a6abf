"""Device milliseconds a train step spends in kernels launched inside
`optim.clip` (the gradients' global norm and their scaling), a part of
`optimizer_ms.train`."""
from bench.metrics import _scopes


def read(run):
    return _scopes.phase_ms(run, "clip")
