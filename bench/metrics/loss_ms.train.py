"""Device milliseconds a train step spends in kernels launched inside
`train.loss`, the chunked loss's forward (the `lm_head` product over the
vocabulary and the cross-entropy), a part of `forward_ms.train`; its
backward and recomputation fall in `backward_ms.train`."""
from bench.metrics import _scopes


def read(run):
    return _scopes.phase_ms(run, "loss")
