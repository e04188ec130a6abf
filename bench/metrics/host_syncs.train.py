"""Host calls a train step makes that wait for the device: stream, device
and event synchronizes and synchronous copies inside `train.step`."""
from bench.metrics import _scopes


def read(run):
    return _scopes.host_syncs(run)
