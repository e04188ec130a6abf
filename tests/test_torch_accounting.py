"""The port's accounting mode (`models/accounting.py`) and the dry run's
`accounting_configs` against the reference's, and the depth extrapolation
the dry run's accounting section rests on.

The extrapolation F(U) = F(1) + (U - 1) * (F(2) - F(1)) over layer units
must equal a direct count at full depth, exactly, wherever the stack is
linear in its units. Each traced count here is a train step of a smoke
configuration on the meta device (batch 2 x 256 tokens, under
`accounting_mode`; 16 tokens for the xLSTM stack, whose sLSTM time loop
runs one Python step a token), at a depth of three units: a dense, an MoE
(its dense layer in the base), a hybrid (a whole number of Mamba2
super-layers) and an xLSTM stack.
"""
import dataclasses
import os

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import list_archs
from repro.models import accounting as ref_acc
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.registry import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import accounting


def _ref_accounting_configs():
    """The reference's `accounting_configs`. Its module sets XLA_FLAGS to
    force 512 host devices when imported (it is meant to run as its own
    process); the variable is put back before anything reads it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref_dryrun.accounting_configs


def _fields(cfg):
    """A config's fields, dtypes by name (torch and jax dtypes differ)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = str(v).rsplit(".", 1)[-1] if isinstance(v, torch.dtype) \
                else jnp.dtype(v).name
        out[f.name] = v
    return out


def _state(mod):
    """The switches that change what is counted. The reference's unroll
    flags steer XLA's loops, which eager PyTorch does not have."""
    return (mod.CHUNK_OVERRIDE, mod.chunk(256), mod.MAX_UNROLL_STEPS)


@pytest.mark.parametrize("seq", [64, 512, 1024, 4096, 32768, 524288])
def test_accounting_mode_sets_and_restores_as_reference(seq):
    assert _state(accounting) == _state(ref_acc)
    with accounting.accounting_mode(seq), ref_acc.accounting_mode(seq):
        assert _state(accounting) == _state(ref_acc)
        assert accounting.CHUNK_OVERRIDE == max(128, seq // 8)
        with accounting.accounting_mode(2 * seq), \
                ref_acc.accounting_mode(2 * seq):
            assert _state(accounting) == _state(ref_acc)
        assert _state(accounting) == _state(ref_acc)
    assert _state(accounting) == _state(ref_acc)
    assert accounting.CHUNK_OVERRIDE is None and not ref_acc.SCAN_UNROLL
    with pytest.raises(RuntimeError):
        with accounting.accounting_mode(seq):
            raise RuntimeError("restored on the way out")
    assert _state(accounting) == _state(ref_acc)


@pytest.mark.parametrize("arch", list_archs())
def test_accounting_configs_match_reference(arch):
    ref = _ref_accounting_configs()(ref_config(arch))
    got = dryrun.accounting_configs(get_config(arch))
    assert got[2:] == ref[2:]
    for c, rc in zip(got[:2], ref[:2]):
        assert _fields(c) == _fields(rc)


class _Mesh:
    """The 16x16 production mesh's shape, for the specs the cell records
    (a record-only trace calls no collective, so no world is needed)."""
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


STACKS = {                              # (arch, depth, tokens)
    "dense": ("gemma-2b", 3, 256),      # 3 layers = 3 units
    "moe": ("deepseek-moe-16b", 4, 256),  # 1 dense + 3 MoE layers
    "hybrid": ("zamba2-1.2b", 6, 256),  # 3 super-layers of 2 Mamba2 + attn
    "xlstm": ("xlstm-1.3b", 6, 16),     # 3 of (mLSTM, sLSTM)
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_unit_extrapolation_equals_full_count(stack, monkeypatch):
    arch, depth, seq = STACKS[stack]
    monkeypatch.setitem(SHAPES, "train_tiny",
                        dict(seq_len=seq, global_batch=2, kind="train"))
    cfg = dataclasses.replace(smoke_config(arch), n_layers=depth)
    c1, c2, units, u1, u2 = dryrun.accounting_configs(cfg)
    assert units == 3 and (u1, u2) == (1, 2)

    def flops(c):
        with accounting.accounting_mode(seq):
            return dryrun.trace_cell(c, "train_tiny", _Mesh())["flops"]

    f1, f2, full = flops(c1), flops(c2), flops(cfg)
    assert 0 < f1 < f2 < full
    assert f1 + (units - u1) / (u2 - u1) * (f2 - f1) == full
