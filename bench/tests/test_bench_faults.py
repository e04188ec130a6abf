"""A run with its timed path broken underneath comes out not correct:
the harness's look for a chip skipped, the rest of a run driven on the CPU
at a tiny size, each fault the cell can have planted in the program's
output or step. The cells' own limits judge (those set from the chip's
readings at the cells' sizes)."""
import io

import pytest
import torch

from bench import calibrate
from bench.harness import runner
from bench.tests._tiny import TRAIN, tiny_gemm, tiny_train

GEMM_CELLS = ["dsv3-gemm-fp8-m4096", "dsv3-gemm-bf16-m4096"]


def execute(name, cell, config, patch=None, seed=2**31 + 17):
    out, err = io.StringIO(), io.StringIO()
    got = runner.execute(name, seed, 0.3, False, device="cpu", cell=cell,
                         config=config, patch=patch, out=out, err=err)
    assert out.getvalue().strip().startswith('{"correct"')
    return got["correct"]


def altered_answer(traffic):
    """One element of each C off by eight times the rms of C."""
    call = traffic._call

    def broken(a, w):
        out = call(a, w).clone()
        rms = float(out.float().pow(2).mean().sqrt())
        out[0, 0] = (out[0, 0].float() + 8 * rms).to(out.dtype)
        return out
    traffic._call = broken


@pytest.mark.parametrize("name", GEMM_CELLS)
def test_gemm_cells(name):
    cell, config = tiny_gemm(name)
    assert execute(name, cell, config)
    assert not execute(name, cell, config, altered_answer)
    assert not execute(name, cell, config, calibrate.half_rows)


def unchanged_state(traffic):
    """A step that returns its state unchanged (with the loss it would have
    stepped from)."""
    from repro_torch.train.steps import loss_fn
    checked = traffic._checked_steps

    def broken(o):
        s = traffic.s

        def step_fn(state, batch):
            with torch.no_grad():
                loss = loss_fn(state[0], batch, s.cfg, remat=False)
            return state, {"loss": loss}
        s.step_fn = step_fn
        return checked(o)
    traffic._checked_steps = broken


@pytest.mark.parametrize("fault", [None, unchanged_state,
                                   calibrate.half_batch])
def test_train_cell(fault):
    cell, config = tiny_train()
    assert execute(TRAIN, cell, config, fault) == (fault is None)
