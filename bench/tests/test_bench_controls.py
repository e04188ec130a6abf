"""Each cell's control, the reference put in the program's place and
computed in the precision below the cell's, comes out not correct under
the cell's limits, while the program comes out correct: on the CPU at a
tiny size here, and at the cells' own sizes on the card
(`python3 bench/calibrate.py` reads it on many seeds; the test marked
`gpu` reads one)."""
import json
import math

import pytest
import torch

from bench import calibrate
from bench.harness import core
from bench.tests._tiny import TRAIN, tiny_gemm, tiny_train

GEMM_CELLS = ["dsv3-gemm-fp8-m4096", "dsv3-gemm-bf16-m4096"]


def readings(name, cell, config, device, seed=2**31 + 23):
    return json.loads(calibrate.main(
        ["--workload", name, "--seeds", str(seed), "--controls", str(seed),
         "--seconds", "0.3"], device=device, cell=cell, config=config)[0])


@pytest.mark.parametrize("name", GEMM_CELLS)
def test_gemm_control_fails_on_the_cpu(name):
    cell, config = tiny_gemm(name, nk=((256, 512), (128, 1024)))
    got = readings(name, cell, config, "cpu")
    assert got["correct"] == {"program": True, "control": False,
                              "half_rows": False}, got


def test_train_control_fails_on_the_cpu():
    # widths at which e4m3's rounding of the gradients reads past the
    # cell's `grad_diff` limit (about 0.15 against 0.12; the narrowest
    # tiny cell's reads about 0.09, the cell's own size 0.24)
    cell, config = tiny_train(seq=128, hidden_size=512, head_dim=128,
                              intermediate_size=1024,
                              moe_intermediate_size=256, vocab_size=4096)
    got = readings(TRAIN, cell, config, "cpu")
    assert got["correct"] == {"program": True, "control": False,
                              "half_batch": False}, got
    limits = cell["limits"]
    assert any(v > limits[k] for k, v in got["state_unchanged"].items())


@pytest.mark.gpu
@pytest.mark.parametrize("name", GEMM_CELLS + [TRAIN])
def test_control_fails_at_the_cells_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card: the cells' own sizes")
    cell = core.load_json("workloads", name)
    got = readings(name, cell, core.load_json("configs", cell["config"]),
                   "cuda")
    verdict = dict(got["correct"])
    assert verdict.pop("program") and not any(verdict.values()), got
    assert all(math.isfinite(v) for v in got["program"].values())


def test_leaves_reads_every_named_leaf():
    from bench.reference import moe_lm
    cell, config = tiny_train()
    got = json.loads(calibrate.main(
        ["--workload", TRAIN, "--seeds", "5", "--seconds", "0.2",
         "--leaves", ""], device="cpu", cell=cell, config=config)[0])
    by_leaf = got["grad_diff_by_leaf"]["program"]
    assert list(by_leaf) == [n for n, _, _ in moe_lm.leaves(config)]
    assert got["program"]["grad_diff"] == max(by_leaf.values())
