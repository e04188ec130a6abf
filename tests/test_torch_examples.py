"""The port's examples (`examples/torch_*.py`) on the CPU, held to the
reference's own functions on the same arguments.

- torch_quickstart: the best schedule's `describe()`, both `summary()`
  strings, `candidates_tried`, the superstep and multicast counts equal
  what the reference's `tune` / `build_program` / `estimate` give (the
  cost model is a carried copy, so the strings are equal);
- torch_deploy_gemm: the six candidates' descriptions and their priced
  times (to 1e-12 relative), the winner and its `op_counts()` equal the
  reference's; the functional run's max error under 1e-4; the SUMMA
  cross-check on 4 gloo ranks passing on every rank (each rank asserts
  its C against numpy's at rtol = atol = 1e-4 and exits non-zero if not);
- torch_train_lm: `--device cpu --steps 101` checkpoints at step 99
  (`ckpt_every=100`) and at the last step, its loss falls, and it decodes
  16 tokens; with no card and no `--device cpu` it raises;
- no `examples/torch_*.py` imports `jax` or the reference (`repro`).
"""
import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import autotuner as jtuner  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.hw import config as jhw  # noqa: E402
from repro.sim import perf as jperf  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
PORT_EXAMPLES = sorted(EXAMPLES.glob("torch_*.py"))


def _example(monkeypatch, name):
    """Import `examples/<name>.py` by module name, with the examples'
    directory on the path (a spawned rank imports it again by name)."""
    monkeypatch.syspath_prepend(str(EXAMPLES))
    return importlib.import_module(name)


def test_the_examples_are_the_references_three():
    assert [p.name for p in PORT_EXAMPLES] == [
        "torch_deploy_gemm.py", "torch_quickstart.py", "torch_train_lm.py"]
    for p in PORT_EXAMPLES:
        assert (EXAMPLES / p.name.removeprefix("torch_")).exists()


@pytest.mark.parametrize("path", PORT_EXAMPLES, ids=lambda p: p.name)
def test_example_imports_neither_jax_nor_the_reference(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def _mini(pkg, name, grid, l1_mb, channels):
    return pkg.AcceleratorConfig(name=name, grid=(grid, grid),
                                 tile=pkg.TileConfig(
                                     l1_bytes=l1_mb * 1024 * 1024),
                                 noc=pkg.NoCConfig(),
                                 hbm=pkg.HBMConfig(n_channels=channels))


def test_quickstart_prints_the_references_schedule_and_report(monkeypatch,
                                                              capsys):
    got = _example(monkeypatch, "torch_quickstart").main()
    out = capsys.readouterr().out
    hw = jhw.softhier_gh200()
    want = jtuner.tune(jsched.GEMMShape(4096, 2112, 7168), hw, elem_bytes=1,
                       max_candidates=24)
    assert got["best_schedule"] == want.schedule.describe()
    assert got["predicted"] == want.report.summary(hw)
    assert got["candidates_tried"] == want.candidates_tried
    mini = _mini(jhw, "mini", 4, 4, 8)
    prog = jsched.build_program(jsched.Schedule(
        jsched.GEMMShape(64, 64, 128), jsched.Tiling(4, 4, 1, tk=32),
        "summa"), mini)
    assert got["supersteps"] == len(prog.supersteps)
    assert got["multicasts"] == prog.op_counts()["multicast"]
    assert got["cost_model"] == jperf.estimate(prog, mini).summary(mini)
    assert f"  best schedule : {got['best_schedule']}" in out
    assert "functional check on mini 4x4 instance: OK" in out


def test_deploy_gemm_matches_the_reference_and_summa_on_gloo(monkeypatch,
                                                             capsys):
    got = _example(monkeypatch, "torch_deploy_gemm").main()
    out = capsys.readouterr().out
    hw = _mini(jhw, "demo-8x8", 8, 2, 16)
    shape = jsched.GEMMShape(32, 512, 2048)
    want = [(c.describe(),
             jperf.estimate(jsched.build_program(c, hw), hw).total_time)
            for c in jtuner.enumerate_candidates(shape, hw, elem_bytes=4,
                                                 max_candidates=6)]
    assert len(want) == 6
    assert [d for d, _ in got["candidates"]] == [d for d, _ in want]
    np.testing.assert_allclose([t for _, t in got["candidates"]],
                               [t for _, t in want], rtol=1e-12, atol=0)
    best = jtuner.tune(shape, hw, elem_bytes=4, max_candidates=24).schedule
    assert got["winner"] == best.describe()
    prog = jsched.build_program(best, hw)
    assert got["op_counts"] == prog.op_counts()
    assert got["supersteps"] == len(prog.supersteps)
    assert got["max_abs_err"] < 1e-4
    assert got["rank_exit_codes"] == [0, 0, 0, 0]
    assert "torch.distributed SUMMA == numpy: OK" in out


def test_train_lm_trains_checkpoints_and_decodes_on_the_cpu(monkeypatch,
                                                            tmp_path,
                                                            capsys):
    train_lm = _example(monkeypatch, "torch_train_lm")
    ckpt = tmp_path / "ckpt"
    # a smoke model's ops are too small to gain from threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = train_lm.main(["--device", "cpu", "--steps", "101", "--ckpt",
                             str(ckpt)])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert got["device"] == "cpu"
    assert len(got["losses"]) == 101
    assert all(np.isfinite(got["losses"]))
    assert got["last_loss"] < got["first_loss"]
    assert len(got["prompt"]) == len(got["continuation"]) == 16
    assert all(0 <= t < 256 for t in got["continuation"])
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "step_0000000099", "step_0000000100"]
    assert "step  100 loss" in out and "continuation :" in out


def test_train_lm_without_a_card_raises(monkeypatch, tmp_path):
    train_lm = _example(monkeypatch, "torch_train_lm")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.main(["--steps", "1", "--ckpt", str(tmp_path / "ckpt")])
    assert not (tmp_path / "ckpt").exists()
