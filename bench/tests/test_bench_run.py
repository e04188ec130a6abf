"""A run needs the card: without one, or in a directory that holds only
the benchmark's files, it exits non-zero and prints no result."""
import os
import shutil
import subprocess
import sys

import pytest

from bench.harness import core


def run(cwd, env=None):
    return subprocess.run([sys.executable, "bench/run.py", "--workload",
                           "dsv3-gemm-fp8-m4096", "--seed", "2147483659",
                           "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_no_card_exits_non_zero_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = run(core.ROOT, env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_benchmark_files_alone_exit_non_zero(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run(tmp_path, dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_unknown_cell_exits_non_zero():
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload",
                           "no-such-cell", "--seed", "1", "--seconds", "1"],
                          cwd=core.ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40])
def test_any_whole_seed_derives_a_63_bit_stream(seed):
    s = core.derive_seed(seed, "weights")
    assert 0 <= s < 2**63 and s != core.derive_seed(seed, "batches")
