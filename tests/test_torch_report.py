"""`launch/report.py` and `launch/sweep.cell_done` of the port against the
reference's, on the same cell JSON files.

A cell written in the reference's format renders to the reference's exact
lines. A port cell adds its `scope` at the end of each row, a value the
port's dry run does not measure (null in the JSON) renders as "-", and a
routed (rank-0) cell has no roofline row.
"""
import json
import os

import pytest

from repro.launch import report as ref_report
from repro.launch import sweep as ref_sweep
from repro_torch.launch import report, sweep


def _full(compile_s=12.3, peak=3.2e9, coll="all-reduce:12.0MB(x4)"):
    return {"compile_s": compile_s, "lower_s": 1.0,
            "argument_bytes_per_device": 1e9, "output_bytes_per_device": 1e9,
            "temp_bytes_per_device": 1.2e9, "peak_bytes_per_device": peak,
            "collectives": coll}


def _roofline(c, m, k, dom):
    terms = {"compute_s": c, "memory_s": m, "collective_s": k}
    return {**terms, "dominant": dom, "roofline_fraction": c / max(terms.values())}


REFERENCE_CELLS = {
    "gemma-2b__train_4k__sp": {
        "arch": "gemma-2b", "shape": "train_4k", "multi_pod": False,
        "status": "ok", "full": _full(),
        "accounting": {"useful_ratio": 0.83},
        "roofline": _roofline(0.9, 0.4, 0.1, "compute_s")},
    "qwen3-14b__decode_32k__sp": {
        "arch": "qwen3-14b", "shape": "decode_32k", "multi_pod": False,
        "status": "ok", "full": _full(3.0, 40.5e9, "x" * 90),
        "accounting": {"useful_ratio": 0.5},
        "roofline": _roofline(0.001, 0.2, 0.3, "collective_s")},
    "olmo-1b__prefill_32k__sp": {
        "arch": "olmo-1b", "shape": "prefill_32k", "multi_pod": False,
        "status": "ok", "full": _full(7.0, 9e9),
        "accounting": {"useful_ratio": 0.97},
        "roofline": _roofline(0.1, 0.6, 0.05, "memory_s")},
    # skip-accounting cell: no roofline section
    "gemma-2b__decode_32k__sp": {
        "arch": "gemma-2b", "shape": "decode_32k", "multi_pod": False,
        "status": "ok", "full": _full(2.0, 1e9)},
    "gemma-2b__train_4k__mp": {
        "arch": "gemma-2b", "shape": "train_4k", "multi_pod": True,
        "status": "ok", "full": _full(30.0, 2e9)},
    "xlstm-1.3b__long_500k__sp": {
        "arch": "xlstm-1.3b", "shape": "long_500k", "multi_pod": False,
        "status": "error", "error": "RuntimeError: " + "boom " * 30},
}


def _write(d, cells):
    os.makedirs(d, exist_ok=True)
    for tag, cell in cells.items():
        with open(os.path.join(d, tag + ".json"), "w") as f:
            json.dump(cell, f)
    # observability sidecars are not cells
    for suffix in (".run_report.json", ".trace.json"):
        with open(os.path.join(d, "gemma-2b__train_4k__sp" + suffix),
                  "w") as f:
            json.dump({"launcher": "dryrun"}, f)


def test_tables_equal_reference_on_reference_cells(tmp_path):
    _write(str(tmp_path), REFERENCE_CELLS)
    cells, ref_cells = report.load(str(tmp_path)), ref_report.load(
        str(tmp_path))
    assert cells == ref_cells and len(cells) == len(REFERENCE_CELLS)
    assert report.dryrun_table(cells) == ref_report.dryrun_table(ref_cells)
    rows = report.roofline_table(cells)
    assert rows == ref_report.roofline_table(ref_cells)
    assert rows[-1].endswith("1 multi-pod, 1 no-roofline-section, 1 not-ok")


def test_port_cells_show_scope_and_unmeasured_values(tmp_path):
    port = {
        "gemma-2b__train_4k__sp": {
            **REFERENCE_CELLS["gemma-2b__train_4k__sp"], "scope": "global",
            "full": {**_full(), "temp_bytes_per_device": None,
                     "peak_bytes_per_device": None},
            "roofline": {**_roofline(0.9, 0.4, 0.1, "compute_s"),
                         "collective_s": None}},
        "gemma-2b__decode_32k__sp__routed": {
            **REFERENCE_CELLS["qwen3-14b__decode_32k__sp"],
            "arch": "gemma-2b", "scope": "rank 0",
            "accounting": {"useful_ratio": None}, "roofline": None},
    }
    _write(str(tmp_path), port)
    cells = report.load(str(tmp_path))
    dry = report.dryrun_table(cells)
    assert dry[2] == ("| gemma-2b | decode_32k | 16x16 | ok (3s) | 40.50 | "
                      + "x" * 70 + " | [rank 0]")
    assert dry[3] == ("| gemma-2b | train_4k | 16x16 | ok (12s) | - | "
                      "all-reduce:12.0MB(x4) | [global]")
    # a rank-0 cell's counts describe no one chip: no roofline row, and
    # the cell is counted under "not shown"
    roof = report.roofline_table(cells)
    assert len(roof) == 4
    assert roof[2].startswith("| gemma-2b | train_4k | 0.900 | 0.400 | - | "
                              "compute | ")
    assert roof[2].endswith("| [global]")
    assert roof[3] == "\n1 cell(s) not shown: 1 rank-0-scope"


@pytest.mark.parametrize("mp", [False, True])
def test_cell_done_equals_reference(tmp_path, mp):
    d = str(tmp_path)
    tag = f"olmo-1b__train_4k__{'mp' if mp else 'sp'}"
    for state in ("missing", "ok", "error", "garbage"):
        path = os.path.join(d, tag + ".json")
        if state == "ok" or state == "error":
            with open(path, "w") as f:
                json.dump({"status": state}, f)
        elif state == "garbage":
            with open(path, "w") as f:
                f.write("{not json")
        assert sweep.cell_done(d, "olmo-1b", "train_4k", mp) == \
            ref_sweep.cell_done(d, "olmo-1b", "train_4k", mp) == \
            (state == "ok")
