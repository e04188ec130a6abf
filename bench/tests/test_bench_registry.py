"""The harness finds every piece of `BENCHMARK.json` by name, and the file
keeps to the benchmark's contract."""
import json
import re

import pytest

from bench.harness import core

SPEC = core.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_size|_dim|_rank|_heads|expansion\w*)$|"
                   r"^num_experts_per_tok$")


def test_every_cell_config_generator_and_metric_is_found_by_name():
    for w in SPEC["workloads"]:
        cell = core.load_json("workloads", w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert cell["why"] == w["why"]
        assert hasattr(core.load_module("traffic", cell["generator"]), "Traffic")
        core.load_json("configs", cell["config"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(core.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("kind", ["workloads", "configs", "traffic",
                                  "metrics"])
def test_an_unknown_name_fails(kind):
    load = core.load_module if kind in ("traffic", "metrics") \
        else core.load_json
    for name in ("no-such-entry", "../BENCHMARK", ""):
        with pytest.raises(LookupError):
            load(kind, name)


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in SPEC["workloads"] + SPEC["configs"]:
        assert 0 < len(x["why"]) <= 200 and "\n" not in x["why"]
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in core.cell_metrics(SPEC, w["name"],
                                                     "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.cell_metrics(SPEC, w["name"], "per_layer")


def test_per_layer_metrics_move_a_metric_their_cells_report():
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            e2e = [x["name"] for x in core.cell_metrics(SPEC, cell,
                                                         "end_to_end")]
            assert m["moves"] in e2e, (m["name"], cell)


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_configs_keep_their_sources_numbers():
    """A catalog model's file holds every number of the catalog's config
    under the same key; `reduced` names no width."""
    for c in SPEC["configs"]:
        data = json.loads((core.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] or c["source"] in data.get(
            "sources", [])
        assert not any(WIDTH.search(k) for k in c["reduced"]), c["reduced"]
        assert set(c["reduced"]) == set(data["reduced"])
        assert c["file"].startswith("bench/configs/")


def test_deepseek_v3_gemms_are_the_configs_projections():
    c = core.load_json("configs", "deepseek-v3-gemms")
    d, h = c["hidden_size"], c["num_attention_heads"]
    assert c["gemms"] == [
        [c["q_lora_rank"] + c["kv_lora_rank"] + c["qk_rope_head_dim"], d],
        [h * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]),
         c["q_lora_rank"]],
        [h * (c["qk_nope_head_dim"] + c["v_head_dim"]), c["kv_lora_rank"]],
        [d, h * c["v_head_dim"]],
        [2 * c["moe_intermediate_size"], d],
        [d, c["moe_intermediate_size"]]]
    # the reference package's benchmarks/common.py:24-31, as data
    assert c["gemms"] == [[2112, 7168], [24576, 1536], [32768, 512],
                          [7168, 16384], [4096, 7168], [7168, 2048]]


def test_command_and_paths():
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    for w in SPEC["workloads"]:
        assert core.load_json("workloads", w["name"])["limits"]
