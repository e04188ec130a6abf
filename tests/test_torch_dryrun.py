"""The port's dry run (`launch/dryrun.py`) at full configuration.

Three cells run in their own processes, all started together (the
launcher initialises a fake 256-rank world in each): gemma-2b decode_32k
record-only with a plan cache through `python -m repro_torch.launch.dryrun`,
and, through `run_cell`, the smoke gemma-2b's train_4k cell record-only
with a plan cache and its decode_32k cell routed. The full gemma-2b
train_4k cell takes some 30 s of meta-device ops to trace; it runs in
`chip_smoke.py`'s dryrun phase, and here its arguments are built and
placed, not traced. The cells are held to the reference:

- the per-device argument bytes equal a count made here from the
  reference's own `param_spec` / `cache_spec` / `batch_spec` on its
  abstract parameters, AdamW state and caches (the reference's stacked
  leaves, so the same bytes by an independent layout); the reference's
  host-side cache `index` arrays and decode `position` scalar have no
  device counterpart in the port and are left out;
- `model_flops` equals the reference's `launch/flops.model_flops`;
- the observed GEMM workload covers `model_workload`'s prediction: all
  of it at decode; at train all but the lm_head, which the loss runs in
  512-token chunks (`steps.LOSS_CHUNK`) in both packages while
  `model_workload` predicts the whole projection (a caveat of the
  reference, listed in ROADMAP.md);
- the routed cell resolves every GEMM with no silent degrade, and has no
  roofline: its rank-0 counts describe no one chip.
"""
import json
import math
import os
import subprocess
import sys

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config
from repro.configs import smoke_config as ref_smoke_config
from repro.launch import flops as ref_flops
from repro.launch.input_specs import input_specs as ref_input_specs
from repro.models.model import init_params as ref_init_params
from repro.parallel import spec_rules as ref_rules
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import flops as port_flops

# run_cell on the smoke gemma-2b: its own process, its own fake world
SMOKE_CELL = (
    "import json, sys\n"
    "from repro_torch.configs import smoke_config\n"
    "from repro_torch.launch import dryrun\n"
    "dryrun.get_config = smoke_config\n"
    "shape, route = sys.argv[1], sys.argv[2] == 'route'\n"
    "out = dryrun.run_cell('gemma-2b', shape, False,\n"
    "                      skip_accounting=not route,\n"
    "                      plan_cache=sys.argv[3], route=route)\n"
    "json.dump(out, open(sys.argv[4], 'w'))\n")


class _Mesh:
    """The 16x16 production mesh's shape, for placing a cell's arguments
    (building them calls no collective, so no world is needed)."""
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    out = str(tmp / "out")
    # a meta-device trace computes nothing: one thread each, beside the
    # other test workers
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {"decode_32k": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma-2b", "--shape", "decode_32k", "--plan-cache",
         str(tmp / "pc"), "--out", out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)}
    smoke = {"smoke_train": ("train_4k", "record"),
             "routed": ("decode_32k", "route")}
    for key, (shape, mode) in smoke.items():
        procs[key] = subprocess.Popen(
            [sys.executable, "-c", SMOKE_CELL, shape, mode,
             str(tmp / f"pc_{key}"), str(tmp / f"{key}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    logs = {k: p.communicate(timeout=600)[0] for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, logs[k][-3000:]
    got = {"decode_32k": json.load(open(os.path.join(
        out, "gemma-2b__decode_32k__sp.json")))}
    for key in smoke:
        got[key] = json.load(open(tmp / f"{key}.json"))
    got["out"] = out
    return got


def _keys(path):
    return [getattr(k, "key", getattr(k, "name", None)) for k in path]


def _local_bytes(leaf, spec, mesh):
    n = 1
    entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
    for dim, e in zip(leaf.shape, entries):
        names = () if e is None else (e,) if isinstance(e, str) else e
        size = math.prod(mesh.shape[a] for a in names)
        assert dim % size == 0
        n *= dim // size
    return n * leaf.dtype.itemsize


def _reference_argument_bytes(shape_name):
    """(argument, output) bytes per device of the reference's cell, from
    its specs on its abstract arguments (see the module docstring)."""
    cfg = ref_config("gemma-2b")
    mesh = AbstractMesh((16, 16), ("data", "model"))
    params = jax.eval_shape(lambda: ref_init_params(jax.random.PRNGKey(0),
                                                    cfg))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    p_bytes = sum(_local_bytes(leaf, ref_rules.param_spec(path, leaf, mesh),
                               mesh) for path, leaf in flat)
    specs = ref_input_specs(cfg, shape_name)
    bspec = ref_rules.batch_spec(mesh)
    if specs["kind"] == "train":
        moments = sum(                      # mu and nu, fp32
            2 * _local_bytes(jax.ShapeDtypeStruct(leaf.shape, "float32"),
                             ref_rules.param_spec(path, leaf, mesh), mesh)
            for path, leaf in flat)
        batch = sum(_local_bytes(x, bspec, mesh)
                    for x in specs["inputs"].values())
        state = p_bytes + moments + 4       # + the int32 step
        return state + batch, state + 4     # outputs: state + fp32 loss
    caches = sum(
        _local_bytes(leaf, ref_rules.cache_spec(path, leaf, mesh, cfg,
                                                specs["batch"]), mesh)
        for path, leaf in
        jax.tree_util.tree_flatten_with_path(specs["caches"])[0]
        if _keys(path)[-1] != "index")
    tokens = _local_bytes(specs["tokens"], bspec, mesh)
    logits = specs["batch"] * cfg.vocab * 4            # replicated fp32
    return p_bytes + caches + tokens, logits + caches


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_full_cell_bytes_and_flops_match_reference(cells, shape):
    args, outs = _reference_argument_bytes(shape)
    cfg = ref_config("gemma-2b")
    spec = ref_input_specs(cfg, shape)
    mf = ref_flops.model_flops(cfg, spec["batch"], spec["seq"], spec["kind"])
    if shape == "train_4k":
        # built and placed, not traced (see the module docstring)
        cell = dryrun.build_cell(get_config("gemma-2b"), shape, _Mesh())
        assert dryrun.placed_bytes(cell.args, _Mesh()) == args
        assert port_flops.model_flops(get_config("gemma-2b"), spec["batch"],
                                      spec["seq"], spec["kind"]) == mf
        return
    r = cells[shape]
    assert r["status"] == "ok" and r["scope"] == "global"
    assert r["mesh"] == {"data": 16, "model": 16}
    full = r["full"]
    assert full["argument_bytes_per_device"] == args
    assert full["output_bytes_per_device"] == outs
    assert full["temp_bytes_per_device"] is None
    assert full["peak_bytes_per_device"] == args + outs
    assert full["collective_bytes_raw"] is None
    assert full["collectives"].startswith("none")
    assert full["hlo_flops_raw"] > 0 and full["hlo_bytes_raw"] > 0
    acc = r["accounting"]
    assert acc["model_flops"] == mf["total"]
    assert acc["model_flops_breakdown"] == mf
    assert acc["units_full"] == cfg.n_layers
    assert 0 < acc["useful_ratio"] <= 1.5
    # a dense stack is linear in depth, so the extrapolation of the 1- and
    # 2-layer traces meets the full trace wherever accounting_mode changes
    # nothing: a decode step runs no chunked attention
    assert acc["hlo_flops"] == full["hlo_flops_raw"]
    rf = r["roofline"]
    assert rf["collective_s"] is None
    assert rf["dominant"] in ("compute_s", "memory_s")
    for suffix in (".run_report.json", ".trace.json"):
        assert os.path.exists(os.path.join(
            cells["out"], f"gemma-2b__{shape}__sp{suffix}"))


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_workload_covers_model_workload(cells, shape):
    """decode_32k at full configuration; train_4k on the smoke gemma-2b,
    whose lm_head gap has the same cause and form."""
    if shape == "decode_32k":
        w = cells[shape]["workload"]
        assert w["observed"] == w["predicted"]
        assert w["covered"] == 1.0 and not w["missing"] and not w["extra"]
        return
    r = cells["smoke_train"]
    assert r["scope"] == "global" and not r["routed"]
    w = r["workload"]
    assert w["observed"] == w["predicted"]
    cfg = ref_smoke_config("gemma-2b")
    spec = ref_input_specs(cfg, shape)
    b, s, v, d = spec["batch"], spec["seq"], cfg.vocab, cfg.d_model
    assert w["missing"] == [[b * s, v, d]]
    assert w["extra"] == [[b * 512, v, d]]
    assert w["covered"] == (w["predicted"] - 1) / w["predicted"]


def test_routed_smoke_cell_resolves_everything(cells):
    r = cells["routed"]
    assert r["scope"] == "rank 0" and r["routed"]
    assert r["roofline"] is None and "roofline_note" in r
    assert r["accounting"]["useful_ratio"] is None
    rt = r["routing"]
    assert rt["resolve_rate"] == 1.0
    assert rt["silent_auto_degrades"] == 0 and rt["fallback"] == 0
    assert sum(rt["modes"].values()) > rt["degraded"]
    # every lowering that landed on auto (the smoke widths do not divide
    # over 16x16) carries its reason
    assert sum(rt["degrade_reasons"].values()) >= rt["degraded"]
    assert r["workload"]["covered"] == 1.0
    # rank 0's share of the routed GEMMs moves bytes over the mesh
    assert r["full"]["collective_bytes_raw"] > 0
    assert "all-reduce" in r["full"]["collectives"]
