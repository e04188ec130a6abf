"""`parallel/spec_rules.py` of the PyTorch port against the reference's.

The port keeps one module (and one cache dict) per layer where the
reference stacks each layer group on a leading axis, so a port leaf is
compared with its reference counterpart over the trailing dims, and the
reference's stacked-axis entry must be None. Meshes are jax
`AbstractMesh`es: both packages read only `.shape` and `.axis_names`.
"""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import get_config as ref_config
from repro.configs import list_archs
from repro.configs.registry import SHAPES
from repro.models.model import decode_init as ref_decode_init
from repro.models.model import init_params as ref_init_params
from repro.parallel import spec_rules as ref_rules
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.input_specs import cache_shapes, param_shapes
from repro_torch.parallel import spec_rules

ARCHS = list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the reference's groups stacked on a leading axis (models/model.py _STACKED)
STACKED = ("layers", "dense_layers", "moe_layers", "mamba_layers",
           "mamba_tail", "mlstm_layers", "slstm_layers", "encoder",
           "decoder")


def _mesh(name):
    return AbstractMesh(*MESHES[name])


def _keys(path):
    return tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path)


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    """The reference's abstract parameters (its `param_shapes`)."""
    return jax.eval_shape(
        lambda: ref_init_params(jax.random.PRNGKey(0), ref_config(arch)))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """path -> (jax path, leaf) of the reference's abstract parameters."""
    return {".".join(_keys(p)): (p, leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(_ref_tree(arch))[0]}


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    """name -> shape of the port's parameters at full configuration."""
    return {n: tuple(p.shape) for n, p in
            param_shapes(get_config(arch)).named_parameters()}


@functools.lru_cache(maxsize=None)
def _caches(arch, shape_name):
    """The reference's abstract caches (path -> (jax path, leaf)), its
    batch, and the port's meta caches for the same cell."""
    # the reference's `cache_shapes` on the abstract parameters made once
    # an arch (it would trace `init_params` again for every cell)
    shape = SHAPES[shape_name]
    batch, seq = shape["global_batch"], shape["seq_len"]
    tree = jax.eval_shape(lambda: ref_decode_init(
        _ref_tree(arch), ref_config(arch), batch, seq))
    ref = {".".join(_keys(p)): (p, leaf) for p, leaf in
           jax.tree_util.tree_flatten_with_path(tree)[0]}
    port = cache_shapes(get_config(arch), batch, seq)
    return ref, batch, port


def _ref_name(name: str) -> str:
    group, _, rest = name.partition(".")
    if group in STACKED:
        return f"{group}.{rest.partition('.')[2]}"
    return name


def _norm(spec):
    """Entries as tuples of names (a PartitionSpec may carry a one-name
    tuple as the bare name; both mean the same placement)."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def _same_over_trailing(port, ref, ndim):
    port, ref = _norm(port), _norm(ref)
    assert len(port) == ndim and len(ref) >= ndim
    assert port == ref[len(ref) - ndim:]
    assert all(e is None for e in ref[:len(ref) - ndim])


class _M:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


def test_fit_drops_indivisible_axes():
    """tests/test_parallel_specs.py's `_fit` cases, on the port's tuples."""
    assert spec_rules._fit(("data", "model"), (64, 160), _M) == \
        ("data", "model")
    assert spec_rules._fit(("data", "model"), (60, 160), _M) == \
        (None, "model")
    m2 = type("M2", (), {"shape": {"pod": 2, "data": 16}})
    assert spec_rules._fit((("pod", "data"), None), (8, 4), m2) == \
        (None, None)                 # 8 % 32 != 0
    for spec, shape in (((("data", "model"),), (256, 3)),
                        (("model", None, "data"), (32, 7, 48))):
        assert _norm(spec_rules._fit(spec, shape, _M)) == \
            _norm(ref_rules._fit(P(*spec), shape, _M))


def test_cache_spec_prefers_heads_then_seq():
    """tests/test_parallel_specs.py's case on the port's (per-layer)
    layout: qwen3's kv=8 < 16 shards the sequence; divisible kv heads
    shard over 'model'."""
    cfg = smoke_config("qwen3-14b")
    spec = spec_rules.cache_spec("k", (128, 32768, 8, 128), _M, cfg, 128)
    assert spec[2] is None and spec[1] == "model"
    spec2 = spec_rules.cache_spec("k", (128, 32768, 32, 128), _M, cfg, 128)
    assert spec2[2] == "model"


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh_name):
    mesh = _mesh(mesh_name)
    ref = _ref_params(arch)
    shapes = _port_params(arch)
    for name, shape in shapes.items():
        spec = spec_rules.param_spec(name, shape, mesh)
        path, leaf = ref[_ref_name(name)]
        assert tuple(leaf.shape[len(leaf.shape) - len(shape):]) == shape
        ref_spec = ref_rules.param_spec(path, leaf, mesh)
        _same_over_trailing(spec, ref_spec, len(shape))


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh_name, shape_name):
    mesh = _mesh(mesh_name)
    rcfg, cfg = ref_config(arch), get_config(arch)
    ref, batch, caches = _caches(arch, shape_name)
    port = spec_rules.cache_shardings(caches, mesh, cfg, batch)
    leaves = {p: t for p, _, t in spec_rules.cache_leaves(caches)}
    assert port and len(port) == len(leaves)
    for path, spec in port.items():
        group, _, rest = path.partition(".")
        rpath, leaf = ref[f"{group}.{rest.partition('.')[2]}"]
        assert tuple(leaf.shape[1:]) == tuple(leaves[path].shape)
        ref_spec = ref_rules.cache_spec(rpath, leaf, mesh, rcfg, batch)
        _same_over_trailing(spec, ref_spec, leaves[path].dim())


def test_param_shardings_over_model_and_moments():
    """`param_shardings` takes a `Model` or a name -> tensor mapping (the
    AdamW moments) and gives each name its `param_spec`."""
    mesh = _mesh("16x16")
    model = param_shapes(smoke_config("deepseek-moe-16b"))
    specs = spec_rules.param_shardings(model, mesh)
    moments = {n: p for n, p in model.named_parameters()}
    assert spec_rules.param_shardings(moments, mesh) == specs
    for name, p in model.named_parameters():
        assert specs[name] == spec_rules.param_spec(name, tuple(p.shape),
                                                    mesh)


def test_batch_spec_and_local_shape():
    for name in MESHES:
        mesh = _mesh(name)
        assert _norm(spec_rules.batch_spec(mesh)) == \
            _norm(ref_rules.batch_spec(mesh))
        assert spec_rules.dp_axes(mesh) == ref_rules.dp_axes(mesh)
    mesh = _mesh("2x16x16")
    assert spec_rules.local_shape((256, 4096), (("pod", "data"), None),
                                  mesh) == (8, 4096)
    assert spec_rules.local_shape((2048, 16384), ("data", "model"),
                                  mesh) == (128, 1024)
    with pytest.raises(ValueError):
        spec_rules.local_shape((100, 8), ("data", None), mesh)
