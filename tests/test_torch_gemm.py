"""Parity of the PyTorch port's `dit_gemm` with the JAX reference on a 1x1
mesh: every exec mode, forward and grads, with and without a plan-carried
inner kernel; plan-driven dispatch of batched operands; and the refusal of
multi-device meshes until the port's `torch.distributed` slice.

The reference mesh uses Auto axis types (jax 0.9's `make_mesh` defaults to
Explicit axes, on which the reference's modes raise). Both sides accumulate
fp32, so fp32 tolerances scale with K: rtol 1e-5, atol 1e-5·sqrt(K).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.core import gemm as jgemm  # noqa: E402
from repro.core import lower as jlower  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro_torch.core import gemm as tgemm  # noqa: E402
from repro_torch.core import lower as tlower  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.launch.mesh import HostMesh  # noqa: E402


def jax_mesh(names):
    return jax.make_mesh((1,) * len(names), tuple(names),
                         axis_types=(AxisType.Auto,) * len(names))


def host_mesh(names):
    return HostMesh(device=torch.device("cpu"), axis_names=tuple(names),
                    shape={n: 1 for n in names})


def close(got, want, k):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-5 * math.sqrt(k))


# mode -> (mesh axes, ExecPlan axes, kwargs)
MODES = {
    "auto": (("data", "model"), {"row": "data", "col": "model"}, {}),
    "summa": (("data", "model"), {"row": "data", "col": "model"}, {}),
    "cannon": (("data", "model"), {"row": "data", "col": "model"}, {}),
    "allgather": (("data", "model"), {"row": "data", "col": "model"}, {}),
    "splitk": (("data", "model"),
               {"row": "data", "col": "model", "k": "model"},
               {"scatter": True}),
    "splitk_summa": (("data", "model", "splitk"),
                     {"row": "data", "col": "model", "k": "splitk"},
                     {"scatter": False}),
    "hierarchical": (("data", "data_in", "model", "model_in"),
                     {"row": "data", "col": "model", "inner_row": "data_in",
                      "inner_col": "model_in"}, {"inner": (1, 1)}),
    "outer_systolic": (("data", "data_in", "model", "model_in"),
                       {"row": "data", "col": "model",
                        "inner_row": "data_in", "inner_col": "model_in"},
                       {"inner": (1, 1)}),
}


def exec_plans(mode, kernel_dtype, overlap):
    """The same ExecPlan for both packages (views are None on 1x1)."""
    _, axes, kwargs = MODES[mode]
    out = []
    for mod, sched in ((jlower, jsched), (tlower, tsched)):
        ik = (None if kernel_dtype is None or mode == "auto"
              else sched.InnerKernel(8, 64, 32, dtype=kernel_dtype))
        out.append(mod.ExecPlan(mode=mode, axes=axes, kwargs=kwargs,
                                view=None, requested=mode, grid=(1, 1, 1),
                                shape=(24, 40, 96), inner_kernel=ik,
                                overlap=overlap and mode != "auto"))
    return out


# overlap only reorders the ring modes' hops; the other modes ignore it
MODE_CASES = ([(m, ik, False) for m in sorted(MODES) for ik in (None, "float32")]
              + [(m, ik, True) for m in ("cannon", "hierarchical",
                                         "outer_systolic")
                 for ik in (None, "float32")])


@pytest.mark.parametrize(
    "mode,kernel_dtype,overlap", MODE_CASES,
    ids=[f"{m}-{'ik' if ik else 'no_ik'}{'-overlap' if ov else ''}"
         for m, ik, ov in MODE_CASES])
def test_every_mode_forward_and_grads_match_reference(mode, kernel_dtype,
                                                      overlap):
    m, k, n = 24, 96, 40
    rng = np.random.default_rng(sorted(MODES).index(mode))
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    names = MODES[mode][0]
    jplan, tplan = exec_plans(mode, kernel_dtype, overlap)

    jmesh = jax_mesh(names)
    jout, vjp = jax.vjp(lambda x, y: jgemm.exec_plan_gemm(x, y, jmesh, jplan),
                        jnp.asarray(a), jnp.asarray(b))
    jga, jgb = vjp(jnp.asarray(g))

    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    tout = tgemm.exec_plan_gemm(ta, tb, host_mesh(names), tplan)
    tout.backward(torch.from_numpy(g))

    assert tout.dtype == torch.float32 and tuple(tout.shape) == (m, n)
    close(tout.detach(), jout, k)
    close(ta.grad, jga, n)
    close(tb.grad, jgb, m)


@pytest.mark.parametrize("mode", ["summa", "splitk", "cannon"])
def test_bf16_inner_kernel_mode_matches_reference(mode):
    """bf16 operands under a bf16 inner kernel: fp32 accumulation, then the
    mode's cast back to the operand dtype — one bf16 ulp apart at most."""
    m, k, n = 16, 128, 64
    rng = np.random.default_rng(21)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    jplan, tplan = exec_plans(mode, "bfloat16", False)
    names = MODES[mode][0]
    jout = jgemm.exec_plan_gemm(jnp.asarray(a, jnp.bfloat16),
                                jnp.asarray(b, jnp.bfloat16),
                                jax_mesh(names), jplan)
    tout = tgemm.exec_plan_gemm(torch.from_numpy(a).bfloat16(),
                                torch.from_numpy(b).bfloat16(),
                                host_mesh(names), tplan)
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout, np.float32)
    np.testing.assert_allclose(tout.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-5 * math.sqrt(k))


@pytest.mark.parametrize("mode", ["auto", "summa", "cannon", "splitk",
                                  "allgather"])
def test_direct_mode_dispatch_matches_reference(mode):
    """`dit_gemm(mode=...)` with batched operands (leading dims -> M)."""
    rng = np.random.default_rng(31)
    a = rng.standard_normal((2, 6, 32)).astype(np.float32)
    b = rng.standard_normal((32, 16)).astype(np.float32)
    jout = jgemm.dit_gemm(jnp.asarray(a), jnp.asarray(b),
                          jax_mesh(("data", "model")), mode=mode)
    tout = tgemm.dit_gemm(torch.from_numpy(a), torch.from_numpy(b),
                          host_mesh(("data", "model")), mode=mode)
    assert tuple(tout.shape) == (2, 6, 16)
    close(tout, jout, 32)


@pytest.mark.parametrize("dataflow", list(jsched.DATAFLOWS))
def test_schedule_dispatch_lowers_and_matches_reference(dataflow):
    """A tuned-schedule dispatch lowers identically (1x1 ExecPlan.to_dict)
    and computes the same product."""
    shape = (32, 16, 64)
    rng = np.random.default_rng(41)
    a = rng.standard_normal((shape[0], shape[2])).astype(np.float32)
    b = rng.standard_normal((shape[2], shape[1])).astype(np.float32)
    outs, plans = [], []
    for sched_mod, lower_mod, gemm_mod, mesh, conv in (
            (jsched, jlower, jgemm, jax_mesh(("data", "model")), jnp.asarray),
            (tsched, tlower, tgemm, host_mesh(("data", "model")),
             torch.from_numpy)):
        ik = sched_mod.InnerKernel(8, 16, 32, dtype="float32")
        sched = sched_mod.Schedule(
            sched_mod.GEMMShape(*shape), sched_mod.Tiling(2, 2, 4, tk=16),
            dataflow, reduce_owner="round_robin", inner_kernel=ik)
        plans.append(lower_mod.lower_schedule(sched, mesh,
                                              shape=shape).to_dict())
        outs.append(gemm_mod.dit_gemm(conv(a), conv(b), mesh, plan=sched))
    assert plans[0] == plans[1]
    close(outs[1], outs[0], shape[2])


def test_multi_device_mesh_raises():
    mesh = HostMesh(device=torch.device("cpu"), shape={"data": 2, "model": 2})
    a, b = torch.ones(8, 8), torch.ones(8, 8)
    for mode in ("auto", "summa", "cannon", "splitk", "allgather"):
        with pytest.raises(NotImplementedError, match="torch.distributed"):
            tgemm.dit_gemm(a, b, mesh, mode=mode)
    view = tlower.MeshView(splits=(("model", (("model", 1), ("splitk", 2))),))
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        view.materialize(host_mesh(("data", "model")))
