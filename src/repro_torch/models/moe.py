"""Mixture-of-Experts layer (DeepSeek-V2 / DeepSeekMoE style: fine-grained
routed experts + always-on shared experts, top-k routing).

Port of `repro/models/moe.py`. Dispatch is the reference's capacity-bounded
one-hot einsum (Switch-style): every expert GEMM is a regular (E, capacity,
d) x (E, d, f) batched matmul — the irregular-N GEMM class the paper's
Insight 3 routes to split-K schedules — and overflowing tokens are dropped
(capacity_factor bounds the buffer). The router and the shared experts are
dense GEMMs and go through `pmm`; the expert einsums stay `torch.einsum`
(the reference computes them outside Pallas too) and are recorded with
`record_gemm` under the reference's tags, so the observed workload matches
`deploy.planner.model_workload`.

At decode this dispatch multiplies every expert's weights, even for a few
tokens: it reads all E experts where top-k would need k of them (PERF.md
§7 queues that finding).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.mesh import resolve_device
from repro_torch.models import shard_ctx
from repro_torch.models.common import (ModelConfig, activation, dense_init,
                                       mlp_params, normal)
from repro_torch.models.matmul import pmm, record_gemm
from repro_torch.obs.trace import get_tracer, profile_scope, profiling


class Experts(nn.Module):
    """Stacked routed experts: `gate`/`up` (E, d, f), `down` (E, f, d)."""

    def __init__(self, generator, cfg: ModelConfig, device="cuda"):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        device = resolve_device(device)

        def stack(shape, scale):
            w = normal(generator, shape, device) * scale
            return nn.Parameter(w.to(cfg.dtype), requires_grad=False)

        self.gate = stack((e, d, f), d ** -0.5)
        self.up = stack((e, d, f), d ** -0.5)
        self.down = stack((e, f, d), f ** -0.5)


class MoE(nn.Module):
    """`router` (d, E) fp32, `experts`, and the shared experts as an MLP of
    width moe_d_ff * n_shared_experts (None without shared experts)."""

    def __init__(self, generator, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.router = dense_init(generator, cfg.d_model, cfg.n_experts,
                                 torch.float32, device)
        self.experts = Experts(generator, cfg, device)
        self.shared = (mlp_params(generator, cfg,
                                  d_ff=cfg.moe_d_ff * cfg.n_shared_experts,
                                  device=device)
                       if cfg.n_shared_experts else None)


def moe_params(generator, cfg: ModelConfig, device="cuda") -> MoE:
    return MoE(generator, cfg, device)


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cap, 4)


_GROUP_TOKENS = 512   # dispatch-group size, as the reference's: the einsum
                      # dispatch costs O(E * cap) = O(k * cf * GROUP_TOKENS)
                      # MACs per token whatever the global batch


def _dp_groups(t: int) -> int:
    """Dispatch groups of the `t` tokens this rank routes: fixed-size token
    groups with per-group capacity, their count a multiple of the
    data-parallel shard count of the installed mesh (1 with none, and on
    the 1x1 mesh). The same rule as `deploy.planner.moe_dispatch_geometry`,
    applied to the global batch: when the batch splits over pods
    (`shard_ctx.batch_pods`), this pod's tokens are a contiguous share of
    it and take the same share of its groups, so each group holds the
    tokens, and the capacity, of the reference's."""
    mesh = shard_ctx.get_mesh()
    dp = 1
    if mesh is not None:
        for a in ("pod", "data"):
            if a in mesh.axis_names:
                dp *= mesh.shape[a]
    pods = shard_ctx.batch_pods()
    whole = t * pods
    if whole % dp:
        dp = 1
    g = dp
    while whole % (g * 2) == 0 and whole // (g * 2) >= _GROUP_TOKENS:
        g *= 2
    if g % pods:
        raise ValueError(f"{g} dispatch groups of {whole} tokens do not "
                         f"split over {pods} pods")
    return g // pods


def _constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's sharding constraint on the dispatch tensors. Eager
    PyTorch on one device has no sharding to pin, so it is the identity
    (as `shard_ctx.constrain_tokens`)."""
    return x


def route(p: MoE, xt: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router -> softmax -> top-k -> renormalised weights. xt: (G, TL, D)
    -> (topv, topi), each (G, TL, k). The router GEMM is fp32 through
    `pmm`. Ties go to the lower expert index, as `jax.lax.top_k` breaks
    them: a stable descending sort, not `torch.topk`, whose order among
    equal values is unspecified."""
    gates = torch.softmax(pmm(xt.float(), p.router, tag="moe.router"),
                          dim=-1)                                  # (G,TL,E)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return topv, topi


def dispatch_slots(topi: torch.Tensor, e: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each (token, choice)'s position inside its expert's per-group buffer,
    in (token, choice) order: (onehot (G,TL,k,E) int, within (G,TL,k) —
    False where the buffer overflowed and the choice is dropped — and the
    clipped position (G,TL,k))."""
    g, tl, k = topi.shape
    onehot = F.one_hot(topi, e).to(torch.int32)                    # (G,TL,k,E)
    flat = onehot.reshape(g, tl * k, e)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) * flat - 1
    pos_tk = (pos.reshape(g, tl, k, e) * onehot).sum(-1)           # (G,TL,k)
    within = (pos_tk >= 0) & (pos_tk < cap)
    return onehot, within, torch.clamp(pos_tk, 0, cap - 1)


def _count_drops(within: torch.Tensor) -> None:
    """While a profiler runs, add to the installed tracer's `moe.pairs` the
    (token, choice) pairs routed and to `moe.dropped` those past their
    expert's capacity (`within` false), the latter as a 0-d device tensor,
    so nothing is read back to the host during the step."""
    tracer = get_tracer()
    if tracer is None or not profiling():
        return
    tracer.metrics.counter("moe.pairs").inc(within.numel())
    tracer.metrics.counter("moe.dropped").inc((~within).sum())


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    g = _dp_groups(t)
    tl = t // g
    cap = _capacity(tl, cfg)
    xt = _constrain(x.reshape(g, tl, d), "dp", None, None)

    topv, topi = route(p, xt, cfg)
    onehot, within, pos_c = dispatch_slots(topi, e, cap)
    _count_drops(within)

    # one-hot einsum dispatch (the reference's: every op a dense
    # contraction, so it stays SPMD-friendly across an expert axis); expert
    # GEMMs batched over (G, E), each logical (cap, d) x (d, f) problem
    # logged for the observed workload, its widths from `cfg` (a read of a
    # sharded weight, its shape's too, gathers it whole)
    experts = p.experts
    record_gemm("moe.expert_gate", cap, cfg.moe_d_ff, d)
    record_gemm("moe.expert_down", cap, d, cfg.moe_d_ff)
    with profile_scope("moe.einsums"):
        oh_cap = F.one_hot(pos_c, cap).to(x.dtype)                # (G,TL,k,cap)
        sel = onehot.to(x.dtype) * within[..., None].to(x.dtype)  # (G,TL,k,E)
        disp = torch.einsum("gtke,gtkc->gtec", sel, oh_cap)       # (G,TL,E,cap)
        disp = _constrain(disp, "dp", None, "model", None)
        comb = torch.einsum("gtke,gtkc->gtec", sel.float() * topv[..., None],
                            oh_cap.float())
        comb = _constrain(comb, "dp", None, "model", None)
        xe = torch.einsum("gtec,gtd->gecd", disp, xt)             # (G,E,cap,D)
        xe = _constrain(xe, "dp", "model", None, None)
        h = activation(cfg, torch.einsum("gecd,edf->gecf", xe, experts.gate),
                       torch.einsum("gecd,edf->gecf", xe, experts.up))
        h = _constrain(h, "dp", "model", None, None)
        ye = torch.einsum("gecf,efd->gecd", h, experts.down)      # (G,E,cap,D)
        ye = _constrain(ye, "dp", "model", None, None)
        out = torch.einsum("gtec,gecd->gtd", comb.to(x.dtype), ye)
        out = _constrain(out, "dp", None, None)

    if p.shared is not None:
        sh = activation(cfg, pmm(xt, p.shared.gate, tag="moe.shared_gate"),
                        pmm(xt, p.shared.up, tag="moe.shared_up"))
        out = out + pmm(sh, p.shared.down, tag="moe.shared_down")
    return out.reshape(b, s, d)
