"""State-space / recurrent mixers: Mamba2 (SSD chunked scan), mLSTM and sLSTM
(xLSTM).

Port of `repro/models/ssm.py`. Training and prefill use the chunked
parallel forms, decode carries O(1) recurrent state. The in/out
projections are regular GEMMs and go through `pmm`; the scans are not
GEMMs and stay outside `mmad`, as in the reference, which keeps them out of
DiT scheduling. The reference's `jax.lax.scan`s over chunks and over time
steps are Python loops here.

Precision: the recurrences and the state are fp32, as the reference keeps
them (its SSD products are marked `preferred_element_type=float32`): every
`torch.einsum` here takes fp32 operands (bf16 values cast exactly), so with
TF32 off the chunked and recurrent forms sum the same products at the same
precision. `a_log`, `d_skip`, `dt_bias`, `w_gates` and sLSTM's `r` are
fp32 parameters; the rest are `cfg.dtype`.

Decode state in place: a recurrent step updates Mamba2's `h` and mLSTM's
`c` and `n` in place (`mul_` then `add_`, the reference's `g * h + u`
with the same two roundings in the same order), so a step allocates no
state-sized memory for its largest tensors; the caller's state dict shares
them. The small ones (the conv window, `m`, and sLSTM's four) are new
tensors each step. Where autograd records the recurrent forms (a
differentiated decode), they update out of place, with the same roundings.
The state updates run inside profiler spans (`mamba.state`, `mlstm.state`,
`slstm.state`) while a profiler runs.

Gradients: every `exp` whose argument can grow takes it masked first (the
SSD's within-chunk decay, the mLSTM's log-weights), so no masked-out
overflow reaches a backward as 0 x inf. The reference masks the SSD's
decay after its `exp`, and its gradients are NaN at a chunk of 128
(ROADMAP.md, queue 3's port-side decisions).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.mesh import resolve_device
from repro_torch.models import accounting
from repro_torch.models.common import ModelConfig, dense_init, normal, silu
from repro_torch.models.matmul import pmm
from repro_torch.obs.trace import profile_scope

CHUNK = 128
NEG_STAB = -1e30              # mLSTM / sLSTM initial stabiliser


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

class Mamba2(nn.Module):
    """`w_in` (d, 2 d_inner + 2 n + heads), the fused in-projection of [z,
    x, B, C, dt]; `conv` (4, d_inner + 2 n); fp32 `a_log`, `d_skip`,
    `dt_bias` (heads); `w_out` (d_inner, d)."""

    def __init__(self, generator, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        d = cfg.d_model
        d_inner = 2 * d
        n_heads = d_inner // cfg.mamba_headdim
        n = cfg.ssm_state
        self.w_in = dense_init(generator, d, 2 * d_inner + 2 * n + n_heads,
                               cfg.dtype, device)
        self.conv = _param((normal(generator, (4, d_inner + 2 * n), device)
                            * 0.1).to(cfg.dtype))
        self.a_log = _param(torch.zeros((n_heads,), dtype=torch.float32,
                                        device=device))
        self.d_skip = _param(torch.ones((n_heads,), dtype=torch.float32,
                                        device=device))
        self.dt_bias = _param(torch.zeros((n_heads,), dtype=torch.float32,
                                          device=device))
        self.w_out = dense_init(generator, d_inner, d, cfg.dtype, device)


def mamba2_params(generator, cfg: ModelConfig, device="cuda") -> Mamba2:
    return Mamba2(generator, cfg, device)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, kernel 4. x: (B, S, C); state: (B, 3, C). The
    taps are summed in x's dtype in the reference's order, from the first."""
    k = w.shape[0]
    s = x.shape[1]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device) if state is None else state)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return silu(out), xp[:, -(k - 1):]


def _recorded(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an update of these tensors (then the
    recurrent forms update their state out of place)."""
    return any(t.requires_grad for t in tensors)


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. xh: (B,S,H,P); dt: (B,S,H) fp32; a: (H) negative; b/c:
    (B,S,N). Returns (y: (B,S,H,P) in xh's dtype, final state (B,H,N,P)
    fp32). One chunk at a time: its within-chunk decay matrix, its summary
    and the state carried in from the chunks before it."""
    bb, s, h, p = xh.shape
    n = b.shape[-1]
    L = min(accounting.chunk(CHUNK), s)
    nc = s // L
    assert nc * L == s, f"seq {s} must divide by chunk {L}"

    la = dt * a[None, None, :]                       # log-decay per step
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))
    hstate = (torch.zeros((bb, h, n, p), dtype=torch.float32, device=xh.device)
              if h0 is None else h0.float())
    ys = []
    for z in range(nc):
        span = slice(z * L, (z + 1) * L)
        xz, dtz = xh[:, span].float(), dt[:, span]
        bz, cz = b[:, span].float(), c[:, span].float()
        cum = torch.cumsum(la[:, span], dim=1)       # (B,L,H) inclusive
        # within the chunk: y_j = sum_{i<=j} exp(cum_j - cum_i) (C_j.B_i)
        # dt_i x_i
        att = torch.einsum("bjn,bin->bji", cz, bz)                # (B,L,L)
        decay = cum[:, :, None, :] - cum[:, None, :, :]           # (B,L,L,H)
        # masked before the exponential: above the diagonal `decay` is a
        # sum of positive log-decays that overflows exp over a long chunk,
        # and the backward of where(mask, exp(decay), 0) would then take
        # 0 x inf = NaN; exp(-inf) is exactly the 0 the forward wants
        w = torch.exp(torch.where(mask[None, :, :, None], decay, -torch.inf))
        w = w * att[..., None]
        y_intra = torch.einsum("bjih,bih,bihp->bjhp", w, dtz, xz)
        # its summary: S_z = sum_i exp(cum_last - cum_i) dt_i (B_i x x_i)
        tail = torch.exp(cum[:, -1:, :] - cum)                    # (B,L,H)
        s_z = torch.einsum("bih,bih,bin,bihp->bhnp", tail, dtz, bz, xz)
        # from the chunks before: y_j += exp(cum_j) C_j . h_prev
        y_inter = torch.einsum("bjh,bjn,bhnp->bjhp", torch.exp(cum), cz,
                               hstate)
        ys.append(y_intra + y_inter)
        # carried: h_z = exp(cum_last) h_{z-1} + S_z
        hstate = torch.exp(cum[:, -1, :])[..., None, None] * hstate + s_z
    y = torch.cat(ys, dim=1)
    return y.to(xh.dtype), hstate


def _ssd_recurrent(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, h: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact scan, one step per token: h = exp(dt a) h + dt (B x x), y =
    C . h. `h` (B,H,N,P) fp32 is updated in place, unless autograd records
    the step (each step's h is then saved for the backward, so each is a
    new tensor, with the same two roundings). Returns (y (B,S,H,P) fp32,
    h)."""
    ys = []
    for t in range(xh.shape[1]):
        dtt = dt[:, t]
        g = torch.exp(dtt * a)                                     # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhnp", dtt, b[:, t].float(),
                           xh[:, t].float())
        if _recorded(h, g, upd):
            h = h * g[..., None, None] + upd
        else:
            h.mul_(g[..., None, None]).add_(upd)
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t].float(), h))
    return torch.stack(ys, dim=1), h


def mamba2_mixer(p: Mamba2, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B,S,D). With `state`, runs recurrently (decode, any S>=1)."""
    bsz, s, d = x.shape
    d_inner = 2 * d
    n = cfg.ssm_state
    h = d_inner // cfg.mamba_headdim
    ph = cfg.mamba_headdim

    proj = pmm(x, p.w_in, tag="mamba.in")
    z, xr, b, c, dt = torch.split(proj, [d_inner, d_inner, n, n, h], dim=-1)
    with profile_scope("mamba.state"):
        conv_in = torch.cat([xr, b, c], dim=-1)
        conv_out, conv_state = _causal_conv(
            conv_in, p.conv, None if state is None else state["conv"])
        xr, b, c = torch.split(conv_out, [d_inner, n, n], dim=-1)
        dt = F.softplus(dt.float() + p.dt_bias)                    # (B,S,H)
        a = -torch.exp(p.a_log)                                    # (H,)
        xh = xr.reshape(bsz, s, h, ph)
        if state is None:
            y, _ = _ssd_chunked(xh, dt, a, b, c)
            new_state = None
        else:
            y, hlast = _ssd_recurrent(xh, dt, a, b, c, state["h"])
            y = y.to(x.dtype)
            new_state = {"h": hlast, "conv": conv_state}

    y = y + xh * p.d_skip[None, None, :, None].to(x.dtype)
    y = y.reshape(bsz, s, d_inner) * silu(z)
    return pmm(y, p.w_out, tag="mamba.out"), new_state


def mamba2_state(cfg: ModelConfig, batch: int,
                 device="cuda") -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    d_inner = 2 * cfg.d_model
    h = d_inner // cfg.mamba_headdim
    return {
        "h": torch.zeros((batch, h, cfg.ssm_state, cfg.mamba_headdim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, 3, d_inner + 2 * cfg.ssm_state),
                            dtype=cfg.dtype, device=device),
    }


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """`w_up` (d, 2 d_inner) of [u, gate]; `w_q`, `w_k`, `w_v` (d_inner,
    d_inner); fp32 `w_gates` (d, 2 heads) of the input and forget gates'
    pre-activations; `w_down` (d_inner, d)."""

    def __init__(self, generator, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        d = cfg.d_model
        d_inner = 2 * d
        self.w_up = dense_init(generator, d, 2 * d_inner, cfg.dtype, device)
        self.w_q = dense_init(generator, d_inner, d_inner, cfg.dtype, device)
        self.w_k = dense_init(generator, d_inner, d_inner, cfg.dtype, device)
        self.w_v = dense_init(generator, d_inner, d_inner, cfg.dtype, device)
        self.w_gates = dense_init(generator, d, 2 * cfg.n_heads,
                                  torch.float32, device)
        self.w_down = dense_init(generator, d_inner, d, cfg.dtype, device)


def mlstm_params(generator, cfg: ModelConfig, device="cuda") -> MLSTM:
    return MLSTM(generator, cfg, device)


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """A Python scalar as the reference applies it to a `dtype` array: JAX
    casts the weakly typed scalar to the array's dtype first."""
    return float(torch.tensor(value, dtype=dtype))


def _mlstm_chunked(q, k, v, i_pre, logf):
    """The chunkwise-stabilised parallel form: within each chunk an (L x L)
    decay matrix, across chunks the carried (C, n, m) state, never the
    (S x S) matrix. q, k, v: (B,S,H,hd); i_pre, logf: (B,S,H) fp32.
    Returns y (B,S,H,hd) fp32."""
    bsz, s, h, hd = q.shape
    L = min(accounting.chunk(CHUNK), s)
    nc = s // L
    assert nc * L == s, f"seq {s} must divide by chunk {L}"
    dev = q.device
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
    ch = torch.zeros((bsz, h, hd, hd), dtype=torch.float32, device=dev)
    nh = torch.zeros((bsz, h, hd), dtype=torch.float32, device=dev)
    mc = torch.full((bsz, h), NEG_STAB, dtype=torch.float32, device=dev)
    ys = []
    for z in range(nc):
        span = slice(z * L, (z + 1) * L)
        qz, kz, vz = q[:, span].float(), k[:, span].float(), v[:, span].float()
        iz, fz = i_pre[:, span], logf[:, span]
        cum = torch.cumsum(fz, dim=1)                # (B,L,H) inclusive
        # intra-chunk log-weights: F_j - F_i + i_i  (i <= j)
        dlog = cum[:, :, None, :] - cum[:, None, :, :] + iz[:, None, :, :]
        dlog = torch.where(tril[None, :, :, None], dlog, -torch.inf)
        m_intra = dlog.amax(dim=2)                   # (B,L,H)
        m_inter = cum + mc[:, None, :]
        m_j = torch.maximum(m_intra, m_inter)
        w = torch.exp(dlog - m_j[:, :, None, :])     # (B,L,L,H)
        att = torch.einsum("bjhd,bihd->bjih", qz, kz)
        num = torch.einsum("bjih,bjih,bihd->bjhd", att, w, vz)
        den = torch.einsum("bjih,bjih->bjh", att, w)
        # the carried state's contribution
        g_j = torch.exp(m_inter - m_j)               # (B,L,H)
        num = num + g_j[..., None] * torch.einsum("bjhd,bhde->bjhe", qz, ch)
        den = den + g_j * torch.einsum("bjhd,bhd->bjh", qz, nh)
        ys.append(num / torch.maximum(den.abs(), torch.exp(-m_j))[..., None])
        # carry to the end of the chunk
        last = cum[:, -1, :]                         # (B,H)
        tail = last[:, None, :] - cum + iz           # (B,L,H)
        m_new = torch.maximum(last + mc, tail.amax(dim=1))
        wu = torch.exp(tail - m_new[:, None, :])
        gain = torch.exp(last + mc - m_new)
        ch = (gain[..., None, None] * ch
              + torch.einsum("bih,bihd,bihe->bhde", wu, kz, vz))
        nh = gain[..., None] * nh + torch.einsum("bih,bihd->bhd", wu, kz)
        mc = m_new
    return torch.cat(ys, dim=1)


def _mlstm_recurrent(q, k, v, i_pre, logf, cm, nv, mm):
    """One step per token. `cm` (B,H,hd,hd) and `nv` (B,H,hd) are updated in
    place, unless autograd records the step (as `_ssd_recurrent`). Returns
    (y (B,S,H,hd) fp32, (cm, nv, m))."""
    ys = []
    for t in range(q.shape[1]):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        it, lft = i_pre[:, t], logf[:, t]
        mnew = torch.maximum(lft + mm, it)
        fi = torch.exp(lft + mm - mnew)
        ii = torch.exp(it - mnew)
        outer = torch.einsum("bhd,bhe->bhde", kt, vt)
        if _recorded(cm, nv, fi, ii, outer):
            cm = cm * fi[..., None, None] + outer * ii[..., None, None]
            nv = nv * fi[..., None] + ii[..., None] * kt
        else:
            cm.mul_(fi[..., None, None]).add_(outer.mul_(ii[..., None, None]))
            nv.mul_(fi[..., None]).add_(ii[..., None] * kt)
        num = torch.einsum("bhd,bhde->bhe", qt, cm)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qt, nv).abs(),
                            torch.exp(-mnew))
        ys.append(num / den[..., None])
        mm = mnew
    return torch.stack(ys, dim=1), (cm, nv, mm)


def mlstm_mixer(p: MLSTM, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Parallel (stabilised) form for training/prefill; recurrent for
    decode."""
    bsz, s, d = x.shape
    h = cfg.n_heads
    d_inner = 2 * d
    hd = d_inner // h

    up = pmm(x, p.w_up, tag="mlstm.up")
    u, gate = torch.split(up, d_inner, dim=-1)
    q = pmm(u, p.w_q, tag="mlstm.q").reshape(bsz, s, h, hd)
    k = (pmm(u, p.w_k, tag="mlstm.k").reshape(bsz, s, h, hd)
         * _in_dtype(hd ** -0.5, x.dtype))
    v = pmm(u, p.w_v, tag="mlstm.v").reshape(bsz, s, h, hd)
    gates = pmm(x.float(), p.w_gates, tag="mlstm.gates").reshape(bsz, s, h, 2)
    with profile_scope("mlstm.state"):
        i_pre, f_pre = gates[..., 0], gates[..., 1]
        logf = F.logsigmoid(f_pre)                                 # (B,S,H)
        if state is None:
            y = _mlstm_chunked(q, k, v, i_pre, logf)
            new_state = None
        else:
            y, (cm, nv, mm) = _mlstm_recurrent(q, k, v, i_pre, logf,
                                               state["c"], state["n"],
                                               state["m"])
            new_state = {"c": cm, "n": nv, "m": mm}
        y = y.to(x.dtype)

    y = y.reshape(bsz, s, d_inner) * silu(gate)
    return pmm(y, p.w_down, tag="mlstm.down"), new_state


def mlstm_state(cfg: ModelConfig, batch: int,
                device="cuda") -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    h = cfg.n_heads
    hd = 2 * cfg.d_model // h
    return {
        "c": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), NEG_STAB, dtype=torch.float32,
                        device=device),
    }


class SLSTM(nn.Module):
    """`w_in` (d, 4 d) of the i, f, z, o pre-activations; fp32 `r` (heads,
    hd, 4 hd), the block-diagonal recurrence; `w_out` (d, d)."""

    def __init__(self, generator, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        d = cfg.d_model
        h = cfg.n_heads
        hd = d // h
        self.w_in = dense_init(generator, d, 4 * d, cfg.dtype, device)
        self.r = _param(normal(generator, (h, hd, 4 * hd), device)
                        * hd ** -0.5)
        self.w_out = dense_init(generator, d, d, cfg.dtype, device)


def slstm_params(generator, cfg: ModelConfig, device="cuda") -> SLSTM:
    return SLSTM(generator, cfg, device)


def _slstm_scan(pre_all: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                n: torch.Tensor, m: torch.Tensor, hid: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The sLSTM recurrence, one step per token. pre_all: (B,S,H,4 hd)
    fp32 pre-activations of [i, f, z, o]; r (H,hd,4 hd); c, n, m, hid
    (B,H,hd) fp32, the state before the first step. Returns (y (B,S,H,hd)
    fp32, (c, n, m, hid) after the last)."""
    hd = hid.shape[-1]
    ys = []
    for t in range(pre_all.shape[1]):
        rec = torch.einsum("bhd,hde->bhe", hid, r)
        it, ft, zt, ot = torch.split(pre_all[:, t] + rec, hd, dim=-1)
        mnew = torch.maximum(ft + m, it)
        i = torch.exp(it - mnew)
        f = torch.exp(ft + m - mnew)
        c = f * c + i * torch.tanh(zt)
        n = f * n + i
        hid = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
        m = mnew
        ys.append(hid)
    return torch.stack(ys, dim=1), (c, n, m, hid)


def slstm_mixer(p: SLSTM, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Strictly recurrent (block-diagonal recurrence), one step per token."""
    bsz, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    pre_all = pmm(x, p.w_in, tag="slstm.in").reshape(bsz, s, h, 4 * hd).float()
    with profile_scope("slstm.state"):
        if state is None:
            zero = torch.zeros((bsz, h, hd), dtype=torch.float32,
                               device=x.device)
            m = torch.full((bsz, h, hd), NEG_STAB, dtype=torch.float32,
                           device=x.device)
            y, (c, n, m, hid) = _slstm_scan(pre_all, p.r, zero, zero, m, zero)
        else:
            y, (c, n, m, hid) = _slstm_scan(pre_all, p.r, state["c"],
                                            state["n"], state["m"],
                                            state["h"])
        y = y.reshape(bsz, s, d).to(x.dtype)
    new_state = None if state is None else {"c": c, "n": n, "m": m, "h": hid}
    return pmm(y, p.w_out, tag="slstm.out"), new_state


def slstm_state(cfg: ModelConfig, batch: int,
                device="cuda") -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    h = cfg.n_heads
    hd = cfg.d_model // h

    def zeros():
        return torch.zeros((batch, h, hd), dtype=torch.float32, device=device)

    return {"c": zeros(), "n": zeros(),
            "m": torch.full((batch, h, hd), NEG_STAB, dtype=torch.float32,
                            device=device),
            "h": zeros()}
