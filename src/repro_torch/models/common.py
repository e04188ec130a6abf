"""Model configuration + shared layer primitives.

Port of `repro/models/common.py`. `ModelConfig` is the same record with a
torch `dtype`; parameters live in `nn.Module`s whose weights keep the
reference's (K, N) layout and are applied as `x @ w` through `pmm`, so the
recorded GEMM shapes and carried weights are identical in both packages.
Layers are plain functions on tensors, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.mesh import resolve_device
from repro_torch.models.matmul import pmm


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    act: str = "swiglu"                     # swiglu | geglu | gelu
    norm: str = "rmsnorm"                   # rmsnorm | layernorm | nonparam_ln
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # attention family
    attn: str = "gqa"                       # gqa | mla
    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0                 # leading dense layers before MoE
    capacity_factor: float = 1.25
    # SSM / hybrid / xlstm
    block_pattern: str = "attn"             # attn | mamba2_hybrid | xlstm
    ssm_state: int = 0
    mamba_headdim: int = 64
    hybrid_attn_every: int = 6              # shared attn block period (zamba2)
    slstm_every: int = 8                    # sLSTM period in xlstm
    # encoder-decoder
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # modality frontend stub: prefix embeddings prepended to the sequence
    frontend: str = "none"                  # none | vision_stub | audio_stub
    n_prefix: int = 0                       # patches / frames per example
    dtype: Any = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Total parameters (for 6ND model-FLOPs accounting): the model's
        module parameters, counted on the meta device (no memory)."""
        from repro_torch.models.model import init_params
        model = init_params(None, self, device="meta")
        return sum(p.numel() for p in model.parameters())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top-k experts only)."""
        total = self.param_count()
        if not self.n_experts:
            return total
        expert = 3 * self.d_model * self.moe_d_ff  # gate+up+down per expert
        n_moe_layers = self.n_layers - self.n_dense_layers
        inactive = (self.n_experts - self.moe_top_k) * expert * n_moe_layers
        return total - inactive


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def normal(generator: Optional[torch.Generator], shape: Tuple[int, ...],
           device) -> torch.Tensor:
    """Unit normal fp32 draws from `generator` on `device`; with no
    generator (meta-device shells) an uninitialised tensor."""
    if generator is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def dense_init(generator, d_in: int, d_out: int, dtype,
               device) -> nn.Parameter:
    """A (d_in, d_out) weight — the reference's (K, N) layout, used as
    `x @ w` — drawn N(0, 1/d_in) in fp32 and cast."""
    w = normal(generator, (d_in, d_out), device) * (1.0 / math.sqrt(d_in))
    return nn.Parameter(w.to(dtype), requires_grad=False)


class Norm(nn.Module):
    """Norm parameters: an fp32 `scale`, or none for `nonparam_ln`."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.scale = (None if cfg.norm == "nonparam_ln" else nn.Parameter(
            torch.ones((cfg.d_model,), dtype=torch.float32,
                       device=resolve_device(device)),
            requires_grad=False))


def norm_params(cfg: ModelConfig, device="cuda") -> Norm:
    return Norm(cfg, device)


def apply_norm(p: Norm, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        xf = xf * p.scale
    elif cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        xf = (xf - mu) * torch.rsqrt(var + eps) * p.scale
    elif cfg.norm == "nonparam_ln":  # OLMo: no learned scale/bias
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        xf = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(cfg.norm)
    return xf.to(x.dtype)


def rms_head_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: per-head RMS normalization (Qwen3)."""
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return xf.to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given integer positions: (..., dim/2)."""
    exps = -torch.arange(0, dim, 2, dtype=torch.float32,
                         device=positions.device) / dim
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, dim); cos/sin: (..., seq, dim/2)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def activation(cfg: ModelConfig, gate: torch.Tensor,
               up: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        return F.silu(gate) * up
    if cfg.act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if cfg.act == "gelu":
        return F.gelu(gate + up, approximate="tanh")
    raise ValueError(cfg.act)


class MLP(nn.Module):
    def __init__(self, generator, cfg: ModelConfig, d_ff: Optional[int] = None,
                 device="cuda"):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        device = resolve_device(device)
        self.gate = dense_init(generator, cfg.d_model, d_ff, cfg.dtype, device)
        self.up = dense_init(generator, cfg.d_model, d_ff, cfg.dtype, device)
        self.down = dense_init(generator, d_ff, cfg.d_model, cfg.dtype, device)


def mlp_params(generator, cfg: ModelConfig, d_ff: Optional[int] = None,
               device="cuda") -> MLP:
    return MLP(generator, cfg, d_ff, device)


def apply_mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = activation(cfg, pmm(x, p.gate, tag="mlp.gate"),
                   pmm(x, p.up, tag="mlp.up"))
    return pmm(h, p.down, tag="mlp.down")
