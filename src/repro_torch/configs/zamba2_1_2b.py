"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.common import ModelConfig


@register("zamba2-1.2b")
def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32000,
        block_pattern="mamba2_hybrid", ssm_state=64, mamba_headdim=64,
        hybrid_attn_every=6,
        tie_embeddings=True,
    )


@register("zamba2-1.2b-smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=256,
        block_pattern="mamba2_hybrid", ssm_state=16, mamba_headdim=16,
        hybrid_attn_every=2,
    )
