"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.common import ModelConfig


@register("phi4-mini-3.8b")
def full() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=200064,
        tie_embeddings=True,
    )


@register("phi4-mini-3.8b-smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=256,
    )
