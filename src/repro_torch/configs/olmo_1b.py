"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.common import ModelConfig


@register("olmo-1b")
def full() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=50304,
        norm="nonparam_ln", act="swiglu",
        tie_embeddings=True,
    )


@register("olmo-1b-smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=256, norm="nonparam_ln",
    )
