"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1) [arXiv:2403.08295; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.common import ModelConfig


@register("gemma-2b")
def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        d_ff=16384, vocab=256000,
        head_dim=256, act="geglu",
        tie_embeddings=True,
    )


@register("gemma-2b-smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=160, vocab=256, head_dim=32, act="geglu",
    )
