"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.common import ModelConfig


@register("qwen3-14b")
def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab=151936,
        qk_norm=True, head_dim=128,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


@register("qwen3-14b-smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=256, qk_norm=True, head_dim=16,
        tie_embeddings=False,
    )
