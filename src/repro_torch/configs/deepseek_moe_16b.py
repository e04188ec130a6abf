"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts
[arXiv:2401.06066; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.common import ModelConfig


@register("deepseek-moe-16b")
def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944,                      # dense-layer FFN (first layer)
        vocab=102400,
        n_experts=64, n_shared_experts=2, moe_top_k=6, moe_d_ff=1408,
        n_dense_layers=1,
        tie_embeddings=False,
    )


@register("deepseek-moe-16b-smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=256,
        n_experts=8, n_shared_experts=2, moe_top_k=2, moe_d_ff=48,
        n_dense_layers=1,
        tie_embeddings=False,
    )
