"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.common import ModelConfig


@register("deepseek-v2-236b")
def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=12288,                      # dense-layer FFN (first layer)
        vocab=102400,
        attn="mla", kv_lora_rank=512, q_lora_rank=1536,
        rope_head_dim=64, nope_head_dim=128,
        n_experts=160, n_shared_experts=2, moe_top_k=6, moe_d_ff=1536,
        n_dense_layers=1,
        tie_embeddings=False,
    )


@register("deepseek-v2-236b-smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        attn="mla", kv_lora_rank=32, q_lora_rank=48,
        rope_head_dim=8, nope_head_dim=16,
        n_experts=8, n_shared_experts=2, moe_top_k=2, moe_d_ff=32,
        n_dense_layers=1,
        tie_embeddings=False,
    )
