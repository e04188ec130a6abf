"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend STUB
(input_specs supplies precomputed patch embeddings)
[hf:microsoft/Phi-3-vision-128k-instruct; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.common import ModelConfig


@register("phi-3-vision-4.2b")
def full() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064,
        frontend="vision_stub", n_prefix=576,      # 24x24 CLIP patches
        tie_embeddings=True,
    )


@register("phi-3-vision-4.2b-smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=256,
        frontend="vision_stub", n_prefix=16,
    )
