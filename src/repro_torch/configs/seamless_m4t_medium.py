"""seamless-m4t-medium [audio] — encoder-decoder transformer backbone; the
speech frontend is a STUB (input_specs supplies precomputed frame embeddings)
[arXiv:2308.11596; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.common import ModelConfig


@register("seamless-m4t-medium")
def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=256206,
        is_encoder_decoder=True, n_encoder_layers=12,
        frontend="audio_stub", n_prefix=960,       # audio frames per utterance
        norm="layernorm", act="gelu",
        tie_embeddings=True,
    )


@register("seamless-m4t-medium-smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=256,
        is_encoder_decoder=True, n_encoder_layers=2,
        frontend="audio_stub", n_prefix=24,
        norm="layernorm", act="gelu",
    )
