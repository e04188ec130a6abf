"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, d_ff=0 (the mixer carries the
up/down projections) [arXiv:2405.04517; unverified]."""
from repro_torch.configs.registry import register
from repro_torch.models.common import ModelConfig


@register("xlstm-1.3b")
def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        block_pattern="xlstm", slstm_every=8,      # 7:1 mLSTM:sLSTM
        tie_embeddings=True,
    )


@register("xlstm-1.3b-smoke")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=256,
        block_pattern="xlstm", slstm_every=2,
    )
