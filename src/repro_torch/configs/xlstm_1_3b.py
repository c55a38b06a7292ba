"""xlstm-1.3b [ssm] — 48 blocks d_model=2048 4 heads d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks (1:3 cycle), no FFN sublayer [arXiv:2405.04517]."""
from repro_torch.configs.base import BlockSpec, ModelConfig

_CYCLE = (
    BlockSpec("slstm", "none"),
    BlockSpec("mlstm", "none"),
    BlockSpec("mlstm", "none"),
    BlockSpec("mlstm", "none"),
)

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    rope_theta=0.0,               # recurrent mixers need no positions
    cycle=_CYCLE,
    xlstm_num_heads=4,
    tie_embeddings=True,
    source="arXiv:2405.04517",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, vocab_size=256, xlstm_num_heads=4,
        cycle=(BlockSpec("slstm", "none"), BlockSpec("mlstm", "none")),
        dtype="float32", remat=False)
