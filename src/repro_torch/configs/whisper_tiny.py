"""whisper-tiny [audio] — 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 —
enc-dec, conv frontend STUBBED: input_specs provides precomputed
(B, 1500, 384) mel/conv frame embeddings [arXiv:2212.04356]."""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,                 # decoder layers
    encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    qkv_bias=True,
    rope_theta=0.0,
    learned_pos=True,             # whisper uses learned/sinusoidal positions
    mlp_kind="gelu",
    norm_kind="layernorm",
    cycle=(BlockSpec("attn", "mlp"),),
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-tiny-smoke", num_layers=2, encoder_layers=2,
        encoder_seq=32, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
        vocab_size=256, dtype="float32", remat=False)
