"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, sliding-window 4096 [arXiv:2402.19173]."""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    qkv_bias=True,
    rope_theta=1e5,
    sliding_window=4096,          # real-model property -> runs long_500k
    mlp_kind="gelu",
    norm_kind="layernorm",
    cycle=(BlockSpec("attn", "mlp"),),
    source="arXiv:2402.19173",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="starcoder2-3b-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=256, sliding_window=16,
        dtype="float32", remat=False)
