"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40, MHA) d_ff=27392
vocab=152064 — QKV bias [hf:Qwen/Qwen1.5-0.5B family]."""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    cycle=(BlockSpec("attn", "mlp"),),
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen1.5-32b-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=256, dtype="float32",
        remat=False)
