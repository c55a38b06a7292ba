"""qwen1.5-4b [dense] — 40L d_model=2560 20H (kv=20, MHA) d_ff=6912
vocab=151936 — QKV bias [hf:Qwen/Qwen1.5-0.5B family]."""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    cycle=(BlockSpec("attn", "mlp"),),
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen1.5-4b-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=256, dtype="float32",
        remat=False)
