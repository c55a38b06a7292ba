"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family].

Note: head_dim is taken as d_model // num_heads = 64 per the exact assigned
config (the HF card uses 128; we follow the assignment table)."""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    rope_theta=1e6,
    cycle=(BlockSpec("attn", "moe"),),
    num_experts=128,
    experts_per_token=8,
    d_ff_expert=1536,
    source="hf:Qwen/Qwen3-30B-A3B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-moe-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=64, d_ff_expert=64, vocab_size=256,
        num_experts=4, experts_per_token=2, dtype="float32", remat=False)
