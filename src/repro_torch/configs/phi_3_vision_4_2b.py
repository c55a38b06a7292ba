"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP vision encoder STUBBED:
input_specs provides (B, 256, 3072) projected patch embeddings occupying
the first 256 token slots [hf:microsoft/Phi-3-vision-128k-instruct]."""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=1e4,
    num_prefix_tokens=256,
    cycle=(BlockSpec("attn", "mlp"),),
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="phi3v-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=256, num_prefix_tokens=8,
        dtype="float32", remat=False)
