"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512 vocab=49155, MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base
family]. The assignment line says 40 experts (bracket note says 32); we
follow the explicit field."""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    rope_theta=1e4,
    tie_embeddings=True,
    cycle=(BlockSpec("attn", "moe"),),
    num_experts=40,
    experts_per_token=8,
    d_ff_expert=512,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="granite-moe-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=64, d_ff_expert=64, vocab_size=256,
        num_experts=4, experts_per_token=2, dtype="float32", remat=False)
