"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave, MoE every 2
layers, NO positional encoding [arXiv:2403.19887]."""
from repro_torch.configs.base import BlockSpec, ModelConfig

# one 8-layer period: attention at index 4, MoE FFN at odd indices.
_CYCLE = tuple(
    BlockSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,                # 4 groups x 8-layer cycle
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    rope_theta=0.0,               # jamba: no positional encoding
    learned_pos=False,
    cycle=_CYCLE,
    num_experts=16,
    experts_per_token=2,
    d_ff_expert=14336,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    source="arXiv:2403.19887",
)


def smoke_config() -> ModelConfig:
    cycle = tuple(
        BlockSpec("attn" if i == 2 else "mamba",
                  "moe" if i % 2 == 1 else "mlp") for i in range(4))
    return CONFIG.replace(
        name="jamba-smoke", num_layers=4, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, d_ff_expert=256, vocab_size=256,
        num_experts=4, experts_per_token=2, cycle=cycle, dtype="float32",
        remat=False)
