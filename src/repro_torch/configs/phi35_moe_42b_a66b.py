"""phi3.5-moe — 16 experts top-2, GQA kv=8 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab=32_064,
    moe=MoEConfig(n_experts=16, top_k=2, shared_expert=False),
    block_pattern=("moe",),
    act_shard="seq", grad_accum=2,
    param_dtype="bfloat16", remat="full",
)
