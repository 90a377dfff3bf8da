"""llama4-scout-17b-16e — MoE, 16 routed experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202_048,
    moe=MoEConfig(n_experts=16, top_k=1, shared_expert=True),
    block_pattern=("moe",),
    act_shard="seq", grad_accum=4,
    param_dtype="bfloat16", remat="full",
)
