"""llama3-405b — dense GQA flagship [arXiv:2407.21783].
bf16 params + bf16 AdamW moments so state fits 256×16GB v5e (DESIGN.md §5)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16_384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53_248, vocab=128_256,
    rope_theta=500_000.0,
    act_shard="seq", grad_accum=8,
    param_dtype="bfloat16", moment_dtype="bfloat16", remat="full",
)
