"""qwen3-32b — dense GQA with per-head qk-norm [hf:Qwen/Qwen3-32B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25_600, vocab=151_936,
    qk_norm=True, rope_theta=1_000_000.0,
    act_shard="seq", grad_accum=4,
    param_dtype="bfloat16", remat="full",
)
