"""mistral-nemo-12b — dense GQA, 128k context [hf:mistralai/Mistral-Nemo-Base-2407]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab=131_072,
    rope_theta=1_000_000.0,
    act_shard="seq", grad_accum=2,
    param_dtype="bfloat16", remat="full",
)
