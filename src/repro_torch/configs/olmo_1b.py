"""olmo-1b — dense MHA with non-parametric LayerNorm [arXiv:2402.00838]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab=50_304,
    nonparam_norm=True,
    act_shard="seq",
    remat="full",
)
