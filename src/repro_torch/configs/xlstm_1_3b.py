"""xlstm-1.3b — mLSTM (matrix-memory, chunkwise-parallel) + sLSTM blocks at
7:1 [arXiv:2405.04517].  Constant-size state → runs long_500k decode."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab=50_304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    sub_quadratic=True,
    act_shard="seq", grad_accum=2,
    remat="full",
)
