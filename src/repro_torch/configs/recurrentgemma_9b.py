"""recurrentgemma-9b — Griffin: RG-LRU recurrent blocks + local attention at
2:1, MQA window 2048 [arXiv:2402.19427].  Bounded state → runs long_500k."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12_288, vocab=256_000,
    block_pattern=("rglru", "rglru", "lattn"),   # 12 units + 2 remainder
    window=2048, rnn_dim=4096, conv_width=4,
    sub_quadratic=True,
    act_shard="seq", grad_accum=2,
    param_dtype="bfloat16", remat="full",
)
