"""llama-3.2-vision-90b — dense GQA with interleaved cross-attention image
layers (1 per 5) [hf:meta-llama/Llama-3.2-90B-Vision].  Vision frontend is a
stub: input_specs supplies precomputed patch embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28_672, vocab=128_256,
    block_pattern=("attn", "attn", "attn", "attn", "xattn"),
    vision_tokens=1601,
    rope_theta=500_000.0,
    act_shard="seq", grad_accum=4,
    param_dtype="bfloat16", remat="full",
)
