"""whisper-base — enc-dec audio transformer [arXiv:2212.04356].
Conv/mel frontend is a stub: input_specs supplies 1500 precomputed frame
embeddings (assignment note)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51_865,
    encoder_layers=6, encoder_seq=1500,
    rope_theta=0.0,          # sinusoidal absolute positions
    remat="dots",
)
