"""Gemma-3-12B [hf:google/gemma-3-12b-pt; unverified] — 5:1 local:global
sliding-window attention, 128k context. head_dim=256 per the public config;
counterpart of ``repro.configs.gemma3_12b``."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    d_ff=15360, vocab_size=262144, head_dim=256,
    attn_pattern="local_global", window=1024, local_per_global=5,
    rope_theta=1000000.0, tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, window=16, local_per_global=5,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
