"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B; unverified] — small llama3;
counterpart of ``repro.configs.llama3_2_1b``."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    rope_theta=500000.0, tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
