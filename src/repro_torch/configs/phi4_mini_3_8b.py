"""Phi-4-mini 3.8B [arXiv:2412.08905; hf] — dense, RoPE SwiGLU GQA kv=8;
counterpart of ``repro.configs.phi4_mini_3_8b``."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064,
    rope_theta=10000.0,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
