"""Qwen2-VL-72B [arXiv:2409.12191; hf] — VLM backbone (vision frontend is a
STUB); M-RoPE with (t,h,w) sections (16,24,24) over head_dim/2=64;
counterpart of ``repro.configs.qwen2_vl_72b``."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    mrope_sections=(16, 24, 24), rope_theta=1000000.0,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, mrope_sections=(4, 2, 2),
    param_dtype="float32", compute_dtype="float32", remat="none",
)
