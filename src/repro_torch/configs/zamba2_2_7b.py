"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 backbone with a shared-weight
attention block applied every 6 SSM layers (54 mamba layers, 9 shared-attn
applications; simplification of the paper's shared-block schedule noted in
DESIGN.md); counterpart of ``repro.configs.zamba2_2_7b``."""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2,
                  conv_width=4, chunk=256),
    shared_every=6,
)

SMOKE = CONFIG.scaled(
    num_layers=4, shared_every=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    ssm=SSMConfig(kind="mamba2", d_state=16, head_dim=16, expand=2,
                  conv_width=4, chunk=8),
    param_dtype="float32", compute_dtype="float32", remat="none",
)
