"""Kimi K2 1T-A32B [arXiv:2501.kimi2; unverified, paper-table] — 384-expert
top-8 MoE, GQA kv=8. The EP/WB stress case: 1T params, 61 layers;
counterpart of ``repro.configs.kimi_k2_1t_a32b``."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048),
    rope_theta=50000.0,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=64,
    vocab_size=256, head_dim=16,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, capacity_factor=8.0),
    param_dtype="float32", compute_dtype="float32", remat="none",
)
