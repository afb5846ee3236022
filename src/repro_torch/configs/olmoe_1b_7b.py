"""OLMoE-1B-7B [arXiv:2409.02060; hf] — 64-expert top-8 MoE, MHA (kv=16);
counterpart of ``repro.configs.olmoe_1b_7b``."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    rope_theta=10000.0,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=64,
    vocab_size=256, head_dim=16,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, capacity_factor=8.0),
    param_dtype="float32", compute_dtype="float32", remat="none",
)
