"""RWKV-6 (Finch) 3B [arXiv:2404.05892; hf] — attention-free, data-dependent
decay. 40 heads x 64 head_dim; counterpart of ``repro.configs.rwkv6_3b``."""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=8960, vocab_size=65536, head_dim=64,
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16,
    ssm=SSMConfig(kind="rwkv6", head_dim=16),
    param_dtype="float32", compute_dtype="float32", remat="none",
)
