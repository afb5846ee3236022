"""Whisper-tiny [arXiv:2212.04356; unverified] — enc-dec; the conv frontend
is a stub (the caller gives precomputed frame embeddings (B, 1500, d));
counterpart of ``repro.configs.whisper_tiny``."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51872,  # 51865 padded to /16 for vocab TP
    encoder_layers=4, num_frames=1500, act="gelu",
    scan_layers=False,
)

SMOKE = CONFIG.scaled(
    num_layers=2, encoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16, num_frames=16,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
