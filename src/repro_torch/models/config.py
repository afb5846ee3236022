"""Model configuration; counterpart of ``repro.models.config``.

The reference's frozen dataclasses (``ModelConfig``, ``MoEConfig``,
``SSMConfig``, ``SparseFFNConfig``) and the dry-run shape cells
(``ShapeCell``, ``SHAPES``), copied so the port imports nothing of the
reference.  Their fields are the reference's, so a
reference config's ``dataclasses.asdict`` rebuilds here
(``repro_torch.interop.model_config_from_fields``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # dispatch path: "auto" applies the paper's selection logic
    # (tokens-per-expert small → one-hot/PR; large → sort-based/SR; "spmm"
    # forces the token→expert matrix through the plan/execute subsystem —
    # the ungrouped sort path routes there by itself)
    dispatch: str = "auto"          # "auto" | "onehot" | "sort" | "spmm"
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"            # "mamba2" | "rwkv6"
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 256                # SSD chunk length (train/prefill)


@dataclasses.dataclass(frozen=True)
class SparseFFNConfig:
    """The paper-as-feature: FFN weight matrices pruned to ``density`` and
    executed through the adaptive SpMM (kernel chosen per Fig. 4)."""
    density: float = 0.1
    tile: int = 512                 # nnz per balancing tile
    impl: str = "auto"              # "auto" or one of the four kernels


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // num_heads

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    sparse_ffn: Optional[SparseFFNConfig] = None

    # attention pattern
    attn_pattern: str = "full"      # full | local_global | block_sparse
    window: int = 0                 # sliding window (tokens) for local layers
    local_per_global: int = 0       # gemma3: 5 local then 1 global
    # block_sparse (DESIGN.md §10): train/prefill attention runs through the
    # fused sparse-softmax chain on a block mask built from ``window`` (token
    # window → block band; 0 → dense-fallback blocks).  Global/random block
    # counts make it a BigBird-style pattern.
    attn_block: int = 64            # block size of the attention mask
    attn_global_blocks: int = 0     # BigBird global block rows/cols
    attn_random_blocks: int = 0     # BigBird random blocks per block row

    # hybrid (zamba2): shared attention block every `shared_every` SSM layers
    shared_every: int = 0

    # enc-dec (whisper)
    encoder_layers: int = 0
    num_frames: int = 1500          # stubbed audio frontend output length

    # vlm (qwen2-vl): M-RoPE with (t, h, w) sections of head_dim/2
    mrope_sections: Tuple[int, ...] = ()

    act: str = "swiglu"             # swiglu | gelu
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logit_dtype: str = "float32"
    remat: str = "block"            # none | block | full
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0 or self.num_kv_heads == 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (see DESIGN.md §6)."""
        return (self.family in ("ssm", "hybrid")
                or self.attn_pattern in ("local_global", "block_sparse"))

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests (same family/topology, tiny dims)."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)
