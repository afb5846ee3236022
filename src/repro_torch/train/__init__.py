"""Training of the port; counterpart of ``repro.train``: AdamW with its
schedule (``optim.py``), the train-step builder with microbatch
accumulation and the sparse weights' shardings (``step.py``), int8
compression with error feedback (``compress.py``) and the compressed
data-parallel all-reduce over a mesh (``manual_collectives.py``)."""
from .compress import (ef_accumulate, int8_decode, int8_encode,
                       tree_int8_decode, tree_int8_encode)
from .optim import (OptConfig, adamw_update, global_norm, init_opt_state,
                    schedule)
from .manual_collectives import (compressed_psum_grads,
                                 make_dp_compressed_allreduce)
from .step import (TrainConfig, init_state, make_train_step,
                   sparse_weight_shardings)

__all__ = ["OptConfig", "TrainConfig", "adamw_update",
           "compressed_psum_grads", "ef_accumulate",
           "make_dp_compressed_allreduce", "sparse_weight_shardings",
           "global_norm", "init_opt_state", "init_state", "int8_decode",
           "int8_encode", "make_train_step", "schedule", "tree_int8_decode",
           "tree_int8_encode"]
