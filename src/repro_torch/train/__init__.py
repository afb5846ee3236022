"""Training of the port; counterpart of ``repro.train``.  Ported so far:
AdamW with its schedule (``optim.py``), the train-step builder with
microbatch accumulation (``step.py``) and int8 compression with error
feedback (``compress.py``)."""
from .compress import (ef_accumulate, int8_decode, int8_encode,
                       tree_int8_decode, tree_int8_encode)
from .optim import (OptConfig, adamw_update, global_norm, init_opt_state,
                    schedule)
from .step import TrainConfig, init_state, make_train_step

__all__ = ["OptConfig", "TrainConfig", "adamw_update", "ef_accumulate",
           "global_norm", "init_opt_state", "init_state", "int8_decode",
           "int8_encode", "make_train_step", "schedule", "tree_int8_decode",
           "tree_int8_encode"]
