"""Training of the port; counterpart of ``repro.train``.  Ported so far:
AdamW with its schedule (``optim.py``) and the train-step builder with
microbatch accumulation (``step.py``)."""
from .optim import (OptConfig, adamw_update, global_norm, init_opt_state,
                    schedule)
from .step import TrainConfig, init_state, make_train_step

__all__ = ["OptConfig", "TrainConfig", "adamw_update", "global_norm",
           "init_opt_state", "init_state", "make_train_step", "schedule"]
