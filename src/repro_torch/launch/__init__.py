"""Device meshes, sharding rules and the launch tooling of the port;
counterpart of ``repro.launch``: ``mesh.py`` (``Mesh``, ``make_local_mesh``,
``make_production_mesh`` on meta devices, the H100's roofline constants),
``sharding_rules.py`` (the logical-axis rules, ``PartitionSpec``),
``cost_model.py`` (the analytic FLOPs and HBM bytes of a cell),
``analysis.py`` (roofline terms, collective wire bytes by link),
``input_specs.py`` (a cell's step and its meta-tensor stand-ins),
``dryrun.py`` and ``diagnose.py`` (every cell on the production meshes, on
meta tensors) and ``train.py`` (the training launcher, on the card).
The submodules ``dryrun``, ``diagnose`` and ``train`` are run with
``python -m`` and imported by name."""
from . import analysis, cost_model, input_specs
from .analysis import Roofline, collective_bytes, roofline_terms, summarize
from .cost_model import CellCost, cell_cost
from .input_specs import build_cell, finalize_rules, rules_for_cell
from .mesh import (H100, V5E, Hardware, Mesh, make_local_mesh,
                   make_production_mesh)
from .sharding_rules import (LONG_CTX_OVERRIDES, SPARSE_WEIGHT_RULES,
                             TRAIN_RULES, NamedSharding, PartitionSpec,
                             check_divisibility, make_sharding_fn,
                             partition_spec, resolve_rules)

__all__ = ["Mesh", "make_local_mesh", "make_production_mesh", "Hardware",
           "H100", "V5E", "TRAIN_RULES", "LONG_CTX_OVERRIDES",
           "SPARSE_WEIGHT_RULES", "NamedSharding", "PartitionSpec",
           "check_divisibility", "make_sharding_fn", "partition_spec",
           "resolve_rules", "CellCost", "cell_cost", "Roofline",
           "collective_bytes", "roofline_terms", "summarize", "build_cell",
           "finalize_rules", "rules_for_cell", "analysis", "cost_model",
           "input_specs"]
