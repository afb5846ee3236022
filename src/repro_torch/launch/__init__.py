"""Device meshes and the sharding rules of the port; counterpart of
``repro.launch`` for what one process on one or a few cards can run:
``mesh.py`` (``Mesh``, ``make_local_mesh``) and ``sharding_rules.py`` (the
logical-axis rules, ``PartitionSpec``).  The reference's production mesh,
its TPU roofline constants, the dry run and the launcher are not ported."""
from .mesh import Mesh, make_local_mesh
from .sharding_rules import (LONG_CTX_OVERRIDES, SPARSE_WEIGHT_RULES,
                             TRAIN_RULES, NamedSharding, PartitionSpec,
                             check_divisibility, make_sharding_fn,
                             partition_spec, resolve_rules)

__all__ = ["Mesh", "make_local_mesh", "TRAIN_RULES", "LONG_CTX_OVERRIDES",
           "SPARSE_WEIGHT_RULES", "NamedSharding", "PartitionSpec",
           "check_divisibility", "make_sharding_fn", "partition_spec",
           "resolve_rules"]
