"""Logical-axis → mesh-axis rules; counterpart of
``repro.launch.sharding_rules``.  The tables and ``PartitionSpec`` /
``NamedSharding`` live in ``dist/sharding_rules.py``, below the models,
the train step and the placed runtime that read them; this module is their
name under the reference's path."""
from ..dist.sharding_rules import (LONG_CTX_OVERRIDES, SPARSE_WEIGHT_RULES,
                                   TRAIN_RULES, NamedSharding, PartitionSpec,
                                   check_divisibility, make_sharding_fn,
                                   partition_spec, resolve_rules)

__all__ = ["LONG_CTX_OVERRIDES", "SPARSE_WEIGHT_RULES", "TRAIN_RULES",
           "NamedSharding", "PartitionSpec", "check_divisibility",
           "make_sharding_fn", "partition_spec", "resolve_rules"]
