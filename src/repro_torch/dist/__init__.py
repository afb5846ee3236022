"""Dense tensors laid out over a device mesh, below the models, the train
step and the checkpoints that read them: ``sharding_rules.py`` (the
logical-axis → mesh-axis rules, ``PartitionSpec``, ``NamedSharding``) and
``placement.py`` (``Placed``, ``device_put`` / ``device_get``, each
position's local view).  The weight-gathered step that runs on placed
parameters is ``models/spmd.py``."""
