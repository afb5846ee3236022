"""The port stands alone: every module of ``repro_torch`` imports in a
fresh interpreter in which ``jax`` and the reference package ``repro``
cannot be imported (a ``sys.meta_path`` finder refuses them)."""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"

_PROBE = r'''
import importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    __import__(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("\n".join(names))
'''


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for module in ("repro_torch.api", "repro_torch.interop",
                   "repro_torch.attention.module",
                   "repro_torch.attention.patterns",
                   "repro_torch.kernels.attention",
                   "repro_torch.kernels.blocks",
                   "repro_torch.kernels.bsr",
                   "repro_torch.models.transformer",
                   "repro_torch.models.layers",
                   "repro_torch.core.vjp",
                   "repro_torch.core.quant",
                   "repro_torch.train.compress",
                   "repro_torch.examples.train_gat",
                   "repro_torch.examples.quickstart",
                   "repro_torch.kernels.ops",
                   "repro_torch.kernels.tune",
                   "repro_torch.train.optim",
                   "repro_torch.train.step",
                   "repro_torch.configs.gemma3_12b",
                   "repro_torch.configs.olmoe_1b_7b",
                   "repro_torch.configs.kimi_k2_1t_a32b",
                   "repro_torch.configs.llama3_2_1b",
                   "repro_torch.configs.phi3_mini_3_8b",
                   "repro_torch.configs.phi4_mini_3_8b",
                   "repro_torch.configs.qwen2_vl_72b",
                   "repro_torch.configs.rwkv6_3b",
                   "repro_torch.configs.zamba2_2_7b",
                   "repro_torch.configs.whisper_tiny",
                   "repro_torch.configs.paper_spmm",
                   "repro_torch.models.ssm",
                   "repro_torch.models.rwkv",
                   "repro_torch.models.sharding_ctx",
                   "repro_torch.models.params",
                   "repro_torch.models.moe",
                   "repro_torch.models.model_loss",
                   "repro_torch.models.model",
                   "repro_torch.core.guardrails",
                   "repro_torch.core.cache",
                   "repro_torch.runtime",
                   "repro_torch.runtime.faults",
                   "repro_torch.runtime.retry",
                   "repro_torch.runtime.driver",
                   "repro_torch.serve",
                   "repro_torch.serve.engine",
                   "repro_torch.serve.metrics",
                   "repro_torch.serve.faults",
                   "repro_torch.checkpoint",
                   "repro_torch.checkpoint.manager",
                   "repro_torch.data",
                   "repro_torch.data.pipeline",
                   "repro_torch.examples.serve_moe",
                   "repro_torch.examples.serve_longcontext",
                   "repro_torch.examples.train_sparse_lm",
                   "repro_torch.core.shard",
                   "repro_torch.launch",
                   "repro_torch.launch.mesh",
                   "repro_torch.launch.sharding_rules",
                   "repro_torch.launch.analysis",
                   "repro_torch.launch.cost_model",
                   "repro_torch.launch.input_specs",
                   "repro_torch.launch.dryrun",
                   "repro_torch.launch.diagnose",
                   "repro_torch.launch.train",
                   "repro_torch.dist",
                   "repro_torch.dist.placement",
                   "repro_torch.dist.sharding_rules",
                   "repro_torch.models.spmd",
                   "repro_torch.train.manual_collectives"):
        assert module in names, (module, sorted(names))


def test_port_exports_the_reference_top_level():
    """Every name of ``repro.__all__`` (``use_mesh`` too, since the
    sharded backend is ported) is an attribute of ``repro_torch``, which
    imports no JAX and nothing of ``repro`` to give them."""
    import repro
    names = list(repro.__all__)
    assert "use_mesh" in names
    probe = _PROBE.split("names = sorted")[0] + (
        "missing = [n for n in sys.argv[1:] if not hasattr(repro_torch, n)]\n"
        "assert not missing, missing\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not leaked, leaked\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe, *names], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert {"calibrate", "calibrate_backend", "PlanArtifact",
            "PlanBuilder"} <= set(names)
