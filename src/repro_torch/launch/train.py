"""End-to-end training launcher on the card; counterpart of
``repro.launch.train``.

Example (~100M model, a few hundred steps):

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --scale 100m --steps 300 --batch 8 --seq 256

``--scale smoke|100m|full`` controls the parameterization; ``full`` is the
published config (Llama-3.2-1B fits one H100: bf16 weights and grads and
f32 AdamW moments ≈ 15 GB).  ``--data-mesh D --model-mesh M`` places the
state over a ``(data=D, model=M)`` mesh by ``param_shardings`` under the
train rules and runs the weight-gathered runtime (``models/spmd.py``): the
positions on ``cuda:0 … cuda:D·M-1`` (``--devices cuda:0,cuda:0,...`` lets
them share one card, ``--device cpu`` the CPU).  Checkpoint/restart, the straggler watchdog
and preemption handling come from ``runtime.TrainDriver``.  The run trains
on ``cuda`` unless ``--device cpu`` is given, and writes
``results/train_<name>.json`` under the working directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import torch

from ..configs import ARCH_NAMES, get, get_smoke
from ..core.registry import resolve_device
from ..data import DataConfig, SyntheticLM
from ..dist.placement import device_put
from ..models import Model
from ..models.params import param_count, param_shardings
from ..models.sharding_ctx import activation_sharding
from ..runtime import DriverConfig, TrainDriver
from ..train import OptConfig, TrainConfig, init_state, make_train_step
from ..train.step import sparse_weight_shardings
from .mesh import make_local_mesh
from .sharding_rules import (SPARSE_WEIGHT_RULES, TRAIN_RULES,
                             make_sharding_fn, resolve_rules)


def scale_config(arch: str, scale: str):
    if scale == "full":
        return get(arch)
    if scale == "smoke":
        return get_smoke(arch)
    # ~100M-param variant of the family
    cfg = get(arch)
    kw = dict(num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
              d_ff=2048, vocab_size=8192, head_dim=64,
              param_dtype="float32", compute_dtype="float32", remat="none")
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=8, top_k=2,
                                        d_ff_expert=1024)
    if cfg.ssm:
        kw["d_ff"] = 2048
    if cfg.family == "hybrid":
        kw["shared_every"] = 4
    if cfg.attn_pattern == "local_global":
        kw["num_layers"] = 12
        kw["window"] = 128
    if cfg.family == "audio":
        kw["encoder_layers"] = 4
        kw["num_frames"] = 128
    return cfg.scaled(**kw)


def local_mesh(data: int, model: int, device: torch.device, devices=None):
    """``make_local_mesh(data, model)`` on the cards, which raises when
    fewer are present; on the CPU its positions share it; ``devices`` places
    them as given."""
    if devices is not None:
        return make_local_mesh(data, model, devices=list(devices))
    if device.type == "cuda":
        return make_local_mesh(data, model)
    return make_local_mesh(data, model, devices=[device] * (data * model))


def train_rules(cfg=None) -> dict:
    """The train rules of a placed run: weights gathered at their use; a
    ``cfg`` with a sparse FFN adds ``SPARSE_WEIGHT_RULES`` (the value
    streams' tiles over the DP axes)."""
    sparse = cfg is not None and cfg.sparse_ffn is not None
    return dict(resolve_rules(TRAIN_RULES,
                               SPARSE_WEIGHT_RULES if sparse else None),
                __gather_weights__=True)


def param_placement(model, params: dict, mesh, rules=None) -> dict:
    """Each parameter's ``NamedSharding`` on ``mesh``: ``param_shardings``
    under ``rules`` (default ``train_rules(model.cfg)``; a decode cell's
    are ``input_specs.rules_for_cell``'s), the sparse FFN's value streams by
    ``sparse_weight_shardings`` (replicated where the tile count does not
    divide the DP axes, the reference's fallback).  ``params``: tensors or
    stand-ins of their shapes."""
    rules = train_rules(model.cfg) if rules is None else rules
    sh = param_shardings(model.specs, make_sharding_fn(mesh, rules))
    if model.cfg.sparse_ffn is None:
        return sh

    def merge(a, b):
        if isinstance(a, dict):
            return {k: merge(a[k], b[k]) for k in a}
        return a if b is None else b
    return merge(sh, sparse_weight_shardings(params, mesh, rules))


def place_state(model, state: dict, mesh) -> tuple:
    """``(placed state, its shardings)``: params and AdamW moments by
    ``param_placement``, the step replicated."""
    sfn = make_sharding_fn(mesh, train_rules(model.cfg))
    sh = param_placement(model, state["params"], mesh)
    shardings = {"params": sh, "opt": {"step": sfn(()), "m": sh, "v": sh}}
    return device_put(state, shardings), shardings


def build(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
          microbatches: int = 1, device=None, params: dict | None = None,
          seed: int = 0):
    """The launcher's composition, as the reference's ``main`` builds it:
    the model, the train state, the step (``make_train_step`` under the
    launcher's ``TrainConfig``) and the synthetic data.  ``params``: the
    initial parameters (default ``Model.init`` from a generator seeded with
    ``seed`` on ``device``).  Returns ``(model, state, step, data_fn)``."""
    dev = resolve_device(device)
    model = Model(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=lr, warmup_steps=20,
                                     total_steps=steps),
                       microbatches=microbatches)
    data = SyntheticLM(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                  seq_len=seq, global_batch=batch))
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed),
                            dev)
    state = init_state(params, tcfg)
    step = make_train_step(model.loss_fn, tcfg)

    def data_fn(i):
        out = {k: torch.as_tensor(v, device=dev)
               for k, v in data.batch(i).items()}
        if cfg.family == "audio":
            out["frames"] = torch.zeros((batch, cfg.num_frames, cfg.d_model),
                                        dtype=torch.float32, device=dev)
        return out

    return model, state, step, data_fn


def train(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
          microbatches: int = 1, ckpt_dir: str | None = None,
          ckpt_every: int = 50, data_mesh: int = 1, model_mesh: int = 1,
          device=None, params: dict | None = None, seed: int = 0,
          devices=None):
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` synthetic
    tokens under ``TrainDriver``, as the reference's ``main``; ``build``
    makes what it runs.  On a mesh of more than one position
    (``data_mesh`` x ``model_mesh``, on ``devices`` when given) the state
    is placed by ``param_shardings`` under the train rules and the
    weight-gathered runtime runs the step (``models/spmd.py``); a
    one-position mesh computes what no mesh does.  Returns
    ``(driver, model, state)``, the state placed on a mesh."""
    dev = resolve_device(device)
    mesh = local_mesh(data_mesh, model_mesh, dev, devices)
    model, state, step, data_fn = build(
        cfg, steps=steps, batch=batch, seq=seq, lr=lr,
        microbatches=microbatches, device=dev, params=params, seed=seed)
    del params
    rules, shardings = resolve_rules(), None
    if mesh.size > 1:
        rules = train_rules(cfg)
        state, shardings = place_state(model, state, mesh)
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")
    driver = TrainDriver(DriverConfig(total_steps=steps,
                                      checkpoint_every=ckpt_every,
                                      checkpoint_dir=ckpt_dir),
                         step, data_fn)
    with activation_sharding(mesh, rules):
        state = driver.run(state, shardings)
    return driver, model, state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="llama3.2-1b")
    ap.add_argument("--scale", choices=("smoke", "100m", "full"), default="100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train_ckpt in $TMPDIR; a "
                    "checkpoint at or past --steps there resumes past the run")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="a checkpoint of the full Llama-3.2-1B (bf16 "
                    "weights, f32 moments) is ~12.4 GB")
    ap.add_argument("--data-mesh", type=int, default=1,
                    help="data extent of the local mesh (data x model "
                    "positions on as many cards; raises when fewer are "
                    "present, see --devices).  Past one position the params "
                    "and moments are placed by their shardings and each "
                    "weight is gathered at its use (models/spmd.py): the "
                    "batch splits over data, the vocab of the loss over "
                    "model")
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--devices", default=None,
                    help="comma-separated device of each mesh position, "
                    "e.g. cuda:0,cuda:0,cuda:0,cuda:0 to share one card")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = scale_config(args.arch, args.scale)
    print(f"arch={cfg.name} scale={args.scale} "
          f"params={param_count(Model(cfg).specs) / 1e6:.1f}M", flush=True)
    driver, _, _ = train(cfg, steps=args.steps, batch=args.batch,
                         seq=args.seq, lr=args.lr,
                         microbatches=args.microbatches,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         data_mesh=args.data_mesh, model_mesh=args.model_mesh,
                         device=args.device, seed=args.seed,
                         devices=(args.devices.split(",") if args.devices
                                  else None))
    losses = [e.metrics["loss"] for e in driver.events]
    walls = [e.wall for e in driver.events]
    print(f"steps={len(driver.events)} loss[first5]={losses[:5]} "
          f"loss[last5]={losses[-5:]}")
    print(f"stragglers={len(driver.straggler_events)} restarts={driver.restarts}")
    out = {"arch": cfg.name, "losses": losses,
           "straggler_events": driver.straggler_events, "step_s": walls}
    os.makedirs("results", exist_ok=True)
    with open(f"results/train_{cfg.name.replace('.', '_')}.json", "w") as f:
        json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
