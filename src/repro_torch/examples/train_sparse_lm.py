"""End-to-end training driver: a llama-family model scaled to 6 layers of
width 512 with the paper's sparse-FFN feature ON — every MLP matmul runs
through the adaptive SpMM with trainable nonzeros (K1 forward, K6 for the
values' grads on the card) — fed by the step-indexed ``SyntheticLM`` and run
by ``TrainDriver`` (periodic async checkpoints, rollback on a failed step);
counterpart of the reference's ``examples/train_sparse_lm.py``.

    python -m repro_torch.examples.train_sparse_lm --steps 200   # card
    python -m repro_torch.examples.train_sparse_lm --device cpu --steps 6 \\
        --batch 2 --seq 32

Checkpoint/restart: kill it mid-run and rerun — it resumes from the last
committed step in ``--checkpoint-dir`` (by default ``repro_torch_sparse_lm``
in the temporary directory; remove it to start over: a checkpoint at or
past ``--steps`` resumes past the whole run).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get
from repro_torch.core.registry import resolve_device
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import Model
from repro_torch.models.config import SparseFFNConfig
from repro_torch.models.params import param_count
from repro_torch.runtime import DriverConfig, TrainDriver
from repro_torch.train import OptConfig, TrainConfig, init_state, make_train_step

DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_sparse_lm")


def config(density: float = 0.15):
    """The example's model: ``llama3.2-1b`` scaled down, sparse FFN on."""
    return get("llama3.2-1b").scaled(
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=4, d_ff=2048,
        vocab_size=8192, head_dim=64,
        sparse_ffn=SparseFFNConfig(density=density, tile=512),
        param_dtype="float32", compute_dtype="float32", remat="none")


def train(*, steps: int = 200, batch: int = 8, seq: int = 128,
          density: float = 0.15, device=None, sparse_backend=None,
          calibrate_to=None, checkpoint_dir: str = DEFAULT_CKPT,
          checkpoint_every: int = 50, failure_hook=None, seed: int = 0):
    """Train ``config(density)`` for ``steps`` under a ``TrainDriver`` on
    ``device`` (``None``: the card).  Returns ``(driver, model, batch_fn,
    initial state, final state)``; ``batch_fn(i)`` is step ``i``'s batch on
    the device."""
    dev = resolve_device(device)
    cfg = config(density)
    model = Model(cfg)
    print(f"sparse-FFN LM: {param_count(model.specs)/1e6:.1f}M params "
          f"(FFN density {density})")
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=20,
                                     total_steps=steps),
                       sparse_backend=sparse_backend)
    data = SyntheticLM(DataConfig(seed=seed, vocab_size=cfg.vocab_size,
                                  seq_len=seq, global_batch=batch))
    step = make_train_step(model.loss_fn, tcfg)
    state = init_state(model.init(torch.Generator(device=dev).manual_seed(seed),
                                  device=dev), tcfg)
    batch_fn = lambda i: {k: torch.from_numpy(v).to(dev)  # noqa: E731
                          for k, v in data.batch(i).items()}
    driver = TrainDriver(
        DriverConfig(total_steps=steps, checkpoint_every=checkpoint_every,
                     checkpoint_dir=checkpoint_dir,
                     calibrate_to=calibrate_to),
        step, batch_fn, failure_hook=failure_hook)
    final = driver.run(state)
    return driver, model, batch_fn, state, final


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--density", type=float, default=0.15)
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the card)")
    ap.add_argument("--sparse-backend", default=None,
                    help="pin the sparse kernels' backend for the whole step "
                         "(repro_torch.api.use_backend scope; default: the "
                         "device's)")
    ap.add_argument("--calibrate-to", default=None,
                    help="background-calibrate selector thresholds to this "
                         "JSON on first run (auto-loads via $REPRO_THRESHOLDS)")
    ap.add_argument("--checkpoint-dir", default=DEFAULT_CKPT)
    args = ap.parse_args(argv)
    driver, *_ = train(steps=args.steps, batch=args.batch, seq=args.seq,
                         density=args.density, device=args.device,
                         sparse_backend=args.sparse_backend,
                         calibrate_to=args.calibrate_to,
                         checkpoint_dir=args.checkpoint_dir)
    losses = [e.metrics["loss"] for e in driver.events]
    print(f"loss: {losses[0]:.3f} → {losses[-1]:.3f} over {len(losses)} steps")
    assert losses[-1] < losses[0], "training must reduce loss"
    return driver


if __name__ == "__main__":
    main()
