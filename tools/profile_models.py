"""Where a model's prefill and decode spend their time on the card:
``torch.profiler`` traces of the port's ``Model.prefill`` and
``Model.decode_step`` at full width (bf16 weights from the seed, made on
the card).

    python3 tools/profile_models.py [--model olmoe-1b-7b] [--seed 0] [--layers N]
    python3 tools/profile_models.py --model llama3.2-1b --train

Run from the root of a checkout on a CUDA card.  ``--model olmoe-1b-7b``
(the default, ``configs/olmoe_1b_7b.py``): after a warm-up it traces three
windows: 3 prefills of 4 x 512 tokens (the "sort" dispatch, K1 twice a MoE
layer), 8 decode steps at B = 4 on the selector's one-hot path, and 8 with
``dispatch="spmm"`` forced.  ``--model rwkv6-3b``: 1 prefill of 2 x 512
tokens (the WKV recurrence a token at a time) and 8 decode steps at B = 2;
``--model zamba2-2.7b``: 1 prefill of 1 x 2,048 tokens and 8 decode steps
at B = 1.  ``--train`` traces the training step that
``launch.train.build`` makes (the launcher's own composition) at the sizes
of ``TRAIN``: 3 steps of the whole step and 3 of its loss and backward
alone (Llama-3.2-1B: 4 x 256 tokens, the launcher's full-width phase in
``chip_smoke.py``).  ``--layers`` cuts the depth (default: the config's).
For each window it prints one JSON line:
the wall time a call (host clock, ending in a sync) unprofiled and
profiled, the device's busy time a call (the union of the device events'
intervals), the idle share against each wall (the profiler's own host cost
lengthens the profiled one), the device events a call (kernel launches,
copies, sets), the host time a call spent in PyTorch's ops (their self CPU
time summed), the top 12 kernels by device time and the top 10 ops by self
CPU time.  Each line names the card and its power limit (``nvidia-smi``)."""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd() / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import Model  # noqa: E402

#: (batch, prompt tokens, prefills traced) of each model; 8 decode steps
SIZES = {"olmoe-1b-7b": (4, 512, 3), "rwkv6-3b": (2, 512, 1),
         "zamba2-2.7b": (1, 2048, 1)}
STEPS = 8
#: (batch, seq, steps traced) of the training windows
TRAIN = {"llama3.2-1b": (4, 256, 3), "olmoe-1b-7b": (4, 256, 3)}


def _window(label, fn, calls, card):
    """Trace ``calls`` calls of ``fn`` after one untraced call; print the
    window's JSON line.  Device time is the union of the device events'
    intervals (kernels, copies and sets on the card), each counted once."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in device):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_kernel: dict = {}
    for e in device:
        n, us = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    cpu_ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU]
    print(json.dumps({
        "window": label, "calls": calls,
        "wall_ms": 1e3 * plain_wall / calls,
        "profiled_wall_ms": 1e3 * wall / calls,
        "device_busy_ms": busy_us / 1e3 / calls,
        "idle_share": 1.0 - busy_us / 1e6 / plain_wall,
        "profiled_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_launches": len(device) / calls,
        "host_op_self_ms": sum(e.self_cpu_time_total for e in cpu_ops)
        / 1e3 / calls,
        "top_kernels": [{"kernel": k[:80], "calls": n / calls,
                         "ms": round(us / 1e3 / calls, 4)}
                        for k, (n, us) in sorted(by_kernel.items(),
                                                 key=lambda kv: -kv[1][1])[:12]],
        "top_host_ops": [{"op": e.key[:80], "calls": e.count / calls,
                          "ms": round(e.self_cpu_time_total / 1e3 / calls, 4)}
                         for e in sorted(cpu_ops, key=lambda e:
                                         -e.self_cpu_time_total)[:10]],
        "card": card}), flush=True)


def _train_windows(cfg, dev, seed, card) -> int:
    """The launcher's training step and its loss and backward alone."""
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.launch.train import build
    batch, seq, steps = TRAIN[cfg.name]
    model, state, step, data_fn = build(cfg, steps=steps, batch=batch,
                                        seq=seq, device=dev, seed=seed)
    data = data_fn(0)

    def grads():
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        loss, _ = model.loss_fn(params, data)
        torch.autograd.grad(loss, tree_leaves(params))
    _window(f"{cfg.name} train step B={batch} S={seq}",
            lambda: step(state, data), steps, card)
    _window(f"{cfg.name} loss + backward B={batch} S={seq}", grads, steps,
            card)
    print(json.dumps({"peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "card": card}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(set(SIZES) | set(TRAIN)),
                    default="olmoe-1b-7b")
    ap.add_argument("--train", action="store_true",
                    help="trace the training step instead of prefill and decode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_models: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.lib()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = configs.get(args.model)
    cfg = cfg.scaled(num_layers=args.layers or cfg.num_layers)
    if args.train:
        return _train_windows(cfg, dev, args.seed, card)
    batch, seq, prefills = SIZES[args.model]
    model = Model(cfg)
    decoders = [("", model)]
    if cfg.moe is not None:
        decoders = [(" onehot", model), (" spmm", Model(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="spmm"))))]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen)
    max_len = seq + 4 * STEPS
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), device=dev,
                         generator=gen)
    with torch.no_grad():
        _window(f"{cfg.name} prefill B={batch} S={seq}", lambda: model.prefill(
            params, {"tokens": toks[:, :seq]}, max_len), prefills, card)
        _, caches = model.prefill(params, {"tokens": toks[:, :seq]}, max_len)
        tok = toks[:, seq:]
        for label, m in decoders:
            _window(f"{cfg.name} decode B={batch}{label}",
                    lambda: m.decode_step(params, caches, tok), STEPS, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
