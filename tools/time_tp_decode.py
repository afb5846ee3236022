"""Time one decode step of Llama-3.2-1B at full width (16 layers, d 2,048,
vocab 128,256, bf16, weights from seed 0) on placed parameters: the
tensor-parallel regime of ``models/spmd.py`` on a (data=2, model=2) mesh
whose four positions share one card, under ``rules_for_cell``'s
``decode_32k`` rules, beside the unsharded decode step on the same card.

    python3 tools/time_tp_decode.py LABEL

Run from the root of a checkout on a CUDA card.  The caches hold 528
slots, 512 of them filled from the seed.  For batch 4 and batch 1 it takes
3 steps to warm up, then times 5 steps, each on its own under
``torch.profiler`` (the device's activity alone): ``busy_ms`` is the union
of the device events' intervals in a step, ``wall_ms`` the step's wall
time; each is the median of the 5.  It prints one JSON line a batch,
naming the card and its power limit (``nvidia-smi``).  To compare two
trees on one card, unpack the other tree into a directory of this one
that ``.gitignore`` lists and run the script from each root in turn, e.g.
parent, change, change, parent
(``(cd .chipwork/parent && python3 ../../tools/time_tp_decode.py parent)``)."""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd() / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.dist.placement import device_put  # noqa: E402
from repro_torch.launch import input_specs, make_local_mesh, train  # noqa: E402
from repro_torch.models import SHAPES, Model  # noqa: E402
from repro_torch.models.sharding_ctx import activation_sharding  # noqa: E402

PROMPT, SLOTS, WARM, TIMED = 512, 528, 3, 5


def busy_ms(fn):
    """``(out, device busy ms, wall ms)`` of one call of ``fn``."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return out, busy / 1e3, 1e3 * wall


def steps(step, caches, tokens):
    """Warm up, then the timed steps: ``(busy ms, wall ms)`` medians."""
    for i in range(WARM):
        _, caches = step(caches, tokens[:, i:i + 1])
    busy, wall = [], []
    for i in range(WARM, WARM + TIMED):
        (_, caches), b, w = busy_ms(
            lambda i=i, c=caches: step(c, tokens[:, i:i + 1]))
        busy.append(b)
        wall.append(w)
    return statistics.median(busy), statistics.median(wall)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_tp_decode: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    cfg = train.scale_config("llama3.2-1b", "full")
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)
    mesh = make_local_mesh(2, 2, devices=[dev] * 4)
    cell = next(c for c in SHAPES if c.name == "decode_32k")
    rules = input_specs.rules_for_cell(cell, cfg, model_axis=2)
    placed = device_put(params, train.param_placement(model, params, mesh,
                                                      rules))
    for batch in (4, 1):
        caches = model.init_cache(batch, SLOTS, device=dev)
        for leaf in caches["kv"].values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev))
        caches["length"].fill_(PROMPT)
        tokens = torch.randint(0, cfg.vocab_size, (batch, WARM + TIMED),
                               generator=gen, device=dev)
        with torch.no_grad():
            plain = steps(lambda c, t: model.decode_step(params, c, t),
                          caches, tokens)
            pc = device_put(caches, model.cache_shardings(caches, mesh, rules))
            with activation_sharding(mesh, rules):
                tp = steps(lambda c, t: model.decode_step(placed, c, t),
                           pc, tokens)
        print(json.dumps({
            "tree": sys.argv[1] if len(sys.argv) > 1 else ".", "card": card,
            "arch": cfg.name, "dtype": cfg.compute_dtype, "batch": batch,
            "mesh": dict(mesh.shape), "busy_ms": tp[0], "wall_ms": tp[1],
            "unsharded_busy_ms": plain[0], "unsharded_wall_ms": plain[1]}),
            flush=True)
        del caches, pc
    return 0


if __name__ == "__main__":
    sys.exit(main())
