"""Long-context serving example (DESIGN.md §10): batched requests against a
small transformer whose prefill attention runs through the **block-sparse
attention subsystem** — a causal sliding-window block mask compiled by the
pattern builders and executed as one fused sparse-softmax chain (SDDMM at
nonzero blocks → online masked softmax → SpMM against V; K7 and K8 on the
card); counterpart of the reference's ``examples/serve_longcontext.py``.

The engine scopes attention plan builds into *its* ``PlanCache``
(``scoped_plan_cache``), so the mask artifact is built once and shared by
every layer, head, and same-shape request — the cache counters printed at
the end make that reuse observable.  The reference looks the plan up once a
trace; the port, which runs eagerly, once a layer call: the builds are the
same (one a prompt length), the hits more.

    python -m repro_torch.examples.serve_longcontext                # card
    python -m repro_torch.examples.serve_longcontext --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api import SparseAttention, sliding_window
from repro_torch.configs import get_smoke
from repro_torch.core.registry import resolve_device
from repro_torch.models import Model
from repro_torch.serve import Request, ServeEngine


def main(device=None) -> dict:
    """Serve the long-context smoke config on ``device`` (``None``: the
    card); returns the engine's ``plan_cache`` counters."""
    dev = resolve_device(device)
    # a dense smoke config re-patterned for long context: causal sliding
    # window of 16 tokens on 8-token blocks → a 3-block causal band mask
    cfg = get_smoke("llama3.2-1b").scaled(
        attn_pattern="block_sparse", window=16, attn_block=8)
    assert cfg.sub_quadratic, "block_sparse must qualify for the long cells"
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = ServeEngine(model, params, slots=3, max_len=64)

    # same-length prompts share one attention plan; the second length adds
    # exactly one more mask build — everything else is a cache hit
    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(24)]
               for i in range(4)]
    prompts.append([(3 * j + 1) % cfg.vocab_size for j in range(40)])
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new=6))
    done = engine.run_until_done()
    for r in done:
        print(f"req {r.rid}: len(prompt)={len(r.prompt)} → out={r.out} "
              f"(done={r.done})")
    assert all(r.done for r in done)

    s = engine.plan_cache.stats()
    print(f"served {len(done)} requests in {engine.ticks} ticks on {dev}")
    print(f"attention plans: built {s['builds']}x for 2 distinct prompt "
          f"lengths, reused {s['hits']}x (every layer call and every "
          f"same-length request shares one plan)")
    assert s["builds"] == 2, s
    # one lookup a layer call of each prefill: all but the two builds hit
    assert s["hits"] >= len(prompts) * cfg.num_layers - 2, s

    # --- cross-layer sharing, made visible --------------------------------
    # Two standalone attention layers pointed at the engine's cache present
    # the same spec the 24-token prefills used (window=16 tok / block=8 →
    # 2-block causal band); nothing new is built — both calls are hits on
    # the plan the serving traffic already paid for.
    hits0 = s["hits"]
    spec = sliding_window(24, 2, block=8, causal=True)
    layers = [SparseAttention(spec, cache=engine.plan_cache, device=dev)
              for _ in range(2)]
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal(
        (24, cfg.head_dim)).astype("float32")).to(dev)
    for layer in layers:
        layer(q, q, q)
    s = engine.plan_cache.stats()
    print(f"+2 standalone layers, same mask: built {s['builds']}x total, "
          f"reused {s['hits']}x — cross-layer/request sharing through one "
          f"PlanCache")
    assert s["builds"] == 2, s      # nothing new was built
    assert s["hits"] >= hits0 + 2, s   # both layer calls hit the serving plan
    engine.close()
    return s


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the card)")
    main(ap.parse_args().device)
