"""Collective-traffic diagnosis for one dry-run cell; counterpart of
``repro.launch.diagnose``.  The reference attributes the HLO's collective
bytes to ``op_name``; the port has no HLO and attributes the plan's
collectives (``dryrun.plan_collectives``) to the parameter path or
activation they move, with its logical axes and the rule that sharded it.

  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch phi4-mini-3.8b \
      --shape prefill_32k [--multipod] [--top 18]

Prints the wire bytes by kind and link, the top collectives, and each
device's argument bytes by parameter group.  Runs on meta tensors anywhere.
"""
from __future__ import annotations

import argparse
from collections import defaultdict

from ..configs import ARCH_NAMES, get
from ..models import SHAPES, Model
from .analysis import link_of, wire_bytes
from .dryrun import _param_paths, cell_by_name, plan_collectives, shard_bytes
from .input_specs import build_cell
from .mesh import H100, make_production_mesh


def _group(path: str) -> str:
    """A parameter's group: its first two path keys (``blocks.attn``)."""
    return ".".join(path.split(".")[:2])


def diagnose(model: Model, cell, mesh, top: int = 18, hw=H100) -> str:
    built = build_cell(model, cell, mesh)
    recs = plan_collectives(model, cell, mesh, built.rules)
    out = ["== wire bytes by kind and link (per device) =="]
    by = defaultdict(float)
    counts = defaultdict(int)
    for r in recs:
        key = (r.kind, link_of(r.axes, hw))
        by[key] += wire_bytes(r)
        counts[key] += r.count
    for (kind, link), b in sorted(by.items(), key=lambda kv: -kv[1]):
        out.append(f"  {b / 1e9:10.3f} GB  {kind:<18s} {link:<7s} "
                   f"x{counts[(kind, link)]:<6d} -> "
                   f"{b / hw.link_bw(link):.3e} s")
    out.append(f"== top {top} collectives ==")
    for r in sorted(recs, key=lambda r: -wire_bytes(r))[:top]:
        out.append(f"  {wire_bytes(r) / 1e9:10.3f} GB {r.kind:<15s} "
                   f"over {','.join(r.axes):<10s} n={r.n:<4d} x{r.count:<4d} "
                   f"{r.what}  [{r.rule}]")
    total = sum(wire_bytes(r) for r in recs)
    secs = sum(b / hw.link_bw(link) for (_, link), b in by.items())
    out.append(f"TOTAL wire: {total / 1e9:.3f} GB/dev -> {secs:.3e} s "
               f"({hw.name})")
    params, shard = built.args[0], built.shardings[0]
    if "params" in params:                      # the train state
        params, shard = params["params"], shard["params"]
    groups = defaultdict(int)
    flat_p = dict(_param_paths(params))
    for path, sh in _param_paths(shard):
        groups[_group(path)] += shard_bytes(flat_p[path], sh)
    out.append("== argument bytes a device by parameter group ==")
    for g, b in sorted(groups.items(), key=lambda kv: -kv[1]):
        out.append(f"  {b / 1e6:12.2f} MB  {g}")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--shape", choices=[c.name for c in SHAPES], required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--top", type=int, default=18)
    args = ap.parse_args(argv)
    mesh = make_production_mesh(multi_pod=args.multipod)
    print(diagnose(Model(get(args.arch)), cell_by_name(args.shape), mesh,
                   args.top))


if __name__ == "__main__":
    main()
