"""Roofline terms of a dry-run cell; counterpart of
``repro.launch.analysis``.

  compute  = FLOPs / (chips x the card's bf16 peak)
  memory   = HBM bytes / (chips x the card's HBM rate)
  collect. = per-device wire bytes of each link / that link's rate, summed

The hardware is an argument (``mesh.Hardware``; default ``mesh.H100``,
datasheet constants).  On the H100 meshes bytes on the ``model`` axis cross
NVLink and bytes on ``data`` / ``pod`` cross InfiniBand; with ``mesh.V5E``
and every byte on its one link the terms are the reference's.

Sources
-------
* collective bytes: the reference parses them from the post-SPMD HLO; the
  port has no HLO, so ``collective_bytes`` takes a list of records
  ``(kind, bytes, group axes, group size)`` — the plan's collectives,
  counted from the sharding rules (``dryrun.plan_collectives``).
* FLOPs / HBM bytes: the analytic model in ``cost_model.py``; the FLOPs and
  bytes that ``FlopCounterMode`` and the dry run's meter count over the
  step traced on meta tensors are recorded beside them as a diagnostic.

Ring-traffic factors (per-device wire bytes, group size n):
  all-gather         out_bytes x (n-1)/n
  all-reduce         in_bytes  x 2(n-1)/n
  reduce-scatter     in_bytes  x (n-1)/n
  all-to-all         bytes     x (n-1)/n
  collective-permute bytes     x 1
  broadcast, reduce  bytes     x (n-1)   (rooted at each position in turn:
                     the sparse matmul's x out to its shards and their
                     partials back, ``spmd.sparse_matmul``)
"""
from __future__ import annotations

import dataclasses

from ..models.spmd import Collective
from .mesh import H100, Hardware

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "broadcast", "reduce")
_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0, "broadcast": 1.0,
           "reduce": 1.0}


def wire_bytes(rec: Collective) -> float:
    """Per-device wire bytes of ``rec``, all its repetitions."""
    if rec.kind == "collective-permute":
        ring = 1.0
    elif rec.kind in ("broadcast", "reduce"):
        ring = max(int(rec.n), 1) - 1
    else:
        n = max(int(rec.n), 2)
        ring = (n - 1) / n
    return rec.bytes * _FACTOR[rec.kind] * ring * rec.count


def link_of(axes: tuple, hw: Hardware = H100) -> str:
    """The link a group over ``axes`` crosses: the slowest of its axes'."""
    links = {hw.link_of(a) for a in axes} or {hw.default_link}
    return min(links, key=hw.link_bw)


def collective_bytes(records, hw: Hardware = H100) -> dict:
    """The reference's dict (wire bytes by kind, ``n_<kind>`` counts,
    ``total_wire_bytes``) over ``records``, plus ``wire_bytes_by_link``."""
    bytes_by = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    by_link = {link: 0.0 for link, _ in hw.links}
    for rec in records:
        w = wire_bytes(rec)
        bytes_by[rec.kind] += w
        counts[rec.kind] += rec.count
        by_link[link_of(rec.axes, hw)] += w
    out = dict(bytes_by)
    out.update({f"n_{k}": v for k, v in counts.items()})
    out["total_wire_bytes"] = sum(bytes_by[k] for k in _COLLECTIVES)
    out["wire_bytes_by_link"] = by_link
    return out


@dataclasses.dataclass
class Roofline:
    flops_global: float
    bytes_global: float
    wire_bytes_per_dev: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    hlo_flops_per_dev: float = 0.0
    hlo_bytes_per_dev: float = 0.0
    collective_s_by_link: dict = dataclasses.field(default_factory=dict)
    hardware: str = ""

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(flops: float, bytes_: float, wire_bytes, chips: int,
                   model_flops: float, hlo_flops: float = 0.0,
                   hlo_bytes: float = 0.0, hw: Hardware = H100) -> Roofline:
    """``wire_bytes``: per-device wire bytes, a number (all on
    ``hw.default_link``) or a dict by link (``collective_bytes``'s
    ``wire_bytes_by_link``)."""
    if not isinstance(wire_bytes, dict):
        wire_bytes = {hw.default_link: float(wire_bytes)}
    compute_s = flops / (chips * hw.peak_flops_bf16)
    memory_s = bytes_ / (chips * hw.hbm_bw)
    by_link = {link: b / hw.link_bw(link) for link, b in wire_bytes.items()}
    collective_s = sum(by_link.values())
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        flops_global=flops, bytes_global=bytes_,
        wire_bytes_per_dev=sum(wire_bytes.values()),
        chips=chips, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=(model_flops / flops) if flops else 0.0,
        hlo_flops_per_dev=hlo_flops, hlo_bytes_per_dev=hlo_bytes,
        collective_s_by_link=by_link, hardware=hw.name)


def summarize(artifact: dict) -> str:
    r = artifact["roofline"]
    return (f"{artifact['arch']:>18s} {artifact['cell']:>11s} "
            f"mesh={artifact['mesh']:<6s} "
            f"C={r['compute_s']:.3e}s M={r['memory_s']:.3e}s "
            f"X={r['collective_s']:.3e}s → {r['bottleneck']:<10s} "
            f"useful={r['useful_ratio']:.2f}")
