"""Measured tuning of the nnz-balanced kernels' geometry and of the fuse
gates; counterpart of ``repro.kernels.tune``.

The paper derives its selector's thresholds from measured times; the same
argument holds one level down, for the workload-balancing granularity: the
BalancedCOO tile (the paper's nnz quota per warp or CTA) and the three
crossovers that decide whether a fused or narrowed kernel runs.

* ``autotune_geometry`` times one pattern under each candidate geometry and
  folds the winner per N-bucket, and a wildcard by mean log-time, into
  ``SelectorThresholds.geometries``, which ``sparse()`` / ``plan()`` read
  on every build.  The Hopper kernels read only the geometry's ``tile``, so
  a ``"hopper"`` sweep with no ``candidates`` takes ``HOPPER_CANDIDATES``
  (one tile each, ``wb`` and ``tile_n`` fixed) rather than the reference's
  ``DEFAULT_CANDIDATES``, three of whose six points would name the same
  kernel twice.
* ``autotune_quant``, ``autotune_chain`` and ``autotune_attention`` set
  ``quant_min_n``, ``chain_fuse_min_n`` and ``attn_fuse_min_seq``: the
  smallest N (sequence) at which the coded (fused) arm beats the other,
  ``*_NEVER`` where it never does.

Every ``measure_*`` times its call with a ``Timer``: the host clock on the
CPU; on the card, after one warm-up call, replays of the call captured in
a CUDA graph timed by CUDA events (the counterpart of the reference's call
compiled outside the timed region), or back-to-back calls between CUDA
events where the call syncs with the host or builds on it (a graph would
replay neither).  ``Timer.log`` says which mode timed each entry.

``modeled_traffic*`` are the reference's byte models of the TPU's
BlockSpec DMA pipeline (DESIGN.md §6), key for key; no tuner reads them.

The sharded overlap crossover (``measure_overlap``, ``autotune_overlap``)
times a sharded psum plan (``core/shard.py``) with the ring forced on and
off; ``modeled_traffic_sharded`` is the reference's per-shard byte model.
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from ..core import registry
from ..core.cache import pattern_fingerprint
from ..core.formats import BUILD_COUNTS, CSR, csr_to_balanced
from ..core.plan import (PATTERN_PREP, execute, execute_attention,
                         execute_chain, plan)
from ..core.selector import (SelectorThresholds, TileGeometry,
                             default_thresholds, geometry_key)

from .vsr import plan_visits, plan_windows

#: the reference's sweep: nnz quota x output-block rows, lane width fixed at
#: the TPU MXU's 128
DEFAULT_CANDIDATES = (
    TileGeometry(tile=256, wb=32, tile_n=128),
    TileGeometry(tile=256, wb=64, tile_n=128),
    TileGeometry(tile=512, wb=32, tile_n=128),
    TileGeometry(tile=512, wb=64, tile_n=128),
    TileGeometry(tile=512, wb=128, tile_n=128),
    TileGeometry(tile=1024, wb=64, tile_n=128),
)

#: the ``"hopper"`` sweep: the nnz quota of a K1 CTA / K2 warp, up to the
#: shared-memory staging's ``HOPPER_MAX_TILE``; ``wb`` and ``tile_n`` are
#: the TPU's and are read by no Hopper kernel
HOPPER_CANDIDATES = tuple(TileGeometry(tile=t, wb=64, tile_n=128)
                          for t in (128, 256, 512, 1024, 2048, 4096))

#: ``quant_min_n`` / ``chain_fuse_min_n`` / ``attn_fuse_min_seq`` /
#: ``overlap_min_n`` sentinels for "that arm never wins"
QUANT_NEVER = 1 << 30
CHAIN_NEVER = 1 << 30
ATTN_NEVER = 1 << 30
OVERLAP_NEVER = 1 << 30

#: the text of the sync guard's warning (``torch.cuda.set_sync_debug_mode``)
_SYNC_MESSAGE = "called a synchronizing CUDA operation"


# ---------------------------------------------------------------------------
# the measurement harness
# ---------------------------------------------------------------------------

def _host_builds() -> tuple:
    return tuple(BUILD_COUNTS.values()) + (PATTERN_PREP["builds"],)


def _uncapturable(fn) -> str | None:
    """Why a warmed-up ``fn`` cannot be timed from a CUDA graph: ``"sync"``
    if a call waits on the card (the sync guard, set to warn, fires),
    ``"build"`` if it builds a substrate or a pattern prep on the host (a
    replay would skip it), else None.  The probe is an eager call, so a
    call that syncs runs to its end and no guardrail counts a failure."""
    before = _host_builds()
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    if any(_SYNC_MESSAGE in str(w.message) for w in caught):
        return "sync"
    return "build" if _host_builds() != before else None


def _captured(fn) -> torch.cuda.CUDAGraph:
    """``fn`` captured in a CUDA graph with the sync guard set to error.
    Any exception here is the caller's: the probe ruled out a sync and a
    host build, so nothing else is expected to break a capture."""
    graph = torch.cuda.CUDAGraph()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph):
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    return graph


def _events(run, device: torch.device, repeats: int) -> float:
    """Mean seconds of ``repeats`` back-to-back ``run()`` by CUDA events,
    after one untimed ``run()``."""
    run()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / repeats


class Timer:
    """``timer(fn, device, repeats, key)``: the mean seconds a call of
    ``fn`` takes on ``device``, each timing appended to ``log`` as
    ``{"key", "seconds", "mode", "reason"}``.

    One warm-up call first (it builds the kernels, substrates and preps).
    On the CPU the host clock times ``repeats`` calls (mode ``"host"``).  On
    the card the call is captured in a CUDA graph and ``repeats`` replays
    are timed by CUDA events (``"graph"``: device time, no Python
    dispatch); a call that syncs with the host or builds on it
    (``reason`` ``"sync"`` / ``"build"``) is timed as ``repeats``
    back-to-back calls between CUDA events (``"b2b"``)."""

    def __init__(self):
        self.log: list[dict] = []

    def __call__(self, fn, device, repeats: int, key: str) -> float:
        device = torch.device(device)
        repeats = max(1, int(repeats))
        reason = None
        if device.type != "cuda":
            fn()
            t0 = time.perf_counter()
            for _ in range(repeats):
                fn()
            seconds, mode = (time.perf_counter() - t0) / repeats, "host"
        else:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                fn()                                  # the warm-up
            torch.cuda.current_stream(device).wait_stream(side)
            reason = _uncapturable(fn)
            if reason is None:
                run, mode = _captured(fn).replay, "graph"
            else:
                run, mode = fn, "b2b"
            seconds = _events(run, device, repeats)
        self.log.append({"key": key, "seconds": seconds, "mode": mode,
                         "reason": reason})
        return seconds

    def modes(self) -> dict[str, str]:
        """``{key: mode}`` of every entry logged."""
        return {e["key"]: e["mode"] for e in self.log}


def _timed_execute(p, n: int, impl: str, repeats: int, timer: Timer | None,
                   key: str) -> float:
    """The shared harness of the geometry and quant sweeps: seconds of
    ``execute(p, x, impl=impl)`` at width ``n`` (x of ones, ``(K,)`` at
    ``n == 1``)."""
    k = p.csr.shape[1]
    x = torch.ones((k, n) if n > 1 else (k,), dtype=torch.float32,
                   device=p.csr.device)
    return (timer or Timer())(lambda: execute(p, x, impl=impl),
                              p.csr.device, repeats, key)


def _geom_label(geom: TileGeometry) -> str:
    return "x".join(str(v) for v in geom.as_tuple())


def _csr_label(csr: CSR) -> str:
    """A cheap name of a matrix for timer keys (no fingerprint: that hashes
    the pattern on the host)."""
    return f"{csr.shape[0]}x{csr.shape[1]}/{csr.nnz}"


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def measure_geometry(csr: CSR, n: int, geom: TileGeometry, *,
                     backend: str | None = None,
                     thresholds: SelectorThresholds | None = None,
                     impl: str = "nb_pr", quant: str | None = None,
                     repeats: int = 2, timer: Timer | None = None) -> float:
    """Seconds per call of the NB kernel ``impl`` under one forced
    geometry; ``backend=None`` is the CSR's device's (``"hopper"`` on the
    card)."""
    backend = backend or registry.default_backend(csr.device)
    th = thresholds if thresholds is not None else default_thresholds()
    p = plan(csr, backend=backend, thresholds=th, geometry=geom, n_hint=n,
             quant=quant)
    return _timed_execute(p, n, impl, repeats, timer,
                          f"geometry|{backend}|{_csr_label(csr)}|{impl}|n={n}|"
                          f"{_geom_label(geom)}|{quant or 'f32'}")


def autotune_geometry(csr: CSR, *, ns: tuple = (8, 128),
                      backend: str | None = None,
                      thresholds: SelectorThresholds | None = None,
                      candidates: tuple | None = None,
                      impl: str = "nb_pr", quant: str | None = None,
                      repeats: int = 2, include_wildcard: bool = True,
                      timer: Timer | None = None) -> SelectorThresholds:
    """Timed sweep over candidate geometries for one sparsity pattern.

    Returns ``thresholds`` extended with one geometry entry per N-bucket of
    ``ns`` (keyed ``geometry_key(backend, fingerprint, n)``) and, when
    ``include_wildcard``, a wildcard entry for plans with no ``n_hint``: the
    candidate of least mean log-time over ``ns``.  ``candidates=None`` takes
    ``HOPPER_CANDIDATES`` on ``"hopper"``, ``DEFAULT_CANDIDATES``
    elsewhere.  ``quant`` tunes under a coded value stream.  On the CPU the
    times are the plain versions' (correctness-grade); tune on the card
    before persisting."""
    backend = backend or registry.default_backend(csr.device)
    th = thresholds if thresholds is not None else default_thresholds()
    if candidates is None:
        candidates = (HOPPER_CANDIDATES if backend == "hopper"
                      else DEFAULT_CANDIDATES)
    cands = tuple(candidates)
    fp = pattern_fingerprint(csr)
    log_times = {g: [] for g in cands}
    for n in ns:
        times = {g: measure_geometry(csr, n, g, backend=backend,
                                     thresholds=th, impl=impl, quant=quant,
                                     repeats=repeats, timer=timer)
                 for g in cands}
        best = min(times, key=times.get)
        th = th.with_geometry(geometry_key(backend, fp, n), best)
        for g, t in times.items():
            log_times[g].append(np.log(max(t, 1e-12)))
    if include_wildcard and cands:
        overall = min(cands, key=lambda g: float(np.mean(log_times[g])))
        th = th.with_geometry(geometry_key(backend, fp, None), overall)
    return th


# ---------------------------------------------------------------------------
# the byte models of the TPU's BlockSpec pipeline (DESIGN.md §6)
# ---------------------------------------------------------------------------

def modeled_traffic(csr: CSR, n: int, *,
                    geometry: TileGeometry | None = None,
                    dtype_bytes: int = 4, index_bytes: int = 4,
                    value_bytes: int | None = None,
                    quant: str | None = None) -> dict:
    """The reference's per-call HBM bytes of the TPU NB SpMM under both
    boundary resolutions (spill, fused), charged as the Pallas pipeline
    DMAs: a block moves between HBM and VMEM only when its BlockSpec index
    changes between grid steps (DESIGN.md §6).  A model of the TPU, not of
    the card: the card's yardstick is ``PERF.md`` §2's bound (each input
    read once, each output written once).

    ``dtype_bytes`` is the dense side's element width; the value stream is
    charged at ``value_bytes`` (default: ``csr.data``'s width) or, under
    ``quant``, at the coded width plus a 4-byte scale a tile load."""
    from ..core import quant as quant_mod
    geom = (geometry or TileGeometry()).validate("pallas")
    bal = csr_to_balanced(csr, tile=geom.tile)
    if value_bytes is None:
        value_bytes = quant_mod.value_bytes(csr.data.dtype)
    return modeled_traffic_balanced(bal, n, int(csr.nnz), geometry=geom,
                                    dtype_bytes=dtype_bytes,
                                    index_bytes=index_bytes,
                                    value_bytes=value_bytes, quant=quant)


def modeled_traffic_balanced(bal, n: int, nnz: int, *,
                             geometry: TileGeometry | None = None,
                             win: int | None = None,
                             dtype_bytes: int = 4, index_bytes: int = 4,
                             value_bytes: int | None = None,
                             quant: str | None = None) -> dict:
    """``modeled_traffic`` on a prebuilt ``BalancedCOO`` slab (the TPU
    model, as there).  ``win`` overrides the spill window; the value stream
    is charged at ``bal.vals``'s width unless ``value_bytes`` or ``quant``
    says otherwise."""
    from ..core import quant as quant_mod
    geom = (geometry or TileGeometry()).validate("pallas")
    m, k = bal.shape
    win = plan_windows(bal)[1] if win is None else max(int(win), 1)
    vt, _, _ = plan_visits(bal, geom.wb)
    n_tiles, t = (int(s) for s in bal.rows.shape)
    n_visits = int(len(vt))
    # tile-stream DMAs per column-block sweep = consecutive-run count of vt
    stream_runs = int(1 + np.count_nonzero(vt[1:] != vt[:-1])) if n_visits else 0
    nb = max(1, -(-n // geom.tile_n))
    n_pad = nb * geom.tile_n
    mb = max(1, -(-m // geom.wb))

    if quant is not None:
        vb = quant_mod.value_bytes(quant_mod.quant_dtype(quant))
        scale_bytes = 4                               # one f32 scale a tile
    else:
        vb = (quant_mod.value_bytes(bal.vals.dtype)
              if value_bytes is None else int(value_bytes))
        scale_bytes = 4 if quant_mod.is_quantized_dtype(bal.vals.dtype) else 0

    value_load = t * vb + scale_bytes                 # vals (+scale), a load
    stream = t * 2 * index_bytes + value_load         # rows+cols+vals, a load
    xblock = k * geom.tile_n * dtype_bytes            # one (K, tile_n) block
    out = m * n_pad * dtype_bytes
    spill_value = n_tiles * value_load
    fused_value = stream_runs * nb * value_load
    spill = (n_tiles * stream
             + n_tiles * nb * xblock                     # X re-read a tile
             + 2 * n_tiles * win * n_pad * dtype_bytes   # partials write+read
             + out)
    fused = (stream_runs * nb * stream
             + nb * xblock                               # one pass over X
             + mb * geom.wb * n_pad * dtype_bytes)       # blocks flushed once
    flops = 2 * nnz * n
    return {
        "spill_bytes": int(spill),
        "fused_bytes": int(fused),
        "spill_value_bytes": int(spill_value),
        "fused_value_bytes": int(fused_value),
        "value_bytes": int(vb),
        "quant": quant,
        "spill_win": int(win),
        "n_tiles": int(n_tiles),
        "n_visits": n_visits,
        "stream_runs": stream_runs,
        "flops": int(flops),
        "spill_ai": flops / max(spill, 1),
        "fused_ai": flops / max(fused, 1),
        "bytes_reduction": spill / max(fused, 1),
    }


def modeled_traffic_chain(csr: CSR, n: int, d: int, *,
                          transform: str = "softmax",
                          geometry: TileGeometry | None = None,
                          dtype_bytes: int = 4,
                          index_bytes: int = 4) -> dict:
    """The reference's per-call HBM bytes of the SDDMM→(transform)→SpMM
    chain on the TPU pipeline (DESIGN.md §6, §9), unfused (edge scores
    written and read back: ``2·nnz·dtype``, twice that more for the
    softmax's pass) against fused (scores recomputed a column block, the
    A/B gathers charged a pass, the softmax statistics as two ``(m,)``
    vectors).  A model of the TPU, not of the card (``PERF.md`` §2)."""
    geom = (geometry or TileGeometry()).validate("pallas")
    bal = csr_to_balanced(csr, tile=geom.tile)
    m, k = csr.shape
    nnz = int(csr.nnz)
    vt, _, _ = plan_visits(bal, geom.wb)
    n_tiles, t = (int(s) for s in bal.rows.shape)
    n_visits = int(len(vt))
    stream_runs = int(1 + np.count_nonzero(vt[1:] != vt[:-1])) if n_visits else 0
    nb = max(1, -(-n // geom.tile_n))
    n_pad = nb * geom.tile_n
    mb = max(1, -(-m // geom.wb))
    softmax = transform == "softmax"

    idx_load = t * 2 * index_bytes                    # rows+cols, a tile load
    ab_pass = (m + k) * d * dtype_bytes               # A and B resident once
    xblock = k * geom.tile_n * dtype_bytes            # one (K, tile_n) block
    out = mb * geom.wb * n_pad * dtype_bytes          # blocks flushed once
    stats_vec = 2 * mb * geom.wb * 4                  # rm + rs, f32

    edge_rt = 2 * nnz * dtype_bytes                   # SDDMM write + SpMM read
    transform_rt = 2 * nnz * dtype_bytes if softmax else 0
    unfused = (n_tiles * idx_load + ab_pass           # SDDMM: stream + A,B
               + stream_runs * nb * idx_load          # SpMM stream re-loads
               + nb * xblock + out                    # one pass over X, flush
               + edge_rt + transform_rt)

    stats_pass = (stream_runs * idx_load + ab_pass + stats_vec) if softmax else 0
    stats_reload = n_visits * nb * 2 * geom.wb * 4 if softmax else 0
    fused = (stats_pass
             + stream_runs * nb * idx_load            # pattern re-read a pass
             + ab_pass                                # A,B resident once
             + nb * xblock + out + stats_reload)

    flops = 2 * nnz * (d + n)
    return {
        "fused_bytes": int(fused),
        "unfused_bytes": int(unfused),
        "fused_edge_value_bytes": 0,
        "unfused_edge_value_bytes": int(edge_rt),
        "unfused_transform_bytes": int(transform_rt),
        "transform": transform,
        "n_tiles": int(n_tiles),
        "n_visits": n_visits,
        "stream_runs": stream_runs,
        "flops": int(flops),
        "fused_ai": flops / max(fused, 1),
        "unfused_ai": flops / max(unfused, 1),
        "bytes_reduction": unfused / max(fused, 1),
    }


def modeled_traffic_attention(mask, head_dim: int = 64, *,
                              geometry: TileGeometry | None = None,
                              dtype_bytes: int = 4,
                              index_bytes: int = 4) -> dict:
    """The reference's TPU byte model of block-sparse attention
    (DESIGN.md §10): ``modeled_traffic_chain`` with the softmax and Q/K/V
    ``head_dim`` wide, plus the score blocks the unfused path writes and
    reads back (``2·nnz_blocks·bs²·dtype``).  ``mask`` is an
    ``AttentionMask``.  A model of the TPU, not of the card."""
    base = modeled_traffic_chain(mask.csr, head_dim, head_dim,
                                 transform="softmax", geometry=geometry,
                                 dtype_bytes=dtype_bytes,
                                 index_bytes=index_bytes)
    bs = int(mask.spec.block)
    nnz_blocks = int(mask.nnz_blocks)
    base.update({
        "seq": int(mask.seq),
        "block": bs,
        "nnz_blocks": nnz_blocks,
        "fused_score_bytes": 0,
        "unfused_score_bytes": int(2 * nnz_blocks * bs * bs * dtype_bytes),
    })
    return base


def modeled_traffic_sharded(sub, n: int, *,
                            geometry: TileGeometry | None = None,
                            dtype_bytes: int = 4, index_bytes: int = 4,
                            quant: str | None = None) -> dict:
    """The reference's per-shard fused-vs-spill byte model of a
    ``ShardedSubstrate`` (a model of the TPU, as ``modeled_traffic``):
    every shard's spill window is the largest over the shards (a static of
    the TPU's ``shard_map`` body), its fused schedule its own.  A baked
    quantized substrate is charged at its coded width."""
    from ..core import quant as quant_mod
    from ..core.formats import BalancedCOO
    geom = (geometry or TileGeometry()).validate("pallas")
    if quant is None:
        quant = getattr(sub, "quant", None)
    value_bytes = None
    vals0 = sub.vals[0]
    if quant is None:
        value_bytes = quant_mod.value_bytes(vals0.dtype)
        if quant_mod.is_quantized_dtype(vals0.dtype):
            quant = "int8"
    rows_h, cols_h, src_h = (sub.stacked(f) for f in ("rows", "cols", "src"))
    n_shards = rows_h.shape[0]
    slabs = [BalancedCOO(torch.from_numpy(rows_h[s]),
                         torch.from_numpy(cols_h[s]),
                         torch.zeros(rows_h[s].shape), sub.inner_shape)
             for s in range(n_shards)]
    win = max(plan_windows(b)[1] for b in slabs)
    per_shard = [modeled_traffic_balanced(
        bal, n, int((src_h[s] >= 0).sum()), geometry=geom, win=win,
        dtype_bytes=dtype_bytes, index_bytes=index_bytes,
        value_bytes=value_bytes, quant=quant)
        for s, bal in enumerate(slabs)]
    spill = sum(t["spill_bytes"] for t in per_shard)
    fused = sum(t["fused_bytes"] for t in per_shard)
    return {
        "per_shard": per_shard,
        "n_shards": n_shards,
        "spill_bytes": int(spill),
        "fused_bytes": int(fused),
        "spill_value_bytes": sum(t["spill_value_bytes"] for t in per_shard),
        "fused_value_bytes": sum(t["fused_value_bytes"] for t in per_shard),
        "quant": quant,
        "spill_win": int(win),
        "max_visits": max(t["n_visits"] for t in per_shard),
        "flops": sum(t["flops"] for t in per_shard),
        "bytes_reduction": spill / max(fused, 1),
    }


# ---------------------------------------------------------------------------
# the sharded overlap crossover: when does the chunked ring beat one psum?
# ---------------------------------------------------------------------------

def _overlap_plan(csr: CSR, mesh, n: int, shard_kind: str,
                  thresholds: SelectorThresholds | None,
                  inner_backend: str | None):
    """A sharded psum plan of ``csr`` on ``mesh`` (on its first shard's
    device), its substrate built for width ``n``."""
    th = thresholds if thresholds is not None else default_thresholds()
    return plan(csr.to(_mesh_device(mesh)), backend="sharded", mesh=mesh,
                shard_kind=shard_kind, thresholds=th,
                inner_backend=inner_backend, n_hint=n)


def _time_overlap(p, n: int, chunked: bool, impl: str, repeats: int,
                  timer: Timer | None) -> float:
    """Seconds per call of the sharded plan ``p`` with the reduction forced
    to the ring or the psum: ``p.with_thresholds`` shares its substrates."""
    q = p.with_thresholds(dataclasses.replace(
        p.thresholds, overlap_min_n=1 if chunked else OVERLAP_NEVER))
    return _timed_execute(q, n, impl, repeats, timer,
                          f"overlap|{_csr_label(p.csr)}|{impl}|n={n}|"
                          f"{'ring' if chunked else 'psum'}")


def measure_overlap(csr: CSR, mesh, n: int, *, chunked: bool,
                    thresholds: SelectorThresholds | None = None,
                    impl: str = "nb_pr", shard_kind: str = "nnz",
                    inner_backend: str | None = None, repeats: int = 2,
                    timer: Timer | None = None) -> float:
    """Seconds per call of a sharded psum plan with the reduction forced to
    the chunked ring (``chunked=True``) or one blocking psum, timed on the
    first shard's device (``Timer``: CUDA events on the card)."""
    p = _overlap_plan(csr, mesh, n, shard_kind, thresholds, inner_backend)
    return _time_overlap(p, n, chunked, impl, repeats, timer)


def autotune_overlap(csr: CSR, mesh, *, ns: tuple = (256, 512, 1024),
                     thresholds: SelectorThresholds | None = None,
                     impl: str = "nb_pr", shard_kind: str = "nnz",
                     inner_backend: str | None = None, repeats: int = 2,
                     timer: Timer | None = None) -> SelectorThresholds:
    """The overlap crossover: the smallest N of ``ns`` at which the chunked
    ring beats the blocking psum becomes ``overlap_min_n``
    (``OVERLAP_NEVER`` when it never does).  Widths of one ring chunk
    (``shard.RING_CHUNK``) or less cannot chunk and are skipped; one plan
    (one substrate build) serves every width."""
    from ..core.shard import RING_CHUNK
    th = thresholds if thresholds is not None else default_thresholds()
    widths = sorted(n for n in ns if n > RING_CHUNK)
    if widths:
        p = _overlap_plan(csr, mesh, widths[0], shard_kind, th, inner_backend)
    for n in widths:
        times = [_time_overlap(p, n, chunked, impl, repeats, timer)
                 for chunked in (True, False)]
        if times[0] < times[1]:
            return dataclasses.replace(th, overlap_min_n=int(n))
    return dataclasses.replace(th, overlap_min_n=OVERLAP_NEVER)


def _mesh_device(mesh) -> torch.device:
    from ..core.shard import default_shard_axis, shard_devices
    return shard_devices(mesh, default_shard_axis(mesh))[0]


# ---------------------------------------------------------------------------
# chain fuse crossover
# ---------------------------------------------------------------------------

def measure_chain(csr: CSR, n: int, d: int, *, fused: bool,
                  transform: str = "softmax", backend: str = "hopper",
                  thresholds: SelectorThresholds | None = None,
                  repeats: int = 2, timer: Timer | None = None) -> float:
    """Seconds per chain call with the fuse gate forced open (``fused=True``:
    on ``"hopper"`` K7 + K8, or the block design on attention patterns) or
    shut (``False``: the unfused pair on the card's kernels, K6 → K7's
    weights → the nnz-balanced SpMM).  A of ones·0.01 ``(M, d)``, B
    ``(K, d)``, X of ones ``(K, n)``."""
    th = thresholds if thresholds is not None else default_thresholds()
    th = dataclasses.replace(th, chain_fuse_min_n=1 if fused else CHAIN_NEVER)
    p = plan(csr, backend=backend, thresholds=th, n_hint=n,
             chain_op=transform)
    m, k = csr.shape
    dev = csr.device
    a = torch.full((m, d), 0.01, dtype=torch.float32, device=dev)
    b = torch.full((k, d), 0.01, dtype=torch.float32, device=dev)
    x = torch.ones((k, n), dtype=torch.float32, device=dev)
    arm = "fused" if fused else "unfused"
    return (timer or Timer())(
        lambda: execute_chain(p, a, b, x, transform=transform), dev, repeats,
        f"chain|{backend}|{_csr_label(csr)}|{transform}|n={n}|d={d}|{arm}")


def autotune_chain(csr: CSR, *, ns: tuple = (8, 32, 128), d: int = 32,
                   transform: str = "softmax", backend: str = "hopper",
                   thresholds: SelectorThresholds | None = None,
                   repeats: int = 2,
                   timer: Timer | None = None) -> SelectorThresholds:
    """The chain-fusion crossover: the smallest N of ``ns`` at which the
    fused chain beats the unfused pair becomes ``chain_fuse_min_n``
    (``CHAIN_NEVER`` when it never does).  The gate acts on ``"hopper"``
    plans only; elsewhere both arms run the same code."""
    th = thresholds if thresholds is not None else default_thresholds()
    for n in sorted(ns):
        kw = dict(transform=transform, backend=backend, thresholds=th,
                  repeats=repeats, timer=timer)
        if (measure_chain(csr, n, d, fused=True, **kw)
                < measure_chain(csr, n, d, fused=False, **kw)):
            return dataclasses.replace(th, chain_fuse_min_n=int(n))
    return dataclasses.replace(th, chain_fuse_min_n=CHAIN_NEVER)


# ---------------------------------------------------------------------------
# attention fuse crossover
# ---------------------------------------------------------------------------

def _alibi(csr: CSR) -> torch.Tensor:
    """An ALiBi-shaped per-edge bias ``-2⁻⁶·(i − j)`` in CSR order."""
    counts = (csr.indptr[1:] - csr.indptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(csr.shape[0], device=csr.device), counts)
    return -(rows - csr.indices.long()).float() * 2.0 ** -6


def measure_attention(mask, d: int, *, fused: bool, backend: str = "hopper",
                      thresholds: SelectorThresholds | None = None,
                      repeats: int = 2, device=None, bias: bool = False,
                      timer: Timer | None = None) -> float:
    """Seconds per attention call over ``mask`` (an ``AttentionMask``) at
    head width ``d``, the fuse gate forced open (``fused=True``) or shut.
    Without ``bias`` (the reference's call) the open arm is the softmax
    chain's K7 + K8 and the shut arm its unfused pair; ``bias=True`` adds an
    ALiBi-shaped per-edge bias, so the open arm is K9 + K10 and the shut
    arm K6 → K9's weights → K1.  ``device=None`` is the card."""
    th = thresholds if thresholds is not None else default_thresholds()
    th = dataclasses.replace(th, attn_fuse_min_seq=1 if fused else ATTN_NEVER)
    dev = registry.resolve_device(device)
    csr = mask.csr.to(dev)
    p = plan(csr, backend=backend, thresholds=th, n_hint=d, chain_op="attn")
    m, k = csr.shape
    q = torch.full((m, d), 0.01, dtype=torch.float32, device=dev)
    kk = torch.full((k, d), 0.01, dtype=torch.float32, device=dev)
    v = torch.ones((k, d), dtype=torch.float32, device=dev)
    edge_bias = _alibi(csr) if bias else None
    arm = "fused" if fused else "unfused"
    return (timer or Timer())(
        lambda: execute_attention(p, q, kk, v, bias=edge_bias), dev, repeats,
        f"attention|{backend}|seq={mask.seq}|d={d}|"
        f"{'bias' if bias else 'nobias'}|{arm}")


def autotune_attention(specs, *, d: int = 64, backend: str = "hopper",
                       thresholds: SelectorThresholds | None = None,
                       repeats: int = 2, device=None, bias: bool = False,
                       timer: Timer | None = None) -> SelectorThresholds:
    """The fused-attention crossover over ``specs`` (sorted by sequence
    length): the smallest ``seq`` at which the fused arm beats the unfused
    one becomes ``attn_fuse_min_seq`` (``ATTN_NEVER`` when it never
    does).  ``bias`` as in ``measure_attention``."""
    from ..attention import build_mask
    th = thresholds if thresholds is not None else default_thresholds()
    for spec in sorted(specs, key=lambda s: s.seq):
        mask = build_mask(spec)
        kw = dict(backend=backend, thresholds=th, repeats=repeats,
                  device=device, bias=bias, timer=timer)
        if (measure_attention(mask, d, fused=True, **kw)
                < measure_attention(mask, d, fused=False, **kw)):
            return dataclasses.replace(th, attn_fuse_min_seq=int(spec.seq))
    return dataclasses.replace(th, attn_fuse_min_seq=ATTN_NEVER)


# ---------------------------------------------------------------------------
# quant crossover
# ---------------------------------------------------------------------------

def measure_quant(csr: CSR, n: int, *, quant: str | None = "int8",
                  backend: str | None = None,
                  thresholds: SelectorThresholds | None = None,
                  impl: str = "nb_pr", repeats: int = 2,
                  timer: Timer | None = None) -> float:
    """Seconds per NB-plan call with the value stream coded as ``quant``
    (the coded K1 / K2 on ``"hopper"``); ``quant=None`` times the f32
    kernels of the same design under the same thresholds."""
    backend = backend or registry.default_backend(csr.device)
    th = thresholds if thresholds is not None else default_thresholds()
    # force the gate open so the requested mode is what runs
    th = dataclasses.replace(th, quant_min_n=1)
    p = plan(csr, backend=backend, thresholds=th, n_hint=n, quant=quant)
    return _timed_execute(p, n, impl, repeats, timer,
                          f"quant|{backend}|{_csr_label(csr)}|{impl}|n={n}|"
                          f"{quant or 'f32'}")


def autotune_quant(csr: CSR, *, ns: tuple = (8, 32, 128),
                   quant: str = "int8", backend: str | None = None,
                   thresholds: SelectorThresholds | None = None,
                   impl: str = "nb_pr", repeats: int = 2,
                   timer: Timer | None = None) -> SelectorThresholds:
    """The quantization crossover: the smallest N of ``ns`` at which the
    coded plan beats the f32 one becomes ``quant_min_n`` (``QUANT_NEVER``
    when it never does)."""
    th = thresholds if thresholds is not None else default_thresholds()
    for n in sorted(ns):
        kw = dict(backend=backend, thresholds=th, impl=impl, repeats=repeats,
                  timer=timer)
        if (measure_quant(csr, n, quant=quant, **kw)
                < measure_quant(csr, n, quant=None, **kw)):
            return dataclasses.replace(th, quant_min_n=int(n))
    return dataclasses.replace(th, quant_min_n=QUANT_NEVER)
