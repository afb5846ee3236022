"""Sharded execution backend; counterpart of ``repro.core.shard`` on a
single-process device mesh (``launch/mesh.py``).

The paper's adaptive rule — workload-balancing or parallel reduction, picked
from cheap matrix statistics — goes one level up: the ``MatrixStats`` that
select a kernel select a partitioning of the matrix across a mesh axis.

* **row split** (``kind="row"``): shard s owns an equal slice of ``m_pad``
  rows; the shards' outputs are disjoint and the reduction is a
  **concat** (the pad rows stripped).
* **nnz split** (``kind="nnz"``): the row-major nonzero stream is cut into
  per-shard quotas that differ by at most one nonzero, each tiled as
  ``csr_to_balanced`` tiles (``row == M`` padding); every shard writes a
  partial of the whole output and the reduction is a **psum**.

``select_partition`` picks nnz when ``cv > partition_cv``.  The slabs are
built on the host exactly as the reference stacks them (``stacked`` gives
that stack back), then each shard's slab goes to its shard's device.

Registry entries under backend ``"sharded"`` run an inner backend's entry
(``"hopper"`` on the card, ``"torch"`` on the CPU) once per shard, each
through the port's own autograd Functions (``ExecBalanced`` / ``ExecEll``)
with a per-shard backward: the SDDMM entry over the shard's pattern for the
values, and the nnz-balanced kernel on the shard's transposed slabs for
``dX``.  A live value stream is gathered into each shard's slab through
``src`` (``-1`` reads 0); autograd scatters its gradient back.  The
collectives (``psum``, ``pmax``, ``ppermute``) are ordered copies and adds
of differentiable torch ops over a list of per-shard tensors, so autograd
transposes them: the gradient of the replicated ``x`` is the sum of the
shards' ``Aᵀ·g``.

On CUDA devices each shard's work is issued on a stream of its own, forked
from and joined to the caller's stream (``_Lanes``): four shards on one
card run concurrently.  psum plans at ``N >= thresholds.overlap_min_n``
replace the trailing psum by a width-chunked ring of ``ppermute`` steps on
a stream of its own (``_overlapped_ring``): chunk j+1's kernels are issued
on the shards' streams before chunk j's ring, joined by events.  On a mesh
of several cards shard s would sit on ``cuda:s``; the port has run only
meshes whose positions share one device.

The sharded SDDMM and chain (DESIGN.md §9): each shard scores or chains its
own slab (row split: local row ids, A cut to the shard's rows); nnz splits
merge the softmax statistics — K7 a shard, then the ``pmax`` of the maxes
and the ``psum`` of ``sum · exp(max_local − max_global)`` — before K8 runs
per shard on the merged statistics.  Their backward is the plan's, over the
whole pattern on the inner backend, as the reference's custom VJP runs
outside ``shard_map``.

``execute_pattern_sharded`` splits a bare balanced pattern's tiles evenly
over the shards and psums the partials (the sparse-weight layers);
``pattern_split`` / ``run_pattern_shard`` are its split and one shard's
product, which the placed runtime (``models.spmd.sparse_matmul``) runs on
the pieces of a placed value stream.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, Tuple

import numpy as np
import torch

from . import quant as quant_mod
from . import registry
from .formats import (BUILD_COUNTS, CSR, ELL, BalancedCOO, _register_pytree,
                      _tiled, host, row_ids_from_indptr)
from .selector import SelectorThresholds, default_thresholds, select_partition
from .stats import MatrixStats
from .vjp import _stream_to_balanced, _tracked, exec_balanced, exec_ell

#: width of the ring's column chunks (the reference's default ``tile_n``)
RING_CHUNK = 128

#: slots a tile of an ELL shard's pattern, re-tiled for its backward
_ELL_BWD_TILE = 512


# ---------------------------------------------------------------------------
# the partition spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Static description of one partitioning of a sparse matrix.

    ``bounds`` are row boundaries for ``kind="row"`` and nonzero-stream
    boundaries for ``kind="nnz"`` (length ``n_shards + 1``); ``m_pad`` is the
    per-shard padded row count of a row split."""

    kind: str            # "row" | "nnz"
    axis: str            # mesh axis the shards map onto
    n_shards: int
    reduction: str       # "concat" (disjoint output rows) | "psum" (partials)
    bounds: Tuple[int, ...]
    m_pad: int = 0


def default_shard_axis(mesh) -> str:
    """The mesh axis with the most positions (ties: the first)."""
    names = list(mesh.axis_names)
    return max(names, key=lambda a: (mesh.shape[a], -names.index(a)))


def make_shard_spec(stats: MatrixStats, mesh, *, axis: str | None = None,
                    kind: str | None = None,
                    thresholds: SelectorThresholds | None = None) -> ShardSpec:
    """The partitioner chosen from the statistics (Fig. 4, one level up)
    unless ``kind`` forces one; ``axis`` defaults to the largest."""
    axis = axis or default_shard_axis(mesh)
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}; axes: {mesh.axis_names}")
    n = int(mesh.shape[axis])
    kind = kind or select_partition(stats, thresholds or default_thresholds())
    if kind == "row":
        m_pad = max(1, -(-stats.m // n))
        bounds = tuple(min(s * m_pad, stats.m) for s in range(n + 1))
        return ShardSpec("row", axis, n, "concat", bounds, m_pad)
    if kind == "nnz":
        bounds = tuple((s * stats.nnz) // n for s in range(n + 1))
        return ShardSpec("nnz", axis, n, "psum", bounds, 0)
    raise ValueError(f"unknown partitioner kind {kind!r}; expected row|nnz")


def shard_devices(mesh, axis: str) -> tuple:
    """The device of each shard along ``axis``; a mesh that names no
    devices (a spec-only stand-in) puts every shard on the CPU."""
    if hasattr(mesh, "shard_devices"):
        return mesh.shard_devices(axis)
    return (torch.device("cpu"),) * int(mesh.shape[axis])


# ---------------------------------------------------------------------------
# the sharded substrate: per-shard inner formats and the stream gather map
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ShardedSubstrate:
    """Per-shard inner substrates, one tensor a shard on its device.

    ``rows`` / ``cols`` / ``vals`` are ``(T, tile)`` slabs (balanced) or
    ``cols`` / ``vals`` ``(Ms, w)`` and ``lens`` ``(Ms,)`` (ELL), every shard
    at the same shape; ``src`` maps each value slot into the global CSR
    stream (-1 for padding).  A quantized substrate holds codes and
    ``scales`` ``(T,)`` a shard (one f32 scale per (shard, tile)).
    ``stacked(name)`` is the reference's stacked array of a field."""

    rows: Any
    cols: Any
    vals: Any
    lens: Any
    src: Any
    scales: Any
    spec: ShardSpec
    mesh: Any
    inner_backend: str
    inner_kind: str      # "ell" | "balanced"
    inner_shape: Tuple[int, int]
    shape: Tuple[int, int]
    nnz: int = 0
    quant: str | None = None

    @property
    def devices(self) -> tuple:
        return tuple(t.device for t in self.cols)

    def local(self, s: int):
        """Shard ``s``'s inner substrate (``BalancedCOO`` or ``ELL``)."""
        if self.inner_kind == "balanced":
            return BalancedCOO(self.rows[s], self.cols[s], self.vals[s],
                               self.inner_shape)
        return ELL(self.cols[s], self.vals[s], self.inner_shape, self.lens[s])

    def stacked(self, name: str) -> np.ndarray | None:
        """The field ``name`` as one host array, shards on the leading
        dim (the reference's layout)."""
        parts = getattr(self, name)
        return None if parts is None else np.stack([host(t) for t in parts])


_register_pytree(ShardedSubstrate,
                 ("rows", "cols", "vals", "lens", "src", "scales"))


def _ell_slab(starts, lens, w, indices, data, nnz):
    """One shard's ELL arrays from per-row global stream starts and lengths."""
    j = np.arange(w, dtype=np.int64)[None, :]
    src = starts[:, None].astype(np.int64) + j
    valid = j < lens[:, None]
    if nnz:
        idx = np.clip(src, 0, nnz - 1)
        cols = np.where(valid, indices[idx], 0).astype(np.int32)
        vals = np.where(valid, data[idx], 0).astype(data.dtype)
    else:
        cols = np.zeros(src.shape, np.int32)
        vals = np.zeros(src.shape, data.dtype)
    return cols, vals, np.where(valid, src, -1).astype(np.int32)


def _bal_slab(b0, b1, row_off, sentinel, n_tiles, tile, rows_g, indices, data):
    """One shard's BalancedCOO arrays from the stream slice ``[b0, b1)``: the
    tiling rule of ``csr_to_balanced`` (fixed quota, sentinel padding)."""
    q = b1 - b0
    pad = n_tiles * tile - q
    rows = np.concatenate([rows_g[b0:b1] - row_off,
                           np.full(pad, sentinel, np.int32)]).astype(np.int32)
    cols = np.concatenate([indices[b0:b1], np.zeros(pad, np.int32)]).astype(np.int32)
    vals = np.concatenate([data[b0:b1], np.zeros(pad, data.dtype)])
    src = np.concatenate([np.arange(b0, b1, dtype=np.int32),
                          np.full(pad, -1, np.int32)])
    shp = (n_tiles, tile)
    return rows.reshape(shp), cols.reshape(shp), vals.reshape(shp), src.reshape(shp)


def _host_stacks(indptr, indices, data, shape, spec: ShardSpec,
                 inner_kind: str, tile: int) -> tuple:
    """``(rows, cols, vals, lens, src, inner_shape)`` stacked on the host,
    the reference's construction line for line."""
    m, k = shape
    nnz = len(data)
    n = spec.n_shards
    rows_s = lens_s = None
    if spec.kind == "row":
        inner_shape = (spec.m_pad, k)
        if inner_kind == "ell":
            w = max(1, int(np.diff(indptr).max()) if m else 1)
            cs, vs, ss, ls = [], [], [], []
            for s in range(n):
                r0, r1 = spec.bounds[s], spec.bounds[s + 1]
                starts = np.concatenate([indptr[r0:r1],
                                         np.full(spec.m_pad - (r1 - r0), nnz)])
                lens = np.concatenate([np.diff(indptr[r0:r1 + 1]),
                                       np.zeros(spec.m_pad - (r1 - r0), np.int64)])
                c, v, sr = _ell_slab(starts, lens, w, indices, data, nnz)
                cs.append(c); vs.append(v); ss.append(sr)
                ls.append(lens.astype(np.int32))
            cols_s, vals_s, src_s = np.stack(cs), np.stack(vs), np.stack(ss)
            lens_s = np.stack(ls)
        else:
            quotas = [int(indptr[spec.bounds[s + 1]] - indptr[spec.bounds[s]])
                      for s in range(n)]
            n_tiles = max(1, -(-max(quotas) // tile)) if quotas else 1
            rows_g = row_ids_from_indptr(indptr, nnz)
            rs, cs, vs, ss = [], [], [], []
            for s in range(n):
                b0, b1 = int(indptr[spec.bounds[s]]), int(indptr[spec.bounds[s + 1]])
                r, c, v, sr = _bal_slab(b0, b1, spec.bounds[s], spec.m_pad,
                                        n_tiles, tile, rows_g, indices, data)
                rs.append(r); cs.append(c); vs.append(v); ss.append(sr)
            rows_s, cols_s, vals_s, src_s = map(np.stack, (rs, cs, vs, ss))
    else:
        inner_shape = (m, k)
        if inner_kind == "ell":
            ws, per = [], []
            for s in range(n):
                b0, b1 = spec.bounds[s], spec.bounds[s + 1]
                starts = np.clip(indptr[:-1], b0, b1)
                lens = np.clip(indptr[1:], b0, b1) - starts
                per.append((starts, lens))
                ws.append(int(lens.max()) if m else 0)
            w = max(1, max(ws) if ws else 1)
            cs, vs, ss, ls = [], [], [], []
            for starts, lens in per:
                c, v, sr = _ell_slab(starts, lens, w, indices, data, nnz)
                cs.append(c); vs.append(v); ss.append(sr)
                ls.append(lens.astype(np.int32))
            cols_s, vals_s, src_s = np.stack(cs), np.stack(vs), np.stack(ss)
            lens_s = np.stack(ls)
        else:
            quotas = [spec.bounds[s + 1] - spec.bounds[s] for s in range(n)]
            n_tiles = max(1, -(-max(quotas) // tile)) if quotas else 1
            rows_g = row_ids_from_indptr(indptr, nnz)
            rs, cs, vs, ss = [], [], [], []
            for s in range(n):
                r, c, v, sr = _bal_slab(spec.bounds[s], spec.bounds[s + 1], 0, m,
                                        n_tiles, tile, rows_g, indices, data)
                rs.append(r); cs.append(c); vs.append(v); ss.append(sr)
            rows_s, cols_s, vals_s, src_s = map(np.stack, (rs, cs, vs, ss))
    return rows_s, cols_s, vals_s, lens_s, src_s, inner_shape


def build_sharded_substrate(csr: CSR, spec: ShardSpec, mesh, *,
                            inner_kind: str, tile: int, inner_backend: str,
                            quant: str | None = None) -> ShardedSubstrate:
    """Host-side construction of every shard's substrate, then each moved to
    its shard's device.

    ``quant``: quantize the stacked balanced value slab per (shard, tile),
    one f32 scale each; when a tile's dynamic range fails
    ``quant.check_tile_range`` the slab stays float (``scales=None``,
    ``quant=None``).  ELL inners never quantize."""
    indptr, indices, data = (host(t) for t in (csr.indptr, csr.indices,
                                               csr.data))
    BUILD_COUNTS[inner_kind] += spec.n_shards
    rows_s, cols_s, vals_s, lens_s, src_s, inner_shape = _host_stacks(
        indptr, indices, data, tuple(csr.shape), spec, inner_kind, tile)
    vals_t = torch.from_numpy(np.ascontiguousarray(vals_s))
    scales_t = None
    if quant is not None and inner_kind == "balanced" and \
            quant_mod.check_tile_range(vals_s, context="sharded substrate"):
        vals_t, scales_t = quant_mod.quantize_stream(vals_t, quant)
    else:
        quant = None
    devices = shard_devices(mesh, spec.axis)

    def per_shard(a):
        if a is None:
            return None
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        return tuple(a[s].contiguous().to(d) for s, d in enumerate(devices))

    return ShardedSubstrate(
        rows=per_shard(rows_s), cols=per_shard(cols_s), vals=per_shard(vals_t),
        lens=per_shard(lens_s), src=per_shard(src_s),
        scales=per_shard(scales_t), spec=spec, mesh=mesh,
        inner_backend=inner_backend, inner_kind=inner_kind,
        inner_shape=tuple(inner_shape), shape=tuple(csr.shape),
        nnz=int(csr.nnz), quant=quant)


#: ``visit_start`` code of a padding visit in a stacked schedule: a no-op
#: that re-points at the shard's last (tile, block) pair
VISIT_PAD = 2


def stack_visit_schedules(schedules) -> tuple:
    """Pad ragged per-shard ``plan_visits`` schedules to one dense stack
    ``(vt, vb, vs)``, each ``(n_shards, max_visits)`` int32: padding visits
    borrow the shard's last (tile, block) pair and carry ``VISIT_PAD``.  The
    TPU's prep (its fused kernels read the stack); the Hopper kernels need
    no schedule."""
    vmax = max(len(vt) for vt, _, _ in schedules)
    vts, vbs, vss = [], [], []
    for vt, vb, vs in schedules:
        pad = vmax - len(vt)
        vts.append(np.concatenate([vt, np.full(pad, vt[-1], np.int32)]))
        vbs.append(np.concatenate([vb, np.full(pad, vb[-1], np.int32)]))
        vss.append(np.concatenate([vs, np.full(pad, VISIT_PAD, np.int32)]))
    return np.stack(vts), np.stack(vbs), np.stack(vss)


# ---------------------------------------------------------------------------
# collectives over a list of per-shard tensors
# ---------------------------------------------------------------------------

def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def psum(parts: list) -> list:
    """The sum of the shards' tensors, added in shard order on shard 0's
    device, one copy on each shard's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + _on(p, total.device)
    return [_on(total, p.device) for p in parts]


def pmax(parts: list) -> list:
    """The elementwise max of the shards' tensors, as ``psum``."""
    total = parts[0]
    for p in parts[1:]:
        total = torch.maximum(total, _on(p, total.device))
    return [_on(total, p.device) for p in parts]


def ppermute(parts: list, perm) -> list:
    """``out[j] = parts[i]`` copied to shard j's device for each ``(i, j)``
    of ``perm``; shards no pair sends to get zeros."""
    out = [None] * len(parts)
    for i, j in perm:
        out[j] = _on(parts[i], parts[j].device)
    return [torch.zeros_like(p) if o is None else o
            for o, p in zip(out, parts)]


def _ring_psum(parts: list) -> list:
    """All-reduce as an (n-1)-step shift-add ring: after step t a shard
    holds its own and its t upstream neighbours' partials.  The same sum as
    ``psum``, in another order."""
    n = len(parts)
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc = parts
    for _ in range(n - 1):
        acc = [a + y for a, y in zip(ppermute(acc, perm), parts)]
    return acc


# ---------------------------------------------------------------------------
# where each shard's work is issued
# ---------------------------------------------------------------------------

#: (device, lane) -> the CUDA stream of that lane, made once
_STREAMS: dict = {}


def _stream(device: torch.device, lane) -> torch.cuda.Stream:
    key = (str(device), lane)
    st = _STREAMS.get(key)
    if st is None:
        st = _STREAMS[key] = torch.cuda.Stream(device)
    return st


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


class _Lanes:
    """The shards' streams.  On the CPU ``map`` runs in program order.  On
    CUDA devices shard s's work goes to a stream of its own that first
    waits on its device's current stream; ``join`` makes the current
    streams wait on every lane and hands the outputs over to them
    (``record_stream``, so the allocator does not reuse them early).  The
    ring runs on a stream of its own on a mesh whose shards share one
    device."""

    def __init__(self, devices: tuple):
        self.devices = tuple(torch.device(d) for d in devices)
        self.cuda = all(d.type == "cuda" for d in self.devices)
        self.streams = ([_stream(d, s) for s, d in enumerate(self.devices)]
                        if self.cuda else None)
        self.ring_stream = (_stream(self.devices[0], "ring")
                            if self.cuda and len(set(self.devices)) == 1
                            else None)

    def map(self, fn) -> tuple[list, list | None]:
        """``[fn(s) for each shard]``, each on its lane, and the events
        recorded on the lanes after them (None on the CPU)."""
        if not self.cuda:
            return [fn(s) for s in range(len(self.devices))], None
        outs, events = [], []
        for s, (d, st) in enumerate(zip(self.devices, self.streams)):
            st.wait_stream(torch.cuda.current_stream(d))
            with torch.cuda.stream(st):
                outs.append(fn(s))
            events.append(st.record_event())
        return outs, events

    def join(self, outs: list, lanes=None) -> None:
        """The devices' current streams wait on ``lanes`` (the shards'
        streams by default); ``outs`` are handed over to them."""
        if not self.cuda:
            return
        for d in set(self.devices):
            cur = torch.cuda.current_stream(d)
            for st in (lanes or self.streams):
                cur.wait_stream(st)
            for t in _tensors(outs):
                if t.device == d:
                    t.record_stream(cur)

    def ring(self, parts: list, events) -> torch.Tensor:
        """Shard 0's copy of ``_ring_psum(parts)``; on a shared card on the
        ring's stream after the lanes' ``events``."""
        if self.ring_stream is None:
            self.join(parts)
            return _ring_psum(parts)[0]
        rs = self.ring_stream
        for ev in events:
            rs.wait_event(ev)
        for t in parts:
            t.record_stream(rs)
        with torch.cuda.stream(rs):
            return _ring_psum(parts)[0]


def _record_on_lane(t: torch.Tensor) -> torch.Tensor:
    """Hand a CUDA tensor the current (lane) stream reads over to it."""
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t


def _overlapped_ring(run_chunk, x: torch.Tensor, chunk_w: int,
                     lanes: _Lanes) -> torch.Tensor:
    """Width-chunked all-reduce: ``run_chunk(x_slice)`` issues one chunk's
    per-shard partials (``(outs, events)``); chunk j+1's are issued before
    chunk j's ring, so each ring hides behind the next chunk's kernels."""
    n = x.shape[1]
    n_chunks = -(-n // chunk_w)
    pad = n_chunks * chunk_w - n
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    part = run_chunk(x[:, :chunk_w])
    outs = []
    for j in range(n_chunks):
        nxt = (run_chunk(x[:, (j + 1) * chunk_w:(j + 2) * chunk_w])
               if j + 1 < n_chunks else None)
        outs.append(lanes.ring(*part))
        part = nxt
    if lanes.ring_stream is not None:
        lanes.join(outs, [lanes.ring_stream])
    y = torch.cat(outs, dim=1)
    return y[:, :n] if pad else y


def _reduce(spec: ShardSpec, lanes: _Lanes, run, x: torch.Tensor, m: int,
            overlap_min_n: int | None) -> torch.Tensor:
    """Run ``run(s, x_chunk)`` a shard and reduce per the spec: concat (the
    pad rows stripped) or psum — the ring past ``overlap_min_n``.  The
    result lies on shard 0's device."""
    chunked = (spec.reduction == "psum" and spec.n_shards > 1
               and overlap_min_n is not None and x.ndim == 2
               and x.shape[1] >= max(int(overlap_min_n), RING_CHUNK + 1))
    if chunked:
        return _overlapped_ring(
            lambda xc: lanes.map(lambda s: run(s, xc)), x, RING_CHUNK, lanes)
    ys, _ = lanes.map(lambda s: run(s, x))
    lanes.join(ys)
    if spec.reduction == "concat":
        d0 = lanes.devices[0]
        return torch.cat([_on(y, d0) for y in ys])[:m]
    return psum(ys)[0]


# ---------------------------------------------------------------------------
# the per-shard backward of the matmul family
# ---------------------------------------------------------------------------

_NB_SIBLING = {"rs_sr": "nb_sr", "rs_pr": "nb_pr", "nb_sr": "nb_sr",
               "nb_pr": "nb_pr"}


class _ShardBwd:
    """One shard's backward prep: its pattern in the balanced layout (an
    ELL shard's slab flattened, ``row == Ms`` past each row's length,
    re-tiled at ``_ELL_BWD_TILE`` slots) and its ``PatternPrep`` (the
    SDDMM's opts, the transposed slabs)."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor, shape):
        from .plan import PatternPrep
        self.rows, self.cols = rows, cols
        self.prep = PatternPrep(shape)

    @classmethod
    def of(cls, local) -> "_ShardBwd":
        if isinstance(local, BalancedCOO):
            return cls(local.rows, local.cols, local.shape)
        ms, w = local.cols.shape
        j = torch.arange(w, device=local.cols.device)[None, :]
        r = torch.arange(ms, dtype=torch.int32, device=local.cols.device)[:, None]
        rows = torch.where(j < local.lens[:, None], r, ms).reshape(-1)
        rows, cols = _tiled(rows.to(torch.int32),
                            local.cols.reshape(-1).to(torch.int32), ms,
                            _ELL_BWD_TILE)
        return cls(rows, cols, local.shape)


#: substrate -> its shards' ``_ShardBwd``, built on the first backward
_BWD: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _shard_bwd(sub: ShardedSubstrate, s: int) -> _ShardBwd:
    states = _BWD.get(sub)
    if states is None:
        states = _BWD[sub] = [None] * sub.spec.n_shards
    if states[s] is None:
        states[s] = _ShardBwd.of(sub.local(s))
    return states[s]


class _ShardVJP:
    """The backward products of one shard's inner call (``core/vjp.py``'s
    ``vjp`` protocol): ``dvals`` the SDDMM entry of the inner backend over
    the shard's pattern, ``dx`` the nnz-balanced entry on its transposed
    slabs (a baked slab of codes decoded with ``scales`` first)."""

    def __init__(self, bwd: _ShardBwd, backend: str, logical: str,
                 scales: torch.Tensor | None = None):
        self.bwd, self.backend, self.scales = bwd, backend, scales
        self.entry = registry.resolve(_NB_SIBLING[logical], backend)

    def dvals(self, g2: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return self.bwd.prep.sample(self.bwd.rows, self.bwd.cols, g2, x2,
                                    self.backend)

    def dx(self, vals: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if self.scales is not None:
            vals = quant_mod.dequantize_stream(
                vals.reshape(self.scales.shape[0], -1), self.scales).reshape(-1)
        bal_t, perm = self.bwd.prep.transposed(self.bwd.rows, self.bwd.cols)
        sub = BalancedCOO(bal_t.rows, bal_t.cols, _stream_to_balanced(
            vals.index_select(0, perm), bal_t), bal_t.shape)
        return self.entry.fn(sub, g, **self.bwd.prep.opts(
            self.entry, bal_t, transposed=True))


def _gather_stream(vals: torch.Tensor, src: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The shard's slab of the CSR-ordered stream ``vals``: ``vals[src]``,
    0 where ``src == -1``; differentiable in ``vals``."""
    v = _on(vals.reshape(-1), src.device)
    if v.numel() == 0:
        return torch.zeros(src.shape, dtype=dtype, device=src.device)
    got = v.index_select(0, src.reshape(-1).clamp(min=0).long()).reshape(src.shape)
    return torch.where(src >= 0, got, torch.zeros((), dtype=got.dtype,
                                                  device=got.device)).to(dtype)


# ---------------------------------------------------------------------------
# the "sharded" entries of the matmul family
# ---------------------------------------------------------------------------

def _inner_opts(shards, s: int) -> dict:
    return dict(shards[s]) if shards else {}


def _sharded_prep(sub: ShardedSubstrate, *, _logical: str, geometry=None,
                  max_win=None, overlap_min_n=None) -> dict:
    """The inner entry's prep hook run on each shard's substrate, each with
    a ``shared`` dict of its own (a K3 group, spill windows, an attention
    block layout: one a shard), as ``{"shards": (opts, ...)}``; and the
    overlap cutoff of the ring."""
    from .plan import _prep_context_kwargs
    inner = registry.resolve(_logical, sub.inner_backend)
    shards = []
    for s in range(sub.spec.n_shards):
        if inner.prep is None:
            shards.append({})
            continue
        ctx = _prep_context_kwargs(inner.prep, {"geometry": geometry,
                                                "max_win": max_win,
                                                "shared": {}})
        shards.append(dict(inner.prep(sub.local(s), **ctx)))
    out: dict = {"shards": tuple(shards)}
    if overlap_min_n is not None:
        out["overlap_min_n"] = int(overlap_min_n)
    return out


def freeze_opts(sub: ShardedSubstrate, opts: dict) -> None:
    """Every host step of the per-shard opts done now (a spill call's row
    windows), so that a frozen artifact's call does none."""
    if opts.get("spill"):
        for s, o in enumerate(opts.get("shards", ())):
            if "windows" in o:
                o["windows"](sub.local(s))


def _sharded_exec(sub: ShardedSubstrate, x: torch.Tensor, *, _logical: str,
                  vals: torch.Tensor | None = None, shards=(),
                  overlap_min_n: int | None = None, spill: bool = False,
                  quant: str | None = None) -> torch.Tensor:
    """Run the inner entry once per shard and reduce per the spec.

    ``vals`` is a live CSR-ordered stream, gathered into each shard's slab
    (a quantized plan's live stream is quantized per shard by the inner
    entry, ``quant``); without it the baked slabs run (codes with their
    per-shard scales).  ``spill=True`` forces K4/K5 and the combine in each
    shard's NB inner."""
    inner = registry.resolve(_logical, sub.inner_backend)
    lanes = _Lanes(sub.devices)
    grad = _tracked(x) or (vals is not None and _tracked(vals))

    def run(s: int, xc: torch.Tensor) -> torch.Tensor:
        local = sub.local(s)
        opts = _inner_opts(shards, s)
        if spill:
            opts["spill"] = True
        scales = None
        if sub.inner_kind == "balanced":
            if vals is None and sub.scales is not None:
                scales = opts["scales"] = sub.scales[s]
            elif quant is not None:
                opts["quant"] = quant
        fn = functools.partial(inner.fn, **opts)
        xs = _record_on_lane(_on(xc, local.cols.device))
        if vals is None:
            if not grad:
                return fn(local, xs)
            stream = local.vals.reshape(-1)
        else:
            dtype = local.vals.dtype
            if quant_mod.is_quantized_dtype(dtype):
                dtype = torch.promote_types(vals.dtype, torch.float32)
            stream = _gather_stream(vals, sub.src[s], dtype).reshape(-1)
        vjp = _ShardVJP(_shard_bwd(sub, s), sub.inner_backend, _logical,
                        scales)
        if sub.inner_kind == "balanced":
            return exec_balanced(fn, local, vjp, stream, xs,
                                 baked=vals is None)
        ids = torch.arange(stream.numel(), dtype=torch.int32,
                           device=stream.device).reshape(local.cols.shape)
        return exec_ell(fn, local, ids, vjp, stream, xs, baked=vals is None)

    return _reduce(sub.spec, lanes, run, x, sub.shape[0], overlap_min_n)


for _logical in registry.MATMUL_KERNELS:
    registry.register(
        _logical, "sharded",
        "shard_ell" if _logical.startswith("rs") else "shard_balanced",
        functools.partial(_sharded_exec, _logical=_logical),
        prep=functools.partial(_sharded_prep, _logical=_logical))


# ---------------------------------------------------------------------------
# the sharded SDDMM and chain (DESIGN.md §9)
# ---------------------------------------------------------------------------

def _row_block(a: torch.Tensor, spec: ShardSpec, s: int) -> torch.Tensor:
    """Shard ``s``'s rows of ``a`` under a row split, padded to ``m_pad``."""
    r0, r1 = spec.bounds[s], spec.bounds[s + 1]
    return torch.nn.functional.pad(a[r0:r1], (0, 0, 0, spec.m_pad - (r1 - r0)))


def _operands(sub: ShardedSubstrate, s: int, a, b):
    """Shard ``s``'s ``(rows, cols, a, b)`` on its device: a row split's
    slab carries local row ids (sentinel ``m_pad``) and takes its rows of
    A; an nnz split's global ids (sentinel ``m``) and all of A."""
    d = sub.devices[s]
    a_s = _row_block(a, sub.spec, s) if sub.spec.kind == "row" else a
    return (sub.rows[s], sub.cols[s], _record_on_lane(_on(a_s, d).contiguous()),
            _record_on_lane(_on(b, d).contiguous()))


def _sddmm_sharded(rows, cols, a, b, *, shape, sub: ShardedSubstrate,
                   shards=(), inner_backend: str | None = None,
                   overlap_min_n: int | None = None):
    """Each shard scores its own slab with the inner SDDMM; the slabs
    scatter to the global CSR-ordered ``(nnz,)`` stream through ``src``.
    ``rows`` / ``cols`` are unused (the substrate's slabs are read), as is
    ``overlap_min_n`` (nothing is summed)."""
    inner = registry.resolve("sddmm", inner_backend or sub.inner_backend)
    lanes = _Lanes(sub.devices)

    def run(s: int):
        r, c, a_s, b_s = _operands(sub, s, a, b)
        return inner.fn(r, c, a_s, b_s, shape=sub.inner_shape,
                        **_inner_opts(shards, s))

    slabs, _ = lanes.map(run)
    lanes.join(slabs)
    d0 = lanes.devices[0]
    nnz = sub.nnz
    out = torch.zeros(nnz + 1, dtype=torch.float32, device=d0)
    for slab, src in zip(slabs, sub.src):
        src = _on(src.reshape(-1), d0).long()
        out.index_add_(0, torch.where(src >= 0, src, nnz),
                       _on(slab.reshape(-1), d0).float())
    return out[:nnz]


def _chain_stats_fn(backend: str):
    """The softmax statistics (K7 on ``"hopper"``) of the inner backend."""
    if backend == "hopper":
        from ..kernels.fused_chain import chain_stats_fused
        return chain_stats_fused
    from .spmm import chain_stats_torch
    return lambda *args, blocks=None, **kw: chain_stats_torch(*args, **kw)


def _chain_sharded(rows, cols, a, b, x, *, shape, sub: ShardedSubstrate,
                   shards=(), transform: str = "identity", alpha=None,
                   inner_backend: str | None = None,
                   overlap_min_n: int | None = None, fuse: bool = True):
    """The fused SDDMM→transform→SpMM a shard.  Row-split shards own their
    rows, so the softmax statistics are local and the reduction a concat.
    nnz-split softmax runs K7 a shard and merges the statistics (``pmax``
    of the maxes, ``psum`` of the rescaled sums) before K8 runs a shard on
    them; the partials psum, or ride the ring at ``N >= overlap_min_n``
    (the statistics computed once, outside the chunk loop).  ``fuse=False``
    is the inner fuse gate shut (the unfused kernels a shard)."""
    inner_backend = inner_backend or sub.inner_backend
    inner = registry.resolve("chain", inner_backend)
    spec = sub.spec
    lanes = _Lanes(sub.devices)
    extra = {} if fuse else {"fuse": False}
    x2 = x[:, None] if x.ndim == 1 else x
    stats = None
    if transform == "softmax" and spec.kind == "nnz" and spec.n_shards > 1:
        stats_fn = _chain_stats_fn(inner_backend)

        def local_stats(s: int):
            r, c, a_s, b_s = _operands(sub, s, a, b)
            rm, rs = stats_fn(r, c, a_s, b_s, shape=sub.inner_shape,
                              alpha=alpha,
                              blocks=_inner_opts(shards, s).get("blocks"))
            return rm, rs

        local, _ = lanes.map(local_stats)
        lanes.join(local)
        rm_g = pmax([rm for rm, _ in local])
        rs_g = psum([rs * torch.exp(rm - g) for (rm, rs), g in zip(local, rm_g)])
        stats = list(zip(rm_g, rs_g))

    def run(s: int, xc: torch.Tensor) -> torch.Tensor:
        r, c, a_s, b_s = _operands(sub, s, a, b)
        return inner.fn(r, c, a_s, b_s,
                        _record_on_lane(_on(xc, r.device).contiguous()),
                        shape=sub.inner_shape, transform=transform,
                        alpha=alpha, stats=None if stats is None else stats[s],
                        **_inner_opts(shards, s), **extra)

    y = _reduce(spec, lanes, run, x2, sub.shape[0], overlap_min_n)
    return y[:, 0] if x.ndim == 1 else y


registry.register("sddmm", "sharded", "shard_balanced", _sddmm_sharded,
                  prep=functools.partial(_sharded_prep, _logical="sddmm"))
registry.register("chain", "sharded", "shard_balanced", _chain_sharded,
                  prep=functools.partial(_sharded_prep, _logical="chain"))


# ---------------------------------------------------------------------------
# the plan-free sharded entry of trainable patterns (sparse-weight layers)
# ---------------------------------------------------------------------------

def pattern_split(rows: torch.Tensor, cols: torch.Tensor, shape, devices,
                  entry: registry.KernelEntry) -> tuple[list, int]:
    """A bare balanced pattern's tiles split evenly over ``devices`` (the
    tail padded with ``row == M`` to equal shares): ``([(local
    BalancedCOO, entry's prep opts, _ShardBwd) a shard], tiles a shard)``,
    each shard's slabs on its device.  Memoised on the pattern's
    ``PatternPrep`` (the identity and version counters of ``rows`` and
    ``cols``, ``plan.pattern_prep``), never hashed."""
    from .plan import pattern_prep
    shape = tuple(int(s) for s in shape)
    t = rows.shape[0]
    n = len(devices)
    per = -(-t // n)
    prep = pattern_prep(rows, cols, shape)
    key = (tuple(str(d) for d in devices), entry.logical, entry.backend)
    split = prep.shards.get(key)
    if split is None:
        pad = per * n - t
        rp = torch.nn.functional.pad(rows, (0, 0, 0, pad), value=shape[0])
        cp = torch.nn.functional.pad(cols, (0, 0, 0, pad))
        split = []
        for s, d in enumerate(devices):
            local = BalancedCOO(rp[s * per:(s + 1) * per].contiguous().to(d),
                                cp[s * per:(s + 1) * per].contiguous().to(d),
                                None, shape)
            opts = {} if entry.prep is None else dict(entry.prep(local))
            split.append((local, opts, _ShardBwd.of(local)))
        prep.shards[key] = split
    return split, per


def run_pattern_shard(split: list, s: int, entry: registry.KernelEntry,
                      backend: str, vals: torch.Tensor, x: torch.Tensor,
                      quant: str | None = None) -> torch.Tensor:
    """Shard ``s`` of ``pattern_split``'s split times ``x``: its kernel on
    its value slab ``vals`` (``(tiles a shard, tile)``), differentiable in
    both (the SDDMM for ``vals``, the nb kernel on the shard's transposed
    slabs for ``x``), on the shard's device."""
    local, opts, bwd = split[s]
    fn = functools.partial(entry.fn, **(opts if quant is None
                                        else dict(opts, quant=quant)))
    return exec_balanced(fn, local, _ShardVJP(bwd, backend, entry.logical),
                         _on(vals, local.rows.device),
                         _record_on_lane(_on(x, local.rows.device)))


def execute_pattern_sharded(rows: torch.Tensor, cols: torch.Tensor,
                            vals: torch.Tensor, shape, x: torch.Tensor, *,
                            mesh, axis: str | None = None,
                            impl: str = "nb_pr", backend: str | None = None,
                            quant: str | None = None) -> torch.Tensor:
    """Split a bare balanced pattern's tiles evenly over ``axis`` (the
    pattern is nnz-balanced already, so equal tiles are the nnz
    partitioner, ``pattern_split``) and psum the partials.  ``backend`` is
    the inner backend (``None``: the one of the first shard's device)."""
    axis = axis or default_shard_axis(mesh)
    devices = shard_devices(mesh, axis)
    n = len(devices)
    backend = backend or default_inner_backend(devices[0])
    entry = registry.resolve(impl, backend)
    if entry.substrate != "balanced":
        raise ValueError(f"execute_pattern_sharded needs a balanced-substrate "
                         f"kernel; {impl!r} consumes {entry.substrate!r}")
    t, tile = rows.shape
    split, per = pattern_split(rows, cols, shape, devices, entry)
    v2 = torch.nn.functional.pad(vals.reshape(t, tile), (0, 0, 0, per * n - t))
    lanes = _Lanes(devices)
    spec = ShardSpec("nnz", axis, n, "psum", tuple(0 for _ in range(n + 1)))

    def run(s: int, xc: torch.Tensor) -> torch.Tensor:
        return run_pattern_shard(split, s, entry, backend,
                                 v2[s * per:(s + 1) * per], xc, quant)

    return _reduce(spec, lanes, run, x, int(shape[0]), None)


def default_inner_backend(device) -> str:
    """The inner backend of a sharded plan on ``device``: the
    ``use_backend`` scope (unless it names ``"sharded"``), else
    ``"hopper"`` on a CUDA device and ``"torch"`` on the CPU."""
    scoped = registry.scoped_backend()
    if scoped is not None and scoped != "sharded":
        return scoped
    return "hopper" if torch.device(device).type == "cuda" else "torch"
