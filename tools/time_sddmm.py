"""Time K6, the SDDMM, on the two scale-20 R-MAT graphs of ``chip_smoke.py``
(Graph500 a, b, c = .57, .19, .19 and uniform .25, .25, .25; edge factor
16, seed 0; tiles of 512 slots) and on one head of Gemma-3-12B's local
attention layer (the causal band of 16 blocks of 64 at seq 8192, d = 256),
beside ``torch.sparse.sampled_addmm`` (cuSPARSE SDDMM) on the same CSR.

    python3 tools/time_sddmm.py LABEL [--only g500-d64-float32,unif-d64-float32]

Run from the root of a checkout on a CUDA card.  It prints one JSON line a
point (graph, d, type) of device times in ms: the mean of 20 back-to-back
calls between two CUDA events, median of 7 such runs after a warm-up; a key
with ``_graph`` holds the same calls replayed from one CUDA graph (device
time alone).  Points: g500 at d = 1, 4, 32, 64, 128, 256 in float32 and 64
in bfloat16, the uniform graph at d = 64, the Gemma head.  Keys: ``k6``
(K6 as a call that names no design takes it, with ``design``, the design
it took, where the tree counts them), ``k6_seq`` and ``k6_par`` (each
design forced, where the tree's ``fused_chain._launch_sddmm`` takes one),
``sampled_addmm`` (null where PyTorch refuses the type), ``bound``:
max(bytes / 3.35 TB/s, 2·nnz·d / rate) with bytes = 12·S + (M + K)·d·e
(S slab slots, e the element size; each input read once, the scores
written once) and the f32 rate at 3×TF32 (165 TFLOP/s) or bf16's 989, and
``gather_bytes``, what a one-pass kernel gathers: one B row a slot and one
A row a run of equal rows in a tile.  Every timed call is first held
against the plain version (relative inf-norm error at most 1e-4; padding
slots exactly 0).  The line names the card and its power limit
(``nvidia-smi``).  To compare two trees on one card, unpack the other tree
into a directory of this one that ``.gitignore`` lists and run the script
from each root in turn, e.g. parent, change, change, parent
(``(cd .chipwork/parent && python3 ../../tools/time_sddmm.py parent)``).
``--only`` keeps the points it names."""
import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd() / "src"))

import torch  # noqa: E402

from repro_torch.configs import gemma3_12b  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.core.rmat import rmat  # noqa: E402
from repro_torch.attention import patterns  # noqa: E402
from repro_torch.kernels import _build, fused_chain, reset_launch_counts  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

GRAPHS = {"g500": (0.57, 0.19, 0.19), "unif": (0.25, 0.25, 0.25)}
#: (graph, d, type) of each point
POINTS = ([("g500", d, torch.float32) for d in (1, 4, 32, 64, 128, 256)]
          + [("g500", 64, torch.bfloat16), ("unif", 64, torch.float32),
             ("gemma", 256, torch.float32)])
H100_BYTES_PER_S = 3.35e12
FLOP_PER_S = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
ATTN_SEQ = 8192


def back_to_back_ms(fn, calls=20, runs=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def graph_ms(fn, calls=20, runs=7):
    """Device time of one call: ``calls`` calls captured in a CUDA graph,
    the graph replayed ``runs`` times between two events (median)."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError:
        return None
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def plain_chunked(rows, cols, a, b, shape, tiles=2048):
    """The plain version, a chunk of tiles at a time (its gathers at d =
    256 would hold 16 GB each)."""
    return torch.cat([fused_chain.sddmm_plain(rows[i:i + tiles], cols[i:i + tiles], a, b,
                                              shape=shape)
                      for i in range(0, rows.shape[0], tiles)])


def runs_of(rows, m: int) -> int:
    """Runs of equal rows within a tile, padding excluded."""
    new = torch.ones_like(rows, dtype=torch.bool)
    new[:, 1:] = rows[:, 1:] != rows[:, :-1]
    return int((new & (rows < m)).sum())


def patterns_on(dev):
    """name -> (CSR, BalancedCOO of 512-slot tiles)."""
    out = {}
    for name, (a, b, c) in GRAPHS.items():
        csr = rmat(20, 16, a, b, c, seed=0, device=dev)
        out[name] = (csr, formats.csr_to_balanced(csr, 512))
    gemma = dataclasses.replace(gemma3_12b.CONFIG, attn_pattern="block_sparse")
    csr = patterns.build_mask(transformer._block_sparse_spec(gemma, ATTN_SEQ, True)).csr
    csr = csr.to(dev)
    out["gemma"] = (csr, formats.csr_to_balanced(csr, 512))
    return out


def point_name(name: str, d: int, dtype) -> str:
    return f"{name}-d{d}-{str(dtype).split('.')[1]}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default=".")
    ap.add_argument("--only", default="",
                    help="comma-separated points, e.g. g500-d64-float32")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    if not torch.cuda.is_available():
        print("time_sddmm: no CUDA device", file=sys.stderr)
        return 2
    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    forced = hasattr(fused_chain, "_launch_sddmm")
    counted = "sddmm" in getattr(fused_chain, "DESIGN_LAUNCHES", {})
    pats = patterns_on(dev)
    for name, d, dtype in POINTS:
        if only and point_name(name, d, dtype) not in only:
            continue
        csr, bal = pats[name]
        m, k = csr.shape
        a = (0.3 * torch.randn(m, d, device=dev, generator=gen)).to(dtype)
        b = (0.3 * torch.randn(k, d, device=dev, generator=gen)).to(dtype)
        pat = (bal.rows, bal.cols, a, b)
        e = a.element_size()
        slots = bal.rows.numel()
        t_bytes = (12 * slots + (m + k) * d * e) / H100_BYTES_PER_S
        t_ops = 2 * csr.nnz * d / FLOP_PER_S[dtype]
        out = {"tree": args.label, "card": card,
               "point": point_name(name, d, dtype), "nnz": csr.nnz,
               "bound": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "gather_bytes": (csr.nnz + runs_of(bal.rows, m)) * d * e}
        want = plain_chunked(*pat, csr.shape)

        def timed(key, fn):
            got = fn()
            rel = float((got - want).abs().max() / want.abs().max())
            if not rel <= 1e-4 or not (got.reshape(-1)[csr.nnz:] == 0).all():
                raise SystemExit(f"time_sddmm: {out['point']} {key} disagrees with "
                                 f"the plain version (rel_inf_err {rel:.3e})")
            out[key] = back_to_back_ms(fn)
            out[f"{key}_graph"] = graph_ms(fn)

        if counted:
            reset_launch_counts()
        timed("k6", lambda: fused_chain.sddmm_fused(*pat, shape=csr.shape))
        if counted:
            out["design"] = [dd for dd, nn in fused_chain.DESIGN_LAUNCHES["sddmm"].items()
                             if nn]
        if forced:
            for design in ("seq", "par"):
                timed(f"k6_{design}", lambda: fused_chain._launch_sddmm(
                    design, *pat, shape=csr.shape))
        try:
            lib_a = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data.to(dtype),
                                            size=csr.shape, check_invariants=False)
            b_t = b.t()
            lib = lambda: torch.sparse.sampled_addmm(lib_a, a, b_t, beta=0.0)  # noqa: E731
            lib()
            out["sampled_addmm"] = back_to_back_ms(lib)
        except RuntimeError as err:
            out["sampled_addmm"] = None
            out["sampled_addmm_error"] = str(err).splitlines()[0][:120]
        print(json.dumps(out), flush=True)
        del a, b, pat, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
