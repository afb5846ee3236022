"""Time the spill path (K4, K5 and their combine) on the uniform scale-20
R-MAT graph of ``chip_smoke.py`` (a, b, c = .25, .25, .25, edge factor 16,
seed 0; tiles of 512 nonzeros, the planned windows) at N = 1, 4, 32 and
128, beside ``torch.sparse.mm`` on the same CSR and the neighbouring
kernels K1, K2 and K3.

    python3 tools/time_spill.py LABEL

Run from the root of a checkout on a CUDA card.  It prints one JSON line of
device times in ms: the mean of 20 back-to-back calls between two CUDA
events, median of 7 such runs after a warm-up.  Keys, per N: ``k4_N<n>``
(``k5_N1``) the kernel alone, ``combine_N<n>`` the combine alone,
``call_N<n>`` the spill call through a plan with ``spill=True`` (the
kernel and the combine), ``sparse_mm_N<n>``, ``fused_N<n>`` K1 (K2), and at
N = 32 and 128 ``k3_N<n>`` (K3 as the plan routes it); where the tree lets
a call force K4's lanes (``vsr.spill_lanes``), ``k4_N<n>_g<lanes>`` at
every lane count.  Beside the kernels, the combine and the call, a key
with ``_graph`` holds the device time alone: 20 calls captured in one CUDA
graph and replayed (median of 7), without the host's work between
launches, which back-to-back calls of a kernel shorter than that work
measure instead (null where the tree's call cannot be captured).  Every
timed variant is first held against its plain version (relative inf-norm
error at most 1e-4).  The script runs on a tree
whose combine is PyTorch's ``index_add_`` too, so that two trees can be
compared on one card: unpack the other tree into a directory of this one
that ``.gitignore`` lists and run the script from each root in turn, e.g.
parent, change, change, parent."""
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd() / "src"))

import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.core.rmat import rmat  # noqa: E402
from repro_torch.kernels import _build, csc, spmv, vsr  # noqa: E402

NS = (1, 4, 32, 128)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("time_spill: no CUDA device", file=sys.stderr)
        return 2
    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    csr = rmat(20, 16, 0.25, 0.25, 0.25, seed=0, device=dev)
    m = csr.shape[0]
    bal = formats.csr_to_balanced(csr, 512)
    base, win = vsr.SpillWindows()(bal)
    ell = formats.csr_to_ell(csr)
    lib_a = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                    size=csr.shape, check_invariants=False)
    S = repro_torch.sparse(csr, cache=False)
    S.plan.kernel_opts(S.plan.entry("nb_pr"))["spill"] = True
    # the combine without a check of row_base, and its plain version (a
    # tree whose combine is index_add_ has no other)
    combine = getattr(vsr, "_combine", vsr.spill_combine)
    combine_plain = getattr(vsr, "spill_combine_plain", vsr.spill_combine)
    lanes_of = getattr(vsr, "spill_lanes", None)
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else ".",
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip().splitlines()[0],
           "nnz": csr.nnz, "n_tiles": bal.n_tiles, "win": win}

    def timed(key, fn, want, graph=False):
        rel = float((fn().float() - want.float()).abs().max()
                    / want.float().abs().max())
        if not rel <= 1e-4:
            raise SystemExit(f"time_spill: {key} disagrees with the plain "
                             f"version (rel_inf_err {rel:.3e})")
        out[key] = back_to_back_ms(fn)
        if graph:
            out[f"{key}_graph"] = graph_ms(fn)

    for n in NS:
        x = (torch.randn(csr.shape[1], n, device=dev, generator=gen) if n > 1
             else torch.randn(csr.shape[1], device=dev, generator=gen))
        x2 = x if n > 1 else x[:, None]
        want_part = vsr.spill_partials_plain(bal, x2, base, win)
        if n == 1:
            want_part = want_part[..., 0]
            timed("k5_N1", lambda: spmv.spmv_vsr_partials(bal, x, base, win),
                  want_part, graph=True)
            part = spmv.spmv_vsr_partials(bal, x, base, win)
            timed("fused_N1", lambda: spmv.spmv_vsr_fused(bal, x),
                  spmv.spmv_vsr_plain(bal, x))
        else:
            timed(f"k4_N{n}", lambda: vsr.spmm_vsr_partials(bal, x, base, win),
                  want_part, graph=True)
            if lanes_of is not None:
                for g in (1, 2, 4, 8, 16, 32):
                    if lanes_of(n) // 4 <= g <= lanes_of(n):
                        timed(f"k4_N{n}_g{g}", lambda: vsr.spmm_vsr_partials(
                            bal, x, base, win, lanes=g), want_part)
            part = vsr.spmm_vsr_partials(bal, x, base, win)
            timed(f"fused_N{n}", lambda: vsr.spmm_vsr_fused(bal, x),
                  vsr.spmm_vsr_plain(bal, x))
        del want_part
        want_y = combine_plain(part, base, m)
        timed(f"combine_N{n}", lambda: combine(part, base, m), want_y, graph=True)
        del part
        timed(f"call_N{n}", lambda: S.matmul(x, impl="nb_pr"), want_y, graph=True)
        out[f"sparse_mm_N{n}_graph"] = graph_ms(lambda: lib_a @ x2)
        del want_y
        out[f"sparse_mm_N{n}"] = back_to_back_ms(lambda: lib_a @ x2)
        if n >= 32:
            timed(f"k3_N{n}", lambda: csc.spmm_csc(ell, x),
                  csc.spmm_csc_plain(ell, x))
        del x, x2
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
