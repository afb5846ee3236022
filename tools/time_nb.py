"""Time the nnz-balanced kernels of the main path — K2 and K1 in its sr and
pr designs — on the two scale-20 R-MAT graphs of ``chip_smoke.py``
(Graph500 a, b, c = .57, .19, .19 and uniform .25, .25, .25; edge factor 16,
seed 0; tiles of 512 nonzeros) at N = 1, 4, 32 and 128, beside
``torch.sparse.mm`` on the same CSR.

    python3 tools/time_nb.py LABEL

Run from the root of a checkout on a CUDA card.  It prints one JSON line a
graph of device times in ms: the mean of 20 back-to-back calls between two
CUDA events, median of 7 such runs after a warm-up; a key with ``_graph``
holds the same calls replayed from one CUDA graph (device time alone,
without the host's work between launches).  Keys, per graph and N:
``k2_N1`` (K2), ``k1_N<n>`` (K1 as a call that names no design takes it),
``k1_sr_N<n>`` and ``k1_pr_N<n>`` (each design forced, where the tree's
``vsr.spmm_vsr_fused`` takes a design), ``sparse_mm_N<n>``, and
``bound_N<n>``: max(bytes / 3.35 TB/s, 2·nnz·N / 165 TFLOP/s) with bytes =
12·nnz + 4·K·N + 4·M·N, each input read once and each output written once.
Every timed kernel is first held against its plain version (relative
inf-norm error at most 1e-4).  The line names the card and its power
limit (``nvidia-smi``).  To compare two trees on one card, unpack the
other tree into a directory of this one that ``.gitignore`` lists and run
the script from each root in turn, e.g. parent, change, change, parent
(``(cd .chipwork/parent && python3 ../../tools/time_nb.py parent)``)."""
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd() / "src"))

import torch  # noqa: E402

from repro_torch.core import formats  # noqa: E402
from repro_torch.core.rmat import rmat  # noqa: E402
from repro_torch.kernels import _build, spmv, vsr  # noqa: E402

NS = (1, 4, 32, 128)
GRAPHS = {"g500": (0.57, 0.19, 0.19), "unif": (0.25, 0.25, 0.25)}
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 495e12 / 3


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
        print("time_nb: no CUDA device", file=sys.stderr)
        return 2
    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    designs = ("sr", "pr") if "design" in inspect.signature(
        vsr.spmm_vsr_fused).parameters else ()
    for name, (a, b, c) in GRAPHS.items():
        csr = rmat(20, 16, a, b, c, seed=0, device=dev)
        m, k = csr.shape
        bal = formats.csr_to_balanced(csr, 512)
        lib_a = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                        size=csr.shape, check_invariants=False)
        out = {"tree": sys.argv[1] if len(sys.argv) > 1 else ".",
               "card": card, "graph": f"{name}_s20_e16", "nnz": csr.nnz,
               "n_tiles": bal.n_tiles}

        def timed(key, fn, want):
            rel = float((fn().float() - want.float()).abs().max()
                        / want.float().abs().max())
            if not rel <= 1e-4:
                raise SystemExit(f"time_nb: {name} {key} disagrees with the "
                                 f"plain version (rel_inf_err {rel:.3e})")
            out[key] = back_to_back_ms(fn)
            out[f"{key}_graph"] = graph_ms(fn)

        for n in NS:
            x = (torch.randn(k, n, device=dev, generator=gen) if n > 1
                 else torch.randn(k, device=dev, generator=gen))
            x2 = x if n > 1 else x[:, None]
            t_bytes = (12 * csr.nnz + 4 * k * n + 4 * m * n) / H100_BYTES_PER_S
            t_ops = 2 * csr.nnz * n / H100_F32_FLOP_PER_S
            out[f"bound_N{n}"] = 1e3 * max(t_bytes, t_ops)
            if n == 1:
                timed("k2_N1", lambda: spmv.spmv_vsr_fused(bal, x),
                      spmv.spmv_vsr_plain(bal, x))
            else:
                want = vsr.spmm_vsr_plain(bal, x)
                timed(f"k1_N{n}", lambda: vsr.spmm_vsr_fused(bal, x), want)
                for design in designs:
                    timed(f"k1_{design}_N{n}",
                          lambda: vsr.spmm_vsr_fused(bal, x, design), want)
                del want
            out[f"sparse_mm_N{n}"] = back_to_back_ms(lambda: lib_a @ x2)
            out[f"sparse_mm_N{n}_graph"] = graph_ms(lambda: lib_a @ x2)
            del x, x2
            torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
        del csr, bal, lib_a
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
