"""Time the GAT chain's kernels and their neighbours back to back on the two
scale-20 R-MAT graphs of ``chip_smoke.py`` (edge factor 16, seed 0:
Graph500 a, b, c = .57, .19, .19 and uniform .25, .25, .25), with A and B
of width d = 64 (x0.3) and alpha = 0.125.

    python3 tools/time_chain.py LABEL

Run from the root of a checkout on a CUDA card.  It prints one JSON line of
device times in ms: the mean of 20 back-to-back calls between two CUDA
events, median of 7 such runs after a warm-up.  Keys, per graph (``g500_``,
``unif_``): ``k6`` (SDDMM), ``k7_full`` (the slot-tile K7, every row),
``k7_edge`` (its edge mode, where the tree has one, beside
``edge_slot_share``, the share of slots in the tiles' first and last
runs), ``k8_N<n>`` (the slot-tile K8 alone as the fused chain runs it: on
K7's edge statistics where the tree has an edge mode, else on every row's),
``k8_given_N<n>`` (K8 on every row's statistics), ``fused_N<n>`` (the fused
softmax call, K7 then K8) and ``unfused_N<n>`` (K6, K7, the weights, K1 or
K2); on g500 also ``k8_identity_N32`` and ``k8_scale_N32``, ``k1_N128``,
``k2_N1`` and the slot-tile ``k9`` / ``k10`` (with a bias, d = N = 64); on
the uniform graph ``k3_N128`` (K3's routed design).  Every timed call is
first held against its plain version (relative inf-norm error at most
1e-4).  It runs on a tree without K7's edge mode too: to compare two trees
on one card, unpack the other tree into a directory of this one that
``.gitignore`` lists and run the script from each root in turn (parent,
change, change, parent)."""
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd() / "src"))

import torch  # noqa: E402

from repro_torch.core import formats  # noqa: E402
from repro_torch.core.rmat import rmat  # noqa: E402
from repro_torch.kernels import (_build, attention, csc, fused_chain,  # noqa: E402
                                 spmv, vsr)

GRAPHS = {"g500": (0.57, 0.19, 0.19), "unif": (0.25, 0.25, 0.25)}
NS = {"g500": (1, 32, 128), "unif": (1, 32, 128)}
D, ALPHA = 64, 0.125


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


def main() -> int:
    if not torch.cuda.is_available():
        print("time_chain: no CUDA device", file=sys.stderr)
        return 2
    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    edge_mode = hasattr(fused_chain, "STATS_MODES")
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else ".",
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip().splitlines()[0],
           "edge_mode": edge_mode}

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def timed(key, fn, want=None):
        if want is not None:
            got = fn()
            got, want = (torch.cat([t.reshape(-1) for t in v]) if
                         isinstance(v, tuple) else v.reshape(-1)
                         for v in (got, want))
            keep = want > -1e29        # a row max of an empty row is -1e30
            rel = float((got[keep] - want[keep]).abs().max()
                        / want[keep].abs().max())
            if not rel <= 1e-4:
                raise SystemExit(f"time_chain: {key} disagrees with the "
                                 f"plain version (rel_inf_err {rel:.3e})")
        out[key] = back_to_back_ms(fn)

    for name, (a_, b_, c_) in GRAPHS.items():
        csr = rmat(20, 16, a_, b_, c_, seed=0, device=dev)
        bal = formats.csr_to_balanced(csr, 512)
        m, k = csr.shape
        a, b = 0.3 * randn(m, D), 0.3 * randn(k, D)
        pat = (bal.rows, bal.cols, a, b)
        kw = dict(shape=csr.shape, alpha=ALPHA)
        # the pattern's routing, found once (the plan's cache): the slot-tile
        # design
        blocks = attention.AttnBlocks()
        p = f"{name}_"
        timed(p + "k6", lambda: fused_chain.sddmm_fused(*pat, shape=csr.shape),
              fused_chain.sddmm_plain(*pat, shape=csr.shape))
        full = fused_chain.chain_stats_plain(*pat, **kw)
        timed(p + "k7_full", lambda: fused_chain._launch_stats("slot", *pat, **kw),
              full)
        stats_k8, k8_kw = full, {}
        if edge_mode:
            edge = fused_chain.chain_stats_edge_plain(*pat, **kw)
            timed(p + "k7_edge", lambda: fused_chain._launch_stats(
                "slot", *pat, edge=True, **kw), edge)
            valid = int((bal.rows < m).sum())
            out[p + "edge_slot_share"] = int(fused_chain.edge_slots(
                bal.rows, m).sum()) / valid
            stats_k8, k8_kw = edge, {"edge_stats": True}
        for n in NS[name]:
            x = randn(k, n) if n > 1 else randn(k)
            ckw = dict(kw, transform="softmax")
            want = fused_chain.chain_plain(*pat, x, **ckw)
            timed(f"{p}k8_N{n}", lambda: fused_chain._launch_chain(
                "slot", *pat, x, stats=stats_k8, **k8_kw, **ckw), want)
            timed(f"{p}k8_given_N{n}", lambda: fused_chain._launch_chain(
                "slot", *pat, x, stats=full, **ckw), want)
            timed(f"{p}fused_N{n}", lambda: fused_chain._launch_chain(
                "slot", *pat, x, **ckw), want)
            timed(f"{p}unfused_N{n}", lambda: fused_chain.chain_unfused(
                *pat, x, blocks=blocks, **ckw), want)
            if name == "g500" and n == 32:
                for transform, alpha in (("identity", None), ("scale", ALPHA)):
                    tkw = dict(shape=csr.shape, transform=transform, alpha=alpha)
                    timed(f"{p}k8_{transform}_N{n}",
                          lambda: fused_chain.chain_fused(*pat, x, **tkw),
                          fused_chain.chain_plain(*pat, x, **tkw))
            del x, want
        if name == "g500":
            x = randn(k, 128)
            timed(p + "k1_N128", lambda: vsr.spmm_vsr_fused(bal, x),
                  vsr.spmm_vsr_plain(bal, x))
            x1 = randn(k)
            timed(p + "k2_N1", lambda: spmv.spmv_vsr_fused(bal, x1),
                  spmv.spmv_vsr_plain(bal, x1))
            slab = 0.1 * randn(*bal.rows.shape)
            v = randn(k, D)
            akw = dict(shape=csr.shape, scale=ALPHA)
            st = attention.attn_stats_plain(*pat, slab, **akw)
            timed(p + "k9", lambda: attention._launch_stats(
                "slot", *pat, slab, **akw), st)
            timed(p + "k10", lambda: attention._launch_chain(
                "slot", *pat, slab, v, stats=st, **akw),
                attention.attn_chain_plain(*pat, slab, v, stats=st, **akw))
            del x, x1, slab, v, st
        else:
            ell = formats.csr_to_ell(csr)
            x = randn(k, 128)
            timed(p + "k3_N128", lambda: csc.spmm_csc(ell, x),
                  csc.spmm_csc_plain(ell, x))
            del ell, x
        del csr, bal, a, b, pat, full, stats_k8, blocks
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
