"""Time K3 (the row-split SpMM on ELL) on the uniform scale-20 R-MAT graph
of ``chip_smoke.py`` (a, b, c = .25, .25, .25, edge factor 16, seed 0) at
its four (design, N) points — sr at N = 32 and 128, pr at N = 1 and 4 —
beside ``torch.sparse.mm`` on the same CSR.

    python3 tools/time_csc.py LABEL

Run from the root of a checkout on a CUDA card.  It prints one JSON line of
device times in ms: the mean of 20 back-to-back calls between two CUDA
events, median of 7 such runs after a warm-up, keyed ``<design>_N<n>``.
Where the tree has K3's two designs (``csc.DESIGN_LAUNCHES``), it also times
the sr design at every lane count (``sr_N<n>_g<lanes>``: fewer lanes make
narrower column slabs of X, run one after another) and the pr design at
every group (``pr_N<n>_p<group>``); a tree with one K3 kernel times that
kernel at each point, and the sr design with a bfloat16 X at N = 128
(``sr_bf16_N128[_g<lanes>]``).  Every timed variant is first held against
the plain version (relative inf-norm error at most 1e-4, 2e-2 with a
bfloat16 X).  To compare two trees on
one card, unpack the other tree into a directory of this one that
``.gitignore`` lists and run the script from each root in turn, e.g.
parent, change, change, parent."""
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd() / "src"))

import torch  # noqa: E402

from repro_torch.core import formats  # noqa: E402
from repro_torch.core.rmat import rmat  # noqa: E402
from repro_torch.kernels import _build, csc  # noqa: E402

POINTS = (("sr", 32), ("sr", 128), ("pr", 1), ("pr", 4))


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
        print("time_csc: no CUDA device", file=sys.stderr)
        return 2
    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    csr = rmat(20, 16, 0.25, 0.25, 0.25, seed=0, device=dev)
    ell = formats.csr_to_ell(csr)
    lib_a = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                    size=csr.shape, check_invariants=False)
    two_designs = hasattr(csc, "DESIGN_LAUNCHES")
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else ".",
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip().splitlines()[0],
           "nnz": csr.nnz, "width": ell.width}

    def timed(key, fn, want, tol=1e-4):
        rel = float((fn().float() - want).abs().max() / want.abs().max())
        if not rel <= tol:
            raise SystemExit(f"time_csc: {key} disagrees with the plain "
                             f"version (rel_inf_err {rel:.3e})")
        out[key] = back_to_back_ms(fn)

    for design, n in POINTS:
        x = torch.randn(csr.shape[1], n, device=dev, generator=gen)
        want = csc.spmm_csc_plain(ell, x).float()
        if not two_designs:
            timed(f"{design}_N{n}", lambda: csc.spmm_csc(ell, x), want)
        else:
            group = csc.pr_group(ell) if design == "pr" else None
            timed(f"{design}_N{n}",
                  lambda: csc.spmm_csc(ell, x, design, group=group), want)
            x2 = csc._check(ell, x)
            if design == "sr":
                for g in (1, 2, 4, 8, 16, 32):
                    if g <= csc.sr_lanes(n):
                        timed(f"sr_N{n}_g{g}",
                              lambda: csc._launch("sr", ell, x2, lanes=g), want)
            else:
                out[f"pr_N{n}_group"] = group
                for p in (8, 16, 32):
                    timed(f"pr_N{n}_p{p}",
                          lambda: csc._launch("pr", ell, x2, lanes=p), want)
        out[f"sparse_mm_N{n}"] = back_to_back_ms(lambda: lib_a @ x)
        del x, want
        torch.cuda.empty_cache()
    if two_designs:
        # bf16 X at N = 128: a lane's 4 columns are 8 bytes
        x = torch.randn(csr.shape[1], 128, device=dev, generator=gen).bfloat16()
        want = csc.spmm_csc_plain(ell, x).float()
        timed("sr_bf16_N128", lambda: csc.spmm_csc(ell, x, "sr"), want, 2e-2)
        for g in (4, 8, 16, 32):
            timed(f"sr_bf16_N128_g{g}",
                  lambda: csc._launch("sr", ell, x, lanes=g), want, 2e-2)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
