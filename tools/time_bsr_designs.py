"""Time K11's two designs on the block-pruned Gemma-3-12B FFN up-projection
of ``chip_smoke.py`` (W 15,360 × 3,840, (8, 128) blocks kept with
probability 0.25 by ``default_rng(seed)``), forced, at each N and column
tile, beside the dense ``torch.matmul`` of W and ``torch.sparse.mm`` on its
CSR: float32 and bfloat16 at (8, 128), float32 at (16, 64).

    python3 tools/time_bsr_designs.py [LABEL] [--seed 0]

Run from the root of a checkout on a CUDA card.  It prints one JSON line of
times in ms (CUDA events, median of 30 single calls after a warm-up, each
with its host work), keyed ``<dtype>_<bm>x<bk>_N<n>_<design>`` with design
``fma``, ``tc<cols>`` (the tensor-core design at a CTA tile of ``cols``
columns of X), ``dense`` or ``sparse_mm``; ``..._routed_b2b`` and
``..._dense_b2b``, the mean of 20 back-to-back calls of the routed design
and of the dense product between two events (the device's time, the host
work hidden behind it); and the layout's build time on the host clock.  Every
tensor-core time is held against the plain version first (relative
inf-norm error at most 1e-4 in float32, 2e-2 in bfloat16)."""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import pruned_ffn_weight  # noqa: E402
from repro_torch.configs import gemma3_12b  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.kernels import _build, bsr  # noqa: E402

NS = (1, 4, 8, 16, 32, 64, 128)
RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def time_ms(fn, reps=30):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("label", nargs="?", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_bsr_designs: no CUDA device")
    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    w, _ = pruned_ffn_weight(gemma3_12b.CONFIG.d_ff, gemma3_12b.CONFIG.d_model,
                             args.seed)
    w_gpu = torch.from_numpy(w).to(dev)
    csr = formats.csr_from_dense(w, device=dev)
    lib_w = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                    size=csr.shape, check_invariants=False)
    out = {"label": args.label}
    for dtype, block in ((torch.float32, (8, 128)), (torch.bfloat16, (8, 128)),
                         (torch.float32, (16, 64))):
        b = formats.csr_to_bsr(csr, *block)
        b = formats.BSR(b.indptr, b.indices, b.blocks.to(dtype), b.shape,
                        b.block_shape)
        t0 = time.perf_counter()
        layout = bsr.build_groups(b)
        torch.cuda.synchronize()
        tag = f"{str(dtype).split('.')[1]}_{block[0]}x{block[1]}"
        out[f"{tag}_layout_build_ms_host"] = 1e3 * (time.perf_counter() - t0)
        wd = w_gpu.to(dtype)
        for n in NS:
            x = torch.randn(w.shape[1], n, device=dev, generator=gen).to(dtype)
            key = f"{tag}_N{n}"
            out[f"{key}_fma"] = time_ms(lambda: bsr._launch("fma", b, x))
            want = bsr.spmm_bsr_plain(b, x).float()
            for cols in (32, 64, 128):
                if cols > 2 * max(n, 32):
                    continue
                got = bsr._launch("tc", b, x, layout, ncols=cols)
                rel = float((got - want).abs().max() / want.abs().max())
                if rel > RTOL[dtype]:
                    sys.exit(f"time_bsr_designs: tc{cols} {key} disagrees "
                             f"with the plain version: {rel:.3e}")
                out[f"{key}_tc{cols}"] = time_ms(
                    lambda: bsr._launch("tc", b, x, layout, ncols=cols))
            out[f"{key}_dense"] = time_ms(lambda: wd @ x)
            out[f"{key}_routed_b2b"] = back_to_back_ms(
                lambda: bsr.spmm_bsr(b, x, layout=layout))
            out[f"{key}_dense_b2b"] = back_to_back_ms(lambda: wd @ x)
            if dtype == torch.float32:
                out[f"{key}_sparse_mm"] = time_ms(lambda: lib_w @ x)
        del b, layout, wd
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
