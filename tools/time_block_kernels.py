"""Time the block-design kernels of the port at Gemma-3-12B's local head
(seq 8192, d = N = 256, a causal band of 16 blocks) and at a BigBird head
(seq 4096, d = N = 64): K9/K10 with an ALiBi bias and, where the tree has
them on the block design, K7/K8 without one, in float32 and bfloat16.

    python3 tools/time_block_kernels.py LABEL

Run from the root of a checkout on a CUDA card.  It prints one JSON line of
kernel times in ms (CUDA events, median of 50 after a warm-up), keyed
``<pattern>_<dtype>_<kernel>``.  To compare two trees on one card, unpack
the other tree into a directory of this one that ``.gitignore`` lists and
run the script from each root in turn, e.g. parent, change, change,
parent."""
import dataclasses
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd() / "src"))

import torch  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.attention import patterns  # noqa: E402
from repro_torch.configs import gemma3_12b  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.core.plan import _stream_to_balanced  # noqa: E402
from repro_torch.kernels import _build, attention, fused_chain  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


def time_ms(fn, reps=50):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("time_block_kernels: no CUDA device", file=sys.stderr)
        return 2
    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    gemma = dataclasses.replace(gemma3_12b.CONFIG, attn_pattern="block_sparse")
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else "."}
    # K7/K8 on the block design arrived with fused_chain.DESIGN_LAUNCHES
    chain_blocks = hasattr(fused_chain, "DESIGN_LAUNCHES")
    for name, spec, d in (
            ("gemma", transformer._block_sparse_spec(gemma, 8192, True), 256),
            ("bigbird", patterns.bigbird(4096, 1, 2, 3, block=64, seed=0), 64)):
        csr = patterns.build_mask(spec).csr.to(dev)
        bal = formats.csr_to_balanced(csr, 512)
        bias = torch.from_numpy(interop.alibi_bias(csr, 2.0 ** -6)).to(dev)
        slab = _stream_to_balanced(bias, bal)
        blocks = attention.AttnBlocks()
        pat = (bal.rows, bal.cols)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(spec.seq, d, device=dev, generator=gen)
                       .to(dt) for _ in range(3))
            kw = dict(shape=csr.shape, scale=d ** -0.5, blocks=blocks)
            st = attention._launch_stats("block", *pat, q, k, slab, **kw)
            tag = f"{name}_{str(dt).split('.')[1]}"
            out[f"{tag}_k9"] = time_ms(lambda: attention._launch_stats(
                "block", *pat, q, k, slab, **kw))
            out[f"{tag}_k10"] = time_ms(lambda: attention._launch_chain(
                "block", *pat, q, k, slab, v, stats=st, **kw))
            if chain_blocks:
                ckw = dict(shape=csr.shape, alpha=d ** -0.5, blocks=blocks)
                cst = fused_chain._launch_stats("block", *pat, q, k, **ckw)
                out[f"{tag}_k7"] = time_ms(lambda: fused_chain._launch_stats(
                    "block", *pat, q, k, **ckw))
                out[f"{tag}_k8"] = time_ms(lambda: fused_chain._launch_chain(
                    "block", *pat, q, k, v, transform="softmax", stats=cst,
                    **ckw))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
