"""The port's models against the reference, on the CPU, at the ``SMOKE``
configs in float32: every architecture (dense, MoE, VLM with M-RoPE,
Gemma's local/global stack, the Zamba2 hybrid, RWKV-6, Whisper), three
``block_sparse`` variants (Llama, Zamba2's shared attention, Whisper's
encoder and decoder over 20 frames, not a multiple of the block), a
``sparse_ffn`` variant and a MoE variant with the SpMM dispatch forced.  The reference runs
as ``tests/test_models.py`` runs it (``jax.jit(model.loss_fn)``,
``jax.grad``); the port gets the same weights (and sparse-FFN patterns)
carried across by ``interop.model_params_from_arrays`` /
``model_patterns_from_arrays``, and the same tokens, made with numpy from a
seed.

Tolerance: relative inf-norm error 1e-4 (a tensor's largest difference over
its largest magnitude) for losses, metrics, grads, logits and caches; the
reference's own contracts (prefill→decode agreement 2e-2, the argmax of a
multi-step decode) as there."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.models import layers as ref_layers
from repro.models import params as ref_params_mod
from repro.models.config import MoEConfig as RefMoEConfig
from repro.models.config import SparseFFNConfig as RefSparseFFNConfig
from repro_torch import configs, interop
from repro_torch.models import SHAPES, Model, ShapeCell, layers, params
from repro_torch.models.config import MoEConfig, SparseFFNConfig

CPU = torch.device("cpu")
TOL = 1e-4


def _variants():
    """name → (reference config, port config)."""
    out = {a: (ref_configs.get_smoke(a), configs.get_smoke(a))
           for a in configs.ARCH_NAMES}
    extra = {
        "llama3.2-1b+block_sparse": ("llama3.2-1b", dict(
            attn_pattern="block_sparse", window=16, attn_block=8)),
        "zamba2-2.7b+block_sparse": ("zamba2-2.7b", dict(
            attn_pattern="block_sparse", window=16, attn_block=8)),
        "whisper-tiny+block_sparse": ("whisper-tiny", dict(
            attn_pattern="block_sparse", window=16, attn_block=8,
            num_frames=20)),
        "llama3.2-1b+sparse_ffn": ("llama3.2-1b", dict(
            sparse_ffn=(RefSparseFFNConfig(density=0.2, tile=64),
                        SparseFFNConfig(density=0.2, tile=64)))),
        "olmoe-1b-7b+spmm": ("olmoe-1b-7b", dict(
            moe=(RefMoEConfig(8, 2, 64, capacity_factor=8.0, dispatch="spmm"),
                 MoEConfig(8, 2, 64, capacity_factor=8.0, dispatch="spmm")))),
    }
    for name, (base, kw) in extra.items():
        ref_kw = {k: v[0] if isinstance(v, tuple) else v for k, v in kw.items()}
        kw = {k: v[1] if isinstance(v, tuple) else v for k, v in kw.items()}
        out[name] = (ref_configs.get_smoke(base).scaled(**ref_kw),
                     configs.get_smoke(base).scaled(**kw))
    return out


VARIANTS = _variants()


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference model, its params, port model, the same params)."""
    ref_cfg, cfg = VARIANTS[name]
    ref = RefModel(ref_cfg)
    ref_p = ref.init(jax.random.PRNGKey(0))
    pats = None
    if ref.patterns is not None:
        pats = interop.model_patterns_from_arrays(
            cfg, {k: (np.asarray(v.rows), np.asarray(v.cols))
                  for k, v in ref.patterns.items()}, device=CPU)
    model = Model(cfg, patterns=pats)
    p = interop.model_params_from_arrays(
        cfg, jax.tree_util.tree_map(np.asarray, ref_p), device=CPU)
    return ref, ref_p, model, p


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _batches(cfg, toks, seed=2):
    """The reference's batch and the port's for ``toks`` (numpy); an audio
    config gets frame embeddings (B, num_frames, d_model) from ``seed``."""
    ref = {"tokens": jnp.asarray(toks)}
    port = {"tokens": torch.from_numpy(toks).long()}
    if cfg.family == "audio":
        frames = np.random.default_rng(seed).standard_normal(
            (toks.shape[0], cfg.num_frames, cfg.d_model)).astype(np.float32)
        ref["frames"], port["frames"] = jnp.asarray(frames), \
            torch.from_numpy(frames)
    return ref, port


def _rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _assert_trees(got, want, tol=TOL):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), (sorted(got), sorted(want))
    for path in want:
        rel = _rel(got[path], want[path])
        assert rel <= tol, (path, rel)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_configs_field_for_field(arch):
    for ref, port in ((ref_configs.get(arch), configs.get(arch)),
                      (ref_configs.get_smoke(arch), configs.get_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_shapes_and_param_counts():
    assert [dataclasses.asdict(c) for c in SHAPES] == \
        [dataclasses.asdict(c) for c in __import__(
            "repro.models", fromlist=["SHAPES"]).SHAPES]
    assert isinstance(SHAPES[0], ShapeCell)
    for arch in configs.ARCH_NAMES:
        cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
        specs, ref_specs = Model(cfg).specs, RefModel(ref_cfg).specs
        assert params.param_count(specs) == ref_params_mod.param_count(ref_specs)
        assert params.param_bytes(specs) == ref_params_mod.param_bytes(ref_specs)
    # OLMoE-1B-7B: ~6.9 B parameters, ~13.8 GB in bf16
    olmoe = Model(configs.get("olmoe-1b-7b")).specs
    assert 6.8e9 < params.param_count(olmoe) < 7.0e9


def test_init_params_follows_the_specs():
    cfg = configs.get_smoke("olmoe-1b-7b")
    model = Model(cfg)
    p = model.init(torch.Generator().manual_seed(0))
    again = model.init(torch.Generator().manual_seed(0))
    ffn = p["blocks"]["ffn"]
    assert ffn["w_router"].dtype == torch.float32
    assert torch.equal(ffn["ln"], torch.zeros_like(ffn["ln"]))
    assert abs(float(ffn["w_router"].std()) - 0.02) < 0.005
    # default std: 1/sqrt(fan_in), fan_in the second-to-last dim
    assert abs(float(ffn["w_up"].std()) - cfg.d_model ** -0.5) < 0.02
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_leaves(p), _leaves(again)))
    with pytest.raises(ValueError, match="shape"):
        interop.model_params_from_arrays(
            cfg, {**jax.tree_util.tree_map(np.asarray, RefModel(
                ref_configs.get_smoke("olmoe-1b-7b")).init(
                    jax.random.PRNGKey(0))), "embed": np.zeros((3, 3))},
            device=CPU)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(VARIANTS))
def test_loss_metrics_and_grads_match_reference(name):
    ref, ref_p, model, p = _pair(name)
    toks = _tokens(model.cfg, 2, 16)
    labels = toks.copy()
    labels[0, -3:] = -1                                      # ignored
    ref_batch, batch = _batches(model.cfg, toks)
    ref_batch["labels"] = jnp.asarray(labels)
    batch["labels"] = torch.from_numpy(labels).long()
    (ref_loss, ref_m), ref_g = jax.jit(jax.value_and_grad(
        ref.loss_fn, has_aux=True))(ref_p, ref_batch)
    leaves = dict(_leaves(p))
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        loss, metrics = model.loss_fn(p, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    assert _rel(loss, ref_loss) <= TOL
    for k in ("ce_loss", "aux_loss", "tokens"):
        assert _rel(metrics[k], ref_m[k]) <= TOL, k
    assert float(metrics["tokens"]) == 29
    ref_leaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, ref_g)))
    assert list(ref_leaves) == list(leaves)
    for path, g in zip(leaves, grads):
        assert _rel(g, ref_leaves[path]) <= TOL, (name, path)
    if model.cfg.moe is not None:
        assert float(metrics["aux_loss"].detach()) > 0  # router entropy term active
    if model.cfg.sparse_ffn is not None:
        vg = dict(zip(leaves, grads))["/blocks/ffn/v_gate"]
        assert float(vg.abs().sum()) > 0


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_and_decode_match_reference(name):
    """Prefill and one decode step: logits and caches against the
    reference; and the reference test's contract decode_step(prefill(t[:n]))
    ≈ prefill(t[:n+1])."""
    ref, ref_p, model, p = _pair(name)
    b, s, max_len = 2, 12, 32
    toks = _tokens(model.cfg, b, s + 1)
    ref_prefill = jax.jit(lambda pp, x: ref.prefill(pp, x, max_len))
    ref_b, b_ = _batches(model.cfg, toks[:, :s])
    ref_lp, ref_c = ref_prefill(ref_p, ref_b)
    ref_ld, ref_c2 = jax.jit(ref.decode_step)(ref_p, ref_c,
                                              jnp.asarray(toks[:, s:]))
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        lp, c = model.prefill(p, b_, max_len)
        ld, c2 = model.decode_step(p, c, t[:, s:])
        lp2, _ = model.prefill(p, dict(b_, tokens=t), max_len)
    assert _rel(lp, ref_lp) <= TOL
    assert _rel(ld, ref_ld) <= TOL
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    _assert_trees(c, np_tree(ref_c))
    _assert_trees(c2, np_tree(ref_c2))
    assert _rel(ld, lp2) < 2e-2


@pytest.mark.parametrize("name", ["llama3.2-1b", "gemma3-12b", "olmoe-1b-7b",
                                  "zamba2-2.7b"])
def test_decode_with_per_lane_lengths(name):
    """Batched serving: each lane at its own position (a (B,) length),
    written at its own slot and masked to its own length."""
    ref, ref_p, model, p = _pair(name)
    toks = _tokens(model.cfg, 2, 21)
    ref_lp, ref_c = ref.prefill(ref_p, {"tokens": jnp.asarray(toks[:, :20])}, 32)
    with torch.no_grad():
        _, c = model.prefill(p, {"tokens": torch.from_numpy(toks[:, :20]).long()}, 32)
    lens = np.array([20, 13], np.int32)
    ref_c = dict(ref_c, length=jnp.asarray(lens))
    c = dict(c, length=torch.from_numpy(lens))
    nxt = toks[:, 20:]
    ref_l, ref_c2 = ref.decode_step(ref_p, ref_c, jnp.asarray(nxt))
    with torch.no_grad():
        got, c2 = model.decode_step(p, c, torch.from_numpy(nxt).long())
    assert _rel(got, ref_l) <= TOL
    _assert_trees(c2, jax.tree_util.tree_map(np.asarray, ref_c2))


def test_multi_step_decode_matches_prefill():
    ref, ref_p, model, p = _pair("llama3.2-1b")
    toks = _tokens(model.cfg, 1, 10, seed=3)
    t = torch.from_numpy(toks).long()
    _, ref_c = ref.prefill(ref_p, {"tokens": jnp.asarray(toks[:, :4])}, 24)
    with torch.no_grad():
        _, c = model.prefill(p, {"tokens": t[:, :4]}, 24)
        for i in range(4, 9):
            ld, c = model.decode_step(p, c, t[:, i:i + 1])
            ref_ld, ref_c = ref.decode_step(ref_p, ref_c,
                                            jnp.asarray(toks[:, i:i + 1]))
            assert _rel(ld, ref_ld) <= TOL, i
        lp, _ = model.prefill(p, {"tokens": t[:, :9]}, 24)
    assert int(ld.argmax()) == int(lp.argmax())


def test_gemma_decodes_past_its_window():
    """gemma3: prefill past the local window (40 > 16), then decode on: the
    rolling local caches against the reference at every step."""
    ref, ref_p, model, p = _pair("gemma3-12b")
    toks = _tokens(model.cfg, 1, 40, seed=5)
    _, ref_c = ref.prefill(ref_p, {"tokens": jnp.asarray(toks)}, 64)
    with torch.no_grad():
        _, c = model.prefill(p, {"tokens": torch.from_numpy(toks).long()}, 64)
    assert c["local"]["k"].shape[-2] == model.cfg.window
    for i in range(5):
        tok = np.full((1, 1), i + 3, np.int32)
        ref_l, ref_c = ref.decode_step(ref_p, ref_c, jnp.asarray(tok))
        with torch.no_grad():
            logits, c = model.decode_step(p, c, torch.from_numpy(tok).long())
        assert bool(torch.isfinite(logits).all())
        assert _rel(logits, ref_l) <= TOL, i
    _assert_trees(c, jax.tree_util.tree_map(np.asarray, ref_c))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _naive(q, k, v, mask):
    """Softmax attention over a boolean (Sq, Sk) mask, −1e30 where masked,
    in float64."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    rep = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    s = np.where(mask, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("causal,window,q_offset,blocks", [
    (True, 0, 0, (8, 16)), (True, 8, 0, (16, 16)), (False, 0, 0, (512, 1024)),
    (True, 5, 7, (8, 8)), (False, 6, 0, (16, 8))])
def test_flash_attention_matches_reference_and_naive(causal, window, q_offset,
                                                     blocks):
    rng = np.random.default_rng(0)
    b, hq, hk, sq, d = 2, 4, 2, 33, 16
    sk = sq + q_offset
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              q_block=blocks[0], kv_block=blocks[1])
    got = layers.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = ref_layers.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert _rel(got, want) <= TOL
    qi, ki = np.arange(sq)[:, None] + q_offset, np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= ki > qi - window
    assert _rel(got, _naive(q, k, v, mask)) <= TOL


def test_flash_attention_fully_masked_row_is_the_mean_of_v():
    """A query whose every key is masked (here: a window that ends before
    the keys start) averages V over the padded keys, as the reference's
    −1e30 online softmax does; no NaN."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 2, 12, 8)).astype(np.float32)
               for _ in range(3))
    kw = dict(causal=False, window=2, q_offset=-20, q_block=4, kv_block=8)
    got = layers.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = ref_layers.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("lengths,window", [(9, 0), (16, 0), ([16, 5], 0),
                                            (12, 4), ([16, 7], 3)])
def test_decode_attention_matches_reference_and_naive(lengths, window):
    rng = np.random.default_rng(2)
    b, hq, hk, lmax, d = 2, 4, 2, 16, 8
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, lmax, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, lmax, d)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    got = layers.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                  length=torch.from_numpy(lens), window=window)
    want = ref_layers.decode_attention(*map(jnp.asarray, (q, k, v)),
                                       length=jnp.asarray(lens), window=window)
    assert _rel(got, want) <= TOL
    pos = np.arange(lmax)
    for lane in range(b):
        n = int(np.broadcast_to(lens, (b,))[lane])
        mask = (pos < n) & ((pos >= n - window) if window else True)
        want_lane = _naive(q[lane:lane + 1], k[lane:lane + 1],
                           v[lane:lane + 1], mask[None, :])
        assert _rel(got[lane:lane + 1], want_lane) <= TOL


def test_rope_and_mrope_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    assert _rel(got, want) <= TOL
    pos3 = rng.integers(0, 300, (2, 7, 3)).astype(np.int32)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             (4, 2, 2), 1e6)
    want = ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                  (4, 2, 2), 1e6)
    assert _rel(got, want) <= TOL
    # text: t == h == w == position reduces M-RoPE to RoPE
    same = np.repeat(pos[..., None], 3, axis=-1)
    assert _rel(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                                   (4, 2, 2), 1e4),
                layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                  1e4)) <= TOL


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply_matches_reference(act):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    p = {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
         for k, s in (("w_gate", (16, 32)), ("w_up", (16, 32)),
                      ("w_down", (32, 16)))}
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), act)
    want = ref_layers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), act)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("name", ["olmoe-1b-7b+spmm", "gemma3-12b",
                                  "llama3.2-1b+sparse_ffn", "rwkv6-3b",
                                  "zamba2-2.7b"])
def test_remat_recomputes_the_same_loss_and_grads(name):
    """``remat="block"`` (``torch.utils.checkpoint`` around each block, a
    Zamba2 group with the shared attention it reads) gives the loss and
    grads of ``remat="none"``, bit for bit on the CPU."""
    _, _, model, p = _pair(name)
    toks = torch.from_numpy(_tokens(model.cfg, 2, 16, seed=7)).long()
    batch = {"tokens": toks, "labels": toks}
    out = []
    for remat in ("none", "block"):
        m = Model(dataclasses.replace(model.cfg, remat=remat),
                  patterns=model.patterns)
        leaves = {k: v.clone().requires_grad_() for k, v in _leaves(p)}
        tree = {}
        for path, v in leaves.items():
            node = tree
            *parents, last = path.strip("/").split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[last] = v
        loss, _ = m.loss_fn(tree, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, list(leaves.values()))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_remat_recompute_keeps_the_backend_scope(monkeypatch):
    """On the card autograd runs the backward (and so the checkpointed
    block's recompute) on a thread of its own, outside the caller's
    ``use_backend`` scope: the recompute re-enters the forward's scope.
    Here the backward runs on another thread, and every SpMM of the
    recompute must resolve the scope's backend."""
    import threading
    from repro_torch.core import registry
    from repro_torch.models import moe
    _, _, model, p = _pair("olmoe-1b-7b+spmm")
    m = Model(dataclasses.replace(model.cfg, remat="block"))
    toks = torch.from_numpy(_tokens(m.cfg, 2, 16, seed=8)).long()
    seen = []
    real = moe.execute_pattern

    def spy(*a, **kw):
        seen.append(registry.default_backend(CPU))
        return real(*a, **kw)
    monkeypatch.setattr(moe, "execute_pattern", spy)
    emb = p["embed"].clone().requires_grad_()
    tree = dict(p, embed=emb)
    with registry.backend_scope("hopper"):
        loss, _ = m.loss_fn(tree, {"tokens": toks, "labels": toks})
    n_forward = len(seen)
    worker = threading.Thread(target=loss.backward)
    worker.start()
    worker.join()
    assert n_forward == 2 * m.cfg.num_layers
    assert len(seen) > n_forward                      # the recompute ran
    assert set(seen) == {"hopper"}, seen
    assert emb.grad is not None


@pytest.mark.parametrize("chunk", [512, 5, 4])
def test_lm_loss_matches_reference(chunk):
    """The chunked cross-entropy: a chunk that does not divide the sequence
    pads it with ignored labels; ``-1`` labels are ignored."""
    from repro.models.model_loss import lm_loss as ref_lm_loss
    from repro_torch.models.model_loss import lm_loss
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, 12, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 40)) * 0.3).astype(np.float32)
    y = rng.integers(-1, 40, (2, 12)).astype(np.int32)
    loss, n = lm_loss(torch.from_numpy(h), torch.from_numpy(w),
                      torch.from_numpy(y).long(), chunk=chunk)
    ref_loss, ref_n = ref_lm_loss(jnp.asarray(h), jnp.asarray(w),
                                  jnp.asarray(y), chunk=chunk)
    assert _rel(loss, ref_loss) <= TOL
    assert float(n) == float(ref_n) == float((y >= 0).sum())


def test_sharding_ctx_is_single_device():
    """Without a scope every hook is the single-device stand-in; under a
    mesh the dense hooks still return their argument (a dim the axis does
    not divide cannot raise), and the sparse-weight marker and the MoE
    groups are read from the rules."""
    from repro_torch.launch import SPARSE_WEIGHT_RULES, make_local_mesh
    from repro_torch.models import sharding_ctx
    x = torch.ones(3)
    assert sharding_ctx.constrain(x, ("batch",)) is x
    assert sharding_ctx.constrain_gemm(w=x) is x
    assert sharding_ctx.constrain_gemm(out=x) is x
    assert sharding_ctx.moe_groups() == 1
    assert sharding_ctx.sparse_shard() == (None, None)
    with sharding_ctx.activation_sharding(None, {}):
        assert sharding_ctx.sparse_shard() == (None, None)
    mesh = make_local_mesh(2, 2, devices=["cpu"] * 4)
    with sharding_ctx.activation_sharding(mesh, SPARSE_WEIGHT_RULES,
                                          enabled=False):
        assert sharding_ctx.sparse_shard() == (None, None)
    rules = dict(SPARSE_WEIGHT_RULES, heads=("model",), __moe_groups__=2)
    with sharding_ctx.activation_sharding(mesh, rules):
        assert sharding_ctx.sparse_shard() == (mesh, "data")
        assert sharding_ctx.moe_groups() == 2
        heads = torch.ones(1, 3, 4)                   # 3 heads on model=2
        assert sharding_ctx.constrain(heads, (None, "heads", None)) is heads
    assert sharding_ctx.sparse_shard() == (None, None)
