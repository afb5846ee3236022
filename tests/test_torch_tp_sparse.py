"""The placed runtime's sparse-weight and SSM / hybrid / audio regimes on a
(data=2, model=2) mesh of CPU positions: two train steps of the smoke
Llama-3.2-1B with a sparse FFN (a tile count that divides ``data``, whose
value streams are placed tiles over ``data``, and one that does not, whose
streams are replicated) and of the smoke Zamba2-2.7B, RWKV-6-3B and
Whisper-tiny, against the port's unsharded steps and against the
reference's GSPMD step on 4 host devices (``TRAIN_RULES`` with
``__gather_weights__``, the sparse cases with ``SPARSE_WEIGHT_RULES``);
each leaf's placement against the reference's; prefill; ``restore
(shardings=)`` of a tile-sharded state onto (4, 1); the runtime's log
against ``dryrun.plan_collectives`` and against an analytic count of the
sparse matmul's moves.

The sparse patterns are the reference's (``repro.models.transformer.
sparse_patterns``, carried by ``interop.sparse_ffn_from_arrays``); the
reference runs in one subprocess (``test_torch_shard.start_reference``),
started by the module's first test and read by the tests that need it."""
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models.config import SparseFFNConfig as RefSparseFFNConfig
from repro.models.transformer import sparse_patterns as ref_sparse_patterns
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.dist import placement
from repro_torch.dist.placement import Placed, device_get, device_put
from repro_torch.launch import dryrun, make_local_mesh
from repro_torch.launch.train import param_placement, place_state, train_rules
from repro_torch.models import Model, spmd
from repro_torch.models.config import ShapeCell, SparseFFNConfig
from repro_torch.train import TrainConfig, init_state, make_train_step

from test_torch_shard import finish_reference, start_reference
from test_torch_tp import _close, _flat, _same_state

STEPS, BATCH, SEQ = 2, 4, 32
TOL = 1e-5
DENSITY = 0.3
#: case -> (arch, sparse FFN tile or None).  At density 0.3 the smoke
#: Llama's matrices hold 2457 nonzeros: 308 tiles of 8 (split over data),
#: 351 tiles of 7 (replicated, the reference's fallback)
CASES = {"sparse-split": ("llama3.2-1b", 8),
         "sparse-replicated": ("llama3.2-1b", 7),
         "zamba2": ("zamba2-2.7b", None),
         "rwkv6": ("rwkv6-3b", None),
         "whisper": ("whisper-tiny", None)}

REF_SCRIPT = r'''
import sys
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.launch.sharding_rules import (SPARSE_WEIGHT_RULES, TRAIN_RULES,
                                        make_sharding_fn, resolve_rules)
from repro.models import Model
from repro.models.config import SparseFFNConfig
from repro.models.params import param_shardings
from repro.models.sharding_ctx import activation_sharding
from repro.train import TrainConfig, init_state, make_train_step
from repro.train.step import sparse_weight_shardings
inp = dict(np.load(sys.argv[1]))
assert jax.device_count() == 4, jax.devices()
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}


def unflatten(prefix):
    tree = {}
    for key, v in inp.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def flatten(tree, prefix, fn=np.asarray):
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten(v, f"{prefix}{k}/", fn)
        else:
            out[f"{prefix}{k}"] = fn(v)


def merge(a, b):
    if isinstance(a, dict):
        return {k: merge(a[k], b[k]) for k in a}
    return a if b is None else b


def spec_of(sh, ndim):
    dims = tuple(sh.spec) + (None,) * (ndim - len(tuple(sh.spec)))
    return np.array(repr(tuple(d if d is None or isinstance(d, str)
                               else tuple(d) for d in dims)))


def run(case, arch, tile):
    """Two steps of ``case``; the cases run on threads of their own, so
    that XLA compiles their steps side by side."""
    cfg = get_smoke(arch)
    rules = resolve_rules(TRAIN_RULES)
    if tile is not None:
        cfg = cfg.scaled(sparse_ffn=SparseFFNConfig(density=%(density)r,
                                                    tile=tile))
        rules = resolve_rules(TRAIN_RULES, SPARSE_WEIGHT_RULES)
    rules = dict(rules, __gather_weights__=True)
    model = Model(cfg)
    host = unflatten(f"{case}/p/")
    sh = param_shardings(model.specs, make_sharding_fn(mesh, rules))
    if tile is not None:
        sh = merge(sh, sparse_weight_shardings(host, mesh, rules))
    params = jax.tree_util.tree_map(jax.device_put, host, sh)
    flatten(jax.tree_util.tree_map(lambda s, a: spec_of(s, a.ndim), sh, host),
            f"{case}/spec/", fn=lambda v: v)
    tcfg = TrainConfig()
    state = init_state(params, tcfg)
    inner = make_train_step(model.loss_fn, tcfg)

    def step(state, batch):
        with activation_sharding(mesh, rules):
            return inner(state, batch)
    step = jax.jit(step)
    keys = ("tokens", "labels") + (("frames",) if cfg.family == "audio"
                                   else ())
    batch = {k: jax.device_put(jnp.asarray(inp[f"batch/{k}"]),
                               NamedSharding(mesh, P("data")))
             for k in keys}
    for i in range(%(steps)d):
        state, metrics = step(state, batch)
        out[f"{case}/loss{i}"] = np.asarray(metrics["loss"])
    flatten(state["params"], f"{case}/params/")
    flatten(state["opt"]["m"], f"{case}/m/")
    flatten(state["opt"]["v"], f"{case}/v/")


with ThreadPoolExecutor(len(%(cases)r)) as pool:
    for f in [pool.submit(run, case, *a) for case, a in %(cases)r.items()]:
        f.result()
np.savez(sys.argv[2], **out)
''' % {"cases": CASES, "density": DENSITY, "steps": STEPS}


def _mesh(data=2, model=2):
    return make_local_mesh(data, model, devices=["cpu"] * (data * model))


def _cfg(case):
    arch, tile = CASES[case]
    cfg = get_smoke(arch)
    if tile is not None:
        cfg = cfg.scaled(sparse_ffn=SparseFFNConfig(density=DENSITY, tile=tile))
    return cfg


def _ref_patterns(case) -> dict:
    """The reference's stacked patterns of ``case`` as numpy slabs."""
    arch, tile = CASES[case]
    cfg = ref_get_smoke(arch).scaled(
        sparse_ffn=RefSparseFFNConfig(density=DENSITY, tile=tile))
    return {k: (np.asarray(p.rows), np.asarray(p.cols))
            for k, p in ref_sparse_patterns(cfg).items()}


_MODELS: dict = {}


def _model(case):
    """``case``'s model (the reference's patterns, one set a layer) and
    its params, made once a module."""
    if case not in _MODELS:
        cfg = _cfg(case)
        patterns = None
        if cfg.sparse_ffn is not None:
            ref = _ref_patterns(case)
            layers = [interop.sparse_ffn_from_arrays(
                cfg, {k: (r[i], c[i]) for k, (r, c) in ref.items()}, {},
                device="cpu").patterns for i in range(cfg.num_layers)]
            patterns = {k: [pl[k] for pl in layers] for k in ref}
        model = Model(cfg, patterns=patterns)
        _MODELS[case] = (model, model.init(torch.Generator().manual_seed(0),
                                           "cpu"))
    return _MODELS[case]


def _batch(case) -> dict:
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32),
           "labels": rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)}
    out["labels"][0, :7] = -1
    out["labels"][3, 20:] = -1
    cfg = _cfg(case)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.num_frames, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(case) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in _batch(case).items()}


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    inputs = {}
    for case in CASES:
        _, params = _model(case)
        inputs.update({f"{case}/p/{k}": v.numpy()
                       for k, v in _flat(params).items()})
    for k, v in _batch("whisper").items():
        inputs[f"batch/{k}"] = v
    started = start_reference(REF_SCRIPT, inputs,
                              tmp_path_factory.mktemp("tp_sparse_ref"))
    box = {}

    def get_out():
        if "out" not in box:
            box["out"] = finish_reference(started)
        return box["out"]
    yield get_out
    if started[0].poll() is None:
        started[0].kill()
        started[0].communicate()


def _steps(case, placed: bool):
    """Two steps of ``case``: ``(losses, the state unplaced, the first
    step's log)``."""
    model, params = _model(case)
    tcfg = TrainConfig()
    state = init_state(params, tcfg)
    if placed:
        state, _ = place_state(model, state, _mesh())
    step = make_train_step(model.loss_fn, tcfg)
    losses, logs = [], []
    for _ in range(STEPS):
        with spmd.collective_log() as log:
            state, metrics = step(state, _torch_batch(case))
        losses.append(float(metrics["loss"]))
        logs.append(log)
    return losses, device_get(state), logs[0]


@pytest.fixture(scope="module")
def runs():
    return {(case, placed): _steps(case, placed)
            for case in CASES for placed in (False, True)}


# ---------------------------------------------------------------------------
# placement and the train step
# ---------------------------------------------------------------------------

def _spec_str(spec) -> str:
    return repr(tuple(d if d is None or isinstance(d, str) else tuple(d)
                      for d in spec))


@pytest.mark.parametrize("case", CASES)
def test_train_matches_the_unsharded_step(case, runs):
    """Losses, params and both AdamW moments of two steps on the (2, 2)
    mesh within 1e-5 of the unsharded steps from the same params."""
    want_losses, want, _ = runs[(case, False)]
    got_losses, got, _ = runs[(case, True)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=TOL)
    _same_state(got, want["params"], want["opt"]["m"], want["opt"]["v"])


@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_the_unsharded_prefill(case):
    """Placed by ``param_placement``: the last position's logits and the
    caches equal the unsharded prefill's."""
    model, params = _model(case)
    batch = _torch_batch(case)
    batch.pop("labels")
    want, want_caches = model.prefill(params, batch, SEQ + 8)
    logits, caches = model.prefill(
        device_put(params, param_placement(model, params, _mesh())), batch,
        SEQ + 8)
    assert logits.spec == ("data", "model")
    _close(device_get(logits), want)
    for key, leaf in _flat(want_caches).items():
        _close(device_get(_flat(caches)[key]), leaf)


def test_restore_a_tile_sharded_state_onto_another_mesh(tmp_path):
    """Saved at (2, 2) with the value streams' 308 tiles over data,
    restored at (4, 1): 77 tiles a position, bit-equal gathered, and a
    step from it equals a step from the state never saved."""
    model, params = _model("sparse-split")
    tcfg = TrainConfig()
    state, _ = place_state(model, init_state(params, tcfg), _mesh())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    mesh4 = _mesh(4, 1)
    _, sh4 = place_state(model, init_state(params, tcfg), mesh4)
    back = mgr.restore(1, like=state, shardings=sh4)
    leaf = back["params"]["blocks"]["ffn"]["v_up"]
    assert isinstance(leaf, Placed) and leaf.spec == (None, "data", None)
    for pos in placement.positions(mesh4):
        assert leaf.local(pos).shape == (2, 77, 8)
    want = device_get(state)
    for key, w in _flat(want).items():
        assert torch.equal(device_get(_flat(back)[key]), w)
    step = make_train_step(model.loss_fn, tcfg)
    a, _ = step(back, _torch_batch("sparse-split"))
    b, _ = step(place_state(model, want, mesh4)[0],
                _torch_batch("sparse-split"))
    for key, w in _flat(device_get(b)).items():
        assert torch.equal(_flat(device_get(a))[key], w)


# ---------------------------------------------------------------------------
# the collective log
# ---------------------------------------------------------------------------

def _by_kind(recs):
    out = {}
    for r in recs:
        out[r.kind] = out.get(r.kind, 0) + r.bytes * r.count
    return out


@pytest.mark.parametrize("case", CASES)
def test_log_matches_the_plan(case, runs):
    """Every position's log of one step, by kind, is the plan's; the value
    streams are never gathered, and their moves are the analytic count:
    per layer and matrix W (m, k), x (k, T) out and the partials (m, T)
    back, the cotangent (m, T) out and dX (k, T) back, T = 64 tokens a
    position, f32, over data when the stream is split."""
    model, _ = _model(case)
    log = runs[(case, True)][2]
    cell = ShapeCell("smoke", SEQ, BATCH, "train")
    mesh = _mesh()
    plan = dryrun.plan_collectives(model, cell, mesh, train_rules(model.cfg))
    for pos in placement.positions(mesh):
        assert _by_kind(log.program(pos)) == _by_kind(plan)
    recs = log.program((0, 0))
    assert not [r for r in recs if ".v_" in r.what
                and r.kind in ("all-gather", "reduce-scatter")]
    cfg = model.cfg
    if cfg.sparse_ffn is None:
        return
    moves = [r for r in recs if r.kind in ("broadcast", "reduce")]
    moved = _by_kind(moves)
    tokens, d, f = BATCH // 2 * SEQ, cfg.d_model, cfg.d_ff
    half = cfg.num_layers * 4 * tokens * sum(m + k for m, k in
                                             ((f, d), (f, d), (d, f)))
    split = CASES[case][1] == 8
    assert moved == ({"broadcast": half, "reduce": half} if split else {})
    assert all(r.axes == ("data",) and r.n == 2 and ".v_" in r.what
               for r in moves)


def test_supports_the_families_and_the_sparse_ffn():
    """The runtime runs the three families and a sparse FFN, decode
    included (``tests/test_torch_tp_decode.py``); MoE stays refused (item
    7b)."""
    for case in CASES:
        assert spmd.supports(_cfg(case))
        spmd.refuse(_cfg(case), "decode")
    assert not spmd.supports(get_smoke("olmoe-1b-7b"))
    with pytest.raises(NotImplementedError, match="item 7b"):
        spmd.refuse(get_smoke("olmoe-1b-7b"), "decode")


# ---------------------------------------------------------------------------
# the reference's run (last: its subprocess runs beside the tests above)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_placement_matches_the_reference(case, reference):
    """Every leaf's spec: ``param_placement`` against the reference's
    ``param_shardings`` with ``sparse_weight_shardings`` over it."""
    model, params = _model(case)
    ref = reference()
    got = param_placement(model, params, _mesh())
    for key, sh in _flat(got).items():
        ndim = _flat(params)[key].ndim
        spec = tuple(sh.spec) + (None,) * (ndim - len(tuple(sh.spec)))
        assert _spec_str(spec) == str(ref[f"{case}/spec/{key}"]), key


@pytest.mark.parametrize("case", CASES)
def test_train_matches_the_reference_gspmd_step(case, runs, reference):
    """The same two steps against the reference's jitted GSPMD step on 4
    host devices: losses, params and moments within 1e-5."""
    ref = reference()
    got_losses, got, _ = runs[(case, True)]
    np.testing.assert_allclose(got_losses, [float(ref[f"{case}/loss{i}"])
                                            for i in range(STEPS)], rtol=TOL)
    want = {part: {k: ref[f"{case}/{part}/{k}"]
                   for k in _flat(got["params"])}
            for part in ("params", "m", "v")}
    _same_state(got, want["params"], want["m"], want["v"])
