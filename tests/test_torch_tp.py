"""The port's weight-gathered SPMD runtime (``dist/placement.py``,
``models/spmd.py``) on a (data=2, model=2) mesh of CPU positions: placement
against ``jax.device_put``'s shards, two train steps of the smoke Llama-3.2-1B
and Gemma-3-12B (f32) against the port's unsharded step and against the
reference's GSPMD step on 4 host devices (the rules of ``train_4k``, weights
gathered at their GEMMs), prefill, ``restore(shardings=)`` onto another mesh,
``TrainDriver``'s rollback on placed state, the runtime's collective log
against ``dryrun.plan_collectives`` (the local mesh and both production
meshes), and the refusals (MoE, and a step under the other regime's
rules).

The reference runs in one subprocess a module with four virtual host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) on an Auto
mesh (this jax's default Explicit axes refuse ``with_sharding_constraint``),
started by the module's first test and read by the tests that need it."""
import math

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get, get_smoke
from repro_torch.dist import placement
from repro_torch.dist.placement import Placed, device_get, device_put
from repro_torch.launch import (dryrun, input_specs, make_local_mesh,
                                make_production_mesh, make_sharding_fn)
from repro_torch.launch.sharding_rules import NamedSharding, PartitionSpec
from repro_torch.launch.train import place_state, train_rules
from repro_torch.models import SHAPES, Model, sharding_ctx, spmd
from repro_torch.models.config import ShapeCell
from repro_torch.models.params import param_shardings
from repro_torch.runtime import DriverConfig, TrainDriver
from repro_torch.train import OptConfig, TrainConfig, init_state, make_train_step

from test_torch_shard import finish_reference, start_reference

ARCHS = ("llama3.2-1b", "gemma3-12b")
STEPS, BATCH, SEQ = 2, 4, 32
TOL = 1e-5

#: (shape, spec) pairs placed on the (2, 2) mesh; (5, 4) over data does not
#: divide and is refused by both packages
PUTS = (((6, 4), ("data", "model")), ((8, 6), (("data", "model"), None)),
        ((4, 3), (None, "model")), ((2, 4, 6), (None, "data", "model")),
        ((5, 4), ("data", None)))

REF_SCRIPT = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.launch.input_specs import finalize_rules, rules_for_cell
from repro.launch.sharding_rules import make_sharding_fn
from repro.models import SHAPES, Model
from repro.models.params import param_shardings
from repro.models.sharding_ctx import activation_sharding
from repro.train import TrainConfig, init_state, make_train_step
inp = dict(np.load(sys.argv[1]))
assert jax.device_count() == 4, jax.devices()
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
ids = {d.id: i for i, d in enumerate(mesh.devices.reshape(-1))}
for k, (shape, spec) in enumerate(%(puts)r):
    a = jnp.arange(int(np.prod(shape)), dtype=jnp.float32).reshape(shape)
    try:
        b = jax.device_put(a, NamedSharding(mesh, P(*spec)))
    except ValueError:
        out[f"put{k}/refused"] = np.ones(())
        continue
    for s in b.addressable_shards:
        out[f"put{k}/{ids[s.device.id]}"] = np.asarray(s.data)


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


def flatten(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten(v, f"{prefix}{k}/")
        else:
            out[f"{prefix}{k}"] = np.asarray(v)


cell = next(c for c in SHAPES if c.name == "train_4k")
for arch in %(archs)r:
    model = Model(get_smoke(arch))
    rules = finalize_rules(rules_for_cell(cell, model.cfg), mesh)
    sh = param_shardings(model.specs, make_sharding_fn(mesh, rules))
    params = jax.tree_util.tree_map(jax.device_put, unflatten(f"{arch}/p/"), sh)
    tcfg = TrainConfig()
    state = init_state(params, tcfg)
    inner = make_train_step(model.loss_fn, tcfg)

    def step(state, batch):
        with activation_sharding(mesh, rules):
            return inner(state, batch)
    step = jax.jit(step)
    bsh = NamedSharding(mesh, P("data", None))
    batch = {k: jax.device_put(jnp.asarray(inp[f"batch/{k}"]), bsh)
             for k in ("tokens", "labels")}
    for i in range(%(steps)d):
        state, metrics = step(state, batch)
        out[f"{arch}/loss{i}"] = np.asarray(metrics["loss"])
    flatten(state["params"], f"{arch}/params/")
    flatten(state["opt"]["m"], f"{arch}/m/")
    flatten(state["opt"]["v"], f"{arch}/v/")
    out[f"{arch}/embed_spec"] = np.array(str(state["params"]["embed"].sharding.spec))
np.savez(sys.argv[2], **out)
''' % {"puts": PUTS, "archs": ARCHS, "steps": STEPS}


def _mesh(data=2, model=2):
    return make_local_mesh(data, model, devices=["cpu"] * (data * model))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _params(arch):
    model = Model(get_smoke(arch))
    return model, model.init(torch.Generator().manual_seed(0), "cpu")


def _batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)
    labels[0, :7] = -1                 # slices with different label counts
    labels[3, 20:] = -1
    return tokens, labels


def _torch_batch():
    tokens, labels = _batch()
    return {"tokens": torch.from_numpy(tokens).long(),
            "labels": torch.from_numpy(labels).long()}


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    inputs = {}
    for arch in ARCHS:
        _, params = _params(arch)
        inputs.update({f"{arch}/p/{k}": v.numpy()
                       for k, v in _flat(params).items()})
    inputs["batch/tokens"], inputs["batch/labels"] = _batch()
    started = start_reference(REF_SCRIPT, inputs,
                              tmp_path_factory.mktemp("tp_ref"))
    box = {}

    def get_out():
        if "out" not in box:
            box["out"] = finish_reference(started)
        return box["out"]
    return get_out


def _close(got, want, rtol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _same_state(got: dict, want_params: dict, want_m: dict, want_v: dict):
    """Params within 1e-5 (absolute, as the reference's sharded-vs-unsharded
    figure is taken) and both AdamW moments, which carry the gradients,
    within 1e-5 of each leaf's largest entry.  (The default schedule moves a
    param by ~1e-5 in two steps; where a gradient entry is near zero AdamW's
    ratio m / sqrt(v) amplifies rounding, so the update is not compared
    entry by entry.)"""
    for key, w in _flat(want_params).items():
        g, w = _flat(got["params"])[key].numpy(), np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    for part, want in (("m", want_m), ("v", want_v)):
        for key, w in _flat(want).items():
            _close(_flat(got["opt"][part])[key], w)


def _steps(arch, placed: bool, tcfg=None, mesh=None):
    model, params = _params(arch)
    tcfg = tcfg or TrainConfig()
    state = init_state(params, tcfg)
    if placed:
        state, _ = place_state(model, state, mesh or _mesh())
    step = make_train_step(model.loss_fn, tcfg)
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, _torch_batch())
        losses.append(float(metrics["loss"]))
    return losses, device_get(state)


@pytest.fixture(scope="module")
def runs():
    """Both archs' unsharded and (2, 2) runs, once a module."""
    return {(arch, placed): _steps(arch, placed)
            for arch in ARCHS for placed in (False, True)}


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_matches_the_unsharded_step(arch, runs):
    """Losses, every param leaf and both AdamW moments of two steps on the
    (2, 2) mesh within 1e-5 of the port's unsharded steps from the same
    params; the batch's slices hold different numbers of valid labels, so a
    mean of per-slice means would show."""
    want_losses, want = runs[(arch, False)]
    got_losses, got = runs[(arch, True)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=TOL)
    _same_state(got, want["params"], want["opt"]["m"], want["opt"]["v"])
    assert int(got["opt"]["step"]) == STEPS


def test_microbatches_match_the_unsharded_step():
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1), microbatches=2)
    want_losses, want = _steps("llama3.2-1b", False, tcfg)
    got_losses, got = _steps("llama3.2-1b", True, tcfg)
    np.testing.assert_allclose(got_losses, want_losses, rtol=TOL)
    for key, leaf in _flat(want["opt"]["m"]).items():
        _close(_flat(got["opt"]["m"])[key], leaf)


def test_nonfinite_step_is_skipped_on_every_position():
    """One NaN in one position's shard: every position keeps its state."""
    model, params = _params("llama3.2-1b")
    tcfg = TrainConfig(skip_nonfinite=True)
    state, _ = place_state(model, init_state(params, tcfg), _mesh())
    bad = state["params"]["blocks"]["ffn"]["w_up"]
    bad.local((1, 1))[0, 0, 0] = float("nan")
    new, metrics = make_train_step(model.loss_fn, tcfg)(state, _torch_batch())
    assert int(metrics["skipped_nonfinite"]) == 1
    before, after = device_get(state), device_get(new)
    for key, leaf in _flat(before).items():
        assert torch.equal(_flat(after)[key].nan_to_num(), leaf.nan_to_num())


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_the_unsharded_prefill(arch):
    model, params = _params(arch)
    mesh = _mesh()
    sh = param_shardings(model.specs, make_sharding_fn(mesh, train_rules()))
    tokens = torch.from_numpy(_batch()[0]).long()
    want, want_caches = model.prefill(params, {"tokens": tokens}, SEQ + 8)
    logits, caches = model.prefill(device_put(params, sh), {"tokens": tokens},
                                   SEQ + 8)
    assert logits.spec == ("data", "model")
    _close(device_get(logits), want)
    for key, leaf in _flat(want_caches).items():
        _close(device_get(_flat(caches)[key]), leaf)


# ---------------------------------------------------------------------------
# checkpoints and the driver
# ---------------------------------------------------------------------------

def test_restore_onto_another_mesh(tmp_path):
    """Saved at (2, 2), restored at (4, 1) and unplaced: gathered bit-equal,
    each shard on its position's device; the format is the logical arrays."""
    model, params = _params("llama3.2-1b")
    state, _ = place_state(model, init_state(params, TrainConfig()), _mesh())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    want = device_get(state)
    mesh4 = _mesh(4, 1)
    _, sh4 = place_state(model, init_state(params, TrainConfig()), mesh4)
    back = mgr.restore(1, like=state, shardings=sh4)
    leaf = back["params"]["blocks"]["attn"]["wq"]
    assert isinstance(leaf, Placed) and leaf.mesh == mesh4
    assert leaf.spec == (None, "data", "model")
    for pos in placement.positions(mesh4):
        assert leaf.local(pos).device == mesh4.devices[pos]
        assert leaf.local(pos).shape == (2, 16, 64)
    plain = mgr.restore(1, like=want)
    for key, w in _flat(want).items():
        assert torch.equal(device_get(_flat(back)[key]), w)
        assert torch.equal(_flat(plain)[key], w)


def test_driver_rolls_back_on_placed_state(tmp_path):
    """A failure at step 5 on placed state: the driver restores the step-4
    checkpoint onto the mesh and the run ends equal to an uninterrupted
    one."""
    model, params = _params("llama3.2-1b")
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1))
    step = make_train_step(model.loss_fn, tcfg)
    batch = _torch_batch()

    def run(fail_at, path):
        state, shardings = place_state(model, init_state(params, tcfg), _mesh())
        seen = {"failed": False}

        def hook(i):
            if i == fail_at and not seen["failed"]:
                seen["failed"] = True
                raise RuntimeError("injected")
        d = TrainDriver(DriverConfig(total_steps=6, checkpoint_every=2,
                                     checkpoint_dir=str(path)),
                        step, lambda i: batch, hook)
        return d, d.run(state, shardings)
    d1, s1 = run(5, tmp_path / "a")
    d2, s2 = run(None, tmp_path / "b")
    assert d1.restarts == 1 and d2.restarts == 0
    assert isinstance(s1["params"]["embed"], Placed)
    for key, w in _flat(device_get(s2)).items():
        assert torch.equal(_flat(device_get(s1))[key], w)


# ---------------------------------------------------------------------------
# the collective log against the plan
# ---------------------------------------------------------------------------

def _by_kind(recs):
    out = {}
    for r in recs:
        out[r.kind] = out.get(r.kind, 0) + r.bytes * r.count
    return out


def test_log_matches_the_plan_on_the_local_mesh():
    """One step of the smoke Llama on the (2, 2) mesh: position (0, 0)'s
    log, by kind, is the plan's for that mesh and shape; every position's
    log is the same (SPMD); the gathers record as the hierarchical plan
    (data, then model)."""
    model, params = _params("llama3.2-1b")
    mesh = _mesh()
    state, _ = place_state(model, init_state(params, TrainConfig()), mesh)
    with spmd.collective_log() as log:
        make_train_step(model.loss_fn, TrainConfig())(state, _torch_batch())
    cell = ShapeCell("smoke", SEQ, BATCH, "train")
    plan = dryrun.plan_collectives(model, cell, mesh, train_rules())
    assert _by_kind(log.program((0, 0))) == _by_kind(plan)
    for pos in placement.positions(mesh):
        assert _by_kind(log.program(pos)) == _by_kind(plan)
    wq = [r for r in log.program((0, 0)) if r.what == "params.blocks.attn.wq[0]"]
    assert [(r.kind, r.axes) for r in wq] == [
        ("all-gather", ("data",)), ("all-gather", ("model",)),
        ("reduce-scatter", ("data",))]


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_log_matches_the_plan_on_the_production_meshes(shape, multi):
    """Llama-3.2-1B's cell on the meta production mesh: the runtime's log
    of position (0, 0)'s program equals the plan by kind, and the dry run's
    artifact takes it (``source``)."""
    model = Model(get("llama3.2-1b"))
    mesh = make_production_mesh(multi_pod=multi)
    cell = next(c for c in SHAPES if c.name == shape)
    built = input_specs.build_cell(model, cell, mesh)
    ran = dryrun.runtime_collectives(model, cell, mesh, built)
    plan = dryrun.plan_collectives(model, cell, mesh, built.rules)
    assert _by_kind(ran) == _by_kind(plan)
    kinds = {"all-gather", "reduce-scatter", "all-reduce"}
    assert set(_by_kind(ran)) == (kinds if shape == "train_4k"
                                  else {"all-gather"})


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_build_cell_on_a_local_mesh_returns_placed_arguments(kind):
    """On a mesh of CPU positions the cell's arguments are placed, batch
    included, and its step runs on them: the train step's loss is finite,
    the prefill's logits are the unsharded prefill's of the same inputs."""
    model = Model(get_smoke("llama3.2-1b"))
    cell = ShapeCell("smoke", SEQ, BATCH, kind)
    built = input_specs.build_cell(model, cell, _mesh())
    first, batch = built.args
    params = first["params"] if kind == "train" else first
    assert isinstance(params["embed"], Placed)
    assert isinstance(batch["tokens"], Placed)
    if kind == "train":
        _, metrics = built.fn(first, batch)
        assert math.isfinite(float(metrics["loss"]))
        return
    logits, caches = built.fn(params, batch)
    assert isinstance(logits, Placed) and logits.spec == ("data", "model")
    want, _ = model.prefill(device_get(params), device_get(batch), SEQ)
    _close(device_get(logits), want)


# ---------------------------------------------------------------------------
# scopes and refusals
# ---------------------------------------------------------------------------

def test_constrain_checks_an_activation_inside_a_position():
    """Inside a position's program ``constrain`` checks the device and the
    batch split; outside, the argument comes back as it is."""
    model, params = _params("llama3.2-1b")
    rt = spmd.Runtime.of(device_put(params, param_shardings(
        model.specs, make_sharding_fn(_mesh(), train_rules()))), BATCH)
    x = torch.ones(BATCH // 2, SEQ, 64)
    with rt.at((1, 0)):
        assert sharding_ctx.gather_weights_mode()
        assert sharding_ctx.constrain(x, ("batch", None, None)) is x
        with pytest.raises(ValueError, match="split over"):
            sharding_ctx.constrain(x, ("batch", "heads", None))
    assert sharding_ctx.constrain(x, ("batch", "heads", None)) is x


@pytest.mark.parametrize("arch,what", [
    ("olmoe-1b-7b", "train"), ("olmoe-1b-7b", "prefill"),
    ("olmoe-1b-7b", "decode"), ("kimi-k2-1t-a32b", "decode")])
def test_placed_families_out_of_scope_are_refused(arch, what):
    """MoE on placed parameters — train, prefill and decode — needs expert
    parallelism (item 7b); the SSM, hybrid and audio families' decode runs
    (``tests/test_torch_tp_decode.py``)."""
    cfg = get_smoke(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    sh = param_shardings(model.specs, make_sharding_fn(_mesh(), train_rules()))
    placed = device_put(params, sh)
    assert not spmd.supports(cfg)
    with pytest.raises(NotImplementedError, match=f"MoE {what}.*item 7b"):
        if what == "train":
            model.loss_fn(placed, _torch_batch())
        elif what == "prefill":
            model.prefill(placed, {"tokens": _torch_batch()["tokens"]}, SEQ)
        else:
            caches = model.init_cache(BATCH, SEQ, device="cpu")
            model.decode_step(placed, caches, torch.zeros(BATCH, 1).long())


def test_sparse_ffn_and_placed_decode_are_refused():
    """The sparse FFN's train, prefill and decode run on placed parameters
    (``tests/test_torch_tp_sparse.py``, ``tests/test_torch_tp_decode.py``);
    what stays refused is a step under the other regime's rules: decode
    under rules that gather the weights (``__gather_weights__``, train's),
    a train step under rules that keep them split (decode's)."""
    from repro_torch.models.config import SparseFFNConfig
    cfg = get_smoke("llama3.2-1b").scaled(
        sparse_ffn=SparseFFNConfig(density=0.25, tile=16))
    assert spmd.supports(cfg)
    spmd.refuse(cfg, "decode")
    model, params = _params("llama3.2-1b")
    sh = param_shardings(model.specs, make_sharding_fn(_mesh(), train_rules()))
    placed = device_put(params, sh)
    caches = model.init_cache(BATCH, SEQ, device="cpu")
    with sharding_ctx.activation_sharding(_mesh(), train_rules()):
        with pytest.raises(ValueError, match="tensor-parallel"):
            model.decode_step(placed, caches, torch.zeros(BATCH, 1).long())
    # a placed weight under rules without the gather (decode's TP)
    rt_rules = dict(train_rules(), __gather_weights__=False)
    with sharding_ctx.activation_sharding(_mesh(), rt_rules):
        with pytest.raises(ValueError, match="gather the weights"):
            model.loss_fn(placed, _torch_batch())


# ---------------------------------------------------------------------------
# the reference's run (last: its subprocess runs beside the tests above)
# ---------------------------------------------------------------------------

def test_device_put_round_trip_and_shards_match_the_reference(reference):
    """Each position's shard is the reference's ``addressable_shards`` data
    on the device of the same place in the mesh; a dim its axes do not
    divide is refused by both; ``device_get`` gives the tensor back."""
    mesh = _mesh()
    ref = reference()
    for k, (shape, spec) in enumerate(PUTS):
        a = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
        sh = NamedSharding(mesh, PartitionSpec(*spec))
        if f"put{k}/refused" in ref:
            with pytest.raises(ValueError, match="divisible"):
                device_put({"a": a}, {"a": sh})
            continue
        p = device_put({"a": a}, {"a": sh})["a"]
        assert isinstance(p, Placed) and p.shape == shape
        for i, pos in enumerate(placement.positions(mesh)):
            local = p.local(pos)
            assert local.device == mesh.devices[pos]
            np.testing.assert_array_equal(local.numpy(), ref[f"put{k}/{i}"])
        assert torch.equal(device_get(p), a)
    # copies along an axis the leaf is not sharded over are distinct tensors
    p = device_put(torch.ones(4, 2), NamedSharding(mesh, PartitionSpec("data")))
    assert p.local((0, 0)).data_ptr() != p.local((0, 1)).data_ptr()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_matches_the_reference_gspmd_step(arch, runs, reference):
    """The same two steps against the reference's jitted GSPMD step on 4
    host devices under ``rules_for_cell(train_4k)``: losses, params and
    moments within 1e-5; the reference keeps its params sharded."""
    ref = reference()
    got_losses, got = runs[(arch, True)]
    np.testing.assert_allclose(got_losses, [float(ref[f"{arch}/loss{i}"])
                                            for i in range(STEPS)], rtol=TOL)
    want = {part: {k: ref[f"{arch}/{part}/{k}"]
                   for k in _flat(got["params"])} for part in ("params", "m",
                                                              "v")}
    _same_state(got, want["params"], want["m"], want["v"])
    assert "model" in str(ref[f"{arch}/embed_spec"])
