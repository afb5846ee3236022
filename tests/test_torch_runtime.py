"""The port's runtime on the CPU: checkpoints (``repro_torch.checkpoint``),
the step-indexed data pipeline (``repro_torch.data``) and the training
driver (``repro_torch.runtime.TrainDriver``), each test of
``tests/test_runtime.py`` against the port, at ``llama3.2-1b``'s ``SMOKE``
config in float32; beside them, parity with ``repro``: checkpoints cross-
load both ways (bfloat16 leaves and dict keys out of order included,
restored bit for bit), ``SyntheticLM`` batches equal the reference's, and
the three examples run on the CPU."""
import json
import os
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.data import DataConfig, MemmapCorpus, SyntheticLM
from repro_torch.models import Model
from repro_torch.runtime import DriverConfig, TrainDriver
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import OptConfig, TrainConfig, init_state, make_train_step

CPU = torch.device("cpu")


@pytest.fixture()
def tmp_ckpt(tmp_path):
    return str(tmp_path / "ckpt")


def _setup(steps=30):
    cfg = get_smoke("llama3.2-1b")
    model = Model(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=steps))
    step = make_train_step(model.loss_fn, tcfg)
    data = SyntheticLM(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                  seq_len=16, global_batch=4))
    data_fn = lambda i: {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
    state = init_state(model.init(torch.Generator().manual_seed(0)), tcfg)
    return model, step, data_fn, state


def _equal_trees(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal_trees(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomic_and_gc(tmp_ckpt):
    mgr = CheckpointManager(tmp_ckpt, keep=2)
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 2))}}
    for s in [1, 2, 3, 4]:
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]          # gc keeps last 2
    back = mgr.restore(4, like=tree)
    np.testing.assert_array_equal(back["a"].numpy(), np.arange(5))
    os.makedirs(os.path.join(tmp_ckpt, "step_000000099.tmp-dead"))
    assert mgr.latest_step() == 4


def test_async_checkpoint(tmp_ckpt):
    mgr = CheckpointManager(tmp_ckpt)
    tree = {"w": torch.ones((64, 64))}
    mgr.save_async(7, tree)
    mgr.wait()
    assert mgr.latest_step() == 7


def test_driver_failure_recovery(tmp_ckpt):
    model, step, data_fn, state = _setup(30)
    boom = {"armed": True}

    def failure_hook(s):
        if s == 25 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected failure")

    d = TrainDriver(DriverConfig(total_steps=30, checkpoint_every=10,
                                 checkpoint_dir=tmp_ckpt),
                    step, data_fn, failure_hook=failure_hook)
    final = d.run(state)
    assert d.restarts == 1
    assert int(final["opt"]["step"]) == 30
    replayed = [e.step for e in d.events].count(21)
    assert replayed == 2


def test_driver_failure_rolls_back_to_an_async_save_still_in_flight(
        tmp_ckpt, monkeypatch):
    """A step that fails while the last ``save_async`` is still writing
    rolls back to that save: the rollback joins the writer before it scans
    for the latest committed step."""
    model, step, data_fn, state = _setup(4)
    write = CheckpointManager._write

    def slow_write(self, s, host):
        time.sleep(1.0)
        write(self, s, host)

    monkeypatch.setattr(CheckpointManager, "_write", slow_write)
    armed = [True]

    def failure_hook(s):
        if s == 3 and armed[0]:
            armed[0] = False
            raise RuntimeError("injected failure")

    d = TrainDriver(DriverConfig(total_steps=4, checkpoint_every=2,
                                 checkpoint_dir=tmp_ckpt),
                    step, data_fn, failure_hook=failure_hook)
    final = d.run(state)
    assert d.restarts == 1
    assert [e.step for e in d.events] == [0, 1, 2, 2, 3]
    assert int(final["opt"]["step"]) == 4


def test_driver_resume_from_disk(tmp_ckpt):
    model, step, data_fn, state = _setup(20)
    d1 = TrainDriver(DriverConfig(total_steps=10, checkpoint_every=5,
                                  checkpoint_dir=tmp_ckpt), step, data_fn)
    d1.run(state)
    d2 = TrainDriver(DriverConfig(total_steps=20, checkpoint_every=5,
                                  checkpoint_dir=tmp_ckpt), step, data_fn)
    s2 = d2.run(state)  # `state` is the structure donor; values come from disk
    assert int(s2["opt"]["step"]) == 20
    assert d2.events[0].step == 10            # resumed, not restarted


def test_straggler_watchdog(tmp_ckpt):
    """Eager steps on a loaded CPU take far longer than the reference's
    compiled ones, and vary: the slow step sleeps five times the slowest
    step the EMA has seen (every step but the first), so it is a straggler
    against any EMA of them."""
    model, step, data_fn, state = _setup(12)

    def slow_step(st, b):
        if int(st["opt"]["step"]) == 8:
            time.sleep(5 * max(e.wall for e in d.events[1:]))
        return step(st, b)

    d = TrainDriver(DriverConfig(total_steps=12, checkpoint_every=50,
                                 checkpoint_dir=tmp_ckpt, straggler_factor=3.0),
                    slow_step, data_fn)
    d.run(state)
    assert len(d.straggler_events) >= 1
    assert 8 in d.straggler_events


def test_elastic_restore(tmp_ckpt):
    """Checkpoint written under one sharding restores onto a different mesh
    (the reference's contract): gathered equal, each shard on its
    position's device; a plain restore places on ``like``'s device."""
    from repro_torch.dist.placement import Placed, device_get
    from repro_torch.launch import make_local_mesh
    from repro_torch.launch.sharding_rules import NamedSharding, PartitionSpec
    mgr = CheckpointManager(tmp_ckpt)
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    mgr.save(1, tree)
    back = mgr.restore(1, like={"w": torch.zeros(8, 8)})
    assert torch.equal(back["w"], tree["w"]) and back["w"].device == CPU
    mesh = make_local_mesh(4, 1, devices=["cpu"] * 4)
    sh = {"w": NamedSharding(mesh, PartitionSpec("data", None))}
    back = mgr.restore(1, like=tree, shardings=sh)
    assert isinstance(back["w"], Placed) and back["w"].sharding == sh["w"]
    assert torch.equal(device_get(back)["w"], tree["w"])
    for i in range(4):
        local = back["w"].local((i, 0))
        assert local.device == mesh.devices[i, 0]
        assert torch.equal(local, tree["w"][2 * i:2 * i + 2])


def test_driver_calibration_retries_and_surfaces_outcome(tmp_ckpt, tmp_path,
                                                         monkeypatch):
    import repro_torch.api as api
    target = str(tmp_path / "thresholds.json")
    calls = []

    def flaky_calibrate(save_to=None, **kw):
        calls.append(save_to)
        if len(calls) < 3:
            raise OSError("transient fs hiccup")
        with open(save_to, "w") as f:
            f.write("{}")

    monkeypatch.setattr(api, "calibrate_backend", flaky_calibrate)
    cfg = DriverConfig(checkpoint_dir=tmp_ckpt, calibrate_to=target,
                       calibrate_retries=3, calibrate_backoff=0.01)
    d = TrainDriver(cfg, lambda s, b: (s, {}), lambda i: None)
    assert d.calibration.status == "off"
    d._start_calibration()
    d.wait_calibration(timeout=30)
    assert d.calibration.ok and d.calibration.attempts == 3
    assert os.path.exists(target)

    calls.clear()

    def always_fails(save_to=None, **kw):
        raise OSError("disk gone")

    monkeypatch.setattr(api, "calibrate_backend", always_fails)
    target2 = str(tmp_path / "thresholds2.json")
    cfg2 = DriverConfig(checkpoint_dir=tmp_ckpt, calibrate_to=target2,
                        calibrate_retries=1, calibrate_backoff=0.01)
    d2 = TrainDriver(cfg2, lambda s, b: (s, {}), lambda i: None)
    with pytest.warns(UserWarning, match="failed after 2 attempts"):
        d2._start_calibration()
        d2.wait_calibration(timeout=30)
    assert d2.calibration.status == "failed" and "OSError" in d2.calibration.error

    d3 = TrainDriver(DriverConfig(checkpoint_dir=tmp_ckpt, calibrate_to=target),
                     lambda s, b: (s, {}), lambda i: None)
    d3._start_calibration()
    assert d3.calibration.status == "skipped"


def test_driver_calibrates_on_the_states_device(tmp_ckpt, tmp_path):
    """``calibrate_to`` runs the port's ``calibrate_backend`` for real on
    the device the train state lives on (the CPU here) and writes a
    thresholds file the reference reads."""
    from repro.core.selector import SelectorThresholds as RefThresholds
    target = str(tmp_path / "thresholds.json")
    cfg = DriverConfig(total_steps=1, checkpoint_dir=tmp_ckpt,
                       calibrate_to=target)
    state = {"w": torch.zeros(2)}
    d = TrainDriver(cfg, lambda s, b: (s, {"loss": torch.zeros(())}),
                    lambda i: None)
    d.run(state)
    d.wait_calibration(timeout=300)
    assert d.calibration.ok, d.calibration.error
    with open(target) as f:
        RefThresholds.from_json(f.read())


def test_serve_engine_batched_decode_masks_per_slot_length():
    cfg = get_smoke("llama3.2-1b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, slots=3, max_len=32,
                      async_prefill=False, async_plans=False)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8], [3, 1, 4, 1, 5]]
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=5))
    batch_sizes = []
    orig = eng._decode

    def spy(params, caches, toks):
        batch_sizes.append(int(toks.shape[0]))
        return orig(params, caches, toks)

    eng._decode = spy
    done = eng.run_until_done()
    assert max(batch_sizes) == 3                  # genuinely batched
    with torch.no_grad():
        for req, prompt in zip(done, prompts):
            toks = torch.tensor([prompt], dtype=torch.int32)
            logits, cache = model.prefill(params, {"tokens": toks}, 32)
            want = [int(torch.argmax(logits[0]))]
            for _ in range(4):
                logits, cache = model.decode_step(
                    params, cache, torch.tensor([[want[-1]]], dtype=torch.int32))
                want.append(int(torch.argmax(logits[0])))
            assert req.out == want, (req.rid, req.out, want)


def test_serve_engine_matches_sequential_decode():
    cfg = get_smoke("llama3.2-1b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, slots=2, max_len=64)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=5))
    done = eng.run_until_done()
    eng.close()
    assert all(r.done for r in done) and len(done) == 3
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.tensor([prompts[0]], dtype=torch.int32)}, 64)
        want = [int(torch.argmax(logits[0]))]
        for _ in range(4):
            logits, cache = model.decode_step(
                params, cache, torch.tensor([[want[-1]]], dtype=torch.int32))
            want.append(int(torch.argmax(logits[0])))
    assert done[0].out == want


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def _ref_tree():
    """A reference tree with a bfloat16 leaf, dict keys out of sorted order
    and a nested list."""
    rng = np.random.default_rng(0)
    return {"b": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16),
            "a": jnp.arange(6, dtype=jnp.int32).reshape(2, 3),
            "c": {"z": jnp.asarray(rng.standard_normal(5), jnp.float32),
                  "y": [jnp.asarray(7, jnp.int32),
                        jnp.asarray(rng.standard_normal(2), jnp.bfloat16)]}}


def _port_tree(ref):
    """``ref`` as tensors, its dicts' keys in their own order."""
    if isinstance(ref, dict):
        return {k: _port_tree(v) for k, v in ref.items()}
    if isinstance(ref, list):
        return [_port_tree(v) for v in ref]
    a = np.asarray(ref)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    """A leaf as numpy, bfloat16 (and the ``|V2`` it loads as) as int16."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 \
        or a.dtype.kind == "V" else a


def test_reference_checkpoint_restores_bit_equal(tmp_path):
    ref = _ref_tree()
    RefCheckpointManager(str(tmp_path)).save(3, ref)
    like = _port_tree(ref)
    like = {"b": torch.zeros_like(like["b"]), "a": like["a"] * 0,
            "c": {"z": like["c"]["z"] * 0, "y": [t * 0 for t in like["c"]["y"]]}}
    back = CheckpointManager(str(tmp_path)).restore(3, like)
    assert list(back) == ["b", "a", "c"] and list(back["c"]) == ["z", "y"]
    want = _port_tree(ref)
    assert back["b"].dtype == torch.bfloat16
    assert back["c"]["y"][1].dtype == torch.bfloat16
    for got, exp in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(want)):
        assert got.dtype == exp.dtype and got.shape == exp.shape
        assert np.array_equal(_bits(got), _bits(exp))


def test_port_checkpoint_restores_bit_equal_in_reference(tmp_path):
    ref = _ref_tree()
    CheckpointManager(str(tmp_path)).save(5, _port_tree(ref))
    back = RefCheckpointManager(str(tmp_path)).restore(5, like=ref)
    for got, exp in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(ref)):
        assert np.array_equal(_bits(got), _bits(exp))
        assert tuple(np.shape(got)) == tuple(np.shape(exp))


def test_checkpoint_format_matches_reference(tmp_path):
    """The same tree gives the same manifest and the same npz members in
    both packages."""
    ref = _ref_tree()
    RefCheckpointManager(str(tmp_path / "ref")).save(1, ref)
    CheckpointManager(str(tmp_path / "port")).save(1, _port_tree(ref))
    step = "step_000000001"
    man = [json.load(open(tmp_path / d / step / "manifest.json"))
           for d in ("ref", "port")]
    assert man[0] == man[1]
    with np.load(tmp_path / "ref" / step / "arrays.npz") as zr, \
            np.load(tmp_path / "port" / step / "arrays.npz") as zp:
        assert sorted(zr.files) == sorted(zp.files)
        for k in zr.files:
            assert zr[k].dtype.itemsize == zp[k].dtype.itemsize
            assert zr[k].tobytes() == zp[k].tobytes()


def test_driver_state_round_trips_bit_equal(tmp_ckpt):
    """A model's train state (nested params, AdamW moments, the step)
    restores bit for bit."""
    _, step, data_fn, state = _setup(4)
    state, _ = step(state, data_fn(0))
    mgr = CheckpointManager(tmp_ckpt)
    mgr.save(1, state)
    like = jax.tree_util.tree_map(torch.zeros_like, state)
    assert _equal_trees(mgr.restore(1, like), state)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 2)])
def test_synthetic_lm_batches_equal_reference(seed, step):
    ref = RefSyntheticLM(RefDataConfig(seed=seed, vocab_size=256, seq_len=16,
                                       global_batch=4)).batch(step)
    got = SyntheticLM(DataConfig(seed=seed, vocab_size=256, seq_len=16,
                                 global_batch=4)).batch(step)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_memmap_corpus_batches_equal_reference(tmp_path):
    from repro.data import MemmapCorpus as RefMemmapCorpus
    path = str(tmp_path / "tokens.bin")
    np.arange(1000, dtype=np.int32).tofile(path)
    cfg = dict(seed=1, vocab_size=1000, seq_len=8, global_batch=3)
    ref = RefMemmapCorpus(path, RefDataConfig(**cfg)).batch(4)
    got = MemmapCorpus(path, DataConfig(**cfg)).batch(4)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert np.array_equal(SyntheticLM(DataConfig(**cfg)).host_slice(2, 1, 3)
                          ["tokens"],
                          RefSyntheticLM(RefDataConfig(**cfg)).host_slice(
                              2, 1, 3)["tokens"])


def test_nested_train_step_matches_reference():
    """The train step on a model's nested params: one AdamW step of the
    llama smoke against ``repro.train`` (loss, metrics, new params)."""
    from repro.configs import get_smoke as ref_get_smoke
    from repro.models import Model as RefModel
    from repro.train import OptConfig as RefOptConfig
    from repro.train import TrainConfig as RefTrainConfig
    from repro.train import init_state as ref_init_state
    from repro.train import make_train_step as ref_make_train_step
    ref = RefModel(ref_get_smoke("llama3.2-1b"))
    ref_p = ref.init(jax.random.PRNGKey(0))
    cfg = get_smoke("llama3.2-1b")
    model = Model(cfg)
    p = interop.model_params_from_arrays(
        cfg, jax.tree_util.tree_map(np.asarray, ref_p), device=CPU)
    batch = SyntheticLM(DataConfig(seed=0, vocab_size=256, seq_len=16,
                                   global_batch=4)).batch(0)
    ref_state, ref_m = jax.jit(ref_make_train_step(
        ref.loss_fn, RefTrainConfig(opt=RefOptConfig(lr=1e-3, warmup_steps=2))))(
        ref_init_state(ref_p, RefTrainConfig()),
        {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = make_train_step(model.loss_fn, TrainConfig(
        opt=OptConfig(lr=1e-3, warmup_steps=2)))(
        init_state(p, TrainConfig()),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(m["loss"]) - float(ref_m["loss"])) < 1e-4 * abs(
        float(ref_m["loss"]))
    assert not m["loss"].requires_grad and not m["ce_loss"].requires_grad
    want = jax.tree_util.tree_map(np.asarray, ref_state["params"])
    got = jax.tree_util.tree_map(lambda t: t.numpy(), state["params"])
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-6)


# ---------------------------------------------------------------------------
# the examples, on the CPU
# ---------------------------------------------------------------------------

def test_example_serve_moe_runs_on_cpu():
    from repro_torch.examples import serve_moe
    m = serve_moe.main("cpu")
    assert m["pinned"]["plan_cache"]["builds"] == 1
    assert m["faulted"]["counters"]["plan_fallback_lanes"] >= 1


def test_example_serve_longcontext_runs_on_cpu():
    from repro_torch.examples import serve_longcontext
    s = serve_longcontext.main("cpu")
    assert s["builds"] == 2


def test_example_train_sparse_lm_runs_on_cpu(tmp_path):
    """Four steps of the example's model (6 layers, d_model 512, sparse FFN
    at density 0.15), a failure at step 3 rolled back to the step-2
    checkpoint, the loss of step 0's batch lower after than before."""
    from repro_torch.examples import train_sparse_lm
    armed = [True]

    def hook(s):
        if s == 3 and armed[0]:
            armed[0] = False
            raise RuntimeError("injected failure")

    driver, model, batch_fn, initial, final = train_sparse_lm.train(
        steps=4, batch=2, seq=16, device="cpu", checkpoint_every=2,
        checkpoint_dir=str(tmp_path / "ck"), failure_hook=hook)
    assert driver.restarts == 1
    assert [e.step for e in driver.events] == [0, 1, 2, 2, 3]
    assert int(final["opt"]["step"]) == 4
    with torch.no_grad():
        before, _ = model.loss_fn(initial["params"], batch_fn(0))
        after, _ = model.loss_fn(final["params"], batch_fn(0))
    assert float(after) < float(before)
