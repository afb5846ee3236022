"""The port's launch tooling (``repro_torch.launch``: ``cost_model``,
``analysis``, ``input_specs``, ``dryrun``, ``diagnose``, ``train``, the
production meshes) and ``models.params.abstract_params`` /
``param_shardings`` on the CPU, each against ``repro`` on the same inputs:
the analytic costs exactly, the stand-ins' shapes, types and specs on a
mesh of the reference's axes and extents (an ``AbstractMesh`` there, a
mesh of meta devices here), the roofline under the reference's v5e
constants exactly, and the launcher's losses within 1e-4 (relative) of
the reference's composition on the same initial params (``interop.
model_params_from_arrays``)."""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro.configs import get as ref_get
from repro.launch import analysis as ref_analysis
from repro.launch import cost_model as ref_cost
from repro.launch import input_specs as ref_specs
from repro.launch import train as ref_train
from repro.launch.sharding_rules import make_sharding_fn as ref_sfn
from repro.models import Model as RefModel
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.params import abstract_params as ref_abstract_params
from repro_torch import interop
from repro_torch.configs import ARCH_NAMES, get
from repro_torch.launch import (H100, V5E, Mesh, analysis, check_divisibility,
                                cost_model, input_specs, make_production_mesh,
                                make_sharding_fn, partition_spec,
                                resolve_rules)
from repro_torch.launch import diagnose, dryrun, train
from repro_torch.launch.analysis import Collective
from repro_torch.models import SHAPES, Model
from repro_torch.models.params import abstract_params, param_shardings

CELLS = [c.name for c in SHAPES]


def _cell(name):
    return next(c for c in SHAPES if c.name == name)


def _ref_cell(name):
    return next(c for c in REF_SHAPES if c.name == name)


def _meta_mesh(shape, axes):
    return Mesh(np.full(shape, "meta", dtype=object), axes)


MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree, path=()):
    """``{path: leaf}`` of nested dicts / tuples (the reference's and the
    port's trees both); a ``NamedSharding``, a ``(mesh, spec)`` pair, is a
    leaf."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], path + (k,)))
        return out
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "spec"):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: tree}


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _same_standins(ref_tree, args, shardings):
    ref, got, sh = _flat(ref_tree), _flat(args), _flat(shardings)
    assert set(ref) == set(got) == set(sh)
    for path, r in ref.items():
        t = got[path]
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(r.shape), path
        assert _dtype(t.dtype) == str(r.dtype), path
        assert tuple(sh[path].spec) == tuple(r.sharding.spec), path


# ------------------------------------------------------------- cost model

@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cell_cost_matches_reference(arch, cell):
    got = cost_model.cell_cost(get(arch), _cell(cell)).to_dict()
    want = ref_cost.cell_cost(ref_get(arch), _ref_cell(cell)).to_dict()
    assert got == want


@pytest.mark.parametrize("scale", ["smoke", "100m", "full"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_scale_config_matches_reference(arch, scale):
    got = dataclasses.asdict(train.scale_config(arch, scale))
    want = dataclasses.asdict(ref_train.scale_config(arch, scale))
    assert got == want


# ------------------------------------------------------ meshes and rules

def test_production_meshes_are_meta_at_the_reference_chip_counts():
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 32, "model": 8} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 32, "model": 8}
    assert multi.size == 512
    assert {d.type for d in multi.devices.reshape(-1)} == {"meta"}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_all_params_divisible_on_h100_production_mesh(arch):
    """Every param of every arch shards evenly on both H100 meshes (the
    counterpart of ``test_all_params_divisible_on_production_mesh``)."""
    rules = resolve_rules()
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for spec in _flat(Model(get(arch)).specs).values():
            ps = partition_spec(spec.logical, rules, mesh)
            assert check_divisibility(spec.shape, ps, mesh), \
                (arch, multi, spec.shape, spec.logical, ps)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_and_shardings_match_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    ref = ref_abstract_params(RefModel(ref_get(arch)).specs,
                              ref_sfn(AbstractMesh(shape, axes)))
    specs = Model(get(arch)).specs
    sfn = make_sharding_fn(_meta_mesh(shape, axes))
    _same_standins(ref, abstract_params(specs, sfn),
                   param_shardings(specs, sfn))


@pytest.mark.parametrize("cell", CELLS)
def test_rules_for_cell_match_reference_with_its_v5e_values(cell):
    """With the reference's model axis (16) and HBM (16 GB) the rules are
    its rules; ``finalize_rules`` sets one MoE group a device."""
    for arch in ARCH_NAMES:
        got = input_specs.rules_for_cell(_cell(cell), get(arch),
                                         model_axis=16, hbm_bytes=16e9)
        want = ref_specs.rules_for_cell(_ref_cell(cell), ref_get(arch))
        assert got == want, arch
        mesh = _meta_mesh(*MESHES["single"])
        assert input_specs.finalize_rules(got, mesh) == \
            ref_specs.finalize_rules(want, AbstractMesh(*MESHES["single"]))


def test_rules_for_cell_on_h100_derive_from_the_mesh_and_the_card():
    decode = _cell("decode_32k")
    # per device: param bytes / 8 against half of 80 GiB
    assert input_specs.rules_for_cell(decode, get("gemma3-12b"))["embed"] == ()
    assert input_specs.rules_for_cell(decode, get("qwen2-vl-72b"))["embed"] == ()
    assert input_specs.rules_for_cell(
        decode, get("kimi-k2-1t-a32b"))["embed"] == ("pod", "data")
    # the reference's v5e keeps qwen2-vl-72b's FSDP (145 GB / 16 > 8 GB)
    assert input_specs.rules_for_cell(
        decode, get("qwen2-vl-72b"), model_axis=16,
        hbm_bytes=V5E.hbm_bytes)["embed"] == ("pod", "data")
    assert input_specs.rules_for_cell(_cell("train_4k"))["__gather_weights__"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_build_cell_standins_match_reference(arch, cell):
    shape, axes = MESHES["single"]
    _, ref_args, _ = ref_specs.build_cell(
        RefModel(ref_get(arch)), _ref_cell(cell), AbstractMesh(shape, axes))
    built = input_specs.build_cell(Model(get(arch)), _cell(cell),
                                   _meta_mesh(shape, axes), hbm_bytes=16e9)
    _same_standins(ref_args, built.args, built.shardings)


# ---------------------------------------------------------------- roofline

@pytest.mark.parametrize("case", [
    (1.2e18, 3.4e15, 7.5e9, 256, 9.0e17, 0.0, 0.0),
    (4.6e12, 8.1e11, 0.0, 512, 2.3e12, 1.5e10, 2.5e9),
    (2.0e15, 9.9e14, 3.3e11, 512, 1.0e15, 0.0, 0.0),
])
def test_roofline_terms_match_reference_under_v5e(case):
    got = analysis.roofline_terms(*case, hw=V5E).to_dict()
    want = ref_analysis.roofline_terms(*case).to_dict()
    for key, value in want.items():
        assert got[key] == value, key
    assert got["collective_s_by_link"] == {"ici": case[2] / 50e9}


def test_roofline_splits_the_collective_term_by_link():
    r = analysis.roofline_terms(
        1e15, 1e12, {"nvlink": 4.5e9, "ib": 5e8}, 256, 6e14)
    assert r.collective_s_by_link == {"nvlink": 0.01, "ib": 0.01}
    assert r.collective_s == pytest.approx(0.02)
    assert r.compute_s == 1e15 / (256 * H100.peak_flops_bf16)
    assert r.memory_s == 1e12 / (256 * H100.hbm_bw)
    assert r.wire_bytes_per_dev == pytest.approx(5e9)
    assert r.bottleneck == "collective"


def test_collective_bytes_hand_computed():
    recs = [
        Collective("all-gather", 100.0, ("data",), 4),           # 75 on ib
        Collective("all-reduce", 64.0, ("model",), 4, 2),        # 2x96 nvlink
        Collective("reduce-scatter", 80.0, ("model",), 8),       # 70 nvlink
        Collective("all-to-all", 40.0, ("pod", "data"), 2),      # 20 on ib
        Collective("collective-permute", 10.0, ("model",), 8),   # 10 nvlink
        Collective("all-gather", 8.0, ("data", "model"), 1),     # n=1 → 2: 4
    ]
    out = analysis.collective_bytes(recs)
    assert out["all-gather"] == 79.0
    assert out["all-reduce"] == 192.0
    assert out["reduce-scatter"] == 70.0
    assert out["all-to-all"] == 20.0
    assert out["collective-permute"] == 10.0
    assert out["n_all-reduce"] == 2 and out["n_all-gather"] == 2
    assert out["total_wire_bytes"] == 371.0
    # a group over data and model crosses the slower link
    assert out["wire_bytes_by_link"] == {"nvlink": 272.0, "ib": 99.0}
    assert analysis.collective_bytes(recs, V5E)["wire_bytes_by_link"] == \
        {"ici": 371.0}


def test_plan_collectives_by_regime():
    """Train gathers a weight twice and reduce-scatters its grad; decode
    keeps TP: it gathers q, k and v over ``model``, merges the
    sequence-split cache's softmax statistics and all-reduces the
    row-parallel outputs; the grouped MoE moves its buffer by
    all-to-all."""
    mesh = make_production_mesh()
    llama = Model(get("llama3.2-1b"))
    # every Llama leaf is sharded over the batch axes (FSDP): no grad
    # all-reduce is left; train's all-reduces are the vocab-sharded loss's
    # and the global norm's, decode's the runtime's (``models/spmd.py``)
    for name, kinds in (("train_4k", {"all-gather", "reduce-scatter",
                                      "all-reduce"}),
                        ("prefill_32k", {"all-gather"}),
                        ("decode_32k", {"all-gather", "all-reduce"})):
        cell = _cell(name)
        rules = input_specs.build_cell(llama, cell, mesh).rules
        recs = dryrun.plan_collectives(llama, cell, mesh, rules)
        assert {r.kind for r in recs} == kinds, name
        assert not [r for r in recs if r.kind == "all-reduce"
                    and r.rule not in ("vocab-parallel loss", "clip",
                                       "runtime")], name
    cell = _cell("decode_32k")
    rules = input_specs.build_cell(llama, cell, mesh).rules
    recs = dryrun.plan_collectives(llama, cell, mesh, rules)
    assert all(r.axes == ("model",) and r.n == 8 for r in recs)
    b = 128 // 32                                   # a position's rows
    rows = [r for r in recs if "row-parallel" in r.what]
    assert sum(r.count for r in rows) == 2 * 16
    assert all(r.bytes == b * 2048 * 4 for r in rows)     # f32 partials
    (q,) = [r for r in recs if r.what.endswith("wq (column-parallel)")]
    assert q.kind == "all-gather" and q.count == 16
    assert q.bytes == b * 32 * 64 * 2
    merge = [r for r in recs if r.what.startswith("decode attention")]
    assert sorted(r.bytes for r in merge) == [b * 32 * 4, b * 32 * 4,
                                              b * 32 * 64 * 4]
    olmoe = Model(get("olmoe-1b-7b"))
    cell = _cell("train_4k")
    rules = input_specs.build_cell(olmoe, cell, mesh).rules
    a2a = [r for r in dryrun.plan_collectives(olmoe, cell, mesh, rules)
           if r.kind == "all-to-all"]
    assert len(a2a) == 1 and a2a[0].count == 4 * 16
    # expert weights stay sharded over model: gathered over data only
    gathers = [r for r in dryrun.plan_collectives(olmoe, cell, mesh, rules)
               if r.kind == "all-gather" and r.what == "blocks.ffn.w_up"]
    assert [r.axes for r in gathers] == [("data",)]


# ----------------------------------------------------------------- dry run

class _OffMeta(TorchDispatchMode):
    """Records every tensor an op makes off the meta device."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.made += [(str(func), t.nbytes) for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor) and t.device.type != "meta"]
        return out


#: host scalars the model code makes from Python numbers (Gemma's √d
#: rounded to the compute type, M-RoPE's three section sizes); no
#: parameter, activation or cache leaves the meta device
HOST_SCALARS = 64


REF_KEYS = {"arch", "cell", "mesh", "status", "chips", "lower_s", "compile_s",
            "memory_analysis", "cost_analysis", "collectives", "cost_model",
            "roofline"}
MEM_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
            "alias_size_in_bytes", "peak_memory_in_bytes"}


def _run(tmp_path, arch, shape, multi=False):
    with _OffMeta() as mode:
        art = dryrun.run_cell(arch, shape, multi, str(tmp_path))
    assert sum(n for _, n in mode.made) <= HOST_SCALARS, mode.made[:5]
    path = tmp_path / f"{arch}__{shape}__{'multi' if multi else 'single'}.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(art))
    return art


def _check_ok(art, cfg, cell):
    assert set(art) == REF_KEYS and art["status"] == "ok"
    assert MEM_KEYS <= set(art["memory_analysis"])
    assert art["memory_analysis"]["fits"] is True
    assert art["cost_model"] == cost_model.cell_cost(cfg, cell).to_dict()
    assert art["cost_analysis"]["off_meta_bytes"] <= HOST_SCALARS
    assert art["roofline"]["bottleneck"] in ("compute", "memory", "collective")


def test_dryrun_dense_train_cell(tmp_path):
    """Llama-3.2-1B train_4k on (data=32, model=8).  The traced FLOPs are
    4/3 of the analytic model's within 1%: the published config remats
    every block (``remat="block"``), so the backward recomputes each
    block's forward (4 forward passes' worth), where the analytic model
    assumes a dots-saveable policy (3, matmul recompute ≈ 0); the loss's
    unembedding, outside the blocks, is not recomputed."""
    cfg, cell = get("llama3.2-1b"), _cell("train_4k")
    art = _run(tmp_path, "llama3.2-1b", "train_4k")
    _check_ok(art, cfg, cell)
    ratio = art["cost_analysis"]["flops"] / art["cost_model"]["flops"]
    assert abs(ratio - 4 / 3) < 0.01 * 4 / 3, ratio
    mem = art["memory_analysis"]
    # params bf16 + f32 moments, fully sharded over 256 cards, and the batch
    n = cost_model.cell_cost(cfg, cell).n_params
    want = n * (2 + 4 + 4) / 256 + 2 * (256 // 32) * 4096 * 4 + 4
    assert abs(mem["argument_size_in_bytes"] - want) < 1e-3 * want
    # the new state beside the old: nothing aliased
    assert mem["output_size_in_bytes"] == mem["argument_size_in_bytes"] - \
        2 * (256 // 32) * 4096 * 4 and mem["alias_size_in_bytes"] == 0
    coll = art["collectives"]
    assert coll["n_all-gather"] > 0 and coll["n_reduce-scatter"] > 0
    assert art["roofline"]["collective_s"] > 0


def test_dryrun_decode_cell(tmp_path):
    cfg, cell = get("gemma3-12b"), _cell("decode_32k")
    art = _run(tmp_path, "gemma3-12b", "decode_32k")
    _check_ok(art, cfg, cell)
    # one token a lane: the trace's FLOPs within 2x of the analytic model
    ratio = art["cost_analysis"]["flops"] / art["cost_model"]["flops"]
    assert 0.5 < ratio < 2.0, ratio
    # the runtime's log: a layer's split-KV merge (3), wo and w_down; the
    # embedding's lookup; q, k and v gathered a layer
    coll = art["collectives"]
    assert coll["source"].startswith("runtime")
    assert coll["n_all-reduce"] == 5 * cfg.num_layers + 1
    assert coll["n_all-gather"] == 3 * cfg.num_layers


def test_dryrun_audio_prefill_cell(tmp_path):
    cfg, cell = get("whisper-tiny"), _cell("prefill_32k")
    art = _run(tmp_path, "whisper-tiny", "prefill_32k")
    _check_ok(art, cfg, cell)
    assert art["cost_analysis"]["flops"] > 0


def test_dryrun_long_context_skip(tmp_path):
    art = _run(tmp_path, "llama3.2-1b", "long_500k")
    assert art["status"] == "skipped" and "full-attention" in art["reason"]


def test_dryrun_moe_train_cell_traces_the_grouped_dispatch(tmp_path):
    """OLMoE-1B-7B train_4k: one dispatch group a device (256) routes the
    MoE through the grouped scatter, which traces on meta tensors; the
    all-to-alls are in the plan."""
    cfg, cell = get("olmoe-1b-7b"), _cell("train_4k")
    art = _run(tmp_path, "olmoe-1b-7b", "train_4k")
    _check_ok(art, cfg, cell)
    assert art["cost_analysis"]["flops"] > art["cost_model"]["flops"]
    assert art["collectives"]["n_all-to-all"] == 4 * cfg.num_layers


def test_trace_of_a_value_dependent_op_is_null_with_its_reason():
    """One dispatch group (no mesh scope) sends the MoE through the SpMM,
    whose backward builds Aᵀ's pattern with ``torch.nonzero`` on the host:
    no meta implementation, so the diagnostic is null and says where."""
    from repro_torch.configs import get_smoke
    from repro_torch.train import TrainConfig, make_train_step
    cfg = get_smoke("olmoe-1b-7b")
    model = Model(cfg)
    mesh = _meta_mesh((1, 1), ("data", "model"))
    state, _ = input_specs.state_specs(model, TrainConfig(),
                                       make_sharding_fn(mesh))
    batch = {k: torch.empty((2, 64), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    step = make_train_step(model.loss_fn, TrainConfig())
    out = dryrun.trace_flops(step, (state, batch))
    assert out["flops"] is None and out["bytes_accessed"] is None
    assert "nonzero" in out["reason"] and "repro_torch/" in out["reason"]


def test_trace_past_its_budget_is_null_with_its_reason():
    built = input_specs.build_cell(Model(get("llama3.2-1b")),
                                   _cell("train_4k"), make_production_mesh())
    out = dryrun.trace_flops(built.fn, built.args, budget_s=0.0)
    assert out["flops"] is None and "budget of 0 s" in out["reason"]


def test_diagnose_attributes_collectives(capsys):
    dryrun_mesh = make_production_mesh(multi_pod=True)
    text = diagnose.diagnose(Model(get("phi4-mini-3.8b")),
                             _cell("prefill_32k"), dryrun_mesh, top=5)
    assert "all-gather" in text and "ib" in text and "nvlink" in text
    assert "blocks.attn" in text and "->" in text
    assert "argument bytes a device by parameter group" in text


def test_dryrun_cli_writes_the_artifact(tmp_path):
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--multipod", "--out", str(tmp_path)])
    art = json.loads((tmp_path / "whisper-tiny__decode_32k__multi.json")
                     .read_text())
    assert art["status"] == "ok" and art["chips"] == 512


# ---------------------------------------------------------------- launcher

STEPS, BATCH, SEQ = 3, 2, 32


def _ref_run(cfg, ckpt_dir, steps=STEPS, batch=BATCH, seq=SEQ, lr=3e-4):
    """The reference's composition (``repro/launch/train.py:86-113``) on
    ``cfg``: its initial params, its losses and its final train state
    (numpy)."""
    from repro.data import DataConfig, SyntheticLM
    from repro.launch.mesh import make_local_mesh
    from repro.runtime import DriverConfig, TrainDriver
    from repro.train import OptConfig, TrainConfig, init_state, make_train_step

    model = RefModel(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=lr, warmup_steps=20,
                                     total_steps=steps))
    data = SyntheticLM(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                  seq_len=seq, global_batch=batch))
    with make_local_mesh(1, 1):
        params = model.init(jax.random.PRNGKey(0))
        host = jax.tree_util.tree_map(np.asarray, params)
        state = init_state(params, tcfg)
        step = jax.jit(make_train_step(model.loss_fn, tcfg),
                       donate_argnums=(0,))
        driver = TrainDriver(
            DriverConfig(total_steps=steps, checkpoint_every=steps + 1,
                         checkpoint_dir=ckpt_dir),
            step, lambda i: {k: jnp.asarray(v)
                             for k, v in data.batch(i).items()})
        state = driver.run(state)
    return (host, [e.metrics["loss"] for e in driver.events],
            jax.tree_util.tree_map(np.asarray, state))


def _arrays(tree):
    """``_flat(tree)`` with its leaves as f64 numpy."""
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v, dtype=np.float64)
            for k, v in _flat(tree).items()}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b"])
def test_launcher_losses_match_reference(arch, tmp_path):
    """The losses, and the update itself: each leaf's change over the run
    and its AdamW moments against the reference's.  Three warm-up steps
    move a parameter by ~1e-5, so the losses alone barely see the update
    (a learning rate 1% off moves them by 3e-7).  Each leaf's change is
    compared in 2-norm, relative, within 1e-3 (measured: under 1e-4; the
    1% learning rate gives 1e-2), the moments within 1e-5 (measured:
    ~1e-6)."""
    host, want, ref_state = _ref_run(ref_train.scale_config(arch, "smoke"),
                                     str(tmp_path / "ref"))
    cfg = train.scale_config(arch, "smoke")
    assert cfg.param_dtype == cfg.compute_dtype == "float32"
    params = interop.model_params_from_arrays(cfg, host, device="cpu")
    driver, _, state = train.train(
        cfg, steps=STEPS, batch=BATCH, seq=SEQ, device="cpu", params=params,
        ckpt_dir=str(tmp_path / "port"))
    got = [e.metrics["loss"] for e in driver.events]
    assert len(got) == STEPS == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(state["opt"]["step"]) == STEPS == int(ref_state["opt"]["step"])
    init, ref_final = _arrays(host), _arrays(ref_state["params"])
    final = _arrays(state["params"])
    assert final.keys() == ref_final.keys() == init.keys()
    worst = {k: _rel(final[k] - init[k], ref_final[k] - init[k])
             for k in final}
    assert max(worst.values()) < 1e-3, worst
    for moment in ("m", "v"):
        ref_m, got_m = _arrays(ref_state["opt"][moment]), _arrays(
            state["opt"][moment])
        assert got_m.keys() == ref_m.keys()
        worst = {k: _rel(got_m[k], ref_m[k]) for k in got_m}
        assert max(worst.values()) < 1e-5, (moment, worst)


def _cut_100m(scale_config):
    """The launcher's 100m OLMoE cut to 2 layers of 128 and a vocab of
    1,024; the MoE keeps the 100m's capacity factor, so experts overflow
    and drop tokens."""
    cfg = scale_config("olmoe-1b-7b", "100m")
    return cfg.scaled(num_layers=2, d_model=128, num_heads=4,
                      num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=1024,
                      moe=dataclasses.replace(cfg.moe, d_ff_expert=256))


def test_launcher_follows_reference_past_warmup(tmp_path):
    """100 steps of 16 x 128 at lr 3e-3 from the reference's params, past
    the warm-up and through the drop in loss that learning the stream's
    structure makes: each 25-step mean within 5e-3 of the reference's
    (measured: 7e-4; near-tied routing picks part single steps by up to
    1e-2), and the loss falls 0.1 from the first 25 steps to the last."""
    steps, batch, seq, lr = 100, 16, 128, 3e-3
    host, want, _ = _ref_run(_cut_100m(ref_train.scale_config),
                             str(tmp_path / "ref"), steps, batch, seq, lr)
    cfg = _cut_100m(train.scale_config)
    params = interop.model_params_from_arrays(cfg, host, device="cpu")
    driver, _, _ = train.train(
        cfg, steps=steps, batch=batch, seq=seq, lr=lr, device="cpu",
        params=params, ckpt_dir=str(tmp_path / "port"), ckpt_every=steps + 1)
    got = np.array([e.metrics["loss"] for e in driver.events])
    ref = np.array(want).reshape(-1, 25).mean(1)
    np.testing.assert_allclose(got.reshape(-1, 25).mean(1), ref, atol=5e-3)
    assert ref[-1] < ref[0] - 0.1


def test_launcher_main_writes_results(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = train.main(["--arch", "whisper-tiny", "--scale", "smoke",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    saved = json.loads((tmp_path / "results" / "train_whisper-tiny.json")
                       .read_text())
    assert saved["losses"] == out["losses"] and len(saved["losses"]) == 2
    assert all(np.isfinite(saved["losses"]))


def test_launcher_mesh_needs_the_cards():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        train.local_mesh(2, 1, torch.device("cuda"))
    assert train.local_mesh(2, 2, torch.device("cpu")).size == 4
