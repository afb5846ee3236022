"""Decode on placed parameters (``models/spmd.py``'s tensor-parallel
regime) on a (data=2, model=2) mesh of CPU positions: three decode steps
after a prefill of the smoke Llama-3.2-1B, Gemma-3-12B (local and global
caches), Llama with a sparse FFN (value streams split over data, and
replicated), Zamba2-2.7B, RWKV-6-3B and Whisper-tiny under the
``decode_32k`` rules, one case with a length a lane, and Llama, Gemma,
Zamba2 and RWKV-6 at batch 1 under the ``long_500k`` rules (the cache's
sequence split four ways).  The logits and every cache leaf are held to
the port's unsharded decode and to the reference's GSPMD decode on 4 host
devices, within 1e-5; the placed caches keep ``cache_logical``'s spec;
the runtime's collective log equals ``dryrun.plan_collectives`` on the
local mesh and on both production meshes; MoE decode is refused.

Params are seeded numpy arrays carried across by ``interop.
model_params_from_arrays``; the sparse patterns are the reference's
(``interop.sparse_ffn_from_arrays``).  The reference runs in one subprocess
(``test_torch_shard.start_reference``), started by the module's first test
and read by the tests that need it."""
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models.config import SparseFFNConfig as RefSparseFFNConfig
from repro.models.transformer import sparse_patterns as ref_sparse_patterns
from repro_torch import interop
from repro_torch.configs import get, get_smoke
from repro_torch.dist import placement
from repro_torch.dist.placement import Placed, device_get, device_put
from repro_torch.launch import (dryrun, input_specs, make_local_mesh,
                                make_production_mesh)
from repro_torch.launch.train import param_placement
from repro_torch.models import SHAPES, Model, spmd
from repro_torch.models.config import ShapeCell, SparseFFNConfig
from repro_torch.models.model import cache_logical
from repro_torch.models.sharding_ctx import activation_sharding

from test_torch_shard import finish_reference, start_reference
from test_torch_tp import _flat

STEPS, PROMPT, MAX_LEN = 3, 14, 32
TOL = 1e-5
DENSITY = 0.3
#: lane lengths of the "lanes" case (each lane at its own position)
LANES = (14, 9, 3, 11)
#: case -> (arch, sparse FFN tile or None, cell).  At density 0.3 the smoke
#: Llama's matrices hold 2457 nonzeros: 308 tiles of 8 (split over data),
#: 351 tiles of 7 (replicated)
CASES = {"llama": ("llama3.2-1b", None, "decode_32k"),
         "gemma": ("gemma3-12b", None, "decode_32k"),
         "sparse-split": ("llama3.2-1b", 8, "decode_32k"),
         "sparse-replicated": ("llama3.2-1b", 7, "decode_32k"),
         "zamba2": ("zamba2-2.7b", None, "decode_32k"),
         "rwkv6": ("rwkv6-3b", None, "decode_32k"),
         "whisper": ("whisper-tiny", None, "decode_32k"),
         "lanes": ("llama3.2-1b", None, "decode_32k"),
         "llama-long": ("llama3.2-1b", None, "long_500k"),
         "gemma-long": ("gemma3-12b", None, "long_500k"),
         "zamba2-long": ("zamba2-2.7b", None, "long_500k"),
         "rwkv6-long": ("rwkv6-3b", None, "long_500k")}
#: port-only cases: weights FSDP-kept (``embed`` over the DP axes, as
#: ``rules_for_cell`` keeps it for an arch that does not fit the model
#: axis), against the unsharded decode and the plan
FSDP_CASES = {"rwkv6-long-fsdp": ("rwkv6-3b", None, "long_500k"),
              "zamba2-fsdp": ("zamba2-2.7b", None, "decode_32k")}

REF_SCRIPT = r'''
import sys
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.launch.input_specs import finalize_rules, rules_for_cell
from repro.launch.sharding_rules import SPARSE_WEIGHT_RULES, make_sharding_fn
from repro.models import SHAPES, Model
from repro.models.config import SparseFFNConfig
from repro.models.params import param_shardings
from repro.models.sharding_ctx import activation_sharding
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


def flatten(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten(v, f"{prefix}{k}/")
        else:
            out[f"{prefix}{k}"] = np.asarray(v)


def merge(a, b):
    if isinstance(a, dict):
        return {k: merge(a[k], b[k]) for k in a}
    return a if b is None else b


def run(case, arch, tile, cell_name):
    """Prefill, then %(steps)d decode steps of ``case`` under the decode
    rules; the cases run on threads of their own, so that XLA compiles
    them side by side."""
    cfg = get_smoke(arch)
    cell = next(c for c in SHAPES if c.name == cell_name)
    rules = finalize_rules(rules_for_cell(cell, cfg), mesh)
    if tile is not None:
        cfg = cfg.scaled(sparse_ffn=SparseFFNConfig(density=%(density)r,
                                                    tile=tile))
        rules = dict(rules, **SPARSE_WEIGHT_RULES)
    model = Model(cfg)
    host = unflatten(f"{case}/p/")
    sh = param_shardings(model.specs, make_sharding_fn(mesh, rules))
    if tile is not None:
        sh = merge(sh, sparse_weight_shardings(host, mesh, rules))
    params = jax.tree_util.tree_map(jax.device_put, host, sh)
    batch = {"tokens": jnp.asarray(inp[f"{case}/prompt"])}
    if cfg.family == "audio":
        batch["frames"] = jnp.asarray(inp[f"{case}/frames"])

    def prefill(p, b):
        with activation_sharding(mesh, rules):
            return model.prefill(p, b, %(max_len)d)

    def decode(p, c, t):
        with activation_sharding(mesh, rules):
            return model.decode_step(p, c, t)
    _, caches = jax.jit(prefill)(params, batch)
    if f"{case}/lanes" in inp:
        caches = dict(caches, length=jnp.asarray(inp[f"{case}/lanes"]))
    decode = jax.jit(decode)
    for i in range(%(steps)d):
        logits, caches = decode(params, caches,
                                jnp.asarray(inp[f"{case}/tok{i}"]))
        out[f"{case}/logits{i}"] = np.asarray(logits)
    out[f"{case}/logits_spec"] = np.array(str(logits.sharding.spec))
    flatten(caches, f"{case}/caches/")


with ThreadPoolExecutor(len(%(cases)r)) as pool:
    for f in [pool.submit(run, case, *a) for case, a in %(cases)r.items()]:
        f.result()
np.savez(sys.argv[2], **out)
''' % {"cases": CASES, "density": DENSITY, "steps": STEPS,
       "max_len": MAX_LEN}


def _mesh():
    return make_local_mesh(2, 2, devices=["cpu"] * 4)


def _case(case):
    return CASES.get(case) or FSDP_CASES[case]


def _cfg(case):
    arch, tile, _ = _case(case)
    cfg = get_smoke(arch)
    if tile is not None:
        cfg = cfg.scaled(sparse_ffn=SparseFFNConfig(density=DENSITY, tile=tile))
    return cfg


def _cell(case) -> ShapeCell:
    return next(c for c in SHAPES if c.name == _case(case)[2])


def _rules(case) -> dict:
    fsdp = case in FSDP_CASES
    rules = input_specs.rules_for_cell(_cell(case), _cfg(case), model_axis=2,
                                       hbm_bytes=1e3 if fsdp else 80e9)
    assert rules["embed"] == (("pod", "data") if fsdp else ())
    return rules


def _batch_size(case) -> int:
    return 1 if _case(case)[2] == "long_500k" else 4


def _np_params(model: Model, seed: int) -> dict:
    """Seeded numpy arrays of every leaf: N(0, 1) / sqrt(fan-in) for the
    matrices, N(0, 0.1²) for the vectors and the value streams."""
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        shape = tree.shape
        scale = 0.1 if len(shape) == 1 or name.startswith("v_") or \
            name.endswith("ln") else 1 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return walk(model.specs)


def _inputs(case) -> dict:
    """The case's prompt, decode tokens (and frames, lanes) from its seed."""
    cfg, b = _cfg(case), _batch_size(case)
    rng = np.random.default_rng(list(CASES).index(case) if case in CASES
                                else 99)
    out = {"prompt": rng.integers(0, 256, (b, PROMPT)).astype(np.int32)}
    for i in range(STEPS):
        out[f"tok{i}"] = rng.integers(0, 256, (b, 1)).astype(np.int32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.num_frames, cfg.d_model)).astype(np.float32)
    if case == "lanes":
        out["lanes"] = np.array(LANES, np.int32)
    return out


_MODELS: dict = {}


def _model(case):
    """``case``'s model (the reference's patterns for a sparse FFN) and its
    numpy params, made once a module."""
    if case not in _MODELS:
        cfg = _cfg(case)
        patterns = None
        if cfg.sparse_ffn is not None:
            ref = ref_sparse_patterns(ref_get_smoke(_case(case)[0]).scaled(
                sparse_ffn=RefSparseFFNConfig(density=DENSITY,
                                              tile=cfg.sparse_ffn.tile)))
            ref = {k: (np.asarray(p.rows), np.asarray(p.cols))
                   for k, p in ref.items()}
            layers = [interop.sparse_ffn_from_arrays(
                cfg, {k: (r[i], c[i]) for k, (r, c) in ref.items()}, {},
                device="cpu").patterns for i in range(cfg.num_layers)]
            patterns = {k: [pl[k] for pl in layers] for k in ref}
        model = Model(cfg, patterns=patterns)
        _MODELS[case] = (model, _np_params(model, seed=len(_MODELS)))
    return _MODELS[case]


def _torch(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.long() if a.dtype == np.int32 else t


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    inputs = {}
    for case in CASES:
        _, params = _model(case)
        inputs.update({f"{case}/p/{k}": v for k, v in _flat(params).items()})
        inputs.update({f"{case}/{k}": v for k, v in _inputs(case).items()})
    started = start_reference(REF_SCRIPT, inputs,
                              tmp_path_factory.mktemp("tp_decode_ref"))
    box = {}

    def get_out():
        if "out" not in box:
            box["out"] = finish_reference(started)
        return box["out"]
    yield get_out
    if started[0].poll() is None:
        started[0].kill()
        started[0].communicate()


def _decode(case, placed: bool):
    """Prefill unsharded, then the decode steps: ``(logits by step, the
    caches unplaced, the placed caches, the first step's log)``."""
    model, arrays = _model(case)
    params = interop.model_params_from_arrays(model.cfg, arrays, device="cpu")
    inp = _inputs(case)
    batch = {"tokens": _torch(inp["prompt"])}
    if "frames" in inp:
        batch["frames"] = _torch(inp["frames"])
    rules, mesh = _rules(case), _mesh()
    logits, log0 = [], None
    with torch.no_grad():
        _, caches = model.prefill(params, batch, MAX_LEN)
        if "lanes" in inp:
            caches["length"] = _torch(inp["lanes"]).int()
        if placed:
            params = device_put(params, param_placement(model, params, mesh,
                                                        rules))
            caches = device_put(caches, model.cache_shardings(caches, mesh,
                                                              rules))
        for i in range(STEPS):
            with activation_sharding(mesh, rules, enabled=placed), \
                    spmd.collective_log() as log:
                out, caches = model.decode_step(params, caches,
                                                _torch(inp[f"tok{i}"]))
            logits.append(out)
            log0 = log0 or log
    return logits, device_get(caches), caches, log0


@pytest.fixture(scope="module")
def runs():
    return {(case, placed): _decode(case, placed)
            for case in (*CASES, *FSDP_CASES) for placed in (False, True)}


def _close(got, want, tol=TOL):
    """Within ``tol`` of the largest entry of ``want``."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want.detach().float() if isinstance(want, torch.Tensor)
                      else want, np.float32)
    atol = tol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# against the unsharded decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [*CASES, *FSDP_CASES])
def test_decode_matches_the_unsharded_decode(case, runs):
    """Every step's logits and every cache leaf after the last step
    within 1e-5 of the port's unsharded decode from the same caches."""
    want_logits, want_caches, _, _ = runs[(case, False)]
    got_logits, got_caches, placed, _ = runs[(case, True)]
    for got, want in zip(got_logits, want_logits):
        assert isinstance(got, Placed)
        _close(device_get(got), want)
    flat = _flat(got_caches)
    assert set(flat) == set(_flat(want_caches))
    for key, leaf in _flat(want_caches).items():
        _close(flat[key], leaf)


@pytest.mark.parametrize("case", [*CASES, *FSDP_CASES])
def test_placed_caches_keep_their_spec(case, runs):
    """The caches come back placed as ``cache_logical`` under the decode
    rules places them (the batch over the batch axes, a KV cache's
    sequence over ``model`` — over ``(data, model)`` at long_500k), the
    logits over the batch and vocab axes."""
    logits, _, placed, _ = runs[(case, True)]
    model, _ = _model(case)
    want = model.cache_shardings(device_get(placed), _mesh(), _rules(case))
    for key, leaf in _flat(placed).items():
        assert isinstance(leaf, Placed), key
        spec = tuple(_flat(want)[key].spec)
        assert leaf.spec == spec + (None,) * (leaf.ndim - len(spec)), key
    long = _case(case)[2] == "long_500k"
    kv = [leaf for key, leaf in _flat(placed).items()
          if key.endswith(("kv/k", "global/k"))]
    assert all(k.spec[-2] == (("data", "model") if long else "model")
               for k in kv)
    assert kv or model.cfg.family == "ssm"
    assert logits[0].spec == ((None, "model") if long else ("data", "model"))


# ---------------------------------------------------------------------------
# the collective log against the plan
# ---------------------------------------------------------------------------

def _by_record(recs) -> dict:
    """Counts by ``(kind, axes, group size, bytes)``."""
    out = {}
    for r in recs:
        key = (r.kind, r.axes, r.n, r.bytes)
        out[key] = out.get(key, 0) + r.count
    return out


@pytest.mark.parametrize("case", [*CASES, *FSDP_CASES])
def test_log_matches_the_plan_on_the_local_mesh(case, runs):
    """Every position's log of one step equals the plan record for record
    in bytes: the q / k / v all-gathers over model, the split-KV merge
    over the cache's sequence axes, the row-parallel all-reduces, the
    embedding's, the Mamba-2 and RWKV-6 gathers, the sparse FFN's
    broadcast and reduce over data, the FSDP-kept weights' gathers."""
    model, _ = _model(case)
    log = runs[(case, True)][3]
    cell = ShapeCell("smoke", MAX_LEN, _batch_size(case), "decode")
    memory = model.cfg.num_frames if model.cfg.family == "audio" else 0
    plan = dryrun.plan_collectives(model, cell, _mesh(), _rules(case),
                                   memory=memory)
    for pos in placement.positions(_mesh()):
        assert _by_record(log.program(pos)) == _by_record(plan), pos
    kinds = {r.kind for r in plan}
    assert kinds >= {"all-gather", "all-reduce"}
    if case == "sparse-split":
        assert {"broadcast", "reduce"} <= kinds
    assert not [r for r in plan if ".v_" in r.what and r.kind == "all-gather"]


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch,shape", [
    ("llama3.2-1b", "decode_32k"), ("gemma3-12b", "long_500k"),
    ("zamba2-2.7b", "decode_32k"), ("rwkv6-3b", "long_500k"),
    ("whisper-tiny", "decode_32k")])
def test_log_matches_the_plan_on_the_production_meshes(arch, shape, multi):
    """The arch's decode cell on the meta production mesh: position
    (0, …, 0)'s log of one step equals the plan record for record, and the
    dry run takes it (``runtime_collectives`` runs decode cells)."""
    model = Model(get(arch))
    mesh = make_production_mesh(multi_pod=multi)
    cell = next(c for c in SHAPES if c.name == shape)
    built = input_specs.build_cell(model, cell, mesh)
    ran = dryrun.runtime_collectives(model, cell, mesh, built)
    assert ran
    assert _by_record(ran) == _by_record(
        dryrun.plan_collectives(model, cell, mesh, built.rules))


@pytest.mark.parametrize("arch", ["whisper-tiny", "zamba2-2.7b"])
def test_decode_on_eight_model_positions(arch):
    """A (1, 8) mesh: Whisper's 4 KV heads do not split whole over 8, so
    its cross-attention gathers q, k and v; Zamba2's Mamba-2 runs one
    state head a position.  Logits and caches within 1e-5 of the
    unsharded decode, the log equal to the plan."""
    cfg = get_smoke(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    mesh = make_local_mesh(1, 8, devices=["cpu"] * 8)
    rules = input_specs.rules_for_cell(_cell("llama"), cfg, model_axis=8)
    rng = np.random.default_rng(8)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (2, PROMPT)))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.num_frames, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 256, (2, 1)))
    with torch.no_grad():
        _, caches = model.prefill(params, batch, MAX_LEN)
        placed = device_put(params, param_placement(model, params, mesh,
                                                    rules))
        pc = device_put(caches, model.cache_shardings(caches, mesh, rules))
        want, want_caches = model.decode_step(params, caches, tokens)
        with activation_sharding(mesh, rules), \
                spmd.collective_log() as log:
            got, pc = model.decode_step(placed, pc, tokens)
    _close(device_get(got), want)
    for key, leaf in _flat(want_caches).items():
        _close(_flat(device_get(pc))[key], leaf)
    memory = cfg.num_frames if cfg.family == "audio" else 0
    plan = dryrun.plan_collectives(model, ShapeCell("t", MAX_LEN, 2,
                                                    "decode"),
                                   mesh, rules, memory=memory)
    assert _by_record(log.program((0, 0))) == _by_record(plan)
    if cfg.family == "audio":
        assert [r for r in plan if r.what == "dec_blocks.xattn.wk "
                "(column-parallel)"]


# ---------------------------------------------------------------------------
# the cell, the runtime's threads and the refusal
# ---------------------------------------------------------------------------

def test_build_cell_decode_on_a_local_mesh():
    """A decode cell on a mesh of CPU positions: params, caches and tokens
    placed, and its step runs: the logits and caches equal the unsharded
    step's of the same inputs."""
    model = Model(get_smoke("zamba2-2.7b"))
    cell = ShapeCell("smoke", MAX_LEN, 4, "decode")
    built = input_specs.build_cell(model, cell, _mesh())
    params, caches, tokens = built.args
    assert isinstance(caches["conv"], Placed) and \
        caches["conv"].spec[-1] == "model"
    logits, new = built.fn(params, caches, tokens)
    with torch.no_grad():
        want, want_caches = model.decode_step(
            device_get(params), device_get(caches), device_get(tokens))
    _close(device_get(logits), want)
    for key, leaf in _flat(want_caches).items():
        _close(device_get(_flat(new)[key]), leaf)


def test_a_failing_program_stops_every_position():
    """A program that raises after its first collective: the others stop
    at the next one and ``run`` raises the error; programs that run
    different collectives are refused."""
    model = Model(get_smoke("llama3.2-1b"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    placed = device_put(params, param_placement(
        model, params, _mesh(), _rules("llama")))
    rt = spmd.Runtime.of(placed, 4, decode=True)
    from repro_torch.models.sharding_ctx import psum

    def failing(pos):
        psum(torch.ones(2), ("model",))
        if pos == (1, 0):
            raise KeyError("injected")
        return psum(torch.ones(2), ("model",))
    with pytest.raises(KeyError, match="injected"):
        rt.run(failing)

    def uneven(pos):
        return psum(torch.ones(2), ("model",)) if pos == (0, 0) else None
    with pytest.raises(RuntimeError, match="programs differ"):
        rt.run(uneven)
    got = rt.run(lambda pos: psum(torch.full((2,), float(sum(pos))),
                                  ("data", "model")))
    assert all(torch.equal(t, torch.full((2,), 4.0)) for t in got.values())


def test_programs_run_in_the_callers_guardrail_scopes():
    """Each position's program, on a thread of its own, runs in the
    caller's sentinel and gradient-sentinel scopes and fault injector: a
    sparse product in a program is sanitized by the caller's sentinel,
    and the caller's injector fires in a program."""
    from repro_torch import api
    from repro_torch.core import guardrails
    from repro_torch.core.formats import CSR
    from repro_torch.runtime import faults

    rt = spmd.Runtime(_mesh(), _rules("llama"), 4, decode=True)
    csr = CSR(torch.tensor([0, 2, 3]), torch.tensor([0, 1, 1]),
              torch.tensor([1.0, float("nan"), 2.0]), (2, 2))
    x = torch.ones(2, 3)
    injector = faults.FaultInjector(
        {"in a program": faults.FaultSpec(fail=1)})

    def program(pos):
        y = api.sparse(csr, device="cpu", cache=False).matmul(x)
        return (guardrails.active_sentinel(),
                guardrails.active_grad_sentinel(),
                faults.active_injector(), y)
    with api.sentinel_scope("sanitize"), api.grad_scope("sanitize"), \
            api.inject_faults(injector):
        got = rt.run(program)
        with pytest.raises(faults.InjectedFault):
            rt.run(lambda pos: faults.consult("in a program"))
    assert set(got) == set(rt.positions) and len(got) == 4
    want = torch.tensor([[0.0] * 3, [2.0] * 3])
    for sentinel, grad_sentinel, inj, y in got.values():
        assert (sentinel, grad_sentinel, inj) == ("sanitize", "sanitize",
                                                  injector)
        assert torch.equal(y, want)
    assert injector.counts() == {"in a program": 1}
    outside = rt.run(program)
    assert all(v[:3] == (None, None, None) and torch.isnan(v[3][0]).all()
               for v in outside.values())


def test_lockstep_holds_under_a_short_switch_interval():
    """16 positions (more threads than this machine's cores) run 50
    collectives each with the interpreter switching threads every
    microsecond: every sum is exact, so no position read a deposit of
    another round, and the run ends within its time limit."""
    import sys
    import threading

    mesh = make_local_mesh(4, 4, devices=["cpu"] * 16)
    rt = spmd.Runtime(mesh, input_specs.rules_for_cell(_cell("llama"),
                                                       _cfg("llama")), 16,
                      decode=True)
    from repro_torch.models.sharding_ctx import all_gather, psum

    def program(pos):
        got = []
        for k in range(50):
            x = torch.full((1,), float(k * 100 + pos[0] * 4 + pos[1]))
            got.append(float(psum(x, ("model",))))
            got.append(all_gather(x, 0, ("data",)).tolist())
        return got
    box = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: box.update(out=rt.run(program)))
        t.start()
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive() and len(box["out"]) == 16
    for (d, m), got in box["out"].items():
        for k in range(50):
            assert got[2 * k] == sum(k * 100 + d * 4 + j for j in range(4))
            assert got[2 * k + 1] == [k * 100 + i * 4 + m for i in range(4)]


def test_moe_decode_and_regime_mismatches_are_refused():
    """MoE decode on placed parameters names item 7b; decode under rules
    that gather the weights, and a train step under decode's, are
    refused."""
    cfg = get_smoke("olmoe-1b-7b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rules = input_specs.rules_for_cell(next(c for c in SHAPES
                                            if c.name == "decode_32k"), cfg)
    placed = device_put(params, param_placement(model, params, _mesh(), rules))
    caches = model.init_cache(4, MAX_LEN, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7b"):
        model.decode_step(placed, caches, torch.zeros(4, 1).long())
    assert not spmd.supports(cfg)
    llama = Model(get_smoke("llama3.2-1b"))
    lp = device_put(*(lambda p: (p, param_placement(
        llama, p, _mesh(), _rules("llama"))))(
            llama.init(torch.Generator().manual_seed(0), "cpu")))
    gather = dict(_rules("llama"), __gather_weights__=True)
    with activation_sharding(_mesh(), gather), \
            pytest.raises(ValueError, match="tensor-parallel"):
        llama.decode_step(lp, llama.init_cache(4, MAX_LEN, device="cpu"),
                          torch.zeros(4, 1).long())
    tokens = torch.zeros(4, 8).long()
    with activation_sharding(_mesh(), _rules("llama")), \
            pytest.raises(ValueError, match="gather the weights"):
        llama.loss_fn(lp, {"tokens": tokens, "labels": tokens})


def test_cache_logical_specs_under_the_decode_rules():
    """``cache_shardings``: a KV cache's sequence over model (over data
    and model at long_500k), a conv cache's channels and an SSM state's
    heads over model, RWKV-6's WKV state by its rows only."""
    mesh = _mesh()
    for case, keys, spec in (
            ("llama", "kv/k", (None, "data", None, "model", None)),
            ("llama-long", "kv/k", (None, None, None, ("data", "model"),
                                    None)),
            ("zamba2", "conv", (None, None, "data", None, "model")),
            ("zamba2", "ssm", (None, None, "data", "model", None, None)),
            ("rwkv6", "wkv", (None, "data", None, None, None))):
        model, _ = _model(case)
        caches = model.init_cache(_batch_size(case), MAX_LEN, device="meta")
        sh = _flat(model.cache_shardings(caches, mesh, _rules(case)))[keys]
        got = tuple(sh.spec) + (None,) * (len(spec) - len(tuple(sh.spec)))
        assert got == spec, (case, keys)
        logical = cache_logical(tuple(keys.split("/")), len(spec))
        assert len(logical) == len(spec)


# ---------------------------------------------------------------------------
# the reference's run (last: its subprocess runs beside the tests above)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_decode_matches_the_reference_gspmd_decode(case, runs, reference):
    """The same steps against the reference's jitted GSPMD decode on 4 host
    devices under ``rules_for_cell`` of the case's cell: every step's
    logits and every cache leaf within 1e-5."""
    ref = reference()
    got_logits, got_caches, _, _ = runs[(case, True)]
    for i, got in enumerate(got_logits):
        _close(device_get(got), ref[f"{case}/logits{i}"])
    for key, leaf in _flat(got_caches).items():
        _close(leaf, ref[f"{case}/caches/{key}"])
    long = _case(case)[2] == "long_500k"
    assert ("data" in str(ref[f"{case}/logits_spec"])) != long
