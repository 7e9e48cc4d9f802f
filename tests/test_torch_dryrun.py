"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's, piece by piece, on the CPU: the reference's own dry run forces
512 host devices at import (`XLA_FLAGS`), so no test here imports
`repro.launch.dryrun`; its constants are read from its source with `ast`.

* `INPUT_SHAPES` field for field; `train_batch_specs` /
  `serve_batch_specs` in keys, shapes and dtypes for every arch at
  train_4k and decode_32k;
* `abstract_params` leaf for leaf and `abstract_cache` at a small batch
  for every arch, against the reference's `abstract_params` and
  `jax.eval_shape` (nothing allocated on either side);
* the placements (`params_shardings` with and without `serving`,
  `batch_shardings`, `cache_shardings`, `opt_state_shardings`) against
  the reference's on a device-free `AbstractMesh` of both production
  shapes, and `_spec_for` at `tests/test_launch.py`'s cases;
* the traced step's optimizer and DP state shapes against the
  reference's `jax.eval_shape(init_fn, ...)` (tiny, per_layer and
  ghost_flat by BK);
* `backward_passes`: 1 under per_layer, non_private and bk, 2 under
  twopass, at 1 and 2 microbatches, held to the reference's HLO count on
  tiny at 4 layers (two reference compiles);
* the traced tiny step's flops equal FlopCounterMode's over the same
  step on real CPU tensors, and its peak and bytes equal the meter's on
  them; the kernel launches predicted from the engine's op calls;
* a debug 2x2 rank's collective log against the placements' arithmetic;
* `run_one` on qwen3-4b train_4k and rwkv6-7b decode_32k at the debug
  mesh (the reference's failing subprocess test's pair), `long_500k`
  skipped, DP-LoRA's rank 32 outside debug only, and the CLI.
"""
import ast
import dataclasses
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.core.dp_sgd import DPConfig as JaxDPConfig
from repro.core.dp_sgd import make_dp_train_step as jax_make_step
from repro.core.spec import abstract_params as jax_abstract_params
from repro.launch import inputs as JI
from repro.launch import sharding as JS
from repro.models.config import INPUT_SHAPES as JAX_SHAPES
from repro.models.transformer import build_model as jax_build_model
from repro_torch import optim
from repro_torch.analysis import graph
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core.spec import P, abstract_params, tree_leaves
from repro_torch.kernels import backend
from repro_torch.launch import dryrun
from repro_torch.launch import inputs as I
from repro_torch.launch import sharding as S
from repro_torch.models.config import InputShape
from repro_torch.models.transformer import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_DRYRUN = ROOT / "src" / "repro" / "launch" / "dryrun.py"
PROD = {"data": 16, "model": 16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the traced steps are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_constant(name):
    tree = ast.parse(REF_DRYRUN.read_text(encoding="utf-8"))
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _flat_torch(tree, prefix=()):
    return {"/".join(p): (tuple(t.shape), _dt(t))
            for p, t in tree_leaves(tree, prefix)}


def _flat_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
    return out


def _norm_spec(spec) -> tuple:
    """A placement's entries as tuples of axis names (None unsplit), the
    trailing unsplit dims dropped: the reference's PartitionSpec and the
    port's tuple compare equal when they split alike."""
    out = [None if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


# ---------------------------------------------------------------------------
# Shapes, inputs, abstract trees.
# ---------------------------------------------------------------------------


def test_input_shapes_and_constants_match_the_reference():
    assert list(INPUT_SHAPES) == list(JAX_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            JAX_SHAPES[name])
    assert isinstance(INPUT_SHAPES["train_4k"], InputShape)
    assert dryrun.LORA_TRAIN_ARCHS == _ref_constant("LORA_TRAIN_ARCHS")
    assert dryrun.LONG_OK == _ref_constant("LONG_OK")
    assert dryrun.COLLECTIVES == _ref_constant("COLLECTIVES")
    for kind in ("train", "decode"):
        name = next(n for n, s in INPUT_SHAPES.items() if s.kind == kind)
        got = dryrun._shape_for(name, True)
        assert (got.seq_len, got.global_batch, got.kind) == (
            64 if kind == "train" else 128, 8, kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape in ("train_4k", "decode_32k"):
        want = _flat_jax(JI.train_batch_specs(jcfg, JAX_SHAPES[shape]))
        got = _flat_torch(I.train_batch_specs(cfg, INPUT_SHAPES[shape]))
        assert got == want
        want = _flat_jax(JI.serve_batch_specs(jcfg, JAX_SHAPES[shape]))
        got = _flat_torch(I.serve_batch_specs(cfg, INPUT_SHAPES[shape]))
        assert got == want
    got = I.train_batch_specs(cfg, INPUT_SHAPES["train_4k"])
    assert all(t.device.type == "meta" for t in got.values())
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        I.sds((2, 2), torch.int32, "cpu")  # would allocate


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_cache_match_the_reference(arch):
    model = build_model(get_config(arch), device="cpu")
    jmodel = jax_build_model(jax_get_config(arch))
    got = abstract_params(model.spec)
    assert all(t.device.type == "meta" for _, t in tree_leaves(got))
    assert _flat_torch(got) == _flat_jax(jax_abstract_params(jmodel.spec))
    cache = model.abstract_cache(3, 40)
    assert all(t.device.type == "meta" for t in cache.values())
    assert _flat_torch(cache) == _flat_jax(jmodel.abstract_cache(3, 40))


# ---------------------------------------------------------------------------
# Placements.
# ---------------------------------------------------------------------------


def test_spec_for_matches_the_reference_cases():
    cases = [("dense_blocks/attn/qkv/w", (36, 2560, 6144), 1),
             ("dense_blocks/attn/o/w", (36, 4096, 2560), 1),
             ("moe_blocks/moe/w_gu", (61, 256, 7168, 4096), 2),
             ("moe_blocks/moe/w_gu", (32, 40, 1536, 1024), 2),
             ("dense_blocks/attn/qkv/w", (2, 30, 30), 1),
             ("final_norm/s", (2560,), 0)]
    for path, shape, stack in cases:
        got = S._spec_for(path, P(shape, stack=stack), 16)
        want = JS._spec_for(path, P(shape, stack=stack), 16)
        assert _norm_spec(got) == _norm_spec(want), path


def _ref_mesh(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v3-671b",
                                  "granite-moe-3b-a800m", "whisper-medium"])
def test_placements_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model = build_model(cfg, device="cpu")
    jmodel = jax_build_model(jcfg)
    for shape in (PROD, {"pod": 2, **PROD}):
        jm = _ref_mesh(shape)
        with dryrun.fake_mesh(shape, "meta") as mesh:
            for serving in (False, True):
                got = S.params_shardings(model.spec, mesh, serving=serving)
                want = JS.params_shardings(jmodel.spec, jm, serving=serving)
                got = {k: _norm_spec(v.spec) for k, v in _flat_pl(got)}
                want = {k: _norm_spec(v.spec)
                        for k, v in _flat_ns(want).items()}
                assert got == want, serving
            for name in ("train_4k", "decode_32k"):
                batch = I.train_batch_specs(cfg, INPUT_SHAPES[name])
                jbatch = JI.train_batch_specs(jcfg, JAX_SHAPES[name])
                assert _specs(S.batch_shardings(batch, mesh)) == \
                    _jspecs(JS.batch_shardings(jbatch, jm))
            for b, t in ((128, 64), (1, 512)):  # batch or sequence split
                got = S.cache_shardings(model.abstract_cache(b, t), mesh)
                want = JS.cache_shardings(jmodel.abstract_cache(b, t), jm)
                assert _specs(got) == _jspecs(want)
            # Adam's moments placed as their weights, the step replicated
            opt = optim.adam(1e-4).init(abstract_params(model.spec))
            jopt = jax.eval_shape(joptim.adam(1e-4).init,
                                  jax_abstract_params(jmodel.spec))
            got = S.opt_state_shardings(
                opt, S.params_shardings(model.spec, mesh), mesh)
            want = JS.opt_state_shardings(
                jopt, JS.params_shardings(jmodel.spec, jm), jm)
            assert got._fields == want._fields
            assert _norm_spec(got.step.spec) == _norm_spec(want.step.spec)
            for f in ("mu", "nu"):
                assert _specs(getattr(got, f)) == _jspecs(getattr(want, f))


def _flat_pl(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat_pl(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _flat_ns(tree):
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _specs(tree):
    return {k: _norm_spec(v.spec) for k, v in _flat_pl(tree)}


def _jspecs(tree):
    return {k: _norm_spec(v.spec) for k, v in _flat_ns(tree).items()}


def test_placed_bytes_are_the_pieces_a_rank_holds():
    with dryrun.fake_mesh(PROD, "meta") as mesh:
        t = torch.empty((36, 2560, 6144), dtype=torch.bfloat16,
                        device="meta")
        pl = S.Placement(mesh, (None, ("data",), "model"))
        assert pl.local_shape(t.shape) == (36, 160, 384)
        assert S.placed_bytes({"w": t}, {"w": pl}) == 36 * 160 * 384 * 2
        assert S.placed_bytes((t, 3), (S.Placement(mesh, ()), None)) == \
            t.numel() * 2
        with pytest.raises(ValueError, match="model-axis"):
            pl.shard(t)


# ---------------------------------------------------------------------------
# The traced step.
# ---------------------------------------------------------------------------


def _tiny(num_layers=4):
    return dataclasses.replace(get_config("tiny"), num_layers=num_layers)


TINY_SHAPE = InputShape("tiny", 16, 4, "train")


def _trace(mode, execution="bk", microbatches=1, mesh_shape=None,
           cfg=None, shape=TINY_SHAPE):
    """Trace one step of `cfg` (tiny at 4 layers) on a meta mesh; returns
    (result of dryrun.analyze, trace, model)."""
    cfg = cfg or _tiny()
    with dryrun.fake_mesh(mesh_shape or {"data": 1, "model": 1},
                          "meta") as mesh, backend.scoped("plain"), \
            dryrun.shape_only_draws():
        trace, model, _ = dryrun.build_train_trace(
            "tiny", "train_4k", mesh, clipping=mode, execution=execution,
            microbatches=microbatches, cfg=cfg, shape=shape)
        found = dryrun.analyze(trace, kind="train", trip=cfg.num_layers,
                               sharded=True, device="cpu")
    return found, trace, model


def test_traced_states_match_the_reference_eval_shape():
    cfg, jcfg = _tiny(), dataclasses.replace(jax_get_config("tiny"),
                                             num_layers=4)
    jmodel = jax_build_model(jcfg)
    for mode in ("per_layer", "ghost_flat"):
        _, trace, _ = _trace(mode)
        opt, dp = trace.args[1], trace.args[2]
        dpc = JaxDPConfig(mode=mode, sigma=1.0, sampling_rate=1e-3,
                          steps=1000, adaptive=True, execution="bk",
                          backend="xla")
        init_fn, _, _ = jax_make_step(jmodel.loss_fn, jmodel.spec,
                                      jmodel.layout, joptim.adam(1e-4), dpc,
                                      batch_size=TINY_SHAPE.global_batch)
        jopt, jdp = jax.eval_shape(init_fn, jax_abstract_params(jmodel.spec))
        for got, want in ((opt, jopt), (dp, jdp)):
            assert type(got).__name__ == type(want).__name__
            assert got._fields == want._fields
            for f in got._fields:
                g, w = getattr(got, f), getattr(want, f)
                if isinstance(g, torch.Tensor):
                    assert (tuple(g.shape), _dt(g)) == (
                        tuple(w.shape), jnp.dtype(w.dtype).name), f
                elif isinstance(g, dict):
                    assert _flat_torch(g) == _flat_jax(w), f
                elif isinstance(g, tuple):  # the quantile state
                    for h, v in zip(g, w):
                        assert (tuple(getattr(h, "shape", ())) ==
                                tuple(v.shape)), f
                else:  # a Python scalar where the reference has a 0-d one
                    assert w.shape == (), f


def _reference_backward_passes():
    from repro.analysis.hlo import backward_passes
    from repro.launch.inputs import concrete_train_batch
    jcfg = dataclasses.replace(jax_get_config("tiny"), num_layers=4)
    m = jax_build_model(jcfg)
    params = jax_abstract_params(m.spec)
    b, t = TINY_SHAPE.global_batch, TINY_SHAPE.seq_len
    batch = jax.eval_shape(lambda k: concrete_train_batch(jcfg, b, t, k),
                           jax.ShapeDtypeStruct((2,), jnp.uint32))
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    out = {}
    for execution in ("bk", "twopass"):
        dpc = JaxDPConfig(mode="ghost_flat", sigma=1.0, sampling_rate=0.1,
                          steps=10, execution=execution, backend="xla")
        init_fn, step_fn, _ = jax_make_step(
            m.loss_fn, m.spec, m.layout, joptim.adam(1e-3), dpc,
            batch_size=b)
        opt_abs, dp_abs = jax.eval_shape(init_fn, params)
        hlo = jax.jit(step_fn).lower(params, opt_abs, dp_abs, batch,
                                     key).compile().as_text()
        out[execution] = backward_passes(hlo, 4)
    return out


def test_backward_passes_are_counted_as_the_reference_counts_them():
    ref = _reference_backward_passes()
    assert ref == {"bk": 1, "twopass": 2}
    cases = [("per_layer", "bk", 1), ("non_private", "bk", 1),
             ("ghost_flat", "bk", ref["bk"]),
             ("per_group", "bk", ref["bk"]),
             ("ghost_flat", "twopass", ref["twopass"]),
             ("per_group", "twopass", ref["twopass"])]
    for mode, execution, want in cases:
        for mb in (1, 2):
            found, _, _ = _trace(mode, execution, microbatches=mb)
            assert found["backward_passes"] == want, (mode, execution, mb)
            assert found["loss_calls"] == want * mb


def test_traced_flops_peak_and_launches_match_a_real_cpu_step():
    """The same tiny step on real CPU tensors: FlopCounterMode's flops,
    the meter's peak and bytes; the launches the op calls predict."""
    found, trace, model = _trace("per_layer", microbatches=2)
    with dryrun.fake_mesh({"data": 1, "model": 1}, "cpu") as mesh, \
            backend.scoped("plain"):
        cfg = _tiny()
        model, init_fn, step_fn = dryrun.build_train_step(
            cfg, mesh, clipping="per_layer", microbatches=2,
            batch_size=TINY_SHAPE.global_batch)
        gen = torch.Generator().manual_seed(0)
        params = model.init_train_params(gen)
        for _, leaf in tree_leaves(params):
            leaf.requires_grad_()
        opt, dp = init_fn(params)
        batch = I.concrete_train_batch(cfg, TINY_SHAPE.global_batch,
                                       TINY_SHAPE.seq_len, gen)
        flops = torch.utils.flop_counter.FlopCounterMode(display=False)
        with flops:
            step_fn(params, opt, dp, batch, 1)
        assert found["flops"] == flops.get_total_flops() > 0
        params = model.init_train_params(gen)
        for _, leaf in tree_leaves(params):
            leaf.requires_grad_()
        opt, dp = init_fn(params)
        real, _ = graph.analyze_step(step_fn, params, opt, dp, batch, 1,
                                     mesh=mesh)
    # on the CPU the step's (K,) int64 group assignment aliases its numpy
    # array (`torch.as_tensor`), where the meta trace (and a card) copies it
    assign = 8 * model.layout.num_groups
    assert real.peak_bytes + assign == found["memory"]["peak_bytes"] > \
        found["memory"]["argument_bytes"]
    assert 0 <= found["bytes_accessed"] - real.bytes <= 4 * assign
    assert real.op_calls == found["op_calls"]
    # tiny's linears are within the fused route's rule: 2 microbatches x
    # (4 linears x 4 layers + the head)
    assert found["kernel_launches"]["fused_norm_clip"] == 2 * 17
    assert found["kernel_launches"]["ghost_norm"] == 0
    bk, _, _ = _trace("ghost_flat", "bk")
    assert bk["kernel_launches"]["scale_contract"] == \
        bk["op_calls"]["scale_contract"] > 0
    assert graph.kernel_launches({"linear_clip": 5, "linear_clip[fits]": 2,
                                  "linear_clip[no_norms]": 1,
                                  "clipped_sum_linear": 4}) == {
        "ghost_norm": 2, "ghost_norm_blocked": 0, "clip_reduce": 7,
        "fused_norm_clip": 2, "scale_contract": 0, "paged_attn": 0}


def test_debug_rank_collectives_are_the_placements_arithmetic():
    mb = 2
    found, trace, model = _trace("per_layer", microbatches=mb,
                                 mesh_shape={"data": 2, "model": 2},
                                 cfg=get_config("tiny"))
    rows = {(r["kind"], r["axes"], r["site"]): r
            for r in graph.classify_collectives(trace.mesh)}
    params, pshard = trace.accounted[0], trace.placements[0]
    sharded = [(t, pl) for (_, t), (_, pl) in zip(
        tree_leaves(params), _flat_pl(pshard)) if pl.dim is not None]
    gather = rows[("all-gather", ("model",), "weight_gather")]
    assert gather["count"] == len(sharded) > 0
    assert gather["bytes"] == sum(t.numel() * 4 for t, _ in sharded)
    grads = rows[("all-reduce", ("data",), "grad_psum")]
    leaves = [t for _, t in tree_leaves(params)]
    assert grads["count"] == mb * len(leaves)
    assert grads["bytes"] == mb * 4 * model.num_params
    counts = rows[("all-reduce", ("data",), "clip_count_psum")]
    assert counts["bytes"] == mb * 4 * model.layout.num_groups
    assert rows[("all-reduce", ("data",), "loss_psum")]["count"] == mb
    assert found["collectives"]["total_bytes"] == sum(
        r["bytes"] for r in rows.values())
    assert found["collectives_by_axis"]["model_axis_norm_count"] == 0
    argument = (S.placed_bytes(params, pshard) + S.placed_bytes(
        trace.accounted[1], trace.placements[1])
        + S.placed_bytes(trace.accounted[2], trace.placements[2])
        + S.placed_bytes(trace.accounted[3], trace.placements[3]))
    assert found["memory"]["argument_bytes"] == argument


# ---------------------------------------------------------------------------
# run_one and the CLI.
# ---------------------------------------------------------------------------


def test_run_one_debug_pair_of_the_reference_subprocess_test():
    for arch, shape in (("qwen3-4b", "train_4k"), ("rwkv6-7b", "decode_32k")):
        r = dryrun.run_one(arch, shape, "debug", debug=True, save=False,
                           device="cpu")
        assert r["status"] == "ok", r.get("traceback")
        assert r["flops"] > 0 and r["memory"]["peak_bytes"] > 0
        assert r["compile_s"] is None and r["trace_s"] >= 0
        assert not dist.is_initialized()
    assert r["kind"] == "decode" and r["memory"]["alias_bytes"] > 0


def test_run_one_skips_long_context_and_sizes_lora_outside_debug():
    r = dryrun.run_one("qwen1.5-32b", "long_500k", "single", save=False,
                       device="cpu")
    assert r["status"] == "skipped"
    assert "sub-quadratic" in r["reason"]
    with dryrun.fake_mesh({"data": 1, "model": 1}, "meta") as mesh:
        for debug, rank in ((False, 32), (True, 0)):
            cfg, mode = dryrun.train_config("qwen2-vl-72b", "train_4k", mesh,
                                            clipping="per_shard",
                                            debug=debug)
            assert (cfg.lora_rank, mode, cfg.dp_blocks) == (rank,
                                                            "per_layer", 1)
        cfg, _ = dryrun.train_config("qwen3-4b", "long_500k", mesh,
                                     clipping="per_layer")
        assert cfg.sliding_window == 4096


def test_cli_writes_results_and_refuses_a_missing_card(tmp_path):
    out = tmp_path / "dr"
    code = dryrun.main(["--arch", "tiny", "--shape", "train_4k", "--mesh",
                        "debug", "--device", "cpu", "--out", str(out),
                        "--sharded"])
    assert code == 0
    (path,) = out.glob("*.json")
    assert path.name == "tiny__train_4k__debug__sharded.json"
    r = json.loads(path.read_text())
    assert r["status"] == "ok" and r["backward_passes"] == 1
    assert r["collectives_by_axis"]["by_axis"]["data"]["count"] > 0
    if not torch.cuda.is_available():
        assert dryrun.build_parser().parse_args([]).device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.main(["--arch", "tiny", "--shape", "train_4k"])
    assert not dist.is_initialized()
