"""DP-LoRA under sharded execution (`sharded_clipped_gradients(
trainable_key="lora")`, the BK epilogue over the `{"lora": ...}` spec, the
sharded step's adapters-only update) on gloo ranks on the CPU, held
against the reference's SINGLE-device LoRA driver (its sharded engine
runs only as multi-device subprocesses), as `test_torch_sharded.py`
holds the full fine-tune. One module-scoped spawn of a 2x2 mesh
(`torch_mesh_workers.lora_mesh`) runs every case:

* clip parity, qwen3-4b-reduced with rank-4 adapters on qkv and o:
  per_layer, ghost_flat by BK, per_group by BK and by twopass; and
  deepseek-v3-reduced per_layer (MLA's kv_b and o adapters, MTP): rank
  0's summed adapter grads against the reference's `dp_clipped_gradients
  (trainable_key="lora")` and the port's single-device LoRA driver (on
  the MoE config, summed over the data shards' batches, whose examples
  its capacity dispatch couples, as phase 16's oracle runs them),
  every rank's grads bitwise equal, every rank's norms² against its
  columns, the counts and the loss;
* the collective log: every `grad_psum` is an adapter leaf's (no base
  leaf crosses the wire), per_group has no model-axis collective before
  its factors, ghost_flat exactly one (B_local,) f32 `flat_norm_psum`,
  the BK epilogue's all-reduces waited after the next leaf's
  contraction;
* two noised steps (per_group by BK: per-device clipping), the noise
  drawn alike on every rank: the adapters move, every rank ends with the
  same bits, the base is bitwise as it was, and the parameters are
  those of the single-device step with the same draws;
* the adapter groups' ownership and placements against the reference's
  `group_shard_assignment` and `_spec_for` (the stacked rule, layer l to
  shard l * M / L; `lora/*/b` column-parallel, `lora/*/a` replicated).

Tolerances: test_torch_sharded's (rtol 2e-4 / atol 2e-6 on the grads
against the port's single-device driver, with the cross-framework term
1e-5 of a leaf's largest magnitude against the reference; rtol 1e-4 /
atol 1e-7 on the norms²); the steps test_torch_sharded_train's (rtol
1e-5, atol 1e-4 of a leaf's largest magnitude).
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.clipping import dp_clipped_gradients as jax_clip
from repro.kernels import backend as jax_backend
from repro.launch.sharding import _spec_for as jax_spec_for
from repro.launch.sharding import group_shard_assignment as jax_assignment

from repro_torch import bridge
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.core.spec import _walk
from repro_torch.launch.sharding import (group_shard_assignment,
                                         params_shardings)
import torch_mesh_workers as workers
from test_torch_lora import _lora_models, _tree
from test_torch_train import _batch, _j, _t

B, T, D, M, RANK = 8, 12, 2, 2, 4
RTOL, ATOL = 2e-4, 2e-6
XLA_ATOL_FRAC = 1e-5
NORM_RTOL, NORM_ATOL = 1e-4, 1e-7
ARCHS = {"qwen": ("qwen3-4b", True), "deepseek": ("deepseek-v3-671b", True)}
CASES = {"qwen": [("per_layer", "bk"), ("ghost_flat", "bk"),
                  ("per_group", "bk"), ("per_group", "twopass")],
         "deepseek": [("per_layer", "bk")]}
PARITY = [(arch, f"{mode}_{ex}") for arch, cases in CASES.items()
          for mode, ex in cases]
STEP = dict(mode="per_group", sigma=0.7, sampling_rate=0.05, steps=10,
            init_threshold=2.0)


def _thresholds(model, tree, batch):
    """Thresholds that clip some examples and not others, from the port's
    single-device norms² (ghost_flat by twopass)."""
    norms = dp_clipped_gradients(
        model.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
        _t(batch), model.layout, mode="ghost_flat", execution="twopass",
        batch_size=B, trainable_key="lora").norms_sq.numpy()
    rng = np.random.default_rng(4)
    th = np.sqrt(np.median(norms, axis=1) * rng.uniform(
        0.5, 2.0, norms.shape[0])).astype(np.float32)
    assign = group_shard_assignment(model.layout, M)
    sup = np.zeros((M, B))
    np.add.at(sup, np.asarray(assign), norms)
    return {"per_layer": {"thresholds": th},
            "ghost_flat": {"flat_threshold": np.float32(
                np.sqrt(np.median(norms.sum(0))))},
            "per_group": {"group_thresholds": np.sqrt(np.median(
                sup, axis=1)).astype(np.float32)}}, assign


def _reference(jm, tree, batch, mode, assign, kw, by_shard):
    """The reference's single-device LoRA driver on the batch, or with
    `by_shard` on each data shard's batch (an MoE's capacity couples the
    examples a forward dispatches): grads summed, norms² side by side,
    the mean loss."""
    kw = {k: jnp.asarray(v) for k, v in kw.items()}
    if mode == "per_group":
        kw["group_assignment"] = jnp.asarray(assign, jnp.int32)
    b = B // D if by_shard else B
    with jax_backend.scoped("xla"):
        fn = jax.jit(functools.partial(
            jax_clip, jm.loss_fn, layout=jm.layout, mode=mode,
            batch_size=b, trainable_key="lora"))
        parts = [fn(_j(tree), _j({k: v[lo: lo + b] for k, v in
                                  batch.items()}), **kw)
                 for lo in range(0, B, b)]
    grads = {}
    for part in parts:
        for name, g in _flat(jax.tree_util.tree_map(np.asarray,
                                                    part.grads)):
            grads[name] = grads.get(name, 0) + g
    return {"grads": grads,
            "norms": np.concatenate([np.asarray(p.norms_sq) for p in parts],
                                    axis=1),
            "loss": float(np.mean([float(p.loss) for p in parts]))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    clips, want, meta = [], {}, {}
    for name, (arch, reduced) in ARCHS.items():
        model, jm = _lora_models(arch, reduced, RANK)
        tree = _tree(model)
        batch = _batch(model.cfg.vocab_size, b=B, t=T, seed=30)
        kws, assign = _thresholds(model, tree, batch)
        cases = {f"{mode}_{ex}": (mode, ex, kws[mode])
                 for mode, ex in CASES[name]}
        clips.append((name, arch, reduced, RANK, tree, batch, cases))
        refs = {mode: _reference(jm, tree, batch, mode, assign, kws[mode],
                                 bool(model.cfg.num_experts))
                for mode in {m for m, _ in CASES[name]}}
        for case, (mode, _, kw) in cases.items():
            want[name, case] = refs[mode]
        meta[name] = {"lora_leaves": sorted(
            "/".join(p) for p, _ in _walk(model.dp_spec)), "tree": tree,
            "vocab": model.cfg.vocab_size}
    qwen = clips[0]
    # the single-device step's supergroups: the mesh's shard ownership
    single = dict(STEP, num_supergroups=M, group_assignment=list(
        group_shard_assignment(_lora_models(*ARCHS["qwen"], RANK)[0].layout,
                               M)))
    step = dict(arch=qwen[1], reduced=qwen[2], lora_rank=RANK, tree=qwen[4],
                batches=[_batch(meta["qwen"]["vocab"], b=B, t=T,
                                seed=40 + s) for s in range(2)],
                dp_kw=STEP, batch_size=B)
    got = workers.spawn("lora_mesh", D * M,
                        store_dir=str(tmp_path_factory.mktemp("lora_mesh")),
                        timeout_s=240, args=(clips, step, single,
                                             {"data": D, "model": M}))
    return {"got": got, "want": want, "meta": meta}


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), tree[k]


@pytest.mark.parametrize("arch,case", PARITY)
def test_sharded_lora_clip_matches_single_device_reference(run, arch, case):
    got, want = run["got"], run["want"][arch, case]
    rank0 = got[0][arch][case]
    single = rank0["single_device"]
    assert set(rank0["grads"]) == set(want["grads"]) == set(single) == set(
        run["meta"][arch]["lora_leaves"])
    for name, g in rank0["grads"].items():
        np.testing.assert_allclose(g, single[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        w = np.asarray(want["grads"][name], np.float32)
        np.testing.assert_allclose(
            g, w, rtol=RTOL,
            atol=max(ATOL, XLA_ATOL_FRAC * float(np.abs(w).max())),
            err_msg=name)
        assert np.abs(g).max() > 0, name  # b != 0: dA moves too
    b_local = B // D
    for rank, res in enumerate(got):
        mine = res[arch][case]
        for name, g in mine["grads"].items():
            np.testing.assert_array_equal(g, rank0["grads"][name],
                                          err_msg=f"rank {rank} {name}")
        lo = (rank // M) * b_local
        np.testing.assert_allclose(mine["norms"],
                                   want["norms"][:, lo: lo + b_local],
                                   rtol=NORM_RTOL, atol=NORM_ATOL)
        np.testing.assert_allclose(mine["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_array_equal(mine["counts"], rank0["counts"])
    assert 0 < rank0["counts"].sum() < rank0["counts"].size * B


def _reduced_leaves(entry):
    """The leaf each `grad_psum` all-reduces: the `reduce <path>` or
    `contract <path>` mark just before its issue."""
    trace, out = entry["trace"], []
    for i, ev in enumerate(trace):
        if ev.startswith("issue grad_psum#"):
            mark = trace[i - 1]
            assert mark.startswith(("reduce ", "contract ")), mark
            out.append(mark.split(" ", 1)[1])
    return out


@pytest.mark.parametrize("arch,case", PARITY)
def test_sharded_lora_moves_adapter_grads_only(run, arch, case):
    """No base leaf crosses the wire, and the paper's Sec. 4 contract
    holds over the adapters as over the whole model."""
    mode, execution = case.rsplit("_", 1)
    leaves = run["meta"][arch]["lora_leaves"]
    for res in run["got"]:
        e = res[arch][case]
        grad = [c for c in e["log"] if c[0] == "grad_psum"]
        assert sorted(_reduced_leaves(e)) == leaves
        assert len(grad) == len(leaves)
        factors = e["trace"].index("factors") if mode != "per_layer" else 0
        before = [e["log"][int(ev.split("#")[1])]
                  for ev in e["trace"][:factors] if ev.startswith("issue ")]
        if mode == "per_group":
            assert not [c for c in before if "model" in c[1]], before
        if mode == "ghost_flat":
            assert before == [("flat_norm_psum", ("model",), "float32",
                               B // D)]
        if execution == "bk" and mode != "per_layer":
            trace = e["trace"]
            contracts = [i for i, ev in enumerate(trace)
                         if ev.startswith("contract ")]
            idx = [i for i, c in enumerate(e["log"]) if c[0] == "grad_psum"]
            assert len(contracts) == len(idx) == len(leaves)
            for n, i in enumerate(idx):
                issue = trace.index(f"issue grad_psum#{i}")
                wait = trace.index(f"wait grad_psum#{i}")
                assert contracts[n] < issue
                if n + 1 < len(idx):
                    assert issue < contracts[n + 1] < wait
            assert all(c[1] == ("data", "model") for c in grad)
        else:
            assert all(c[1] == ("data",) for c in grad)


def test_sharded_lora_step_trains_the_adapters_alone(run):
    tree = run["meta"]["qwen"]["tree"]
    got = run["got"]
    mesh0, single = got[0]["step"], got[0]["step_single"]
    for rank, res in enumerate(got):
        for name, v in res["step"]["params"].items():
            np.testing.assert_array_equal(
                v, mesh0["params"][name], err_msg=f"rank {rank} {name}")
        np.testing.assert_array_equal(res["step"]["thresholds"],
                                      mesh0["thresholds"])
    base = dict(_flat({k: v for k, v in tree.items() if k != "lora"}))
    lora = dict(_flat({"lora": tree["lora"]}))
    for name, v in mesh0["params"].items():
        if name in base:  # the base: bit for bit as it was
            np.testing.assert_array_equal(v, base[name], err_msg=name)
        else:
            assert not np.array_equal(v, lora[name]), name
        w = single["params"][name]
        np.testing.assert_allclose(
            v, w, rtol=1e-5, atol=1e-4 * max(float(np.abs(w).max()), 1e-30),
            err_msg=name)
    assert set(mesh0["params"]) == set(base) | set(lora)
    np.testing.assert_allclose(np.asarray(mesh0["metrics"]),
                               np.asarray(single["metrics"]), rtol=1e-5)
    # the counts all-reduced over the mesh, and no base leaf in any log
    for log in mesh0["logs"]:
        assert sorted(_reduced_leaves(log)) == sorted(lora)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("m", [2, 4])
def test_lora_groups_and_placements_follow_the_reference(arch, m):
    model, jm = _lora_models(*ARCHS[arch], RANK)
    assert group_shard_assignment(model.layout, m) == tuple(
        jax_assignment(jm.layout, m))
    placements = params_shardings(model.spec, SimpleNamespace(
        shape={"model": m}))
    for path, p in _walk(model.spec["lora"], ("lora",)):
        pl = placements
        for k in path:
            pl = pl[k]
        want = tuple(jax_spec_for("/".join(path), p, m))
        assert pl.spec[:len(want)] == want and not any(pl.spec[len(want):])
        if path[-1] == "b" and p.shape[-1] % m == 0:
            assert pl.dim == len(p.shape) - 1  # column-parallel
        if path[-1] == "a":
            assert pl.dim is None  # replicated
