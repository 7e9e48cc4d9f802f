"""Sharded execution (`launch.mesh`, `core.clipping.
sharded_clipped_gradients`, the BK epilogue's all-reduces) on gloo ranks
on the CPU, held against the reference's SINGLE-DEVICE drivers run in
this process on the same numpy-seeded parameters (through `bridge`) and
batches: sharded == single-device, the reference's own contract
(`tests/sharded_checks.py:84-152`).

Each spawn (`launch.mesh.spawn`, workers in `torch_mesh_workers`) runs
many cases on its ranks; the tests below read its results:

* the mesh: coordinates, the data index, the axis groups' members;
* placements: `params_shardings` against the reference's `_spec_for`
  leaf by leaf, and a shard / all-gather round trip;
* clip parity on 2x2 and 1x2 meshes (tiny) and 2x2 (qwen3-4b reduced):
  grads (rank 0's, and every rank's bitwise equal), every rank's norms²
  against its columns, counts and the loss, for non_private, per_layer,
  ghost_flat and per_group by bk and by twopass;
* the paper's Sec. 4 contract from the collective log: per_group has no
  model-axis collective before its factors, ghost_flat exactly one (B_local,)
  f32 `flat_norm_psum`, the BK epilogue one `grad_psum` per leaf, issued
  asynchronously and waited after the next leaf's contraction;
* the quantile update with `counts_axes`: bitwise the single-device
  tracker's (in the port) and the reference's at rtol 1e-6;
* the refusals, with the reference's messages.

Tolerances: the reference's sharded checks', rtol 2e-4 / atol 2e-6 on the
grads against the port's single-device driver and rtol 1e-4 / atol 1e-7
on the norms², in f32; against the reference's grads the atol also takes
test_torch_train's cross-framework term, 1e-5 of the leaf's largest
magnitude (XLA and torch sum in other orders: an embedding row that
cancels to ~1e-3 of its terms misses 2e-6 by ~1e-6 in either package).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import quantile as JQ
from repro.core.clipping import dp_clipped_gradients as jax_clip
from repro.kernels import backend as jax_backend
from repro.launch.sharding import _spec_for as jax_spec_for
from repro.launch.sharding import group_shard_assignment as jax_assignment
import torch

from repro_torch import bridge
from repro_torch.core.spec import _walk
from repro_torch.launch import mesh as mesh_lib
import torch_mesh_workers as workers
from test_torch_train import _batch, _j, _models

B, T = 8, 12
RTOL, ATOL = 2e-4, 2e-6
XLA_ATOL_FRAC = 1e-5  # of the leaf's largest magnitude, torch vs XLA
NORM_RTOL, NORM_ATOL = 1e-4, 1e-7
CASES = [("non_private", "bk"), ("per_layer", "bk"), ("ghost_flat", "bk"),
         ("ghost_flat", "twopass"), ("per_group", "bk"),
         ("per_group", "twopass")]
MESHES = {"tiny_2x2": ("tiny", False, 2, 2),
          "tiny_1x2": ("tiny", False, 1, 2),
          "qwen_2x2": ("qwen3-4b", True, 2, 2)}
# qwen3-4b reduced runs the three paths of the smoke run's phase 16
QWEN_CASES = ("per_layer_bk", "ghost_flat_bk", "per_group_bk")


def _ref_clip(jm, tree, batch, mode, execution, **kw):
    kw = {k: jnp.asarray(v) for k, v in kw.items()}
    with jax_backend.scoped("xla"):
        return jax.jit(functools.partial(
            jax_clip, jm.loss_fn, layout=jm.layout, mode=mode,
            batch_size=B, execution=execution))(_j(tree), _j(batch), **kw)


def _expected_counts(mode, norms, kw, assign, m):
    if mode == "per_layer":
        th = kw["thresholds"]
        return np.sum(norms <= th[:, None] ** 2, axis=1).astype(np.float32)
    if mode == "ghost_flat":
        c = kw["flat_threshold"]
        return np.array([np.sum(norms.sum(0) <= c * c)], np.float32)
    sup = np.zeros((m, norms.shape[1]), np.float64)
    np.add.at(sup, np.asarray(assign), norms)
    gth = kw["group_thresholds"]
    return np.sum(sup <= gth[:, None] ** 2, axis=1).astype(np.float32)


def _reference(arch, reduced, m):
    """The cases, their reference results (the reference's single-device
    driver) and the port's single-device results, for a model axis of m
    (the cases do not depend on the data axis)."""
    model, jm = _models(arch, reduced)
    tree = bridge.numpy_params(model.spec, seed=0)
    batch = _batch(model.cfg.vocab_size, b=B, t=T, seed=30)
    assign = jax_assignment(jm.layout, m)
    # thresholds that clip some examples and not others: from the norms
    probe = _ref_clip(jm, tree, batch, "ghost_flat", "twopass",
                      flat_threshold=np.float32(1.0))
    norms = np.asarray(probe.norms_sq)
    rng = np.random.default_rng(4)
    k = jm.layout.num_groups
    th = np.sqrt(np.median(norms, axis=1) * rng.uniform(0.5, 2.0, k)
                 ).astype(np.float32)
    c = np.float32(np.sqrt(np.median(norms.sum(0))))
    sup = np.zeros((m, B))
    np.add.at(sup, np.asarray(assign), norms)
    gth = np.sqrt(np.median(sup, axis=1)).astype(np.float32)
    gth[gth == 0] = 1.0  # a shard that owns nothing
    kws = {"non_private": {}, "per_layer": {"thresholds": th},
           "ghost_flat": {"flat_threshold": c},
           "per_group": {"group_thresholds": gth}}
    cases = {f"{mode}_{ex}": (mode, ex, kws[mode]) for mode, ex in CASES
             if arch == "tiny" or f"{mode}_{ex}" in QWEN_CASES}
    want = {}
    for name, (mode, ex, kw) in cases.items():
        rkw = dict(kw)
        if mode == "per_group":
            rkw["group_assignment"] = np.asarray(assign, np.int32)
        # one reference run a mode: its bk and twopass agree to f32
        ref = (want[f"{mode}_bk"]["ref"] if ex == "twopass" else
               _ref_clip(jm, tree, batch, mode, ex, **rkw))
        want[name] = {"ref": ref,
                      "grads": jax.tree_util.tree_map(np.asarray, ref.grads),
                      "norms": np.asarray(ref.norms_sq),
                      "loss": float(ref.loss),
                      "counts": (None if mode == "non_private" else
                                 _expected_counts(mode, np.asarray(
                                     ref.norms_sq), kw, assign, m))}
    return model, tree, batch, cases, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs, cache = {}, {}

    def get(key):
        if key not in cache:
            arch, reduced, d, m = MESHES[key]
            if (arch, m) not in refs:
                refs[arch, m] = _reference(arch, reduced, m)
            model, tree, batch, cases, want = refs[arch, m]
            got = workers.spawn(
                "clip_cases", d * m,
                store_dir=str(tmp_path_factory.mktemp(key)), timeout_s=240,
                args=(arch, reduced, tree, batch, {"data": d, "model": m},
                      cases))
            cache[key] = {"got": got, "want": want, "spec": model.spec,
                          "d": d, "m": m,
                          "leaves": len(list(_walk(model.spec)))}
        return cache[key]

    return get


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), tree[k]


@pytest.mark.parametrize("key,case", [
    (key, f"{m}_{e}") for key in MESHES for m, e in CASES
    if not key.startswith("qwen") or f"{m}_{e}" in QWEN_CASES])
def test_sharded_clip_matches_single_device_reference(runs, key, case):
    r = runs(key)
    got, want = r["got"], r["want"][case]
    b_local = B // r["d"]
    rank0 = got[0][case]
    ref_grads = dict(_flat(want["grads"]))
    single = rank0["single_device"]
    assert set(rank0["grads"]) == set(ref_grads) == set(single)
    for name, g in rank0["grads"].items():
        # sharded == single-device (the port's), the reference's contract
        np.testing.assert_allclose(g, single[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        # and the reference's single-device driver, with the cross-
        # framework term of test_torch_train (f32 sums in another order)
        w = np.asarray(ref_grads[name], np.float32)
        np.testing.assert_allclose(
            g, w, rtol=RTOL,
            atol=max(ATOL, XLA_ATOL_FRAC * float(np.abs(w).max())),
            err_msg=name)
    for rank, res in enumerate(got):
        mine = res[case]
        for name, g in mine["grads"].items():  # replicated: bitwise
            np.testing.assert_array_equal(g, rank0["grads"][name],
                                          err_msg=f"rank {rank} {name}")
        lo = res["data_index"] * b_local
        np.testing.assert_allclose(mine["norms"],
                                   want["norms"][:, lo: lo + b_local],
                                   rtol=NORM_RTOL, atol=NORM_ATOL)
        np.testing.assert_allclose(mine["loss"], want["loss"], rtol=1e-6)
        if want["counts"] is not None:
            np.testing.assert_array_equal(mine["counts"], want["counts"])


def _by_site(entry, site):
    return [c for c in entry["log"] if c[0] == site]


def _before_factors(entry):
    """Log indices of the collectives issued before the factors."""
    trace = entry["trace"]
    stop = trace.index("factors")
    return [int(e.split("#")[1]) for e in trace[:stop]
            if e.startswith("issue ")]


@pytest.mark.parametrize("key", ["tiny_2x2", "tiny_1x2"])
@pytest.mark.parametrize("execution", ["bk", "twopass"])
def test_per_group_moves_no_norm_over_the_model_axis(runs, key, execution):
    for res in runs(key)["got"]:
        e = res[f"per_group_{execution}"]
        before = [e["log"][i] for i in _before_factors(e)]
        assert not [c for c in before if "model" in c[1]], before
        assert not _by_site(e, "flat_norm_psum")
        # the counts go into the shard's slot over every axis, after
        counts = _by_site(e, "clip_count_psum")
        assert len(counts) == 1 and counts[0][1] == ("data", "model")
        if execution == "twopass":
            (gather,) = _by_site(e, "factor_gather_psum")
            assert gather[1] == ("model",)


@pytest.mark.parametrize("key", ["tiny_2x2", "tiny_1x2"])
@pytest.mark.parametrize("execution", ["bk", "twopass"])
def test_ghost_flat_pays_exactly_one_norm_all_reduce(runs, key, execution):
    r = runs(key)
    for res in r["got"]:
        e = res[f"ghost_flat_{execution}"]
        flat = _by_site(e, "flat_norm_psum")
        assert flat == [("flat_norm_psum", ("model",), "float32",
                         B // r["d"])]
        before = [e["log"][i] for i in _before_factors(e)]
        assert [c[0] for c in before] == ["flat_norm_psum"]


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("mode", ["ghost_flat", "per_group"])
def test_bk_epilogue_all_reduces_each_leaf_after_the_next_contraction(
        runs, key, mode):
    r = runs(key)
    for res in r["got"]:
        e = res[f"{mode}_bk"]
        grad = [i for i, c in enumerate(e["log"]) if c[0] == "grad_psum"]
        assert len(grad) == r["leaves"]
        assert all(e["log"][i][1] == ("data", "model") for i in grad)
        trace = e["trace"]
        contracts = [i for i, ev in enumerate(trace)
                     if ev.startswith("contract ")]
        assert len(contracts) == r["leaves"]
        for n, i in enumerate(grad):
            issue = trace.index(f"issue grad_psum#{i}")
            wait = trace.index(f"wait grad_psum#{i}")
            assert contracts[n] < issue  # issued once contracted ...
            if n + 1 < len(grad):  # ... waited after the next contraction
                assert issue < contracts[n + 1] < wait
    # twopass and per_layer reduce over the data plane only
    for res in r["got"]:
        for case in ("per_layer_bk", f"{mode}_twopass", "non_private_bk"):
            if case not in res:  # qwen3-4b reduced: phase 16's paths
                continue
            g = _by_site(res[case], "grad_psum")
            assert len(g) == r["leaves"]
            assert all(c[1] == ("data",) for c in g)


def test_mesh_coordinates_and_groups(runs):
    got = runs("tiny_2x2")["got"]
    for rank, res in enumerate(got):
        assert res["coords"] == {"data": rank // 2, "model": rank % 2}
        assert res["data_index"] == rank // 2
        g = res["groups"]
        assert g["model"] == [rank - rank % 2, rank - rank % 2 + 1]
        assert g["data"] == [rank % 2, rank % 2 + 2]
        assert g["data,model"] == [0, 1, 2, 3]
    g1 = runs("tiny_1x2")["got"][1]["groups"]
    assert g1["data"] == [1] and g1["model"] == [0, 1]


@pytest.mark.parametrize("key", ["tiny_2x2", "qwen_2x2"])
def test_placements_follow_the_reference_rules_and_round_trip(runs, key):
    r = runs(key)
    for path, p in _walk(r["spec"]):
        name = "/".join(path)
        want = tuple(jax_spec_for(name, p, r["m"]))
        got = r["got"][0]["placements"][name]
        assert tuple(got[:len(want)]) == want and not any(got[len(want):]), (
            name, got, want)
    sharded = sum("model" in pl for pl in r["got"][0]["placements"].values())
    assert sharded > 0
    for res in r["got"]:
        assert res["round_trip"]
        assert res["replicated"] == [()] * len(res["placements"])
        log = res["gather_log"]["log"]
        assert len(log) == sharded
        assert all(c[0] == "weight_gather" and c[1] == ("model",)
                   for c in log)


def test_quantile_counts_axes_match_the_single_device_tracker(tmp_path):
    """Shard-local counts all-reduced over the data plane by
    `update_thresholds(counts_axes=)`: bitwise the port's single-device
    update on every rank, and the reference's within rtol 1e-6."""
    from repro_torch.core import quantile as Q
    k = 5
    rng = np.random.default_rng(3)
    norms = (rng.uniform(size=(k, B)) * 0.8).astype(np.float32)
    init = np.linspace(0.2, 1.0, k).astype(np.float32)
    key = jax.random.PRNGKey(7)
    zq = np.asarray(jax.random.normal(key, (k,), jnp.float32))
    got = workers.spawn("quantile_update", 4, store_dir=str(tmp_path),
                        timeout_s=120, args=(norms, init, B,
                                             {"data": 2, "model": 2}, zq,
                                             3.0))
    state = Q.init_quantile_state(init, sigma_b=3.0)
    real = Q.count_noise
    Q.count_noise = lambda shape, gen: torch.from_numpy(zq.copy())
    try:
        single = Q.update_thresholds(state, Q.clip_counts(
            torch.from_numpy(norms), state.thresholds), B, None).thresholds
    finally:
        Q.count_noise = real
    jstate = JQ.init_quantile_state(init, sigma_b=3.0)
    ref = JQ.update_thresholds(jstate, JQ.clip_counts(
        jnp.asarray(norms), jstate.thresholds), B, key).thresholds
    for res in got:
        np.testing.assert_array_equal(res["thresholds"], single.numpy())
        np.testing.assert_allclose(res["thresholds"], np.asarray(ref),
                                   rtol=1e-6)
        assert [c[:2] for c in res["log"]] == [("clip_count_psum",
                                                ("data",))]


REFUSALS = {
    "foreign_assignment": "sharded per_group IS per-device clipping: "
                          "group_assignment must equal the model-axis shard "
                          "ownership",
    "naive_flat": "sharded execution supports non_private/per_layer/"
                  "ghost_flat/per_group, not 'naive_flat' (naive_flat is a "
                  "single-device oracle)",
    "naive_flat_driver": "not 'naive_flat' (naive_flat is a single-device "
                         "oracle)",
    "microbatches": "per-shard batch must divide by microbatches",
    "data_plane": "global batch 7 must divide across the 2-way data plane",
    "per_layer_thresholds": "per_layer mode needs thresholds (K,)",
    "shard_assignment": "sharded flat/group modes need shard_assignment",
    "group_thresholds": "per_group mode needs group_thresholds (M,)",
    "production_mesh": "a data=16xmodel=16 mesh needs 256 ranks, the "
                       "process group has 4",
}


@pytest.fixture(scope="module")
def refused(tmp_path_factory):
    return workers.spawn("refusals", 4,
                         store_dir=str(tmp_path_factory.mktemp("refuse")),
                         timeout_s=120, args=("tiny",
                                              {"data": 2, "model": 2}))


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_sharded_refusals_name_the_reference_reason(refused, name):
    for res in refused:
        assert res[name] is not None and REFUSALS[name] in res[name], (
            res[name])


def test_spawn_fails_on_a_rank_error_and_on_a_hang(tmp_path):
    with pytest.raises(RuntimeError, match="AttributeError"):
        mesh_lib.spawn("repro_torch.launch.mesh:resolve", 2,
                       store_dir=str(tmp_path / "a"), timeout_s=60,
                       args=("repro_torch.launch.mesh:NOPE",))
    with pytest.raises(TimeoutError):
        mesh_lib.spawn("time:sleep", 2, store_dir=str(tmp_path / "b"),
                       timeout_s=3, args=(60,))


def test_rank_device_refuses_nccl_past_the_cards(monkeypatch):
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        mesh_lib.rank_device("cpu", "nccl", 0, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.rank_device("cuda", "gloo", 0, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        mesh_lib.rank_device("cuda", "nccl", 0, 4)
    assert mesh_lib.rank_device("cuda", "gloo", 3, 4) == torch.device(
        "cuda", 0)
    assert mesh_lib.parse_mesh("2x4") == {"data": 2, "model": 4}
    with pytest.raises(ValueError, match="DxM"):
        mesh_lib.parse_mesh("4")
