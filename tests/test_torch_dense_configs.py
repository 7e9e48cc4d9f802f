"""The remaining dense configs (deepseek-67b, qwen1.5-32b with its QKV bias,
minicpm-2b), the sliding-window variant and the optimizer pieces they
bring, against the JAX package on the CPU in f32.

* the configs' numbers, specs and clipping layouts, reduced and full (the
  full parameters built on the meta device), `get_config(variant="swa")`
  and `list_archs`;
* one `serve_step` of each reduced config on both planes and the engine
  against the reference's, with a non-zero QKV bias loaded through the
  bridge (a zero bias, the init, would hide a dropped one);
* two noised steps of qwen1.5-32b reduced with the reference's draws and
  a non-zero bias, under `per_layer` and BK `ghost_flat`;
* the windowed training forward and gradient (`sliding_window = 8`, 20
  tokens) against the reference's;
* `cosine_decay`, `wsd` and `chain_clip_by_global_norm`;
* the train CLI's `--variant` and the new `--arch` values on the CPU.

Tolerances: float32, the same math summed in another order (rtol 1e-5, an
atol of 1e-5 of a leaf's largest magnitude; 1e-4 after a full step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro import optim as joptim
from repro.core import dp_sgd as JDP
from repro.core.clipping import dp_clipped_gradients as jax_clip
from repro.core.spec import _walk as jax_walk
from repro.core.spec import stable_hash as jax_stable_hash
from repro.kernels import backend as jax_backend
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.launch.inputs import synthetic_requests
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge, configs, optim
from repro_torch.core import dp_sgd
from repro_torch.core import quantile as Q
from repro_torch.core import spec as S
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.launch import serve, train
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models.transformer import build_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small torch ops: beside
    the other test workers, a thread per core makes them spin ~8x slower.
    Every comparison here is between runs under the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NEW = ["deepseek-67b", "minicpm-2b", "qwen1.5-32b"]
# the reference's parameter counts of the full configs
FULL = {"deepseek-67b": 67_425_001_472, "minicpm-2b": 3_007_703_808,
        "qwen1.5-32b": 35_197_096_960}
TIE_GAP = 1e-4


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), tree[k]


def assert_trees_close(got, want, atol_frac=1e-5, rtol=1e-5):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for name in got:
        g = got[name]
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(
            g, w, rtol=rtol,
            atol=atol_frac * max(float(np.abs(w).max()), 1e-30),
            err_msg=name)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _biased_tree(spec, seed=0):
    """A numpy parameter tree drawn from `spec` with every bias leaf (zero
    at init) replaced by a non-zero draw."""
    tree = bridge.numpy_params(spec, seed)
    rng = np.random.default_rng(seed + 1)
    for path, _ in S._walk(spec):
        if path[-1] == "b":
            node = tree
            for name in path[:-1]:
                node = node[name]
            node["b"] = (0.5 * rng.standard_normal(node["b"].shape)
                         ).astype(np.float32)
    return tree


def _batch(vocab, b, t, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, t)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    targets[:, -1] = -1
    targets[-1, t // 2:] = -1  # a ragged example
    return {"tokens": tokens, "targets": targets}


# ---------------------------------------------------------------------------
# Configs, specs, layouts.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", NEW)
def test_config_numbers_match_reference(arch, reduced):
    cfg = configs.get_config(arch, reduced=reduced)
    want = jax_configs.get_config(arch, reduced=reduced)
    for f in dataclasses.fields(cfg):
        got = getattr(cfg, f.name)
        ref = getattr(want, f.name)
        if f.name == "dtype":
            assert str(got).split(".")[-1] == np.dtype(ref).name
        else:
            assert got == ref, f.name


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", NEW)
def test_spec_and_layout_match_reference(arch, reduced):
    """Paths, shapes, inits, stack dims and clipping groups; the full
    parameters exist only on the meta device."""
    jm = jax_build_model(jax_configs.get_config(arch, reduced=reduced))
    model = build_model(configs.get_config(arch, reduced=reduced),
                        device="cpu")
    want = {"/".join(p): (v.shape, v.init, v.stack)
            for p, v in jax_walk(jm.spec)}
    got = {"/".join(p): (v.shape, v.init, v.stack)
           for p, v in S._walk(model.spec)}
    assert got == want
    assert [(g.name, g.stack_shape, g.dim, g.offset)
            for g in model.layout.groups] == \
        [(g.name, tuple(g.stack_shape), g.dim, g.offset)
         for g in jm.layout.groups]
    assert model.num_params == sum(int(np.prod(v.shape, dtype=np.int64))
                                   for _, v in jax_walk(jm.spec))
    qkv = model.spec["dense_blocks"]["attn"]["qkv"]
    assert ("b" in qkv) == (arch == "qwen1.5-32b")
    if not reduced:
        assert model.num_params == FULL[arch]
        meta = S.meta_params(model.spec)
        leaves = dict(_leaves(meta))
        assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
                   for t in leaves.values())
        assert sum(t.numel() for t in leaves.values()) == FULL[arch]


def test_variants_and_arch_list_match_reference():
    assert configs.list_archs() == configs.ARCH_IDS
    assert sorted(set(jax_configs.list_archs()) | {"tiny"}) == sorted(
        set(configs.ARCH_IDS) | set(configs.NOT_PORTED))
    for arch in configs.ARCH_IDS:
        for reduced in (False, True):
            cfg = configs.get_config(arch, reduced=reduced, variant="swa")
            want = jax_configs.get_config(arch, reduced=reduced,
                                          variant="swa")
            assert (cfg.name, cfg.sliding_window) == (
                want.name, want.sliding_window) == (
                configs.get_config(arch, reduced=reduced).name + "-swa",
                4096)
            assert configs.get_config(arch, reduced=reduced,
                                      variant="base") == \
                configs.get_config(arch, reduced=reduced)
    with pytest.raises(ValueError, match="unknown variant"):
        configs.get_config("qwen3-4b", variant="long")
    with pytest.raises(NotImplementedError, match="A.8"):
        configs.get_config("rwkv6-7b", variant="swa")


# ---------------------------------------------------------------------------
# Serving with a non-zero bias.
# ---------------------------------------------------------------------------


def _serving_pair(arch):
    jm = jax_build_model(jax_configs.get_config(arch, reduced=True))
    model = build_model(configs.get_config(arch, reduced=True), device="cpu")
    tree = _biased_tree(model.spec)
    return model, bridge.params_from_numpy(tree, "cpu"), jm, _j(tree)


@pytest.mark.parametrize("plane", ["paged", "contiguous"])
@pytest.mark.parametrize("arch", NEW)
def test_serve_step_matches_reference(arch, plane):
    model, params, jm, jp = _serving_pair(arch)
    slots, cache_len, page_len = 3, 32, 8
    rng = np.random.default_rng(5)
    if plane == "paged":
        n = slots * cache_len // page_len
        cache = jax.tree_util.tree_map(np.asarray, jm.init_paged_cache(
            slots, cache_len, num_pages=n, page_len=page_len))
        cache["pt"] = rng.permutation(n).reshape(slots, -1).astype(np.int32)
    else:
        cache = jax.tree_util.tree_map(np.asarray,
                                       jm.init_cache(slots, cache_len))
    for k in cache:
        if k not in ("pos", "pt"):
            cache[k] = rng.standard_normal(cache[k].shape).astype(np.float32)
    cache["pos"] = np.array([4, 17, 30], np.int32)
    active = np.array([True, False, True])
    token = rng.integers(0, model.cfg.vocab_size, (slots, 1)).astype(
        np.int32)
    want, wcache = jm.serve_step(jp, _j(cache), {
        "token": jnp.asarray(token), "active": jnp.asarray(active)})
    got, gcache = model.serve_step(
        params, bridge.cache_from_numpy(cache, "cpu"),
        {"token": torch.from_numpy(token),
         "active": torch.from_numpy(active)})
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active],
                               rtol=1e-4, atol=1e-4)
    for k in cache:
        np.testing.assert_allclose(gcache[k].numpy(), np.asarray(wcache[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", NEW)
def test_engine_matches_reference_engine(arch):
    """Ragged prompts, mid-flight admission, on the paged plane (`auto`),
    token for token, or a tie at the first divergence."""
    model, params, jm, jp = _serving_pair(arch)
    reqs = synthetic_requests(model.cfg.vocab_size, 4, min_len=2,
                              max_len=14, seed=3)
    kw = dict(num_slots=2, cache_len=32, prefill_chunk=4, page_len=8)
    out = []
    for eng in (JaxEngine(jm, jp, **kw), DecodeEngine(model, params, **kw)):
        assert eng.paged
        rids = [eng.submit(r, max_new_tokens=6) for r in reqs]
        done = eng.run()
        out.append([done[rid].tokens for rid in rids])
    for r, want, got in zip(reqs, *out):
        if got != want:
            i = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
            top2 = torch.topk(serve.last_logits(
                model, params, list(r) + got[:i], 8), 2).values
            assert float(top2[0] - top2[1]) < TIE_GAP, (got, want)


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------


def _reference_draws(spec, num_groups, key, step):
    """The reference step's noise: per leaf, normal(fold_in(k_noise,
    stable_hash(path))); for the counts, normal(k_q, (K,))."""
    k_noise, k_q = jax.random.split(jax.random.fold_in(key, step))
    z = {}
    for path, p in jax_walk(spec):
        name = "/".join(path)
        z[name] = np.array(jax.random.normal(
            jax.random.fold_in(k_noise, jax_stable_hash(name)), p.shape,
            jnp.float32))
    return z, np.array(jax.random.normal(k_q, (num_groups,), jnp.float32))


@pytest.mark.parametrize("mode", ["per_layer", "ghost_flat"])
def test_two_noised_steps_with_a_bias_match_reference(mode, monkeypatch):
    """qwen1.5-32b reduced, its QKV bias non-zero, two full steps (SGD with
    momentum) with the reference's noise and count-noise draws; ghost_flat
    by BK (one backward and the epilogue)."""
    arch = "qwen1.5-32b"
    jm = jax_build_model(jax_configs.get_config(arch, reduced=True))
    m = build_model(configs.get_config(arch, reduced=True), device="cpu")
    tree = _biased_tree(m.spec)
    kw = dict(mode=mode, sigma=0.7, sampling_rate=0.05, steps=10,
              init_threshold=0.5, noise_strategy="weighted")
    j_init, j_step, j_plan = JDP.make_dp_train_step(
        jm.loss_fn, jm.spec, jm.layout, joptim.sgd(0.05, momentum=0.9),
        JDP.DPConfig(backend="xla", **kw), batch_size=4)
    p_init, p_step, p_plan = dp_sgd.make_dp_train_step(
        m.loss_fn, m.spec, m.layout, optim.sgd(0.05, momentum=0.9),
        dp_sgd.DPConfig(backend="kernels", execution="bk", **kw),
        batch_size=4)
    assert (p_plan.sigma, p_plan.sigma_b, p_plan.sigma_new) == (
        j_plan.sigma, j_plan.sigma_b, j_plan.sigma_new)
    key = jax.random.PRNGKey(7)
    cur = {}
    monkeypatch.setattr(dp_sgd, "standard_normal",
                        lambda path, shape, rows, gen: torch.from_numpy(
                            cur["z"][path][rows]))
    monkeypatch.setattr(Q, "count_noise", lambda shape, gen:
                        torch.from_numpy(cur["zq"]))
    jp, (jo, jd) = _j(tree), j_init(_j(tree))
    pp = bridge.train_params_from_numpy(tree, "cpu")
    po, pd = p_init(pp)
    step = jax.jit(j_step)
    for s in range(2):
        cur["z"], cur["zq"] = _reference_draws(
            jm.spec, max(j_plan.num_noise_groups, 1), key, s)
        batch = _batch(m.cfg.vocab_size, 4, 12, seed=10 + s)
        jp, jo, jd, jmet = step(jp, jo, jd, _j(batch), key)
        pp, po, pd, pmet = p_step(pp, po, pd, _t(batch), 0)
        np.testing.assert_allclose([float(x) for x in pmet],
                                   [float(x) for x in jmet], rtol=1e-5)
    np.testing.assert_allclose(pd.qstate.thresholds.numpy(),
                               np.asarray(jd.qstate.thresholds), rtol=1e-5)
    assert_trees_close(pp, jp, atol_frac=1e-4)
    assert_trees_close(po.momentum, jo.momentum, atol_frac=1e-4)
    moved = pp["dense_blocks"]["attn"]["qkv"]["b"].detach().numpy()
    assert not np.allclose(moved, tree["dense_blocks"]["attn"]["qkv"]["b"])


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen1.5-32b"])
def test_windowed_training_matches_reference(arch):
    """sliding_window = 8 in both packages, 20 tokens: the per_layer
    clipped gradients (loss, (K, B) norms², every leaf) of the windowed
    forward and backward; the window changes the loss."""
    jcfg = dataclasses.replace(jax_configs.get_config(arch, reduced=True),
                               sliding_window=8)
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                              sliding_window=8)
    jm, m = jax_build_model(jcfg), build_model(cfg, device="cpu")
    tree = _biased_tree(m.spec)
    batch = _batch(cfg.vocab_size, 3, 20, seed=1)
    thr = np.random.default_rng(2).uniform(
        0.05, 2.0, m.layout.num_groups).astype(np.float32)
    with jax_backend.scoped("xla"):
        want = jax.jit(lambda p, b, c: jax_clip(
            jm.loss_fn, p, b, jm.layout, mode="per_layer", batch_size=3,
            thresholds=c))(_j(tree), _j(batch), jnp.asarray(thr))
    params = bridge.train_params_from_numpy(tree, "cpu")
    got = dp_clipped_gradients(m.loss_fn, params, _t(batch), m.layout,
                               mode="per_layer", batch_size=3,
                               thresholds=torch.from_numpy(thr))
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(),
                               np.asarray(want.norms_sq), rtol=1e-5,
                               atol=1e-9)
    assert_trees_close(got.grads, want.grads)
    full = build_model(configs.get_config(arch, reduced=True), device="cpu")
    th = m.layout.pack_value(float("inf"), 3)
    with torch.no_grad():
        assert not torch.allclose(m.loss_fn(params, _t(batch), th),
                                  full.loss_fn(params, _t(batch), th))


# ---------------------------------------------------------------------------
# Optimizer pieces.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("cosine_decay", (0.1, 20, 4)), ("cosine_decay", (0.01, 7, 0, 0.2)),
    ("wsd", (0.1, 20, 4)), ("wsd", (3e-2, 37, 3, 0.2, 0.05)),
    ("linear_decay", (0.1, 20, 4, 0.1))])
def test_schedules_match_reference(name, args):
    """f32 in both; the decay's exp may differ from XLA's in the last
    place."""
    got_f, want_f = getattr(optim, name)(*args), getattr(joptim, name)(*args)
    for step in range(0, args[1] + 6):
        got, want = got_f(step), np.float32(want_f(jnp.int32(step)))
        assert isinstance(got, np.float32)
        np.testing.assert_allclose(got, want, rtol=3e-7, err_msg=str(step))


def test_wsd_shape():
    f = optim.wsd(1.0, 100, 10, decay_fraction=0.1, end_fraction=0.01)
    assert f(0) == np.float32(0.1) and f(9) == f(50) == f(90) == 1.0
    assert 0.01 < f(95) < 1.0
    np.testing.assert_allclose(f(100), 0.01, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e6], ids=["clips", "passes"])
@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_chain_clip_by_global_norm_matches_reference(name, max_norm):
    rng = np.random.default_rng(12)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
    kw = {"momentum": 0.9} if name == "sgd" else {}
    j_opt = joptim.chain_clip_by_global_norm(
        getattr(joptim, name)(0.01, **kw), max_norm)
    p_opt = optim.chain_clip_by_global_norm(
        getattr(optim, name)(0.01, **kw), max_norm)
    jp, js = _j(params), j_opt.init(_j(params))
    pp = {"a": torch.from_numpy(params["a"].copy()),
          "b": {"c": torch.from_numpy(params["b"]["c"].copy())}}
    ps = p_opt.init(pp)
    for _ in range(3):
        grads = {"a": rng.standard_normal((5, 3)).astype(np.float32),
                 "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
        tg = {"a": torch.from_numpy(grads["a"].copy()),
              "b": {"c": torch.from_numpy(grads["b"]["c"].copy())}}
        upd, js = j_opt.update(_j(grads), js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        ps = p_opt.update(tg, ps, pp)
        assert np.array_equal(tg["a"].numpy(), grads["a"])  # not scaled
    assert_trees_close(pp, jp, atol_frac=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# The CLIs.
# ---------------------------------------------------------------------------


def test_train_cli_variant_on_cpu(capsys):
    assert train.main(["--arch", "qwen1.5-32b", "--reduced", "--variant",
                       "swa", "--steps", "2", "--batch", "4", "--seq", "16",
                       "--docs", "16", "--log-every", "1",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=qwen1.5-32b-reduced-swa" in out
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-67b"])
def test_new_archs_train_and_serve_on_cpu(arch, capsys):
    assert train.main(["--arch", arch, "--reduced", "--steps", "1",
                       "--batch", "4", "--seq", "16", "--docs", "16",
                       "--device", "cpu"]) == 0
    assert serve.main(["--arch", arch, "--reduced", "--batch", "3",
                       "--prompt-len", "8", "--gen", "4", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out and "paged=yes" in out
