"""The port's training slice against the JAX package, on the CPU in f32.

Parameters cross through the numpy bridge; the same numpy-seeded batches
go through both packages:

* `dp_clipped_gradients` (`per_layer` and `non_private`): loss, (K, B)
  norms² and every clipped gradient leaf, on tiny and qwen3-4b-reduced
  (the flat and group modes: `test_torch_bk.py`);
* two full `make_dp_train_step` steps (SGD with momentum) of every ported
  mode with the reference's noise and count-noise draws substituted for
  the port's, and Adam / AdamW as optimizer units on identical inputs;
* the port's own draws by their distribution; the quantile update, the
  noise allocation, the schedules;
* the accounting copy to 1e-12 and the data pipeline bit for bit;
* remat on/off, the kernel call counts of one step (4 per block + the
  head, `fused_norm_clip` for each under per_layer, since every linear of
  the reduced config is within the fused route's rule, or `ghost_norm`
  and `clip_reduce` on the composed route; 5 `scale_contract` calls and
  no `clip_reduce` under BK; 2 per block `ghost_norm_blocked` under
  per_shard), `non_private` calling no norm op, and the `--device cpu`
  CLI (per_shard too; its noised steps: `test_torch_blocked.py`).

Tolerances: float32, the same math summed in another order: rtol 1e-5
and an atol of 1e-5 of the leaf's largest magnitude (1e-4 after a full
step, where the update of one step feeds the next).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.core import accounting as JACC
from repro.core import dp_sgd as JDP
from repro.core import noise as JNOISE
from repro.core import quantile as JQ
from repro.core.clipping import dp_clipped_gradients as jax_clip
from repro.core.spec import _walk as jax_walk
from repro.core.spec import stable_hash as jax_stable_hash
from repro.data import pipeline as JPIPE
from repro.kernels import backend as jax_backend
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge, optim
from repro_torch.configs import get_config
from repro_torch.core import accounting as ACC
from repro_torch.core import dp_sgd, ghost
from repro_torch.core import noise as NOISE
from repro_torch.core import quantile as Q
from repro_torch.core.spec import _walk
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.data import pipeline as PIPE
from repro_torch.kernels import bk as SC
from repro_torch.kernels import clip_reduce as CR
from repro_torch.kernels import fused_clip as FC
from repro_torch.kernels import ghost_norm as GN
from repro_torch.launch import train
from repro_torch.models.transformer import build_model

B, T_LEN = 3, 12


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
            g, w, rtol=rtol, atol=atol_frac * max(float(np.abs(w).max()), 1e-30),
            err_msg=name)


def _batch(vocab, b=B, t=T_LEN, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, t)).astype(np.int32)
    tokens[0, 3] = tokens[0, 7]  # an embedding collision
    targets = np.roll(tokens, -1, 1)
    targets[:, -1] = -1
    targets[-1, 5:] = -1  # a ragged example
    return {"tokens": tokens, "targets": targets}


def _models(arch, reduced=False):
    cfg = get_config(arch, reduced=reduced)
    return (build_model(cfg, device="cpu"),
            jax_build_model(jax_get_config(arch, reduced=reduced)))


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("mode", ["per_layer", "non_private"])
@pytest.mark.parametrize("arch,reduced", [("tiny", False), ("qwen3-4b", True)])
def test_clipped_gradients_match_reference(arch, reduced, mode):
    m, jm = _models(arch, reduced)
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    thr = np.random.default_rng(2).uniform(
        0.05, 2.0, m.layout.num_groups).astype(np.float32)
    kw = dict(mode=mode, batch_size=B)
    if mode == "per_layer":
        kw["thresholds"] = thr
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(jax_clip, jm.loss_fn,
                                         layout=jm.layout, **{
            k: v for k, v in kw.items() if k != "thresholds"}))(
            _j(tree), _j(batch), **({"thresholds": jnp.asarray(thr)}
                                    if mode == "per_layer" else {}))
    if mode == "per_layer":
        kw["thresholds"] = torch.from_numpy(thr)
    params = bridge.train_params_from_numpy(tree, "cpu")
    got = dp_clipped_gradients(m.loss_fn, params, _t(batch), m.layout, **kw)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(), np.asarray(want.norms_sq),
                               rtol=1e-5, atol=1e-9)
    assert_trees_close(got.grads, want.grads)
    if mode == "per_layer":  # some groups clipped, some not
        n = got.norms_sq.numpy()
        assert (n > thr[:, None] ** 2).any() and (n < thr[:, None] ** 2).any()


def test_remat_changes_nothing_and_norms_arrive_once():
    """Activation checkpointing recomputes each block's forward in
    backward; the threshold gradient (the norms²) must not double."""
    import dataclasses
    cfg = get_config("qwen3-4b", reduced=True)
    out = {}
    for remat in (True, False):
        m = build_model(dataclasses.replace(cfg, remat=remat), device="cpu")
        params = bridge.train_params_from_numpy(
            bridge.numpy_params(m.spec, seed=0), "cpu")
        out[remat] = dp_clipped_gradients(
            m.loss_fn, params, _t(_batch(cfg.vocab_size)), m.layout,
            mode="per_layer", batch_size=B,
            thresholds=torch.full((m.layout.num_groups,), 0.5))
    torch.testing.assert_close(out[True].norms_sq, out[False].norms_sq,
                               rtol=1e-6, atol=0)
    for (name, a), (_, b) in zip(_leaves(out[True].grads),
                                 _leaves(out[False].grads)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)


def _count_calls(monkeypatch, scale_contract=False):
    calls = {"ghost_norm": 0, "clip_reduce": 0, "fused_norm_clip": 0}
    if scale_contract:
        calls["scale_contract"] = 0

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(GN, "ghost_norm", counting("ghost_norm",
                                                   GN.ghost_norm))
    monkeypatch.setattr(CR, "clip_reduce", counting("clip_reduce",
                                                    CR.clip_reduce))
    monkeypatch.setattr(FC, "fused_norm_clip", counting(
        "fused_norm_clip", FC.fused_norm_clip))
    if scale_contract:
        monkeypatch.setattr(SC, "scale_contract", counting(
            "scale_contract", SC.scale_contract))
    return calls


@pytest.mark.parametrize("mode", ["per_layer", "non_private"])
def test_kernel_calls_per_step_and_non_private_skips_norms(mode,
                                                           monkeypatch):
    """One step clips each linear (4 per block + the head) once: under
    per_layer by fused_norm_clip, since every linear of the reduced config
    is within the fused route's rule (on qwen3-4b none is: ghost_norm and
    clip_reduce, 145 each); non_private calls clip_reduce alone and runs
    no norm op at all (its factor is 1 whatever the norm)."""
    calls = _count_calls(monkeypatch)
    if mode == "non_private":
        def boom(*a, **k):
            raise AssertionError("non_private ran a norm op")
        for name in ("linear_norms_sq", "embed_norms_sq", "scale_norms_sq",
                     "bias_norms_sq"):
            monkeypatch.setattr(ghost, name, boom)
    args = train.build_train_parser().parse_args(
        ["--arch", "qwen3-4b", "--reduced", "--clipping", mode, "--steps",
         "2", "--batch", "2", "--seq", "8", "--docs", "4", "--device",
         "cpu"])
    trainer = train.Trainer(args)
    met = trainer.step()
    linears = 4 * trainer.cfg.num_layers + 1
    fused = mode == "per_layer"
    assert calls == {"ghost_norm": 0, "clip_reduce": 0 if fused else linears,
                     "fused_norm_clip": linears if fused else 0}
    assert np.isfinite(float(met.loss)) and np.isfinite(float(met.grad_norm))


def test_kernel_calls_per_step_on_the_composed_route(monkeypatch):
    """Where the fit rule fails, per_layer composes ghost_norm and then
    clip_reduce at every linear, as on qwen3-4b at full width (the rule
    is patched off here, since every reduced linear passes it)."""
    calls = _count_calls(monkeypatch)
    monkeypatch.setattr(FC, "fits", lambda din, dout: False)
    args = train.build_train_parser().parse_args(
        ["--arch", "qwen3-4b", "--reduced", "--steps", "2", "--batch", "2",
         "--seq", "8", "--docs", "4", "--device", "cpu"])
    trainer = train.Trainer(args)
    met = trainer.step()
    linears = 4 * trainer.cfg.num_layers + 1
    assert calls == {"ghost_norm": linears, "clip_reduce": linears,
                     "fused_norm_clip": 0}
    assert np.isfinite(float(met.loss)) and np.isfinite(float(met.grad_norm))


@pytest.mark.parametrize("mode,execution", [
    ("ghost_flat", "bk"), ("per_group", "bk"), ("ghost_flat", "twopass"),
    ("per_group_twopass", "bk")])
def test_kernel_calls_per_step_under_bk_and_twopass(mode, execution,
                                                    monkeypatch):
    """BK: one ghost_norm per linear, no clip_reduce, one scale_contract
    per linear leaf (the 4 stacked block linears and the head); twopass:
    one ghost_norm and one clip_reduce per linear, no scale_contract."""
    calls = _count_calls(monkeypatch, scale_contract=True)
    args = train.build_train_parser().parse_args(
        ["--arch", "qwen3-4b", "--reduced", "--clipping", mode,
         "--execution", execution, "--steps", "2", "--batch", "2", "--seq",
         "8", "--docs", "4", "--device", "cpu"])
    trainer = train.Trainer(args)
    met = trainer.step()
    linears = 4 * trainer.cfg.num_layers + 1
    bk = trainer.execution == "bk"
    assert calls == {"ghost_norm": linears,
                     "clip_reduce": 0 if bk else linears,
                     "scale_contract": 5 if bk else 0, "fused_norm_clip": 0}
    assert np.isfinite(float(met.loss)) and np.isfinite(float(met.grad_norm))


# ---------------------------------------------------------------------------
# Full steps with the reference's draws substituted.
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


@pytest.mark.parametrize("mode,rescale", [("per_layer", None),
                                          ("per_layer", 2.0),
                                          ("non_private", None),
                                          ("ghost_flat", None),
                                          ("per_group", None),
                                          ("per_group", 2.0)])
def test_two_train_steps_match_reference_with_its_draws(mode, rescale,
                                                        monkeypatch):
    """rescale: the Appendix A.1 global threshold rescale. per_group's
    supergroups: what 2 virtual model shards own."""
    from repro_torch.launch.sharding import group_shard_assignment
    m, jm = _models("tiny")
    tree = bridge.numpy_params(m.spec, seed=0)
    kw = dict(mode=mode, sigma=0.7, sampling_rate=0.05, steps=10,
              init_threshold=0.5, noise_strategy="weighted",
              threshold_rescale=rescale)
    if mode == "per_group":
        kw.update(group_assignment=group_shard_assignment(m.layout, 2),
                  num_supergroups=2)
    j_init, j_step, j_plan = JDP.make_dp_train_step(
        jm.loss_fn, jm.spec, jm.layout, joptim.sgd(0.05, momentum=0.9),
        JDP.DPConfig(backend="xla", **kw), batch_size=4)
    p_init, p_step, p_plan = dp_sgd.make_dp_train_step(
        m.loss_fn, m.spec, m.layout, optim.sgd(0.05, momentum=0.9),
        dp_sgd.DPConfig(backend="kernels", **kw), batch_size=4)
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
        batch = _batch(m.cfg.vocab_size, b=4, seed=10 + s)
        jp, jo, jd, jmet = step(jp, jo, jd, _j(batch), key)
        pp, po, pd, pmet = p_step(pp, po, pd, _t(batch), 0)
        np.testing.assert_allclose([float(x) for x in pmet],
                                   [float(x) for x in jmet], rtol=1e-5)
    assert pd.step == 2
    np.testing.assert_allclose(pd.qstate.thresholds.numpy(),
                               np.asarray(jd.qstate.thresholds), rtol=1e-5)
    assert_trees_close(pp, jp, atol_frac=1e-4)
    assert_trees_close(po.momentum, jo.momentum, atol_frac=1e-4)


@pytest.mark.parametrize("name,kw", [
    ("adam", {}), ("adam", {"weight_decay": 0.1}),
    ("adamw", {"weight_decay": 0.1}),
    ("sgd", {"momentum": 0.9, "nesterov": True, "weight_decay": 0.1})])
def test_optimizers_match_reference_on_identical_inputs(name, kw):
    rng = np.random.default_rng(11)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
    sched_args = (0.01, 6, 2)
    j_opt = getattr(joptim, name)(joptim.linear_decay(*sched_args), **kw)
    p_opt = getattr(optim, name)(optim.linear_decay(*sched_args), **kw)
    jp, js = _j(params), j_opt.init(_j(params))
    pp = {"a": torch.from_numpy(params["a"].copy()),
          "b": {"c": torch.from_numpy(params["b"]["c"].copy())}}
    ps = p_opt.init(pp)
    for _ in range(3):
        grads = {"a": rng.standard_normal((5, 3)).astype(np.float32),
                 "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
        upd, js = j_opt.update(_j(grads), js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        ps = p_opt.update({"a": torch.from_numpy(grads["a"]),
                           "b": {"c": torch.from_numpy(grads["b"]["c"])}},
                          ps, pp)
    assert ps.step == 3
    assert_trees_close(pp, jp, atol_frac=1e-6, rtol=1e-6)
    if name == "sgd":
        assert_trees_close(ps.momentum, js.momentum, atol_frac=1e-6,
                           rtol=1e-6)
    else:
        assert_trees_close(ps.mu, js.mu, atol_frac=1e-6, rtol=1e-6)
        assert_trees_close(ps.nu, js.nu, atol_frac=1e-6, rtol=1e-6)


def test_optimizer_slices_large_leaves(monkeypatch):
    """Updating in slices along the first axis changes no result."""
    from repro_torch.optim import optimizers
    p0 = torch.randn(9, 4, generator=torch.Generator().manual_seed(0))
    g = torch.randn(9, 4, generator=torch.Generator().manual_seed(1))
    out = []
    for limit in (1 << 26, 8):
        monkeypatch.setattr(optimizers, "_SLICE_ELEMS", limit)
        opt = optim.adam(1e-2)
        p = {"w": p0.clone()}
        st = opt.update({"w": g}, opt.init(p), p)
        out.append((p["w"], st.mu["w"], st.nu["w"]))
        assert len(optimizers.slices(p["w"])) == (1 if limit > 36 else 5)
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_schedules_match_reference():
    for step in (0, 1, 3, 9, 20):
        assert optim.linear_decay(0.1, 20, 4, 0.1)(step) == np.float32(
            joptim.linear_decay(0.1, 20, 4, 0.1)(jnp.int32(step)))
        assert optim.constant(0.3)(step) == np.float32(
            joptim.constant(0.3)(step))


# ---------------------------------------------------------------------------
# Noise, quantiles, accounting, data.
# ---------------------------------------------------------------------------


def test_port_noise_draws_by_their_distribution():
    """Zero grads plus noise: each group's draws have its std (a 5-sigma
    band on the sample std), are deterministic per (seed, step) and
    differ between steps and between leaves."""
    m = build_model(get_config("tiny"), device="cpu")
    lay = m.layout
    stds = torch.linspace(0.5, 2.0, lay.num_groups)

    def noise(seed, step):
        grads = {}
        for path, p in _walk(m.spec):
            node = grads
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.zeros(p.shape)
        return dp_sgd.add_noise_to_grads(m.spec, lay, grads, stds, seed,
                                         step)

    z = noise(3, 0)
    w = z["dense_blocks"]["mlp"]["gate_up"]["w"]  # (2, 64, 256) stacked
    grp = lay.group("dense_blocks/mlp/gate_up")
    for layer in range(2):
        x = w[layer].flatten()
        want = float(stds[grp.offset + layer])
        band = 5 * want / np.sqrt(2 * x.numel())
        assert abs(float(x.std()) - want) < band
        assert abs(float(x.mean())) < 5 * want / np.sqrt(x.numel())
    again = noise(3, 0)
    for (_, a), (_, b) in zip(_leaves(z), _leaves(again)):
        assert torch.equal(a, b)
    other = noise(3, 1)["dense_blocks"]["mlp"]["gate_up"]["w"]
    assert not torch.equal(w, other)
    q = z["dense_blocks"]["attn"]["qkv"]["w"][0, :, :64].flatten()
    corr = np.corrcoef(q.numpy(), w[0, :, :64].flatten()[: q.numel()])[0, 1]
    assert abs(corr) < 0.05


def test_noise_allocation_and_collision_check_match_reference():
    rng = np.random.default_rng(12)
    thr = rng.uniform(0.1, 3.0, 7).astype(np.float32)
    dims = rng.integers(10, 5000, 7)
    for strategy in ("global", "equal_budget", "weighted"):
        got = NOISE.group_noise_stds(strategy, torch.from_numpy(thr),
                                     torch.from_numpy(dims), 1.3)
        want = JNOISE.group_noise_stds(strategy, jnp.asarray(thr),
                                       jnp.asarray(dims), 1.3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown noise allocation"):
        NOISE.gammas("nope", torch.ones(2), torch.ones(2))
    with pytest.raises(ValueError, match="leaf-key collision"):
        NOISE.check_leaf_key_collisions(["a/w", "b/w"], hash_fn=lambda s: 1)
    paths = ["/".join(p) for p, _ in _walk(build_model(
        get_config("qwen3-4b"), device="cpu").spec)]
    assert (NOISE.check_leaf_key_collisions(paths)
            == JNOISE.check_leaf_key_collisions(paths))


def test_quantile_update_matches_reference():
    rng = np.random.default_rng(13)
    norms = rng.uniform(0, 4, (5, 6)).astype(np.float32)
    thr = rng.uniform(0.5, 2, 5).astype(np.float32)
    z = rng.standard_normal(5).astype(np.float32)
    counts = Q.clip_counts(torch.from_numpy(norms), torch.from_numpy(thr))
    j_counts = JQ.clip_counts(jnp.asarray(norms), jnp.asarray(thr))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    key = jax.random.PRNGKey(4)
    js = JQ.init_quantile_state(thr, target_quantile=0.4, lr=0.3,
                                sigma_b=2.5)
    want = JQ.update_thresholds(js, j_counts, 6, key).thresholds
    z = np.asarray(jax.random.normal(key, (5,), jnp.float32))
    ps = Q.init_quantile_state(thr, target_quantile=0.4, lr=0.3, sigma_b=2.5)
    orig = Q.count_noise
    try:
        Q.count_noise = lambda shape, gen: torch.from_numpy(z.copy())
        got = Q.update_thresholds(ps, counts, 6, torch.Generator())
    finally:
        Q.count_noise = orig
    np.testing.assert_allclose(got.thresholds.numpy(), np.asarray(want),
                               rtol=1e-6)


@pytest.mark.parametrize("q,sigma,steps", [(0.01, 1.1, 100), (0.25, 0.7, 7),
                                           (1.0, 3.0, 2), (0.003, 0.6, 1000)])
def test_accounting_copy_matches_reference(q, sigma, steps):
    kw = dict(sigma=sigma, sampling_rate=q, steps=steps, delta=1e-5)
    assert abs(ACC.compute_epsilon(**kw) - JACC.compute_epsilon(**kw)) <= 1e-12
    np.testing.assert_allclose(
        ACC.rdp_sampled_gaussian(q, sigma, steps),
        JACC.rdp_sampled_gaussian(q, sigma, steps), rtol=0, atol=1e-12)
    cal = dict(target_eps=4.0, sampling_rate=q, steps=steps, delta=1e-5)
    assert abs(ACC.calibrate_sigma(**cal) - JACC.calibrate_sigma(**cal)) \
        <= 1e-12
    sb = ACC.sigma_b_for_fraction(sigma, 11, 0.02)
    assert abs(sb - JACC.sigma_b_for_fraction(sigma, 11, 0.02)) <= 1e-12
    got = ACC.split_noise_multiplier(sigma, sb, 11)
    want = JACC.split_noise_multiplier(sigma, sb, 11)
    assert abs(got.sigma_new - want.sigma_new) <= 1e-12
    assert abs(got.r - want.r) <= 1e-12


def test_data_pipeline_streams_are_bitwise_the_reference():
    src, jsrc = (mod.SyntheticLM(vocab_size=97, num_docs=6, doc_len=40,
                                 seed=3) for mod in (PIPE, JPIPE))
    docs, jdocs = src.documents(), jsrc.documents()
    assert all(np.array_equal(a, b) for a, b in zip(docs, jdocs))
    rows = PIPE.pack_documents(docs, 16, bos=96)
    np.testing.assert_array_equal(rows, JPIPE.pack_documents(jdocs, 16,
                                                             bos=96))
    s, js = (mod.PoissonSampler(num_examples=rows.shape[0], rate=0.4,
                                max_batch=4, seed=1) for mod in (PIPE, JPIPE))
    for _ in range(5):
        idx, jidx = s.next_indices(), js.next_indices()
        np.testing.assert_array_equal(idx, jidx)
        for k, v in PIPE.make_lm_batch(rows, idx, 4).items():
            np.testing.assert_array_equal(
                v, JPIPE.make_lm_batch(rows, jidx, 4)[k])
    assert s.overflow_count == js.overflow_count
    snap = s.state()
    a = s.next_indices()
    s.restore(snap)
    np.testing.assert_array_equal(s.next_indices(), a)


@pytest.mark.parametrize("mode", ["ghost_flat", "per_group",
                                  "ghost_flat_twopass"])
def test_train_cli_flat_and_group_modes_on_cpu(mode, capsys):
    """bk and twopass print the same step lines (the same clipped sums in
    another order, to the printed digits)."""
    lines = {}
    for execution in ("bk", "twopass"):
        assert train.main(["--arch", "tiny", "--clipping", mode,
                           "--execution", execution, "--group-count", "3",
                           "--steps", "2", "--batch", "4", "--seq", "16",
                           "--docs", "16", "--log-every", "1", "--seed", "3",
                           "--device", "cpu"]) == 0
        out = capsys.readouterr().out.splitlines()
        want_exec = "twopass" if mode.endswith("_twopass") else execution
        assert out[0].startswith(f"# arch=tiny params=106,944 groups=15 "
                                 f"mode={mode} backend=kernels device=cpu "
                                 f"execution={want_exec} ")
        lines[execution] = [ln for ln in out if ln.startswith("step")]
        assert all(np.isfinite(float(s.split()[i])) for s in
                   lines[execution] for i in (3, 5, 7, 9))
    assert len(lines["bk"]) == 2 and lines["bk"] == lines["twopass"]


def test_train_cli_on_cpu(capsys):
    assert train.main(["--arch", "tiny", "--steps", "2", "--batch", "4",
                       "--seq", "16", "--docs", "16", "--log-every", "1",
                       "--seed", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# arch=tiny params=106,944 groups=15 "
                             "mode=per_layer backend=kernels device=cpu")
    steps = [ln.split() for ln in out if ln.startswith("step")]
    assert [s[1] for s in steps] == ["0", "1"]
    assert all(np.isfinite(float(s[i])) for s in steps for i in (3, 5, 7, 9))
    assert out[-1].startswith("# spent epsilon=")


def test_train_cli_per_shard_on_cpu(capsys):
    """per_shard resolves to dp_blocks = --group-count and per_layer over
    the (layer x block) groups (tiny, M = 4: 15 + 2 * 2 * 3 = 27 groups);
    the plain and kernels engines print the same step lines."""
    lines = {}
    for engine in ("kernels", "plain"):
        assert train.main(["--arch", "tiny", "--clipping", "per_shard",
                           "--group-count", "4", "--backend", engine,
                           "--steps", "2", "--batch", "4", "--seq", "16",
                           "--docs", "16", "--log-every", "1", "--seed", "3",
                           "--device", "cpu"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith(f"# arch=tiny params=106,944 groups=27 "
                                 f"mode=per_layer backend={engine} "
                                 f"device=cpu ")
        assert out[0].endswith(" dp_blocks=4")
        lines[engine] = [ln for ln in out if ln.startswith("step")]
        assert all(np.isfinite(float(s.split()[i])) for s in lines[engine]
                   for i in (3, 5, 7, 9))
    assert len(lines["plain"]) == 2 and lines["plain"] == lines["kernels"]


def test_train_cli_per_shard_refuses_a_group_count_that_does_not_divide():
    with pytest.raises(ValueError, match="dp_blocks=3 must divide the qkv "
                       "output width 128 and the o output width 64"):
        train.main(["--arch", "tiny", "--clipping", "per_shard",
                    "--group-count", "3", "--steps", "1", "--batch", "2",
                    "--docs", "4", "--device", "cpu"])


def test_kernel_calls_per_step_under_per_shard(monkeypatch):
    """Per step: ghost_norm_blocked and clip_reduce (with the (B, M)
    block factors) once per blocked projection (qkv and o of each block); each other
    linear (gate_up, down, the head) by fused_norm_clip, within the fused
    route's rule at this size (on qwen3-4b: ghost_norm and clip_reduce,
    72 / 73 / 145 / 0); no scale_contract."""
    calls = _count_calls(monkeypatch, scale_contract=True)
    calls["ghost_norm_blocked"] = 0
    real = GN.ghost_norm_blocked

    def counting(*a, **k):
        calls["ghost_norm_blocked"] += 1
        return real(*a, **k)

    monkeypatch.setattr(GN, "ghost_norm_blocked", counting)
    args = train.build_train_parser().parse_args(
        ["--arch", "qwen3-4b", "--reduced", "--clipping", "per_shard",
         "--group-count", "4", "--steps", "2", "--batch", "2", "--seq", "8",
         "--docs", "4", "--device", "cpu"])
    trainer = train.Trainer(args)
    assert trainer.cfg.dp_blocks == 4
    assert trainer.plan.config.mode == "per_layer"
    met = trainer.step()
    n = trainer.cfg.num_layers
    assert calls == {"ghost_norm": 0, "ghost_norm_blocked": 2 * n,
                     "clip_reduce": 2 * n, "scale_contract": 0,
                     "fused_norm_clip": 2 * n + 1}
    assert np.isfinite(float(met.loss)) and np.isfinite(float(met.grad_norm))


def test_every_mode_ported_sharded_lora_runs_and_a8_named():
    """Every clipping mode of the reference is ported (naive_flat takes
    one flat noise group, as ghost_flat, and the CLI accepts it), and the
    sharded driver trains DP-LoRA's `trainable_key` (here on a mesh of
    one rank; `test_torch_sharded_lora.py` on four); the BK recipes of
    `dp_shift` / `dp_broadcast`, once named A.8, are ported with the
    recurrent families (`test_torch_recurrent.py`)."""
    import dataclasses
    from repro_torch.core.clipping import sharded_clipped_gradients
    from repro_torch.core import bk
    from repro_torch.launch.mesh import Mesh
    m = build_model(get_config("tiny"), device="cpu")
    assert train.build_train_parser().parse_args(
        ["--clipping", "naive_flat"]).clipping == "naive_flat"
    for mode in ("ghost_flat", "per_group_twopass", "naive_flat"):
        plan = dp_sgd.build_plan(dp_sgd.DPConfig(
            mode=mode, group_assignment=(0,) * m.layout.num_groups),
            m.layout)
        assert plan.num_noise_groups == 1
    m = build_model(dataclasses.replace(get_config("tiny"), lora_rank=4),
                    device="cpu")
    params = bridge.train_params_from_numpy(
        bridge.numpy_params(m.spec, seed=0), "cpu")
    res = sharded_clipped_gradients(
        m.loss_fn, params, _t(_batch(m.cfg.vocab_size)), m.layout,
        mode="non_private", batch_size=B, data_size=1,
        mesh=Mesh({"data": 1, "model": 1}, device="cpu", backend="gloo"),
        trainable_key="lora")
    assert set(res.grads) == {"lora"}
    assert not hasattr(bk, "_NOT_PORTED")
    assert callable(bk.record_shift) and callable(bk.record_broadcast)
