"""Microbatches (`DPConfig.microbatches`, `--microbatches`) and the train
CLI's new surface, on the CPU in f32.

* a full `make_dp_train_step` step with microbatches = 4 (B = 8) against
  the reference's, with the reference's noise and count-noise draws
  substituted (as `test_torch_train.py` does), under per_layer,
  ghost_flat by bk and by twopass, and naive_flat: metrics, thresholds,
  parameters and momenta;
* inside the port: microbatches = 1 ≡ 4 (the port of
  `tests/test_dp_sgd.py:48`) and microbatched bk ≡ twopass
  (`tests/test_bk.py:93`), at those tests' tolerance (rtol 2e-4, atol
  2e-6); the (K, B) norms in example order; a batch that does not divide
  raises;
* the kernel calls of a microbatched step (each microbatch's);
* the train CLI: `--clipping naive_flat --microbatches 2` prints the
  ghost_flat run's step lines, `microbatches=` in the header, and its
  `--clipping` / `--microbatches` against the reference parser's;
* `examples/torch_quickstart.py --device cpu`.

Tolerances against the reference: those of `test_torch_train.py`'s full
steps (rtol 1e-5 on the metrics and thresholds, atol 1e-4 of the leaf's
largest magnitude after a step).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import clipping as JCLIP
from repro.core import dp_sgd as JDP
from repro.launch import train as jtrain
from repro_torch import bridge, optim
from repro_torch.core import dp_sgd
from repro_torch.core import quantile as Q
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.kernels import clip_reduce as CR
from repro_torch.kernels import fused_clip as FC
from repro_torch.kernels import ghost_norm as GN
from repro_torch.launch import train
from test_torch_train import (_batch, _j, _leaves, _models, _reference_draws,
                              _t, assert_trees_close)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, NMB = 8, 4


@pytest.mark.parametrize("mode,execution", [
    ("per_layer", "bk"), ("ghost_flat", "bk"), ("ghost_flat", "twopass"),
    ("naive_flat", "bk")])
def test_microbatched_step_matches_reference_with_its_draws(mode, execution,
                                                            monkeypatch):
    m, jm = _models("tiny")
    tree = bridge.numpy_params(m.spec, seed=0)
    kw = dict(mode=mode, execution=execution, sigma=0.7, sampling_rate=0.05,
              steps=10, init_threshold=0.5 if mode == "per_layer" else 30.0,
              noise_strategy="weighted", microbatches=NMB)
    j_init, j_step, j_plan = JDP.make_dp_train_step(
        jm.loss_fn, jm.spec, jm.layout, joptim.sgd(0.05, momentum=0.9),
        JDP.DPConfig(backend="xla", **kw), batch_size=BATCH)
    p_init, p_step, p_plan = dp_sgd.make_dp_train_step(
        m.loss_fn, m.spec, m.layout, optim.sgd(0.05, momentum=0.9),
        dp_sgd.DPConfig(backend="kernels", **kw), batch_size=BATCH)
    assert (p_plan.num_noise_groups, p_plan.sigma_new) == (
        j_plan.num_noise_groups, j_plan.sigma_new)
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
    cur["z"], cur["zq"] = _reference_draws(
        jm.spec, max(j_plan.num_noise_groups, 1), key, 0)
    batch = _batch(m.cfg.vocab_size, b=BATCH, seed=20)
    jp, jo, jd, jmet = jax.jit(j_step)(jp, jo, jd, _j(batch), key)
    pp, po, pd, pmet = p_step(pp, po, pd, _t(batch), 0)
    np.testing.assert_allclose([float(x) for x in pmet],
                               [float(x) for x in jmet], rtol=1e-5)
    assert 0.0 < float(pmet.clip_fraction) < 1.0
    np.testing.assert_allclose(pd.qstate.thresholds.numpy(),
                               np.asarray(jd.qstate.thresholds), rtol=1e-5)
    assert_trees_close(pp, jp, atol_frac=1e-4)
    assert_trees_close(po.momentum, jo.momentum, atol_frac=1e-4)


def _one_step(m, tree, batch, **kw):
    init_fn, step_fn, _ = dp_sgd.make_dp_train_step(
        m.loss_fn, m.spec, m.layout, optim.sgd(0.1), dp_sgd.DPConfig(
            sigma=1.0, sampling_rate=0.1, steps=10, **kw),
        batch_size=BATCH)
    params = bridge.train_params_from_numpy(tree, "cpu")
    opt_state, dp_state = init_fn(params)
    params, _, _, met = step_fn(params, opt_state, dp_state, _t(batch), 5)
    assert np.isfinite(float(met.loss))
    return params, met


def _close(a, b):
    for (name, x), (_, y) in zip(_leaves(a), _leaves(b)):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=name)


def test_microbatching_is_exact():
    """The port of `tests/test_dp_sgd.py:48`: the same seed draws the same
    noise, so the parameters differ only by the clipped sums."""
    m, _ = _models("tiny")
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size, b=BATCH, seed=21)
    (p1, m1), (p4, m4) = (_one_step(m, tree, batch, mode="per_layer",
                                    microbatches=n) for n in (1, NMB))
    _close(p1, p4)
    np.testing.assert_allclose([float(x) for x in m4],
                               [float(x) for x in m1], rtol=1e-5)


def test_bk_microbatched_step_equals_twopass():
    """The port of `tests/test_bk.py:93`."""
    m, _ = _models("tiny")
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size, b=BATCH, seed=22)
    (pb, _), (pt, _) = (_one_step(m, tree, batch, mode="ghost_flat",
                                  execution=ex, microbatches=NMB)
                        for ex in ("bk", "twopass"))
    _close(pb, pt)


def test_microbatched_norms_come_back_in_example_order():
    m, _ = _models("tiny")
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _t(_batch(m.cfg.vocab_size, b=BATCH, seed=23))
    params = bridge.train_params_from_numpy(tree, "cpu")
    thr = torch.full((m.layout.num_groups,), 0.5)

    def clip(mb, n):
        return dp_clipped_gradients(m.loss_fn, params, mb, m.layout,
                                    mode="per_layer", batch_size=n,
                                    thresholds=thr)

    whole = clip(batch, BATCH)
    split = dp_sgd.clipped_microbatches(clip, batch, BATCH, NMB)
    torch.testing.assert_close(split.norms_sq, whole.norms_sq, rtol=1e-5,
                               atol=1e-9)
    torch.testing.assert_close(split.loss, whole.loss, rtol=1e-6, atol=0)
    _close(split.grads, whole.grads)


def test_batch_that_does_not_divide_raises():
    m, _ = _models("tiny")
    with pytest.raises(ValueError, match="batch_size must divide by "
                       "microbatches"):
        dp_sgd.make_dp_train_step(
            m.loss_fn, m.spec, m.layout, optim.sgd(0.1),
            dp_sgd.DPConfig(sigma=1.0, microbatches=4), batch_size=6)
    with pytest.raises(ValueError, match="batch_size must divide by "
                       "microbatches"):
        train.main(["--arch", "tiny", "--batch", "6", "--microbatches", "4",
                    "--steps", "1", "--docs", "4", "--device", "cpu"])


def test_kernel_calls_of_a_microbatched_step(monkeypatch):
    """Each microbatch's backward clips every linear: per_layer on the
    composed route launches ghost_norm and clip_reduce per linear and
    microbatch (on qwen3-4b at B = 64 in 8 microbatches: 145 x 8)."""
    calls = dict.fromkeys(("ghost_norm", "clip_reduce", "fused_norm_clip"),
                          0)
    for mod, name in ((GN, "ghost_norm"), (CR, "clip_reduce"),
                      (FC, "fused_norm_clip")):
        def counting(*a, _name=name, _fn=getattr(mod, name), **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counting)
    monkeypatch.setattr(FC, "fits", lambda din, dout: False)
    args = train.build_train_parser().parse_args(
        ["--arch", "qwen3-4b", "--reduced", "--batch", "4", "--microbatches",
         "2", "--seq", "8", "--steps", "2", "--docs", "4", "--device",
         "cpu"])
    trainer = train.Trainer(args)
    met = trainer.step()
    linears = 4 * trainer.cfg.num_layers + 1
    assert calls == {"ghost_norm": 2 * linears, "clip_reduce": 2 * linears,
                     "fused_norm_clip": 0}
    assert np.isfinite(float(met.loss))


def test_train_cli_naive_flat_with_microbatches(capsys):
    """naive_flat clips as ghost_flat does: the two print the same step
    lines; the header carries microbatches=2."""
    lines = {}
    for mode in ("naive_flat", "ghost_flat"):
        assert train.main(["--arch", "tiny", "--clipping", mode,
                           "--microbatches", "2", "--steps", "2", "--batch",
                           "4", "--seq", "16", "--docs", "16", "--log-every",
                           "1", "--seed", "3", "--device", "cpu"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith(f"# arch=tiny params=106,944 groups=15 "
                                 f"mode={mode} backend=kernels device=cpu "
                                 f"execution=bk microbatches=2 ")
        lines[mode] = [ln for ln in out if ln.startswith("step")]
    assert len(lines["naive_flat"]) == 2
    assert lines["naive_flat"] == lines["ghost_flat"]


def test_cli_choices_match_the_reference_parser():
    """Every ported --clipping is a reference mode (or per_shard, which the
    reference resolves in its dry run), and all of them are ported;
    --microbatches takes the reference's type and default."""
    assert set(train.CLIPPING) == set(JCLIP.MODES) | {"per_shard"}
    ours = {a.dest: a for a in train.build_train_parser()._actions}
    ref = {a.dest: a for a in jtrain.build_arg_parser()._actions}
    for dest in ("microbatches", "clipping"):
        assert ours[dest].default == ref[dest].default
        assert ours[dest].type == ref[dest].type


def test_torch_quickstart_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_quickstart.py"),
         "--device", "cpu", "--steps", "2"], capture_output=True, text=True,
        env=env, timeout=300, check=True).stdout
    assert "clipping groups K=19" in out
    steps = [ln.split() for ln in out.splitlines() if ln.startswith("step")]
    assert [s[1] for s in steps] == ["0", "1"]
    assert all(np.isfinite(float(s[3])) for s in steps)
    assert "privacy spent: eps=8.00" in out
