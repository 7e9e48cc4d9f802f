"""The `auto` ghost-op backend and its measured table
(`repro_torch.kernels.autotune`), on the CPU.

* The reference's `tests/test_autotune.py`, case for case, under the
  port's candidate names (`plain` / `kernels` for `xla` / `pallas`, and
  `linear_clip`'s third, `fused`): bucketing, record / best precedence,
  the table's persistence discipline (versioned, stamped with the card
  and the kernels' sources, checksummed, never a crash on a bad file),
  the measured argmin deciding every measured bucket, the static model
  the rest, installation, `auto`'s dispatch and values, seeding, the
  sweep and the stamp.
* Against the reference: `bucket_key` over a grid of shapes, and
  `choose_op` of both packages over one synthetic table (names mapped)
  in every measured bucket.
* The entry points: the train CLI under `--backend auto` with a table in
  a temporary `--cache-dir` prints the step lines of `--backend kernels`
  and `plain`; the serve CLI under each `--backend` prints the
  reference CLI's tokens (f32).

Tolerances: values of the ghost ops as `tests/test_torch_ghost.py` (f32,
rtol 1e-5, atol 1e-5); the paged decode as `tests/test_torch_paged_attn.py`
(rtol = atol = 2e-5).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.spec import init_params as jax_init_params
from repro.kernels import autotune as jax_autotune
from repro.kernels import backend as jax_backend
from repro.launch import serve as jax_serve
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.kernels import _build, autotune, backend
from repro_torch.kernels import fused_clip
from repro_torch.launch import compile_cache, serve, train


def _tab(path=None, topology=None):
    return autotune.AutotuneTable(
        topology=topology or autotune.topology_stamp(), path=path)


@pytest.fixture
def restore_caches():
    """The CLIs install a table and move the build directory for the
    process: put both back."""
    yield
    autotune.install(None)
    compile_cache.disable()


# ---------------------------------------------------------------------------
# Bucketing.
# ---------------------------------------------------------------------------


def test_bucket_dim_next_pow2():
    assert [autotune.bucket_dim(n) for n in (0, 1, 2, 3, 127, 128, 129)] \
        == [0, 1, 2, 4, 128, 128, 256]


def test_bucket_key_covers_the_bucket():
    assert autotune.bucket_key("norms", 100, 64, 48) \
        == autotune.bucket_key("norms", 128, 64, 64)
    assert autotune.bucket_key("norms", 129, 64, 64) \
        != autotune.bucket_key("norms", 128, 64, 64)
    assert autotune.bucket_key("norms", 128, 64, 64) \
        != autotune.bucket_key("clip_sum", 128, 64, 64)


def test_bucket_key_matches_reference():
    for op in autotune.OPS:
        for t in (0, 1, 7, 8, 9, 256, 257, 4096):
            for din, dout in ((1, 1), (40, 1536), (2560, 151936),
                              (576, 512), (3, 8)):
                assert autotune.bucket_key(op, t, din, dout) \
                    == jax_autotune.bucket_key(op, t, din, dout)
    assert autotune.OPS == jax_autotune.OPS


# ---------------------------------------------------------------------------
# Record / best semantics.
# ---------------------------------------------------------------------------


def test_record_and_best_argmin():
    tab = _tab()
    assert tab.record("norms", 128, 64, 64, "plain", 100.0)
    assert tab.record("norms", 128, 64, 64, "kernels", 50.0)
    assert tab.best("norms", 128, 64, 64) == "kernels"
    assert tab.best("norms", 4096, 64, 64) is None  # unmeasured bucket
    tab.record("norms", 128, 64, 64, "kernels", 500.0)  # refreshed
    assert tab.best("norms", 128, 64, 64) == "plain"
    # linear_clip's third candidate, the one fused launch
    tab.record("linear_clip", 128, 64, 64, "kernels", 30.0)
    tab.record("linear_clip", 128, 64, 64, "fused", 20.0)
    assert tab.best("linear_clip", 128, 64, 64) == "fused"


def test_best_plain_margin():
    """`best` is the bare argmin unless asked for a margin; with one,
    `plain` stands only where it beats the fastest other candidate by
    more than the margin, and `choose_op` asks for PLAIN_MARGIN."""
    tab = _tab()
    tab.record("clip_sum", 128, 64, 64, "plain", 100.0)
    tab.record("clip_sum", 128, 64, 64, "kernels", 110.0)
    assert tab.best("clip_sum", 128, 64, 64) == "plain"
    assert tab.best("clip_sum", 128, 64, 64, plain_margin=0.15) == "kernels"
    assert tab.best("clip_sum", 128, 64, 64, plain_margin=0.05) == "plain"
    for on_gpu in (False, True):
        assert backend.choose_op("clip_sum", 128, 64, 64, on_gpu=on_gpu,
                                 table=tab) == "kernels"
    # a reading like one noisy sweep's: the kernel far slower stays plain
    tab.record("clip_sum", 128, 64, 64, "kernels", 847.7)
    assert backend.choose_op("clip_sum", 128, 64, 64, on_gpu=True,
                             table=tab) == "plain"
    # linear_clip: the faster of fused and the composed pair is the rival
    tab.record("linear_clip", 128, 64, 64, "plain", 100.0)
    tab.record("linear_clip", 128, 64, 64, "kernels", 140.0)
    tab.record("linear_clip", 128, 64, 64, "fused", 112.0)
    assert backend.choose_op("linear_clip", 128, 64, 64, on_gpu=True,
                             table=tab) == "fused"
    # a plain-only bucket has no rival
    tab.record("norms", 128, 64, 64, "plain", 5.0)
    assert tab.best("norms", 128, 64, 64, plain_margin=0.15) == "plain"


def test_measured_beats_model_seed():
    tab = _tab()
    tab.record("clip_sum", 128, 64, 64, "plain", 100.0)
    assert not tab.record("clip_sum", 128, 64, 64, "plain", 1.0,
                          source="model")
    assert tab.lookup("clip_sum", 128, 64, 64)["plain"]["us"] == 100.0
    tab.record("clip_sum", 128, 64, 64, "kernels", 0.5, source="model")
    assert tab.best("clip_sum", 128, 64, 64) == "plain"
    tab.record("clip_sum", 512, 64, 64, "kernels", 2.0, source="model")
    assert tab.best("clip_sum", 512, 64, 64) == "kernels"
    tab.record("clip_sum", 128, 64, 64, "kernels", 10.0)
    assert tab.best("clip_sum", 128, 64, 64) == "kernels"


def test_record_rejects_garbage():
    tab = _tab()
    for name in ("cuda", "xla", "pallas"):
        with pytest.raises(ValueError):
            tab.record("norms", 128, 64, 64, name, 1.0)
    with pytest.raises(ValueError):  # fused is linear_clip's alone
        tab.record("norms", 128, 64, 64, "fused", 1.0)
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError):
            tab.record("norms", 128, 64, 64, "plain", bad)


# ---------------------------------------------------------------------------
# Persistence: round trip + every staleness mode loads EMPTY, never raises.
# ---------------------------------------------------------------------------


def test_save_load_round_trip(tmp_path):
    path = str(tmp_path / "tab.json")
    tab = _tab(path)
    tab.record("norms", 128, 64, 64, "kernels", 42.0)
    tab.record("paged_attn", 256, 64, 64, "plain", 7.0)
    tab.save()
    back = autotune.load(path)
    assert back.stale_reason is None
    assert back.entries == tab.entries
    assert back.best("norms", 100, 33, 64) == "kernels"  # same bucket


@pytest.mark.parametrize("breakage", [
    "missing", "not_json", "truncated", "crc", "version", "topology",
    "not_dict"])
def test_stale_or_corrupt_loads_empty(tmp_path, breakage):
    path = str(tmp_path / "tab.json")
    tab = _tab(path)
    tab.record("norms", 128, 64, 64, "kernels", 42.0)
    tab.save()
    if breakage == "missing":
        os.unlink(path)
    elif breakage == "not_json":
        open(path, "w").write("))) not json (((")
    elif breakage == "truncated":
        blob = open(path).read()
        open(path, "w").write(blob[: len(blob) // 2])
    elif breakage == "crc":
        doc = json.load(open(path))
        doc["entries"]["norms|t128|i64|o64"]["kernels"]["us"] = 1e-9
        json.dump(doc, open(path, "w"))  # edited without re-checksumming
    elif breakage == "version":
        doc = json.load(open(path))
        doc["version"] = autotune.TABLE_VERSION + 1
        json.dump(doc, open(path, "w"))
    elif breakage == "not_dict":
        json.dump([1, 2, 3], open(path, "w"))
    topo = autotune.topology_stamp()
    if breakage == "topology":  # a redesigned kernel: another digest
        topo = dict(topo, kernel_sources="0" * 64, device_count=8192)
    back = autotune.load(path, topology=topo)
    assert back.stale_reason is not None
    assert len(back) == 0
    assert back.best("norms", 128, 64, 64) is None  # clean miss
    back.record("norms", 128, 64, 64, "plain", 9.0)  # the next sweep
    back.save()
    again = autotune.load(path, topology=topo)
    assert again.stale_reason is None and len(again) == 1


def test_save_is_atomic_no_tmp_left(tmp_path):
    path = str(tmp_path / "tab.json")
    tab = _tab(path)
    tab.record("norms", 128, 64, 64, "plain", 1.0)
    tab.save()
    assert os.listdir(tmp_path) == ["tab.json"]


# ---------------------------------------------------------------------------
# choose_op: the measured argmin wins on and off the card; the static
# model decides the unmeasured buckets.
# ---------------------------------------------------------------------------


def _with_margin(us: dict) -> str:
    """The measured argmin of {candidate: µs}, but `plain` only where it
    beats every other candidate by more than autotune.PLAIN_MARGIN."""
    win = min(us, key=us.get)
    rivals = {k: v for k, v in us.items() if k != "plain"}
    if win == "plain" and rivals:
        rival = min(rivals, key=rivals.get)
        if rivals[rival] <= us["plain"] * (1 + autotune.PLAIN_MARGIN):
            return rival
    return win


def test_choose_op_equals_measured_argmin_everywhere():
    """Over a synthetic table with KNOWN winners per bucket, auto's choice
    is the measured argmin on EVERY measured bucket, on the card and off
    it (`plain` only past the margin): kernels wins off the card and plain
    on it, which the static model never picks."""
    tab = _tab()
    want = {}
    rng = np.random.RandomState(0)
    for op in autotune.OPS:
        names = autotune.candidates(op)
        for t, d in ((128, 64), (256, 128), (1024, 512)):
            us = 1.0 + rng.rand(len(names)) * 100
            for name, u in zip(names, us):
                tab.record(op, t, d, d, name, float(u))
            want[(op, t, d)] = _with_margin(
                {n: float(u) for n, u in zip(names, us)})
    for (op, t, d), winner in want.items():
        for on_gpu in (False, True):
            assert backend.choose_op(op, t, d, d, on_gpu=on_gpu,
                                     table=tab) == winner, (op, t, d)
    assert {"plain", "kernels", "fused"} <= set(want.values())


def test_choose_op_unmeasured_falls_back_to_static_model():
    tab = _tab()
    tab.record("norms", 128, 64, 64, "kernels", 1.0)
    # off the card the plain path, on it the kernels (and the fused route
    # where the reference engine's rule passes)
    assert backend.choose_op("norms", 4096, 1024, 1024, on_gpu=False,
                             table=tab) == "plain"
    assert backend.choose_op("norms", 4096, 1024, 1024, on_gpu=True,
                             table=tab) == "kernels"
    assert backend.choose_op("paged_attn", 4096, 64, 64, on_gpu=False,
                             table=tab) == "plain"
    assert backend.choose_op("paged_attn", 4096, 64, 64, on_gpu=True,
                             table=tab) == "kernels"
    assert fused_clip.fits(1536, 40) and not fused_clip.fits(2560, 6144)
    assert backend.choose_op("linear_clip", 256, 1536, 40, on_gpu=True,
                             table=tab) == "fused"
    assert backend.choose_op("linear_clip", 256, 2560, 6144, on_gpu=True,
                             table=tab) == "kernels"
    # ...but the MEASURED bucket is honoured off the card
    assert backend.choose_op("norms", 128, 64, 64, on_gpu=False,
                             table=tab) == "kernels"


def test_autotune_off_pins_static_model():
    tab = _tab()
    tab.record("norms", 128, 64, 64, "kernels", 1.0)
    assert backend.choose_op("norms", 128, 64, 64, autotune=False,
                             on_gpu=False, table=tab) == "plain"
    with autotune.use_table(tab):
        eng = backend.make_engine("auto", autotune=False)
        assert eng.choice("norms", torch.ones(2, 128, 64),
                          torch.ones(2, 128, 64)) == "plain"


def test_no_table_installed_matches_static_choice(monkeypatch):
    # a CLI run earlier in this process may have installed its table
    monkeypatch.setattr(autotune, "_INSTALLED", None)
    assert autotune.installed_table() is None
    for on_gpu in (False, True):
        assert backend.choose_op("norms", 128, 64, 64, on_gpu=on_gpu) \
            == backend.choose_linear_path(128, 64, 64, on_gpu=on_gpu)


def test_choose_op_matches_reference_under_one_table():
    """One synthetic table in both packages (xla <-> plain, pallas <->
    kernels): the same choice in every measured bucket, on and off the
    accelerator, but where xla wins by no more than the port's
    PLAIN_MARGIN: there the port keeps the kernels (a deliberate
    deviation; at least one such bucket is in the table)."""
    names = {"xla": "plain", "pallas": "kernels"}
    ours = _tab()
    theirs = jax_autotune.AutotuneTable(
        topology=jax_autotune.topology_stamp())
    rng = np.random.RandomState(1)
    buckets, kept = [], 0
    for op in autotune.OPS:
        for t, din, dout in ((8, 1536, 40), (256, 2560, 6144),
                             (256, 9728, 2560), (272, 128, 128)):
            us = {}
            for ref_name, name in names.items():
                us[name] = float(1.0 + rng.rand() * 100)
                theirs.record(op, t, din, dout, ref_name, us[name])
                ours.record(op, t, din, dout, name, us[name])
            buckets.append((op, t, din, dout, us))
    # a bucket where plain wins inside the margin
    us = {"plain": 10.0, "kernels": 11.0}
    for ref_name, name in names.items():
        theirs.record("norms", 64, 64, 64, ref_name, us[name])
        ours.record("norms", 64, 64, 64, name, us[name])
    buckets.append(("norms", 64, 64, 64, us))
    cfg = jax_backend.EngineConfig(backend="auto")
    for op, t, din, dout, us in buckets:
        for on in (False, True):
            want = names[jax_backend.choose_op(op, t, din, dout, cfg,
                                               on_tpu=on, table=theirs)]
            if want == "plain" and us["kernels"] <= us["plain"] * (
                    1 + autotune.PLAIN_MARGIN):
                want = "kernels"
                kept += 1
            assert backend.choose_op(op, t, din, dout, on_gpu=on,
                                     table=ours) == want
    assert kept >= 2


# ---------------------------------------------------------------------------
# Installation plumbing.
# ---------------------------------------------------------------------------


def test_install_and_use_table_scoping():
    base, override = _tab(), _tab()
    base.record("norms", 128, 64, 64, "plain", 1.0)
    override.record("norms", 128, 64, 64, "kernels", 1.0)
    try:
        autotune.install(base)
        assert autotune.installed_table() is base
        with autotune.use_table(override):
            assert autotune.installed_table() is override
        assert autotune.installed_table() is base
    finally:
        autotune.install(None)
    assert autotune.installed_table() is None


def test_install_default_survives_stale_file(tmp_path):
    root = str(tmp_path)
    try:
        tab = autotune.install_default(root)
        assert len(tab) == 0 and tab.stale_reason == "missing"
        os.makedirs(os.path.dirname(tab.path), exist_ok=True)
        open(tab.path, "w").write("garbage")
        tab2 = autotune.install_default(root)
        assert len(tab2) == 0 and tab2.stale_reason is not None
    finally:
        autotune.install(None)


# ---------------------------------------------------------------------------
# The AutoBackend dispatches, and stays numerically right, on a
# table-driven choice.
# ---------------------------------------------------------------------------


def test_auto_backend_dispatch_and_value_parity_under_table(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((2, 128, 64), generator=gen)
    g = torch.randn((2, 128, 48), generator=gen) * 0.1
    f = torch.rand((2,), generator=gen)
    c = torch.full((2,), 0.5)
    tab = _tab()
    tab.record("clip_sum", 128, 64, 64, "kernels", 1.0)  # dout 48 -> o64
    tab.record("clip_sum", 128, 64, 64, "plain", 2.0)
    tab.record("linear_clip", 128, 64, 64, "fused", 1.0)
    tab.record("linear_clip", 128, 64, 64, "kernels", 2.0)
    calls = []
    real = fused_clip.fused_norm_clip
    monkeypatch.setattr(fused_clip, "fused_norm_clip",
                        lambda *x: calls.append(1) or real(*x))
    # the BK epilogue's stacked form: (S, B, T, d), T read off dim -2
    tab.record("scale_contract", 128, 64, 64, "kernels", 1.0)
    tab.record("scale_contract", 128, 64, 64, "plain", 2.0)
    from repro_torch.kernels import bk as kbk
    contracts = []
    real_sc = kbk.scale_contract
    monkeypatch.setattr(kbk, "scale_contract",
                        lambda *x: contracts.append(1) or real_sc(*x))
    a4, g4, f2 = torch.stack([a, a]), torch.stack([g, -g]), torch.stack(
        [f, f])
    plain = backend.make_engine("plain")
    with backend.scoped("auto"):
        eng = backend.active()
        assert eng._engine("clip_sum", a, g) is eng._plain  # off the card
        with autotune.use_table(tab):
            assert eng._engine("clip_sum", a, g) is eng._kernels
            got = eng.clipped_sum_linear(a, g, f)
            n, fac, dw = eng.linear_clip(a, g, c)
            sc = eng.scale_contract(a4, g4, f2)
    assert calls == [1]  # the measured fused route, off the card too
    assert contracts == [1]
    want = plain.clipped_sum_linear(a, g, f)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sc.numpy(), plain.scale_contract(
        a4, g4, f2).numpy(), rtol=1e-5, atol=1e-5)
    wn, wf, wdw = plain.linear_clip(a, g, c)
    for x, y in ((n, wn), (fac, wf), (dw, wdw)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_unscoped_paged_decode_takes_the_kernel_wrapper(monkeypatch):
    """Outside any scope the paged decode goes through the kernel's
    wrapper (its CUDA kernel on the card, its plain version for these
    CPU tensors) and resolves to `kernels` for a CUDA device; only an
    explicit `plain` engine takes `paged_attn_ref` there."""
    import contextvars
    from repro_torch.kernels import paged_attn as kpa
    q, kp, vp, pt, pos = autotune.paged_attn_data((2, 64, 32, 32))
    calls = []
    real = kpa.paged_attn
    monkeypatch.setattr(kpa, "paged_attn",
                        lambda *x, **k: calls.append(1) or real(*x, **k))
    cuda = torch.device("cuda")

    def unscoped():
        eng = backend.active()
        assert eng.name == "plain"
        assert eng.paged_impl(device=cuda) == "kernels"
        assert eng.paged_impl(device=torch.device("cpu")) == "plain"
        return eng.paged_attn(q, kp, vp, pt, pos, scale=0.125)

    got = contextvars.Context().run(unscoped)
    assert calls == [1]
    with backend.scoped("plain"):
        eng = backend.active()
        assert eng.paged_impl(device=cuda) == "plain"
        ref = eng.paged_attn(q, kp, vp, pt, pos, scale=0.125)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_auto_paged_impl_hint_consults_table():
    args = autotune.paged_attn_data((2, 128, 64, 64))
    q, kp, vp, pt, pos = args
    t, din, dout = autotune.paged_attn_dims(q, pt, kp.shape[1], vp.shape[-1])
    tab = _tab()
    tab.record("paged_attn", t, din, dout, "kernels", 1.0)
    tab.record("paged_attn", t, din, dout, "plain", 2.0)
    eng = backend.make_engine("auto")
    cpu = torch.device("cpu")
    assert eng.paged_impl(device=cpu) == "plain"  # no hints: static rule
    assert eng.paged_impl(t=t, din=din, dout=dout, device=cpu) == "plain"
    assert backend.make_engine("kernels").paged_impl() == "kernels"
    with autotune.use_table(tab):
        assert eng.paged_impl(t=t, din=din, dout=dout,
                              device=cpu) == "kernels"
        got = eng.paged_attn(q, kp, vp, pt, pos, scale=0.125)
    ref = backend.make_engine("plain").paged_attn(q, kp, vp, pt, pos,
                                                  scale=0.125)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# Seeding paths: records + the live sweep.
# ---------------------------------------------------------------------------


def test_seed_from_records_parses_bench_rows():
    records = [
        {"name": "kernel_clip_sum_kernels", "backend": "kernels",
         "t": 128, "din": 64, "dout": 64, "us_per_call": 5.0},
        {"name": "kernel_clip_sum_plain", "backend": "plain",
         "t": 128, "din": 64, "dout": 64, "us_per_call": 9.0},
        {"name": "kernel_linear_clip_fused", "backend": "fused",
         "t": 128, "din": 64, "dout": 64, "us_per_call": 4.0},
        {"name": "kernel_norms_naive", "backend": "naive",
         "t": 128, "din": 64, "dout": 64, "us_per_call": 3.0},  # ignored
        {"name": "kernel_kernels_skipped", "backend": "kernels"},
        {"name": "other_row", "backend": "plain", "t": 1, "din": 1,
         "dout": 1, "us_per_call": 1.0},  # not a kernel row
    ]
    tab = autotune.seed_from_records(records, _tab())
    assert len(tab) == 2
    assert tab.best("clip_sum", 128, 64, 64) == "kernels"
    assert tab.best("linear_clip", 128, 64, 64) == "fused"


def test_sweep_measures_and_persists(tmp_path):
    path = str(tmp_path / "tab.json")
    tab = autotune.sweep(ops=("norms", "linear_clip"),
                         shapes=((2, 16, 64, 64),), table=_tab(path))
    slot = tab.lookup("norms", 16, 64, 64)
    assert set(slot) == {"plain", "kernels"}
    assert set(tab.lookup("linear_clip", 16, 64, 64)) == {
        "plain", "kernels", "fused"}
    assert all(v["us"] > 0 and v["source"] == "measured"
               for v in slot.values())
    back = autotune.load(path)
    assert back.entries == tab.entries
    assert back.best("norms", 16, 64, 64) in ("plain", "kernels")


def test_measure_op_skips_a_shape_a_candidate_refuses(monkeypatch):
    """A candidate's ValueError (a shape it does not take) skips it; any
    other failure (a build or a launch) raises."""
    def refuse(*a, **k):
        raise ValueError("too many tiles")

    monkeypatch.setattr(fused_clip, "fused_norm_clip", refuse)
    got = autotune.measure_op("linear_clip", (2, 8, 16, 16), iters=1)
    assert set(got) == {"plain", "kernels"}

    def broken(*a, **k):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(fused_clip, "fused_norm_clip", broken)
    with pytest.raises(RuntimeError, match="build failed"):
        autotune.measure_op("linear_clip", (2, 8, 16, 16), iters=1)


# ---------------------------------------------------------------------------
# Topology stamp.
# ---------------------------------------------------------------------------


def test_topology_stamp_keys_and_crc_stability():
    stamp = autotune.topology_stamp()
    assert set(stamp) == {"torch_version", "cuda_version", "device_name",
                          "capability", "device_count", "kernel_sources"}
    assert stamp["torch_version"] == torch.__version__
    assert stamp["device_name"] == autotune.device_kind()
    assert stamp["kernel_sources"] == _build.source_digest()
    assert autotune.stamp_crc(stamp) == autotune.stamp_crc(stamp)
    assert autotune.stamp_crc(dict(stamp, device_count=8192)) \
        != autotune.stamp_crc(stamp)
    # another build of the kernels moves the table's path: a clean miss
    assert autotune.default_path("/x", stamp) != autotune.default_path(
        "/x", dict(stamp, kernel_sources="0" * 64))


# ---------------------------------------------------------------------------
# The entry points.
# ---------------------------------------------------------------------------

TRAIN = ["--arch", "tiny", "--clipping", "per_shard", "--group-count", "2",
         "--steps", "2", "--batch", "4", "--seq", "16", "--docs", "16",
         "--log-every", "1", "--seed", "3", "--device", "cpu"]


def test_train_cli_auto_prints_the_kernels_and_plain_step_lines(
        tmp_path, capsys, monkeypatch, restore_caches):
    """A table under --cache-dir that sends tiny's buckets both ways (the
    blocked norms and the fused route to kernels, the blocked clipped
    sums to plain): `auto` prints the step lines of `kernels` and of
    `plain`."""
    from repro_torch.kernels import ghost_norm
    root = str(tmp_path)
    tab = autotune.AutotuneTable(path=autotune.default_path(root))
    # tiny: qkv 64 -> 128 and o 64 -> 64 (blocked), gate_up 64 -> 256,
    # down 128 -> 64, the head 64 -> 257; T = 16
    for din, dout in ((64, 128), (64, 64), (64, 256), (128, 64), (64, 257)):
        tab.record("norms", 16, din, dout, "kernels", 1.0)
        tab.record("norms", 16, din, dout, "plain", 2.0)
        tab.record("linear_clip", 16, din, dout, "fused", 1.0)
        tab.record("clip_sum", 16, din, dout, "plain", 1.0)
    tab.save()
    calls = {"fused": 0, "blocked": 0}
    fused, blocked = fused_clip.fused_norm_clip, ghost_norm.ghost_norm_blocked

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fused_clip, "fused_norm_clip", count("fused", fused))
    monkeypatch.setattr(ghost_norm, "ghost_norm_blocked",
                        count("blocked", blocked))
    lines, routed = {}, {}
    for be in ("auto", "kernels", "plain"):
        calls.update(fused=0, blocked=0)
        assert train.main(TRAIN + ["--backend", be, "--cache-dir",
                                   root]) == 0
        out = capsys.readouterr().out.splitlines()
        assert f" backend={be} " in out[0]
        assert out[2].startswith("# startup ") and "nvcc_runs=0" in out[2]
        lines[be] = [ln for ln in out if ln.startswith("step")]
        routed[be] = dict(calls)
    assert len(autotune.installed_table()) == len(tab)
    # a step: gate_up and down of each of the 2 layers and the head fused,
    # qkv and o blocked; 2 steps
    assert routed == {"auto": {"fused": 10, "blocked": 8},
                      "kernels": {"fused": 10, "blocked": 8},
                      "plain": {"fused": 0, "blocked": 0}}
    assert len(lines["auto"]) == 2
    assert lines["auto"] == lines["kernels"] == lines["plain"]
    progs = compile_cache.warmed_programs(root)
    assert sorted(r["parts"]["backend"] for r in progs.values()) == [
        "auto", "kernels", "plain"]


@pytest.fixture(scope="module")
def reference_serve_grid():
    """The reference serve CLI's tokens for SERVE_ARGV (paged, f32)."""
    argv = ["serve"] + SERVE_ARGV + ["--paging", "on", "--backend", "xla",
                                     "--cache", "off", "--autotune", "off"]
    real, sys.argv = sys.argv, argv
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            assert jax_serve.main() == 0
    finally:
        sys.argv = real
    return _grid(buf.getvalue())


SERVE_ARGV = ["--arch", "tiny", "--batch", "4", "--slots", "2",
              "--prompt-len", "12", "--min-prompt-len", "4", "--gen", "6",
              "--page-len", "8"]


def _grid(out):
    lines = out.strip().splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("# arch="))
    return lines[head + 1:]


@pytest.mark.parametrize("be", ["kernels", "plain", "auto"])
def test_serve_cli_backends_print_the_reference_tokens(
        be, reference_serve_grid, capsys, monkeypatch, tmp_path,
        restore_caches):
    import jax
    jm = jax_build_model(jax_get_config("tiny"))
    jp = jax.tree_util.tree_map(np.asarray,
                                jax_init_params(jm.spec,
                                                jax.random.PRNGKey(0)))
    monkeypatch.setattr(serve, "serve_params",
                        lambda model, seed, device:
                        bridge.params_from_numpy(jp, device))
    assert serve.main(SERVE_ARGV + ["--backend", be, "--device", "cpu",
                                    "--cache-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"backend={be} " in out and "paged=yes" in out
    assert _grid(out) == reference_serve_grid
    assert [r["parts"]["entry"] for r in
            compile_cache.warmed_programs(str(tmp_path)).values()] == [
                "serve"]
