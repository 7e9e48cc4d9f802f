"""The port's multi-tenant DP-LoRA serving plane against the JAX package,
on the CPU in f32.

* a pool mixing tenants decodes each request as serving its tenant
  alone, on tiny and deepseek-v3-reduced (MLA: the kv_b delta through the
  absorbed form), paged and contiguous; the zero-adapter tenant IS the
  single-model engine; tiny's tokens equal the reference engine's on the
  same adapters, and deepseek-v3's `serve_step` logits the reference's
  with the same tenant-stacked adapters, on both planes;
* onboarding and a hot swap write into the allocated buffer: one
  adapter storage (each leaf's data_ptr and shape) for the engine's
  life, the counterpart of the reference's "no retrace"; the
  installed slots read back with the source tree's crc32s, which are the
  reference's `leaf_crc32`s of the same adapter;
* submit validation, and the lifecycle of `tests/test_swap.py`: a swap
  mid-decode pins in-flight requests to the old version, a queued one
  takes the new version, a removed tenant drains then recycles its slot,
  an exhausted adapter pool defers FIFO, the watcher installs only
  verified publishes (bit for bit, re-publishes skipped), ignores a
  torn one and refuses a publish without crcs;
* the serve CLI refuses `--tenants` outside engine mode.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import leaf_crc32 as jax_leaf_crc32
from repro.configs import get_config as jax_get_config
from repro.core import lora as JL
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.checkpoint.packer import packb, unpackb
from repro_torch.checkpoint.store import (save_checkpoint, tree_crcs,
                                          tree_flatten)
from repro_torch.configs import get_config
from repro_torch.core.spec import _walk
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.launch.inputs import synthetic_requests
from repro_torch.launch.swap import AdapterWatcher
from repro_torch.models.transformer import build_model


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: beside the other test workers, a process that
    spins up a thread per core runs these many small ops far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(num_slots=4, cache_len=64, prefill_chunk=4)


class Setup:
    """One LoRA model in both packages, its base parameters from one numpy
    tree, and numpy adapters (a and b random, so the delta is not zero)."""

    def __init__(self, arch, rank=4):
        reduced = arch != "tiny"
        self.cfg = dataclasses.replace(get_config(arch, reduced=reduced),
                                       lora_rank=rank)
        self.model = build_model(self.cfg, device="cpu")
        self.jmodel = jax_build_model(dataclasses.replace(
            jax_get_config(arch, reduced=reduced), lora_rank=rank))
        tree = bridge.numpy_params(self.model.spec, seed=0)
        self.base_np = {k: v for k, v in tree.items() if k != "lora"}
        self.params = bridge.params_from_numpy(self.base_np, "cpu")

    def adapter_np(self, seed, scale=0.05):
        rng = np.random.default_rng(seed)
        out: dict = {}
        for path, p in _walk(self.model.spec["lora"]):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = (scale * rng.standard_normal(p.shape)).astype(
                np.float32)
        return out

    def adapter(self, seed):
        return bridge.cache_from_numpy(self.adapter_np(seed), "cpu")

    def engine(self, **kw):
        return DecodeEngine(self.model, self.params, **{**KW, **kw})


_SETUPS: dict = {}


def setup_of(arch) -> Setup:
    if arch not in _SETUPS:
        _SETUPS[arch] = Setup(arch)
    return _SETUPS[arch]


def _reqs(cfg, n=6, seed=3):
    return synthetic_requests(cfg.vocab_size, n, min_len=2, max_len=12,
                              seed=seed)


def _mixed(s, adb, reqs, **kw):
    eng = s.engine(max_tenants=2, **kw)
    ta, tb = eng.add_tenant(), eng.add_tenant(adb)
    rids = {eng.submit(r, max_new_tokens=6,
                       tenant=ta if i % 2 == 0 else tb): i
            for i, r in enumerate(reqs)}
    done = eng.run()
    assert len(eng.adapter_storages) == 1
    return {i: done[rid].tokens for rid, i in rids.items()}


def _alone(s, adapters, reqs, idxs, gen=6, **kw):
    eng = s.engine(max_tenants=1, **kw)
    t = eng.add_tenant(adapters)
    rids = {eng.submit(reqs[i], max_new_tokens=gen, tenant=t): i
            for i in idxs}
    done = eng.run()
    return {i: done[rid].tokens for rid, i in rids.items()}


@pytest.fixture(scope="module")
def tiny_reference():
    """The reference engine's tokens on tiny's mixed pool (paged)."""
    s = setup_of("tiny")
    reqs = _reqs(s.cfg)
    eng = JaxEngine(s.jmodel, jax.tree_util.tree_map(jnp.asarray,
                                                     s.base_np),
                    max_tenants=2, **KW)
    ta = eng.add_tenant()
    tb = eng.add_tenant(jax.tree_util.tree_map(jnp.asarray,
                                               s.adapter_np(7)))
    rids = {eng.submit(r, max_new_tokens=6,
                       tenant=ta if i % 2 == 0 else tb): i
            for i, r in enumerate(reqs)}
    done = eng.run()
    return {i: done[rid].tokens for rid, i in rids.items()}


@pytest.mark.parametrize("arch", ["tiny", "deepseek-v3-671b"])
@pytest.mark.parametrize("paging", ["on", "off"])
def test_mixed_tenants_equal_each_tenant_alone(arch, paging, request):
    s = setup_of(arch)
    adb = s.adapter(7)
    reqs = _reqs(s.cfg)
    mixed = _mixed(s, adb, reqs, paging=paging)
    alone = {**_alone(s, None, reqs, [0, 2, 4], paging=paging),
             **_alone(s, adb, reqs, [1, 3, 5], paging=paging)}
    assert mixed == alone
    single = s.engine(paging=paging)
    rid0, rid1 = (single.submit(reqs[i], max_new_tokens=6) for i in (0, 1))
    sd = single.run()
    assert mixed[0] == sd[rid0].tokens  # the zero adapter: the base model
    assert mixed[1] != sd[rid1].tokens  # the adapter changes the output
    if arch == "tiny":
        assert mixed == request.getfixturevalue("tiny_reference")


@pytest.mark.parametrize("plane", ["paged", "contiguous"])
def test_mla_serve_step_with_tenants_matches_reference(plane):
    """deepseek-v3-reduced: four rows of three tenants (one the zero
    adapter) through 5 decode steps of both packages' serve_step."""
    s = setup_of("deepseek-v3-671b")
    b, steps, nt = 4, 5, 3
    stack = {}
    for path, p in _walk(s.model.spec["lora"]):
        node = stack
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.zeros((p.shape[0], nt) + p.shape[1:],
                                  np.float32)
    for slot, seed in ((1, 7), (2, 11)):
        for path, leaf in zip((p for p, _ in _walk(s.model.spec["lora"])),
                              tree_flatten(s.adapter_np(seed))):
            node = stack
            for k in path:
                node = node[k]
            node[:, slot] = leaf
    tenant = np.array([1, 0, 2, 1], np.int32)
    if plane == "paged":
        jcache = s.jmodel.init_paged_cache(b, 16, num_pages=b * 2,
                                           page_len=8)
        jcache["pt"] = jnp.arange(b * 2, dtype=jnp.int32).reshape(b, 2)
    else:
        jcache = s.jmodel.init_cache(b, 16)
    cache = bridge.cache_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jcache), "cpu")
    jparams = {**jax.tree_util.tree_map(jnp.asarray, s.base_np),
               "lora_stack": jax.tree_util.tree_map(jnp.asarray, stack)}
    params = {**s.params, "lora_stack": bridge.cache_from_numpy(stack,
                                                                "cpu")}
    jstep = jax.jit(s.jmodel.serve_step)
    toks = np.random.default_rng(5).integers(1, s.cfg.vocab_size,
                                             (steps, b, 1)).astype(np.int32)
    for t in range(steps):
        jl, jcache = jstep(jparams, jcache, {"token": jnp.asarray(toks[t]),
                                             "tenant": jnp.asarray(tenant)})
        lg, cache = s.model.serve_step(params, cache, {
            "token": torch.from_numpy(toks[t]),
            "tenant": torch.from_numpy(tenant)})
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="BOTH"):
        s.model.serve_step(s.params, cache, {
            "token": torch.from_numpy(toks[0]),
            "tenant": torch.from_numpy(tenant)})


def test_swap_in_place_one_signature_and_bitwise_crcs():
    s = setup_of("tiny")
    reqs = _reqs(s.cfg, n=4, seed=9)
    eng = s.engine(num_slots=2, max_tenants=3)
    t0 = eng.add_tenant()
    eng.submit(reqs[0], max_new_tokens=4, tenant=t0)
    eng.run()
    ptrs = [t.data_ptr() for t in tree_flatten(eng._adapters)]
    sig = set(eng.adapter_storages)
    adb_np = s.adapter_np(11)
    adb = bridge.cache_from_numpy(adb_np, "cpu")
    t1 = eng.add_tenant(adb)       # onboarding: a copy into the buffer
    eng.update_adapter(t0, adb)    # a hot swap: the same
    for i, t in ((1, t1), (2, t0), (3, t1)):
        eng.submit(reqs[i], max_new_tokens=4, tenant=t)
    eng.run()
    assert eng.adapter_storages == sig and len(sig) == 1
    assert [t.data_ptr() for t in tree_flatten(eng._adapters)] == ptrs
    want = tree_crcs(adb)
    assert eng.adapter_crcs(t1) == want == eng.adapter_crcs(t0)
    # the same bytes the reference checksums, leaf for leaf
    assert want == [jax_leaf_crc32(jnp.asarray(x))
                    for x in jax.tree_util.tree_leaves(adb_np)]
    assert eng.adapter_bytes() == sum(t.numel() * 4 for t in
                                      tree_flatten(eng._adapters))
    assert [tuple(t.shape) for t in tree_flatten(eng.adapter_template())] \
        == [tuple(t.shape) for t in tree_flatten(adb)]


def test_submit_validation():
    s = setup_of("tiny")
    eng = s.engine(num_slots=2, cache_len=32, max_tenants=1)
    with pytest.raises(ValueError, match="unknown tenant"):
        eng.submit([1, 2], max_new_tokens=2, tenant=99)
    t = eng.add_tenant()
    with pytest.raises(ValueError, match="unknown tenant"):
        eng.submit([1, 2], max_new_tokens=2, tenant=None)
    plain = s.engine(num_slots=2, cache_len=32)
    with pytest.raises(ValueError, match="multi-tenant"):
        plain.submit([1, 2], max_new_tokens=2, tenant=t)
    with pytest.raises(ValueError, match="max_tenants"):
        plain.add_tenant()
    m0 = build_model(get_config("tiny"), device="cpu")
    with pytest.raises(ValueError, match="lora_rank"):
        DecodeEngine(m0, s.params, num_slots=2, cache_len=32, max_tenants=1)


# ---------------------------------------------------------------------------
# The lifecycle (tests/test_swap.py).
# ---------------------------------------------------------------------------


def _one(s, adapters, prompt, gen):
    return _alone(s, adapters, [prompt], [0], gen=gen, num_slots=2)[0]


def test_swap_mid_decode_pins_inflight_to_old_version():
    s = setup_of("tiny")
    ad1, ad2 = s.adapter(1), s.adapter(2)
    reqs = synthetic_requests(s.cfg.vocab_size, 2, min_len=4, max_len=6,
                              seed=4)
    eng = s.engine(num_slots=2, max_tenants=3)
    t = eng.add_tenant(ad1)
    r_old = eng.submit(reqs[0], max_new_tokens=10, tenant=t)
    for _ in range(3):
        eng.step()
    eng.update_adapter(t, ad2)  # blue/green: v0 keeps its slot, draining
    r_new = eng.submit(reqs[1], max_new_tokens=10, tenant=t)
    done = eng.run()
    assert done[r_old].tokens == _one(s, ad1, reqs[0], 10)
    assert done[r_new].tokens == _one(s, ad2, reqs[1], 10)
    st = eng.tenant_stats(t)
    assert st["version"] == 1 and st["swaps"] == 1
    assert eng.num_free_adapter_slots == 2


def test_swap_while_queued_routes_to_new_version():
    s = setup_of("tiny")
    ad1, ad2 = s.adapter(1), s.adapter(2)
    prompt = synthetic_requests(s.cfg.vocab_size, 1, min_len=9, max_len=12,
                                seed=6)[0]
    eng = s.engine(num_slots=2, max_tenants=2)
    t = eng.add_tenant(ad1)
    rid = eng.submit(prompt, max_new_tokens=6, tenant=t)
    eng.update_adapter(t, ad2)  # before any dispatch
    assert eng.run()[rid].tokens == _one(s, ad2, prompt, 6)


def test_remove_tenant_drains_inflight_then_recycles_slot():
    s = setup_of("tiny")
    ad = s.adapter(3)
    reqs = synthetic_requests(s.cfg.vocab_size, 3, min_len=3, max_len=6,
                              seed=8)
    eng = s.engine(num_slots=2, max_tenants=1)
    t = eng.add_tenant(ad)
    r0 = eng.submit(reqs[0], max_new_tokens=8, tenant=t)
    r1 = eng.submit(reqs[1], max_new_tokens=8, tenant=t)
    eng.step()
    eng.remove_tenant(t)
    assert eng.tenant_stats(t)["state"] == "retiring"
    with pytest.raises(ValueError, match="retiring"):
        eng.submit(reqs[2], max_new_tokens=2, tenant=t)
    done = eng.run()
    assert done[r0].tokens == _one(s, ad, reqs[0], 8)
    assert done[r1].tokens == _one(s, ad, reqs[1], 8)
    assert eng.tenant_stats(t)["state"] == "removed"
    assert eng.num_free_adapter_slots == 1 and eng.tenants() == []
    assert eng.remove_tenant(t) is None  # idempotent


def test_adapter_slot_exhaustion_defers_fifo_until_drain():
    s = setup_of("tiny")
    ad = s.adapter(5)
    reqs = synthetic_requests(s.cfg.vocab_size, 2, min_len=3, max_len=6,
                              seed=10)
    eng = s.engine(num_slots=2, max_tenants=1)
    t0 = eng.add_tenant()
    t1 = eng.add_tenant(ad)  # no slot: waits
    assert eng.tenant_stats(t1)["state"] == "waiting"
    r0 = eng.submit(reqs[0], max_new_tokens=4, tenant=t0)
    r1 = eng.submit(reqs[1], max_new_tokens=4, tenant=t1)
    eng.run(max_steps=12)  # t0 completes; t1's request holds the queue
    assert r0 in eng.completions() and r1 not in eng.completions()
    assert eng.stats["adapter_slot_deferrals"] > 0
    assert eng.num_pending == 1
    eng.remove_tenant(t0)  # an idle retire frees the slot: t1 admitted
    done = eng.run()
    assert eng.tenant_stats(t1)["state"] == "active"
    assert done[r1].tokens == _one(s, ad, reqs[1], 4)
    t2 = eng.add_tenant()  # a stuck head: an unbounded run raises
    eng.submit(reqs[0], max_new_tokens=2, tenant=t2)
    with pytest.raises(RuntimeError, match="stalled"):
        eng.run()


def test_watcher_installs_verified_publishes_bitwise(tmp_path):
    s = setup_of("tiny")
    d = str(tmp_path / "publish")
    eng = s.engine(num_slots=2, max_tenants=2)
    t = eng.add_tenant()
    w = AdapterWatcher(eng, t, d)
    assert w.poll() is None  # nothing published yet
    ad1 = s.adapter(1)
    save_checkpoint(d, 4, {"lora": ad1})
    got = w.poll()
    assert got is not None and got.step == 4
    assert eng.adapter_crcs(t) == tree_crcs(ad1)
    assert w.poll() is None  # idempotent
    save_checkpoint(d, 8, {"lora": ad1})  # an identical re-publish
    assert w.poll() is None and w.stats["skipped_unchanged"] == 1
    ad2 = s.adapter(2)
    save_checkpoint(d, 12, {"lora": ad2})
    got = w.poll()
    assert got.step == 12 and eng.tenant_stats(t)["version"] == 2
    assert eng.adapter_crcs(t) == tree_crcs(ad2)
    prompt = synthetic_requests(s.cfg.vocab_size, 1, min_len=4, max_len=8,
                                seed=12)[0]
    rid = eng.submit(prompt, max_new_tokens=5, tenant=t)
    assert eng.run()[rid].tokens == _one(s, ad2, prompt, 5)


def test_watcher_ignores_torn_publish(tmp_path):
    s = setup_of("tiny")
    d = tmp_path / "publish"
    eng = s.engine(num_slots=2, max_tenants=1)
    t = eng.add_tenant()
    w = AdapterWatcher(eng, t, str(d))
    save_checkpoint(str(d), 4, {"lora": s.adapter(1)})
    assert w.poll().step == 4
    save_checkpoint(str(d), 8, {"lora": s.adapter(2)})
    shard = next(str(p) for p in sorted((d / "step_00000008").iterdir())
                 if "shard" in p.name)
    with open(shard, "r+b") as f:  # flip bytes mid-shard
        f.seek(max(0, os.path.getsize(shard) // 2))
        f.write(b"\xff\xff\xff\xff")
    assert w.poll() is None  # the torn step never installs
    assert w.installed_step == 4


def test_watcher_refuses_a_publish_without_crcs(tmp_path):
    """A manifest with no per-leaf crc32s verifies structurally, but
    gives nothing to hold the installed slot against: the poll raises
    and installs nothing."""
    s = setup_of("tiny")
    d = str(tmp_path / "publish")
    eng = s.engine(num_slots=2, max_tenants=1)
    t = eng.add_tenant()
    save_checkpoint(d, 4, {"lora": s.adapter(1)})
    path = os.path.join(d, "step_00000004", "manifest.msgpack")
    with open(path, "rb") as f:
        manifest = unpackb(f.read())
    for m in manifest["leaves"]:
        del m["crc32"]
    with open(path, "wb") as f:
        f.write(packb(manifest))
    w = AdapterWatcher(eng, t, d)
    with pytest.raises(RuntimeError, match="no per-leaf crc32s"):
        w.poll()
    assert w.installed_step is None
    assert eng.tenant_stats(t)["version"] == 0


def test_serve_cli_tenants_require_engine_mode(capsys):
    with pytest.raises(SystemExit, match="--mode engine"):
        serve.main(["--arch", "tiny", "--tenants", "2", "--mode", "batch",
                    "--device", "cpu"])
    assert serve.main(["--arch", "tiny", "--tenants", "2", "--batch", "4",
                       "--slots", "2", "--gen", "3", "--prompt-len", "6",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "tenants=2 swaps=0 adapter_storages=1" in out
    assert out.count("# tenant ") == 2
