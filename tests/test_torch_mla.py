"""The port's MLA attention against the JAX package, on the CPU in f32.

The same numpy-seeded parameters and inputs go through both packages
(deepseek-v3-671b-reduced, with its q LoRA and with a direct q
projection):

* `mla_spec` against the reference's (paths, shapes, inits, stack dims);
* `mla_attention`, the full-sequence form, against the reference's;
* `mla_decode_paged` step by step through a scattered page table against
  the port's own `mla_attention` at every position (the reference's
  `test_mla_decode_matches_prefill`, on the paged plane);
* `mla_decode_paged` against the reference's, inactive rows, a retired
  row and trash-mapped table tails included: the output and every pool
  row. The reference runs its XLA gather route, its plain version: its
  Pallas route hands the 3-D latent pool to a kernel whose BlockSpecs
  are 4-D, which Pallas refuses.

Tolerance: f32 atol = rtol = 1e-4 (XLA and torch sum in other orders;
the absorbed and the materialized forms group the products differently).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.spec import GroupLayout as JaxLayout
from repro.core.spec import _walk as jax_walk
from repro.kernels import backend as jax_backend
from repro.models import attention as JA
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import spec as S
from repro_torch.models import attention as A

TOL = dict(rtol=1e-4, atol=1e-4)
Q_LORA = pytest.mark.parametrize("q_lora", [64, 0], ids=["q_lora", "direct_q"])


def _cfgs(q_lora):
    """(port cfg, reference cfg): deepseek-v3-671b-reduced, its q LoRA rank
    replaced by `q_lora` (0: the direct q projection)."""
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", reduced=True),
                              q_lora_rank=q_lora)
    jcfg = dataclasses.replace(
        jax_get_config("deepseek-v3-671b", reduced=True), q_lora_rank=q_lora)
    return cfg, jcfg


def _params(cfg, jcfg, seed=0):
    """One numpy parameter tree of `mla_spec`, in both packages."""
    tree = bridge.numpy_params(A.mla_spec(cfg), seed)
    tparams = jax.tree_util.tree_map(lambda a: bridge.tensor_from_numpy(
        a, "cpu"), tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return tparams, jparams, JaxLayout(JA.mla_spec(jcfg))


def _inf_th(layout, b):
    return {g.name: jnp.full((b,), jnp.inf) for g in layout.groups}


def _x(cfg, b, t, seed=1):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((b, t, cfg.d_model))).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@Q_LORA
def test_mla_spec_matches_reference(q_lora):
    cfg, jcfg = _cfgs(q_lora)
    for stack in ((), (3,)):
        want = {"/".join(p): (v.shape, v.init, v.stack)
                for p, v in jax_walk(JA.mla_spec(jcfg, stack=stack))}
        got = {"/".join(p): (v.shape, v.init, v.stack)
               for p, v in S._walk(A.mla_spec(cfg, stack=stack))}
        assert got == want
    assert ("q_a/w" in got) == bool(q_lora)
    assert ("q/w" in got) == (not q_lora)


@Q_LORA
def test_mla_attention_matches_reference(q_lora):
    cfg, jcfg = _cfgs(q_lora)
    tparams, jparams, layout = _params(cfg, jcfg)
    b, t = 2, 7
    x = _x(cfg, b, t)
    rng = np.random.default_rng(2)
    pos = np.sort(rng.integers(0, 50, size=(b, t)), axis=1).astype(np.int32)
    want = JA.mla_attention(jcfg, jparams, jnp.asarray(x),
                            _inf_th(layout, b), jnp.asarray(pos))
    got = A.mla_attention(cfg, tparams, torch.from_numpy(x),
                          torch.from_numpy(pos))
    assert got.shape == (b, t, cfg.d_model)
    _close(got, want)


def _scattered_table(b, p_tab, num_pages, seed):
    """Each row's pages drawn without replacement from the pool."""
    perm = np.random.default_rng(seed).permutation(num_pages)
    return perm[: b * p_tab].reshape(b, p_tab).astype(np.int32)


@Q_LORA
def test_mla_decode_paged_matches_full_attention(q_lora):
    """Decoding the tokens one by one through a paged latent pool gives the
    full-sequence causal MLA output at every position."""
    cfg, jcfg = _cfgs(q_lora)
    tparams, _, _ = _params(cfg, jcfg)
    b, t, page_len, p_tab = 2, 9, 4, 3
    num_pages = 8
    x = torch.from_numpy(_x(cfg, b, t))
    positions = torch.arange(t, dtype=torch.int32)[None].expand(b, t)
    full = A.mla_attention(cfg, tparams, x, positions)
    latpool = torch.zeros((num_pages + 1, page_len,
                           cfg.kv_lora_rank + cfg.qk_rope_head_dim))
    pt = torch.from_numpy(_scattered_table(b, p_tab, num_pages, 3))
    for i in range(t):
        out = A.mla_decode_paged(cfg, tparams, x[:, i:i + 1], latpool, pt,
                                 torch.full((b,), i, dtype=torch.int32))
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, i].numpy(),
                                   **TOL)
    assert not torch.any(latpool[-1])  # no active row wrote to the trash


@Q_LORA
def test_mla_decode_paged_matches_reference(q_lora):
    """One decode step from an identical random pool state, with two
    inactive rows (one retired at the end of its capacity): the output of
    every active row and every pool row but the trash page agree."""
    cfg, jcfg = _cfgs(q_lora)
    tparams, jparams, layout = _params(cfg, jcfg)
    b, page_len, p_tab, num_pages = 4, 4, 3, 12
    rng = np.random.default_rng(5)
    lat = rng.standard_normal(
        (num_pages + 1, page_len, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    ).astype(np.float32)
    pos = np.array([0, 6, 9, p_tab * page_len], np.int32)  # last: retired
    pt = _scattered_table(b, p_tab, num_pages, 6)
    for i in range(b - 1):
        pt[i, pos[i] // page_len + 1:] = num_pages  # trash-mapped tail
    active = np.array([True, True, False, False])
    x = _x(cfg, b, 1, seed=7)

    with jax_backend.scoped("xla"):
        want, want_pool = JA.mla_decode_paged(
            jcfg, jparams, jnp.asarray(x), _inf_th(layout, b),
            jnp.asarray(lat), jnp.asarray(pt), jnp.asarray(pos),
            active=jnp.asarray(active))
    latpool = torch.from_numpy(lat.copy())
    got = A.mla_decode_paged(cfg, tparams, torch.from_numpy(x), latpool,
                             torch.from_numpy(pt), torch.from_numpy(pos),
                             active=torch.from_numpy(active))
    _close(got[active], np.asarray(want)[active])
    _close(latpool[:-1], np.asarray(want_pool)[:-1])
    changed = np.any(latpool[:-1].numpy() != lat[:-1], axis=(1, 2))
    assert changed.sum() == 2  # the two active rows' pages, nothing else
