"""The port's checkpoint store (`repro_torch.checkpoint`) on the CPU.

* Round trips of the port's trees (bf16, f32, int32 tensors, the Python
  ints and floats of its optimizer / DP / quantile states, None subtrees)
  bitwise, under both codecs and with leaves spread over many shards and
  16 MiB pieces;
* crash safety: a torn shard raises `CheckpointCorrupt` under
  `verify=True`, `load_latest_checkpoint` walks back past a corrupt step,
  orphan `tmp-` stages are invisible, a re-publish swaps atomically, the
  fault hook's stages fire in order;
* the format's pieces: the manifest packer gives `msgpack.packb`'s bytes
  and reads them; `crc32_combine` and the parallel zlib stream against
  zlib itself;
* the JAX package's store: a reference checkpoint of a tiny {"params",
  "opt_state", "dp_state"} loads into the port's template bit for bit, and
  the port's checkpoint of the same (bridged) state has the reference's
  per-leaf crc32 list and loads in the reference; the quantile export and
  the incremental accountant against the reference's.

Tolerances: the bytes are exact; the accountant 1e-12 (a numpy copy).
"""
import json
import os
import zlib

import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JCK
from repro.core import accounting as JACC
from repro.core import dp_sgd as JDP
from repro.core import quantile as JQ
from repro.optim import optimizers as JOPT
from repro_torch import bridge
from repro_torch.checkpoint import packer
from repro_torch.checkpoint import store as S
from repro_torch.configs import get_config
from repro_torch.core import accounting as ACC
from repro_torch.core import quantile as Q
from repro_torch.core.dp_sgd import DPState
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizers import AdamState, SGDState

CODECS = ["zlib"] + (["zstd"] if S.zstd is not None else [])


def port_state(seed: int, dtype=torch.float32, momentum=True):
    """A tiny training state of the port with every kind of leaf: tensor
    params and moments, Python int counters and quantile floats, and (SGD
    without momentum) a None subtree."""
    spec = build_model(get_config("tiny"), device="cpu").spec
    params = bridge.train_params_from_numpy(bridge.numpy_params(spec, seed),
                                            "cpu")
    params = {k: _cast(v, dtype) for k, v in params.items()}
    rng = np.random.default_rng(seed + 1)

    def like(tree):
        return {k: like(v) if isinstance(v, dict) else
                torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                 .astype(np.float32)).to(v.dtype)
                for k, v in tree.items()}

    opt = (AdamState(7, like(params), like(params)) if momentum
           else SGDState(3, None))
    q = Q.init_quantile_state(rng.uniform(0.5, 2.0, 15), target_quantile=0.4,
                              lr=0.3, sigma_b=12.345)
    return {"params": params, "opt_state": opt, "dp_state": DPState(q, 7)}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.detach().to(dtype).requires_grad_()


def assert_bitwise(a, b):
    la, lb = S.tree_flatten(a), S.tree_flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.requires_grad == y.requires_grad
            assert torch.equal(x.detach().view(-1).view(torch.uint8),
                               y.detach().view(-1).view(torch.uint8))
        else:
            assert x == y


@pytest.fixture(params=CODECS)
def codec(request, monkeypatch):
    """The store's codec: zstd where zstandard is installed, else zlib."""
    if request.param == "zlib":
        monkeypatch.setattr(S, "zstd", None)
    return request.param


@pytest.mark.parametrize("dtype,momentum,shard_bytes", [
    (torch.float32, True, S._SHARD_BYTES),   # one shard
    (torch.bfloat16, True, 20_000),          # many shards, big leaves alone
    (torch.float32, False, 1),               # a leaf a shard; a None subtree
])
def test_round_trip_is_bitwise(tmp_path, codec, dtype, momentum,
                               shard_bytes, monkeypatch):
    monkeypatch.setattr(S, "_PIECE", 4096)  # many pieces a leaf
    tree = port_state(3, dtype, momentum)
    S.save_checkpoint(str(tmp_path), 5, tree, shard_bytes=shard_bytes,
                      meta={"sampler": {"draws": 5}})
    out = S.load_checkpoint(str(tmp_path), 5, tree, verify=True)
    assert_bitwise(tree, out)
    assert isinstance(out["opt_state"], type(tree["opt_state"]))
    m = S.load_manifest(str(tmp_path), 5)
    assert m["codec"] == codec and m["step"] == 5 and m["treedef"] is None
    assert m["meta"] == {"sampler": {"draws": 5}}
    assert m["num_shards"] == len(set(x["shard"] for x in m["leaves"]))
    assert S.manifest_crcs(str(tmp_path), 5) == S.tree_crcs(tree)
    # the Python scalars are the reference's 0-d int32 / float32 leaves
    dp = m["leaves"][:5]  # dp_state: thresholds, target_quantile, lr,
    assert [x["dtype"] for x in dp] == ["float32"] * 4 + ["int32"]
    assert [x["shape"] for x in dp[1:]] == [[]] * 4
    assert S.verify_checkpoint(str(tmp_path), 5)


def test_meta_template_restores_onto_a_device(tmp_path):
    """A template on the meta device takes no memory; `device` places the
    leaves (the train CLI's and the service's resume)."""
    tree = port_state(4)
    S.save_checkpoint(str(tmp_path), 1, tree)
    meta = S.tree_unflatten(tree, [
        x.to("meta") if isinstance(x, torch.Tensor) else x
        for x in S.tree_flatten(tree)])
    out = S.load_checkpoint(str(tmp_path), 1, meta, device="cpu")
    assert_bitwise(tree, out)


def test_template_mismatch_raises(tmp_path):
    tree = port_state(4)
    S.save_checkpoint(str(tmp_path), 1, tree)
    bad = port_state(4, torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit"):
        S.load_checkpoint(str(tmp_path), 1, bad)
    with pytest.raises(ValueError, match="leaves"):
        S.load_checkpoint(str(tmp_path), 1, {"params": tree["params"]})


def _corrupt_one_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _shards(directory, step):
    d = os.path.join(directory, f"step_{step:08d}")
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.startswith("shard_"))


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_torn_shard_raises_under_verify(tmp_path, codec, damage):
    tree = port_state(5)
    S.save_checkpoint(str(tmp_path), 2, tree)
    shard = _shards(str(tmp_path), 2)[0]
    if damage == "flip":
        _corrupt_one_byte(shard)
    else:
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) // 2)
    assert not S.verify_checkpoint(str(tmp_path), 2)
    with pytest.raises(S.CheckpointCorrupt):
        S.load_checkpoint(str(tmp_path), 2, tree, verify=True)


def test_latest_walks_back_past_a_corrupt_step(tmp_path):
    d = str(tmp_path)
    old, new = port_state(6), port_state(7)
    S.save_checkpoint(d, 3, old)
    S.save_checkpoint(d, 6, new)
    step, tree, manifest = S.load_latest_checkpoint(d, old)
    assert step == 6 and manifest["step"] == 6
    assert_bitwise(new, tree)
    _corrupt_one_byte(_shards(d, 6)[-1])
    assert S.latest_step(d) == 6 and S.latest_verified_step(d) == 3
    step, tree, _ = S.load_latest_checkpoint(d, old)
    assert step == 3
    assert_bitwise(old, tree)
    # an unreadable manifest is corrupt too
    with open(os.path.join(d, "step_00000003", "manifest.msgpack"),
              "wb") as f:
        f.write(b"\xc1garbage")
    assert S.load_latest_checkpoint(d, old) is None
    assert S.latest_verified_step(d) is None


def test_orphan_stage_is_invisible(tmp_path):
    d = str(tmp_path)
    tree = port_state(8)

    def die(stage):
        if stage == "pre-rename":
            raise KeyboardInterrupt  # a kill between staging and publish

    with pytest.raises(KeyboardInterrupt):
        S.save_checkpoint(d, 4, tree, fault_hook=die)
    assert any(n.startswith("tmp-step_00000004") for n in os.listdir(d))
    assert S.all_steps(d) == [] and S.latest_step(d) is None
    assert S.load_latest_checkpoint(d, tree) is None
    # the next save of the step rebuilds the leftover stage
    S.save_checkpoint(d, 4, tree)
    assert S.all_steps(d) == [4]
    assert not any(n.startswith("tmp-") for n in os.listdir(d))


def test_republish_swaps_atomically(tmp_path, monkeypatch):
    d = str(tmp_path)
    first, second = port_state(9), port_state(10)
    S.save_checkpoint(d, 2, first)
    seen = []
    real_replace = os.replace

    def replace(src, dst):
        # at every instant a complete step_2 exists (old or new)
        seen.append((os.path.basename(src), os.path.basename(dst)))
        real_replace(src, dst)
        if os.path.isdir(os.path.join(d, "step_00000002")):
            assert S.verify_checkpoint(d, 2)

    monkeypatch.setattr(os, "replace", replace)
    S.save_checkpoint(d, 2, second)
    assert [s for s, _ in seen] == ["step_00000002",
                                    f"tmp-step_00000002-{os.getpid()}"]
    assert seen[0][1].startswith("tmp-old_00000002")
    assert sorted(os.listdir(d)) == ["step_00000002"]
    assert_bitwise(second, S.load_checkpoint(d, 2, first, verify=True))


def test_fault_hook_stages_fire_in_order(tmp_path):
    stages = []
    S.save_checkpoint(str(tmp_path), 1, port_state(11),
                      fault_hook=stages.append)
    assert stages == ["pre-stage", "pre-rename", "post-rename"]


@pytest.mark.parametrize("value", [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, -1.5, 3.141592653589793, 1e300, "", "a" * 31,
    "b" * 32, "é" * 200, "c" * 70000, b"", b"\x00" * 300, b"x" * 70000,
    [], list(range(15)), list(range(16)), list(range(70000)),
    {}, {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
    {"codec": "zlib", "treedef": None, "num_shards": 2,
     "leaves": [{"shape": [36, 2560], "dtype": "bfloat16", "shard": 0,
                 "bytes": 184320, "crc32": 4294967295}],
     "step": 8, "meta": {"sampler": {"rng": json.dumps({"s": [1, 2]}),
                                     "rate": 0.0625}, "eps": None}},
])
def test_packer_matches_msgpack(value):
    blob = packer.packb(value)
    assert blob == msgpack.packb(value)
    assert packer.unpackb(blob) == msgpack.unpackb(blob)
    assert packer.unpackb(msgpack.packb(value)) == msgpack.unpackb(
        msgpack.packb(value))


def test_packer_reads_msgpack_float32_and_rejects_the_rest():
    blob = msgpack.packb({"x": 1.5, "t": (1, 2)}, use_single_float=True)
    assert packer.unpackb(blob) == {"x": 1.5, "t": [1, 2]}
    with pytest.raises(TypeError):
        packer.packb({"x": object()})
    with pytest.raises(ValueError):
        packer.unpackb(msgpack.packb(1) + b"\x00")


def test_crc32_combine_and_zlib_stream_match_zlib(monkeypatch):
    rng = np.random.default_rng(0)
    parts = [rng.bytes(n) for n in (0, 1, 1000, 4096, 33333)]
    whole = b"".join(parts)
    assert S._combined_crc((zlib.crc32(p), len(p)) for p in parts) \
        == zlib.crc32(whole)
    # a leaf checksummed in pieces: the piece size changes nothing
    x = torch.from_numpy(rng.standard_normal(10_000).astype(np.float32))
    monkeypatch.setattr(S, "_PIECE", 1000)
    assert S.leaf_crc32(x) == zlib.crc32(x.numpy().tobytes())
    # the parallel deflate pieces make one zlib stream, as the reference
    # reads it
    out = [S._deflate_piece(np.frombuffer(p, np.uint8), i == len(parts) - 1)
           for i, p in enumerate(parts)]
    adler = 1
    for (_, a), p in zip(out, parts):
        adler = S._adler32_combine(adler, a, len(p))
    assert adler == zlib.adler32(whole)
    stream = S._ZLIB_HEADER + b"".join(d for d, _ in out) + \
        adler.to_bytes(4, "big")
    assert zlib.decompress(stream) == whole


# ---------------------------------------------------------------------------
# Against the JAX package's store.
# ---------------------------------------------------------------------------


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.detach().numpy()


def reference_state(tree):
    """The port's state in the JAX package's types (leaf for leaf)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return jnp.asarray(_np(t))

    opt = tree["opt_state"]
    qs, step = tree["dp_state"]
    jq = JQ.QuantileState(jnp.asarray(_np(qs.thresholds)),
                          jnp.float32(qs.target_quantile), jnp.float32(qs.lr),
                          jnp.float32(qs.sigma_b))
    return {"params": conv(tree["params"]),
            "opt_state": JOPT.AdamState(jnp.int32(opt.step), conv(opt.mu),
                                        conv(opt.nu)),
            "dp_state": JDP.DPState(jq, jnp.int32(step))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_checkpoint_loads_bitwise(tmp_path, dtype):
    tree = port_state(12, dtype)
    ref = reference_state(tree)
    JCK.save_checkpoint(str(tmp_path), 3, ref, meta={"sampler": {"a": 1}})
    template = port_state(13, dtype)
    step, out, manifest = S.load_latest_checkpoint(str(tmp_path), template)
    assert step == 3 and manifest["meta"] == {"sampler": {"a": 1}}
    assert_bitwise(tree, out)
    assert S.manifest_crcs(str(tmp_path), 3) == S.tree_crcs(tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_checkpoint_loads_in_the_reference(tmp_path, codec, dtype):
    tree = port_state(14, dtype)
    ref = reference_state(tree)
    d = str(tmp_path)
    S.save_checkpoint(d, 4, tree, shard_bytes=30_000,
                      meta={"sampler": {"draws": 4}})
    assert S.load_manifest(d, 4)["codec"] == codec
    assert S.manifest_crcs(d, 4) == JCK.manifest_crcs(d, 4) == [
        JCK.leaf_crc32(x) for x in jax_leaves(ref)]
    assert JCK.verify_checkpoint(d, 4)
    assert JCK.load_manifest(d, 4) == S.load_manifest(d, 4)
    step, out, _ = JCK.load_latest_checkpoint(d, ref)
    assert step == 4
    for x, y in zip(jax_leaves(out), jax_leaves(ref)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def jax_leaves(tree):
    import jax
    return jax.tree_util.tree_leaves(tree)


def test_quantile_export_matches_reference():
    thr = np.random.default_rng(2).uniform(0.1, 3.0, 9).astype(np.float32)
    for tq, lr, sb in [(0.5, 0.3, 10.0), (0.4, 0.3, 57.123456789),
                       (0.9, 0.2, 0.0)]:
        ps = Q.init_quantile_state(thr, target_quantile=tq, lr=lr,
                                   sigma_b=sb)
        js = JQ.init_quantile_state(thr, target_quantile=tq, lr=lr,
                                    sigma_b=sb)
        exp = Q.export_state(ps)
        assert json.dumps(exp) == json.dumps(JQ.export_state(js))
        back = Q.restore_state(exp)
        assert back == ps._replace(thresholds=back.thresholds)
        assert torch.equal(back.thresholds, ps.thresholds)
        assert Q.export_state(Q.restore_state(JQ.export_state(js))) == exp


def test_accountant_matches_reference():
    rng = np.random.default_rng(3)
    mechs = [(float(rng.uniform(1e-3, 0.3)), float(rng.uniform(0.5, 3.0)))
             for _ in range(4)]
    pa, ja = ACC.RdpAccountant(), JACC.RdpAccountant()
    records = []
    for i in range(40):
        q, sigma = mechs[i % len(mechs)] if i % 7 else mechs[0]
        for delta in (1e-5, 1e-7):
            assert abs(pa.peek(q, sigma, delta)
                       - ja.peek(q, sigma, delta)) <= 1e-12
        pa.spend(q, sigma)
        ja.spend(q, sigma)
        records.append({"q": q, "sigma": sigma})
        assert pa.steps == ja.steps == i + 1
        assert abs(pa.epsilon(1e-5) - ja.epsilon(1e-5)) <= 1e-12
    np.testing.assert_allclose(pa.rdp(), ja.rdp(), rtol=0, atol=1e-12)
    assert ACC.DEFAULT_ORDERS == JACC.DEFAULT_ORDERS
    _, eps = ACC.replay_ledger(records, 1e-5)
    assert abs(eps - JACC.replay_ledger(records, 1e-5)[1]) <= 1e-12
    assert ACC.RdpAccountant().epsilon(1e-5) == 0.0
    with pytest.raises(ValueError):
        ACC.RdpAccountant(orders=())
