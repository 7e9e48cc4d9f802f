"""The kernels' build cache (`repro_torch.launch.compile_cache`), on the
CPU: the reference's `tests/test_compile_cache.py` case for case, with
ELF-shaped fake libraries where the reference has compiled executables
and a stand-in compiler (a script that writes one) where it compiles:
the semantic program index, the manifest sweep (adopt, keep, delete a
corrupt or torn library so its next use rebuilds it, drop vanished
records, rebuild a torn manifest, wipe another toolchain's libraries),
`enable()` pointing `kernels._build` at the cache with one rebuild after
a corrupted library and none on a warm start, best effort on a bad root,
and the acceptance bar: a DP train step and the decode engine give
bitwise the same results with the cache on and off."""
import hashlib
import json
import os
import stat
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.launch import compile_cache as cc


@pytest.fixture
def cache_off():
    """Put `_build`'s directory back after the test."""
    yield
    cc.disable()


def _elf(payload: bytes = b"kernel") -> bytes:
    """A 64-bit ELF header, a payload and a two-entry section header
    table at the end, as a linked library lays them out."""
    shoff = 64 + len(payload)
    head = bytearray(64)
    head[:7] = b"\x7fELF\x02\x01\x01"
    struct.pack_into("<Q", head, 0x28, shoff)
    struct.pack_into("<HH", head, 0x3A, 64, 2)
    return bytes(head) + payload + b"\0" * 128


def _fake_lib(dirpath, name, blob=None):
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, name + ".so")
    with open(path, "wb") as fh:
        fh.write(_elf(name.encode()) if blob is None else blob)
    return path


# ---------------------------------------------------------------------------
# Semantic program key / index.
# ---------------------------------------------------------------------------


def test_program_key_stable_and_order_independent():
    a = cc.program_key(entry="train", arch="tiny", mesh="none")
    b = cc.program_key(mesh="none", arch="tiny", entry="train")
    assert a == b
    assert cc.program_key(entry="serve", arch="tiny", mesh="none") != a
    assert cc.program_key(entry="train", arch="tiny", mesh="none",
                          torch_version="0.0.0") != a


def test_record_program_round_trip(tmp_path):
    root = str(tmp_path)
    key = cc.record_program({"entry": "train", "arch": "tiny"}, root=root)
    cc.record_program({"entry": "train", "arch": "tiny"}, root=root)
    cc.record_program({"entry": "serve", "arch": "tiny"}, root=root)
    progs = cc.warmed_programs(root)
    assert progs[key]["runs"] == 2
    assert progs[key]["parts"]["entry"] == "train"
    assert len(progs) == 2


def test_record_program_survives_torn_index(tmp_path):
    root = str(tmp_path)
    os.makedirs(cc.compile_dir(root), exist_ok=True)
    open(os.path.join(cc.compile_dir(root), "programs.json"),
         "w").write("{torn")
    assert cc.record_program({"entry": "train"}, root=root) is not None
    assert len(cc.warmed_programs(root)) == 1


# ---------------------------------------------------------------------------
# Sweep: adopt / keep / drop-corrupt / drop-missing / stale toolchain.
# ---------------------------------------------------------------------------

CLEAN = {"kept": 0, "adopted": 0, "dropped_corrupt": 0, "dropped_missing": 0,
         "wiped_stale_toolchain": 0}


def test_sweep_adopts_then_keeps(tmp_path):
    d = str(tmp_path / "compile")
    _fake_lib(d, "aaa")
    _fake_lib(d, "bbb")
    assert cc.sweep(d) == dict(CLEAN, adopted=2)
    stats = cc.sweep(d)  # idempotent: everything known
    assert stats["kept"] == 2 and stats["adopted"] == 0


def test_sweep_deletes_corrupt_entry_for_warm_rebuild(tmp_path):
    d = str(tmp_path / "compile")
    good = _fake_lib(d, "good")
    bad = _fake_lib(d, "bad")
    cc.sweep(d)
    with open(bad, "ab") as fh:  # bit rot after the manifest was written
        fh.write(b"XXXX")
    stats = cc.sweep(d)
    assert stats["dropped_corrupt"] == 1 and stats["kept"] == 1
    assert not os.path.exists(bad)  # its next load rebuilds it
    assert os.path.exists(good)
    assert cc.sweep(d) == dict(CLEAN, kept=1)  # not double-counted


def test_sweep_never_adopts_torn_entry(tmp_path):
    """A library cut short (or garbage) is never adopted: loading it could
    crash the process. It is deleted, and rebuilds at its next use."""
    d = str(tmp_path / "compile")
    whole = _elf(b"compiled kernel")
    _fake_lib(d, "ok")
    torn = _fake_lib(d, "torn", blob=whole[: len(whole) // 2])
    junk = _fake_lib(d, "junk", blob=b"not an object file at all" * 4)
    stats = cc.sweep(d)
    assert stats["dropped_corrupt"] == 2 and stats["adopted"] == 1
    assert not os.path.exists(torn) and not os.path.exists(junk)
    assert cc.sweep(d) == dict(CLEAN, kept=1)


def test_sweep_drops_vanished_entries(tmp_path):
    d = str(tmp_path / "compile")
    keep = _fake_lib(d, "keep")
    gone = _fake_lib(d, "gone")
    cc.sweep(d)
    os.unlink(gone)
    stats = cc.sweep(d)
    assert stats["dropped_missing"] == 1 and stats["kept"] == 1
    assert os.path.exists(keep)


def test_sweep_rebuilds_torn_manifest_by_adoption(tmp_path):
    d = str(tmp_path / "compile")
    _fake_lib(d, "aaa")
    cc.sweep(d)
    open(os.path.join(d, "manifest.json"), "w").write("{torn json")
    stats = cc.sweep(d)  # never a crash; files re-adopted
    assert stats["adopted"] == 1 and stats["kept"] == 0
    assert cc.sweep(d)["kept"] == 1


def test_sweep_wipes_entries_from_another_toolchain(tmp_path):
    d = str(tmp_path / "compile")
    old = _fake_lib(d, "old")
    # a manifest legitimately written (crc OK) by another toolchain
    payload = {"version": cc.MANIFEST_VERSION,
               "toolchain": dict(cc.toolchain_stamp(), nvcc_version="0.0"),
               "entries": {"old.so": 123}}
    blob = json.dumps(payload, sort_keys=True)
    json.dump({"crc32": zlib.crc32(blob.encode()), **payload},
              open(os.path.join(d, "manifest.json"), "w"))
    stats = cc.sweep(d)
    assert stats["wiped_stale_toolchain"] == 1
    assert not os.path.exists(old)
    _fake_lib(d, "new")  # built by this toolchain: adopted
    assert cc.sweep(d)["adopted"] == 1


# ---------------------------------------------------------------------------
# enable(): the kernels build into the cache; one rebuild after damage.
# ---------------------------------------------------------------------------


def _fake_nvcc(tmp_path) -> str:
    """A stand-in compiler: writes an ELF-shaped library to its -o."""
    path = tmp_path / "nvcc"
    path.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"blob = {_elf(b'built')!r}\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(blob)\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_enable_builds_in_the_cache_and_rebuilds_only_a_corrupt_library(
        tmp_path, monkeypatch, cache_off):
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    # the process's logs and compiler count stay as they were
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    monkeypatch.setattr(_build, "NVCC_RUNS", _build.NVCC_RUNS)
    root = str(tmp_path / "cache")
    assert cc.enable(root) == cc.compile_dir(root)
    assert cc.enabled_dir() == cc.compile_dir(root)
    assert str(_build.build_dir()) == cc.compile_dir(root)
    names = ["clip_reduce", "scale_contract"]
    runs = _build.NVCC_RUNS
    libs = _build.build(names)
    assert _build.NVCC_RUNS - runs == 2  # cold: one compiler a source
    assert all(os.path.dirname(p) == cc.compile_dir(root)
               for p in map(str, libs.values()))
    assert cc.enable(root) is not None
    assert cc.last_sweep() == dict(CLEAN, adopted=2)
    runs = _build.NVCC_RUNS
    _build.build(names)
    assert _build.NVCC_RUNS == runs  # warm: none
    # one flipped byte in one library, written through a rename (a loaded
    # library's pages are never touched)
    bad = str(libs["clip_reduce"])
    blob = bytearray(open(bad, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(bad + ".new", "wb").write(bytes(blob))
    os.replace(bad + ".new", bad)
    cc.enable(root)
    assert cc.last_sweep() == dict(CLEAN, kept=1, dropped_corrupt=1)
    runs = _build.NVCC_RUNS
    _build.build(names)
    assert _build.NVCC_RUNS - runs == 1  # only the corrupt one
    assert cc.sweep(cc.compile_dir(root)) == dict(CLEAN, kept=1, adopted=1)


def test_enable_is_best_effort_on_unwritable_root(tmp_path, cache_off):
    before = _build.build_dir()
    blocker = tmp_path / "flat"
    blocker.write_text("not a directory")
    assert cc.enable(str(blocker)) is None  # degraded, not raised
    assert cc.enabled_dir() is None
    assert _build.build_dir() == before


# ---------------------------------------------------------------------------
# Acceptance: results are BITWISE the same with the cache on and off.
# ---------------------------------------------------------------------------


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().float().numpy().tobytes())
    return h.hexdigest()


def _train_step_digest():
    """A fresh tiny DP train step on the CPU: the updated parameters and
    the loss."""
    from repro_torch.launch import train
    args = train.build_train_parser().parse_args(
        ["--arch", "tiny", "--steps", "1", "--batch", "4", "--seq", "16",
         "--docs", "16", "--device", "cpu"])
    trainer = train.Trainer(args)
    met = trainer.step()
    return _digest([t for _, t in train.trainable(trainer.model,
                                                  trainer.params)]
                   + [met.loss])


def _engine_tokens():
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.inputs import synthetic_requests
    from repro_torch.models.transformer import build_model
    model = build_model(get_config("tiny"), device="cpu")
    params = serve.serve_params(model, 0, "cpu")
    reqs = synthetic_requests(257, 2, min_len=1, max_len=6, seed=7)
    _, done = serve.serve_requests(model, params, reqs, gen=4, num_slots=2,
                                   cache_len=32, page_len=8)
    return [done[r].tokens for r in sorted(done)]


def test_train_step_bitwise_identical_cached_vs_uncached(tmp_path,
                                                         cache_off):
    cold = _train_step_digest()
    assert cc.enable(str(tmp_path)) is not None
    assert _train_step_digest() == cold
    assert cc.enable(str(tmp_path)) is not None  # a warm start
    assert _train_step_digest() == cold


def test_engine_decode_bitwise_identical_cached_vs_uncached(tmp_path,
                                                            cache_off):
    cold = _engine_tokens()
    assert cc.enable(str(tmp_path)) is not None
    assert _engine_tokens() == cold
    assert cc.enable(str(tmp_path)) is not None
    assert _engine_tokens() == cold
    assert all(len(t) == 4 for t in cold)
    assert np.isfinite(np.asarray(cold)).all()


def test_train_cli_records_its_program_and_prints_its_startup(
        tmp_path, capsys, cache_off):
    from repro_torch.kernels import autotune
    from repro_torch.launch import train
    root = str(tmp_path)
    runs = _build.NVCC_RUNS  # this process's, so far
    try:
        for _ in range(2):
            assert train.main(["--arch", "tiny", "--steps", "1", "--batch",
                               "4", "--seq", "16", "--docs", "16",
                               "--device", "cpu", "--cache-dir", root]) == 0
    finally:
        autotune.install(None)
    out = capsys.readouterr().out.splitlines()
    startup = [ln for ln in out if ln.startswith("# startup ")]
    assert len(startup) == 2
    assert all(f"nvcc_runs={runs} " in ln and cc.compile_dir(root) in ln
               for ln in startup)
    (row,) = cc.warmed_programs(root).values()
    assert row["runs"] == 2 and row["parts"]["entry"] == "train"
    assert row["parts"]["torch_version"] == torch.__version__
