"""The port stands alone: no file of `src/repro_torch/`, not
`chip_smoke.py` and not the port's examples (`examples/torch_*.py`)
imports `jax` or anything of the `repro` package, and its entry points
default to `cuda` and raise, rather than fall back to the CPU, where there
is no CUDA device."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "src" / "repro_torch").rglob("*.py")) + [
        "chip_smoke.py", "examples/torch_quickstart.py",
        "examples/torch_serve_batched.py", "examples/torch_train_e2e.py",
        "examples/torch_train_service.py", "examples/torch_train_mesh.py",
        "examples/torch_dp_lora_finetune.py",
        "examples/torch_multi_tenant_serve.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse((ROOT / path).read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax_and_no_repro(path):
    bad = [m for m in _imports(path)
           if m and m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_package_is_scanned():
    for name in ("kernels/paged_attn.py", "kernels/ghost_norm.py",
                 "kernels/clip_reduce.py", "kernels/bk.py", "core/bk.py",
                 "launch/sharding.py", "launch/train.py",
                 "launch/service.py", "checkpoint/store.py",
                 "checkpoint/packer.py", "launch/mesh.py",
                 "core/pipeline.py", "core/lora.py", "launch/swap.py",
                 "analysis/__init__.py", "analysis/graph.py",
                 "launch/dryrun.py", "analysis/findings.py",
                 "analysis/taint.py", "analysis/rules.py",
                 "launch/audit.py", "core/scopes.py"):
        assert f"src/repro_torch/{name}" in PORT_FILES
    assert len(PORT_FILES) > 10


def test_build_model_defaults_to_cuda_and_raises_without_it():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import build_model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("tiny"))


def test_serve_cli_defaults_to_cuda_and_raises_without_it():
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    assert serve.build_serve_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "tiny", "--batch", "1", "--gen", "1"])


def test_train_cli_defaults_to_cuda_and_raises_without_it():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    assert train.build_train_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "tiny", "--steps", "1", "--batch", "1",
                    "--docs", "2"])


def test_train_cli_mesh_defaults_to_cuda_and_nccl(monkeypatch):
    """`--mesh` keeps the CLI's device default and NCCL; without a CUDA
    device the rank's device raises before any process group exists."""
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    args = train.build_train_parser().parse_args(["--mesh", "2x2"])
    assert (args.device, args.dist_backend) == ("cuda", "nccl")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "tiny", "--mesh", "2x2"])
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_service_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    from repro_torch.launch import service
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    argv = ["--service-dir", str(tmp_path), "--arch", "tiny", "--steps",
            "1", "--batch", "1", "--docs", "2"]
    assert service.build_service_parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        service.main(argv)
    assert not (tmp_path / "ledger.jsonl").exists()


def test_torch_quickstart_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--steps", "1"], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "step" not in out.stdout


@pytest.mark.parametrize("example,argv", [
    ("torch_train_e2e.py", ["--steps", "1", "--batch", "1", "--docs", "2",
                            "--checkpoint-dir"]),
    ("torch_train_service.py", ["--service-dir"]),
    ("torch_train_mesh.py", ["--steps", "1", "--checkpoint-dir"]),
])
def test_torch_train_examples_default_to_cuda_and_raise_without_it(
        example, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / example), *argv,
         str(tmp_path / "out")],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "step " not in out.stdout


def test_torch_serve_example_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_serve_batched.py")],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "tokens over" not in out.stdout


@pytest.mark.parametrize("example,marker", [
    ("torch_dp_lora_finetune.py", "LoRA params"),
    ("torch_multi_tenant_serve.py", "tenant A trained")])
def test_torch_lora_examples_default_to_cuda_and_raise_without_it(
        example, marker):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / example), "--steps", "1"]
        if example == "torch_dp_lora_finetune.py"
        else [sys.executable, str(ROOT / "examples" / example)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert marker not in out.stdout


def test_torch_multi_tenant_example_on_cpu(tmp_path):
    """Two services (epsilon 2 and 8) publish, one engine serves both,
    a hot swap lands mid-traffic, bit for bit, at tiny size."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" /
                             "torch_multi_tenant_serve.py"),
         "--device", "cpu", "--work-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert ("(read back equal to its manifest's crcs); in-flight requests "
            "drain") in out.stdout
    assert "swaps=3 adapter_storages=1" in out.stdout
    assert (tmp_path / "tenant-b" / "publish" / "step_00000012").is_dir()


def test_torch_serve_example_on_cpu():
    # one intra-op thread: beside the other test workers, a process that
    # spins up a thread per core runs its many small ops ~100x slower
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_serve_batched.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr
    rows = [ln for ln in out.stdout.splitlines() if "tokens over" in ln]
    assert len(rows) == 4 and all("4/4 as alone" in ln for ln in rows)
    assert sum("contiguous" in ln for ln in rows) == 2


def test_importing_the_port_builds_nothing():
    import repro_torch.launch.train  # noqa: F401  (imports every module)
    from repro_torch.kernels import _build, launch_counts
    assert _build.BUILD_LOGS == {} and _build._LIBS == {}
    assert set(launch_counts()) == {"paged_attn", "ghost_norm",
                                    "ghost_norm_blocked", "clip_reduce",
                                    "scale_contract", "fused_norm_clip"}
    assert set(_build.sources()) == set(launch_counts())


def test_dryrun_cli_defaults_to_cuda_and_raises_without_it():
    from repro_torch.launch import dryrun
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    assert dryrun.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_one("qwen3-4b", "train_4k", "debug", debug=True,
                       save=False)
