"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C entry point. It is compiled with
`nvcc` for `sm_90a` into `<name>-<source hash>.so` in the build directory
at first use, and loaded with `ctypes`. The directory is the compile
cache's (`launch.compile_cache`): `<repo>/.cache/compile`, or
`$REPRO_CACHE_DIR/compile`, unless `set_build_dir` moved it (`--cache-dir`
of the CLIs), so every process of a checkout shares one build of each
source. The hash covers the source and every shared header `csrc/*.cuh`,
so a changed source or header gets a new file name and a stale library is
never loaded. Nothing is built when a module is imported: the CPU tests
import every module and this machine may have no `nvcc`. `NVCC_RUNS`
counts the compilers this process started.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills) of each fresh build
BUILD_LOGS: dict[str, str] = {}
NVCC_RUNS = 0  # nvcc processes started by this process
_build_dir: pathlib.Path | None = None  # set_build_dir's, else the default


def repo_cache_root(override: str | None = None) -> str:
    """Repo-local cache root: <repo>/.cache (REPRO_CACHE_DIR overrides):
    the autotune tables under `autotune/` (`kernels.autotune`), the
    kernels' builds under `compile/` (`launch.compile_cache`)."""
    if override:
        return override
    env = os.environ.get("REPRO_CACHE_DIR")
    if env:
        return env
    # src/repro_torch/kernels -> the checkout's root
    return str(pathlib.Path(__file__).resolve().parents[3] / ".cache")


def build_dir() -> pathlib.Path:
    """Where the libraries are built and loaded from."""
    if _build_dir is not None:
        return _build_dir
    return pathlib.Path(repo_cache_root()) / "compile"


def set_build_dir(path) -> None:
    """Build and load the libraries under `path` from now on (None: the
    default). A library already loaded stays loaded."""
    global _build_dir
    _build_dir = None if path is None else pathlib.Path(path)


def sources() -> list[str]:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def source_digest() -> str:
    """sha256 over every kernel source and shared header (names and
    bytes) and the compiler flags: what a library's name hashes, for all
    of them at once."""
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode() + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build(names: list[str] | None = None) -> dict[str, pathlib.Path]:
    """Compile the named kernels (default: all), one `nvcc` per source,
    all started together. Raises RuntimeError with the compiler's output
    if any build fails. Returns name -> library path."""
    global NVCC_RUNS
    names = sources() if names is None else names
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
        NVCC_RUNS += 1
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic publish
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib
