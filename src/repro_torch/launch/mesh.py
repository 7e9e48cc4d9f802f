"""Meshes over `torch.distributed`: the counterpart of `repro.launch.mesh`.

The reference builds a `jax.sharding.Mesh` and runs the sharded step as a
`shard_map` body. Here every rank is a process that runs the body itself
(SPMD by processes), and each `jax.lax.psum(x, axes)` of the reference
becomes one SUM `all_reduce` over the process group of those axes. A
`Mesh` holds this rank's coordinates and one process group per axis set
that a psum names: each single axis, the data plane (`pod`, `data`) and
data + model. Every rank creates every group, in the same order.

Ranks are laid out row-major over the axis names, the model axis
fastest, as `jax.make_mesh` orders its devices: rank = d * M + m on a
(data, model) mesh.

Every collective appends a `Collective(site, axes, dtype, numel)` to
the rank's collective log (`Mesh.log`) and its HLO kind name
(all-reduce, all-gather, collective-permute; broadcast for the host's
object broadcast) to `Mesh.kinds`, and `Mesh.trace` keeps the
order of issues, waits and the drivers' marks. They take the place of the
reference's HLO classifier (`analysis/hlo.py:classify_collectives`,
`model_axis_norm_collectives`) for the paper's Sec. 4 contract.
`named_shard_map` has no counterpart: each rank calls the body itself.

Rendezvous goes through a `FileStore` path (`spawn`, or the environment
variable `STORE_ENV`) or `torchrun`'s environment (`env://`), always with
a timeout. The backend is never picked quietly: NCCL takes one rank per
card, and a world larger than the visible cards raises, naming
`--dist-backend gloo`, under which ranks share a card and gloo stages
CUDA tensors through the host itself for all-reduce and all-gather (of
every dtype the drivers send, bf16 among them). gloo sends and receives
only host tensors, so under gloo `isend` / `recv` (the pipeline's
transport) stage a CUDA tensor through the host here: `isend` copies it
to the host (a synchronous copy, complete before gloo reads it) and the
handle keeps that copy alive until `wait()`; `recv` receives into a host
buffer and returns it on the rank's device. That is how ranks sharing one
card run the pipeline, not a fallback: under NCCL nothing is staged.

A mesh of one rank (every axis of size 1) needs no process group: each
of its collectives is the identity, as a psum over a size-1 axis is.

`python -m repro_torch.launch.mesh --nproc N MODULE ARGS...` launches a
CLI (`MODULE.main(ARGS)`, the train CLI or the service) on N ranks of
this host through `spawn` and exits with the launch's code: 0, or the
failed rank's (`RanksFailed.exit_code`), so the service's fault ends it
with 86. torchrun launches the same CLIs but exits 1 when a rank fails,
naming the rank's code only in its error report.
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import math
import os
import sys
import tempfile
import time
import traceback
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

AXIS_ORDER = ("pod", "data", "model")
STORE_ENV = "REPRO_TORCH_DIST_STORE"  # FileStore path set by `spawn`
TIMEOUT_ENV = "REPRO_TORCH_DIST_TIMEOUT"  # process group timeout, seconds
PG_TIMEOUT_S = 60.0

class Collective(NamedTuple):
    """One entry of a rank's collective log."""

    site: str  # the reference's named scope (grad_psum, flat_norm_psum..)
    axes: tuple[str, ...]  # the mesh axes it reduces or moves over
    dtype: str
    numel: int


class _Done:
    """The handle of a collective that needed no communication."""

    def __init__(self, t):
        self._t = t

    def wait(self):
        return self._t


class _Pending:
    """The handle of an asynchronous collective: `wait()` returns its
    tensor (the reduced one, or the buffer a send keeps alive)."""

    def __init__(self, mesh, work, t, label):
        self._mesh, self._work, self._t = mesh, work, t
        self._label = label

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._mesh.trace.append(f"wait {self._label}")
            self._work = None
        return self._t


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


class Mesh:
    """A (data[, pod], model) mesh over the initialised default process
    group: axis names, shape, this rank's coordinates, one process group
    per axis set, the device this rank computes on, and its collective
    log."""

    def __init__(self, shape: dict[str, int], *, device, backend: str):
        names = tuple(a for a in AXIS_ORDER if a in shape)
        if set(shape) - set(names) or "model" not in shape:
            raise ValueError(f"mesh axes {tuple(shape)} are not a subset of "
                             f"{AXIS_ORDER} with a model axis")
        self.axis_names = names
        self.shape = {a: int(shape[a]) for a in names}
        self.size = math.prod(self.shape.values())
        alone = self.size == 1 and not dist.is_initialized()
        world = 1 if alone else dist.get_world_size()
        if world != self.size:
            raise ValueError(f"a {self.describe()} mesh needs {self.size} "
                             f"ranks, the process group has {world}")
        self.rank = 0 if alone else dist.get_rank()
        self.device = torch.device(device)
        self.backend = backend
        self.coords = self._coords(self.rank)
        self.log: list[Collective] = []
        self.kinds: list[str] = []  # each log entry's HLO kind name
        self.trace: list[str] = []
        # checkpoint directories every rank was found to share
        # (`train.check_shared`)
        self.shared_dirs: set[str] = set()
        self._sends: list[str] = []  # isend labels since reset_log
        # one group per axis set a psum names, made in the same order on
        # every rank: each axis, the data plane, data + model
        sets = [(a,) for a in names]
        for s in (data_axes(self), tuple(names)):
            if s and s not in sets:
                sets.append(s)
        self._groups: dict[tuple, tuple[Any, list[int]]] = {}
        for s in sets:
            self._groups[s] = self._make_group(s)

    def describe(self) -> str:
        return "x".join(f"{a}={n}" for a, n in self.shape.items())

    def _coords(self, rank: int) -> dict[str, int]:
        out, rest = {}, rank
        for a in reversed(self.axis_names):
            out[a] = rest % self.shape[a]
            rest //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _make_group(self, axes: tuple):
        """(process group, member ranks in axis order) of the ranks that
        share this rank's coordinates off `axes`. Every rank creates
        every such group (`new_group` is collective over the world)."""
        others = [a for a in self.axis_names if a not in axes]
        mine = None
        size = math.prod(self.shape[a] for a in axes)
        combos = [{}]
        for a in others:
            combos = [dict(c, **{a: i}) for c in combos
                      for i in range(self.shape[a])]
        for c in combos:
            ranks = sorted(r for r in range(self.size)
                           if all(self._coords(r)[a] == v
                                  for a, v in c.items()))
            if size == 1:
                group = None  # no communication over a size-1 axis set
            elif len(ranks) == self.size:
                group = dist.group.WORLD
            else:
                group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = (group, ranks)
        return mine

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(axes) or key not in self._groups:
            raise ValueError(f"no process group over axes {axes} on the "
                             f"{self.describe()} mesh")
        return key

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (`jax.lax.axis_index`)."""
        return self.coords[axis]

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def data_index(self) -> int:
        """This rank's index on the data plane (pod-major), the slot of
        its batch shard."""
        i = 0
        for a in data_axes(self):
            i = i * self.shape[a] + self.coords[a]
        return i

    def _record(self, site, axes, t, kind):
        self.log.append(Collective(site, axes, _dtype_name(t), t.numel()))
        self.kinds.append(kind)

    def psum(self, t: torch.Tensor, axes, *, site: str,
             async_op: bool = False):
        """SUM all-reduce of `t` IN PLACE over the ranks that share this
        rank's coordinates off `axes`; returns `t`, or with `async_op` a
        handle whose `wait()` returns it."""
        axes = self._axes(axes)
        group, _ = self._groups[axes]
        self._record(site, axes, t, "all-reduce")
        label = f"{site}#{len(self.log) - 1}"
        self.trace.append(f"issue {label}")
        if group is None:
            self.trace.append(f"wait {label}")
            return _Done(t) if async_op else t
        work = dist.all_reduce(t, group=group, async_op=async_op)
        if async_op:
            return _Pending(self, work, t, label)
        self.trace.append(f"wait {label}")
        return t

    def all_gather(self, t: torch.Tensor, axes, dim: int, *,
                   site: str) -> torch.Tensor:
        """The pieces of `t` of every rank along `axes`, concatenated
        along `dim` in axis order."""
        axes = self._axes(axes)
        group, ranks = self._groups[axes]
        self._record(site, axes, t, "all-gather")
        self.trace.append(f"issue {site}#{len(self.log) - 1}")
        if group is None:
            return t.clone()
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in ranks]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim)

    def _peer(self, axis: str, index: int) -> int:
        return self.rank_of(dict(self.coords, **{axis: index}))

    def stages(self, t: torch.Tensor) -> bool:
        """Whether point-to-point traffic of `t` goes through the host:
        a CUDA tensor under gloo, which sends and receives host tensors
        only. Never under NCCL."""
        return self.backend == "gloo" and t.is_cuda

    def isend(self, t: torch.Tensor, axis: str, to_index: int, *,
              site: str, tag: int = 0):
        """Start sending `t` to the rank at coordinate `to_index` along
        `axis` (the others equal); returns a handle to `wait()` on, which
        keeps the sent buffer (under gloo, a CUDA tensor's host copy)
        alive."""
        self._record(site, (axis,), t, "collective-permute")
        label = f"{site}#{len(self.log) - 1}"
        self.trace.append(f"issue {label}")
        self._sends.append(label)
        src = t.detach()
        if self.stages(src):
            src = src.cpu()  # synchronous: complete before gloo reads it
        src = src.contiguous()
        work = dist.isend(src, self._peer(axis, to_index), tag=tag)
        return _Pending(self, work, src, label)

    def recv(self, shape, dtype, axis: str, from_index: int, *, site: str,
             tag: int = 0) -> torch.Tensor:
        """A tensor on the rank's device received from the rank at
        `from_index` along `axis` (blocking, matched by `tag`); under gloo
        on a card, received into a host buffer and copied to the card."""
        buf = torch.empty(shape, dtype=dtype, device=self.device)
        self._record(site, (axis,), buf, "collective-permute")
        if self.stages(buf):
            host = torch.empty(shape, dtype=dtype)
            dist.recv(host, self._peer(axis, from_index), tag=tag)
            return buf.copy_(host)
        dist.recv(buf, self._peer(axis, from_index), tag=tag)
        return buf

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank `src`'s picklable `obj` on every rank (a host-side
        broadcast over the whole mesh, site `object_broadcast`): how the
        ranks take one rank's decision."""
        self.log.append(Collective("object_broadcast", self.axis_names,
                                   "object", 1))
        self.kinds.append("broadcast")
        if self.size == 1:
            return obj
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def mark(self, event: str) -> None:
        """Note a driver's event (a contraction, the clip factors) in the
        trace, between the collectives around it."""
        self.trace.append(event)

    def sends_drained(self) -> bool:
        """Whether every `isend` issued since the last `reset_log` was
        waited (each staged copy released)."""
        waited = {e.split(" ", 1)[1] for e in self.trace
                  if e.startswith("wait ")}
        return all(label in waited for label in self._sends)

    def reset_log(self) -> None:
        self.log.clear()
        self.kinds.clear()
        self.trace.clear()
        self._sends.clear()


# ---------------------------------------------------------------------------
# The reference's functions.
# ---------------------------------------------------------------------------


def data_axes(mesh) -> tuple[str, ...]:
    """Mesh axes forming the data-parallel plane."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _current_mesh(shape: dict[str, int]) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed (or run "
                           "under torchrun or mesh.spawn) first")
    return Mesh(shape, device=_DEVICE.get("device", "cpu"),
                backend=dist.get_backend())


def make_debug_mesh(data: int = 2, model: int = 2, *, pod: int = 0) -> Mesh:
    """A small mesh over the current process group (its world must be
    pod * data * model)."""
    shape = {"data": data, "model": model}
    if pod:
        shape = {"pod": pod, **shape}
    return _current_mesh(shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production axis shapes, (data 16, model 16) or
    (pod 2, data 16, model 16), over a world of that size."""
    shape = {"data": 16, "model": 16}
    if multi_pod:
        shape = {"pod": 2, **shape}
    return _current_mesh(shape)


def parse_mesh(arg: str) -> dict[str, int]:
    """'--mesh DxM' -> {"data": D, "model": M}."""
    try:
        d, m = (int(x) for x in arg.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DxM (e.g. 2x2), not {arg!r}")
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {arg}: both sizes must be >= 1")
    return {"data": d, "model": m}


# this process's rank device, set once by `init_process`
_DEVICE: dict[str, torch.device] = {}


def rank_device(device: str, backend: str, local_rank: int,
                local_world: int) -> torch.device:
    """The device of a rank: the CPU (gloo only), or cuda:(local_rank %
    cards). NCCL takes one rank per card: more ranks than visible cards
    raise, naming `--dist-backend gloo`."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"--dist-backend {backend!r} not in (nccl, gloo)")
    if device == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL needs CUDA devices: pass --dist-backend "
                             "gloo with --device cpu")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass --device cpu to run on the CPU)")
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_world > cards:
        raise ValueError(
            f"{local_world} ranks on {cards} visible card(s): NCCL takes one "
            f"rank per card; pass --dist-backend gloo to share cards")
    return torch.device("cuda", local_rank % cards)


def _env_int(name: str, default: int | None = None) -> int:
    v = os.environ.get(name)
    if v is None:
        if default is None:
            raise RuntimeError(f"{name} is not set: run under torchrun "
                               "(python -m torch.distributed.run) or "
                               "repro_torch.launch.mesh.spawn")
        return default
    return int(v)


def init_process(backend: str, device: str, *, store: str | None = None,
                 timeout_s: float | None = None) -> torch.device:
    """Initialise the default process group of this rank (once) from a
    FileStore path (`store`, or $REPRO_TORCH_DIST_STORE) or torchrun's
    environment, with a timeout; returns the rank's device."""
    rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    dev = rank_device(device, backend, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"not the requested {backend}")
    else:
        if timeout_s is None:
            timeout_s = float(os.environ.get(TIMEOUT_ENV, PG_TIMEOUT_S))
        timeout = datetime.timedelta(seconds=timeout_s)
        store = store or os.environ.get(STORE_ENV)
        if store:
            dist.init_process_group(backend, store=dist.FileStore(store, world),
                                    rank=rank, world_size=world,
                                    timeout=timeout)
        else:
            dist.init_process_group(backend, init_method="env://", rank=rank,
                                    world_size=world, timeout=timeout)
    _DEVICE["device"] = dev
    return dev


def init_distributed(mesh_shape: dict[str, int], *, backend: str = "nccl",
                     device: str = "cuda", store: str | None = None,
                     timeout_s: float | None = None) -> Mesh:
    """Join the process group (see `init_process`) and build the mesh of
    `mesh_shape` over it; the world must be its size."""
    world = _env_int("WORLD_SIZE")
    size = math.prod(mesh_shape.values())
    if world != size:
        raise ValueError(f"mesh {mesh_shape} needs {size} ranks, the launch "
                         f"has WORLD_SIZE={world}")
    dev = init_process(backend, device, store=store, timeout_s=timeout_s)
    return Mesh(mesh_shape, device=dev, backend=backend)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# spawn: ranks as child processes, for tests and the smoke run.
# ---------------------------------------------------------------------------


def resolve(qualname: str):
    """'package.module:function' -> the function."""
    mod, _, name = qualname.partition(":")
    fn = importlib.import_module(mod)
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn


def _child(rank, world, qualname, backend, device, pg_timeout_s, store,
           out_dir, args, kwargs, extra_paths):
    sys.path[:0] = [p for p in extra_paths if p not in sys.path]
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world), STORE_ENV: store,
                       TIMEOUT_ENV: str(pg_timeout_s)})
    if device == "cpu":
        torch.set_num_threads(1)  # ranks share the host's cores
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        init_process(backend, device)
        result = ("ok", resolve(qualname)(*args, **kwargs))
    except Exception:  # noqa: BLE001  (the parent raises it)
        result = ("error", traceback.format_exc())
    try:
        torch.save(result, path + ".tmp")
        os.replace(path + ".tmp", path + ".pt")
    finally:
        shutdown()
    if result[0] != "ok":
        os._exit(1)


class RanksFailed(RuntimeError):
    """Spawned ranks exited non-zero. `codes` maps each failed rank to
    its exit code; `exit_code` is the launch's: rank 0's where it failed
    (the rank that writes, whose deliberate exit, such as the service's
    injected fault, takes its peers down with it), else the lowest failed
    rank's."""

    def __init__(self, message: str, codes: dict[int, int]):
        super().__init__(message)
        self.codes = dict(codes)

    @property
    def exit_code(self) -> int:
        return self.codes[min(self.codes)]


def spawn(fn_qualname: str, world: int, *, backend: str = "gloo",
          device: str = "cpu", timeout_s: float = 120.0, store_dir: str,
          args: tuple = (), kwargs: dict | None = None,
          pg_timeout_s: float = PG_TIMEOUT_S,
          extra_paths: tuple[str, ...] = ()) -> list:
    """Run `fn_qualname` ('module:function', importable from `src/` or
    from a directory of `extra_paths`, which each child puts first on its
    `sys.path`) on `world` ranks, each a child process (the `spawn` start method) that
    has joined a process group of `backend` through a FileStore in
    `store_dir`, on `device` (cuda: cuda:(rank % cards)). Returns each
    rank's result, in rank order. A rank's exception fails the call with
    its traceback (the other ranks are killed); so does a rank that dies
    (`RanksFailed`, which carries the exit codes), and the hard join
    timeout `timeout_s` kills every child and raises TimeoutError."""
    if device != "cpu":
        rank_device(device, backend, 0, world)  # refuse before starting
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, "filestore")
    for name in os.listdir(store_dir):  # a FileStore must start empty
        if name == "filestore" or name.startswith("rank"):
            os.remove(os.path.join(store_dir, name))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, daemon=True, args=(
        r, world, fn_qualname, backend, device, pg_timeout_s, store,
        store_dir, tuple(args), dict(kwargs or {}),
        tuple(str(p) for p in extra_paths))) for r in range(world)]
    for p in procs:
        p.start()

    def kill_all():
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)

    def result(r):
        path = os.path.join(store_dir, f"rank{r}.pt")
        if not os.path.exists(path):
            return None
        return torch.load(path, weights_only=False)

    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                kill_all()
                msgs = []
                for r in failed:
                    res = result(r)
                    msgs.append(f"rank {r} exited {codes[r]}" + (
                        f":\n{res[1]}" if res else " without a result"))
                raise RanksFailed("spawned ranks failed:\n" +
                                  "\n".join(msgs),
                                  {r: codes[r] for r in failed})
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                kill_all()
                raise TimeoutError(f"{fn_qualname} on {world} ranks did not "
                                   f"finish within {timeout_s} s")
            time.sleep(0.05)
    finally:
        kill_all()
    out = []
    for r in range(world):
        res = result(r)
        if res is None or res[0] != "ok":
            raise RuntimeError(f"rank {r} left no result" if res is None
                               else f"rank {r} failed:\n{res[1]}")
        out.append(res[1])
    return out


def _run_cli(module: str, argv: list) -> int:
    """A rank of `main`: `module.main(argv)`; a non-zero code ends this
    rank with that code."""
    code = importlib.import_module(module).main(argv) or 0
    if code:
        sys.stdout.flush()
        shutdown()
        os._exit(code)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.mesh",
        description="Run MODULE.main(ARGS) on --nproc ranks of this host "
                    "(launch.mesh.spawn); exit with the launch's code.")
    ap.add_argument("--nproc", type=int, required=True,
                    help="ranks: the product of MODULE's --mesh")
    ap.add_argument("module", help="e.g. repro_torch.launch.service")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    a = ap.parse_args(argv)
    # the ranks join with the CLI's own backend and device
    flags = argparse.ArgumentParser(add_help=False)
    flags.add_argument("--dist-backend", default="nccl")
    flags.add_argument("--device", default="cuda")
    f, _ = flags.parse_known_args(a.args)
    with tempfile.TemporaryDirectory(prefix="mesh-launch-") as store:
        try:
            spawn("repro_torch.launch.mesh:_run_cli", a.nproc,
                  backend=f.dist_backend, device=f.device, store_dir=store,
                  timeout_s=math.inf, args=(a.module, a.args),
                  pg_timeout_s=float(os.environ.get(TIMEOUT_ENV,
                                                    PG_TIMEOUT_S)))
        except RanksFailed as e:
            print(e, file=sys.stderr)
            return e.exit_code
    return 0


if __name__ == "__main__":
    sys.exit(main())
