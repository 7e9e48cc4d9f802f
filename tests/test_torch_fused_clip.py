"""The port's fused norm + clip + reduce (`fused_norm_clip`) and its route
in the `kernels` engine, against the JAX package.

* `fused_norm_clip_ref` against the reference's Pallas kernel in
  interpret mode (bt = 32, as `tests/test_kernels.py`) and against
  `repro.kernels.ref.fused_norm_clip_ref`: ragged T, T = 1, dout past one
  128-lane tile, `extra` None and given, the four encodings of c (clip,
  +inf, direct scale, and all three mixed), f32 and bf16 inputs;
* on a CPU tensor the wrapper is its plain version and counts no launch;
  its input checks refuse what the kernel does not take;
* `KernelsBackend.linear_clip` takes the fused route exactly where the
  reference's `PallasBackend._fused_fits` passes, over every linear shape
  of qwen3-4b, granite-moe-3b-a800m and their reduced configs, and only
  when norms are asked for;
* the composed route (the fit rule patched off) gives the same answer;
* on a Hopper card (`-m cuda`; skipped elsewhere) the kernel against its
  plain version, up to B = 16,384 (past the first kernel's limit) and B =
  1024 at the route rule's 1024 x 1024 limit with extra memory within
  the plan's scratch; two calls bitwise equal; a CUDA-graph replay, twice,
  bitwise equal to the eager call; one device kernel a call; the C plan
  equal to `fused_clip.plan`.

Tolerances: f32, the same math summed in another order: rtol 1e-5, and
for dW an atol of 1e-5 of its largest magnitude (entries near zero).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import backend as jax_backend
from repro.kernels import ref as JREF
from repro.kernels.fused_clip import fused_norm_clip as jax_fused
from repro_torch.configs import get_config
from repro_torch.core import dp_layers as DP
from repro_torch.core import spec as S
from repro_torch.kernels import backend
from repro_torch.kernels import clip_reduce as CR
from repro_torch.kernels import fused_clip as FC
from repro_torch.kernels import ghost_norm as GN
from repro_torch.models.transformer import build_model

T = torch.from_numpy
INF = np.inf
# B, T, din, dout: ragged T against the reference's 32-row tiles, T = 1,
# dout past one 128-lane tile, din and dout off the port's 64-wide tiles
CASES = [(2, 8, 16, 24), (3, 70, 48, 40), (1, 130, 36, 140), (4, 1, 20, 7),
         (2, 33, 65, 130)]
# the four encodings: clip, +inf, direct scale, mixed
ENCODINGS = {"clip": [0.5, 0.01], "inf": [INF], "scale": [-0.7, -2.0],
             "mixed": [0.5, INF, -0.7, 0.01]}


def _inputs(b, t, din, dout, enc, seed=0):
    rng = np.random.default_rng(seed + 11 * t + din + 3 * dout)
    a = rng.standard_normal((b, t, din)).astype(np.float32)
    g = (0.1 * rng.standard_normal((b, t, dout))).astype(np.float32)
    c = np.resize(np.asarray(ENCODINGS[enc], np.float32), b)
    extra = rng.uniform(0.0, 1.0, b).astype(np.float32)
    return a, g, c, extra


def close(got, want, rtol=1e-5, atol_frac=0.0):
    want = np.asarray(want, np.float32)
    atol = atol_frac * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_extra", [False, True])
@pytest.mark.parametrize("enc", sorted(ENCODINGS))
@pytest.mark.parametrize("case", CASES)
def test_fused_norm_clip_ref_matches_pallas_kernel_and_ref(case, enc,
                                                           with_extra, dtype):
    """bf16 inputs are read as f32 on both sides (the TPU kernel casts each
    block), so the same values go in and the f32 tolerance holds."""
    a, g, c, extra = _inputs(*case, enc)
    ta, tg = T(a), T(g)
    if dtype == "bfloat16":
        ta, tg = ta.bfloat16(), tg.bfloat16()
    ja = jnp.asarray(ta.float().numpy()).astype(jnp.dtype(dtype))
    jg = jnp.asarray(tg.float().numpy()).astype(jnp.dtype(dtype))
    te = T(extra) if with_extra else None
    je = jnp.asarray(extra) if with_extra else None
    n, dw = FC.fused_norm_clip_ref(ta, tg, T(c), te)
    assert n.dtype == dw.dtype == torch.float32
    assert n.shape == (case[0],) and dw.shape == (case[2], case[3])
    for want_n, want_dw in (
            jax_fused(ja, jg, jnp.asarray(c), je, bt=32, interpret=True),
            JREF.fused_norm_clip_ref(ja, jg, jnp.asarray(c), je)):
        close(n, want_n)
        close(dw, want_dw, atol_frac=1e-5)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    a, g, c, extra = (T(v) for v in _inputs(4, 9, 12, 10, "mixed"))
    before = FC.launches
    for e in (None, extra):
        got, want = FC.fused_norm_clip(a, g, c, e), FC.fused_norm_clip_ref(
            a, g, c, e)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert FC.launches == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        FC.fused_norm_clip(a.to("meta"), g.to("meta"), c.to("meta"))


def _bad_inputs():
    a, g, c, extra = (T(v) for v in _inputs(3, 5, 8, 6, "mixed"))
    return [
        ((a[0], g[0], c, None), "must be 3-D"),
        ((a, g[:2], c, None), "differ in B or T"),
        ((a, g, c[:2], None), r"c \(2,\) must be \(3,\)"),
        ((a, g, c, extra[:1]), r"extra_norms_sq \(1,\) must be \(3,\)"),
        ((a, g, c.double(), None), "c must be float32"),
        ((a.half(), g.half(), c, None), "not supported"),
        ((a, g.bfloat16(), c, None), "share one dtype"),
        ((a.transpose(1, 2).contiguous().transpose(1, 2), g, c, None),
         "contiguous"),
        ((a[:, :0], g[:, :0], c, None), "empty input"),
    ]


@pytest.mark.parametrize("i", range(9))
def test_input_checks_refuse_what_the_kernel_does_not_take(i):
    args, msg = _bad_inputs()[i]
    with pytest.raises(ValueError, match=msg):
        FC._check(*args)


def test_input_checks_accept_the_router_and_the_fit_limit():
    for b, t, din, dout in ((8, 256, 1536, 40), (8, 256, 1024, 1024)):
        a = torch.empty((b, t, din), dtype=torch.bfloat16)
        g = torch.empty((b, t, dout), dtype=torch.bfloat16)
        FC._check(a, g, torch.empty(b), torch.empty(b))


def _linear_shapes(arch, reduced):
    """(din, dout) of every linear weight of the model: the leaves named
    `w` past their stack dims, but the embedding's."""
    spec = build_model(get_config(arch, reduced=reduced), device="cpu").spec
    return sorted({p.shape[p.stack:] for path, p in S._walk(spec)
                   if path[-1] == "w" and path[0] != "embed"})


def _spy_routes(monkeypatch):
    """Replace the three wrappers with spies that record the route and
    return zeros of the right shapes (no contraction is computed)."""
    routes = []

    def fused(a, g, c, extra=None):
        routes.append("fused")
        return (torch.zeros(a.shape[0]),
                torch.zeros(a.shape[-1], g.shape[-1]))

    def norms(a, g):
        routes.append("ghost_norm")
        return torch.zeros(a.shape[0])

    def reduce(a, g, f):
        routes.append("clip_reduce")
        return torch.zeros(a.shape[-1], g.shape[-1])

    monkeypatch.setattr(FC, "fused_norm_clip", fused)
    monkeypatch.setattr(GN, "ghost_norm", norms)
    monkeypatch.setattr(CR, "clip_reduce", reduce)
    return routes


@pytest.mark.parametrize("arch,reduced", [
    ("qwen3-4b", False), ("qwen3-4b", True),
    ("granite-moe-3b-a800m", False), ("granite-moe-3b-a800m", True)])
def test_route_is_the_reference_fit_rule_on_every_linear(arch, reduced,
                                                         monkeypatch):
    """The fused route exactly where `PallasBackend._fused_fits` passes,
    with norms; the composed route otherwise (also with the rule patched
    off), and clip_reduce alone without norms."""
    shapes = _linear_shapes(arch, reduced)
    ref_engine = jax_backend.make_engine("pallas")
    fits = {s: ref_engine._fused_fits(*s) for s in shapes}
    assert fits == {s: FC.fits(*s) for s in shapes}
    if arch == "granite-moe-3b-a800m" and not reduced:
        # the router fits; qkv, o and the head do not
        assert fits == {(1536, 40): True, (1536, 1536): False,
                        (1536, 2560): False, (1536, 49155): False}
    routes = _spy_routes(monkeypatch)
    c = torch.full((2,), 0.5)
    for (din, dout), fused in fits.items():
        a, g = torch.ones((2, 1, din)), torch.ones((2, 1, dout))
        for rule_on, norms, want in (
                (True, True, ["fused"] if fused
                 else ["ghost_norm", "clip_reduce"]),
                (False, True, ["ghost_norm", "clip_reduce"]),
                (True, False, ["clip_reduce"])):
            routes.clear()
            with monkeypatch.context() as m:
                if not rule_on:
                    m.setattr(FC, "fits", lambda din, dout: False)
                eng = backend.make_engine("kernels")
                n, f, dw = eng.linear_clip(a, g, c, norms=norms)
            assert routes == want, (din, dout, rule_on, norms)
            assert dw.shape == (din, dout)


@pytest.mark.parametrize("bias", [False, True])
def test_composed_route_gives_the_same_answer(bias, monkeypatch):
    """dp_linear's backward (output cotangent, clipped weight and bias
    gradients, norms²) under the fused route, the composed route and the
    plain engine; the fused and composed routes run the same plain
    arithmetic on CPU tensors, so they agree bit for bit."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((12, 10)).astype(np.float32)
    b = rng.standard_normal((10,)).astype(np.float32)
    x = rng.standard_normal((4, 7, 12)).astype(np.float32)
    gy = rng.standard_normal((4, 7, 10)).astype(np.float32)
    c = np.asarray(ENCODINGS["mixed"], np.float32)
    calls = {"fused": 0}
    real = FC.fused_norm_clip

    def counting(*a, **k):
        calls["fused"] += 1
        return real(*a, **k)

    monkeypatch.setattr(FC, "fused_norm_clip", counting)
    out = {}
    for label, engine, rule_on in (("fused", "kernels", True),
                                   ("composed", "kernels", False),
                                   ("plain", "plain", True)):
        tw, tx, tc = (T(v).requires_grad_() for v in (w, x, c))
        tb = T(b).requires_grad_() if bias else None
        with monkeypatch.context() as m, backend.scoped(engine):
            if not rule_on:
                m.setattr(FC, "fits", lambda din, dout: False)
            y = DP.dp_linear(tw, tb, tx, tc)
            ins = [tw, tx, tc] + ([tb] if bias else [])
            out[label] = torch.autograd.grad(y, ins, T(gy))
        assert calls["fused"] == 1  # the fused route's call only
    for x_f, x_c, x_p in zip(out["fused"], out["composed"], out["plain"]):
        assert torch.equal(x_f, x_c)
        close(x_f, x_p.numpy(), atol_frac=1e-5)


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("needs compute capability 9.x (Hopper)")


# B, T, din, dout: ragged T, T = 1, T past one 256-row chunk, din and dout
# off the 64-wide tiles, the router of granite-moe-3b-a800m, the fit limit,
# a DP-scale batch there (1,024 rounds of one example), 16,384 examples
CARD_CASES = [(3, 37, 20, 45), (1, 1, 64, 4096), (3, 200, 1000, 40),
              (8, 300, 40, 1000), (8, 256, 1536, 40), (8, 256, 1024, 1024),
              (1024, 8, 1024, 1024), (16384, 1, 64, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("enc", sorted(ENCODINGS))
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_version_on_card(case, enc, dtype):
    """Identical inputs on the card, extra None and given; only the f32
    summation order differs: rtol 1e-4, atol 1e-4 of the largest
    magnitude of the plain result."""
    _on_card()
    a, g, c, extra = _inputs(*case, enc)
    dt = getattr(torch, dtype)
    a, g = T(a).to("cuda", dt), T(g).to("cuda", dt)
    c, extra = T(c).cuda(), T(extra).cuda()
    for e in (None, extra):
        before = FC.launches
        got = FC.fused_norm_clip(a, g, c, e)
        torch.cuda.synchronize()
        assert FC.launches == before + 1
        for x, w in zip(got, FC.fused_norm_clip_ref(a, g, c, e)):
            atol = 1e-4 * float(w.abs().max())
            torch.testing.assert_close(x, w, rtol=1e-4, atol=atol)


def _card_inputs(case, enc="mixed", dtype="bfloat16"):
    a, g, c, extra = _inputs(*case, enc)
    dt = getattr(torch, dtype)
    return (T(a).to("cuda", dt), T(g).to("cuda", dt), T(c).cuda(),
            T(extra).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_two_calls_give_the_same_bits_on_card(case, dtype):
    _on_card()
    a, g, c, extra = _card_inputs(case, dtype=dtype)
    first, second = (FC.fused_norm_clip(a, g, c, extra) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extra_memory_stays_within_the_plans_scratch_on_card(dtype):
    """B = 1024 at the route rule's 1024 x 1024 limit: beside its inputs
    and outputs a call holds the plan's scratch (1 KB here; the first
    kernel's workspace was 4.3 GB), within 1 MB of the allocator's
    rounding."""
    _on_card()
    case = (1024, 8, 1024, 1024)
    a, g, c, extra = _card_inputs(case, dtype=dtype)
    FC.fused_norm_clip(a, g, c, extra)  # the barrier words, once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    n, dw = FC.fused_norm_clip(a, g, c, extra)
    torch.cuda.synchronize()
    extra_bytes = (torch.cuda.max_memory_allocated() - before
                   - 4 * (n.numel() + dw.numel()))
    p = FC.plan(*case, a.dtype, FC.sm_count(a.device))
    assert extra_bytes <= 4 * p.scratch + (1 << 20), (extra_bytes, p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(8, 256, 1536, 40), (3, 37, 20, 45),
                                  (64, 8, 1024, 1024)])
def test_graph_replay_gives_the_eager_bits_on_card(case):
    """The cooperative launch captured in a CUDA graph and replayed twice:
    the barrier words need no reset between replays."""
    _on_card()
    a, g, c, extra = _card_inputs(case)
    want = FC.fused_norm_clip(a, g, c, extra)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        FC.fused_norm_clip(a, g, c, extra)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = FC.fused_norm_clip(a, g, c, extra)
    for _ in range(2):
        for x in got:
            x.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_device_kernel_a_call_on_card(dtype):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _on_card()
    a, g, c, extra = _card_inputs((8, 256, 1536, 40), dtype=dtype)
    FC.fused_norm_clip(a, g, c, extra)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            FC.fused_norm_clip(a, g, c, extra)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
    assert len(kernels) == 1 and "fused_kernel" in next(iter(kernels)), \
        kernels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_c_plan_is_the_python_plan(dtype):
    """The C entry point fused_norm_clip_plan gives `fused_clip.plan` and
    `plan_fits`, at 132 and 114 SMs and at the card's count."""
    import ctypes

    from repro_torch.kernels import _build
    _on_card()
    c_plan = _build.load("fused_norm_clip").fused_norm_clip_plan
    c_plan.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong)]
    c_plan.restype = ctypes.c_int
    shapes = [(8, 256, 1536, 40), (1024, 8, 1024, 1024), (16384, 1, 64, 40),
              (3, 37, 20, 45), (1, 1, 64, 4096), (5, 300, 200, 130),
              (2, 3, 8192, 8192)]
    for sms in (132, 114, FC.sm_count(torch.device("cuda"))):
        for shape in shapes:
            want = FC.plan(*shape, dtype, sms)
            out = (ctypes.c_longlong * len(want))()
            fit = c_plan(*shape, int(dtype == torch.bfloat16), sms, out)
            assert (tuple(out), bool(fit)) == (
                tuple(want), FC.plan_fits(want, sms)), (shape, sms)
