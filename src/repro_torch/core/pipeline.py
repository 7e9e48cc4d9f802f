"""Algorithm 2: private pipeline-parallel training with per-device
clipping. The counterpart of `repro.core.pipeline`.

  * the model is partitioned into S stages of consecutive blocks; stage s
    runs on the rank at coordinate s of the mesh's `stage_axis` (`pod`,
    as the reference's default);
  * microbatches stream through the pipeline: at each of
    (n_micro + S - 1) ticks every stage processes the microbatch it holds
    and sends its activations to the next stage (LocalForward's
    activation sends, Algorithm 3 line 5). The reference's `ppermute`
    becomes an autograd pair: the forward's send / receive, and the
    backward's mirrored receive / send of the cotangent (Algorithm 4
    line 7), so the backward schedule is derived, not hand-written;
  * PER-DEVICE CLIPPING: each stage's parameters form one clipping group,
    and the DP primitives inside the stage body compute stage-LOCAL
    per-example norms: no norm crosses the stage axis (the collective log
    holds only the activation and cotangent sends and the outputs'
    broadcast);
  * the last stage's outputs reach every stage through the reference's
    masked psum (`:48-50`), whose backward hands the (replicated)
    cotangent back to the last stage alone.

The reference model is a stage-stacked MLP tower (each stage body is any
block function). Each rank holds the whole parameter tree and trains its
stage's slice of `blocks`; the embedding's input is stage 0's, the head
is replicated. So a rank's gradients are its stage's: `blocks[s]` on
stage s, `embed` on stage 0, and the head's on every stage, whose
per_group factor (embed and head share supergroup 0 in the reference's
test) stage 0 alone can form.

Sends are non-blocking and tagged by microbatch (a receive matches its
send whatever order autograd runs the backward in); `drain()` waits for
the outstanding ones, each forward drains the previous backward's. On a
card the backward's receives and sends run on autograd's device thread;
under gloo the mesh stages them through the host (`launch.mesh`), the
staged copy kept alive by its pending handle until `drain()`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dp_layers import dp_linear
from repro_torch.core.spec import P

_SEND_SITE, _OUT_SITE = "pipeline_send", "pipeline_out_psum"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    layers_per_stage: int
    d_model: int
    d_in: int
    n_classes: int

    @property
    def total_layers(self) -> int:
        return self.n_stages * self.layers_per_stage


def pipeline_spec(cfg: PipelineConfig) -> dict:
    lps, d = cfg.layers_per_stage, cfg.d_model
    return {
        # stage-stacked: leading dim = stage; ONE clipping group per stage
        # (per-DEVICE clipping): the explicit group name joins a stage's
        # per-layer parameters
        "blocks": {
            "w": P((cfg.n_stages, lps, d, d), stack=1, group="stage"),
            "b": P((cfg.n_stages, lps, d), init="zeros", stack=1,
                   group="stage"),
        },
        "head": {"w": P((d, cfg.n_classes))},
        "embed": {"w": P((cfg.d_in, d))},
    }


def _stage_body(stage_params, x, c):
    """One stage: layers_per_stage DP blocks. x: (B, d); c: (B,) encoded
    thresholds of THIS stage's group."""
    for w, b in zip(stage_params["w"], stage_params["b"]):
        x = torch.tanh(dp_linear(w, b, x[:, None, :], c)[:, 0])
    return x


class _Sender:
    """The stage's point-to-point traffic on the stage axis: tagged sends
    whose handles are kept until `drain()`, and blocking receives."""

    def __init__(self, mesh, axis):
        self.mesh, self.axis, self.pending = mesh, axis, []

    def isend(self, t: torch.Tensor, to: int, tag: int) -> None:
        self.pending.append(self.mesh.isend(t, self.axis, to,
                                            site=_SEND_SITE, tag=tag))

    def recv(self, shape, dtype, frm: int, tag: int) -> torch.Tensor:
        return self.mesh.recv(shape, dtype, self.axis, frm, site=_SEND_SITE,
                              tag=tag)

    def drain(self) -> None:
        while self.pending:
            self.pending.pop(0).wait()


class _Send(torch.autograd.Function):
    """Forward: send x to stage `to`; returns a token (0-d zeros) that
    ties the send into the graph. Backward: receive x's cotangent."""

    @staticmethod
    def forward(ctx, x, sender, to, tag):
        sender.isend(x, to, 2 * tag)
        ctx.meta = (sender, to, tag, x.shape, x.dtype)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        sender, to, tag, shape, dtype = ctx.meta
        return (sender.recv(shape, dtype, to, 2 * tag + 1), None, None,
                None)


class _Recv(torch.autograd.Function):
    """Forward: receive stage `frm`'s activations (`anchor` only puts the
    result on the graph). Backward: send the cotangent back."""

    @staticmethod
    def forward(ctx, anchor, sender, frm, tag, shape):
        ctx.meta = (sender, frm, tag)
        return sender.recv(shape, anchor.dtype, frm, 2 * tag)

    @staticmethod
    def backward(ctx, g):
        sender, frm, tag = ctx.meta
        sender.isend(g, frm, 2 * tag + 1)
        return None, None, None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs on every stage: psum over the stage axis
    of the outputs masked to the last stage. Every stage computes the same
    loss from them, so the backward hands the cotangent to the last stage
    and zeros to the tokens (which runs the sends' backward)."""

    @staticmethod
    def forward(ctx, local, mesh, axis, last, *tokens):
        ctx.meta = (last, len(tokens))
        out = (local if last else torch.zeros_like(local)).clone()
        return mesh.psum(out, (axis,), site=_OUT_SITE)

    @staticmethod
    def backward(ctx, g):
        last, n = ctx.meta
        toks = tuple(g.new_zeros(()) for _ in range(n))
        return (g if last else None, None, None, None) + toks


def make_pipeline_loss(cfg: PipelineConfig, mesh, *,
                       stage_axis: str = "pod"):
    """Returns loss_fn(params, (x, y), thresholds, *, n_micro=2) -> (B,)
    per-example losses, computed through the pipeline: this rank runs
    stage `mesh.axis_index(stage_axis)`, and every rank returns the same
    losses. thresholds: {'stage': (S, B) encoded, 'embed', 'head': (B,)}.
    `loss_fn.drain()` waits for the sends still in flight (call it after
    the last backward)."""
    s_count = cfg.n_stages
    if mesh.shape[stage_axis] != s_count:
        raise ValueError(f"{s_count} stages on a {stage_axis} axis of "
                         f"{mesh.shape[stage_axis]}")
    stage = mesh.axis_index(stage_axis)
    last = stage == s_count - 1
    sender = _Sender(mesh, stage_axis)

    def pipelined(blocks, x0, c):
        """x0: (n_micro, mb, d) embedded inputs; c: (B,) this stage's
        thresholds. Returns the (n_micro, mb, d) final activations."""
        n_micro, mb, d = x0.shape
        sp = {"w": blocks["w"][stage], "b": blocks["b"][stage]}
        outs, tokens, buf = [None] * n_micro, [], None
        for t in range(n_micro + s_count - 1):
            m = t - stage  # this stage's microbatch at tick t
            if 0 <= m < n_micro:
                inp = x0[m] if stage == 0 else buf
                out = _stage_body(sp, inp, c[m * mb:(m + 1) * mb])
                if last:
                    outs[m] = out
                else:
                    tokens.append(_Send.apply(out, sender, stage + 1, m))
            nxt = t + 1 - stage  # the microbatch the previous stage sent
            if stage > 0 and 0 <= nxt < n_micro:
                buf = _Recv.apply(x0, sender, stage - 1, nxt, (mb, d))
        local = (torch.stack(outs) if last else
                 torch.zeros_like(x0))
        return _Broadcast.apply(local, mesh, stage_axis, last, *tokens)

    def loss_fn(params, batch, th, *, n_micro: int = 2):
        sender.drain()  # the previous backward's cotangent sends
        x, y = batch
        b = x.shape[0]
        mb = b // n_micro
        h = dp_linear(params["embed"]["w"], None, x[:, None, :],
                      th["embed"])[:, 0]
        c = th["stage"].unbind(0)[stage]  # a tensor's or a BkChannel's row
        out = pipelined(params["blocks"], h.reshape(n_micro, mb, -1), c)
        logits = dp_linear(params["head"]["w"], None,
                           out.reshape(b, -1)[:, None, :], th["head"])[:, 0]
        logp = torch.log_softmax(logits, dim=-1)
        sender.drain()  # the activations sent
        return -logp[torch.arange(b, device=logp.device), y]

    loss_fn.drain = sender.drain
    return loss_fn


def reference_loss(cfg: PipelineConfig, params, batch, th):
    """Single-device reference: the same math, no pipeline."""
    x, y = batch
    h = dp_linear(params["embed"]["w"], None, x[:, None, :],
                  th["embed"])[:, 0]
    cs = th["stage"].unbind(0)
    for s in range(cfg.n_stages):
        sp = {"w": params["blocks"]["w"][s], "b": params["blocks"]["b"][s]}
        h = _stage_body(sp, h, cs[s])
    logits = dp_linear(params["head"]["w"], None, h[:, None, :],
                       th["head"])[:, 0]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp[torch.arange(y.shape[0], device=logp.device), y]
