"""Model inputs: the ragged request sets of serving (a copy of the numpy
part of `repro.launch.inputs`) and, as in the reference, the only place
the frontend stubs live: Whisper's precomputed frame embeddings and
Qwen2-VL's precomputed patch embeddings with their M-RoPE positions.

`sds`, `train_batch_specs` and `serve_batch_specs` are the dry run's
shape-only inputs (the reference's ShapeDtypeStructs): tensors on the
meta device, or fake tensors on `device` inside a `FakeTensorMode`."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spec import shape_only

VLM_PATCHES = 256  # stub vision-token count prepended to the text sequence


def sds(shape, dtype, device="meta") -> torch.Tensor:
    """A shape-only tensor (`core.spec.shape_only`)."""
    return shape_only(shape, dtype, device)


def train_batch_specs(cfg, shape, device="meta") -> dict:
    """The train (and prefill) batch of `shape` (an `InputShape`), shape
    only: tokens and targets (B, T) int32, Whisper's frames (B,
    encoder_seq_len, D) and Qwen2-VL's VLM_PATCHES patch embeddings with
    their (B, 3, T + VLM_PATCHES) M-RoPE positions, in the model dtype."""
    b, t = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((b, t), torch.int32, device),
             "targets": sds((b, t), torch.int32, device)}
    if cfg.arch_type == "audio":
        batch["frames"] = sds((b, cfg.encoder_seq_len, cfg.d_model),
                              cfg.dtype, device)
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = sds((b, VLM_PATCHES, cfg.d_model),
                                     cfg.dtype, device)
        batch["positions3_full"] = sds((b, 3, t + VLM_PATCHES), torch.int32,
                                       device)
    return batch


def serve_batch_specs(cfg, shape, device="meta") -> dict:
    """The decode batch of `shape`: one token (B, 1) int32 a slot."""
    return {"token": sds((shape.global_batch, 1), torch.int32, device)}


def pad_ragged_prompts(prompts) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad a list of variable-length prompts into one batch.

    prompts: sequence of 1-D int token sequences (len >= 1 each).
    Returns (tokens (B, Pmax) int32, lengths (B,) int32); the pad value
    is 0.
    """
    rows = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    if not rows:
        raise ValueError("empty request set")
    if any(r.size == 0 for r in rows):
        raise ValueError("empty prompt in request set: seed with a BOS token")
    pmax = max(r.size for r in rows)
    toks = np.zeros((len(rows), pmax), np.int32)
    lengths = np.zeros((len(rows),), np.int32)
    for i, r in enumerate(rows):
        toks[i, : r.size] = r
        lengths[i] = r.size
    return toks, lengths


def synthetic_requests(vocab_size: int, n: int, *, min_len: int,
                       max_len: int, seed: int = 0) -> list[np.ndarray]:
    """n random prompts with lengths uniform in [min_len, max_len]: the
    same request sets as the reference's serve CLI for the same seed."""
    if not 1 <= min_len <= max_len:
        raise ValueError(f"need 1 <= min_len <= max_len, got "
                         f"[{min_len}, {max_len}]")
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=n)
    return [rng.integers(0, vocab_size, size=int(l)).astype(np.int32)
            for l in lens]


def concrete_train_batch(cfg, b: int, t: int,
                         generator: torch.Generator) -> dict:
    """A small concrete batch on the generator's device, as the
    reference's: tokens, next-token targets (-1 at the end), and the
    stubs: Whisper's `frames` (B, encoder_seq_len, D), Qwen2-VL's 8
    patches of `vision_embeds` (B, 8, D) with `positions3_full` (B, 3,
    8 + T), the 1-D positions on all three streams (where M-RoPE is
    RoPE; `mrope_grid_positions` gives distinct ones). Draws from the
    torch generator: the two packages' batches differ."""
    dev = generator.device
    toks = torch.randint(0, cfg.vocab_size, (b, t), generator=generator,
                         device=dev, dtype=torch.int32)
    tgt = torch.roll(toks, -1, dims=1)
    tgt[:, -1] = -1
    batch = {"tokens": toks, "targets": tgt}
    if cfg.arch_type == "audio":
        batch["frames"] = (0.1 * torch.randn(
            (b, cfg.encoder_seq_len, cfg.d_model), generator=generator,
            device=dev)).to(cfg.dtype)
    if cfg.arch_type == "vlm":
        tv = 8
        batch["vision_embeds"] = (0.1 * torch.randn(
            (b, tv, cfg.d_model), generator=generator, device=dev)).to(
            cfg.dtype)
        pos = torch.arange(t + tv, dtype=torch.int32, device=dev)
        batch["positions3_full"] = pos.expand(b, 3, t + tv).contiguous()
    return batch


def mrope_grid_positions(b: int, grid: tuple[int, int], t: int,
                         device=None) -> torch.Tensor:
    """Qwen2-VL's M-RoPE positions of one image of grid (h, w) patches
    followed by t text tokens, (B, 3, h * w + t) int32: a patch's (t, h,
    w) streams are (0, its row, its column); the text continues from one
    past the largest patch position on all three streams."""
    gh, gw = grid
    rows = torch.arange(gh, dtype=torch.int32, device=device)
    cols = torch.arange(gw, dtype=torch.int32, device=device)
    patches = torch.stack([torch.zeros(gh * gw, dtype=torch.int32,
                                       device=device),
                           rows.repeat_interleave(gw), cols.repeat(gh)])
    start = max(gh, gw)  # one past max(0, gh - 1, gw - 1)
    text = (start + torch.arange(t, dtype=torch.int32,
                                 device=device)).expand(3, t)
    return torch.cat([patches, text], dim=1).expand(b, 3, gh * gw + t) \
        .contiguous()
