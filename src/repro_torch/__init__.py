"""PyTorch/CUDA port of the `repro` package for NVIDIA Hopper (H100).

The layout mirrors `repro`: `configs/`, `core/spec.py`, `models/`,
`kernels/` and `launch/`, so every module has a counterpart of the same
name there. This slice covers paged continuous-batching serving of the
dense decoder family; `bridge.py` moves parameter trees and decode caches
between the two packages through numpy.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
Nothing falls back to the CPU when no GPU is present: asking for `cuda`
without one raises.
"""
