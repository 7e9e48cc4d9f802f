"""Analysis of the port's traced steps: the counterpart of `repro.analysis`.

`graph` reads a step run on fake tensors (the dry run, `launch.dryrun`):
flops, bytes, peak memory, collectives by kind and axes, backward passes,
the ghost-op engine's calls and the ops of data-dependent shape. It
stands for the reference's `hlo` module (and `launch/hlo_analysis.py`'s
re-export of it): torch has no HLO to parse.

The static DP-safety audit (`launch.audit`) has two cooperating passes
over the same traced step, the reference's two:

  * `taint` (the reference's `jaxpr_taint`): a dispatch mode that proves,
    per trainable leaf, that every batch-derived dataflow path is
    clip-factor-scaled before the parameter's update and that exactly one
    noise draw, from a leaf-specific generator, reaches it;
  * `rules`: named, severity-tagged rules over the traced step (the
    model-axis collective leak, backward-pass counts, in-place state,
    shape stability), `run_trace_rules` in place of `run_hlo_rules`.

`findings` is their shared vocabulary, a copy of the reference's.
"""
from repro_torch.analysis.findings import (ERROR, INFO, WARNING, Finding,
                                           errors, worst_severity)
from repro_torch.analysis.graph import (COLLECTIVES, Totals, analyze_step,
                                        backward_passes,
                                        classify_collectives,
                                        filter_model_norm_rows,
                                        kernel_launches, summarize_axis_rows)

__all__ = ["ERROR", "INFO", "WARNING", "Finding", "errors", "worst_severity",
           "COLLECTIVES", "Totals", "analyze_step", "backward_passes",
           "classify_collectives", "filter_model_norm_rows",
           "kernel_launches", "summarize_axis_rows"]
