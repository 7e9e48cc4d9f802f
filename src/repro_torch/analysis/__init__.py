"""Analysis of the port's traced steps: the counterpart of `repro.analysis`.

`graph` reads a step run on fake tensors (the dry run, `launch.dryrun`):
flops, bytes, peak memory, collectives by kind and axes, backward passes
and the ghost-op engine's calls. It stands for the reference's `hlo`
module (and `launch/hlo_analysis.py`'s re-export of it): torch has no HLO
to parse. The reference's static DP-safety rules (`findings`, `rules`,
`jaxpr_taint`) are ROADMAP A.19.
"""
from repro_torch.analysis.graph import (COLLECTIVES, Totals, analyze_step,
                                        backward_passes,
                                        classify_collectives,
                                        filter_model_norm_rows,
                                        kernel_launches, summarize_axis_rows)

__all__ = ["COLLECTIVES", "Totals", "analyze_step", "backward_passes",
           "classify_collectives", "filter_model_norm_rows",
           "kernel_launches", "summarize_axis_rows"]
