"""Share of the shaded sample slots whose weight passes the threshold, in %.

Layer: whole step. Source: program_counter: the port's counters over the
profiled steps (tensorf_tpu_torch/utils/tracing.py), render.shaded (the
samples whose weight passes ray_march_weight_thres) over render.shade_rows
(each render's rays times its top-K, or without top-K its samples a ray).
Moves train_rays_per_s.device_bound."""

from portbench.span_reads import slot_use_pct


def read(ctx):
    return slot_use_pct(ctx, "train", "render.shaded", "render.shade_rows")
