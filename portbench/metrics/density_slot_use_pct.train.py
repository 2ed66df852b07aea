"""Share of the density's sample slots that hold a sample the mask admits, in %.

Layer: whole step. Source: program_counter: the port's counters over the
profiled steps (tensorf_tpu_torch/utils/tracing.py), render.alive (each
render's mean alive samples a ray times its rays) over render.density_rows
(its rays times the samples a ray the density runs on: each stratum's
budget or lattice). Moves train_rays_per_s."""

from portbench.span_reads import slot_use_pct


def read(ctx):
    return slot_use_pct(ctx, "train", "render.alive", "render.density_rows")
