from .encoding import positional_encoding
from .freq_mask import FreeMasks, free_masks, freq_reg_mask
from .grid_sample import (
    footprint_sample_2d,
    gather_rows,
    grid_sample_1d,
    grid_sample_2d,
    line_sample_matmul,
    make_footprint_2d,
)
from .rays import aabb_entry_exit, sample_along_rays
from .render_math import exclusive_transmittance, raw2alpha
from .scatter_add import scatter_add, scatter_add_reference
