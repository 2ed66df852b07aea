from .encoding import positional_encoding
from .freq_mask import FreeMasks, free_masks, freq_reg_mask
from .grid_sample import (
    footprint_sample_1d,
    footprint_sample_2d,
    gather_rows,
    grid_sample_1d,
    grid_sample_2d,
    grid_sample_3d,
    line_sample_matmul,
    make_footprint_1d,
    make_footprint_2d,
)
from .rays import aabb_entry_exit, sample_along_rays
from .render_math import exclusive_transmittance, raw2alpha
from .resize import resize_bilinear_align_corners, resize_linear_align_corners
from .scatter_add import scatter_add, scatter_add_reference
from .sh import eval_sh, eval_sh_bases
