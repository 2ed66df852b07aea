from .chunked import render_chunked
from .culling import compute_alpha_grid, filter_rays_alpha, filter_rays_bbox, update_alpha_mask
from .volume import RenderOutput, feature2density, normalize_coord, render_rays
