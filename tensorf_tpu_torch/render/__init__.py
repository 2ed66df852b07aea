from .culling import filter_rays_bbox
from .volume import RenderOutput, feature2density, normalize_coord, render_rays
