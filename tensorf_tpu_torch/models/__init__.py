from .alpha_mask import AlphaGridMask, coarse_gate_valid, sample_alpha, sample_alpha_gate
from .config import MAT_MODE, VEC_MODE, GridGeometry, ModelConfig, n_voxel_schedule
from .shading import apply_shading, init_shading
from .tensorf import FIELD_MODELS, TensorCP, TensorVM, TensorVMSplit, spatial_label_tree
