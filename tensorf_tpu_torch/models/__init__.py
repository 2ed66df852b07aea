from .config import MAT_MODE, VEC_MODE, GridGeometry, ModelConfig
from .shading import apply_shading, init_shading
from .tensorf import FIELD_MODELS, TensorVMSplit, spatial_label_tree
