"""Static model configuration + grid geometry (a copy of
tensorf_tpu/models/config.py, which the port may not import).

Derivations follow the reference's update_stepSize
(models/tensorBase.py:104-116): units = aabb_size/(grid-1);
step = mean(units)*step_ratio; n_samples = diag/step + 1.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Plane/line axis conventions (reference models/tensorBase.py:60-61).
MAT_MODE: Tuple[Tuple[int, int], ...] = ((0, 1), (0, 2), (1, 2))
VEC_MODE: Tuple[int, ...] = (2, 1, 0)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of a factorized radiance field (same fields and
    defaults as the JAX package's ModelConfig)."""

    model_name: str = "TensorVMSplit"  # TensorVMSplit | TensorCP | TensorVM
    density_n_comp: Tuple[int, ...] = (16, 16, 16)
    app_n_comp: Tuple[int, ...] = (48, 48, 48)
    app_dim: int = 27
    density_shift: float = -10.0
    distance_scale: float = 25.0
    alpha_mask_thres: float = 0.001
    ray_march_weight_thres: float = 0.0001
    fea2dense_act: str = "softplus"  # softplus | relu
    near_far: Tuple[float, float] = (2.0, 6.0)
    step_ratio: float = 0.5
    shading_mode: str = "MLP_Fea"  # MLP_PE | MLP_Fea | MLP | SH | RGB
    pos_pe: int = 6
    view_pe: int = 6
    fea_pe: int = 6
    feature_c: int = 128
    dtype: str = "float32"  # shading MLP compute dtype
    grid_dtype: str = "float32"  # factor-grid gather/scatter dtype
    line_dtype: str = "float32"  # one-hot-lerp matrix dtype of line sampling

    # --- FreeNeRF mask bit lengths (reference models/tensorBase.py:81-83) ---
    @property
    def pos_bit_length(self) -> int:
        return 2 * self.pos_pe * 3

    @property
    def view_bit_length(self) -> int:
        return 2 * self.view_pe * 3

    @property
    def fea_bit_length(self) -> int:
        return 2 * self.fea_pe * self.app_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """aabb + grid resolution + derived sampling quantities."""

    aabb: Tuple[float, float, float, float, float, float]
    grid_size: Tuple[int, int, int]
    step_ratio: float

    @property
    def aabb_np(self) -> np.ndarray:
        return np.asarray(self.aabb, dtype=np.float32).reshape(2, 3)

    @property
    def aabb_size(self) -> np.ndarray:
        a = self.aabb_np
        return a[1] - a[0]

    @property
    def units(self) -> np.ndarray:
        return self.aabb_size / (np.asarray(self.grid_size, np.float32) - 1)

    @property
    def step_size(self) -> float:
        return float(np.mean(self.units) * self.step_ratio)

    @property
    def aabb_diag(self) -> float:
        return float(np.sqrt(np.sum(np.square(self.aabb_size))))

    @property
    def n_samples(self) -> int:
        return int(self.aabb_diag / self.step_size) + 1

    @staticmethod
    def create(aabb, grid_size, step_ratio) -> "GridGeometry":
        aabb = tuple(float(v) for v in np.asarray(aabb).reshape(-1))
        grid_size = tuple(int(g) for g in grid_size)
        return GridGeometry(aabb, grid_size, float(step_ratio))


def n_to_reso(n_voxels: int, aabb) -> Tuple[int, int, int]:
    """Voxel count -> per-axis resolution (reference utils.py:117-121).

    float32 arithmetic on purpose: the reference computes this in float32
    and the truncation boundary differs in float64 (128^3 would give 127
    per axis in double precision).
    """
    aabb = np.asarray(aabb, dtype=np.float32).reshape(2, 3)
    size = aabb[1] - aabb[0]
    voxel_size = np.float32((size.prod() / n_voxels) ** (1.0 / 3))
    return tuple(int(v) for v in (size / voxel_size).astype(np.int64))


def cal_n_samples(reso, step_ratio: float = 0.5) -> int:
    """||reso||2 / step_ratio (reference utils.py:124-125)."""
    return int(np.linalg.norm(reso) / step_ratio)

