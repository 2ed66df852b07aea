"""Unified configuration schema (a copy of tensorf_tpu/config/schema.py,
same fields and defaults, so the repo's txt/yaml configs parse the same).

Field names and defaults follow the reference's opt.py.  The port reads
only part of it so far; train/loop.py says which knobs it does not honour
yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..models.config import ModelConfig


@dataclasses.dataclass
class TrainConfig:
    # --- experiment / logging ---
    expname: str = "exp"
    basedir: str = "./log"
    add_timestamp: int = 0
    datadir: str = "./data/llff/fern"
    progress_refresh_rate: int = 10
    N_vis: int = 5
    vis_every: int = 1000
    train_vis_every: int = 1000
    save_ckpt_every: List[int] = dataclasses.field(default_factory=list)
    overwrt: bool = False

    # --- few-shot image selection ---
    N_train_imgs: int = 0
    N_test_imgs: int = 0
    train_idxs: List[int] = dataclasses.field(default_factory=list)
    test_idxs: List[int] = dataclasses.field(default_factory=list)
    val_idxs: List[int] = dataclasses.field(default_factory=list)
    train_images: Optional[List[int]] = None  # hydra-surface aliases
    test_images: Optional[List[int]] = None
    val_images: Optional[List[int]] = None

    # --- data ---
    with_depth: bool = False
    downsample_train: float = 1.0
    downsample_test: float = 1.0
    dataset_name: str = "blender"
    object_name: str = ""

    # --- model ---
    model_name: str = "TensorVMSplit"
    batch_size: int = 4096
    n_iters: int = 30000
    n_lamb_sigma: List[int] = dataclasses.field(default_factory=lambda: [16, 16, 16])
    n_lamb_sh: List[int] = dataclasses.field(default_factory=lambda: [48, 48, 48])
    data_dim_color: int = 27
    rm_weight_mask_thre: float = 0.0001
    alpha_mask_thre: float = 0.0001
    alphaMask_thres: Optional[float] = None  # yaml alias
    distance_scale: float = 25.0
    density_shift: float = -10.0
    shadingMode: str = "MLP_PE"
    pos_pe: int = 6
    view_pe: int = 6
    fea_pe: int = 6
    featureC: int = 128

    # --- learning rates ---
    lr_init: float = 0.02
    lr_basis: float = 1e-3
    lr_decay_iters: int = -1
    lr_decay_target_ratio: float = 0.1
    lr_upsample_reset: int = 1

    # --- losses ---
    L1_weight_inital: float = 0.0
    L1_weight_rest: float = 0.0
    Ortho_weight: float = 0.0
    TV_weight_density: float = 0.0
    TV_weight_app: float = 0.0

    # --- FreeNeRF ---
    free_reg: bool = False
    free_decomp: bool = False
    freq_reg_ratio: float = 1.0
    mask_ratio_list: List[float] = dataclasses.field(default_factory=lambda: [1.0])
    max_vis_freq_ratio: float = 0.0

    # --- occlusion regularizer ---
    occ_reg: bool = False
    occ_reg_loss_mult: float = 0.0
    occ_reg_range: int = 0
    occ_wb_range: int = 0
    occ_wb_prior: bool = False

    # --- rendering ---
    ckpt: Optional[str] = None
    ckpt_path: Optional[str] = None
    render_only: int = 0
    render_test: int = 0
    render_train: int = 0
    render_path: int = 0
    export_mesh: int = 0
    lindisp: bool = False
    perturb: float = 1.0
    accumulate_decay: float = 0.998
    fea2denseAct: str = "softplus"
    ndc_ray: int = 0
    nSamples: int = 1_000_000
    step_ratio: float = 0.5
    white_bkgd: bool = False

    # --- voxel schedule ---
    N_voxel_init: int = 100**3
    N_voxel_final: int = 300**3
    upsamp_list: List[int] = dataclasses.field(default_factory=list)
    update_AlphaMask_list: List[int] = dataclasses.field(default_factory=list)
    idx_view: int = 0
    occ_grid_reso: int = 0

    # --- knobs of the JAX package's accelerated path ---
    fused_gathers: bool = True  # packed footprint gathers
    sample_budget: int = 0  # 0 = all samples; >0 = per-ray alive-sample cap
    shade_top_k: int = 0  # 0 = shade all samples; >0 = top-K compaction (mask era)
    # Top-K appearance compaction before the first alpha mask; 0 shades
    # every in-bbox sample until then.
    prefilter_shade_top_k: int = 64
    compute_dtype: str = "float32"  # shading MLP compute dtype
    grid_dtype: str = "float32"  # factor-grid gather/scatter compute dtype
    line_dtype: str = "float32"  # one-hot-lerp matrix dtype of line sampling
    prefilter_budget: int = 0  # per-ray candidate cap before the first alpha mask
    stratify: int = 1  # candidate-count-stratified ray batching
    strata_quantiles: List[float] = dataclasses.field(default_factory=list)
    stratify_noise_match: int = 1
    stratify_render: int = 1
    stratify_prefilter: int = 1
    stratify_alive: int = 0
    # ray-batch data parallelism: N ranks, one per visible card, spawned by
    # the launch (0 = every visible card; on the CPU N ranks over gloo, 0 = one)
    n_devices: int = 0
    # this process is one rank of a run started outside it (torchrun, or
    # TFTPU_COORDINATOR/TFTPU_NUM_PROCESSES/TFTPU_PROCESS_ID); each rank draws
    # from its own id pool; n_devices must be 0 or the world size
    distributed: bool = False
    # --- failure detection / recovery ---
    resume: int = 0
    wedge_timeout_s: float = 900.0
    auto_resume: int = 0
    platform: str = ""
    profile_dir: str = ""
    profile_start: int = 50
    profile_steps: int = 5
    seed: int = 20211202

    def resolved_alpha_mask_thres(self) -> float:
        if self.alphaMask_thres is not None:
            return float(self.alphaMask_thres)
        return float(self.alpha_mask_thre)

    def resolved_train_images(self):
        """Few-shot train index selection across the two config surfaces."""
        if self.train_images is not None:
            return list(self.train_images)
        if self.train_idxs:
            return list(self.train_idxs)
        if self.N_train_imgs > 0:
            return int(self.N_train_imgs)
        return -1

    def resolved_test_images(self):
        if self.test_images is not None:
            return list(self.test_images)
        if self.test_idxs:
            return list(self.test_idxs)
        if self.N_test_imgs > 0:
            return int(self.N_test_imgs)
        return -1


def model_config_from(cfg: TrainConfig) -> ModelConfig:
    """TrainConfig -> static ModelConfig."""
    return ModelConfig(
        model_name=cfg.model_name,
        density_n_comp=tuple(cfg.n_lamb_sigma),
        app_n_comp=tuple(cfg.n_lamb_sh),
        app_dim=cfg.data_dim_color,
        density_shift=cfg.density_shift,
        distance_scale=cfg.distance_scale,
        alpha_mask_thres=cfg.resolved_alpha_mask_thres(),
        ray_march_weight_thres=cfg.rm_weight_mask_thre,
        fea2dense_act=cfg.fea2denseAct,
        step_ratio=cfg.step_ratio,
        shading_mode=cfg.shadingMode,
        pos_pe=cfg.pos_pe,
        view_pe=cfg.view_pe,
        fea_pe=cfg.fea_pe,
        feature_c=cfg.featureC,
        dtype=cfg.compute_dtype,
        grid_dtype=cfg.grid_dtype,
        line_dtype=cfg.line_dtype,
    )
