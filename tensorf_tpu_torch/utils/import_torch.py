"""Import the reference's PyTorch checkpoints (``.th``) as the port's own
(the counterpart of tensorf_tpu/utils/import_torch.py).

The reference saves ``{kwargs, state_dict}`` plus a bit-packed alpha mask
with ``torch.save`` (models/tensorBase.py:160-168).  This module maps that
layout onto the channels-last layout both packages share, so a model
trained by the reference loads, renders, exports and resumes training here:

================================  =================================
reference state_dict              port (JAX flat key)
================================  =================================
``density_plane.{i}`` (1,R,H,W)   ``density_plane/i`` (H,W,R)
``density_line.{i}``  (1,R,L,1)   ``density_line/i``  (L,R)
``app_plane.{i}`` / ``app_line.{i}``  same transposes
``basis_mat.weight`` (out,in)     ``basis`` (in,out)
``renderModule.mlp.{0,2,4}``      ``render/l{1,2,3}/{w,b}`` (w = weight.T)
``plane_coef``/``line_coef``      legacy TensorVM ``plane/i``, ``line/i``
  (3,C,res,res)/(3,C,res,1)
``alphaMask.{shape,mask,aabb}``   AlphaGridMask (volume (Z,Y,X))
================================  =================================

The checkpoint does not record its model class (the reference's loader
takes it from the command line): it is inferred from the state dict's
keys.  ``utils/ckpt.py::load_checkpoint`` sends every ``.th`` path here, so
``--ckpt reference.th`` works in every entry point; ``convert`` writes the
port's ``.npz``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.alpha_mask import AlphaGridMask, unpack_mask
from ..models.config import ModelConfig
from .device import resolve_device


def _np(x) -> np.ndarray:
    """A tensor, list or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _comp(x) -> Tuple[int, ...]:
    """An n_comp int (legacy TensorVM) or per-axis list as a 3-tuple."""
    if isinstance(x, (int, np.integer)):
        return (int(x),) * 3
    return tuple(int(v) for v in x)


def _near_far(kwargs: Dict[str, Any]) -> Tuple[float, float]:
    raw = kwargs["near_far"]
    try:
        nf = tuple(float(v) for v in _np(raw).reshape(-1))
        if len(nf) == 2:
            return nf
    except (TypeError, ValueError):
        pass
    # the reference's TensorCP checkpoints carry near_far='cuda'/'cpu': its
    # constructor passes the device positionally into TensorBase's near_far
    # slot (tensoRF.py:331-332)
    print(f"[import] reference ckpt carries non-numeric near_far ({raw!r} — the TensorCP "
          "device-into-near_far bug, tensoRF.py:331-332); defaulting to (2.0, 6.0)")
    return (2.0, 6.0)


def torch_load_safe(path: str) -> Dict[str, Any]:
    """``torch.load`` with ``weights_only=True``: a ``--ckpt`` path is user
    input, so no pickle may run code.  The reference's pickle holds numpy
    arrays (the bit-packed mask, tensorBase.py:166), which the weights-only
    unpickler takes only from an explicit allowlist."""
    import numpy.dtypes as np_dtypes
    from torch.serialization import safe_globals

    try:
        reconstruct = np._core.multiarray._reconstruct  # numpy >= 2
    except AttributeError:  # numpy 1.x
        reconstruct = np.core.multiarray._reconstruct
    allow = [reconstruct, np.ndarray, np.dtype]
    allow += [getattr(np_dtypes, n) for n in dir(np_dtypes) if n.endswith("DType")]
    with safe_globals(allow):
        return torch.load(path, map_location="cpu", weights_only=True)


def infer_model_name(sd_keys) -> str:
    keys = set(sd_keys)
    if any(k.startswith("density_plane.") for k in keys):
        return "TensorVMSplit"
    if "plane_coef" in keys:
        return "TensorVM"
    if any(k.startswith("density_line.") for k in keys):
        return "TensorCP"
    raise ValueError(f"unrecognized reference state_dict (keys: {sorted(keys)[:8]}...)")


def cfg_from_reference_kwargs(kwargs: Dict[str, Any], model_name: str) -> ModelConfig:
    """The reference's get_kwargs dict (tensorBase.py:136-158) as a
    ModelConfig."""
    return ModelConfig(
        model_name=model_name,
        density_n_comp=_comp(kwargs["density_n_comp"]),
        app_n_comp=_comp(kwargs["appearance_n_comp"]),
        app_dim=int(kwargs["app_dim"]),
        density_shift=float(kwargs["density_shift"]),
        distance_scale=float(kwargs["distance_scale"]),
        alpha_mask_thres=float(kwargs["alphaMask_thres"]),
        ray_march_weight_thres=float(kwargs["rayMarch_weight_thres"]),
        fea2dense_act=str(kwargs["fea2denseAct"]),
        near_far=_near_far(kwargs),
        step_ratio=float(kwargs["step_ratio"]),
        shading_mode=str(kwargs["shadingMode"]),
        pos_pe=int(kwargs["pos_pe"]),
        view_pe=int(kwargs["view_pe"]),
        fea_pe=int(kwargs["fea_pe"]),
        feature_c=int(kwargs["featureC"]),
    )


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _plane(arr) -> np.ndarray:
    """(1, R, H, W) -> (H, W, R)."""
    a = _np(arr)
    if a.ndim != 4 or a.shape[0] != 1:
        raise ValueError(f"reference plane factor must be (1, R, H, W), got {a.shape}")
    return _f32(a[0].transpose(1, 2, 0))


def _line(arr) -> np.ndarray:
    """(1, R, L, 1) -> (L, R)."""
    a = _np(arr)
    if a.ndim != 4 or a.shape[0] != 1 or a.shape[-1] != 1:
        raise ValueError(f"reference line factor must be (1, R, L, 1), got {a.shape}")
    return _f32(a[0, :, :, 0].T)


def _render_params(sd: Dict[str, np.ndarray], shading_mode: str) -> Dict[str, np.ndarray]:
    """renderModule.mlp.{0,2,4}.{weight,bias} -> render/l{1,2,3}/{w,b}: the
    linear layers sit at the Sequential's slots 0/2/4 with ReLUs between
    (models/mlp.py:38); SH and RGB have no parameters on either side."""
    if not shading_mode.startswith("MLP"):
        return {}
    out = {}
    for ours, slot in (("l1", 0), ("l2", 2), ("l3", 4)):
        out[f"render/{ours}/w"] = _f32(_np(sd[f"renderModule.mlp.{slot}.weight"]).T)
        out[f"render/{ours}/b"] = _f32(_np(sd[f"renderModule.mlp.{slot}.bias"]))
    return out


def convert_reference_state_dict(
    model_name: str, sd: Dict[str, np.ndarray], shading_mode: str
) -> Tuple[Dict[str, np.ndarray], Tuple[int, int, int]]:
    """A reference state dict -> (flat params under the JAX keys, grid size
    (X, Y, Z)).  The grid comes from the factors' own shapes (plane i is
    (1, R, grid[m1], grid[m0]), line i (1, R, grid[vec_i], 1); reference
    tensoRF.py:152-162), so a shrunk, anisotropic grid converts exactly."""
    flat: Dict[str, np.ndarray] = {"basis": _f32(_np(sd["basis_mat.weight"]).T)}
    if model_name == "TensorVMSplit":
        for field in ("density", "app"):
            for i in range(3):
                flat[f"{field}_plane/{i}"] = _plane(sd[f"{field}_plane.{i}"])
                flat[f"{field}_line/{i}"] = _line(sd[f"{field}_line.{i}"])
        # plane 0 spans axes (0, 1) as (H = grid[1], W = grid[0]); line 0
        # runs along VEC_MODE[0] = 2
        p0, l0 = flat["density_plane/0"], flat["density_line/0"]
        grid = (p0.shape[1], p0.shape[0], l0.shape[0])
    elif model_name == "TensorCP":
        for field in ("density", "app"):
            for i in range(3):
                flat[f"{field}_line/{i}"] = _line(sd[f"{field}_line.{i}"])
        # lines run along VEC_MODE = (2, 1, 0)
        grid = tuple(flat[f"density_line/{i}"].shape[0] for i in (2, 1, 0))
    elif model_name == "TensorVM":
        pc, lc = _np(sd["plane_coef"]), _np(sd["line_coef"])
        if pc.ndim != 4 or pc.shape[0] != 3:
            raise ValueError(f"legacy plane_coef must be (3, C, res, res), got {pc.shape}")
        for i in range(3):
            flat[f"plane/{i}"] = _f32(pc[i].transpose(1, 2, 0))
            flat[f"line/{i}"] = _f32(lc[i, :, :, 0].T)
        p0, l0 = flat["plane/0"], flat["line/0"]
        grid = (p0.shape[1], p0.shape[0], l0.shape[0])
    else:
        raise ValueError(f"unknown model {model_name}")
    flat.update(_render_params(sd, shading_mode))
    return flat, tuple(int(g) for g in grid)


def _alpha_mask_from(ckpt: Dict[str, Any], device) -> Optional[AlphaGridMask]:
    if "alphaMask.aabb" not in ckpt:
        return None
    # the saved shape is the viewed (1, 1, Z, Y, X) tensor's
    # (tensorBase.py:166); the volume is its last three dimensions
    shape = tuple(int(s) for s in _np(ckpt["alphaMask.shape"]).reshape(-1))[-3:]
    return unpack_mask({
        "alphaMask.shape": np.asarray(shape, np.int64),
        "alphaMask.mask": _np(ckpt["alphaMask.mask"]).astype(np.uint8),
        "alphaMask.aabb": _np(ckpt["alphaMask.aabb"]).astype(np.float32),
    }, device=device)


def load_reference_checkpoint(path: str, device=None):
    """A reference ``.th`` -> (cfg, field, aabb (2, 3) float32, grid_size,
    alpha_mask|None, None): the return of ``utils/ckpt.py::load_checkpoint``,
    the field and mask on ``device`` (cuda unless asked)."""
    from .ckpt import field_from_params

    device = resolve_device(device)
    ckpt = torch_load_safe(path)
    sd = {k: _np(v) for k, v in ckpt["state_dict"].items()}
    kwargs = ckpt["kwargs"]
    model_name = infer_model_name(sd.keys())
    cfg = cfg_from_reference_kwargs(kwargs, model_name)
    flat, grid_size = convert_reference_state_dict(model_name, sd, cfg.shading_mode)
    if "gridSize" in kwargs:
        saved = tuple(int(g) for g in _np(kwargs["gridSize"]).reshape(-1))
        if saved != grid_size:
            raise ValueError(f"checkpoint kwargs gridSize {saved} disagrees with the factor "
                             f"shapes ({grid_size}) — truncated/corrupt .th?")
    aabb = _np(kwargs["aabb"]).astype(np.float32).reshape(2, 3)
    field = field_from_params(cfg, grid_size, flat, device)
    return cfg, field, aabb, grid_size, _alpha_mask_from(ckpt, device), None


def convert(path_in: str, path_out: str) -> str:
    """Offline conversion of a reference ``.th`` into the port's ``.npz``
    (which the JAX package loads too); returns the path written."""
    from .ckpt import save_checkpoint

    _, field, aabb, _, alpha_mask, _ = load_reference_checkpoint(path_in, "cpu")
    return save_checkpoint(path_out, field, aabb, alpha_mask)
