"""Self-describing ``.npz`` checkpoints in the layout of
tensorf_tpu/utils/ckpt.py, so a checkpoint loads in either package.

Entries: every parameter under ``params/<flat JAX key>`` (channels-last
planes, lines, basis, the shading MLP), ``kwargs`` (the JSON of the
ModelConfig fields plus ``gridSize`` and ``extra``), ``aabb`` (2, 3) and,
with a mask, ``alphaMask.{shape,mask,aabb}`` bit-packed.  A resumable
checkpoint also carries the optimizer state as ordered leaves
``opt/{i:05d}`` (the leaf order of the JAX package's optax state,
convert.py::optimizer_to_jax) and free-form ``aux/<name>`` arrays (sampler
state, history rows), which ``load_opt_leaves`` and ``load_aux`` read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..convert import params_from_jax, params_to_jax
from ..models.alpha_mask import AlphaGridMask, pack_mask, unpack_mask
from ..models.config import ModelConfig
from ..models.tensorf import FIELD_MODELS
from .device import resolve_device


def save_checkpoint(
    path: str,
    field,
    aabb,
    alpha_mask: Optional[AlphaGridMask] = None,
    extra: Optional[Dict[str, Any]] = None,
    opt_leaves: Optional[Sequence[np.ndarray]] = None,
    aux: Optional[Dict[str, np.ndarray]] = None,
) -> str:
    """Write ``field`` (its cfg, grid and params), ``aabb``, the mask and,
    for a resumable checkpoint, the optimizer leaves and aux arrays to
    ``path`` through a ``.tmp`` file renamed into place (a kill mid-write
    never corrupts the checkpoint a resume depends on); returns the path
    written (``.npz`` appended when missing)."""
    entries: Dict[str, np.ndarray] = {
        f"params/{k}": v for k, v in params_to_jax(field).items()
    }
    kwargs = dataclasses.asdict(field.cfg)
    kwargs["gridSize"] = [int(g) for g in field.grid_size]
    if extra:
        kwargs["extra"] = extra
    entries["kwargs"] = np.frombuffer(json.dumps(kwargs).encode(), dtype=np.uint8)
    entries["aabb"] = np.asarray(aabb, np.float32).reshape(2, 3)
    if alpha_mask is not None:
        entries.update(pack_mask(alpha_mask))
    for i, leaf in enumerate(opt_leaves or ()):
        entries[f"opt/{i:05d}"] = np.asarray(leaf)
    for k, v in (aux or {}).items():
        entries[f"aux/{k}"] = np.asarray(v)
    tmp = f"{path}.tmp"
    np.savez(tmp, **entries)  # np.savez appends .npz
    final = path if path.endswith(".npz") else f"{path}.npz"
    os.replace(f"{tmp}.npz", final)
    return final


def field_from_params(cfg: ModelConfig, grid_size, flat: Dict[str, np.ndarray], device):
    """A field of ``cfg``'s model on ``grid_size`` holding the flat JAX-keyed
    params ``flat``, on ``device``."""
    if cfg.model_name not in FIELD_MODELS:
        raise ValueError(f"unknown model {cfg.model_name!r}")
    field = FIELD_MODELS[cfg.model_name](cfg, grid_size, device)
    field.load_state_dict(params_from_jax(flat))
    return field


def load_checkpoint(path: str, device=None):
    """Returns (cfg, field, aabb (2, 3) float32, grid_size, alpha_mask|None,
    extra), the field and mask on ``device`` (cuda unless asked).

    A reference PyTorch ``.th`` checkpoint is read as it is (converted in
    memory by utils/import_torch.py), so every ``--ckpt`` entry point takes
    checkpoints the reference trained."""
    if path.endswith(".th"):
        from .import_torch import load_reference_checkpoint

        return load_reference_checkpoint(path, device)
    device = resolve_device(device)
    data = np.load(path, allow_pickle=False)
    kwargs = json.loads(bytes(data["kwargs"]).decode())
    grid_size = tuple(int(g) for g in kwargs.pop("gridSize"))
    extra = kwargs.pop("extra", None)
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{
        k: (tuple(v) if isinstance(v, list) else v) for k, v in kwargs.items() if k in names
    })
    field = field_from_params(cfg, grid_size, {
        k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")
    }, device)
    alpha_mask = None
    if "alphaMask.mask" in data.files:
        alpha_mask = unpack_mask(
            {k: data[k] for k in ("alphaMask.shape", "alphaMask.mask", "alphaMask.aabb")},
            device=device,
        )
    return cfg, field, np.asarray(data["aabb"], np.float32), grid_size, alpha_mask, extra


def load_opt_leaves(path: str) -> Optional[List[np.ndarray]]:
    """The ordered optimizer leaves of a resumable checkpoint (None when it
    carries none, as a reference ``.th`` never does)."""
    if path.endswith(".th"):
        return None
    data = np.load(path, allow_pickle=False)
    keys = sorted(k for k in data.files if k.startswith("opt/"))
    return [data[k] for k in keys] if keys else None


def load_aux(path: str) -> Dict[str, np.ndarray]:
    """The ``aux/`` arrays of a checkpoint, by name (empty without them)."""
    if path.endswith(".th"):
        return {}
    data = np.load(path, allow_pickle=False)
    return {k[len("aux/"):]: data[k] for k in data.files if k.startswith("aux/")}
