"""The field modules: what the benchmark knows of one kind of field's
factor layout, one file each, ``fields/<model_name>.py``, which the
configuration selects by its ``train.model_name``.  The rest of the
harness (the made state's schedule walk, mask, basis and head in
``made.py``; ray sampling, the MLP_Fea head, compositing, the loss and
Adam in ``reference.py``; the basis, head and step FLOPs in ``counts.py``)
knows no factor layout and calls the module.  A new kind of field adds its
file here and nothing else.

``load(model_name, shading_mode)`` finds ``fields/<model_name>.py`` by
path, checks that it has the interface below and returns it.  A
configuration whose field has no file, or whose head is not MLP_Fea (the
only head the reference has), fails there, before anything is built.

The interface.  ``P`` maps the port's parameter names to tensors: the
field's factors under the names ``make_factors`` gives them, ``basis``
(sum(n_lamb_sh), data_dim_color) and the head's ``render.l{1,2,3}.{w,b}``;
``cfg`` is the port's ``TrainConfig`` as the configuration file builds it.

* ``HAS_ORTHO: bool`` -- whether the field has an ortho term; the
  configuration's ``Ortho_weight`` counts only where it has.
* ``make_factors(cfg, grid, occ, visible, amplitude, gen, device) -> dict``
  -- the field's factors at the segment's grid (X, Y, Z), each drawn from
  the card-side generator ``gen`` in a fixed order, as the port's
  parameters of that name are shaped.  ``occ`` is the (X, Y, Z) bool
  occupancy of the scene on the grid's lattice, or None in the first
  segment (the init draw alone, step 0 of a reconstruction); in a late
  segment the density factors add a profile of ``occ`` whose sum reaches
  about 3 x ``amplitude`` inside the objects, on the first
  ``visible(R)`` of a factor's R ranks (those FreeNeRF's mask leaves
  visible at the segment's first step).  The harness draws the basis and
  the head from ``gen`` after this.
* ``density_feature(P, xyz, masks) -> (M,)`` -- the density feature
  before the activation at ``xyz`` (M, 3), the box mapped to [-1, 1];
  ``masks`` is None or FreeNeRF's rank masks, one a component of
  ``n_lamb_sigma`` (``reference.masks_at``).
* ``app_features(P, xyz, masks) -> (M, sum(n_lamb_sh))`` -- the
  appearance features before the basis, ``masks`` as above over
  ``n_lamb_sh``; the reference multiplies them by ``P["basis"]``.
* ``ortho(P, prec) -> scalar`` -- the ortho term before its weight, its
  matrix products through ``prec.matmul``; read only where ``HAS_ORTHO``.
* ``l1(P) -> scalar`` -- the L1 term of the density factors before its
  weight.
* ``tv(P, kind) -> scalar`` -- the TV term of ``kind`` ("density" or
  "app") before its weight and decay, with the model's own factor.
* ``density_flops(cfg) -> int`` -- FLOPs a density read takes a sample
  (a multiply-add counts 2).
* ``app_read_flops(cfg) -> int`` -- FLOPs the appearance features take a
  shaded sample, before the basis.

``reference.py`` has the plain pieces a module reads its factors with:
``bilinear(plane (H, W, C), u, v)``, ``linear(line (L, C), w)`` (align
corners, zeros outside) and ``tv2d(plane)``.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
INTERFACE = ("HAS_ORTHO", "make_factors", "density_feature", "app_features", "ortho", "l1",
             "tv", "density_flops", "app_read_flops")
HEADS = ("MLP_Fea",)


def load(model_name: str, shading_mode: str, root: Path = HERE) -> ModuleType:
    """The field module of ``model_name``, ``<root>/<model_name>.py``."""
    if shading_mode not in HEADS:
        raise ValueError(
            f"shadingMode {shading_mode!r}: the reference has only the {', '.join(HEADS)} "
            "head (portbench/reference.py::radiance); another head needs its own there first")
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", model_name):
        raise ValueError(f"model_name {model_name!r} names no field module")
    path = Path(root) / f"{model_name}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"model_name {model_name!r} has no field module: {path} does not exist "
            "(a new kind of field adds that file; portbench/fields/__init__.py says what it has)")
    spec = importlib.util.spec_from_file_location(f"portbench_field_{model_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [n for n in INTERFACE if not hasattr(mod, n)]
    if missing:
        raise AttributeError(f"{path} lacks {', '.join(missing)} of the field interface")
    return mod
