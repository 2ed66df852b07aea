"""Small host-side helpers: PSNR, depth visualization (a copy of
tensorf_tpu/utils/misc.py).

visualize_depth_numpy matches reference utils.py:72-87 (JET colormap over
min-positive..max normalized depth).  cv2 is used when it imports, else a
pure numpy JET.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover - environment without cv2
    _HAS_CV2 = False


def mse2psnr(mse: float) -> float:
    return float(-10.0 * np.log(mse) / np.log(10.0))


def _jet_numpy(x: np.ndarray) -> np.ndarray:
    """uint8 grayscale (H, W) -> BGR JET colormap, cv2-compatible."""
    t = x.astype(np.float32) / 255.0
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return (np.stack([b, g, r], axis=-1) * 255).astype(np.uint8)


def visualize_depth_numpy(depth: np.ndarray, minmax=None):
    """depth (H, W) -> (uint8 BGR colormap, [mi, ma])."""
    x = np.nan_to_num(depth)
    if minmax is None:
        positive = x[x > 0]
        mi = float(np.min(positive)) if positive.size else 0.0
        ma = float(np.max(x))
    else:
        mi, ma = float(minmax[0]), float(minmax[1])
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * np.clip(x, 0, 1)).astype(np.uint8)
    if _HAS_CV2:
        return cv2.applyColorMap(x, cv2.COLORMAP_JET), [mi, ma]
    return _jet_numpy(x), [mi, ma]
