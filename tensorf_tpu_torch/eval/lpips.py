"""LPIPS (v0.1) perceptual distance in PyTorch: the counterpart of
tensorf_tpu/eval/lpips_jax.py, with the same weight files.

The reference scores each test view with the ``lpips`` package's AlexNet
and VGG distances (reference loss.py:144-159, renderer.py:186-198).  This
is the same metric as an ``nn.Module``: the scaling layer's shift and scale,
an AlexNet or VGG16 feature stack, channel-normalised activations at five
taps, squared differences weighted by the LPIPS calibration layers,
averaged over space and summed over the taps.

Weights are not in the repo.  Each net reads one ``lpips_{alex,vgg}.npz``
(the layout tensorf_tpu/eval/lpips_jax.py documents: ``conv{i}.w`` HWIO
and ``conv{i}.b`` in forward order, ``lin{k}.w`` (C_k,)) from
``TENSORF_LPIPS_DIR``, else from ``tensorf_tpu_torch/eval/weights/``;
nothing is downloaded.  Without the file ``lpips`` returns None, and the
evaluation writes NaN into mean.txt's LPIPS lines.  The convolutions run
in full float32 (``resolve_device`` turns cuDNN's TF32 off), as XLA runs
the JAX stack's.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

# (out_ch, kernel, stride, pad) per conv; a max pool runs before each conv
# listed in ``pool_before``; a tap is taken after the ReLU of each conv in
# ``taps``
_ALEX = {
    "convs": [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)],
    "pool_before": {1, 2},  # maxpool(3, 2) before conv2 and conv3
    "pool": 3,
    "taps": [0, 1, 2, 3, 4],
}
_VGG = {
    "convs": [
        (64, 3, 1, 1), (64, 3, 1, 1),
        (128, 3, 1, 1), (128, 3, 1, 1),
        (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1),
        (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1),
        (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1),
    ],
    "pool_before": {2, 4, 7, 10},  # maxpool(2, 2)
    "pool": 2,
    "taps": [1, 3, 6, 9, 12],
}
ARCHS = {"alex": _ALEX, "vgg": _VGG}
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def default_weights_dir() -> str:
    return os.environ.get(
        "TENSORF_LPIPS_DIR", os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights"))


def weights_path(net: str) -> str:
    return os.path.join(default_weights_dir(), f"lpips_{net}.npz")


@functools.lru_cache(maxsize=2)
def load_weights(net: str) -> Optional[Dict[str, np.ndarray]]:
    path = weights_path(net)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class LPIPS(nn.Module):
    """One net's LPIPS distance between batches of images."""

    def __init__(self, net: str, weights: Dict[str, np.ndarray]):
        super().__init__()
        self.arch = ARCHS[net]
        # HWIO -> OIHW, torch's layout
        self.w = nn.ParameterList(
            nn.Parameter(torch.from_numpy(np.ascontiguousarray(
                weights[f"conv{i}.w"].transpose(3, 2, 0, 1), np.float32)), requires_grad=False)
            for i in range(len(self.arch["convs"])))
        self.b = nn.ParameterList(
            nn.Parameter(torch.from_numpy(np.asarray(weights[f"conv{i}.b"], np.float32)),
                         requires_grad=False)
            for i in range(len(self.arch["convs"])))
        self.lin = nn.ParameterList(
            nn.Parameter(torch.from_numpy(np.asarray(weights[f"lin{k}.w"], np.float32)),
                         requires_grad=False)
            for k in range(len(self.arch["taps"])))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1))

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (N, 3, H, W) in [-1, 1] -> the tap activations."""
        x = (x - self.shift) / self.scale
        taps = []
        for i, (_, _, stride, pad) in enumerate(self.arch["convs"]):
            if i in self.arch["pool_before"]:
                x = F.max_pool2d(x, self.arch["pool"], stride=2)
            x = F.relu(F.conv2d(x, self.w[i], self.b[i], stride=stride, padding=pad))
            if i in self.arch["taps"]:
                taps.append(x)
        return taps

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """Images (N, 3, H, W) in [-1, 1] -> (N,) distances."""
        n = img0.shape[0]
        taps = self.taps(torch.cat([img0, img1]))
        total = torch.zeros(n, dtype=torch.float32, device=img0.device)
        for k, t in enumerate(taps):
            # channel-normalised, as lpips_jax.py: x / sqrt(sum_c x^2 + 1e-10)
            t = t / torch.sqrt(torch.sum(t * t, dim=1, keepdim=True) + 1e-10)
            diff = (t[:n] - t[n:]) ** 2
            total = total + torch.mean(
                torch.sum(diff * self.lin[k].view(1, -1, 1, 1), dim=1), dim=(1, 2))
        return total


@functools.lru_cache(maxsize=4)
def _net(net: str, device: str) -> Optional[LPIPS]:
    weights = load_weights(net)
    return None if weights is None else LPIPS(net, weights).to(device)


def clear_cache() -> None:
    """Forget the loaded weights and nets (after TENSORF_LPIPS_DIR changes)."""
    load_weights.cache_clear()
    _net.cache_clear()


def lpips(np_gt: np.ndarray, np_im: np.ndarray, net: str = "alex",
          device=None) -> Optional[float]:
    """LPIPS distance of two (H, W, 3) images in [0, 1] on ``device`` (cuda
    unless asked); None if the weight file for ``net`` is absent."""
    if load_weights(net) is None:
        return None
    device = resolve_device(device)
    model = _net(net, str(device))

    def nchw(img):
        x = torch.as_tensor(np.asarray(img, np.float32), device=device)
        return (x * 2.0 - 1.0).permute(2, 0, 1)[None]

    with torch.no_grad():
        return float(model(nchw(np_gt), nchw(np_im))[0])
