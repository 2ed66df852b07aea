"""Training-progress visualization: per-checkpoint figures and the GIF (a
copy of tensorf_tpu/eval/vis.py, rendering through the port's
RendererHandle).

Counterparts of save_rendered_image_per_train (reference renderer.py:42-146)
— a 3x2 matplotlib figure with train/test renders, depths, and loss/PSNR
curves — and create_gif (renderer.py:29-39).  matplotlib and imageio are
imported inside the functions, so the package imports without them.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..utils.misc import visualize_depth_numpy


def create_gif(path_to_dir: str, name_gif: str):
    if not os.path.exists(path_to_dir):
        return
    import imageio.v2 as imageio

    filenames = sorted(
        os.listdir(path_to_dir), key=lambda x: int(x.split(".")[0])
    )
    if not filenames:
        return
    images = [
        imageio.imread(os.path.join(path_to_dir, f)) for f in filenames
    ]
    imageio.mimsave(name_gif, images, "GIF", duration=5.0)


def save_rendered_image_per_train(
    train_dataset,
    test_dataset,
    handle,
    step: int,
    logs: Dict[str, List],
    savePath: str,
    chunk: int = 4096,
):
    """Render one train + one test view and plot them with the loss/PSNR
    history; saves to <savePath>/plot/vis_every/<step>.png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(savePath, exist_ok=True)
    os.makedirs(os.path.join(savePath, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(savePath, "rgbd"), exist_ok=True)
    os.makedirs(os.path.join(savePath, "plot", "vis_every"), exist_ok=True)

    panels = {}
    for name, ds in (("train", train_dataset), ("test", test_dataset)):
        if ds is None or ds.all_rays.shape[0] == 0:
            continue
        W, H = ds.img_wh
        rays = np.asarray(ds.all_rays[0]).reshape(-1, 6)
        rgb, depth, _ = handle.render(rays, chunk=chunk)
        rgb = np.clip(rgb, 0, 1).reshape(H, W, 3)
        depth_vis, _ = visualize_depth_numpy(
            depth.reshape(H, W), ds.near_far
        )
        panels[name] = (rgb, depth_vis[..., ::-1] / 255.0)

    fig, axes = plt.subplots(3, 2, figsize=(10, 12))
    for col, name in enumerate(("train", "test")):
        if name in panels:
            axes[0][col].imshow(panels[name][0])
            axes[1][col].imshow(panels[name][1])
        axes[0][col].set_title(f"{name} rgb @ {step}")
        axes[1][col].set_title(f"{name} depth @ {step}")
        axes[0][col].axis("off")
        axes[1][col].axis("off")
    if logs.get("iteration"):
        axes[2][0].plot(logs["iteration"], logs.get("mse", []), label="mse")
        axes[2][0].set_title("loss")
        axes[2][0].legend()
        axes[2][1].plot(
            logs["iteration"], logs.get("train_psnr", []), label="train"
        )
        axes[2][1].plot(
            logs["iteration"], logs.get("test_psnr", []), label="test"
        )
        axes[2][1].set_title("PSNR")
        axes[2][1].legend()
    fig.tight_layout()
    fig.savefig(os.path.join(savePath, "plot", "vis_every", f"{step}.png"))
    plt.close(fig)
