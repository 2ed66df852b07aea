"""THuman2.0 render loader (blender-style transforms json); a copy of
tensorf_tpu/data/human.py.

The blender loader but for the Windows-path parsing of ``file_path``
(images live under ``<root>/<split>/<name>.png``) and the few-shot
selection by ``N_imgs``/``indexs``.
"""

from __future__ import annotations

import os
from typing import List, Union

from .blender import BlenderDataset


class HumanDataset(BlenderDataset):
    def __init__(
        self,
        datadir: str,
        split: str = "train",
        downsample: float = 1.0,
        is_stack: bool = False,
        N_vis: int = -1,
        N_imgs: int = 0,
        indexs: List[int] = (),
        num_images: Union[int, List[int], None] = -1,
        **kw,
    ):
        # the human loader's few-shot arguments onto the shared selection
        if len(indexs) > 0:
            num_images = list(indexs)
        elif N_imgs and N_imgs > 0:
            num_images = int(N_imgs)
        super().__init__(
            datadir,
            split=split,
            downsample=downsample,
            is_stack=is_stack,
            N_vis=N_vis,
            num_images=num_images,
            **kw,
        )

    def _frame_image_path(self, frame) -> str:
        file_path = frame["file_path"].split("\\")[-1].split(".")[-2]
        return os.path.join(self.root_dir, self.split, file_path + ".png")
