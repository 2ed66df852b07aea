"""Dataset registry: the six loaders of tensorf_tpu/data by config name."""

from .blender import BlenderDataset
from .human import HumanDataset
from .llff import LLFFDataset
from .nsvf import NSVF
from .tankstemple import TanksTempleDataset
from .your_own_data import YourOwnDataset

dataset_dict = {
    "blender": BlenderDataset,
    "llff": LLFFDataset,
    "tankstemple": TanksTempleDataset,
    "nsvf": NSVF,
    "human": HumanDataset,
    "own_data": YourOwnDataset,
}
