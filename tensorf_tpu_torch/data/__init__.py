"""Dataset registry.  Only the blender loader is ported so far."""

from .blender import BlenderDataset

dataset_dict = {"blender": BlenderDataset}
