"""The harness on the card at a tiny size: the port's CUDA kernels (the
scatter-add's backward) against the reference.  Run on the card with
``python -m pytest -p no:cacheprovider portbench/tests -m cuda``."""

import pytest
import torch

from .tiny import assert_agrees


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["synth_full.train", "flower.train",
                                  "synth_full.serve"])
def test_tiny_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels run only there")
    from tensorf_tpu_torch.utils.device import resolve_device
    assert_agrees(name, resolve_device("cuda"))
