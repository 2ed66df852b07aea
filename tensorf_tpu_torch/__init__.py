"""tensorf_tpu_torch — the PyTorch/CUDA port of tensorf_tpu for NVIDIA Hopper.

Mirrors ``tensorf_tpu``'s module tree and names so each counterpart is easy
to find.  Parameters keep the JAX layout (channels-last planes ``(H, W, R)``,
lines ``(L, R)``, ``w (in, out)``) so checkpoints and tests carry across.
The package imports torch only, never jax and nothing of ``tensorf_tpu``.
"""

from .utils.device import resolve_device

__all__ = ["resolve_device"]
