"""Carry weights across between the port and the JAX package.

The JAX params pytree flattens (tensorf_tpu/utils/ckpt.py::_flatten) to
``{"density_plane/0": ndarray, ..., "render/l1/w": ndarray}``.  Both
packages keep the same layout, so the port's state-dict names are those
keys with '/' -> '.', and the arrays cross unchanged.

The optimizer state crosses as the ordered leaves of the JAX package's
optax ``multi_transform`` state (tensorf_tpu/train/optim.py), the layout
of a resumable checkpoint's ``opt/`` entries: per group in label order
(``network``, then ``spatial``), ``ScaleByAdamState(count, mu, nu)`` then
``ScaleByScheduleState(count)``, where ``mu`` and ``nu`` hold that
group's parameters in the params pytree's flatten order (dict keys sorted,
tuple items in order) and the counts are int32 scalars.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from .models.tensorf import spatial_label_tree


def params_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX params -> a state dict for a field's ``load_state_dict``
    (float32 CPU tensors; ``load_state_dict`` copies them to the field's
    device and rejects missing or unexpected names)."""
    return {
        key.replace("/", "."): torch.from_numpy(np.array(value, dtype=np.float32))
        for key, value in flat.items()
    }


def params_to_jax(field: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_jax``: a field's parameters as flat JAX
    keys ('.' -> '/') with float32 numpy arrays."""
    return {
        name.replace(".", "/"): p.detach().cpu().numpy().astype(np.float32)
        for name, p in field.named_parameters()
    }


# optax's multi_transform keeps its inner states in a dict: sorted labels
OPT_GROUPS = ("network", "spatial")


def _jax_order(key: str):
    return tuple(int(c) if c.isdigit() else c for c in key.split("/"))


def _opt_layout(field: torch.nn.Module) -> List[tuple]:
    """(label, [(jax key, param), ...] in the params pytree's flatten
    order) per optax group; ``TwoGroupAdam`` groups by the same labels."""
    labels = spatial_label_tree(field)
    return [(label, sorted(((name.replace(".", "/"), p) for name, p in field.named_parameters()
                            if labels[name] == label), key=lambda kv: _jax_order(kv[0])))
            for label in OPT_GROUPS]


def optimizer_to_jax(optimizer, field: torch.nn.Module) -> List[np.ndarray]:
    """A ``TwoGroupAdam``'s state as the JAX optax state's ordered leaves
    (zero moments and counts before its first step)."""
    leaves: List[np.ndarray] = []
    count = np.int32(optimizer.schedule_count)
    for _, params in _opt_layout(field):
        states = [optimizer.adam.state.get(p, {}) for _, p in params]
        steps = {int(s["step"]) for s in states if "step" in s}
        assert len(steps) <= 1, steps
        leaves.append(np.int32(steps.pop() if steps else 0))
        for moment in ("exp_avg", "exp_avg_sq"):
            for (_, p), s in zip(params, states):
                m = s.get(moment)
                leaves.append(np.zeros(tuple(p.shape), np.float32) if m is None
                              else m.detach().cpu().numpy().astype(np.float32))
        leaves.append(count)
    return leaves


def optimizer_from_jax(optimizer, field: torch.nn.Module, leaves: Sequence[np.ndarray]) -> None:
    """Load ordered optax leaves (``optimizer_to_jax``'s layout) into a
    fresh ``TwoGroupAdam`` over ``field``: the moments, the Adam step count
    and the LR decay's position.  Raises ValueError, changing nothing, when
    the leaves do not fit the field's parameters."""
    layout = _opt_layout(field)
    want = sum(2 + 2 * len(params) for _, params in layout)
    if len(leaves) != want:
        raise ValueError(f"{len(leaves)} optimizer leaves, the field needs {want}")
    pos, plan, sched = 0, [], set()
    for label, params in layout:
        count = int(np.asarray(leaves[pos]))
        mu = leaves[pos + 1: pos + 1 + len(params)]
        nu = leaves[pos + 1 + len(params): pos + 1 + 2 * len(params)]
        pos += 1 + 2 * len(params)
        sched.add(int(np.asarray(leaves[pos])))
        pos += 1
        for (key, p), m, v in zip(params, mu, nu):
            if tuple(np.shape(m)) != tuple(p.shape) or tuple(np.shape(v)) != tuple(p.shape):
                raise ValueError(f"{label} moment of {key}: shape {np.shape(m)}, "
                                 f"parameter {tuple(p.shape)}")
            plan.append((p, count, m, v))
    if len(sched) != 1:
        raise ValueError(f"the groups' schedule counts differ: {sorted(sched)}")
    optimizer.adam.state.clear()
    for p, count, m, v in plan:
        if count > 0:
            optimizer.adam.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.as_tensor(np.array(m, np.float32), device=p.device),
                "exp_avg_sq": torch.as_tensor(np.array(v, np.float32), device=p.device),
            }
    optimizer.set_schedule_count(sched.pop())
