"""Epoch-free random ray-batch sampler (counterpart of
tensorf_tpu/train/sampler.py::SimpleSampler, driven by a torch.Generator).
The stratified sampler is not ported yet."""

from __future__ import annotations

import torch


class SimpleSampler:
    """Random-permutation batch sampler over a flat ray store.

    Draws the permutations on the CPU from a seeded generator, so the id
    stream is the same on every device.
    """

    def __init__(self, total: int, batch: int, seed: int = 20211202):
        if total <= 0:
            raise ValueError(f"SimpleSampler: empty ray store (total={total})")
        self.total = total
        self.batch = batch
        self.curr = total
        self.ids = None
        self._gen = torch.Generator().manual_seed(int(seed))

    def nextids(self) -> torch.Tensor:
        """The next (batch,) int64 CPU tensor of store ids."""
        if self.batch > self.total:
            # a store smaller than the batch: tile fresh permutations so the
            # batch shape stays fixed
            reps = -(-self.batch // self.total)
            ids = torch.cat(
                [torch.randperm(self.total, generator=self._gen) for _ in range(reps)]
            )
            return ids[: self.batch]
        self.curr += self.batch
        if self.curr + self.batch > self.total:
            self.ids = torch.randperm(self.total, generator=self._gen)
            self.curr = 0
        return self.ids[self.curr : self.curr + self.batch]
