"""Epoch-free random ray-batch samplers (counterpart of
tensorf_tpu/train/sampler.py, driven by torch.Generators).

``StratifiedSampler`` draws a fixed per-stratum quota each step from a
count-partitioned ray store (render/culling.py::stratify_rays); with
quotas proportional to stratum sizes every ray keeps about the per-step
inclusion probability of uniform sampling, while each sub-batch renders at
its own sample budget.  On a distributed run each rank draws only from
its id pool (``pool``, parallel/mesh.py::host_ray_pool) and its slice of
the global stratum plan (``localize_strata``).

``get_state``/``set_state`` carry a sampler across a resume: a json-able
meta (sizes, cursor) and arrays (the generator state, the permutation
being drawn and, stratified, the strata), so a resumed run draws the ids
an uninterrupted run draws.  They are the port's own: the JAX samplers
draw from numpy generators.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


class SimpleSampler:
    """Random-permutation batch sampler over a flat ray store.

    Draws the permutations on the CPU from a seeded generator, so the id
    stream is the same on every device.  ``pool`` (optional): draw from this
    array of store ids instead of ``range(total)`` — a distributed run keeps
    the store whole on every rank and gives each rank a disjoint id pool
    (parallel/mesh.py::host_ray_pool).
    """

    def __init__(self, total: int, batch: int, seed: int = 20211202, pool=None):
        if pool is not None:
            pool = torch.as_tensor(np.asarray(pool, np.int64))
            total = int(pool.numel())
        if total <= 0:
            # on a distributed run an empty pool would otherwise surface as a
            # hang at the other ranks' next collective
            raise ValueError(f"SimpleSampler: empty ray store (total={total}); on a "
                             "distributed run this means this rank's id pool is empty")
        self.total = total
        self.batch = batch
        self.curr = total
        self.ids = None
        self.pool = pool
        self._gen = torch.Generator().manual_seed(int(seed))

    def nextids(self) -> torch.Tensor:
        """The next (batch,) int64 CPU tensor of store ids."""
        out = self._next_positions()
        return out if self.pool is None else self.pool[out]

    def _next_positions(self) -> torch.Tensor:
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

    def get_state(self) -> Tuple[dict, Dict[str, np.ndarray]]:
        """(json-able meta, arrays) from which ``set_state`` continues this
        sampler's id stream exactly."""
        meta = dict(total=int(self.total), batch=int(self.batch), curr=int(self.curr),
                    has_ids=self.ids is not None)
        arrays = {"rng": self._gen.get_state().numpy()}
        if self.ids is not None:
            arrays["ids"] = self.ids.numpy()
        if self.pool is not None:
            arrays["pool"] = self.pool.numpy()
        return meta, arrays

    def set_state(self, meta: dict, arrays: Dict[str, np.ndarray]) -> None:
        if int(meta["total"]) != self.total or int(meta["batch"]) != self.batch:
            raise ValueError(
                f"sampler state mismatch: saved total/batch {meta['total']}/{meta['batch']} "
                f"vs {self.total}/{self.batch}"
            )
        self._gen.set_state(torch.from_numpy(np.array(arrays["rng"], np.uint8)))
        self.curr = int(meta["curr"])
        self.ids = torch.from_numpy(np.array(arrays["ids"], np.int64)) if meta["has_ids"] else None
        if "pool" in arrays:
            self.pool = torch.from_numpy(np.array(arrays["pool"], np.int64))


def allocate_quotas(
    sizes: Sequence[int], batch: int, round_to: int = 8
) -> List[int]:
    """Per-stratum batch quotas: proportional to stratum size, each a
    positive multiple of ``round_to`` (device-mesh shard alignment), summing
    to ``batch`` (largest-remainder rounding).  Each quota is additionally
    capped at its stratum's size (a quota beyond the stratum would make
    SimpleSampler return a short id array and change the compiled sub-batch
    shape); the residual is redistributed to strata with headroom."""
    assert batch % round_to == 0, (batch, round_to)
    assert len(sizes) * round_to <= batch, (sizes, batch, round_to)
    total = float(sum(sizes))

    def cap(i: int) -> int:
        # max quota stratum i can absorb: its size rounded down to round_to
        # (but at least round_to — a stratum smaller than round_to keeps a
        # round_to quota and oversamples; SimpleSampler tiles permutations
        # so the output shape stays fixed).
        return max(round_to, sizes[i] // round_to * round_to)

    raw = [batch * s / total for s in sizes]
    quotas = [
        min(cap(i), max(round_to, int(round(r / round_to)) * round_to))
        for i, r in enumerate(raw)
    ]
    # force the sum to `batch`: distribute the residual over strata in
    # descending size order, respecting each stratum's cap / floor
    diff = batch - sum(quotas)
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    for i in order:
        if diff == 0:
            break
        if diff > 0:
            take = min(diff, cap(i) - quotas[i])
        else:
            take = max(diff, round_to - quotas[i])
        quotas[i] += take
        diff -= take
    if diff > 0:
        # batch exceeds the total clamped capacity (tiny store): the
        # largest stratum absorbs the rest and oversamples — SimpleSampler
        # tiles permutations, so the sub-batch shape stays fixed
        quotas[order[0]] += diff
        diff = 0
    assert diff == 0 and all(q >= round_to for q in quotas), (
        quotas, sizes, batch
    )
    return quotas


def localize_strata(
    strata: Sequence[np.ndarray],
    counts: np.ndarray,
    pool: np.ndarray,
    fallback_max: int,
) -> List[np.ndarray]:
    """Per-rank slice of a GLOBAL stratum plan (distributed layout; a copy
    of tensorf_tpu/train/sampler.py::localize_strata).

    Every rank computes the same ``strata`` over the identical full store;
    rank r then draws only from ``pool`` (its disjoint id subset).  A
    stratum whose pool slice is empty borrows lower-count pool rays (they
    fit the stratum budget exactly); the whole pool only as a last resort.
    """
    in_pool = np.zeros(counts.size, bool)
    in_pool[pool] = True
    out = []
    for sel in strata:
        loc = sel[in_pool[sel]]
        if loc.size == 0:
            bound = int(counts[sel].max()) if sel.size else int(fallback_max)
            cand = pool[counts[pool] <= bound]
            loc = cand if cand.size else pool
        out.append(loc)
    return out


class StratifiedSampler:
    """Fixed per-stratum quota sampler over a partitioned ray store.

    ``strata``: per-stratum arrays of store ids; ``quotas``: rays drawn per
    stratum each step (see allocate_quotas).  Stratum i draws from its own
    SimpleSampler seeded ``seed + 7919 * i``.
    """

    def __init__(self, strata: Sequence, quotas: Sequence[int], seed: int = 20211202):
        assert len(strata) == len(quotas)
        self.strata = [torch.as_tensor(np.asarray(s, np.int64)) for s in strata]
        self.quotas = [int(q) for q in quotas]
        self.samplers = [
            SimpleSampler(len(s), q, seed + 7919 * i)
            for i, (s, q) in enumerate(zip(self.strata, self.quotas))
        ]

    def nextids(self) -> Tuple[torch.Tensor, ...]:
        """One (quota,) int64 CPU tensor of store ids per stratum."""
        return tuple(s[smp.nextids()] for s, smp in zip(self.strata, self.samplers))

    def get_state(self) -> Tuple[dict, Dict[str, np.ndarray]]:
        """(json-able meta, arrays): the quotas, each stratum's ids and each
        stratum sampler's state; rebuild with ``from_state``."""
        metas, arrays = [], {}
        for i, (stratum, smp) in enumerate(zip(self.strata, self.samplers)):
            m, a = smp.get_state()
            metas.append(m)
            arrays[f"strata/{i}"] = stratum.numpy()
            arrays.update({f"{k}/{i}": v for k, v in a.items()})
        return {"quotas": list(self.quotas), "samplers": metas}, arrays

    @classmethod
    def from_state(cls, meta: dict, arrays: Dict[str, np.ndarray]) -> "StratifiedSampler":
        n = len(meta["samplers"])
        smp = cls([arrays[f"strata/{i}"] for i in range(n)], meta["quotas"])
        for i, (sub, m) in enumerate(zip(smp.samplers, meta["samplers"])):
            sub.set_state(m, {k: arrays[f"{k}/{i}"] for k in ("rng", "ids", "pool")
                              if f"{k}/{i}" in arrays})
        return smp
