"""Sharded infinite samplers with explicit advance/resume state (a copy of
pope_tpu/data/samplers.py, numpy only: the port imports nothing of the JAX
package).

Behavioral spec: dinov2/dinov2/data/samplers.py:100-230 (InfiniteSampler /
ShardedInfiniteSampler) — each rank draws an infinite stream of dataset
indices such that

  * within one "iteration" (one pass over a permutation of the dataset)
    the ranks' slices are DISJOINT strided shards of a single shared
    permutation (so every sample is seen once per iteration across the
    fleet, modulo the ``sample_count % step`` remainder the reference also
    drops);
  * each rank re-shuffles ITS slice per iteration with a seed derived from
    (seed, start, iter_count) — the reference's ``_make_seed`` — so whole
    permutations can be skipped arithmetically on resume;
  * ``advance=k`` reproduces the unadvanced stream with its first ``k``
    yields removed, with whole iterations skipped O(1) (no permutation is
    materialized for skipped iterations).

Numpy-native (no torch RNG): the base permutation and the per-iteration
slice shuffles come from ``np.random.default_rng``. Bit-streams therefore
differ from the torch reference, but every structural property above is
preserved and tested (tests/test_samplers.py).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


def _make_seed(seed: int, start: int, iter_count: int) -> int:
    """Per-(rank, iteration) reshuffle seed (samplers.py:160-162)."""
    return (seed + start + (iter_count << 24)) & 0x7FFFFFFF


@dataclass
class SamplerState:
    """The resumable state of one rank's sampler — small enough to ride in
    a checkpoint sidecar. ``consumed`` counts samples this rank has yielded
    since construction (callers track it as steps * per_rank_batch)."""

    sample_count: int
    seed: int
    start: int  # rank
    step: int  # world size
    consumed: int = 0
    shuffle: bool = True


class ShardedInfiniteSampler:
    """Infinite per-rank index stream over a shared epoch permutation.

    Parameters mirror the reference (samplers.py:166-183): ``start`` is the
    global rank, ``step`` the world size, ``advance`` the number of samples
    this rank already consumed (resume point).
    """

    def __init__(
        self,
        sample_count: int,
        shuffle: bool = True,
        seed: int = 0,
        start: int = 0,
        step: int = 1,
        advance: int = 0,
    ):
        if not (0 <= start < step):
            raise ValueError(f"start {start} must be in [0, step={step})")
        if sample_count < step:
            raise ValueError(
                f"sample_count {sample_count} < world size {step}: every "
                "iteration would yield nothing on some ranks"
            )
        self._sample_count = sample_count
        self._shuffle = shuffle
        self._seed = seed
        self._start = start
        self._step = step
        self._advance = advance

    @property
    def per_iter_count(self) -> int:
        """Samples each rank yields per iteration (the reference drops the
        ``sample_count % step`` remainder, samplers.py:131-134)."""
        return self._sample_count // self._step

    def state(self, consumed: int) -> SamplerState:
        return SamplerState(
            sample_count=self._sample_count,
            seed=self._seed,
            start=self._start,
            step=self._step,
            consumed=self._advance + consumed,
            shuffle=self._shuffle,
        )

    @classmethod
    def from_state(cls, st: SamplerState) -> "ShardedInfiniteSampler":
        return cls(
            sample_count=st.sample_count,
            shuffle=st.shuffle,
            seed=st.seed,
            start=st.start,
            step=st.step,
            advance=st.consumed,
        )

    def _slice(self, perm: np.ndarray, iter_count: int) -> np.ndarray:
        """This rank's reshuffled slice of the shared permutation for one
        iteration (``_new_shuffle_tensor_slice`` + ``_make_seed``)."""
        count = self.per_iter_count
        sl = perm[self._start :: self._step][:count]
        if not self._shuffle:
            return sl
        rs = np.random.default_rng(_make_seed(self._seed, self._start, iter_count))
        return sl[rs.permutation(count)]

    def __iter__(self) -> Iterator[int]:
        count = self.per_iter_count
        # whole skipped iterations cost O(1): only iter_count advances
        iter_count = self._advance // count
        skip = self._advance % count
        if self._shuffle:
            # one SHARED base permutation for all ranks (samplers.py:208-212):
            # rank-slices of it are disjoint by construction
            perm = np.random.default_rng(self._seed).permutation(self._sample_count)
        else:
            perm = np.arange(self._sample_count)

        def forever():
            ic = iter_count
            while True:
                yield from self._slice(perm, ic)
                ic += 1

        yield from itertools.islice(forever(), skip, None)


class InfiniteSampler(ShardedInfiniteSampler):
    """Single-iteration-permutation variant (samplers.py:57-121): the whole
    stream is one permutation repeated with fresh shuffles per cycle but NO
    shared cross-rank permutation — each rank slices a per-iteration
    permutation directly. Kept for parity of surface; the sharded variant
    is what the SSL driver uses."""

    def _slice(self, perm: np.ndarray, iter_count: int) -> np.ndarray:
        count = self.per_iter_count
        if not self._shuffle:
            return perm[self._start :: self._step][:count]
        rs = np.random.default_rng(_make_seed(self._seed, 0, iter_count))
        fresh = rs.permutation(self._sample_count)
        return fresh[self._start :: self._step][:count]
