"""Length-bucketed padded batching — replaces the reference's per-example loops.

Reference parity: SURVEY.md §2.1/§4.1 — the reference iterated Python loops
over single examples (Keras ``predict(x)`` per pair).  TPU-native design
(SURVEY §9.3 item 2): variable caption lengths / pair counts / box counts are
quantized to a **fixed bucket inventory** so XLA compiles one program per
bucket shape instead of one per example shape; padding is masked end-to-end.

The bucketizer is pure numpy (host side); jit-compiled consumers see only
static shapes.  Tests assert (a) no example is dropped, (b) pad positions are
mask-zero, (c) compile count stays bounded by the bucket inventory.

The port's own copy of ``icl/data/buckets.py``: ``icl_torch`` imports
nothing of the JAX package, and ``tests/test_torch_data.py`` holds the two
copies to the same outputs.  Rationale below is the original's; where it
names XLA or the TPU, read PyTorch and the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Bucket inventory: sorted length boundaries (inclusive caps)."""

    boundaries: tuple[int, ...] = (8, 16, 24, 40)

    def bucket_of(self, length: int, strict: bool = False) -> int:
        """Smallest boundary >= length.

        Overflow beyond the largest boundary rounds up to the next multiple
        of 8 (one extra compiled shape per distinct outlier size) instead of
        clamping — clamping would silently drop data (mentions/pairs/boxes),
        which downstream id bookkeeping treats as a hard error.  Pass
        ``strict=True`` to clamp (only for callers that tolerate truncation).
        """
        for b in self.boundaries:
            if length <= b:
                return b
        if strict:
            return self.boundaries[-1]
        return ((length + 7) // 8) * 8


@dataclasses.dataclass
class Batch:
    """A padded batch; arbitrary named arrays + a validity mask + ids.

    ``valid`` marks real rows (False rows are batch padding); per-array
    sequence masks live inside ``arrays`` (e.g. ``token_mask``).
    """

    arrays: dict[str, np.ndarray]
    valid: np.ndarray          # bool[batch]
    ids: list[str]             # only the valid rows' example ids

    @property
    def size(self) -> int:
        return int(self.valid.shape[0])

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())


class Bucketizer:
    """Groups examples by quantized length and emits fixed-shape batches.

    Every emitted batch has exactly ``batch_size`` rows (short final groups
    are padded with repeated row 0 and masked out via ``valid``), so the set
    of compiled shapes is |buckets| × 1.
    """

    def __init__(self, spec: BucketSpec, batch_size: int):
        self.spec = spec
        self.batch_size = batch_size

    def batches(
        self,
        lengths: Sequence[int],
        arrays: dict[str, np.ndarray],
        ids: Sequence[str],
        shuffle_rng: np.random.Generator | None = None,
        pad_axis_keys: dict[str, int] | None = None,
        skip: int = 0,
    ) -> Iterator[tuple[int, Batch]]:
        """Yield (bucket_len, Batch).

        Args:
          lengths: per-example true length used for bucketing.
          arrays: name → array with leading example axis; arrays named in
            ``pad_axis_keys`` are cropped along the given axis to bucket_len.
          ids: per-example ids.
          shuffle_rng: optional rng; shuffles examples within buckets and
            bucket emission order (deterministic given the rng seed).
          skip: drop the first N batches of the schedule without building
            them (resume support — no host-side replay of trained batches).
        """
        lengths = np.asarray(lengths)
        if len(lengths) != len(ids):
            # a silent mismatch would schedule only min(len) examples,
            # violating the no-example-dropped invariant below
            raise ValueError(f"lengths ({len(lengths)}) and ids "
                             f"({len(ids)}) disagree")
        order = np.arange(len(ids))
        by_bucket: dict[int, list[int]] = {}
        for i in order:
            by_bucket.setdefault(self.spec.bucket_of(int(lengths[i])), []).append(int(i))

        bucket_keys = sorted(by_bucket)
        if shuffle_rng is not None:
            for k in bucket_keys:
                shuffle_rng.shuffle(by_bucket[k])

        # Build the emission schedule: (bucket, start) chunks.
        schedule: list[tuple[int, list[int]]] = []
        for k in bucket_keys:
            idxs = by_bucket[k]
            for s in range(0, len(idxs), self.batch_size):
                schedule.append((k, idxs[s:s + self.batch_size]))
        if shuffle_rng is not None:
            shuffle_rng.shuffle(schedule)

        for bucket_len, chunk in schedule[skip:]:
            n = len(chunk)
            rows = np.asarray(chunk + [chunk[0]] * (self.batch_size - n))
            batch_arrays = {}
            for name, arr in arrays.items():
                take = arr[rows]
                axis = (pad_axis_keys or {}).get(name)
                if axis is not None:
                    width = take.shape[axis]
                    if bucket_len <= width:
                        take = np.take(take, np.arange(bucket_len),
                                       axis=axis)
                    else:
                        # overflow bucket rounded past the dataset's padded
                        # width (bucket_of rounds outliers UP to 8s): pad
                        # out instead of crashing the crop
                        pad = [(0, 0)] * take.ndim
                        pad[axis] = (0, bucket_len - width)
                        take = np.pad(take, pad)
                batch_arrays[name] = take
            valid = np.zeros(self.batch_size, dtype=bool)
            valid[:n] = True
            yield bucket_len, Batch(
                arrays=batch_arrays, valid=valid, ids=[ids[i] for i in chunk])
