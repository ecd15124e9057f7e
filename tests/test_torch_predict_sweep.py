"""The task CLIs' shared ``--predict`` sweep (``icl_torch/cli/_predict.py``)
on the CPU, with a stand-in device output that counts its host reads.

For each example form (relation's ``(image, pair)`` index, affinity's
``(image, mention * B + box)`` index over the packed probabilities and
rank column, the mention tasks' leading rows) and each stream length
around the in-flight queue's depth: the batches come out in their input
order, each predict is read to the host once and at the queue's pace, and
the rows land in dataset order as a dict keyed by id, stacked in dataset
order, would put them (a repeated id reads its last row).  An empty split
gives and writes a ``(0, C)`` result.
"""

import json
import types

import numpy as np
import pytest
import torch

from icl_torch.cli import _predict
from icl_torch.data.buckets import Bucketizer, BucketSpec
from icl_torch.data.imagebatch import ImageBatch

C = 3        # columns of the stand-in output


class _Out:
    """A predict's device output: counts its ``.cpu()`` reads."""

    def __init__(self, arr, key, events):
        self.arr, self.key, self.events, self.reads = arr, key, events, 0

    def cpu(self):
        self.reads += 1
        self.events.append(("read", self.key))
        return self

    def numpy(self):
        return self.arr


def _dataset(n_batches, rng):
    """Dataset-order ids (one repeated, from two batches), and each
    batch's dataset positions, in a shuffled batch order; some batches
    hold no example."""
    sizes = rng.integers(0, 6, n_batches)
    if n_batches:
        sizes[0] = max(sizes[0], 1)
    n = int(sizes.sum())
    ids = [f"id{k}" for k in range(n)]
    if n > 1:
        ids[-1] = ids[0]
    order = rng.permutation(n)
    return ids, (np.split(order, np.cumsum(sizes)[:-1]) if n_batches
                 else [])


def _image_batches(form, ids, groups, rng):
    """ImageBatches whose ``out`` array is the predict's output: relation
    ``[I, P, C]``, affinity ``[I, M, B, C]`` (probabilities and rank)."""
    batches = []
    for k, pos in enumerate(groups):
        I = 2
        shape = (I, 4, 3) if form == "affinity" else (I, 12)
        out = rng.random(shape + (C,)).astype(np.float32)
        cells = rng.permutation(I * 12)[:len(pos)]
        id_index = [(int(c) // 12, int(c) % 12, ids[p])
                    for c, p in zip(cells, pos)]
        batches.append(ImageBatch(arrays={"out": out}, id_index=id_index,
                                  shape_key=(k,)))
    return batches


def _mention_batches(ids, rng):
    """A bucketizer's batches over the examples' numbers, 4 rows each."""
    n = len(ids)
    arrays = {"token_ids": np.arange(n, dtype=np.int32)[:, None],
              "lengths": np.ones(n, np.int32)}
    bz = Bucketizer(BucketSpec((1,)), batch_size=4)
    return [b for _, b in bz.batches(np.ones(n, np.int32), arrays, ids)]


def _dict_and_stack(form, batches, outputs, ids):
    """The per-id dict each CLI kept before the shared sweep, stacked in
    dataset order."""
    by_id = {}
    for b, out in zip(batches, outputs):
        if form == "mention":
            for row, eid in enumerate(b.ids):
                by_id[eid] = out[row]
        elif form == "affinity":
            B = out.shape[2]
            for s, cell, eid in b.id_index:
                by_id[eid] = out[(s, *divmod(cell, B))]
        else:
            for s, pi, eid in b.id_index:
                by_id[eid] = out[s, pi]
    return (np.stack([by_id[eid] for eid in ids]) if ids
            else np.zeros((0, C)))


def _in_flight_pace(n):
    """Predict k is dispatched, then the oldest read once more than
    IN_FLIGHT are queued; the rest drain in order."""
    events, queued = [], []
    for k in range(n):
        events.append(("predict", k))
        queued.append(k)
        if len(queued) > _predict.IN_FLIGHT:
            events.append(("read", queued.pop(0)))
    return events + [("read", k) for k in queued]


@pytest.mark.parametrize("form", ["relation", "affinity", "mention"])
@pytest.mark.parametrize("n_batches", [0, 1, 3, 4, 9])
def test_the_sweep_keeps_order_reads_once_and_scatters(form, n_batches,
                                                        tmp_path):
    rng = np.random.default_rng(n_batches)
    if form == "mention":
        n = 4 * (n_batches - 1) + 2 if n_batches else 0
        ids = [f"id{k}" for k in range(n)]
        if n > 1:
            ids[-1] = ids[0]
        batches = _mention_batches(ids, rng)
        where = _predict.mention_rows
    else:
        ids, groups = _dataset(n_batches, rng)
        batches = _image_batches(form, ids, groups, rng)
        where = _predict.image_rows
    assert len(batches) == n_batches
    events, outs, host = [], [], []

    def predict(a):
        k = len(outs)
        events.append(("predict", k))
        if form == "mention":
            rows = a["token_ids"].numpy()[:, :1].astype(np.float32)
            arr = rows * 10 + np.arange(C, dtype=np.float32)
        else:
            arr = a["out"].numpy()
        host.append(arr)
        # affinity's predict hands the packed [I, M, B, C] grid over as
        # [I, M * B, C], so that its index is (image, cell)
        outs.append(_Out(arr.reshape(arr.shape[0], -1, C)
                         if form == "affinity" else arr, k, events))
        return outs[-1]

    swept = list(_predict.sweep(iter(batches), torch.device("cpu"),
                                predict, where))
    assert [id(b) for b, _, _ in swept] == list(map(id, batches))  # order
    assert [o.reads for o in outs] == [1] * n_batches    # one read each
    assert events == _in_flight_pace(n_batches)

    outs.clear()
    host.clear()
    got = _predict.predict_in_order(iter(batches), torch.device("cpu"),
                                    predict, where, ids, "units", C, "t")
    want = _dict_and_stack(form, batches, host, ids)
    assert got.shape == (len(ids), C) and want.shape == got.shape
    np.testing.assert_array_equal(got, want)
    if not ids:
        args = types.SimpleNamespace(scores_file=str(tmp_path / "e.scores"),
                                     data_split="dev", data_dir=None)
        path = _predict.write_scores(args, "t", ("a", "b", "c"), ids, got,
                                     0, 0)
        assert open(path).read() == ""
        meta = json.load(open(path + ".meta.json"))
        assert meta["num_examples"] == 0 and meta["num_classes"] == C
