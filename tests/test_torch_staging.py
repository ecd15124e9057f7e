"""The pinned slab pool of the data layer and the one-copy staging it feeds
(``icl_torch/data/staging.py``), on the CPU.

A test pool stands in for page-locked memory and CUDA events: its slabs are
plain host tensors filled with 0xFF when allocated, and its events complete
only when a test says so.  The batchers, which pad into the process's pool
(``staging.POOL``), are held to the fresh ``np.zeros`` path byte for byte.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from icl_torch.data import staging
from icl_torch.data.imagebatch import AffinityBatcher, RelationBatcher
from icl_torch.data.pipeline import (AffinityDataset, AffinityImage,
                                     RelationDataset, RelationImage)
from icl_torch.util import trace

CPU = torch.device("cpu")
KEYS = [(a, b) for a in (8, 16, 32) for b in (8, 16, 32)]


class _Event:
    """A copy's event: pending from ``record()`` until ``done()``."""

    def __init__(self):
        self.pending = False
        self.records = 0

    def record(self):
        self.pending = True
        self.records += 1

    def query(self):
        return not self.pending

    def done(self):
        self.pending = False


class _Pool(staging.SlabPool):
    """A pool over 0xFF-filled host tensors with :class:`_Event` events,
    engaged; ``allocated`` lists its slabs, ``events`` its events."""

    def __init__(self, **kw):
        self.allocated, self.events = [], []
        super().__init__(alloc=self._dirty, event=self._new_event, **kw)
        self.engage()

    def _dirty(self, nbytes):
        t = torch.full((nbytes,), 0xFF, dtype=torch.uint8)
        self.allocated.append(t)
        return t

    def _new_event(self):
        self.events.append(_Event())
        return self.events[-1]

    def dirty(self):
        for t in self.allocated:
            t.fill_(0xFF)


@pytest.fixture
def pool(monkeypatch):
    p = _Pool()
    monkeypatch.setattr(staging, "POOL", p)
    return p


def _ptr(x: np.ndarray) -> int:
    return x.__array_interface__["data"][0]


def test_fields_lie_at_256_byte_offsets_of_one_slab(pool):
    specs = [("a", (3, 5), np.int32), ("b", (7,), bool),
             ("c", (2, 3, 5), np.float32), ("d", (1,), bool),
             ("e", (4, 4), np.int32)]
    got = pool.fields(specs)
    assert list(got) == [n for n, _, _ in specs]
    (slab,) = pool.allocated
    start = slab.data_ptr()
    end = 0
    for name, shape, dtype in specs:
        x = got[name]
        assert x.shape == shape and x.dtype == np.dtype(dtype)
        assert x.flags.c_contiguous and x.flags.writeable
        off = _ptr(x) - start
        assert off % 256 == 0 and off >= end
        end = off + x.nbytes
    assert len({id(x.base) for x in got.values()}) == 1
    found, where = pool.find(got)
    assert where == {k: _ptr(x) - start for k, x in got.items()}


def test_fields_hold_what_the_slab_held(pool):
    got = pool.fields([("a", (4,), np.int32), ("b", (3,), bool)])
    assert (got["a"].view(np.uint32) == 0xFFFFFFFF).all()
    assert (got["b"].view(np.uint8) == 0xFF).all()


def test_an_unengaged_pool_hands_out_nothing(monkeypatch):
    fresh = staging.SlabPool(alloc=lambda n: pytest.fail("allocated"))
    monkeypatch.setattr(staging, "POOL", fresh)
    a, clean = staging.zeros([("a", (2, 3), np.int32)])
    assert clean and a["a"].base is None and not a["a"].any()
    assert fresh.fields([("a", (2,), bool)]) is None and fresh.bytes == 0


def test_a_slab_is_not_handed_out_while_a_view_lives(pool):
    specs = [("a", (100,), np.float32)]
    first = pool.fields(specs)
    view = first["a"][10:20]          # a view of a view still holds it
    del first
    second = pool.fields(specs)
    assert len(pool.allocated) == 2
    del second
    assert _ptr(pool.fields(specs)["a"]) == pool.allocated[1].data_ptr()
    del view
    third = pool.fields(specs)       # the first slab again
    assert len(pool.allocated) == 2
    assert _ptr(third["a"]) == pool.allocated[0].data_ptr()


def test_a_slab_is_not_handed_out_while_its_copy_is_pending(pool):
    specs = [("a", (5, 7), np.int32), ("b", (5,), bool)]
    arrays = pool.fields(specs)
    out = staging.stage(arrays, CPU)
    (event,) = pool.events
    assert event.records == 1 and event.pending
    del arrays
    pool.fields(specs)               # a new slab: the copy is pending
    assert len(pool.allocated) == 2
    event.done()
    again = pool.fields(specs)       # both clear: handed out again
    assert len(pool.allocated) == 2
    assert _ptr(again["a"]) == pool.allocated[0].data_ptr()
    assert out["a"].shape == (5, 7)


def test_a_smaller_request_takes_a_free_larger_slab(pool):
    big = pool.fields([("a", (100_000,), np.float32)])
    assert pool.allocated[0].numel() == 1 << 19
    del big
    small = pool.fields([("a", (10,), np.int32)])
    assert len(pool.allocated) == 1
    assert _ptr(small["a"]) == pool.allocated[0].data_ptr()


def test_a_full_pool_falls_back_to_fresh_zeros(monkeypatch):
    p = _Pool(cap=staging.SMALLEST)
    monkeypatch.setattr(staging, "POOL", p)
    held, clean = staging.zeros([("a", (8,), np.int32)])
    assert not clean
    again, clean = staging.zeros([("a", (8,), np.int32)])
    assert clean and again["a"].base is None and not again["a"].any()
    assert p.bytes == staging.SMALLEST and len(p.allocated) == 1


# --- the batchers, at every bucket key of (8, 16, 32) ---

def _relation_images(key, n=6, seed=0) -> RelationDataset:
    """``n`` images whose (L, M) buckets of (16, 32, 48) and (8, 16, 32)
    are ``key``: L tokens and M mentions at most, a few less on some."""
    L, M = key
    rng = np.random.default_rng(seed)
    images = []
    for k in range(n):
        c = int(rng.integers(2, 6))
        l = L - int(rng.integers(0, 6))
        m = M - int(rng.integers(0, 4))
        tokens = rng.integers(1, 50, (c, l)).astype(np.int32)
        tok_len = rng.integers(2, l + 1, c).astype(np.int32)
        m_cap = rng.integers(0, c, m).astype(np.int32)
        m_first = rng.integers(0, l - 1, m).astype(np.int32)
        m_last = np.minimum(m_first + 1, l - 1).astype(np.int32)
        ij = np.array([(i, j) for i in range(m) for j in range(i + 1, m)
                       if rng.random() < 0.7], np.int32).reshape(-1, 2)
        key4 = np.stack([m_cap[ij[:, 0]], ij[:, 0], m_cap[ij[:, 1]],
                         ij[:, 1]], 1).astype(np.int32)
        images.append(RelationImage(
            img_id=f"img{k}", tokens=tokens, tok_len=tok_len, m_cap=m_cap,
            m_first=m_first, m_last=m_last, pair_ij=ij,
            pair_label=rng.integers(0, 4, len(ij)).astype(np.int32),
            pair_key=key4))
    return RelationDataset(images=images)


def _affinity_images(key, n=6, seed=0, D=24) -> AffinityDataset:
    """``n`` images whose (M, B) buckets of (8, 16, 32) are ``key``."""
    M, B = key
    rng = np.random.default_rng(seed)
    images = []
    for k in range(n):
        m = M - int(rng.integers(0, 4))
        nb = B - int(rng.integers(0, 4))
        valid = rng.random((m, nb)) < 0.8
        images.append(AffinityImage(
            img_id=f"img{k}",
            phrase_tokens=rng.integers(1, 50, (m, 16)).astype(np.int32),
            phrase_len=rng.integers(1, 17, m).astype(np.int32),
            mention_ids=[f"doc:img{k};caption:{r % 3};mention:{r}"
                         for r in range(m)],
            box_feats=rng.standard_normal((nb, D)).astype(np.float32),
            box_idx=list(range(nb)),
            grid_label=rng.integers(0, 2, (m, nb)).astype(np.int32),
            grid_valid=valid))
    return AffinityDataset(images=images, box_dim=D)


def _relation(key, with_ids, D=None, host_rows=None):
    """The relation batcher's batches of ``key``'s images."""
    return RelationBatcher(images_per_batch=4, with_ids=with_ids).batches(
        _relation_images(key), host_rows=host_rows)


def _affinity(key, with_ids, D=24, host_rows=None):
    """The affinity batcher's batches of ``key``'s images, with ``D``-wide
    boxes."""
    return AffinityBatcher(images_per_batch=4, with_ids=with_ids).batches(
        _affinity_images(key, D=D), host_rows=host_rows)


def _key(make, key):
    """A key of (8, 16, 32) as ``make``'s bucket key: relation's L takes
    (16, 32, 48)."""
    if make is _relation:
        return {8: 16, 16: 32, 32: 48}[key[0]], key[1]
    return key


def _bytes_equal(a, b):
    assert a.shape_key == b.shape_key and a.id_index == b.id_index
    assert list(a.arrays) == list(b.arrays)
    for k, x in a.arrays.items():
        y = b.arrays[k]
        assert (x.dtype, x.shape) == (y.dtype, y.shape), k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("host_rows", [None, (1, 3)])
@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("make", [_relation, _affinity])
def test_a_dirty_slab_batches_byte_for_byte_as_fresh_zeros(
        monkeypatch, make, key, host_rows):
    """Each key's two batches (the second short: two padding images) from
    fresh zeros, from new 0xFF slabs, and from the same slabs reused after
    0xFF was written over them."""
    key = _key(make, key)
    fresh = list(make(key, with_ids=True, host_rows=host_rows))
    assert all(b.arrays["img_valid"].base is None for b in fresh)
    assert len(fresh) == 2 and not fresh[1].arrays["img_valid"].all()
    p = _Pool()
    monkeypatch.setattr(staging, "POOL", p)
    first = list(make(key, with_ids=True, host_rows=host_rows))
    for a, b in zip(fresh, first):
        _bytes_equal(a, b)
    del first, a, b
    p.dirty()
    n = len(p.allocated)
    again = list(make(key, with_ids=True, host_rows=host_rows))
    assert len(p.allocated) == n
    for a, b in zip(fresh, again):
        assert p.find(b.arrays)[1].keys() == b.arrays.keys()
        _bytes_equal(a, b)


@pytest.mark.parametrize("make", [_relation, _affinity])
def test_the_bucket_keys_share_size_classes(pool, make):
    """One batch of each key, each dropped before the next: the nine keys
    take a few slabs, a power of two each, no more than their classes."""
    classes = set()
    for key in KEYS:
        b = next(make(_key(make, key), with_ids=False, D=1024))
        slab, where = pool.find(b.arrays)
        used = max(off + b.arrays[k].nbytes for k, off in where.items())
        classes.add(max(staging.SMALLEST, 1 << (used - 1).bit_length()))
        assert slab.buf.numel() >= used
        del b, slab
    sizes = [t.numel() for t in pool.allocated]
    assert all(n & (n - 1) == 0 for n in sizes)
    assert len(sizes) <= len(classes) < len(KEYS)
    assert (len(classes) > 1) == (make is _affinity)


# --- staging ---

def _share_one_buffer(tensors) -> bool:
    return len({t.untyped_storage().data_ptr() for t in tensors}) == 1


def test_a_slab_batch_goes_in_one_copy_as_typed_views(pool):
    b = next(_affinity((16, 8), with_ids=False))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = staging.stage(b.arrays, CPU)
    trace_counts = trace.snapshot()["counters"]
    trace.reset()
    assert trace_counts.get("h2d.slab") == 1
    assert list(out) == list(b.arrays)
    assert _share_one_buffer(out.values())
    base = next(iter(out.values())).untyped_storage().data_ptr()
    for k, t in out.items():
        x = b.arrays[k]
        assert t.is_contiguous() and t.shape == x.shape
        assert t.dtype == torch.from_numpy(x).dtype
        assert (t.data_ptr() - base) % 256 == 0
        assert t.numpy().tobytes() == x.tobytes()
    assert pool.events[0].records == 1


def test_a_bf16_box_block_goes_alone_and_the_rest_in_one_copy(pool):
    batcher = AffinityBatcher(images_per_batch=4, with_ids=False,
                              box_dtype=torch.bfloat16)
    b = next(batcher.batches(_affinity_images((8, 16))))
    boxes = b.arrays["box_feats"]
    assert isinstance(boxes, torch.Tensor) and boxes.dtype == torch.bfloat16
    slab, where = pool.find(b.arrays)
    assert "box_feats" not in where and len(where) == 6
    out = staging.stage(b.arrays, CPU)
    assert torch.equal(out["box_feats"], boxes)
    assert _share_one_buffer(t for k, t in out.items() if k != "box_feats")
    for k, x in b.arrays.items():
        if k != "box_feats":
            assert out[k].numpy().tobytes() == x.tobytes()


def test_tuples_and_cut_rows_go_array_by_array(pool):
    arrays = pool.fields([("a", (4, 3), np.int32), ("b", (4,), bool)])
    arrays["a"][:] = np.arange(12).reshape(4, 3)
    arrays["b"][:] = [True, False, True, True]
    tup = staging.stage((arrays["a"], arrays["b"]), CPU)
    assert tup[0].tolist() == arrays["a"].tolist()
    half = staging.stage(arrays, CPU, cut=lambda x: x[2:])
    assert half["a"].tolist() == arrays["a"][2:].tolist()
    assert half["b"].tolist() == [True, True]
    assert not pool.events                # nothing went by the slab path


def test_staging_on_the_cpu_engages_no_pool(monkeypatch):
    fresh = staging.SlabPool(alloc=lambda n: pytest.fail("allocated"))
    monkeypatch.setattr(staging, "POOL", fresh)
    out = staging.stage({"a": np.ones((2, 2), np.float32)}, CPU)
    assert out["a"].sum().item() == 4 and not fresh.engaged
    assert all(b.arrays["box_feats"].base is None
               for b in _affinity((8, 8), with_ids=False))


def test_concurrent_hand_outs_never_share_a_slab(pool):
    """Threads take, fill, check and drop fields at once, the interpreter
    switching threads every few microseconds: a slab handed out twice
    would show another thread's pattern."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    bad, done = [], []

    def work(k):
        for i in range(300):
            got = pool.fields([("a", (64 + 8 * (i % 5),), np.int32)])
            got["a"][:] = k
            for _ in range(3):
                if not (got["a"] == k).all():
                    bad.append(k)
            del got
        done.append(k)

    try:
        workers = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert sorted(done) == list(range(8)) and not bad
    assert len(pool.allocated) <= 8
