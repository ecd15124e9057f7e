"""The port's own numpy data layer against the JAX package's.

``icl_torch`` imports nothing of ``icl``; it keeps copies of the modules it
needs (``icl_torch/util/log.py``, ``data/{buckets,embeddings,pairs,pipeline,
imagebatch}.py``, ``io/{boxes,captions,feats,scores}.py``,
``eval/scoredict.py``, ``testing/synth.py``) and of the C++ I/O library
(``icl_torch/native``).  File formats and batch layouts must not drift, so
each copy is held to its original on the same seeded input: the same bytes
written, the same arrays (dtype, shape, values) read and batched.  Every
reader and writer with a native fast path is held to the original on both
of the port's paths (``port_io``): its C++ library and the pure Python it
falls back to.  The originals may take their C++ paths here where their
library is built; the results must agree all the same.
"""

import filecmp
import json
import logging
import os

import numpy as np
import pytest

import icl.data.buckets as jbuckets
import icl.data.embeddings as jemb
import icl.data.imagebatch as jbatch
import icl.data.pairs as jpairs
import icl.data.pipeline as jpipe
import icl.io.boxes as jboxes
import icl.io.captions as jcaps
import icl.eval.scoredict as jscoredict
import icl.io.feats as jfeats
import icl.io.scores as jscores
import icl.testing.synth as jsynth
import icl.util.log as jlog
import icl_torch.data.buckets as tbuckets
import icl_torch.data.embeddings as temb
import icl_torch.data.imagebatch as tbatch
import icl_torch.data.pairs as tpairs
import icl_torch.data.pipeline as tpipe
import icl_torch.io.boxes as tboxes
import icl_torch.io.captions as tcaps
import icl_torch.eval.scoredict as tscoredict
import icl_torch.io.feats as tfeats
import icl_torch.io.scores as tscores
import icl_torch.native as tnative
import icl_torch.testing.synth as tsynth
import icl_torch.util.log as tlog

CONFIGS = {
    "default": {"num_images": 6, "seed": 3},
    "planted": {"num_images": 9, "seed": 5, "planted": True, "emb_dim": 16,
                "vocab_size": 80, "max_caption_len": 32,
                "max_mentions_per_caption": 3, "max_boxes_per_image": 10},
    "skewed": {"num_images": 5, "seed": 7, "planted": True,
               "planted_active_words": 3, "captions_per_image": 3},
}


@pytest.fixture(params=["native", "python"])
def port_io(request, monkeypatch):
    """The port's I/O path a test drives: its C++ library, which must
    build here, or the pure-Python code it falls back to."""
    if request.param == "native":
        assert tnative.available(), "the port's native library did not build"
    else:
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_load_failed", True)
    return request.param


def _same(a, b, what=""):
    """Equal arrays: dtype, shape and every value."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                      a.shape, b.shape)
    assert np.array_equal(a, b), what


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """name -> data dir written by the port's generator (test_synth_* hold
    it to the original's bytes)."""
    out = {}
    for name, kw in CONFIGS.items():
        d = str(tmp_path_factory.mktemp(f"torch_data_{name}"))
        tsynth.generate_dataset(d, "train", tsynth.SynthConfig(**kw))
        out[name] = d
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_synth_writes_the_same_bytes(name, datasets, tmp_path):
    assert (jsynth.SynthConfig(**CONFIGS[name])
            == jsynth.SynthConfig(**vars(tsynth.SynthConfig(**CONFIGS[name]))))
    d = str(tmp_path)
    jsynth.generate_dataset(d, "train", jsynth.SynthConfig(**CONFIGS[name]))
    names = sorted(os.listdir(d))
    assert names == sorted(os.listdir(datasets[name])) and len(names) >= 8
    match, mismatch, errors = filecmp.cmpfiles(d, datasets[name], names,
                                               shallow=False)
    assert not mismatch and not errors and match == names


@pytest.mark.parametrize("build_grid,with_ids,shuffle",
                         [(True, True, False), (False, False, True)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_relation_dataset_and_batches_are_equal(name, datasets, build_grid,
                                                with_ids, shuffle,
        port_io):
    d = datasets[name]
    path = os.path.join(d, "embeddings.txt")
    jds = jpipe.load_relation_dataset(d, "train", jemb.EmbeddingStore.load(path))
    tds = tpipe.load_relation_dataset(d, "train", temb.EmbeddingStore.load(path))
    assert len(jds.images) == len(tds.images) > 0
    assert jds.num_pairs == tds.num_pairs
    for a, b in zip(jds.images, tds.images):
        assert a.img_id == b.img_id and a.pair_ids == b.pair_ids
        for f in ("tokens", "tok_len", "m_cap", "m_first", "m_last",
                  "pair_ij", "pair_label", "pair_key"):
            _same(getattr(a, f), getattr(b, f), f)
    kw = dict(images_per_batch=4, build_grid=build_grid, with_ids=with_ids)
    rngs = [np.random.default_rng(11) if shuffle else None for _ in range(2)]
    jb = list(jbatch.RelationBatcher(
        len_spec=jbuckets.BucketSpec((16, 32, 48)), **kw).batches(jds, rngs[0]))
    tb = list(tbatch.RelationBatcher(
        len_spec=tbuckets.BucketSpec((16, 32, 48)), **kw).batches(tds, rngs[1]))
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert a.shape_key == b.shape_key and a.id_index == b.id_index
        assert sorted(a.arrays) == sorted(b.arrays)
        for k in a.arrays:
            _same(a.arrays[k], b.arrays[k], k)
    assert ("grid_label" in tb[0].arrays) == build_grid
    assert bool(tb[0].id_index) == with_ids


@pytest.mark.parametrize("with_ids,phrase_len,buckets",
                         [(True, 16, (8, 16, 32)), (False, 8, (4, 8, 16))])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_affinity_dataset_and_batches_are_equal(name, datasets, with_ids,
                                                phrase_len, buckets,
        port_io):
    d = datasets[name]
    path = os.path.join(d, "embeddings.txt")
    jds = jpipe.load_affinity_dataset(d, "train",
                                      jemb.EmbeddingStore.load(path),
                                      max_phrase_len=phrase_len)
    tds = tpipe.load_affinity_dataset(d, "train",
                                      temb.EmbeddingStore.load(path),
                                      max_phrase_len=phrase_len)
    assert len(jds.images) == len(tds.images) > 0
    assert jds.box_dim == tds.box_dim and jds.num_cells == tds.num_cells
    for a, b in zip(jds.images, tds.images):
        assert (a.img_id, a.mention_ids, a.box_idx) == (
            b.img_id, b.mention_ids, b.box_idx)
        assert a.cell_id(0, 1, 2) == b.cell_id(0, 1, 2)
        for f in ("phrase_tokens", "phrase_len", "box_feats", "grid_label",
                  "grid_valid"):
            _same(getattr(a, f), getattr(b, f), f)
    jb = list(jbatch.AffinityBatcher(
        images_per_batch=4, mention_spec=jbuckets.BucketSpec(buckets),
        box_spec=jbuckets.BucketSpec(buckets), phrase_len=phrase_len,
        with_ids=with_ids).batches(jds))
    tb = list(tbatch.AffinityBatcher(
        images_per_batch=4, mention_spec=tbuckets.BucketSpec(buckets),
        box_spec=tbuckets.BucketSpec(buckets), phrase_len=phrase_len,
        with_ids=with_ids).batches(tds))
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert a.shape_key == b.shape_key and a.id_index == b.id_index
        assert sorted(a.arrays) == sorted(b.arrays)
        for k in a.arrays:
            _same(a.arrays[k], b.arrays[k], k)


@pytest.mark.parametrize("task", ["nonvisual", "cardinality"])
def test_mention_dataset_is_equal(task, datasets, port_io):
    d = datasets["default"]
    path = os.path.join(d, "embeddings.txt")
    a = jpipe.load_mention_dataset(d, "train", task,
                                   jemb.EmbeddingStore.load(path))
    b = tpipe.load_mention_dataset(d, "train", task,
                                   temb.EmbeddingStore.load(path))
    assert a.ids == b.ids and len(a.ids) > 0 and a.max_len == b.max_len
    for f in ("token_ids", "lengths", "labels"):
        _same(getattr(a, f), getattr(b, f), f)


@pytest.mark.parametrize("fmt", ["text", "text_header", "binary",
                                 "binary_restricted"])
def test_embedding_store_loads_are_equal(fmt, tmp_path, port_io):
    rng = np.random.default_rng(2)
    words = ["Dog", "dog", "cat", "Zebra", "ünï", "a-b"]
    vecs = rng.normal(size=(len(words), 5)).astype(np.float32)
    path = str(tmp_path / ("emb.bin" if fmt.startswith("binary")
                           else "emb.txt"))
    if fmt.startswith("binary"):
        temb.EmbeddingStore.from_arrays(words, vecs).save_binary(path)
        other = str(tmp_path / "emb_j.bin")
        jemb.EmbeddingStore.from_arrays(words, vecs).save_binary(other)
        assert filecmp.cmp(path, other, shallow=False)
    else:
        with open(path, "w", encoding="utf-8") as f:
            if fmt == "text_header":
                f.write(f"{len(words)} 5\n")
            for w, v in zip(words, vecs):
                f.write(w + " " + " ".join(repr(float(x)) for x in v) + "\n")
    keep = ["Cat", "Zebra", "missing"] if fmt.endswith("restricted") else None
    a = jemb.EmbeddingStore.load(path, restrict_to=keep)
    b = temb.EmbeddingStore.load(path, restrict_to=keep)
    assert a.vocab == b.vocab and a.dim == b.dim == 5
    _same(a.table, b.table)
    assert not b.table[temb.PAD_ID].any() and temb.PAD_ID == jemb.PAD_ID
    # exact match, then lowercase, else the PAD/OOV row
    for w in ("Dog", "dog", "DOG", "Cat", "cat", "ZEBRA", "zebra", "nope",
              "ünï"):
        assert a.lookup_id(w) == b.lookup_id(w), w
    if keep is None:
        assert b.lookup_id("Dog") != b.lookup_id("dog") != temb.PAD_ID
        assert b.lookup_id("Cat") == b.lookup_id("cat") != temb.PAD_ID
        assert b.lookup_id("nope") == temb.PAD_ID
    toks = ["Dog", "nope", "cat", "a-b", "Zebra"]
    for got, want in zip(b.encode_tokens(toks, 4), a.encode_tokens(toks, 4)):
        _same(got, want)
    ra, rb = a.restrict(["Zebra", "Dog"]), b.restrict(["Zebra", "Dog"])
    assert ra.vocab == rb.vocab
    _same(ra.table, rb.table)


@pytest.mark.parametrize("buckets", [(8, 16, 32), (4,), (16, 32, 48)])
def test_bucket_spec_and_bucketizer_are_equal(buckets):
    ja, tb = jbuckets.BucketSpec(buckets), tbuckets.BucketSpec(buckets)
    for n in range(0, max(buckets) + 12):
        assert ja.bucket_of(n) == tb.bucket_of(n)
        assert ja.bucket_of(n, strict=True) == tb.bucket_of(n, strict=True)
    # overflow rounds up to a multiple of 8; strict clamps
    assert tb.bucket_of(max(buckets) + 1) == (max(buckets) + 8) // 8 * 8
    assert tb.bucket_of(max(buckets) + 1, strict=True) == max(buckets)
    rng = np.random.default_rng(4)
    n = 23
    lengths = rng.integers(1, max(buckets) + 1, n)
    arrays = {"tok": rng.integers(0, 9, (n, max(buckets))).astype(np.int32),
              "y": rng.integers(0, 2, n).astype(np.int32)}
    ids = [f"id{i}" for i in range(n)]
    runs = [list(mod.Bucketizer(spec, 4).batches(
        lengths, arrays, ids, shuffle_rng=np.random.default_rng(9),
        pad_axis_keys={"tok": 1}, skip=1))
        for mod, spec in ((jbuckets, ja), (tbuckets, tb))]
    assert len(runs[0]) == len(runs[1]) > 0
    for (la, a), (lb, b) in zip(*runs):
        assert la == lb and a.ids == b.ids and a.size == b.size
        _same(a.valid, b.valid)
        for k in a.arrays:
            _same(a.arrays[k], b.arrays[k], k)


@pytest.mark.parametrize("mmap", [False, True])
def test_box_feats_round_trip_both_ways(mmap, tmp_path):
    rng = np.random.default_rng(6)
    ids = [tboxes.make_box_id(f"{i // 3}.jpg", i % 3) for i in range(7)]
    assert ids == [jboxes.make_box_id(f"{i // 3}.jpg", i % 3)
                   for i in range(7)]
    feats = rng.normal(size=(7, 12)).astype(np.float32)
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tboxes.write_box_feats(pt, ids, feats)
    jboxes.write_box_feats(pj, ids, feats)
    assert filecmp.cmp(pt, pj, shallow=False)
    for read, path in ((tboxes.read_box_feats, pj),
                       (jboxes.read_box_feats, pt)):
        got_ids, got = read(path, mmap=mmap)
        assert list(got_ids) == ids
        _same(np.asarray(got), feats)
    assert tboxes.parse_box_id(ids[4]) == jboxes.parse_box_id(ids[4])
    ga = jboxes.group_boxes_by_image(ids, feats, lazy=mmap)
    gb = tboxes.group_boxes_by_image(ids, feats, lazy=mmap)
    assert sorted(ga) == sorted(gb)
    for k in ga:
        assert list(ga[k][0]) == list(gb[k][0])
        _same(np.asarray(ga[k][1]), np.asarray(gb[k][1]))


@pytest.mark.parametrize("task", ["relation", "affinity", "nonvisual",
                                  "cardinality"])
def test_feats_readers_are_equal(task, datasets, tmp_path, port_io):
    path = os.path.join(datasets["default"], f"train.{task}.feats")
    a, b = jfeats.read_feats(path), tfeats.read_feats(path)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert (x.example_id, x.label) == (y.example_id, y.label)
        _same(x.indices, y.indices)
        _same(x.values, y.values)
        _same(x.to_dense(40), y.to_dense(40))
    (ia, la), (ib, lb) = (jfeats.read_feats_labels(path),
                          tfeats.read_feats_labels(path))
    assert list(ia) == list(ib)
    _same(la, lb)
    out_a, out_b = str(tmp_path / "a.feats"), str(tmp_path / "b.feats")
    jfeats.write_feats(out_a, a)
    tfeats.write_feats(out_b, b)
    assert filecmp.cmp(out_a, out_b, shallow=False)
    assert filecmp.cmp(out_b, path, shallow=False)       # a round trip


def test_malformed_feats_lines_are_dropped_alike(tmp_path, port_io):
    path = str(tmp_path / "bad.feats")
    with open(path, "w", encoding="utf-8") as f:
        f.write("1 1:0.5 3:2 # ok0\n\n# a comment\nx 1:1 # badlabel\n"
                "0 2:1_0 # underscore\n2 4:1.25 # ok1\n")
    a, b = jfeats.read_feats(path), tfeats.read_feats(path)
    assert [x.example_id for x in b] == ["ok0", "ok1"]
    assert [x.example_id for x in a] == [x.example_id for x in b]
    ia, ib = jfeats.read_feats_labels(path), tfeats.read_feats_labels(path)
    assert list(ia[0]) == list(ib[0])
    _same(ia[1], ib[1])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_caption_and_mention_readers_are_equal(name, datasets, port_io):
    d = datasets[name]
    ca = jcaps.read_captions(os.path.join(d, "train.captions.txt"))
    cb = tcaps.read_captions(os.path.join(d, "train.captions.txt"))
    assert list(ca) == list(cb) and len(cb) > 0
    for k in ca:
        assert (ca[k].img_id, ca[k].cap_idx, ca[k].tokens) == (
            cb[k].img_id, cb[k].cap_idx, cb[k].tokens)
    mpath = os.path.join(d, "train.mentions.txt")
    ma, mb = jcaps.read_mentions(mpath), tcaps.read_mentions(mpath)
    assert [vars(m) for m in ma] == [vars(m) for m in mb] and mb
    cola, colb = (jcaps.read_mention_columns(mpath),
                  tcaps.read_mention_columns(mpath))
    assert cola.docs == colb.docs
    for f in ("doc_idx", "cap_idx", "mention_idx", "first", "last"):
        _same(getattr(cola, f), getattr(colb, f), f)
    by_img = {}
    for m in mb:
        by_img.setdefault(m.img_id, []).append(m)
    some = next(iter(by_img.values()))
    (pa, ida), (pb, idb) = (jpairs.enumerate_pairs(
        [jcaps.Mention(**vars(m)) for m in some]), tpairs.enumerate_pairs(some))
    _same(pa, pb)
    assert ida == idb
    assert jpairs.RELATION_CLASSES == tpairs.RELATION_CLASSES


def test_log_util_has_the_same_surface(capsys):
    names = [n for n in dir(jlog.LogUtil) if not n.startswith("_")]
    assert names == [n for n in dir(tlog.LogUtil) if not n.startswith("_")]
    log = tlog.LogUtil(level="info", tick_seconds=0.0, name="icl_torch_test")
    log.tic(4, "rows")
    log.toc(2, force=True)
    log.debug("hidden")
    log.warning("shown %d", 7)
    err = capsys.readouterr().err
    assert "50.0% complete (2/4 rows)" in err and "shown 7" in err
    assert "hidden" not in err
    assert logging.getLogger("icl_torch_test").level == logging.INFO


def _score_rows(n, c, seed):
    rng = np.random.default_rng(seed)
    probs = rng.random((n, c))
    probs /= probs.sum(axis=1, keepdims=True)
    if n:
        probs[0] = [1.0] + [0.0] * (c - 1)             # exact 0 and 1
    if n > 1:
        probs[1, 0] = 0.1234565                        # a rounding tie
    ids = [f"doc:im{i}.jpg;caption:{i % 5};mention:{i % 3}" for i in range(n)]
    return ids, probs


@pytest.mark.parametrize("writer", ["write_scores", "write_scores_sharded"])
@pytest.mark.parametrize("n,c", [(7, 4), (5, 2), (3, 1), (0, 2)])
def test_scores_writers_write_the_same_bytes(writer, n, c, tmp_path, port_io):
    ids, probs = _score_rows(n, c, seed=n + c)
    paths = {}
    for name, mod in (("j", jscores), ("t", tscores)):
        path = paths[name] = str(tmp_path / f"{name}.scores")
        order = [f"c{k}" for k in range(c)]
        if writer == "write_scores":
            mod.write_scores(path, ids, probs.astype(np.float32),
                             class_order=order, meta={"task": "x"})
        else:
            mod.write_scores_sharded(path, ids, probs, num_classes=c,
                                     total_examples=n + 3, class_order=order,
                                     meta={"task": "x", "split": "dev"})
    assert filecmp.cmp(paths["j"], paths["t"], shallow=False)
    assert filecmp.cmp(paths["j"] + ".meta.json", paths["t"] + ".meta.json",
                       shallow=False)
    text = open(paths["t"], encoding="utf-8").read()
    assert text.count("\n") == n and "\r" not in text
    if n:
        assert text.splitlines()[0] == ids[0] + ",1.000000" + ",0.000000" * (
            c - 1)
    # each package reads the other's file to the same arrays
    (ia, pa), (ib, pb) = (jscores.read_scores(paths["t"]),
                          tscores.read_scores(paths["j"]))
    assert ia == ib == ids
    _same(pa, pb)
    if n:
        assert np.abs(pb - probs).max() <= 1e-6   # half a unit, and f32


def test_scores_writers_refuse_the_same_shapes(tmp_path):
    path = str(tmp_path / "x.scores")
    for mod in (jscores, tscores):
        with pytest.raises(ValueError, match="does not match"):
            mod.write_scores(path, ["a", "b"], np.zeros((3, 2)))
        with pytest.raises(ValueError, match="does not match"):
            mod.write_scores_sharded(path, ["a"], np.zeros((1, 3)),
                                     num_classes=2, total_examples=1)


def test_read_scores_parses_alike(tmp_path):
    path = str(tmp_path / "odd.scores")
    with open(path, "w", encoding="utf-8") as f:
        f.write("a,0.5,0.5\n\nb,1e-3,0.999\n")
    (ia, pa), (ib, pb) = jscores.read_scores(path), tscores.read_scores(path)
    assert ia == ib == ["a", "b"]
    _same(pa, pb)
    with open(path, "w", encoding="utf-8") as f:
        f.write("a,\n")
    for mod in (jscores, tscores):
        with pytest.raises(ValueError):
            mod.read_scores(path)


@pytest.mark.parametrize("labels", [None, ["null", "coref", "subset_ij",
                                           "subset_ji"], [0, 1]])
def test_scoredict_is_equal(labels):
    rng = np.random.default_rng(8)
    names = labels or ["x", "y", "z"]
    golds = [names[i] for i in rng.integers(0, len(names), 60)]
    preds = [names[i] for i in rng.integers(0, len(names) - 1, 60)]
    a, b = jscoredict.ScoreDict(labels), tscoredict.ScoreDict(labels)
    a.increment_all(golds, preds)
    b.increment_all(golds, preds)
    b.increment(names[0], names[0], count=0)
    assert a.table() == b.table() and a.labels == b.labels
    assert (a.accuracy, a.macro_f1()) == (b.accuracy, b.macro_f1())
    for name in names:
        assert (a.precision(name), a.recall(name), a.f1(name),
                a.gold_count(name)) == (b.precision(name), b.recall(name),
                                        b.f1(name), b.gold_count(name))
    assert a.state_dict() == b.state_dict()
    merged = tscoredict.ScoreDict(labels)
    merged.update_state(json.loads(json.dumps(b.state_dict())))
    merged.update_state(a.state_dict())
    twice = jscoredict.ScoreDict(labels)
    twice.increment_all(golds + golds, preds + preds)
    assert merged.table() == twice.table()
    with pytest.raises(ValueError):
        b.increment_all(golds, preds[:-1])
    # one process: the sweep's own table, as the reference returns it
    assert tscoredict.merge_sharded(b, "unused") is b
    assert jscoredict.merge_sharded(a, "unused") is a
    empty = tscoredict.ScoreDict(labels)
    assert empty.table() == jscoredict.ScoreDict(labels).table()
    names_a = [n for n in dir(jscoredict.ScoreDict) if not n.startswith("_")]
    assert names_a == [n for n in dir(tscoredict.ScoreDict)
                       if not n.startswith("_")]
