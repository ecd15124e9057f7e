"""The port's C++ I/O library (``icl_torch/native``) against its own
pure-Python paths and against the JAX package.

The fast paths parse ids, group rows per image, tokenize captions, read
mentions and word2vec tables, and write ``.scores`` in C++.  Their contract
is equality with the Python paths: the same datasets, the same bytes, and a
whole-load fallback (return None) on any input the strict native grammar
cannot prove equivalent, so the Python path's exact error behavior applies.
Each case holds the port's native path to its Python path and to the JAX
package's output for the same files.  The library is also built with
ASAN/UBSAN against the harness ``native/asan_harness.cpp`` (read, never
built in place), and a failed build, a failed ``dlopen`` and a library
without the bound symbols must each degrade to the Python paths with one
WARNING.
"""

import contextlib
import io
import logging
import os
import random
import shutil
import subprocess

import numpy as np
import pytest

import icl.data.embeddings as jemb
import icl.data.pipeline as jpipe
import icl.io.captions as jcaps
import icl.io.feats as jfeats
import icl.io.scores as jscores
import icl_torch.native as tnative
from icl_torch.data import pipeline
from icl_torch.data.embeddings import EmbeddingStore
from icl_torch.data.pipeline import (load_affinity_dataset,
                                     load_mention_dataset,
                                     load_relation_dataset, split_path)
from icl_torch.io import captions as tcaps
from icl_torch.io import feats as tfeats
from icl_torch.io import scores as tscores
from icl_torch.native.captions import caption_words, parse_captions
from icl_torch.native.feats import (parse_feats_file, parse_feats_ids,
                                    parse_feats_labels, write_scores_native)
from icl_torch.native.mentions import parse_mentions
from icl_torch.testing.synth import SynthConfig, generate_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def native_built(monkeypatch):
    """Every case here drives the port's library: it must build on this
    box.  The JAX package's loaders may take its own library where it is
    built, but never run its ``make`` from here."""
    monkeypatch.setenv("ICL_NO_NATIVE_BUILD", "1")
    assert tnative.available(), "the port's native library did not build"


@contextlib.contextmanager
def python_io():
    """The port's pure-Python paths: the library as if it had not loaded."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tnative, "_lib", None)
        m.setattr(tnative, "_load_failed", True)
        yield


@pytest.fixture
def log_capture():
    """The package logger's records through a temporary handler (the
    logger does not propagate, so caplog sees nothing)."""
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    log = logging.getLogger("icl")
    log.addHandler(handler)
    try:
        yield buf
    finally:
        log.removeHandler(handler)


@pytest.fixture
def synth_dir(tmp_path):
    d = str(tmp_path)
    generate_dataset(d, "train", SynthConfig(num_images=4, seed=11))
    return d


def _emb(d):
    return EmbeddingStore.load(f"{d}/embeddings.txt")


def _three_ways(load, jload, d):
    """The port's loader on its native path, on its Python path, and the
    JAX package's loader, over the same files."""
    fast = load(d, "train", _emb(d))
    with python_io():
        slow = load(d, "train", _emb(d))
    ref = jload(d, "train", jemb.EmbeddingStore.load(f"{d}/embeddings.txt"))
    return fast, slow, ref


def _pad_field(path, field, skip=2):
    lines = open(path).read().splitlines()
    target = next(i for i, l in enumerate(lines) if "#" in l and i > skip)
    head, _, eid = lines[target].partition("# ")
    pre, sep, post = eid.partition(field + ":")
    num = post.split(";", 1)[0]
    lines[target] = head + "# " + pre + sep + "00" + num + post[len(num):]
    open(path, "w").write("\n".join(lines) + "\n")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, what)


# ---------------------------------------------------------------------------
# Dataset loaders: native == Python == the JAX package
# ---------------------------------------------------------------------------

def test_relation_dataset_parity(synth_dir):
    # a zero-padded id, so the override path is compared too
    _pad_field(split_path(synth_dir, "train", "relation.feats"), "mention_2")
    fast, slow, ref = _three_ways(load_relation_dataset,
                                  jpipe.load_relation_dataset, synth_dir)
    assert len(fast.images) == len(slow.images) == len(ref.images) > 0
    assert any(im.pair_id_overrides for im in fast.images)
    for x, y, z in zip(fast.images, slow.images, ref.images):
        assert x.img_id == y.img_id == z.img_id
        for f in ("tokens", "tok_len", "m_cap", "m_first", "m_last",
                  "pair_ij", "pair_label", "pair_key"):
            _same(getattr(x, f), getattr(y, f), f)
            _same(getattr(x, f), getattr(z, f), f)
        assert ((x.pair_id_overrides or {}) == (y.pair_id_overrides or {})
                == (z.pair_id_overrides or {}))
        assert x.pair_ids == y.pair_ids == z.pair_ids


def test_affinity_dataset_parity(synth_dir):
    _pad_field(split_path(synth_dir, "train", "affinity.feats"), "box")
    fast, slow, ref = _three_ways(load_affinity_dataset,
                                  jpipe.load_affinity_dataset, synth_dir)
    assert len(fast.images) == len(slow.images) == len(ref.images) > 0
    for x, y, z in zip(fast.images, slow.images, ref.images):
        assert x.img_id == y.img_id == z.img_id
        for f in ("phrase_tokens", "phrase_len", "grid_label", "grid_valid",
                  "box_feats"):
            _same(getattr(x, f), getattr(y, f), f)
            _same(getattr(x, f), getattr(z, f), f)
        assert x.mention_ids == y.mention_ids == z.mention_ids
        assert x.box_idx == y.box_idx == z.box_idx
        assert ((x.cell_id_overrides or {}) == (y.cell_id_overrides or {})
                == (z.cell_id_overrides or {}))


def test_mention_dataset_parity_and_padded_ids(synth_dir):
    """A zero-padded feats id joins by parsed ints while ``ids`` keeps the
    file's exact bytes, on both paths and in the JAX package."""
    path = split_path(synth_dir, "train", "nonvisual.feats")
    _pad_field(path, "mention")
    lines = open(path).read().splitlines()
    padded_id = next(eid for eid in (l.partition("# ")[2]
                                     for l in lines if "#" in l)
                     if tcaps.parse_mention_id_padded(eid)[-1])
    emb = _emb(synth_dir)
    fast = load_mention_dataset(synth_dir, "train", "nonvisual", emb)
    with python_io():
        slow = load_mention_dataset(synth_dir, "train", "nonvisual", emb)
    ref = jpipe.load_mention_dataset(
        synth_dir, "train", "nonvisual",
        jemb.EmbeddingStore.load(f"{synth_dir}/embeddings.txt"))
    for f in ("token_ids", "lengths", "labels"):
        _same(getattr(fast, f), getattr(slow, f), f)
        _same(getattr(fast, f), getattr(ref, f), f)
    assert fast.ids == slow.ids == ref.ids
    assert padded_id in fast.ids          # exact bytes, resolved by ints
    assert any(le > 0 for le in fast.lengths)


def test_mention_dataset_missing_mention_keyerror(synth_dir):
    path = split_path(synth_dir, "train", "nonvisual.feats")
    with open(path, "a") as f:
        f.write("1 2:1 # doc:nosuch.jpg;caption:0;mention:0\n")
    for ctx in (contextlib.nullcontext(), python_io()):
        with ctx, pytest.raises(KeyError, match="nosuch"):
            load_mention_dataset(synth_dir, "train", "nonvisual",
                                 _emb(synth_dir))


@pytest.mark.parametrize("row,error", [
    ("1 2:1 # doc:z.jpg;caption:0;mention:1", "bad pair id"),  # grammar
    ("1 2:1 # doc:z.jpg;caption_1:2147483648;mention_1:0"
     ";caption_2:0;mention_2:1", OverflowError),               # int32 field
    ("nan 2:1 # doc:z.jpg;caption_1:0;mention_1:0;caption_2:0;mention_2:1",
     ValueError),                                              # non-finite
    ("4294967296 2:1 # doc:z.jpg;caption_1:0;mention_1:0;caption_2:0"
     ";mention_2:1", OverflowError)],                          # int32 label
    ids=["bad_id", "overflow_id", "nonfinite_label", "overflow_label"])
def test_fallback_rows_raise_the_python_error(synth_dir, row, error):
    """Each row makes the native grouping decline (astype would wrap a huge
    label, int(nan) raises in Python): the loader then raises the Python
    path's exact error, as the JAX package's does."""
    with open(split_path(synth_dir, "train", "relation.feats"), "a") as f:
        f.write(row + "\n")
    path = split_path(synth_dir, "train", "relation.feats")
    assert pipeline._fast_grouped_rows(path, "pair") is None
    kind, match = ((ValueError, error) if isinstance(error, str)
                   else (error, None))
    with pytest.raises(kind, match=match):
        load_relation_dataset(synth_dir, "train", _emb(synth_dir))
    with pytest.raises(kind, match=match):
        jpipe.load_relation_dataset(
            synth_dir, "train",
            jemb.EmbeddingStore.load(f"{synth_dir}/embeddings.txt"))


# ---------------------------------------------------------------------------
# The id grammar and the per-image grouping
# ---------------------------------------------------------------------------

def _one_row_feats(tmp_path, eid, label="1"):
    p = tmp_path / "t.feats"
    p.write_text(f"{label} 3:0.5 # {eid}\n")
    return str(p)


def test_native_grammar_fuzz_matches_python(tmp_path):
    """For every fuzz case the native id parse either extracts exactly
    what the Python parsers (the port's and the JAX package's) do, or
    signals fallback exactly when they raise."""
    rng = random.Random(7)
    pieces = ["doc:", "caption:", "mention:", "box:", "caption_1:",
              "mention_1:", "caption_2:", "mention_2:", ";", "0", "7",
              "07", "img.jpg", "", "x", ":", "12", "4294967296"]
    cases = ["".join(rng.choice(pieces) for _ in range(rng.randint(1, 10)))
             for _ in range(800)]
    for d in ("a.jpg", "b", "x y.jpg", "ümlaut.jpg"):
        cases += [f"doc:{d};caption:3;mention:0",
                  f"doc:{d};caption:03;mention:0",
                  f"doc:{d};caption_1:1;mention_1:2;caption_2:3;mention_2:4",
                  f"doc:{d};caption_1:1;mention_1:02;caption_2:3;mention_2:4",
                  f"doc:{d};caption:1;mention:2;box:07",
                  f"doc:{d};caption:1;mention:2;box:2147483647",
                  f"doc:{d};caption:1;mention:2;box:2147483648"]
    kinds = (("mention", tcaps.parse_mention_id_padded,
              jcaps.parse_mention_id_padded),
             ("pair", tcaps.parse_pair_id_padded, jcaps.parse_pair_id_padded),
             ("affinity", pipeline.parse_affinity_id_padded,
              jpipe.parse_affinity_id_padded))
    for kind, parser, jparser in kinds:
        for eid in cases:
            if "#" in eid or "\n" in eid or eid != eid.strip():
                continue  # not representable as a feats id comment
            path = _one_row_feats(tmp_path, eid)
            try:
                want = parser(eid)
                # int32-range fields only: the loaders' array('i') would
                # raise OverflowError -> native must fall back
                in_range = all(v <= 2**31 - 1 for v in want[1:-1])
            except ValueError:
                want, in_range = None, False
            try:
                assert jparser(eid) == want, (kind, eid)
            except ValueError:
                assert want is None, (kind, eid)
            got = parse_feats_ids(path, kind)
            if want is None or not in_range:
                assert got is None, (kind, eid)
            else:
                assert got is not None, (kind, eid)
                labels, fields, doc_idx, docs, overrides = got
                assert docs[int(doc_idx[0])] == want[0], (kind, eid)
                assert fields[0].tolist() == list(want[1:-1]), (kind, eid)
                assert (0 in overrides) is want[-1], (kind, eid)
                if want[-1]:
                    assert overrides[0] == eid


def _grouped_three_ways(path):
    fast = pipeline._fast_grouped_rows(path, "pair")
    slow = pipeline._python_grouped_pair_rows(path)
    ref = jpipe._python_grouped_pair_rows(path)
    assert fast is not None
    assert [g[0] for g in fast] == [g[0] for g in slow] == [g[0] for g in ref]
    for (fi, fpk, fl, fo), (si, spk, sl_, so), (ri, rpk, rl, ro) in zip(
            fast, slow, ref):
        _same(fpk, spk, fi)
        _same(fpk, rpk, fi)
        np.testing.assert_array_equal(fl, sl_)
        np.testing.assert_array_equal(fl, rl)
        assert (fo or {}) == (so or {}) == (ro or {})
    return fast


def test_grouping_with_out_of_order_docs(tmp_path):
    """File order != sorted-doc order != first-appearance order: the fast
    grouping still emits sorted-doc groups with file-order rows and
    correctly attached overrides."""
    p = tmp_path / "o.feats"
    p.write_text(
        "1 1:1 # doc:bb;caption_1:0;mention_1:0;caption_2:0;mention_2:1\n"
        "2 1:1 # doc:aa;caption_1:1;mention_1:0;caption_2:1;mention_2:1\n"
        "0 1:1 # doc:cc;caption_1:0;mention_1:0;caption_2:0;mention_2:1\n"
        "3 1:1 # doc:bb;caption_1:2;mention_1:03;caption_2:2;mention_2:1\n"
        "1 1:1 # doc:aa;caption_1:3;mention_1:0;caption_2:3;mention_2:1\n")
    fast = _grouped_three_ways(str(p))
    assert [g[0] for g in fast] == ["aa", "bb", "cc"]
    # the padded bb row carries its exact-bytes override at file position 1
    assert fast[1][3] == {1: "doc:bb;caption_1:2;mention_1:03"
                             ";caption_2:2;mention_2:1"}


def test_grouping_soak_random_files(tmp_path):
    """Shuffled doc orders, interleaved images, zero-padded fields,
    duplicate rows and float/negative labels."""
    rng = random.Random(171)
    docs_pool = ["b.jpg", "a.jpg", "c c.jpg", "z", "m_9.jpg"]
    for trial in range(60):
        lines = []
        for _ in range(rng.randint(1, 40)):
            d = rng.choice(docs_pool)
            ci, mi, cj, mj = (rng.randint(0, 9) for _ in range(4))
            ci_s = f"0{ci}" if rng.random() < 0.15 else str(ci)
            lbl = rng.choice(["0", "1", "2", "3", "-1", "2.7", "0.0"])
            lines.append(f"{lbl} 1:1 # doc:{d};caption_1:{ci_s};"
                         f"mention_1:{mi};caption_2:{cj};mention_2:{mj}")
        p = tmp_path / "g.feats"
        p.write_text("\n".join(lines) + "\n")
        _grouped_three_ways(str(p))


# ---------------------------------------------------------------------------
# Captions and mentions
# ---------------------------------------------------------------------------

def test_caption_ids_parity(tmp_path):
    """Native caption tokenizer == the Python reader + encode_tokens, and
    the JAX package's: exact/lowercase/OOV lookups, non-ASCII rows
    (re-encoded in Python via the flagged-row path), comment/blank lines,
    duplicate keys last-wins, zero-padded caption indices."""
    words = ["the", "Dog", "straße", "dog"]
    vecs = np.arange(12, dtype=np.float32).reshape(4, 3)
    emb = EmbeddingStore.from_arrays(words, vecs)
    p = tmp_path / "c.txt"
    p.write_text("a.jpg#0\tThe dog DOG Dog unknownword\n"
                 "# comment\n\n"
                 "a.jpg#1\tüber STRASSE straße\n"      # non-ASCII row
                 "b.jpg#02\tthe the\n"                 # padded cap idx
                 "b.jpg#2\tdog\n")                     # duplicate key wins
    fast = pipeline._load_caption_ids(str(p), emb)
    assert fast._patched                      # the flagged row went native
    with python_io():
        slow = pipeline._load_caption_ids(str(p), emb)
    ref = jpipe._load_caption_ids(
        str(p), jemb.EmbeddingStore.from_arrays(words, vecs))
    for img, ci in (("a.jpg", 0), ("a.jpg", 1), ("b.jpg", 2)):
        _same(fast.ids(img, ci), slow.ids(img, ci), (img, ci))
        _same(fast.ids(img, ci), ref.ids(img, ci), (img, ci))
    assert fast.ids("a.jpg", 0).tolist() == [1, 4, 4, 2, 0]
    assert fast.ids("b.jpg", 2).tolist() == [4]        # last duplicate wins
    with pytest.raises(KeyError, match="a.jpg#9"):
        fast.ids("a.jpg", 9)
    # bad key -> native whole-file fallback -> read_captions' error
    p.write_text("nokey\tthe\n")
    assert parse_captions(str(p), emb.words_by_row()) is None
    with pytest.raises(ValueError, match="bad caption key"):
        pipeline._load_caption_ids(str(p), emb)


def test_caption_words_parity(tmp_path):
    """Native split_vocab scan == read_captions dict walk, including
    duplicate keys (last-wins: words of overwritten lines must not enter
    the prune vocabulary) and non-ASCII rows."""
    from icl.cli._common import split_vocab as jsplit_vocab
    from icl_torch.cli._common import split_vocab

    p = tmp_path / "train.captions.txt"
    p.write_text("a.jpg#0\talpha beta\n"
                 "# comment\n"
                 "b.jpg#1\tgamma Straße\n"
                 "a.jpg#00\tdelta epsilon\n")   # overwrites a.jpg#0
    fast = caption_words(str(p))
    slow = set()
    for cap in tcaps.read_captions(str(p)).values():
        slow.update(cap.tokens)
    assert fast == slow == split_vocab(str(tmp_path), "train")
    assert fast == jsplit_vocab(str(tmp_path), "train")
    assert "alpha" not in fast and "delta" in fast and "Straße" in fast
    p.write_text("nokey\tthe\n")
    assert caption_words(str(p)) is None        # grammar fallback
    with pytest.raises(ValueError, match="bad caption key"):
        split_vocab(str(tmp_path), "train")


def test_caption_words_key_region_high_bytes(tmp_path):
    """Invalid UTF-8 in the KEY region never reaches Python from the words
    scan, so the native path falls back whole-file and split_vocab hits
    read_captions' UnicodeDecodeError instead of silently succeeding."""
    p = tmp_path / "c.txt"
    p.write_bytes(b"a\xffb.jpg#0\talpha beta\n")
    assert caption_words(str(p)) is None
    for read in (tcaps.read_captions, jcaps.read_captions):
        with pytest.raises(UnicodeDecodeError):
            read(str(p))


def _mention_columns_equal(path):
    fast = tcaps.read_mention_columns(path)
    slow = tcaps.read_mention_columns(path, use_native=False)
    ref = jcaps.read_mention_columns(path, use_native=False)
    assert fast.docs == slow.docs == ref.docs
    for f in ("doc_idx", "cap_idx", "mention_idx", "first", "last"):
        _same(getattr(fast, f), getattr(slow, f), f)
        _same(getattr(fast, f), getattr(ref, f), f)
        assert getattr(fast, f).dtype == np.int32
    return fast


def test_mention_columns_parity(synth_dir):
    """Padded id fields and comment/blank lines."""
    path = f"{synth_dir}/train.mentions.txt"
    with open(path, "a") as f:
        f.write("# a comment line\n\n"
                "doc:zz.jpg;caption:02;mention:1\t3,07\textra text\n")
    assert parse_mentions(path) is not None
    fast = _mention_columns_equal(path)
    assert fast.docs[-1] == "zz.jpg" and fast.cap_idx[-1] == 2
    assert fast.first[-1] == 3 and fast.last[-1] == 7


def test_mention_columns_fallback_cases(tmp_path):
    """Lines the strict native grammar cannot prove equivalent fall back
    whole-file: the reader then raises read_mentions' exact error or
    accepts what Python accepts."""
    ok = "doc:a.jpg;caption:0;mention:1\t2,3\n"
    for bad, python_accepts in (
            ("doc:a.jpg;caption:0;mention:1\t3,2\n", False),   # first > last
            ("doc:a.jpg;caption:0;mention:1\t2\n", False),     # no comma
            ("doc:a.jpg;caption:0;mention:1\n", False),        # no span
            ("doc:bad id\t2,3\n", False),                      # bad grammar
            ("doc:a.jpg;caption:0;mention:1\t+2,3\n", True),   # int('+2')=2
            ("doc:a.jpg;caption:0;mention:1\t 2,3\n", True)):  # int(' 2')=2
        p = tmp_path / "m.txt"
        p.write_text(ok + bad)
        assert parse_mentions(str(p)) is None, bad  # native punts
        if python_accepts:
            assert len(_mention_columns_equal(str(p)).cap_idx) == 2
        else:
            for read in (tcaps.read_mention_columns,
                         jcaps.read_mention_columns):
                with pytest.raises(ValueError):
                    read(str(p))
    # universal newlines: CRLF and bare-CR line breaks parse natively,
    # as Python text mode splits them
    p = tmp_path / "m.txt"
    p.write_bytes(b"doc:a.jpg;caption:0;mention:1\t2,3\r\n"
                  b"doc:b.jpg;caption:1;mention:0\t0,1\r"
                  b"doc:c.jpg;caption:2;mention:2\t1,4\n")
    assert parse_mentions(str(p)) is not None
    assert _mention_columns_equal(str(p)).docs == ["a.jpg", "b.jpg", "c.jpg"]


def test_duplicate_mention_key_keeps_last(tmp_path):
    """Duplicate (cap, mention) rows: last wins, as the dict lookups did."""
    p = tmp_path / "m.txt"
    p.write_text("doc:a.jpg;caption:0;mention:0\t0,1\n"
                 "doc:a.jpg;caption:0;mention:1\t1,1\n"
                 "doc:a.jpg;caption:0;mention:1\t2,3\n")  # duplicate key
    cols = _mention_columns_equal(str(p))
    sl = pipeline._mention_groups(cols)["a.jpg"]
    mkeys = (cols.cap_idx[sl].astype(np.int64) << 32) | cols.mention_idx[sl]
    ij = pipeline._rows_for_mentions(mkeys, np.array([[0, 0, 0, 1]],
                                                     np.int32))
    assert int(cols.first[sl[ij[0, 1]]]) == 2
    with pytest.raises(KeyError):
        pipeline._rows_for_mentions(mkeys, np.array([[0, 0, 0, 9]],
                                                    np.int32))


def test_mentions_and_captions_fuzz_one_sided(tmp_path):
    """Randomized grammar crosscheck (one-sided, as native may punt
    conservatively): whenever the native parse returns, it equals the
    Python reader's; whenever the Python reader raises, native punted."""
    rng = random.Random(13)
    pieces = ["doc:", "caption:", "mention:", ";", "#", "\t", ",", " ",
              "0", "7", "07", "a.jpg", "", "x y", "x", ":", "12", "-1",
              "+3", "1_0", "\r", "word", "Wo", "2,3"]
    lines = ["".join(rng.choice(pieces) for _ in range(rng.randint(1, 8)))
             for _ in range(1200)]
    lines += ["doc:a.jpg;caption:0;mention:1\t2,3",
              "doc:a.jpg;caption:0;mention:1\t2,3\tsome text",
              "a.jpg#0\tThe dog", "a.jpg#0\t", "a.jpg#0", "b#1\tx y z"]
    p = tmp_path / "f.txt"
    for ln in lines:
        p.write_text(ln + "\n")
        try:
            want = tcaps.read_mentions(str(p))
        except ValueError:
            want = None
        got = parse_mentions(str(p))
        if want is None:
            assert got is None, ("mentions", ln)
        elif got is not None:
            docs, doc_idx, cap, men, first, last = got
            assert len(cap) == len(want), ("mentions", ln)
            for i, m in enumerate(want):
                assert (docs[doc_idx[i]], cap[i], men[i], first[i],
                        last[i]) == (m.img_id, m.cap_idx, m.mention_idx,
                                     m.first, m.last), ("mentions", ln)
        try:
            pw = set()
            for c in tcaps.read_captions(str(p)).values():
                pw.update(c.tokens)
        except ValueError:
            pw = None
        gw = caption_words(str(p))
        if pw is None:
            assert gw is None, ("captions", ln)
        elif gw is not None:
            assert gw == pw, ("captions", ln)


# ---------------------------------------------------------------------------
# .feats readers, the word2vec loader, the .scores writer
# ---------------------------------------------------------------------------

def _feats_equal(path):
    ids_n, lab_n = tfeats.read_feats_labels(path, use_native=True)
    ids_p, lab_p = tfeats.read_feats_labels(path, use_native=False)
    ids_j, lab_j = jfeats.read_feats_labels(path, use_native=False)
    assert ids_n == ids_p == ids_j
    np.testing.assert_array_equal(lab_n, lab_p)
    np.testing.assert_array_equal(lab_n, lab_j)
    full = [tfeats.read_feats(path, use_native=True),
            tfeats.read_feats(path, use_native=False),
            jfeats.read_feats(path, use_native=False)]
    assert len(full[0]) == len(full[1]) == len(full[2])
    for a, *others in zip(*full):
        for b in others:
            assert a.example_id == b.example_id
            assert a.label == b.label or (a.label != a.label
                                          and b.label != b.label)
            _same(a.indices, b.indices, a.example_id)
            _same(a.values, b.values, a.example_id)
    return ids_n, lab_n, full[0]


def test_feats_labels_raw_fuzz(tmp_path):
    """Random raw lines through both feats parsers: the native label scan
    has no fallback, so (ids, labels) and the full sparse rows must match
    the Python parsers exactly on arbitrary garbage."""
    rng = random.Random(29)
    pieces = ["1", "0.5", "-2", "nan", "1e3", "0x1A", "1_0", "#", " ",
              "\t", ":", "2:3", "abc", "doc:a;m:1", "\r", "", "99999999999",
              "3:", ":4", "+", "1.5e", "# id with spaces ", "\v", "\f",
              " ", "٣", "Inf", "nan(1)", "nan(", "1:nan(2)"]
    p = tmp_path / "f.feats"
    for trial in range(400):
        content = ""
        for _ in range(rng.randint(1, 6)):
            content += "".join(rng.choice(pieces)
                               for _ in range(rng.randint(0, 6)))
            content += rng.choice(["\n", "\r\n", "\r", "\n"])
        p.write_text(content, newline="")   # keep exact bytes
        try:
            _feats_equal(str(p))
        except AssertionError as e:
            raise AssertionError((trial, content)) from e


def test_feats_universal_newlines(tmp_path):
    """A bare CR is a line break in Python text mode: the C++ parsers
    split identically."""
    p = tmp_path / "t.feats"
    p.write_bytes(b"1 2:3 # doc:a;caption:0;mention:1\r"
                  b"0 4:5 # doc:b;caption:1;mention:0\r\n"
                  b"2 1:1 # doc:c;caption:2;mention:2\n")
    assert parse_feats_labels(str(p)) is not None
    assert parse_feats_file(str(p)) is not None
    ids, labels, full = _feats_equal(str(p))
    assert ids == ["doc:a;caption:0;mention:1", "doc:b;caption:1;mention:0",
                   "doc:c;caption:2;mention:2"]
    assert [e.label for e in full] == [1.0, 0.0, 2.0]


def test_w2v_native_rejection_falls_back_to_python(tmp_path):
    """A null native w2v handle means a missing file OR a rejected header:
    only the former is FileNotFoundError; an existing-but-rejected file
    takes the Python loader (keep-what-parsed)."""
    from icl_torch.native.w2v import load_binary

    p = tmp_path / "huge_dim.bin"
    p.write_bytes(b"2 2000000000\nthe \x01\x02")     # native dim cap rejects
    assert load_binary(str(p)) is None
    assert len(EmbeddingStore.load(str(p)).vocab) == 0
    assert len(jemb.EmbeddingStore.load(str(p)).vocab) == 0
    with pytest.raises(FileNotFoundError):
        EmbeddingStore.load(str(tmp_path / "absent.bin"))


def test_w2v_native_load_matches_python(tmp_path):
    from icl_torch.native.w2v import load_binary

    rng = np.random.default_rng(5)
    words = ["Dog", "dog", "ünï", "a-b", "zebra"]
    path = str(tmp_path / "e.bin")
    EmbeddingStore.from_arrays(
        words, rng.normal(size=(5, 7)).astype(np.float32)).save_binary(path)
    for keep in (None, ["dog", "Zebra", "ünï"]):
        assert load_binary(path, keep) is not None
        fast = EmbeddingStore.load(path, restrict_to=keep)
        with python_io():
            slow = EmbeddingStore.load(path, restrict_to=keep)
        ref = jemb.EmbeddingStore.load(path, restrict_to=keep)
        assert fast.vocab == slow.vocab == ref.vocab
        _same(fast.table, slow.table, keep)
        _same(fast.table, ref.table, keep)


def _python_scores(path, ids, probs):
    with open(path, "w", encoding="utf-8", newline="\n") as f:
        for eid, row in zip(ids, probs):
            f.write(eid + "," + ",".join(f"{v:.6f}" for v in row) + "\n")
    return open(path, "rb").read()


def test_extreme_values_native_python_byte_parity(tmp_path):
    """%.6f of ±1e300 is ~314 characters: the native writer's buffer must
    hold it (or bail to the Python fallback); a sign-bit NaN prints "nan"
    as Python does, not glibc's "-nan".  Both paths and the JAX package's
    writer give the same bytes."""
    ids = ["a", "b", "c"]
    probs = np.array([[1e300, -1e300], [0.5, 1e-300], [np.nan, -np.nan]])
    want = _python_scores(str(tmp_path / "p.scores"), ids, probs)
    if write_scores_native(str(tmp_path / "n.scores"), ids, probs):
        assert open(tmp_path / "n.scores", "rb").read() == want
    for mod in (tscores, jscores):
        path = str(tmp_path / f"{mod.__name__}.scores")
        mod.write_scores(path, ids, probs)
        assert open(path, "rb").read() == want


@pytest.mark.parametrize("chunk", [1, 3, 200_000])
def test_scores_writer_streams_chunks(tmp_path, chunk):
    """Rows stream in chunks (the first truncates, the rest append): any
    chunk size writes the Python loop's bytes."""
    rng = np.random.default_rng(chunk)
    n = 7
    ids = [f"doc:im{i}.jpg;caption:{i % 5};mention:{i % 3}" for i in range(n)]
    probs = rng.random((n, 4))
    probs[1, 0] = 0.1234565                      # a rounding tie
    path = str(tmp_path / "n.scores")
    open(path, "w").write("stale bytes\n" * 50)  # overwritten, not appended
    assert write_scores_native(path, ids, probs, chunk=chunk)
    assert open(path, "rb").read() == _python_scores(
        str(tmp_path / "p.scores"), ids, probs)
    with python_io():
        tscores.write_scores(str(tmp_path / "t.scores"), ids, probs)
    assert open(tmp_path / "t.scores", "rb").read() == open(path, "rb").read()


# ---------------------------------------------------------------------------
# Degradation: a failed build, a stale library, demotion warnings
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The loader as at a process's first call, building into tmp_path."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_failed", False)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.delenv(tnative.OFF_SWITCH, raising=False)
    return tmp_path


def _feats_fallback_still_reads(tmp_path):
    feats = tmp_path / "t.feats"
    feats.write_text("1 3:0.5 7:1.0 # doc:x;m:0\n0 2:0.25 # doc:x;m:1\n")
    ids, labels = tfeats.read_feats_labels(str(feats))
    assert ids == ["doc:x;m:0", "doc:x;m:1"]
    np.testing.assert_array_equal(labels, [1.0, 0.0])


def test_failed_build_warns_once_and_degrades(fresh_native, monkeypatch,
                                              log_capture):
    calls = fresh_native / "calls"
    cxx = fresh_native / "broken-cxx"
    cxx.write_text(f"#!/bin/sh\necho x >> {calls}\n"
                   "echo 'icl_native.cpp:1: error: no compiler here' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    assert tnative._load() is None and tnative._load_failed
    assert tnative.available() is False      # remembered: not built again
    _feats_fallback_still_reads(fresh_native)
    err = log_capture.getvalue()
    assert err.count("native I/O library unusable") == 1, err
    assert "no compiler here" in err and "pure-Python" in err, err
    # --version for the library's name, then the one build
    assert calls.read_text().count("x") == 2
    assert not list((fresh_native / "_build").glob("*.tmp"))


def test_stale_library_degrades_to_python(fresh_native, monkeypatch,
                                          log_capture):
    """A library without the bound symbols (or one that does not load)
    degrades with one WARNING, no AttributeError through the loaders."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build a stale stand-in library")
    src = fresh_native / "stale.cpp"
    src.write_text('extern "C" int unrelated_symbol() { return 1; }\n')
    so = fresh_native / "libstale.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True, capture_output=True)
    not_a_library = fresh_native / "text.so"
    not_a_library.write_text("not an ELF file\n")
    for path, error in ((so, "AttributeError"), (not_a_library, "OSError")):
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_load_failed", False)
        monkeypatch.setattr(tnative, "build", lambda p=path: (p, 0.0))
        assert tnative._load() is None and tnative._load_failed
        assert tnative.available() is False
        _feats_fallback_still_reads(fresh_native)
        assert f"unusable ({error}" in log_capture.getvalue()


def test_off_switch_builds_and_loads_nothing(fresh_native, monkeypatch,
                                             log_capture):
    monkeypatch.setenv(tnative.OFF_SWITCH, "1")
    monkeypatch.setattr(tnative, "build", lambda: pytest.fail("built"))
    assert tnative.available() is False
    _feats_fallback_still_reads(fresh_native)
    assert log_capture.getvalue() == ""


def test_library_is_named_by_source_flags_and_compiler(fresh_native):
    """Built once into the build dir under a hashed name, then taken from
    the cache; another compiler version or CPU names another library."""
    cxx, version = tnative.compiler()
    path, seconds = tnative.build()
    assert seconds > 0 and path.parent == fresh_native / "_build"
    assert path == tnative.library_path(cxx, version)
    assert tnative.build() == (path, 0.0)
    assert tnative.library_path(cxx, version + " other") != path
    assert tnative._load() is not None


def test_demotion_warning_carries_file_and_line(tmp_path, log_capture):
    """A whole-load fallback says WHICH line triggered it: line 3's id is
    padded with a non-breaking space, which Python's strip() removes."""
    p = tmp_path / "t.feats"
    p.write_bytes(b"1.0 1:2.0 # doc:a;mention:0\n"
                  b"0.0 2:1.5 # doc:b;mention:1\n"
                  b"1.0 3:0.5 # \xc2\xa0doc:c;mention:2\n")
    assert parse_feats_file(str(p)) is None
    err = log_capture.getvalue()
    assert "line 3" in err and "t.feats" in err, err
    assert "icl-torch-check" in err, err
    assert parse_feats_labels(str(p)) is None
    assert log_capture.getvalue().count("line 3") >= 2
    _feats_equal(str(p))            # the Python path reads it all the same


def test_mentions_demotion_warning_line(tmp_path, log_capture):
    p = tmp_path / "m.txt"
    p.write_text("doc:a.jpg;caption:0;mention:0\t0,1\n"
                 "doc:a.jpg;caption:0;mention:1\t1,2\n"
                 "not-an-id\t0,1\n")
    assert parse_mentions(str(p)) is None
    err = log_capture.getvalue()
    assert "line 3" in err and "m.txt" in err, err


@pytest.mark.parametrize("terminators", ["lf", "mixed_cr"])
def test_check_census_counts_nonascii_lines(tmp_path, capsys, terminators):
    """icl-torch-check's census of the non-ASCII lines that demote a
    native load, numbered as the parsers' universal newlines number them
    (bare \\r, \\r\\n and a trailing \\r)."""
    from icl_torch.cli import check as check_cli

    d = tmp_path / "data"
    generate_dataset(str(d), "train", SynthConfig(num_images=2, seed=0))
    feats = d / "train.nonvisual.feats"
    lines = feats.read_bytes().splitlines()
    if terminators == "lf":
        lines[1] += b"\xc2\xa0"
        blob, expect = b"\n".join(lines) + b"\n", 2
    else:
        # line 3 hides in the first physical \n-chunk behind a bare \r
        # and an \r\n; the file ends with a bare \r
        blob = (lines[0] + b"\r" + lines[1] + b"\r\n" + lines[2]
                + b"\xc2\xa0" + b"\n" + b"\n".join(lines[3:]) + b"\r")
        expect = 3
    feats.write_bytes(blob)
    try:
        check_cli.main(["--data_dir", str(d), "--data_split", "train"])
    except SystemExit:
        pass  # an NBSP-padded id is legal data: the exit code is not gated
    cap = capsys.readouterr()
    out = cap.out + cap.err
    assert "non-ASCII" in out and f"first: line {expect}" in out, out


# ---------------------------------------------------------------------------
# Memory safety: the port's C++ under ASAN/UBSAN
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """``native/asan_harness.cpp`` (read only) built against the port's
    copy of the library, in a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ for the sanitizer build")
    out = tmp_path_factory.mktemp("asan") / "asan_harness"
    r = subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-Wall",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         "-o", str(out), str(tnative.SOURCE),
         os.path.join(REPO, "native", "asan_harness.cpp")],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    return str(out)


def _run(harness, paths):
    r = subprocess.run([harness, *map(str, paths)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:] or r.stdout[-2000:]
    assert "asan-harness: OK" in r.stdout


def test_sanitizers_clean_on_synth_split(harness, tmp_path):
    d = tmp_path / "d"
    generate_dataset(str(d), "train", SynthConfig(num_images=3, seed=61))
    _run(harness, [d / "train.relation.feats", d / "train.affinity.feats",
                   d / "train.nonvisual.feats", d / "train.mentions.txt",
                   d / "train.captions.txt"])


def test_sanitizers_clean_on_adversarial_bytes(harness, tmp_path):
    cases = {
        "empty": b"",
        "no_newline": b"1 2:3 # doc:a;caption:0;mention:1",
        "only_newlines": b"\n\r\n\r\r\r\n",
        "nul_bytes": b"1 2:3 # doc:a\x00b;caption:0;mention:1\n\x00\x00\n",
        "huge_line": b"1 " + b"2:3 " * 100_000 + b"# doc:a;m:0\n",
        "hash_storm": b"#" * 5000 + b"\n# # # #\n1 # # #\n",
        "truncated_utf8": b"1 2:3 # doc:caf\xc3\n",
        "high_bytes": bytes(range(1, 256)) + b"\n",
        "tabs_only": b"\t\t\t\n\t1\t2,3\n",
        "deep_fields": b"doc:" + b";caption:1" * 2000 + b"\t1,2\n",
        "long_token": b"a.jpg#1\t" + b"x" * 200_000 + b"\n",
        # truncated/overstated w2v .bin headers (the harness drives
        # w2v_load over every input)
        "w2v_truncated": b"1000000 300\nthe " + b"\x00" * 40,
        "w2v_zero_dim": b"5 0\nthe ",
        "w2v_huge_dim": b"2 2000000000\nthe \x01\x02",
    }
    paths = []
    for name, data in cases.items():
        p = tmp_path / name
        p.write_bytes(data)
        paths.append(p)
    _run(harness, paths)
