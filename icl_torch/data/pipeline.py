"""Dataset assembly: files → padded index-table datasets (layer L3).

Reference parity: SURVEY.md §4.1–4.4.  The reference assembled per-example
feature vectors inside Python loops at train time; here each split is turned
once, on host, into dense numpy tables that jit-compiled programs consume
with static shapes:

* **mention datasets** (nonvisual / cardinality): flat ``[N, L]`` token-id
  rows per mention — SURVEY §4.4.
* **relation datasets**: *image-centric* — captions ``[I, C, L]``, mention
  span tables ``[I, M]``, pair index tables ``[I, P]``.  Each caption is
  encoded exactly once per step (the reference re-embedded both captions for
  every one of the O(M²) pairs); pairs are formed on-device from mention
  indices (XLA gather or Pallas K1) — SURVEY §4.1, §9.3(3).
* **affinity datasets**: image-centric grids — phrases ``[I, M, L]`` ×
  boxes ``[I, B, 4096]`` with a dense ``[I, M, B]`` label/valid grid, so the
  affinity head runs as two GEMMs + broadcast-add instead of per-pair concat
  (the K2 restructuring, SURVEY §4.3).

Data-dir layout (DECISION, SURVEY §0 — reference checkout empty):
``<split>.captions.txt``, ``<split>.mentions.txt``, ``<split>.<task>.feats``,
``<split>.boxes.npz``; embeddings via an explicit path.

Affinity example-id scheme (DECISION):
``doc:<img>;caption:<ci>;mention:<mi>;box:<bi>`` — consistent with §6.1.

The port's own copy of ``icl/data/pipeline.py``: ``icl_torch`` imports
nothing of the JAX package, and ``tests/test_torch_data.py`` holds the two
copies to the same outputs.  Rationale below is the original's; where it
names XLA or the TPU, read PyTorch and the GPU.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from array import array

import numpy as np

from icl_torch.data.embeddings import EmbeddingStore
from icl_torch.io.boxes import group_boxes_by_image, read_box_feats
from icl_torch.io.captions import (MentionColumns, make_pair_id,
                             parse_pair_id_padded, read_captions,
                             read_mention_columns)
from icl_torch.io.feats import read_feats_labels

# affinity id grammar (implemented by hand below, see icl.io.captions):
#   doc:(?P<doc>[^;]+);caption:(\d+);mention:(\d+);box:(\d+)$


def parse_affinity_id(example_id: str) -> tuple[str, int, int, int]:
    img, ci, mi, bi, _ = parse_affinity_id_padded(example_id)
    return img, ci, mi, bi


def parse_affinity_id_padded(
        example_id: str) -> tuple[str, int, int, int, bool]:
    """Manual parse of the affinity id grammar (3-4x faster at MSCOCO
    scale, see icl.io.captions) plus the zero-padded-field flag — padded
    ids don't round-trip re-serialization and take the exact-bytes
    override path below."""
    if example_id.startswith("doc:"):
        doc, s1, rest = example_id[4:].partition(";caption:")
        ci, s2, rest = rest.partition(";mention:")
        mi, s3, bi = rest.partition(";box:")
        if (s1 and s2 and s3 and doc and ";" not in doc
                and ci.isdigit() and mi.isdigit() and bi.isdigit()
                and (ci + mi + bi).isascii()):
            return (doc, int(ci), int(mi), int(bi),
                    (ci != "0" and ci[0] == "0")
                    or (mi != "0" and mi[0] == "0")
                    or (bi != "0" and bi[0] == "0"))
    raise ValueError(f"bad affinity id: {example_id!r}")


def make_affinity_id(img_id: str, ci: int, mi: int, bi: int) -> str:
    return f"doc:{img_id};caption:{ci};mention:{mi};box:{bi}"


# The id grammar is rigid (fixed field names/separators; the doc field is
# copied verbatim), so the ONLY way a valid id can differ from its
# canonical re-serialization is a zero-padded numeric field (":007") —
# which the parse_*_padded parsers flag for free during field validation.
# Flagged rows store the file's exact bytes as an override: predict must
# emit those bytes — the downstream join (gold `.feats` vs written
# `.scores`, SURVEY §6.2) is on raw strings.


def split_path(data_dir: str, split: str, what: str) -> str:
    return os.path.join(data_dir, f"{split}.{what}")


# ---------------------------------------------------------------------------
# Mention-level datasets (nonvisual, cardinality)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MentionDataset:
    """Flat per-mention dataset: token ids + true length + label + id."""

    token_ids: np.ndarray    # int32[N, L]
    lengths: np.ndarray      # int32[N]
    labels: np.ndarray       # int32[N]
    ids: list[str]

    @property
    def max_len(self) -> int:
        return self.token_ids.shape[1]


def load_mention_dataset(
    data_dir: str, split: str, task: str, emb: EmbeddingStore, max_len: int = 16,
) -> MentionDataset:
    """Join <split>.<task>.feats labels with mention token spans.

    Labels-only `.feats` read: the sparse feature columns feed the sklearn
    baseline alone (SURVEY §4.4), so the loaders skip them entirely.
    Same native fast path as the relation/affinity loaders (C++ id table +
    columnar mentions); mentions resolve by parsed (doc, caption, mention)
    ints, so non-canonical (zero-padded) feats ids join correctly while
    ``ids`` keeps the file's exact bytes for the `.scores` round-trip
    (§6.1 override discipline — the pre-r3 dict join crashed on them)."""
    from icl_torch.io.captions import parse_mention_id_padded

    feats_path = split_path(data_dir, split, f"{task}.feats")
    from icl_torch.native import feats as _nat

    fast = _nat.parse_feats_ids(feats_path, "mention")
    cap_ids = _load_caption_ids(
        split_path(data_dir, split, "captions.txt"), emb)
    cols = read_mention_columns(split_path(data_dir, split, "mentions.txt"))
    groups = _mention_groups(cols)

    if fast is not None:
        flabels, fields, doc_idx, docs, row_over = fast
        n = len(flabels)
        labels = flabels.astype(np.int32)
        ids = [None] * n
        row_doc = [docs[d] for d in doc_idx.tolist()]
        row_ci = fields[:, 0].tolist()
        row_mi = fields[:, 1].tolist()
    else:
        raw_ids, flabels = read_feats_labels(feats_path)
        n = len(raw_ids)
        labels = flabels.astype(np.int32)
        ids = list(raw_ids)
        row_doc, row_ci, row_mi, row_over = [None] * n, [0] * n, [0] * n, {}
        for r, eid in enumerate(raw_ids):
            img, ci, mi, padded = parse_mention_id_padded(eid)
            row_doc[r], row_ci[r], row_mi[r] = img, ci, mi

    token_ids = np.zeros((n, max_len), dtype=np.int32)
    lengths = np.zeros(n, dtype=np.int32)
    cur_doc, sl, mkeys = None, None, None
    for r in range(n):
        img, ci, mi = row_doc[r], row_ci[r], row_mi[r]
        if ids[r] is None:
            ids[r] = row_over.get(r) or f"doc:{img};caption:{ci};mention:{mi}"
        if img != cur_doc:
            cur_doc = img
            sl = groups.get(img)
            mkeys = (None if sl is None else
                     (cols.cap_idx[sl].astype(np.int64) << 32)
                     | cols.mention_idx[sl])
        enc = (ci << 32) | mi
        pos = (-1 if mkeys is None
               else int(np.searchsorted(mkeys, enc, side="right")) - 1)
        if pos < 0 or mkeys[pos] != enc:
            raise KeyError(ids[r])
        g = int(sl[pos])
        seg = cap_ids.ids(img, ci)[int(cols.first[g]):int(cols.last[g]) + 1]
        n_tok = min(len(seg), max_len)
        token_ids[r, :n_tok] = seg[:n_tok]
        lengths[r] = n_tok
    return MentionDataset(token_ids, lengths, labels, ids)


# ---------------------------------------------------------------------------
# Caption token-id table: captions.txt pre-encoded to vocab rows
# ---------------------------------------------------------------------------

class _CaptionIds:
    """Per-caption token-id rows keyed (img, cap_idx).

    The id arrays are exactly what ``emb.encode_tokens(cap.tokens, len)``
    would produce (exact match → ASCII/Unicode lowercase → PAD 0), built
    either by the C++ tokenizer or the Python reader; loaders slice/pad
    them instead of re-encoding token strings per use."""

    def __init__(self, lookup, flat, offsets, patched):
        self._lookup = lookup       # img -> {cap_idx -> row}, last-wins
        self._flat = flat           # int32[T]
        self._off = offsets         # int64[rows+1]
        self._patched = patched     # row -> int32[...] (non-ASCII rows)

    def ids(self, img: str, ci: int) -> np.ndarray:
        d = self._lookup.get(img)
        row = None if d is None else d.get(ci)
        if row is None:
            raise KeyError(f"{img}#{ci}")   # read_captions-dict parity
        p = self._patched.get(row)
        if p is not None:
            return p
        return self._flat[self._off[row]:self._off[row + 1]]


def _load_caption_ids(path: str, emb: EmbeddingStore) -> _CaptionIds:
    from icl_torch.native import captions as _nat

    fast = _nat.parse_captions(path, emb.words_by_row())
    if fast is not None:
        docs, doc_idx, cap_idx, offsets, ids, flagged = fast
        lookup: dict[str, dict[int, int]] = {}
        di, ci_l = doc_idx.tolist(), cap_idx.tolist()
        for r in range(len(di)):
            lookup.setdefault(docs[di[r]], {})[ci_l[r]] = r
        patched = {r: np.fromiter((emb.lookup_id(t) for t in text.split()),
                                  np.int32)
                   for r, text in flagged.items()}
        return _CaptionIds(lookup, ids, offsets, patched)
    caps = read_captions(path)
    lookup = {}
    chunks, offsets = [], [0]
    for r, cap in enumerate(caps.values()):
        lookup.setdefault(cap.img_id, {})[cap.cap_idx] = r
        chunks.append(np.fromiter((emb.lookup_id(t) for t in cap.tokens),
                                  np.int32, len(cap.tokens)))
        offsets.append(offsets[-1] + len(cap.tokens))
    flat = (np.concatenate(chunks) if chunks else np.empty(0, np.int32))
    return _CaptionIds(lookup, flat, np.asarray(offsets, np.int64), {})


def _pad_id_rows(rows: list[np.ndarray], max_len: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged id rows into (int32[N, L] zero-padded, int32[N] len) —
    ``encode_tokens`` semantics: truncate at max_len when given."""
    L = max((len(r) for r in rows), default=0)
    if max_len is not None:
        L = max_len
    out = np.zeros((len(rows), L), np.int32)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        n = min(len(r), L)
        out[i, :n] = r[:n]
        lens[i] = n
    return out, lens


# ---------------------------------------------------------------------------
# Native fast path: group feats rows by image without Python id strings
# ---------------------------------------------------------------------------

def _fast_grouped_rows(path: str, kind: str):
    """C++-parsed (img_id, fields i32[P,k], labels i32[P], overrides) groups
    in sorted-img order, rows in file order within each image — exactly the
    grouping the pure-Python loaders build row-by-row (the id parse was
    ~60% of a 50k-image load wall).  None → caller takes the Python path
    (native unavailable, or any id/label deviates: grammar, int32 range,
    non-finite labels — the slow path's exact error behavior applies)."""
    from icl_torch.native import feats as _nat

    fast = _nat.parse_feats_ids(path, kind)
    if fast is None:
        return None
    flabels, fields, doc_idx, docs, row_overrides = fast
    if len(flabels) == 0:
        return []
    if not np.isfinite(flabels).all() or np.abs(flabels).max() > 2**31 - 1:
        # int(nan/inf) raises in the Python path, and an int32-overflowing
        # label raises OverflowError at array('i') — astype would silently
        # wrap; take the Python path for its exact behavior
        return None
    # rows sorted by doc STRING (the loaders' sorted(by_img) order) with a
    # stable sort, so file order is preserved within each image
    order_docs = sorted(range(len(docs)), key=docs.__getitem__)
    rank = np.empty(len(docs), np.int64)
    rank[order_docs] = np.arange(len(docs))
    row_rank = rank[doc_idx]
    order = np.argsort(row_rank, kind="stable")
    sorted_rank = row_rank[order]
    bounds = np.flatnonzero(np.diff(sorted_rank)) + 1
    slices = np.split(order, bounds)
    labels_i = flabels.astype(np.int32)   # truncation == Python int(lbl)
    over_by_rank: dict[int, dict[int, str]] = {}
    if row_overrides:
        # slices hold ORIGINAL row indices (ascending within each group,
        # since the stable sort keeps file order): index groups by the
        # rank of their first ROW, i.e. row_rank[sl[0]] — NOT sorted_rank,
        # which is positional (caught by test_native_ids out-of-order case)
        slice_of_rank = {int(row_rank[s[0]]): s for s in slices}
        for g, eid in row_overrides.items():
            r = int(row_rank[g])
            sl = slice_of_rank[r]
            over_by_rank.setdefault(r, {})[int(np.searchsorted(sl, g))] = eid
    return [(docs[order_docs[int(row_rank[sl[0]])]],
             fields[sl], labels_i[sl],
             over_by_rank.get(int(row_rank[sl[0]])))
            for sl in slices]


# ---------------------------------------------------------------------------
# Relation dataset (image-centric)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RelationImage:
    """One image's caption/mention/pair tables, unpadded."""

    img_id: str
    tokens: np.ndarray       # int32[C, L_img] (L_img = max caption len here)
    tok_len: np.ndarray      # int32[C]
    m_cap: np.ndarray        # int32[M] caption row of each mention
    m_first: np.ndarray      # int32[M]
    m_last: np.ndarray       # int32[M]
    pair_ij: np.ndarray      # int32[P, 2] mention-row pairs
    pair_label: np.ndarray   # int32[P]
    pair_key: np.ndarray     # int32[P, 4] original (ci, mi, cj, mj) indices
    # rare non-canonical feats ids (zero-padded fields), row → exact string
    pair_id_overrides: dict[int, str] | None = None

    @functools.cached_property
    def pair_ids(self) -> list[str]:
        """§6.1 pair-id strings, derived on demand from ``pair_key``.

        Ids feed only `.scores` writing at predict; a training split never
        materializes them (≈90 bytes/string × millions of pairs at MSCOCO
        scale — the dataset stores 16 bytes of ints instead, VERDICT r2
        missing#2).  Cached once touched: predict derives them up to three
        times (batcher ids, parity audit, write order) and training never
        touches the property, so the bound is unaffected.  Overrides
        restore the file's exact bytes for non-canonical ids."""
        ids = [make_pair_id(self.img_id, ci, mi, cj, mj)
               for ci, mi, cj, mj in self.pair_key.tolist()]
        if self.pair_id_overrides:
            for r, s in self.pair_id_overrides.items():
                ids[r] = s
        return ids


@dataclasses.dataclass
class RelationDataset:
    images: list[RelationImage]

    @property
    def num_pairs(self) -> int:
        return sum(len(im.pair_label) for im in self.images)


def _python_grouped_pair_rows(path: str):
    """Pure-Python grouping (the pre-native structure): gold
    (ci, mi, cj, mj, label) rows accumulate per image into compact
    ``array('i')`` buffers (20 bytes/pair instead of a tuple-of-ints per
    pair — the MSCOCO-scale memory posture, VERDICT r2 missing#2)."""
    ids, flabels = read_feats_labels(path)
    labels_by_img: dict[str, array] = {}
    overrides_by_img: dict[str, dict[int, str]] = {}
    for eid, lbl in zip(ids, flabels):
        img, ci, mi, cj, mj, padded = parse_pair_id_padded(eid)
        rows = labels_by_img.get(img)
        if rows is None:
            rows = labels_by_img.setdefault(img, array("i"))
        if padded:
            overrides_by_img.setdefault(img, {})[len(rows) // 5] = eid
        rows.extend((ci, mi, cj, mj, int(lbl)))
    del ids, flabels
    out = []
    for img_id in sorted(labels_by_img):
        rows = np.frombuffer(labels_by_img[img_id], dtype=np.int32
                             ).reshape(-1, 5)
        out.append((img_id, np.ascontiguousarray(rows[:, :4]),
                    np.ascontiguousarray(rows[:, 4]),
                    overrides_by_img.get(img_id)))
    return out


def _mention_groups(cols: MentionColumns) -> dict[str, np.ndarray]:
    """img_id → row indices of its mentions, sorted by (cap_idx,
    mention_idx) with file order for ties (the ``sorted(ms, key=...)``
    of the object-based loaders, vectorized with one global lexsort)."""
    if len(cols.doc_idx) == 0:
        return {}
    order = np.lexsort((cols.mention_idx, cols.cap_idx, cols.doc_idx))
    sorted_doc = cols.doc_idx[order]
    bounds = np.flatnonzero(np.diff(sorted_doc)) + 1
    return {cols.docs[int(sorted_doc[s[0]])]: s
            for s in np.split(order, bounds)}


def _rows_for_mentions(mkeys: np.ndarray, pair_key: np.ndarray) -> np.ndarray:
    """Map pair_key's (ci, mi)/(cj, mj) columns to mention rows — the
    positions of the encoded (cap << 32 | mention) keys in the ascending
    ``mkeys`` — int32[P, 2].

    Vectorized over the image's pairs via searchsorted; a pair referencing
    a nonexistent mention raises KeyError((ci, mi)) like the dict lookup
    it replaces."""
    pk = pair_key.astype(np.int64)
    pair_ij = np.empty((len(pk), 2), np.int32)
    for col in (0, 1):
        enc = (pk[:, 2 * col] << 32) | pk[:, 2 * col + 1]
        # side='right' - 1: the LAST row of an equal run, matching the
        # dict-comprehension (last-wins) lookup this replaces in the
        # pathological duplicate-mention-key case
        pos = np.searchsorted(mkeys, enc, side="right") - 1
        ok = (pos >= 0) & (mkeys[np.maximum(pos, 0)] == enc)
        if not ok.all():
            b = int(np.flatnonzero(~ok)[0])
            raise KeyError((int(pk[b, 2 * col]), int(pk[b, 2 * col + 1])))
        pair_ij[:, col] = pos
    return pair_ij


def load_relation_dataset(
    data_dir: str, split: str, emb: EmbeddingStore,
) -> RelationDataset:
    """Build image-centric tables from <split>.relation.feats + captions.

    Scale posture (VERDICT r2 missing#2): the `.feats` read is labels-only
    (no sparse-column materialization), pair rows are grouped per image as
    int32 tables (20 bytes/pair), and pair-id strings are never stored —
    ``RelationImage.pair_ids`` derives them on demand.  When the native
    library is available the parse+group runs entirely in C++/numpy
    (``_fast_grouped_rows``); dataset equality between the two paths is
    tested (tests/test_torch_native.py)."""
    feats_path = split_path(data_dir, split, "relation.feats")
    grouped = _fast_grouped_rows(feats_path, "pair")
    if grouped is None:
        grouped = _python_grouped_pair_rows(feats_path)
    cap_ids = _load_caption_ids(
        split_path(data_dir, split, "captions.txt"), emb)
    cols = read_mention_columns(split_path(data_dir, split, "mentions.txt"))
    mention_rows = _mention_groups(cols)

    images: list[RelationImage] = []
    for img_id, pair_key, pair_label, overrides in grouped:
        sl = mention_rows.get(img_id)
        if sl is None:
            raise ValueError(f"no mentions for image {img_id} with relation pairs")
        cap, men = cols.cap_idx[sl], cols.mention_idx[sl]
        ucaps = np.unique(cap)
        tokens, tok_len = _pad_id_rows(
            [cap_ids.ids(img_id, int(ci)) for ci in ucaps])
        m_cap = np.searchsorted(ucaps, cap).astype(np.int32)
        lim = tok_len[m_cap] - 1
        m_first = np.minimum(cols.first[sl], lim).astype(np.int32)
        m_last = np.minimum(cols.last[sl], lim).astype(np.int32)
        mkeys = (cap.astype(np.int64) << 32) | men
        pair_ij = _rows_for_mentions(mkeys, pair_key)
        images.append(RelationImage(
            img_id=img_id, tokens=tokens, tok_len=tok_len, m_cap=m_cap,
            m_first=m_first, m_last=m_last, pair_ij=pair_ij,
            pair_label=pair_label, pair_key=pair_key,
            pair_id_overrides=overrides))
    return RelationDataset(images=images)


# ---------------------------------------------------------------------------
# Affinity dataset (image-centric mention × box grids)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AffinityImage:
    img_id: str
    phrase_tokens: np.ndarray  # int32[M, L]
    phrase_len: np.ndarray     # int32[M]
    mention_ids: list[str]     # §6.1 mention ids, row order
    box_feats: np.ndarray      # float32[B, D]
    box_idx: list[int]         # original box indices, row order
    grid_label: np.ndarray     # int32[M, B]
    grid_valid: np.ndarray     # bool[M, B] — cells present in the .feats file
    # rare non-canonical feats ids (zero-padded fields): (ci,mi,bi) → bytes
    cell_id_overrides: dict[tuple[int, int, int], str] | None = None

    def cell_id(self, ci: int, mi: int, bi: int) -> str:
        """§6.1 cell id for (caption, mention, box) — the file's exact
        bytes when the feats id was non-canonical (zero-padded fields)."""
        if self.cell_id_overrides:
            ov = self.cell_id_overrides.get((ci, mi, bi))
            if ov is not None:
                return ov
        return make_affinity_id(self.img_id, ci, mi, bi)


@dataclasses.dataclass
class AffinityDataset:
    images: list[AffinityImage]
    box_dim: int

    @property
    def num_cells(self) -> int:
        return sum(int(im.grid_valid.sum()) for im in self.images)


def _python_grouped_affinity_rows(path: str):
    """Pure-Python grouping for affinity cells — same structure as
    ``_fast_grouped_rows(path, "affinity")`` (overrides keyed by file-order
    position within the image)."""
    ids, flabels = read_feats_labels(path)
    cells: dict[str, array] = {}
    overrides_by_img: dict[str, dict[int, str]] = {}
    for eid, lbl in zip(ids, flabels):
        img, ci, mi, bi, padded = parse_affinity_id_padded(eid)
        rows = cells.get(img)
        if rows is None:
            rows = cells.setdefault(img, array("i"))
        if padded:
            overrides_by_img.setdefault(img, {})[len(rows) // 4] = eid
        rows.extend((ci, mi, bi, int(lbl)))
    del ids, flabels
    out = []
    for img_id in sorted(cells):
        rows = np.frombuffer(cells[img_id], dtype=np.int32).reshape(-1, 4)
        out.append((img_id, np.ascontiguousarray(rows[:, :3]),
                    np.ascontiguousarray(rows[:, 3]),
                    overrides_by_img.get(img_id)))
    return out


def load_affinity_dataset(
    data_dir: str, split: str, emb: EmbeddingStore, max_phrase_len: int = 16,
) -> AffinityDataset:
    """Labels-only `.feats` read + int-packed per-image cell buffers +
    mmap'd lazy box views — same scale posture as load_relation_dataset
    (incl. the C++ parse+group fast path, tests/test_torch_native.py)."""
    feats_path = split_path(data_dir, split, "affinity.feats")
    grouped = _fast_grouped_rows(feats_path, "affinity")
    if grouped is None:
        grouped = _python_grouped_affinity_rows(feats_path)
    cap_ids = _load_caption_ids(
        split_path(data_dir, split, "captions.txt"), emb)
    cols = read_mention_columns(split_path(data_dir, split, "mentions.txt"))
    mention_rows = _mention_groups(cols)
    # memory-mapped + lazy per-image views (SURVEY §4.3): feature bytes are
    # paged in only when a batch containing the image is actually assembled
    box_ids, box_arr = read_box_feats(
        split_path(data_dir, split, "boxes.npz"), mmap=True)
    boxes_by_img = group_boxes_by_image(box_ids, box_arr, lazy=True)

    images: list[AffinityImage] = []
    box_dim = box_arr.shape[1] if box_arr.size else 4096
    for img_id, cell_key, cell_label, pos_overrides in grouped:
        box_order, bfeats = boxes_by_img[img_id]
        # unique (ci, mi) in ascending order == sorted(set(...)) of tuples
        enc_m = (cell_key[:, 0].astype(np.int64) << 32) | cell_key[:, 1]
        uniq_m = np.unique(enc_m)
        mention_keys = [(int(e >> 32), int(e & 0xFFFFFFFF)) for e in uniq_m]
        M, B = len(mention_keys), len(box_order)
        rows_r = np.searchsorted(uniq_m, enc_m)
        # box index -> grid column (KeyError parity with the dict lookup)
        bo = np.asarray(box_order, dtype=np.int64)
        if len(bo) == 0:
            raise KeyError(int(cell_key[0, 2]))
        sb_order = np.argsort(bo, kind="stable")
        sb = bo[sb_order]
        # side='right'-1 lands on the LAST index of an equal run: with a
        # duplicated box id, the {b: c} dict this replaced was last-wins,
        # so the cell must map to the LATER file-order grid column — the
        # stable argsort preserves file order within the run (ADVICE r3)
        pos = np.searchsorted(sb, cell_key[:, 2], side="right") - 1
        pos_c = np.maximum(pos, 0)
        ok = (pos >= 0) & (sb[pos_c] == cell_key[:, 2])
        if not ok.all():
            b = int(np.flatnonzero(~ok)[0])
            raise KeyError(int(cell_key[b, 2]))
        bcols = sb_order[pos_c]
        sl = mention_rows.get(img_id)
        # resolve all M mention keys at once; side='right' - 1 keeps the
        # last file-order row of an equal run, matching the
        # {mention_id: m} dict (last-wins) it replaces
        mkeys = (np.empty(0, np.int64) if sl is None else
                 (cols.cap_idx[sl].astype(np.int64) << 32)
                 | cols.mention_idx[sl])
        pos_m = np.searchsorted(mkeys, uniq_m, side="right") - 1
        bad = (pos_m < 0) | (mkeys[np.maximum(pos_m, 0)] != uniq_m) \
            if len(mkeys) else np.ones(M, bool)
        if bad.any():
            ci, mi = mention_keys[int(np.flatnonzero(bad)[0])]
            raise KeyError(f"doc:{img_id};caption:{ci};mention:{mi}")
        gs = sl[pos_m]
        firsts, lasts = cols.first[gs], cols.last[gs]
        phrase_tokens = np.zeros((M, max_phrase_len), dtype=np.int32)
        phrase_len = np.zeros(M, dtype=np.int32)
        mention_ids = []
        for r, (ci, mi) in enumerate(mention_keys):
            seg = cap_ids.ids(img_id, ci)[int(firsts[r]):int(lasts[r]) + 1]
            n_tok = min(len(seg), max_phrase_len)
            phrase_tokens[r, :n_tok] = seg[:n_tok]
            phrase_len[r] = n_tok
            mention_ids.append(f"doc:{img_id};caption:{ci};mention:{mi}")
        grid_label = np.zeros((M, B), dtype=np.int32)
        grid_valid = np.zeros((M, B), dtype=bool)
        # duplicate cells keep the LAST file-order occurrence, matching the
        # row-by-row fill this replaces (unique on the reversed linear
        # index keeps each cell's final write)
        lin = rows_r.astype(np.int64) * B + bcols
        uniq_lin, first_rev = np.unique(lin[::-1], return_index=True)
        sel = len(lin) - 1 - first_rev
        grid_label.flat[uniq_lin] = cell_label[sel]
        grid_valid.flat[uniq_lin] = True
        cell_over = None
        if pos_overrides:
            cell_over = {(int(cell_key[p, 0]), int(cell_key[p, 1]),
                          int(cell_key[p, 2])): eid
                         for p, eid in pos_overrides.items()}
        images.append(AffinityImage(
            img_id=img_id, phrase_tokens=phrase_tokens, phrase_len=phrase_len,
            mention_ids=mention_ids, box_feats=bfeats, box_idx=box_order,
            grid_label=grid_label, grid_valid=grid_valid,
            cell_id_overrides=cell_over))
    return AffinityDataset(images=images, box_dim=box_dim)
