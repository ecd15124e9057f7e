"""Caption-token and mention-span loaders (component C3).

Reference parity: SURVEY.md §3.1 C3 / §6.1 id schemes.  The Java preprocessing
side emits tokenized captions keyed ``<imgid>.jpg#<capIdx>`` plus mention span
indices; this module defines the concrete on-disk contract (DECISION per
SURVEY.md §0 — the reference checkout was empty):

``captions.txt`` — one caption per line, tab between key and tokens::

    <imgid>.jpg#<capIdx>\tthe quick brown fox ...

``mentions.txt`` — one mention per line::

    doc:<imgid>.jpg;caption:<ci>;mention:<mi>\t<first_tok>,<last_tok>[\t<text>]

token indices are 0-based and inclusive on both ends (a one-token mention has
first == last).

The port's own copy of ``icl/io/captions.py``: ``icl_torch`` imports
nothing of the JAX package, and ``tests/test_torch_data.py`` holds the two
copies to the same outputs.  Rationale below is the original's; where it
names XLA or the TPU, read PyTorch and the GPU.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Caption:
    img_id: str           # e.g. "123.jpg"
    cap_idx: int
    tokens: list[str]

    @property
    def key(self) -> str:
        return f"{self.img_id}#{self.cap_idx}"


@dataclasses.dataclass
class Mention:
    img_id: str
    cap_idx: int
    mention_idx: int
    first: int            # inclusive 0-based token index
    last: int             # inclusive
    text: str = ""

    @property
    def mention_id(self) -> str:
        """§6.1 mention id scheme (nonvisual/cardinality tasks)."""
        return f"doc:{self.img_id};caption:{self.cap_idx};mention:{self.mention_idx}"

    @property
    def caption_key(self) -> str:
        return f"{self.img_id}#{self.cap_idx}"


# id grammar (kept as the reference spec; the parsers below implement it
# by hand — the regex + 3-5 group() calls cost 14 s of a 29 s 2.3M-pair
# MSCOCO-scale load, the manual parse ~4 s.  Strictness is identical
# except ASCII-only digits and no trailing-newline tolerance, both
# strictly narrower):
#   mention: doc:(?P<doc>[^;]+);caption:(\d+);mention:(\d+)$
#   pair:    doc:(?P<doc>[^;]+);caption_1:(\d+);mention_1:(\d+)
#            ;caption_2:(\d+);mention_2:(\d+)$


def parse_mention_id(example_id: str) -> tuple[str, int, int]:
    """``doc:<img>;caption:<ci>;mention:<mi>`` → (img, ci, mi)."""
    img, ci, mi, _ = parse_mention_id_padded(example_id)
    return img, ci, mi


def parse_mention_id_padded(example_id: str) -> tuple[str, int, int, bool]:
    """Like :func:`parse_mention_id` plus a zero-padded-field flag (a
    field like ':07' — such ids don't round-trip through re-serialization
    and need the exact-bytes override path, icl.data.pipeline)."""
    if example_id.startswith("doc:"):
        doc, s1, rest = example_id[4:].partition(";caption:")
        ci, s2, mi = rest.partition(";mention:")
        if (s1 and s2 and doc and ";" not in doc
                and ci.isdigit() and mi.isdigit() and (ci + mi).isascii()):
            return (doc, int(ci), int(mi),
                    (ci != "0" and ci[0] == "0")
                    or (mi != "0" and mi[0] == "0"))
    raise ValueError(f"bad mention id: {example_id!r}")


def parse_pair_id(example_id: str) -> tuple[str, int, int, int, int]:
    """§6.1 relation pair id → (img, ci, mi, cj, mj)."""
    img, ci, mi, cj, mj, _ = parse_pair_id_padded(example_id)
    return img, ci, mi, cj, mj


def parse_pair_id_padded(
        example_id: str) -> tuple[str, int, int, int, int, bool]:
    """Like :func:`parse_pair_id` plus the zero-padded-field flag."""
    if example_id.startswith("doc:"):
        doc, s1, rest = example_id[4:].partition(";caption_1:")
        ci, s2, rest = rest.partition(";mention_1:")
        mi, s3, rest = rest.partition(";caption_2:")
        cj, s4, mj = rest.partition(";mention_2:")
        if (s1 and s2 and s3 and s4 and doc and ";" not in doc
                and ci.isdigit() and mi.isdigit() and cj.isdigit()
                and mj.isdigit() and (ci + mi + cj + mj).isascii()):
            return (doc, int(ci), int(mi), int(cj), int(mj),
                    (ci != "0" and ci[0] == "0")
                    or (mi != "0" and mi[0] == "0")
                    or (cj != "0" and cj[0] == "0")
                    or (mj != "0" and mj[0] == "0"))
    raise ValueError(f"bad pair id: {example_id!r}")


def make_pair_id(img_id: str, ci: int, mi: int, cj: int, mj: int) -> str:
    return (f"doc:{img_id};caption_1:{ci};mention_1:{mi}"
            f";caption_2:{cj};mention_2:{mj}")


def read_captions(path: str) -> dict[str, Caption]:
    """Load captions keyed by ``<imgid>.jpg#<capIdx>``."""
    out: dict[str, Caption] = {}
    with open(path, "r", encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            key, _, toks = line.partition("\t")
            img_id, sep, cap_idx = key.rpartition("#")
            if (not sep or not img_id
                    or not (cap_idx.isdigit() and cap_idx.isascii())):
                raise ValueError(
                    f"{path}:{ln}: bad caption key {key!r} "
                    f"(want '<imgid>.jpg#<capIdx>')")
            cap = Caption(img_id=img_id, cap_idx=int(cap_idx),
                          tokens=toks.split())
            out[cap.key] = cap
    return out


def read_mentions(path: str) -> list[Mention]:
    """Load mention spans; see module docstring for the line format."""
    out: list[Mention] = []
    with open(path, "r", encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            fields = line.split("\t")
            try:
                img_id, ci, mi = parse_mention_id(fields[0])
                first_s, _, last_s = fields[1].partition(",")
                first, last = int(first_s), int(last_s)
                if not 0 <= first <= last:
                    raise ValueError(
                        f"span must satisfy 0 <= first <= last, got "
                        f"{first},{last}")
                mention = Mention(img_id=img_id, cap_idx=ci, mention_idx=mi,
                                  first=first, last=last,
                                  text=fields[2] if len(fields) > 2 else "")
            except (IndexError, ValueError) as e:
                raise ValueError(
                    f"{path}:{ln}: bad mention line {line!r} "
                    f"(want '<mention_id>\\t<first>,<last>[\\t<text>]'): "
                    f"{e}") from None
            out.append(mention)
    return out


@dataclasses.dataclass
class MentionColumns:
    """Columnar mentions.txt: the MSCOCO-scale form the dataset loaders
    consume (no per-mention Python objects).  ``docs`` is the unique image
    ids in first-appearance order; the int32 columns are parallel."""

    docs: list[str]
    doc_idx: "np.ndarray"     # int32[N] index into docs
    cap_idx: "np.ndarray"     # int32[N]
    mention_idx: "np.ndarray" # int32[N]
    first: "np.ndarray"       # int32[N] inclusive token span
    last: "np.ndarray"        # int32[N]


def read_mention_columns(path: str, use_native: bool = True) -> MentionColumns:
    """Columnar :func:`read_mentions` — C++ single-pass parse when
    available (icl_torch/native/icl_native.cpp mentions_parse), else built
    from the Python reader.  The native path falls back WHOLE-FILE on any
    line its strict grammar cannot prove equivalent, so error behavior
    always matches read_mentions (equality tested in
    tests/test_torch_native.py)."""
    import numpy as np

    if use_native:
        from icl_torch.native import mentions as _nat

        cols = _nat.parse_mentions(path)
        if cols is not None:
            return MentionColumns(*cols)
    ms = read_mentions(path)
    n = len(ms)
    docs: list[str] = []
    dmap: dict[str, int] = {}
    cols = [np.empty(n, np.int32) for _ in range(5)]
    doc_idx, cap, men, first, last = cols
    for i, m in enumerate(ms):
        j = dmap.get(m.img_id)
        if j is None:
            j = dmap.setdefault(m.img_id, len(docs))
            docs.append(m.img_id)
        doc_idx[i], cap[i], men[i] = j, m.cap_idx, m.mention_idx
        first[i], last[i] = m.first, m.last
    return MentionColumns(docs, doc_idx, cap, men, first, last)


def write_captions(path: str, captions: list[Caption]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for c in captions:
            if any("\t" in t or "\n" in t for t in c.tokens):
                raise ValueError(
                    f"caption {c.key}: tokens may not contain tab/newline")
            f.write(f"{c.key}\t{' '.join(c.tokens)}\n")


def write_mentions(path: str, mentions: list[Mention]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for m in mentions:
            if "\t" in m.text or "\n" in m.text:
                # the format is tab-separated, one record per line — embedded
                # separators would silently truncate/split on read-back
                raise ValueError(
                    f"mention {m.mention_id}: text may not contain "
                    f"tab/newline")
            text = f"\t{m.text}" if m.text else ""
            f.write(f"{m.mention_id}\t{m.first},{m.last}{text}\n")
