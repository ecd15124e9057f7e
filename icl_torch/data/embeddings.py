"""Word2vec embedding store (component C4) — device-resident lookup table.

Reference parity: SURVEY.md §3.1 C4 — the reference loaded GoogleNews 300-d
word2vec via gensim ``KeyedVectors`` (C/Cython inside gensim) and mean-pooled
token spans per mention in Python.  TPU-native design (SURVEY §3.2 N2):

* the vocabulary lives on host as a dict; token→id happens once at data-prep;
* the embedding matrix is a single ``float32[V+1, D]`` device array with
  **row 0 reserved for PAD/OOV = zero vector** (DECISION: OOV words contribute
  a zero vector and still count in the mean-pool denominator, matching the
  additive-zero behavior of masked mean over padded ids);
* lookup is a row gather of the table on the device (``table[ids]``), and
  mean-pool is a masked matmul-free reduction.

File formats supported: word2vec *text* format (optional ``V D`` header line,
then ``word v1 ... vD``) and the GoogleNews *binary* ``.bin`` format (header
``V D\\n`` then per-word ``word<space><D float32 LE>``), auto-detected.
Binary parsing is pure numpy — IO is not a hot path (SURVEY §3.2 N2).

The port's own copy of ``icl/data/embeddings.py``: ``icl_torch`` imports
nothing of the JAX package, and ``tests/test_torch_data.py`` holds the two
copies to the same outputs.  Rationale below is the original's; where it
names XLA or the TPU, read PyTorch and the GPU.
"""

from __future__ import annotations

import numpy as np

PAD_ID = 0


class EmbeddingStore:
    """Vocabulary + float32[V+1, D] table; row 0 is PAD/OOV (zeros)."""

    def __init__(self, vocab: dict[str, int], table: np.ndarray):
        # vocab maps word -> row index >= 1; table[0] is the PAD/OOV row.
        self.vocab = vocab
        self.table = np.asarray(table, dtype=np.float32)
        assert self.table.ndim == 2 and len(vocab) + 1 == self.table.shape[0]

    @property
    def dim(self) -> int:
        return self.table.shape[1]

    # -- construction ----------------------------------------------------
    @classmethod
    def from_arrays(cls, words: list[str], vectors: np.ndarray) -> "EmbeddingStore":
        vectors = np.asarray(vectors, dtype=np.float32)
        table = np.zeros((len(words) + 1, vectors.shape[1]), dtype=np.float32)
        table[1:] = vectors
        vocab = {w: i + 1 for i, w in enumerate(words)}
        return cls(vocab, table)

    @classmethod
    def load(cls, path: str, restrict_to=None) -> "EmbeddingStore":
        """Load text or binary word2vec format, auto-detected.

        restrict_to: optional word collection — only matching entries are
        kept (plus their lowercase forms for the OOV fallback).  Value-
        preserving for any corpus whose words are all in ``restrict_to``,
        since the table is frozen and lookups are by word: the standard
        trick for GoogleNews-scale (3M × 300) tables.
        """
        if restrict_to is not None:
            restrict_to = set(restrict_to) | {w.lower() for w in restrict_to}
        with open(path, "rb") as f:
            head = f.read(1024)
        if path.endswith(".bin") or _looks_binary(head):
            from icl_torch.native.w2v import load_binary

            loaded = load_binary(path, restrict_to)
            if loaded is not None:
                return cls.from_arrays(*loaded)
            return cls._load_binary(path, restrict_to)
        return cls._load_text(path, restrict_to)

    def restrict(self, words) -> "EmbeddingStore":
        """Subset the store to the given words (order-preserving).

        Keeps the lowercase forms too — the same expansion
        ``load(restrict_to=...)`` applies — so the ``lookup_id`` OOV
        fallback (exact, then lowercase) survives restriction identically
        on both construction paths."""
        words = set(words)
        words |= {w.lower() for w in words}
        keep = [w for w in sorted(self.vocab, key=self.vocab.get)
                if w in words]
        rows = np.array([self.vocab[w] for w in keep], dtype=np.int64)
        return EmbeddingStore.from_arrays(keep, self.table[rows])

    @classmethod
    def _load_text(cls, path: str, restrict_to=None) -> "EmbeddingStore":
        # filter DURING parse: the full GoogleNews-scale table must never be
        # materialized on the fallback path (the native loader filters too)
        words: list[str] = []
        rows: list[np.ndarray] = []

        def take(parts):
            if len(parts) < 2:
                return
            if restrict_to is None or parts[0] in restrict_to:
                words.append(parts[0])
                rows.append(np.array(parts[1:], dtype=np.float32))

        with open(path, "r", encoding="utf-8", errors="replace") as f:
            first = f.readline().rstrip("\n")
            parts = first.split(" ")
            # optional "V D" header
            if len(parts) != 2 or not all(p.isdigit() for p in parts):
                take(parts)
            for line in f:
                take(line.rstrip("\n").split(" "))
        dim = rows[0].shape[0] if rows else 1
        return cls.from_arrays(words, np.stack(rows) if rows
                               else np.zeros((0, dim), np.float32))

    @classmethod
    def _load_binary(cls, path: str, restrict_to=None) -> "EmbeddingStore":
        """GoogleNews .bin: ascii header 'V D\\n', then word + D float32 LE.

        Streams record-by-record through a bounded window — a 3.4 GB
        GoogleNews file with restrict_to must never be materialized whole
        on this fallback path (r3 review finding; the native loader
        streams too).  Peak memory ≈ kept rows + the 1 MiB window."""
        words: list[str] = []
        rows: list[np.ndarray] = []
        with open(path, "rb") as f:
            header = f.readline().decode("utf-8").strip()
            v_str, d_str = header.split(" ")
            v, d = int(v_str), int(d_str)
            vec_bytes = d * 4
            buf = b""
            pos = 0
            for _ in range(v):
                end = buf.find(b" ", pos)
                while end < 0 or len(buf) - (end + 1) < vec_bytes:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    buf = buf[pos:] + chunk
                    pos = 0
                    end = buf.find(b" ", pos)
                if end < 0 or len(buf) - (end + 1) < vec_bytes:
                    break   # truncated file: keep what parsed
                word = buf[pos:end].decode("utf-8",
                                           errors="replace").lstrip("\n")
                pos = end + 1
                if restrict_to is None or word in restrict_to:
                    words.append(word)
                    rows.append(np.frombuffer(buf, dtype="<f4", count=d,
                                              offset=pos).copy())
                pos += vec_bytes
        return cls.from_arrays(words, np.stack(rows) if rows
                               else np.zeros((0, d), np.float32))

    def save_binary(self, path: str) -> None:
        with open(path, "wb") as f:
            words = sorted(self.vocab, key=self.vocab.get)
            f.write(f"{len(words)} {self.dim}\n".encode("utf-8"))
            for w in words:
                f.write(w.encode("utf-8") + b" ")
                f.write(self.table[self.vocab[w]].astype("<f4").tobytes())

    def words_by_row(self) -> list[str]:
        """Vocabulary words in table-row order (row 1 first) — the layout
        the native caption tokenizer consumes
        (icl_torch/native/captions.py)."""
        out = [""] * len(self.vocab)
        for w, r in self.vocab.items():
            out[r - 1] = w
        return out

    # -- tokenization ----------------------------------------------------
    def lookup_id(self, word: str) -> int:
        """word → table row; OOV path mirrors gensim-era normalization:
        exact match, then lowercase, else PAD_ID(0)."""
        wid = self.vocab.get(word)
        if wid is None:
            wid = self.vocab.get(word.lower(), PAD_ID)
        return wid

    def encode_tokens(self, tokens: list[str], max_len: int) -> tuple[np.ndarray, int]:
        """Tokens → (int32[max_len] padded ids, true length)."""
        ids = np.zeros(max_len, dtype=np.int32)
        n = min(len(tokens), max_len)
        for i in range(n):
            ids[i] = self.lookup_id(tokens[i])
        return ids, n

    def mean_pool(self, tokens: list[str]) -> np.ndarray:
        """Host-side mean of token vectors (OOV rows are zero but counted),
        mirroring the reference's averaged-w2v mention features [B:7]."""
        if not tokens:
            return np.zeros(self.dim, dtype=np.float32)
        ids = np.array([self.lookup_id(t) for t in tokens], dtype=np.int32)
        return self.table[ids].mean(axis=0)


# bytes that never occur in text-format w2v lines (UTF-8 words + ascii
# floats + space/tab/newline) but are near-certain within a few raw
# float32s: NUL..BS, VT, FF, SO..US  (\t=9, \n=10, \r=13 excluded)
_CTRL = frozenset(range(0, 9)) | {11, 12} | frozenset(range(14, 32))


def _looks_binary(head: bytes) -> bool:
    """Binary w2v starts with an ascii 'V D\\n' header then raw floats.

    The tail test is CONTROL bytes, not non-ascii: a text file whose first
    words are non-English ('über …') is perfectly valid UTF-8 >127, and
    treating it as binary silently loaded a garbage table (r3 review
    finding).  Raw float32 runs hit a control byte with overwhelming
    probability inside the 1 KiB probe; .bin files are caught by extension
    before this heuristic anyway (see load())."""
    try:
        nl = head.index(b"\n")
    except ValueError:
        return False
    try:
        parts = head[:nl].decode("ascii").split(" ")
    except UnicodeDecodeError:
        return True
    if len(parts) == 2 and all(p.isdigit() for p in parts):
        return any(b in _CTRL for b in head[nl + 1:])
    return False
