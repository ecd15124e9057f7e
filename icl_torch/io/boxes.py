"""VGG-16 fc7 box-feature loader (component C5).

Reference parity: SURVEY.md §3.1 C5 — the Java side exports precomputed
VGG-16 fc7 features (4096-d) per candidate bounding box per image; the Python
side only consumes them (the CNN itself is outside both repos' scope).

On-disk contract (DECISION, SURVEY.md §0):

* fast path — ``<split>.boxes.npz`` with arrays ``ids`` (unicode, box ids in
  the §6.1 scheme ``doc:<imgid>.jpg;box:<bi>``) and ``feats``
  (float32[N, 4096]);
* text path — one box per line: ``<box_id> v1 v2 ... v4096`` whitespace-
  separated (the Java-era export shape), auto-detected by extension.

Box ids group by image via the ``doc:`` prefix; :func:`group_boxes_by_image`
gives the per-image candidate sets the affinity model ranks over.

The port's own copy of ``icl/io/boxes.py``: ``icl_torch`` imports
nothing of the JAX package, and ``tests/test_torch_data.py`` holds the two
copies to the same outputs.  Rationale below is the original's; where it
names XLA or the TPU, read PyTorch and the GPU.
"""

from __future__ import annotations

import ast
import re
import struct
import zipfile

import numpy as np

_BOX_ID_RE = re.compile(r"doc:(?P<doc>[^;]+);box:(?P<box>\d+)$")

FC7_DIM = 4096


def _mmap_npz_member(path: str, name: str) -> np.memmap | None:
    """Memory-map one STORED (uncompressed) member of an .npz archive.

    numpy's ``np.load(mmap_mode=...)`` only maps bare ``.npy`` files — the
    zip container defeats it — but an uncompressed zip member is a
    contiguous byte range, so we locate the member's data offset, parse the
    npy header ourselves, and hand the tail to ``np.memmap``.  Returns None
    (caller falls back to an eager load) for compressed members, Fortran
    order, or any structural surprise.  This is the SURVEY §4.3
    "memory-mapped" box-feature path: MSCOCO-scale fc7 tables never
    materialize in RAM; only the rows each batch touches are paged in.
    """
    try:
        with zipfile.ZipFile(path) as z:
            info = z.getinfo(name)
            if info.compress_type != zipfile.ZIP_STORED:
                return None
        with open(path, "rb") as f:
            f.seek(info.header_offset)
            lh = f.read(30)
            if lh[:4] != b"PK\x03\x04":
                return None
            name_len, extra_len = struct.unpack("<HH", lh[26:30])
            data_off = info.header_offset + 30 + name_len + extra_len
            f.seek(data_off)
            if f.read(6) != b"\x93NUMPY":
                return None
            major = f.read(2)[0]
            if major == 1:
                (hlen,) = struct.unpack("<H", f.read(2))
                hdr_end = data_off + 10 + hlen
            else:
                (hlen,) = struct.unpack("<I", f.read(4))
                hdr_end = data_off + 12 + hlen
            header = ast.literal_eval(f.read(hlen).decode("latin1"))
            if header.get("fortran_order"):
                return None
            dt = np.dtype(header["descr"])
            shape = tuple(header["shape"])
            if dt != np.float32:
                # the eager path casts to f32; a pass-through f64 memmap
                # would silently vary dtype (and double page-in bytes)
                # with a performance flag — fall back and cast eagerly
                return None
            # the header's claimed extent must exactly fill the zip
            # member, else the memmap would silently read into the NEXT
            # member's bytes (truncated/hand-edited archives)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            if (hdr_end - data_off) + nbytes != info.file_size:
                return None
        return np.memmap(path, dtype=dt, mode="r",
                         offset=hdr_end, shape=shape)
    except (KeyError, ValueError, OSError, SyntaxError, struct.error,
            IndexError):
        # any structural surprise (incl. truncated members: short reads
        # raise struct.error/IndexError) falls back to eager np.load,
        # which reports real corruption clearly
        return None


class BoxRows:
    """Lazy row-subset view over a (possibly memory-mapped) feats table.

    Quacks enough like ``float32[B, D]`` for the batchers (shape/len/
    slicing); actual feature bytes are read only when a batch containing
    this image is assembled — so ``--resume auto`` skipping batches, or a
    split subset, never pages in the untouched rows.
    """

    def __init__(self, base: np.ndarray, rows) -> None:
        self.base = base
        self.rows = np.asarray(rows, dtype=np.int64)

    @property
    def shape(self) -> tuple[int, int]:
        return (int(self.rows.size), int(self.base.shape[1]))

    def __len__(self) -> int:
        return int(self.rows.size)

    def __getitem__(self, key):
        return np.asarray(self.base[self.rows[key]])

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self.base[self.rows])
        return out.astype(dtype) if dtype is not None else out


def parse_box_id(box_id: str) -> tuple[str, int]:
    m = _BOX_ID_RE.match(box_id)
    if not m:
        raise ValueError(f"bad box id: {box_id!r}")
    return m.group("doc"), int(m.group("box"))


def make_box_id(img_id: str, box_idx: int) -> str:
    return f"doc:{img_id};box:{box_idx}"


def read_box_feats(path: str,
                   mmap: bool = False) -> tuple[list[str], np.ndarray]:
    """Load (box_ids, float32[N, D]) from .npz (fast) or text format.

    ``mmap=True`` memory-maps the feats member of an uncompressed .npz
    (ids, tiny, load eagerly); falls back to the eager load when the
    archive is compressed (the pre-round-2 writer used savez_compressed).
    """
    if path.endswith(".npz"):
        if mmap:
            feats = _mmap_npz_member(path, "feats.npy")
            if feats is not None:
                with np.load(path) as z:
                    ids = [str(s) for s in z["ids"]]
                return ids, feats
        with np.load(path) as z:
            ids = [str(s) for s in z["ids"]]
            feats = np.asarray(z["feats"], dtype=np.float32)
        return ids, feats
    ids = []
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            first, _, rest = line.partition(" ")
            ids.append(first)
            rows.append(np.array(rest.split(), dtype=np.float32))
    return ids, np.stack(rows) if rows else np.zeros((0, FC7_DIM), np.float32)


def write_box_feats(path: str, ids: list[str], feats: np.ndarray) -> None:
    feats = np.asarray(feats, dtype=np.float32)
    if path.endswith(".npz"):
        # UNcompressed on purpose: fc7 activations barely compress, and a
        # STORED member is what makes the mmap read path possible
        with open(path, "wb") as f:
            np.savez(f, ids=np.array(ids), feats=feats)
        return
    with open(path, "w", encoding="utf-8") as f:
        for bid, row in zip(ids, feats):
            f.write(bid + " " + " ".join(f"{v:.6g}" for v in row) + "\n")


def group_boxes_by_image(ids: list[str], feats: np.ndarray,
                         lazy: bool = False) -> dict[str, tuple[list[int], np.ndarray]]:
    """Group to {img_id: (box_indices_in_image_order, float32[B, D])}.

    ``lazy=True`` returns :class:`BoxRows` views instead of row copies —
    pair it with ``read_box_feats(mmap=True)`` so grouping a huge table
    touches no feature bytes at all.
    """
    by_img: dict[str, list[tuple[int, int]]] = {}
    for row, bid in enumerate(ids):
        img, b = parse_box_id(bid)
        by_img.setdefault(img, []).append((b, row))
    out: dict[str, tuple[list[int], np.ndarray]] = {}
    for img, pairs in by_img.items():
        pairs.sort()
        box_idx = [b for b, _ in pairs]
        rows = [r for _, r in pairs]
        out[img] = (box_idx, BoxRows(feats, rows) if lazy else feats[rows])
    return out
