"""icl-torch-serve — HTTP scoring of the four tasks on PyTorch
(counterpart of icl/serve.py).

Loads the word vectors once and each task's weights, then scores JSON
requests with the same padding buckets, class orders and response formats
as ``icl-serve``.  A task's weights come from its model dir
``<data_dir>/<task>.model/`` as the port's ``--train`` (or
``icl-torch-import``) writes it, the newest ``step_<n>.pt`` with its
``model_config.json``; else from ``<data_dir>/<task>.npz`` (+
``.manifest.json``, whose ``model_config`` gives the widths; write one with
``icl-torch-export`` or ``icl-export``).  A task with neither is skipped;
the server refuses to start when no task has weights.  It scores on the GPU
(``cuda``), where the image models run their fused forms through the
hand-written grid-head and LSTM-recurrence kernels, and refuses to start
when there is none; ``--device cpu`` (``device="cpu"`` in :class:`Scorer`
and :func:`serve`) asks for the CPU, where they run their plain forms.  The
mention tasks run no hand-written kernel on either.

Endpoints (JSON in/out):

    GET  /healthz          -> {"status", "tasks", "coalescer", "latency_ms"}
    POST /score/nonvisual  {"mentions": [{"id", "tokens": [...]}]}
                           -> {"class_order", "scores": [{"id", "probs"}]}
    POST /score/cardinality  same shape as nonvisual
    POST /score/relation   {"images": [{"id", "captions": [[tok]],
                             "mentions": [{"caption", "first", "last"}],
                             "pairs": [[i, j], ...]}]}
    POST /score/affinity   {"images": [{"id", "phrases": [[tok]],
                             "boxes": [[f32 x D]]}]}
                           -> {"class_order", "images": [{"id", "grid":
                             [phrase][box] probs}]}

Usage::

    python -m icl_torch.serve --data_dir D [--port 8414]
        [--tasks nonvisual,cardinality,relation,affinity]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from icl_torch.cli._common import note_compilation_cache_dir
from icl_torch.data.buckets import BucketSpec
from icl_torch.data.embeddings import EmbeddingStore
from icl_torch.util.log import LOG
from icl_torch.models.affinity import AFFINITY_CLASSES, AffinityModel
from icl_torch.models.cardinality import CARDINALITY_CLASSES, CardinalityModel
from icl_torch.models.nonvisual import NONVIS_CLASSES, NonvisualModel
from icl_torch.models.relation import RELATION_CLASSES, RelationModel
from icl_torch.params import load_npz
from icl_torch.train.checkpoint import Checkpointer
from icl_torch.train.steps import (affinity_predict, mention_predict,
                                   relation_predict)

_LEN_SPEC = BucketSpec((8, 16, 32, 48))
_CNT_SPEC = BucketSpec((4, 8, 16, 32))
_IMG_SPEC = BucketSpec((1, 2, 4, 8))   # images per predict call (batched)

TASKS = ("nonvisual", "cardinality", "relation", "affinity")
MENTION_TASKS = {"nonvisual": (NonvisualModel, NONVIS_CLASSES),
                 "cardinality": (CardinalityModel, CARDINALITY_CLASSES)}

# startup warm-up inventory: the shapes a typical Flickr30k-style client
# hits first, mentions (count, L), relation (I, C, L, M) and affinity
# (I, M, B, L).  C follows the _CNT_SPEC bucketing _prep_relation_image
# applies (5 captions -> bucket 8).  On CUDA the first call also builds the
# kernels and lets cuBLAS pick its algorithms.
_WARMUP_BASIC = {"mentions": [(8, 16)],
                 "relation": [(1, 8, 16, 8), (4, 8, 16, 8)],
                 "affinity": [(1, 8, 8, 16), (4, 8, 8, 16)]}


class ServerOverloaded(Exception):
    """Coalescer queue full; the HTTP layer maps this to 503 + Retry-After."""


class _Coalescer:
    """Cross-request micro-batcher.

    ``ThreadingHTTPServer`` runs one thread per request.  Request threads
    submit per-image work items; a collector thread drains the queue after
    a short accumulation window and scores same-(task, shape) items in
    shared batched device calls.  The pending queue is bounded
    (``max_pending`` image items): a submit that would overflow it raises
    :class:`ServerOverloaded` without enqueuing anything.  When a batched
    group fails, each item is retried alone, so a bad payload fails only
    its own request.
    """

    def __init__(self, run_group, window_s: float = 0.002,
                 max_pending: int = 256):
        self._run_group = run_group   # (task, key, [arrays]) -> [row result]
        self.window = max(window_s, 0.0)
        self.max_pending = max_pending
        self._lock = threading.Lock()
        self._pending: list = []
        self._wakeup = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="icl-torch-serve-coalescer")
        self._thread.start()

    def submit_many(self, task: str, items: list[tuple]) -> list:
        """Submit [(shape_key, arrays)] work; block until all rows scored.

        All-or-nothing admission: a request whose items do not fit in the
        bounded queue is rejected whole (ServerOverloaded -> HTTP 503)."""
        entries = [{"task": task, "key": key, "arrays": arrays,
                    "done": threading.Event(), "result": None, "error": None}
                   for key, arrays in items]
        with self._lock:
            if len(self._pending) + len(entries) > self.max_pending:
                raise ServerOverloaded(
                    f"scoring queue full ({len(self._pending)} pending, "
                    f"limit {self.max_pending} items) — retry later")
            self._pending.extend(entries)
            self._wakeup.set()
        for e in entries:
            e["done"].wait()
            if e["error"] is not None:
                raise e["error"]
        return [e["result"] for e in entries]

    def _loop(self):
        while True:
            self._wakeup.wait()
            if self.window:
                time.sleep(self.window)   # let concurrent requests pile up
            with self._lock:
                batch, self._pending = self._pending, []
                self._wakeup.clear()
            try:
                self._run_batch(batch)
            except BaseException as exc:   # noqa: BLE001 — see below
                # the collector is the only drain: if this thread died,
                # every in-flight and future request would hang in
                # submit_many.  Fail the batch and keep the thread alive.
                for e in batch:
                    if e["result"] is None and e["error"] is None:
                        e["error"] = exc
                    e["done"].set()

    def _run_batch(self, batch):
        groups: dict[tuple, list] = {}
        for e in batch:
            groups.setdefault((e["task"], e["key"]), []).append(e)
        for (task, key), entries in groups.items():
            try:
                rows = self._run_group(task, key,
                                       [e["arrays"] for e in entries])
                for e, r in zip(entries, rows):
                    e["result"] = r
            except Exception as exc:
                if len(entries) == 1:
                    entries[0]["error"] = exc
                else:
                    # isolate the culprit: rescore each item alone
                    for e in entries:
                        try:
                            e["result"] = self._run_group(
                                task, key, [e["arrays"]])[0]
                        except Exception as exc1:
                            e["error"] = exc1
            finally:
                for e in entries:
                    e["done"].set()


class Scorer:
    """Loads the word vectors and the task weights; scores payloads.

    ``device``: where to score, ``cuda`` unless the caller names another; it
    never falls to the CPU by itself, so with no GPU and no ``device="cpu"``
    the constructor raises.  ``tasks``: the tasks to load (default all of
    :data:`TASKS`); a task with neither a checkpoint under
    ``<data_dir>/<task>.model/`` nor ``<data_dir>/<task>.npz`` is skipped,
    and none found raises.  ``batch_window_ms``: cross-request micro-batching window
    (see _Coalescer); negative disables coalescing (inline per-request
    scoring).
    """

    def __init__(self, data_dir: str, embeddings_file: str | None = None,
                 device: torch.device | str | None = None,
                 batch_window_ms: float = 2.0, max_pending: int = 256,
                 tasks: list[str] | None = None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "icl_torch.serve: no CUDA device is available; scoring runs "
                "on the GPU unless the CPU is asked for (--device cpu, or "
                "device=\"cpu\")")
        emb_path = embeddings_file or os.path.join(data_dir, "embeddings.txt")
        self.emb = EmbeddingStore.load(emb_path)
        self.table = torch.from_numpy(self.emb.table).to(self.device)
        # lifetime counters for /healthz: items/device_calls is the
        # effective batching ratio of the grouped image tasks.  Mention
        # requests dispatch directly (one call per request, batched within
        # it), so they get their own pair of counters.  Lock-guarded: with
        # coalescing off every request thread calls _run_group, and mention
        # requests always score on their own thread.
        self.stats = {"device_calls": 0, "items": 0,
                      "mention_calls": 0, "mention_items": 0}
        self._lat: dict[str, deque] = {}   # task -> last 2048 call ms
        self._lat_maxlen = 2048
        self._stats_lock = threading.Lock()
        self.coalescer = (None if batch_window_ms < 0 else
                          _Coalescer(self._run_group,
                                     window_s=batch_window_ms / 1000.0,
                                     max_pending=max_pending))
        self.tasks: dict[str, dict] = {}
        for task in tasks or TASKS:
            if task not in TASKS:
                raise ValueError(f"unknown task {task!r}; known: {TASKS}")
            found = _find_weights(data_dir, task)
            if found is None:
                continue
            flat, cfg, source = found
            self.tasks[task] = self._load_task(task, flat, cfg)
            LOG.info("serve: loaded %s from %s on %s", task, source,
                     self.device)
        if not self.tasks:
            raise FileNotFoundError(
                f"no <task>.model checkpoint and no <task>.npz weights "
                f"archive under {data_dir} (tasks: "
                f"{', '.join(tasks or TASKS)})")

    def _load_task(self, task: str, flat: dict, cfg: dict) -> dict:
        fused = self.device.type == "cuda"
        if task in MENTION_TASKS:
            cls, classes = MENTION_TASKS[task]
            # the hidden width is a property of the weights
            model = cls(emb_dim=self.emb.dim,
                        hidden=flat["dense_1/kernel"].shape[1],
                        num_classes=len(classes), device=self.device)
        elif task == "relation":
            model = RelationModel(emb_dim=self.emb.dim,
                                  lstm_hidden=cfg.get("lstm_hidden", 200),
                                  head_hidden=cfg.get("head_hidden", 800),
                                  num_classes=len(RELATION_CLASSES),
                                  fused=fused, device=self.device)
            classes = RELATION_CLASSES
        else:
            # the box width is a property of the weights (4096 for VGG fc7)
            box_dim = flat["head_dense_box/kernel"].shape[0]
            model = AffinityModel(emb_dim=self.emb.dim, box_dim=box_dim,
                                  lstm_hidden=cfg.get("lstm_hidden", 200),
                                  head_hidden=cfg.get("head_hidden", 1024),
                                  num_classes=len(AFFINITY_CLASSES),
                                  phrase_enc=cfg.get("phrase_enc", "lstm"),
                                  fused=fused, device=self.device)
            classes = AFFINITY_CLASSES
        model.load_flat(flat)
        model.eval()
        return {"classes": classes, "model": model}

    def warmup(self, level: str = "basic") -> int:
        """Run predict once per common bucket shape so first-request
        latency is steady-state; returns the number of shapes run.

        'basic' runs the _WARMUP_BASIC inventory, 'full' the whole bucket
        cross-product."""
        if level == "off":
            return 0
        inv = _WARMUP_BASIC
        if level == "full":
            inv = {"mentions": [(n, L) for n in _CNT_SPEC.boundaries
                                for L in _LEN_SPEC.boundaries],
                   "relation": [(I, _CNT_SPEC.bucket_of(5), L, M)
                                for I in (1, 4)
                                for L in _LEN_SPEC.boundaries
                                for M in _CNT_SPEC.boundaries],
                   "affinity": [(I, M, B, 8) for I in (1, 4)
                                for M in _CNT_SPEC.boundaries
                                for B in _CNT_SPEC.boundaries]}
        n = 0
        for task, t in self.tasks.items():
            for shape in inv["mentions" if task in MENTION_TASKS else task]:
                if task in MENTION_TASKS:
                    cnt, L = shape
                    mention_predict(
                        t["model"], self.table,
                        torch.zeros((cnt, L), dtype=torch.int32,
                                    device=self.device),
                        torch.ones(cnt, dtype=torch.int32,
                                   device=self.device))
                elif task == "relation":
                    relation_predict(t["model"], self.table,
                                     _empty_relation_batch(*shape,
                                                           self.device))
                else:
                    I, M, B, L = shape
                    affinity_predict(t["model"], self.table,
                                     _empty_affinity_batch(
                                         I, L, M, B,
                                         t["model"].dims["box_dim"],
                                         self.device))
                n += 1
        return n

    def score_mentions(self, task: str, payload: dict) -> dict:
        """One mention request, scored in one call on the request's own
        thread (already batched within itself, so it does not go through
        the coalescer)."""
        t = self.tasks[task]
        mentions = payload["mentions"]
        L = _LEN_SPEC.bucket_of(max((len(m["tokens"]) for m in mentions),
                                    default=1))
        n = len(mentions)
        rows = _CNT_SPEC.bucket_of(max(n, 1))
        tok = np.zeros((rows, L), np.int32)
        ln = np.zeros(rows, np.int32)
        for r, m in enumerate(mentions):
            tok[r], ln[r] = self.emb.encode_tokens(m["tokens"], L)
        with self._stats_lock:
            self.stats["mention_calls"] += 1
            self.stats["mention_items"] += n
        t0 = time.perf_counter()
        probs = mention_predict(
            t["model"], self.table, torch.from_numpy(tok).to(self.device),
            torch.from_numpy(ln).to(self.device)).cpu().numpy()
        self._record_latency(task, (time.perf_counter() - t0) * 1e3)
        return {
            "class_order": list(t["classes"]),
            "scores": [{"id": m.get("id", str(r)),
                        "probs": [round(float(p), 6) for p in probs[r]]}
                       for r, m in enumerate(mentions)],
        }

    def _prep_relation_image(self, img: dict):
        """One image -> (shape_key, host arrays without batch dim, pairs)."""
        captions = img["captions"]
        ments = img["mentions"]
        # an explicit empty pairs list means "score nothing"
        pairs = img.get("pairs")
        if pairs is None:
            pairs = [[i, j] for i in range(len(ments))
                     for j in range(i + 1, len(ments))]
        # every shape dim is bucketed, so clients cannot make the server
        # run an unbounded set of shapes; P doubles for long pair lists
        C = _CNT_SPEC.bucket_of(max(len(captions), 1))
        L = _LEN_SPEC.bucket_of(max((len(c) for c in captions), default=1))
        M = _CNT_SPEC.bucket_of(max(len(ments), 1))
        P = max(M * (M - 1) // 2, 1)
        while P < len(pairs):
            P *= 2
        tok = np.zeros((C, L), np.int32)
        tl = np.zeros(C, np.int32)
        for c, toks in enumerate(captions):
            tok[c], tl[c] = self.emb.encode_tokens(toks, L)
        mc = np.zeros(M, np.int32)
        mf = np.zeros(M, np.int32)
        ml = np.zeros(M, np.int32)
        mv = np.zeros(M, bool)
        for r, m in enumerate(ments):
            cap = int(m["caption"])
            if not 0 <= cap < len(captions):
                raise ValueError(f"mention caption {cap} out of range "
                                 f"for {len(captions)} captions")
            if int(m["first"]) < 0 or int(m["last"]) < int(m["first"]):
                raise ValueError(f"bad mention span "
                                 f"[{m['first']}, {m['last']}]")
            cap_len = max(int(tl[cap]), 1)
            mc[r] = cap
            mf[r] = min(int(m["first"]), cap_len - 1)
            ml[r] = min(int(m["last"]), cap_len - 1)
            mv[r] = True
        pij = np.zeros((P, 2), np.int32)
        pv = np.zeros(P, bool)
        for k, (i, j) in enumerate(pairs):
            if not (0 <= i < len(ments) and 0 <= j < len(ments)):
                raise ValueError(f"pair [{i}, {j}] out of range for "
                                 f"{len(ments)} mentions")
            pij[k] = (i, j)
            pv[k] = True
        arrays = {"tokens": tok, "tok_len": tl, "m_cap": mc, "m_first": mf,
                  "m_last": ml, "m_valid": mv, "pair_ij": pij,
                  "pair_label": np.zeros(P, np.int32), "pair_valid": pv}
        return (C, L, M, P), arrays, pairs

    def _prep_affinity_image(self, img: dict):
        """One image -> (shape_key, host arrays without batch dim,
        (phrases, boxes))."""
        phrases = img["phrases"]
        boxes = np.asarray(img["boxes"], np.float32)
        box_dim = self.tasks["affinity"]["model"].dims["box_dim"]
        if boxes.ndim != 2 or boxes.shape[1] != box_dim:
            raise ValueError(f"boxes must be [n, {box_dim}] floats, got "
                             f"shape {list(boxes.shape)}")
        M = _CNT_SPEC.bucket_of(max(len(phrases), 1))
        B = _CNT_SPEC.bucket_of(max(boxes.shape[0], 1))
        L = _LEN_SPEC.bucket_of(max((len(p) for p in phrases), default=1))
        pt = np.zeros((M, L), np.int32)
        pl = np.zeros(M, np.int32)
        for r, toks in enumerate(phrases):
            pt[r], pl[r] = self.emb.encode_tokens(toks, L)
        bf = np.zeros((B, box_dim), np.float32)
        bf[:boxes.shape[0]] = boxes
        arrays = {"phrase_tokens": pt, "phrase_len": pl, "box_feats": bf,
                  "box_valid": np.arange(B) < boxes.shape[0],
                  "grid_label": np.zeros((M, B), np.int32),
                  "grid_valid": np.ones((M, B), bool)}
        return (M, B, L, box_dim), arrays, (len(phrases), boxes.shape[0])

    def _stack_arrays(self, arrays_list: list) -> dict:
        """Pad same-shape per-image array dicts to an _IMG_SPEC batch on
        the scoring device."""
        I = _IMG_SPEC.bucket_of(len(arrays_list))
        batch = {k: np.zeros((I, *v.shape), v.dtype)
                 for k, v in arrays_list[0].items()}
        batch["img_valid"] = np.zeros(I, bool)
        for row, arrays in enumerate(arrays_list):
            for k, v in arrays.items():
                batch[k][row] = v
            batch["img_valid"][row] = True
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def _run_group(self, task: str, key: tuple, arrays_list: list) -> list:
        """Score same-shaped per-image work in batched predict calls."""
        del key  # shapes are identical within a group by construction
        model = self.tasks[task]["model"]
        cap = _IMG_SPEC.boundaries[-1]
        rows: list = []
        for s in range(0, len(arrays_list), cap):
            chunk = arrays_list[s:s + cap]
            with self._stats_lock:
                self.stats["device_calls"] += 1
                self.stats["items"] += len(chunk)
            t0 = time.perf_counter()
            predict = (relation_predict if task == "relation"
                       else affinity_predict)
            probs = predict(model, self.table,
                            self._stack_arrays(chunk)).cpu().numpy()
            self._record_latency(task, (time.perf_counter() - t0) * 1e3)
            rows.extend(probs[r] for r in range(len(chunk)))
        return rows

    def _record_latency(self, task: str, ms: float) -> None:
        with self._stats_lock:
            d = self._lat.get(task)
            if d is None:
                d = self._lat[task] = deque(maxlen=self._lat_maxlen)
            d.append(ms)

    def latency_summary(self) -> dict:
        """p50/p99/max (ms) per task over the retained window of predict
        calls, plus the lifetime counters."""
        with self._stats_lock:
            snap = {k: list(d) for k, d in self._lat.items()}
            calls = dict(self.stats)
        out = {}
        for task, xs in snap.items():
            xs.sort()
            n = len(xs)
            out[task] = {
                "window": n,
                "p50_ms": round(xs[n // 2], 2),
                "p99_ms": round(xs[min(n - 1, int(n * 0.99))], 2),
                "max_ms": round(xs[-1], 2),
            }
        return {"latency_ms": out, "counters": calls}

    def _score_images(self, task: str, prepped: list) -> list:
        """Per-image results via the coalescer, or inline grouped calls
        when coalescing is disabled."""
        if self.coalescer is not None:
            return self.coalescer.submit_many(
                task, [(key, arrays) for key, arrays, *_ in prepped])
        results: list = [None] * len(prepped)
        groups: dict[tuple, list[int]] = {}
        for idx, (key, _a, *_rest) in enumerate(prepped):
            groups.setdefault(key, []).append(idx)
        for key, idxs in groups.items():
            rows = self._run_group(task, key, [prepped[i][1] for i in idxs])
            for idx, r in zip(idxs, rows):
                results[idx] = r
        return results

    def score_relation(self, payload: dict) -> dict:
        t = self.tasks["relation"]
        prepped = [self._prep_relation_image(img)
                   for img in payload["images"]]
        results = self._score_images("relation", prepped)
        out = []
        for idx, img in enumerate(payload["images"]):
            pairs = prepped[idx][2]
            out.append({
                "id": img.get("id", ""),
                "pairs": [{"pair": [int(i), int(j)],
                           "probs": [round(float(p), 6)
                                     for p in results[idx][k]]}
                          for k, (i, j) in enumerate(pairs)],
            })
        return {"class_order": list(t["classes"]), "images": out}

    def score_affinity(self, payload: dict) -> dict:
        t = self.tasks["affinity"]
        prepped = [self._prep_affinity_image(img)
                   for img in payload["images"]]
        results = self._score_images("affinity", prepped)
        out = []
        for idx, img in enumerate(payload["images"]):
            n_phrases, n_boxes = prepped[idx][2]
            out.append({
                "id": img.get("id", ""),
                "grid": [[[round(float(x), 6) for x in results[idx][r, c]]
                          for c in range(n_boxes)]
                         for r in range(n_phrases)],
            })
        return {"class_order": list(t["classes"]), "images": out}


def _find_weights(data_dir: str, task: str):
    """A task's weights under ``data_dir`` -> (key -> CPU tensor,
    model_config, where they came from), or None.  The order is the CLIs'
    (:func:`icl_torch.cli._common.restore_for_predict`): the newest
    checkpoint of ``<task>.model/``, else ``<task>.npz``."""
    model_dir = os.path.join(data_dir, f"{task}.model")
    if os.path.isdir(model_dir):
        ckpt = Checkpointer(model_dir)
        if ckpt.latest_step is not None:
            flat, step = ckpt.load_weights()
            cfg_path = os.path.join(model_dir, "model_config.json")
            cfg = {}
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    cfg = json.load(f)
            return flat, cfg, os.path.join(model_dir, f"step_{step}.pt")
    path = os.path.join(data_dir, f"{task}.npz")
    if os.path.exists(path):
        flat, manifest = load_npz(path)
        return flat, manifest.get("model_config", {}), path
    return None


def _empty_relation_batch(I, C, L, M, device) -> dict:
    P = max(M * (M - 1) // 2, 1)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"tokens": z(I, C, L),
            "tok_len": torch.ones((I, C), dtype=torch.int32, device=device),
            "m_cap": z(I, M), "m_first": z(I, M), "m_last": z(I, M),
            "m_valid": z(I, M, dtype=torch.bool), "pair_ij": z(I, P, 2),
            "pair_label": z(I, P), "pair_valid": z(I, P, dtype=torch.bool),
            "img_valid": z(I, dtype=torch.bool)}


def _empty_affinity_batch(I, L, M, B, D, device) -> dict:
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"phrase_tokens": z(I, M, L),
            "phrase_len": torch.ones((I, M), dtype=torch.int32,
                                     device=device),
            "box_feats": z(I, B, D, dtype=torch.float32),
            "box_valid": z(I, B, dtype=torch.bool),
            "grid_label": z(I, M, B),
            "grid_valid": z(I, M, B, dtype=torch.bool),
            "img_valid": z(I, dtype=torch.bool)}


class _Handler(BaseHTTPRequestHandler):
    scorer: Scorer = None          # set by serve()
    max_body_bytes: int = 8 << 20  # 413 above this (set by serve())
    max_items: int = 64            # images/mentions per request (413 above)

    def log_message(self, fmt, *args):  # route through LogUtil
        LOG.debug("serve: " + fmt, *args)

    def _reply(self, code: int, obj: dict,
               headers: dict | None = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            summary = self.scorer.latency_summary()   # one lock snapshot
            self._reply(200, {"status": "ok",
                              "tasks": sorted(self.scorer.tasks),
                              "coalescer": summary["counters"],
                              "latency_ms": summary["latency_ms"]})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._reply(400, {"error": "bad Content-Length"})
            return
        if n > self.max_body_bytes:
            # reject without reading the body; the unread body poisons the
            # connection for keep-alive, so close it
            self.close_connection = True
            self._reply(413, {"error": f"request body {n} B exceeds the "
                                       f"{self.max_body_bytes} B limit"})
            return
        try:
            payload = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError as e:
            self._reply(400, {"error": f"bad json: {e}"})
            return
        if not isinstance(payload, dict):
            self._reply(400, {"error": "payload must be a JSON object"})
            return
        task = self.path.rsplit("/", 1)[-1]
        if not self.path.startswith("/score/") or task not in self.scorer.tasks:
            self._reply(404, {"error": f"unknown or unloaded task {task!r}",
                              "tasks": sorted(self.scorer.tasks)})
            return
        items = payload.get("mentions" if task in MENTION_TASKS
                            else "images")
        if isinstance(items, list) and len(items) > self.max_items:
            self._reply(413, {"error": f"{len(items)} items exceeds the "
                                       f"{self.max_items}-item request "
                                       f"limit — split the request"})
            return
        try:
            if task in MENTION_TASKS:
                out = self.scorer.score_mentions(task, payload)
            elif task == "relation":
                out = self.scorer.score_relation(payload)
            else:
                out = self.scorer.score_affinity(payload)
            self._reply(200, out)
        except ServerOverloaded as e:
            self._reply(503, {"error": str(e)}, headers={"Retry-After": "1"})
        except (KeyError, IndexError, ValueError, TypeError) as e:
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})


def serve(data_dir: str, port: int, embeddings_file: str | None = None,
          warmup: str = "basic", batch_window_ms: float = 2.0,
          max_body_mb: float = 8.0, max_items: int = 64,
          max_pending: int = 256,
          device: torch.device | str | None = None,
          tasks: list[str] | None = None) -> ThreadingHTTPServer:
    """Build the server (caller decides serve_forever vs background)."""
    # parity-grade scoring: full f32 matmuls, no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scorer = Scorer(data_dir, embeddings_file, device,
                    batch_window_ms=batch_window_ms, max_pending=max_pending,
                    tasks=tasks)
    t0 = time.perf_counter()
    n = scorer.warmup(warmup)
    if n:
        LOG.info("serve: warm-up ran %d predict shapes in %.1fs", n,
                 time.perf_counter() - t0)
    handler = type("Handler", (_Handler,), {
        "scorer": scorer,
        "max_body_bytes": int(max_body_mb * 2**20),
        "max_items": max_items})
    # a listen backlog of 256 covers the burst the pending queue is sized
    # for (http.server's default of 5 resets concurrent connects)
    server_cls = type("Server", (ThreadingHTTPServer,),
                      {"request_queue_size": 256})
    httpd = server_cls(("127.0.0.1", port), handler)
    LOG.info("serve: listening on 127.0.0.1:%d (tasks: %s)",
             httpd.server_port, ", ".join(sorted(scorer.tasks)))
    return httpd


def parse_args(argv=None) -> argparse.Namespace:
    """The server's flags; logs ``--compilation_cache_dir`` as the task
    CLIs do."""
    p = argparse.ArgumentParser(
        prog="icl-torch-serve",
        description="HTTP scoring of the four tasks on PyTorch (CUDA "
                    "kernels on a GPU) over the port's model dirs or "
                    "icl-export weights archives")
    p.add_argument("--data_dir", required=True,
                   help="directory with <task>.model/ (the port's "
                        "checkpoints) or <task>.npz (+ .manifest.json) per "
                        "task, and embeddings.txt")
    p.add_argument("--embeddings_file", default=None)
    p.add_argument("--port", type=int, default=8414)
    p.add_argument("--tasks", default=None,
                   help="comma-separated subset of nonvisual,cardinality,"
                        "relation,affinity (default: every task with "
                        "weights)")
    p.add_argument("--device", default="cuda",
                   help="where to score: cuda (the default; the server "
                        "refuses to start without a GPU), cuda:N, or cpu")
    p.add_argument("--warmup", default="basic",
                   choices=["off", "basic", "full"],
                   help="run predict at startup over the common bucket "
                        "shapes ('basic') or all of them ('full')")
    p.add_argument("--batch_window_ms", type=float, default=2.0,
                   help="cross-request micro-batching window: concurrent "
                        "same-shape image work coalesces into shared "
                        "device calls; negative disables coalescing")
    p.add_argument("--max_body_mb", type=float, default=8.0,
                   help="reject request bodies above this size with 413 "
                        "(without reading them)")
    p.add_argument("--max_items", type=int, default=64,
                   help="reject requests with more images or mentions than "
                        "this with 413")
    p.add_argument("--max_pending", type=int, default=256,
                   help="coalescer queue bound (image items); submits past "
                        "it get 503 + Retry-After")
    p.add_argument("--compilation_cache_dir", default=None,
                   help="accepted for the reference's command lines; "
                        "PyTorch runs eagerly, nothing is cached")
    args = p.parse_args(argv)
    note_compilation_cache_dir(args.compilation_cache_dir)
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    httpd = serve(args.data_dir, args.port, args.embeddings_file,
                  warmup=args.warmup, batch_window_ms=args.batch_window_ms,
                  max_body_mb=args.max_body_mb, max_items=args.max_items,
                  max_pending=args.max_pending, device=args.device,
                  tasks=args.tasks.split(",") if args.tasks else None)
    if threading.current_thread() is threading.main_thread():
        def _graceful(signum, frame):
            # stop accepting and drain instead of dying mid-response.
            # shutdown() must not run on this thread: it waits for
            # serve_forever, which cannot return while the handler holds
            # the main thread.
            LOG.info("serve: signal %d — shutting down", signum)
            threading.Thread(target=httpd.shutdown, daemon=True).start()

        signal.signal(signal.SIGTERM, _graceful)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()
    # drain: close the listen socket, then give queued and in-flight work a
    # bounded grace to finish before the daemon handler threads end with
    # the process
    httpd.server_close()
    co = httpd.RequestHandlerClass.scorer.coalescer
    deadline = time.monotonic() + 5.0
    while (co is not None and co._pending
           and time.monotonic() < deadline):
        time.sleep(0.05)
    time.sleep(0.2)
    LOG.info("serve: drained, exiting")


if __name__ == "__main__":
    main()
