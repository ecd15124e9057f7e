"""icl-torch-import — rebuild a loadable model dir from an export ``.npz``
(counterpart of ``icl/cli/import_.py``).

Takes the flat ``.npz`` (+ its ``.manifest.json`` sidecar) that
``icl-torch-export`` or the JAX package's ``icl-export`` wrote and writes a
fresh model directory that ``--predict``, ``--resume auto`` and
``icl-torch-serve`` load exactly like one produced by ``--train``:

* the leaves become the model's ``state_dict`` (``a/b`` keys -> ``a.b``),
  bytes unchanged;
* a fresh Adam state goes beside them (no moments yet, as before the first
  step; resumed TRAINING from an import restarts the moments, which the
  import logs), with the learning rate of the manifest's ``train_config``;
* ``--seed`` is the run seed a resumed run draws its dropout masks from;
* the manifest's ``model_config`` / ``train_config`` are written back as
  ``model_config.json`` / ``train_config.json``, so predict picks up the
  widths without flags.

Checks before anything is written: the keys form a tree (no key is a
prefix of another, no empty component); with a manifest, its ``params``
section lists exactly the archive's leaves with their shapes and dtypes;
and when the task is known (``--task``, the manifest's ``model_config``, or
leaves only one task's model has) the keys, shapes and dtypes are held against
:data:`icl_torch.params.PARAM_SHAPES`.  ``--validate_only`` runs these
checks and writes nothing; without a manifest it says that only the
structure was checked.  The model dir must be fresh: one that holds
checkpoints or config files already is refused.

Round trip: train -> export -> import -> predict gives a ``.scores`` file
byte-identical to predicting from the original model dir.

Usage::

    icl-torch-import --npz rel_weights.npz --model_file runs/rel_imported
        [--step N] [--seed S] [--task relation] [--validate_only]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from icl_torch.params import MENTION_NUM_CLASSES, PARAM_SHAPES
from icl_torch.train.checkpoint import Checkpointer
from icl_torch.util.log import LOG

_CONFIGS = ("model_config", "train_config")


def check_key_tree(keys) -> None:
    """Raise unless ``keys`` are the leaf paths of one tree: every
    component non-empty, and no key a proper prefix of another."""
    keys = sorted(keys)
    for key in keys:
        if not key or any(not part for part in key.split("/")):
            raise ValueError(f"key {key!r} has an empty path component — "
                             f"the archive's keys do not form a tree")
    for a, b in zip(keys, keys[1:]):
        if b.startswith(a + "/"):
            raise ValueError(
                f"key {b!r} nests under {a!r}, which is already a parameter "
                f"leaf — the archive's keys do not form a tree")


def infer_task(flat: dict[str, np.ndarray]) -> str | None:
    """The task whose model has this key set, where the leaves tell: the
    two mention tasks share their keys and are told apart by the head's
    width (2 classes or 12)."""
    if any(k.startswith("caption_bilstm/") for k in flat):
        return "relation"
    if "head_dense_box/kernel" in flat:
        return "affinity"
    head = flat.get("dense_out/kernel")
    if head is not None and head.ndim == 2:
        return {n: t for t, n in MENTION_NUM_CLASSES.items()}.get(
            int(head.shape[1]))
    return None


def _dims_of(task: str, flat: dict[str, np.ndarray]) -> dict:
    """The widths ``flat``'s arrays imply for ``task``'s model (the class
    count is the task's own); a missing or non-matrix leaf gives width 0
    (the key check names it)."""
    def dim(key, axis):
        a = flat.get(key)
        return int(a.shape[axis]) if a is not None and a.ndim == 2 else 0

    if task == "relation":
        return {"emb_dim": dim("caption_bilstm/fwd/kernel", 0),
                "lstm_hidden": dim("caption_bilstm/fwd/recurrent_kernel", 0),
                "head_hidden": dim("head_dense/kernel", 1)}
    if task == "affinity":
        lstm = "phrase_lstm/kernel" in flat
        return {"phrase_enc": "lstm" if lstm else "mean_w2v",
                "emb_dim": dim("phrase_lstm/kernel" if lstm
                               else "head_dense_phrase/kernel", 0),
                "lstm_hidden": dim("phrase_lstm/recurrent_kernel", 0),
                "head_hidden": dim("head_dense_phrase/kernel", 1),
                "box_dim": dim("head_dense_box/kernel", 0)}
    return {"emb_dim": dim("dense_1/kernel", 0),
            "hidden": dim("dense_1/kernel", 1)}


def check_param_shapes(task: str, flat: dict[str, np.ndarray]) -> None:
    """Hold an archive's leaves against ``task``'s pinned keys and shapes
    (at the widths the leaves themselves imply) and f32."""
    want = PARAM_SHAPES[task](_dims_of(task, flat))
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"not a {task} archive: missing {missing}, "
                         f"unknown {extra}")
    for k, shape in want.items():
        if tuple(flat[k].shape) != tuple(shape) or \
                flat[k].dtype != np.float32:
            raise ValueError(
                f"{k}: archive has {flat[k].dtype}{list(flat[k].shape)}, a "
                f"{task} model of these widths has float32{list(shape)}")


def _check_manifest(npz: str, manifest: dict,
                    flat: dict[str, np.ndarray]) -> None:
    """The manifest is the export's self-description: a mismatch means the
    archive was edited inconsistently."""
    want = manifest.get("params")
    if not isinstance(want, dict) or not want:
        raise ValueError(
            f"{npz}.manifest.json has no 'params' section — it is not an "
            f"export manifest; regenerate it, or remove it to import the "
            f"archive as it is")
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(
            f"archive does not match its manifest (missing {missing}, "
            f"unlisted {extra}) — regenerate the manifest or remove it "
            f"to import as-is")
    for k, spec in want.items():
        got = flat[k]
        if list(got.shape) != spec["shape"] or str(got.dtype) != \
                spec["dtype"]:
            raise ValueError(
                f"{k}: archive has {got.dtype}{list(got.shape)}, "
                f"manifest says {spec['dtype']}{spec['shape']}")


def _occupied(model_dir: str) -> list[str]:
    """What a model dir already holds of a model: checkpoints, config
    files, weights archives."""
    if not os.path.isdir(model_dir):
        return []
    return sorted(n for n in os.listdir(model_dir)
                  if (n.startswith("step_") and n.endswith(".pt"))
                  or n in tuple(c + ".json" for c in _CONFIGS)
                  or n.endswith(".npz"))


def import_checkpoint(npz: str, model_dir: str | None,
                      step: int | None = None, seed: int = 0,
                      validate_only: bool = False,
                      task: str | None = None) -> int:
    """Write ``model_dir`` as a restorable checkpoint; returns the step.

    With ``validate_only`` the checks run (module docstring) and nothing is
    written.
    """
    manifest = None
    man_path = npz + ".manifest.json"
    if os.path.exists(man_path):
        with open(man_path, encoding="utf-8") as f:
            manifest = json.load(f)
    elif not validate_only:
        LOG.warning("no manifest sidecar at %s — importing as step %s with "
                    "no model_config.json (predict will need explicit "
                    "dimension flags)", man_path,
                    step if step is not None else 0)

    with np.load(npz) as z:
        flat = {k: np.asarray(z[k]) for k in z.files}
    if not flat:
        raise ValueError(f"{npz} contains no arrays")
    check_key_tree(flat)
    if manifest is not None:
        _check_manifest(npz, manifest, flat)
    named = task or (manifest or {}).get("model_config", {}).get("task")
    task = named or infer_task(flat)
    if task is not None:
        if task not in PARAM_SHAPES:
            raise ValueError(f"unknown task {task!r}; known: "
                             f"{sorted(PARAM_SHAPES)}")
        check_param_shapes(task, flat)

    if step is None:
        step = int(manifest.get("step", 0)) if manifest else 0
    total = f"{sum(v.size for v in flat.values()):,}"
    if validate_only:
        held = (f"keys and shapes held against the {task} model's"
                if task else "task not identified (pass --task): keys not "
                "held against a model's")
        if manifest is not None:
            LOG.info("validate: %s OK — %d tensors / %s parameters, step "
                     "%d, manifest consistent; %s", npz, len(flat), total,
                     step, held)
        else:
            LOG.warning("validate: %s has NO manifest — structure only "
                        "was checked (%d tensors / %s parameters form a "
                        "tree; shapes and dtypes have nothing to be held "
                        "against but the model's); %s", npz, len(flat),
                        total, held)
        return step
    if model_dir is None:
        raise ValueError("model_dir is required unless validate_only")
    model_dir = os.path.abspath(model_dir)
    held = _occupied(model_dir)
    if held:
        raise ValueError(f"{model_dir} already holds {held} — import into "
                         f"a fresh directory")

    # the payload Checkpointer.save writes: the model's state_dict and a
    # fresh Adam's (made from stand-in parameters, so its format is this
    # torch version's; no moments yet, as before the first step)
    train_config = (manifest or {}).get("train_config") or {}
    lr = float(train_config.get("learn_rate", 1e-3))
    model = {k.replace("/", "."): torch.from_numpy(v)
             for k, v in flat.items()}
    stand_ins = [torch.nn.Parameter(torch.empty(0)) for _ in model]
    optimizer = torch.optim.Adam(stand_ins, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8).state_dict()
    Checkpointer(model_dir).save_payload(step, {
        "model": model, "optimizer": optimizer, "step": int(step),
        "seed": int(seed), "epoch": 0, "batch_in_epoch": 0})

    wrote_cfg = []
    for name in _CONFIGS:
        if manifest and name in manifest:
            with open(os.path.join(model_dir, name + ".json"), "w") as f:
                json.dump(manifest[name], f)
            wrote_cfg.append(name + ".json")
    LOG.info("imported %d tensors as step %d -> %s (%s; seed %d; optimizer "
             "state is fresh — resumed training restarts Adam moments)",
             len(flat), step, model_dir,
             ", ".join(wrote_cfg) if wrote_cfg else "no configs in manifest",
             seed)
    return step


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="icl-torch-import", allow_abbrev=False,
        description="Rebuild a predict/serve-loadable model directory from "
                    "an icl-torch-export or icl-export .npz (+ "
                    ".manifest.json)")
    p.add_argument("--npz", required=True, help="export archive")
    p.add_argument("--model_file", default=None,
                   help="output checkpoint directory (must be fresh)")
    p.add_argument("--step", type=int, default=None,
                   help="step number to import as (default: manifest step)")
    p.add_argument("--seed", type=int, default=0,
                   help="run seed stored in the checkpoint: a run resumed "
                        "from it draws its dropout masks from this seed")
    p.add_argument("--task", default=None, choices=sorted(PARAM_SHAPES),
                   help="hold the archive against this task's keys and "
                        "shapes (default: the manifest's task, else what "
                        "the key set identifies)")
    p.add_argument("--validate_only", action="store_true",
                   help="check the archive (and its manifest), write "
                        "nothing")
    args = p.parse_args(argv)
    if not args.validate_only and args.model_file is None:
        p.error("--model_file is required unless --validate_only")
    import_checkpoint(args.npz, args.model_file, args.step, seed=args.seed,
                      validate_only=args.validate_only, task=args.task)


if __name__ == "__main__":
    main()
