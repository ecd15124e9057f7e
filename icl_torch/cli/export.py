"""icl-torch-export — dump a checkpoint's weights to a portable ``.npz``
(counterpart of ``icl/cli/export.py``, same archive format).

The port's ``--train`` checkpoints the full train state as
``<model dir>/step_<n>.pt``.  This exports the parameters of the newest (or
a named) step as one flat ``numpy.savez`` archive:

* one entry per parameter leaf, keyed by its param-tree path with ``/``
  separators (``caption_bilstm/fwd/kernel``, ``dense_out/bias``, ...), in
  sorted key order: the pinned paths and layouts the JAX package's
  ``icl-export`` writes, so either package's import and predict read it;
* a ``<out>.manifest.json`` sidecar with the step, each leaf's shape and
  dtype, the parameter total and the ``model_config.json`` /
  ``train_config.json`` contents.

Every exported leaf is byte-identical to the checkpoint's.

Usage::

    icl-torch-export --model_file runs/rel.model --out rel_weights.npz
        [--step N]
"""

from __future__ import annotations

import argparse
import json
import os

from icl_torch.params import save_npz
from icl_torch.train.checkpoint import Checkpointer
from icl_torch.util.log import LOG


def export_checkpoint(model_dir: str, out: str,
                      step: int | None = None) -> dict:
    """Write ``out`` (.npz) + ``out``.manifest.json; returns the manifest."""
    model_dir = os.path.abspath(model_dir)
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(f"no model directory {model_dir}")
    flat, step = Checkpointer(model_dir).load_weights(step)
    if not flat:
        raise ValueError(f"checkpoint step {step} has no parameters")
    configs = {}
    for name in ("model_config", "train_config"):
        p = os.path.join(model_dir, name + ".json")
        if os.path.exists(p):
            with open(p) as f:
                configs[name] = json.load(f)
    manifest = save_npz(out, flat, configs.get("model_config"), step=step,
                        train_config=configs.get("train_config"))
    LOG.info("exported step %d: %d tensors / %s parameters -> %s (+ "
             "manifest)", step, len(flat),
             f"{manifest['total_parameters']:,}", out)
    return manifest


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="icl-torch-export", allow_abbrev=False,
        description="Export checkpoint weights to a flat .npz archive "
                    "(+ self-describing .manifest.json)")
    p.add_argument("--model_file", required=True,
                   help="checkpoint directory (the CLIs' --model_file)")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to export (default: latest)")
    args = p.parse_args(argv)
    export_checkpoint(args.model_file, args.out, args.step)


if __name__ == "__main__":
    main()
