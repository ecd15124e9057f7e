"""icl-torch-nonvisual — visual/nonvisual mention detector CLI (counterpart
of ``icl/cli/nonvisual.py``): the same train/predict surface and `.scores`
byte format, class order [visual, nonvisual]."""

from __future__ import annotations

from icl_torch.cli._common import base_parser, parse_task_args
from icl_torch.cli._mention_task import run
from icl_torch.models.nonvisual import NONVIS_CLASSES, NonvisualModel


def main(argv=None) -> None:
    p = base_parser(
        "nonvisual",
        "Binary visual/nonvisual mention classifier over mean-pooled "
        "word2vec mention embeddings (FFNN).")
    run(parse_task_args(p, argv, "nonvisual"),
        "nonvisual", NonvisualModel, NONVIS_CLASSES)


if __name__ == "__main__":
    main()
