"""icl-torch-cardinality — box-count bin predictor CLI (counterpart of
``icl/cli/cardinality.py``), class order 0, 1, ..., 10, 11+."""

from __future__ import annotations

from icl_torch.cli._common import base_parser, parse_task_args
from icl_torch.cli._mention_task import run
from icl_torch.models.cardinality import CARDINALITY_CLASSES, CardinalityModel


def main(argv=None) -> None:
    p = base_parser(
        "cardinality",
        "Softmax over box-count bins {0..10,11+} per mention "
        "(ILP constraint signal).")
    run(parse_task_args(p, argv, "cardinality"),
        "cardinality", CardinalityModel, CARDINALITY_CLASSES)


if __name__ == "__main__":
    main()
