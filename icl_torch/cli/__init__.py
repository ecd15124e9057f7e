"""Command-line entry points of the port, one for each of ``icl/cli``'s:
the four task CLIs (``icl-torch-relation``, ``-affinity``, ``-nonvisual``,
``-cardinality``), ``icl-torch-joint``, ``icl-torch-export`` and
``-import``, and the tools ``icl-torch-eval``, ``-check``, ``-baseline``."""
