"""Command-line entry points of the port (``icl-torch-relation``,
``icl-torch-affinity``); counterparts of ``icl/cli``."""
