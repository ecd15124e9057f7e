"""Host time of the program's copy of a train batch to the device (its
span ``icl.h2d`` in ``dist/mesh.py``: pinning each array and issuing its
copy), on the prefetch worker, ms a call."""

from portbench.lib import spans


def read(run: dict):
    return spans.ms_per(run, "icl.h2d")
