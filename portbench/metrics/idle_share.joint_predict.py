"""Share of the traced window in which no device operation ran, %: read
from the profiler's timeline (kernels, copies and sets)."""

from portbench.lib.readers import idle_share


def read(run: dict):
    return idle_share(run)
