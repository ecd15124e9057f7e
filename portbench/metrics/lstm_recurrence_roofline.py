"""The phrase LSTM's recurrence kernel (``csrc/lstm_recurrence.cu``,
``lstm_cluster_kernel``) in affinity predict: the least time the card could
take for the traced window's calls (``work/affinity-flickr30k.predict.py:
lstm_bound_s``) over the device time of its launches, %."""

from portbench.lib import cell
from portbench.lib.readers import roofline

KERNELS = r"lstm_cluster_kernel"


def read(run: dict):
    t = run.get("trace")
    if t is None:
        return None
    return roofline(run, t.kernels(KERNELS),
                    cell.work(run["cell"]).lstm_bound_s)
