"""kernels_roofline: the five kernels' summed least times (dasbench/
roofline.py, from each call's own arguments) over the device time the
profiler gave the same calls; calls outside the byte model are left out
of both sides."""

from dasbench.metrics_util import roofline_share


def read(run):
    return roofline_share(run.observed)
