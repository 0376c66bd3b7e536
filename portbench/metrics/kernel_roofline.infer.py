"""Least time of the aggregation work over the port's own kernels' device time, in %."""
from portbench.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "infer")
