"""Device ms an epoch or request in operations that are not the port's own kernels."""
from portbench.readers import torch_ops_ms


def read(run):
    return torch_ops_ms(run, "train")
