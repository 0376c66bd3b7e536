"""Share of the traced stretch in which no device operation ran, in %."""
from portbench.readers import device_idle


def read(run):
    return device_idle(run, "infer")
