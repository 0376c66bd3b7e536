"""The whole step's least time at the card's peaks over its measured time, in %."""
from portbench.readers import mfu


def read(run):
    return mfu(run, "train")
