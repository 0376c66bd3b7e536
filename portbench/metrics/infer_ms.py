"""Window milliseconds a request (infer cells)."""
from portbench.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, "infer")
