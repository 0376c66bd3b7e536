"""95th percentile of the window's request latencies, in ms (nearest rank)."""
from portbench.readers import p95_ms


def read(run):
    return p95_ms(run) if run.traffic["kind"] == "infer" else None
