"""torch.cuda.max_memory_allocated over set-up and window, in GiB."""


def read(run):
    return run.memory_peak / 2**30 if run.memory_peak else None
