"""Seconds from the harness's start to the window's: imports, inputs, sym_norm,
prepare, model, warm-up (the first run in a checkout also builds the
port's kernels)."""


def read(run):
    return run.setup_s
