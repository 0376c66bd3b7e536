"""Host seconds of the port's sym_norm and prepare_from_config in set-up."""


def read(run):
    return run.parts["sym_norm"] + run.parts["prepare"]
