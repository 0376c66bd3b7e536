"""Example programs, the torch twins of the repository's ``examples/``:
each is a module with ``main(argv)``, run as
``python -m sgracex1_tpu_torch.examples.<name> [--device cpu] ...``, on the
CUDA card unless ``--device cpu``."""
