"""The benchmark of sgracex1_tpu_torch, the PyTorch and CUDA port: see
``portbench/README.md`` and ``python3 -m portbench.run --help``."""
