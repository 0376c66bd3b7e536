"""The plain reference: float32 PyTorch with TF32 off, importing nothing of
the program (``common``: adjacency, precision, loss, Adam; one module a
model family)."""
