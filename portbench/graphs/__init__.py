"""Graph generators, one module each, named by a configuration's
``graph.generator``: ``make(cfg, seed, device)`` gives a ``gen.Graph``."""
