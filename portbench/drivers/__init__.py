"""Traffic drivers, one module a ``kind``, named by a mix's data file
(``traffic/<name>.json``): ``setup(run)`` builds what the window runs,
``drive(run)`` warms up, measures, traces and checks against the
reference, and ``unit_ops(run)`` is the count of one unit of its work (an
epoch, a request) for ``portbench/counts.py``."""
