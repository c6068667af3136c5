"""The port's benchmark: cells of ``BENCHMARK.json`` run on one H100.

Everything a cell needs is found by name: its configuration
(``configs/<config>.json``, the program's model in ``program/<config>.py``,
the plain reference in ``reference/<config>.py``), its traffic mix
(``traffic/<mix>.json``, read by the generator ``traffic/<kind>.py``), its
correctness limits (``workloads/<cell>.json``) and one reader per per-layer
metric (``metrics/<metric>.py``).  ``README.md`` says how to run a cell and
how to add one.
"""
