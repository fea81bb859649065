"""The serving benchmark of ``repro_torch`` (run ``python3 bench/run.py``).

Everything one configuration, traffic mix or metric needs sits in files
of its own, found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the model's published sizes, what the port
  changes, the deployment and the engine settings;
* ``traffic/<mix>.json``: the parameters of a mix, read by the
  generator module it names (``traffic/<generator>.py``);
* ``metrics/<metric>.py``: one reader per metric, ``read(run)``;
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
* ``count/``: operations and bytes of the work, for the rooflines;
* ``reference/``: the plain PyTorch reference the served tokens are
  held against.

``harness/`` is the general part: it builds the engine, drives the
window, traces a slice of it and reduces what it saw.
"""
