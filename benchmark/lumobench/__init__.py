"""The benchmark harness of ``lumo_tpu_torch``: cells resolved by name
from ``BENCHMARK.json`` (``cells.py``), the system under test driven
through its public entry points (``program.py``), the closed-loop window
and its traced variant (``window.py``, ``trace.py``), and the
comparison with the plain reference that decides ``correct``
(``check.py``).  Only ``program.py`` imports the port."""
