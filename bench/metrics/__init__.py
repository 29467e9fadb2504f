"""One reader a metric: ``<metric>.py`` holds ``read(run)``, which returns
the metric's value from a ``harness.Run`` or None where the run holds
nothing to read, and the metric's ``LAYER``, ``UNIT`` and ``MOVES`` as
``BENCHMARK.json`` gives them."""
