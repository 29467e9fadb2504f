"""The training benchmark of ``repro_torch`` on H100 cards.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json``, its configuration (``bench/configs/<config>.json``)
and its model family (``bench/archs/<model_type>.py``, the plain
reference's ``bench/reference/<model_type>.py``), its traffic
(``bench/traffic/<traffic>.json``), its correctness limits
(``bench/limits/<cell>.json``) and one reader per metric
(``bench/metrics/<metric>.py``).
"""
