"""The benchmark of ``graphmine_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration
(``configs/<name>.json``, whose generator is ``generators/<name>.py``),
its traffic mix (``mixes/<name>.json``, whose job is ``jobs/<name>.py``),
its limits (``limits/<cell>.json``) and each metric (``metrics/<name>.py``).
The plain reference that decides ``correct`` is ``reference/``.
"""
