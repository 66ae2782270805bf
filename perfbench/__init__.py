"""The benchmark of ``repro_torch``: one command, driven by the files here.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` reads ``BENCHMARK.json`` at the root of the checkout, finds
the cell's configuration (``configs/``), traffic mix (``traffic/``), entry
(``entries/``) and metric readers (``metrics/``) by name, runs the cell on
one card and prints one JSON line.  Nothing here imports ``jax`` or the JAX
package, and the references under ``reference/`` import nothing of
``repro_torch``.
"""
