"""The benchmark of the PyTorch and CUDA port (``prego_tpu_torch``).

``perf_bench/run.py`` runs one cell of ``BENCHMARK.json`` once. Everything
that belongs to one configuration, traffic mix or per-layer metric is a
file of its own, found by its name:

  configs/<config>.json     the configuration as it is run (``file`` in
                            BENCHMARK.json names it)
  traffic/<traffic>.json    a traffic mix: parameters for the general
                            generator (``gen.py``) and the name of the
                            loop that runs it (``loops/<loop>.py``)
  metrics/<metric>.py       the reader of one per-layer metric
  limits/<workload>.json    the limits of the numbers that decide a cell's
                            ``correct``, with the readings they were set from

The yardstick (traffic generation, the reduction of traces to metrics, the
table of peaks, the operations and bytes of each kernel, the plain
references and the comparisons) lives here. Nothing here imports ``jax``
or the JAX package; the references import nothing of the port.
"""
