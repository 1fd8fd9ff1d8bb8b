"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 -m imc_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root names every cell, configuration,
traffic mix and metric; the harness finds each by that name under this
folder and holds no list of them in code:

* ``configs/<config>.json``: the configuration's sizes, precision, peaks
  and the limits of its correctness check; ``configs/<config>.py`` builds
  the port's served request from the weights the harness made;
* ``reference/<config>.py``: the plain PyTorch reference (no kernel, no
  import of the port), the shapes of the weights and the frozen work count;
* ``traffic/<mix>.json``: frames a request, requests in flight, distinct
  input batches, the traced slice's length, the checked sample's size;
* ``metrics/<metric>.py`` (or ``metrics/<stem>.py`` for ``<stem>.<part>``):
  a ``read(run)`` that returns the metric's value, or None where the run
  holds nothing for it to read (which ends a run of a cell that
  ``BENCHMARK.json`` lists for the metric).

Nothing here imports ``jax``, ``repro`` (the JAX package), ``benchmarks``
or ``benchmarks_torch``.
"""
