"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of ButterFly BFS.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  What
belongs to one configuration, traffic mix, driver, generator or metric
sits in a file of its own, found by its name:

* ``configs/<config>.json``: a graph deployment (its source, ``reduced``,
  ``assumed``) and the generator that draws its edge tuples;
* ``generators/<generator>.py``: ``edges(config, gen, device)``, a frozen
  copy of a public generator in plain torch;
* ``traffic/<mix>.json``: the driver and its parameters;
* ``drivers/<driver>.py``: the entry point of the port that the window
  drives, its set-up and its check against :mod:`bench.reference`;
* ``metrics/<metric>.py``: ``read(run)``, the reader of one metric.

Nothing here imports ``jax`` or the JAX package; :mod:`bench.reference`
imports nothing of the port either.
"""
