"""ButterFly BFS on PyTorch and CUDA: the port of the JAX package ``repro``.

The port mirrors the reference's module paths (``repro/core/bfs.py`` ->
``repro_torch/core/bfs.py``) and imports nothing of it. P ranks are
simulated as a leading ``[P, ...]`` axis on one device; the frontier
kernels are hand-written CUDA C++ for Hopper (``kernels/csrc``).
"""
