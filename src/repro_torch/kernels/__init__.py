"""Hand-written CUDA kernels for the BFS frontier hot spots (phase-1
gather/scatter and the butterfly OR merge), the port of the JAX package's
Pallas kernels.  Sources in ``csrc/``, build and binding in ``build.py``,
plain PyTorch versions in ``ref.py``, layouts in ``blocks.py``, the
BFS-facing compositions in ``ops.py``.
"""
