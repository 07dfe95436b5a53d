"""PyTorch + CUDA port of the Double-Duty CAD stack (``repro``).

The layout mirrors the JAX package: ``core/`` holds the flow (netlists,
packing, timing, equivalence, the bit-parallel evaluator) and
``kernels/`` the hand-written CUDA kernels with their plain-torch
counterparts.  Nothing here imports jax or the JAX package.
"""
