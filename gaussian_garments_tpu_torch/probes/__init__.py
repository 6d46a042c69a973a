"""Card-side probes: the counterparts of the JAX package's TPU probe scripts.

Each module runs as ``python -m gaussian_garments_tpu_torch.probes.<name>``
and asks on the card the question its TPU script asked:

- ``gather``: is a table held on chip faster than a gather through L2?
  (``scripts/profile_pallas_gather{,2,3}.py``);
- ``composite_null``: what share of the forward compositor is staging, and
  what share per-pixel work? (``scripts/profile_kernel_null.py``);
- ``grid_overhead``: what does one block per (tile × 256-pair chunk) work
  item cost, and what is that cost made of?
  (``scripts/profile_grid_overhead.py``);
- ``worklist``: that work list, built from the port's tile ranges.

Every probe kernel has a plain PyTorch version in its module, which the CPU
tests use, a launch counter, and a wrapper that launches the kernel for CUDA
tensors, runs the plain version for CPU tensors and raises otherwise.
"""
