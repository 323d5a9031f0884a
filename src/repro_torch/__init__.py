"""PyTorch/CUDA port of the Ring-Mesh NoC reproduction.

A second package beside the JAX reference (``src/repro``), with the same
module layout so that each ported module has its reference twin at the
same relative path.  It imports torch and numpy, never jax, and nothing of
the reference package.  ROADMAP.md lists what is ported and what is not.
"""
