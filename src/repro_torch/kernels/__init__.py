"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Kernel sources live in ``csrc/`` and are compiled by ``_build`` at first
use; importing this package builds nothing.
"""
