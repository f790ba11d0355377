"""PyTorch/CUDA port of the ToaD system, beside the JAX package ``repro``.

Subpackages mirror ``repro`` (``core``, ``gbdt``, ``kernels``, ``api``,
``launch``) module for module.  The port imports torch and numpy, never
JAX and nothing of ``repro``; its entry points run on the card
(``device="cuda"``) unless the caller asks for ``device="cpu"``.
"""
