"""PyTorch/CUDA port of the ``repro`` package.

Each module sits across from the reference module of the same name under
``repro``; the port imports ``torch`` and numpy, never JAX and never
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
