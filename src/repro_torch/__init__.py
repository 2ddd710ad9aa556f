"""PyTorch/CUDA port of the ``repro`` package (the JAX reference in
``src/repro/``), grown slice by slice for one NVIDIA H100.

The layout and names follow ``repro`` path for path, so each module's
counterpart is ``repro/<same path>``; every module's docstring names it.
The port imports ``torch``, numpy and the standard library only — never
``jax`` and never ``repro``. Entry points run on CUDA unless the caller
passes ``device="cpu"`` (``compat.resolve_device``).
"""
