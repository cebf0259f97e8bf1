"""VUSA reproduction, PyTorch + CUDA port (NVIDIA H100).

The JAX package ``repro`` is the reference this package is held against.
Unlike ``repro/__init__.py`` there is no process-wide flag to set here:
sampling draws from an explicit ``torch.Generator``.  This package imports
neither ``jax`` nor ``repro``.
"""
