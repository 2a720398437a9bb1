"""repro_torch — the PyTorch/CUDA port of ``repro``, for one NVIDIA H100.

Mirrors the JAX package's layout and public names: ``kernels`` (hand-written
Hopper kernels with plain PyTorch versions), ``core.rma`` (the one-sided
window layer, plans and collectives), ``configs``, ``models``, ``train``,
``data`` and ``launch``.  Ranks are the rows of stacked ``(n, ...)``
tensors on one card.  Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU, and raise when CUDA is asked for and
absent.  Nothing here imports ``jax`` or ``repro``.
"""
