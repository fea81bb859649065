"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``models``, ``configs``, ``kernels``, ``obs``, ``serving``,
``launch``) and imports nothing of it.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
