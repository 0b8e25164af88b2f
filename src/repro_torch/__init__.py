"""PyTorch/CUDA port of the FLuID reproduction (``src/repro`` is the JAX reference).

Same module layout and names as ``repro``; imports ``torch`` and ``numpy``
only. Entry points take an explicit ``device`` that defaults to ``"cuda"``.
"""
