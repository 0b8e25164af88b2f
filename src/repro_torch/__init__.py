"""PyTorch/CUDA port of the FLuID reproduction (``src/repro`` is the JAX reference).

Same module layout and names as ``repro``, except ``launch/mesh.py`` and
``launch/sharding.py``, which have no counterpart on one card (the step
routes the reference's sharding modes select are arguments of the steps
here); imports ``torch`` and ``numpy`` only. Entry points take an explicit
``device`` that defaults to ``"cuda"``.
"""
