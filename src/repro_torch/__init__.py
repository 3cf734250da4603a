"""PyTorch/CUDA port of the streaming-RPQ engine (``repro`` is the JAX
reference it is held against).

Layers, as in the reference: service (``streaming.service``) -> engine
(``core.engine``) -> executor (``core.executor``) -> closure rounds
(``core.semiring``) -> contraction backend (``core.contraction``) ->
kernel B1 (``kernels.maxmin``, CUDA C++ in ``csrc/maxmin.cu``). Entry
points run on the CUDA card unless given ``device="cpu"``. This package
never imports JAX or ``repro``.
"""
