"""PyTorch/CUDA port of the streaming-RPQ engine (``repro`` is the JAX
reference it is held against).

Layers, as in the reference: service (``streaming.service``) -> engine
(``core.engine``) -> executor (``core.executor``; the ELL adjacency in
``core.sparse_adj``) -> closure rounds, dense and frontier-restricted
(``core.semiring``) -> contraction backend (``core.contraction``) ->
kernels B1 (``kernels.maxmin``, CUDA C++ in ``csrc/maxmin.cu``) and B5
(``kernels.ell``, CUDA C++ in ``csrc/ell.cu``). Entry points run on the
CUDA card unless given ``device="cpu"``. This package never imports JAX
or ``repro``.
"""
