"""PyTorch/CUDA port of the streaming-RPQ engine (``repro`` is the JAX
reference it is held against).

Layers, as in the reference: service (``streaming.service``) -> engine
(``core.engine``) -> executor (``core.executor``, or the mesh executor
over a grid of devices in ``distributed.executor``; the ELL adjacency in
``core.sparse_adj``, the row-sparse dist in ``core.sparse_dist``) ->
closure rounds, dense, frontier-restricted and sharded, and the legacy
single-query round (``core.semiring``) -> contraction backend
(``core.contraction``: float kernels or the level-quantized bucket mode)
-> kernels B1/B2 (``kernels.maxmin``, CUDA C++ in ``csrc/maxmin.cu``),
B3/B4 (``kernels.bucket``, ``csrc/bucket.cu``), B5 (``kernels.ell``,
``csrc/ell.cu``) and B6 (``kernels.rowsparse``, ``csrc/rowsparse.cu``).
Entry points run on the CUDA card unless given ``device="cpu"``. This
package never imports JAX or ``repro``.
"""
