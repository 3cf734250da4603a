"""Public entry of the single-pair level product: the counterpart of
``repro.kernels.bucket.ops.bucket_maxmin_op``. It is kernel B4's wrapper,
which launches the kernel on a CUDA tensor and takes the plain version on
a CPU tensor."""
from __future__ import annotations

from .bucket import bucket_maxmin

bucket_maxmin_op = bucket_maxmin
