"""The optimiser (the port of ``repro.optim``): AdamW with its schedule and
global-norm clipping (``adamw``) and int8 error-feedback gradient
compression (``compression``). Plain PyTorch operations on dicts of
tensors keyed by parameter name."""
