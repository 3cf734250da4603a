"""The LM decoder (the port of ``repro.models``): shared layers
(``layers``), the Mamba-2 SSD mixer (``ssd``), the MoE layer (``moe``), the
model (``transformer.Model``) and the weight and cache layouts shared with
the JAX package (``params``). Plain PyTorch operations throughout: the
reference computes this path in plain ``jnp``, with no Pallas kernel."""
