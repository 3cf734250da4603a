"""The launch layer: the production and host device grids (``mesh``), the
per-round capacity plan on the production grid (``dryrun_rpq``) and the
LM cells' input stand-ins (``specs``)."""
