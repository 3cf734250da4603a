"""The launch layer: the production and host device grids (``mesh``) and
the per-round capacity plan on the production grid (``dryrun_rpq``)."""
