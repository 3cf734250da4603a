"""Seconds from the start of ``run.py`` to the first timed call: imports,
the kernels' build or load, the stream's generation, the service, its
registrations and the warm-up prefix (the output check is not counted)."""


def read(run):
    return run.setup_s
