"""``torch.cuda.max_memory_allocated()`` over the timed window, reset when
it opens (GiB): what a deployment has to provision on the card."""


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None
