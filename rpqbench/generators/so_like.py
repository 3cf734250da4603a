"""The SO-like stream (``rpqbench/generator.py``): preferential attachment
on both endpoints, the three sx-stackoverflow labels, exponential arrival
gaps at ``rate``, and the deletion protocol at ``deletion_ratio``.

With ``arrival_seed`` in the stream's keys, every seed shares the arrival
times and the deletion protocol's draws (which inserts are followed by a
delete, and the victim's position) of that seed; they are independent of
the endpoints in the generator, so the stream's distribution is the
generator's, and seeds differ only in the graph."""
from rpqbench.generator import so_like, with_deletions


def make(stream: dict, seed: int, n_inserts: int):
    n, rate = int(stream["n_vertices"]), float(stream["rate"])
    inserts = so_like(n, n_inserts, seed, rate)
    del_seed = seed + 1
    if stream.get("arrival_seed") is not None:
        arrivals = so_like(n, n_inserts, int(stream["arrival_seed"]), rate)
        inserts = [s._replace(ts=a.ts) for s, a in zip(inserts, arrivals)]
        del_seed = int(stream["arrival_seed"]) + 1
    return with_deletions(inserts, float(stream["deletion_ratio"]), del_seed)
