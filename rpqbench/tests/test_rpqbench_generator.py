"""The benchmark's generator copy draws what the port's generator draws."""
import pytest

from rpqbench.generator import Fenwick, so_like, with_deletions


@pytest.mark.parametrize("n, m, seed, rate", [
    (64, 400, 0, 10.0), (2048, 600, 42, 10.0), (8192, 500, 2**31 + 7, 50.0),
    (300, 700, 123456789012, 3.0)])
def test_so_like_matches_the_port(n, m, seed, rate):
    from repro_torch.streaming import generators as port

    mine = with_deletions(so_like(n, m, seed, rate), 0.02, seed + 1)
    theirs = list(port.with_deletions(port.so_like(n, m, seed=seed, rate=rate),
                                      0.02, seed=seed + 1))
    assert [tuple(s) for s in mine] == [(s.ts, s.src, s.dst, s.label, s.op)
                                        for s in theirs]


def test_fenwick_first_reaching():
    w = [3, 1, 4, 1, 5]
    f = Fenwick(w)
    prefix = [3, 4, 8, 9, 14]
    for r in [0.0, 0.5, 3.0, 3.0001, 4.0, 8.5, 13.99, 14.0]:
        assert f.first_reaching(r) == next(i for i, p in enumerate(prefix) if r <= p)
    f.add(1, 10)
    assert f.total == 24 and f.first_reaching(13.5) == 1 and f.first_reaching(14.5) == 2
