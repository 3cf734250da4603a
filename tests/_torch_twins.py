"""A JAX service and the port's (``device="cpu"``) driven alike, for the
port's tests that hold a whole service against the JAX package's:
registrations return the same initial answers, every ingest the same
report, and results, stats and telemetry logs agree."""
from repro.streaming.service import PersistentQueryService as JaxService
from repro.streaming.stream import SGT as JaxSGT
from repro.streaming.stream import Stream as JaxStream
from repro_torch.streaming.service import PersistentQueryService
from repro_torch.streaming.stream import SGT, Stream


def rows(stream):
    """A stream of either package as plain (ts, src, dst, label, op) rows."""
    return [(s.ts, s.src, s.dst, s.label, s.op) for s in stream]


class TwinService:
    """Both services built with the same options; every call goes to both
    and must agree. The port's answer is returned."""

    def __init__(self, window, slide, **kw):
        self.jax = JaxService(window=window, slide=slide, **kw)
        self.port = PersistentQueryService(window=window, slide=slide,
                                           device="cpu", **kw)

    def register(self, name, expr, **kw):
        a = self.jax.register(name, expr, **kw)
        b = self.port.register(name, expr, **kw)
        assert a == b, name
        return b

    def deregister(self, name):
        self.jax.deregister(name)
        self.port.deregister(name)

    def ingest(self, sgts):
        """``sgts``: (ts, src, dst, label[, op]) rows."""
        sgts = list(sgts)
        rj = self.jax.ingest(JaxStream([JaxSGT(*s) for s in sgts]))
        rt = self.port.ingest(Stream([SGT(*s) for s in sgts]))
        assert dict(rt) == dict(rj)
        assert rt.invalidated == rj.invalidated
        assert rt.fallbacks == rj.fallbacks
        assert rt.deletions == rj.deletions
        return rt

    def results(self, name):
        a, b = self.jax.results(name), self.port.results(name)
        assert a == b, name
        return b

    def tuples(self, name):
        a, b = self.jax.stats[name].tuples, self.port.stats[name].tuples
        assert a == b, name
        return b

    def assert_equal(self):
        """Every live query's results and the controllers' logs."""
        for name in self.port.stats:
            if name in self.port._dense_specs or name in self.port._ref_engines:
                self.results(name)
        assert self.port.frontier_log == self.jax.frontier_log
        assert self.port.dist_log == self.jax.dist_log
        assert self.port.batch_size_log == self.jax.batch_size_log
