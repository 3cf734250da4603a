"""The output check fails its control (the program on its own
lower-precision path) and the program broken underneath it."""
import pytest

from rpqbench import harness
from rpqbench.control import control_checks


@pytest.mark.parametrize("workload, seed", [("so-dense-2048.steady", 11),
                                            ("so-dense-2048.steady", 12),
                                            ("so-dense-2048.steady", 13)])
def test_control_is_not_correct(small_cell, workload, seed):
    """The program on its bucket backend (int levels, a coarsened expiry)."""
    # 4 stream seconds of warm-up and 300 sgts: expiry is live for the last ~10
    checks = control_checks(small_cell(workload), seed, 300, device="cpu")
    assert not harness.is_correct(checks)


class Broken:
    """The port's service with one fault planted under ``ingest``."""

    def __init__(self, svc, fault: str):
        self.svc, self.fault, self.calls = svc, fault, 0

    def __getattr__(self, name):
        return getattr(self.svc, name)

    def ingest(self, stream, record_latency=False):
        self.calls += 1
        if self.fault == "unchanged" and self.calls % 7 == 0 and stream[0].op == "+":
            # the step returns with the state as it was: the sgt is dropped
            return type(self.svc.ingest([]))({}, {})
        report = self.svc.ingest(stream, record_latency=record_latency)
        if self.fault == "half_lanes":
            # half of the dispatch's lanes left out of the answer
            for name in sorted(report)[::2]:
                report[name] = set()
        elif self.fault == "altered" and self.calls % 30 == 0:
            # one answer altered where it is produced
            for name in sorted(report):
                if report[name]:
                    x, y = next(iter(report[name]))
                    report[name] = (report[name] - {(x, y)}) | {(x, y + 1000)}
                    break
            else:
                report["Q1"] = {(0, 1000)}
        return report


@pytest.mark.parametrize("fault", ["unchanged", "half_lanes", "altered"])
def test_broken_program_is_not_correct(small_cell, fault):
    cell = small_cell("so-dense-2048.steady")
    rec = harness.run_cell(
        cell, 21, 1e9, device="cpu", max_window_sgts=60,
        make_service=lambda cfg: Broken(harness.build_service(cfg, "cpu"), fault))
    assert not harness.is_correct(rec.checks) and rec.failed > 0


def test_the_sound_program_is_correct(small_cell):
    rec = harness.run_cell(small_cell("so-dense-2048.steady"), 21, 1e9, device="cpu",
                           max_window_sgts=60)
    assert harness.is_correct(rec.checks) and rec.failed == 0
