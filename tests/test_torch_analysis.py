"""The port's dispatch-hygiene analyzer (``repro_torch.analysis``): every
rule catches its seeded-violation fixture and stays silent on its clean
twin, suppressions work, the CLI gates, the port's tree is clean, and
the analyzer agrees with the JAX package's (``repro.analysis``) where the
two rules are the same rule: R2's findings and R5's FIFO half, the JSON
report's keys, and a port counterpart (or a stated reason) for every
root of the JAX package's call graph.

Both analyzers are pure stdlib: these tests import neither torch nor
jax.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis.analyzer import analyze_sources as jax_analyze_sources
from repro.analysis.analyzer import format_json as jax_format_json
from repro.analysis.analyzer import load_project as jax_load_project
from repro_torch.analysis.analyzer import (analyze_sources, format_json,
                                           load_project, run)
from repro_torch.analysis.rules import ALL_RULES
from repro_torch.analysis.rules.r1_dispatch_syncs import DISPATCH_ROOTS

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"

# -- fixtures: (rule, bad source, expected minimum hits, clean twin) ---------

# rooted by DISPATCH_ROOTS: the port's counterpart of repro.core.executor's
# jitted _ingest
R1_BAD = """\
import torch

from ..device import device_get


def _ingest(dist, mask, changed):
    total = float(dist.sum())
    host = dist.cpu()
    n = dist.item()
    rows = torch.nonzero(mask)
    if torch.any(dist > 0):
        dist = dist + 1
    while changed.any():
        changed = step(dist, changed)
    now = torch.tensor(3.0, device=dist.device)
    top = device_get(dist.max())
    src = torch.as_tensor([1, 2]).to(dist.device)
    first = mask.argmax()
    row = dist[first]
    return helper(dist) + total + host + n + rows + now + top + src + row


def step(dist, changed):
    return changed & (dist > 0)


def helper(x):
    return x.tolist()
"""

R1_CLEAN = """\
import numpy as np
import torch

from ..device import device_get


def _ingest(dist, mask):
    m = dist.shape[0]
    k = int(dist.ndim)
    j = bool(mask.numel())
    dist = torch.where(dist > 0, dist + 1.0, dist)
    sizes = np.asarray([1, 2])
    top = int(sizes.max())
    cnt_h = np.arange(m)
    big = bool((cnt_h > 4).any())
    src = torch.as_tensor(np.arange(m)).to(dist.device, non_blocking=True)
    now = torch.full((), 3.0, device=dist.device)
    row = dist.index_select(0, mask.argmax().reshape(1))
    return dist, k, j, top, big, src, now, row


def host_prep(x):
    # not reachable from a dispatch root: a flush site reads the device
    return device_get(x).tolist()
"""

R2_BAD = """\
import functools

import torch


@functools.lru_cache(maxsize=None)
def grid_tables(grid, q_axes):
    return q_axes


def grow(n, device):
    f_cap = n + 3
    q_cap = 100
    ell_cap = n + 5
    dist_cap = n + 7
    tables = grid_tables(1, [1, 2])
    slab = torch.full((q_cap, f_cap), float("-inf"), device=device)
    return slab, ell_cap, dist_cap, tables
"""

R2_CLEAN = """\
import functools

import torch


def _next_pow2(n):
    return 1 << max(int(n) - 1, 1).bit_length()


@functools.lru_cache(maxsize=None)
def grid_tables(grid, q_axes):
    return q_axes


def grow(n, dist):
    f_cap = _next_pow2(n)
    f_cap *= 2
    q_cap = dist.shape[0]
    ell_cap = _next_pow2(n)
    spill_cap = ell_cap
    spill_cap *= 2
    dist_cap = _next_pow2(n)
    dist_ovf_cap = min(dist_cap, 4096)
    tables = grid_tables(1, (1, 2))
    slab = torch.full((q_cap, f_cap), float("-inf"), device=dist.device)
    return slab, ell_cap, spill_cap, dist_ovf_cap, tables
"""

R3_BAD = """\
from ..build import bind, call_on


def launch(a, out):
    fn = bind("maxmin", "maxmin_fused_f32", [])
    call_on(a, fn, a.data_ptr(), out.data_ptr(), 128, 64)
    bind("ell", "ell_contract_rows_f32", [])(a.data_ptr(), 16)
    fn(out.data_ptr())
"""

R3_CLEAN = """\
from ..build import bind, call_on

_TILE_BM = 128


def launch(a, out, j, m, k, n):
    nbytes = bind("maxmin", "maxmin_flag_bytes", [])(j, m, k, n, _TILE_BM)
    call_on(a, bind("maxmin", "maxmin_fused_f32", []), a.data_ptr(),
            out.data_ptr(), nbytes, j, m, k, n, _TILE_BM, 1)
"""

_BASE = """\
class Backend:
    zero = float("-inf")
    exact = True

    def prepare_state(self, dist, adj, now=None, w_max=None):
        return dist, adj

    def decode_state(self, dist, now=None, w_max=None):
        return dist

    def contract(self, d, a):
        raise NotImplementedError

    def contract_rows(self, d_s, a_l):
        raise NotImplementedError

    def contract_batched(self, dist, adj, btt, mask):
        return self.contract_rows(dist, adj)

    def _contract_ell(self, d, ell, labs):
        raise NotImplementedError

    def contract_rows_ell(self, d_s, ell, labs):
        return self._contract_ell(d_s, ell, labs)

    def gather_dist_rows(self, idx, ts, e):
        raise NotImplementedError


"""

R4_BAD = _BASE + """\
class HalfBackend(Backend):
    def contract(self, d, a):
        return d


def use(make_engine, resolve_backend, backend="cdua"):
    resolve_backend("cdua")
    return make_engine(backend="cdua")
"""

R4_CLEAN = _BASE + """\
class FullBackend(Backend):
    def contract(self, d, a):
        return d

    def contract_rows(self, d_s, a_l):
        return d_s

    def _contract_ell(self, d, ell, labs):
        return d

    def gather_dist_rows(self, idx, ts, e):
        return ts


def use(make_engine, resolve_backend, backend="mxu_bucket"):
    resolve_backend("plain")
    return make_engine(backend="cuda")
"""

R5_BAD = """\
class Executor:
    def drain(self, pending):
        while pending:
            h = pending.pop(0)
        return h

    def requeue(self, pending, h):
        pending.insert(0, h)

    def telemetry(self, arrays, qrounds, shard_counts):
        t = float(arrays.now)
        c = arrays.now.item()
        r = qrounds.cpu()
        s = int(shard_counts)
        return t, c, r, s
"""

R5_CLEAN = """\
import numpy as np

from ..device import device_get


class Executor:
    def drain(self, pending):
        while pending:
            h = pending.popleft()
        return h

    def _consume_count(self, rounds, qrounds, n_live):
        return rounds + int(device_get(qrounds.sum()))

    def _flush_health(self, overflow_counts):
        # the supervisor's per-interval telemetry flush is a sanctioned
        # site, as the executor's counter flushes are
        return np.asarray(overflow_counts)

    def restore(self, state):
        return float(device_get(state.now))
"""

FIXTURES = {
    "R1": (R1_BAD, 11, R1_CLEAN),
    "R2": (R2_BAD, 5, R2_CLEAN),
    "R3": (R3_BAD, 5, R3_CLEAN),
    "R4": (R4_BAD, 4, R4_CLEAN),
    "R5": (R5_BAD, 6, R5_CLEAN),
}

# R1's fixture is the port's executor module (so DISPATCH_ROOTS roots its
# _ingest); the others live under a kernels/ dir (R3's scope)
FIXTURE_RELPATH = {rule: "src/repro_torch/kernels/fixture/fixture.py"
                   for rule in FIXTURES}
FIXTURE_RELPATH["R1"] = "src/repro_torch/core/executor.py"


def _hits(source, rule):
    findings = analyze_sources({FIXTURE_RELPATH[rule]: source}, rules=[rule])
    return [f for f in findings if f.rule == rule]


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_catches_seeded_fixture(rule):
    bad, n_min, _clean = FIXTURES[rule]
    hits = _hits(bad, rule)
    assert len(hits) >= n_min, (
        f"{rule} found {len(hits)} of >= {n_min} seeded violations:\n"
        + "\n".join(f.format() for f in hits))


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_silent_on_clean_twin(rule):
    _bad, _n, clean = FIXTURES[rule]
    hits = _hits(clean, rule)
    assert not hits, "\n".join(f.format() for f in hits)


def test_r1_reaches_through_helper_calls():
    hits = _hits(R1_BAD, "R1")
    assert any("`helper`" in f.message for f in hits), (
        "the .tolist() in the helper must be reached through the rooted "
        "_ingest")


def test_r1_ignores_host_side_code():
    # host_prep's device_get is outside the dispatch path; cnt_h and the
    # numpy-rooted names are host values
    assert not _hits(R1_CLEAN + "\n", "R1")


def test_r1_roots_methods_by_qualname():
    src = ("class MeshExecutor:\n"
           "    def _closures(self, shards):\n"
           "        return shards[0].item()\n"
           "\n"
           "    def emit(self, x):\n"
           "        return x.item()\n")
    findings = analyze_sources({"src/repro_torch/distributed/executor.py": src},
                               rules=["R1"])
    assert [f.line for f in findings] == [3], [f.format() for f in findings]


def test_r1_roots_only_the_table():
    # the same function anywhere but its counterpart's module is not rooted
    assert not analyze_sources({"src/repro_torch/core/elsewhere.py": R1_BAD},
                               rules=["R1"])


def test_noqa_suppresses_but_still_reports():
    src = R5_BAD.replace(
        "h = pending.pop(0)",
        "h = pending.pop(0)  # repro: noqa[R5] a two-entry list, drained once")
    findings = analyze_sources({FIXTURE_RELPATH["R5"]: src}, rules=["R5"])
    popfinds = [f for f in findings if "pop(0)" in f.message]
    assert popfinds and all(f.suppressed for f in popfinds)
    assert any(not f.suppressed for f in findings)  # the others still fail


def test_bare_noqa_suppresses_all_rules():
    src = "def f(n):\n    f_cap = n + 3  # repro: noqa\n    return f_cap\n"
    findings = analyze_sources({"m.py": src})
    assert findings and all(f.suppressed for f in findings)


def test_rule_registry_complete():
    assert sorted(m.RULE for m in ALL_RULES) == ["R1", "R2", "R3", "R4", "R5"]
    for m in ALL_RULES:
        assert m.TITLE


# -- the port's own tree -------------------------------------------------------


def test_port_tree_is_clean():
    findings, n_files = run([str(SRC / "repro_torch")])
    live = [f for f in findings if not f.suppressed]
    assert n_files > 40
    assert not live, "\n".join(f.format() for f in live)


def test_r1_inventory_reaches_the_dispatch_path():
    """Known positives: the host fixpoint loop's read (the reference's
    lax.while_loop) and the frontier's fallback read (its lax.cond) are
    suppressed R1 findings, and every suppressed R1 finding states its
    reason on its line."""
    findings, _ = run([str(SRC / "repro_torch")], rules=["R1"])
    sup = [f for f in findings if f.suppressed]
    assert sup and len(sup) == len(findings)
    where = {f.message.rsplit("`", 2)[-2] for f in sup}
    assert {"_masked_closure_loop", "_plan", "_frontier_loop"} <= where, where
    loop = [f for f in sup if "`_masked_closure_loop`" in f.message]
    assert len(loop) == 1 and loop[0].path.endswith("core/semiring.py")
    for f in sup:
        line = Path(f.path).read_text().splitlines()[f.line - 1]
        reason = line.split("noqa[R1]", 1)[1].strip()
        assert len(reason) >= 12, f"{f.format()}: no reason on its line"


# -- against the JAX package's analyzer ----------------------------------------


def _jax_fixtures():
    """tests/test_analysis.py's fixture sources (the JAX package's own)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_analysis_fixtures", REPO / "tests" / "test_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _key(findings):
    return [(f.rule, f.line, f.col, f.message) for f in findings]


@pytest.mark.parametrize("name", ["R2_BAD", "R2_CLEAN"])
def test_r2_agrees_with_jax_analyzer(name):
    src = getattr(_jax_fixtures(), name)
    path = "src/fake/kernels/fixture.py"
    port = analyze_sources({path: src}, rules=["R2"])
    jax = jax_analyze_sources({path: src}, rules=["R2"])
    assert _key(port) == _key(jax)
    assert bool(port) == (name == "R2_BAD")


def test_r5_fifo_half_agrees_with_jax_analyzer():
    src = _jax_fixtures().R5_BAD
    path = "src/fake/kernels/fixture.py"

    def fifo(findings):
        return [f for f in findings
                if f.message.startswith(("`pop(0)`", "`insert(0"))]

    port = fifo(analyze_sources({path: src}, rules=["R5"]))
    jax = fifo(jax_analyze_sources({path: src}, rules=["R5"]))
    assert len(port) == 2 and _key(port) == _key(jax)


def test_json_report_has_the_jax_analyzers_keys():
    src = _jax_fixtures().R5_BAD
    path = "src/fake/kernels/fixture.py"
    port = json.loads(format_json(analyze_sources({path: src}), 1))
    jax = json.loads(jax_format_json(jax_analyze_sources({path: src}), 1))
    assert set(port) == set(jax) >= {"unsuppressed", "suppressed",
                                     "counts_by_rule", "checked_files"}
    assert set(port["findings"][0]) == set(jax["findings"][0])


def test_every_jax_root_has_a_port_counterpart():
    jax_roots = jax_load_project([str(SRC / "repro")]).callgraph().roots
    assert len(jax_roots) >= 21
    assert set(DISPATCH_ROOTS) == set(jax_roots), (
        f"missing {sorted(set(jax_roots) - set(DISPATCH_ROOTS))}, stale "
        f"{sorted(set(DISPATCH_ROOTS) - set(jax_roots))}")
    port = load_project([str(SRC / "repro_torch")])
    for root, entry in DISPATCH_ROOTS.items():
        if isinstance(entry, str):
            assert entry.startswith("no counterpart: "), (root, entry)
            continue
        missing = [key for key in entry if not port.has_function(key)]
        assert entry and not missing, f"{root}: no port function {missing}"


# -- the CLI ---------------------------------------------------------------------


def _cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_cli_exits_1_on_each_seeded_fixture(rule, tmp_path):
    path = tmp_path / FIXTURE_RELPATH[rule]
    path.parent.mkdir(parents=True)
    path.write_text(FIXTURES[rule][0])
    proc = _cli(str(tmp_path), "--format=json", f"--rules={rule}")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["counts_by_rule"].get(rule, 0) >= FIXTURES[rule][1]
    assert payload["checked_files"] == 1


def test_cli_default_path_is_the_port_and_clean():
    proc = _cli("--format=json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["unsuppressed"] == 0 and payload["suppressed"] > 0
    assert payload["checked_files"] > 40
    assert {f["path"].split("/", 1)[0] for f in payload["findings"]} == {"src"}
    text = _cli()
    assert text.returncode == 0 and "0 finding(s)" in text.stdout.splitlines()[-1]


def test_package_imports_no_torch_jax_or_repro():
    """The analyzer runs on a bare interpreter: with torch, jax and repro
    unimportable, the package imports and gates the port's tree."""
    code = ("import sys\n"
            "for name in ('torch', 'jax', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "from repro_torch.analysis.__main__ import main\n"
            "sys.exit(main(['src/repro_torch', '--format=json']))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr
    assert json.loads(proc.stdout)["unsuppressed"] == 0
