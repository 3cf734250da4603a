"""The import check the port's tests share: code run in a fresh interpreter
with only ``src`` on the path must load neither JAX nor the ``repro``
package."""
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def assert_loads_neither_jax_nor_repro(code: str) -> None:
    """Run ``code`` in a subprocess; fail if it raised or left a ``jax`` or
    ``repro`` module in ``sys.modules``."""
    check = ("\nimport sys\n"
             "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
             "or m == 'repro' or m.startswith('repro.')]\n"
             "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code + check],
                          capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
