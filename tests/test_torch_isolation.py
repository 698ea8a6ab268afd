"""`repro_torch` stands alone: it imports no JAX and nothing of `repro`,
and `chip_smoke.py` refuses to report a result without a CUDA card."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    __import__(name)
from repro_torch.core.spec import available_backends
available_backends()    # registers the backends: imports kernels.ops lazily
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_loads_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 54          # every module, optim and examples too
    assert out[1].strip() == "[]"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_line_imports_jax_or_repro(path):
    """Catches function-local imports too, which the module walk above
    never executes."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")
    lines = [ln for ln in path.read_text().splitlines() if bad.match(ln)]
    assert lines == []


def test_chip_smoke_without_a_card_fails_and_reports_nothing(tmp_path):
    """Run where torch sees no card (CUDA hidden), from the repository and
    from a directory holding chip_smoke.py and nothing else."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], env=env,
                              cwd=script.parent, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_the_backend_registry_loads_nothing_of_the_serving_layer():
    """`core.spec.may_degrade` reads the injected mark off the exception's
    class, so the conv stack's lowest layer needs nothing of `serve`."""
    code = ("import sys, repro_torch.core.spec as s; "
            "s.available_backends(); "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.serve')))")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
