"""The port stands alone: importing every ``repro_torch`` module loads
neither ``jax`` nor any module of the JAX package ``repro``, and neither
the port's sources nor ``chip_smoke.py`` name them in an import."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT = re.compile(r"^\s*(import\s+(jax|repro)(\.|\s|$)|"
                     r"from\s+(jax|repro)(\.|\s))", re.M)


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith('jax.') or n == 'repro' "
        "or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules "
        "if n.startswith('repro_torch')]), bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 20 and bad.strip() == "[]"


def test_no_source_names_jax_or_repro_in_an_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for f in files:
        text = f.read_text()
        assert not _IMPORT.search(text), f"{f} imports jax or repro"
    assert _IMPORT.search("import jax\n")
    assert _IMPORT.search("from repro.core import x\n")
    assert not _IMPORT.search("from repro_torch.core import x\n")
