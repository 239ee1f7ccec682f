"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package `repro`, and `chip_smoke.py` fails without a CUDA device."""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in PORT.rglob("*.py"))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_modules_and_smoke_import_no_jax():
    code = ("import sys, importlib\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"for m in {MODULES!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 12


def test_port_sources_hold_no_jax_import():
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not FORBIDDEN.search(path.read_text()), path


def test_chip_smoke_fails_without_a_card(tmp_path):
    # Here: no CUDA device. Alone in a directory: no port sources either.
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    bare = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, env in ((ROOT / "chip_smoke.py", _env()), (lone, bare)):
        out = subprocess.run([sys.executable, str(script)], env=env,
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
