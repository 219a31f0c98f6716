"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke`` load
neither ``jax`` nor any module of the JAX package ``repro``, and
``chip_smoke.py`` refuses to run (no result line) without a card."""

import os
import pathlib
import pkgutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHECK = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print(len(names), bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return env


def test_port_and_chip_smoke_import_no_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(maxsplit=1)
    expected = sum(1 for _ in pkgutil.walk_packages(
        [str(ROOT / "src" / "repro_torch")], "repro_torch."))
    assert int(count) == expected > 10
    assert bad.strip() == "[]"


def test_chip_smoke_fails_without_a_card():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
