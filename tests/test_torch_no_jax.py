"""The port never imports jax or the JAX package.

Checked in a fresh interpreter (this test process has jax loaded by
conftest): import every module of minotaur_tpu_torch (the NL path, the
readers and the `mbnb` CLI included), then look at sys.modules.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, os, pkgutil, sys
sys.path.insert(0, {root!r})
import minotaur_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    minotaur_tpu_torch.__path__, "minotaur_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k == "minotaur_tpu" or k.startswith("minotaur_tpu."))
print(len(names), "modules")
assert len(names) >= 40, names
# the NL path and the CLI (ROADMAP.md Queue 1) are among them
for name in ("ops.stage", "ops.interval", "engines.staging", "convert",
             "bnb.nlpres", "bnb.substitute", "bnb.bin2lin",
             "models.convex_suite", "io.nl_reader", "io.mps_reader",
             "io.sol_writer", "io.nl_writer", "io.gams_reader",
             "solvers.base", "solvers.mbnb"):
    assert "minotaur_tpu_torch." + name in names, name
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _SCRIPT.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_set_default_dtype():
    pkg = os.path.join(ROOT, "minotaur_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert "set_default_dtype" not in fh.read(), f
