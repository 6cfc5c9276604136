"""The port never imports jax or the JAX package.

Checked in a fresh interpreter (this test process has jax loaded by
conftest): import every module of minotaur_tpu_torch (the NL path, the
readers, the QG/OA path, the global path, the solver CLIs, the node
store, QPD, the sweep, the multi-device layer and the device-resident
node pool included), then look at sys.modules.  The port keeps its own
copies of the JAX package's numpy-only modules; those copied as they
are must stay byte-equal to the JAX package's file (utils/environment.py
but for two help strings).
"""

import os
import subprocess
import sys

import pytest

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
             "solvers.base", "solvers.mbnb", "bnb.cuts", "bnb.heuristics",
             "bnb.persp", "bnb.multistart", "bnb.linearizations", "bnb.qg",
             "bnb.oa", "solvers.mqg", "solvers.moa", "solvers.mlstoa",
             "solvers.mqgpar", "solvers.msbnb", "solvers.mmultistart",
             "native", "bnb.checkpoint", "bnb.qpd", "tools.sweep",
             "engines.factory", "ir.polynomial", "utils.operations",
             "glob", "glob.transformer", "glob.univariate", "glob.rlt",
             "glob.glob_step", "glob.glob_bnb", "solvers.mglob",
             "parallel", "parallel.pool", "parallel.dist_bnb",
             "parallel.multihost", "solvers.mqgdist", "solvers.mqgmpi",
             "bnb.device_pool"):
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


# modules the port copies byte for byte from the JAX package
VERBATIM = (
    "utils/__init__.py", "utils/types.py", "utils/options.py",
    "utils/logger.py", "utils/timer.py",
    "ir/expr.py", "ir/functions.py", "ir/problem.py", "ops/opcodes.py",
    "bnb/node.py", "bnb/solpool.py", "bnb/nlpres.py",
    "bnb/bin2lin.py", "bnb/cuts.py", "bnb/persp.py", "bnb/checkpoint.py",
    "ir/polynomial.py", "utils/operations.py", "native/treestore.cpp",
    "models/generators.py", "models/convex_suite.py",
    "io/nl_reader.py", "io/nl_writer.py", "io/mps_reader.py",
    "io/sol_writer.py", "io/gams_reader.py", "glob/transformer.py",
)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies(rel):
    with open(os.path.join(ROOT, "minotaur_tpu", rel), "rb") as fh:
        ref = fh.read()
    with open(os.path.join(ROOT, "minotaur_tpu_torch", rel), "rb") as fh:
        assert fh.read() == ref, rel


# options whose help strings the port rewrites (they quoted TPU figures)
PORT_HELP = ("ipm_use_pallas", "device_tree")


def _help_spans(src):
    """Source of `src` with the help argument of each PORT_HELP option's
    `ins(...)` call cut out."""
    import ast
    cuts = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == \
                "ins" and isinstance(node.args[0], ast.Constant) and \
                node.args[0].value in PORT_HELP:
            help_arg = node.args[2]
            cuts.append((help_arg.lineno, help_arg.col_offset,
                         help_arg.end_lineno, help_arg.end_col_offset))
    assert len(cuts) == len(PORT_HELP)
    lines = src.splitlines(keepends=True)
    offset = [0]
    for line in lines:
        offset.append(offset[-1] + len(line.encode()))
    data = src.encode()
    out, pos = b"", 0
    for l0, c0, l1, c1 in sorted(cuts):
        out += data[pos:offset[l0 - 1] + c0] + b"<help>"
        pos = offset[l1 - 1] + c1
    return out + data[pos:]


def test_environment_copy_differs_only_in_help():
    """utils/environment.py is the JAX package's file but for the help
    strings of `ipm_use_pallas` and `device_tree`, which the port words
    without TPU figures; the option tables are equal by name, type and
    default."""
    from minotaur_tpu.utils.environment import Environment as JaxEnv
    from minotaur_tpu_torch.utils.environment import Environment
    rel = "utils/environment.py"
    with open(os.path.join(ROOT, "minotaur_tpu", rel)) as fh:
        ref = fh.read()
    with open(os.path.join(ROOT, "minotaur_tpu_torch", rel)) as fh:
        port = fh.read()
    assert _help_spans(port) == _help_spans(ref)
    table = lambda env: [(o.name, o.otype, o.default)  # noqa: E731
                         for o in env.options]
    assert table(Environment()) == table(JaxEnv())
    helps = {o.name: o.help for o in Environment().options}
    for name in PORT_HELP:
        assert "v5e" not in helps[name] and "PERF.md" in helps[name]
