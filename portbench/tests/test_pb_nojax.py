"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the program.  Top-level module names (before
the first dot) are compared whole: ``icl_torch`` is not ``icl``."""

from __future__ import annotations

import glob
import os
import re
import subprocess
import sys

from portbench.tests.conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "icl", "imagecaptionlearn_py_tpu")

ALL_FILES_THEN_A_RUN = """
import glob, os, sys, torch
sys.path.insert(0, {root!r}); sys.path.insert(0, os.path.join({root!r}, "portbench"))
import run as pbrun
from portbench.lib import cell
from portbench.tests.conftest import tiny_cell, measure
for f in sorted(glob.glob(os.path.join({root!r}, "portbench", "**", "*.py"), recursive=True)):
    if "/tests/" not in f and not f.endswith("run.py"):
        cell.load_module(f)
for name in ("affinity.predict", "relation.train.highest"):
    assert measure(tiny_cell(name), 5, seconds=0.2)["correct"]
bad = pbrun.forbidden_modules()
print("FORBIDDEN", bad)
sys.exit(1 if bad else 0)
"""


def test_no_jax_after_every_module_and_a_run():
    proc = subprocess.run(
        [sys.executable, "-c", ALL_FILES_THEN_A_RUN.format(root=ROOT)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "FORBIDDEN []" in proc.stdout


def test_names_compared_whole(monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "portbench"))
    import run as pbrun

    for name in ("icl_torch", "icl_torch.serve", "iclx", "jax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not [m for m in pbrun.forbidden_modules()
                if m.split(".")[0] in ("icl_torch", "iclx", "jax_like")]
    for name in ("icl", "icl.models", "jax", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"icl", "icl.models", "jax", "flax.linen"} <= set(
        pbrun.forbidden_modules())


def test_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.lib import cell\n"
            "import glob, os\n"
            "for f in glob.glob(os.path.join(cell.HERE, 'reference', '*.py')):\n"
            "    cell.load_module(f)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
            "assert not bad, bad\n") % (ROOT, ("icl_torch",) + FORBIDDEN)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_no_source_of_the_benchmark_imports_the_jax_package():
    rx = re.compile(r"^\s*(import|from)\s+(%s)(\.|\s|$)"
                    % "|".join(FORBIDDEN), re.M)
    for f in glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"),
                       recursive=True):
        assert not rx.search(open(f, encoding="utf-8").read()), f
