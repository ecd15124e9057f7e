"""The port runs where JAX is not installed: icl_torch and chip_smoke.py
import no JAX, flax, optax or orbax, directly or through the shared
modules."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax")


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import icl_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    icl_torch.__path__, 'icl_torch.')] + ['chip_smoke']\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"bad = sorted(m for m in {BANNED!r} if m in sys.modules)\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n, bad = proc.stdout.split(maxsplit=1)
    assert int(n) >= 10 and bad.strip() == "[]", proc.stdout


def test_no_source_line_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(" + "|".join(BANNED) + r")\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "icl_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]     # build outputs
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(open(f, encoding="utf-8"), 1)
            if pat.match(line)]
    assert len(files) >= 10 and not hits, hits
