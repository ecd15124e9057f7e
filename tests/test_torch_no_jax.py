"""The port runs where JAX is not installed and stands without the JAX
package: icl_torch and chip_smoke.py import no JAX, flax, optax or orbax,
and nothing of ``icl``, directly or through another module.  Nor do they
need ``keras``, ``sklearn`` or ``ml_dtypes`` at import: the machine with
the GPU has none of them (``sklearn`` is imported inside
``icl-torch-baseline``'s ``main`` and ``keras`` inside the oracle's loader
``icl_torch/eval/oracle.py:_k``, and nowhere else; bf16 conversions go
through torch)."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_SOURCE_LINE = ("jax", "jaxlib", "flax", "optax", "orbax", "icl",
                  "ml_dtypes")
# not in sys.modules after import; the lazy imports of the last two are
# test_sklearn_is_imported_only_inside_the_baseline_main's
BANNED = NO_SOURCE_LINE + ("sklearn", "keras")
# the modules of the CLI slice: the walk below must reach each of them
CLI_SLICE = ("icl_torch.cli._common", "icl_torch.cli.relation",
             "icl_torch.cli.affinity", "icl_torch.io.scores",
             "icl_torch.eval.scoredict", "icl_torch.train.loop",
             "icl_torch.train.checkpoint", "icl_torch.train.evalhook",
             # the mention tasks, the remaining CLIs
             "icl_torch.models.nonvisual", "icl_torch.models.cardinality",
             "icl_torch.cli._mention_task", "icl_torch.cli.nonvisual",
             "icl_torch.cli.cardinality", "icl_torch.cli.joint",
             "icl_torch.cli.export", "icl_torch.cli.import_",
             "icl_torch.cli.evaluate", "icl_torch.cli.check",
             "icl_torch.cli.baseline", "icl_torch.serve",
             # data parallelism over torch.distributed
             "icl_torch.dist.mesh", "icl_torch.testing.dist_worker",
             # the native I/O library's bindings, the Keras oracle
             "icl_torch.native.feats", "icl_torch.native.mentions",
             "icl_torch.native.captions", "icl_torch.native.w2v",
             "icl_torch.eval.oracle")
DIST_PACKAGES = ("icl_torch.dist", "icl_torch.runtime", "icl_torch.native")


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import icl_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    icl_torch.__path__, 'icl_torch.')] + ['chip_smoke']\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {BANNED!r})\n"
        f"missing = sorted(set({CLI_SLICE + DIST_PACKAGES!r}) - set(names))\n"
        "print(len(names), bad + missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n, bad = proc.stdout.split(maxsplit=1)
    assert int(n) >= 10 and bad.strip() == "[]", proc.stdout


def test_no_source_line_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(" + "|".join(NO_SOURCE_LINE)
                     + r")(\.|\s|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "icl_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]     # build outputs
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(open(f, encoding="utf-8"), 1)
            if pat.match(line)]
    assert len(files) >= 10 and not hits, hits
    rel = {os.path.relpath(f, REPO)[:-3].replace(os.sep, ".") for f in files}
    assert set(CLI_SLICE) <= rel
    assert {p + ".__init__" for p in DIST_PACKAGES} <= rel


def test_sklearn_is_imported_only_inside_the_baseline_main():
    """One lazy import of ``sklearn``, inside
    ``icl_torch/cli/baseline.py``'s function, and one of ``keras``, inside
    the oracle's loader ``_k`` in ``icl_torch/eval/oracle.py``; nothing
    else of the package imports either, lazily or not."""
    pat = re.compile(r"^(\s*)(import|from)\s+(sklearn|keras)(\.|\s|$)")
    hits = []
    for root, dirs, names in os.walk(os.path.join(REPO, "icl_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]
        for n in sorted(names):
            if n.endswith(".py"):
                path = os.path.join(root, n)
                func = None
                for line in open(path, encoding="utf-8"):
                    d = re.match(r"def (\w+)", line)
                    func = d.group(1) if d else func
                    m = pat.match(line)
                    if m:
                        hits.append((os.path.relpath(path, REPO),
                                     m.group(3), len(m.group(1)) > 0,
                                     func))
    for line in open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8"):
        assert not pat.match(line), line
    assert sorted(hits) == [
        (os.path.join("icl_torch", "cli", "baseline.py"), "sklearn", True,
         "main"),
        (os.path.join("icl_torch", "eval", "oracle.py"), "keras", True,
         "_k")], hits
