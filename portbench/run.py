"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Sets up the cell named in ``BENCHMARK.json`` from the seed, warms up every
shape it uses, measures for ``--seconds`` (``--trace 1``: a traced window,
the per-layer metrics), holds what the timed path produced to the plain
reference, and prints one JSON line last: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced), then
``checks``, each compared number beside its limit.  It runs on the CUDA
device it finds and exits non-zero without a result when there is none, or
when JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of a run lies at a fixed path inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, ".portbench_cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, ".portbench_cache", "extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = {"jax", "jaxlib", "flax", "icl", "imagecaptionlearn_py_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (names compared whole: ``icl_torch`` is not ``icl``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell: dict, seed: int, seconds: float, trace: bool,
            device, t_process: float, control: bool = False) -> dict:
    """Drive one run of ``cell``; returns the result line as a dict (no
    device block) and, under ``"_run"``, what the cell's driver returned."""
    import torch

    from portbench.lib import cell as cells

    ctx = {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
           "device": device, "control": control, "work": cells.work(cell),
           "reference": cells.reference(cell)}
    run = cells.driver(cell).run(ctx)
    setup_s = run["t_start"] - t_process
    units = {m["name"]: m["unit"] for m in cell["end_to_end"]
             + cell["per_layer"]}
    metrics = {}
    if trace:
        run["cell"] = cell
        for m in cell["per_layer"]:
            value = cells.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        values = {**run["e2e"], "setup_s": setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    limits = cell["spec"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in run["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics}
    if trace and run.get("trace") is not None:
        out["breakdown"] = {"device_ops": run["trace"].top_ops(),
                            "idle_gaps": run["trace"].idle_gaps()}
        out["_trace"] = {"busy_s": run["trace"].busy_s(),
                         "window_s": run["trace"].window_s}
    out["checks"] = checks
    out["_run"] = run
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench.lib import cell as cells

    cell = cells.load_cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"portbench: cell {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = measure(cell, args.seed, args.seconds, bool(args.trace), device,
                  T_PROCESS)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    run = out.pop("_run")
    traced = out.pop("_trace", None)
    checks = out.pop("checks")
    device_block = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(device),
                    "count": cell["chips"],
                    "memory_peak_bytes": run["memory_peak"]}
    if args.trace:
        device_block.update(traced or {})
    out["device"] = device_block
    if "breakdown" in out:
        out["breakdown"] = out.pop("breakdown")
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
