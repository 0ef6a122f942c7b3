"""Run one cell of the benchmark of ``norma_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration file, its
traffic mix and its metrics come from ``BENCHMARK.json``: the cell names a
configuration (``configs[].file``) and a traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``kind`` names the driver,
``benchmark/harness/<kind>.py``); the limits of its check come from
``benchmark/limits/<config>.json``; each per-layer metric is read by
``benchmark/metrics/<name>.py``.  A run builds the kernels (kept under
``build/`` in the checkout), draws the weights on the card from the seed,
warms up the cell's shapes, measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints one JSON
line last on standard output.  ``--trace 1`` reports the per-layer
metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "norma_tpu")


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so a
    cell's later runs there find what its first run built (the program
    keeps its own kernels in ``build/norma_tpu_torch/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(root, "build", "benchmark", sub)


def load_spec(root: str, workload: str) -> dict:
    """The cell's entry, configuration, traffic mix, the limits of its
    check (``benchmark/limits/<config>.json``) and its metric entries."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    with open(os.path.join(root, "benchmark", "limits", cell["config"] + ".json")) as f:
        limits = json.load(f)
    mine = lambda m: cell["name"] in m.get("workloads", [cell["name"]])
    return dict(cell=cell, cfg=cfg, mix=mix, limits=limits, chips=cell["chips"],
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load, compared whole (``norma_tpu_torch`` is not ``norma_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """One run's state, filled by the traffic kind's driver."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float):
        self.cell, self.cfg, self.mix = spec["cell"], spec["cfg"], spec["mix"]
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.t_start = t_start
        self.setup_s = None
        self.peak_bytes = self.window_peak_bytes = 0
        self.e2e: dict = {}
        self.data: dict = {}
        self.extra: dict = {}
        self.checks: dict = {}  # name -> (value, limit)
        self.samples: list = []  # (audio row, served tokens) for the reference
        self.attempted = self.failed = 0

    def setup_done(self) -> None:
        if self.setup_s is None:
            self.setup_s = time.perf_counter() - self.t_start

    def set_memory(self, setup_peak: int, window_peak: int) -> None:
        """The allocator's peaks over set-up and over the serving window:
        the run's peak is the larger, ``peak_mem_gib`` the window's."""
        self.peak_bytes, self.window_peak_bytes = max(setup_peak, window_peak), window_peak

    def free(self) -> None:
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def reader(name: str):
    """The per-layer metric's reader, ``benchmark/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_workload(spec: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    """Drive the cell once and return its result line (a dict)."""
    import torch

    from benchmark.harness import check

    driver = importlib.import_module(f"benchmark.harness.{spec['mix']['kind']}")
    run = Run(spec, seed, seconds, trace, torch.device(device), T_START)
    driver.drive(run)

    limits = spec["limits"]
    c = check.compare(run.cfg, seed, run.device, run.samples, limits["token_gap"])
    checks = dict(run.checks)
    checks["rows_short"] = (max(0, run.mix["check_rows"] - c["rows"]), 0)
    checks["token_gap"] = (c["token_gap"], limits["token_gap"])
    checks["grammar_breaks"] = (c["grammar_breaks"], 0)
    run.extra["judged_tokens"] = c["judged"]
    run.extra["exact_tokens"] = c["exact"]
    correct = all(v <= lim for v, lim in checks.values())

    values = dict(run.e2e, setup_s=run.setup_s, peak_mem_gib=run.window_peak_bytes / 2**30)
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        v = reader(m["name"])(run) if trace else values.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
           "count": spec["chips"], "memory_peak_bytes": int(run.peak_bytes)}
    line = {"correct": bool(correct), "attempted": int(run.attempted), "failed": int(run.failed),
            "metrics": metrics, "device": dev}
    tr = run.data.get("trace")
    if tr is not None:
        lo, hi = tr.window
        dev["busy_s"] = tr.busy_union_us(lo, hi) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        line["breakdown"] = {"device_ops": tr.top_kernels(10), "idle_gaps": tr.idle_by_host(10)}
    line.update(run.extra)
    line["checks"] = {k: {"value": float(v), "limit": float(lim)} for k, (v, lim) in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    # The package's root, not this script's folder, leads the import path.
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    spec = load_spec(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"needs {spec['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        line = run_workload(spec, args.seed, args.seconds, bool(args.trace), "cuda:0")
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark must not load: {found}", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
