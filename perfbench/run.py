"""Run one cell of the benchmark once, on the card, and print its line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``perfbench/configs/<config>.json``) and a traffic
mix (``perfbench/workloads/<traffic>.json``), which names its generator
(``perfbench/traffic/<generator>.py``) and driver
(``perfbench/drivers/<driver>.py``). The driver sets up the program, warms
the shapes the traffic reaches, runs the window and keeps a sample of what
the window produced; its ``check`` then compares that sample with the
plain reference, each number against its limit in
``perfbench/limits/<cell>.json``. Each metric is read by
``perfbench/metrics/<metric>.py``: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiled stretch of the window.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared and its limit);
the last lines of standard error repeat the checks. Without a CUDA device,
or with fewer than the cell asks for, it exits with code 2 and prints no
line; if ``jax``, ``jaxlib``, ``flax``, ``orbax`` or the JAX package
``iris_tts_tpu`` is loaded once the window has closed, with code 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from functools import cached_property  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
BUILD = ROOT / "build" / "perfbench"
# Fixed cache directories inside the checkout, so only a checkout's first
# run builds or compiles anything.
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")

FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "iris_tts_tpu"}


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run must not hold,
    compared whole (``iris_tts_tpu_torch`` is not ``iris_tts_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r}")


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py``, found by name."""
    return importlib.import_module(f"perfbench.{kind}.{name}")


def cell_parts(bench: dict, cell_name: str, base: Path = HERE) -> dict:
    """Everything a cell resolves to by name, loaded; the data files
    (``configs/``, ``workloads/``, ``limits/``) from under ``base``."""
    from perfbench import weights

    cell = find(bench["workloads"], cell_name, "cell")
    traffic = json.loads((base / "workloads" / f"{cell['traffic']}.json")
                         .read_text())

    def applies(metric):
        return cell_name in metric.get("workloads", [cell_name])

    return {
        "cell": cell,
        "config": weights.load_config(
            cell["config"], base / "configs" / f"{cell['config']}.json"),
        "traffic": traffic,
        "generator": load_module("traffic", traffic["generator"]),
        "driver": load_module("drivers", traffic["driver"]),
        "limits": json.loads((base / "limits" / f"{cell_name}.json")
                             .read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


class Context:
    """What the metric readers read: the run's record (the driver's own
    keys besides the common ones that ``run_cell`` reads), the summary of
    its device trace, the card's peaks, and ``memo`` for quantities that
    several readers derive from the record."""

    def __init__(self, parts: dict, record: dict, kind: str):
        self.parts, self.record, self.kind = parts, record, kind
        self._memo = {}

    def memo(self, key: str, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    @cached_property
    def trace(self):
        from perfbench.devtrace import summarize

        prof = self.record.get("profile")
        return None if prof is None else summarize(prof.events())

    @cached_property
    def peaks(self):
        """The card's peaks; None off the card (no device number then)."""
        from perfbench.cost import PEAKS

        return PEAKS.get(self.kind)


def read_metrics(specs: list, ctx: Context) -> dict:
    out = {}
    for spec in specs:
        value = load_module("metrics", spec["name"]).read(ctx)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi did not run: {e}"


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float = T_START,
             tf32: bool = False, base: Path = HERE) -> dict:
    """One run of a cell on ``device``: ``result`` (the line without its
    device block), the driver's ``record`` and the metrics' context
    ``ctx``. The caller has made sure of the device. ``tf32`` runs the
    control: the timed path with TF32 on.

    The driver's ``run`` sets up, runs the window and returns its record,
    which holds at least ``setup_s``, ``window_s``, ``attempted``,
    ``failed``, ``memory_peak_bytes``, ``profile`` (the profiler of a
    traced run, else None), ``trace_window_s`` and ``summary`` (a line for
    standard error); its ``check(cfg, record, device)`` then returns the
    numbers compared, by the names of the cell's limits."""
    import torch

    parts = cell_parts(bench, cell_name, base)
    cfg, driver = parts["config"], parts["driver"]
    record = driver.run(cfg, parts["traffic"], parts["generator"].Generator,
                        seed, seconds, trace, device, t_start, tf32=tf32)
    numbers = driver.check(cfg, record, device)
    gc.collect()
    checks = {k: {"value": numbers[k], "limit": parts["limits"][k]}
              for k in parts["limits"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    ctx = Context(parts, record, kind)
    metrics = read_metrics(parts["per_layer"] if trace
                           else parts["end_to_end"], ctx)
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics}
    if trace and ctx.trace is not None:
        result["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                               "idle_gaps": ctx.trace["idle_gaps"]}
    result["checks"] = checks
    return {"result": result, "record": record, "ctx": ctx}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = benchmark()
    cell = find(bench["workloads"], args.workload, "cell")
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    from perfbench.cost import PEAKS

    print(f"perfbench: card {card_line()}; peaks "
          f"{PEAKS.get(torch.cuda.get_device_name(device))}", file=sys.stderr)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), device)
    result, record = out["result"], out["record"]

    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded after the window: {bad}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"],
                   "memory_peak_bytes": int(record["memory_peak_bytes"])}
    if args.trace:
        trace = out["ctx"].trace
        device_info["busy_s"] = trace["busy_us"] * 1e-6 if trace else 0.0
        device_info["window_s"] = record["trace_window_s"]
    checks = result.pop("checks")
    result["device"] = device_info
    result["checks"] = checks
    print(f"perfbench: {record['summary']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
