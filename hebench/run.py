"""Run one benchmark cell once and print its result line.

    python3 hebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell is looked up in BENCHMARK.json; its
configuration (`configs/<config>.json`), traffic (`traffic/<traffic>.json`),
op (`ops/<op>.py`, the op the configuration names), work count
(`work/<op>.py`) and per-layer metric readers (`metrics/<metric>.py`) are
found by name under this directory.  Set-up (imports, the CUDA context, the
kernels' builds or their cached libraries, inputs from the seed, warm-up)
runs first; then the window; then the kept answers are compared with the
plain reference (`reference/`), once the program's state is freed.  The
last line of standard output is one JSON object (the result); the numbers
compared, each beside its limit, are the last lines of standard error.
Exits 1 without a result when no CUDA device (or too few) is visible, and
when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "hexl_fpga_tpu")
PACKAGE = "hexl_fpga_tpu_torch"
# knobs of the port that a cell sets itself or leaves at their defaults
PORT_KNOBS = ("RUN_CHOICE", "NUM_DEV", "FPGA_DEBUG", "HEXL_TPU_PROFILE",
              "HEXL_TPU_WIRE_PACK", "BATCH_SIZE_KEYSWITCH",
              "BATCH_SIZE_DYADIC_MULTIPLY", "BATCH_SIZE_NTT", "BATCH_SIZE_INTT")


def load(kind: str, name: str):
    """The module hebench/<kind>/<name>.py."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"hebench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def _cell(spec: dict, name: str):
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"hebench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    files = {c["name"]: c["file"] for c in spec["configs"]}
    with open(os.path.join(ROOT, files[cell["config"]])) as f:
        cfg = json.load(f)
    return cell, cfg, read_json("traffic", cell["traffic"])


def _in(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


class Reading:
    """What a per-layer metric reader may read: the window, the trace's
    summary, the work the traced part did and the card's peaks."""

    def __init__(self, cfg, traffic, win, summary, work, peak):
        self.op, self.cfg, self.traffic = cfg["op"], cfg, traffic
        self.win, self.trace, self.peak = win, summary, peak
        ops, batches = win.traced_ops, win.traced_batches
        per_op, per_batch = work.per_op(cfg), work.per_batch(cfg)
        self.work = {k: ops * per_op[k] + batches * per_batch[k]
                     for k in ("imad32", "bytes")}

    def roofline(self, op: str):
        """Percent: the least time the card could take for the traced
        part's work of `op`, over the kernels' device time."""
        if self.op != op or not self.peak or not self.trace.kernel_s:
            return None
        least = max(self.work["imad32"] / self.peak["imad32_per_s"],
                    self.work["bytes"] / self.peak["bytes_per_s"])
        return 100.0 * least / self.trace.kernel_s


def _peak(kind: str):
    with open(os.path.join(HERE, "peaks.json")) as f:
        peaks = json.load(f)
    for prefix, peak in peaks.items():
        if kind.startswith(prefix):
            return peak
    return None


def main(argv=None, spec: dict | None = None, rehearse: bool = False,
         out=None, err=None, overrides: dict | None = None) -> int:
    """One run.  For the tests: `rehearse` runs the cell on the CPU through
    the kernels' plain versions (RUN_CHOICE=1), so no number it prints is a
    device number; `overrides` replace keys of the traffic mix."""
    out, err = out or sys.stdout, err or sys.stderr
    ap = argparse.ArgumentParser(prog="hebench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if spec is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            spec = json.load(f)
    cell, cfg, traffic = _cell(spec, args.workload)
    traffic.update(overrides or {})

    for k in PORT_KNOBS:
        os.environ.pop(k, None)
    os.environ["RUN_CHOICE"] = "1" if rehearse else "2"
    os.environ.update({k: str(v) for k, v in traffic.get("env", {}).items()})
    # a library that would load JAX by itself must not
    os.environ.setdefault("USE_FLAX", "0")

    import numpy as np
    import torch

    from hebench import devtrace, driver

    if rehearse:
        device = torch.device("cpu")
    elif not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"hebench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "visible", file=err)
        return 1
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)

    op = load("ops", cfg["op"])
    os.environ[op.BATCH_ENV] = str(traffic["batch"])
    w = op.Workload(cfg, int(traffic["pool"]), args.seed, device)
    run = driver.PATTERNS[traffic["pattern"]](w, traffic, args.seed)
    run.setup(device)
    tracer = driver.Tracer(bool(args.trace), float(traffic["trace_seconds"]),
                           device.type == "cuda")
    setup_s = time.perf_counter() - T_START
    win = run.window(args.seconds, tracer)
    peak_bytes = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    run.close()
    t_parse = time.perf_counter()
    events = tracer.events()
    parse_s = time.perf_counter() - t_parse
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the kept answers against the plain reference
    t_check = time.perf_counter()
    found = driver.compare(w, win.kept, w.reference("exact", device))
    check_s = time.perf_counter() - t_check
    compared = {
        "mismatched_words": {"value": found["mismatched_words"], "max": 0},
        "ops_checked": {"value": found["ops_checked"], "min": 1},
        "failed_ops": {"value": win.failed, "max": 0},
    }
    correct = (found["mismatched_words"] == 0 and found["ops_checked"] >= 1
               and win.failed == 0)

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = {"correct": correct, "attempted": win.ops, "failed": win.failed}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": 1 if device.type == "cuda" else 0,
           "memory_peak_bytes": int(peak_bytes)}
    metrics = {}
    if args.trace:
        summary = devtrace.summarize(
            events, devtrace.hand_written_kernels(os.path.join(ROOT, PACKAGE)),
            rehearse)
        reading = Reading(cfg, traffic, win, summary, load("work", cfg["op"]),
                          _peak(kind))
        for m in spec["per_layer"]:
            if _in(m, cell["name"]):
                value = load("metrics", m["name"]).read(reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = summary.breakdown()
    else:
        values = {"setup_s": setup_s}
        if traffic["pattern"] == "api_rounds":
            values["api_ops_per_s"] = win.ops / win.seconds
        else:
            values["device_ops_per_s"] = win.ops / win.seconds
        for m in spec["end_to_end"]:
            if _in(m, cell["name"]) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["metrics"], result["device"] = metrics, dev
    result["compared"] = compared

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"hebench: loaded {', '.join(loaded)}: the port must run without "
              "JAX and the JAX package", file=err)
        return 1
    if win.error:
        print(f"hebench: the program raised {win.error}", file=err)
    print(f"hebench: setup {setup_s:.3f} s, window {win.seconds:.3f} s, "
          f"{win.ops} ops, profiler stop {getattr(tracer, 'stop_s', 0):.3f} s "
          f"and read {parse_s:.3f} s, check {check_s:.3f} s", file=err)
    if win.round_s:
        q = np.percentile(win.round_s, [0, 25, 50, 75, 100]) * 1e3
        print("hebench: round ms min/q1/median/q3/max "
              + " ".join(f"{v:.2f}" for v in q), file=err)
    for name, c in compared.items():
        limit = " ".join(f"{k} {v}" for k, v in c.items() if k != "value")
        print(f"hebench compared: {name} {c['value']} ({limit})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
