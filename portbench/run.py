"""Runs one cell of the port's benchmark once and prints its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json at the root of the
checkout. Its configuration file (`configs`), the reference that file
names (`portbench/reference/<reference>.py`), its traffic file
(`portbench/traffic/<traffic>.json`), the traffic's load loop
(`portbench/loops/<loop>.py`) and each of its metrics
(`portbench/metrics/<metric>.py`, the name up to its first dot) are
found by name, so a new cell needs only new files and entries. With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a device trace of the window. `--control` puts the reference, with
TF32 on, in the program's place (the check's control; see check.py).

The last line of standard output is one JSON object; the numbers the
check compared, each with its limit, are the last lines of standard error
and the result's last key. The run exits with another code and prints no
result without the CUDA cards the cell asks for, or if JAX or the JAX
package has been imported.
"""

import time

T0_NS = time.time_ns()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# the checkout's root in place of this script's directory, whose module
# names (devtrace, check, ...) must not shadow others
if sys.path and Path(sys.path[0] or ".").resolve() == PKG:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "ood_gan_inversion_tpu")


def cache_env(root):
    """Every kernel and build cache at a fixed path inside the checkout (the
    port's own nvcc build directory, build/ogi_torch_kernels, is fixed in
    its code and lies there too)."""
    cache = Path(root) / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def load_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name):
    """The reader of a metric: `metrics/<name>.py`, where a name's part
    after its first dot only splits one quantity by the end-to-end metric
    it moves (`mfu_pct.restyle` is read by `metrics/mfu_pct.py`)."""
    base = name.split(".")[0]
    return load_file(PKG / "metrics" / f"{base}.py", f"portbench_metric_{base}")


def loop_module(kind):
    return load_file(PKG / "loops" / f"{kind}.py", f"portbench_loop_{kind}")


def resolve(root, workload):
    """The cell's entry, configuration, traffic and metric lists."""
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {"workload": w,
            "config": json.loads((Path(root) / cfg["file"]).read_text()),
            "traffic": json.loads((PKG / "traffic" / f"{w['traffic']}.json").read_text()),
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


class Run:
    """What a run has made and measured, for the loop and the metrics."""

    def __init__(self, cell, seconds, device):
        self.cell, self.seconds = cell, seconds
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.device = device
        self.t0_ns = T0_NS
        self.calls, self.samples, self.spans, self.events = [], [], [], None
        self.t_start_ns = self.t_end_ns = None
        self.memory_peak_bytes = 0
        self.cache = {}


def build_system(run, weight_seed, control):
    """The system under test with the weights of `weight_seed`, drawn from
    the specs of the configuration's reference (or, for the control, that
    reference itself)."""
    import torch
    if control:
        from portbench.check import ControlSystem
        return ControlSystem(run.config, weight_seed, run.device)
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    from portbench.weights import make_state_dict
    state = make_state_dict(run.config, weight_seed, run.device)
    engine = InversionEngine({"network_g": run.config["network_g"]}, params=state,
                             device=run.device, **run.config.get("engine", {}))
    del state
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return engine


def run_cell(cell, seed, seconds, trace, device, control=False, system_hook=None):
    """One run of the cell on `device`; returns the Run. system_hook(system)
    -> system may wrap the system under test (the fault tests)."""
    import torch
    from portbench import check, devtrace, loadgen

    run = Run(cell, seconds, torch.device(device))
    marks = [("imports", devtrace.now_ns())]
    weight_seed, pool_seed, request_seed, sample_seed = loadgen.child_seeds(seed)
    run.sample_seed = sample_seed
    system = build_system(run, weight_seed, control)
    run.system = system_hook(system) if system_hook else system
    marks.append(("weights and engine", devtrace.now_ns()))
    run.pool = loadgen.image_pool(pool_seed, run.traffic, run.device)
    run.requests = loadgen.Requests(request_seed, run.traffic)
    marks.append(("image pool", devtrace.now_ns()))
    loop = loop_module(run.traffic["loop"])
    loop.warm_up(run)
    marks.append(("warm-up", devtrace.now_ns()))
    run.setup_parts = [(name, (t - t_prev) / 1e9) for (name, t), t_prev
                       in zip(marks, [run.t0_ns] + [t for _, t in marks])]
    with devtrace.device_trace(run) if trace else contextlib.nullcontext():
        loop.window(run)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    run.system = system = None
    run.check = check.compare(run.samples, run.pool, run.config, weight_seed, run.device)
    run.samples = []
    return run


def verdict(run):
    """(correct, {number: {"value", "limit"}})."""
    limits = run.config["limits"]
    numbers = {k: {"value": v, "limit": limits[k]} for k, v in run.check.items()}
    ok = any(c["counted"] for c in run.calls) and bool(numbers) and all(
        n["value"] <= n["limit"] for n in numbers.values())
    return ok, numbers


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def result(run, trace):
    """The result object of a finished run."""
    import torch
    correct, numbers = verdict(run)
    metrics = {}
    for m in run.cell["per_layer" if trace else "end_to_end"]:
        value = metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
              "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": correct, "attempted": sum(len(c["idx"]) for c in run.calls),
           "failed": 0, "metrics": metrics, "device": device}
    if trace:
        from portbench import devtrace
        w = devtrace.window(run)
        device["busy_s"] = w["busy_ns"] / 1e9
        device["window_s"] = (w["hi"] - w["lo"]) / 1e9
        out["breakdown"] = devtrace.breakdown(run)
        kinds = {}
        for ev in run.events:
            kinds[ev[1]] = kinds.get(ev[1], 0) + 1
        first = min((ev[2] for ev in run.events if ev[2] >= w["lo"]), default=w["lo"])
        print(f"trace: {len(run.events)} device events {kinds}; window {device['window_s']!r} s, "
              f"first activity {(first - w['lo']) / 1e6!r} ms after its start, last copy "
              f"{(run.t_end_ns - w['hi']) / 1e6!r} ms before the last arrival", file=sys.stderr)
    device["power_limit"] = power_limit()
    out["check"] = numbers
    return out


def loop_summary(run):
    """One line on the window's calls: host entry time and the gaps between
    arrivals, ms (min, median, max)."""
    import statistics

    def mmm(xs):
        return [round(min(xs), 3), round(statistics.median(xs), 3), round(max(xs), 3)] if xs else []

    done = [c["t_done"] for c in run.calls if c["counted"]]
    parts = ", ".join(f"{name} {sec:.3f}" for name, sec in getattr(run, "setup_parts", []))
    return (f"setup s: {parts}\n"
            f"loop: {len(run.calls)} calls, {len(done)} counted; entry ms "
            f"{mmm([c['entry_ns'] / 1e6 for c in run.calls])}, arrival gaps ms "
            f"{mmm([(b - a) / 1e6 for a, b in zip(done, done[1:])])}")


def imported_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="the reference with TF32 on in the program's place")
    args = ap.parse_args(argv)
    cache_env(ROOT)
    cell = resolve(ROOT, args.workload)
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                   control=args.control)
    out = result(run, bool(args.trace))
    bad = imported_forbidden()
    if bad:
        print(f"portbench: the run imported {bad}; no result", file=sys.stderr)
        return 3
    print(loop_summary(run), file=sys.stderr)
    for name, n in out["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
