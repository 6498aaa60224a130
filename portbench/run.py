"""One run of one benchmark cell: the port's training step at published widths.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run, in one process:

1. **Set-up** (``setup_s``: from the process's start to the first timed
   step). Builds the port's step from the cell (``portbench/program.py``),
   makes the weights and a pool of token batches on the card from the seed
   (``portbench/weights.py``), then drives that same step through the
   compared steps, on batches that all differ, reading after the first
   the first moment of every leaf and after the last every leaf's change
   from its initial weights. These steps also warm every shape the window
   uses. The first run in a checkout also builds the port's CUDA kernels
   (``build/kernels/``, inside the checkout); its first step's time says
   how long that took.
2. **The window.** Steps back to back, eager, as a user of the step calls
   it, for ``--seconds`` of host time, each step's boundaries marked by
   CUDA events on the stream (the host waits for the step two back before
   it issues the next), then a synchronize. ``tokens_per_s`` is every
   token of the window's steps over its wall time; ``step_ms_p90`` the 90th
   percentile of every step interval between boundary events.
3. With ``--trace 1``, a few more steps under ``torch.profiler``
   (``portbench/trace.py``) for the per-layer metrics.
4. **Correctness**, once the window has closed, the peak has been read and
   the program's state is freed: the plain reference (``portbench/
   reference.py``) follows the compared steps from the same weights and
   batches, and ``portbench/compare.py`` holds the program's readings to
   the cell's limits.

The last line on standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines on standard
error. A run exits 2 with no result when it finds no card, and 3 when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_STARTED = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

_TORCH_IMPORTED = time.monotonic()

from portbench import compare, manifest, program, reference, weights  # noqa: E402
from portbench import trace as tracing  # noqa: E402
from portbench.weights import Model, get_path  # noqa: E402

#: steps the reference follows and compares
COMPARED_STEPS = 3
#: steps under the profiler in a traced run
PROFILED_STEPS = 3
#: the linear layers' arithmetic in the reference, by the cell's ``linear``
LEVELS = {"bf16": None, "int8": 127}
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "simumax_tpu")
#: the port's kernel-build directory, fixed inside the checkout (the port
#: keeps no other build or kernel cache)
CACHE_DIRS = {"SIMUMAX_TPU_TORCH_BUILD_DIR": os.path.join("build", "kernels")}
TRACE_DIR = os.path.join(ROOT, "build", "portbench_traces")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``simumax_tpu_torch`` is not ``simumax_tpu``)."""
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


def card_readout() -> str:
    """The card's name, power limit, clocks, draw and temperature from
    ``nvidia-smi``."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return f"{query}: {out.stdout.strip()}"


class Marks:
    """Step boundaries: CUDA events on the stream on the card, the host
    clock elsewhere (the CPU runs only in tests)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def wait(self, i: int) -> None:
        if self.cuda:
            self.marks[i].synchronize()

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def setup_program(m: Model, cell: Dict, opt: Dict, seed: int, device, batches,
                  wrap_step: Optional[Callable] = None, phases: Optional[Dict] = None):
    """The port's step and its state, driven from the seed's weights
    through the compared steps: (step, params, opt_state, readings), the
    readings {"loss", "grad1", "change"} as :func:`compare.numbers` takes
    them (the first gradient from the first moment after one step). The
    seconds of each part go into ``phases`` where it is given."""
    phases = {} if phases is None else phases
    t = time.perf_counter()
    init_opt, step = program.build(m, cell, opt)
    if wrap_step is not None:
        step = wrap_step(step)
    phases["the port's import"] = time.perf_counter() - t
    t = time.perf_counter()
    params = weights.make_params(m, seed, device)
    opt_state = init_opt(params)
    sync(torch.device(device))
    phases["weights and moments"] = time.perf_counter() - t
    losses, grad1 = [], {}
    for i in range(COMPARED_STEPS):
        t = time.perf_counter()
        _p, _o, loss = step(params, opt_state, batches[i])
        losses.append(loss)
        if i == 0:
            with torch.no_grad():
                grad1 = {path: float(torch.linalg.vector_norm(get_path(opt_state["mu"], path)))
                         / (1.0 - opt["b1"]) for path in weights.paths(m)}
            phases["first step, with any kernel build"] = time.perf_counter() - t
    t = time.perf_counter()
    readings = {"loss": [float(x) for x in losses], "grad1": grad1,
                "change": weights.change_norms(m, seed, params, device)}
    phases["steps 2-3 and the change"] = time.perf_counter() - t
    return step, params, opt_state, readings


def timed_window(step, params, opt_state, batches, first: int, seconds: float, device):
    """Steps back to back for ``seconds`` of host time: (wall seconds,
    step intervals in ms, the steps' losses)."""
    marks = Marks(device)
    losses = []
    sync(device)
    t0 = time.perf_counter()
    marks.mark()
    i = 0
    while True:
        if i >= 2:
            marks.wait(i - 1)  # the step two back has finished
        _p, _o, loss = step(params, opt_state, batches[(first + i) % len(batches)])
        marks.mark()
        losses.append(loss.detach())
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return time.perf_counter() - t0, marks.intervals_ms(), losses


def profiled_steps(step, params, opt_state, batches, first: int, workload: str, device) -> Dict:
    """:data:`PROFILED_STEPS` steps under ``torch.profiler``, read by
    :func:`trace.read_window`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tracing.open_window(device)
        for i in range(PROFILED_STEPS):
            step(params, opt_state, batches[(first + i) % len(batches)])
        tracing.close_window()
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, f"{workload}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    return tracing.read_window(events, PROFILED_STEPS)


def card_start(device: torch.device) -> None:
    """Start the card's context (the first call on it), so that its cost
    is timed apart from what follows."""
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()


def record_of(spec: manifest.Spec, m: Model, wall_s: float, intervals: List[float],
              setup_s: float, peak_alloc_bytes: int, traced: Optional[Dict]) -> Dict:
    """What every metric reader reads: the window's steps and times, the
    set-up, the peak, the traced steps' families, and the run's shapes
    (the model's sizes, the cell's batch, sequence and linear type, and
    the cell and configuration files whole), from which a reader counts
    the work it holds a time against."""
    mbs, seq = int(spec.cell["mbs"]), int(spec.cell["seq"])
    return {"steps": len(intervals), "tokens_per_step": mbs * seq, "window_s": wall_s,
            "intervals_ms": intervals, "setup_s": setup_s, "peak_alloc_bytes": peak_alloc_bytes,
            "traced": traced, "model": m, "mbs": mbs, "seq": seq, "linear": spec.cell["linear"],
            "cell": spec.cell, "config": spec.config}


def run_cell(spec: manifest.Spec, seed: int, seconds: float, trace: bool, device="cuda",
             wrap_step: Optional[Callable] = None) -> Dict:
    """One run of ``spec``'s cell; returns the result object. On the CPU
    (the tests' tiny runs) nothing is traced and no memory is read."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    cell, config = spec.cell, spec.config
    m = Model.from_config(config)
    opt = config["optimizer"]
    mbs, seq = int(cell["mbs"]), int(cell["seq"])
    phases = {"import torch": _TORCH_IMPORTED - _STARTED,
              "the harness's import, its files and the card count":
                  time.monotonic() - _TORCH_IMPORTED}
    t = time.perf_counter()
    card_start(device)
    phases["card start"] = time.perf_counter() - t
    t = time.perf_counter()
    batches = weights.make_batches(seed, int(cell["batches"]), mbs, seq, m.vocab, device)
    sync(device)
    phases["batches"] = time.perf_counter() - t
    step, params, opt_state, prog = setup_program(m, cell, opt, seed, device, batches, wrap_step,
                                                  phases)
    sync(device)
    setup_s = time.monotonic() - _STARTED
    log("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        log(card_readout())
        torch.cuda.reset_peak_memory_stats()
    wall_s, intervals, losses = timed_window(step, params, opt_state, batches, COMPARED_STEPS,
                                             seconds, device)
    peak_window = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"window: {len(intervals)} steps in {wall_s:.3f} s; first step intervals ms "
        + ", ".join(f"{x:.3f}" for x in intervals[:4]))
    traced = None
    if trace and on_card:
        traced = profiled_steps(step, params, opt_state, batches,
                                COMPARED_STEPS + len(intervals), spec.workload, device)
        log("device ms a step by family: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(traced.get("family_ms", {}).items())))
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    memory_peak = max(peak_setup, torch.cuda.max_memory_allocated() if on_card else 0)
    del step, params, opt_state, losses
    gc.collect()
    if on_card:
        log(card_readout())
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = reference.follow(m, opt, seed, batches[:COMPARED_STEPS], COMPARED_STEPS,
                           LEVELS[cell["linear"]], device)
    found = compare.numbers(prog, ref)
    correct, compared = compare.judge(found, cell["limits"])
    log(f"reference: {time.perf_counter() - t:.3f} s; losses program "
        f"{prog['loss']} reference {ref['loss']}; worst leaves: grad1 "
        f"{found['grad1_gap']['leaf']}, change {found['change_gap']['leaf']}")

    record = record_of(spec, m, wall_s, intervals, setup_s, peak_window, traced)
    readers = spec.per_layer if trace else spec.end_to_end
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": spec.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct and failed == 0), "attempted": len(intervals),
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": [list(kv) for kv in traced["device_ops"]],
                               "idle_gaps": traced["idle_gaps"]}
    result["compared"] = {name: {k: v if math.isfinite(v) else None for k, v in c.items()}
                          for name, c in compared.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, rel)
    spec = manifest.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        log(f"portbench: needs {spec.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log("portbench: JAX or the JAX package was loaded: " + ", ".join(found))
        return 3
    for name, c in result["compared"].items():
        log(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
