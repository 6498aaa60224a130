"""The port's command line (``simumax_tpu_torch/cli.py``) held against the
JAX package's (``simumax_tpu/cli.py``) on the CPU.

Each parity case runs the same arguments through ``simumax_tpu.cli.main``
and through ``simumax_tpu_torch.cli.main`` with ``--device cpu`` (the
kernels' plain versions), each side in its own directory and with its own
planner cache, on the JAX package's TPU configs, and compares the exit
code, stdout and stderr, and the artifacts the command wrote
(``--json``, ``--csv``, ``--save``, ``--diagnostics``, traces). Before
the comparison the program's name is normalised (``simumax_tpu_torch``
-> ``simumax_tpu``), each side's directory is written ``<D>``, and the
run-scoped ids (a diagnostics report's reporter-coined ``run_id``, a
trace's ids, a log line's timestamp) are dropped. The cases mirror every
JAX test that drives the CLI: ``test_fault_isolation.py``
(``TestCLIErrorSurface``), ``test_critpath.py`` (``TestCli``),
``test_memledger.py`` (``TestExplainMemoryCli``), ``test_observability.py``
(``TestExplainCli``), ``test_service_server.py`` (its CLI cases),
``test_fleet.py`` (``test_cli_fleet``; the shared-against-naive walk its
``bench_fleet.py`` smoke gates, through ``fleet --naive``),
``test_fleetledger.py`` (its CLI cases), ``test_faults.py`` (its CLI
cases), ``test_surfaces.py`` (``TestCLI`` in subprocesses, and
``test_cli_dualpp``), ``test_telemetry.py``
(``test_cli_trace_requests_artifacts``) and ``test_service_chaos.py``
(``test_serve_nodes_sigterm_reaps_whole_fleet``). Where a JAX test
checks a property of one run (a run id joining log lines, a cache that
hits, an exit code), the port's run is checked for it as well.

Backends: the JAX package runs its scalar replay engine and its numpy
fold (``jax_available`` patched to False in both: its jitted programs
need ``jax.experimental.enable_x64``, which this jax lacks, and the JAX
package pins its numpy paths to them); so its ``/v1/faults`` and
``faults --monte-carlo`` are the oracle the port's plain replay is held
to, as the port's server tests do for ``test_faults_endpoint_seeded``.

Then the port alone: ``--device cuda`` without a card stops each of the
seven subcommands that take it with one ``error:`` line and exit code 1;
``calibrate`` refuses the CPU the same way; ``calibrate --collectives``
with the device-count helper set to 2 under ``--device cpu`` spawns two
gloo ranks and writes the fitted op table into the saved system (the
card-only measurements of ``calibrate_system`` stood in for: they refuse
the CPU); ``search --jobs`` takes its default from the engine and the
device; ``python -m simumax_tpu_torch --help`` lists the JAX CLI's 13
subcommands; ``serve`` answers over HTTP as a subprocess, and ``serve
--nodes 2`` is reaped whole by SIGTERM.

Tolerance: ``==`` on text, on canonical JSON and on CSV: the two
packages run the same float64 arithmetic in the same order.
"""

import csv
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from simumax_tpu import cli as jax_cli  # noqa: E402
from simumax_tpu.core.errors import SimulationError as JaxSimulationError  # noqa: E402
from simumax_tpu.observe.report import configure_reporter as jax_configure_reporter  # noqa: E402
from simumax_tpu.search import batched as jax_batched  # noqa: E402
from simumax_tpu.service.planner import Planner as JaxPlanner  # noqa: E402
from simumax_tpu.service.server import response_bytes as jax_response_bytes  # noqa: E402
from simumax_tpu.simulator import batched_replay as jax_replay  # noqa: E402
from simumax_tpu.simulator import runner as jax_runner  # noqa: E402
from simumax_tpu.simulator.faults import FaultScenario as JaxFaultScenario  # noqa: E402
from simumax_tpu_torch import cli  # noqa: E402
from simumax_tpu_torch.core.config import get_system_config  # noqa: E402
from simumax_tpu_torch.core.errors import SimulationError  # noqa: E402
from simumax_tpu_torch.observe.ledger import Ledger  # noqa: E402
from simumax_tpu_torch.observe.memledger import MemoryLedger  # noqa: E402
from simumax_tpu_torch.observe.report import configure_reporter  # noqa: E402
from simumax_tpu_torch.observe.telemetry import get_tracer  # noqa: E402
from simumax_tpu_torch.service.planner import Planner  # noqa: E402
from simumax_tpu_torch.simulator import runner as port_runner  # noqa: E402

from test_fleet import base_trace, churn_trace  # noqa: E402
from test_fleetledger import explained as jax_explained  # noqa: E402
from test_trace_validity import check_chrome_trace  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model", "llama2-tiny", "--strategy", "tp1_pp2_dp4_mbs1",
        "--system", "tpu_v5e_256"]
TINY_DP8 = ["--model", "llama2-tiny", "--strategy", "tp1_pp1_dp8_mbs1",
            "--system", "tpu_v5e_256"]
#: the JAX server tests' configuration
L8B = ["--model", "llama3-8b", "--strategy", "tp1_pp2_dp4_mbs1",
       "--system", "tpu_v5e_256"]
#: the subcommands whose work can reach the card, with the least
#: arguments each needs
DEVICE_COMMANDS = {
    "perf": TINY,
    "explain": TINY,
    "search": ["--model", "llama2-tiny", "--system", "tpu_v5e_256", "--gbs", "8"],
    "calibrate": TINY,
    "faults": TINY + ["--monte-carlo", "2"],
    "fleet": ["--trace", "trace.json"],
    "serve": ["--port", "0"],
}
#: keys whose values are coined per run (ids, clocks), dropped before a
#: comparison
RUN_SCOPED = {"run_id", "trace_id", "span_id", "parent_id", "ts", "created",
              "elapsed_s", "wall_s", "duration_ms", "start_ns", "end_ns"}


@pytest.fixture(autouse=True)
def _oracles_and_reporters(monkeypatch):
    monkeypatch.setattr(jax_replay, "jax_available", lambda: False)
    monkeypatch.setattr(jax_batched, "jax_available", lambda: False)
    yield
    # the reporters are process-global: the human default for the rest
    jax_configure_reporter(level="info", json_lines=False, run_id="")
    configure_reporter(level="info", json_lines=False, run_id="")


def _call(main, argv, capsys):
    """``main(argv)``: (exit code, stdout, stderr); a ``SystemExit``'s
    code as it is (the JAX CLI exits with a message for some usage
    errors), a return value of None as 0."""
    try:
        rc = main(argv)
    except SystemExit as exc:
        rc = exc.code
    out, err = capsys.readouterr()
    return (rc or 0), out, err


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in RUN_SCOPED}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


#: run-scoped ids in report lines: a cache key (it names the trace's
#: path, which differs by side), a telemetry trace id
RUN_SCOPED_TEXT = re.compile(r"(\[cache (?:hit|miss)\] |\(trace )[0-9a-f]{16}")


def _norm(text, d):
    """Lines of ``text`` with the program's name, the side's directory
    and the run-scoped ids normalised."""
    text = str(text).replace("simumax_tpu_torch", "simumax_tpu").replace(str(d), "<D>")
    text = RUN_SCOPED_TEXT.sub(r"\1<id>", text)
    lines = []
    for line in text.splitlines():
        if line.startswith("[diagnostics] {"):
            line = "[diagnostics] " + json.dumps(_scrub(json.loads(line[14:])),
                                                 sort_keys=True)
        elif line.startswith("{"):
            line = json.dumps(_scrub(json.loads(line)), sort_keys=True)
        lines.append(line)
    return lines


def _artifact(path, d):
    if path.suffix == ".json":
        text = path.read_text().replace("simumax_tpu_torch", "simumax_tpu")
        return _scrub(json.loads(text.replace(str(d), "<D>")))
    text = path.read_text().replace(str(d), "<D>")
    if path.suffix == ".csv":
        return list(csv.reader(text.splitlines()))
    return text.replace("simumax_tpu_torch", "simumax_tpu")


def both(argv_of, capsys, monkeypatch, tmp_path, device=True, artifacts=(),
         prepare=None):
    """Run ``argv_of(d)`` through the JAX CLI and the port's (with
    ``--device cpu`` where ``device``), each in its own directory ``d``
    with its own planner cache; assert equal exit codes, output and
    artifacts (paths relative to ``d``). Returns {side: (rc, out, err,
    d)} before normalisation."""
    runs, seen = {}, {}
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.setenv("SIMUMAX_TPU_CACHE_DIR", str(d / "cache"))
        if prepare:
            prepare(d)
        argv = list(argv_of(d)) + (["--device", "cpu"] if device and side == "port" else [])
        rc, out, err = _call(main, argv, capsys)
        runs[side] = (rc, out, err, d)
        seen[side] = (_norm(rc, d), _norm(out, d), _norm(err, d),
                      {a: _artifact(d / a, d) for a in artifacts})
    jax_side, port_side = seen["jax"], seen["port"]
    for i, what in enumerate(("exit code", "stdout", "stderr")):
        assert port_side[i] == jax_side[i], what
    for a in artifacts:
        assert port_side[3][a] == jax_side[3][a], a
    return runs


def _fleet_trace(d, trace=None):
    (d / "trace.json").write_text(json.dumps(trace or base_trace()))


def _scenario(d):
    JaxFaultScenario([], horizon_steps=6, checkpoint={
        "interval_steps": 2, "restart_overhead_s": 7.0}).save(str(d / "sc.json"))


# -- parity cases: one test each ----------------------------------------------

#: id -> (argv of the side's directory, artifacts, takes --device, prepare)
PARITY = {
    # test_surfaces.py TestCLI
    # test_fault_isolation.py TestCLIErrorSurface
    "unknown-config-exits-2": (
        lambda d: ["perf", "--model", "no-such-model", "--strategy", "tp1_pp2_dp4_mbs1",
                   "--system", "tpu_v5e_256"], (), True, None),
    "perf-diagnostics-json": (
        lambda d: ["perf", *TINY, "--diagnostics", str(d / "diag.json")],
        ("diag.json",), True, None),
    "report-emitted-when-command-aborts": (
        lambda d: ["perf", "--model", "no-such-model", "--strategy", "tp1_pp2_dp4_mbs1",
                   "--system", "tpu_v5e_256", "--diagnostics", str(d / "diag.json")],
        ("diag.json",), True, None),
    "strict-exits-3": (lambda d: ["perf", *TINY, "--strict"], (), True, None),
    # test_surfaces.py TestCLI: perf with --save and --simulate
    "perf-save-simulate": (
        lambda d: ["perf", *TINY, "--save", str(d / "save"), "--simulate", str(d / "sim")],
        (), True, None),
    # test_critpath.py TestCli
    "critical-path": (
        lambda d: ["critical-path", *TINY, "--granularity", "chunk",
                   "--json", str(d / "cp.json")], ("cp.json",), False, None),
    "perf-simulate-critical-path": (
        lambda d: ["perf", *TINY, "--simulate", str(d), "--critical-path"],
        ("critpath.json",), True, None),
    "diff-memory-and-critical-path-exclusive": (
        lambda d: ["diff", "--memory", "--critical-path", "a", "b"], (), False, None),
    # test_memledger.py TestExplainMemoryCli
    "explain-memory": (
        lambda d: ["explain", *TINY, "--memory", "--top", "3", "--json", str(d / "mem.json"),
                   "--csv", str(d / "holders.csv"), "--mem-artifacts", str(d / "art")],
        ("mem.json", "holders.csv"), True, None),
    "explain-memory-oom-forensics": (
        lambda d: ["explain", *L8B, "--memory", "--top", "2"], (), True, None),
    "crosscheck-requires-memory": (
        lambda d: ["explain", *TINY_DP8, "--crosscheck"], (), True, None),
    # test_observability.py TestExplainCli
    "explain-waterfall-and-artifacts": (
        lambda d: ["explain", *TINY, "--top", "3", "--json", str(d / "led.json"),
                   "--csv", str(d / "ops.csv"), "--trace", str(d / "trace.json")],
        ("led.json", "ops.csv", "trace.json"), True, None),
    "explain-sum-row": (lambda d: ["explain", *TINY_DP8], (), True, None),
    "diff-rejects-non-ledger": (
        lambda d: ["diff", str(d / "bad.json"), str(d / "bad.json")], (), False,
        lambda d: (d / "bad.json").write_text("{}")),
    # test_faults.py
    "faults-flags-beat-scenario-checkpoint": (
        lambda d: ["faults", *TINY, "--scenario", str(d / "sc.json"), "--ckpt-interval", "3",
                   "--json", str(d / "report.json")], ("report.json",), True, _scenario),
    "faults-monte-carlo-exact": (
        lambda d: ["faults", *TINY, "--monte-carlo", "2", "--horizon", "4", "--exact",
                   "--json", str(d / "mc.json")], ("mc.json",), True, None),
    "faults-monte-carlo-incremental": (
        lambda d: ["faults", *TINY, "--monte-carlo", "2", "--horizon", "4",
                   "--json", str(d / "mc.json")], ("mc.json",), True, None),
    "faults-jobs-0-refused": (
        lambda d: ["faults", *TINY, "--monte-carlo", "2", "--horizon", "4", "--jobs", "0"],
        (), True, None),
    "faults-needs-scenario-or-monte-carlo": (lambda d: ["faults", *TINY], (), True, None),
    # test_fleet.py, test_fleetledger.py
    "fleet": (
        lambda d: ["fleet", "--trace", str(d / "trace.json"), "--no-cache",
                   "--json", str(d / "report.json")], ("report.json",), True, _fleet_trace),
    "fleet-explain-chrome-trace": (
        lambda d: ["fleet", "--trace", str(d / "trace.json"), "--no-cache",
                   "--chrome-trace", str(d / "chrome.json")], ("chrome.json",), True,
        lambda d: _fleet_trace(d, churn_trace())),
    "fleet-planner": (
        lambda d: ["fleet", "--trace", str(d / "trace.json"), "--json", str(d / "report.json")],
        ("report.json",), True, _fleet_trace),
    # test_surfaces.py TestCLI and test_cli_dualpp
    "search": (
        lambda d: ["search", "--model", "llama2-tiny", "--system", "tpu_v5e_256", "--world", "8",
                   "--gbs", "8", "--tp", "1,2", "--pp", "1", "--topk", "2",
                   "--csv", str(d / "sweep.csv")], ("sweep.csv",), True, None),
    "search-batched-guided": (
        lambda d: ["search", "--model", "llama3-8b", "--system", "tpu_v5p_256", "--world", "32",
                   "--gbs", "32", "--tp", "1,2,4", "--pp", "1,2,4", "--zero", "0,1",
                   "--engine", "batched", "--guided", "--jobs", "1",
                   "--csv", str(d / "sweep.csv")], ("sweep.csv",), True, None),
    "search-bad-zero": (
        lambda d: ["search", "--model", "llama2-tiny", "--system", "tpu_v5e_256", "--gbs", "8",
                   "--zero", "5"], (), True, None),
    "dualpp": (
        lambda d: ["dualpp", "--model", "llama3-8b", "--strategy", "tp1_pp2_dp4_mbs1",
                   "--system", "tpu_v5p_256"], (), False, None),
    "dualpp-odd-pp": (
        lambda d: ["dualpp", "--model", "llama3-8b", "--strategy", "tp2_pp1_dp4_mbs1",
                   "--system", "tpu_v5p_256"], (), False, None),
    "straggler": (
        lambda d: ["straggler", *TINY, "--ranks", "0:1.2,5:1.5"], (), False, None),
    "straggler-bad-rank": (
        lambda d: ["straggler", *TINY, "--ranks", "99:1.2"], (), False, None),
    # test_telemetry.py: the span tree's shape (its ids are run-scoped)
    "perf-trace-requests": (
        lambda d: ["perf", *TINY, "--trace-requests", str(d / "trace.json")], (), True, None),
    "log-json": (
        lambda d: ["explain", *TINY_DP8, "--log-json", "--json", str(d / "led.json")],
        ("led.json",), True, None),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_cli_parity(case, capsys, monkeypatch, tmp_path):
    argv_of, artifacts, device, prepare = PARITY[case]
    runs = both(argv_of, capsys, monkeypatch, tmp_path, device=device,
                artifacts=artifacts, prepare=prepare)
    rc, out, err, d = runs["port"]
    # what the JAX test checks of its run, on the port's
    if case == "unknown-config-exits-2":
        assert rc == cli.EXIT_CONFIG
        assert "unknown model" in err and "llama2-tiny" in err and "Traceback" not in err
    elif case == "report-emitted-when-command-aborts":
        report = json.loads((d / "diag.json").read_text())
        assert rc == cli.EXIT_CONFIG and report["counts"]["errors"] >= 1
        assert any(e["context"].get("exception") == "UnknownConfigError"
                   for e in report["errors"])
    elif case == "strict-exits-3":
        assert rc == cli.EXIT_STRICT and "strict mode" in err
    elif case == "perf-save-simulate":
        assert rc == 0 and "MFU" in out and "simulated" in out
        assert (d / "sim" / "trace.json").exists()
        names = sorted(os.listdir(d / "save"))
        assert names == sorted(os.listdir(tmp_path / "jax" / "save"))
        for name in names:
            got = _artifact(d / "save" / name, d)
            if name == "strategy_config.json":
                # the port's attention backends in place of the JAX package's
                got["sdp_backend"] = {"torch": "xla", "cuda": "pallas"}[got["sdp_backend"]]
            if name == "system_config.json":
                # the port's GPU networks, absent from a TPU system
                assert got.pop("nvlink") is None and got.pop("ib") is None
            assert got == _artifact(tmp_path / "jax" / "save" / name, tmp_path / "jax"), name
    elif case == "critical-path":
        assert "simulated critical-path waterfall" in out and "= makespan" in out
    elif case == "explain-memory":
        assert "peak-HBM waterfall" in out and "top holders" in out
        assert MemoryLedger.load(str(d / "mem.json"))["meta"]["run_id"]
        assert (d / "art" / "analytical_memory_viz.pickle").exists()
    elif case == "explain-memory-oom-forensics":
        assert "OOM" in out and "what-if probes" in out
    elif case == "crosscheck-requires-memory":
        assert "require --memory" in str(rc)
    elif case == "explain-waterfall-and-artifacts":
        assert "MFU-loss waterfall" in out and "= step time" in out
        assert Ledger.load(str(d / "led.json"))["meta"]["run_id"]
    elif case == "explain-sum-row":
        assert "100.00%" in out
    elif case in ("diff-rejects-non-ledger", "diff-memory-and-critical-path-exclusive",
                  "faults-needs-scenario-or-monte-carlo", "search-bad-zero",
                  "dualpp-odd-pp", "straggler-bad-rank"):
        assert rc not in (0, None)
    elif case == "faults-flags-beat-scenario-checkpoint":
        rep = json.loads((d / "report.json").read_text())
        assert rep["checkpoint"] == {**rep["checkpoint"], "interval_steps": 3,
                                     "restart_overhead_s": 7.0}
    elif case == "faults-jobs-0-refused":
        assert "--jobs" in str(rc)
    elif case == "fleet":
        report = json.loads((d / "report.json").read_text())
        assert "fleet goodput" in out and report["schema"] == "simumax-fleet-v1"
        assert len(report["jobs"]) == 2
    elif case == "fleet-explain-chrome-trace":
        assert "fleet goodput waterfall" in out
        check_chrome_trace(json.loads((d / "chrome.json").read_text()))
    elif case == "dualpp":
        assert "DualPipe" in out and "speedup" in out
    elif case == "perf-trace-requests":
        data = json.loads((d / "trace.json").read_text())
        jax_data = json.loads((tmp_path / "jax" / "trace.json").read_text())
        assert data["command"] == "perf" and data["trace_id"]
        (root,) = data["spans"]
        assert root["name"] == "perf" and root["children"]
        assert _span_names(data["spans"]) == _span_names(jax_data["spans"])
        check_chrome_trace(json.loads((d / "trace.json.chrome.json").read_text()))
        assert not get_tracer().enabled
    elif case == "log-json":
        recs = [json.loads(line) for line in out.splitlines() if line.strip()]
        assert all("ts" in r and "run_id" in r and "msg" in r for r in recs)
        waterfall = [r for r in recs if r.get("event") == "waterfall"]
        assert waterfall
        run_id = Ledger.load(str(d / "led.json"))["meta"]["run_id"]
        assert all(r["run_id"] == run_id for r in waterfall)
    else:
        assert rc == 0


def test_cli_list_is_the_jax_clis_and_the_ports_own_configs(capsys):
    """``list`` prints the JAX CLI's configs, in its order, and the
    port's own system configs (``simumax_tpu_torch/configs/system``) in
    their sorted places."""
    jax_lines = _call(jax_cli.main, ["list"], capsys)[1].splitlines()
    port_lines = _call(cli.main, ["list"], capsys)[1].splitlines()
    own = sorted(f"  {fn[:-5]}" for fn in os.listdir(
        os.path.join(REPO, "simumax_tpu_torch", "configs", "system")))
    assert len(own) >= 5 and set(own) <= set(port_lines)
    assert [line for line in port_lines if line not in own] == jax_lines
    systems = port_lines[port_lines.index("system:") + 1:]
    systems = systems[:next((i for i, line in enumerate(systems)
                             if not line.startswith("  ")), len(systems))]
    assert systems == sorted(systems)


def _span_names(spans):
    return [(s["name"], _span_names(s.get("children") or [])) for s in spans]


# -- the kernels' plain versions behind the CLI ---------------------------------


def test_cli_faults_monte_carlo_replays_on_the_plain_kernel(capsys, monkeypatch, tmp_path):
    """``faults --monte-carlo 8`` at the default horizon: the port's
    batched replay (the kernel's plain version under ``--device cpu``)
    solves some of the misses, and the analysis is the JAX package's
    scalar engine's."""
    from simumax_tpu_torch.simulator import batched_replay as port_replay

    calls = []
    real = port_replay.solve_batch

    def counted(prog, models, device="cuda"):
        calls.append((len(models), device))
        return real(prog, models, device=device)

    monkeypatch.setattr(port_replay, "solve_batch", counted)
    runs = both(lambda d: ["faults", *TINY, "--monte-carlo", "8",
                           "--json", str(d / "mc.json")],
                capsys, monkeypatch, tmp_path, artifacts=("mc.json",))
    assert runs["port"][0] == 0
    assert calls and {device for _n, device in calls} == {"cpu"}


def test_cli_guided_search_folds_on_the_plain_kernel(capsys, monkeypatch, tmp_path):
    """The guided Mixtral-8x7B sweep of ``chip_smoke.py`` phase 10d through
    ``search --engine batched --guided``: the sweep-wide fold batch
    sends its shape groups to the fold kernel's plain version, and the
    audit CSV is the JAX package's (its numpy fold) byte for byte."""
    from simumax_tpu_torch.search import batched as port_batched

    folded = []
    real = port_batched._fold_members_cuda

    def counted(members, *args, **kw):
        folded.append(len(members))
        return real(members, *args, **kw)

    monkeypatch.setattr(port_batched, "_fold_members_cuda", counted)
    runs = both(lambda d: ["search", "--model", "mixtral-8x7b", "--system", "tpu_v5p_256",
                           "--base-strategy", "ep4_pp2_dp4_mbs1", "--world", "64",
                           "--gbs", "64", "--tp", "1,2,4,8", "--pp", "1,2,4,8",
                           "--ep", "1,2,4,8", "--zero", "0,1,2,3", "--engine", "batched",
                           "--guided", "--no-cache", "--csv", str(d / "sweep.csv")],
                capsys, monkeypatch, tmp_path, artifacts=("sweep.csv",))
    assert runs["port"][0] == 0
    assert (tmp_path / "port" / "sweep.csv").read_bytes() == \
        (tmp_path / "jax" / "sweep.csv").read_bytes()
    assert len(folded) == 11


def test_cli_fleet_naive_walk_equals_the_shared_walk(capsys, monkeypatch, tmp_path):
    """The JAX ``bench_fleet.py`` gate's oracle through the CLI: with
    elastic reshaping off, the naive walk (a fresh replay context per
    job) reports what the shared walk reports; each as the JAX CLI's."""
    reports = {}
    for naive in (False, True):
        sub = tmp_path / ("naive" if naive else "shared")
        sub.mkdir()
        both(lambda d: ["fleet", "--trace", str(d / "trace.json"), "--no-cache",
                        "--no-elastic", "--json", str(d / "report.json")]
             + (["--naive"] if naive else []),
             capsys, monkeypatch, sub, artifacts=("report.json",), prepare=_fleet_trace)
        reports[naive] = json.loads((sub / "port" / "report.json").read_text())
    assert reports[True] == reports[False]


# -- diffs of saved ledgers and reports -----------------------------------------


def _save_inputs(d, capsys, family):
    """Save the inputs of ``diff`` for ``family`` with the port's CLI into
    ``d``; returns their paths."""
    if family == "ledger":
        a, b = d / "a.json", d / "b.json"
        cli.main(["explain", *TINY_DP8, "--json", str(a), "--device", "cpu"])
        cli.main(["explain", *TINY, "--json", str(b), "--device", "cpu"])
    elif family == "memory":
        a, b = d / "a.json", d / "b.json"
        cli.main(["explain", *TINY_DP8, "--memory", "--json", str(a), "--device", "cpu"])
        cli.main(["explain", *TINY, "--memory", "--json", str(b), "--device", "cpu"])
    elif family == "critical-path":
        a = b = d / "cp.json"
        cli.main(["critical-path", *TINY, "--granularity", "chunk", "--json", str(a)])
    else:
        a, b = d / "a.json", d / "b.json"
        a.write_text(json.dumps(jax_explained(base_trace())))
        b.write_text(json.dumps(jax_explained(churn_trace())))
    capsys.readouterr()
    return a, b


@pytest.mark.parametrize("family,flags,self_diff", [
    ("ledger", [], True), ("ledger", [], False),
    ("memory", ["--memory"], True), ("memory", ["--memory"], False),
    ("critical-path", ["--critical-path"], True),
    ("fleet", [], False), ("fleet", ["--fleet"], False),
])
def test_cli_diff_parity(family, flags, self_diff, capsys, monkeypatch, tmp_path):
    """``diff`` of two saved ledgers (``test_observability.py``), memory
    ledgers (``test_memledger.py``), critical-path reports
    (``test_critpath.py``) and fleet reports, auto-detected or flagged
    (``test_fleetledger.py``): the same inputs through both CLIs give the
    same lines and the same ``--json`` report."""
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    a, b = _save_inputs(inputs, capsys, family)
    if self_diff:
        b = a
    runs = both(lambda d: ["diff", *flags, str(a), str(b), "--json", str(d / "diff.json")],
                capsys, monkeypatch, tmp_path, device=False, artifacts=("diff.json",))
    rc, out, _err, d = runs["port"]
    assert rc == 0
    report = json.loads((d / "diff.json").read_text())
    if self_diff:
        assert "identical" in out and report["identical"] is True
    if family == "fleet":
        assert "fleet diff" in out and "fleet goodput" in out


def test_cli_diff_memory_rejects_a_time_ledger(capsys, tmp_path):
    led = tmp_path / "led.json"
    cli.main(["explain", *TINY_DP8, "--json", str(led), "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["diff", "--memory", str(led), str(led)])


# -- the planner cache (test_service_server.py) ---------------------------------


def _body(text):
    """The lines of a run without its run-scoped ones, the program's name
    normalised."""
    return [line.replace("simumax_tpu_torch", "simumax_tpu") for line in text.splitlines()
            if not line.startswith("[diagnostics]") and "ledger ->" not in line]


def test_cli_perf_planner_routed_output_identical(capsys, tmp_path):
    """Cold, warm and cache-off ``perf`` print the same body, the JAX
    CLI's, and the cache holds the one entry."""
    cache = str(tmp_path / "cache")
    args = ["perf", *L8B, "--cache-dir", cache, "--device", "cpu"]
    outs = [_call(cli.main, argv, capsys)[1]
            for argv in (args, args, args + ["--no-cache"])]
    jax_out = _call(jax_cli.main, ["perf", *L8B, "--no-cache"], capsys)[1]
    assert _body(outs[0]) == _body(outs[1]) == _body(outs[2]) == _body(jax_out)
    assert any("MFU" in line for line in _body(outs[0]))
    cli.main(["cache", "stats", "--cache-dir", cache, "--json", str(tmp_path / "s.json")])
    stats = json.loads((tmp_path / "s.json").read_text())
    assert stats["namespaces"]["estimate"]["entries"] == 1


def test_cli_explain_planner_routed(capsys, tmp_path):
    cache = str(tmp_path / "cache")
    a, b, j = (str(tmp_path / n) for n in ("a.json", "b.json", "j.json"))
    args = ["explain", *L8B, "--cache-dir", cache, "--device", "cpu"]
    cold = _call(cli.main, args + ["--json", a], capsys)[1]
    warm = _call(cli.main, args + ["--json", b], capsys)[1]
    jax_out = _call(jax_cli.main, ["explain", *L8B, "--no-cache", "--json", j], capsys)[1]
    assert _body(cold) == _body(warm) == _body(jax_out)
    assert any("MFU-loss waterfall" in line for line in _body(cold))
    led_a, led_b = (json.load(open(p)) for p in (a, b))
    assert led_a == led_b and led_a["schema"].startswith("simumax")
    assert _scrub(led_a) == _scrub(json.load(open(j)))
    assert "ledger diff" in _call(cli.main, ["diff", a, b], capsys)[1]


def test_cli_search_uses_store_and_marks_cached(capsys, tmp_path):
    base = ["search", "--model", "llama3-8b", "--system", "tpu_v5p_256", "--world", "32",
            "--gbs", "32", "--pp", "1", "--zero", "1", "--jobs", "1",
            "--cache-dir", str(tmp_path / "cache"), "--device", "cpu"]
    _call(cli.main, base + ["--tp", "1,2"], capsys)
    rc, out, _err = _call(cli.main, base + ["--tp", "1,2,4"], capsys)
    assert rc == 0 and "served 6/9 cells from the planner cache" in out


def test_cli_cache_verify_and_clear(capsys, tmp_path):
    cache = str(tmp_path / "cache")
    Planner(cache_dir=cache, device="cpu").estimate("llama3-8b", "tp1_pp2_dp4_mbs1",
                                                    "tpu_v5e_256")

    def report(action, *extra):
        path = tmp_path / f"{action}.json"
        cli.main(["cache", action, "--cache-dir", cache, "--json", str(path), *extra])
        return json.loads(path.read_text())

    assert len(report("ls")["entries"]) == 1
    rep = report("verify")
    assert rep["ok"] == 1 and not rep["corrupt"]
    entries = [os.path.join(dirpath, fn) for dirpath, _d, files in os.walk(cache)
               for fn in files if fn.endswith(".entry")]
    with open(entries[0], "ab") as f:
        f.write(b"tail-garbage")
    with pytest.raises(SystemExit) as exc:
        cli.main(["cache", "verify", "--cache-dir", cache])
    assert exc.value.code == 1
    assert "corrupt" in capsys.readouterr().out
    assert report("clear")["removed"] == 1


# -- the run ids of one run (test_observability.py) -----------------------------


def test_cli_perf_diagnostics_and_log_lines_share_run_id(capsys, tmp_path):
    diag = tmp_path / "d.json"
    cli.main(["perf", *TINY_DP8, "--log-json", "--diagnostics", str(diag), "--device", "cpu"])
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.strip()]
    report = json.loads(diag.read_text())
    assert report["run_id"] and recs
    assert all(r["run_id"] == report["run_id"] for r in recs)


# -- a failing simulation (test_fault_isolation.py) -----------------------------


def test_cli_simulation_error_exits_3_with_one_liner(capsys, monkeypatch, tmp_path):
    """A SimulationError escaping ``perf --simulate`` exits 3 with one
    line in both CLIs."""
    def wedged(*a, **k):
        raise SimulationError("engine invariant violated\n  rank 0 blocked on recv",
                              phase="simulate")

    def jax_wedged(*a, **k):
        raise JaxSimulationError("engine invariant violated\n  rank 0 blocked on recv",
                                 phase="simulate")

    monkeypatch.setattr(port_runner, "run_simulation", wedged)
    monkeypatch.setattr(jax_runner, "run_simulation", jax_wedged)
    runs = both(lambda d: ["perf", *TINY, "--simulate", str(d / "sim"),
                           "--diagnostics", str(d / "diag.json")],
                capsys, monkeypatch, tmp_path)
    rc, _out, err, d = runs["port"]
    assert rc == cli.EXIT_SIMULATION == 3
    assert "simulation failed" in err and "engine invariant violated" in err
    assert "rank 0 blocked" not in err
    report = json.loads((d / "diag.json").read_text())
    assert report["counts"]["errors"] >= 1


# -- the card -------------------------------------------------------------------


@pytest.mark.parametrize("command", sorted(DEVICE_COMMANDS))
def test_device_cuda_without_a_card_is_one_line_and_nonzero(command, capsys, monkeypatch,
                                                            tmp_path):
    """``--device cuda`` (the default) on a machine without a card stops
    before any work with the port's own error as one line; nothing runs
    on the CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    _fleet_trace(tmp_path)
    monkeypatch.chdir(tmp_path)
    started = []
    monkeypatch.setattr(cli, f"cmd_{command}", lambda args: started.append(args))
    for argv in ([command, *DEVICE_COMMANDS[command]],
                 [command, *DEVICE_COMMANDS[command], "--device", "cuda"]):
        rc, out, err = _call(cli.main, argv, capsys)
        assert rc == cli.EXIT_DEVICE == 1
        assert err.splitlines() == ["error: no CUDA device is available; pass device='cpu' "
                                    "to run on the CPU explicitly"]
        assert out == ""
    assert not started


def test_calibrate_refuses_the_cpu_in_one_line(capsys):
    rc, _out, err = _call(cli.main, ["calibrate", *TINY, "--device", "cpu"], capsys)
    assert rc == cli.EXIT_DEVICE
    assert err.splitlines() == ["error: calibration measures on the CUDA card, not on cpu"]


def test_calibrate_collectives_spawns_gloo_ranks_and_saves_the_fit(capsys, monkeypatch,
                                                                  tmp_path):
    """``calibrate --collectives`` with the device-count helper at 2 on
    the CPU: two gloo ranks sweep the five collectives, and the fit lands
    in the saved system's ICI op table (a group of 2 on ``tpu_v5e_256``).
    The card-only measurements of ``calibrate_system`` are stood in for
    by a save of the system they were given (they refuse the CPU: see
    the test above)."""
    from simumax_tpu_torch import calibration

    counted = []

    def device_count(device):
        counted.append(device)
        return 2

    def save_only(perf, save_path=None, device="cuda", **kwargs):
        assert device == "cpu"
        perf.run_estimate()
        with open(save_path, "w") as f:
            json.dump(perf.system.to_dict(), f, default=lambda o: vars(o))
        return {}

    monkeypatch.setattr(cli, "_device_count", device_count)
    monkeypatch.setattr(calibration, "calibrate_system", save_only)
    out_path = tmp_path / "system.json"
    rc, out, err = _call(cli.main, ["calibrate", *TINY, "--collectives", "--device", "cpu",
                                    "--save", str(out_path)], capsys)
    assert rc == 0, err
    assert counted == ["cpu"]
    fitted = [line for line in out.splitlines() if line.startswith("[cal] ")]
    assert [line.split(":")[0] for line in fitted] == [
        "[cal] all_reduce", "[cal] all_gather", "[cal] reduce_scatter", "[cal] all2all",
        "[cal] p2p"]
    saved = json.loads(out_path.read_text())
    prior = get_system_config("tpu_v5e_256")
    table = saved["ici"]["op"]
    for op in ("all_reduce", "all_gather", "reduce_scatter", "all2all", "p2p"):
        assert 0 < table[op]["efficient_factor"] <= 1.0
        assert table[op]["latency_us"] >= 0
    assert table != {k: vars(v) for k, v in prior.ici.op.items()}


def test_calibrate_collectives_on_one_device_logs_the_skip(capsys, monkeypatch, tmp_path):
    from simumax_tpu_torch import calibration

    monkeypatch.setattr(calibration, "calibrate_system", lambda perf, **kw: {})
    rc, out, _err = _call(cli.main, ["calibrate", *TINY, "--collectives", "--device", "cpu"],
                          capsys)
    assert rc == 0
    assert "[cal] collectives: need >1 device, skipping" in out.splitlines()


@pytest.mark.parametrize("engine,device,jobs,expect", [
    ("scalar", "cpu", None, "cpus"), ("scalar", "cuda", None, "cpus"),
    ("batched", "cpu", None, "cpus"), ("batched", "cuda", None, 1),
    ("batched", "cuda", 3, 3),
])
def test_search_jobs_default(engine, device, jobs, expect, monkeypatch):
    """``--jobs`` defaults to ``os.cpu_count()``, as in the JAX CLI, but to
    1 for the batched engine on the card: there the folds run on the one
    card, and pool workers would each build a CUDA context."""
    import simumax_tpu_torch.search as search

    seen = {}
    monkeypatch.setattr(cli, "_require_device", lambda args: None)
    monkeypatch.setattr(search, "search_best_parallel_strategy",
                        lambda *a, **kw: seen.update(kw) or [])
    argv = ["search", "--model", "llama2-tiny", "--system", "tpu_v5e_256", "--gbs", "8",
            "--engine", engine, "--device", device, "--no-cache"]
    cli.main(argv + (["--jobs", str(jobs)] if jobs else []))
    assert seen["jobs"] == (os.cpu_count() or 1 if expect == "cpus" else expect)
    assert seen["device"] == device


def test_help_lists_the_jax_clis_subcommands():
    outs = [subprocess.run([sys.executable, "-m", pkg, "--help"], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
            for pkg in ("simumax_tpu", "simumax_tpu_torch")]
    assert all(p.returncode == 0 for p in outs)
    first = [p.stdout.split("{")[1].split("}")[0].split(",") for p in outs]
    assert first[0] == first[1] and len(first[1]) == 13
    assert outs[1].stdout.startswith("usage: simumax_tpu_torch")


def test_pyproject_packages_every_port_subpackage_and_names_the_script():
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    packages = set(project["tool"]["setuptools"]["packages"])
    port = {os.path.relpath(dirpath, REPO).replace(os.sep, ".")
            for dirpath, _dirs, files in os.walk(os.path.join(REPO, "simumax_tpu_torch"))
            if "__init__.py" in files}
    assert len(port) >= 12 and port <= packages
    scripts = project["project"]["scripts"]
    assert scripts["simumax-tpu-torch"] == "simumax_tpu_torch.cli:main"
    assert scripts["simumax-tpu"] == "simumax_tpu.cli:main"


# -- subprocesses (test_surfaces.py TestCLI, test_service_chaos.py) -------------


def _run_module(*args, env=None):
    return subprocess.run([sys.executable, "-m", "simumax_tpu_torch", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=300, env=env)


def test_module_entry_point_runs_the_port(tmp_path):
    """``python -m simumax_tpu_torch``: ``list``, a ``perf`` with
    ``--save``/``--simulate``, a ``search``, and a bad model's nonzero
    exit, each as a child process."""
    r = _run_module("list")
    assert r.returncode == 0 and "llama3-8b" in r.stdout and "h100_sxm" in r.stdout
    r = _run_module("perf", *TINY, "--device", "cpu", "--save", str(tmp_path),
                    "--simulate", str(tmp_path / "sim"))
    assert r.returncode == 0, r.stderr
    assert "MFU" in r.stdout and "simulated" in r.stdout
    assert (tmp_path / "sim" / "trace.json").exists()
    r = _run_module("search", "--model", "llama2-tiny", "--system", "tpu_v5e_256", "--world",
                    "8", "--gbs", "8", "--tp", "1,2", "--pp", "1", "--topk", "2",
                    "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "MFU" in r.stdout
    r = _run_module("perf", "--model", "nope", "--strategy", "tp1_pp2_dp4_mbs1",
                    "--system", "tpu_v5e_256", "--device", "cpu")
    assert r.returncode == 2 and "python -m simumax_tpu_torch list" in r.stderr


def _free_ports(n):
    for base in range(18931, 19131, n):
        socks = []
        try:
            for off in range(n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + off))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError("no run of free ports")


def _healthy(port, deadline):
    while True:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/healthz")
            ok = conn.getresponse().status == 200
            conn.close()
            if ok:
                return
        except OSError:
            pass
        assert time.monotonic() < deadline, f"node on {port} never became healthy"
        time.sleep(0.2)


def _descendants(pid):
    out, frontier = set(), [pid]
    while frontier:
        p = frontier.pop()
        try:
            with open(f"/proc/{p}/task/{p}/children") as f:
                kids = [int(c) for c in f.read().split()]
        except (OSError, ValueError):
            continue
        for k in kids:
            if k not in out:
                out.add(k)
                frontier.append(k)
    return out


def test_serve_answers_an_estimate_as_the_jax_planner(tmp_path):
    port = _free_ports(1)
    proc = subprocess.Popen(
        [sys.executable, "-m", "simumax_tpu_torch", "serve", "--port", str(port),
         "--device", "cpu", "--cache-dir", str(tmp_path / "cache")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        _healthy(port, time.monotonic() + 90)
        body = {"model": "llama3-8b", "strategy": "tp1_pp2_dp4_mbs1", "system": "tpu_v5e_256"}
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/estimate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        assert resp.status == 200
        assert data == jax_response_bytes(JaxPlanner(enabled=False).estimate(
            body["model"], body["strategy"], body["system"]))
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0
        assert b"[serve] planning service on http://127.0.0.1:" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)


def test_serve_nodes_sigterm_reaps_whole_fleet(tmp_path):
    port = _free_ports(2)
    proc = subprocess.Popen(
        [sys.executable, "-m", "simumax_tpu_torch", "serve", "--port", str(port),
         "--nodes", "2", "--workers", "1", "--device", "cpu",
         "--cache-dir", str(tmp_path / "cache")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 90
        for p in (port, port + 1):
            _healthy(p, deadline)
        kin = _descendants(proc.pid)
        assert kin  # the sibling node and the pool workers
        proc.send_signal(signal.SIGTERM)
        # an orphaned worker holding our stdout pipe would block this
        proc.communicate(timeout=60)
        assert proc.returncode == 0
        deadline = time.monotonic() + 10
        live = set(kin)
        while live and time.monotonic() < deadline:
            for k in sorted(live):
                try:
                    os.kill(k, 0)
                except ProcessLookupError:
                    live.discard(k)
                except PermissionError:
                    pass
            time.sleep(0.2)
        assert not live, f"orphaned fleet processes: {sorted(live)}"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
