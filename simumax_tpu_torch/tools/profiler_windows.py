"""How many launches a ``torch.profiler`` window drops, with and without
the marked lead of :func:`attribute_step.open_window`.

One process captures the int8 bench row's step (``bench.ROWS``) in a CUDA
graph, then for ``--seconds`` profiles one replay at a time, in turns:

* ``single``: the window opens with one one-element fill and a wait for
  it, then the replay, then a wait for the card (the lead ``chip_smoke.py``
  and ``attribute_step`` used before);
* ``marked``: :func:`attribute_step.open_window`, the replay,
  :func:`attribute_step.close_window`, read after the mark
  (:func:`attribute_step.after_mark`).

Between turns it opens a few empty windows and waits, as a long smoke run
does. Each window's line gives the device events it recorded, how many of
the replay's it lacks (by name, against a first marked window's) and
its ``q8_*`` kernels; the last line is a JSON summary.

Run on the card: ``python -m simumax_tpu_torch.tools.profiler_windows
--seconds 180``.
"""

from __future__ import annotations

import argparse
import json
import re
import time
from collections import Counter

import torch

from simumax_tpu_torch.tools import attribute_step as A


def _q8(events):
    return dict(Counter(m.group(0) for e in events
                        for m in [re.search(r"q8_\w+?_kernel", e["name"])] if m))


def main(seconds: float) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from simumax_tpu_torch import bench
    from simumax_tpu_torch.calibration.timing import capture_step
    from simumax_tpu_torch.torchref.rows import make_row_step

    label, kind, seq, mbs, layers, remat = next(r for r in bench.ROWS if r[1] == "int8")
    step = make_row_step(kind, bench.build_model(kind), seq, mbs, layers, remat)
    graph = capture_step(step)[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        A.open_window()
        graph.replay()
        A.close_window()
    full = A.device_events(A.after_mark(A._trace(prof, "windows_reference")))
    lost = {"single": [], "marked": []}
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        for lead in lost:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                if lead == "single":
                    torch.zeros(1, device="cuda")
                    torch.cuda.synchronize()
                    graph.replay()
                    torch.cuda.synchronize()
                else:
                    A.open_window()
                    graph.replay()
                    A.close_window()
            events = A._trace(prof, f"windows_{lead}")
            events = A.device_events(A.after_mark(events) if lead == "marked" else events)
            lacking = Counter(e["name"] for e in full) - Counter(e["name"] for e in events)
            lost[lead].append(sum(lacking.values()))
            print(json.dumps({"t_s": round(time.monotonic() - t0, 1), "lead": lead,
                              "device_events": len(events), "lacking": lost[lead][-1],
                              "q8": _q8(events)}), flush=True)
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.zeros(1, device="cuda")
                torch.cuda.synchronize()
        time.sleep(8)
    out = {"row": label, "replay_events": len(full), "replay_q8": _q8(full),
           "card": torch.cuda.get_device_name(0)}
    for lead, xs in lost.items():
        out[lead] = {"windows": len(xs), "lacking_any": sum(x > 0 for x in xs),
                     "lacking": sorted(xs)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=180.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_windows: needs a CUDA card")
    main(args.seconds)
