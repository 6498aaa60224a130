"""p90 over every step interval, the device's idle share as a union of
intervals, and the attribution of kernels to the program's op families."""

import pytest

from portbench import manifest, trace

percentile = manifest.load_reader("step_ms_p90").percentile


def test_percentile_over_every_value():
    xs = list(range(1, 12))  # 1 .. 11
    assert percentile(xs, 90) == 10.0
    assert percentile(xs, 50) == 6.0
    assert percentile([5.0], 90) == 5.0
    assert percentile([1.0, 2.0], 90) == pytest.approx(1.9)
    # every interval counts: one slow step among 100 moves p90 only when
    # more than a tenth are slow
    steady = [100.0] * 95 + [200.0] * 5
    assert percentile(steady, 90) == 100.0
    slow = [100.0] * 85 + [200.0] * 15
    assert percentile(slow, 90) == 200.0


def test_step_ms_p90_reads_the_intervals_whole():
    reader = manifest.load_reader("step_ms_p90")
    intervals = [float(i) for i in range(1, 101)]
    assert reader.read({"intervals_ms": intervals}) == pytest.approx(90.1)


def test_union_merges_overlaps():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert trace.union([]) == []


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def _window():
    """A mark, then: a forward gemm under the ``gemm`` range (op with
    sequence number 7), an elementwise kernel in no range, and the
    backward of op 7 under autograd's node, on one thread."""
    events = [
        _kernel("spin_kernel", 0, 10, 1),
        {"ph": "X", "cat": "user_annotation", "name": "gemm", "ts": 100, "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 105, "dur": 20, "tid": 1,
         "args": {"Sequence number": 7, "Fwd thread id": 1}},
        _launch(110, 2),
        _kernel("sm90_gemm", 120, 40, 2),
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 200, "dur": 10, "tid": 1},
        _launch(202, 3),
        _kernel("elementwise_add", 170, 10, 3),
        {"ph": "X", "cat": "cpu_op", "name": trace._BACKWARD + "MmBackward0", "ts": 300,
         "dur": 30, "tid": 1, "args": {"Sequence number": 7, "Fwd thread id": 1}},
        _launch(305, 4),
        _kernel("sm90_gemm_bwd", 220, 60, 4),
    ]
    return events


def test_read_window_attributes_by_range_and_sequence_number():
    got = trace.read_window(_window(), steps=2)
    assert got["family_ms"]["gemm"] == pytest.approx((40 + 60) / 1e3 / 2)
    assert got["family_ms"][trace.ELEMENTWISE] == pytest.approx(10 / 1e3 / 2)
    # busy: [120, 160), [170, 180), [220, 280) of the window [120, 280)
    assert got["busy_s"] == pytest.approx(110 / 1e6)
    assert got["window_s"] == pytest.approx(160 / 1e6)
    assert [g[1] for g in got["idle_gaps"]] == pytest.approx([40 / 1e6, 10 / 1e6])
    assert got["device_ops"][0] == ("sm90_gemm_bwd", pytest.approx(60 / 1e6))
    assert got["untied"] == 0


def test_device_idle_is_one_minus_the_union():
    reader = manifest.load_reader("device_idle_pct")
    got = trace.read_window(_window(), steps=2)
    assert reader.read({"traced": got}) == pytest.approx(100 * (1 - 110 / 160))


def test_a_window_that_lost_its_mark_reads_nothing():
    events = [e for e in _window() if e.get("name") != "spin_kernel"]
    assert trace.read_window(events, steps=2) == {}
