"""The window's statistics and the trace's arithmetic, against values
worked out by hand."""

import math

import pytest

from perfbench.harness import counts, trace, window


def test_rate_is_all_work_over_all_time():
    assert window.rate(900, 30.0) == 30.0
    with pytest.raises(ValueError):
        window.rate(1, 0.0)


def test_p95_over_all_requests_from_due_time():
    due = [float(i) for i in range(100)]
    # every request served 0.1 s after it was due, but one stall holds
    # requests 50..59 until t = 62
    done = [d + 0.1 for d in due]
    for i in range(50, 60):
        done[i] = 62.0
    lat = window.latencies_from_due(due, done)
    assert lat[50] == pytest.approx(12.0) and lat[59] == pytest.approx(3.0)
    # sorted: 90 of 0.1, then 3..12 at ranks 90..99; rank 94.05 lies
    # between 7 and 8
    assert window.percentile(lat, 95) == pytest.approx(7.05)
    lat = window.latencies_from_due([0.0, 1.0], [0.5, None])
    assert lat[1] == math.inf
    assert window.percentile([0.1] * 99 + [math.inf], 95) == \
        pytest.approx(0.1)
    assert window.percentile([0.1] * 90 + [math.inf] * 10, 95) == math.inf


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 7), (10, 11)]
    assert trace.union_s(iv) == 3 + 2 + 1
    assert trace.gaps(iv) == [(3, 5), (7, 10)]
    assert trace.union_s([]) == 0.0


def test_summary_labels_gaps_by_the_innermost_host_event():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 300, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 350,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1000, "dur": 50},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.step",
         "ts": 50, "dur": 1000},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 90, "dur": 300},
    ]
    s = trace.summarize(ev, window_s=0.002)
    assert s["busy_s"] == pytest.approx(100e-6 + 150e-6 + 50e-6)
    assert s["kernel_s"]["k1"] == pytest.approx(150e-6)
    assert s["kernel_n"] == {"k1": 2, "k2": 1, "Memcpy HtoD": 1}
    gaps = dict(s["idle_gaps"])
    assert gaps["cudaMemcpyAsync"] == pytest.approx(200e-6)   # 100..300
    assert gaps["perfbench.step"] == pytest.approx(550e-6)    # 450..1000
    assert s["device_ops"][0] == ["k1", pytest.approx(150e-6)]
    with pytest.raises(RuntimeError):
        trace.summarize([ev[4]], 1.0)


def test_warp_bounds_by_hand():
    # the serving forward at B=8, P=24, 512^2, T=64, k=4: bytes bind;
    # 8*24*N*4 + 8*N*4*8 + 8*24*3*64*64*4 + 8*3*N*4 with N = 262144
    N = 512 * 512
    nbytes = 8 * 24 * N * 4 + 8 * N * 4 * 8 + 8 * 24 * 3 * 4096 * 4 \
        + 8 * 3 * N * 4
    assert nbytes == 303_038_464
    got = counts.warp_fwd_bound_s(8, 24, 3, 64, N, 4, False, 8)
    assert got == pytest.approx(nbytes / 3.35e12)
    assert got * 1e3 == pytest.approx(0.0905, abs=1e-4)
    # the backward at B=2: 40 operations a selected pair and channel stay
    # under the bytes at 67 TFLOP/s
    nnz = 2 * N * 4
    tex = 2 * 24 * 3 * 4096
    nb = 2 * 24 * N * 4 + nnz * 8 + 2 * 3 * N * 4 + 2 * tex * 4 \
        + 3 * 2 * 24 * N * 4
    assert counts.warp_bwd_bound_s(2, 24, 3, 64, N, 4, 2) == \
        pytest.approx(max(nb / 3.35e12, nnz * 3 * 40 / 67e12))
