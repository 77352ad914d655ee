"""The window's arithmetic: a rate is all the work over all the time, a tail
is over every request, the request mix is the same for every seed, a leaf's
gap is measured as documented, and a trace reduces to busy time, device time
in ranges and idle gaps."""

import statistics

import pytest

from port_bench.trace import Trace
from port_bench.traffic import serve_closed, train_steps


def test_percentile_is_over_every_request():
    values = [float(i) for i in range(1, 201)]
    assert serve_closed.percentile(values, 95) == \
        statistics.quantiles(values, n=100, method="inclusive")[94]
    assert serve_closed.percentile([3.0], 95) == 3.0
    # one slow request among 200 moves the p95 no further than its rank allows
    assert serve_closed.percentile(values[:-1] + [1e6], 95) == \
        serve_closed.percentile(values, 95)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5, 4294967297])
def test_request_order_sends_the_same_mix_for_every_seed(seed):
    order = serve_closed.request_order(seed, 80, 8)
    assert len(order) == 80
    for i in range(0, 80, 8):
        assert sorted(order[i:i + 8]) == list(range(8))


def test_request_order_depends_on_the_seed():
    assert serve_closed.request_order(1, 64, 8) != serve_closed.request_order(2, 64, 8)


def test_leaf_gap_against_the_larger_of_its_norm_and_the_median():
    ref = {"a": 1.0, "b": 2.0, "c": 4.0, "tiny": 1e-6}
    assert train_steps.leaf_gap(dict(ref), ref) == (0.0, None)
    gap, leaf = train_steps.leaf_gap({**ref, "tiny": 0.5}, ref)
    # the median of (1e-6, 1, 2, 4) is 1.5
    assert leaf == "tiny" and gap == pytest.approx((0.5 - 1e-6) / 1.5)
    gap, leaf = train_steps.leaf_gap({**ref, "c": 3.0}, ref)
    assert leaf == "c" and gap == pytest.approx(0.25)
    assert train_steps.leaf_gap({}, ref)[0] == 1.0
    assert train_steps.leaf_gap({**ref, "tiny": 0.5}, ref, keep={"a", "b", "c"})[0] == 0.0


def test_terms_gap_is_the_median_over_the_nonzero_reference_terms():
    ref = {"a": 1.0, "b": 2.0, "c": 4.0, "zero": 0.0}
    assert train_steps.terms_gap_median(dict(ref), ref) == 0.0
    # gaps 0.5, 0, 0.25: the median is 0.25; the zero term is left out
    assert train_steps.terms_gap_median({"a": 1.5, "b": 2.0, "c": 3.0, "zero": 9.0}, ref) == \
        pytest.approx(0.25)
    assert train_steps.terms_gap_median({}, ref) == 1.0


def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_busy_range_time_and_gaps():
    events = [
        _event("user_annotation", "ProfilerStep#2", 0, 100),
        _event("user_annotation", "bench::x", 10, 20),
        _event("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=2),
        _event("cpu_op", "aten::wait", 50, 30),
        _event("kernel", "k_a", 20, 10, tid=7, corr=1),
        _event("kernel", "k_b", 25, 15, tid=8, corr=2),
        _event("gpu_memcpy", "copy", 90, 20, tid=7),
    ]
    t = Trace(events)
    assert t.window_s == pytest.approx(110e-6)
    # k_a and k_b overlap: the union of 20-40 and 90-110
    assert t.busy_s == pytest.approx(40e-6)
    assert t.device_s_in(lambda n: n == "bench::x") == pytest.approx(10e-6)
    assert t.device_s_in(lambda n: n == "absent") is None
    assert t.host_s_in(lambda n: n == "bench::x") == pytest.approx(20e-6)
    gaps = t.idle_gaps()
    assert gaps[0] == ["aten::wait", pytest.approx(50e-6)]
    assert sum(g[1] for g in gaps) == pytest.approx(t.window_s - t.busy_s)
    assert t.top_device_ops()[0] == ["copy", pytest.approx(20e-6)]


def test_trace_of_the_card_alone_holds_its_own_launches_work():
    events = [
        # an earlier unit's queued kernel, launched before the trace began
        _event("kernel", "k_tail", 0, 8, tid=7, corr=99),
        _event("cuda_runtime", "cudaLaunchKernel", 5, 2, tid=3, corr=1),
        _event("cuda_runtime", "cudaStreamSynchronize", 30, 40, tid=3),
        _event("cuda_runtime", "cudaLaunchKernel", 75, 2, tid=3, corr=2),
        _event("kernel", "k_a", 10, 20, tid=7, corr=1),
        _event("kernel", "k_b", 80, 10, tid=7, corr=2),
        _event("kernel", "k_c", 92, 8, tid=7, corr=2),
    ]
    t = Trace(events)
    assert t.window_s == pytest.approx(90e-6)
    assert t.busy_s == pytest.approx(38e-6)
    assert t.device_s_in(lambda n: True) is None
    assert [k for k, _ in t.top_device_ops()] == ["k_a", "k_b", "k_c"]
    gaps = t.idle_gaps()
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(50e-6)]
    assert gaps[1] == ["host, no CUDA call", pytest.approx(2e-6)]
    assert sum(g[1] for g in gaps) == pytest.approx(t.window_s - t.busy_s)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_training_batches_hold_the_same_counts_for_every_seed(seed):
    from port_bench import data

    pool = data.train_pool(seed, 2, image_size=32, num_classes=5, slots=6,
                           instances=[1, 2, 4, 6], stride=4)
    for images, t in pool:
        assert images.shape == (4, 32, 32, 3) and t.masks.shape == (4, 6, 8, 8)
        assert sorted(t.valid.sum(1).tolist()) == [1, 2, 4, 6]
    assert not all(pool[0][1].valid.sum(1) == pool[1][1].valid.sum(1)) or \
        not (pool[0][0] == pool[1][0]).all()
