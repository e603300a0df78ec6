"""Reading a traced window card by card: on one card every reading is
what it was before the trace kept cards (frozen below); on two, busy time
is each card's union and their mean, and each breakdown name begins with
its card."""

import pytest

from benchmark.trace import from_events

LONG = "void_at::native::" + "templated_kernel_" * 12


def _host(cat, name, ts, dur, tid=11):
    return {"ph": "X", "cat": cat, "name": name, "pid": 4242, "tid": tid, "ts": ts,
            "dur": dur}


def _dev(cat, name, ts, dur, card=0, stream=7, in_args=True):
    event = {"ph": "X", "cat": cat, "name": name, "pid": card, "tid": stream, "ts": ts,
             "dur": dur}
    if in_args:
        event["args"] = {"device": card, "stream": stream}
    return event


def one_card_events(card=0, in_args=True):
    """A traced window of two jobs on one card, in microseconds: overlaps
    across streams, operations cut by the window's ends, one outside it,
    a gap between the jobs and host events of another thread."""
    def dev(*args, **kwargs):
        return _dev(*args, card=card, in_args=in_args, **kwargs)

    return [
        {"ph": "M", "name": "process_name", "pid": 4242, "args": {"name": "python"}},
        _host("user_annotation", "bench.window", 1000.0, 10000.0),
        _host("user_annotation", "bench.job", 1050.0, 4450.0),
        _host("cpu_op", "aten::index", 1100.0, 300.0),
        _host("cuda_runtime", "cudaLaunchKernel", 1150.0, 20.0),
        _host("cpu_op", "aten::scatter_reduce_", 1500.0, 900.0),
        _host("cuda_runtime", "cudaLaunchKernel", 1600.0, 30.0),
        _host("cuda_runtime", "cudaDeviceSynchronize", 2500.0, 2950.0),
        _host("user_annotation", "bench.job", 5600.0, 5300.0),
        _host("cpu_op", "aten::copy_", 5650.0, 400.0),
        _host("cuda_runtime", "cudaMemcpyAsync", 5700.0, 300.0),
        _host("cpu_op", "aten::arange", 6200.0, 100.0),
        _host("cuda_runtime", "cudaDeviceSynchronize", 7000.0, 3800.0),
        _host("cpu_op", "aten::empty", 5200.0, 50.0, tid=12),
        dev("kernel", "gather_kernel", 900.0, 400.0),
        dev("kernel", "gather_kernel", 1400.0, 600.0),
        dev("kernel", "mode_mid_kernel", 1800.0, 900.0, stream=9),
        dev("gpu_memset", "Memset (Device)", 2800.0, 50.0),
        dev("kernel", LONG + "a", 3000.0, 2530.0),
        dev("kernel", LONG + "b", 3100.0, 500.0, stream=9),
        dev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 5800.0, 250.0),
        dev("kernel", "mode_mid_kernel", 6400.0, 1500.0),
        dev("kernel", "gather_kernel", 8000.0, 2000.0),
        dev("kernel", "argmax_kernel", 10500.0, 900.0),
        dev("kernel", "late_kernel", 11200.0, 100.0),
        dev("gpu_user_annotation", "bench.job", 1400.0, 3000.0),
    ]


def second_card_events():
    """Card 1's operations in the same window: busy 1000-3000 us of it is
    shared with the host's first job, 7000-10000 with the second."""
    return [_dev("kernel", "gather_kernel", 2000.0, 1000.0, card=1),
            _dev("kernel", "mode_mid_kernel", 7000.0, 2000.0, card=1),
            _dev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 9000.0, 1000.0, card=1)]


# What the trace reading gave for one_card_events() before it kept cards
FROZEN_OPS = [[(LONG + "a")[:160], 0.0030299999999999997],
              ["gather_kernel", 0.0029], ["mode_mid_kernel", 0.0024000000000000002],
              ["argmax_kernel", 0.0005], ["Memcpy DtoH (Device -> Pinned)", 0.00025],
              ["Memset (Device)", 4.9999999999999996e-05]]
FROZEN_GAPS = [["bench.job/cudaDeviceSynchronize", 0.0008500000000000001],
               ["bench.job/aten::copy_", 0.00035], ["bench.window/bench.window", 0.00027],
               ["bench.job/aten::index", 9.999999999999999e-05]]


@pytest.mark.parametrize("cards", [None, [0]])
@pytest.mark.parametrize("in_args", [True, False])
def test_one_card_reads_exactly_as_before(cards, in_args):
    tr = from_events(one_card_events(in_args=in_args), cards)
    assert tr.cards == (0,)
    assert tr.window_s == 0.01
    assert tr.busy_s == 0.00843
    assert tr.busy_s_by_card() == {0: 0.00843}
    assert tr.device_seconds() == 0.00913
    assert tr.device_seconds(r"\bgather_kernel\b") == 0.0029
    assert tr.device_seconds("mode_") == 0.0024
    assert tr.top_ops() == FROZEN_OPS
    assert tr.top_ops(2) == FROZEN_OPS[:2]
    assert tr.top_gaps() == FROZEN_GAPS
    assert tr.top_gaps(1) == FROZEN_GAPS[:1]
    assert len(tr.ops) == 10 and len(tr.gaps) == 7


def test_a_missing_window_gives_no_trace():
    events = [e for e in one_card_events() if e.get("name") != "bench.window"]
    assert from_events(events) is None


@pytest.mark.parametrize("in_args", [True, False])
def test_two_cards_read_each_card_and_their_mean(in_args):
    events = one_card_events() + second_card_events()
    if not in_args:
        for e in events:
            e.pop("args", None)
    tr = from_events(events, [0, 1])
    assert tr.cards == (0, 1)
    by = tr.busy_s_by_card()
    assert by[0] == 0.00843 and by[1] == pytest.approx(0.004, rel=1e-12)
    assert tr.busy_s == pytest.approx((0.00843 + 0.004) / 2, rel=1e-12)
    assert tr.device_seconds(card=0) == 0.00913
    assert tr.device_seconds(card=1) == pytest.approx(0.004, rel=1e-12)
    assert tr.device_seconds() == pytest.approx((0.00913 + 0.004) / 2, rel=1e-12)
    assert tr.device_seconds("gather", card=1) == pytest.approx(0.001, rel=1e-12)
    assert tr.device_seconds("gather") == pytest.approx((0.0029 + 0.001) / 2, rel=1e-12)
    ops = dict(tr.top_ops())
    assert ops["cuda:0 gather_kernel"] == 0.0029
    assert ops["cuda:1 mode_mid_kernel"] == pytest.approx(0.002, rel=1e-12)
    assert ops["cuda:1 Memcpy HtoD (Pinned -> Device)"] == pytest.approx(0.001, rel=1e-12)
    assert all(name.startswith(("cuda:0 ", "cuda:1 ")) for name in ops)
    gaps = dict(tr.top_gaps())
    # card 1 idles 1000-2000 (window open, no job yet), 3000-7000 and
    # 10000-11000 (the host waiting in a job's synchronise)
    assert gaps["cuda:1 bench.window/bench.window"] == pytest.approx(0.001, rel=1e-12)
    assert gaps["cuda:1 bench.job/cudaDeviceSynchronize"] == pytest.approx(0.005, rel=1e-12)
    for label, seconds in FROZEN_GAPS:
        assert gaps["cuda:0 " + label] == seconds


def test_a_card_of_the_cell_that_ran_nothing_was_idle_all_through():
    tr = from_events(one_card_events(), [0, 1])
    assert tr.cards == (0, 1)
    assert tr.busy_s_by_card() == {0: 0.00843, 1: 0.0}
    assert tr.busy_s == pytest.approx(0.00843 / 2, rel=1e-12)
    assert dict(tr.top_gaps())["cuda:1 bench.window/bench.window"] == 0.01


def test_a_card_outside_the_cell_still_shows():
    tr = from_events(one_card_events() + second_card_events(), [0])
    assert tr.cards == (0, 1)
    assert tr.busy_s_by_card()[1] == pytest.approx(0.004, rel=1e-12)


def test_the_card_is_the_events_device_then_its_process():
    from benchmark.trace import event_card

    assert event_card({"pid": 0, "args": {"device": 3}}) == 3
    assert event_card({"pid": 2, "args": {"stream": 7}}) == 2
    assert event_card({"pid": 1}) == 1
