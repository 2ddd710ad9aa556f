"""The split of the card's idle time by the program span the host was in
(``portbench/idle.py``), on a made-up device trace and spans: exact
overlap, the innermost span wins, time outside every span is counted,
and the shares add up to ``device_idle``; each new metric is found by
name, reads None untraced and None where the program has no span of its
kind."""
import pytest

from portbench import devtrace, idle, readers, spec

METRICS = {"idle_forward.train": "forward",
           "idle_backward.train": "backward",
           "idle_update.train": "update",
           "idle_boundary.serve": "boundary",
           "idle_experts.serve": "experts"}


def _win(events, t0=10.0, t1=11.0):
    w = devtrace.Window(False)
    w.t_start, w.t_stop, w.events = t0, t1, events
    return w


# busy 10.0-10.1, 10.3-10.4, 10.8-10.9: idle 10.1-10.3, 10.4-10.8,
# 10.9-11.0 (0.7 s of the 1 s window)
EVENTS = [("a", 10.0, 10.1), ("b", 10.3, 10.4), ("c", 10.8, 10.9)]
SPANS = [("step", 9.9, 10.7),              # outer
         ("forward", 10.15, 10.35),        # inside step
         ("emission", 10.2, 10.25),        # inside forward: innermost
         ("backward", 10.5, 10.65),
         ("step", 10.75, 10.85)]


def test_split_by_innermost_span_exactly():
    rec = {"win": _win(EVENTS), "spans": SPANS}
    split = idle.split_pct(rec)
    # 10.1-10.3: step 10.1-10.15, forward 10.15-10.2 and 10.25-10.3,
    # emission 10.2-10.25; 10.4-10.8: step 10.4-10.5 and 10.65-10.7,
    # backward 10.5-10.65, outside 10.7-10.75, step 10.75-10.8;
    # 10.9-11.0: outside
    want = {"step": 5 + 10 + 5 + 5, "forward": 10, "emission": 5,
            "backward": 15, idle.OUTSIDE: 5 + 10}
    assert split.keys() == want.keys()
    for k, v in want.items():
        assert split[k] == pytest.approx(v), k
    assert sum(split.values()) == pytest.approx(
        readers.device_idle_pct(rec), abs=1e-9)
    # a gap's midpoint would have named 10.4-10.8 (0.4 s) backward
    assert idle.innermost_pct(rec, "backward") == pytest.approx(15.0)
    assert idle.outside_pct(rec, "step") == pytest.approx(15.0)
    assert spec.find_reader("idle_between_steps.train")(rec) == \
        pytest.approx(15.0)
    assert spec.find_reader("idle_forward.train")(rec) == \
        pytest.approx(10.0)
    assert spec.find_reader("idle_update.train")(rec) is None


def test_innermost_is_the_shortest_holding_span():
    pieces = idle.innermost([("step", 0.0, 10.0), ("forward", 1.0, 3.0),
                             ("emission", 2.0, 2.5), ("boundary", 3.0, 4.0)],
                            0.5, 5.0)
    assert pieces == [(0.5, 1.0, "step"), (1.0, 2.0, "forward"),
                      (2.0, 2.5, "emission"), (2.5, 3.0, "forward"),
                      (3.0, 4.0, "boundary"), (4.0, 5.0, "step")]
    assert idle.innermost([], 0.0, 1.0) == [(0.0, 1.0, idle.OUTSIDE)]


def test_shares_add_up_on_a_busier_trace():
    events = [(f"k{i}", 10.0 + 0.013 * i, 10.0 + 0.013 * i + 0.004 * (i % 3))
              for i in range(70)]
    spans = [("step", 10.0 + 0.25 * j, 10.0 + 0.25 * j + 0.2)
             for j in range(4)]
    spans += [("update", 10.15 + 0.25 * j, 10.19 + 0.25 * j)
              for j in range(4)]
    spans += [("boundary", 10.95, 10.97)]
    rec = {"win": _win(events), "spans": spans}
    split = idle.split_pct(rec)
    assert sum(split.values()) == pytest.approx(
        readers.device_idle_pct(rec), abs=1e-9)
    assert split["update"] > 0 and split[idle.OUTSIDE] > 0
    assert idle.outside_pct(rec, "step") == pytest.approx(
        split[idle.OUTSIDE] + split["boundary"])


@pytest.mark.parametrize("name", sorted(METRICS) +
                         ["idle_between_steps.train"])
def test_new_metrics_found_and_none_untraced(name):
    read = spec.find_reader(name)
    kind = METRICS.get(name, "step")
    untraced = devtrace.Window(False)
    assert read({"win": untraced, "spans": [(kind, 1.0, 2.0)]}) is None
    # traced, but the program opened no span of the kind (a parent
    # commit without it): left out, not 0
    assert read({"win": _win(EVENTS), "spans": [("decode", 10.0, 10.5)]}) \
        is None
    assert read({"win": _win(EVENTS), "spans": [(kind, 10.0, 10.5)]}) \
        is not None
