"""The per-layer readers' arithmetic on a made-up device trace: busy and
idle time, a kernel's share, the ring-pack roofline per profiled step,
and a reader that finds nothing returns None."""
import pytest

from portbench import devtrace, flops, spec

SC = spec.find_config("starcoder2-3b-15L")


def _win(events, t0=10.0, t1=11.0):
    w = devtrace.Window(False)
    w.t_start, w.t_stop, w.events = t0, t1, events
    return w


def test_busy_union_and_gaps_named_by_span():
    w = _win([("a", 10.1, 10.3), ("b", 10.2, 10.4), ("c", 10.6, 10.7)])
    assert devtrace.busy_s(w) == pytest.approx(0.4)
    bd = devtrace.breakdown(w, [("decode", 10.35, 10.65)])
    assert bd["idle_gaps"][0][0] == "outside the program's spans"   # 0.3 s
    assert bd["idle_gaps"][0][1] == pytest.approx(0.3)
    assert ["decode", pytest.approx(0.2)] in bd["idle_gaps"]
    assert [n for n, _ in bd["device_ops"]] == ["a", "b", "c"]
    idle = spec.find_reader("device_idle.serve")({"win": w})
    assert idle == pytest.approx(60.0)


def test_ring_pack_roofline_per_profiled_step():
    n = flops.param_count(SC)
    t = flops.ring_pack_bytes(n, "none") / flops.PEAK_HBM_BYTES_S / 0.8
    ev = [("void (anonymous namespace)::pack_kernel<float, false>(...)",
           10.0 + i, 10.0 + i + t) for i in range(3)]
    ev.append(("ncclDevKernel_AllReduce_Sum_f32", 13.5, 13.501))
    w = _win(ev, 10.0, 14.0)
    rec = {"win": w, "profiled_steps": 3, "cfg": SC,
           "mix": {"comm": {"compress": "none"}}}
    assert spec.find_reader("ring_pack_roofline.train")(rec) == \
        pytest.approx(80.0)
    assert spec.find_reader("exchange_device_ms.train")(rec) == \
        pytest.approx((3 * t + 0.001) / 3 * 1e3)
    rec["win"] = _win([], 10.0, 14.0)
    assert spec.find_reader("ring_pack_roofline.train")(rec) is None
    assert spec.find_reader("device_idle.train")(rec) is None


def test_flash_share():
    ev = [("void (anonymous namespace)::tc::flash_fwd_tc<128>(...)", 10.0,
           10.1), ("nvjet_gemm", 10.1, 10.4)]
    assert spec.find_reader("flash_device_share")({"win": _win(ev)}) == \
        pytest.approx(25.0)
