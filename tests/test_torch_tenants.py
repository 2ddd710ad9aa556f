"""repro_torch multi-tenant serving against the JAX reference: the tenant
config checks case for case, ``--tenant`` parsing, the weighted-fair
stride dispatch (``dispatch_log``, ``fairness_counters``) under several
weights with stub runners, a heterogeneous group of a dense and an ssm
model whose tokens per uid equal the reference group's, the routing and
binding errors, and the ``--tenant`` CLI on the CPU."""
import types

import jax
import numpy as np
import pytest

from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import TenantConfig as JTenantConfig
from repro.configs.registry import get_config as jax_config
from repro.launch.serve import parse_tenant_specs as jax_parse
from repro.models import api as japi
from repro.serving import EventLoop as JEventLoop
from repro.serving import EventLoopGroup as JEventLoopGroup
from repro.serving import Request as JRequest
from repro.serving import make_engine_group as jax_group
from repro_torch.configs.base import CommConfig, ServeConfig, TenantConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import from_numpy_params
from repro_torch.serving import (EventLoop, EventLoopGroup, Request,
                                 make_engine_group)

# (ServeConfig keywords, tenants as (name, weight, event_loops)): the
# reference's test_tenant_config_validation cases first, then the two
# checks it leaves untested
BAD_TENANTS = {
    "duplicate_name": (dict(event_loops=2), (("a", 1, 1), ("a", 1, 1))),
    "zero_weight": (dict(event_loops=2), (("a", 0, 1), ("b", 1, 1))),
    "loops_do_not_sum": (dict(event_loops=4), (("a", 1, 1), ("b", 1, 1))),
    "empty_name": (dict(event_loops=2), (("", 1, 1), ("b", 1, 1))),
    "zero_loops": (dict(event_loops=1), (("a", 1, 0), ("b", 1, 1))),
}


@pytest.mark.parametrize("case", sorted(BAD_TENANTS))
def test_tenant_config_errors_match_reference(case):
    kw, tenants = BAD_TENANTS[case]
    with pytest.raises(ValueError) as want:
        JServeConfig(comm=JCommConfig(mode="hadronio", channels=4,
                                      hierarchical=False),
                     tenants=tuple(JTenantConfig(n, weight=w, event_loops=e)
                                   for n, w, e in tenants), **kw)
    with pytest.raises(ValueError) as got:
        ServeConfig(comm=CommConfig(mode="hadronio", channels=4),
                    tenants=tuple(TenantConfig(n, weight=w, event_loops=e)
                                  for n, w, e in tenants), **kw)
    assert str(got.value) == str(want.value)


def test_valid_tenants_accepted():
    serve = ServeConfig(event_loops=3, comm=CommConfig(channels=4),
                        tenants=(TenantConfig("a", weight=2, event_loops=2),
                                 TenantConfig("b")))
    assert [t.name for t in serve.tenants] == ["a", "b"]


@pytest.mark.parametrize("specs", [
    ["chat=qwen2-0.5b"],
    ["chat=qwen2-0.5b:2", "rnn=rwkv6-7b:1"],
    ["a=qwen2-0.5b-reduced:3:2", "b=rwkv6-7b-reduced", "c=mixtral-8x7b:1:1"],
])
def test_parse_tenant_specs_matches_reference(specs):
    got = [(t.name, t.arch, t.weight, t.event_loops)
           for t in serve_cli.parse_tenant_specs(specs)]
    want = [(t.name, t.arch, t.weight, t.event_loops)
            for t in jax_parse(specs)]
    assert got == want


@pytest.mark.parametrize("spec", ["=qwen2-0.5b", "chat=", "chat"])
def test_parse_tenant_specs_rejects_what_reference_rejects(spec):
    with pytest.raises(ValueError) as want:
        jax_parse([spec])
    with pytest.raises(ValueError) as got:
        serve_cli.parse_tenant_specs([spec])
    assert str(got.value) == str(want.value)


def _stub_group(loop_cls, group_cls, bindings, n_loops):
    loops = []
    for i in range(n_loops):
        loop = loop_cls(i, channels=(i,))
        loop.runner = lambda l, items: [(l.index, it.uid) for it in items]
        loops.append(loop)
    return group_cls(loops, tenants=bindings)


# tenants as (name, weight, loops); items as tenant names ("" = untagged)
MIXES = {
    "1:1": ((("a", 1, 1), ("b", 1, 1)), "abababba" + "aa"),
    "2:1": ((("a", 2, 1), ("b", 1, 1)), "a" * 6 + "b" * 3),
    "3:2": ((("a", 3, 2), ("b", 2, 1)), "ab" * 5 + "a" * 4 + "_" * 2),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_stride_dispatch_matches_reference(mix):
    """The same mixed batches (two submits) through the reference's
    EventLoopGroup and the port's: equal dispatch logs, counters, per-loop
    queues and drained results."""
    tenants, names = MIXES[mix]
    bindings, start = [], 0
    for n, w, k in tenants:
        bindings.append((n, w, tuple(range(start, start + k))))
        start += k
    items = [types.SimpleNamespace(uid=u, tenant="" if t == "_" else t)
             for u, t in enumerate(names)]
    groups = [_stub_group(JEventLoop, JEventLoopGroup, bindings, start),
              _stub_group(EventLoop, EventLoopGroup, bindings, start)]
    for g in groups:
        g.submit(items[:5])
        g.submit(items[5:])
    want, got = groups
    assert list(got.dispatch_log) == list(want.dispatch_log)
    assert got.dispatch_log == list(want.dispatch_log)
    assert got.fairness_counters == want.fairness_counters
    assert [[it.uid for it in l.queue] for l in got.loops] == \
        [[it.uid for it in l.queue] for l in want.loops]
    assert got.run(threads=False) == want.run(threads=False)
    if mix == "2:1":                   # one batch: A A B A A B A A B
        one = _stub_group(EventLoop, EventLoopGroup, bindings, start)
        one.submit(items)
        assert one.dispatch_log == ["a", "a", "b"] * 3


def test_dispatch_log_is_bounded():
    loops = [EventLoop(0, channels=(0,)), EventLoop(1, channels=(1,))]
    g = EventLoopGroup(loops, tenants=(("a", 1, (0,)), ("b", 1, (1,))),
                       dispatch_log_capacity=4)
    g.submit([types.SimpleNamespace(uid=u, tenant="ab"[u % 2])
              for u in range(6)])
    assert list(g.dispatch_log) == ["a", "b", "a", "b"]
    assert g.dispatch_log.dropped == 2 and len(g.dispatch_log) == 4
    assert g.fairness_counters == {"a": 3, "b": 3}


def test_tenant_ranges_must_partition_the_loops():
    loops = [EventLoop(0, channels=(0,)), EventLoop(1, channels=(1,))]
    with pytest.raises(ValueError, match="partition"):
        EventLoopGroup(loops, tenants=(("a", 1, (0,)), ("b", 1, (0,))))


ARCHS = {"qwen": "qwen2-0.5b-reduced", "rwkv": "rwkv6-7b-reduced"}


@pytest.fixture(scope="module")
def pair():
    """Both -reduced models (f32), the JAX init's params in both
    packages: {tenant: (jax cfg, port cfg, jax params, port params)}."""
    out = {}
    for i, (name, arch) in enumerate(ARCHS.items()):
        jcfg = jax_config(arch)
        jp = japi.init(jax.random.PRNGKey(i), jcfg)
        out[name] = (jcfg, get_config(arch), jp,
                     from_numpy_params(jax.tree.map(np.asarray, jp), "cpu"))
    return out


def _serve(tenant_cls, serve_cls, comm_cls, wa=2, wb=1):
    return serve_cls(
        event_loops=2, poll="busy", max_batch=2, max_len=48,
        comm=comm_cls(mode="gspmd", channels=4),
        tenants=(tenant_cls("qwen", arch=ARCHS["qwen"], weight=wa),
                 tenant_cls("rwkv", arch=ARCHS["rwkv"], weight=wb)))


def _mixed_requests(req_cls):
    rng = np.random.default_rng(3)
    reqs = []
    for uid in range(8):
        t = "qwen" if uid % 2 == 0 else "rwkv"
        # the ssm engine buckets equal lengths: pairs of equal prompts
        n = int(rng.integers(4, 20)) if t == "qwen" else 6 + 4 * (uid // 4)
        reqs.append(req_cls(uid, rng.integers(0, 256, size=n),
                            max_new=3 + uid % 3, tenant=t))
    return reqs


def test_two_families_one_group_match_reference(pair):
    """qwen2-0.5b-reduced and rwkv6-7b-reduced side by side in ONE group
    (threaded, gspmd): tokens per uid, dispatch log and counters equal
    the reference group's, and each tenant's tokens equal its
    single-tenant group's."""
    jgrp = jax_group({n: p[0] for n, p in pair.items()},
                     {n: p[2] for n, p in pair.items()},
                     _serve(JTenantConfig, JServeConfig, JCommConfig))
    jgrp.submit(_mixed_requests(JRequest))
    want = {r.uid: tuple(r.tokens.tolist()) for r in jgrp.run(threads=True)}
    grp = make_engine_group({n: p[1] for n, p in pair.items()},
                            {n: p[3] for n, p in pair.items()},
                            _serve(TenantConfig, ServeConfig, CommConfig),
                            device="cpu")
    reqs = _mixed_requests(Request)
    grp.submit(reqs)
    got = {r.uid: tuple(r.tokens.tolist()) for r in grp.run(threads=True)}
    assert got == want
    assert [len(got[r.uid]) for r in reqs] == [r.max_new for r in reqs]
    assert grp.dispatch_log == list(jgrp.dispatch_log)
    assert grp.fairness_counters == jgrp.fairness_counters \
        == {"qwen": 4, "rwkv": 4}
    assert [l.engine.cfg.name for l in grp.loops] == list(ARCHS.values())
    for name, (_, tcfg, _, tp) in pair.items():
        solo = make_engine_group(tcfg, tp, ServeConfig(
            event_loops=1, max_batch=2, max_len=48,
            comm=CommConfig(mode="gspmd", channels=2)), device="cpu")
        solo.submit([Request(r.uid, r.prompt, max_new=r.max_new)
                     for r in reqs if r.tenant == name])
        alone = {r.uid: tuple(r.tokens.tolist())
                 for r in solo.run(threads=False)}
        assert {u: got[u] for u in alone} == alone, name


def test_routing_rules(pair):
    """Untagged requests ride the FIRST tenant; an unknown tenant name
    is rejected at submit."""
    _, tcfg, _, tp = pair["qwen"]
    grp = make_engine_group(tcfg, tp, _serve(TenantConfig, ServeConfig,
                                             CommConfig), device="cpu")
    grp.submit(Request(0, np.arange(4), max_new=0))
    assert grp.dispatch_log == ["qwen"]
    with pytest.raises(ValueError, match="unknown tenant 'nobody'"):
        grp.submit(Request(1, np.arange(4), max_new=0, tenant="nobody"))


def test_binding_errors_match_reference(pair):
    """A per-tenant cfg/params dict must key exactly the tenant names;
    per-tenant dicts without tenants are rejected (the reference's
    texts)."""
    jcfg, tcfg, jp, tp = pair["qwen"]
    cases = [
        (lambda g, c, p, s: g({"qwen": c, "other": c},
                              {"qwen": p, "other": p}, s), "tenants"),
        (lambda g, c, p, s: g({"qwen": c}, {"qwen": p}, s), "single"),
    ]
    for call, serve_kind in cases:
        def serves(serve_cls, comm_cls, tenant_cls):
            if serve_kind == "single":
                return serve_cls(event_loops=1,
                                 comm=comm_cls(mode="gspmd", channels=2))
            return _serve(tenant_cls, serve_cls, comm_cls)
        with pytest.raises(ValueError) as want:
            call(jax_group, jcfg, jp, serves(JServeConfig, JCommConfig,
                                             JTenantConfig))
        with pytest.raises(ValueError) as got:
            call(lambda c, p, s: make_engine_group(c, p, s, device="cpu"),
                 tcfg, tp, serves(ServeConfig, CommConfig, TenantConfig))
        assert str(got.value) == str(want.value)


def test_explicit_affinity_checked():
    cfg = get_config("qwen2-0.5b-reduced")
    serve = ServeConfig(event_loops=2, comm=CommConfig(channels=4))
    with pytest.raises(ValueError, match="must partition channels"):
        make_engine_group(cfg, {}, serve, device="cpu",
                          affinity=((0, 1), (1, 2, 3)))
    with pytest.raises(ValueError, match="must partition channels"):
        make_engine_group(cfg, {}, serve, device="cpu",
                          affinity=((0, 1, 2, 3), ()))


def test_tenant_cli_on_cpu(capsys):
    """The --tenant CLI: two families, weights 2:1, one loop each; the
    fairness line is the stride sequence."""
    assert serve_cli.main([
        "--device", "cpu", "--requests", "6", "--max-new", "3",
        "--tenant", "chat=qwen2-0.5b-reduced:2",
        "--tenant", "rnn=rwkv6-7b-reduced:1"]) == 0
    out = capsys.readouterr().out
    assert "[serve] 6 requests, 18 tokens" in out
    assert ("[serve] tenants: fairness={'chat': 3, 'rnn': 3} dispatch="
            "['chat', 'chat', 'rnn', 'chat', 'rnn', 'rnn']") in out
    assert "2 event loop(s)" in out


@pytest.mark.parametrize("extra", [[], ["--arch", "qwen2-0.5b-reduced"],
                                   ["--ckpt", "/nonexistent"]])
def test_tenant_cli_rejects_mixed_arguments(extra, capsys):
    argv = ["--device", "cpu"] + extra
    if extra:
        argv += ["--tenant", "chat=qwen2-0.5b-reduced"]
    with pytest.raises(SystemExit) as e:
        serve_cli.main(argv)
    assert e.value.code == 2
    assert "--arch" in capsys.readouterr().err
