"""The traffic generators are deterministic in the seed, and every seed
offers the same work in another order."""
import numpy as np
import pytest
import torch

from portbench import spec

BIG = 2 ** 31 + 12_345


def _gen(mix_name):
    mix = spec.find_traffic(mix_name)
    return mix, spec.find_generator(mix["generator"])


def _sizes(reqs):
    return sorted(len(r["prompt"]) for r in reqs), \
        sorted(r["max_new"] for r in reqs)


@pytest.mark.parametrize("mix_name", ["serve_code", "serve_offline"])
def test_same_seed_same_requests(mix_name):
    mix, gen = _gen(mix_name)
    a = gen.generate(mix, BIG, 30.0, 49_152)
    b = gen.generate(mix, BIG, 30.0, 49_152)
    assert [r["due"] for r in a] == [r["due"] for r in b]
    assert all(np.array_equal(x["prompt"], y["prompt"])
               for x, y in zip(a, b))
    c = gen.generate(mix, BIG + 1, 30.0, 49_152)
    assert _sizes(a) == _sizes(c)
    assert [len(r["prompt"]) for r in a] != [len(r["prompt"]) for r in c]


def test_open_loop_rate_and_lengths():
    # serve_code's sizes sent on a Poisson schedule: a mix that adds
    # ``generator`` and ``rate_per_s`` as data
    mix, _ = _gen("serve_code")
    mix = dict(mix, generator="open_loop", rate_per_s=3.5)
    mix.pop("backlog")
    gen = spec.find_generator("open_loop")
    reqs = gen.generate(mix, BIG, 30.0, 49_152)
    due = np.array([r["due"] for r in reqs])
    assert len(reqs) == int(mix["rate_per_s"] * 30) // 4 * 4
    assert np.all(np.diff(due) > 0) and due[-1] < 30.0
    plen = np.array([len(r["prompt"]) for r in reqs])
    assert plen.min() >= 2048 and plen.max() <= 4032
    assert max(plen) + max(r["max_new"] for r in reqs) \
        <= mix["engine"]["max_len"]
    ids = np.concatenate([r["prompt"] for r in reqs])
    assert ids.min() >= 0 and ids.max() < 49_152


@pytest.mark.parametrize("mix_name", ["serve_code", "serve_offline"])
def test_every_block_spans_the_law(mix_name):
    mix, gen = _gen(mix_name)
    reqs = gen.generate(mix, BIG, 51.0, 32_000)
    b = mix["block"]
    assert len(reqs) % b == 0
    for get in (lambda r: len(r["prompt"]), lambda r: r["max_new"]):
        strata = np.sort([get(r) for r in reqs]).reshape(b, -1)
        lo, hi = strata.min(axis=1), strata.max(axis=1)
        for i in range(0, len(reqs), b):
            v = np.sort([get(r) for r in reqs[i:i + b]])
            assert np.all((lo <= v) & (v <= hi)), i


@pytest.mark.parametrize("mix_name,lo,step", [("serve_offline", 512, 16),
                                               ("serve_code", 2048, 1)])
def test_backlog_sizes(mix_name, lo, step):
    mix, gen = _gen(mix_name)
    reqs = gen.generate(mix, BIG, 51.0, 32_000)
    assert len(reqs) == mix["backlog"]
    assert all(r["due"] == 0.0 for r in reqs)
    plen = [len(r["prompt"]) for r in reqs]
    assert all(p % step == 0 for p in plen) and min(plen) >= lo
    assert max(plen) + mix["output"]["max"] <= mix["engine"]["max_len"]


def test_train_batches_deterministic_and_distinct():
    mix, gen = _gen("train_hadronio")
    small = dict(mix, seq_len=16)
    a = gen.batch(small, BIG, 1, 49_152, torch.device("cpu"))
    b = gen.batch(small, BIG, 1, 49_152, torch.device("cpu"))
    c = gen.batch(small, BIG, 2, 49_152, torch.device("cpu"))
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    rows = {tuple(r.tolist()) for r in a["tokens"]}
    assert len(rows) == mix["global_batch"]
