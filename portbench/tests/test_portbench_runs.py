"""Whole runs of each cell on the CPU at a tiny size, through the
harness that the card runs (only its look for a card is skipped): the
run comes out correct, and with the timed path broken underneath it
comes out not correct, once for each fault the cell can have; the
float8 control fails the comparison too."""
import time

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.reference import decoder as ref
from portbench.tests import tiny

TRAIN = {"loss_gap": 1e-6, "grad_gap": 1e-5, "change_gap": 1e-4}
LIMITS = {"starcoder2-3b-15L.serve_code": {"logit_gap": 1e-4},
          "mixtral-8x7b-16L.serve_offline": {"logit_gap": 1e-4,
                                             "request_median_gap": 1e-4},
          "starcoder2-3b-15L.train_hadronio": dict(
              TRAIN, count_off=0,
              **{"last_" + k: v for k, v in TRAIN.items()})}
SEED = 2 ** 31 + 77


def _run(tmp_path, cell, seconds=None):
    # a serving window long enough to finish the tokens a check compares
    # on a loaded machine; training's needs only a few steps
    seconds = seconds or (1.0 if "train" in cell else 3.0)
    root, bench = tiny.make(tmp_path, LIMITS)
    return harness.run_cell(root, cell, SEED, seconds, False,
                            torch.device("cpu"), time.perf_counter(), bench)


@pytest.mark.parametrize("cell", sorted(LIMITS))
def test_cell_is_correct(tmp_path, cell):
    line = _run(tmp_path, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2
    assert list(line)[-1] == "checks"


def test_serve_token_altered_where_produced(tmp_path, monkeypatch):
    from repro_torch.serving import engine
    real = engine.DecodeEngine._sample
    calls = {"n": 0}

    def altered(self, logits, temps):
        tok = real(self, logits, temps)
        calls["n"] += 1
        if calls["n"] % 5 == 0:
            tok = (tok + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(engine.DecodeEngine, "_sample", altered)
    line = _run(tmp_path, "starcoder2-3b-15L.serve_code")
    assert not line["correct"]
    assert line["checks"]["logit_gap"]["value"] > 1e-4


def test_open_loop_mix_runs_correct(tmp_path):
    """A mix that sends each request when it is due (``open_loop``),
    added as data alone, runs through the same harness."""
    import json
    root, bench = tiny.make(tmp_path, LIMITS)
    path = bench / "traffic" / "serve_code.json"
    mix = json.loads(path.read_text())
    mix.pop("backlog")
    path.write_text(json.dumps(dict(mix, generator="open_loop",
                                    rate_per_s=40.0)))
    line = harness.run_cell(root, "starcoder2-3b-15L.serve_code", SEED, 1.0,
                            False, torch.device("cpu"), time.perf_counter(),
                            bench)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 40 and line["failed"] == 0


def test_request_median_gap_sees_one_request_served_wrong():
    """One request of four served wrong throughout (one faulty slot)
    moves the worst request's median however few its tokens, where the
    median of all tokens stays put."""
    from portbench import serve
    ok = [np.zeros(8), np.zeros(20), np.zeros(30), np.zeros(30)]
    bad = ok[:1] + [np.full(20, 9.0)] + ok[2:]
    stat = serve.GAP_STATS["request_median_gap"]
    assert stat(ok) == 0.0 and stat(bad) == 9.0
    assert serve.GAP_STATS["logit_gap_median"](bad) == 0.0


def test_serve_request_lost(tmp_path, monkeypatch):
    from repro_torch.serving import engine
    real = engine.DecodeEngine.generate

    def lossy(self, reqs):
        return [r for r in real(self, reqs) if r.uid % 7 != 3]
    monkeypatch.setattr(engine.DecodeEngine, "generate", lossy)
    line = _run(tmp_path, "mixtral-8x7b-16L.serve_offline")
    assert not line["correct"]
    assert line["checks"]["miscounted"]["value"] > 0


def _train_fault(monkeypatch, make):
    from repro_torch.launch import train as train_mod
    real = train_mod.steps_mod.make_train_step
    monkeypatch.setattr(train_mod.steps_mod, "make_train_step",
                        lambda *a, **k: make(real(*a, **k)))


def test_train_state_left_unchanged(tmp_path, monkeypatch):
    def make(_step):
        return lambda state, batch: (state, {
            "loss": torch.tensor(5.5), "lr": 0.0,
            "grad_norm": torch.tensor(1.0)})
    _train_fault(monkeypatch, make)
    line = _run(tmp_path, "starcoder2-3b-15L.train_hadronio")
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_fault_after_the_first_steps(tmp_path, monkeypatch, fault):
    """A step that goes wrong only after the checked first steps, as a
    warm path or a captured graph could: the step after the window
    catches it, and the start's numbers stay within their limits."""
    def make(step):
        calls = {"n": 0}

        def faulty(state, batch):
            calls["n"] += 1
            if calls["n"] <= 3:
                return step(state, batch)
            if fault == "unchanged":
                return state, {"loss": torch.tensor(5.5), "lr": 0.0,
                               "grad_norm": torch.tensor(1.0)}
            return step(state, {k: v[: v.shape[0] // 2]
                                for k, v in batch.items()})
        return faulty
    _train_fault(monkeypatch, make)
    line = _run(tmp_path, "starcoder2-3b-15L.train_hadronio")
    c = line["checks"]
    assert not line["correct"]
    assert all(c[k]["value"] <= c[k]["limit"] for k in TRAIN)
    if fault == "unchanged":
        assert c["count_off"]["value"] > 0
        assert c["last_change_gap"]["value"] == pytest.approx(1.0)
    else:
        assert c["last_grad_gap"]["value"] > TRAIN["grad_gap"]


def test_train_half_batch_left_out(tmp_path, monkeypatch):
    def make(step):
        return lambda state, batch: step(
            state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    _train_fault(monkeypatch, make)
    line = _run(tmp_path, "starcoder2-3b-15L.train_hadronio")
    assert not line["correct"]
    assert line["checks"]["grad_gap"]["value"] > 1e-5


def test_train_exchange_result_lost(tmp_path, monkeypatch):
    from repro_torch.core import tac
    from repro_torch.models.common import tree_map
    real = tac.sync_grads

    def lost(grads, comm, **kw):
        res = real(grads, comm, **kw)
        return res._replace(grads=tree_map(torch.zeros_like, res.grads))
    monkeypatch.setattr(tac, "sync_grads", lost)
    line = _run(tmp_path, "starcoder2-3b-15L.train_hadronio")
    assert not line["correct"]
    assert line["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_float8_control_fails_the_serving_limit(tmp_path):
    root, bench = tiny.make(tmp_path, LIMITS)
    import json
    cfg = json.loads((bench / "configs" / "starcoder2-3b-15L.json")
                     .read_text())
    flat = weights.make(cfg, SEED, torch.device("cpu"))
    rng = np.random.default_rng(0)
    # at this width the tied table makes the current token the first
    # choice by a wide margin at most positions (not so at the cell's
    # width): 32 served tokens a sequence give float8 room to flip one
    seqs = [{"prompt": rng.integers(0, 256, 40).astype(np.int32),
             "served": rng.integers(0, 256, 32), "padded_len": 40}
            for _ in range(4)]
    from portbench import serve
    f32 = ref.served_logits(flat, cfg, seqs)
    q = ref.served_logits(flat, cfg, seqs, "fp8")
    gap = serve.GAP_STATS["logit_gap"](serve.logit_gaps(f32, seqs, pick=q))
    assert gap > LIMITS["starcoder2-3b-15L.serve_code"]["logit_gap"]
