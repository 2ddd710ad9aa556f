"""On the card (skipped without one): each cell runs at its own size for
a short window and comes out correct, and the float8 control, put in the
program's place, fails the cell's comparison. Run on the chip with

    python -m pytest -q -m cuda portbench/tests
"""
import time

import pytest
import torch

from portbench import harness, serve, spec, train

ROOT = spec.BENCH_DIR.parent
SEED = 3_141_592_653


@pytest.mark.cuda
@pytest.mark.parametrize("workload,seconds", [
    ("starcoder2-3b-15L.serve_code", 8.0),
    # long enough to finish the 256 served tokens a run compares
    ("mixtral-8x7b-16L.serve_offline", 20.0)])
def test_serving_cell_and_its_control(card, workload, seconds, monkeypatch):
    seen = {}
    real = serve.reference_gaps

    def reference_gaps(cell, flat, seqs):
        out = real(cell, flat, seqs)
        ref = spec.find_reference(cell.config)
        f32 = ref.served_logits(flat, cell.config, seqs)
        q = ref.served_logits(flat, cell.config, seqs, "fp8")
        gaps = serve.logit_gaps(f32, seqs, pick=q)
        seen.update({n: fn(gaps) for n, fn in serve.GAP_STATS.items()})
        return out
    monkeypatch.setattr(serve, "reference_gaps", reference_gaps)
    line = harness.run_cell(ROOT, workload, SEED, seconds, False, card,
                            time.perf_counter())
    assert line["correct"], line["checks"]
    # the control fails a number the cell compares
    compared = [n for n in serve.GAP_STATS if n in line["checks"]]
    assert compared and any(seen[n] > line["checks"][n]["limit"]
                            for n in compared)


@pytest.mark.cuda
def test_training_cell_and_its_control(card, monkeypatch):
    seen = {}
    real = train.check

    def check(cell, seed, device, batch, start, after):
        out = real(cell, seed, device, batch, start, after)
        base = train.reference(cell, seed, device, batch)
        fp8 = train.reference(cell, seed, device, batch, "fp8")
        seen["control"] = train.compare(fp8, base)
        return out
    monkeypatch.setattr(train, "check", check)
    line = harness.run_cell(ROOT, "starcoder2-3b-15L.train_hadronio", SEED,
                            6.0, False, card, time.perf_counter())
    assert line["correct"], line["checks"]
    # the control fails a number of the start that the cell compares
    assert any(seen["control"].get(k, 0.0) > c["limit"]
               for k, c in line["checks"].items())
