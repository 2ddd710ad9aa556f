"""The plain reference agrees with the port at a reduced size on the
CPU: served logits through prefill and decoding through the cache, the
experts' per-row capacity drops included, and the training loss and
gradients. (The test imports both; the reference imports neither the
port nor JAX.)"""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import program, weights
from portbench.reference import decoder as ref
from portbench.tests import tiny


def _cfg(tmp_path, name):
    _, bench = tiny.make(tmp_path)
    return json.loads((bench / "configs" / f"{name}.json").read_text())


def _program_logits(flat, cfg, prompt, served):
    """The port's logits at each served position: its prefill, then one
    decode step per served token, through the cache."""
    from repro_torch.models import api
    pcfg = program.model_config(cfg)
    params = weights.nest(flat)
    toks = torch.as_tensor(prompt)[None].long()
    logits, cache = api.prefill(params, {"tokens": toks,
                                         "last_pos": torch.tensor([len(prompt)
                                                                   - 1])},
                                pcfg)
    cache = api.grow_cache(pcfg, cache, len(prompt) + len(served) + 1)
    out = [logits[0]]
    for i, t in enumerate(served[:-1]):
        logits, cache = api.decode_step(
            params, cache, {"token": torch.tensor([int(t)]),
                            "pos": torch.tensor([len(prompt) + i])}, pcfg)
        out.append(logits[0])
    return torch.stack(out)


@pytest.mark.parametrize("name", ["starcoder2-3b-15L", "mixtral-8x7b-16L"])
def test_served_logits_match_the_port(tmp_path, name):
    cfg = _cfg(tmp_path, name)
    flat = weights.make(cfg, 2 ** 31 + 5, torch.device("cpu"))
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg["vocab_size"], 48).astype(np.int32)
    if "layers.moe.router" in flat:
        prompt[16:] = 7      # one token repeated: its experts overflow
    served = rng.integers(0, cfg["vocab_size"], 6).astype(np.int64)
    got = _program_logits(flat, cfg, prompt, served)
    want = ref.served_logits(flat, cfg, [{"prompt": prompt, "served": served,
                                          "padded_len": len(prompt)}])[0]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if "layers.moe.router" in flat:
        undropped = dict(cfg, capacity_factor=100.0)
        loose = ref.served_logits(flat, undropped, [{
            "prompt": prompt, "served": served, "padded_len": len(prompt)}])
        assert (loose[0] - want).abs().max() > 1e-3   # drops happened


def test_training_loss_and_gradients_match_the_port(tmp_path):
    from repro_torch.models import api
    cfg = _cfg(tmp_path, "starcoder2-3b-15L")
    flat = weights.make(cfg, 11, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg["vocab_size"], (2, 17), generator=gen)
    tk, lb = ids[:, :-1], ids[:, 1:]
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss, _ = api.loss(weights.nest(leaves), {"tokens": tk, "labels": lb},
                       program.model_config(cfg))
    loss.backward()
    mine = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    rl = ref.loss(mine, tk, lb, cfg)
    rl.backward()
    torch.testing.assert_close(loss, rl, rtol=1e-5, atol=1e-6)
    for k in flat:
        torch.testing.assert_close(leaves[k].grad, mine[k].grad, rtol=1e-4,
                                   atol=1e-6)


def test_reference_imports_nothing_of_the_program():
    src = (Path(ref.__file__)).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "typing", "torch"}
