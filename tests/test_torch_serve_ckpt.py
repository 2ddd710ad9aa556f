"""``repro_torch.launch.serve --ckpt``: serving the params of a train
checkpoint, against the reference's ``load_params`` (f32, CPU).

A reduced moe model (``mixtral-8x7b-reduced``) trains two steps through
the port's ``Trainer`` (hadronio, bf16 wire, ring-pack path), which
writes its checkpoints with the port's store. Then:

* the serve CLI restores the LATEST step's params bitwise equal to the
  trained state's and says so (``[serve] restored params from step 2``);
* the reference's ``load_params`` reads the same directory (the stores
  interchange byte for byte), and its engine group serves the same
  tokens from those params as the port's group from its own;
* a directory without ``LATEST`` serves the ``--seed`` init;
* a checkpoint of another layout (a leaf missing, a leaf of another
  shape) raises: nothing falls back to random weights.
"""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_parity import requests, served_tokens

from repro.configs.registry import get_config as jax_config
from repro.launch.serve import load_params as jax_load_params
from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.launch.train import Trainer
from repro_torch.models import api
from repro_torch.models.common import tree_paths

ARCH = "mixtral-8x7b-reduced"
BATCH, MAX_LEN = 2, 48


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A checkpoint directory of two trained steps, and the live state."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    run = RunConfig(model=get_config(ARCH),
                    shape=ShapeConfig("t", "train", 16, 4),
                    comm=CommConfig(mode="hadronio", compress="bf16",
                                    pack="pallas", slice_bytes=64 * 1024),
                    total_steps=2, warmup_steps=1, checkpoint_dir=ckpt,
                    checkpoint_every=1)
    trainer = Trainer(run, device="cpu", log_fn=lambda line: None)
    try:
        state = trainer.run_loop()["state"]
    finally:
        trainer.close()
    return ckpt, state


def _load(cfg, ckpt, **kw):
    return serve.load_params(cfg, ckpt=ckpt, batch=BATCH, max_len=MAX_LEN,
                             seed=0, device="cpu", **kw)


def test_cli_restores_params_bitwise(trained, capsys, monkeypatch):
    ckpt, state = trained
    restored = []
    real = serve.load_params
    monkeypatch.setattr(serve, "load_params",
                        lambda *a, **k: restored.append(real(*a, **k))
                        or restored[-1])
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--ckpt", ckpt,
                       "--requests", "3", "--max-new", "3", "--batch",
                       str(BATCH), "--max-len", str(MAX_LEN)]) == 0
    out = capsys.readouterr().out
    assert "[serve] restored params from step 2" in out
    assert "[serve] 3 requests, 9 tokens" in out
    got, want = dict(tree_paths(restored[0])), dict(tree_paths(state.params))
    assert sorted(got) == sorted(want)
    for path, t in want.items():
        assert got[path].dtype == t.dtype and torch.equal(got[path], t), \
            path


def test_served_tokens_match_reference_load_params(trained):
    ckpt, _ = trained
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    args = argparse.Namespace(ckpt=ckpt, max_len=MAX_LEN, batch=BATCH,
                              seed=0)
    jp = jax_load_params(args, jcfg)
    tp = _load(tcfg, ckpt, log=lambda line: None)
    # the same numbers on both sides before any token is compared
    jl = {".".join(str(k.key) for k in path): np.asarray(leaf) for path, leaf
          in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for path, t in tree_paths(tp):
        np.testing.assert_array_equal(t.numpy(), jl[path])
    reqs = requests((5, 9, 12, 7), (4, 6), seed=3)
    want, got, _ = served_tokens(jcfg, tcfg, jp, tp, reqs,
                                 max_len=MAX_LEN)
    assert got == want
    assert all(len(t) in (4, 6) for t in got)


def test_directory_without_latest_serves_seed_init(tmp_path, capsys):
    cfg = get_config(ARCH)
    got = _load(cfg, str(tmp_path))
    assert "restored" not in capsys.readouterr().out
    want = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for (p, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("other, error", [
    (dict(arch="qwen2-0.5b-reduced"), KeyError),      # no moe leaves
    (dict(replace=dict(d_ff=96)), ValueError)])        # expert widths
def test_mismatched_layout_raises(trained, other, error):
    ckpt, _ = trained
    cfg = get_config(other.get("arch", ARCH))
    if "replace" in other:
        cfg = dataclasses.replace(cfg, **other["replace"])
    with pytest.raises(error, match="checkpoint"):
        _load(cfg, ckpt, log=lambda line: None)
