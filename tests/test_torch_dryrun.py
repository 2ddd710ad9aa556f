"""repro_torch's dry run (``launch/dryrun.py``) against the JAX reference's.

* THE TRACED STEP — ``main`` runs qwen2-0.5b-reduced x train_4k on the
  256-peer production mesh in ``hadronio``, ``hadronio_rs`` and
  ``hadronio_overlap_rs``, each in a subprocess of its own (a fake
  process group cannot share a process with a real one), beside the
  reference's ``_lower_cell`` of the same cells in a JAX subprocess
  (importing ``repro.launch.dryrun`` forces 512 host devices). The
  artifact's collective counts and result bytes by kind equal the
  reference's ``stablehlo_collective_stats``; its keys are the
  reference's artifact keys (read off ``repro/launch/dryrun.py``) plus
  the port's own; the model FLOPs and analytic bytes are the
  reference's; ``--skip-existing`` reuses an ``ok`` artifact.
* CELLS IT CANNOT RUN — a dense model's ``long_500k`` is a ``skip`` with
  the reference's reason; ``gspmd`` and ``prefill_32k`` are ``fail``
  with the named ``NotImplementedError``; ``main`` writes every artifact
  under ``--out`` and returns 1 only when a cell failed.
"""
import ast
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.launch import dryrun

try:
    import jax
    from repro.configs.base import cell_skip_reason as jreason
    from repro.configs.registry import get_config as jax_config
    from repro.configs.registry import get_shape as jax_shape
    from repro.launch import hlo_analysis as jhlo
except ImportError:
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-0.5b-reduced"
MODES = ("hadronio", "hadronio_rs", "hadronio_overlap_rs")

_JAX = textwrap.dedent('''
    import json, sys
    from repro import compat
    from repro.configs.registry import get_config, get_shape
    from repro.launch import dryrun, hlo_analysis as hlo
    from repro.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=False)
    out = {}
    with compat.set_mesh(mesh):
        for mode in sys.argv[2:]:
            low = dryrun._lower_cell(get_config("%s"), get_shape("train_4k"),
                                     mesh, mode, 1)
            out[mode] = hlo.stablehlo_collective_stats(
                low.as_text()).as_dict()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
''' % ARCH)


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def jx():
    if jax is None:
        pytest.skip("the JAX reference is not installed")


@pytest.fixture(scope="module")
def cells(jx, tmp_path_factory):
    """Each mode's artifact from the port's CLI, its stdout and rc, and
    the reference's StableHLO stats, all run side by side."""
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {mode: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", "train_4k", "--mode", mode, "--out", str(tmp)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for mode in MODES}
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "jax.json"), *MODES],
        env=dict(_env(), JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    logs = {m: p.communicate(timeout=300)[0] for m, p in procs.items()}
    jlog = ref.communicate(timeout=300)[0]
    assert ref.returncode == 0, jlog
    out = {}
    for mode, p in procs.items():
        assert p.returncode == 0, logs[mode]
        path = dryrun.artifact_path(ARCH, "train_4k", "pod", mode, str(tmp))
        with open(path) as f:
            out[mode] = json.load(f)
    with open(tmp / "jax.json") as f:
        want = json.load(f)
    return tmp, out, logs, want


def _reference_artifact_keys() -> set:
    """The keys of the reference's ``ok`` artifact dict in
    ``dryrun_cell`` (``art = {...}``), read off its source."""
    # its source only: importing it would force 512 host devices
    path = importlib.util.find_spec("repro.launch.dryrun").origin
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_cell")
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == "art"
                        for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no art = {...} in the reference's dryrun_cell")


@pytest.mark.parametrize("mode", MODES)
def test_collectives_match_reference_lowering(cells, mode):
    _, out, logs, want = cells
    art = out[mode]
    assert art["status"] == "ok", art
    assert art["collectives"]["counts"] == want[mode]["counts"]
    assert art["collectives"]["bytes"] == want[mode]["bytes"]
    assert art["n_chips"] == 256 and art["global_batch"] == 256
    assert f"[ok]   {ARCH} x train_4k (pod,{mode})" in logs[mode]


def test_artifact_keys_and_arithmetic(cells):
    _, out, _, _ = cells
    art = out["hadronio_rs"]
    ref_keys = _reference_artifact_keys()
    assert ref_keys <= art.keys()
    assert art.keys() - ref_keys == {"cross_pod", "global_batch", "comm"}
    jcfg, jshape = jax_config(ARCH), jax_shape("train_4k")
    assert art["model_flops_global"] == jhlo.model_flops(jcfg, jshape)
    assert art["analytic_hbm_bytes_per_chip"] == \
        jhlo.analytic_hbm_bytes(jcfg, jshape, 256, tp=16, dp=16)
    assert art["param_count"] == jcfg.param_count()
    mem = art["memory_analysis"]
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert art["cost_analysis"]["flops"] > 0
    assert art["scan_corrected"]["flops"] == art["cost_analysis"]["flops"]
    assert 0 < art["useful_flops_ratio"] < 1.5
    # no pod axis: every collective stays inside the one pod
    assert art["cross_pod"]["cross_pod_total"] == 0
    assert art["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


def test_skip_existing_reuses_an_ok_artifact(cells, capsys):
    tmp = cells[0]
    rc = dryrun.main(["--arch", ARCH, "--shape", "train_4k", "--mode",
                      "hadronio", "--out", str(tmp), "--skip-existing"])
    assert rc == 0
    assert f"[cached] {ARCH} x train_4k" in capsys.readouterr().out


def test_dense_long_500k_is_a_skip_with_the_reference_reason(jx, tmp_path):
    art = dryrun.dryrun_cell("qwen2-0.5b", "long_500k", mode="hadronio")
    assert art["status"] == "skip"
    assert art["reason"] == jreason(jax_config("qwen2-0.5b"),
                                    jax_shape("long_500k"))
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                      "--mode", "hadronio", "--out", str(tmp_path)])
    assert rc == 0
    path = dryrun.artifact_path("qwen2-0.5b", "long_500k", "pod",
                                "hadronio", str(tmp_path))
    with open(path) as f:
        assert json.load(f)["status"] == "skip"


@pytest.mark.parametrize("shape,mode,named", [
    ("train_4k", "gspmd", "GSPMD step family"),
    ("prefill_32k", "hadronio", "GSPMD serve steps"),
    ("decode_32k", "hadronio_rs", "GSPMD serve steps"),
])
def test_cells_it_cannot_run_fail_with_the_named_error(tmp_path, shape, mode,
                                                       named):
    with pytest.raises(NotImplementedError, match=named):
        dryrun.dryrun_cell(ARCH, shape, mode=mode)
    rc = dryrun.main(["--arch", ARCH, "--shape", shape, "--mode", mode,
                      "--out", str(tmp_path)])
    assert rc == 1
    with open(dryrun.artifact_path(ARCH, shape, "pod", mode,
                                   str(tmp_path))) as f:
        art = json.load(f)
    assert art["status"] == "fail"
    assert art["error"].startswith("NotImplementedError") and named in \
        art["error"]
