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
* THE GSPMD CELLS — ``main`` with the default ``--mode gspmd`` traces
  qwen2-0.5b-reduced x ``train_4k`` (one ``make_train_step_gspmd``
  step), ``prefill_32k`` and ``decode_32k`` (``make_prefill_step`` /
  ``make_decode_step`` on ``serve_specs``' layouts) over a ``(16, 16)``
  ``DeviceMesh`` on the fake group: each ``ok``, with the reference's
  artifact keys and arithmetic. Their collective counts are DTensor's
  schedule, not XLA's (``PERF.md`` sets the two side by side), so they
  are not held to the reference's. The fake group does not change that
  schedule: a prefill and a decode cell traced on a fake group of 4 over
  ``(2, 2)`` issue, kind for kind and byte for byte, the collectives the
  same steps issue on a real gloo world of 4, and so does a decode cell
  of each recurrent family.
* THE RECURRENT CELLS — ``rwkv6-7b-reduced`` and
  ``recurrentgemma-9b-reduced`` x ``train_4k``, ``prefill_32k``,
  ``decode_32k`` and ``long_500k`` (batch 1: the state's longest dim
  over ``data``) with ``--mode gspmd`` on the fake group: each ``ok``,
  with the reference's artifact keys and arithmetic (their scans traced
  in log-depth form, ``dryrun._log_depth_scans``).
* THE MOE AND ENCDEC CELLS — ``mixtral-8x7b-reduced`` x ``train_4k``,
  ``prefill_32k``, ``decode_32k`` and ``long_500k`` (its window makes it
  sub-quadratic) with ``--mode gspmd``, its serve cells in ``hadronio``
  and ``hadronio_rs`` too, and ``whisper-tiny-reduced``'s three gspmd
  cells: each ``ok`` with the reference's keys and arithmetic, traced
  in the recurrent cells' subprocesses (one per arch).
* CELLS IT CANNOT RUN — a dense model's ``long_500k`` and whisper's are
  ``skip``s with the reference's reason; no family's gspmd, prefill or
  decode cell fails any more (every family's ``shard_fn`` sites are
  threaded); ``main`` writes every artifact under ``--out`` and
  returns 1 only when a cell failed.
"""
import ast
import importlib.util
import json
import os
import pickle
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
SERVE = ("train_4k", "prefill_32k", "decode_32k")      # --mode gspmd
RECURRENT = ("rwkv6-7b-reduced", "recurrentgemma-9b-reduced")
RECURRENT_CELLS = [(a, s) for a in RECURRENT for s in SERVE + ("long_500k",)]
MOE = "mixtral-8x7b-reduced"
ENCDEC = "whisper-tiny-reduced"
# (arch, shape, mode): mixtral's prefill and decode cells in a TAC mode
# too (a serve cell lowers through the GSPMD serve steps whatever the
# mode); whisper's long_500k is the reference's skip
MOE_ENCDEC_CELLS = [(MOE, "train_4k", "gspmd"), (MOE, "prefill_32k", "gspmd"),
                    (MOE, "decode_32k", "gspmd"), (MOE, "long_500k", "gspmd"),
                    (MOE, "prefill_32k", "hadronio"),
                    (MOE, "decode_32k", "hadronio_rs"),
                    (ENCDEC, "train_4k", "gspmd"),
                    (ENCDEC, "prefill_32k", "gspmd"),
                    (ENCDEC, "decode_32k", "gspmd"),
                    (ENCDEC, "long_500k", "gspmd")]

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
    cli = lambda shape, mode: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", shape, "--mode", mode, "--out", str(tmp)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    procs = {mode: cli("train_4k", mode) for mode in MODES}
    procs.update({shape: cli(shape, "gspmd") for shape in SERVE})
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "jax.json"), *MODES],
        env=dict(_env(), JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    logs = {m: p.communicate(timeout=300)[0] for m, p in procs.items()}
    jlog = ref.communicate(timeout=300)[0]
    assert ref.returncode == 0, jlog
    out = {}
    for key, p in procs.items():
        assert p.returncode == 0, logs[key]
        shape, mode = (key, "gspmd") if key in SERVE else ("train_4k", key)
        path = dryrun.artifact_path(ARCH, shape, "pod", mode, str(tmp))
        with open(path) as f:
            out[key] = json.load(f)
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


@pytest.mark.parametrize("shape", SERVE)
def test_gspmd_cells_trace_with_the_reference_keys(cells, shape):
    """The default ``--mode gspmd`` cells are ``ok``: the reference's
    artifact keys plus the port's own, its model FLOPs, analytic bytes
    and param count, and a traced schedule with collectives in it."""
    _, out, logs, _ = cells
    _check_gspmd_cell(ARCH, shape, out[shape], logs[shape])


_CELLS = textwrap.dedent('''
    import sys
    from repro_torch.launch import dryrun
    arch, out = sys.argv[1:3]
    sys.exit(max(dryrun.main(["--arch", arch, "--shape", cell.split(":")[0],
                              "--mode", cell.split(":")[1], "--out", out])
                 for cell in sys.argv[3:]))
''')


@pytest.fixture(scope="module")
def recurrent_cells(jx, tmp_path_factory):
    """The recurrent, moe and encdec families' gspmd cells through the
    port's CLI entry (``dryrun.main``), one subprocess per arch running
    its cells in turn, all started together: {(arch, shape, mode):
    (artifact, that arch's stdout)}."""
    tmp = tmp_path_factory.mktemp("dryrun_recurrent")
    cells = [(a, s, "gspmd") for a, s in RECURRENT_CELLS] + MOE_ENCDEC_CELLS
    archs = dict.fromkeys(a for a, _, _ in cells)
    procs = {a: subprocess.Popen(
        [sys.executable, "-c", _CELLS, a, str(tmp)]
        + [f"{s}:{m}" for b, s, m in cells if b == a], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a in archs}
    logs = {a: p.communicate(timeout=300)[0] for a, p in procs.items()}
    out = {}
    for a, p in procs.items():
        assert p.returncode == 0, logs[a][-3000:]
    for a, s, m in cells:
        with open(dryrun.artifact_path(a, s, "pod", m, str(tmp))) as f:
            out[a, s, m] = (json.load(f), logs[a])
    return out


@pytest.mark.parametrize("arch,shape", RECURRENT_CELLS,
                         ids=[f"{a}-{s}" for a, s in RECURRENT_CELLS])
def test_recurrent_gspmd_cells_trace(recurrent_cells, arch, shape):
    """rwkv6 and recurrentgemma (reduced): the gspmd train step and every
    serve cell, ``long_500k`` included, are ``ok`` on the fake group of
    256, with the reference's keys and arithmetic, and parameter
    all-gathers (FSDP) in the schedule (a reduced rwkv6 prefill issues
    no all-reduce: its 4 heads do not split over 16)."""
    art, log = recurrent_cells[arch, shape, "gspmd"]
    _check_gspmd_cell(arch, shape, art, log, kinds=("all-gather",))


RUNS = [c for c in MOE_ENCDEC_CELLS if c != (ENCDEC, "long_500k", "gspmd")]


@pytest.mark.parametrize("arch,shape,mode", RUNS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in RUNS])
def test_moe_encdec_gspmd_cells_trace(recurrent_cells, arch, shape, mode):
    """mixtral and whisper (reduced): the gspmd train step and every
    serve cell (mixtral's ``long_500k`` too: its window makes the cell
    sub-quadratic; its serve cells in TAC modes too) are ``ok`` on the
    fake group of 256, with the reference's keys and arithmetic and
    parameter all-gathers (FSDP) in the schedule."""
    art, log = recurrent_cells[arch, shape, mode]
    _check_gspmd_cell(arch, shape, art, log, kinds=("all-gather",),
                      mode=mode)


def test_encdec_long_500k_is_a_skip_with_the_reference_reason(
        recurrent_cells):
    """whisper's full attention: ``long_500k`` is the reference's skip,
    recorded as such by ``main`` (rc 0)."""
    art, log = recurrent_cells[ENCDEC, "long_500k", "gspmd"]
    assert art["status"] == "skip"
    assert art["reason"] == jreason(jax_config(ENCDEC),
                                    jax_shape("long_500k"))
    assert f"[skip] {ENCDEC} x long_500k" in log


def _check_gspmd_cell(arch, shape, art, log,
                      kinds=("all-gather", "all-reduce"), mode="gspmd"):
    assert art["status"] == "ok", art
    assert f"[ok]   {arch} x {shape} (pod,{mode})" in log
    ref_keys = _reference_artifact_keys()
    assert ref_keys <= art.keys()
    assert art.keys() - ref_keys == {"cross_pod", "global_batch", "comm"}
    jcfg, jshape = jax_config(arch), jax_shape(shape)
    assert art["n_chips"] == 256
    assert art["global_batch"] == jshape.global_batch
    assert art["model_flops_global"] == jhlo.model_flops(jcfg, jshape)
    assert art["analytic_hbm_bytes_per_chip"] == \
        jhlo.analytic_hbm_bytes(jcfg, jshape, 256, tp=16, dp=16)
    assert art["param_count"] == jcfg.param_count()
    mem = art["memory_analysis"]
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert art["cost_analysis"]["flops"] > 0
    assert art["scan_corrected"]["flops"] == art["cost_analysis"]["flops"]
    assert art["useful_flops_ratio"] > 0
    coll = art["collectives"]
    assert coll["total_ops"] > 0 and coll["total_bytes"] > 0
    assert set(kinds) <= set(coll["counts"])
    assert art["cross_pod"]["cross_pod_total"] == 0


_REAL = textwrap.dedent('''
    import pickle, sys
    import torch, torch.distributed as dist
    from repro_torch.launch import hlo_analysis as hlo
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import api
    from repro_torch.models.common import tree_map
    sys.path.insert(0, sys.argv[5])
    from test_torch_dryrun import schedule_runs

    rank, store, out = int(sys.argv[1]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=int(sys.argv[2]))
    res = {}
    try:
        mesh = make_device_mesh((2, 2), ("data", "model"), "cpu")
        gen = torch.Generator().manual_seed(0)
        real = lambda t: tree_map(lambda v: torch.zeros(
            v.shape, dtype=v.dtype), t)
        for run in schedule_runs():
            if run.shape.kind == "train":
                state = steps.distribute_state(
                    steps.init_train_state(gen, run, "cpu"),
                    steps.train_state_shardings(mesh, run))
                args = [state, real(api.input_specs(run.model, run.shape))]
                step = steps.make_train_step_gspmd(run, mesh, donate=True)
            else:
                params, cache, inputs, psh, csh, ish = steps.serve_specs(
                    run, run.shape, mesh)
                args = [sharding.distribute_tree(
                    api.init(gen, run.model, device="cpu"), psh),
                    sharding.distribute_tree(real(inputs), ish)]
                if run.shape.kind == "prefill":
                    step = steps.make_prefill_step(run, mesh)
                else:
                    args.insert(1, sharding.distribute_tree(real(cache),
                                                            csh))
                    step = steps.make_decode_step(run, mesh)
            log = hlo.profile(step, *args).log
            res[run.model.name, run.shape.kind] = [
                (op.kind, op.nbytes, op.ranks) for op in log.collectives]
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
''')

_FAKE = textwrap.dedent('''
    import pickle, sys
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    sys.path.insert(0, sys.argv[2])
    from test_torch_dryrun import schedule_runs

    res = {}
    for run in schedule_runs():
        prof = dryrun.trace_gspmd_cell(run, make_mesh((2, 2),
                                                     ("data", "model")))
        res[run.model.name, run.shape.kind] = [
            (op.kind, op.nbytes, op.ranks) for op in prof.log.collectives]
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
''')


def schedule_runs():
    """A gspmd train, prefill and decode step of ``ARCH`` at a small
    shape (its 4 heads split over the (2, 2) mesh's ``model`` axis), and
    a decode step of each recurrent family."""
    from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    return [RunConfig(model=get_config(arch), shape=ShapeConfig(
        "s", kind, 32, 8), comm=CommConfig(mode="gspmd"))
        for arch, kind in [(ARCH, "train"), (ARCH, "prefill"),
                           (ARCH, "decode")]
        + [(a, "decode") for a in RECURRENT]]


def test_fake_group_keeps_the_gspmd_schedule(tmp_path):
    """A prefill and a decode cell traced on a fake group of 4 over a
    (2, 2) mesh issue the collectives, in order, kind for kind, byte for
    byte and group for group, that the same steps issue on rank 0 of a
    real gloo world of 4 (values do not steer DTensor's schedule,
    placements do); so does a decode cell of each recurrent family (its
    state redistributed to the scan's blocks and back). The train step traces too:
    its collectives are of the real run's kinds and groups, but the
    sequences are not held equal: under a fake mode DTensor plans some
    of a step's redistributions apart from a real run's (``PERF.md``),
    its attention on local blocks or not."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REAL, str(r), "4", str(tmp_path / "store"),
         str(tmp_path / f"real{r}.pkl"), here], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _FAKE, str(tmp_path / "fake.pkl"), here],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    with open(tmp_path / "real0.pkl", "rb") as f:
        real = pickle.load(f)
    with open(tmp_path / "fake.pkl", "rb") as f:
        fake = pickle.load(f)
    for key in [(ARCH, "prefill"), (ARCH, "decode")] + [
            (a, "decode") for a in RECURRENT]:
        assert real[key], key
        assert fake[key] == real[key], key
    groups = lambda log: {(k, ranks) for k, _, ranks in log}
    train = (ARCH, "train")
    assert fake[train] and groups(fake[train]) == groups(real[train])


@pytest.mark.parametrize("shape,mode,named", [
    ("train_4k", "gspmd", "GSPMD step family"),
    ("prefill_32k", "hadronio", "GSPMD serve steps"),
    ("decode_32k", "hadronio_rs", "GSPMD serve steps"),
])
def test_cells_it_cannot_run_fail_with_the_named_error(recurrent_cells, shape,
                                                       mode, named):
    """No cell is left that the port cannot run: the moe family's gspmd
    train cell and its serve cells in any mode (``named``: the step
    family that traces them), whose ``shard_fn`` sites are threaded now,
    are ``ok`` through ``main`` (rc 0) with a traced schedule, as the
    encdec family's are."""
    art, log = recurrent_cells[MOE, shape, mode]
    assert art["status"] == "ok", (named, art)
    assert art["mode"] == mode and art["collectives"]["total_ops"] > 0
    assert f"[ok]   {MOE} x {shape} (pod,{mode})" in log
    for s in SERVE:
        art, _ = recurrent_cells[ENCDEC, s, "gspmd"]
        assert art["status"] == "ok", art
