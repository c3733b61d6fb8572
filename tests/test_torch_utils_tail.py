"""Port parity: the `utils/` tail of `eggshell_tpu_torch` (trace,
si_prefix, errors, checkpoint, step_parser, crash_handler), the package
exports the JAX package has (SimConfig from `utils`, `ops.quaternion`,
`__version__`), and the box-pair narrowphase routing of the unfused
contacts.

Mirrors tests/test_toolkit.py:89 (trace), :109 (si_prefix), :138
(errors), :212 (checkpoint), tests/test_physics.py:267 (a checkpoint
mid-rollout, resumed: equal to the straight run within 1e-12 in float64)
and tests/test_io_geometry.py:29,44 (step_parser: the JAX module's parse
of the same text, compared exactly).  The resumed rollout runs 2 + 2
steps against 4 where the JAX test runs 40 + 40 against 80: the port's
single-scene PGS at 200 sweeps is a Python row loop of about 1.4 s a
step on this CPU.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from eggshell_tpu.utils import si_prefix as jsi
from eggshell_tpu.utils import step_parser as jstep
from eggshell_tpu_torch.ops import collision
from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes_diff
from eggshell_tpu_torch.physics import contacts, scenes
from eggshell_tpu_torch.utils import errors, si_prefix, step_parser, trace
from eggshell_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind
from torch_limits import time_limit  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESUME_TOL = 1e-12          # tests/test_physics.py:283


# ------------------------------------------------------------------- tracing


def test_trace_scopes():
    trace.trace_start()
    with trace.Trace("outer"):
        time.sleep(0.01)
        with trace.Trace("inner"):
            time.sleep(0.02)
    t = trace.timings()
    assert t["inner"][2] == 1 and t["outer"][2] == 1
    # inner total ~20ms; outer exclusive ~10ms < outer total ~30ms
    assert t["inner"][1] >= 15_000
    assert t["outer"][0] < t["outer"][1]
    rep = trace.trace_report()
    assert "outer" in rep and "inner" in rep


def test_scope_label_shows_in_profiler_trace():
    """`scope` opens torch.profiler.record_function where the JAX package
    opens jax.named_scope: the label is an event of the profile, and the
    host Trace counts it."""
    trace.trace_start()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.scope("eggshell_step_label"):
            torch.ones(8).sum()
    assert "eggshell_step_label" in {e.key for e in prof.key_averages()}
    assert trace.timings()["eggshell_step_label"][2] == 1


def test_set_tracing_off_records_nothing():
    trace.trace_start()
    trace.set_tracing(False)
    try:
        with trace.Trace("off"):
            pass
    finally:
        trace.set_tracing(True)
    assert "off" not in trace.timings()


# ------------------------------------------------------------------ utilities


def test_si_prefix_roundtrip():
    assert si_prefix.si_prefix(1.23e-8) == "12.3n"
    assert si_prefix.si_prefix(1500.0) == "1.5k"
    assert abs(si_prefix.si_parse("12.3n") - 1.23e-8) < 1e-15
    assert si_prefix.si_prefix(0) == "0"


@pytest.mark.parametrize("value", [1.23e-8, 1500.0, 0.0, -4.2e7, 3.3e-30, 9.99e25, 1.0])
def test_si_prefix_matches_jax_module(value):
    got = si_prefix.si_prefix(value)
    assert got == jsi.si_prefix(value)
    assert si_prefix.si_parse(got) == jsi.si_parse(got)


def test_error_funnel():
    captured = []
    errors.set_error_handler(lambda lvl, msg: captured.append((lvl, msg)))
    try:
        errors.warning("w %d", 1)
        errors.error("e")
        errors.message("m %s", "x")
        with pytest.raises(errors.PanicError):
            errors.panic("boom %s", "x")
        with pytest.raises(errors.PanicError):
            errors.check(False, "chk")
        with pytest.raises(errors.PanicError, match="bad 3"):
            errors.check_msg(False, "bad %d", 3)
        errors.check(True)
    finally:
        errors.set_error_handler(None)
    assert captured[0] == ("Warning", "w 1")
    assert ("Message", "m x") in captured
    assert ("Panic", "boom x") in captured


@pytest.mark.parametrize("pred, fires", [(True, False), (False, True),
                                         (torch.tensor(True), False),
                                         (torch.tensor(0.0), True)])
def test_device_check_on_the_host(pred, fires):
    """A Python bool or a CPU tensor is checked at once, through the
    handler, as check_msg (the CUDA branch queues torch._assert_async)."""
    captured = []
    errors.set_error_handler(lambda lvl, msg: captured.append((lvl, msg)))
    try:
        if fires:
            with pytest.raises(errors.PanicError, match="step 7 diverged"):
                errors.device_check(pred, "step %d diverged", 7)
        else:
            errors.device_check(pred, "step %d diverged", 7)
    finally:
        errors.set_error_handler(None)
    assert captured == ([("Panic", "step 7 diverged")] if fires else [])


def test_crash_handler_reports_unhandled_exception():
    """In a process of its own: the installed hook prints the banner and
    the traceback of an unhandled exception to the stream."""
    code = ("import sys; from eggshell_tpu_torch.utils.crash_handler import setup_crash_handling;"
            " setup_crash_handling(sys.stderr); raise RuntimeError('boom 42')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "=== unhandled exception ===" in out.stderr and "boom 42" in out.stderr


# -------------------------------------------------------------- checkpointing


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "state": {"p": torch.arange(6.0).reshape(2, 3)},
        "controls": torch.ones((4, 6)),
        "step": torch.tensor(7),
    }
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, tree)
    out = restore_checkpoint(path)
    np.testing.assert_allclose(out["state"]["p"].numpy(), tree["state"]["p"].numpy())
    assert int(out["step"]) == 7


def test_checkpoint_target_gives_types_dtypes_and_overwrites(tmp_path):
    """A save replaces the file (orbax's force=True); the target rebuilds
    NamedTuples and numbers and gives each tensor its dtype."""
    spec, st = scenes.box_stack(2, device="cpu", dtype=torch.float64)
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"state": st._replace(p=st.p + 1.0), "step": 1})
    save_checkpoint(path, {"state": st, "step": 5, "ids": [torch.arange(3)]})
    target = {"state": st._replace(p=st.p.float()), "step": 0,
              "ids": [torch.zeros(3, dtype=torch.int32)]}
    out = restore_checkpoint(path, target)
    assert type(out["state"]) is type(st) and out["step"] == 5
    assert out["state"].p.dtype == torch.float32
    assert torch.equal(out["state"].p, st.p.float())
    assert torch.equal(out["state"].q, st.q)
    assert out["ids"][0].dtype == torch.int32 and out["ids"][0].tolist() == [0, 1, 2]


def test_checkpoint_resume_rollout(tmp_path):
    """Checkpoint mid-rollout, restore, continue: the uninterrupted run's
    state within 1e-12 in float64 (tests/test_physics.py:267)."""
    from eggshell_tpu_torch.parallel.rollout import rollout
    from eggshell_tpu_torch.physics.scene import State

    spec, state = scenes.box_stack(3, device="cpu", dtype=torch.float64)
    cfg = SimConfig(solver=SolverKind.PGS, solver_iters=200, contact_capacity=24)
    mid, _ = rollout(spec, state, cfg, 2)
    save_checkpoint(str(tmp_path / "ck"), {"state": mid._asdict()})
    loaded = restore_checkpoint(str(tmp_path / "ck"))
    resumed = State(**loaded["state"])
    fin_resumed, _ = rollout(spec, resumed, cfg, 2)
    fin_straight, _ = rollout(spec, state, cfg, 4)
    np.testing.assert_allclose(fin_resumed.p.numpy(), fin_straight.p.numpy(), rtol=0,
                               atol=RESUME_TOL)


# ---------------------------------------------------------------- STEP files

STEP_SAMPLE = """ISO-10303-21;
HEADER;
FILE_DESCRIPTION(('test part'),'2;1');
FILE_NAME('box.step','2026-01-01',('author'),(''),'proc','sys','');
ENDSEC;
DATA;
#1=CARTESIAN_POINT('origin',(0.,0.,0.));
#2=CARTESIAN_POINT('p',(1.,2.5,-3.E-1));
#3=DIRECTION('z',(0.,0.,1.));
#4=AXIS2_PLACEMENT_3D('',#1,#3,$);
#5=ADVANCED_FACE('',(),#4,.T.);
/* a comment */ #6=NAME_ONLY('it''s',*,12,-4);
ENDSEC;
END-ISO-10303-21;
"""


def _plain(x):
    """A parse result with the modules' own Ref/Enum as tagged tuples."""
    if isinstance(x, (jstep.Ref, step_parser.Ref)):
        return ("ref", x.id)
    if isinstance(x, (jstep.Enum, step_parser.Enum)):
        return ("enum", x.name)
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def test_step_parse_basics():
    sf = step_parser.parse_step(STEP_SAMPLE)
    assert sf.header[0][0] == "FILE_DESCRIPTION"
    assert len(sf.entities) == 6
    name, args = sf.entities[2]
    assert name == "CARTESIAN_POINT"
    assert args[0] == "p"
    np.testing.assert_allclose(args[1], [1.0, 2.5, -0.3])
    _, args4 = sf.entities[4]
    assert args4[1] == step_parser.Ref(1) and args4[2] == step_parser.Ref(3)
    assert args4[3] is None
    assert sf.entities[5][1][3] == step_parser.Enum("T")
    assert set(sf.of_type("cartesian_point")) == {1, 2}


def test_step_parse_matches_jax_module(tmp_path):
    want = jstep.parse_step(STEP_SAMPLE)
    path = tmp_path / "part.step"
    path.write_text(STEP_SAMPLE)
    got = step_parser.parse_step_file(str(path))
    assert _plain(got.header) == _plain(want.header)
    assert _plain(got.entities) == _plain(want.entities)


@pytest.mark.parametrize("text", ["NOT-A-STEP;", "ISO-10303-21;\nDATA;\n#1=FOO(;\n",
                                  "ISO-10303-21;\nDATA;\n#1=FOO(1)", "ISO-10303-21;\n@"])
def test_step_errors(text):
    with pytest.raises(step_parser.StepError):
        step_parser.parse_step(text)
    with pytest.raises(jstep.StepError):
        jstep.parse_step(text)


# ------------------------------------------------------- exports and routing


def test_exports_of_the_jax_package():
    """`from ...utils import SimConfig`, `ops.quaternion` after importing
    `ops`, and `__version__`, in a fresh process (an import cycle would
    show there)."""
    import eggshell_tpu

    code = ("import eggshell_tpu_torch.ops as o; from eggshell_tpu_torch.utils import SimConfig;"
            " import eggshell_tpu_torch as e, sys; o.quaternion.quat_to_mat;"
            " print(e.__version__, SimConfig is e.SimConfig,"
            " any(m.split('.')[0] in ('jax', 'eggshell_tpu') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [eggshell_tpu.__version__, "True", "False"]


CUDA = torch.device("cuda")


@pytest.mark.parametrize("dtype, contact_kernel, want", [
    (torch.float32, None, "kernel"),
    (torch.float32, True, "kernel"),
    (torch.float64, None, "plain"),
    (torch.float32, False, "plain"),
    (torch.float64, False, "plain"),
])
def test_box_pair_narrowphase_on_the_card(dtype, contact_kernel, want):
    """The routing of the unfused contacts' box pairs on a CUDA device
    (decided from the device type, so no card is needed): B2 for float32
    unless contact_kernel=False, else the plain collide_boxes."""
    fn = contacts.box_pair_narrowphase(dtype, CUDA, contact_kernel)
    assert fn is {"kernel": collide_boxes_lanes_diff, "plain": collision.collide_boxes}[want]


def test_box_pair_narrowphase_refuses_float64_kernel():
    with pytest.raises(ValueError, match="float32"):
        contacts.box_pair_narrowphase(torch.float64, CUDA, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("contact_kernel", [None, True, False])
def test_box_pair_narrowphase_off_the_card(dtype, contact_kernel):
    """On the CPU the wrapper runs its plain version itself, and the
    contacts do not depend on contact_kernel."""
    assert contacts.box_pair_narrowphase(dtype, "cpu", contact_kernel) is collide_boxes_lanes_diff
    spec, st = scenes.box_stack(3, jitter=0.01, device="cpu", dtype=dtype)
    want = contacts.make_contacts(spec, st, SimConfig(contact_capacity=24))
    got = contacts.make_contacts(spec, st, SimConfig(contact_capacity=24,
                                                     contact_kernel=contact_kernel))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
