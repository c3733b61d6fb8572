"""Batched rollouts, counterpart of `eggshell_tpu.parallel.rollout`.

The JAX package scans the step over the horizon inside one compiled
program.  Here, on the card, the step is captured once in a CUDA graph
(`StepGraph`) and the graph is replayed once a step, so no host work
stands between two steps; the graphs are cached by scene, configuration
and batch.  The fused chain, the matrix-free step and the unfused branch
without a host read all capture.  On the CPU, and on the card for a
configuration whose step waits on the host (`capture_refusal`), the
horizon is a Python loop over `step_ode_batched`.  Both give the same
bits.  A `StepGraph` with a control input replays one control period a
graph (the controlled rollouts of `mpc.sampling`).

`rollout` steps one scene through `step_ode`, a Python loop, with its
trajectory stacked on a leading time axis.
"""

from __future__ import annotations

import collections
import warnings
from typing import Optional

import torch

from eggshell_tpu_torch.ops import launch_counters
from eggshell_tpu_torch.physics.scene import SceneSpec, State
from eggshell_tpu_torch.physics.stepper import (_fused_step, _is_fused, _wants_grad, step_ode,
                                                step_ode_batched)
from eggshell_tpu_torch.utils.config import FrictionModel, SimConfig, SolverKind

# Captured graphs kept, the least recently used dropped first: each holds
# its own memory pool, the step's intermediates (A alone is 67 MB at the
# bench shape).
CACHED_GRAPHS = 4


class RolloutLoopWarning(UserWarning):
    """A rollout on the card ran as a Python loop over the step, because
    its configuration's step waits on the host (`capture_refusal`)."""


def capture_refusal(cfg: SimConfig) -> Optional[str]:
    """Why a step under `cfg` cannot be captured in a CUDA graph, or None
    where it can.  Decided from the configuration alone, before any
    capture; a rollout whose step cannot be captured stays a Python loop.
    What stops a capture was found on the card
    (`tools/rollout_graph_probe.py captures`):

    - the fused chain (`stepper._is_fused`) captures: fixed sweeps, every
      launch plan from shapes, no host read (solver_tol does not reach it);
    - so does the matrix-free step (SolverKind.MATRIX_FREE): fixed sweeps,
      and the broadphase and contacts read nothing back; the constants of
      the contacts and constraints are made on the card at the warm-up
      step (`utils.constants`);
    - the unfused branch captures but where, under conditional CFM, the
      exact estimator's `torch.linalg.eigvalsh` checks its errors on the
      host, and the power estimator's `cholesky_ex` and `cholesky_solve`
      (MAGMA's batched routines) invalidate a capture, and where the plain
      solves (PGS, SOR, JACOBI, and JACOBI_KERNEL under COULOMB_PYRAMID)
      with solver_tol > 0 read bool(done.all()) on the host every sweep,
      and where DIRECT's pivot loop reads whether every scenario is done on
      the host every pivot (`ops.lcp_direct`).

    A rollout that autograd records (a state or control requires grad)
    never captures either (`_use_graph`).
    """
    if _is_fused(cfg) or cfg.solver == SolverKind.MATRIX_FREE:
        return None
    reasons = []
    if cfg.conditional_cfm and cfg.cond_estimator == "exact":
        reasons.append("the exact condition estimator's torch.linalg.eigvalsh checks its "
                       "errors on the host")
    elif cfg.conditional_cfm:
        reasons.append("the power estimator's cholesky_ex and cholesky_solve invalidate a "
                       "capture")
    kernel_solve = (cfg.solver == SolverKind.JACOBI_KERNEL
                    and cfg.friction_model != FrictionModel.COULOMB_PYRAMID)
    if cfg.solver == SolverKind.DIRECT:
        reasons.append("SolverKind.DIRECT: the pivot loop reads `done` on the host")
    elif not kernel_solve and cfg.solver_tol > 0:
        reasons.append("solver_tol > 0: the plain solve reads bool(done.all()) on the host "
                       "every sweep")
    return "; ".join(reasons) or None


def graph_capturable(cfg: SimConfig) -> bool:
    """Whether `rollout_batched` and `rollout_batched_monitored` replay a
    CUDA graph of the step under `cfg` on the card (`capture_refusal`)."""
    return capture_refusal(cfg) is None


def _divergence(nxt: State, speed_limit: float):
    """(B,) bool: a scenario whose next state is not finite or moves
    faster than `speed_limit` (any |v| or |w| component)."""
    bad = torch.zeros(nxt.p.shape[0], dtype=torch.bool, device=nxt.p.device)
    for x in nxt:
        bad = bad | (~torch.isfinite(x)).flatten(1).any(1)
    for x in (nxt.v, nxt.w):
        bad = bad | (x.abs().flatten(1).amax(1) > speed_limit)
    return bad


def _monitor(nxt: State, sts: State, diverged, first_bad, i, speed_limit: float, out=None):
    """One step of the divergence monitor (the JAX package's scan body) at
    step i: the scenarios that go bad get i as their first bad step, and
    every diverged scenario keeps its last good state (written into `out`,
    a State of buffers, where given).  Returns (state, diverged,
    first_bad)."""
    bad = _divergence(nxt, speed_limit)
    first_bad = torch.where(bad & ~diverged, i, first_bad)
    diverged = diverged | bad
    keep = ~diverged
    outs = (None,) * 4 if out is None else out
    state = State(*(torch.where(keep.view((-1,) + (1,) * (x.dim() - 1)), x, y, out=o)
                    for x, y, o in zip(nxt, sts, outs)))
    return state, diverged, first_bad


def _step(spec: SceneSpec, states: State, cfg: SimConfig, ext=None, out=None) -> State:
    """One step of `step_ode_batched`; with `out`, a State of buffers, the
    next state is written into them: by B7 itself on the fused chain,
    copied there on the other branches."""
    if _is_fused(cfg):
        return _fused_step(spec, states, cfg, ext, out=out)
    nxt = step_ode_batched(spec, states, cfg, ext)
    if out is None:
        return nxt
    for dst, src in zip(out, nxt):
        dst.copy_(src)
    return out


class StepGraph:
    """One step of B scenarios of one scene under `cfg` (a configuration
    `graph_capturable` takes), captured in CUDA graphs and replayed.

    Two state buffers and two graphs on one memory pool: the first graph
    reads the state from buffer 0 and writes the next state into buffer 1
    (B7 writes it there on the fused chain; the other branches copy it
    there), the second the other way round.  `replay`
    alternates them, so replaying r times advances r steps and `state` is
    the buffer written last; nothing is copied between steps.  With
    `speed_limit` the graphs also carry the divergence monitor's flags
    (`rollout_batched_monitored`), and the monitor writes the merged state
    into the other buffer.

    With `controls` (a (B, H, 6) tensor of the control sequences' shape and
    dtype) a graph is one control period: the graph-owned `ext` (B, n, 6)
    gets `controlled_body`'s slot from the graph-owned `controls` at the
    device step counter `index` (inside the graph, so replays stay back to
    back), then `substeps` fused steps read it, the last writing into the
    other buffer, and `running_cost` (one scene's State to a scalar,
    `torch.func.vmap`-ped over the batch) is added to `acc` (B,).  `load`
    fills `controls`; at most H replays follow a load.

    Capture: the step runs once from a copy of `like` to warm up (the
    kernel library loads; every C entry makes its first runtime calls
    there), then each graph is captured.  The kernel wrappers' launch
    counters are Python increments that a replay does not run: the first
    capture's increase of each counter is recorded, the counters are put
    back as they were before the warm-up, and `replay` adds the increase
    once a replay.  A capture that fails raises.
    """

    def __init__(self, spec: SceneSpec, cfg: SimConfig, like: State,
                 speed_limit: Optional[float] = None, controls=None, controlled_body: int = 0,
                 substeps: int = 1, running_cost=None):
        self.spec, self.cfg, self.speed_limit = spec, cfg, speed_limit
        self.controlled_body, self.substeps = controlled_body, substeps
        self.running_cost = running_cost
        dev = like.p.device
        self.buffers = [State(*(torch.empty(x.shape, dtype=x.dtype, device=dev) for x in like))
                        for _ in range(2)]
        self.current = 0
        B = like.p.shape[0]
        self.index = torch.zeros((), dtype=torch.int32, device=dev)
        if speed_limit is not None:
            self.diverged = torch.zeros(B, dtype=torch.bool, device=dev)
            self.first_bad = torch.zeros(B, dtype=torch.int32, device=dev)
        self.controls = self.ext = None
        if controls is not None:
            self.controls = torch.empty(controls.shape, dtype=like.p.dtype, device=dev)
            self.ext = torch.zeros((B, spec.num_bodies, 6), dtype=like.p.dtype, device=dev)
            self.acc = torch.zeros(B, dtype=like.p.dtype, device=dev)
        self.left = 0
        counters = launch_counters()
        before = {name: fn.launches for name, fn in counters.items()}
        self.load(like, controls=controls)
        self._body(0)                                  # warm-up from the copy
        torch.cuda.synchronize(dev)
        self.graphs, pool, self.launches = [], None, None
        for src in (0, 1):
            ahead = {name: fn.launches for name, fn in counters.items()}
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                self._body(src)
            pool = graph.pool()
            self.graphs.append(graph)
            if self.launches is None:
                self.launches = {name: fn.launches - ahead[name]
                                 for name, fn in counters.items() if fn.launches != ahead[name]}
        for name, fn in counters.items():
            fn.launches = before[name]

    @property
    def state(self) -> State:
        """The buffer the last replay wrote (after `load`, the loaded one)."""
        return self.buffers[self.current]

    def _control(self):
        """The control wrenches of this replay: `controls[:, index]` into
        the controlled body's slot of `ext`, the counter advanced, inside
        the graph."""
        step = self.controls.index_select(1, self.index.view(1))
        self.ext[:, self.controlled_body].copy_(step[:, 0])
        self.index += 1
        return self.ext

    def _body(self, src: int) -> None:
        sts, out = self.buffers[src], self.buffers[1 - src]
        ext = None if self.controls is None else self._control()
        for _ in range(self.substeps - 1):
            sts = _step(self.spec, sts, self.cfg, ext)
        if self.speed_limit is None:
            _step(self.spec, sts, self.cfg, ext, out=out)
        else:
            nxt = _step(self.spec, sts, self.cfg, ext)
            _, diverged, first_bad = _monitor(nxt, sts, self.diverged, self.first_bad,
                                              self.index, self.speed_limit, out)
            self.diverged.copy_(diverged)
            self.first_bad.copy_(first_bad)
            self.index += 1
        if self.running_cost is not None:
            self.acc += torch.func.vmap(self.running_cost)(out)

    def load(self, states: State, num_steps: int = 0, controls=None) -> None:
        """Copy `states` into buffer 0, the next replay's input, and zero
        the step counter; with the monitor, clear its flags and set every
        first bad step to `num_steps`; with controls, copy `controls` in
        and zero the running cost."""
        self.current = 0
        for dst, src in zip(self.buffers[0], states):
            dst.copy_(src)
        self.index.zero_()
        if self.speed_limit is not None:
            self.diverged.zero_()
            self.first_bad.fill_(num_steps)
        if self.controls is not None:
            self.controls.copy_(controls)
            self.acc.zero_()
            self.left = self.controls.shape[1]

    def replay(self, times: int) -> None:
        """Replay the graphs `times` times in turn and count each replay's
        launches."""
        if self.controls is not None:
            if times > self.left:
                raise ValueError(f"{times} replays, but {self.left} controls are left since "
                                 f"the last load")
            self.left -= times
        for _ in range(times):
            self.graphs[self.current].replay()
            self.current = 1 - self.current
        counters = launch_counters()
        for name, n in self.launches.items():
            counters[name].launches += n * times


class _GraphCache:
    """StepGraphs by scene, configuration, batch, speed limit and control
    input (the controls' shape and dtype, controlled body, substeps and
    running cost), at most CACHED_GRAPHS of them, the least recently used
    dropped first.  A graph holds its scene and its running cost, so their
    identities stay theirs.

    One step a graph, replayed once a step: on the card as fast as the
    horizon unrolled in one capture, within the spread of their runs
    (PERF.md section 6, `tools/rollout_graph_probe.py`), its capture the
    cheapest, and its memory that of one step (and the two buffers)."""

    def __init__(self):
        self._graphs = collections.OrderedDict()

    def get(self, spec, cfg, states: State, speed_limit=None, controls=None,
            controlled_body: int = 0, substeps: int = 1, running_cost=None) -> StepGraph:
        control_key = None if controls is None else (
            tuple(controls.shape), controls.dtype, controlled_body, substeps, running_cost)
        key = (id(spec), cfg, tuple((tuple(x.shape), x.dtype) for x in states),
               states.p.device, speed_limit, control_key)
        g = self._graphs.get(key)
        if g is None or g.spec is not spec:
            g = StepGraph(spec, cfg, states, speed_limit, controls, controlled_body, substeps,
                          running_cost)
            self._graphs[key] = g
            while len(self._graphs) > CACHED_GRAPHS:
                self._graphs.popitem(last=False)
        self._graphs.move_to_end(key)
        return g

    def clear(self) -> None:
        self._graphs.clear()


_graphs = _GraphCache()


def clear_graphs() -> None:
    """Drop every cached graph and its memory pool."""
    _graphs.clear()


def _replayed(spec, states: State, cfg, num_steps: int, speed_limit=None, controls=None,
              controlled_body: int = 0, substeps: int = 1, running_cost=None) -> StepGraph:
    """The cached graph of this rollout (one step, or with `controls` one
    control period), replayed `num_steps` times from `states`."""
    g = _graphs.get(spec, cfg, states, speed_limit, controls, controlled_body, substeps,
                    running_cost)
    g.load(states, num_steps, controls)
    g.replay(num_steps)
    return g


def _use_graph(states: State, cfg: SimConfig, graph: Optional[bool], controls=None) -> bool:
    """Whether to replay a graph: `graph` None decides by the device and
    `capture_refusal` (warning where a card's rollout stays a loop); True
    raises where the rule refuses; False runs the loop.  Where grad mode is
    on and a state or `controls` requires grad, the rollout loops, so that
    autograd records every step (a graph's replays it cannot see), and
    `graph=True` raises."""
    if graph is False:
        return False
    if _wants_grad(controls, *states):
        if graph:
            raise ValueError("cannot capture this rollout in a CUDA graph: grad mode is on and "
                             "a state or control requires grad (the rollout loops so that "
                             "autograd records every step)")
        return False
    on_card = states.p.device.type == "cuda"
    reason = capture_refusal(cfg) if on_card else "the states are not on a CUDA device"
    if reason is None:
        return True
    if graph:
        raise ValueError(f"cannot capture this rollout in a CUDA graph: {reason}")
    if on_card:
        warnings.warn(f"rollout runs as a Python loop: {reason}", RolloutLoopWarning,
                      stacklevel=3)
    return False


def _fresh(states: State) -> State:
    return State(*(x.clone() for x in states))


def rollout(spec: SceneSpec, state: State, cfg: SimConfig, num_steps: int,
            keep_trajectory: bool = False):
    """Advance one scene (`state` without a batch axis) `num_steps` steps of
    `step_ode`.  Returns (final_state, trajectory), the trajectory the
    state after each step stacked on a leading time axis where
    `keep_trajectory`, else None."""
    trajectory = []
    for _ in range(num_steps):
        state, _ = step_ode(spec, state, cfg)
        if keep_trajectory:
            trajectory.append(state)
    if not keep_trajectory:
        return state, None
    if not trajectory:
        return state, State(*(x.new_empty((0,) + x.shape) for x in state))
    return state, batch_states(trajectory)


def rollout_batched(spec: SceneSpec, states: State, cfg: SimConfig, num_steps: int,
                    graph: Optional[bool] = None) -> State:
    """Roll B scenarios of one scene `num_steps` steps forward; states
    (B, n, ...).  Returns the final states, in tensors of their own.

    On the card the step is replayed from a CUDA graph where
    `graph_capturable(cfg)`, else looped with a `RolloutLoopWarning`;
    `graph=True` raises instead of looping, `graph=False` always loops
    (the eager form the graph is measured against)."""
    if num_steps > 0 and _use_graph(states, cfg, graph):
        return _fresh(_replayed(spec, states, cfg, num_steps).state)
    for _ in range(num_steps):
        states = step_ode_batched(spec, states, cfg)
    return states


def rollout_batched_monitored(spec: SceneSpec, states: State, cfg: SimConfig, num_steps: int,
                              speed_limit: float = 1e3, graph: Optional[bool] = None):
    """`rollout_batched` with the JAX package's in-rollout divergence
    monitor.  A scenario diverges the first step its state goes non-finite
    or any |v| or |w| component exceeds `speed_limit`, and stays frozen at
    its last good state from then on.

    Returns (final_states, diagnostics), diagnostics = {"diverged" (B,)
    bool, "diverged_count" () int32, "first_bad_step" (B,) int32
    (num_steps where the scenario never diverged)}.  On the card the
    monitor runs inside the captured graph; `graph` as in
    `rollout_batched`."""
    speed_limit = float(speed_limit)
    if num_steps > 0 and _use_graph(states, cfg, graph):
        g = _replayed(spec, states, cfg, num_steps, speed_limit)
        final, diverged, first_bad = _fresh(g.state), g.diverged.clone(), g.first_bad.clone()
    else:
        B = states.p.shape[0]
        dev = states.p.device
        diverged = torch.zeros(B, dtype=torch.bool, device=dev)
        first_bad = torch.full((B,), num_steps, dtype=torch.int32, device=dev)
        final = states
        for i in range(num_steps):
            final, diverged, first_bad = _monitor(step_ode_batched(spec, final, cfg), final,
                                                  diverged, first_bad, i, speed_limit)
    return final, {"diverged": diverged,
                   "diverged_count": diverged.sum(dtype=torch.int32),
                   "first_bad_step": first_bad}


def batch_states(states) -> State:
    """Stack a list of States along a new leading batch axis."""
    return State(*(torch.stack(xs) for xs in zip(*states)))
