"""Declarative scenario spec → realised non-stationary world.

A :class:`Scenario` is an ordered list of :mod:`transforms` applied on top
of any (scheduler, timing) pair from the existing registries.  Realising a
scenario (:func:`realise_world`) wraps both objects behind a shared
round-indexed :class:`WorldClock` and runs the UNMODIFIED discrete-event
engine, so the output is an ordinary :class:`repro.core.engine.Schedule` —
every downstream consumer (round masks, ``runtime.compile_plan``, the
compiled ``PlanExecutor``) works untouched.  Non-schedule channels
(membership, data drift, sparsification) come back as plain per-round
arrays on the :class:`ScenarioWorld` and are folded into the ``RunPlan`` at
lowering time.

Spec-string grammar (CLI / ``ExperimentSpec.scenario``)::

    spec      := transform (";" transform)*
    transform := name [":" key "=" value ("," key "=" value)*]

e.g. ``"straggler:k=2,factor=8,every=16,span=4;elastic:k=1,every=32"``.
Values parse as int when possible, else float.  The empty spec ``""`` is
the identity scenario — it still takes the wrapped path, and MUST
reproduce the stationary world bit-for-bit (tests pin this).

Bit-exactness design: the timing wrapper owns no RNG — it feeds modulated
speeds through the base model's own ``_draw``/``_draw_batch``, so a
neutral factor consumes the base stream identically.  The scheduler
wrapper delegates policy decisions to the base scheduler's RNG and touches
its own (separate) remap RNG only when an elastic transform actually has
to move a job off a down worker.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.delays import TimingModel
from ..core.engine import Schedule, build_schedule
from ..core.schedulers import Scheduler
from .transforms import TRANSFORMS, WorldTransform


# ---------------------------------------------------------------------------
# Spec parsing
# ---------------------------------------------------------------------------

def _coerce(v: str):
    try:
        return int(v)
    except ValueError:
        return float(v)


def parse_scenario(spec: str) -> "Scenario":
    """Parse the ``name:k=v,...;name2:...`` grammar into a Scenario."""
    transforms: list[WorldTransform] = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        name, _, argstr = part.partition(":")
        name = name.strip()
        if name not in TRANSFORMS:
            raise ValueError(
                f"unknown transform {name!r}; want one of {sorted(TRANSFORMS)}")
        kwargs = {}
        for kv in filter(None, (a.strip() for a in argstr.split(","))):
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"malformed transform arg {kv!r} (want k=v)")
            kwargs[k.strip()] = _coerce(v.strip())
        try:
            transforms.append(TRANSFORMS[name](**kwargs))
        except TypeError as e:
            raise ValueError(f"bad args for transform {name!r}: {e}") from None
    return Scenario(transforms=tuple(transforms), spec=spec)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """An ordered composition of world transforms (plus its source spec)."""

    transforms: tuple = ()
    spec: str = ""

    parse = staticmethod(parse_scenario)

    @property
    def names(self) -> tuple:
        return tuple(t.name for t in self.transforms)


# ---------------------------------------------------------------------------
# World clock + wrappers
# ---------------------------------------------------------------------------

class WorldClock:
    """Shared mutable round counter.

    The scheduler wrapper advances it once per ``next_workers`` call — i.e.
    at every server-round boundary — so the timing wrapper can look up
    round-indexed trajectories without the engine knowing anything changed.
    The final boundary of a T-receipt run calls ``next_workers`` at
    t == T, so the clock legitimately reaches ``rounds`` (= T // wait_b);
    trajectory tables are sized rounds+1 (or clamp) for exactly this.
    """

    def __init__(self):
        self.round = 0

    def reset(self) -> None:
        self.round = 0


class ScenarioTimingModel:
    """Timing wrapper: draws from the BASE model's RNG stream at
    transform-modulated speeds.  With no speed-modulating transforms it
    delegates wholesale, so the stationary stream is untouched."""

    def __init__(self, base: TimingModel, clock: WorldClock,
                 speed_transforms: tuple):
        self.base = base
        self.clock = clock
        self.speed_transforms = speed_transforms

    @property
    def n_workers(self) -> int:
        return self.base.n_workers

    @property
    def pattern(self) -> str:
        return self.base.pattern

    def _factors(self, workers: np.ndarray) -> np.ndarray:
        f = np.ones(len(workers), dtype=np.float64)
        for tr in self.speed_transforms:
            f *= tr.speed_factors(workers, self.clock.round)
        return f

    def sample(self, worker: int) -> float:
        if not self.speed_transforms:
            return self.base.sample(worker)
        w = np.asarray([worker], dtype=np.intp)
        s = float(self.base.speeds[worker]) * float(self._factors(w)[0])
        return self.base._draw(s)

    def sample_round(self, workers) -> np.ndarray:
        if not self.speed_transforms:
            return self.base.sample_round(workers)
        workers = np.asarray(workers, dtype=np.intp)
        if workers.size == 0:
            return np.zeros(0, dtype=np.float64)
        s = self.base.speeds[workers] * self._factors(workers)
        return self.base._draw_batch(s)


class ScenarioScheduler:
    """Scheduler wrapper: advances the world clock at each round boundary
    and — when elastic transforms declare workers down — remaps fresh
    assignments onto available workers (graceful drain: the pool never
    halts, jobs just avoid absent workers).

    Policy randomness stays in the base scheduler's RNG; remapping uses a
    separate RNG consumed only when a reassignment actually happens, so
    worlds without elastic transforms (and elastic worlds outside any down
    window) replay the base policy stream untouched.
    """

    def __init__(self, base: Scheduler, clock: WorldClock,
                 availability: np.ndarray | None, remap_seed):
        self.base = base
        self.clock = clock
        self.availability = availability
        self._remap_seed = remap_seed
        self._remap_rng = np.random.default_rng(remap_seed)

    # engine-facing surface -------------------------------------------------
    @property
    def n(self) -> int:
        return self.base.n

    @property
    def wait_b(self) -> int:
        return self.base.wait_b

    @property
    def name(self) -> str:
        return f"scenario({self.base.name})"

    def concurrency(self) -> int:
        return self.base.concurrency()

    def reset(self) -> None:
        self.base.reset()
        self.clock.reset()
        self._remap_rng = np.random.default_rng(self._remap_seed)

    def _remap(self, ws: list) -> list:
        if self.availability is None:
            return ws
        r = min(self.clock.round, self.availability.shape[0] - 1)
        up = np.flatnonzero(self.availability[r] > 0)
        if up.size == 0:        # transforms guarantee this can't happen
            return ws
        up_set = set(int(w) for w in up)
        taken = set(w for w in ws if w in up_set)
        out = []
        for w in ws:
            if w in up_set:
                out.append(w)
                continue
            # prefer an available worker the round hasn't claimed yet (keeps
            # without-replacement policies without replacement)
            free = [int(u) for u in up if int(u) not in taken]
            pool = free if free else [int(u) for u in up]
            pick = int(pool[self._remap_rng.integers(len(pool))])
            taken.add(pick)
            out.append(pick)
        return out

    def initial_workers(self):
        return self._remap(list(self.base.initial_workers()))

    def next_workers(self, finished):
        self.clock.round += 1
        return self._remap(list(self.base.next_workers(finished)))


# ---------------------------------------------------------------------------
# Realisation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScenarioWorld:
    """A realised scenario: the ordinary Schedule plus the per-round
    channels that `runtime.compile_plan` folds into the RunPlan."""

    schedule: Schedule
    scenario: Scenario
    rounds: int
    #: (rounds, n) 0/1 membership, or None when no elastic transform
    availability: np.ndarray | None = None
    #: (rounds,) Zipf exponents, or None when the data law is static
    zipf_as: np.ndarray | None = None
    #: (rounds,) gradient keep-densities in (0, 1], or None
    grad_density: np.ndarray | None = None
    #: (rounds, n) per-worker loss-weight gains (NaN = poisoned receipt),
    #: or None when no fault transform injects gradient faults
    fault_gain: np.ndarray | None = None
    #: sorted round indices where the driver process is scheduled to be
    #: preempted (host-level metadata — never lowered to device), or None
    preempt_rounds: np.ndarray | None = None


def realise_world(scenario: Scenario, scheduler: Scheduler,
                  timing: TimingModel, T: int, *, seed: int = 0,
                  rounds: int | None = None) -> ScenarioWorld:
    """Wrap (scheduler, timing) in the scenario and run the exact engine.

    ``seed`` drives ONLY the scenario layer (transform trajectories and
    elastic remapping) — the base scheduler/timing keep their own seeds, so
    the identity scenario reproduces the stationary schedule bit-for-bit
    regardless of ``seed``.
    """
    if timing.n_workers != scheduler.n:
        raise ValueError("scheduler and timing model disagree on n_workers")
    b = scheduler.wait_b
    n_rounds = T // b if rounds is None else min(rounds, T // b)
    n = scheduler.n

    for i, tr in enumerate(scenario.transforms):
        tr.prepare(n, n_rounds, np.random.default_rng([seed, i]))

    avail = None
    for tr in scenario.transforms:
        a = tr.availability()
        if a is not None:
            a = a[:n_rounds]
            avail = a if avail is None else avail * a

    clock = WorldClock()
    speed_trs = tuple(t for t in scenario.transforms if t.modulates_speed)
    sched_w = ScenarioScheduler(scheduler, clock, avail, [seed, 10_007])
    timing_w = ScenarioTimingModel(timing, clock, speed_trs)
    schedule = build_schedule(sched_w, timing_w, T)

    zipf_as = None
    for tr in scenario.transforms:
        z = tr.zipf_trajectory()
        if z is not None:
            zipf_as = np.asarray(z, dtype=np.float64)[:n_rounds]  # last wins

    density = None
    for tr in scenario.transforms:
        d = tr.grad_density(schedule)
        if d is not None:
            d = np.asarray(d, dtype=np.float32)[:n_rounds]
            # composing sparsifiers: the most aggressive density wins
            density = d if density is None else np.minimum(density, d)

    gain = None
    for tr in scenario.transforms:
        g = tr.fault_gain()
        if g is not None:
            g = np.asarray(g, dtype=np.float32)[:n_rounds]
            # gains compose multiplicatively; NaN absorbs (poison wins)
            gain = g if gain is None else gain * g

    preempts = []
    for tr in scenario.transforms:
        p = tr.preempt_rounds()
        if p is not None and len(p):
            preempts.append(np.asarray(p, dtype=np.int64))
    preempt = (np.unique(np.concatenate(preempts)[
        np.concatenate(preempts) < n_rounds]) if preempts else None)
    if preempt is not None and preempt.size == 0:
        preempt = None

    return ScenarioWorld(
        schedule=schedule,
        scenario=scenario,
        rounds=n_rounds,
        availability=avail,
        zipf_as=zipf_as,
        grad_density=density,
        fault_gain=gain,
        preempt_rounds=preempt,
    )
