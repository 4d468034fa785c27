"""Fault-injection harness: deterministic failures for chaos tests.

None of the crash/resume machinery (SIGTERM graceful stop, rescue
checkpoints, the anomaly guard, the crash supervisor) is trustworthy
until a test actually kills a run mid-flight — this module is the
injection side of those tests (tests/test_faults.py). It is inert
unless explicitly armed; it imports only the stdlib, so the supervisor
and checkpoint layer can use it without device initialization.

A copy of the JAX package's ``utils/faults.py``: the same kinds, spec
grammar, ``DTX_FAULTS`` variable and one-shot rules, so one plan arms
either package. The port's serving engine fires ``serve_raise``,
``serve_hang``, ``canary_regress`` (all three through
:func:`serve_fire`), ``serve_corrupt``, ``page_exhaust``,
``prefix_corrupt``, ``spec_reject_storm``, ``quality_drift`` and
``quality_nan``, the host-tier kinds (``page_demote_fail``,
``page_promote_hang``, ``page_swap_corrupt``) and the migration kinds
(``migrate_corrupt``, ``migrate_hang``) at the JAX engine's points;
its model drafter fires ``spec_drafter_crash`` and its constraint FSM
``constrain_dead_end``. The port's router (serving/router.py) fires the
four router kinds where the JAX router does: ``router_probe_fail`` and
``router_stale_metrics`` in its probe, ``router_pick_raise`` in its
pick and ``router_replica_hang`` in each forwarded attempt. The
control plane's two kinds fire where JAX's do: ``scale_flap`` in
``Autoscaler.tick`` (serving/autoscaler.py), which oscillates the
polled signal over its tick window before the pure ``decide()``, and
``canary_regress`` in every engine step of a canary replica that was
relaunched with it in ``DTX_FAULTS`` (``CanaryController.run``'s
``extra_env``).

A fault PLAN is a comma-separated spec of ``kind@step`` (or
``kind@a-b`` for an inclusive step range, or bare ``kind`` for
call-point faults):

  ``raise@K``           raise :class:`FaultInjected` at the top of
                        training iteration K (a generic crash)
  ``sigterm@K``         SIGTERM self at iteration K (exercises the
                        graceful-stop path, trainer.py)
  ``sigkill@K``         SIGKILL self at iteration K — uncatchable, no
                        cleanup runs (the preemption/hard-crash case)
  ``nan@K`` / ``nan@A-B``
                        NaN-poison the loss of the batch(es) at those
                        iterations (the trainer threads a poison scale
                        into the jitted step; the gradient inherits the
                        NaN, so the whole update is bad)
  ``corrupt_params@K``  overwrite one param leaf with NaN before
                        iteration K — state corruption that batch
                        skipping CANNOT cure; only rollback recovers
  ``ckpt_write`` / ``ckpt_write@N``
                        fail the next (or the Nth upcoming) checkpoint
                        file write, AFTER the temp file is written but
                        BEFORE the atomic rename — the crash point
                        ``atomic_write`` exists to survive
  ``ckpt_fsync``        fail a checkpoint file write AFTER the rename
                        but BEFORE the parent-directory fsync — the
                        window where a power cut can roll the rename
                        back (train/ckpt_writer.py:atomic_write)
  ``ckpt_manifest``     fail a checkpoint save just before the
                        manifest write: leaves a complete but
                        UNcertified directory that latest-resolution
                        and resume must skip
  ``ckpt_gc``           fail retention GC between a checkpoint's
                        de-certification (manifest removed) and its
                        data deletion — the crash-safe-delete-ordering
                        window (train/ckpt_writer.py)
  ``ckpt_hang`` / ``ckpt_hang@N``
                        stall the Nth upcoming async checkpoint save
                        for ``DTX_CKPT_HANG_S`` seconds (default 2.0)
                        inside the writer THREAD — proves the train
                        loop keeps stepping while checkpoint I/O drags
                        and exercises submit() back-pressure
  ``train_hang@K``      stall the HOST train loop at iteration K for
                        ``DTX_TRAIN_HANG_S`` seconds (default 30.0) —
                        the wedge a dead peer or a stuck collective
                        produces; the step-deadline watchdog's trigger
                        (train/watchdog.py). One-shot.
  ``collective_skew@K`` stall iteration K for ``DTX_SKEW_S`` seconds
                        (default 0.5) — one host entering the step's
                        collectives LATE. Short enough that a sane
                        watchdog budget must tolerate it (skew is
                        normal; silence is not). One-shot.
  ``heartbeat_silence@P``
                        MUTE heartbeat publications from process index
                        P (parallel/heartbeat.py skips its publish) —
                        a host that is alive but unreachable; peers
                        must see its heartbeat age grow past
                        ``heartbeat_timeout_s`` and coordinate an
                        abort. NOT one-shot: the peer stays silent.

Serving fault points (``@N`` counts ENGINE iterations —
``ServingEngine.stats["iterations"]`` — not training steps; exercised
by tests/test_serving_resilience.py against the engine supervision in
serving/server.py):

  ``serve_raise@N``     raise :class:`FaultInjected` at the top of
                        engine iteration N (a mid-batch engine crash)
  ``serve_hang@N``      stall engine iteration N for
                        ``DTX_SERVE_HANG_S`` seconds (default 2.0) —
                        the step-time watchdog's trigger
  ``serve_corrupt@N``   NaN-poison one occupied slot's KV rows before
                        iteration N's decode; the engine's finite-logits
                        guard turns this into a typed EngineCrashError
                        that the supervised restart recovers from
  ``page_exhaust@N``    make the paged KV pool (serving/pages.py)
                        refuse its next admission plan with a typed
                        PagePoolExhaustedError at engine iteration N —
                        the request is shed through the 503 queue-shed
                        path instead of waiting or crashing
  ``prefix_corrupt@N``  NaN-poison one radix-CACHED prefix page before
                        iteration N's decode (preferring one shared
                        with an occupied slot): the finite-logits
                        guard fires, the supervised restart rebuilds
                        pool + radix tree, and the poisoned prefix is
                        evicted instead of ever serving garbage tokens
  ``spec_drafter_crash@N``
                        NaN-poison the speculative drafter's own KV
                        pool (serving/spec.py:ModelDrafter) before
                        engine iteration N's proposals: the drafter's
                        finite-logits reduction trips, it rebuilds
                        from params and proposes nothing, and the
                        engine falls back to the non-spec decode step
                        — never garbage tokens. One-shot.
  ``spec_reject_storm@N`` / ``spec_reject_storm@A-B``
                        force the fused verify step to REJECT every
                        drafted token at those engine iterations (a
                        pathological drafter): throughput must
                        degrade gracefully to ~non-spec — one emitted
                        token per slot per step, outputs still exact.
                        NOT one-shot: a range is a storm window.
  ``constrain_dead_end@N``
                        poison one constrained ACTIVE slot's FSM
                        cursor with the dead-end sentinel before
                        engine iteration N's decode: every token is
                        masked out, and the engine must retire the
                        request TYPED (finish_reason
                        "constraint_dead_end", partial output
                        delivered, slot + pages reclaimed) — never
                        hang, never emit a garbage token. One-shot.
                        Compiled FSMs prune dead states (Willard &
                        Louf), so only this fault reaches the
                        non-accepting zero-mask sweep.
  ``page_demote_fail@N``
                        fail the host-tier page demotions drained at
                        engine iteration N (serving/host_tier.py): the
                        evicted pages' device capture is skipped, the
                        prefix is simply LOST from the tier (counted
                        ``serving_host_tier_fallbacks_total``), and the
                        next request for it recomputes — degradation
                        back to pre-tier behavior, never a wedge.
                        One-shot.
  ``page_promote_hang@N``
                        stall the promotions applied at engine
                        iteration N for ``DTX_TIER_HANG_S`` seconds
                        (default 2.0), then FAIL them: the admission
                        truncates its cached length back to the
                        device-resident prefix and prefills the rest —
                        recompute fallback, typed and counted, never a
                        hang past the stall or garbage KV. One-shot.
  ``page_swap_corrupt@N``
                        flip one byte of a stashed page image before
                        the swap-in at engine iteration N: the CRC32
                        verify at injection must catch it, drop the
                        stash, and fall back to a full bit-exact
                        restart of the request (fold_in per-request
                        keys) — never garbage tokens. One-shot.
  ``quality_drift@N``   perturb the model's params before engine
                        iteration N (layer-1 λ for diff/ndiff; an
                        exact lm_head logit rescale for control, so
                        greedy outputs stay IDENTICAL) — logits stay
                        finite and latency flat, only the token-
                        quality distribution moves; the drift
                        fingerprint (obs/quality.py,
                        ``serving_quality_drift``) is the ONLY
                        detector that can catch it. Requires
                        ``--quality-telemetry``. One-shot; persists in
                        the params until restart.
  ``quality_nan@N``     NaN-poison the HOST-side quality telemetry of
                        engine iteration N (the decode step itself is
                        untouched): every signal that iteration must
                        degrade to "no signal" — skipped
                        observations, never a crash, never a drift
                        false-positive. Requires
                        ``--quality-telemetry``. One-shot.

Constraint fault points (call-point style — ``@N`` counts CALLS):

  ``constrain_compile_fail`` / ``constrain_compile_fail@N``
                        fail the Nth upcoming constraint FSM compile
                        (serving/constrain.py:compile_constraint)
                        with the typed ConstraintCompileError: the
                        submit path must reject the request (HTTP
                        400 "constraint_compile_failed") with the
                        engine untouched — no queue entry, no slot,
                        no cache reference.

Router fault points (call-point style like ``ckpt_*`` — ``@N`` counts
CALLS until the fault fires, default 1; exercised by
tests/test_router.py against serving/router.py):

  ``router_probe_fail`` / ``router_probe_fail@N``
                        fail the Nth upcoming health probe (the prober
                        treats it like an unreachable replica — drives
                        the ejection state machine deterministically)
  ``router_replica_hang`` / ``router_replica_hang@N``
                        stall the Nth upcoming forwarded request for
                        ``DTX_ROUTER_HANG_S`` seconds (default 2.0)
                        before it leaves the router — a hung replica
                        from the client's view; the hedging trigger
  ``router_pick_raise`` / ``router_pick_raise@N``
                        raise :class:`FaultInjected` inside the Nth
                        upcoming replica pick — an unexpected router
                        bug; must surface as a typed 500, never kill
                        the router process
  ``router_stale_metrics`` / ``router_stale_metrics@N``
                        SKIP the next N probe /metrics refreshes
                        (fires through :func:`consume`, consuming one
                        count per skipped refresh): the replica stays
                        healthy and routable but its /fleet/metrics
                        body goes STALE — the staleness stamping
                        (scrape_age_seconds) must flag it and judges
                        must treat the body as missing

Migration fault points (serving/migrate.py + serving/server.py;
call-point style — ``@N`` counts CALLS; exercised by
tests/test_migrate.py):

  ``migrate_corrupt`` / ``migrate_corrupt@N``
                        flip one byte of the Nth upcoming exported
                        page image AFTER its CRC32 is stamped (fires
                        through :func:`consume`): the import side's
                        checksum verify must convict the transfer
                        (typed MigratePayloadError), the migration
                        fails counted, and the router falls back to
                        resume-by-replay — the request still succeeds
                        and garbage KV is never attended
  ``migrate_hang`` / ``migrate_hang@N``
                        stall the Nth upcoming slot-state export for
                        ``DTX_MIGRATE_HANG_S`` seconds (default 2.0)
                        — a slow/stuck transfer; the drain path's
                        total transfer budget (serving/retry.py
                        deadline) must bound it and fall back typed

Control-plane fault points (tools/autoscaler.py + serving/engine.py;
exercised by tests/test_autoscaler.py):

  ``scale_flap@T`` / ``scale_flap@A-B``
                        oscillate the autoscaler's observed capacity
                        signal on those control TICKS (alternating
                        extreme-high / extreme-low burn by tick
                        parity): hysteresis + cooldowns must hold the
                        replica count steady. NOT one-shot — arm a
                        range for a sustained flap window.
  ``canary_regress``    persistent per-iteration step-time penalty
                        (``DTX_CANARY_REGRESS_S`` seconds, default
                        0.05) injected at the top of every engine
                        step while armed — a deliberately
                        perf-regressed canary build; the canary judge
                        must auto-roll-back unattended. Armed on ONE
                        replica via its DTX_FAULTS env.

Armed from the ``DTX_FAULTS`` environment variable on first use (env
crosses the supervisor's subprocess boundary) and/or programmatically
via :func:`arm` (``TrainConfig.faults`` feeds this). One-shot kinds
(raise/sigterm/sigkill/corrupt_params/ckpt_write) disarm after firing
so a resumed run that replays the same step does not re-fire in
process; across processes the supervisor strips ``DTX_FAULTS`` from the
child environment on restarts (tools/train_supervisor.py).
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional, Set

ENV_VAR = "DTX_FAULTS"
HANG_ENV_VAR = "DTX_SERVE_HANG_S"
CKPT_HANG_ENV_VAR = "DTX_CKPT_HANG_S"
ROUTER_HANG_ENV_VAR = "DTX_ROUTER_HANG_S"
TRAIN_HANG_ENV_VAR = "DTX_TRAIN_HANG_S"
SKEW_ENV_VAR = "DTX_SKEW_S"
TIER_HANG_ENV_VAR = "DTX_TIER_HANG_S"
CANARY_REGRESS_ENV_VAR = "DTX_CANARY_REGRESS_S"
MIGRATE_HANG_ENV_VAR = "DTX_MIGRATE_HANG_S"

_STEP_KINDS = (
    "raise", "sigterm", "sigkill", "nan", "corrupt_params",
    # host-loop stall kinds: train_hang is the watchdog's trigger,
    # collective_skew the tolerance case; heartbeat_silence's "step"
    # is a PROCESS INDEX to mute (parallel/heartbeat.py), not a step
    "train_hang", "collective_skew", "heartbeat_silence",
    # serving kinds: steps are ENGINE iterations, not training steps
    "serve_raise", "serve_hang", "serve_corrupt",
    # paged-KV kinds (serving/pages.py): typed pool exhaustion and
    # cached-prefix poisoning, same engine-iteration counting
    "page_exhaust", "prefix_corrupt",
    # speculative-decoding kinds (serving/spec.py): drafter-pool
    # poison (one-shot) and the persistent 0%-acceptance storm
    "spec_drafter_crash", "spec_reject_storm",
    # structured-decoding kind (serving/constrain.py): dead-end-sentinel
    # poison of one constrained slot's FSM cursor
    "constrain_dead_end",
    # host-tier kinds (serving/host_tier.py): demotion capture failure,
    # promotion stall-then-fail, and stash corruption before swap-in
    "page_demote_fail", "page_promote_hang", "page_swap_corrupt",
    # autoscaler kind (tools/autoscaler.py): "step" is a control TICK;
    # armed ticks see an oscillating capacity signal (not one-shot)
    "scale_flap",
    # model-quality kinds (obs/quality.py): a silent params drift only
    # the quality fingerprint catches, and a NaN telemetry tail that
    # must degrade to "no signal" rather than crash the step or judge
    "quality_drift", "quality_nan",
)
_POINT_KINDS = (
    "ckpt_write", "ckpt_fsync", "ckpt_manifest", "ckpt_gc",
    # stall-class point: fires through stall() (sleeps), not check()
    "ckpt_hang",
    # router points (serving/router.py): probe/pick fire through
    # check(), replica_hang through stall()
    "router_probe_fail", "router_pick_raise", "router_replica_hang",
    # constraint-compile point (serving/constrain.py:compile_constraint)
    "constrain_compile_fail",
    # staleness point (serving/router.py): consume() skips the next N
    # probe metrics refreshes instead of raising
    "router_stale_metrics",
    # persistent engine-step penalty (serve_fire): a deliberately
    # perf-regressed canary build; membership-checked, never consumed
    "canary_regress",
    # live-migration points (serving/migrate.py): corrupt fires through
    # consume() (flip a byte post-checksum), hang through stall()
    "migrate_corrupt", "migrate_hang",
)


class FaultInjected(RuntimeError):
    """The injected failure (distinguishable from organic errors)."""


_plan: Optional[dict] = None  # lazy; see _get()


def _parse_steps(expr: str) -> Set[int]:
    if "-" in expr:
        a, b = expr.split("-", 1)
        return set(range(int(a), int(b) + 1))
    return {int(expr)}


def _parse(spec: str) -> dict:
    plan = {k: set() for k in _STEP_KINDS}
    plan["points"] = {}  # point -> calls remaining until it fires
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        kind, _, arg = token.partition("@")
        if kind in _STEP_KINDS:
            if not arg:
                raise ValueError(f"fault {kind!r} needs @step (got {token!r})")
            plan[kind] |= _parse_steps(arg)
        elif kind in _POINT_KINDS:
            plan["points"][kind] = int(arg) if arg else 1
        else:
            raise ValueError(
                f"unknown fault kind {kind!r} in {token!r}; known: "
                f"{_STEP_KINDS + _POINT_KINDS}"
            )
    return plan


def _get() -> dict:
    global _plan
    if _plan is None:
        _plan = _parse(os.environ.get(ENV_VAR, ""))
    return _plan


def arm(spec: Optional[str]) -> None:
    """Merge a spec into the armed plan (env faults stay armed)."""
    if not spec:
        _get()
        return
    extra = _parse(spec)
    plan = _get()
    for k in _STEP_KINDS:
        plan[k] |= extra[k]
    plan["points"].update(extra["points"])


def reset() -> None:
    """Disarm everything (tests); env re-arms lazily on next use."""
    global _plan
    _plan = None
    if ENV_VAR in os.environ:  # a stale env spec must not re-arm
        _plan = _parse("")


def armed() -> bool:
    p = _get()
    return bool(p["points"]) or any(p[k] for k in _STEP_KINDS)


def fire(step: int) -> None:
    """Crash-class faults for this iteration; called at the top of the
    train loop. raise/sigterm are one-shot; sigkill needs no disarm."""
    p = _get()
    if step in p["raise"]:
        p["raise"].discard(step)
        raise FaultInjected(f"injected crash at iteration {step}")
    if step in p["sigterm"]:
        p["sigterm"].discard(step)
        os.kill(os.getpid(), signal.SIGTERM)
    if step in p["sigkill"]:
        os.kill(os.getpid(), signal.SIGKILL)


def serve_fire(iteration: int) -> None:
    """Crash-class serving faults for this ENGINE iteration; called at
    the top of ``ServingEngine.step``. ``serve_raise`` is one-shot (a
    supervised restart replaying the same iteration number must not
    re-crash); ``serve_hang`` stalls the step long enough for the
    wall-time watchdog to flag the engine degraded, then disarms.
    ``canary_regress`` is deliberately PERSISTENT — every iteration
    pays the injected step-time penalty while it stays armed (a
    regressed build does not heal itself); the canary judge's
    auto-rollback is what ends it."""
    p = _get()
    if iteration in p["serve_raise"]:
        p["serve_raise"].discard(iteration)
        raise FaultInjected(
            f"injected engine crash at iteration {iteration}"
        )
    if iteration in p["serve_hang"]:
        p["serve_hang"].discard(iteration)
        time.sleep(float(os.environ.get(HANG_ENV_VAR, "2.0")))
    if "canary_regress" in p["points"]:
        time.sleep(float(os.environ.get(CANARY_REGRESS_ENV_VAR, "0.05")))


def serve_corrupt_at(iteration: int) -> bool:
    """One-shot slot-corruption fault: when armed for this engine
    iteration, the engine NaN-poisons one occupied slot's KV rows."""
    p = _get()
    if iteration in p["serve_corrupt"]:
        p["serve_corrupt"].discard(iteration)
        return True
    return False


def page_exhaust_at(iteration: int) -> bool:
    """One-shot paged-pool exhaustion fault: when armed for this engine
    iteration, the engine forces the page pool's next admission plan to
    raise the typed :class:`~serving.pages.PagePoolExhaustedError`
    (surfaced as the 503 shed path)."""
    p = _get()
    if iteration in p["page_exhaust"]:
        p["page_exhaust"].discard(iteration)
        return True
    return False


def prefix_corrupt_at(iteration: int) -> bool:
    """One-shot cached-prefix poison fault: when armed for this engine
    iteration, the engine NaN-poisons one radix-cached prefix page —
    the finite-logits guard (not garbage tokens) must catch it."""
    p = _get()
    if iteration in p["prefix_corrupt"]:
        p["prefix_corrupt"].discard(iteration)
        return True
    return False


def spec_drafter_crash_at(iteration: int) -> bool:
    """One-shot drafter-pool poison fault: when armed for this engine
    iteration, the engine NaN-poisons the speculative drafter's KV
    pool — the drafter's finite-logits guard (not garbage proposals)
    must catch it and fall back to non-spec decode."""
    p = _get()
    if iteration in p["spec_drafter_crash"]:
        p["spec_drafter_crash"].discard(iteration)
        return True
    return False


def spec_reject_storm_at(iteration: int) -> bool:
    """Whether the fused verify step must reject EVERY drafted token
    at this engine iteration. Deliberately NOT one-shot — arm a range
    (``spec_reject_storm@A-B``) for a sustained storm; the throughput
    floor under it is the non-spec rate."""
    return iteration in _get()["spec_reject_storm"]


def constrain_dead_end_at(iteration: int) -> bool:
    """One-shot constraint dead-end fault: when armed for this engine
    iteration, the engine plants the dead-end sentinel (fsm_state -1)
    on one constrained ACTIVE slot — the zero-mask sweep must retire
    it typed (finish_reason "constraint_dead_end"), never hang or
    emit through an all-zero mask."""
    p = _get()
    if iteration in p["constrain_dead_end"]:
        p["constrain_dead_end"].discard(iteration)
        return True
    return False


def page_demote_fail_at(iteration: int) -> bool:
    """One-shot demotion-failure fault: when armed for this engine
    iteration, the engine SKIPS capturing the drained demotion plans'
    device bytes — the evicted prefixes are lost from the tier (typed,
    counted) and later requests recompute them. One-shot."""
    p = _get()
    if iteration in p["page_demote_fail"]:
        p["page_demote_fail"].discard(iteration)
        return True
    return False


def page_promote_hang_at(iteration: int) -> bool:
    """One-shot promotion-stall fault: when armed for this engine
    iteration, the engine sleeps ``DTX_TIER_HANG_S`` seconds (default
    2.0) and then FAILS the admission's promotions — the recompute
    fallback (cached length truncated to the device prefix) must kick
    in, typed and counted, never a wedge."""
    p = _get()
    if iteration in p["page_promote_hang"]:
        p["page_promote_hang"].discard(iteration)
        time.sleep(float(os.environ.get(TIER_HANG_ENV_VAR, "2.0")))
        return True
    return False


def page_swap_corrupt_at(iteration: int) -> bool:
    """One-shot swap-corruption fault: when armed for this engine
    iteration, the engine flips one byte of a stashed page image
    before injecting it — the CRC32 verify must detect it and degrade
    to a bit-exact full restart, never inject garbage KV."""
    p = _get()
    if iteration in p["page_swap_corrupt"]:
        p["page_swap_corrupt"].discard(iteration)
        return True
    return False


def quality_drift_at(iteration: int) -> bool:
    """One-shot silent-drift fault: when armed for this engine
    iteration, the engine perturbs its params (λ for the diff
    families, an argmax-preserving logit rescale for control) — logits
    stay finite and fast, so only the quality fingerprint's PSI score
    can flag the replica. The perturbation persists until restart."""
    p = _get()
    if iteration in p["quality_drift"]:
        p["quality_drift"].discard(iteration)
        return True
    return False


def quality_nan_at(iteration: int) -> bool:
    """One-shot telemetry-poison fault: when armed for this engine
    iteration, the engine replaces that iteration's host-side quality
    signals with NaN — the "no signal" degradation contract
    (obs/quality.py) must skip them, never crash or score drift."""
    p = _get()
    if iteration in p["quality_nan"]:
        p["quality_nan"].discard(iteration)
        return True
    return False


def train_stall(step: int) -> None:
    """Host-loop stall faults for this training iteration; called just
    after the watchdog arms (train/trainer.py) so the stall lands
    INSIDE the armed window. ``train_hang`` sleeps long enough
    (``DTX_TRAIN_HANG_S``, default 30 s) that a sane step deadline
    fires first; ``collective_skew`` sleeps briefly (``DTX_SKEW_S``,
    default 0.5 s) — ordinary straggler skew the watchdog must ride
    out. Both one-shot."""
    p = _get()
    if step in p["train_hang"]:
        p["train_hang"].discard(step)
        time.sleep(float(os.environ.get(TRAIN_HANG_ENV_VAR, "30.0")))
    if step in p["collective_skew"]:
        p["collective_skew"].discard(step)
        time.sleep(float(os.environ.get(SKEW_ENV_VAR, "0.5")))


def scale_flap_at(tick: int) -> bool:
    """Whether the autoscaler's observed capacity signal must OSCILLATE
    at this control tick (``scale_flap@A-B``). Deliberately NOT
    one-shot — a flap window spans many ticks; hysteresis + cooldowns
    are what must hold the fleet steady through it."""
    return tick in _get()["scale_flap"]


def canary_regress_armed() -> bool:
    """Whether the persistent canary step-time penalty is armed (the
    judge/test side can ask without paying the sleep)."""
    return "canary_regress" in _get()["points"]


def heartbeat_silenced(process_index: int) -> bool:
    """Whether heartbeat publications from this process index are muted
    (``heartbeat_silence@P``). Deliberately NOT one-shot — a partitioned
    host stays silent until something kills it."""
    return process_index in _get()["heartbeat_silence"]


def nan_armed() -> bool:
    """Whether any NaN-poison steps are armed — when true the trainer
    threads a poison scale through EVERY step so the batch pytree
    structure (and therefore the compiled program) never changes."""
    return bool(_get()["nan"])


def poison_at(step: int) -> bool:
    return step in _get()["nan"]


def corrupt_params_at(step: int) -> bool:
    p = _get()
    if step in p["corrupt_params"]:
        p["corrupt_params"].discard(step)
        return True
    return False


def check(point: str) -> None:
    """Call-point fault (e.g. ``ckpt_write``): raises on the armed call."""
    points = _get()["points"]
    if point not in points:
        return
    points[point] -= 1
    if points[point] <= 0:
        del points[point]
        raise FaultInjected(f"injected failure at {point}")


def consume(point: str) -> bool:
    """Consuming call-point fault (``router_stale_metrics@N``): each
    armed call returns True AND spends one count — the fault fires on
    the next N calls, then disarms. The inverse budget shape from
    :func:`check` (which fires ONCE, on the Nth call): use this for
    "the next N occurrences misbehave" windows."""
    points = _get()["points"]
    if point not in points:
        return False
    points[point] -= 1
    if points[point] <= 0:
        del points[point]
    return True


def stall(point: str) -> None:
    """Stall-class call-point fault (``ckpt_hang``,
    ``router_replica_hang``, ``migrate_hang``): the armed call SLEEPS
    instead of raising — a slow disk / hung replica, not a broken one.
    The sleep length comes from ``DTX_ROUTER_HANG_S`` for ``router_*``
    points, ``DTX_MIGRATE_HANG_S`` for ``migrate_*`` points, and
    ``DTX_CKPT_HANG_S`` otherwise (default 2.0 s). Same ``@N``
    call-counting as :func:`check`."""
    points = _get()["points"]
    if point not in points:
        return
    points[point] -= 1
    if points[point] <= 0:
        del points[point]
        if point.startswith("router_"):
            env = ROUTER_HANG_ENV_VAR
        elif point.startswith("migrate_"):
            env = MIGRATE_HANG_ENV_VAR
        else:
            env = CKPT_HANG_ENV_VAR
        time.sleep(float(os.environ.get(env, "2.0")))
