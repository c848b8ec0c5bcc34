"""Host-side async runtime: supervised eval / viz / SSD-checkpoint
workers. Counterpart of ``repro/core/runtime.py``.

Paper (§3.1, Fig. 4b): sampling, network update, *test and
visualization* are separate processes that never block each other. The
train thread only *publishes* an actor snapshot (plus the round index,
per-consumer key material and frame/step counters) into a **latest-wins
mailbox** and goes on with the next megastep; worker threads consume
snapshots and run eval and the viz rollout. Results land in the
thread-safe ``TrainHistory`` in **round order** (workers may finish out
of order; recording inserts by round index), solved-early detection is
signalled through an ``Event`` the train loop polls, and ``close()``
drains every pending snapshot before joining, so the last published
weights are always scored.

Latest-wins: a mailbox holds at most ONE pending snapshot. If the
workers fall behind the publish cadence, newer snapshots replace older
unconsumed ones (counted in ``stats()["..._dropped"]``), the way the
paper's processes poll the newest SSD weights. A snapshot a worker has
claimed is never revoked, and the final snapshot is always processed on
drain.

The SSD weight channel (``materialize_fn``): when the trainer syncs
weights through ``.npz`` files, a channel worker does the atomic save +
restore **once per snapshot** and forwards the same materialized actor
to both the eval and viz mailboxes; the train thread never touches the
filesystem. The same machinery carries a **full-state snapshot
channel** (``state_fn`` + ``publish_state``): bundles land in their own
latest-wins mailbox and a dedicated worker persists them.

**Supervision** (:class:`SupervisorPolicy`): *transient* I/O errors
(``OSError``/``ConnectionError``/``TimeoutError``) are retried on the
same snapshot with bounded exponential backoff; anything else is a
*programming error* that propagates to the train thread via
``drain()``/``close()``. A consumer that spends its retry budget
**degrades**: training goes on, its snapshots are dropped (counted) and
``stats()`` records it. A heartbeat watchdog replaces workers that hang
mid-snapshot (``worker_hangs``); a replaced worker's thread is *retired*,
left out of ``close()``'s leak check, and exits quietly if it ever wakes.
``close(timeout=...)`` raises ``RuntimeError`` naming any (non-retired)
worker that fails to join in time.

The runtime has no device code: ``eval_fn(actor, key) -> float`` and
``viz_fn(actor, key, round_i)`` are opaque callables (the trainer's run
each snapshot on the worker's own CUDA stream), so the same machinery
drives device work and plain-Python test doubles. Worker exceptions are
captured and re-raised in the train thread from ``drain()`` /
``close()``.
"""
from __future__ import annotations

import dataclasses
import inspect
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set

#: error classes the supervisor treats as transient I/O trouble worth
#: retrying (ConnectionError/TimeoutError are OSError subclasses —
#: listed for the reader, not the isinstance check)
TRANSIENT_ERRORS = (OSError, ConnectionError, TimeoutError)


def classify_error(e: BaseException) -> str:
    """``"transient"`` (I/O trouble: retry/degrade) or ``"fatal"``
    (programming error: propagate to the train thread)."""
    return "transient" if isinstance(e, TRANSIENT_ERRORS) else "fatal"


@dataclass(frozen=True)
class SupervisorPolicy:
    """How hard the runtime fights to keep its workers alive.

    ``max_restarts`` is a per-consumer budget shared by crash-retries
    and hang-replacements; once spent, the consumer degrades (drops
    snapshots) instead of failing the run. ``heartbeat_timeout_s <= 0``
    disables the watchdog.
    """
    supervise: bool = True
    max_restarts: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    heartbeat_timeout_s: float = 30.0


@dataclass
class Snapshot:
    """One published weight snapshot plus everything its consumers need.

    ``actor`` must be safe for the workers to own: a copy made before
    the next megastep updates the live parameters in place (the
    trainer's clone, with the CUDA event that marks it done).
    ``eval_key``/``viz_key`` are opaque key *material* passed through to
    the consumer callables: the trainer publishes the round index and
    the workers derive their per-round draws from it, so publishing
    launches nothing on the device. ``t`` is the train-clock
    publish time — the instant the weights existed — so async and
    inline runs report comparable solve times.
    """
    round_i: int
    actor: Any
    eval_key: Any = None
    viz_key: Any = None
    t: float = 0.0
    frames: int = 0
    steps: int = 0
    want_eval: bool = True
    want_viz: bool = False


class SnapshotMailbox:
    """Single-slot, latest-wins mailbox shared through one Condition.

    ``publish`` replaces any unconsumed item (the replaced one counts as
    dropped); ``_pop_locked`` hands the slot to a worker atomically with
    the runtime's active-task counter, so a drain can never observe an
    "empty" runtime while a claimed snapshot is still being processed.
    Items are opaque — ``Snapshot`` on the eval/viz/SSD boxes, a
    ``(bundle, meta)`` tuple on the full-state channel.
    """

    def __init__(self, cond: threading.Condition, name: str = "mailbox"):
        self._cond = cond
        self.name = name
        self._item: Optional[Any] = None
        self.published = 0
        self.dropped = 0

    def publish(self, item: Any) -> None:
        with self._cond:
            self._publish_locked(item)

    def _publish_locked(self, item: Any) -> None:
        if self._item is not None:
            self.dropped += 1
        self._item = item
        self.published += 1
        self._cond.notify_all()

    def _pop_locked(self) -> Optional[Any]:
        item, self._item = self._item, None
        return item

    @property
    def empty(self) -> bool:
        return self._item is None


class HostRuntime:
    """Supervised eval/viz/SSD workers behind latest-wins mailboxes.

    Parameters
    ----------
    eval_fn : (actor, key) -> float — blocking eval of one snapshot.
    viz_fn : (actor, key, round_i) -> None — records one trajectory.
    hist : TrainHistory (or duck-type with ``record_eval``) receiving
        results; recording is round-ordered and thread-safe.
    materialize_fn : optional (actor) -> actor. The SSD weight channel:
        runs once per snapshot in its own worker (atomic ``.npz``
        save + restore) before the result fans out to eval and viz.
    state_fn : optional (item) -> None. The full-state snapshot
        channel: persists one ``publish_state`` bundle per call on its
        own worker.
    eval_workers / viz_workers : thread counts per consumer. More than
        one worker only helps when a single eval is slower than the
        publish cadence; results stay round-ordered regardless.
    target_return : solved threshold — an eval result >= this sets
        ``solved`` (an Event the train loop polls) and ``solved_time``
        (the *publish* time of the solving snapshot).
    log_cb : optional (t, ret, frames, steps) callback per eval result.
    policy : SupervisorPolicy — retry/degrade/watchdog behavior.
    """

    def __init__(self, *, eval_fn: Callable[[Any, Any], float],
                 viz_fn: Optional[Callable[[Any, Any, int], None]] = None,
                 hist=None,
                 materialize_fn: Optional[Callable[[Any], Any]] = None,
                 state_fn: Optional[Callable[[Any], None]] = None,
                 eval_workers: int = 1, viz_workers: int = 1,
                 target_return: Optional[float] = None,
                 log_cb: Optional[Callable] = None,
                 policy: Optional[SupervisorPolicy] = None):
        if eval_workers < 1 or viz_workers < 1:
            raise ValueError("worker counts must be >= 1")
        self._eval_fn = eval_fn
        self._viz_fn = viz_fn
        self._hist = hist
        self._materialize_fn = materialize_fn
        # two-arg materializers also receive the snapshot's round index
        # (the trainer's SSD channel keys fault injection by round);
        # one-arg callables keep the original (actor)->actor contract
        self._mat_takes_round = False
        if materialize_fn is not None:
            try:
                params = inspect.signature(materialize_fn).parameters
                self._mat_takes_round = len(params) >= 2
            except (TypeError, ValueError):
                pass
        self._state_fn = state_fn
        self._target = target_return
        self._log_cb = log_cb
        self._policy = policy or SupervisorPolicy()

        self._cond = threading.Condition()
        self._active = 0                 # live claims being processed
        self._closed = False
        self._errors: List[BaseException] = []
        self.solved = threading.Event()
        self.solved_time: Optional[float] = None
        self.eval_done = 0
        self.viz_done = 0
        self.state_done = 0
        # supervision bookkeeping (all under self._cond)
        self.worker_restarts = 0         # crash retries + hang replacements
        self.worker_hangs = 0            # watchdog-detected hangs
        self._restarts_left: Dict[str, int] = {}
        self._degraded: Set[str] = set() # consumers out of retry budget
        self._degraded_dropped = 0       # snapshots dropped while degraded
        self._claims: Dict[int, tuple] = {}  # token -> (thread, box, t0)
        self._claim_seq = 0
        self._abandoned: Set[int] = set()     # claims the watchdog gave up on
        self._abandoned_active = 0
        self._retired: Set[threading.Thread] = set()  # replaced hung threads
        self._replacements = 0

        self._eval_box = SnapshotMailbox(self._cond, "eval")
        self._viz_box = SnapshotMailbox(self._cond, "viz")
        self._boxes = [self._eval_box, self._viz_box]
        self._threads: List[threading.Thread] = []
        if materialize_fn is not None:
            # the SSD channel sits between publish and the consumers
            self._ssd_box = SnapshotMailbox(self._cond, "ssd")
            self._boxes.append(self._ssd_box)
            self._spawn("ssd-channel", self._ssd_box, self._handle_ssd)
        else:
            self._ssd_box = None
        if state_fn is not None:
            self._state_box = SnapshotMailbox(self._cond, "state")
            self._boxes.append(self._state_box)
            self._spawn("state-snap", self._state_box, self._handle_state)
        else:
            self._state_box = None
        for i in range(eval_workers):
            self._spawn(f"eval-{i}", self._eval_box, self._handle_eval)
        if viz_fn is not None:
            for i in range(viz_workers):
                self._spawn(f"viz-{i}", self._viz_box, self._handle_viz)
        if self._policy.supervise and self._policy.heartbeat_timeout_s > 0:
            t = threading.Thread(target=self._watchdog_loop,
                                 name="spreeze-watchdog", daemon=True)
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------------------ #
    # train-thread API
    # ------------------------------------------------------------------ #
    def publish(self, snap: Snapshot) -> None:
        """Non-blocking: route a snapshot to its consumers (via the SSD
        channel when one is configured) and return immediately."""
        with self._cond:
            if self._closed:
                raise RuntimeError("publish() on a closed HostRuntime")
            if self._ssd_box is not None:
                self._ssd_box._publish_locked(snap)
            else:
                self._route_locked(snap)

    def publish_state(self, item: Any) -> None:
        """Non-blocking: hand a full-state bundle to the snapshot
        writer. Latest-wins — an unwritten older bundle is replaced
        (the newest state is strictly more useful to resume from)."""
        with self._cond:
            if self._closed:
                raise RuntimeError("publish_state() on a closed "
                                   "HostRuntime")
            if self._state_box is None:
                raise RuntimeError("no state_fn configured")
            self._state_box._publish_locked(item)

    def state_slot_free(self) -> bool:
        """True when a ``publish_state`` item would be picked up rather
        than replace an unconsumed one. The train loop peeks this before
        building a bundle copy: a copy destined to be dropped
        latest-wins still costs a device copy, so skip it. The slot
        empties the moment the writer *claims* an item, so at most one
        publish is ever pending and cadence cannot stall."""
        with self._cond:
            return self._state_box is not None and self._state_box.empty

    def drain(self, timeout: Optional[float] = 60.0) -> None:
        """Block until every published snapshot is consumed or dropped,
        then re-raise the first worker error (if any) in this thread."""
        with self._cond:
            ok = self._cond.wait_for(self._drained_locked, timeout)
        if not ok:
            raise TimeoutError(f"HostRuntime.drain timed out after "
                               f"{timeout}s")
        self._reraise()

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Graceful shutdown: drain pending snapshots, join workers,
        surface worker errors. Idempotent. A (non-retired) worker that
        fails to join within ``timeout`` raises ``RuntimeError`` naming
        the stuck thread: a silently leaked worker would keep its stream
        (and whatever it holds) alive for the rest of the process."""
        err: Optional[BaseException] = None
        try:
            self.drain(timeout)
        except BaseException as e:      # still join threads on error
            err = e
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            threads = list(self._threads)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for t in threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        with self._cond:
            retired = set(self._retired)
        stuck = [t for t in threads if t.is_alive() and t not in retired]
        if stuck:
            names = ", ".join(t.name for t in stuck)
            raise RuntimeError(
                f"HostRuntime.close: worker(s) {names} failed to join "
                f"within {timeout}s — thread would dangle") from err
        if err is not None:             # the FIRST failure is the story;
            raise err                   # later ones stay queued behind it
        self._reraise()

    def stats(self) -> dict:
        with self._cond:
            s = {"published": (self._ssd_box or self._eval_box).published,
                 "eval_done": self.eval_done, "viz_done": self.viz_done,
                 "eval_dropped": self._eval_box.dropped,
                 "viz_dropped": self._viz_box.dropped,
                 "worker_restarts": self.worker_restarts,
                 "worker_hangs": self.worker_hangs,
                 "degraded": sorted(self._degraded),
                 "degraded_dropped": self._degraded_dropped}
            if self._ssd_box is not None:
                s["ssd_dropped"] = self._ssd_box.dropped
            if self._state_box is not None:
                s["state_done"] = self.state_done
                s["state_dropped"] = self._state_box.dropped
            return s

    # ------------------------------------------------------------------ #
    # worker internals
    # ------------------------------------------------------------------ #
    def _spawn(self, name, box, handler):
        t = threading.Thread(target=self._worker_loop,
                             args=(box, handler),
                             name=f"spreeze-{name}", daemon=True)
        with self._cond:
            self._threads.append(t)
        t.start()

    def _route_locked(self, snap: Snapshot) -> None:
        if snap.want_eval:
            self._eval_box._publish_locked(snap)
        if snap.want_viz and self._viz_fn is not None:
            self._viz_box._publish_locked(snap)

    def _drained_locked(self) -> bool:
        return (all(b.empty for b in self._boxes) and self._active == 0
                ) or bool(self._errors)  # tracelint: allow[host-transfer] -- a list of worker errors

    def _budget_left(self, consumer: str) -> int:
        if consumer not in self._restarts_left:
            self._restarts_left[consumer] = self._policy.max_restarts
        return self._restarts_left[consumer]

    def _worker_loop(self, box: SnapshotMailbox, handler):
        while True:
            with self._cond:
                while box.empty and not self._closed:
                    self._cond.wait(0.2)
                if box.empty and self._closed:
                    return
                item = box._pop_locked()
                if box.name in self._degraded:
                    # out of retry budget: keep draining (training goes
                    # on; the drop is counted, the final summary warns)
                    self._degraded_dropped += 1
                    self._cond.notify_all()
                    continue
                self._active += 1
                self._claim_seq += 1
                token = self._claim_seq
                self._claims[token] = (threading.current_thread(), box,
                                       time.monotonic())
                # handlers re-check this token before committing side
                # effects: a claim the watchdog abandoned must never
                # record its (stale) result when the thread finally wakes
                threading.current_thread()._spreeze_claim = token
            if self._run_claim(token, box, handler, item):
                return      # retired mid-claim: a replacement owns the box

    def _run_claim(self, token: int, box: SnapshotMailbox, handler,
                   item) -> bool:
        """Run one claimed snapshot under the supervisor: transient
        failures retry with bounded backoff, fatal ones propagate, a
        spent budget degrades the consumer. Returns True iff the
        watchdog retired this thread while it ran."""
        err: Optional[BaseException] = None
        was_abandoned = False
        try:
            attempt = 0
            while True:
                try:
                    handler(item)
                    err = None
                    break
                except BaseException as e:
                    err = e
                    if not (self._policy.supervise
                            and classify_error(e) == "transient"):
                        break
                    with self._cond:
                        if self._budget_left(box.name) <= 0:
                            break
                        self._restarts_left[box.name] -= 1
                        self.worker_restarts += 1
                    time.sleep(min(
                        self._policy.backoff_base_s * (2 ** attempt),
                        self._policy.backoff_max_s))
                    attempt += 1
        finally:
            threading.current_thread()._spreeze_claim = None
            with self._cond:
                was_abandoned = token in self._abandoned
                self._claims.pop(token, None)
                if was_abandoned:
                    self._abandoned.discard(token)
                    self._abandoned_active -= 1
                else:
                    self._active -= 1
                    if err is not None:
                        if (self._policy.supervise
                                and classify_error(err) == "transient"):
                            self._degraded.add(box.name)
                        else:
                            self._errors.append(err)
                self._cond.notify_all()
        return was_abandoned

    def _watchdog_loop(self):
        """Heartbeat watchdog: a claim older than the heartbeat timeout
        means its worker hung mid-snapshot. The claim is abandoned (so
        drain() can't deadlock on it), the thread retired, and — budget
        permitting — a replacement worker spawned for the same box."""
        period = min(max(self._policy.heartbeat_timeout_s / 4, 0.01), 1.0)
        while True:
            to_spawn = []
            with self._cond:
                self._cond.wait(period)
                if self._closed:
                    return
                now = time.monotonic()
                for token, (thread, box, t0) in list(self._claims.items()):
                    if (token in self._abandoned or now - t0 <=
                            self._policy.heartbeat_timeout_s):
                        continue
                    self._abandoned.add(token)
                    self._abandoned_active += 1
                    self._active -= 1
                    self.worker_hangs += 1
                    self._retired.add(thread)
                    if self._budget_left(box.name) > 0:
                        self._restarts_left[box.name] -= 1
                        self.worker_restarts += 1
                        self._replacements += 1
                        to_spawn.append(
                            (f"{box.name}-r{self._replacements}", box))
                    else:
                        self._degraded.add(box.name)
                    self._cond.notify_all()
            for name, box in to_spawn:
                self._spawn(name, box, self._handler_for(box))

    def _handler_for(self, box: SnapshotMailbox):
        return {"eval": self._handle_eval, "viz": self._handle_viz,
                "ssd": self._handle_ssd,
                "state": self._handle_state}[box.name]

    def _claim_abandoned_locked(self) -> bool:
        """Caller holds ``self._cond``. True iff the watchdog abandoned
        the calling thread's current claim — its result is stale (the
        round was given away to a replacement) and must not commit."""
        tok = getattr(threading.current_thread(), "_spreeze_claim", None)
        return tok is not None and tok in self._abandoned

    def _handle_ssd(self, snap: Snapshot) -> None:
        # one atomic save+restore per snapshot, shared by eval AND viz
        actor = (self._materialize_fn(snap.actor, snap.round_i)
                 if self._mat_takes_round
                 else self._materialize_fn(snap.actor))
        snap = dataclasses.replace(snap, actor=actor)
        with self._cond:
            if self._claim_abandoned_locked():
                return          # never route a stale snapshot downstream
            self._route_locked(snap)

    def _handle_state(self, item: Any) -> None:
        self._state_fn(item)
        with self._cond:
            if self._claim_abandoned_locked():
                return
            self.state_done += 1

    def _handle_eval(self, snap: Snapshot) -> None:
        # tracelint: allow[host-transfer] -- the eval worker's result, on its own thread and stream
        ret = float(self._eval_fn(snap.actor, snap.eval_key))
        with self._cond:
            if self._claim_abandoned_locked():
                return
            if self._hist is not None:
                self._hist.record_eval(snap.t, ret, snap.frames,
                                       snap.steps, round_i=snap.round_i)
            if self._log_cb is not None:
                self._log_cb(snap.t, ret, snap.frames, snap.steps)
            self.eval_done += 1
            if (self._target is not None and ret >= self._target
                    and not self.solved.is_set()):
                self.solved_time = snap.t
                self.solved.set()

    def _handle_viz(self, snap: Snapshot) -> None:
        self._viz_fn(snap.actor, snap.viz_key, snap.round_i)
        with self._cond:
            if self._claim_abandoned_locked():
                return
            self.viz_done += 1

    def _reraise(self) -> None:
        with self._cond:
            if not self._errors:
                return
            err = self._errors.pop(0)
        raise RuntimeError("HostRuntime worker failed") from err
