"""Queue controller (pkg/controllers/queue).

Reconciles Queue status — PodGroup phase counts
(queue_controller_action.go:34-82) — and the open/close lifecycle driven
by Commands (queue_controller.go:268-330) through the reference's 5-state
machine (queue/state/{factory,open,closed,closing,unknown}.go; "" is
treated as Open, factory.go NewState).

Parity notes (each anchored to the reference):

- The PodGroup set per queue is an incrementally-maintained index
  (queue_controller.go ``podGroups`` map + handler updates,
  queue_controller_handler.go addPodGroup/deletePodGroup), not a scan
  over every PodGroup per sync; phase-only updates re-enqueue a sync
  (updatePodGroup: "if oldPG.Status.Phase != newPG.Status.Phase").
- Open/Close transitions record events on the queue: Normal
  "Open queue succeed"/"Close queue succeed" on an actual state change,
  Warning with the failure on error (queue_controller_action.go
  openQueue/closeQueue recorder.Event calls).
- Status write-back is skipped when nothing changed
  (queue_controller_action.go:70 "ignore update when status does not
  change").
- Failed requests retry up to ``MAX_RETRIES`` (=15, queue_controller.go
  maxRetries) and are then dropped with a Warning event naming the
  action (queue_controller.go handleQueueErr → recordEventsForQueue).
- State-machine quirk reproduced verbatim: a plain Sync on a *Closing*
  queue lands in **Unknown** — closing.go's default branch reads the
  status state ("Closing"), which is neither Open nor Closed, and falls
  through to QueueStateUnknown.  Draining Closing→Closed happens through
  an explicit CloseQueue action when the queue has emptied (closing.go
  CloseQueueAction branch), not through passive syncs.
"""

from __future__ import annotations

import logging
from collections import deque
from dataclasses import dataclass
from typing import Dict, Set

from ..api import QueueState
from ..cache import ClusterStore
from .apis import Action

log = logging.getLogger(__name__)

# queue_controller.go:50-55 maxRetries.
MAX_RETRIES = 15

_OPEN = QueueState.Open.value
_CLOSED = QueueState.Closed.value
_CLOSING = QueueState.Closing.value
_UNKNOWN = QueueState.Unknown.value


@dataclass
class QueueStatus:
    """v1beta1.QueueStatus: state + per-phase PodGroup counts."""

    state: str = _OPEN
    pending: int = 0
    running: int = 0
    unknown: int = 0
    inqueue: int = 0


class QueueController:
    """Poll-driven analog of the reference's queue controller workers."""

    def __init__(self, store: ClusterStore):
        self.store = store
        self.queue = deque()
        self.status: Dict[str, QueueStatus] = {}
        # queue name -> set of PodGroup uids (queue_controller.go podGroups)
        # plus the reverse map, so a PodGroup that moves queues (or is
        # deleted by uid) is removed from its OLD queue's set.
        self.pod_groups: Dict[str, Set[str]] = {}
        self._pg_queue: Dict[str, str] = {}
        # Last-seen PodGroup phase, so updates re-enqueue a sync only on
        # an actual phase change (updatePodGroup's
        # "oldPG.Status.Phase != newPG.Status.Phase" gate) — the store
        # passes only the new object, so the old phase is tracked here.
        self._pg_phase: Dict[str, str] = {}
        self._retries: Dict[tuple, int] = {}
        store.watch(self._on_store_event)

    # ------------------------------------------------------------- handlers

    def _enqueue(self, action: str, name: str) -> None:
        self.queue.append((action, name))

    def _on_store_event(self, kind: str, event: str, obj) -> None:
        if kind == "Queue":
            name = obj if isinstance(obj, str) else obj.name
            if event == "delete":
                # deleteQueue handler: drop the PodGroup index entry.
                self.pod_groups.pop(name, None)
                self.status.pop(name, None)
                return
            # addQueue → SyncQueue.  updateQueue is an explicit no-op in
            # the reference ("currently do not care about queue update",
            # queue_controller_handler.go) — and must be here too: this
            # controller's own write-backs arrive as update events, and
            # reacting to them would self-drive a Closing queue into
            # Unknown with no external cause (Sync-on-Closing derives
            # Unknown, closing.go default branch).
            if event == "add":
                self._enqueue(Action.SyncQueue.value, name)
        elif kind == "PodGroup":
            if event == "delete":
                # The store notifies deletes by uid (the object is gone);
                # the reference recovers the queue from the informer
                # tombstone — here the reverse map is the tombstone.
                uid = obj if isinstance(obj, str) else obj.uid
                old = self._pg_queue.pop(uid, None)
                self._pg_phase.pop(uid, None)
                if old is not None:
                    members = self.pod_groups.get(old)
                    if members is not None:
                        members.discard(uid)
                    self._enqueue(Action.SyncQueue.value, old)
                return
            pg = obj
            qname = getattr(pg, "queue", None)
            if qname is None:
                return
            uid = getattr(pg, "uid", None) or getattr(pg, "name", "")
            old = self._pg_queue.get(uid)
            moved = old is not None and old != qname
            if moved:
                # Queue move: drop from the old set so the group is not
                # double-counted and the old queue can drain.
                members = self.pod_groups.get(old)
                if members is not None:
                    members.discard(uid)
                self._enqueue(Action.SyncQueue.value, old)
            first_seen = old is None
            self._pg_queue[uid] = qname
            self.pod_groups.setdefault(qname, set()).add(uid)
            phase = getattr(getattr(pg, "status", None), "phase", "")
            phase_changed = self._pg_phase.get(uid) != phase
            self._pg_phase[uid] = phase
            # addPodGroup always syncs; updatePodGroup only on a phase
            # change ("if oldPG.Status.Phase != newPG.Status.Phase",
            # queue_controller_handler.go) or a queue move — a spec-only
            # update must NOT re-sync (a Sync on a Closing queue derives
            # Unknown, so a no-op update would corrupt the state).
            if event == "add" or first_seen or moved or phase_changed:
                self._enqueue(Action.SyncQueue.value, qname)
        elif kind == "Command" and event == "add":
            if obj.target_kind == "Queue":
                # handleCommand: delete the Command, enqueue the request.
                self.store.delete_command(obj.name)
                action = (
                    obj.action
                    if obj.action in (Action.OpenQueue.value,
                                      Action.CloseQueue.value)
                    else Action.SyncQueue.value
                )
                self._enqueue(action, obj.target_name)

    # ------------------------------------------------------------- process

    def process_all(self) -> None:
        # Requeued items append to the tail; bound the walk to the items
        # present now so a persistently-failing request cannot spin this
        # call forever (the reference's rate limiter provides the same
        # backpressure through delays).
        for _ in range(len(self.queue)):
            if not self.queue:
                break
            action, name = self.queue.popleft()
            try:
                self._handle_queue(action, name)
            except Exception as e:  # handleQueueErr
                key = (action, name)
                n = self._retries.get(key, 0)
                if n < MAX_RETRIES:
                    self._retries[key] = n + 1
                    self.queue.append((action, name))
                else:
                    self._retries.pop(key, None)
                    self.store.record_event(
                        f"Queue/{name}", action,
                        f"{action} queue failed for {e}",
                    )
                    log.warning("Dropping queue request %s/%s: %s",
                                action, name, e)
            else:
                self._retries.pop((action, name), None)

    def _handle_queue(self, action: str, name: str) -> None:
        queue = self.store.raw_queues.get(name)
        if queue is None:
            # handleQueue: NotFound → "Queue %s has been deleted", done.
            # The PodGroup index is NOT dropped here (the reference's
            # handleQueue touches neither podGroups nor queueStatus):
            # a sync can race ahead of the queue's own add event — e.g.
            # PodGroup-before-Queue watch ordering — and wiping the
            # incrementally-built index would leave a late-created
            # queue permanently reporting zero PodGroups.  Cleanup of
            # both maps belongs to the Queue delete handler.
            self.status.pop(name, None)
            return
        state = queue.state or _OPEN
        if state not in (_OPEN, _CLOSED, _CLOSING, _UNKNOWN):
            raise ValueError(f"queue {name} state {state} is invalid")
        # state.Execute(action): per-state action dispatch
        # (queue/state/*.go).  Each cell is (fn, update_state_fn).
        if action == Action.OpenQueue.value:
            if state == _OPEN:
                # open.go OpenQueueAction → SyncQueue(state=Open).
                self._sync_queue(queue, lambda n_pgs: _OPEN)
            else:
                # closed/closing/unknown.go → OpenQueue(state=Open).
                self._open_queue(queue)
        elif action == Action.CloseQueue.value:
            if state == _CLOSED:
                # closed.go CloseQueueAction → SyncQueue(state=Closed).
                self._sync_queue(queue, lambda n_pgs: _CLOSED)
            elif state == _CLOSING:
                # closing.go CloseQueueAction → SyncQueue(drain).
                self._sync_queue(
                    queue,
                    lambda n_pgs: _CLOSED if n_pgs == 0 else _CLOSING,
                )
            else:
                # open/unknown.go → CloseQueue (event + drain).
                self._close_queue(queue)
        else:
            # SyncQueue: every state's default branch re-derives from
            # the recorded state through the same closure shape
            # (open.go/closed.go/closing.go/unknown.go default cases):
            # Open/"" → Open; Closed → Closed (empty-check only from a
            # non-closed state, closed.go omits it); Closing/Unknown →
            # Unknown (the v0.4 quirk documented in the module
            # docstring).
            def derive(n_pgs: int) -> str:
                if state == _OPEN:
                    return _OPEN
                if state == _CLOSED:
                    return _CLOSED
                return _UNKNOWN

            self._sync_queue(queue, derive)

    # ------------------------------------------------------------- actions

    def _pg_list(self, qname: str) -> Set[str]:
        return self.pod_groups.get(qname, set())

    def _sync_queue(self, queue, update_state_fn) -> None:
        """queue_controller_action.go syncQueue: counts + state closure +
        skip-unchanged write-back."""
        counts = {"Pending": 0, "Running": 0, "Unknown": 0, "Inqueue": 0}
        stale = []
        for uid in self._pg_list(queue.name):
            pg = self.store.pod_groups.get(uid)
            if pg is None:
                # Parity: the reference's syncQueue Get()s each member
                # and, on a NotFound error, deletes it from its local
                # podGroups cache before counting on
                # (queue_controller_action.go:44-56 — the code behind
                # its "check NotFound error and sync local cache"
                # comment).  A store miss IS our NotFound, and the
                # compaction below is that cache delete: the stale uid
                # leaves the index, the counts exclude it, and the
                # post-compaction member count feeds the state closure
                # exactly as n_pgs does there.
                stale.append(uid)
                continue
            phase = pg.status.phase
            if phase in counts:
                counts[phase] += 1
        if stale:
            members = self.pod_groups.get(queue.name)
            if members:
                members.difference_update(stale)
        n_pgs = len(self._pg_list(queue.name))
        new = QueueStatus(
            state=update_state_fn(n_pgs),
            pending=counts["Pending"],
            running=counts["Running"],
            unknown=counts["Unknown"],
            inqueue=counts["Inqueue"],
        )
        old = self.status.get(queue.name)
        if old == new and queue.state == new.state:
            return  # ignore update when status does not change
        self.status[queue.name] = new
        if queue.state != new.state:
            queue.state = new.state
            # UpdateStatus analog: refresh the store's QueueInfo wrapper
            # (what the scheduler session reads) and notify watchers.
            self.store.update_queue(queue)

    def _open_queue(self, queue) -> None:
        """queue_controller_action.go openQueue: state write + event,
        then status refinement."""
        if queue.state == _OPEN:
            return  # openQueue early return: nothing to change
        queue.state = _OPEN
        self.store.record_event(
            f"Queue/{queue.name}", Action.OpenQueue.value,
            "Open queue succeed",
        )
        self.store.update_queue(queue)
        self._sync_queue(queue, lambda n_pgs: _OPEN)

    def _close_queue(self, queue) -> None:
        """queue_controller_action.go closeQueue: state write + event,
        then drain refinement (Closed when empty, else Closing)."""
        if queue.state == _CLOSED:
            return  # closeQueue early return: nothing to change
        # Two-phase write, as the reference does it: the state lands as
        # Closed first (Update + event), then the status refinement
        # downgrades to Closing when PodGroups remain (UpdateStatus after
        # a re-Get).  The transient Closed IS reference behavior — its
        # informers observe the same intermediate write.
        queue.state = _CLOSED
        self.store.record_event(
            f"Queue/{queue.name}", Action.CloseQueue.value,
            "Close queue succeed",
        )
        self.store.update_queue(queue)
        self._sync_queue(
            queue, lambda n_pgs: _CLOSED if n_pgs == 0 else _CLOSING
        )
