"""Active/passive leader election.

The counterpart of the JAX package's ``ha.py``, unchanged in behaviour.
The reference runs the scheduler as active/passive replicas coordinated
by a resource-lock lease in the API server (15 s lease, 10 s renew
deadline, 5 s retry -- ``cmd/scheduler/app/server.go`` leaderelection
block).  Without an API server the shared lock is a lease file on storage
every replica reaches: the holder refreshes a (holder-id, expiry) record;
a standby acquires when the record expires.

Atomicity relies on ``os.replace`` within one filesystem plus re-reading
the record after writing -- the optimistic concurrency the reference gets
from resourceVersion-checked updates.  A leader that finds another holder
in the record demotes at once.  ``Scheduler(store, gate=lambda:
elector.is_leader)`` runs cycles only while leading.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Callable, Optional

LEASE_DURATION = 15.0  # seconds (leaseDuration in the reference)
RENEW_DEADLINE = 10.0  # renewDeadline
RETRY_PERIOD = 5.0  # retryPeriod


class LeaderElector:
    """File-lease active/passive election.

    ``run(on_started_leading, on_stopped_leading)`` blocks, retrying
    acquisition every ``retry_period`` until elected, then renews every
    ``renew_deadline/2``; losing the lease invokes ``on_stopped_leading``
    and re-enters the acquire loop (the reference exits the process;
    embedders may do the same from the callback).
    """

    def __init__(
        self,
        lease_path: str,
        identity: Optional[str] = None,
        lease_duration: float = LEASE_DURATION,
        renew_deadline: float = RENEW_DEADLINE,
        retry_period: float = RETRY_PERIOD,
    ):
        self.lease_path = lease_path
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self._stop = threading.Event()
        self.is_leader = False

    # ------------------------------------------------------------- lease io

    def _read(self) -> Optional[dict]:
        try:
            with open(self.lease_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write(self, record: dict) -> bool:
        tmp = f"{self.lease_path}.{self.identity}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, self.lease_path)
        except OSError:
            return False
        # Optimistic concurrency: verify our write won.
        check = self._read()
        return bool(check and check.get("holder") == self.identity
                    and check.get("acquired") == record["acquired"])

    # ------------------------------------------------------------ election

    def try_acquire(self) -> bool:
        now = time.time()
        rec = self._read()
        if rec and rec.get("holder") != self.identity:
            if now < float(rec.get("expiry", 0)):
                return False  # held by a live leader
        record = {
            "holder": self.identity,
            "acquired": now,
            "expiry": now + self.lease_duration,
        }
        if not self._write(record):
            return False
        # Double-check after a short settle: two standbys racing the same
        # expiry can both see their own write momentarily; the later
        # writer wins, so re-read once more before claiming leadership.
        time.sleep(min(0.05, self.retry_period / 10))
        check = self._read()
        return bool(check and check.get("holder") == self.identity)

    def renew(self) -> bool:
        rec = self._read()
        if not rec or rec.get("holder") != self.identity:
            return False
        now = time.time()
        record = {
            "holder": self.identity,
            "acquired": rec["acquired"],
            "expiry": now + self.lease_duration,
        }
        return self._write(record)

    def release(self) -> None:
        rec = self._read()
        if rec and rec.get("holder") == self.identity:
            try:
                os.unlink(self.lease_path)
            except OSError:
                pass
        self.is_leader = False

    def run(
        self,
        on_started_leading: Callable[[], None],
        on_stopped_leading: Callable[[], None],
        once: bool = False,
    ) -> None:
        """Acquire -> lead -> (lose) -> reacquire loop.  ``once`` returns
        after the first leadership loss (reference semantics: the process
        exits on lost leadership, server.go OnStoppedLeading)."""
        while not self._stop.is_set():
            while not self._stop.is_set() and not self.try_acquire():
                self._stop.wait(self.retry_period)
            if self._stop.is_set():
                return
            self.is_leader = True
            on_started_leading()
            deadline = time.time() + self.renew_deadline
            while not self._stop.is_set():
                self._stop.wait(self.renew_deadline / 2)
                if self._stop.is_set():
                    break
                if self.renew():
                    deadline = time.time() + self.renew_deadline
                    continue
                rec = self._read()
                if rec and rec.get("holder") != self.identity:
                    # Another replica holds the lease: demote NOW —
                    # continuing to act until the deadline would run two
                    # leaders concurrently.
                    break
                if time.time() > deadline:
                    break
            self.is_leader = False
            on_stopped_leading()
            if once or self._stop.is_set():
                return

    def stop(self) -> None:
        self._stop.set()
        self.release()
