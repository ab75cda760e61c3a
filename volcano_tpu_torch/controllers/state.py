"""Job state machine (pkg/controllers/job/state/): 8 states, each mapping a
bus Action to SyncJob/KillJob plus a phase-transition closure.

Pod-retain semantics (state/factory.go): ``PodRetainPhaseNone`` kills every
pod; ``PodRetainPhaseSoft`` retains Succeeded/Failed pods.
"""

from __future__ import annotations

from typing import Callable, Optional, Set

from .apis import Action, DEFAULT_MAX_RETRY, Job, JobPhase, JobStatus

POD_RETAIN_PHASE_NONE: Set[str] = set()
POD_RETAIN_PHASE_SOFT: Set[str] = {"Succeeded", "Failed"}

UpdateStatusFn = Optional[Callable[[JobStatus], bool]]


class State:
    """Base: execute(action) drives sync_job/kill_job on the controller."""

    def __init__(self, ctrl, job: Job):
        self.ctrl = ctrl
        self.job = job

    def execute(self, action: str) -> None:
        raise NotImplementedError


def _phase(status: JobStatus, phase: JobPhase) -> bool:
    status.state.phase = phase.value
    return True


class PendingState(State):
    def execute(self, action: str) -> None:
        job = self.job
        if action == Action.RestartJob.value:
            def f(s):
                s.retry_count += 1
                return _phase(s, JobPhase.Restarting)
            self.ctrl.kill_job(job, POD_RETAIN_PHASE_NONE, f)
        elif action == Action.AbortJob.value:
            self.ctrl.kill_job(job, POD_RETAIN_PHASE_SOFT,
                               lambda s: _phase(s, JobPhase.Aborting))
        elif action == Action.CompleteJob.value:
            self.ctrl.kill_job(job, POD_RETAIN_PHASE_SOFT,
                               lambda s: _phase(s, JobPhase.Completing))
        elif action == Action.TerminateJob.value:
            self.ctrl.kill_job(job, POD_RETAIN_PHASE_SOFT,
                               lambda s: _phase(s, JobPhase.Terminating))
        else:
            def f(s):
                if job.min_available <= s.running + s.succeeded + s.failed:
                    return _phase(s, JobPhase.Running)
                return False
            self.ctrl.sync_job(job, f)


class RunningState(State):
    def execute(self, action: str) -> None:
        job = self.job
        if action == Action.RestartJob.value:
            def f(s):
                s.retry_count += 1
                return _phase(s, JobPhase.Restarting)
            self.ctrl.kill_job(job, POD_RETAIN_PHASE_NONE, f)
        elif action == Action.AbortJob.value:
            self.ctrl.kill_job(job, POD_RETAIN_PHASE_SOFT,
                               lambda s: _phase(s, JobPhase.Aborting))
        elif action == Action.TerminateJob.value:
            self.ctrl.kill_job(job, POD_RETAIN_PHASE_SOFT,
                               lambda s: _phase(s, JobPhase.Terminating))
        elif action == Action.CompleteJob.value:
            self.ctrl.kill_job(job, POD_RETAIN_PHASE_SOFT,
                               lambda s: _phase(s, JobPhase.Completing))
        else:
            def f(s):
                total = job.total_tasks()
                if s.succeeded + s.failed == total:
                    if s.succeeded >= job.min_available:
                        return _phase(s, JobPhase.Completed)
                    return _phase(s, JobPhase.Failed)
                return False
            self.ctrl.sync_job(job, f)


class RestartingState(State):
    def execute(self, action: str) -> None:
        job = self.job

        def f(s):
            max_retry = job.max_retry or DEFAULT_MAX_RETRY
            if s.retry_count >= max_retry:
                return _phase(s, JobPhase.Failed)
            total = job.total_tasks()
            if total - s.terminating >= s.min_available:
                return _phase(s, JobPhase.Pending)
            return False

        self.ctrl.kill_job(job, POD_RETAIN_PHASE_NONE, f)


class AbortingState(State):
    def execute(self, action: str) -> None:
        job = self.job
        if action == Action.ResumeJob.value:
            def f(s):
                s.retry_count += 1
                return _phase(s, JobPhase.Restarting)
            self.ctrl.kill_job(job, POD_RETAIN_PHASE_SOFT, f)
        else:
            def f(s):
                if s.terminating or s.pending or s.running:
                    return False
                return _phase(s, JobPhase.Aborted)
            self.ctrl.kill_job(job, POD_RETAIN_PHASE_SOFT, f)


class AbortedState(State):
    def execute(self, action: str) -> None:
        job = self.job
        if action == Action.ResumeJob.value:
            def f(s):
                s.retry_count += 1
                return _phase(s, JobPhase.Restarting)
            self.ctrl.kill_job(job, POD_RETAIN_PHASE_SOFT, f)
        else:
            self.ctrl.kill_job(job, POD_RETAIN_PHASE_SOFT, None)


class TerminatingState(State):
    def execute(self, action: str) -> None:
        def f(s):
            if s.terminating or s.pending or s.running:
                return False
            return _phase(s, JobPhase.Terminated)

        self.ctrl.kill_job(self.job, POD_RETAIN_PHASE_SOFT, f)


class CompletingState(State):
    def execute(self, action: str) -> None:
        def f(s):
            if s.terminating or s.pending or s.running:
                return False
            return _phase(s, JobPhase.Completed)

        self.ctrl.kill_job(self.job, POD_RETAIN_PHASE_SOFT, f)


class FinishedState(State):
    """Completed/Failed/Terminated: only ensure lingering pods are gone
    (state/finished.go)."""

    def execute(self, action: str) -> None:
        self.ctrl.kill_job(self.job, POD_RETAIN_PHASE_SOFT, None)


def new_state(ctrl, job: Job) -> State:
    """state/factory.go NewState."""
    phase = job.status.state.phase
    if phase in (JobPhase.Pending.value, ""):
        return PendingState(ctrl, job)
    if phase == JobPhase.Running.value:
        return RunningState(ctrl, job)
    if phase == JobPhase.Restarting.value:
        return RestartingState(ctrl, job)
    if phase == JobPhase.Aborting.value:
        return AbortingState(ctrl, job)
    if phase == JobPhase.Aborted.value:
        return AbortedState(ctrl, job)
    if phase == JobPhase.Terminating.value:
        return TerminatingState(ctrl, job)
    if phase == JobPhase.Completing.value:
        return CompletingState(ctrl, job)
    return FinishedState(ctrl, job)
