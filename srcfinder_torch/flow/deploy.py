"""Pipeline-stage orchestration: the local job queue.

The reference wires pipeline stages together with AWS S3 events, Lambda
fan-out and Batch submit_job calls (msf_flow/deployment/README.md:1-27).
The equivalent here is a small event-driven work queue:

- ``JobQueue`` registers handlers per job type and executes submitted
  jobs — the Lambda/Batch analog;
- ``watch_and_trigger`` turns new files in a directory into jobs — the
  S3-event analog (DirWatcher supplies the "event stream").

The port's copy of ``Job``, ``JobQueue`` and ``watch_and_trigger`` from
the JAX package's ``flow/deploy.py``, which the pipeline's ``--watch``
runs; its queue runs each job as it is submitted (the JAX package's
worker threads serve only its job-spec runner, not ported).
"""

from __future__ import annotations

import traceback
from dataclasses import dataclass, field
from typing import Callable

from .utils import DirWatcher

__all__ = ["Job", "JobQueue", "watch_and_trigger"]


@dataclass
class Job:
    job_type: str
    params: dict = field(default_factory=dict)


class JobQueue:
    """Register handlers per job type and run each submitted job at once.
    Results and failures are retained for inspection (the reference's
    only failure handling is keep-going + logs)."""

    def __init__(self):
        self._handlers: dict[str, Callable[[dict], object]] = {}
        self._results: list = []
        self._failures: list = []

    def register(self, job_type: str, handler: Callable[[dict], object]):
        self._handlers[job_type] = handler

    def submit(self, job: Job):
        if job.job_type not in self._handlers:
            raise KeyError(f"no handler for job type {job.job_type!r}")
        try:
            self._results.append((job, self._handlers[job.job_type](job.params)))
        except Exception as e:  # keep-going semantics
            traceback.print_exc()
            self._failures.append((job, e))

    @property
    def results(self):
        return list(self._results)

    @property
    def failures(self):
        return list(self._failures)


def watch_and_trigger(watch_dir: str, job_type: str, jobq: JobQueue,
                      regex: str = ".*", force: bool = False,
                      param_key: str = "path"):
    """One watch cycle: new files matching ``regex`` become jobs — the
    S3-event -> Lambda trigger analog. Returns the submitted jobs."""
    watcher = DirWatcher(watch_dir, force=force, regex=regex)
    jobs = []
    for path in watcher.whats_new_local():
        job = Job(job_type, {param_key: path})
        jobq.submit(job)
        jobs.append(job)
    return jobs
