"""Pipeline-stage orchestration: the local job queue and job-spec runner.

The reference wires pipeline stages together with AWS S3 events, Lambda
fan-out and Batch submit_job calls (msf_flow/deployment/README.md:1-27;
trigger scripts compute-ime/invoke-ime, workflow/trigger-msf-flow.py,
spectrometer-masks/trigger-spectroscopy-masks.py). The equivalent here is
a small event-driven work queue:

- ``JobQueue`` registers handlers per job type and executes submitted
  jobs (synchronously or on a thread pool) — the Lambda/Batch analog;
- ``watch_and_trigger`` turns new files in a directory into jobs — the
  S3-event analog (DirWatcher supplies the "event stream");
- ``load_job_specs``/``register_job_specs`` wire a declarative job map
  (``deployment/jobs.json`` — the Batch job definitions + invoke-script
  parameter dicts) onto the queue as CLI handlers.

The port's copy of the JAX package's ``flow/deploy.py``. The job map names
the JAX package's console scripts (``srcfinder-<name>``); the port's
default runner, :func:`run_port_command`, runs each as ``python -m
srcfinder_torch <name>`` and fails a job whose script the port lacks.

Job parameter conventions follow the reference's Batch parameters
(deployment/compute-ime/invoke-ime:21-33: CMF_DIR, PPMMTHR=1500,
FETCHMAX=150, MERGEDISTS="10 20 50", MINAREA=9).
"""

from __future__ import annotations

import json
import os
import queue
import string
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable

from .utils import DirWatcher

__all__ = ["Job", "JobQueue", "watch_and_trigger", "IME_JOB_DEFAULTS",
           "load_job_specs", "render_command", "make_cli_handler",
           "register_job_specs", "run_jobs", "command_placeholders",
           "port_argv", "run_port_command"]

#: reference Batch parameters for the compute-ime job
#: (deployment/compute-ime/invoke-ime:21-33)
IME_JOB_DEFAULTS = {
    "PPMMTHR": 1500,
    "FETCHMAX": 150,
    "MERGEDISTS": "10 20 50",
    "MINAREA": 9,
}

#: the prefix of the console scripts the job map names
SCRIPT_PREFIX = "srcfinder-"


@dataclass
class Job:
    job_type: str
    params: dict = field(default_factory=dict)


class JobQueue:
    """Register handlers per job type; submit jobs; run them inline
    (``workers=0``) or on worker threads. Results and failures are
    retained for inspection (the reference's only failure handling is
    keep-going + logs)."""

    def __init__(self, workers: int = 0):
        self._handlers: dict[str, Callable[[dict], object]] = {}
        self._results: list = []
        self._failures: list = []
        self._q: "queue.Queue[Job]" = queue.Queue()
        self._workers = workers
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        for _ in range(workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def register(self, job_type: str, handler: Callable[[dict], object]):
        self._handlers[job_type] = handler

    def submit(self, job: Job):
        if job.job_type not in self._handlers:
            raise KeyError(f"no handler for job type {job.job_type!r}")
        if self._workers > 0:
            self._q.put(job)
        else:
            self._run(job)

    def _run(self, job: Job):
        try:
            self._results.append((job, self._handlers[job.job_type](job.params)))
        except Exception as e:  # keep-going semantics
            traceback.print_exc()
            self._failures.append((job, e))

    def _worker(self):
        while not self._stop.is_set():
            try:
                job = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            self._run(job)
            self._q.task_done()

    def join(self):
        if self._workers > 0:
            self._q.join()

    def shutdown(self):
        self._stop.set()

    @property
    def results(self):
        return list(self._results)

    @property
    def failures(self):
        return list(self._failures)


def load_job_specs(path: str) -> dict:
    """Load a job-definition map (``deployment/jobs.json``): job name ->
    {command: [argv template], defaults: {PARAM: value}, trigger:
    {regex, param}}. This is the declarative equivalent of the
    reference's Batch job definitions + invoke scripts (the parameter
    dicts in deployment/compute-ime/invoke-ime:21-33 and
    workflow/trigger-msf-flow.py:1-30)."""
    with open(path) as f:
        specs = json.load(f)
    for name, spec in specs.items():
        if "command" not in spec:
            raise ValueError(f"job {name!r} has no command template")
    return specs


def render_command(spec: dict, params: dict) -> list[str]:
    """Render a job's argv from its template: ``{PARAM}`` placeholders are
    substituted from ``params`` merged over the spec's defaults (Batch
    `parameters` semantics — submit-time values override the job
    definition's defaults)."""
    merged = {**spec.get("defaults", {}), **params}
    return [str(a).format(**merged) for a in spec["command"]]


def command_placeholders(spec: dict) -> set:
    """The ``{PARAM}`` field names a job's argv template consumes —
    derived from the template itself so validation can never drift from
    the command (the json's ``required_sets`` is documentation only)."""
    fields = set()
    for arg in spec["command"]:
        for _, name, _, _ in string.Formatter().parse(str(arg)):
            if name:
                fields.add(name)
    return fields


def port_argv(argv) -> list[str]:
    """The port's argv for a rendered job command: a console script
    ``srcfinder-<name>`` becomes ``[python, -m, srcfinder_torch, <name>,
    ...]``; any other command is kept as it is. Raises ValueError for a
    ``srcfinder-`` name the port's dispatcher does not run, so the job
    fails rather than reach the JAX package's script."""
    from ..__main__ import COMMANDS, NOT_PORTED

    argv = [str(a) for a in argv]
    if not argv[0].startswith(SCRIPT_PREFIX):
        return argv
    name = argv[0][len(SCRIPT_PREFIX):]
    if name in NOT_PORTED:
        raise ValueError(f"{argv[0]} is not yet ported to srcfinder_torch")
    if name not in COMMANDS:
        raise ValueError(f"{argv[0]} is not a console script srcfinder_torch "
                         f"knows (python -m srcfinder_torch lists them)")
    return [sys.executable, "-m", "srcfinder_torch", name, *argv[1:]]


def run_port_command(argv):
    """The default runner: run :func:`port_argv`'s command to its end
    (``check=True``), with this package's parent directory on the child's
    ``PYTHONPATH`` so ``-m srcfinder_torch`` resolves from any directory."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=root + (os.pathsep + path if path else ""))
    return subprocess.run(port_argv(argv), check=True, env=env)


def make_cli_handler(spec: dict, runner: Callable | None = None):
    """Handler that executes a job spec's CLI command — the Batch
    container-run analog. ``runner`` (default :func:`run_port_command`)
    is injectable for schedulers and tests."""
    runner = runner or run_port_command

    def handler(params: dict):
        return runner(render_command(spec, params))

    return handler


def register_job_specs(jobq: JobQueue, specs: dict,
                       runner: Callable | None = None):
    """Register every job in a spec map on a queue (the deployment's
    job<->source wiring, reference deployment/README.md:3-27)."""
    for name, spec in specs.items():
        jobq.register(name, make_cli_handler(spec, runner))


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


def run_jobs(specs: dict, watch_dir: str, extra_params: dict | None = None,
             once: bool = True, workers: int = 0, runner=None,
             force: bool = False, interval: float = 5.0,
             max_cycles: int | None = None, explicit_jobs=None):
    """The local job scheduler: one event stream over ``watch_dir``,
    fanned out to every job whose trigger regex matches each new file
    (the S3-event -> per-Lambda-filter model of the reference's
    deployment; deployment/README.md:3-27). ``extra_params`` supplies
    the non-trigger placeholders (e.g. LIBRARY, WEIGHTS, OUTDIR) shared
    by all jobs. ``once`` processes the current backlog and returns;
    otherwise polls every ``interval`` seconds (``max_cycles`` bounds
    the loop for tests). Returns (queue, submitted jobs).

    A trigger with ``"opt_in": true`` only fires when its job name is in
    ``explicit_jobs`` (the CLI's --jobs list) — used for per-stage jobs
    whose work a broader triggered job already covers (fcn-pred and
    compute-ime duplicate flightline-pipeline stages when pipeline
    outputs land in the watched directory)."""
    import re as _re

    jobq = JobQueue(workers=workers)
    register_job_specs(jobq, specs, runner)
    extra = dict(extra_params or {})
    explicit = set(explicit_jobs or ())
    triggers = []
    for name, spec in specs.items():
        trig = spec.get("trigger")
        if not trig:
            continue
        if trig.get("opt_in") and name not in explicit:
            continue
        param = trig.get("param", "path")
        # fail fast: a triggered job must be fully renderable from the
        # event path + defaults + the shared extra params; the needed
        # placeholders come from the command template itself
        supplied = set(spec.get("defaults", {})) | set(extra) | {param}
        missing = sorted(command_placeholders(spec) - supplied)
        if missing:
            raise ValueError(
                f"job {name!r} is event-triggered but lacks required "
                f"params {missing}; pass them via extra_params / --set, "
                f"or disable the job (--jobs)")
        triggers.append((name, _re.compile(trig["regex"]), param))

    submitted = []
    cycles = 0
    # In a fresh watch directory (no .last_run_time cursor yet) DirWatcher
    # initializes its cursor to *now* (reference dir_watcher.py:38-52), so
    # the pre-existing backlog would never be seen — contradicting the
    # "--once: process the current backlog" contract. Treat the first
    # cycle over a fresh directory as forced.
    fresh = not os.path.isfile(os.path.join(watch_dir, ".last_run_time"))
    while True:
        watcher = DirWatcher(watch_dir,
                             force=(force or fresh) and cycles == 0)
        for path in watcher.whats_new_local():
            for name, rx, param in triggers:
                if rx.search(path):
                    job = Job(name, {param: path, **extra})
                    jobq.submit(job)
                    submitted.append(job)
        cycles += 1
        if once or (max_cycles is not None and cycles >= max_cycles):
            break
        time.sleep(interval)
    jobq.join()
    return jobq, submitted


def _timed_port_command(argv):
    t0 = time.perf_counter()
    try:
        return run_port_command(argv)
    finally:
        print(f"[TIME] {argv[0]}: {time.perf_counter() - t0:.3f} s", flush=True)


def main(argv=None):
    """``srcfinder-jobs`` — run the declarative job map over a watched
    directory (the local stand-in for the reference's S3-event ->
    Lambda/Batch wiring). Each job's seconds, its process start-up
    included, print as ``[TIME] <script>: <s> s``."""
    import argparse

    p = argparse.ArgumentParser(
        description="Event-driven job runner over deployment/jobs.json")
    p.add_argument("specs", help="job-definition JSON (deployment/jobs.json)")
    p.add_argument("--watch", required=True, help="directory to watch")
    p.add_argument("--once", action="store_true",
                   help="process the current backlog and exit")
    p.add_argument("--force", action="store_true",
                   help="treat all existing files as new")
    p.add_argument("--workers", type=int, default=0)
    p.add_argument("--interval", type=float, default=5.0)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="extra command parameters (repeatable)")
    p.add_argument("--jobs", default=None,
                   help="comma-separated subset of job names to enable")
    args = p.parse_args(argv)

    specs = load_job_specs(args.specs)
    explicit = set(args.jobs.split(",")) if args.jobs else set()
    if explicit:
        unknown = explicit - set(specs)
        if unknown:
            p.error(f"unknown jobs: {sorted(unknown)}")
        specs = {k: v for k, v in specs.items() if k in explicit}
    extra = dict(kv.split("=", 1) for kv in args.set)
    try:
        jobq, jobs = run_jobs(specs, args.watch, extra_params=extra,
                              once=args.once, workers=args.workers,
                              runner=_timed_port_command,
                              force=args.force, interval=args.interval,
                              explicit_jobs=explicit)
    except ValueError as e:
        print(f"[ERROR] {e}")
        return 2
    print(f"[INFO] submitted {len(jobs)} job(s); "
          f"{len(jobq.results)} ok, {len(jobq.failures)} failed")
    for job, err in jobq.failures:
        print(f"[FAIL] {job.job_type}: {err}")
    return 1 if jobq.failures else 0


if __name__ == "__main__":
    sys.exit(main())
