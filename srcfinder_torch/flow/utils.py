"""Flow utilities: the directory watcher and the logger
(reference: msf_flow/utils/{dir_watcher.py, logger.py}).

The port's copy of ``DirWatcher`` and ``init_logger`` from the JAX
package's ``flow/utils.py``.
"""

from __future__ import annotations

import logging
import os
import re
import sys
from datetime import datetime, timezone

__all__ = ["DirWatcher", "init_logger"]


class DirWatcher:
    """mtime-based new-file detection with a persisted ``.last_run_time``
    cursor and a regex filter (reference: msf_flow/utils/dir_watcher.py).
    """

    def __init__(self, local_dir: str, force: bool = False,
                 regex: str = ".*"):
        if not os.path.isdir(local_dir):
            raise ValueError(f"Directory {local_dir} does not exist.")
        self._local_dir = local_dir
        self._datetime_fmt = "%Y-%m-%dT%H:%M:%S%z"
        self._lrt_fname = os.path.join(local_dir, ".last_run_time")
        if force:
            self._last_run_time = datetime(1, 1, 1, tzinfo=timezone.utc)
        else:
            self._last_run_time = self.get_last_run_time()
        self.update_last_run_time()
        self._matcher = re.compile(regex)

    def get_last_run_time(self) -> datetime:
        if os.path.isfile(self._lrt_fname):
            with open(self._lrt_fname) as f:
                return datetime.strptime(f.readline().strip(),
                                         self._datetime_fmt)
        return datetime.now(timezone.utc)

    def update_last_run_time(self) -> None:
        with open(self._lrt_fname, "w") as f:
            f.write(datetime.strftime(datetime.now(timezone.utc),
                                      self._datetime_fmt))

    def whats_new_local(self):
        new_files = []
        for root, dirs, files in os.walk(self._local_dir, followlinks=True):
            dirs[:] = [d for d in dirs if not d.startswith(".")]
            paths = [os.path.join(root, f) for f in files
                     if not f.startswith(".")]
            new_files += [
                f for f in paths
                if (self._matcher.search(f)
                    and datetime.fromtimestamp(
                        os.stat(f).st_mtime).astimezone()
                    > self._last_run_time)]
        return new_files


def init_logger(name="msf_flow", level=logging.INFO, stream=sys.stdout):
    """(reference: msf_flow/utils/logger.py:1-20)"""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(stream)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(handler)
    return logger
