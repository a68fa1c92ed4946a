"""One builder at a time: an exclusive ``flock`` on a file beside a build.

The processes of a data-parallel world each build the kernels' library
(``_build.py``) and the batch assembler (``data/native.py``) at their first
use.  On a fresh checkout they would all run every compiler at once; under
this lock one builds, and the others wait, find the finished file and load
it.  The lock is the operating system's, so a builder that dies releases it.
"""
from __future__ import annotations

import contextlib
import fcntl
import os
from pathlib import Path


@contextlib.contextmanager
def build_lock(target: Path):
    """Hold an exclusive lock on ``<target>.lock`` for the block."""
    target.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(f"{target}.lock", os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
