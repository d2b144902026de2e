"""Filesystem durability helper shared by the WAL and the checkpoints."""

from __future__ import annotations

import os


def fsync_dir(path: str) -> None:
    """Make a directory-entry change (create/rename/unlink) durable.
    Best-effort: some filesystems refuse directory fsync; the data-file
    fsyncs still hold."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
