"""Crash-safe file writes: fsync + rename + content digests.

Shared by the checkpoint writer (persist/checkpoint.py) and the eventlog
segment sealer (persist/eventlog.py). Counterpart of
`sitewhere_tpu/persist/atomic.py`, the same bytes on disk. The contract:

  write tmp -> fsync(tmp) -> rename -> fsync(parent dir)

so a crash at any instant leaves either the old state or the complete
new state — never a torn file that the next boot trusts. Checkpoint
directories additionally carry a ``digest.json`` (sha256 per payload
file) so a restore can *verify* completeness instead of assuming it, and
quarantine what fails.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

DIGEST_NAME = "digest.json"


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Durably record a rename/create in its parent directory. Some
    platforms refuse O_RDONLY on directories — best-effort there."""
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


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_digest_manifest(directory: str) -> None:
    """Write `digest.json` covering every regular file in `directory`
    (itself excluded), fsyncing payloads first so the digest never
    describes bytes that did not reach the platter."""
    digests: Dict[str, str] = {}
    for name in sorted(os.listdir(directory)):
        if name == DIGEST_NAME:
            continue
        path = os.path.join(directory, name)
        if not os.path.isfile(path):
            continue
        fsync_file(path)
        digests[name] = file_digest(path)
    digest_path = os.path.join(directory, DIGEST_NAME)
    with open(digest_path, "w", encoding="utf-8") as fh:
        json.dump(digests, fh)
        fh.flush()
        os.fsync(fh.fileno())


def verify_digest_manifest(directory: str) -> Optional[bool]:
    """True = every digest matches; False = torn/corrupt; None = no
    digest.json (a pre-digest legacy write — caller decides trust)."""
    digest_path = os.path.join(directory, DIGEST_NAME)
    if not os.path.exists(digest_path):
        return None
    try:
        with open(digest_path, encoding="utf-8") as fh:
            digests = json.load(fh)
        for name, expect in digests.items():
            path = os.path.join(directory, name)
            if not os.path.isfile(path) or file_digest(path) != expect:
                return False
    except (OSError, ValueError):
        return False
    return True
