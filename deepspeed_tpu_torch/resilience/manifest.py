"""Checksummed checkpoint manifests + the atomic commit/publish protocol
(counterpart of ``deepspeed_tpu/resilience/manifest.py``; the same files,
so either package verifies the other's checkpoints).

Every checkpoint tag carries a ``manifest.json`` recording, per file:
byte size and CRC32 — plus the writing topology and framework version.
The save path stages everything in ``<tag>.tmp/`` and only renames it to
``<tag>/`` after all shards are durable and checksummed; the ``latest``
pointer is then republished via write-temp + ``os.replace`` + fsync.  A
crash at ANY instant therefore leaves ``latest`` pointing at a fully
verified tag (the previous one, or the new one once published) — never at
a torn directory.

Protocol: each process checksums only the files it wrote (sidecar
``<file>.crc.json``); after the commit, process 0 merges the sidecars into
``manifest.json`` and performs the rename + publish.  The port saves from
one process (its ``topology`` says so) through the same steps, so its
directories are the JAX package's.  Verification (:func:`verify_tag`) is
manifest-driven: missing files, size mismatches, and — in ``full`` mode —
checksum mismatches are each reported precisely.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.resilience import chaos, heartbeat
from deepspeed_tpu_torch.utils.logging import logger

MANIFEST = "manifest.json"
SIDECAR_SUFFIX = ".crc.json"
TMP_SUFFIX = ".tmp"
_CHUNK = 1 << 20


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename/create inside it is durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    heartbeat.tick_active()


def file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            # every checksummed chunk is progress — a multi-GB shard's
            # CRC must not read as a hang to the supervisor, while a
            # single wedged read() still goes stale (the tick is
            # throttled, so this costs nothing on small files)
            heartbeat.tick_active()
    return crc & 0xFFFFFFFF


# --------------------------------------------------------------------- #
# Save side
# --------------------------------------------------------------------- #
def write_sidecars(dirpath: str, files: List[str]) -> None:
    """Record size + CRC32 for the files THIS process wrote.

    The ``corrupt_shard_bytes`` fault point fires after each checksum is
    taken — an injected flip there models post-write bit-rot, which the
    loader must catch via the manifest.
    """
    for path in files:
        entry = {"bytes": os.path.getsize(path), "crc32": file_crc32(path)}
        chaos.fire("corrupt_shard_bytes", path=path)
        side = path + SIDECAR_SUFFIX
        with open(side, "w") as f:
            json.dump(entry, f)
            f.flush()
            os.fsync(f.fileno())


def build_manifest(dirpath: str, tag: str,
                   step: Optional[int] = None) -> Dict[str, Any]:
    """Merge every process's sidecars into ``manifest.json`` (removing the
    sidecars), fsync, and return the manifest dict."""
    import torch

    from deepspeed_tpu_torch import __version__

    shards: Dict[str, Dict[str, Any]] = {}
    for fname in sorted(os.listdir(dirpath)):
        if not fname.endswith(SIDECAR_SUFFIX):
            continue
        with open(os.path.join(dirpath, fname)) as f:
            shards[fname[:-len(SIDECAR_SUFFIX)]] = json.load(f)
        os.remove(os.path.join(dirpath, fname))
    manifest = {
        "format": 1,
        "tag": str(tag),
        "step": int(step) if step is not None else None,
        "framework_version": __version__,
        "torch_version": torch.__version__,
        "topology": {"process_count": 1},
        "shards": shards,
    }
    tmp = os.path.join(dirpath, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dirpath, MANIFEST))
    fsync_dir(dirpath)
    return manifest


def finalize_tag(tmp_path: str, final_path: str, tag: str,
                 step: Optional[int] = None) -> Dict[str, Any]:
    """Manifest the staged ``<tag>.tmp/`` dir and rename it into place.

    The rename is the commit point: before it the tag does not exist,
    after it the tag is complete AND checksummed.
    """
    manifest = build_manifest(tmp_path, tag, step=step)
    aside = final_path + ".old"
    if os.path.isdir(final_path):
        # re-saving an existing tag: move the old copy ASIDE rather than
        # deleting it, so no instant exists where both copies are gone —
        # a crash here leaves the aside dir as a loadable candidate
        if os.path.isdir(aside):
            shutil.rmtree(aside)  # stale aside; final exists, so redundant
        os.rename(final_path, aside)
    os.rename(tmp_path, final_path)
    fsync_dir(os.path.dirname(final_path) or ".")
    if os.path.isdir(aside):
        shutil.rmtree(aside)  # new copy committed; old one can go
    return manifest


def publish_latest(save_dir: str, tag: str) -> None:
    """Atomically repoint ``latest`` (write-temp + ``os.replace`` + fsync)."""
    chaos.fire("fail_latest_publish", path=os.path.join(save_dir, "latest"))
    tmp = os.path.join(save_dir, "latest.tmp")
    with open(tmp, "w") as f:
        f.write(str(tag))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(save_dir, "latest"))
    fsync_dir(save_dir)


def read_latest(save_dir: str) -> Optional[str]:
    path = os.path.join(save_dir, "latest")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().strip() or None


# --------------------------------------------------------------------- #
# Load side
# --------------------------------------------------------------------- #
def load_manifest(tag_path: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(tag_path, MANIFEST)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        logger.warning(f"unreadable {path}: {e}")
        return None


def verify_tag(tag_path: str,
               mode: str = "full") -> Tuple[bool, List[str]]:
    """Validate a tag directory against its manifest.

    ``mode``: ``"full"`` (size + CRC32) or ``"size"`` (size only — cheap,
    catches truncation but not bit flips).  Returns ``(ok, problems)``
    where each problem names exactly what is wrong; a missing manifest is
    itself a problem (the caller decides the legacy-checkpoint policy).
    """
    if mode not in ("full", "size"):
        raise ValueError(f"verify mode must be 'full' or 'size', got {mode!r}")
    manifest = load_manifest(tag_path)
    if manifest is None:
        return False, [f"{MANIFEST} missing or unreadable"]
    problems: List[str] = []
    for fname, entry in manifest.get("shards", {}).items():
        path = os.path.join(tag_path, fname)
        if not os.path.exists(path):
            problems.append(f"{fname}: file missing")
            continue
        size = os.path.getsize(path)
        if size != entry["bytes"]:
            problems.append(f"{fname}: size {size} != manifest "
                            f"{entry['bytes']} (truncated?)")
            continue
        if mode == "full":
            crc = file_crc32(path)
            if crc != entry["crc32"]:
                problems.append(f"{fname}: crc32 {crc:#010x} != manifest "
                                f"{entry['crc32']:#010x} (corrupt bytes)")
    return not problems, problems


@dataclasses.dataclass
class TagInfo:
    tag: str
    path: str
    step: Optional[int]     # from the manifest, when present
    mtime: float
    has_manifest: bool


def candidate_tags(save_dir: str) -> List[TagInfo]:
    """Every loadable-looking tag directory under ``save_dir``, newest
    first (manifest step, then directory mtime).  ``<tag>.tmp`` staging
    dirs are never candidates."""
    out: List[TagInfo] = []
    if not os.path.isdir(save_dir):
        return out
    for name in os.listdir(save_dir):
        path = os.path.join(save_dir, name)
        if not os.path.isdir(path) or name.endswith(TMP_SUFFIX):
            continue
        manifest = load_manifest(path)
        has_files = manifest is not None or any(
            f.endswith(".npz") for f in os.listdir(path))
        if not has_files:
            continue
        step = manifest.get("step") if manifest else None
        out.append(TagInfo(tag=name, path=path, step=step,
                           mtime=os.path.getmtime(path),
                           has_manifest=manifest is not None))
    out.sort(key=lambda t: (t.step if t.step is not None else -1, t.mtime),
             reverse=True)
    return out
