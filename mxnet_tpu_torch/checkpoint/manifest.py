"""Checkpoint manifests: crash-safe file primitives and the integrity
index.

Counterpart of ``mxnet_tpu/checkpoint/manifest.py``, the same format.
Every checkpoint commit is a JSON manifest (``<prefix>-<tag>.ckpt.json``)
naming the data files it covers with file-level and per-tensor CRC32
checksums.  The write protocol is the atomic-publish sequence: data
files first (tmp + fsync + rename), the manifest's rename last, so a
crash at any byte leaves either the previous checkpoint intact or a
tmp file that validation never looks at.  ``latest(prefix)`` walks the
tags newest first, validates each candidate's checksums and falls back
to the newest intact one.
"""
from __future__ import annotations

import json
import os
import re
import threading
import zlib

__all__ = ["MANIFEST_FORMAT", "manifest_path", "tag_str", "atomic_write",
           "crc32_file", "write_manifest", "read_manifest", "validate",
           "list_tags", "latest", "delete_checkpoint"]

MANIFEST_FORMAT = 1
_CHUNK = 1 << 20


def tag_str(tag):
    """Zero-padded tag, the ``%04d`` of the legacy ``%s-%04d.params``
    contract (tags past 9999 simply widen)."""
    return "%04d" % int(tag)


def manifest_path(prefix, tag):
    return "%s-%s.ckpt.json" % (prefix, tag_str(tag))


def _fsync_dir(path):
    """Best-effort directory fsync so the rename itself is durable."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path, data=None, writer=None):
    """Write ``data`` bytes (or stream through ``writer(tmp_path)``) to
    ``path`` crash-safely: tmp file in the same directory, fsync, atomic
    rename, directory fsync. Returns (bytes_written, crc32). The tmp
    name carries pid AND thread id: the async writer and an emergency
    save may target the same prefix from different threads."""
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), threading.get_ident())
    try:
        if writer is not None:
            writer(tmp)
            with open(tmp, "rb") as f:
                os.fsync(f.fileno())
            nbytes, crc = crc32_file(tmp)
        else:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            nbytes, crc = len(data), zlib.crc32(data) & 0xFFFFFFFF
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(path)
    return nbytes, crc


def crc32_file(path):
    """(size, crc32) of a file, streamed."""
    crc, n = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            n += len(chunk)
    return n, crc & 0xFFFFFFFF


def write_manifest(prefix, tag, files, tensors, meta=None):
    """Commit point: publish the manifest naming ``files``
    ({role: {"file", "bytes", "crc32"}}) and ``tensors``
    ({key: {"crc32", "bytes", "shape", "dtype"}}). Everything it names
    must already be durably in place."""
    doc = {"format": MANIFEST_FORMAT, "tag": int(tag),
           "files": files, "tensors": tensors}
    if meta:
        doc.update(meta)
    path = manifest_path(prefix, tag)
    atomic_write(path, json.dumps(doc, sort_keys=True).encode())
    return doc


def read_manifest(prefix, tag):
    """Parse one manifest; None when missing/undecodable (a torn
    manifest is just 'not a checkpoint', never an error)."""
    try:
        with open(manifest_path(prefix, tag)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "files" not in doc:
        return None
    return doc


def validate(prefix, manifest):
    """File-level integrity: every file the manifest names exists with
    the recorded size and CRC32. (Per-tensor checksums are re-verified
    at load time by ``snapshot.load``.)

    The shared ``-symbol.json`` is exempt: it is overwritten by every
    save, so a run that resumes with a changed graph under the same
    prefix would otherwise invalidate EVERY older manifest at once and
    collapse the newest-intact fallback chain."""
    if manifest is None:
        return False
    base_dir = os.path.dirname(prefix)
    for role, rec in manifest.get("files", {}).items():
        if role == "symbol":
            continue
        path = os.path.join(base_dir, rec["file"])
        try:
            nbytes, crc = crc32_file(path)
        except OSError:
            return False
        if nbytes != rec["bytes"] or crc != rec["crc32"]:
            return False
    return True


def list_tags(prefix):
    """All manifest tags for ``prefix``, ascending (no validation)."""
    base_dir = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix)
    rx = re.compile(r"^%s-(\d{4,})\.ckpt\.json$" % re.escape(base))
    tags = []
    try:
        names = os.listdir(base_dir)
    except OSError:
        return []
    for name in names:
        m = rx.match(name)
        if m:
            tags.append(int(m.group(1)))
    return sorted(tags)


def latest(prefix, validate_files=True):
    """Newest INTACT manifest for ``prefix`` (checksum-validated), or
    None. Corrupt/truncated newer checkpoints are skipped with a
    warning — resume always falls back to the newest one that passes."""
    import logging
    for tag in reversed(list_tags(prefix)):
        man = read_manifest(prefix, tag)
        if man is None:
            logging.warning("checkpoint %s: unreadable manifest, skipping",
                            manifest_path(prefix, tag))
            continue
        if validate_files and not validate(prefix, man):
            logging.warning("checkpoint %s: checksum validation failed "
                            "(truncated or corrupt), falling back",
                            manifest_path(prefix, tag))
            continue
        return man
    return None


def delete_checkpoint(prefix, tag):
    """Remove one checkpoint: manifest first (so it stops being a
    candidate), then its data files. Shared files (``-symbol.json``)
    are never named in ``files`` with role ``symbol`` removed here."""
    man = read_manifest(prefix, tag)
    try:
        os.unlink(manifest_path(prefix, tag))
    except OSError:
        pass
    if man is None:
        return
    base_dir = os.path.dirname(prefix)
    for role, rec in man.get("files", {}).items():
        if role == "symbol":
            continue        # shared across tags
        try:
            os.unlink(os.path.join(base_dir, rec["file"]))
        except OSError:
            pass
