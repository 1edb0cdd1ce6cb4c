"""Commit manifests: content-addressed integrity for a checkpoint step dir
(the port's copy of picotron_tpu/ckpt_integrity/manifest.py).

A manifest is a JSON sidecar (`manifest.json`, written tmp+rename as the
last act of a save) recording, for every file under `step_<n>/` at commit
time, its byte size and a content digest. The payload's atomic rename
proves the *write protocol* completed; the manifest proves the *bytes*
that landed are the bytes that were staged: a later bit flip, truncation
or torn metadata file fails verification instead of poisoning restore.

Digest: xxh64 when the `xxhash` package is importable, else the standard
library's `zlib.crc32` (what runs on a machine without `xxhash`). The algo
is recorded in the manifest, so a store written under one and read under
the other still verifies sizes and fails loudly on the digest rather than
silently passing. Paths are local (plain `os`): the port reads and writes
no URL stores.
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field
from typing import Optional

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = "picotron-ckpt-manifest"
MANIFEST_VERSION = 1

_CHUNK = 1 << 24  # 16 MiB read chunks: streaming, never whole-file in RAM


def digest_algo() -> str:
    try:
        import xxhash  # noqa: F401

        return "xxh64"
    except ImportError:
        return "crc32"


def file_digest(path: str, algo: Optional[str] = None) -> tuple[str, int]:
    """(hexdigest, byte_size) of one file, streaming."""
    algo = algo or digest_algo()
    size = 0
    if algo == "xxh64":
        import xxhash

        h = xxhash.xxh64()
        with open(path, "rb") as f:
            while chunk := f.read(_CHUNK):
                size += len(chunk)
                h.update(chunk)
        return h.hexdigest(), size
    if algo == "crc32":
        crc = 0
        with open(path, "rb") as f:
            while chunk := f.read(_CHUNK):
                size += len(chunk)
                crc = zlib.crc32(chunk, crc)
        return f"{crc & 0xFFFFFFFF:08x}", size
    raise ValueError(f"unknown digest algo {algo!r} (xxh64/crc32)")


def _walk_files(root: str) -> list[str]:
    """Relative (posix-style) paths of every regular file under `root`,
    sorted for a deterministic manifest. Skips the manifest itself and
    in-flight `*.tmp*` names (our own atomic-write staging)."""
    rels = []
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            rels.append(os.path.relpath(os.path.join(dirpath, f), root)
                        .replace(os.sep, "/"))
    return sorted(r for r in rels if r != MANIFEST_NAME
                  and ".tmp" not in r)


def build_manifest(step_dir: str, *, step: int,
                   topology: Optional[dict] = None) -> dict:
    """Hash every committed file under `step_dir` into a manifest dict.
    Runs AFTER the payload is durable (checkpoint._commit) and off the
    step path."""
    algo = digest_algo()
    files: dict[str, dict] = {}
    total = 0
    for rel in _walk_files(step_dir):
        digest, size = file_digest(os.path.join(step_dir, rel), algo)
        files[rel] = {"bytes": size, "digest": digest}
        total += size
    return {
        "format": MANIFEST_FORMAT,
        "version": MANIFEST_VERSION,
        "step": int(step),
        "algo": algo,
        "file_count": len(files),
        "total_bytes": total,
        "topology": dict(topology or {}),
        "files": files,
    }


def fsync_dir(path: str) -> None:
    """Make a rename inside `path` durable (a no-op where directories
    cannot be opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str) -> None:
    """Write `text` to `path` via tmp-file + rename, so a crash mid-write
    leaves either the old content or nothing under the final name, never
    a torn file (the meta.json / manifest commit primitive)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


def write_manifest(step_dir: str, manifest: dict) -> str:
    path = os.path.join(step_dir, MANIFEST_NAME)
    atomic_write_text(path, json.dumps(manifest, indent=1, sort_keys=True))
    return path


@dataclass
class VerifyResult:
    """Per-step verification verdict.

    status: "verified" (manifest present, every entry matches), "legacy"
    (no manifest, e.g. the commit thread died before writing it; meta.json
    parsed, so it stays restorable), or "corrupt" (manifest/meta torn, a
    listed file missing, or bytes/digest mismatch; `failures` names each
    culprit).
    """

    status: str
    failures: list = field(default_factory=list)
    manifest: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return self.status in ("verified", "legacy")


def _check_meta(step_dir: str, failures: list) -> None:
    """meta.json must parse: the restore path reads it before the payload,
    so a torn JSON there poisons resume even when the tensors are fine."""
    try:
        with open(os.path.join(step_dir, "meta.json"), "rb") as f:
            json.loads(f.read().decode("utf-8"))
    except FileNotFoundError:
        failures.append("meta.json: missing")
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        failures.append(f"meta.json: torn/invalid JSON ({e})")


def verify_step_dir(step_dir: str, deep: bool = True) -> VerifyResult:
    """Verify one committed step dir against its manifest.

    `deep=False` checks existence + byte sizes only (catches truncation
    and deletion for the cost of a stat walk); `deep=True` additionally
    re-digests every file (catches bit flips). Durability (the payload's
    rename) is the caller's concern: this judges bytes, not the commit
    protocol.
    """
    failures: list[str] = []
    try:
        with open(os.path.join(step_dir, MANIFEST_NAME), "rb") as f:
            manifest = json.loads(f.read().decode("utf-8"))
    except FileNotFoundError:
        _check_meta(step_dir, failures)
        return VerifyResult("corrupt" if failures else "legacy", failures)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        return VerifyResult(
            "corrupt", [f"{MANIFEST_NAME}: torn/invalid JSON ({e})"])
    if not isinstance(manifest.get("files"), dict):
        return VerifyResult(
            "corrupt", [f"{MANIFEST_NAME}: malformed (no files map)"],
            manifest)

    algo = manifest.get("algo", "crc32")
    for rel, want in sorted(manifest["files"].items()):
        path = os.path.join(step_dir, rel)
        try:
            if deep:
                digest, size = file_digest(path, algo)
            else:
                size, digest = os.path.getsize(path), None
        except FileNotFoundError:
            failures.append(f"{rel}: missing")
            continue
        except OSError as e:
            failures.append(f"{rel}: unreadable ({e})")
            continue
        if size != want.get("bytes"):
            failures.append(
                f"{rel}: size {size} != manifest {want.get('bytes')}")
        elif digest is not None and digest != want.get("digest"):
            failures.append(
                f"{rel}: {algo} digest {digest} != manifest "
                f"{want.get('digest')}")
    _check_meta(step_dir, failures)
    return VerifyResult("corrupt" if failures else "verified", failures,
                        manifest)
