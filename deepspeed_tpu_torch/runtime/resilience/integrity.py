"""Checkpoint integrity (counterpart of
``deepspeed_tpu/runtime/resilience/integrity.py``): checksum manifests,
verified-good registry, retry-with-backoff, retention — the storage half
of the resilience layer. The manifest format, the registry and the error
texts are the JAX package's, so a tag either package committed verifies
in the other.

Config-gated (``resilience.checkpoint``):

- **manifest commit** — :class:`ResilientCheckpointEngine` wraps any
  inner engine (Array or Tiered); its ``commit`` first drains
  the inner commit (which publishes/barriers), then rank 0 walks the tag
  directory, sha256s every payload file, and atomically writes
  ``.integrity.json``. A checkpoint without a matching manifest is never
  treated as verified-good.
- **verify-on-load** — before any bytes deserialize, the manifest is
  re-checked against the files; a mismatch raises
  :class:`CheckpointCorruptionError` naming the offending file, and the
  engine's load path falls back down the verified-good chain.
- **verified-good registry** — ``<save_dir>/.resilience/verified.json``
  records tags in commit order; it is the fallback chain for resume and
  the ordering for retention.
- **retry with exponential backoff** — every save/load IO call retries
  transient ``OSError``s (never ``FileNotFoundError`` — a missing tag is
  an answer, not a flake).
- **keep-last-N retention** — prunes old *verified* tags only, and never
  the newest verified-good tag nor the elastic agent's ``preempt`` tag.

Chaos seams (:mod:`deepspeed_tpu_torch.runtime.resilience.chaos`) are threaded
through every IO call so the test suite can prove each path end-to-end.
"""

import hashlib
import json
import os
import time
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    CheckpointEngine,
    atomic_write_text,  # noqa: F401 — re-exported: the resilience
    # layer's pointer/manifest/registry writes share the engine's
    # durable-text primitive
    barrier,
)
from deepspeed_tpu_torch.runtime.resilience import chaos
from deepspeed_tpu_torch.utils.logging import log_dist, logger

MANIFEST_NAME = ".integrity.json"
REGISTRY_DIR = ".resilience"
REGISTRY_NAME = "verified.json"
# tags retention must never touch regardless of age (the elastic agent's
# preemption checkpoint is consumed on restore, not superseded by count)
PROTECTED_TAGS = ("preempt",)


class CheckpointCorruptionError(RuntimeError):
    """Integrity verification failed: on-disk bytes do not match the
    manifest written at commit time."""


# ----------------------------------------------------------------------
# crash-safe small-file writes (the `latest` pointer / preempt marker fix)
def available_tags(load_dir: str) -> List[str]:
    """Checkpoint tag directories actually present in ``load_dir``
    (engine-internal dirs — staging, the resilience registry, stranded
    ``.replaced`` versions — are not user-loadable tags)."""
    try:
        entries = sorted(os.listdir(load_dir))
    except OSError:
        return []
    return [e for e in entries
            if os.path.isdir(os.path.join(load_dir, e))
            and not e.startswith(".") and not e.endswith(".replaced")]


def missing_tag_error(load_dir: str, tag, via: str) -> FileNotFoundError:
    """A clear missing-tag error naming the tags actually present —
    never a cryptic npz exception (shared by the training engines)."""
    present = available_tags(load_dir)
    listing = ", ".join(repr(t) for t in present) if present else "(none)"
    return FileNotFoundError(
        f"checkpoint {via} but {os.path.join(load_dir, str(tag))!r} "
        f"does not exist; tags present in {load_dir!r}: {listing}")


# ----------------------------------------------------------------------
# retry with exponential backoff
def retry_io(fn: Callable, *, retries: int, backoff_secs: float, what: str,
             on_retry: Optional[Callable] = None):
    """Run ``fn`` retrying transient ``OSError``s up to ``retries`` times
    with exponential backoff. ``FileNotFoundError``/``IsADirectoryError``
    are answers (wrong path), not flakes — they propagate immediately."""
    attempt = 0
    while True:
        try:
            return fn()
        except (FileNotFoundError, IsADirectoryError, NotADirectoryError):
            raise
        except OSError as e:
            attempt += 1
            if attempt > max(0, int(retries)):
                raise
            delay = float(backoff_secs) * (2 ** (attempt - 1))
            logger.warning(f"[resilience] {what}: transient IO error "
                           f"({e}); retry {attempt}/{retries} in "
                           f"{delay:.2f}s")
            if on_retry is not None:
                on_retry(attempt, delay, e)
            if delay > 0:
                time.sleep(delay)


# ----------------------------------------------------------------------
# manifest build / verify
def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def build_manifest(tag_dir: str) -> Dict:
    """Per-file sha256 + byte size of every payload file under the tag
    directory (dot-files — the manifest itself — are
    metadata, not payload)."""
    files = {}
    for base, dirs, names in os.walk(tag_dir):
        dirs[:] = [d for d in dirs if not d.startswith(".")]
        for fn in sorted(names):
            if fn.startswith("."):
                continue
            p = os.path.join(base, fn)
            rel = os.path.relpath(p, tag_dir)
            files[rel] = {"sha256": file_sha256(p),
                          "bytes": os.path.getsize(p)}
    return {"version": 1, "created": round(time.time(), 3), "files": files}


def write_manifest(tag_dir: str) -> Dict:
    """Hash the tag directory and atomically publish its manifest (the
    real ``commit()`` step)."""
    chaos.raise_if("ckpt.commit", tag_dir)
    manifest = build_manifest(tag_dir)
    atomic_write_text(os.path.join(tag_dir, MANIFEST_NAME),
                      json.dumps(manifest, indent=1, sort_keys=True))
    return manifest


def verify_tag_dir(tag_dir: str) -> str:
    """Re-check a tag directory against its manifest.

    Returns ``"ok"`` (manifest present, every file matches) or
    ``"unverified"`` (no manifest — a pre-resilience checkpoint; loadable
    but never verified-good). Raises :class:`CheckpointCorruptionError`
    naming the first mismatching file otherwise.
    """
    mpath = os.path.join(tag_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return "unverified"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointCorruptionError(
            f"checkpoint {tag_dir!r}: integrity manifest unreadable ({e})")
    for rel, want in sorted((manifest.get("files") or {}).items()):
        p = os.path.join(tag_dir, rel)
        if not os.path.exists(p):
            raise CheckpointCorruptionError(
                f"checkpoint {tag_dir!r}: file {rel!r} listed in the "
                "integrity manifest is missing")
        size = os.path.getsize(p)
        if size != want.get("bytes"):
            raise CheckpointCorruptionError(
                f"checkpoint {tag_dir!r}: file {rel!r} is {size} bytes, "
                f"manifest says {want.get('bytes')} (truncated write?)")
        digest = file_sha256(p)
        if digest != want.get("sha256"):
            raise CheckpointCorruptionError(
                f"checkpoint {tag_dir!r}: file {rel!r} checksum mismatch "
                f"({digest[:12]}… != manifest {str(want.get('sha256'))[:12]}…)")
    return "ok"


# ----------------------------------------------------------------------
# verified-good registry (per save_dir, commit order)
def _registry_path(save_dir: str) -> str:
    return os.path.join(save_dir, REGISTRY_DIR, REGISTRY_NAME)


def read_verified(save_dir: str) -> List[str]:
    """Tags with a committed manifest, oldest → newest."""
    path = _registry_path(save_dir)
    if not os.path.exists(path):
        return []
    try:
        with open(path) as f:
            tags = json.load(f)
        return [str(t) for t in tags] if isinstance(tags, list) else []
    except (ValueError, OSError):
        logger.warning(f"[resilience] verified-good registry at {path!r} "
                       "unreadable; treating as empty")
        return []


def _write_verified(save_dir: str, tags: List[str]):
    os.makedirs(os.path.join(save_dir, REGISTRY_DIR), exist_ok=True)
    atomic_write_text(_registry_path(save_dir), json.dumps(tags))


def record_verified(save_dir: str, tag: str) -> List[str]:
    tags = [t for t in read_verified(save_dir) if t != str(tag)]
    tags.append(str(tag))
    _write_verified(save_dir, tags)
    return tags


# ----------------------------------------------------------------------
class ResilientCheckpointEngine(CheckpointEngine):
    """Integrity wrapper around any checkpoint engine.

    ``save``/``load`` gain retry-with-backoff and chaos seams; ``commit``
    gains the manifest write + verified-good registry + retention;
    ``load`` gains verify-before-deserialize; it composes with the Array
    and Tiered tiers unchanged.
    """

    def __init__(self, inner: CheckpointEngine, config, emit=None):
        super().__init__(None)
        self._inner = inner
        self._cfg = config
        # fault-event emitter: (name, **data) -> None; wired to the
        # resilience manager (telemetry "fault" events + tail)
        self._emit = emit or (lambda name, **data: None)
        self._roots = set()           # save_dirs written this round
        self._verified_ok = set()     # tag dirs verified ok this process

    @staticmethod
    def _split(path):
        """'<save_dir>/<tag>/<name>' -> (save_dir, tag, name)."""
        tag_dir, name = os.path.split(path)
        save_dir, tag = os.path.split(tag_dir)
        return save_dir or ".", tag, name

    def create(self, tag):
        self._inner.create(tag)

    def makedirs(self, path, exist_ok=False):
        self._inner.makedirs(path, exist_ok=exist_ok)

    # -- save / load with retry + chaos --------------------------------
    def _on_retry(self, op, path):
        def hook(attempt, delay, exc):
            self._emit("ckpt.retry", op=op, path=path, attempt=attempt,
                       delay_secs=round(delay, 3), error=str(exc)[:200])

        return hook

    def _guarded_save(self, path, write):
        """``write()`` (a payload or sidecar save to ``path``) with the
        chaos seam and retries; re-saving a tag drops its cached
        verification verdict (the bytes on disk are about to change)."""
        save_dir, tag, _ = self._split(path)
        self._roots.add(save_dir)
        self._verified_ok.discard(
            os.path.realpath(os.path.join(save_dir, tag)))

        def do():
            chaos.raise_if("ckpt.save", path)
            return write()

        return retry_io(do, retries=self._cfg.retries,
                        backoff_secs=self._cfg.retry_backoff_secs,
                        what=f"save {path!r}",
                        on_retry=self._on_retry("save", path))

    def save(self, state_dict, path):
        return self._guarded_save(
            path, lambda: self._inner.save(state_dict, path))

    def save_text(self, path, text):
        """Sidecar metadata (topology manifest) rides the same retry +
        chaos seams and the same verdict-invalidation as payload saves."""
        return self._guarded_save(
            path, lambda: self._inner.save_text(path, text))

    def load(self, path, map_location=None):
        """Verify the tag before any bytes deserialize, then load with the
        chaos seam and retries."""
        save_dir, tag, _ = self._split(path)
        self.verify(os.path.join(save_dir, tag))

        def do():
            chaos.raise_if("ckpt.load", path)
            return self._inner.load(path, map_location=map_location)

        return retry_io(do, retries=self._cfg.retries,
                        backoff_secs=self._cfg.retry_backoff_secs,
                        what=f"load {path!r}",
                        on_retry=self._on_retry("load", path))

    # -- verify ---------------------------------------------------------
    def verify(self, tag_dir: str) -> str:
        """Verify a tag directory (cached per process once it passes).
        Raises :class:`CheckpointCorruptionError` on mismatch.

        Multi-process: rank 0 alone hashes (a shared filesystem holds one
        set of bytes — N hosts re-reading the full checkpoint would
        multiply restore IO by the host count); the engine's load path
        broadcasts rank 0's verdict before any collective load starts."""
        if not self._cfg.verify_on_load:
            return "skipped"
        from deepspeed_tpu_torch import comm as dist

        if dist.get_world_size() > 1 and dist.get_rank() != 0:
            return "delegated"
        key = os.path.realpath(tag_dir)
        if key in self._verified_ok:
            return "ok"
        try:
            status = verify_tag_dir(tag_dir)
        except CheckpointCorruptionError as e:
            self._emit("ckpt.corrupt", tag_dir=tag_dir, error=str(e)[:300])
            raise
        if status == "ok":
            self._verified_ok.add(key)
        else:
            logger.info(f"[resilience] {tag_dir!r} has no integrity "
                        "manifest (pre-resilience checkpoint); loading "
                        "unverified")
        return status

    # -- commit: manifest + registry + retention ------------------------
    def commit(self, tag):
        from deepspeed_tpu_torch import comm as dist

        tag = str(tag)
        out = self._inner.commit(tag)  # publishes (the tiered engine)
        barrier()                      # every process's files are final
        if dist.get_rank() == 0:
            for root in sorted(self._roots):
                tag_dir = os.path.join(root, tag)
                if not os.path.isdir(tag_dir):
                    continue
                retry_io(lambda d=tag_dir: write_manifest(d),
                         retries=self._cfg.retries,
                         backoff_secs=self._cfg.retry_backoff_secs,
                         what=f"manifest for {tag_dir!r}",
                         on_retry=self._on_retry("commit", tag_dir))
                verified = record_verified(root, tag)
                self._emit("ckpt.verified", tag=tag, save_dir=root,
                           n_verified=len(verified))
                log_dist(f"[resilience] committed integrity manifest for "
                         f"{tag!r} ({len(verified)} verified-good tag(s) "
                         f"in {root})", ranks=[0])
                self._prune(root, verified)
        barrier()                      # peers wait for manifest publish
        self._roots = set()
        return out

    def _prune(self, save_dir: str, verified: List[str]):
        """keep-last-N retention over *verified* tags only. The newest
        verified-good tag and the protected tags (``preempt``) are never
        deleted; tags this engine never published are never touched."""
        import shutil

        keep_n = int(self._cfg.keep_last_n)
        if keep_n <= 0:
            return
        protected = set(PROTECTED_TAGS)
        try:  # never strand the `latest` pointer at a deleted dir
            with open(os.path.join(save_dir, "latest")) as f:
                protected.add(f.read().strip())
        except OSError:
            pass
        deletable = [t for t in verified if t not in protected]
        victims = deletable[:-max(1, keep_n)]
        if not victims:
            return
        survivors = [t for t in verified if t not in victims]
        _write_verified(save_dir, survivors)  # registry first: a crash
        # between registry and rmtree leaves an extra dir, never a
        # registry entry pointing at a deleted checkpoint
        for t in victims:
            shutil.rmtree(os.path.join(save_dir, t), ignore_errors=True)
            self._verified_ok.discard(
                os.path.realpath(os.path.join(save_dir, t)))
        self._emit("ckpt.prune", save_dir=save_dir, pruned=victims,
                   kept=survivors)
        log_dist(f"[resilience] retention pruned {victims} "
                 f"(keep_last_n={keep_n})", ranks=[0])
