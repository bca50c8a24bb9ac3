"""Checkpoint engine (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``):
pluggable save / load / commit used by the training engine.

- :class:`ArrayCheckpointEngine` — synchronous npz + json, the JAX
  package's on-disk format byte for byte in layout: each leaf of a nested
  dict under its ``/``-joined path in ``<path>.npz``, scalars and strings
  in the ``<path>.json`` sidecar with the ``#none`` (a None leaf) and
  ``#dtype`` markers. A ``torch.bfloat16`` leaf (numpy has no bf16) is
  stored as its uint16 view with ``"<key>#dtype": "bfloat16"``, as JAX
  stores an ml_dtypes leaf; loading it back gives a ``torch.bfloat16``
  tensor.
- :class:`TieredCheckpointEngine` — the ``nebula`` section's staged
  commit with a durable mirror.

JAX's orbax engines (``checkpoint.async_save``, ``checkpoint.sharded``)
are not ported: the config refuses both keys, naming ROADMAP item [10b].

Host code only: tensors are copied to the CPU and written with numpy.
"""

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import log_dist, logger


def fsync_dir(path):
    """Make rename/creation of directory entries durable (fsyncing file
    contents alone does not persist the dirent on ext4/xfs)."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # platform without dir-fsync: best effort
        pass


def atomic_write_bytes(path: str, blob: bytes):
    """tmp file + fsync + ``os.replace``: a crash mid-write never leaves
    a truncated file at ``path`` — either the old content survives or the
    new content is complete. The one durable-write primitive: the
    sidecars and the resilience layer's pointer / manifest / registry
    writes go through it."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


def atomic_write_text(path: str, text: str):
    """Text face of :func:`atomic_write_bytes`."""
    atomic_write_bytes(path, text.encode())


def barrier():
    """A barrier over the world when a process group runs; nothing
    otherwise (a run on one device has no group)."""
    from deepspeed_tpu_torch import comm as dist

    if dist.is_initialized():
        dist.barrier()


class CheckpointEngine:
    def __init__(self, config_params=None):
        pass

    def create(self, tag):
        log_dist(f"[ckpt] Saving checkpoint: {tag}", ranks=[0])

    def save(self, state_dict: Dict[str, Any], path: str):
        raise NotImplementedError

    def load(self, path: str, map_location=None) -> Dict[str, Any]:
        raise NotImplementedError

    def save_text(self, path: str, text: str):
        """Small sidecar file saved into a tag directory (the topology
        manifest), written atomically; staging engines override it so
        the sidecar rides their atomic publish."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        atomic_write_text(path, text)

    def commit(self, tag):
        return True

    def makedirs(self, path, exist_ok=False):
        os.makedirs(path, exist_ok=exist_ok)


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten nested dict/tuple/list/namedtuple structure to {path: leaf}
    (a tensor is a leaf)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):  # namedtuple
        for k in tree._fields:
            out.update(flatten_tree(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix.rstrip("/") + "#none"] = None
    else:
        out[prefix.rstrip("/")] = tree
    return out


def unflatten_by_paths(flat: Dict[str, Any], prefix: str = "") -> dict:
    """Rebuild a nested dict from ``{path: leaf}`` entries under
    ``prefix`` (JAX's ``_unflatten_by_paths``)."""
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def read_latest(save_dir: str) -> Optional[str]:
    """The tag that ``<save_dir>/latest`` names; None without the file."""
    latest = os.path.join(save_dir, "latest")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return f.read().strip()


def _to_numpy(v, key: str, meta: Dict[str, Any]) -> np.ndarray:
    """The npz payload of one array leaf; a dtype numpy cannot store
    (torch bf16, ml_dtypes) becomes a same-width uint view plus a
    ``#dtype`` marker in ``meta``."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            meta[key + "#dtype"] = "bfloat16"
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.contiguous().numpy()
    a = np.asarray(v)
    if a.dtype.kind not in "biufcSU?":
        meta[key + "#dtype"] = str(a.dtype)
        a = a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])
    return a


def _view_dtype(arr: np.ndarray, name: str):
    """A uint payload back in its saved dtype: bf16 as a
    ``torch.bfloat16`` tensor, another ml_dtypes name as that numpy
    dtype (``ml_dtypes`` registers the names)."""
    if name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    import ml_dtypes  # noqa: F401 — registers the names

    return arr.view(np.dtype(name))


class LazyNpz:
    """Slice-addressable reader over an uncompressed ``.npz``.

    ``np.savez`` stores each member with ``ZIP_STORED`` (no compression),
    so every array's bytes sit contiguously in the archive at a knowable
    offset. This reader parses the zip + npy headers once, then serves
    ``read_slice(key, index)`` through a per-call ``np.memmap``: only the
    pages the slice touches are read. Compressed / Fortran / object
    members degrade to a cached full read of that member only.
    """

    def __init__(self, path: str):
        import struct
        import zipfile

        self._path = path
        # key -> (array_byte_offset, shape, dtype) | None (full-read fallback)
        self._entries: Dict[str, Optional[tuple]] = {}
        self._full_cache: Dict[str, Any] = {}
        with zipfile.ZipFile(path) as zf, open(path, "rb") as raw:
            for zinfo in zf.infolist():
                name = zinfo.filename
                key = name[:-4] if name.endswith(".npy") else name
                entry = None
                if zinfo.compress_type == zipfile.ZIP_STORED:
                    raw.seek(zinfo.header_offset)
                    local = raw.read(30)
                    if len(local) == 30 and local[:4] == b"PK\x03\x04":
                        nlen, elen = struct.unpack("<HH", local[26:30])
                        raw.seek(zinfo.header_offset + 30 + nlen + elen)
                        entry = self._parse_npy_header(raw)
                self._entries[key] = entry

    @staticmethod
    def _parse_npy_header(f):
        try:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            else:
                return None
        except ValueError:
            return None
        if fortran or dtype.hasobject:
            return None
        return (f.tell(), tuple(shape), dtype)

    def keys(self):
        return list(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def shape_dtype(self, key):
        entry = self._entries[key]
        if entry is not None:
            return entry[1], entry[2]
        a = self._full(key)
        return tuple(a.shape), a.dtype

    def _full(self, key):
        if key not in self._full_cache:
            with np.load(self._path, allow_pickle=False) as z:
                self._full_cache[key] = z[key]
        return self._full_cache[key]

    def read_slice(self, key: str, index=()) -> np.ndarray:
        """``arr[index]``, reading only those bytes (plus filesystem page
        granularity); ``()`` reads the whole array."""
        entry = self._entries[key]
        if entry is None:
            return np.ascontiguousarray(self._full(key)[index])
        offset, shape, dtype = entry
        if not shape:  # 0-d member
            mm = np.memmap(self._path, dtype=dtype, mode="r",
                           offset=offset, shape=(1,))
            return np.asarray(mm[0]).reshape(())
        mm = np.memmap(self._path, dtype=dtype, mode="r",
                       offset=offset, shape=shape)
        return np.array(mm[index])  # copy: touches only the sliced pages

    def read(self, key: str) -> np.ndarray:
        return self.read_slice(key, ())


def apply_npz_meta(flat: Dict[str, Any], meta: Dict[str, Any]) -> Dict[str, Any]:
    """Decode the ``.json`` sidecar's markers over loaded npz payloads, in
    place: ``#none`` entries restore None leaves, ``#dtype`` entries view
    uint payloads back in their dtype (:func:`_view_dtype`), everything
    else is a scalar / string leaf."""
    for k, v in meta.items():
        if k.endswith("#none"):
            flat[k[:-len("#none")]] = None
        elif k.endswith("#dtype"):
            base = k[:-len("#dtype")]
            if base in flat:
                flat[base] = _view_dtype(flat[base], v)
        else:
            flat[k] = v
    return flat


class ArrayCheckpointEngine(CheckpointEngine):
    """npz (arrays) + json (structure / scalars) on the filesystem.

    ``save`` takes a dict whose leaves are tensors, numpy arrays, python
    scalars or strings, nested arbitrarily; ``load`` returns the flat
    ``{path: value}`` mapping (numpy arrays, bf16 leaves as torch
    tensors) with the sidecar's scalars merged in."""

    def save(self, state_dict: Dict[str, Any], path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        flat = flatten_tree(state_dict)
        arrays, meta = {}, {}
        for k, v in flat.items():
            if k.endswith("#none"):
                meta[k] = None
            elif hasattr(v, "shape"):
                arrays[k] = _to_numpy(v, k, meta)
            else:
                meta[k] = v
        np.savez(path + ".npz", **arrays)
        with open(path + ".json", "w") as f:
            json.dump(meta, f, default=str)

    def load(self, path: str, map_location=None) -> Dict[str, Any]:
        flat = {}
        with np.load(path + ".npz", allow_pickle=False) as z:
            for k in z.files:
                flat[k] = z[k]
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
            apply_npz_meta(flat, meta)
        return flat

    def load_lazy(self, path: str):
        """``(LazyNpz, meta)``: slice-addressable reads; ``meta`` is the
        raw sidecar (markers included — the caller applies them after
        slicing)."""
        reader = LazyNpz(path + ".npz")
        meta: Dict[str, Any] = {}
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
        return reader, meta


class TieredCheckpointEngine(CheckpointEngine):
    """Commit / rollback checkpointing — the ``nebula`` section, service
    free (JAX's ``TieredCheckpointEngine``):

    - ``save`` writes into a hidden per-tag staging dir, never the final
      location — a crash mid-save leaves no partial checkpoint visible;
    - ``commit`` fsyncs and atomically publishes (``os.replace``) staging
      into the tag dir, then mirrors to durable storage
      (``persistent_storage_path``) at most every
      ``persistent_time_interval`` seconds and prunes mirror versions
      beyond ``num_of_version_in_retention`` (only versions this engine
      published — recorded in a manifest — are ever pruned);
    - uncommitted staging from a crashed run is rolled back on the next
      ``create``;
    - ``load`` falls back to the durable mirror when the fast tier lost
      the file.
    """

    def __init__(self, config_params=None, inner: CheckpointEngine = None):
        super().__init__(config_params)
        cfg = config_params
        self._inner = inner or ArrayCheckpointEngine()
        self._persist_path = getattr(cfg, "persistent_storage_path", None)
        self._persist_interval = float(
            getattr(cfg, "persistent_time_interval", 100.0))
        self._retention = int(
            getattr(cfg, "num_of_version_in_retention", 2))
        self._load_mirror = bool(getattr(cfg, "enable_nebula_load", True))
        self._load_path = getattr(cfg, "load_path", None)
        self._tag = None
        self._roots = set()          # save_dirs staged into this round
        self._fresh = set()          # (root, tag) staging dirs wiped this round
        self._last_persist = 0.0

    @staticmethod
    def _split(path):
        """'<save_dir>/<tag>/<name>' -> (save_dir, tag, name)."""
        tag_dir, name = os.path.split(path)
        save_dir, tag = os.path.split(tag_dir)
        return save_dir or ".", tag, name

    def create(self, tag):
        super().create(tag)
        self._tag = str(tag)
        self._roots = set()
        self._fresh = set()

    def _staged_target(self, path):
        """``path`` inside the tag's staging dir, wiping a crashed
        earlier run's leftovers before the round's first write (a publish
        holds only this round's files)."""
        import shutil

        save_dir, tag, name = self._split(path)
        staged_dir = os.path.join(save_dir, ".staging", tag)
        if (save_dir, tag) not in self._fresh:
            shutil.rmtree(staged_dir, ignore_errors=True)
            self._fresh.add((save_dir, tag))
        self._roots.add(save_dir)
        return os.path.join(staged_dir, name)

    def save(self, state_dict, path):
        self._inner.save(state_dict, self._staged_target(path))

    def save_text(self, path, text):
        CheckpointEngine.save_text(self, self._staged_target(path), text)

    def load(self, path, map_location=None):
        """The fast tier's file, else the stranded ``.replaced`` version,
        ``load_path``'s or the durable mirror's."""
        def load(p):
            return self._inner.load(p, map_location=map_location)

        try:
            return load(path)
        except (OSError, FileNotFoundError):
            if not self._load_mirror:
                raise
            save_dir, tag, name = self._split(path)
            last_err = None
            # a crash inside a re-publish can strand the previous version
            # in <tag>.replaced — it is a complete checkpoint, recover it
            fallbacks = [os.path.join(save_dir, tag + ".replaced", name)]
            fallbacks += [os.path.join(base, tag, name) for base in
                          (self._load_path, self._persist_path) if base]
            for cand in fallbacks:
                try:
                    out = load(cand)
                    logger.warning(f"[ckpt] fast tier missing {path}; "
                                   f"restored from {cand}")
                    return out
                except (OSError, FileNotFoundError) as e:
                    last_err = e
            raise last_err or FileNotFoundError(path)

    def commit(self, tag):
        import shutil
        import time

        from deepspeed_tpu_torch import comm as dist

        tag = str(tag)
        self._inner.commit(tag)
        barrier()                # every process's staging is complete
        if dist.get_rank() == 0:
            for root in self._roots:
                staging_root = os.path.join(root, ".staging")
                staged = os.path.join(staging_root, tag)
                final = os.path.join(root, tag)
                trash = final + ".replaced"
                if not os.path.isdir(staged):
                    continue
                # durability before visibility: file contents first, then
                # the directory entries the publish renames touch
                for base, _, files in os.walk(staged):
                    for fn in files:
                        with open(os.path.join(base, fn), "rb") as f:
                            os.fsync(f.fileno())
                fsync_dir(staged)
                if not os.path.isdir(final) and os.path.isdir(trash):
                    # a previous commit crashed between its two renames
                    os.replace(trash, final)
                if os.path.isdir(final):
                    shutil.rmtree(trash, ignore_errors=True)
                    os.replace(final, trash)
                    os.replace(staged, final)  # atomic publish
                    shutil.rmtree(trash, ignore_errors=True)
                else:
                    os.replace(staged, final)  # atomic publish
                fsync_dir(root)
                for stale in os.listdir(staging_root):
                    shutil.rmtree(os.path.join(staging_root, stale),
                                  ignore_errors=True)
                self._mirror(root, tag, time.time())
        barrier()                # peers wait for the publish
        self._roots = set()
        self._fresh = set()
        return True

    # -- durable mirror -------------------------------------------------
    def _manifest(self):
        return os.path.join(self._persist_path, ".tiered_manifest.json")

    def _mirror(self, root, tag, now):
        import shutil

        if not self._persist_path:
            return
        if now - self._last_persist < self._persist_interval:
            return  # fast-tier only this round
        os.makedirs(self._persist_path, exist_ok=True)
        dst = os.path.join(self._persist_path, tag)
        tmp = dst + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.copytree(os.path.join(root, tag), tmp)
        if os.path.isdir(dst):
            shutil.rmtree(dst, ignore_errors=True)
        os.replace(tmp, dst)
        self._last_persist = now
        published = []
        if os.path.exists(self._manifest()):
            try:
                with open(self._manifest()) as f:
                    published = json.load(f)
            except (ValueError, OSError):
                logger.warning("[ckpt] mirror manifest unreadable; "
                               "restarting retention tracking")
        published = [t for t in published if t != tag] + [tag]
        while len(published) > max(1, self._retention):
            victim = published.pop(0)
            shutil.rmtree(os.path.join(self._persist_path, victim),
                          ignore_errors=True)
        atomic_write_text(self._manifest(), json.dumps(published))
        log_dist(f"[ckpt] mirrored {tag} to {self._persist_path} "
                 f"(retention {self._retention})", ranks=[0])
