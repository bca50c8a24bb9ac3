"""Data loading (counterpart of ``deepspeed_tpu/runtime/dataloader.py``;
reference ``deepspeed/runtime/dataloader.py``: ``DeepSpeedDataLoader:39``,
``RepeatingLoader:16``).

The loader yields *global* micro-batches of ``train_micro_batch_size_per_gpu
x dp_world`` samples, as the JAX package's does: every rank builds the
same loader and the engine keeps each rank's rows (``SpecLayout.
batch_spec``). Its sample order (the per-epoch ``default_rng(seed +
epoch)`` shuffle) and its cursor (``state_dict`` / ``load_state_dict`` /
``fast_forward_samples``) are JAX's, so a run resumed in either package
continues the same sample sequence. A dataset may be a numpy array, a
tensor, a tuple / dict of them, or any ``__len__`` + ``__getitem__``
object.
"""

from typing import Callable, Optional

import numpy as np
import torch


def dataset_len(dataset) -> int:
    """Sample count of a dataset in any accepted shape: tuple → columns of
    arrays, dict → column mapping, else ``len`` (samples)."""
    if isinstance(dataset, tuple):
        return len(dataset[0])
    if isinstance(dataset, dict):
        return len(next(iter(dataset.values())))
    return len(dataset)


class RepeatingLoader:
    """Wrap an iterator to restart on StopIteration (reference ``:16``).

    State (cursor + RNG seed) passes through to the wrapped loader when
    it is state-capable (:class:`DeepSpeedDataLoader`), so an elastic
    resume restores the exact sample position through the wrapper."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    # cursor API provided via __getattr__ (not plain methods) so that
    # ``hasattr(wrapper, "load_state_dict")`` is False when the wrapped
    # loader is a plain iterable — capability probes in the elastic
    # restore must see the wrapper exactly as capable as what it wraps,
    # or the designed micro-batch fast-forward fallback is unreachable
    def __getattr__(self, name):
        if name in ("state_dict", "load_state_dict",
                    "fast_forward_samples"):
            inner = getattr(self.loader, name)  # AttributeError -> hasattr False
            if name == "state_dict":
                return inner

            def call(*args, **kwargs):
                out = inner(*args, **kwargs)
                # the live iterator predates the cursor restore; rebuild
                # so the next __next__ starts at the restored position
                self.data_iter = iter(self.loader)
                return out

            return call
        raise AttributeError(name)


class DeepSpeedDataLoader:
    """Batched loader over an indexable dataset.

    ``dataset`` may be: a numpy array / tensor (first dim = samples), a
    tuple/dict of such arrays, or any object with ``__len__`` +
    ``__getitem__``. ``collate_fn`` assembles a batch from a list of samples
    (defaults to np.stack per leaf for array-like samples).
    """

    def __init__(self,
                 dataset,
                 batch_size: int,
                 local_rank: int = 0,
                 collate_fn: Optional[Callable] = None,
                 num_local_io_workers: Optional[int] = None,
                 data_sampler=None,
                 data_parallel_world_size: Optional[int] = None,
                 data_parallel_rank: Optional[int] = None,
                 dataloader_drop_last: bool = False,
                 shuffle: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.drop_last = dataloader_drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.data_sampler = data_sampler
        self.epoch = 0
        # sample cursor: which epoch's permutation is being consumed and
        # how many samples of it have been yielded — together with the
        # (seed-derived, deterministic) per-epoch order this pins the
        # exact position in the GLOBAL sample sequence, independent of
        # batch size (the elastic-resume replay anchor)
        self._cursor_epoch = 0
        self._cursor_offset = 0
        self._resume_offset = 0
        self._len = self._num_batches()

    def _dataset_len(self) -> int:
        return dataset_len(self.dataset)

    def _num_batches(self) -> int:
        n = self._dataset_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __len__(self):
        if self.data_sampler is not None and hasattr(self.data_sampler,
                                                     "global_batch_size"):
            # sampler drives the schedule: len(sampler) global batches of
            # global_batch_size samples, rebatched to this loader's size
            total = len(self.data_sampler) * self.data_sampler.global_batch_size
            return (total // self.batch_size if self.drop_last
                    else -(-total // self.batch_size))
        return self._len

    def _index(self, idx):
        d = self.dataset
        if isinstance(d, tuple):
            return tuple(x[idx] for x in d)
        if isinstance(d, dict):
            return {k: v[idx] for k, v in d.items()}
        return d[idx]

    def _samplewise(self) -> bool:
        """True when the dataset yields one sample per __getitem__ (lists,
        MMapIndexedDataset, generic map-style datasets) rather than
        supporting fancy array indexing. Array-likes have BOTH dtype and
        shape; an indexed dataset exposes dtype alone."""
        return isinstance(self.dataset, list) or not (
            isinstance(self.dataset, (np.ndarray, torch.Tensor, tuple, dict))
            or (hasattr(self.dataset, "dtype")
                and hasattr(self.dataset, "shape")))

    def _yield_batch(self, idx):
        if self._samplewise():
            samples = [self.dataset[int(i)] for i in idx]
            if self.collate_fn is not None:
                return self.collate_fn(samples)
            return _default_collate(samples)
        return self._index(idx)

    def __iter__(self):
        if self.data_sampler is not None:
            # sampler drives the index stream; it may yield single indices
            # or whole index arrays (DeepSpeedDataSampler yields one global
            # batch per engine step) — rebatch to the loader's batch_size.
            # NOTE: a stateful sampler (consumed_samples) spans its whole
            # num_epochs budget across __iter__ calls and is single-pass;
            # iterating past exhaustion yields nothing, loudly:
            if (hasattr(self.data_sampler, "consumed_samples")
                    and hasattr(self.data_sampler, "total_samples")
                    and self.data_sampler.consumed_samples
                    >= self.data_sampler.total_samples):
                from deepspeed_tpu_torch.utils.logging import logger

                logger.warning(
                    "data sampler exhausted (consumed "
                    f"{self.data_sampler.consumed_samples}/"
                    f"{self.data_sampler.total_samples} samples); this "
                    "iteration yields no batches — raise "
                    "data_sampling.num_epochs or rebuild the sampler")
            buf = np.empty((0,), np.int64)
            for chunk in iter(self.data_sampler):
                buf = np.concatenate(
                    [buf, np.atleast_1d(np.asarray(chunk, np.int64))])
                while len(buf) >= self.batch_size:
                    idx, buf = buf[:self.batch_size], buf[self.batch_size:]
                    yield self._yield_batch(idx)
            if len(buf) and not self.drop_last:
                yield self._yield_batch(buf)
            return
        n = self._dataset_len()
        order = np.arange(n)
        epoch = self.epoch
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)
        self.epoch += 1
        # resume support: start this pass partway into the epoch's order
        # (set by load_state_dict / fast_forward_samples); consumed once
        start = self._resume_offset
        self._resume_offset = 0
        self._cursor_epoch = epoch
        self._cursor_offset = start
        pos = start
        while pos < n:
            idx = order[pos:pos + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            pos += len(idx)
            self._cursor_offset = pos
            yield self._yield_batch(idx)


    # ------------------------------------------------------------------
    # sample-exact cursor (elastic resume / rollback replay)
    def _check_sampler_resumable(self, what: str):
        """A custom ``data_sampler`` drives its own sample order, so the
        epoch/offset cursor does not describe it; its position is only
        capturable through a ``consumed_samples`` attribute (the stateful
        curriculum samplers). Anything else must fail LOUDLY — a cursor
        that silently records/restores nothing would restart the stream
        from the beginning, the exact failure sample-exact replay exists
        to prevent (the engine's manifest writer degrades to
        no-cursor-recorded on this error)."""
        if (self.data_sampler is not None
                and not hasattr(self.data_sampler, "consumed_samples")):
            raise ValueError(
                f"cannot {what}: data_sampler "
                f"{type(self.data_sampler).__name__} exposes no "
                "consumed_samples, so its position in the sample stream "
                "is unknowable — sample-exact elastic resume is not "
                "supported for this sampler")

    def state_dict(self) -> dict:
        """Position in the global sample sequence + the RNG identity that
        makes each epoch's order reproducible. Batch-size independent:
        a resumed loader with a DIFFERENT batch size continues the exact
        sample stream (the elastic topology-shift contract). With a
        stateful ``data_sampler`` the position lives in its
        ``consumed_samples`` (the epoch/offset cursor describes only the
        sampler-less index order)."""
        self._check_sampler_resumable("snapshot the cursor")
        state = {
            "epoch": int(self._cursor_epoch),
            "offset": int(self._cursor_offset),
            "seed": int(self.seed),
            "shuffle": bool(self.shuffle),
            "dataset_len": int(self._dataset_len()),
        }
        if self.data_sampler is not None:
            consumed = getattr(self.data_sampler, "consumed_samples", None)
            if consumed is not None:
                state["sampler_consumed_samples"] = int(consumed)
        return state

    def load_state_dict(self, state: dict):
        """Restore the cursor. Loud on identity mismatches: a different
        seed/shuffle/dataset length would silently change which samples
        each step sees — the exact failure sample-exact replay exists to
        prevent."""
        self._check_sampler_resumable("restore the cursor")
        for field, mine in (("seed", self.seed), ("shuffle", self.shuffle),
                            ("dataset_len", self._dataset_len())):
            theirs = state.get(field)
            if theirs is not None and theirs != mine:
                raise ValueError(
                    f"dataloader state mismatch: saved {field}="
                    f"{theirs!r} but this loader has {field}={mine!r} — "
                    "an elastic resume must rebuild the loader with the "
                    "same dataset/seed/shuffle so the global sample "
                    "sequence continues exactly")
        epoch, offset = int(state["epoch"]), int(state["offset"])
        n = self._dataset_len()
        if n > 0 and offset >= n:
            epoch += offset // n
            offset = offset % n
        self.epoch = epoch
        self._cursor_epoch = epoch
        self._cursor_offset = offset
        self._resume_offset = offset
        consumed = state.get("sampler_consumed_samples")
        if (consumed is not None and self.data_sampler is not None
                and hasattr(self.data_sampler, "consumed_samples")):
            self.data_sampler.consumed_samples = int(consumed)

    def fast_forward_samples(self, n_samples: int):
        """Seek to global sample index ``n_samples`` (the engine's
        ``global_samples`` counter) — the manifest-less fallback when no
        saved cursor is available. With ``drop_last`` the per-epoch
        yielded count depends on batch size, so cursor state
        (:meth:`state_dict`) is the exact mechanism; this seek assumes
        the historical batch geometry yielded full epochs."""
        n = self._dataset_len()
        per_epoch = ((n // self.batch_size) * self.batch_size
                     if self.drop_last else n)
        if per_epoch <= 0:
            raise ValueError(
                f"cannot fast-forward: dataset of {n} sample(s) yields no "
                f"full batch at batch_size={self.batch_size} with "
                "drop_last")
        self.load_state_dict({
            "epoch": int(n_samples) // per_epoch,
            "offset": int(n_samples) % per_epoch,
            "seed": self.seed, "shuffle": self.shuffle, "dataset_len": n})


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(samples)
    if isinstance(first, tuple):
        return tuple(np.stack([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    return np.stack(samples)
