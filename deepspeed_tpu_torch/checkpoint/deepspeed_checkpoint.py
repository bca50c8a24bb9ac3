"""Checkpoint inspection and resharding (counterpart of
``deepspeed_tpu/checkpoint/deepspeed_checkpoint.py``).

Both packages write *consolidated* checkpoints (rank 0 writes whole
tensors, in the JAX layout), so restoring onto any mesh, ZeRO stage or tp
degree needs no offline reshape: the engines lay whole tensors out at
load. What remains is the reference's surface for inspecting a
checkpoint, re-slicing a weight for a target tp degree, and the fp32
consolidation utility (``utils/zero_to_fp32.py``). Names are the file's
(JAX's flax paths).
"""

import os
from typing import Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    ArrayCheckpointEngine, read_latest, unflatten_by_paths)
from deepspeed_tpu_torch.utils.logging import logger


def _latest_tag(ckpt_dir: str) -> str:
    latest = read_latest(ckpt_dir)
    if latest is not None:
        return latest
    tags = sorted(d for d in os.listdir(ckpt_dir)
                  if os.path.isdir(os.path.join(ckpt_dir, d)))
    if not tags:
        raise FileNotFoundError(f"no checkpoint tags under {ckpt_dir}")
    return tags[-1]


class DeepSpeedCheckpoint:
    """Reference ``DeepSpeedCheckpoint``
    (``checkpoint/deepspeed_checkpoint.py:37``).

    ``target_tp``/``target_pp`` request re-slicing for a new parallel
    layout; since stored params are consolidated, any degree is reachable.
    """

    def __init__(self, ckpt_dir: str, target_tp: Optional[int] = None,
                 target_pp: Optional[int] = None, tag: Optional[str] = None):
        self.ckpt_dir = ckpt_dir
        self.tag = tag or _latest_tag(ckpt_dir)
        self.target_tp = target_tp or 1
        self.target_pp = target_pp or 1
        self._engine = ArrayCheckpointEngine()
        self._flat_module = self._engine.load(
            os.path.join(ckpt_dir, self.tag, "module"))
        self._flat_engine_state = {}
        eng_path = os.path.join(ckpt_dir, self.tag, "engine")
        if os.path.exists(eng_path) or os.path.exists(eng_path + ".npz"):
            try:
                self._flat_engine_state = self._engine.load(eng_path)
            except Exception:
                pass

    # -- inspection surface
    @property
    def original_tp_degree(self) -> int:
        return 1  # consolidated storage

    @property
    def original_pp_degree(self) -> int:
        return 1

    def parameter_names(self) -> List[str]:
        return sorted(k[len("params/"):] for k in self._flat_module
                      if k.startswith("params/"))

    def get_parameter(self, name: str) -> np.ndarray:
        v = self._flat_module[f"params/{name}"]
        if hasattr(v, "float"):  # a bf16 leaf (a torch tensor)
            v = v.float().numpy()
        return np.asarray(v)

    def params_tree(self):
        return unflatten_by_paths(self._flat_module, "params/")

    def global_steps(self) -> int:
        return int(self._flat_engine_state.get("global_steps", 0))

    # -- resharding
    def slice_for_tp(self, name: str, tp_rank: int, dim: int) -> np.ndarray:
        """One TP shard of a parameter along ``dim`` (reference
        ``ReplaceWithTensorSlicing``/``MegatronSDLoader.split`` capability)."""
        w = self.get_parameter(name)
        if w.shape[dim] % self.target_tp:
            raise ValueError(
                f"{name}: dim {dim} size {w.shape[dim]} not divisible by "
                f"tp={self.target_tp}")
        return np.split(w, self.target_tp, axis=dim)[tp_rank]

    def merge_tp_slices(self, slices: List[np.ndarray], dim: int) -> np.ndarray:
        """Inverse of :meth:`slice_for_tp` (reference ``merge`` path)."""
        return np.concatenate(slices, axis=dim)

    def show_summary(self):
        names = self.parameter_names()
        total = sum(int(np.prod(self.get_parameter(n).shape)) for n in names)
        logger.info(f"checkpoint {self.ckpt_dir}@{self.tag}: {len(names)} "
                    f"params, {total/1e6:.1f}M elements, "
                    f"step {self.global_steps()}")
        return {"num_params": len(names), "total_elements": total,
                "global_steps": self.global_steps()}


def get_fp32_state_dict_from_zero_checkpoint(ckpt_dir: str,
                                             tag: Optional[str] = None
                                             ) -> Dict[str, np.ndarray]:
    """Reference ``utils/zero_to_fp32.py``: reconstruct the full fp32 state
    dict. Consolidated storage makes this a load + cast."""
    ckpt = DeepSpeedCheckpoint(ckpt_dir, tag=tag)
    return {n: ckpt.get_parameter(n).astype(np.float32)
            for n in ckpt.parameter_names()}


def convert_zero_checkpoint_to_fp32_state_dict(ckpt_dir: str,
                                               output_file: str,
                                               tag: Optional[str] = None):
    """CLI body of ``zero_to_fp32.py``: write a consolidated ``.npz``."""
    sd = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)
    np.savez(output_file, **sd)
    logger.info(f"wrote fp32 state dict ({len(sd)} tensors) to {output_file}")
    return output_file
