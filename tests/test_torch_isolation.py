"""The port stands alone and never falls back to the CPU.

- ``import deepspeed_tpu_torch`` (every module of it) leaves ``jax`` and
  ``deepspeed_tpu`` out of ``sys.modules``, checked in a fresh process;
- no file under the package imports either (the block-sparse modules
  keep their own copy of the numpy ``sparsity_config``);
- asking for the card without one raises; a tensor on a device the
  wrappers do not run on raises instead of taking the plain version;
- ``chip_smoke.py`` exits non-zero, printing no result, without a card
  or without the rest of the repository.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2ForTraining,
                                             GPT2LMHeadModel)
from deepspeed_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_paged, decode_attention_paged_int8,
    decode_attention_paged_int8_tp, decode_attention_paged_tp,
    decode_attention_tp)
from deepspeed_tpu_torch.models.bert import BertConfig, BertForTraining
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForTraining,
                                              LlamaModel)
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_backward_dkv,
    flash_attention_bthd, flash_attention_bthd_tp)
from deepspeed_tpu_torch.ops.quantizer import stochastic_quantize
from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import (
    block_sparse_attention, block_sparse_backward_dkv,
    block_sparse_backward_dq)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    FixedSparsityConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deepspeed_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "deepspeed_tpu")


def _no_gpu_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = REPO
    return env


# the data-parallel slice's modules, which the walk below must reach
DATA_PARALLEL = ("comm.comm", "comm.backend", "parallel.topology",
                 "utils.groups", "module_inject.policies",
                 "runtime.zero.config", "runtime.zero.partition",
                 "runtime.zero.reduce", "runtime.zero.stage", "zero")
# the tensor-parallel slice's modules
TENSOR_PARALLEL = ("module_inject.layers", "runtime.state_dict_factory")
# the Llama family's modules
LLAMA = ("models.llama", "inference.auto", "runtime.state_dict_factory",
         "utils.params")
# the serving fleet's modules
FLEET = ("serving.router", "serving.health", "serving.autoscaler",
         "serving.migration", "serving.capacity", "serving.replay",
         "serving.tenancy", "serving.gateway", "runtime.resilience.chaos",
         "telemetry.events", "telemetry.tracing", "telemetry.metrics",
         "telemetry.registry", "telemetry.prom")
# the checkpoint and resilience slice's modules
RESILIENCE = ("runtime.checkpoint_engine.checkpoint_engine",
              "runtime.resilience.integrity", "runtime.resilience.topology",
              "runtime.resilience.sentinel", "runtime.resilience.watchdog",
              "runtime.resilience.manager", "runtime.dataloader",
              "telemetry.flightrec", "checkpoint.deepspeed_checkpoint",
              "utils.zero_to_fp32")


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepspeed_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "missing = [m for m in "
        f"{DATA_PARALLEL + TENSOR_PARALLEL + FLEET + LLAMA + RESILIENCE!r} "
        "if 'deepspeed_tpu_torch.' + m not in names]\n"
        "assert not missing, missing\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_no_gpu_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), name) for f in files
           for name in _imports(f) if name.split(".")[0] in FORBIDDEN]
    assert not bad


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    model = GPT2LMHeadModel(GPT2Config.tiny(), device="meta")
    with pytest.raises(RuntimeError, match="cuda"):
        deepspeed_tpu_torch.init_inference(model)  # default device: card
    with pytest.raises(RuntimeError, match="cuda"):
        deepspeed_tpu_torch.init_inference(  # a tp rank: the card
            model, tensor_parallel={"tp_size": 2})
    with pytest.raises(RuntimeError, match="cuda"):
        deepspeed_tpu_torch.initialize(  # the training engine: the card
            model=GPT2ForTraining(GPT2Config.tiny(), device="meta"),
            config={"train_batch_size": 1})
    with pytest.raises(RuntimeError, match="cuda"):
        deepspeed_tpu_torch.initialize(  # sparse BERT training: the card
            model=BertForTraining(BertConfig.tiny(), device="meta"),
            config={"train_batch_size": 1,
                    "sparse_attention": {"mode": "fixed", "block": 16}})
    with pytest.raises(RuntimeError, match="cuda"):
        deepspeed_tpu_torch.initialize(  # ZeRO: NCCL on the card
            model=GPT2ForTraining(GPT2Config.tiny(), device="meta"),
            config={"train_batch_size": 1,
                    "zero_optimization": {"stage": 1}})
    with pytest.raises(RuntimeError, match="cuda"):  # Llama: the card
        deepspeed_tpu_torch.init_inference(
            LlamaModel(LlamaConfig.tiny(), device="meta"))
    with pytest.raises(RuntimeError, match="cuda"):
        deepspeed_tpu_torch.initialize(
            model=LlamaForTraining(LlamaConfig.tiny(), device="meta"),
            config={"train_batch_size": 1})
    with pytest.raises(RuntimeError, match="cuda"):
        deepspeed_tpu_torch.init_distributed()  # NCCL needs the card
    assert not deepspeed_tpu_torch.comm.is_initialized()
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device
    launches the kernel or raises."""
    q = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_bthd(q, q, q)
    lse = torch.empty((1, 2, 8), device="meta")
    for backward in (flash_attention_backward, flash_attention_backward_dkv):
        with pytest.raises(ValueError, match="cuda or cpu"):
            backward(q, q, q, q, lse, lse)
    q4 = torch.empty((1, 1, 2, 16), device="meta")
    idx = torch.empty((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention(q4, q4, q4, idx)
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention_paged(q4, q4, q4, idx, idx)
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention_paged_int8(q4, q4, q4, q4, q4, idx, idx)
    # the tensor-parallel wrappers: the same kernels
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_bthd_tp(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention_tp(q4, q4, q4, idx)
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention_paged_tp(q4, q4, q4, idx, idx)
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention_paged_int8_tp(q4, q4, q4, q4, q4, idx, idx)
    # the block-sparse wrappers, and SparseSelfAttention's kernel path
    qs = torch.empty((1, 4, 256, 64), device="meta")
    lses = torch.empty((1, 4, 256), device="meta")
    layout = FixedSparsityConfig(num_heads=4, block=128).make_layout(256)
    with pytest.raises(ValueError, match="cuda or cpu"):
        block_sparse_attention(qs, qs, qs, layout)
    for backward in (block_sparse_backward_dq, block_sparse_backward_dkv):
        with pytest.raises(ValueError, match="cuda or cpu"):
            backward(qs, qs, qs, qs, lses, lses, layout)
    with pytest.raises(ValueError, match="cuda or cpu"):
        SparseSelfAttention(FixedSparsityConfig(num_heads=4, block=128),
                            max_seq_length=256)(qs, qs, qs)
    # the stochastic quantizer (a stand-alone op: no path calls it)
    with pytest.raises(ValueError, match="cuda or cpu"):
        stochastic_quantize(torch.empty((4, 4), device="meta"), 0)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    env = _no_gpu_env()
    if alone:  # a directory holding chip_smoke.py and nothing else
        cwd = str(tmp_path)
        shutil.copy(script, cwd)
        script = os.path.join(cwd, "chip_smoke.py")
        env["PYTHONPATH"] = ""
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
