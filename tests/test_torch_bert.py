"""The port's BERT family against the JAX package's, on the CPU.

The JAX model's own init, converted with ``bert_params_from_jax``, and the
same numpy batches go through both models and through
``deepspeed_tpu.initialize`` / ``deepspeed_tpu_torch.initialize`` with
``bench_bert.py``'s keys, at ``BertConfig.tiny`` in float32. On the CPU the
JAX BERT takes its masked dense path for every sparse layout (its kernel
path needs a TPU); the port takes the block-sparse function's plain
version at blocks >= 128 and the masked path below: the same function,
which is why these comparisons hold. Tolerances, with their reasons:

- logits: 1e-5 — the same fp32 math summed in other orders;
- training: losses and global gradient norms 1e-5 relative; parameters
  after three Adam steps within 1e-5 for 99.9 % of the elements and every
  element within ``2 * lr * steps`` (a near-zero gradient element can flip
  the sign of its Adam step: ``tests/test_torch_training.py``);
- remat policies against no remat: 1e-6 (the same ops, recomputed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.parallel.topology import MeshTopology, reset_topology
from deepspeed_tpu_torch.models import bert as port_bert
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2ForTraining
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse_kernel as bs
from deepspeed_tpu_torch.utils.params import (bert_params_from_jax,
                                              bert_training_model_from_jax)

B, T, LR = 2, 64, 1e-4
# the slice's section (fixed, per-head layouts, 4 global patterns) at a
# block that leaves tiny sequences more than one window
FIXED = {"mode": "fixed", "block": 8, "different_layout_per_head": True,
         "num_local_blocks": 4, "num_global_blocks": 1,
         "attention": "bidirectional", "horizontal_global_attention": False,
         "num_different_global_patterns": 4}
BIGBIRD = {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
           "num_sliding_window_blocks": 3, "num_global_blocks": 1}


def jax_config(**kw):
    return jax_bert.BertConfig.tiny(dtype=jnp.float32, **kw)


def port_config(**kw):
    return port_bert.BertConfig.tiny(dtype=torch.float32, **kw)


def ids_batch(seed, t=T, vocab=256):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (B, t)).astype(np.int32)
    labels = np.where(rng.random((B, t)) < 0.15, ids, -100).astype(np.int32)
    return ids, labels


@pytest.fixture(scope="module")
def mlm_params():
    model = jax_bert.BertForMaskedLM(jax_config())
    return jax.device_get(model.init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, T), jnp.int32)))


LOGIT_CASES = {
    "dense": {},
    "dense_padding_mask": {"mask": True},
    "token_types": {"token_types": True},
    "sparse_fixed_per_head": {"sparse": FIXED},
    "sparse_bigbird": {"sparse": BIGBIRD, "mask": True},
}


@pytest.mark.parametrize("case", sorted(LOGIT_CASES))
def test_mlm_logits_match_jax(mlm_params, case):
    spec = LOGIT_CASES[case]
    extra = {"sparse_attention": spec["sparse"]} if "sparse" in spec else {}
    ids, _ = ids_batch(1)
    rng = np.random.default_rng(2)
    mask = tt = None
    if spec.get("mask"):
        mask = np.ones((B, T), np.int32)
        mask[1, T // 2:] = 0
    if spec.get("token_types"):
        tt = (rng.random((B, T)) < 0.5).astype(np.int32)
    jmodel = jax_bert.BertForMaskedLM(jax_config(**extra))
    want = jmodel.apply(mlm_params, jnp.asarray(ids),
                        attention_mask=None if mask is None
                        else jnp.asarray(mask),
                        token_type_ids=None if tt is None
                        else jnp.asarray(tt))
    cfg = port_config(**extra)
    pmodel = port_bert.BertForMaskedLM(cfg, device="meta")
    pmodel.load_state_dict(bert_params_from_jax(mlm_params, cfg),
                           assign=True)

    def t(x):
        return None if x is None else torch.from_numpy(x).long()

    with torch.no_grad():
        got = pmodel(t(ids), t(mask), t(tt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_sequence_classification_matches_jax():
    jmodel = jax_bert.BertForSequenceClassification(jax_config(), num_labels=3)
    ids, _ = ids_batch(3)
    mask = np.ones((B, T), np.int32)
    mask[0, -5:] = 0
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1),
                                        jnp.asarray(ids)))
    want = jmodel.apply(params, jnp.asarray(ids),
                        attention_mask=jnp.asarray(mask))
    cfg = port_config()
    pmodel = port_bert.BertForSequenceClassification(cfg, num_labels=3,
                                                     device="meta")
    pmodel.load_state_dict(bert_params_from_jax(params, cfg), assign=True)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(ids).long(),
                     torch.from_numpy(mask).long())
    assert got.dtype == torch.float32 and got.shape == (B, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_per_layer_tree_converts_like_the_scanned_one(mlm_params):
    """``scan_layers=False`` trees (``encoder/layer_<i>``) convert to the
    same state-dict keys."""
    model = jax_bert.BertForMaskedLM(jax_config(scan_layers=False))
    params = jax.device_get(model.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 8), jnp.int32)))
    cfg = port_config()
    assert bert_params_from_jax(params, cfg).keys() == \
        bert_params_from_jax(mlm_params, cfg).keys() == \
        port_bert.BertForMaskedLM(cfg, device="meta").state_dict().keys()


def test_hooks_keep_the_weights():
    """``with_sparse_attention`` and ``with_activation_checkpointing``
    return a model holding the SAME parameter tensors, and the engine's
    ``sparse_attention`` hook trains those tensors."""
    model = port_bert.BertForTraining(port_config())
    sparse = model.with_sparse_attention(FIXED)
    assert dict(sparse.config.sparse_attention) == FIXED
    remat = sparse.with_activation_checkpointing(True, "dots")
    assert remat.config.remat and remat.config.remat_policy == "dots"
    for other in (sparse, remat):
        for (n, p), (m, q) in zip(model.named_parameters(),
                                  other.named_parameters()):
            assert n == m and p is q
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={**bench_config(1, True),
                             "sparse_attention": FIXED}, device="cpu")
    assert engine.module is not model
    assert dict(engine.module.config.sparse_attention) == FIXED
    assert all(p is q for p, q in zip(model.parameters(),
                                      engine.module.parameters()))


def test_sparse_section_without_hook_trains_dense():
    model = GPT2ForTraining(GPT2Config.tiny(dtype=torch.float32))
    with mock.patch("deepspeed_tpu_torch.runtime.engine.logger") as log:
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, config={**bench_config(1, True),
                                 "sparse_attention": FIXED}, device="cpu")
    assert engine.module is model
    assert "with_sparse_attention" in log.warning.call_args[0][0]


def test_knobs_of_later_slices_raise():
    """Dropout and host-offloaded checkpoints raise naming their slice;
    ``partition_activations`` is accepted (a no-op without a tp group)."""
    for kw, where in (({"dropout": 0.1}, "training-features"),
                      ({"cpu_checkpointing": True}, "offload")):
        with pytest.raises(NotImplementedError, match=where):
            port_config(**kw)
    assert port_config(partition_activations=True).partition_activations
    with pytest.raises(ValueError, match="remat_policy"):
        port_config(remat=True, remat_policy="everything")


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_no_remat_gradients(policy):
    """At block 128 the layers take the block-sparse function: "dots"
    saves its forward (one plain forward a layer, as without remat),
    "full" runs it again in backward; every gradient equals the no-remat
    one."""
    section = dict(FIXED, block=128, num_local_blocks=2,
                   num_different_global_patterns=2)
    ids, labels = ids_batch(4, t=256)
    batch = {"input_ids": torch.from_numpy(ids),
             "labels": torch.from_numpy(labels)}
    grads, calls = {}, {}
    for remat in (None, policy):
        cfg = port_config(max_position_embeddings=256,
                          sparse_attention=section,
                          **({} if remat is None else
                             {"remat": True, "remat_policy": remat}))
        model = port_bert.BertForTraining(cfg, seed=5)
        forward = bs.block_sparse_attention_reference
        with mock.patch.object(bs, "block_sparse_attention_reference",
                               wraps=forward) as spy:
            model(batch).backward()
        calls[remat] = spy.call_count
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    layers = port_config().num_hidden_layers
    assert calls[None] == layers
    assert calls[policy] == (layers if policy == "dots" else 2 * layers)
    for name, g in grads[None].items():
        torch.testing.assert_close(grads[policy][name], g, atol=1e-6,
                                   rtol=1e-6)


def test_key_bias_gradient_is_zero_unless_ds_rows_fail_to_sum_to_zero():
    """A key bias shifts every score of a row alike, which the softmax
    ignores: its gradient, the column sums of dS, vanishes because each
    row of ds = p * (dP - delta) sums to zero. With delta zeroed the rows
    no longer do, and the key-bias gradient grows to the size of the
    query bias's: what ``chip_smoke.py`` phase 7's control reads."""
    section = dict(FIXED, block=128, num_local_blocks=2,
                   num_different_global_patterns=2)
    ids, labels = ids_batch(6, t=256)
    batch = {"input_ids": torch.from_numpy(ids),
             "labels": torch.from_numpy(labels)}
    cfg = port_config(max_position_embeddings=256, sparse_attention=section)

    def shares(delta=None):
        model = port_bert.BertForTraining(cfg, seed=5)
        with mock.patch.object(bs, "attention_delta",
                               delta or bs.attention_delta):
            model(batch).backward()
        grads = dict(model.named_parameters())
        return [(grads[n].grad.norm() / grads[n.replace(
            "key.bias", "query.bias")].grad.norm()).item()
                for n in grads if n.endswith("attention.self.key.bias")]

    assert max(shares()) < 1e-4
    assert min(shares(lambda do, o: torch.zeros(o.shape[:-1]))) > 1.0


def bench_config(gas, fused):
    """bench_bert.py's engine keys at a tiny batch, fp32, ZeRO stage 0."""
    return {"train_micro_batch_size_per_gpu": B,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "Adam",
                          "params": {"lr": LR, "weight_decay": 0.01}},
            "gradient_clipping": 1.0,
            "bf16": {"enabled": False},
            "fused_step": fused,
            "zero_optimization": {"stage": 0},
            "steps_per_print": 10_000}


@pytest.mark.parametrize("gas,fused", [(1, True), (2, False)],
                         ids=["fused_step", "gas2"])
def test_sparse_training_matches_jax_engine(gas, fused):
    """Three optimizer steps of bench_bert.py's keys plus the slice's
    sparse_attention section (block 128, 512 tokens: the port's
    block-sparse function, the JAX masked path) from the same weights,
    "dots" remat: the losses of every micro-step, the pre-clip grad norm
    of every step and the final parameters agree. Two local blocks and two
    global patterns give two windows at 512 tokens, so the heads still
    see different global columns."""
    t = 512
    section = dict(FIXED, block=128, num_local_blocks=2,
                   num_different_global_patterns=2)
    remat = dict(remat=True, remat_policy="dots",
                 max_position_embeddings=t)
    reset_topology()
    topo = MeshTopology(axis_sizes={"data": 1}, devices=jax.devices()[:1])
    jmodel = jax_bert.BertForTraining(jax_config(**remat))
    # the parameters do not depend on the sequence: init on 8 tokens
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32)))
    config = {**bench_config(gas, fused), "sparse_attention": section}
    jax_engine, *_ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params["params"], mesh=topo,
        config=config)
    port_engine, *_ = deepspeed_tpu_torch.initialize(
        model=bert_training_model_from_jax(params, port_config(**remat)),
        config=config, device="cpu")
    assert port_engine.module.config.sparse_attention is not None
    losses, norms = [], []
    for i in range(3 * gas):
        ids, labels = ids_batch(10 + i, t=t)
        pair = []
        for engine in (jax_engine, port_engine):
            loss = engine({"input_ids": ids, "labels": labels})
            engine.backward(loss)
            engine.step()
            pair.append(float(loss))
        losses.append(pair)
        if (i + 1) % gas == 0:
            norms.append([jax_engine.get_global_grad_norm(),
                          port_engine.get_global_grad_norm()])
    losses, norms = np.array(losses), np.array(norms)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    np.testing.assert_allclose(norms[:, 1], norms[:, 0], rtol=1e-5)
    assert port_engine.global_steps == 3

    want = bert_params_from_jax(jax.device_get(jax_engine.state.params),
                                port_config())
    got = port_engine.module_state_dict()
    diff = torch.cat([(got[f"model.{k}"] - v).abs().flatten()
                      for k, v in want.items()])
    assert (diff <= 1e-5).float().mean() >= 0.999
    assert diff.max() <= 2 * LR * 3
