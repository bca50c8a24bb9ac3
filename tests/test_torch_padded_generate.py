"""Left-padded ``generate()`` in the port against the JAX package.

- ``models/decode_utils.py``: the left-padding helpers and the ``pad`` /
  ``window`` forms of ``cache_attn_mask`` equal the JAX package's on the
  cases of its own tests, and the mask check raises its errors.
- ``decode_attention_reference(pad=)`` (kernel 7's plain version with a
  per-row first key) equals the JAX padded decode step's masked attention,
  and the causal forward of a left-padded batch the JAX model's.
- On a tiny fp32 GPT-2 (weights carried across by ``params_from_jax``):
  padded greedy and keyed ``generate()`` emit the JAX engine's tokens,
  each padded row its solo call's, and ``serving.bucket_legacy_generate``
  on and off the same tokens.

Everything runs on the CPU in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import decode_utils as jax_du
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxConfig
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JaxModel
from deepspeed_tpu.ops.attention import attention as jax_attention
from deepspeed_tpu_torch.models import decode_utils as du
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)
from tests.test_torch_gpt2 import jax_engine, port_model, random_flax_params

_SERVING = {"block_size": 8, "decode_slots": 3}


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# decode_utils
# ---------------------------------------------------------------------------
# (S, idx, T, pad, window): the cases of tests/unit/test_decode_utils.py
MASK_CASES = {
    "scalar_causal": (8, 3, 2, None, 0),
    "window_1": (16, 9, 3, None, 1),
    "window_4": (16, 9, 3, None, 4),
    "window_wider_than_history": (8, 2, 1, None, 100),
    "ragged_pad": (12, 6, 2, [0, 3, 5], 0),
    "ragged_pad_window": (12, 7, 1, [0, 6], 3),
    "vector_idx": (16, [0, 5, 7, 14], 2, None, 0),
    "vector_idx_pad_window": (16, [4, 9], 1, [1, 2], 4),
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_cache_attn_mask_matches_jax(case):
    S, idx, T, pad, window = MASK_CASES[case]
    vector = isinstance(idx, list)
    ref = jax_du.cache_attn_mask(
        S, jnp.asarray(idx, jnp.int32) if vector else idx, T,
        None if pad is None else jnp.asarray(pad, jnp.int32), window=window)
    ours = du.cache_attn_mask(
        S, torch.tensor(idx, dtype=torch.int32) if vector else idx, T,
        None if pad is None else torch.tensor(pad, dtype=torch.int32),
        window=window)
    np.testing.assert_array_equal(_np(ours), np.asarray(ref))


def test_position_helpers_match_jax():
    """Ragged pads: row positions, pad lengths and a decode step's
    positions (scalar and 0-d tensor index) equal JAX's."""
    mask = np.array([[1, 1, 1, 1], [0, 0, 1, 1], [0, 0, 0, 1]], np.int32)
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    np.testing.assert_array_equal(_np(du.row_positions(tm)),
                                  np.asarray(jax_du.row_positions(jm)))
    pads = du.pad_lengths(tm, 4)
    assert pads.dtype == torch.int32
    np.testing.assert_array_equal(_np(pads),
                                  np.asarray(jax_du.pad_lengths(jm, 4)))
    jpads = jax_du.pad_lengths(jm, 4)
    for idx, T in ((4, 1), (6, 3)):
        ref = np.asarray(jax_du.decode_positions(idx, T, jpads))
        np.testing.assert_array_equal(_np(du.decode_positions(idx, T, pads)),
                                      ref)
        np.testing.assert_array_equal(_np(du.decode_positions(
            torch.tensor(idx, dtype=torch.int32), T, pads)), ref)


# masks on ids of shape [1, 5]: the cases of
# tests/unit/test_padded_generate.py:test_mask_conventions_enforced and a
# mis-shaped one
BAD_MASKS = {"right_padded": [[1, 1, 1, 0, 0]],
             "all_pad_row": [[0, 0, 0, 0, 0]],
             "mis_shaped": [[1, 1, 1]]}


@pytest.mark.parametrize("case", list(BAD_MASKS))
def test_mask_errors_match_jax(case):
    ids = np.array([[7, 23, 56, 11, 9]], np.int32)
    mask = np.array(BAD_MASKS[case], np.int32)
    with pytest.raises(ValueError) as ref:
        jax_du.validate_left_padded_mask(jnp.asarray(ids), jnp.asarray(mask))
    with pytest.raises(ValueError) as ours:
        du.validate_left_padded_mask(torch.from_numpy(ids),
                                     torch.from_numpy(mask))
    assert str(ours.value) == str(ref.value)


def test_mask_check_collapses_and_promotes():
    ids = torch.ones((2, 3), dtype=torch.long)
    assert du.validate_left_padded_mask(ids, np.ones((2, 3))) is None
    one = torch.ones((1, 3), dtype=torch.long)
    got = du.validate_left_padded_mask(one, [0, 1, 1])
    assert got.dtype == torch.int32 and got.tolist() == [[0, 1, 1]]


# ---------------------------------------------------------------------------
# kernel 7's plain version with a per-row first key
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tq,pads", [(1, [0, 3, 9, 12]), (3, [0, 5, 12, 2])])
def test_padded_decode_reference_matches_jax(tq, pads):
    """``decode_attention_reference(pad=)`` against the JAX padded decode
    step (``gpt2.py:507-516``: ``cache_attn_mask`` with the pads, plain
    attention), pads down to a row that sees its last key alone (pad =
    idx at T_q = 1); rows outside [pad, idx + T_q) hold NaN, which must
    not reach the output."""
    B, H, D, S, idx = 4, 2, 16, 24, 12
    rng = np.random.default_rng(tq)
    q = rng.standard_normal((B, tq, H, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S, H, D)).astype(np.float32)
              for _ in range(2))
    pad = np.array(pads, np.int32)
    mask = jax_du.cache_attn_mask(S, idx, tq, jnp.asarray(pad))
    ref = jax_attention(jnp.asarray(q).transpose(0, 2, 1, 3),
                        jnp.asarray(kc).transpose(0, 2, 1, 3),
                        jnp.asarray(vc).transpose(0, 2, 1, 3), mask=mask,
                        causal=False, use_flash=False).transpose(0, 2, 1, 3)
    for b, p in enumerate(pads):   # what no row may read
        kc[b, :p], vc[b, :p] = np.nan, np.nan
    kc[:, idx + tq:], vc[:, idx + tq:] = np.nan, np.nan
    index = torch.tensor(idx, dtype=torch.int32)
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            index)
    ours = decode_attention_reference(*args, pad=torch.from_numpy(pad))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    # the wrapper takes its plain version for a CPU tensor
    torch.testing.assert_close(decode_attention(*args,
                                                pad=torch.from_numpy(pad)),
                               ours, atol=0, rtol=0)


def test_masked_causal_forward_matches_jax():
    """The causal forward of a left-padded batch (``attention_mask``):
    per-row positions and pad keys masked, as the JAX model's, also
    under remat."""
    ids, mask = _ragged_batch()
    model = JaxModel(JaxConfig.tiny(dtype=jnp.float32))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(ids))["params"]
    params = random_flax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), seed=3)
    ref = model.apply({"params": params}, jnp.asarray(ids),
                      attention_mask=jnp.asarray(mask))
    for remat in (False, True):
        port = port_model(params, remat=remat)
        out = port(torch.from_numpy(ids).long(),
                   attention_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=0)


def test_paged_and_padded_are_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        GPT2Config.tiny(decode=True, paged=True, padded=True)
    cfg = GPT2Config.tiny().for_decode(padded=True)
    assert cfg.padded and cfg.decode
    assert not cfg.for_paged_decode(4, 8).padded


# ---------------------------------------------------------------------------
# generate() against the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    engine, params = jax_engine(seed=0)
    port = deepspeed_tpu_torch.init_inference(port_model(params),
                                              dtype="fp32", device="cpu")
    return engine, port, params


def _padded_batch():
    """tests/unit/test_padded_generate.py's batch: lengths 5 and 3."""
    ids = np.array([[7, 23, 56, 11, 9], [0, 0, 3, 17, 42]], np.int32)
    mask = np.array([[1, 1, 1, 1, 1], [0, 0, 1, 1, 1]], np.int32)
    return ids, mask


def _ragged_batch():
    """Four prompts of real lengths 9 / 6 / 2 / 1, left-padded to 9."""
    rng = np.random.default_rng(7)
    lens = (9, 6, 2, 1)
    ids = np.zeros((4, 9), np.int32)
    mask = np.zeros((4, 9), np.int32)
    for b, n in enumerate(lens):
        ids[b, 9 - n:] = rng.integers(1, 256, n)
        mask[b, 9 - n:] = 1
    return ids, mask


BATCHES = {"two_rows": _padded_batch, "ragged_four": _ragged_batch}


def _generate(engine, ids, mask, n, **kw):
    """Both packages' call: numpy in, the new tokens out as lists."""
    if isinstance(engine, deepspeed_tpu_torch.inference.engine.
                  InferenceEngine):
        out = engine.generate(torch.from_numpy(ids), max_new_tokens=n,
                              attention_mask=None if mask is None
                              else torch.from_numpy(mask), **kw)
    else:
        out = engine.generate(jnp.asarray(ids), max_new_tokens=n,
                              attention_mask=None if mask is None
                              else jnp.asarray(mask), **kw)
    return _np(out)[:, ids.shape[1]:].tolist()


@pytest.mark.parametrize("batch", list(BATCHES))
def test_padded_greedy_matches_jax_and_solo(engines, batch):
    engine, port, _ = engines
    ids, mask = BATCHES[batch]()
    ours = _generate(port, ids, mask, 6)
    assert ours == _generate(engine, ids, mask, 6)
    for b in range(len(ids)):
        solo = ids[b:b + 1, mask[b] == 1]
        assert _generate(port, solo, None, 6) == [ours[b]], b


@pytest.mark.parametrize("batch", list(BATCHES))
def test_padded_keyed_matches_jax_and_solo(engines, batch):
    """Each row's first draw is at its real prompt length: the JAX
    engine's keyed tokens, and each row its solo keyed call's."""
    engine, port, _ = engines
    ids, mask = BATCHES[batch]()
    kw = dict(do_sample=True, seed=5, temperature=1.3, top_k=0, top_p=0.0)
    ours = _generate(port, ids, mask, 6, **kw)
    assert ours == _generate(engine, ids, mask, 6, **kw)
    assert ours != _generate(port, ids, mask, 6)   # not the greedy stream
    for b in range(len(ids)):
        solo = ids[b:b + 1, mask[b] == 1]
        assert _generate(port, solo, None, 6, **kw) == [ours[b]], b


def test_all_real_mask_is_the_unpadded_call(engines):
    _, port, _ = engines
    ids = np.array([[7, 23, 56, 11, 9]], np.int32)
    assert (_generate(port, ids, np.ones_like(ids), 3)
            == _generate(port, ids, None, 3))


@pytest.mark.parametrize("keyed", [False, True])
def test_bucketing_keeps_tokens(engines, keyed):
    """``serving.bucket_legacy_generate`` (on by default) left-pads a
    6-token prompt to the 8-token bucket and strips the pads: the same
    tokens as with it off and as the JAX engine's bucketed call, with and
    without a caller's own mask."""
    _, _, params = engines
    jax_bucketed, _ = jax_engine(seed=0, serving=_SERVING)
    jax_bucketed.params = engines[0].params
    kw = dict(do_sample=True, seed=3) if keyed else {}
    ids = np.random.default_rng(2).integers(1, 256, (2, 6)).astype(np.int32)
    padded, mask = _padded_batch()
    out = {}
    for on in (True, False):
        port = deepspeed_tpu_torch.init_inference(
            port_model(params), dtype="fp32", device="cpu",
            serving={**_SERVING, "bucket_legacy_generate": on})
        full = port.generate(torch.from_numpy(ids), max_new_tokens=5, **kw)
        assert full.shape == (2, 11)
        assert torch.equal(full[:, :6], torch.from_numpy(ids).long())
        out[on] = (_generate(port, ids, None, 5, **kw),
                   _generate(port, padded, mask, 5, **kw))
    assert out[True] == out[False]
    assert out[True] == (_generate(jax_bucketed, ids, None, 5, **kw),
                         _generate(jax_bucketed, padded, mask, 5, **kw))
