"""The port's block-sparse attention against the JAX package's, on the CPU.

The same numpy inputs go through the JAX Pallas kernels (in interpret
mode, as ``tests/unit/test_block_sparse_kernel.py`` runs them) and the
port's plain versions, which its wrappers take on a CPU tensor. fp32 at
B=1, H=2 or 4, D=32, blocks of 32 tokens, S=128 or 256. Tolerances, with their
reasons:

- layouts: equal, bit for bit (the port's ``sparsity_config`` is a copy);
- forward O and lse: 1e-5 — the same fp32 math, one softmax over the
  whole row against the kernel's block-by-block online one;
- dQ, dK/dV and autograd gradients: 2e-5 — the backward sums the same
  products over blocks in another order;
- ``SparseSelfAttention`` masked paths: 1e-5 (the same plain attention).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.ops.sparse_attention import block_sparse_kernel as jax_bs
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jax_sc
from deepspeed_tpu.ops.sparse_attention.sparse_self_attention import (
    SparseAttentionUtils as JaxUtils)
from deepspeed_tpu.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention as JaxSparseSelfAttention)
from deepspeed_tpu.utils.compat import tpu_interpret_mode
from deepspeed_tpu_torch.models import bert as port_bert
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.flash_attention import (attention_delta,
                                                     tma_view_error)
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse_kernel as bs
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseAttentionUtils, SparseSelfAttention)
from deepspeed_tpu_torch.tools.profile_training import BERT_SPARSE
from deepspeed_tpu_torch.utils.params import bert_params_from_jax
from tests.test_torch_ops import _c_arity

B, H, S, D = 1, 4, 256, 32
BLOCK = 32

# every mode of the layout zoo, random ones included: (class name, kwargs)
LAYOUT_MODES = {
    "dense": ("DenseSparsityConfig", {}),
    "fixed": ("FixedSparsityConfig", {"num_local_blocks": 4}),
    "fixed_per_head": ("FixedSparsityConfig", {
        "different_layout_per_head": True, "num_local_blocks": 4,
        "num_global_blocks": 1, "num_different_global_patterns": 4}),
    "fixed_uni_horizontal": ("FixedSparsityConfig", {
        "num_local_blocks": 2, "attention": "unidirectional"}),
    "fixed_horizontal": ("FixedSparsityConfig", {
        "num_local_blocks": 3, "horizontal_global_attention": True}),
    "variable_random": ("VariableSparsityConfig", {
        "num_random_blocks": 2, "local_window_blocks": [2, 3],
        "global_block_indices": [0, 5]}),
    "variable_ranges": ("VariableSparsityConfig", {
        "local_window_blocks": [4], "global_block_indices": [1],
        "global_block_end_indices": [3], "attention": "unidirectional"}),
    "bigbird": ("BigBirdSparsityConfig", {"num_random_blocks": 2}),
    "bigbird_per_head": ("BigBirdSparsityConfig", {
        "different_layout_per_head": True, "num_random_blocks": 1,
        "attention": "unidirectional"}),
    "bslongformer": ("BSLongformerSparsityConfig", {
        "global_block_indices": [0, 6]}),
    "bslongformer_ranges": ("BSLongformerSparsityConfig", {
        "global_block_indices": [2], "global_block_end_indices": [4]}),
    "local": ("LocalSlidingWindowSparsityConfig", {
        "num_sliding_window_blocks": 3}),
}


@pytest.mark.parametrize("mode", sorted(LAYOUT_MODES))
def test_layouts_equal_jax(mode):
    """Two draws from one instance (the random modes advance their
    generator between them) give the JAX layouts and token masks."""
    cls, kw = LAYOUT_MODES[mode]
    port = getattr(sc, cls)(num_heads=H, block=BLOCK, **kw)
    want = getattr(jax_sc, cls)(num_heads=H, block=BLOCK, **kw)
    for seq in (S, S + 2 * BLOCK):
        np.testing.assert_array_equal(port.make_layout(seq),
                                      want.make_layout(seq))
        np.testing.assert_array_equal(port.expand_mask(port.make_layout(seq),
                                                       seq),
                                      want.expand_mask(want.make_layout(seq),
                                                       seq))


def test_config_from_dict_equals_jax():
    section = {"mode": "bigbird", "block": BLOCK, "num_random_blocks": 1,
               "num_heads": 99}
    got = sc.sparsity_config_from_dict(section, H)
    want = jax_sc.sparsity_config_from_dict(section, H)
    assert type(got).__name__ == type(want).__name__
    assert got.num_heads == H and got.block == BLOCK
    np.testing.assert_array_equal(got.make_layout(S), want.make_layout(S))
    with pytest.raises(ValueError, match="unknown sparse_attention mode"):
        sc.sparsity_config_from_dict({"mode": "nope"}, H)


def _qkv(seed, n=3, seq=S, heads=H):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, heads, seq, D)) * 0.5).astype(
        np.float32) for _ in range(n)]


def _random_layout(seed, nb):
    rng = np.random.default_rng(seed)
    layout = rng.random((1, nb, nb)) < 0.35
    layout |= np.eye(nb, dtype=bool)[None]
    return layout


# the Pallas interpreter takes ~25 ms a grid step (one active block of one
# head), so each layout is as small as what it shows allows: the 4-pattern
# per-head layout needs 8 x 8 blocks (4 local blocks a window) and 4 heads,
# the others (one layout for every head) run at 4 x 4 blocks of 32 tokens
# and 2 heads. name: (sequence, layout [heads, nq, nk])
LAYOUTS = {
    "shared": (128, lambda: np.broadcast_to(_random_layout(1, 4),
                                            (2, 4, 4)).copy()),
    "fixed_per_head_4_patterns": (S, lambda: sc.FixedSparsityConfig(
        num_heads=H, block=BLOCK, different_layout_per_head=True,
        num_local_blocks=4, num_global_blocks=1,
        num_different_global_patterns=4).make_layout(S).astype(bool)),
    "bigbird": (128, lambda: sc.BigBirdSparsityConfig(
        num_heads=2, block=BLOCK, num_random_blocks=1,
        num_sliding_window_blocks=3,
        num_global_blocks=1).make_layout(128).astype(bool)),
}


def _jax_forward(q, k, v, layout):
    """O [B, H, S, D] and lse [B, H, S] of the JAX kernel."""
    qrow, kcol, cnt = jax_bs.flatten_layout(layout)
    nq, nk = layout.shape[1:]
    heads = [jnp.asarray(t).transpose(1, 0, 2, 3) for t in (q, k, v)]
    with tpu_interpret_mode():
        o, lse = jax_bs._sparse_forward_impl(
            *heads, jnp.asarray(qrow), jnp.asarray(kcol), jnp.asarray(cnt),
            D ** -0.5, nq=nq, nk=nk)
    return (np.asarray(o).transpose(1, 0, 2, 3),
            np.asarray(lse).transpose(1, 0, 2))


@functools.lru_cache(maxsize=None)
def _case(name):
    """(layout, q, k, v, dO, O, lse) of a layout, the JAX kernel's O and
    lse: the forward and backward tests share one interpreted forward."""
    seq, make = LAYOUTS[name]
    layout = make()
    q, k, v, do = _qkv(3, 4, seq, len(layout))
    return (layout, q, k, v, do, *_jax_forward(q, k, v, layout))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_forward_matches_pallas_kernel(name):
    """O and lse of the plain forward (and of the wrapper, which takes it
    on the CPU) equal the Pallas kernel's, and O equals the JAX entry
    point's."""
    layout, q, k, v, _, want_o, want_lse = _case(name)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    for o, lse in (bs.block_sparse_attention_reference(tq, tk, tv, layout),
                   bs.block_sparse_attention_with_lse(tq, tk, tv, layout)):
        np.testing.assert_allclose(o.numpy(), want_o, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5,
                                   rtol=1e-5)
    if name == "shared":  # the JAX entry's one-layout fold of B x H rows
        with tpu_interpret_mode():
            entry = jax_bs.block_sparse_attention(
                *(jnp.asarray(t) for t in (q, k, v)), layout)
        np.testing.assert_allclose(
            bs.block_sparse_attention(tq, tk, tv, layout).numpy(),
            np.asarray(entry), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["shared", "bigbird"])
def test_backward_matches_pallas_kernels(name):
    """The plain dQ and dK/dV (and their wrappers) against the JAX
    backward's two kernels on the same q, k, v, dO and the forward's O and
    lse."""
    layout, q, k, v, do, o, lse = _case(name)
    nq, nk = layout.shape[1:]
    lists = tuple(jnp.asarray(x) for x in (
        *jax_bs.flatten_layout(layout),
        *jax_bs.flatten_layout(layout.transpose(0, 2, 1))))
    heads = [jnp.asarray(t).transpose(1, 0, 2, 3) for t in (q, k, v, o, do)]
    with tpu_interpret_mode():
        dq, dk, dv = jax_bs._sparse_backward(
            *heads[:4], jnp.asarray(lse.transpose(1, 0, 2)), heads[4],
            lists, D ** -0.5, nq, nk)
    want = [np.asarray(t).transpose(1, 0, 2, 3) for t in (dq, dk, dv)]
    tq, tk, tv, to, tdo = (torch.from_numpy(t.copy())
                           for t in (q, k, v, o, do))
    tlse = torch.from_numpy(lse.copy())
    delta = attention_delta(tdo, to)
    args = (tq, tk, tv, tdo, tlse, delta, layout)
    for got in ([bs.block_sparse_backward_dq_reference(*args),
                 *bs.block_sparse_backward_dkv_reference(*args)],
                [bs.block_sparse_backward_dq(*args),
                 *bs.block_sparse_backward_dkv(*args)]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", ["shared"])
def test_autograd_matches_jax_grad(name):
    """Gradients of sum(O * W) through BlockSparseAttentionFunction equal
    ``jax.grad`` of the JAX entry point (its custom VJP, interpret mode)."""
    seq, make = LAYOUTS[name]
    layout = make()
    q, k, v, w = _qkv(4, 4, seq, len(layout))

    def loss(a, b, c):
        return jnp.sum(jax_bs.block_sparse_attention(a, b, c, layout) * w)

    with tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(t) for t in (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    (bs.block_sparse_attention(*leaves, layout)
     * torch.from_numpy(w)).sum().backward()
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   atol=2e-5, rtol=2e-5)


def _attn_pair(section, **kw):
    port = SparseSelfAttention(sc.sparsity_config_from_dict(section, H),
                               max_seq_length=S, **kw)
    want = JaxSparseSelfAttention(
        jax_sc.sparsity_config_from_dict(section, H), max_seq_length=S,
        **kw)
    return port, want


FIXED = {"mode": "fixed", "block": BLOCK, "num_local_blocks": 4,
         "different_layout_per_head": True,
         "num_different_global_patterns": 2}


@pytest.mark.parametrize("case", ["add_padding", "mul_padding",
                                  "attn_mask_mul", "attn_mask_add", "rpe",
                                  "no_mask", "kernel_block_128"])
def test_sparse_self_attention_matches_jax(case):
    """Key-padding masks in both modes, attention masks, a relative
    position bias, and the pure-layout case (the block-sparse function at
    block 128, the JAX masked path on the CPU)."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(5)
    section = dict(FIXED, block=128, num_local_blocks=1,
                   num_different_global_patterns=1) \
        if case == "kernel_block_128" else FIXED
    kw, call = {}, {}
    keep = (rng.random((B, S)) < 0.8).astype(np.float32)
    keep[:, 0] = 1
    if case == "add_padding":
        kw["key_padding_mask_mode"] = "add"
        call["key_padding_mask"] = np.where(keep > 0, 0.0, -10000.0).astype(
            np.float32)
    elif case == "mul_padding":
        kw["key_padding_mask_mode"] = "mul"
        call["key_padding_mask"] = keep
    elif case.startswith("attn_mask"):
        tri = np.tril(np.ones((S, S), np.float32))
        kw["attn_mask_mode"] = case[-3:]
        call["attn_mask"] = tri if case.endswith("mul") else np.where(
            tri > 0, 0.0, -10000.0).astype(np.float32)
    elif case == "rpe":
        call["rpe"] = (rng.standard_normal((H, S, S)) * 0.1).astype(
            np.float32)
    port, want = _attn_pair(section, **kw)
    if case == "kernel_block_128":
        assert port._use_kernel(None, None, None)
    out = port(*(torch.from_numpy(t) for t in (q, k, v)),
               **{n: torch.from_numpy(m) for n, m in call.items()})
    ref = want(*(jnp.asarray(t) for t in (q, k, v)),
               **{n: jnp.asarray(m) for n, m in call.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_layout_checks_raise_like_jax():
    q = torch.zeros((B, H, S, D))
    nb = S // BLOCK
    bad = {"layout": np.ones((H + 1, nb, nb), bool),
           "incompatible": np.ones((H, 3, 3), bool)}
    empty_row = np.ones((H, nb, nb), bool)
    empty_row[1, 2] = False
    empty_col = np.ones((H, nb, nb), bool)
    empty_col[2, :, 5] = False
    bad["at least one active block"] = empty_row
    bad["k_block"] = empty_col
    for match, layout in bad.items():
        with pytest.raises(ValueError, match=match):
            bs.block_sparse_attention(q, q, q, layout)
        with pytest.raises(ValueError, match=match):
            jax_bs.block_sparse_attention(jnp.zeros((B, H, S, D)),
                                          jnp.zeros((B, H, S, D)),
                                          jnp.zeros((B, H, S, D)), layout)


def test_kernel_shape_checks_name_the_supported_set():
    """What the kernels take on the card: D = 64, blocks that are a
    multiple of 16 in [16, 256], bf16 or fp32."""
    q = torch.zeros((1, 2, 256, 64))
    bs._check(q, q, q, 128)
    with pytest.raises(ValueError, match=r"head dim 32 .* D in \(64,\)"):
        bs._check(q[..., :32], q[..., :32], q[..., :32], 128)
    with pytest.raises(ValueError, match="multiple of 16"):
        bs._check(q, q, q, 24)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        bs._check(*(q.half() for _ in range(3)), 128)


def test_block_lists_are_csr_and_csc_per_head():
    layout = LAYOUTS["fixed_per_head_4_patterns"][1]()
    lists = bs.block_lists(layout, "cpu")
    assert bs.block_lists(layout, "cpu") is lists  # cached per layout
    nq = layout.shape[1]
    for h in range(H):
        for i in range(nq):
            row = slice(*lists.row_ptr[h * nq + i:h * nq + i + 2].tolist())
            np.testing.assert_array_equal(lists.col_idx[row].numpy(),
                                          np.nonzero(layout[h, i])[0])
            col = slice(*lists.col_ptr[h * nq + i:h * nq + i + 2].tolist())
            np.testing.assert_array_equal(lists.row_idx[col].numpy(),
                                          np.nonzero(layout[h, :, i])[0])
    # head h's global columns move with h % 4: a kernel reading head 0's
    # lists for every head would give other outputs
    assert len({tuple(np.nonzero(layout[h, 0])[0]) for h in range(H)}) == 4


# the tensor-core kernels' routing, schedules and views: on the CPU, with
# the kernel library stubbed where a launch is reached
class _StubLib:
    """Stands in for a built kernel library: records each call's source,
    symbol, argument count and ctypes signature length (and, into
    ``seen``, its arguments), returns 0."""

    def __init__(self, calls, source, sigs, seen=None):
        self.calls, self.source, self.sigs = calls, source, sigs
        self.seen = seen

    def __getattr__(self, fn):
        def call(*args):
            self.calls.append((self.source, fn, len(args),
                               len(self.sigs[fn][0])))
            if self.seen is not None:
                self.seen.append(args)
            return 0
        return call


def _bthd_views(b, h, s, dtype, width=64):
    """q, k, v, dO as BERT hands them: ``[B, H, S, 64]`` views of
    ``[B, S, H, width]`` tensors (``width`` 65 breaks TMA's rule: token
    rows 130 bytes apart)."""
    return [torch.zeros((b, s, h, width), dtype=dtype)[..., :64]
            .transpose(1, 2) for _ in range(4)]


def _launch_with_stub(which, q, k, v, do, layout, seen=None):
    """The calls that launch ``which`` ("fwd", "dq" or "dkv") makes into
    a stub library (their arguments into ``seen``)."""
    calls = []
    lists = bs.block_lists(layout, "cpu")
    lse, delta = (torch.zeros(q.shape[:3]) for _ in range(2))
    with mock.patch.object(fa, "load", lambda src, sigs: _StubLib(
            calls, src, sigs, seen)), \
            mock.patch.object(bs, "_stream", lambda t: 0):
        if which == "fwd":
            bs._fwd_launch(q, k, v, lists.layout, lists.row_ptr,
                           lists.col_idx, lists.dq_order, 0.125)
        else:
            launch = bs._dq_launch if which == "dq" else bs._dkv_launch
            launch(q, k, v, do, lse, delta, lists, 0.125)
    return calls


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("dtype,block,suffix", [
    (torch.bfloat16, 128, "_sm90"), (torch.bfloat16, 64, "_sm90"),
    (torch.float32, 128, ""), (torch.bfloat16, 32, "")])
def test_backward_launch_reaches_its_kernel_symbol(which, dtype, block,
                                                   suffix):
    """Pins the routing rule: bf16 at a block that is a multiple of 64
    calls the tensor-core entry point, fp32 and bf16 at block 32 the
    CUDA-core one, with as many arguments as its ctypes signature and its
    C declaration have; the launch is counted either way."""
    s = 256
    layout = _random_layout(5, s // block)
    layout = np.broadcast_to(layout, (2, *layout.shape[1:])).copy()
    q, k, v, do = _bthd_views(1, 2, s, dtype)
    counter = (bs.block_sparse_backward_dq if which == "dq"
               else bs.block_sparse_backward_dkv)
    with mock.patch.object(counter, "launches", 0):
        calls = _launch_with_stub(which, q, k, v, do, layout)
        assert counter.launches == 1
    assert bs.tensor_cores(dtype, block) == (suffix == "_sm90")
    source = f"block_sparse_bwd_{which}{suffix}"
    n = len(bs._SIGS[source][0])
    assert calls == [(source, f"ds_{source}", n, n)]
    assert _c_arity(source) == n


@pytest.mark.parametrize("dtype,block,suffix", [
    (torch.bfloat16, 64, "_sm90"), (torch.bfloat16, 128, "_sm90"),
    (torch.bfloat16, 256, "_sm90"), (torch.float32, 128, ""),
    (torch.bfloat16, 32, "")])
def test_forward_launch_reaches_its_kernel_symbol(dtype, block, suffix):
    """The forward follows the backward's routing rule: bf16 at a block
    that is a multiple of 64 calls ``ds_block_sparse_fwd_sm90`` with the
    lists and the rows' longest-first schedule (``dq_order``) after O and
    lse, and the (batch, head, token) strides of q, k, v and O; fp32 and
    bf16 at block 32 call ``ds_block_sparse_fwd`` with the lists alone.
    As many arguments as the ctypes signature and the C declaration have;
    the launch is counted either way."""
    s = 512
    layout = _random_layout(7, s // block)
    layout = np.broadcast_to(layout, (2, *layout.shape[1:])).copy()
    q, k, v, _ = _bthd_views(1, 2, s, dtype)
    seen = []
    with mock.patch.object(bs.block_sparse_attention, "launches", 0):
        calls = _launch_with_stub("fwd", q, k, v, None, layout, seen)
        assert bs.block_sparse_attention.launches == 1
    assert bs.tensor_cores(dtype, block) == (suffix == "_sm90")
    source = f"block_sparse_fwd{suffix}"
    n = len(bs._SIGS[source][0])
    assert calls == [(source, f"ds_{source}", n, n)]
    assert _c_arity(source) == n
    lists = bs.block_lists(layout, "cpu")
    args = seen[0]
    assert args[5:7] == (lists.row_ptr.data_ptr(), lists.col_idx.data_ptr())
    if suffix:
        assert args[7] == lists.dq_order.data_ptr()
        assert args[8:14] == (1, 2, s, s, 64, block)
        # token rows of the [B, S, H, 64] views are H * 64 apart; the
        # batch dim of size 1 takes a row's stride in the tensor maps
        assert args[14:23] == (64, 64, 2 * 64) * 3
        assert args[23:26] == (s * 2 * 64, 64, 2 * 64)   # O in q's layout
    else:
        assert args[7:14] == (int(dtype == torch.bfloat16), 1, 2, s, s, 64,
                              block)


def test_forward_op_fake_gives_the_shapes():
    """``deepspeed_tpu_torch::block_sparse_fwd`` takes the schedule after
    the lists, and its fake (which traced and meta calls run) gives O in
    q's shape and dtype and lse ``[B, H, S]`` fp32."""
    op = torch.ops.deepspeed_tpu_torch.block_sparse_fwd.default
    assert [a.name for a in op._schema.arguments] == [
        "q", "k", "v", "layout", "row_ptr", "col_idx", "order", "scale"]
    q = torch.empty((2, 4, 256, 64), dtype=torch.bfloat16, device="meta")
    ints = torch.empty(9, dtype=torch.int32, device="meta")
    layout = torch.empty((4, 2, 2), dtype=torch.bool, device="meta")
    o, lse = op(q, q, q, layout, ints, ints, ints[:8], 0.125)
    assert (o.shape, o.dtype) == (q.shape, q.dtype)
    assert (lse.shape, lse.dtype) == ((2, 4, 256), torch.float32)


def _brute_force_order(layout, by):
    """The (head, block) pairs ``h * n + i`` sorted by walk length,
    longest first, ties by head then block, counted one by one."""
    h, nq, nk = layout.shape
    n = nq if by == "row" else nk
    length = {}
    for hh in range(h):
        for i in range(n):
            cells = layout[hh, i, :] if by == "row" else layout[hh, :, i]
            length[hh * n + i] = sum(bool(c) for c in cells)
    return sorted(length, key=lambda p: (-length[p], p)), length


@pytest.mark.parametrize("name", ["bert_slice", "bigbird"])
def test_schedules_are_longest_first(name):
    """``dq_order`` and ``dkv_order`` of the sparse BERT slice's layout
    (16 heads, 4096 tokens, block 128: every row 11 key blocks, 384
    columns of 4 query blocks and 128 global ones of 32) and of
    bench_sparse.py's BigBird layout (12 heads, 8192 tokens, block 256):
    each a permutation of every (head, block) pair, lengths not
    increasing along it, equal to a brute-force count."""
    if name == "bert_slice":
        section, heads, seq = dict(BERT_SPARSE), 16, 4096
    else:
        section, heads, seq = {
            "mode": "bigbird", "block": 256, "num_random_blocks": 1,
            "num_sliding_window_blocks": 3, "num_global_blocks": 1,
            "attention": "bidirectional"}, 12, 8192
    layout = sc.sparsity_config_from_dict(section, heads).make_layout(
        seq).astype(bool)
    lists = bs.block_lists(layout, "cpu")
    for order, by in ((lists.dq_order, "row"), (lists.dkv_order, "col")):
        want, length = _brute_force_order(layout, by)
        got = order.tolist()
        assert order.dtype == torch.int32
        assert sorted(got) == list(range(len(length)))
        lengths = [length[p] for p in got]
        assert all(a >= b for a, b in zip(lengths, lengths[1:]))
        assert got == want
    if name == "bert_slice":
        assert set(layout.sum(axis=2).ravel()) == {11}
        cols = layout.sum(axis=1).ravel()
        assert (cols == 4).sum() == 384 and (cols == 32).sum() == 128
        # the global columns come first
        assert [length for length in
                np.diff(lists.col_ptr.numpy())[lists.dkv_order[:128]]] == \
            [32] * 128


def _cotangents_seen(q, k, v, do, layout):
    """dO as :class:`BlockSparseAttentionFunction`'s backward hands it to
    the dQ and dK/dV wrappers (stubbed to return zeros)."""
    seen = []

    def dq(q_, k_, v_, do_, *rest):
        seen.append(do_)
        return torch.zeros_like(q_)

    def dkv(q_, k_, v_, do_, *rest):
        seen.append(do_)
        return torch.zeros_like(k_), torch.zeros_like(v_)

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with mock.patch.object(bs, "_backward_dq", dq), \
            mock.patch.object(bs, "_backward_dkv", dkv):
        bs.block_sparse_attention(*leaves, layout).backward(do)
    assert len(seen) == 2
    return seen


@pytest.mark.parametrize("block,width,copied", [
    (128, 65, True), (128, 64, False), (32, 65, False)])
def test_cotangent_copied_where_tma_cannot_read_it(block, width, copied):
    """A bf16 dO view that breaks TMA's rule (token rows 130 bytes apart)
    is copied to a readable one before the tensor-core launches, with the
    same values; one that keeps the rule, or one bound for the CUDA-core
    kernels (block 32), reaches them as it is."""
    s = 256
    layout = np.ones((2, s // block, s // block), bool)
    rng = np.random.default_rng(3)
    q, k, v, do = (t.copy_(torch.from_numpy(
        rng.standard_normal(t.shape).astype(np.float32)))
        for t in _bthd_views(1, 2, s, torch.bfloat16, width))
    for got in _cotangents_seen(q, k, v, do, layout):
        assert (got.data_ptr() != do.data_ptr()) == copied
        torch.testing.assert_close(got, do, rtol=0, atol=0)
        if bs.tensor_cores(got.dtype, block):
            assert tma_view_error(got.shape, got.stride(),
                                  got.element_size(),
                                  got.data_ptr()) is None


@pytest.mark.parametrize("which", ["dq", "dkv", "fwd"])
def test_tma_breaking_q_view_raises_on_the_tensor_core_route(which):
    """A bf16 q view whose token rows are 130 bytes apart cannot be read
    through a tensor map: the tensor-core launch (forward or backward)
    refuses it with ValueError before any call; the CUDA-core route (fp32)
    takes the same view."""
    layout = np.ones((2, 2, 2), bool)
    q, *_ = _bthd_views(1, 2, 256, torch.bfloat16, width=65)
    k, v, do = _bthd_views(1, 2, 256, torch.bfloat16)[1:]
    with pytest.raises(ValueError, match=r"TMA.*q view"):
        _launch_with_stub(which, q, k, v, do, layout)
    q, *_ = _bthd_views(1, 2, 256, torch.float32, width=65)
    k, v, do = _bthd_views(1, 2, 256, torch.float32)[1:]
    assert len(_launch_with_stub(which, q, k, v, do, layout)) == 1


def test_self_attention_validation_like_jax():
    port = SparseSelfAttention(sc.FixedSparsityConfig(num_heads=H,
                                                      block=BLOCK),
                               max_seq_length=S)
    x = torch.zeros((B, H, 2 * S, D))
    with pytest.raises(ValueError, match="max_seq_length"):
        port(x, x, x)
    x = torch.zeros((B, H, S - 8, D))
    with pytest.raises(ValueError, match="divisible by block"):
        port(x, x, x)
    for kw in ({"key_padding_mask_mode": "x"}, {"attn_mask_mode": "x"}):
        with pytest.raises(ValueError, match="must be 'add' or 'mul'"):
            SparseSelfAttention(**kw)


def test_utils_pad_unpad_extend_match_jax():
    rng = np.random.default_rng(6)
    ids = rng.integers(1, 50, (2, 45)).astype(np.int64)
    mask = np.ones((2, 45), np.int64)
    pos = np.tile(np.arange(45), (2, 1))
    emb_table = rng.standard_normal((50, 8)).astype(np.float32)
    embeds = emb_table[ids]
    got = SparseAttentionUtils.pad_to_block_size(
        16, torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(mask * 0), torch.from_numpy(pos),
        torch.from_numpy(embeds), pad_token_id=3,
        model_embeddings=lambda i: torch.from_numpy(emb_table)[i])
    want = JaxUtils.pad_to_block_size(
        16, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(mask * 0),
        jnp.asarray(pos), jnp.asarray(embeds), pad_token_id=3,
        model_embeddings=lambda i: jnp.asarray(emb_table)[i])
    assert got[0] == want[0] == 3
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    seq = torch.arange(2 * 48 * 3).reshape(2, 48, 3)
    np.testing.assert_array_equal(
        SparseAttentionUtils.unpad_sequence_output(3, seq).numpy(),
        np.asarray(JaxUtils.unpad_sequence_output(3, jnp.asarray(
            seq.numpy()))))
    table = rng.standard_normal((10, 4)).astype(np.float32)
    for n in (7, 25):
        np.testing.assert_array_equal(
            SparseAttentionUtils.extend_position_embedding(
                torch.from_numpy(table), n).numpy(),
            np.asarray(JaxUtils.extend_position_embedding(table, n)))


@pytest.mark.parametrize("how", ["dict", "instance"])
def test_utils_patch_model_matches_jax(how):
    """The patcher on the port's BERT gives the JAX patcher's config and
    retiled position table, and keeps every other weight."""
    jcfg = jax_bert.BertConfig.tiny(dtype=jnp.float32)
    jmodel = jax_bert.BertForTraining(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32)))
    pcfg = port_bert.BertConfig.tiny(dtype=torch.float32)
    pmodel = port_bert.BertForTraining(pcfg, device="meta")
    pmodel.model.load_state_dict(bert_params_from_jax(params, pcfg),
                                 assign=True)
    if how == "dict":
        section, jsection = ({"mode": "bigbird", "block": 16},) * 2
    else:
        section = sc.BigBirdSparsityConfig(num_heads=4, block=16)
        jsection = jax_sc.BigBirdSparsityConfig(num_heads=4, block=16)
    patched = SparseAttentionUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            pmodel, 160, section)
    jpatched, jparams = JaxUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            jmodel, 160, jsection, params=params)
    assert patched.config.sparse_attention == \
        jpatched.config.sparse_attention
    assert patched.config.max_position_embeddings == 160
    want = bert_params_from_jax(jax.device_get(jparams), pcfg)
    got = patched.model.state_dict()
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w.numpy(), name)
    assert got["bert.position_embeddings"].shape[0] == 160
    assert patched.model.bert.word_embeddings is \
        pmodel.model.bert.word_embeddings
    with pytest.raises(ValueError, match="no sparse_attention field"):
        SparseAttentionUtils.\
            replace_model_self_attention_with_sparse_self_attention(
                torch.nn.Linear(2, 2), 64)


def test_exports_mirror_the_jax_package():
    import deepspeed_tpu.ops.sparse_attention as jax_pkg
    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.ops.sparse_attention as port_pkg

    assert port_pkg.__all__ == jax_pkg.__all__
    assert all(hasattr(port_pkg, name) for name in port_pkg.__all__)
    assert deepspeed_tpu_torch.SparseSelfAttention is SparseSelfAttention
    assert deepspeed_tpu_torch.SparseAttentionUtils is SparseAttentionUtils
    with pytest.raises(AttributeError):
        deepspeed_tpu_torch.NotAThing  # noqa: B018
