"""The port's stochastic int8 quantizer against the JAX package's Pallas
kernel ``stochastic_quantize_tpu``.

In interpret mode on the CPU the Pallas kernel's PRNG draws all-zero
bits, so there its codes are ``floor(x / scale)``: the port's plain
version with ``u = 0`` must give the same codes and scale bit for bit on
the same numpy inputs. The port's own draw is Philox4x32-10 written out
in torch (the CUDA kernel computes the same words, held bit for bit on
the card by ``chip_smoke.py``): it is held to Random123's known-answer
vectors and to a pure-Python integer Philox, and the drawn quantizer to
stochastic rounding's contract (floor or floor + 1, unbiased).
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.quantizer import stochastic_quantize_tpu
from deepspeed_tpu.utils.compat import tpu_interpret_mode
from deepspeed_tpu_torch.ops import quantizer as qz
from deepspeed_tpu_torch.ops.quantizer import (philox4x32_10,
                                               stochastic_quantize,
                                               stochastic_quantize_reference,
                                               stochastic_uniforms)
from tests.test_torch_ops import _c_arity

MASK = 0xFFFFFFFF


def _inputs(name):
    rng = np.random.default_rng(11)
    if name == "64x256":
        return rng.normal(size=(64, 256)).astype(np.float32)
    if name == "1000x3":
        return (rng.normal(size=(1000, 3)) * 1e-3).astype(np.float32)
    if name == "exact_absmax":  # ±absmax land on ±127 exactly
        x = rng.uniform(-2.0, 2.0, size=(32, 48)).astype(np.float32)
        x[3, 5], x[17, 40] = 2.5, -2.5
        return x
    if name == "nan":  # max|x| is NaN: so is the scale, and every code 0
        x = rng.normal(size=(16, 24)).astype(np.float32)
        x[4, 9] = np.nan
        return x
    return np.zeros((16, 24), np.float32)


@pytest.mark.parametrize("name", ["64x256", "1000x3", "exact_absmax",
                                  "zeros", "nan"])
def test_plain_version_matches_pallas_bit_for_bit(name):
    x = _inputs(name)
    with tpu_interpret_mode():
        ref_q, ref_scale = stochastic_quantize_tpu(jnp.asarray(x), seed=3)
    xt = torch.from_numpy(x)
    q, scale = stochastic_quantize_reference(xt, 3, u=torch.zeros_like(xt))
    assert q.dtype == torch.int8 and q.shape == xt.shape
    assert scale.dtype == torch.float32 and scale.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    if name == "nan":
        assert np.isnan(np.asarray(ref_scale)) and scale.isnan()
        assert not q.any()
    else:
        assert scale.numpy().tobytes() == np.asarray(ref_scale).tobytes()
    if name == "zeros":
        assert float(scale) == 1.0 and not q.any()
    if name == "exact_absmax":
        assert q.max() == 127 and q.min() == -127


def _philox_int(ctr, key):
    """Philox4x32-10 in Python integers (Salmon et al. 2011)."""
    c, (k0, k1) = list(ctr), key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & MASK, (p0 >> 32) ^ c[3] ^ k1,
             p0 & MASK]
        k0, k1 = (k0 + 0x9E3779B9) & MASK, (k1 + 0xBB67AE85) & MASK
    return c


def _philox_torch(ctrs, key):
    cols = torch.tensor(ctrs, dtype=torch.int64).T
    return torch.stack(philox4x32_10(*cols, *key), dim=1).tolist()


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((MASK,) * 4, (MASK, MASK),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for philox4x32_10."""
    assert tuple(_philox_torch([ctr], key)[0]) == want
    assert tuple(_philox_int(ctr, key)) == want


def test_philox_matches_integer_philox():
    rng = np.random.default_rng(5)
    ctrs = [tuple(int(w) for w in row)
            for row in rng.integers(0, 2 ** 32, size=(300, 4))]
    for key in ((0, 0), (7, 0), (int(rng.integers(2 ** 32)),
                                 int(rng.integers(2 ** 32)))):
        assert _philox_torch(ctrs, key) == [_philox_int(c, key)
                                            for c in ctrs]


def test_uniforms_follow_the_counter_layout():
    """Element i takes word i & 3 of the counter (i >> 2, 0, 0, 0) under
    the key (seed, 0), its top 24 bits times 2^-24."""
    u = stochastic_uniforms(10, 9)
    for i in (0, 1, 3, 4, 9):
        word = _philox_int((i >> 2, 0, 0, 0), (9, 0))[i & 3]
        assert u[i].item() == (word >> 8) * 2.0 ** -24


def test_drawn_codes_round_stochastically():
    x = torch.from_numpy(_inputs("64x256"))
    q, scale = stochastic_quantize(x, 21)  # a CPU tensor: the plain version
    lo = torch.floor(x / scale)
    assert ((q == lo) | (q == lo + 1)).all()
    assert (q == lo + 1).any() and (q == lo).any()
    q2, scale2 = stochastic_quantize(x, 21)
    assert torch.equal(q, q2) and torch.equal(scale, scale2)
    assert not torch.equal(q, stochastic_quantize(x, 22)[0])


def test_drawn_codes_of_a_nan_input_are_zero():
    """A NaN anywhere makes the drawn path's scale NaN and every code 0,
    whatever u adds (the CUDA kernel is held to this on the card)."""
    x = torch.from_numpy(_inputs("nan"))
    q, scale = stochastic_quantize(x, 21)
    assert scale.isnan() and not q.any()


def test_drawn_codes_are_unbiased():
    """Over 256 seeds the mean of q * scale is within 5 sigma of x, sigma
    the standard error of stochastic rounding (at least one draw's step)."""
    x = torch.from_numpy(_inputs("1000x3")[:256])
    n = 256
    total = torch.zeros_like(x)
    for seed in range(n):
        q, scale = stochastic_quantize(x, seed)
        total += q.float() * scale
    frac = x / scale - torch.floor(x / scale)
    var = torch.clamp(frac * (1 - frac), min=1.0 / n)
    sigma = scale * torch.sqrt(var / n)
    assert ((total / n - x).abs() <= 5 * sigma).all()


def test_errors():
    x = torch.zeros(4, 4)
    with pytest.raises(NotImplementedError):
        stochastic_quantize(x, 0, num_bits=4)
    with pytest.raises(ValueError, match="fp32"):
        stochastic_quantize(x.to(torch.bfloat16), 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        stochastic_quantize(torch.empty(4, device="meta"), 0)


def test_launch_is_one_cooperative_call_with_its_workspace():
    """``launch_passes`` (what :func:`stochastic_quantize` runs for a CUDA
    tensor) on CPU tensors with ``load`` patched to a stub library: the
    grid is queried once a device, every call is one ``ds_stochastic_
    quantize`` with as many arguments as its ctypes signature and its C
    declaration, a workspace of two fp32 slots a CTA (nothing zeroed)
    and the grid, and counts one launch; a failed launch raises and counts
    none."""
    calls = []

    class Lib:
        err = 0

        def ds_stochastic_quantize_grid(self, blocks):
            calls.append(("grid",))
            blocks._obj.value = 132
            return 0

        def ds_stochastic_quantize(self, *args):
            calls.append(args)
            return self.err

    lib = Lib()
    x = torch.randn(3072, 768)
    q = torch.empty(x.shape, dtype=torch.int8)
    scale = torch.empty(())
    with mock.patch.object(qz, "load", lambda src, sigs: lib), \
            mock.patch.object(qz, "_stream", lambda t: 5), \
            mock.patch.object(torch.cuda, "device",
                              lambda dev: mock.MagicMock()), \
            mock.patch.object(qz, "_GRID", {}), \
            mock.patch.object(torch, "empty", wraps=torch.empty) as empty, \
            mock.patch.object(stochastic_quantize, "launches", 0):
        qz.launch_passes(x, q, scale, 7, 3)
        assert empty.call_args_list[0] == mock.call(
            264, dtype=torch.float32, device=x.device)
        qz.launch_passes(x, q, scale, (1 << 32) + 9, 2)
        assert stochastic_quantize.launches == 2
        lib.err = 700
        with pytest.raises(RuntimeError, match="error 700"):
            qz.launch_passes(x, q, scale, 7, 3)
        assert stochastic_quantize.launches == 2
    assert calls[0] == ("grid",) and len(calls) == 4
    n = len(qz._SIG["ds_stochastic_quantize"][0])
    assert _c_arity("stochastic_quantize") == n
    for args, seed, passes in ((calls[1], 7, 3), (calls[2], 9, 2)):
        assert len(args) == n
        assert args[:3] == (x.data_ptr(), q.data_ptr(), scale.data_ptr())
        assert args[4:] == (x.numel(), seed, passes, 132, 5)
