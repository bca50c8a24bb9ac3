"""Keyed, batch-invariant next-token sampling (counterpart of
``deepspeed_tpu/ops/sampling.py``).

The token emitted at absolute position P of a request with seed S is a
pure function of ``(S, P, the logits row)``: the row's key is
``fold_in(PRNGKey(S), P)`` of JAX's threefry2x32 PRNG, its logits are
filtered by temperature, top-k and top-p, and one categorical draw takes
the argmax of the filtered logits plus gumbel noise from the key's
random bits. No sampler state exists beside the position, so a sampled
stream is the same whatever slot, batch mix or replay serves it, and the
same as the JAX package's on the same logits.

Everything here mirrors jax 0.9.0's own definitions bit for bit
(``jax/_src/prng.py``, ``jax/_src/random.py``): threefry2x32's 20
rounds, ``threefry_seed``, the fold-in, the partitionable random bits
(``bits1 ^ bits2`` of the hash of each element's 64-bit flat index),
``uniform`` on ``[tiny, 1)``, the "low" gumbel and the gumbel-max
categorical. uint32 words are int64 tensors masked to 32 bits. The
JAX package computes this in XLA, not in a Pallas kernel, so there is no
TPU kernel to port: the same plain PyTorch runs on the CPU and the card.
Greedy rows (``flags == 0``) take the float32 argmax, the first maximal
index, as ``inference.engine.sample_logits`` does, so a mixed batch never
perturbs its greedy members.
"""

import numpy as np
import torch

__all__ = ["threefry_2x32", "threefry_seed", "fold_in_key", "random_bits",
           "uniform", "gumbel", "keyed_filter_logits", "keyed_sample"]

_MASK = 0xFFFFFFFF
# threefry2x32 (Salmon et al. 2011; jax/_src/prng.py:883): rotation
# constants of the two round groups and the key-schedule parity word
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
# float32's smallest normal number: uniform's minval in the "low" gumbel
TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(k1, k2, x0, x1):
    """threefry2x32 of the counter words ``(x0, x1)`` under the key
    ``(k1, k2)``: int64 tensors (or ints) holding uint32 values, which
    broadcast. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x0, x1 = (x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def threefry_seed(seed):
    """The raw key of an integer seed, ``(seed >> 32, seed & 0xFFFFFFFF)``
    (``prng.py:802``): ``PRNGKey(s)`` of a 32-bit seed is ``(0, s)``."""
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in_key(seed, position):
    """The per-token key ``fold_in(PRNGKey(seed), position)`` as an int64
    tensor ``[..., 2]``: threefry2x32 of the counter ``threefry_seed(
    position)`` under the key ``PRNGKey(seed)``. ``seed`` and
    ``position`` are ints or int64 tensors that broadcast; both are taken
    as uint32, as the JAX package passes them."""
    seed = torch.as_tensor(seed, dtype=torch.int64) & _MASK
    position = torch.as_tensor(position, dtype=torch.int64,
                               device=seed.device) & _MASK
    k1, k2 = threefry_seed(seed)
    c1, c2 = threefry_seed(position)
    return torch.stack(threefry_2x32(k1, k2, c1, c2), dim=-1)


def random_bits(key, n: int):
    """32 random bits for each of ``n`` elements under each key of ``key``
    (``[..., 2]``): ``[..., n]``, the partitionable lowering
    (``prng.py:1184``): element i hashes the counter ``(i >> 32, i &
    0xFFFFFFFF)`` and its bits are the two output words XORed."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry_2x32(key[..., :1], key[..., 1:], i >> 32, i & _MASK)
    return b1 ^ b2


def uniform(bits):
    """fp32 uniforms on ``[tiny, 1)`` from 32 random bits (``random.py:
    _uniform`` with ``minval = tiny``): the top 23 bits fill the mantissa
    of a float in [1, 2), less 1, scaled by ``maxval - minval`` (which
    rounds to 1 in fp32, so the scaling is exact and left out) and
    shifted by ``tiny``."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min((one - 1.0) + TINY, TINY)


def gumbel(u):
    """The "low" gumbel of uniforms ``u`` (``random.py:1735``)."""
    return -torch.log(-torch.log(u))


def keyed_filter_logits(logits, temperature, top_k, top_p):
    """Temperature, top-k and top-p filtering of logits rows ``[N, V]``
    with per-row knobs ``[N]`` (``sampling.py:46``): fp32, divided by
    ``max(temperature, 1e-6)``; top-k keeps what is not below the kth
    largest value (``top_k <= 0`` keeps all); top-p keeps the smallest
    prefix of the sorted distribution whose mass reaches ``top_p``, the
    first token past it included (``top_p <= 0`` keeps every token of
    nonzero probability). Filtered entries become ``-inf``."""
    dev = logits.device
    logits = logits.float()
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev).reshape(-1, 1)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev).reshape(
        -1, 1)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev).reshape(
        -1, 1)
    v = logits.shape[-1]
    neg_inf = torch.tensor(float("-inf"), device=dev)
    logits = logits / torch.clamp_min(temperature, 1e-6)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1, torch.clamp(top_k - 1, 0, v - 1))
    kth = torch.where(top_k > 0, kth, neg_inf)
    logits = torch.where(logits < kth, neg_inf, logits)
    p = torch.where(top_p > 0.0, top_p, torch.ones_like(top_p))
    sorted2 = torch.sort(logits, dim=-1, descending=True).values
    # jax.nn.softmax's formula: exp(x - max) / sum (torch.softmax scales
    # by the sum's reciprocal, another rounding)
    e = torch.exp(sorted2 - sorted2[..., :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < p
    cutoff = torch.where(keep, sorted2, torch.tensor(
        float("inf"), device=dev)).amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, neg_inf, logits)


def keyed_sample(logits, seeds, positions, flags, temperatures, top_ks,
                 top_ps):
    """Batch keyed sampling (``sampling.py:91``): ``logits [N, V]``, every
    other argument ``[N]`` on the host (numpy or lists). Row i with
    ``flags[i] > 0`` draws a categorical over its filtered logits from
    ``fold_in_key(seeds[i], positions[i])``; a row with ``flags[i] == 0``
    is the fp32 argmax. The draw runs only for the flagged rows, and not
    at all when none is. Returns int64 ``[N]`` on ``logits``' device."""
    logits = logits.float()
    tokens = torch.argmax(logits, dim=-1)
    rows = np.flatnonzero(np.asarray(flags).reshape(-1) > 0)
    if rows.size == 0:
        return tokens
    dev = logits.device

    def pick(values, dtype):
        return torch.as_tensor(
            np.asarray(values).reshape(-1)[rows], device=dev).to(dtype)

    sel = torch.as_tensor(rows, device=dev)
    key = fold_in_key(pick(np.asarray(seeds, np.int64) & _MASK, torch.int64),
                      pick(np.asarray(positions, np.int64), torch.int64))
    filtered = keyed_filter_logits(
        logits[sel], pick(temperatures, torch.float32),
        pick(top_ks, torch.int64), pick(top_ps, torch.float32))
    noise = gumbel(uniform(random_bits(key, logits.shape[-1])))
    tokens[sel] = torch.argmax(noise + filtered, dim=-1)
    return tokens
