"""Device time of the decode kernels at the shapes their paths give them
(GPT-2 125M: 12 heads of 64, bf16).

    python -m deepspeed_tpu_torch.tools.time_decode [--idx N ...]
        [--batch B] [--heads H] [--head-dim D] [--cache S] [--tq T]
        [--dtype bfloat16|float32] [--min-split-keys N ...]
        [--repeats N] [--seed N] [--out F]
    python -m deepspeed_tpu_torch.tools.time_decode --paged [...]
    python -m deepspeed_tpu_torch.tools.time_decode --int8
        [--tc-min-rows N ...] [--chunk-rows T ...] [...]

Without a mode: one append-cache decode call (``decode_attention``, the
kernel ``csrc/decode_append.cu``) at the shapes ``InferenceEngine.
generate`` gives it: batch 2, a cache of ``n_positions`` = 1024 rows, one
query row, the cache index at the prompt's end and on (128 to 159 for a
128-token prompt and 32 new tokens), and at the kernel's timed shape
(index 1000).

``--paged``: ``decode_attention_paged`` (bf16 pools, block 16, 64 blocks
a row) at serving's decode steps (4 slots of its 8-900-token prompts
plus up to 32 new tokens, lengths 8-932), the fast path's leg B verify
steps (4 slots, T_q = 5, its ~200-token tiled prompts) and
``chip_smoke.py``'s timed shapes. ``--int8``:
``decode_attention_paged_int8`` (int8 pools, fp32 scales) at leg A's
decode steps (8 slots) and every length its 256-row prefill chunks start
at, and the timed shapes;
``--chunk-rows`` adds chunks of those many rows after the system prompt
and ``--tc-min-rows`` sweeps the module's ``TC_MIN_ROWS`` (the rows from
which a bf16 chunk runs on the tensor cores), to find the crossover.

It calls only the public functions, so the same file times the kernels
of any commit that has them (``PYTHONPATH`` naming that commit's
checkout). ``--min-split-keys`` sweeps the least number of keys a split
of the cache takes (the module's ``MIN_SPLIT_KEYS``, or in the paged
modes ``PAGED_MIN_SPLIT_KEYS`` where it has one, which sizes the grid and
which the kernels take as an argument); without it the module's own
value is timed. Each time is the mean of ``--repeats`` calls that the
host queued behind a device spin, so the card runs them back to back;
each case is also checked against the plain version, and its output's
hash printed, so two commits' results can be compared bit for bit.
Prints one JSON object. Needs a card.
"""

import argparse
import hashlib
import json
import subprocess

import numpy as np
import torch

from deepspeed_tpu_torch.ops import decode_attention as da

SPIN_CYCLES = 50_000_000
# paged workloads: (name, [(lengths, T_q), ...]) at block 16, 64 blocks a
# row. Serving (tools/profile_serving.py SERVING): its first four
# prompts, its last four, and those four 31 tokens later. Leg B
# (chip_smoke.py SPEC_SERVING): 4 slots of 200-208-token prompts halfway
# through 32 new tokens. Leg A (profile_serving.py FAST_SERVING): 8 slots
# of its prompts (384-token system prompt + tails) halfway through, then
# the lengths its chunks start at: the serving engine pads every chunk
# step to the 256-row chunk, so each is a 256-row call (the first prompt's
# at 0 and 256, the others' after the 384 cached tokens and on, one
# copied-on-write prompt's after 392)
SERVING_DECODE = ([8, 40, 100, 230], [400, 555, 720, 900],
                  [431, 586, 751, 931])
LEG_B_VERIFY = ([217, 216, 216, 224],)
LEG_A_DECODE = ([408, 440, 500, 630, 800, 955, 411, 445],)
LEG_A_CHUNKS = ((0, 256), (256, 256), (384, 256), (392, 256), (640, 256),
                (896, 256))
TIMED = ((([0, 137, 602, 1000], 1), ([0, 137, 602, 1019], 5),
          ([512], 256)))
BLOCK, MAX_BLOCKS = 16, 64


def device_ms(fn, repeats):
    """Mean device time of one ``fn()`` call, the calls queued behind a
    spin (``torch.cuda._sleep``); with a longer spin where the host had
    not queued them all before the spin ended."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / repeats
        spin *= 4
    raise RuntimeError(f"the host could not queue {repeats} calls within a "
                       f"spin of {spin // 4} cycles")


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def digest(t):
    """The first 16 hex digits of the sha256 of ``t``'s bytes."""
    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def sweep(values, name):
    """Each value of the sweep set on the module (where it has ``name``),
    or the module's own value once."""
    for value in values or [getattr(da, name, None)]:
        if value is not None and hasattr(da, name):
            setattr(da, name, value)
        yield value


def time_append(args, dtype, gen):
    shape = (args.batch, args.cache, args.heads, args.head_dim)
    kc, vc = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    q = torch.randn((args.batch, args.tq, args.heads, args.head_dim),
                    generator=gen, device="cuda").to(dtype)
    rows = []
    for min_keys in sweep(args.min_split_keys, "MIN_SPLIT_KEYS"):
        for idx in args.idx:
            index = torch.tensor(idx, dtype=torch.int32, device="cuda")
            got = da.decode_attention(q, kc, vc, index)
            want = da.decode_attention_reference(q, kc, vc, index)
            err = (got.float() - want.float()).abs().max().item()
            rows.append({
                "min_split_keys": min_keys, "idx": idx, "max_abs_err": err,
                "sha": digest(got),
                "ms": device_ms(lambda: da.decode_attention(q, kc, vc,
                                                            index),
                                args.repeats)})
    return {"B": args.batch, "H": args.heads, "D": args.head_dim,
            "S": args.cache, "T_q": args.tq}, rows


def paged_cases(int8, chunk_rows):
    """(workload, lengths, T_q) of the mode's paged calls."""
    if int8:
        cases = [("leg_a_decode", ln, 1) for ln in LEG_A_DECODE]
        cases += [("leg_a_chunk", [ln], tq) for ln, tq in LEG_A_CHUNKS]
        cases += [("chunk_rows", [384], tq) for tq in chunk_rows]
    else:
        cases = [("serving_decode", ln, 1) for ln in SERVING_DECODE]
        cases += [("leg_b_verify", ln, 5) for ln in LEG_B_VERIFY]
    return cases + [("timed", ln, tq) for ln, tq in TIMED]


def time_paged(args, dtype, gen, int8):
    from deepspeed_tpu_torch.ops.quantizer import quantize_rowwise

    kernel, plain = ((da.decode_attention_paged_int8,
                      da.decode_attention_paged_int8_reference) if int8 else
                     (da.decode_attention_paged,
                      da.decode_attention_paged_reference))
    h, d = args.heads, args.head_dim
    nb = 1 + 8 * MAX_BLOCKS
    k, v = (torch.randn((nb, BLOCK, h, d), generator=gen, device="cuda")
            for _ in range(2))
    if int8:
        (kp, ks), (vp, vs) = quantize_rowwise(k), quantize_rowwise(v)
        pools = (kp, vp, ks, vs)
    else:
        pools = (k.to(dtype), v.to(dtype))
    rng = np.random.default_rng(args.seed)
    # the paged kernels' own least keys a split, where the module has one
    min_name = ("PAGED_MIN_SPLIT_KEYS" if hasattr(da, "PAGED_MIN_SPLIT_KEYS")
                else "MIN_SPLIT_KEYS")
    rows = []
    for workload, lengths, tq in paged_cases(int8, args.chunk_rows or []):
        tables = np.full((len(lengths), MAX_BLOCKS), da.GARBAGE_BLOCK,
                         np.int32)
        free = list(rng.permutation(np.arange(1, nb)))
        for b, ln in enumerate(lengths):
            # a chunk's pad rows may run past the table, as in the engine
            need = min(-(-(ln + tq) // BLOCK), MAX_BLOCKS)
            tables[b, :need] = [free.pop() for _ in range(need)]
        tables = torch.tensor(tables, device="cuda")
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = torch.randn((len(lengths), tq, h, d), generator=gen,
                        device="cuda").to(dtype)
        call = (q, *pools, tables, lens)
        for tc_rows in (sweep(args.tc_min_rows, "TC_MIN_ROWS") if int8
                        else [None]):
            for min_keys in sweep(args.min_split_keys, min_name):
                before = dict(getattr(kernel, "source_launches", {}))
                got = kernel(*call)
                ran = [s for s, n in getattr(kernel, "source_launches",
                                             {}).items()
                       if n != before.get(s, 0)]
                want = plain(*call)
                rows.append({
                    "workload": workload, "lengths": lengths, "T_q": tq,
                    "tc_min_rows": tc_rows, "min_split_keys": min_keys,
                    "source": ran[0] if ran else None,
                    "max_abs_err": (got.float() - want.float()).abs()
                    .max().item(),
                    "sha": digest(got),
                    "ms": device_ms(lambda: kernel(*call), args.repeats)})
    return {"H": h, "D": d, "block_size": BLOCK, "max_blocks": MAX_BLOCKS,
            "pool_blocks": nb, "int8": int8}, rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--paged", action="store_true")
    mode.add_argument("--int8", action="store_true")
    parser.add_argument("--idx", type=int, nargs="+",
                        default=[0, 128, 144, 159, 255, 511, 1000])
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--heads", type=int, default=12)
    parser.add_argument("--head-dim", type=int, default=64)
    parser.add_argument("--cache", type=int, default=1024)
    parser.add_argument("--tq", type=int, default=1)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32"))
    parser.add_argument("--min-split-keys", type=int, nargs="+")
    parser.add_argument("--tc-min-rows", type=int, nargs="+")
    parser.add_argument("--chunk-rows", type=int, nargs="+")
    parser.add_argument("--repeats", type=int, default=400)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_decode needs a CUDA card")

    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.paged or args.int8:
        shape, rows = time_paged(args, dtype, gen, args.int8)
    else:
        shape, rows = time_append(args, dtype, gen)
    result = {"card": card(), "mode": ("int8" if args.int8 else "paged"
                                       if args.paged else "append"),
              "shape": {**shape, "dtype": args.dtype},
              "repeats": args.repeats, "rows": rows}
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
