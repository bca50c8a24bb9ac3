"""Device time of one append-cache decode call (``decode_attention``, the
kernel ``csrc/decode_append.cu``) at the shapes ``InferenceEngine.generate``
gives it on GPT-2 125M: batch 2, 12 heads of 64, a cache of
``n_positions`` = 1024 rows, one query row, the cache index at the
prompt's end and on (128 to 159 for a 128-token prompt and 32 new
tokens), and at the kernel's timed shape (index 1000).

    python -m deepspeed_tpu_torch.tools.time_decode [--idx N ...]
        [--batch B] [--heads H] [--head-dim D] [--cache S] [--tq T]
        [--dtype bfloat16|float32] [--min-split-keys N ...]
        [--repeats N] [--seed N] [--out F]

It calls only the public ``decode_attention(q, k_cache, v_cache,
cache_index)``, so the same file times the kernel of any commit that has
that function. ``--min-split-keys`` sweeps the least number of keys a
split of the cache takes (the module's ``MIN_SPLIT_KEYS``, which sizes
the grid and which the kernel takes as an argument); without it the
module's own value is timed. Each time is the mean of ``--repeats``
calls that the host queued behind a device spin, so the card runs them
back to back; each case is also checked against the plain version
(``decode_attention_reference``). Prints one JSON object. Needs a card.
"""

import argparse
import json
import subprocess

import torch

from deepspeed_tpu_torch.ops import decode_attention as da

SPIN_CYCLES = 50_000_000


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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    parser.add_argument("--repeats", type=int, default=400)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_decode needs a CUDA card")

    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    shape = (args.batch, args.cache, args.heads, args.head_dim)
    kc, vc = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    q = torch.randn((args.batch, args.tq, args.heads, args.head_dim),
                    generator=gen, device="cuda").to(dtype)
    sweep = args.min_split_keys or [getattr(da, "MIN_SPLIT_KEYS", None)]
    rows = []
    for min_keys in sweep:
        if min_keys is not None:
            da.MIN_SPLIT_KEYS = min_keys
        for idx in args.idx:
            index = torch.tensor(idx, dtype=torch.int32, device="cuda")
            got = da.decode_attention(q, kc, vc, index)
            want = da.decode_attention_reference(q, kc, vc, index)
            err = (got.float() - want.float()).abs().max().item()
            rows.append({
                "min_split_keys": min_keys, "idx": idx, "max_abs_err": err,
                "ms": device_ms(lambda: da.decode_attention(q, kc, vc, index),
                                args.repeats)})
    result = {"card": card(), "shape": {
        "B": args.batch, "H": args.heads, "D": args.head_dim,
        "S": args.cache, "T_q": args.tq, "dtype": args.dtype},
        "repeats": args.repeats, "rows": rows}
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
