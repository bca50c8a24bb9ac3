"""Device time of the stochastic int8 quantizer (TPU kernel 13,
``csrc/stochastic_quantize.cu``) at GPT-2 125M's gradient shapes, fp32.

    python -m deepspeed_tpu_torch.tools.time_quantize [--shapes R,C ...]
        [--profile] [--passes] [--repeats N] [--seed N] [--out F]

Each shape is timed warm and cold. Warm: one input, quantized again and
again, so an input smaller than the card's 50 MB L2 is read from L2.
Cold: the calls rotate over as many copies of the input as exceed
100 MB together, so each call finds its input in device memory only.
Each time is the mean of ``--repeats`` calls that the host queued behind
a device spin, so the card runs them back to back.

``--profile`` adds the device time of each kernel the wrapper launches
(``torch.profiler``), which splits a design of several launches into
its passes. ``--passes`` times the one-launch kernel's passes apart
through ``quantizer.launch_passes``: pass 1 alone (absmax and scale),
pass 2 alone (codes from the scale already written, every tile read from
L2 or device memory, none from shared memory) and both.

Without ``--passes`` it calls only the public
``stochastic_quantize``, so the same file times any commit's kernel
(``PYTHONPATH`` naming that commit's checkout, the file run by its path).
Each row also checks the codes and scale against the plain version and
prints the codes' hash. Prints one JSON object. Needs a card.
"""

import argparse
import hashlib
import json
import math
import subprocess
from collections import defaultdict

import torch

from deepspeed_tpu_torch.ops import quantizer as qz

SPIN_CYCLES = 50_000_000
COLD_BYTES = 100e6  # twice the H100's L2
SHAPES = ((50257, 768), (3072, 768))


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


def kernel_ms(fn, repeats):
    """Device ms a call of each CUDA kernel ``fn`` launches, by kernel
    name, from ``torch.profiler`` over ``repeats`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            out[ev.key] += us / 1e3 / repeats
    return dict(out)


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def digest(t):
    """The first 16 hex digits of the sha256 of ``t``'s bytes."""
    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def rotation(x, cold):
    """A function that quantizes the next input of the rotation on each
    call: ``x`` alone (warm), or enough copies to exceed COLD_BYTES."""
    copies = [x] + ([x.clone() for _ in range(
        math.ceil(COLD_BYTES / (4 * x.numel())))] if cold else [])
    state = {"i": 0}

    def next_input():
        state["i"] = (state["i"] + 1) % len(copies)
        return copies[state["i"]]
    return next_input


def time_shape(shape, args, gen):
    x = torch.randn(shape, generator=gen, device="cuda")
    seed = args.seed + 101
    q, scale = qz.stochastic_quantize(x, seed)
    rq, rscale = qz.stochastic_quantize_reference(x, seed)
    torch.cuda.synchronize()
    row = {"shape": list(shape), "mb_read": 4 * x.numel() / 1e6,
           "bound_ms": 1e3 * 5 * x.numel() / 3.35e12,
           "bit_equal": bool(torch.equal(q, rq) and torch.equal(
               scale.view(torch.int32), rscale.view(torch.int32))),
           "sha": digest(q)}
    for temp in ("warm", "cold"):
        nxt = rotation(x, temp == "cold")

        def call():
            return qz.stochastic_quantize(nxt(), seed)
        row[f"{temp}_ms"] = device_ms(call, args.repeats)
        if args.profile:
            row[f"{temp}_kernels_ms"] = kernel_ms(call, args.repeats)
        if args.passes:
            for name, passes in (("pass1", 1), ("pass2", 2), ("both", 3)):
                def part(passes=passes):
                    qz.launch_passes(nxt(), q, scale, seed, passes)
                row[f"{temp}_{name}_ms"] = device_ms(part, args.repeats)
        del nxt
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", nargs="+",
                        default=[f"{r},{c}" for r, c in SHAPES])
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--passes", action="store_true")
    parser.add_argument("--repeats", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_quantize needs a CUDA card")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for text in args.shapes:
        shape = tuple(int(v) for v in text.split(","))
        rows.append(time_shape(shape, args, gen))
        torch.cuda.empty_cache()
    result = {"card": card(), "repeats": args.repeats, "rows": rows}
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
