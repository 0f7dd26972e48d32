#!/usr/bin/env python3
"""Design probe of the 3xTF32 flash forward at head dims in (128, 256]
(``deepspeed_tpu_torch/csrc/flash_attention_tf32.cu``'s DMAX = 256
instance) on one GPU.

    python3 tools/probe_flash_tf32_d256.py

Builds five variants of the source with ``nvcc`` into
``build/flash_tf32_d256_variants/`` (a directory ``.gitignore`` lists),
one per process, all started together, by setting three of its
constants:

- ``split1``: ``FWD256_SPLIT`` = 1: four warps a block, each owning one
  16-row group and all 256 columns of o (128 accumulator registers a
  thread), 32-key tiles (200 KB of shared memory, one block an SM);
- ``split2``: ``FWD256_SPLIT`` = 2, ``FWD256_SHARE_S`` off: eight warps,
  two over each 16-row group, each computing all of the group's s and
  its softmax itself and owning 128 columns of o (twice the s products,
  half the accumulator);
- ``split2_share``: the same with ``FWD256_SHARE_S`` on: each warp of a
  pair sums s over its half of the head dim and the two add their
  partial sums through 16 KB of shared memory (216 KB);
- ``split1_bs16`` and ``split2_share_bs16``: 16-key tiles (``BS`` = 16:
  133 and 141 KB, still one block an SM at D = 256).

Prints each variant's registers and spill stores for the D = 256
forward; holds each on ``chip_smoke.py``'s fp32 flash cases above D =
128 (``compare_flash_case`` over ``FLASH_CASES_256``,
``FLASH_DROP_CASES_256`` and ``FLASH_NONCAUSAL_CASES_256`` at dropout 0
and 0.1: the forward against the plain version within 1e-5, the FMA
forward on the same inputs, the whole autograd path with the FMA dq and
dk/dv); then times the forward at ``FLASH_D256_SHAPE`` ([4, 512, 8,
256] fp32 causal, 4-layer rotation) at dropout 0 and 0.1, in two rounds
of opposite order, beside the FMA forward on the same inputs and SDPA's
fp32 forward (memory-efficient backend, TF32 off), all as device time
(``chip_smoke.device_ms``). A variant that fails to build or to hold is
reported and skipped; the exit code is then 1. Exits 2 without CUDA.
"""

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "flash_tf32_d256_variants")
NAME = "flash_attention_tf32"
CONSTANTS = {"split": ("constexpr int FWD256_SPLIT = {};", r"\d+"),
             "share": ("constexpr bool FWD256_SHARE_S = {};", r"\w+"),
             "bs": ("constexpr int BS = {};", r"\d+")}
# name: (split, share, key-tile rows)
VARIANTS = {"split1": (1, "false", 32), "split2": (2, "false", 32),
            "split2_share": (2, "true", 32),
            "split1_bs16": (1, "false", 16),
            "split2_share_bs16": (2, "true", 16)}


def variants(src: str) -> dict:
    """The source with each variant's constants set."""
    found = {}
    for key, (pattern, value) in CONSTANTS.items():
        found[key] = re.compile(re.escape(pattern).replace(r"\{\}", value))
        if len(found[key].findall(src)) != 1:
            raise SystemExit(f"probe_flash_tf32_d256: {pattern!r} not "
                             f"found once in the source")
    out = {}
    for name, values in VARIANTS.items():
        text = src
        for key, value in zip(CONSTANTS, values):
            text = found[key].sub(CONSTANTS[key][0].format(value), text)
        out[name] = text
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_flash_tf32_d256: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), torch.__version__, flush=True)
    with open(os.path.join(build.CSRC, NAME + ".cu")) as f:
        srcs = variants(f.read())
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise SystemExit("probe_flash_tf32_d256: nvcc not found")
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
             os.path.join(OUT, name + ".so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    good, failed = [], []
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed:\n{err[-6000:]}", flush=True)
            failed.append(name)
            continue
        report = out + err
        blocks = re.findall(r"Compiling entry function '(\S*flash_fwd_tf32_"
                            r"kernelILi256E\S*)'(.*?)(?=Compiling entry|$)",
                            report, re.S)
        for kname, body in blocks:
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            print(f"{name}: {kname[-40:]} registers "
                  f"{regs.group(1) if regs else '?'}, spill stores "
                  f"{spill.group(1) if spill else '?'} bytes", flush=True)
        good.append(name)

    def bind(name):
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        real = build.load
        build.load = lambda _n: lib
        try:
            fa._FN.pop(NAME, None)
            return fa._kernel(NAME)
        finally:
            build.load = real

    f32 = torch.float32
    held = []
    for name in good:
        fa._FN[NAME] = bind(name)
        beyond, n, worst = [], 0, {}
        for cases, rate, causal in (
                (cs.FLASH_CASES_256, 0.0, True),
                (cs.FLASH_DROP_CASES_256, cs.FLASH_DROPOUT, True),
                (cs.FLASH_NONCAUSAL_CASES_256, 0.0, False),
                (cs.FLASH_NONCAUSAL_CASES_256, cs.FLASH_DROPOUT, False)):
            for case in cases:
                n += 1
                try:
                    routes = cs.compare_flash_case(
                        torch, fa, f32, case, worst, rate,
                        cs.FLASH_DROPOUT_SEED if rate else None,
                        causal=causal)
                    if routes != ("tf32", "fma", "fma"):
                        beyond.append(f"{case}: routes {routes}")
                except RuntimeError as e:
                    beyond.append(str(e)[:300])
        fwd_err = worst.get(("fwd", "float32"), (None,))[0]
        print(f"{name}: {n - len(beyond)} of {n} fp32 flash cases above D "
              f"= 128 within 1e-5 (the forward's max |err| {fwd_err}); "
              f"beyond: {beyond}", flush=True)
        (failed if beyond else held).append(name)

    b, s, h, d = cs.FLASH_D256_SHAPE
    scale = d ** -0.5
    layers = [cs.flash_case(torch, f32, b, s, h, d, seed=100 + i)
              for i in range(4)]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(layers)
        return layers[it["i"]][1:4]

    for rate in (0.0, 0.1):
        drop = (rate, cs.FLASH_DROPOUT_SEED if rate else None)

        def fma_fwd():
            fa._launch_fwd("flash_attention", *nxt(), None, True, scale,
                           *drop)

        sdpa_in = [tuple(t.transpose(1, 2).contiguous() for t in lay[1:4])
                   for lay in layers]

        def sdpa():
            it["i"] = (it["i"] + 1) % len(sdpa_in)
            F.scaled_dot_product_attention(*sdpa_in[it["i"]], is_causal=True,
                                           dropout_p=rate)

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib_ms = cs.device_ms(torch, sdpa)[0]
        print(f"dropout {rate}: the FMA forward on the same inputs "
              f"{cs.device_ms(torch, fma_fwd)[0]:.4f} ms, SDPA fp32 "
              f"(efficient) {lib_ms:.4f} ms (device time)", flush=True)
    for rnd, order in enumerate((held, list(reversed(held)))):
        for name in order:
            fa._FN[NAME] = bind(name)
            for rate in (0.0, 0.1):
                drop = (rate, cs.FLASH_DROPOUT_SEED if rate else None)

                def fwd():
                    fa.flash_attention_fwd_tf32(*nxt(), None, True, scale,
                                                *drop)

                print(f"round {rnd} {name} dropout {rate}: fwd "
                      f"{cs.device_ms(torch, fwd)[0]:.4f} ms (device time, "
                      f"fp32 {list(cs.FLASH_D256_SHAPE)} causal)",
                      flush=True)
    fa._FN.pop(NAME, None)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
