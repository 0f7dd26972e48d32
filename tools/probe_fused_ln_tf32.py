#!/usr/bin/env python3
"""Check and design probe of the 3xTF32 fused LayerNorm + projection
(``deepspeed_tpu_torch/csrc/fused_ln_tf32.cu``, TPU kernels #6 and #7 in
fp32) on one GPU.

    python3 tools/probe_fused_ln_tf32.py [check|all]

``check`` (the default) builds the source and ``fused_ln.cu`` (the first
version), prints each kernel's registers and spills, holds the forward
and backward on the 3xTF32 route against their plain versions in every
fp32 case of ``chip_smoke.py``'s FUSED_LN_CASES (each output's max |err|
over the plain version's RMS, within FUSED_LN_TOL["float32"]; y and the
five gradients bit-equal over two launches), prints the errors at the
path's two sites beside ``fused_ln.cu``'s on the same inputs, times the
forward and backward per layer (both sites) beside ``fused_ln.cu`` and
the unfused eager sequence, and prints the kernels of one backward call
by device time (the prologue's share is what moving the transposed
splits from the workspace into shared memory could save at most).

``all`` then builds variants of the source, each a text patch of it,
with ``nvcc`` into ``build/fused_ln_tf32_variants/`` (a directory
``.gitignore`` lists), all started together:

- ``fold1``: the running sum folded after every k-step (8 deep), not
  every stage (32 deep);
- ``fold8``: folded every other stage (64 deep);
- ``nosplit``: dW's tiles never split over the rows (MAX_SPLIT 1);
- ``tile64x256``: 64 x 256 output tiles (the two warpgroups side by side
  on the same rows, three 72 KB stages) instead of 128 x 128;
- ``no_norm``: x not normalised on its way into the A fragments (wrong
  results: timed only, the normalisation's cost);

holds each variant but ``no_norm`` on every fp32 case (errors at the
sites printed) and times the forward and backward of the source and
every variant at the path's sites, in two rounds of opposite order, as
device time. Exits non-zero without CUDA or on any miss.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "fused_ln_tf32_variants")
NAME = "fused_ln_tf32"
FOLD = "constexpr int FOLD = 4;"
SPLIT = "constexpr int MAX_SPLIT = 8;"
TILE = ("constexpr int BM = 128;", "constexpr int BN = 128;",
        "constexpr int WG_ROWS = 64;", "constexpr int WG_COLS = 0;",
        "constexpr int STAGES = 4;")
WIDE = ("constexpr int BM = 64;", "constexpr int BN = 256;",
        "constexpr int WG_ROWS = 0;", "constexpr int WG_COLS = 128;",
        "constexpr int STAGES = 3;")
NORM = ("        v = k0 + kc < p.K ? normalize(v, mu[e & 1], rs[e & 1],\n"
        "                                      gm[kk][e >> 1], bt[kk][e >> 1])\n"
        "                          : 0.f;\n")
TIMED_ONLY = ("no_norm",)


def variants(src: str) -> dict:
    """Each of the source's open choices changed, as a text patch."""
    for text in (FOLD, SPLIT, NORM) + TILE:
        if src.count(text) != 1:
            raise SystemExit(f"probe_fused_ln_tf32: {text!r} moved")
    wide = src
    for old, new in zip(TILE, WIDE):
        wide = wide.replace(old, new)
    return {"fold1": src.replace(FOLD, "constexpr int FOLD = 1;"),
            "fold8": src.replace(FOLD, "constexpr int FOLD = 8;"),
            "nosplit": src.replace(SPLIT, "constexpr int MAX_SPLIT = 1;"),
            "tile64x256": wide,
            "no_norm": src.replace(NORM, "        v = v;\n")}


def hold(torch, cs, fz, tag, first=False):
    """Every fp32 case of FUSED_LN_CASES on the 3xTF32 route against the
    plain versions; returns the worst rel error by output and the errors
    at the two sites (with ``first``, fused_ln.cu's too)."""
    f32 = torch.float32
    worst, sites = {}, {}
    for i, (n, d, f, act) in enumerate(cs.FUSED_LN_CASES):
        x, gamma, beta, w, bias, dy = cs.fused_ln_case(torch, f32, n, d, f,
                                                       seed=40 + i)
        args = fz._prepare(x, gamma, beta, w, bias)
        kw = dict(eps=1e-5, activation=act)
        outs = [(fz.ln_matmul_fwd_tf32(*args, **kw),
                 *fz.ln_matmul_bwd_tf32(*args, dy, **kw)) for _ in range(2)]
        for key, a, b in zip(("y",) + cs.FUSED_LN_NAMES, *outs):
            if not torch.equal(a, b):
                cs.fail(f"{tag} n={n} D={d} F={f} {act}: {key} differs "
                        f"between two launches")
        refs = (fz.ln_matmul_reference(x, gamma, beta, w, bias, **kw),
                *fz.ln_matmul_bwd_reference(x, gamma, beta, w, bias, dy,
                                            **kw))
        rows = [("tf32", outs[0])]
        if first and i < len(cs.FUSED_LN_SITES):
            rows.append(("first", (
                fz._launch_fwd("fused_ln", *args, 1e-5, act),
                *fz._launch_bwd("fused_ln", *args, dy, 1e-5, act))))
        for label, got in rows:
            for key, a, ref in zip(("y",) + cs.FUSED_LN_NAMES, got, refs):
                rms = ref.float().pow(2).mean().sqrt().item()
                rel = ((a.float() - ref.float()).abs().max().item()
                       / max(rms, 1e-30))
                if not rel <= cs.FUSED_LN_TOL["float32"] and label == "tf32":
                    cs.fail(f"{tag} n={n} D={d} F={f} {act}: {key} "
                            f"{rel:.3g} of the plain version's RMS")
                if label == "tf32":
                    worst[key] = max(worst.get(key, 0.0), rel)
                if i < len(cs.FUSED_LN_SITES):
                    sites[f"{label} F={f} {key}"] = float(f"{rel:.3g}")
    torch.cuda.synchronize()
    print(f"{tag}: held in every fp32 case; worst of the plain version's "
          f"RMS {json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}"
          f"; at the sites {json.dumps(sites)}", flush=True)
    return worst, sites


def site_inputs(torch, cs):
    return {site: [cs.fused_ln_case(torch, torch.float32, *site[:3],
                                    seed=60 + j) for j in range(2)]
            for site in cs.FUSED_LN_SITES}


def time_route(torch, cs, launch_fwd, launch_bwd, sets):
    """(fwd, bwd) device ms per layer (both sites summed)."""
    total = [0.0, 0.0]
    for (n, d, f, act), cases in sets.items():
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % len(cases)
            return cases[it["i"]]

        total[0] += cs.device_ms(torch, lambda: launch_fwd(
            *nxt()[:5], 1e-5, act))[0]
        total[1] += cs.device_ms(torch, lambda: launch_bwd(
            *nxt(), 1e-5, act))[0]
    return tuple(round(t, 4) for t in total)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_fused_ln_tf32: no CUDA device", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else "check"
    if mode not in ("check", "all"):
        raise SystemExit(f"probe_fused_ln_tf32: unknown mode {mode!r}")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import fused as fz

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    libs = build.build_all([NAME, "fused_ln"])
    print(f"{os.path.relpath(libs[0], HERE)}: "
          f"{cs.ptxas_summary(libs[0], each=True)}", flush=True)
    with open(libs[0][:-3] + ".log") as f:
        warned = [ln.strip() for ln in f if "arning" in ln or "wgmma" in ln]
    print(f"ptxas warnings: {json.dumps(warned[:12])}", flush=True)
    hold(torch, cs, fz, "source", first=True)

    sets = site_inputs(torch, cs)
    tf32 = (lambda *a: fz._launch_fwd(NAME, *a),
            lambda *a: fz._launch_bwd(NAME, *a))
    first = (lambda *a: fz._launch_fwd("fused_ln", *a),
             lambda *a: fz._launch_bwd("fused_ln", *a))

    def eager(which):
        def fwd(x, gamma, beta, w, bias, eps, act):
            with torch.no_grad():
                cs.fused_ln_unfused(torch, x, gamma, beta, w, bias, act)
        graphs = {}

        def bwd(x, gamma, beta, w, bias, dy, eps, act):
            key = x.data_ptr()
            if key not in graphs:
                leaves = [t.clone().requires_grad_()
                          for t in (x, gamma, beta, w, bias)]
                graphs[key] = (leaves, cs.fused_ln_unfused(torch, *leaves,
                                                           act))
            leaves, out = graphs[key]
            torch.autograd.grad(out, leaves, dy, retain_graph=True)
        return fwd if which == "fwd" else bwd

    times = {"tf32": time_route(torch, cs, *tf32, sets),
             "fused_ln.cu": time_route(torch, cs, *first, sets),
             "eager": time_route(torch, cs, eager("fwd"), eager("bwd"),
                                 sets)}
    breakdown = {}
    for (n, d, f, act), cases in sets.items():
        x, gamma, beta, w, bias, dy = cases[0]
        for which, call in (
                ("fwd", lambda: fz._launch_fwd(NAME, x, gamma, beta, w, bias,
                                               1e-5, act)),
                ("bwd", lambda: fz._launch_bwd(NAME, x, gamma, beta, w, bias,
                                               dy, 1e-5, act))):
            _ms, kernels = cs.device_ms(torch, call, names=True)
            breakdown[f"{which} F={f} {act}"] = {
                re.sub(r"^void |\(anonymous namespace\)::", "", k)[:44]:
                    round(v, 4) for k, v in kernels.items()}
    print(f"fp32 #6 / #7 per layer, both sites (forward, backward) device "
          f"ms ({card}): {json.dumps(times)}; one call's kernels by device "
          f"ms: {json.dumps(breakdown)}", flush=True)
    if mode == "check":
        return 0

    with open(os.path.join(build.CSRC, NAME + ".cu")) as f:
        srcs = variants(f.read())
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
             os.path.join(OUT, name + ".so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    src_fns = fz._kernel(NAME)
    fns = {"source": src_fns}
    for name, proc in procs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_fused_ln_tf32: {name} failed:\n{err}")
        regs = re.findall(r"Used (\d+) registers", err)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", err)))
        print(f"{name}: registers {regs}, spill stores {spills}", flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        got = []
        for fn in src_fns:
            g = getattr(lib, fn.__name__)
            g.argtypes, g.restype = fn.argtypes, fn.restype
            got.append(g)
        fns[name] = tuple(got)
    for name, f4 in fns.items():
        if name not in ("source",) + TIMED_ONLY:
            fz._FN[NAME] = f4
            hold(torch, cs, fz, name)
    rounds = {}
    order = list(fns)
    for names in (order, order[::-1]):
        for name in names:
            fz._FN[NAME] = fns[name]
            rounds.setdefault(name, []).append(
                time_route(torch, cs, *tf32, sets))
    fz._FN[NAME] = src_fns
    print(f"fp32 #6 / #7 per layer, both sites (forward, backward) device "
          f"ms by variant, two rounds ({card}): {json.dumps(rounds)}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
