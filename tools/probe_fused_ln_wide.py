#!/usr/bin/env python3
"""Design probe of the 16-bit fused LayerNorm + projection above
``fused.TC_MAX_D`` (``deepspeed_tpu_torch/csrc/fused_ln_tc.cu``'s streamed
product, ``stream_gemm_kernel``) on one GPU.

    python3 tools/probe_fused_ln_wide.py

Builds variants of the source with ``nvcc`` into
``build/fused_ln_wide_variants/`` (a directory ``.gitignore`` lists), one
per process, all started together; each is a text patch of a constant of
the source, so the kernel keeps no switch:

- ``source``: the source as it is (the forward's tiles 128 x 256, the
  GELU recompute's 128 x 128; 4 stages of 48 or 32 KB; groups of 8 row
  tiles);
- ``bn128``: the forward's tiles 128 x 128 as well;
- ``gelu_bn256``: the recompute's tiles 128 x 256 as well (its dy in
  registers then spills);
- ``stages3``: the ring's depth;
- ``group1``, ``group16``, ``group64``: the tile order (groups of 1, 16 or
  64 row tiles walked column tile by column tile; 64 is every row tile
  at n 8192, i.e. column-major order);
- ``a_regs``: A built in registers from raw x and the rows' statistics
  (the ``wgmma`` RS form ``fused_ln_tf32.cu`` uses, with B K-major): the
  ring holds x's boxes instead of T(ln)'s, the forward's rows kernel
  writes only the statistics (no T(ln) round trip), and a stage's
  fragments are built while the stage before it is in the tensor cores;
  128 x 128 tiles (``bn128`` is its yardstick).

Prints each variant's registers and spill stores (ptxas), holds every
variant against the plain version (``FUSED_LN_TOL`` beyond one rounding
step) and says whether it is bit-equal to the source (the same sums in
the same order), then times the forward and the backward of each per
layer at ``chip_smoke.FUSED_LN_D2048`` (n 8192, D 2048, F 6144 and 8192 +
GELU, bf16; ``chip_smoke.device_ms``) in two rounds of opposite order. A
variant that does not build is reported and left out. Exits non-zero
without CUDA or if a variant is wrong.
"""

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "fused_ln_wide_variants")
CONSTS = {"FWD_BN": 256, "GELU_BN": 128, "FWD_STAGES": 4, "FWD_GROUP": 8}
VARIANTS = {"source": {}, "bn128": {"FWD_BN": 128},
            "gelu_bn256": {"GELU_BN": 256}, "stages3": {"FWD_STAGES": 3},
            "group1": {"FWD_GROUP": 1}, "group16": {"FWD_GROUP": 16},
            "group64": {"FWD_GROUP": 64}, "a_regs": {"FWD_BN": 128}}

# a_regs: the products with A from registers and B K-major, the function
# that builds the fragments, and the kernel's and host's edits (text
# patches: old -> new)
RSK_HELPERS = r"""
template <typename T>
__device__ __forceinline__ void wgmma128_rsk(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGMMA_RSK("bf16");
  } else {
    WGMMA_RSK("f16");
  }
}

// a[kk][2 half + h]: (row r0 + 8 h, k 16 kk + 2 t + 8 half, + 1) of the
// stage's raw x box, normalised as ln_rows_kernel does (0 past D)
template <typename T>
__device__ __forceinline__ void a_frags16(const uint8_t* st, int r0, int k0,
                                          int D, const float (&mu)[2],
                                          const float (&rs)[2],
                                          const void* gamma,
                                          const void* beta, int gcode,
                                          uint32_t (&a)[GEMM_K / 16][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < GEMM_K / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kc = 16 * kk + 2 * t + 8 * half, col = k0 + kc;
      const bool ok = col < D;
      const float g0 = ok ? param(gamma, gcode, col) : 0.f;
      const float g1 = ok ? param(gamma, gcode, col + 1) : 0.f;
      const float b0 = ok ? param(beta, gcode, col) : 0.f;
      const float b1 = ok ? param(beta, gcode, col + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const float2 v = unpack2<T>(*reinterpret_cast<const uint32_t*>(
            st + r * 128 + (((kc >> 3) ^ (r & 7)) << 4) + (kc & 7) * 2));
        uint32_t u = 0;
        if (ok)
          store2(reinterpret_cast<T*>(&u),
                 normalize(v.x, mu[h], rs[h], g0, b0),
                 normalize(v.y, mu[h], rs[h], g1, b1));
        a[kk][2 * half + h] = u;
      }
    }
}

"""
RSK_LOOP = r"""  float d[HALVES][64];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) d[h][i] = 0.f;
  const int r0 = wg * 64 + q * 16 + (lane >> 2);   // in the stage's box
  float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (m0 + r0 + 8 * h < n) {
      mu[h] = stats[m0 + r0 + 8 * h];
      rs[h] = stats[n + m0 + r0 + 8 * h];
    }
  uint32_t a[GEMM_K / 16][4];
  if (ksteps > 0) {
    mbar_wait(&full[0], 0);
    a_frags16<T>(smem, r0, 0, D, mu, rs, gamma, beta, gcode, a);
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    const int s = ks % FWD_STAGES;
    const uint8_t* st = smem + s * STAGE;
#pragma unroll
    for (int h = 0; h < HALVES; ++h) fence_acc(d[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GEMM_K / 16; ++kk) {
      fence_regs(a[kk]);
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
        wgmma128_rsk<T>(d[h], a[kk],
                        gmma_desc(st + A_BYTES + h * BN * 128 + kk * 32, 16,
                                  1024, 1),
                        1);
    }
    wgmma_commit();
    uint32_t na[GEMM_K / 16][4];
    if (ks + 1 < ksteps) {
      const int s1 = (ks + 1) % FWD_STAGES;
      mbar_wait(&full[s1], ((ks + 1) / FWD_STAGES) & 1);
      a_frags16<T>(smem + s1 * STAGE, r0, (ks + 1) * GEMM_K, D, mu, rs,
                   gamma, beta, gcode, na);
    }
    wgmma_wait<0>();
    // wgmma reads a asynchronously: held live to here, so that the
    // compiler does not build na in a's registers while they are read
#pragma unroll
    for (int kk = 0; kk < GEMM_K / 16; ++kk) fence_regs(a[kk]);
#pragma unroll
    for (int h = 0; h < HALVES; ++h) fence_acc(d[h]);
    mbar_arrive(&empty[s]);
#pragma unroll
    for (int kk = 0; kk < GEMM_K / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[kk][e] = na[kk][e];
  }
"""
RSK_EDITS = (
    ("using hopper::fence_acc;\n",
     "using hopper::fence_acc;\nusing hopper::fence_regs;\n"),
    ("                       int n, int D, int F) {\n",
     "                       int n, int D, int F, const void* gamma,\n"
     "                       const void* beta, int gcode,\n"
     "                       const float* __restrict__ stats) {\n"),
    ("                        float* dbias_part, int n, int D, int F,\n"
     "                        cudaStream_t s) {\n",
     "                        float* dbias_part, int n, int D, int F,\n"
     "                        cudaStream_t s, const void* gamma,\n"
     "                        const void* beta, int gcode,\n"
     "                        const float* stats) {\n"),
    ("      static_cast<T*>(out), dbias_part, n, D, F);\n",
     "      static_cast<T*>(out), dbias_part, n, D, F, gamma, beta, gcode,\n"
     "      stats);\n"),
    ("        static_cast<T*>(lnT), n, D, eps);\n",
     "        MODE == 2 ? static_cast<T*>(lnT) : nullptr, n, D, eps);\n"),
    ("    return stream_gemm<T, MODE>(lnT, w, bias, bcode, dy, out, "
     "dbias_part, n,\n                                D, F, s);\n",
     "    return stream_gemm<T, MODE>(x, w, bias, bcode, dy, out, dbias_part,"
     " n,\n                                D, F, s, gamma, beta, gcode, "
     "stats);\n"),
    # ln_rows_kernel: no T(ln) when it is not asked for
    ("  for (int c = lane * 8; c < D; c += 256) {\n    float v[8];\n"
     "    load8(xr + c, v);\n    *reinterpret_cast<uint4*>(lnT",
     "  for (int c = lane * 8; lnT != nullptr && c < D; c += 256) {\n"
     "    float v[8];\n    load8(xr + c, v);\n"
     "    *reinterpret_cast<uint4*>(lnT"),
)


def replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"probe_fused_ln_wide: {old[:60]!r} moved")
    return text.replace(old, new)


def a_regs(src: str, header: str) -> str:
    """The a_regs variant of ``src``; ``header``: wgmma.cuh, whose A-from-
    registers m64n128k16 macro it copies with B K-major (trans-b 0)."""
    i = header.index("#define WGMMA_M64N128K16_RS(TYPE)")
    j = header.index("\n\n", i)
    macro = replace_once(header[i:j], "p, 1, 1, 1;", "p, 1, 1, 0;").replace(
        "WGMMA_M64N128K16_RS", "WGMMA_RSK")
    for old, new in RSK_EDITS:
        src = replace_once(src, old, new)
    mark = ("// -------------------------------------------------------------"
            "--------------\n// above TC_MAX_D, the forward's product")
    src = replace_once(src, mark, macro + "\n" + RSK_HELPERS + mark)
    i = src.index("  float d[HALVES][64];\n")
    j = src.index("\n  const int wrow = m0 + wg * 64 + q * 16;")
    return src[:i] + RSK_LOOP + src[j:]


def variants(src: str, header: str) -> dict:
    out = {}
    for name, patch in VARIANTS.items():
        text = src
        for const, value in patch.items():
            text = replace_once(text, f"constexpr int {const} = "
                                f"{CONSTS[const]};",
                                f"constexpr int {const} = {value};")
        out[name] = a_regs(text, header) if name == "a_regs" else text
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_fused_ln_wide: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import chip_smoke as cs
    from check_fused_ln_tc_identity import bind
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import fused as fz

    print(cs.card_line(), torch.__version__)
    with open(os.path.join(build.CSRC, "fused_ln_tc.cu")) as f, \
            open(os.path.join(build.CSRC, "wgmma.cuh")) as g:
        srcs = variants(f.read(), g.read())
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise SystemExit("probe_fused_ln_wide: nvcc not found")
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
    fns = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            print(f"{name} does not build; left out:\n{err[-3000:]}")
            continue
        report = out + err
        regs = re.findall(r"Compiling entry function '(\S+)'.*?(\d+) bytes "
                          r"spill stores.*?Used (\d+) registers", report,
                          re.S)
        print(name, [(re.sub(r"^.*stream_gemm_kernel", "", n)[:20], int(r),
                      int(sp)) for n, sp, r in regs
                     if "stream_gemm_kernel" in n],
              "(stream_gemm_kernel instantiations: registers, spill "
              "stores)", flush=True)
        fns[name] = bind(ctypes.CDLL(os.path.join(OUT, name + ".so")))

    dtype, tol = torch.bfloat16, cs.FUSED_LN_TOL["bfloat16"]
    bad = []
    sets = {site: [cs.fused_ln_case(torch, dtype, *site[:3], seed=60 + j)
                   for j in range(2)] for site in cs.FUSED_LN_D2048}

    def use(name):
        fz._FN["fused_ln_tc"] = fns[name]

    # correctness: every variant against the plain version, and whether
    # it gives the source's bits
    for (n, d, f, act), cases in sets.items():
        x, gamma, beta, w, bias, dy = cases[0]
        got = {}
        for name in fns:
            use(name)
            got[name] = (fz._launch_fwd("fused_ln_tc", x, gamma, beta, w,
                                        bias, 1e-5, act),
                         *fz._launch_bwd("fused_ln_tc", x, gamma, beta, w,
                                         bias, dy, 1e-5, act))
        torch.cuda.synchronize()
        want = (fz.ln_matmul_reference(x, gamma, beta, w, bias,
                                       activation=act),
                *fz.ln_matmul_bwd_reference(x, gamma, beta, w, bias, dy,
                                            activation=act))
        for name, outs in got.items():
            rels = []
            for key, a, b in zip(("y",) + cs.FUSED_LN_NAMES, outs, want):
                diff = ((a.float() - b.float()).abs()
                        - cs.round_step(torch, b, b.dtype)).clamp_min(0)
                rels.append(diff.max().item() / max(
                    b.float().pow(2).mean().sqrt().item(), 1e-30))
                if not rels[-1] <= tol:
                    bad.append(f"{name} {key} n={n} F={f} {act}")
            same = all(torch.equal(a, b) for a, b in zip(outs,
                                                          got["source"]))
            if not rels[0] <= tol:
                # where a wrong y sits: its share, its first element, and
                # the rows (mod 128) and columns (mod 128) it touches
                wrong = ((outs[0].float() - want[0].float()).abs()
                         > 0.1 * want[0].float().abs() + 0.1)
                idx = wrong.nonzero()
                r, c = (int(v) for v in idx[0])
                rows = sorted(set((idx[:, 0] % 128).tolist()))[:20]
                cols = sorted(set((idx[:, 1] % 128).tolist()))[:20]
                print(f"{name} y wrong at {wrong.float().mean().item():.3g} "
                      f"of the elements; first at ({r}, {c}): "
                      f"{outs[0][r, c].item()} against "
                      f"{want[0][r, c].item()}; rows mod 128 {rows}; "
                      f"columns mod 128 {cols}")
            print(f"{name} n={n} D={d} F={f} {act}: y, dx, dgamma, dbeta, "
                  f"dw, dbias {[f'{r:.3g}' for r in rels]} of the plain "
                  f"version's RMS beyond one step (limit {tol}); bit-equal "
                  f"to the source: {same}")
        del got, want
    print(f"variants held: {len(bad)} wrong {bad}", flush=True)

    times = {}
    for order in (list(fns), list(reversed(list(fns)))):
        for name in order:
            use(name)
            for which in ("fwd", "bwd"):
                total = 0.0
                for (n, d, f, act), cases in sets.items():
                    it = {"i": 0}

                    def call():
                        it["i"] = (it["i"] + 1) % len(cases)
                        x, gamma, beta, w, bias, dy = cases[it["i"]]
                        if which == "fwd":
                            fz._launch_fwd("fused_ln_tc", x, gamma, beta, w,
                                           bias, 1e-5, act)
                        else:
                            fz._launch_bwd("fused_ln_tc", x, gamma, beta, w,
                                           bias, dy, 1e-5, act)
                    total += cs.device_ms(torch, call)[0]
                times.setdefault((name, which), []).append(round(total, 4))
    use("source")
    for which in ("fwd", "bwd"):
        print(f"{which} per layer at FUSED_LN_D2048 (both sites, bf16, "
              f"device ms, two rounds of opposite order): "
              + ", ".join(f"{name} {times[(name, which)]}" for name in fns))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
