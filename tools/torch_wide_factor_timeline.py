#!/usr/bin/env python3
"""Where the wide factor's time goes, on one NVIDIA GPU.

Usage: python3 tools/torch_wide_factor_timeline.py [--systems 8 64]

Builds a copy of the port's CUDA kernels in which the wide factor
(``csrc/chol_solve_sample_wide.cu``) records, for system 0: the
``%globaltimer`` at each cluster barrier (prep, first diagonal block,
then per panel the panel step and the trailing step), the ``clock64``
cycles of the lookahead's staging and its one-warp diagonal factor, and
the largest panel-step and trailing-step cycles of any warp; and a
one-CTA kernel that runs the diagonal staging and factor alone, again and
again (cold, then warm).  Runs the factor on README's Quick-start model
of the J1713+0747 snapshot (order 673, ``chip_smoke.py``'s seeded state)
at each ``--systems`` count and prints the timeline.  The copy and its
build go under ``build/`` (listed in ``.gitignore``); the package's own
kernels are not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "pulsar_timing_gibbsspec_torch" / "ops" / "kernels" / "csrc"
SNAPSHOT = ROOT / "tests" / "data" / "enterprise_J1713+0747.npz"
#: trace slots: start per system, barrier times, lookahead factor cycles,
#: trailing max, panel max, end per system, lookahead staging cycles
T_START, T_BAR, T_LOOK, T_TRAIL, T_PANEL, T_END, T_STAGE = (
    0, 64, 256, 512, 768, 1024, 1100)

_PRELUDE = '''namespace cg = cooperative_groups;
__device__ unsigned long long g_tr[2048];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TRB if (blockIdx.y == 0 && rank == 0 && threadIdx.x == 0) \\
  g_tr[64 + trn] = gtime(); ++trn;
'''

_BENCH = '''
namespace {
__global__ void diag_bench_kernel(float* A, float* Lo, float* R, int n,
                                  unsigned long long* out, int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sP0 = reinterpret_cast<float*>(smem_raw);
  float* sQ0 = sP0 + kB * kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Work<float> Wa{A, R, nullptr, n}, Wo{Lo, R, nullptr, n};
  for (int r = 0; r < reps; ++r) {
    __syncthreads();
    const long long c0 = clock64();
    diag_stage(Wa, 0, false, sP0, sQ0, warp, lane);
    const long long c1 = clock64();
    if (warp == 0) diag_factor(Wo, 0, sP0, sQ0, lane);
    __syncthreads();
    if (threadIdx.x == 0) {
      out[2 * r] = c1 - c0;
      out[2 * r + 1] = clock64() - c1;
    }
  }
}
}  // namespace

extern "C" int ptg_diag_bench(void* A, void* Lo, void* R, int n, void* out,
                              int reps) {
  diag_bench_kernel<<<1, kThreads, 2 * kB * kLd * sizeof(float)>>>(
      static_cast<float*>(A), static_cast<float*>(Lo),
      static_cast<float*>(R), n, static_cast<unsigned long long*>(out),
      reps);
  return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int ptg_trace(void* out, int zero) {
  static unsigned long long z[2048];
  if (zero) return static_cast<int>(cudaMemcpyToSymbol(g_tr, z, sizeof(z)));
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_tr, sizeof(z)));
}
'''


def _replace(text, old, new, count=1):
    if text.count(old) < count:
        raise RuntimeError(f"instrumentation anchor not found: {old!r}")
    return text.replace(old, new, count)


def instrumented_source(src: str) -> str:
    """The wide factor's source with the trace and the benchmark kernel."""
    src = _replace(src, "namespace cg = cooperative_groups;\n", _PRELUDE)
    head, body = src.split("wide_chol_kernel(const T* __restrict__ Sig", 1)
    body = _replace(body, "  const int gw = rank * kWarps + warp, nw = cs * kWarps;\n",
                    "  const int gw = rank * kWarps + warp, nw = cs * kWarps;\n"
                    "  if (threadIdx.x == 0 && rank == 0) g_tr[blockIdx.y] = gtime();\n"
                    "  int trn = 0;\n")
    body = _replace(body, "cluster_barrier();", "cluster_barrier(); TRB", 4)
    body = _replace(
        body, "    panel_task(W, k, gw, nw, lane);",
        "    { const long long c0 = clock64(); panel_task(W, k, gw, nw, lane);\n"
        "      if (blockIdx.y == 0 && lane == 0) atomicMax(&g_tr[768 + k],"
        " (unsigned long long)(clock64() - c0)); }")
    body = _replace(
        body, "      if (rank == own) diag_stage(W, k + 1, true, sP0, sQ0, warp, lane);",
        "      if (rank == own) { const long long c0 = clock64();\n"
        "        diag_stage(W, k + 1, true, sP0, sQ0, warp, lane);\n"
        "        if (blockIdx.y == 0 && threadIdx.x == 0) g_tr[1100 + k] = clock64() - c0; }")
    body = _replace(
        body, "        diag_factor(W, k + 1, sP0, sQ0, lane);",
        "        { const long long c0 = clock64(); diag_factor(W, k + 1, sP0, sQ0, lane);\n"
        "          if (blockIdx.y == 0 && lane == 0) g_tr[256 + k] = clock64() - c0; }")
    body = _replace(
        body, "        trailing_task(W, k, nblk, wid, nw - 1, sP, sQ, lane);",
        "        { const long long c0 = clock64();\n"
        "          trailing_task(W, k, nblk, wid, nw - 1, sP, sQ, lane);\n"
        "          if (blockIdx.y == 0 && lane == 0) atomicMax(&g_tr[512 + k],"
        " (unsigned long long)(clock64() - c0)); }")
    body = _replace(
        body, "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)\n"
        "    atomicAdd(count, 1ull);",
        "  if (threadIdx.x == 0 && rank == 0) g_tr[1024 + blockIdx.y] = gtime();\n"
        "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)\n"
        "    atomicAdd(count, 1ull);")
    return head + "wide_chol_kernel(const T* __restrict__ Sig" + body + _BENCH


def build():
    """Build the instrumented copy; returns the loaded library."""
    from torch.utils.cpp_extension import load

    sys.path.insert(0, str(ROOT))
    from pulsar_timing_gibbsspec_torch.ops.kernels import build as kbuild

    dst = ROOT / "build" / "timeline_csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    f = dst / "chol_solve_sample_wide.cu"
    f.write_text(instrumented_source(f.read_text()))
    out = ROOT / "build" / "timeline_build"
    out.mkdir(parents=True, exist_ok=True)
    so = load(name="ptg_timeline", sources=[str(dst / s) for s in kbuild.SOURCES],
              extra_cflags=["-O3"], extra_cuda_cflags=list(kbuild.CUDA_FLAGS),
              extra_include_paths=[str(dst)], build_directory=str(out),
              is_python_module=False, verbose=False)
    lib = kbuild._declare(ctypes.CDLL(str(so)))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ptg_trace.argtypes = [P, I]
    lib.ptg_diag_bench.argtypes = [P, P, P, I, P, I]
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--systems", type=int, nargs="+", default=[8, 64])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import load_enterprise_snapshot
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    from chip_smoke import parity_state

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    lib = build()
    dev = torch.device("cuda")

    # the diagonal staging and factor alone, cold then warm
    g = torch.Generator(device=dev).manual_seed(3)
    X = torch.randn(64, 64, generator=g, device=dev)
    A = (X @ X.T / 64 + torch.eye(64, device=dev)).contiguous()
    Lo, R = torch.zeros_like(A), torch.zeros_like(A)
    reps = 20
    out = torch.zeros(2 * reps, dtype=torch.int64, device=dev)
    code = lib.ptg_diag_bench(A.data_ptr(), Lo.data_ptr(), R.data_ptr(), 64,
                              out.data_ptr(), reps)
    if code:
        raise RuntimeError(f"diag bench failed ({code})")
    ob = out.cpu().numpy().reshape(reps, 2)
    print(f"diagonal block alone (one CTA): staging cycles {ob[0, 0]} cold, "
          f"{int(np.median(ob[1:, 0]))} warm; factor and inverse cycles "
          f"{ob[0, 1]} cold, {int(np.median(ob[1:, 1]))} warm", flush=True)

    cm = ptt.model_general([load_enterprise_snapshot(str(SNAPSHOT))],
                           red_var=False, white_vary=True,
                           common_psd="spectrum", common_components=30,
                           device=dev)
    n = cm.Bmax
    x = parity_state(cm, 8, torch.Generator(device=dev).manual_seed(0))
    TNT, d = blocks.tnt_d_seg32(cm, cm.ndiag_fast(x))
    phi = cm.phi(x, dtype=torch.float32)
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    Sig8 = (TNT + (1.0 / phi)[..., :, None] * eye).reshape(-1, n, n)
    d8 = d.reshape(-1, n)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for B in args.systems:
        Sig = Sig8.repeat(-(-B // 8), 1, 1)[:B].contiguous()
        dd = d8.repeat(-(-B // 8), 1)[:B].contiguous()
        z = torch.ones_like(dd)
        outs = [torch.empty_like(Sig), torch.empty_like(Sig)] + [
            torch.empty_like(dd) for _ in range(4)]

        def run():
            code = lib.ptg_chol_solve_sample_wide(
                0, Sig.data_ptr(), dd.data_ptr(), z.data_ptr(),
                *[o.data_ptr() for o in outs], B, n, 4e-6,
                count.data_ptr(), stream)
            if code:
                raise RuntimeError(f"wide factor failed ({code})")

        for _ in range(3):
            run()
        torch.cuda.synchronize()
        lib.ptg_trace(None, 1)
        run()
        torch.cuda.synchronize()
        tr = np.zeros(2048, dtype=np.uint64)
        if lib.ptg_trace(tr.ctypes.data, 0):
            raise RuntimeError("reading the trace failed")
        tr = tr.astype(np.int64)
        nblk = -(-n // 32)
        starts, ends = tr[T_START:T_START + B], tr[T_END:T_END + B]
        bars = (tr[T_BAR:T_BAR + 2 + 2 * nblk] - tr[T_START]) / 1e3
        print(f"{B} systems: call {(ends.max() - starts.min()) / 1e3:.1f} us "
              f"(systems started within {(starts.max() - starts.min()) / 1e3:.1f} us)",
              flush=True)
        print(f"{B} systems, system 0 (us from its start): prep "
              f"{bars[0]:.1f}, first diagonal block {bars[1] - bars[0]:.1f}, "
              f"panel steps {np.round(bars[2::2] - bars[1::2][:nblk], 1).tolist()}, "
              f"trailing steps {np.round(bars[3::2][:nblk] - bars[2::2][:nblk], 1).tolist()}, "
              f"last pass {(tr[T_END] - tr[T_START]) / 1e3 - bars[-1]:.1f}",
              flush=True)
        print(f"{B} systems, cycles per panel: lookahead staging "
              f"{tr[T_STAGE:T_STAGE + nblk - 1].tolist()}; lookahead factor "
              f"and inverse {tr[T_LOOK:T_LOOK + nblk - 1].tolist()}; trailing "
              f"step, slowest warp {tr[T_TRAIL:T_TRAIL + nblk - 1].tolist()}; "
              f"panel step, slowest warp {tr[T_PANEL:T_PANEL + nblk].tolist()}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
