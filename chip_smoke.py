#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

Usage: python3 chip_smoke.py [--seed S] [--outdir DIR]

Phases (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit) and build the
   CUDA kernels from ``pulsar_timing_gibbsspec_torch/ops/kernels/csrc``;
2. kernel parity: every kernel form the main path runs is held against
   its plain PyTorch version on the card, at the main path's shapes
   (64 chains x 45 pulsars, Bmax = 37, Nmax = 720), from a seeded state
   near the stationary region; each is timed (CUDA events, median of 30)
   beside its plain version, the PyTorch library equivalent and the
   least time the card could take (bytes over the HBM rate, operations
   over the peak rate of their type);
3. small-input agreement: the steady b-draw on a 3-pulsar model, with
   the same state and noise on the card and on the CPU;
4. main path: the synthetic 45-pulsar CRN free-spectrum array from
   ``--seed`` sampled by ``PTABlockGibbs(nchains=64)`` through 50
   warmup sweeps, adaptation and 240 steady sweeps; every record finite,
   every common log10_rho median inside the prior (-10, -4), every
   kernel form launched during this phase;
5. profile: ``torch.profiler`` over steady sweeps continuing from the
   main path's final state (after its launch counts are read): the
   device's idle share and kernel time by name over a window traced on
   the device alone, and kernel launches per block and per white MH
   step from a second window traced on the host as well.

The kernels' JSON record and the card as ``nvidia-smi`` reports it are
the two lines before the last; the last line is the JSON result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth; the card's peak rate for
#: each type (float32 outside the tensor cores, since TF32 is not float32;
#: float64 through the tensor cores, the card's fastest IEEE float64)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 67e12}
EPS = {"f32": 2.0 ** -23, "f64": 2.0 ** -52}
_PALLAS = "pulsar_timing_gibbsspec_tpu/ops/kernels/pallas_tpu.py"
_CSRC = "pulsar_timing_gibbsspec_torch/ops/kernels/csrc"
REPLACES = {"chol_solve_sample": f"{_PALLAS}:33",
            "gram_accumulate": f"{_PALLAS}:61"}
SOURCES = {"chol_solve_sample": f"{_CSRC}/chol_solve_sample.cu",
           "gram_accumulate": f"{_CSRC}/gram_accumulate.cu"}
#: the device the run drives
DEVICE = "cuda"
#: the main path: chains, warmup sweeps, steady sweeps after adaptation
NCHAINS, WARMUP, STEADY = 64, 50, 240
#: steady sweeps traced on the device alone, and with the host as well
PROFILE_SWEEPS, PROFILE_HOST_SWEEPS = 6, 2


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=30, warm=3):
    """Median device milliseconds of ``fn()`` over ``reps`` calls, each
    between two CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    ts.sort()
    return ts[len(ts) // 2]


def bound_ms(nbytes, flops, kind):
    """Least time for the work: the larger of bytes over the HBM rate and
    operations over the peak rate of ``kind``; and which one it is."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[kind]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def parity_state(cm, C, gen):
    """A seeded state near the sampler's stationary region: efac in
    [0.8, 1.2], equad in [-8.5, -6.5], the common log10_rho at the
    injected power law (log10_A = log10(2e-15), gamma = 13/3) +-0.3 dex,
    the red log10_rho in [-9, -8.5]."""
    import torch

    from pulsar_timing_gibbsspec_torch.data.simulate import (YEAR,
                                                              powerlaw_psd)

    u = torch.rand((C, cm.nx), generator=gen, dtype=torch.float64,
                   device=gen.device).to(cm.device)
    x = torch.zeros((C, cm.nx), dtype=torch.float64, device=cm.device)
    Tspan = 15.0 * YEAR
    for j, nm in enumerate(cm.param_names):
        if nm.endswith("_efac"):
            x[:, j] = 0.8 + 0.4 * u[:, j]
        elif nm.endswith("_log10_tnequad"):
            x[:, j] = -8.5 + 2.0 * u[:, j]
        elif "red_noise_log10_rho" in nm:
            x[:, j] = -9.0 + 0.5 * u[:, j]
        elif nm.startswith("gw_crn_log10_rho_"):
            k = int(nm.rsplit("_", 1)[1])
            phi = powerlaw_psd((k + 1) / Tspan, math.log10(2e-15),
                               13.0 / 3.0, 1.0 / Tspan)
            x[:, j] = 0.5 * math.log10(phi) + 0.6 * (u[:, j] - 0.5)
    return x


def gram_parity(cm, x, timer):
    """Phase 2, Gram: the three kernel forms against the plain version.
    The difference is measured at the Jacobi scale sqrt(G_ii G_jj), and
    the tolerance is twice the rigorous accumulation bound (m + nseg) eps
    of either side (Cauchy-Schwarz bounds every partial sum's products
    by the Jacobi scale)."""
    import torch

    from pulsar_timing_gibbsspec_torch.config import settings
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    TNa, Ta = blocks._gram_operands(cm, cm.ndiag_fast(x),
                                    settings.gram_seg_len)
    C = TNa.shape[0]
    TNa = TNa.reshape((-1,) + TNa.shape[-3:]).contiguous()
    Bt, nseg, m, B1 = TNa.shape
    recs, ok = {}, True
    for form, odt, widen in (("f32", torch.float32, False),
                             ("f32_dot_f64_reduce", torch.float64, False),
                             ("widen_f64", torch.float64, True)):
        def run_k():
            return kernels.gram_accumulate(TNa, Ta, out_dtype=odt,
                                           widen=widen)

        def run_p():
            return kernels.reference.gram_accumulate_ref(
                TNa, Ta, out_dtype=odt, widen=widen)

        Gk, Gp = run_k(), run_p()
        dg = torch.sqrt(torch.clamp(
            torch.diagonal(Gp, dim1=-2, dim2=-1).double(), min=1e-300))
        diff = (Gk.double() - Gp.double()).abs()
        err = (diff / (dg[:, :, None] * dg[:, None, :])).max().item()
        tol = 2.0 * (m + nseg) * EPS["f64" if widen else "f32"]
        good = bool(torch.isfinite(Gk).all()) and err <= tol
        ok &= good
        ms_k, ms_p = timer(run_k), timer(run_p)
        # one unsegmented torch.matmul (float64 forms: on float64 copies
        # of the operands, made outside the timing)
        A = TNa.reshape(C, cm.P, nseg * m, B1).transpose(-1, -2).to(odt)
        B = Ta.reshape(cm.P, nseg * m, B1).to(odt)
        lib = timer(lambda: torch.matmul(A, B))
        obytes = 4 if odt == torch.float32 else 8
        nbytes = (TNa.numel() + Ta.numel()) * 4 + Bt * B1 * B1 * obytes
        flops = 2.0 * Bt * nseg * m * B1 * B1
        bms, bby = bound_ms(nbytes, flops, "f64" if widen else "f32")
        recs[("gram_accumulate", form)] = dict(
            max_abs_err=diff.max().item(), ms=ms_k, plain_ms=ms_p,
            bound_ms=bms, bound_by=bby, library_ms=lib)
        print(f"phase 2 gram_accumulate[{form}]: max |kernel-plain| / "
              f"Jacobi scale {err:.3e} (tol {tol:.3e}) "
              f"{'ok' if good else 'FAIL'}; kernel {ms_k:.4f} ms, plain "
              f"{ms_p:.4f} ms, torch.matmul {lib:.4f} ms, bound "
              f"{bms:.4f} ms ({bby})", flush=True)
    return recs, ok


def chol_parity(cm, x, gen, timer):
    """Phase 2, factor chain: the float32 kernel's error against a
    float64 evaluation of the same float32 inputs must stay in the plain
    float32 chain's class (at most 8x its error plus 64 eps of the
    output's scale), and the float64 kernel must match the float64 chain
    to 1e-8 of the output's scale."""
    import torch

    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    TNT, d = blocks.tnt_d_seg32(cm, cm.ndiag_fast(x))
    n = cm.Bmax
    phi32 = cm.phi(x, dtype=torch.float32)
    eye = torch.eye(n, dtype=torch.float32, device=cm.device)
    Sig = (TNT + (1.0 / phi32)[..., :, None] * eye).reshape(-1, n, n)
    d = d.reshape(-1, n).contiguous()
    z = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=gen.device).to(cm.device)
    ridge = blocks._PROP_RIDGE
    ref = kernels.reference.chol_solve_sample_ref

    def run_k():
        return kernels.chol_solve_sample(Sig, d, z, ridge=ridge)

    def run_p():
        return ref(Sig, d, z, ridge=ridge)

    K, Pl = run_k(), run_p()
    R = ref(Sig.double(), d.double(), z.double(), ridge=ridge)
    K64 = kernels.chol_solve_sample(Sig.double(), d.double(), z.double(),
                                    ridge=ridge)
    ok, mae = True, 0.0
    for name, k, p, r, k64 in zip(("L", "Li", "dj", "mean", "bp"), K, Pl, R,
                                  K64):
        rmax = r.abs().max().item()
        ek = (k.double() - r).abs().max().item()
        ep = (p.double() - r).abs().max().item()
        e64 = (k64 - r).abs().max().item()
        tol = 8.0 * ep + 64.0 * EPS["f32"] * rmax
        good = (bool(torch.isfinite(k).all()) and ek <= tol
                and e64 <= 1e-8 * rmax)
        ok &= good
        mae = max(mae, (k - p).abs().max().item())
        print(f"phase 2 chol_solve_sample {name}: |kernel-f64| {ek:.3e}, "
              f"|plain-f64| {ep:.3e}, tol {tol:.3e}; float64 kernel "
              f"{e64:.3e} (tol {1e-8 * rmax:.3e}) {'ok' if good else 'FAIL'}",
              flush=True)

    def library_chain():
        dj = 1.0 / torch.sqrt(torch.diagonal(Sig, dim1=-2, dim2=-1))
        A = Sig * dj[:, :, None] * dj[:, None, :] + ridge * eye
        L = torch.linalg.cholesky(A)
        Li = torch.linalg.solve_triangular(L, eye.expand_as(A), upper=False)
        w = torch.linalg.solve_triangular(L, (dj * d)[..., None],
                                          upper=False)
        mz = torch.linalg.solve_triangular(
            L.transpose(-1, -2), torch.cat([w, z[..., None]], -1),
            upper=True)
        mean = dj * mz[..., 0]
        return L, Li, dj, mean, mean + dj * mz[..., 1]

    ms_k, ms_p, lib = timer(run_k), timer(run_p), timer(library_chain)
    Bt = Sig.shape[0]
    nbytes = Bt * (3 * n * n + 5 * n) * 4
    flops = Bt * (2.0 * n ** 3 / 3.0 + 6.0 * n * n)
    bms, bby = bound_ms(nbytes, flops, "f32")
    print(f"phase 2 chol_solve_sample[f32]: {'ok' if ok else 'FAIL'}; max "
          f"|kernel-plain| {mae:.3e}; kernel {ms_k:.4f} ms, plain "
          f"{ms_p:.4f} ms, cholesky+solve_triangular chain {lib:.4f} ms, "
          f"bound {bms:.4f} ms ({bby})", flush=True)
    return {("chol_solve_sample", "f32"): dict(
        max_abs_err=mae, ms=ms_k, plain_ms=ms_p, bound_ms=bms,
        bound_by=bby, library_ms=lib)}, ok


def small_agreement(dev, seed):
    """Phase 3: the steady b-draw core on a 3-pulsar model with the same
    state and noise on ``dev`` and on the CPU: equal accept masks and
    proposals within 1e-3 of each pulsar's largest coefficient (the
    float32 proposal's conditioning class)."""
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import synthetic_array
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    small = synthetic_array(npsr=3, seed=seed + 1, ntoa_max=150)
    cm_d = ptt.build_crn_spectrum(small, nbins=4, red_bins=4, device=dev)
    cm_c = ptt.build_crn_spectrum(small, nbins=4, red_bins=4, device="cpu")

    def g(s):
        return torch.Generator().manual_seed(seed + s)

    x = parity_state(cm_c, 4, g(0))
    b = blocks.draw_b_fn_core(cm_c, x, torch.randn(
        (4, cm_c.P, cm_c.Bmax), dtype=torch.float64, generator=g(1)))
    u = blocks.b_matvec(cm_c, b)
    z = torch.randn(b.shape, dtype=torch.float32, generator=g(2))
    logu = torch.log(torch.rand(b.shape[:-1], dtype=torch.float64,
                                generator=g(3)))
    bc, _, ac = blocks.draw_b_mh_core(cm_c, x, b, u, z, logu)
    bd, _, ad = blocks.draw_b_mh_core(*(t.to(dev) if torch.is_tensor(t)
                                        else t for t in
                                        (cm_d, x, b, u, z, logu)))
    err = ((bd.cpu() - bc).abs()
           / bc.abs().amax(-1, keepdim=True)).max().item()
    same = bool(torch.equal(ad.cpu(), ac))
    ok = same and err <= 1e-3
    print(f"phase 3 small-input b-draw, card vs CPU: accept masks "
          f"{'equal' if same else 'DIFFER'}, max |b_card - b_cpu| / "
          f"max|b| {err:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def _busy_ms(events):
    """Milliseconds of the union of the events' device intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def profile_steady(drv):
    """Phase 5: steady b_mh sweeps from the main path's final state under
    ``torch.profiler``.  Window 1 traces the device alone: its idle share
    is 1 - (union of the device's kernel and copy intervals) / (host wall
    of the window, synchronized at both ends), and its kernel time by
    name.  Window 2 adds the host: the kernel launch calls
    (``cu*LaunchKernel*``) inside each ``block:<name>`` range give the
    launches per block and per white MH step.  The profiler slows the
    host, so window 1's idle share is an upper bound of the unprofiled
    run's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pulsar_timing_gibbsspec_torch.sampler import blocks

    x, b = drv.x, drv.b
    u = blocks.b_matvec(drv.cm, b)

    def sweeps(n, x, b, u):
        for _ in range(n):
            x, b, u = drv._sweep(x, b, u, exact=False)
        return x, b, u

    x, b, u = sweeps(1, x, b, u)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        x, b, u = sweeps(PROFILE_SWEEPS, x, b, u)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kern = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    if not kern:
        raise RuntimeError("the device trace holds no kernel")
    by_name = {}
    for e in kern:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += (e.time_range.end - e.time_range.start) / 1e3
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    busy = _busy_ms(dev)
    print(f"phase 5 device trace, {PROFILE_SWEEPS} steady b_mh sweeps: "
          f"host wall {wall / PROFILE_SWEEPS:.3f} ms per sweep, device "
          f"busy {busy / PROFILE_SWEEPS:.3f} ms per sweep, idle share "
          f"{1.0 - busy / wall:.4f}; {len(kern) / PROFILE_SWEEPS:.1f} "
          f"kernels and {(len(dev) - len(kern)) / PROFILE_SWEEPS:.1f} "
          "copies per sweep", flush=True)
    print("phase 5 kernel ms per sweep by name (count per sweep): "
          + json.dumps([[n[:80], round(t / PROFILE_SWEEPS, 4),
                         c / PROFILE_SWEEPS] for n, (t, c) in top]),
          flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sweeps(PROFILE_HOST_SWEEPS, x, b, u)
        torch.cuda.synchronize()
    evs = prof.events()
    ranges = [(e.name[len("block:"):], e.time_range) for e in evs
              if e.name.startswith("block:")
              and e.device_type == DeviceType.CPU]
    launches = [e.time_range.start for e in evs
                if e.device_type == DeviceType.CPU
                and "LaunchKernel" in e.name]
    per_block = dict.fromkeys(sorted({n for n, _ in ranges}), 0)
    for n, r in ranges:
        per_block[n] += sum(r.start <= t <= r.end for t in launches)
    steps = PROFILE_HOST_SWEEPS * (drv.aclength_white or 0)
    print(f"phase 5 host trace, {PROFILE_HOST_SWEEPS} steady b_mh sweeps: "
          f"kernel launches per sweep {len(launches) / PROFILE_HOST_SWEEPS}"
          ", by block " + json.dumps(
              {k: v / PROFILE_HOST_SWEEPS for k, v in per_block.items()})
          + f"; per white MH step {per_block.get('white', 0) / max(steps, 1):.1f}",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--outdir", default="build/chip_smoke")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import pulsar_timing_gibbsspec_torch as ptt
        from pulsar_timing_gibbsspec_torch.data import synthetic_array
        from pulsar_timing_gibbsspec_torch.ops import kernels
        from pulsar_timing_gibbsspec_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run it "
              "from the repository root", file=sys.stderr)
        return 2

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.library(verbose=True)
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device(DEVICE)
    C = NCHAINS
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    psrs = synthetic_array(npsr=45, seed=args.seed)
    cm = ptt.build_crn_spectrum(psrs, nbins=10, red_bins=10, device=dev)
    print(f"model: P={cm.P} Nmax={cm.Nmax} Bmax={cm.Bmax} nx={cm.nx}, "
          f"{C} chains", flush=True)
    x = parity_state(cm, C, gen)
    records, ok_g = gram_parity(cm, x, cuda_ms)
    rec_c, ok_c = chol_parity(cm, x, gen, cuda_ms)
    records.update(rec_c)
    if not (ok_g and ok_c):
        print("chip_smoke: kernel parity failed", file=sys.stderr)
        return 1
    if not small_agreement(dev, args.seed):
        print("chip_smoke: small-input agreement failed", file=sys.stderr)
        return 1

    # ---- phase 4: the main path, launch counts from 0 ----------------------
    niter = WARMUP + 1 + STEADY
    kernels.reset_launches()
    t0 = time.perf_counter()
    g = ptt.PTABlockGibbs(cm, nchains=C, device=dev, seed=args.seed,
                          warmup_sweeps=WARMUP)
    x0 = g.initial_sample(torch.Generator(device=dev).manual_seed(
        args.seed))
    chain = g.sample(x0, outdir=args.outdir, niter=niter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"chol_solve_sample":
                dict(kernels.chol_solve_sample.form_launches),
                "gram_accumulate":
                dict(kernels.gram_accumulate.form_launches)}
    drv = g.driver
    sps = drv.steady_sweeps / drv.steady_seconds
    acc = drv.b_mh_accepts[:, :cm.P_real] / max(drv.b_mh_sweeps, 1)
    rho = chain[WARMUP + 1:, :, cm.rho_ix_x.cpu().numpy()]
    med = np.median(rho.reshape(-1, rho.shape[-1]), axis=0)
    per_block = {k: round(v / drv.steady_sweeps, 4)
                 for k, v in sorted(drv.timer.ms.items())}
    print(f"phase 4 main path: {niter} rows x {C} chains in {wall:.1f} s "
          f"(warmup {WARMUP}); white sub-chain "
          f"{drv.aclength_white} steps; steady {drv.steady_sweeps} sweeps "
          f"in {drv.steady_seconds:.3f} s = {sps:.3f} sweeps/s = "
          f"{sps * C:.1f} samples/s", flush=True)
    print("phase 4 per-block ms per steady sweep (CUDA events): "
          + json.dumps(per_block), flush=True)
    print("phase 4 warmup block ms in all (CUDA events): " + json.dumps(
        {k: round(v, 1) for k, v in sorted(drv.warmup_ms.items())}),
        flush=True)
    print(f"phase 4 draw_b_mh acceptance: mean {acc.mean().item():.4f}, "
          f"min over (chain, pulsar) {acc.min().item():.4f}", flush=True)
    print("phase 4 common log10_rho medians per bin: "
          + json.dumps([round(float(v), 3) for v in med]), flush=True)
    print("phase 4 kernel launches: " + json.dumps(launches), flush=True)
    print(f"phase 4 non-finite Laplace blocks in warmup and adaptation: "
          f"{int(drv.laplace_nonfinite)} of "
          f"{(WARMUP + 1) * C * cm.P_real}", flush=True)
    finite = bool(np.isfinite(chain).all())
    inside = bool(((med > -10.0) & (med < -4.0)).all())
    missing = [f"{k}[{f}]" for (k, f) in records if launches[k][f] == 0]
    if not finite or not inside or missing:
        print(f"chip_smoke: main path failed (finite={finite}, medians "
              f"inside the prior={inside}, never launched={missing})",
              file=sys.stderr)
        return 1
    profile_steady(drv)

    print(json.dumps({"kernels": [
        dict(name=f"{k}[{f}]", route="cuda", source=SOURCES[k],
             replaces=REPLACES[k], launches=launches[k][f], **r)
        for (k, f), r in records.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
