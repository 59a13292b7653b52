#!/usr/bin/env python3
"""The port's driver against the JAX driver on the CPU: white and ECORR
sub-chain lengths under kernel ECORR, ``red_mh`` acceptance on the array
with red powerlaw noise, and ``b_mh`` acceptance with a DM GP.

Usage: python3 tools/torch_subchain_probe.py {ke,red,dm} [--chains C]
[--warmup W] [--steady S] [--red-adapt N] [--seed 0] [--small]

Each case builds one model in both packages from the same pulsars and
samples it with each package's facade on the CPU, same seed, chains and
depth (the two packages' random streams differ, so the comparison is of
rates, chain by chain and over chains):

- ``ke``: ``chip_smoke.py`` phase 13's model (J1713+0747 from the par/tim
  pair ``chip_smoke.write_quickstart_partim`` writes, kernel ECORR,
  ``PulsarBlockGibbs(ecorrsample="kernel")``).  Prints each driver's
  white and ECORR sub-chain lengths (the 95th percentile of the
  adaptation record's integrated ACTs, capped at 64) and the ACTs before
  the cap, and the port's ``driver._act_from_rec`` on the JAX driver's
  own adaptation records beside the JAX value from the same records.
- ``red``: ``chip_smoke.py`` phase 9's model (R2: the synthetic 45-pulsar
  array, common free spectrum, red powerlaw; ``PTABlockGibbs``).  Prints
  per chain the share of steady sweeps whose red hypers moved (the
  ``red_mh`` block's 20 steps accepted at least once) and their mean
  squared jump per sweep over the prior widths, on both sides, and the
  port's per-step acceptance.
- ``dm``: ``chip_smoke.py`` phase 12's model (J1713+0747, white noise
  fixed from a seeded noise dictionary, turnover common process, red and
  DM powerlaws, BayesEphem; ``PulsarBlockGibbs``).  Prints per chain the
  share of steady Metropolised b-draws (the sweeps off the refresh grid)
  whose b moved, on both sides, and the same model without the DM GP;
  ``--small`` puts the model on a 120-TOA synthetic NANOGrav-flagged
  pulsar with 10 bins.

One JSON line per case on standard output; progress on standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _jax_pulsar(p):
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar

    return Pulsar(**dataclasses.asdict(p))


def run_both(psrs, facade, model_kw, drv_kw, niter, tmp, jax_psrs=None,
             kernel=False):
    """Sample ``model_general(psrs, **model_kw)`` with each package's
    ``facade``; returns ``(jax facade, jax chain, port facade, port
    chain, JAX ACT records)``, the records being ``(record, nper, the
    JAX ACT)`` of each ``_act_from_rec`` call of the JAX driver."""
    import numpy as np

    import pulsar_timing_gibbsspec_torch as ptt
    import pulsar_timing_gibbsspec_tpu.sampler.gibbs as jgibbs
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.jax_backend import \
        JaxGibbsDriver

    from pulsar_timing_gibbsspec_torch.sampler import driver as tdriver

    jp = jax_psrs or [_jax_pulsar(p) for p in psrs]
    pta = model_general(jp, **model_kw)
    x0 = pta.initial_sample(np.random.default_rng(0))
    # white noise starts at EFAC 1 and small EQUAD/ECORR, powerlaws at a
    # moderate amplitude: the JAX exact b-draw returns NaN where a prior
    # draw makes a float32 Gram indefinite (ROADMAP C.1), which stops its
    # run
    for j, nm in enumerate(pta.param_names):
        for end, v in (("_efac", 1.0), ("_log10_tnequad", -8.0),
                       ("_log10_ecorr", -7.0), ("_log10_A", -14.5),
                       ("_gamma", 3.0)):
            if nm.endswith(end):
                x0[j] = v
    extra = dict(ecorrsample="kernel") if kernel else {}
    records = {"jax": [], "torch": []}
    act, tact = JaxGibbsDriver._act_from_rec, tdriver._act_from_rec

    def spy(self, rec, nper, pct=95.0):
        out = act(self, rec, nper, pct)
        records["jax"].append((np.asarray(rec), np.asarray(nper), out))
        return out

    def tspy(rec, nper, P_real, pct=95.0):
        out = tact(rec, nper, P_real, pct)
        records["torch"].append(out)
        return out

    JaxGibbsDriver._act_from_rec = spy
    tdriver._act_from_rec = tspy
    try:
        t0 = time.perf_counter()
        jg = getattr(jgibbs, facade)(pta, backend="jax", progress=False,
                                     **extra, **drv_kw)
        jchain = jg.sample(x0, outdir=str(tmp / "jax"), niter=niter)
        print(f"jax: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        cm = ptt.model_general(psrs, device="cpu", kernel_ecorr=kernel,
                               **model_kw)
        t0 = time.perf_counter()
        tg = getattr(ptt, facade)(cm, device="cpu", progress=False, **extra,
                                  **drv_kw)
        tchain = tg.sample(x0, outdir=str(tmp / "torch"), niter=niter)
        print(f"torch: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    finally:
        JaxGibbsDriver._act_from_rec = act
        tdriver._act_from_rec = tact
    return jg, jchain, tg, tchain, records


def moved(rows):
    """Per chain, the share of consecutive rows (C axis second) that
    differ."""
    import numpy as np

    d = np.diff(rows, axis=0)
    return (np.abs(d).reshape(d.shape[0], d.shape[1], -1).max(-1)
            > 0).mean(0)


def case_ke(args, tmp):
    import chip_smoke
    from pulsar_timing_gibbsspec_torch.data import load_pulsar
    from pulsar_timing_gibbsspec_torch.sampler.driver import _act_from_rec
    from pulsar_timing_gibbsspec_tpu.data import load_pulsar as jload

    par, tim = chip_smoke.write_quickstart_partim(tmp / "partim")
    psr = load_pulsar(par, tim, inject=chip_smoke.QS_INJECT)
    jpsr = jload(par, tim, inject=chip_smoke.QS_INJECT)
    kw = dict(red_var=False, white_vary=True, common_psd="spectrum",
              common_components=chip_smoke.SINGLE_BINS)
    jg, _, tg, _, recs = run_both(
        [psr], "PulsarBlockGibbs", kw,
        dict(nchains=args.chains, seed=args.seed,
             warmup_sweeps=args.warmup),
        args.warmup + 1 + args.steady, tmp, jax_psrs=[jpsr], kernel=True)
    jd, td = jg._backend, tg.driver
    return {"case": "ke", "chains": args.chains, "warmup": args.warmup,
            "seed": args.seed,
            "jax": {"aclength_white": jd.aclength_white,
                    "aclength_ecorr": jd.aclength_ecorr,
                    "act_uncapped": [int(r[2]) for r in recs["jax"]]},
            "torch": {"aclength_white": td.aclength_white,
                      "aclength_ecorr": td.aclength_ecorr,
                      "act_uncapped": recs["torch"]},
            "on_jax_records": [{"block": blk, "jax_act": int(out),
                                "torch_act": _act_from_rec(
                                    rec, nper, jd.cm.P_real)}
                               for blk, (rec, nper, out) in
                               zip(("white", "ecorr"), recs["jax"])]}


def case_red(args, tmp):
    import numpy as np

    from pulsar_timing_gibbsspec_torch.data import synthetic_array

    psrs = synthetic_array(npsr=45, seed=args.seed)
    kw = dict(tm_svd=True, white_vary=True, common_psd="spectrum",
              common_components=10, red_psd="powerlaw", red_components=10)
    W = args.warmup
    jg, jchain, tg, tchain, _ = run_both(
        psrs, "PTABlockGibbs", kw,
        dict(nchains=args.chains, seed=args.seed, warmup_sweeps=W),
        W + 1 + args.steady, tmp)
    red = np.asarray(tg.cm.idx.red)
    jm = moved(jchain[W + 1:][:, :, red])
    tm = moved(tchain[W + 1:][:, :, red])
    # mean squared jump of the hypers per sweep over the squared prior
    # widths: a chain whose steps are mostly rejected jumps less
    width = (tg.cm.pb - tg.cm.pa).numpy()[red]
    jump = [np.mean((np.diff(ch[W + 1:][:, :, red], axis=0) / width) ** 2,
                    axis=(0, 2)) for ch in (jchain, tchain)]
    drv = tg.driver
    step = (drv.red_mh_accepts / max(drv.red_steps * drv.red_mh_sweeps, 1))
    return {"case": "red", "chains": args.chains, "warmup": W,
            "steady": args.steady,
            "jax_moved_share": [round(float(v), 4) for v in jm],
            "torch_moved_share": [round(float(v), 4) for v in tm],
            "torch_step_acceptance": [round(float(v), 4)
                                      for v in step.tolist()],
            "jax_jump": [float(f"{v:.4g}") for v in jump[0]],
            "torch_jump": [float(f"{v:.4g}") for v in jump[1]],
            "means": [round(float(jm.mean()), 4), round(float(tm.mean()), 4)]}


def case_dm(args, tmp):
    import numpy as np

    import chip_smoke
    from pulsar_timing_gibbsspec_torch.data import (load_enterprise_snapshot,
                                                     synthetic_array,
                                                     synthetic_noisedict)

    if args.small:
        snap = synthetic_array(npsr=3, seed=1, ntoa_min=71,
                               ntoa_max=120)[2]
        snap.flags = {"pta": "NANOGrav"}
        bins = 10
    else:
        snap = load_enterprise_snapshot(ROOT / chip_smoke.SNAPSHOT)
        bins = chip_smoke.N12_BINS
    W = args.warmup
    out = {"case": "dm", "pulsar": snap.name, "bins": bins,
           "chains": args.chains, "warmup": W, "steady": args.steady}
    for label, dm in (("with DM", True), ("without DM", False)):
        kw = dict(white_vary=False,
                  noisedict=synthetic_noisedict([snap], args.seed),
                  common_psd="turnover", gamma_common=13.0 / 3.0,
                  common_components=bins, red_psd="powerlaw",
                  red_components=bins, dm_var=dm, dm_components=bins,
                  bayesephem=True)
        jg, jchain, tg, tchain, _ = run_both(
            [snap], "PulsarBlockGibbs", kw,
            dict(nchains=args.chains, seed=args.seed, warmup_sweeps=W,
                 red_adapt_iters=args.red_adapt),
            W + 1 + args.steady, tmp / label.replace(" ", "_"))
        ee = tg.driver.exact_every
        # row t + 1 - (W + 1) holds the state after steady sweep t
        t = np.arange(W + 1, W + 1 + args.steady - 1)
        keep = t % ee != 0
        share = [(np.abs(np.diff(ch[W + 1:], axis=0)).max(-1) > 0)[keep]
                 .mean(0) for ch in (jg.bchain, tg.bchain)]
        drv = tg.driver
        out[label] = {
            "jax_b_mh_moved": [round(float(v), 4) for v in share[0]],
            "torch_b_mh_moved": [round(float(v), 4) for v in share[1]],
            "torch_b_mh_acceptance": [
                round(float(v), 4) for v in
                (drv.b_mh_accepts[:, 0] / max(drv.b_mh_sweeps, 1)).tolist()],
            "means": [round(float(share[0].mean()), 4),
                      round(float(share[1].mean()), 4)]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=("ke", "red", "dm"))
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--steady", type=int, default=60)
    ap.add_argument("--red-adapt", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true",
                    help="dm: the model on JSYN02, a 120-TOA synthetic "
                    "NANOGrav-flagged pulsar, 10 bins (the JAX compile of "
                    "the snapshot's model can exhaust a small host's "
                    "memory)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as d:
        res = {"ke": case_ke, "red": case_red, "dm": case_dm}[args.case](
            args, Path(d))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
