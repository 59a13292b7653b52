#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

Usage: python3 chip_smoke.py [--seed S] [--outdir DIR] [--steady N]

(``DIR``, default ``build/chip_smoke``, receives phase 13's par/tim
pair, the checkpoint directories of phases 3b-25 and phase 23's flight
recorder capture; ``N``, default
240, is the steady sweeps of the main paths of phases 4, 7, 11 and 18:
a deeper run reads what checkpoints cost as the record grows.)

Phases (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit) and build the
   CUDA kernels from ``pulsar_timing_gibbsspec_torch/ops/kernels/csrc``;
2. kernel parity: every kernel form the main path runs is held against
   its plain PyTorch version on the card, at the main path's shapes
   (64 chains x 45 pulsars, Bmax = 37, Nmax = 720), from a seeded state
   near the stationary region; each is timed (device time from
   ``torch.profiler``, mean of 10 calls, and CUDA events around each
   call, median of 10; for a call slower than 20 ms one traced call and
   two by events; where the trace loses kernels, calls back to back
   between two CUDA events) beside its
   plain version, the PyTorch library
   equivalent and the least time the card could take (bytes over the HBM
   rate, operations over the peak rate of their type).
   The wide forms likewise at the single-pulsar path's shape (README's
   Quick-start model of the J1713+0747 snapshot, 30 bins, 8 chains:
   Bmax = 673, Nmax = 720), the wide factor also held to the plain
   chain's backward error; the wide
   forms' launch configuration (the factor's cluster size, the
   Gram's output tile, threads, dynamic shared memory) is printed
   beside the ``cuobjdump`` resources;
3. small-input agreement: the steady b-draw on a 3-pulsar model, with
   the same state and noise on the card and on the CPU;
3b. graphs against eager: on the 45-pulsar model at 64 chains, after a
   short eager run has adapted the sampler, 9 steady sweeps from
   iteration 8 (16 a refresh) from one state replayed from the CUDA
   graphs equal the eager sweeps bitwise in x, b and the b_mh
   acceptance counts;
4. main path: the synthetic 45-pulsar CRN free-spectrum array from
   ``--seed`` sampled by ``PTABlockGibbs(nchains=64)`` through 20
   warmup sweeps, adaptation and 240 steady sweeps replayed from the
   CUDA graphs, checkpointed every 100 sweeps into ``--outdir``; every
   record finite, every common log10_rho median inside the prior (-10,
   -4), the final checkpoint verified, and every kernel form run on the
   card during this phase, as the kernels' own device counters count it
   (eager runs and graph replays alike): each form the steady graphs hold
   replayed since the captures exactly as often as each capture's
   launches times its replays, and each form's runs equal to the host's
   eager launches plus those replays; with the device sketch on
   (``obs={"lags": 256}``, as ``bench.py``'s headline run): its common
   rho ACT (sweeps), ESS, ESS/s (chains x sweeps/s / ACT), ``rhat_max``
   and ``window_saturated``, beside the host Sokal ACT of the phase's own
   records and their ratio (gate: every steady sweep folded, a finite
   ACT >= 1); phase 17, without the sketch, is bitwise equal to this run;
5. profile: ``torch.profiler`` over steady sweeps of the driver's
   steady-chunk entry, continuing from the main path's graphs (after its
   launch counts are read): the device's idle share and kernel time by
   name over a window traced on the device alone, where the port's
   kernels, counted by name, must equal their device counters' growth
   and the graphs' replayed launches; and host launches (graph and
   kernel) per block, and the device's busy time inside each block, from
   a second window traced on the host as well;
6. (merged into 17 since the supervised run resumes the main path
   through the graphs at 64 chains, bitwise);
7. the single-pulsar main path: README's Quick-start model of
   ``tests/data/enterprise_J1713+0747.npz`` (basis ECORR, the inverse-CDF
   rho draw) sampled by ``PulsarBlockGibbs(nchains=8)`` through 5
   warmup sweeps, adaptation and 240 steady sweeps
   replayed from the CUDA graphs, checkpointed every 100 sweeps, with the
   launch counts set to 0 just before it: samples/s, per-block ms, the white and ECORR
   sub-chain lengths, the b_mh and refresh acceptance per chain, every
   record finite, every log10_rho median inside (-10, -4), the final
   checkpoint verified, every wide kernel form run on the card and each
   graphed one replayed as often as captured times replays; then (7b)
   9 graph-replayed steady sweeps bitwise equal to eager ones and (7c)
   at 8 chains, 5 warmup and 64 steady sweeps, a run whole and checkpointed
   at a chunk boundary, that checkpoint (the ``.bak`` generation,
   restored by ``integrity.rollback``) resumed in a fresh sampler, both
   through the graphs: ``chain.npy`` and ``bchain.npy`` bitwise equal
   (every "c" check below is this one);
8. the powerlaw hyper block, R1: the reference's complete single-pulsar
   sweep, ``model_general([J1713+0747], white_vary=True,
   common_psd="spectrum", red_psd="powerlaw")`` (30 bins each; white,
   ECORR, the red powerlaw MH with its DE history, rho by the grid draw,
   scale moves, b) by ``PulsarBlockGibbs(nchains=8)`` through 5 warmup
   sweeps, the adaptation (1000 MH steps on the b-marginalized
   likelihood, the float64 wide factor) and 515 steady sweeps from the
   graphs, checkpointed every 100, launch counts from 0: samples/s,
   per-block ms, the adaptation's seconds and float64 factor runs,
   red_mh acceptance per chain, the DE periods read from chain rows (at
   least one); every record finite, rho medians inside (-10, -4), every
   powerlaw hyper's median inside its prior, the final checkpoint
   verified, every wide form (``f64_wide`` too) run on the card and the
   graphed ones replayed as captured; (8b) 9 steady sweeps from
   iteration 504, across the DE period switch at 512, graphed equal to
   eager bitwise; (8c) a run split at row 390 (after 384, off the
   128-grid) and resumed equal to the whole run bitwise, both reading a
   DE period from chain rows;
9. R2: the 45-pulsar array with powerlaw red noise (10 bins, Bmax 37,
   90 powerlaw hypers) by ``PTABlockGibbs(nchains=64)``, depth cut to 3
   warmup and 24 steady sweeps and an adaptation of 1000 MH steps, the
   gates of 8 but the DE one (the float64 narrow factor must run); 9b.
   R3: ``model_general([J1713+0747], white_vary=True)`` (common and red
   powerlaw, 30 bins), 8 chains, 3 warmup and 24 steady sweeps, 1000
   adaptation steps, the gates of 9 without rho.
   Phase 2 also holds the float64 factor forms against their plain
   version on the marginalized likelihood's systems of R2 (2880 of order
   37) and R1 (8 of order 673), and the Gram's float32-product,
   float64-reduce form at the Hellings-Downs path's shape (B1 = 58, 32
   chains x 45 pulsars) against its plain version, timed beside it and
   float64 ``torch.matmul``;
10. the Hellings-Downs array: ``bench.py``'s HD model,
   ``model_general(psrs, tm_svd=True, white_vary=True,
   common_psd="spectrum", common_components=10, red_psd="spectrum",
   red_components=10, orf="hd")`` on the synthetic 45-pulsar array (the
   common process on columns of its own: Bmax = 57), by
   ``PTABlockGibbs(nchains=32)`` through 5 warmup sweeps (the float64
   joint b-draw), adaptation and 64 steady sweeps from the CUDA graphs
   (the two-float joint draw ``b_joint``, float64 ``b_joint_exact`` on
   every 16th), checkpointed every 100, launch counts from 0:
   samples/s, per-block ms, the warmup's ms, capture seconds and pool MB,
   the draws that kept their b by stage, the Gram form's runs; every
   record finite, every common log10_rho median inside (-10, -4), the
   final checkpoint verified, the Gram form run on the card and replayed
   as captured; (10b) 9 steady sweeps from iteration 296, across the
   refresh at 304, graphed equal to eager bitwise; (10c) 8 chains, 3
   warmup and 32 steady sweeps, a run split at row 20 and resumed equal
   to the whole run bitwise;
11. the array with the standard noise model: ``model_general(psrs,
   tm_svd=True, white_vary=False, noisedict=nd, common_psd="spectrum",
   common_components=10, red_psd="powerlaw", red_components=10,
   dm_var=True, dm_components=10, dm_annual=True)`` on the synthetic
   45-pulsar array, ``nd`` a noise dictionary in the NANOGrav key format
   seeded from ``--seed`` (``data.synthetic_noisedict``): fixed EFAC and
   EQUAD, a DM powerlaw GP on columns of its own, the annual DM sinusoid
   marginalized (Bmax = 17 + 20 + 20 + 2 = 59, the narrow forms), by
   ``PTABlockGibbs(nchains=64)`` through 20 warmup sweeps, the
   adaptation (the float64 narrow factor) and 240 steady sweeps from the
   graphs, checkpointed every 100, launch counts from 0: samples/s,
   per-block ms, the adaptation's seconds, red_mh acceptance, capture
   seconds and pool MB; the gates of 4 and 9 (every record finite,
   common log10_rho medians inside (-10, -4), every powerlaw hyper's
   median inside its prior, DM included, the final checkpoint verified,
   every narrow form run on the card and the graphed ones replayed as
   captured), and no white or ECORR block in the sweep; (11b) 17 steady
   sweeps from iteration 296, across the refresh at 304, graphed equal
   to eager bitwise; (11c) 8 chains, 3 warmup and 32 steady sweeps, a
   run split at row 20 and resumed equal to the whole run bitwise;
12. the single pulsar with the NANOGrav single-pulsar noise model:
   ``model_general([J1713+0747], white_vary=False, noisedict=nd,
   common_psd="turnover", gamma_common=13/3, common_components=30,
   red_psd="powerlaw", dm_var=True, dm_components=30, bayesephem=True)``
   (fixed EFAC/EQUAD, fixed ECORR on 508 columns, the 11 BayesEphem
   columns: Bmax = 744, the wide forms at an order they had not run at)
   by ``PulsarBlockGibbs(nchains=8)`` through 5 warmup sweeps, the
   adaptation (the float64 wide factor) and 495 steady sweeps, so the DE
   history reads chain rows; the gates of 8 but the rho one, and no
   white or ECORR block; (12c) a split-and-resumed run bitwise as 7c.
   Phase 2 also holds and times every kernel form of these two paths at
   their shapes: the narrow factor (float32 and float64) at 2880 systems
   of order 59, the narrow Gram's three forms at B1 = 60, and the wide
   factor (float32 and float64) and the wide Gram's three forms at 8
   systems of order 744 (B1 = 745);
13. README's Quick start from par/tim with kernel ECORR: a NANOGrav-
   style par/tim pair of J1713+0747 written into ``--outdir`` from the
   snapshot's TOAs, uncertainties, frequencies and flags (F0, F1,
   position, proper motion, parallax, 87 DMX windows, a JUMP, a DD
   binary with M2/SINI: the snapshot's 105 timing columns), read by
   ``load_pulsar(par, tim, inject=...)``; ``model_general([psr],
   red_var=False, white_vary=True, common_psd="spectrum",
   common_components=30, kernel_ecorr=True)`` (the 508 ECORR epochs in
   N: Bmax = 165) by ``PulsarBlockGibbs(nchains=8,
   ecorrsample="kernel")`` through 5 warmup sweeps, adaptation and 64
   steady sweeps from the graphs (one body: white, ECORR, rho and the
   exact b-draw, whose wide widening Gram runs at B1 = 166 every
   sweep), checkpointed every 100, launch counts from 0: samples/s,
   per-block ms, the sub-chain lengths, the Gram's runs; every record
   finite, log10_rho and log10_ecorr medians inside their priors, the
   final checkpoint verified, the Gram one launch in its graph and run
   once per steady sweep, replayed as captured.  13a, before it: the
   kernel-ECORR Gram (the widening kernel minus the Woodbury
   correction) on the card equal to the CPU's at one float32 N; (13b)
   9 graphed steady sweeps equal to eager ones bitwise; (13c) 8 chains,
   a split-and-resumed run bitwise;
14. the t-process array: ``model_general(psrs, tm_svd=True,
   white_vary=True, common_psd="spectrum", common_components=10,
   red_psd="tprocess", red_components=10)`` on the synthetic 45-pulsar
   array (450 InvGamma alphas drawn by their conjugate grid draw, 90
   powerlaw hypers) by ``PTABlockGibbs(nchains=64)`` through 5 warmup
   sweeps, the adaptation (1000 MH steps) and 385 steady sweeps (so the
   DE history reads
   chain rows), the gates of 9 with the DE one, every alpha finite and
   positive and moved; (14b) 9 steady sweeps from iteration 392,
   across the refresh at 400, graphed equal to eager bitwise; (14c) 8
   chains, split and resumed bitwise; (14d) ``red_psd="infinitepower"``
   on the array, 8 chains, 3 warmup and 16 steady sweeps: every record
   finite.  Phase 2 holds and times the wide widening Gram at phase
   13's shape (8 x 166), and holds every narrow form at phase 14's
   state (2880 x 37: the shapes phase 4 and R2 time, whose times its
   rows carry).
15. the frequency-grid and selection options (:func:`grid_paths`);
16. the sampled-ORF array: phase 10's model with ``orf="bin_orf"`` (7
   correlation weights, ``G(theta) = I + sum_j theta_j B_j``, their MH
   block ``orf_mh`` after rho) by ``PTABlockGibbs(nchains=32)`` through
   5 warmup sweeps, adaptation and 64 steady sweeps from the graphs,
   checkpointed every 100, launch counts from 0: phase 10's gates and
   prints, with ``orf_mh``'s ms and acceptance; G(theta) positive
   definite in every recorded row (host ``eigvalsh``), every weight
   moved in every chain and inside (-1, 1); (16b) 9 steady sweeps
   across the refresh at 304 graphed equal to eager bitwise; (16c) 8
   chains, split and resumed bitwise; (16d) phase 10's model at 32
   chains under ``PTGIBBS_HD_KERNEL=pulsar`` and ``=freq`` (the
   pulsar-wise and frequency-block b-draws), 3 warmup and 12 steady
   sweeps each: every record finite, rho medians inside (-10, -4), one
   steady sweep graphed equal to eager bitwise, the Gram form run on
   the card.  Phase 2 holds the Gram form at phase 16's state.
17. the resilient runtime on the main path: phase 4's model, seed, 64
   chains and sweeps under ``runtime.run_supervised`` (backoff sleeps
   injected, a ``DispatchWatchdog`` with a 3 s floor, checkpoints at
   every chunk), launch counts from 0, one fault of each class at rows
   of the steady part: the device error at the ``dispatch.chunk`` seam
   of row 121 (the ``device`` class), a stall at that seam of row 221
   past the watchdog's deadline (``stall``; the abandoned worker wakes
   while a later attempt samples), ``chain.npy`` truncated after the
   save at 121 (rolled back to ``.bak`` when the next attempt resumes),
   a NaN'd row 150 (a ``divergence``, then a rewind) and a drain request
   at row 221 (``preempted``), then a second incarnation after
   ``preemption.reset()`` on the same sampler.  Gates: the final chain
   and bchain bitwise phase 4's, the reports' classes, retries and
   statuses and the telemetry counters exactly the expected ones, the
   final checkpoint and its ``.bak`` verified, the narrow factor's and
   Gram's device counters risen.  Prints each incarnation's wall, the
   recovery cost over phase 4's wall, ``chunk_health``'s last values and
   phase 4's sweeps/s with the sentinels on; (17b) phase 4's model at 64
   chains, 3 + 24 sweeps, with ``record_precision="f32"`` and ``"bf16"``:
   final carries bitwise equal, the bf16 rows the bfloat16 rounding of
   the f32 rows to 1 ulp (in more than 0.9999 of entries), every f32 b
   row a float32 value.
18. the ensemble array: ``bench.py``'s ``ensemble=True, pt_ladder=2`` on
   phase 4's model and seed, 64 chains (the 32 with ``c % 2 == 0`` at
   beta = 1 are the posterior samples), the sketch on, 20 warmup and 240
   steady sweeps from the graphs (each steady sweep followed by the
   stage's ASIS redraw, stretch move and tempering swap, and every
   likelihood block of a hot chain at its beta: the narrow factor and
   Grams at ``N / beta``), checkpointed every 100, launch counts from 0:
   samples/s of the cold chains, per-block ms with ``asis``, ``stretch``
   and ``pt_swap``, the ensemble summary, the sketch's ACT and ESS/s (as
   phase 4).  Gates: every record finite; the cold chains' common
   log10_rho medians inside (-10, -4); per bin, over the steady rows past
   the first 80, the cold chains' mean of per-chain medians within 5
   combined standard errors of phase 4's; ``betas[0] == 1``, ``0 <
   betas[1] < 1``, every rung's swap rate in (0, 1), stretch acceptance
   above 0 at every temperature, ``sa_steps`` the steady sweeps; the
   kernel counters as phase 4's; the final checkpoint verified.  Phase 2
   then holds and times the float32 factor and the three narrow Gram
   forms at phase 18's final state with every chain at the hot rung's
   ``N / betas[1]``; (18b) 9 steady sweeps from iteration 264 (across the
   refresh at 272, both swap parities) graphed equal to eager bitwise in
   x, b, the counters, the ensemble state and the sketch; (18c) 8 chains
   with ``pt_ladder=2`` and the sketch, split and resumed bitwise, and a
   resume of that checkpoint with ``pt_ladder=1`` raises.
19. the collapsed rho draw: phase 4's model, seed and 64 chains with
   ``PTGIBBS_RHO_COLLAPSE=1`` (read when the driver is built: rho drawn
   with the per-pulsar red amplitudes integrated out over a 64-point
   quadrature, before the red draw), 20 warmup and 96 steady sweeps
   from the graphs, checkpointed every 100, launch counts from 0: rho and
   red ms per sweep, sweeps/s, samples/s, the draw alone against the
   conditional draw and its transient's peak memory.  Gates: the
   predicate holds; rho before red in the sweep; every common and red
   log10_rho record finite and inside its prior; per bin, past the first
   48 steady rows, the chains' mean of per-chain medians within 5
   combined standard errors of phase 4's; the kernel counters as phase
   4's; the final checkpoint verified.  Phase 2 holds and times the
   narrow forms at its final state; (19b) 9 steady sweeps from iteration
   104 (across the refresh at 112) graphed equal to eager bitwise.
20. the card's posterior against the oracle: before the first card
   phase the script starts a child process (no card, one BLAS thread)
   that runs README's Quick-start model of the snapshot on the port's
   NumPy oracle (``backend="numpy"``, one chain, float64 on the host):
   its adaptation sweep, then 1000 sweeps.  (20a) After phase 16d the
   card runs the same model at 32 chains, 50 warmup sweeps (the facades'
   default) and 400 steady sweeps from the graphs, launch counts from 0
   (every wide form run, replays as captured, the final checkpoint
   verified), and phase 2 holds and times the wide forms at its final
   state.
   (20b) At each chain's final b the card's ECORR block runs alone 200
   times; given b each backend's log10_ecorr has an exact
   one-dimensional law (its columns and prior from the oracle's float64
   host view), under which the draws' probability integral transform is
   uniform: per hyper, past 10 calls, its mean within 5 standard errors
   of 1/2 and its variance within 5 of 1/12.  Then the script waits for
   the child (failing past 1150 s of the run's clock, or if the child
   fails) and holds 20a's chains (past their first 100 steady rows)
   against the oracle's chain (past its first 100 rows): per common
   log10_rho bin and per white-noise hyper, |median difference| at most
   5 combined standard errors (each median's error its interquartile
   range over sqrt(ESS), the ESS from ``ops/acf.py``'s ACT window, of
   the card's chains together through their multi-chain
   autocorrelation), every white-noise hyper with an ESS of at least 20
   on both sides; the ECORR hypers (ACT of hundreds of sweeps on either
   side) have their z printed, and gated where both sides' ESS reach
   20.  Prints the oracle's sweeps/s and the host CPU's model name, and
   phase 4's samples/s with the oracle running beside it.
21. repeated device errors on the card: the Quick start at one chain (3
   warmup and 40 steady sweeps, chunks and checkpoints of 10, the white
   and ECORR adaptation on 120 steps), whole, and under
   ``run_supervised`` with the device error injected at the
   ``sample.loop`` seam from row 14, three times in a row
   (``degrade_after=3``, where the JAX package would move the run to its
   NumPy oracle): the run stays on the card.  Gates: the report
   completed with three device failures, ``degradations == 0`` in the
   report and the telemetry, ``rep.backend == "torch"``, no
   ``backend_degraded`` event; the chain and the b chain bitwise the
   whole card run's; the final checkpoint verified with
   ``layout.backend == "torch"``; the wide forms run on the card during
   the supervised run.  Phase 2 then holds and times the wide forms at
   one system, at the final state.  (Phase 17's report keeps 0
   degradations too.)
22. the tenant-multiplexed service (``serve.SamplerService``), after
   phase 20, launch counts from 0: ``BucketTable.ladder(10)``, 4 slots,
   chunks of 8 sweeps, a fair-share quantum of 24 chunks (one short of
   a job's 25), checkpoints every 5 chunks, ``bench.py``'s CRN model
   (10 + 10 bins) on the seeded 45-pulsar array (A) and a second one (B)
   (bucket (46, 1024, 60, 10): B1 61, the narrow Gram), a 30-pulsar
   array padded into that bucket (C, another signature), an 8-pulsar
   array of at most 120 TOAs (D, bucket (8, 128, 60, 10)), and a fifth
   45-pulsar array (E) submitted once a job is done; 200 sweeps a job.
   One group samples at a time, and a job that reaches its quantum
   while another waits yields its slot: A and B (B yields before its
   last chunk and is readmitted at once), then C, D and E in turns, E on
   A's captured program.  Gates: every job done, its records finite,
   its common log10_rho medians inside the prior, its checkpoint
   verified; one
   CUDA-graph capture per (bucket, signature, chunk) and none from E's
   admission on; the widening Gram run on the card as often as its
   eager launches plus each capture's launches times its replays.
   Prints aggregate samples/s, E's queueing and warm start (its first
   admission to its first chunk's rows), the captures and the phase's
   seconds.
   (22b) B alone in a service of 4 slots, through the same cached
   program: its chain and b chain bitwise equal to its multiplexed run
   (slot 1, evicted once, beside A), no capture more.  (22c) Phase 2
   holds and times the widening Gram at the stack's shape (184 systems,
   B1 61, N 184 x 1024).
23. the serving guards and the perf observatory, after 22 on its
   bucket table and arrays, launch counts from 0: one
   ``SamplerService(perf=True, breaker=, admission=, prewarm=1,
   clock=)`` (4 slots, chunks of 8, a checkpoint every chunk, a fresh
   program cache, an injected clock, ``max_queue`` 3) takes B as tenant
   1 (200 sweeps), A as tenant 0 NaN-poisoned at its second chunk
   (``poison_rows``) and E as tenant 4, then after the first chunk A
   again as tenant 5 and D (the 8-pulsar bucket, queued behind the full
   46-pulsar group, so it is prebuilt); A's breaker opens,
   its re-submission raises ``CircuitOpen``, a job pushes the queue to
   ``max_queue`` and the next submission is refused, and once the
   injected clock passes the cooldown (4 chunks later) A's half-open
   probe is admitted and closes the breaker.  A ``FlightRecorder`` on a second ``StageAggregator``
   (``band_k`` 5) is armed through the breach path: a 1 s ``stall`` at
   the ``chainstore.post_save`` seam inside B's checkpoint at row 96,
   which lies in a ``serve.writeback`` span.  Prints the
   ``dispatch_ms`` gauges per stage (p50, p90), the breaker's states by
   chunk (read after each step and at each dispatch), the refusals, the prewarm, ``compile_stalls`` and
   ``warm_hit_rate`` before and after the step that prebuilt D and at
   the end, and the capture's device
   events by name.  Gates: B bitwise equal to 22b's lone B; A
   quarantined once, readmitted and done, its breaker closed after one
   opening; both refusals typed; one prewarm and no compile stall at
   D's admission; every job's records finite and its final checkpoint
   verified; each kernel form the path launched run on the card as
   often as its eager launches plus each capture's launches times its
   replays; one capture whose merged Perfetto file holds the
   ``serve.*`` spans and at least one kernel or copy of the card.
24. the precision settings, each read from the environment while its
   model is built, launch counts from 0: (24) phase 4's array and seed
   under ``PTGIBBS_PRECISION=f64`` (float64 storage: T, y and N float64),
   64 chains, 20 warmup and 96 steady sweeps from the graphs,
   checkpointed every 100; (24b) the J1713+0747 Quick start (phase 7's
   model) under ``PTGIBBS_PRECISION=f64``, 8 chains, 5 + 96; (24c) the
   array under ``PTGIBBS_COMPUTE=f32`` (float32 state, reductions and
   factors) with ``PTGIBBS_GRAM_SEG=48``, 64 chains, 3 + 24.  Gates, for
   each: records finite, the medians of the common and red log10_rho and
   of every hyper with a uniform prior inside that prior, every kernel
   form of the path run on the card (the float64 storage paths: the
   ``f64`` / ``f64_wide`` Gram and factor forms, in the steady graphs,
   and no float32 Gram form; 24c: the float32 forms), each form's runs
   equal to its eager launches plus the captures' launches times their
   replays, the final checkpoint verified, 9 steady sweeps from the
   graphs bitwise equal to eager ones (24 and 24b across the refresh at
   112, 24c across the one at 32), each form held against its plain
   version at the path's final state; 24's common log10_rho per bin past
   the first 48 steady rows within 5 combined standard errors of phase
   4's.  Phase 2's rows of the ``f64`` Gram form (2880 x 720, B1 38), the
   ``f64_wide`` form at 8 chains and at one (B1 674) and the float64
   factor at the steady proposal's systems (2880 x 37, 8 x 673) are timed
   at those final states, and the float32 form at the 48-TOA segments
   at 24c's;
25. the array sharded over ranks (``mesh=``, ``parallel/sharding.py``):
   the array padded to 46 pulsars at 64 chains, 5 + 48 (its white
   block adapted on 250 steps, as the side paths'), unsharded and
   eager (the reference), then on two gloo ranks that share the card
   (``parallel.sharding.spawn``, pulsar mesh 2: 23 pulsars a rank,
   eager, since gloo's collectives cannot be captured), checkpointed
   every 24 sweeps; its chain bitwise equal to the reference's, or else
   within the class this phase prints (per common rho bin the chains'
   medians past 8 steady rows within 5 combined standard errors), the
   manifest verified, every kernel form of the path run on each rank
   (the ranks' device counters), and each form held against its plain
   version at the shard's shapes on each rank in turn (timed);
   samples/s beside the reference's and the card; 25c: the reference's
   own checkpoint at 5 + 1 + 24 (the ``.bak`` generation) resumed by
   ``integrity.reshard_restore`` on one rank, eager as the reference,
   to the end: bitwise equal to the reference's whole chain; then phase
   25's checkpoint at the same row resumed so on one rank, then again
   with ``device_count_change_on_resume`` armed (asked 2 ranks, given
   1): each its first 5 + 1 + 24 rows bitwise phase 25's, the two
   resumes bitwise equal to each other, and to phase 25's whole chain
   when 25 was bitwise the reference's; 25b:
   phase 4's array on a one-rank NCCL group on an explicit (1, 1) mesh,
   its steady sweep from CUDA graphs with the collectives captured, to
   W + 48: bitwise equal to phase 4's first rows, its kernels replayed
   as captured, each form held against its plain version.

To keep the whole run inside its time limit, every main path (4, 11,
17-19) runs 20 warmup sweeps and phase 7 and the side paths 8 and 12-16
5 (8, 12 and 14 run 15 more steady sweeps so their DE iterations stand;
20a runs the facades' 50), phases 9 and 9b 3 warmup and 24 steady
sweeps, the powerlaw adaptations of 8, 9, 9b, 11, 12, 14 and 15b 500
steps (the facades' default is 2000) and the white and ECORR
adaptation of 8-10 and 13-16 250 steps (the default 1000), 10 5 and 64,
13 and 16 64 steady
sweeps, 16d 3 and 12, 14d 3 and 16, the resume checks 11c-14c 3 and 32
(each resumes the whole run's own checkpoint: no second run to the
split), the graphs-against-eager checks 9 sweeps, and every resume and
graphs-against-eager check adapts its white and ECORR blocks on a
record of 120 steps; phase 2 times each kernel form once, at its path's
shape, beside its plain version and library call; phase 24 runs 96
steady sweeps on the array (as phase 19) and 24c 3 + 24, phase 25 48.
Every phase prints the run's seconds when it is done.

The kernels' JSON record and the card as ``nvidia-smi`` reports it are
the two lines before the last; the last line is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

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
#: each kernel's source: narrow form, wide form
SOURCES = {"chol_solve_sample": (f"{_CSRC}/chol_solve_sample.cu",
                                 f"{_CSRC}/chol_solve_sample_wide.cu"),
           "gram_accumulate": (f"{_CSRC}/gram_accumulate.cu",
                               f"{_CSRC}/gram_accumulate_wide.cu")}
#: the device the run drives
DEVICE = "cuda"
#: the main path: chains, warmup sweeps (every main path's: warmup
#: sweeps run eagerly, the run's dearest sweeps), steady sweeps after
#: adaptation
NCHAINS, WARMUP, STEADY = 64, 20, 240
#: steady sweeps traced on the device alone, and with the host as well
PROFILE_SWEEPS, PROFILE_HOST_SWEEPS = 6, 2
#: sweeps between checkpoints of the main path
SAVE_EVERY = 100
#: each kernel form by the name the device trace gives its kernel
TRACE_NAMES = {("chol_solve_sample", "f32"): "chol_solve_sample_kernel<float",
               ("chol_solve_sample", "f64"): "chol_solve_sample_kernel<double",
               ("gram_accumulate", "f32"): "gram_f32_kernel<float>",
               ("gram_accumulate", "f32_dot_f64_reduce"):
               "gram_f32_kernel<double>",
               ("gram_accumulate", "widen_f64"): "gram_widen_kernel<"}
#: the kernel forms the steady graphs must replay (the exact b-draws'
#: widening Gram runs eagerly, in the warmup and the adaptation)
GRAPHED = (("chol_solve_sample", "f32"), ("gram_accumulate", "f32"),
           ("gram_accumulate", "f32_dot_f64_reduce"))
#: the same for the wide forms on the single-pulsar path
WIDE_GRAPHED = (("chol_solve_sample", "f32_wide"),
                ("gram_accumulate", "f32_wide"),
                ("gram_accumulate", "f32_dot_f64_reduce_wide"))
#: steady sweeps of the graphs-against-eager checks, and where phases 3b
#: and 7b start them (so iteration 16 is their one refresh)
GRAPH_CHECK_SWEEPS, GRAPH_CHECK_FROM = 9, 8
#: the single-pulsar path: the snapshot, its frequency bins, its chains;
#: the systems the wide forms are also timed at
SNAPSHOT = "tests/data/enterprise_J1713+0747.npz"
SINGLE_BINS, SINGLE_CHAINS, WIDE_CONFIG_SYSTEMS = 30, 8, 64
#: the resume phase: chains, warmup and steady sweeps, chunk length
RESUME_CHAINS, RESUME_WARMUP, RESUME_STEADY, RESUME_CHUNK = 8, 5, 64, 16
#: the powerlaw paths: R1's steady sweeps (past iteration 384, where the
#: DE history first reads chain rows, and 512, where it reads them anew);
#: the depth of R2 and R3 (warmup, steady sweeps; cut from 10 + 100 to
#: keep the run inside its limit)
R1_STEADY = 515
R2_WARMUP, R2_STEADY, R3_WARMUP, R3_STEADY = 3, 24, 3, 24
#: R1's graphs-against-eager sweeps start here (crossing the DE period
#: switch at 512); its resume check's steady sweeps, split row (after
#: 384, off the 128-grid, on the chunk grid from iteration 6) and the
#: adaptation scan's length there
R1_GRAPH_CHECK_AT = 504
R1_RESUME_STEADY, R1_RESUME_SPLIT, R1_RESUME_ADAPT = 416, 390, 500
#: the float64 factor forms: the b-marginalized likelihood's (the
#: powerlaw adaptation), run on the powerlaw paths alone
F64_FORMS = (("chol_solve_sample", "f64"), ("chol_solve_sample", "f64_wide"))
#: the Hellings-Downs path: chains, frequency bins, the one kernel form it
#: runs (every b-draw's Gram), where its graphs-against-eager sweeps
#: start (crossing the refresh at 304)
HD_CHAINS, HD_BINS, HD_GRAPH_CHECK_AT = 32, 10, 296
#: phase 10's warmup and steady sweeps (short: phase 16 drives the same
#: joint draw at the main paths' depth)
HD_WARMUP, HD_STEADY = 5, 64
#: its resume check's warmup and steady sweeps (split at row 20, after the
#: refresh at 16, before the one at 32)
HD_RESUME_WARMUP, HD_RESUME_STEADY = 3, 32
HD_FORMS = (("gram_accumulate", "f32_dot_f64_reduce"),)
#: the array with the standard noise model (phase 11): its frequency
#: bins and where its graphs-against-eager sweeps start (crossing the
#: refresh at 304); the single pulsar with the NANOGrav single-pulsar
#: noise model (phase 12): its bins and steady sweeps (past 384, where
#: the DE history first reads chain rows)
N11_BINS, N11_GRAPH_CHECK_AT = 10, 296
N12_BINS, N12_STEADY = 30, 495
#: the Quick start from par/tim with kernel ECORR (phase 13): the
#: injection ``load_pulsar`` regenerates the residuals with, and the one
#: kernel form its sweeps run (the exact b-draw's widening Gram, wide at
#: B1 = 166)
QS_INJECT = dict(log10_A=math.log10(2e-15), gamma=13.0 / 3.0, nmodes=30)
KE_FORMS = (("gram_accumulate", "widen_f64_wide"),)
#: the t-process array (phase 14): bins, steady sweeps (past 384, so the
#: DE history reads chain rows), where its graphs-against-eager sweeps
#: start (crossing the refresh at 400); the infinitepower array (14d):
#: chains, warmup and steady sweeps
TP_BINS, TP_STEADY, TP_GRAPH_CHECK_AT = 10, 385, 392
IP_CHAINS, IP_WARMUP, IP_STEADY = 8, 3, 16
#: warmup and steady sweeps of the resume checks 11c-14c (cut from 5 +
#: 64 to keep the run inside its limit), and the white / ECORR
#: adaptation record of every resume and graphs-against-eager check's
#: sampler (the main paths' 1000: these checks compare two runs)
SIDE_RESUME_WARMUP, SIDE_RESUME_STEADY, CHECK_ADAPT = 3, 32, 120
#: the frequency-grid options (phase 15): the linear and log-spaced bins
#: of the grid, the pshift seed, the driver options, the steady sweeps;
#: the band-split red noise (15b): warmup and steady sweeps
P15_BINS, P15_LOG_BINS, P15_PSEED, P15_STEADY = 10, 10, 1, 120
P15_OPTS = dict(white_steps_max=32, exact_every=8)
P15B_WARMUP, P15B_STEADY = 3, 32
#: the sampled-ORF array (phase 16): the ORF with sampled weights, where
#: its graphs-against-eager sweeps start (across the refresh at 304); the
#: alternative correlated-ORF b-draws (16d): the choices of
#: ``PTGIBBS_HD_KERNEL``, warmup and steady sweeps
ORF_SAMPLED, ORF_GRAPH_CHECK_AT = "bin_orf", 296
HD_ALT_KERNELS, HD_ALT_WARMUP, HD_ALT_STEADY = ("pulsar", "freq"), 3, 12
#: the supervised run (phase 17): the watchdog's k, floor and soft
#: fraction (its deadline is k guarded waits, at least the floor), the
#: seconds the stall outlasts k chunk walls (the most its deadline can
#: be, so the abandoned worker wakes while a later attempt samples), the
#: NaN'd row's offset into the second steady chunk
SUP_WD_K, SUP_WD_FLOOR_S, SUP_WD_SOFT, SUP_STALL_EXTRA_S = 2.0, 3.0, 0.8, 5.0
SUP_NAN_OFFSET = 29
#: the record-precision pair (17b): warmup and steady sweeps
REC_WARMUP, REC_STEADY = 3, 24
#: depth cuts that keep the whole run inside its limit: the powerlaw
#: adaptation's MH steps of every path that adapts one (the facades'
#: default is 2000), the white and ECORR adaptation record of the side
#: paths 8-10 and 13-16 (the facades' default is 1000, ~7 s a path on
#: the card), the steady sweeps of phases 13 and 16 (cut from 240)
SIDE_RED_ADAPT, SIDE_WHITE_ADAPT, KE_STEADY, ORF_STEADY = 500, 250, 64, 64
#: the warmup sweeps of phase 7 and the side paths 8, 12-16 (cut from 20:
#: their eager warmup sweeps were the dearest part of each; phases 8,
#: 12 and 14 run 15 more steady sweeps, so their DE iterations stand)
SIDE_WARMUP = 5
#: the device sketch of phases 4 and 18 (``bench.py``'s headline run:
#: ``obs={"lags": 256}``)
OBS = {"lags": 256}
#: the ensemble array (phase 18): the tempering ladder's depth, the
#: steady rows its rho-law gate skips, where its graphs-against-eager
#: sweeps start (crossing the refresh at 272, both swap parities)
PT_LADDER, ENS_BURN, ENS_GRAPH_CHECK_AT = 2, 80, 264
#: the collapsed rho draw (phase 19): steady sweeps, the steady rows its
#: rho-law gate skips, where its graphs-against-eager sweeps start
#: (crossing the refresh at 112)
COLLAPSE_STEADY, COLLAPSE_BURN, COLLAPSE_GRAPH_CHECK_AT = 96, 48, 104
#: the oracle (phase 20): its sweeps after the adaptation sweep, the
#: rows it skips after that sweep, the steady rows of phase 7's card
#: chains skipped, the ESS both sides need before a white-noise or
#: ECORR hyper is gated, and the second of the run's clock by which it
#: must have finished
ORACLE_SWEEPS, ORACLE_BURN, ORACLE_CARD_BURN, ORACLE_MIN_ESS = (1000, 100,
                                                                100, 20)
ORACLE_DEADLINE_S = 1150.0
#: the card's side of phase 20 (20a): its chains, warmup sweeps (the
#: facades' default: at 5 the white hypers of chains drawn from the prior
#: stay apart for hundreds of sweeps) and steady sweeps; the ECORR block
#: alone (20b): its calls, the calls skipped and the points of the exact
#: law's grid over the prior
ORACLE_CARD_CHAINS, ORACLE_CARD_WARMUP, ORACLE_CARD_STEADY = 32, 50, 400
ECORR_CHECK_CALLS, ECORR_CHECK_BURN, ECORR_CHECK_GRID = 200, 10, 20001
#: repeated device errors (phase 21): warmup and steady sweeps at one
#: chain, the chunk length (and checkpoint interval), the row of the
#: first injected device error, and ``degrade_after`` (the errors in a
#: row)
RETRY_WARMUP, RETRY_STEADY, RETRY_CHUNK, RETRY_AT, RETRY_AFTER = (3, 40, 10,
                                                                  14, 3)
#: the tenant-multiplexed service (phase 22): the bucket ladder's mode
#: count, slots, sweeps a dispatch, the fair-share quantum in chunks (one
#: short of a job's chunks: the second array yields its slot once, before
#: its last chunk), checkpoints every so many chunks, sweeps a job; the
#: requests (a tag, pulsars, seed offset, largest TOA count); the rows
#: of a job's record its rho gate skips
SERVE_MODES, SERVE_SLOTS, SERVE_CHUNK, SERVE_QUANTUM = 10, 4, 8, 24
SERVE_SAVE_EVERY, SERVE_NITER, SERVE_BURN = 5, 200, 50
SERVE_REQUESTS = (("A", 45, 0, 720), ("B", 45, 1, 720), ("C", 30, 2, 720),
                  ("D", 8, 3, 120))
SERVE_FIFTH = ("E", 45, 4, 720)
#: the serving guards (phase 23): sweeps of the short jobs, the poisoned
#: tenant's breaker, the admission controller, the stage band, the stall
#: (seconds, and the checkpoint row at whose save it fires), the flight
#: recorder's window in chunks
GUARD_NITER = 40
GUARD_BREAKER = {"window": 4, "threshold": 0.5, "min_events": 1,
                 "cooldown_s": 30.0}
GUARD_ADMISSION = {"max_queue": 3, "storm_compiles": 3,
                   "storm_window_s": 600.0}
GUARD_BAND_K, GUARD_STALL_S, GUARD_STALL_ROW, GUARD_WINDOW = 5.0, 1.0, 96, 3
#: chunks the poisoned tenant's breaker stays open before the injected
#: clock passes its cooldown
GUARD_OPEN_CHUNKS = 4
#: the precision settings (phase 24): steady sweeps of the float64
#: storage paths, the steady rows the rho-law gate skips and where the
#: graphs-against-eager sweeps start (across the refresh at 112); the
#: float32-compute array (24c): its Gram segment, warmup and steady
#: sweeps, where its graphs-against-eager sweeps start (across 32)
P24_STEADY, P24_BURN, P24_GRAPH_CHECK_AT = 96, 48, 104
P24C_SEG, P24C_WARMUP, P24C_STEADY, P24C_GRAPH_CHECK_AT = 48, 3, 24, 24
#: the kernel forms of the float64 storage paths (the exact and refresh
#: Grams run eagerly too, the steady proposal's Gram and factor replay)
P24_FORMS = (("gram_accumulate", "f64"), ("chol_solve_sample", "f64"))
P24B_FORMS = (("gram_accumulate", "f64_wide"),
              ("chol_solve_sample", "f64_wide"))
#: the kernel forms of the float32-compute path: every Gram is all
#: float32 (the exact one too), the steady factor float32
P24C_FORMS = (("gram_accumulate", "f32"), ("chol_solve_sample", "f32"))
#: the array sharded over ranks (phases 25-25c): its padded width (an
#: even split over two ranks), steady sweeps, the checkpoint interval and
#: chunk (a mid-run checkpoint at 5 + 1 + 24), the steady rows the rho
#: law skips when a chain is not bitwise, and the kernel forms the path
#: runs (every Gram form of the f32 array, the steady factor)
P25_PAD, P25_STEADY, P25_SAVE, P25_BURN = 46, 48, 24, 8
P25_FORMS = (("gram_accumulate", "f32"),
             ("gram_accumulate", "f32_dot_f64_reduce"),
             ("gram_accumulate", "widen_f64"), ("chol_solve_sample", "f32"))


#: the run's start on the host clock (set by :func:`main`)
_RUN_START = time.perf_counter()


def elapsed(label):
    """Print the run's wall seconds so far, after ``label``."""
    print(f"{label} done at {time.perf_counter() - _RUN_START:.1f} s of the "
          "run", flush=True)


def _sexagesimal(deg, hours):
    """``[+-]dd:mm:ss.sss...`` of an angle in degrees (hours of 15 deg
    with ``hours``)."""
    v = abs(deg) / (15.0 if hours else 1.0)
    d = int(v)
    m = int((v - d) * 60.0)
    sec = (v - d - m / 60.0) * 3600.0
    sign = "-" if deg < 0 else ("" if hours else "+")
    return f"{sign}{d:02d}:{m:02d}:{sec:011.8f}"


def write_quickstart_partim(outdir, snapshot=SNAPSHOT):
    """Write a NANOGrav-style par/tim pair of J1713+0747 into
    ``outdir`` from the recorded snapshot's TOAs, uncertainties,
    frequencies and ``-fe``/``-be``/``-f``/``-pta`` flags (720 TOAs, 4
    backends).  The par fits the snapshot's own timing parameters: F0
    and F1 (in tempo2's D exponents), the sexagesimal position, proper
    motion, parallax, a DMX window per 60 days with TOAs (87), one
    flag-form JUMP and a DD binary with M2/SINI, so ``design_matrix``
    gives the snapshot's 105 columns.  Returns ``(par, tim)`` paths."""
    import numpy as np

    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    with np.load(snapshot, allow_pickle=False) as z:
        name = str(z["name"])
        mjd = z["toas"] / 86400.0
        errs, freqs, pos = z["toaerrs"], z["freqs"], z["pos"]
        fe, be, f = z["flag_fe"], z["flag_be"], z["flag_f"]
    ra = math.degrees(math.atan2(pos[1], pos[0])) % 360.0
    dec = math.degrees(math.asin(pos[2]))
    lines = [f"PSRJ           {name}",
             f"RAJ            {_sexagesimal(ra, True)} 1 2e-07",
             f"DECJ           {_sexagesimal(dec, False)} 1 4e-06",
             "PMRA           4.9171 1 0.0023", "PMDEC          -3.9150 1 0.0047",
             "PX             0.8471 1 0.0279",
             "F0             218.81184379596750D0 1 1.2D-14",
             "F1             -4.0836D-16 1 1.1D-21", "PEPOCH         53729",
             "POSEPOCH       53729", "DM             15.9907", "BINARY DD",
             "PB             67.8251309 1 1e-08", "T0             53761.0306",
             "A1             32.34242 1 1e-07", "OM             176.196 1 0.002",
             "ECC            7.49D-05 1 1D-08", "M2             0.290 1 0.011",
             "SINI           0.951 1 0.002"]
    edges = np.arange(mjd.min(), mjd.max() + 60.0, 60.0)
    nwin = 0
    for j in range(len(edges) - 1):
        if not ((mjd >= edges[j]) & (mjd < edges[j + 1])).any():
            continue
        nwin += 1
        lines += [f"DMX_{nwin:04d}   0.0 1 1e-6",
                  f"DMXR1_{nwin:04d} {edges[j]:.6f}",
                  f"DMXR2_{nwin:04d} {edges[j + 1] - 1e-6:.6f}"]
    lines.append("JUMP -be GUPPI 0.0 1 1e-8")
    par = out / f"{name}.par"
    par.write_text("\n".join(lines) + "\n")
    tim_lines = ["FORMAT 1", "MODE 1"]
    for i in range(len(mjd)):
        tim_lines.append(f"{name} {freqs[i]:.3f} {mjd[i]:.12f} "
                         f"{errs[i] * 1e6:.6f} ao -fe {fe[i]} -be {be[i]} "
                         f"-f {f[i]} -pta NANOGrav")
    tim = out / f"{name}.tim"
    tim.write_text("\n".join(tim_lines) + "\n")
    return par, tim


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def resource_usage(lib):
    """Registers, stack frame (spills land there) and static shared
    memory of every kernel in the built library, from ``cuobjdump
    -res-usage`` (names demangled by ``cu++filt``, argument lists cut;
    a narrow kernel's dynamic shared memory is not in it):
    ``[(name, REG, STACK, SHARED), ...]``, empty where the tools fail."""
    import re

    tools = Path("/usr/local/cuda/bin")
    try:
        out = subprocess.run([str(tools / "cuobjdump"), "-res-usage",
                              str(lib)], capture_output=True, text=True,
                             timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    rows, name = [], None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+)", line)
        if m and name:
            rows.append([name] + [int(v) for v in m.groups()])
            name = None
    try:
        names = subprocess.run([str(tools / "cu++filt")]
                               + [r[0] for r in rows], capture_output=True,
                               text=True, timeout=60,
                               check=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                # drop the argument list (template arguments stay)
                r[0] = re.sub(r"\([^()]*\)$", "", n.strip())
    except (OSError, subprocess.SubprocessError):
        pass
    return [tuple(r) for r in rows]


def cuda_ms(fn, reps=30, warm=3):
    """Median milliseconds of ``fn()`` over ``reps`` calls, each between
    two CUDA events (the host's launch overhead included where it exceeds
    the device's work)."""
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


def _trace(fn, reps):
    """``(device events, kernels among them, kernel launch calls on the
    host)`` of ``reps`` calls of ``fn`` under ``torch.profiler``, tracing
    the host and the device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = prof.events()
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    kern = sum(not e.name.startswith(("Memcpy", "Memset")) for e in dev)
    host = sum(e.device_type != DeviceType.CUDA and "LaunchKernel" in e.name
               for e in ev)
    return dev, kern, host


def device_ms(fn, reps=30, warm=3):
    """Mean device milliseconds of one ``fn()``: the summed durations of
    the kernels and copies it runs on the card, from ``torch.profiler``'s
    device trace over ``reps`` calls (no host time).  The trace can hold
    fewer kernels than the host launched (on the H100 it loses one at a
    session's edge on some sessions, and on a few all of them): a trace
    that lost at most a tenth is scaled by launched / found; else the
    calls are timed back to back between two CUDA events instead (said
    on a line of its own; a second trace mostly lost kernels as the
    first had, so none is taken)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    dev, kern, host = _trace(fn, reps)
    if dev and kern >= 0.9 * host:
        return (sum(e.time_range.end - e.time_range.start for e in dev)
                * max(1.0, host / kern) / 1e3 / reps)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    ms = s.elapsed_time(e) / reps
    print(f"note: the device trace lost kernels ({kern} of {host} "
          f"launched); {ms:.4f} ms is {reps} back-to-back calls between two "
          "CUDA events", flush=True)
    return ms


def wide_configs(lib, batch, B1):
    """The wide forms' launch configuration at ``batch`` systems (of
    augmented width ``B1``, which the ``f64_wide`` Gram's tile follows) as
    their launchers use it (``ptg_wide_config``): cluster size, output
    tile, threads per CTA, dynamic shared memory bytes, and how many
    16-CTA clusters of the factor the card runs at once."""
    import ctypes

    out = {}
    for name, kernel, variant in (
            ("chol_solve_sample[f32_wide]", 0, 0),
            ("chol_solve_sample[f64_wide]", 0, 1),
            ("gram_accumulate[f32_wide]", 1, 0),
            ("gram_accumulate[f32_dot_f64_reduce_wide]", 1, 1),
            ("gram_accumulate[widen_f64_wide]", 1, 2),
            ("gram_accumulate[f64_wide]", 1, 3)):
        buf = (ctypes.c_int * 5)()
        code = lib.ptg_wide_config(kernel, variant, batch, B1, buf)
        keys = ("cluster", "tile", "threads", "dynamic_smem_bytes") + (
            ("clusters_of_16_at_once",) if kernel == 0 else ())
        out[name] = (dict(zip(keys, buf)) if code == 0 else f"error {code}")
    return out


def time_ms(fn):
    """``(device ms, event ms)`` of one ``fn()``: over 10 calls after 3
    warm-up calls; for a call slower than 20 ms (the plain versions at the
    wide order: thousands of kernels and ~0.3 s of host time a call, whose
    device trace took ~6 s a call to read back on the card's host) one
    traced call and two timed by events, after the call that measured
    it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 < 0.02:
        return device_ms(fn, 10, 3), cuda_ms(fn, 10, 3)
    return device_ms(fn, 1, 0), cuda_ms(fn, 2, 0)


def bound_ms(nbytes, flops, kind):
    """Least time for the work: the larger of bytes over the HBM rate and
    operations over the peak rate of ``kind``; and which one it is."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[kind]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def parity_state(cm, C, gen):
    """A seeded state near the sampler's stationary region: efac in
    [0.8, 1.2], equad in [-8.5, -6.5], ecorr in [-8, -6.5], the common
    log10_rho at the
    injected power law (log10_A = log10(2e-15), gamma = 13/3) +-0.3 dex,
    the red log10_rho in [-9, -8.5], powerlaw log10_A in [-14.5, -13.5],
    gamma in [3, 5] and t-process alphas in [0.5, 2]."""
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
        elif nm.endswith("_log10_ecorr"):
            x[:, j] = -8.0 + 1.5 * u[:, j]
        elif "red_noise_log10_rho" in nm:
            x[:, j] = -9.0 + 0.5 * u[:, j]
        elif nm.endswith("_log10_A"):
            x[:, j] = -14.5 + u[:, j]
        elif nm.endswith("_gamma"):
            x[:, j] = 3.0 + 2.0 * u[:, j]
        elif "_alphas_" in nm:
            x[:, j] = 0.5 + 1.5 * u[:, j]
        elif nm.startswith("gw_") and "_log10_rho_" in nm:
            k = int(nm.rsplit("_", 1)[1])
            phi = powerlaw_psd((k + 1) / Tspan, math.log10(2e-15),
                               13.0 / 3.0, 1.0 / Tspan)
            x[:, j] = 0.5 * math.log10(phi) + 0.6 * (u[:, j] - 0.5)
    return x


def gram_parity(cm, x, timer, forms=("f32", "f32_dot_f64_reduce",
                                      "widen_f64"), beta=None, seg_len=None):
    """Phase 2, Gram: the kernel forms, which take ``(Ta, N)`` and
    form ``TNa = Ta / N`` on chip, against the plain version: the three
    float32-operand forms of a float32-storage model, the ``f64`` form
    (in ``forms``) of a float64-storage one.  The
    difference is measured at the Jacobi scale sqrt(G_ii G_jj), and the
    tolerance is twice the rigorous accumulation bound (m + nseg) eps of
    either side (Cauchy-Schwarz bounds every partial sum's products by
    the Jacobi scale).  Beside the kernel: the plain version, one
    unsegmented ``torch.matmul`` on a ``TNa`` made outside the timing (the
    library call).  The bound
    counts the fused kernel's bytes (Ta, N and G) and the operations of
    the rows this run's data needs (rows past a pulsar's last nonzero Ta
    row add exact zeros, and the kernel skips them); the bound over the
    whole grid, and that of a kernel reading a materialized ``TNa``, are
    printed beside it.  A width beyond the narrow form's runs the wide
    form (``*_wide``).  ``forms`` names the forms to hold; ``timer=None``
    holds them without timing (a shape an earlier row timed); ``beta``
    (a float) takes the Gram at a tempered chain's ``N / beta``;
    ``seg_len`` the TOA segment (``cm.gram_seg_len`` when None).
    On a tenant stack (``cm.tenants``) the T P systems are one chain's."""
    import torch

    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    ref = kernels.reference
    Nx = cm.ndiag_fast(x) if beta is None else cm.ndiag_fast(x) / beta
    Ta, N = blocks._gram_operands(cm, Nx, seg_len or cm.gram_seg_len)
    f64_in = Ta.dtype == torch.float64
    ebytes = Ta.element_size()
    N = N.reshape(-1, N.shape[-1]).contiguous()
    P, nseg, m, B1 = Ta.shape
    C = N.shape[0] // P
    suffix = "_wide" if B1 > kernels.GRAM_MAX_B1 else ""
    Bt = N.shape[0]
    TNa = ref.gram_operand(Ta, N)
    # the rows this run's data needs: a row past a pulsar's last nonzero Ta
    # row (where no chain's N is zero or NaN) adds exact zeros
    live = (Ta.reshape(P, nseg * m, B1)[:, :N.shape[1]] != 0).any(-1)
    live |= ((N == 0) | torch.isnan(N)).reshape(C, P, -1).any(0)
    idx = torch.arange(1, live.shape[1] + 1, device=live.device)
    extent = (live * idx).amax(-1)
    rows = float(extent.sum().item()) * C
    print(f"phase 2 gram rows the data needs: {rows:.0f} of "
          f"{Bt * nseg * m} ({rows / (Bt * nseg * m):.4f})", flush=True)
    recs, ok = {}, True
    for form, odt, widen in (("f32", torch.float32, False),
                             ("f32_dot_f64_reduce", torch.float64, False),
                             ("widen_f64", torch.float64, True),
                             ("f64", torch.float64, False)):
        if form not in forms or (form == "f64") != f64_in:
            continue
        kind = "f64" if widen or f64_in else "f32"
        def run_k():
            return kernels.gram_accumulate(Ta, N, out_dtype=odt,
                                           widen=widen)

        def run_p():
            return ref.gram_accumulate_ref(Ta, N, out_dtype=odt,
                                           widen=widen)

        Gk, Gp = run_k(), run_p()
        dg = torch.sqrt(torch.clamp(
            torch.diagonal(Gp, dim1=-2, dim2=-1).double(), min=1e-300))
        diff = (Gk.double() - Gp.double()).abs()
        err = (diff / (dg[:, :, None] * dg[:, None, :])).max().item()
        tol = 2.0 * (m + nseg) * EPS[kind]
        good = bool(torch.isfinite(Gk).all()) and err <= tol
        ok &= good
        del Gk, Gp
        if timer is None:
            recs[("gram_accumulate", form + suffix)] = dict(
                max_abs_err=diff.max().item())
            print(f"phase 2 gram_accumulate[{form}{suffix}] (B1 {B1}, {Bt} "
                  "rows of N): max |kernel-plain| / Jacobi scale "
                  f"{err:.3e} (tol {tol:.3e}) {'ok' if good else 'FAIL'}; "
                  "not timed again (an earlier row has this shape)",
                  flush=True)
            continue
        (ms_k, ev_k), (ms_p, ev_p) = timer(run_k), timer(run_p)
        # one unsegmented torch.matmul (float64 forms: on float64 copies
        # of the operands, made outside the timing)
        A = TNa.reshape(C, P, nseg * m, B1).transpose(-1, -2).to(odt)
        B = Ta.reshape(P, nseg * m, B1).to(odt)
        lib, ev_lib = timer(lambda: torch.matmul(A, B))
        del A, B
        obytes = 4 if odt == torch.float32 else 8
        gbytes = Bt * B1 * B1 * obytes
        nbytes = (Ta.numel() + N.numel()) * ebytes + gbytes
        flops = 2.0 * rows * B1 * B1
        bms, bby = bound_ms(nbytes, flops, kind)
        dense_bms, _ = bound_ms(nbytes, 2.0 * Bt * nseg * m * B1 * B1, kind)
        old_bms, old_bby = bound_ms(
            (TNa.numel() + Ta.numel()) * ebytes + gbytes, flops, kind)
        recs[("gram_accumulate", form + suffix)] = dict(
            max_abs_err=diff.max().item(), ms=ms_k, plain_ms=ms_p,
            bound_ms=bms, bound_by=bby, library_ms=lib)
        print(f"phase 2 gram_accumulate[{form}{suffix}] (B1 {B1}, {Bt} "
              "rows of N): max |kernel-plain| / "
              f"Jacobi scale {err:.3e} (tol {tol:.3e}) "
              f"{'ok' if good else 'FAIL'}; device ms (event ms): kernel "
              f"{ms_k:.4f} ({ev_k:.4f}), plain {ms_p:.4f} ({ev_p:.4f}), "
              f"torch.matmul {lib:.4f} ({ev_lib:.4f}); bound {bms:.4f} "
              f"ms ({bby}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP "
              f"on the rows the data needs; {dense_bms:.4f} ms over the "
              f"whole grid), with a materialized TNa {old_bms:.4f} ms "
              f"({old_bby})", flush=True)
    return recs, ok


def _backward(L, Li, A):
    """Largest backward errors of a factor over the batch, in float64:
    ``|L L^T - A|`` and ``|Li L - I|``."""
    import torch

    L, Li = L.double(), Li.double()
    eye = torch.eye(A.shape[-1], dtype=torch.float64, device=A.device)
    return ((L @ L.transpose(-1, -2) - A).abs().amax().item(),
            (Li @ L - eye).abs().amax().item())


def library_factor(Sig, d, z, ridge):
    """The factor chain's five outputs from PyTorch's library calls
    (``torch.linalg.cholesky`` and ``solve_triangular``): the yardstick
    beside the kernel, never called by the port."""
    import torch

    eye = torch.eye(Sig.shape[-1], dtype=Sig.dtype, device=Sig.device)
    dj = 1.0 / torch.sqrt(torch.diagonal(Sig, dim1=-2, dim2=-1))
    A = Sig * dj[:, :, None] * dj[:, None, :] + ridge * eye
    L = torch.linalg.cholesky(A)
    Li = torch.linalg.solve_triangular(L, eye.expand_as(A), upper=False)
    w = torch.linalg.solve_triangular(L, (dj * d)[..., None], upper=False)
    mz = torch.linalg.solve_triangular(
        L.transpose(-1, -2), torch.cat([w, z[..., None]], -1), upper=True)
    mean = dj * mz[..., 0]
    return L, Li, dj, mean, mean + dj * mz[..., 1]


def chol_parity(cm, x, gen, timer, beta=None):
    """Phase 2, factor chain: the float32 kernel's error against a
    float64 evaluation of the same float32 inputs must stay in the plain
    float32 chain's class (at most 8x its error plus 64 eps of the
    output's scale), and the float64 kernel must match the float64 chain
    to 1e-8 of the output's scale.  An order beyond the narrow form's
    runs the wide form (``*_wide``), which is also held to the plain
    chain's backward errors ``|L L^T - A|`` and ``|Li L - I|`` (A the
    preconditioned matrix in float64): at most 8x the plain chain's plus
    64 eps_f32 of the matrix scale.  ``timer=None`` skips the timing;
    ``beta`` (a float) factors a tempered chain's system (``N /
    beta``)."""
    import torch

    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    Nx = cm.ndiag_fast(x) if beta is None else cm.ndiag_fast(x) / beta
    TNT, d = blocks.tnt_d_seg32(cm, Nx)
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

    wide = n > kernels.CHOL_MAX_N
    form = "f32_wide" if wide else "f32"
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
        print(f"phase 2 chol_solve_sample[{form}] {name}: "
              f"|kernel-f64| {ek:.3e}, "
              f"|plain-f64| {ep:.3e}, tol {tol:.3e}; float64 kernel "
              f"{e64:.3e} (tol {1e-8 * rmax:.3e}) {'ok' if good else 'FAIL'}",
              flush=True)
    if wide:
        dj = K[2].double()
        A = (Sig.double() * dj[:, :, None] * dj[:, None, :]
             + ridge * torch.eye(n, dtype=torch.float64, device=Sig.device))
        bk, bp = _backward(K[0], K[1], A), _backward(Pl[0], Pl[1], A)
        tol = [8.0 * e + 64.0 * EPS["f32"] for e in bp]
        good = all(k <= t for k, t in zip(bk, tol))
        ok &= good
        print(f"phase 2 chol_solve_sample[{form}] backward errors |L L^T - "
              f"A|, |Li L - I|: kernel {bk[0]:.3e}, {bk[1]:.3e}; plain "
              f"{bp[0]:.3e}, {bp[1]:.3e}; tol {tol[0]:.3e}, {tol[1]:.3e} "
              f"{'ok' if good else 'FAIL'}", flush=True)
    del K64, R
    if timer is None:
        print(f"phase 2 chol_solve_sample[{form}] ({Sig.shape[0]} systems "
              f"of order {n}): {'ok' if ok else 'FAIL'}; not timed again "
              "(an earlier row has this shape)", flush=True)
        return {("chol_solve_sample", form): dict(max_abs_err=mae)}, ok

    (ms_k, ev_k), (ms_p, ev_p), (lib, ev_lib) = (
        timer(run_k), timer(run_p),
        timer(lambda: library_factor(Sig, d, z, ridge)))
    Bt = Sig.shape[0]
    nbytes = Bt * (3 * n * n + 5 * n) * 4
    flops = Bt * (2.0 * n ** 3 / 3.0 + 6.0 * n * n)
    bms, bby = bound_ms(nbytes, flops, "f32")
    print(f"phase 2 chol_solve_sample[{form}] ({Bt} systems of order {n}): "
          f"{'ok' if ok else 'FAIL'}; max "
          f"|kernel-plain| {mae:.3e}; device ms (event ms): kernel "
          f"{ms_k:.4f} ({ev_k:.4f}), plain {ms_p:.4f} ({ev_p:.4f}), "
          f"cholesky+solve_triangular chain {lib:.4f} ({ev_lib:.4f}); bound "
          f"{bms:.4f} ms ({bby})", flush=True)
    return {("chol_solve_sample", form): dict(
        max_abs_err=mae, ms=ms_k, plain_ms=ms_p, bound_ms=bms,
        bound_by=bby, library_ms=lib)}, ok


def chol64_parity(cm, x, timer, gen=None):
    """Phase 2, the float64 factor forms on the b-marginalized
    likelihood's systems (``blocks.lnlike_fullmarg_fn``, which the
    powerlaw adaptation runs): ``Sigma = TNT + diag(1/phi)`` from the
    exact widening Gram at a seeded state, ``d``, and ``z = 0`` (the
    likelihood draws nothing); with ``gen``, on a float64-storage model,
    the steady proposal's systems instead (``blocks.propose_b_mh``: the
    segmented Gram, the ``_PROP_RIDGE`` guard, normals from ``gen``).
    Every output within ``max(1e-8 scale, 8 spread + 64 eps_f64
    scale)`` of the plain float64 chain, ``scale``
    the output's largest magnitude and ``spread`` the largest difference
    between the plain chain and the library chain (``torch.linalg.
    cholesky`` and ``solve_triangular``), an independent float64
    evaluation of the same outputs: where the Jacobi-scaled systems are
    ill-conditioned two float64 orders of operation differ by more than
    1e-8 of the scale (the DM GP's low frequencies beside the timing
    model's DM columns: condition numbers to ~4e8 at order 59), and the
    kernel is held to that class, as the float32 forms are.  Timed
    beside the plain chain and the library chain (``timer=None``: not
    timed)."""
    import torch

    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.ops.linalg import _batched_diag
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    n = cm.Bmax
    if gen is None:
        TNT, d = blocks.tnt_d_x(cm, x, cm.ndiag(x))
        phi, ridge, what = cm.phi(x), 0.0, "the marginalized likelihood's"
    else:
        TNT, d = blocks.tnt_d_seg32(cm, cm.ndiag_fast(x))
        phi, ridge = cm.phi(x, dtype=cm.dtype), blocks._PROP_RIDGE
        what = "the steady proposal's, float64 storage"
    Sig = (TNT + _batched_diag(1.0 / phi)).reshape(-1, n, n)
    Sig = Sig.contiguous()
    d = d.reshape(-1, n).contiguous()
    z = (torch.zeros_like(d) if gen is None else torch.randn(
        d.shape, generator=gen, dtype=d.dtype,
        device=gen.device).to(d.device))
    ref = kernels.reference.chol_solve_sample_ref

    def run_k():
        return kernels.chol_solve_sample(Sig, d, z, ridge=ridge)

    def run_p():
        return ref(Sig, d, z, ridge=ridge)

    form = "f64_wide" if n > kernels.CHOL_MAX_N else "f64"
    K, Pl = run_k(), run_p()
    Lib = library_factor(Sig, d, z, ridge)
    ok, mae, errs = True, 0.0, {}
    for name, k, p, q in zip(("L", "Li", "dj", "mean", "bp"), K, Pl, Lib):
        e = (k - p).abs().max().item()
        scale = p.abs().max().item()
        spread = (q - p).abs().max().item()
        tol = max(1e-8 * scale, 8.0 * spread + 64.0 * EPS["f64"] * scale)
        errs[name] = [e, spread, tol]
        ok &= bool(torch.isfinite(k).all()) and e <= tol
        mae = max(mae, e)
    del K, Pl, Lib
    if timer is None:
        print(f"phase 2 chol_solve_sample[{form}] ({Sig.shape[0]} systems "
              f"of order {n}, {what}): |kernel - "
              "plain|, |library - plain| and tolerance by output "
              + json.dumps({k: [float(f"{v:.3e}") for v in e]
                            for k, e in errs.items()})
              + f" {'ok' if ok else 'FAIL'}; not timed again (an earlier "
              "row has this shape)", flush=True)
        return {("chol_solve_sample", form): dict(max_abs_err=mae)}, ok
    (ms_k, ev_k), (ms_p, ev_p), (lib, ev_lib) = (
        timer(run_k), timer(run_p),
        timer(lambda: library_factor(Sig, d, z, ridge)))
    Bt = Sig.shape[0]
    bms, bby = bound_ms(Bt * (3 * n * n + 5 * n) * 8,
                        Bt * (2.0 * n ** 3 / 3.0 + 6.0 * n * n), "f64")
    print(f"phase 2 chol_solve_sample[{form}] ({Bt} systems of order {n}, "
          f"{what}): |kernel - plain|, |library - "
          "plain| and tolerance by output " + json.dumps(
              {k: [float(f"{v:.3e}") for v in e] for k, e in errs.items()})
          + f" {'ok' if ok else 'FAIL'}; device ms (event ms): kernel "
          f"{ms_k:.4f} ({ev_k:.4f}), plain {ms_p:.4f} ({ev_p:.4f}), "
          f"cholesky+solve_triangular chain {lib:.4f} ({ev_lib:.4f}); bound "
          f"{bms:.4f} ms ({bby})", flush=True)
    return {("chol_solve_sample", form): dict(
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


def graphs_vs_eager(drv, x, b, it0, phase, label,
                    sweeps=GRAPH_CHECK_SWEEPS):
    """``sweeps`` steady sweeps of the adapted driver ``drv`` from ``(x,
    b)`` at iteration ``it0``, eagerly and from the CUDA graphs: x, b,
    the b_mh, refresh, powerlaw-block and ORF-weight acceptance counts,
    the joint draw's breakdown count and, where the driver has them, the
    ensemble state and the sketch must be bitwise equal (every draw comes
    from the per-sweep stream, and no atomic add of the sweep meets one
    real slot twice); both runs start from the ensemble state and the
    sketch the driver holds."""
    import torch

    counters = (drv.b_mh_accepts, drv.b_refresh_accepts, drv.red_mh_accepts,
                drv.orf_mh_accepts, drv.b_joint_breakdowns)
    stage = {**{"ens_" + k: v for k, v in (drv.ens_state or {}).items()},
             **{"sketch_" + k: v for k, v in
                (drv._obs_state or {}).items()}}
    stage0 = {k: v.clone() for k, v in stage.items()}
    out, wall = {}, {}
    for graphs in (False, True):
        drv.graphs = graphs
        for c in counters:
            c.zero_()
        for k, v in stage.items():
            v.copy_(stage0[k])
        drv.begin_steady(x.clone(), b.clone())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv.steady_chunk(it0, sweeps)
        torch.cuda.synchronize()
        wall[graphs] = 1e3 * (time.perf_counter() - t0) / sweeps
        out[graphs] = (drv.carry.x.clone(), drv.carry.b.clone(),
                       *(c.clone() for c in counters),
                       *(v.clone() for v in stage.values()))
    diffs = {what: (e - r).abs().max().item() if e.numel() else 0.0
             for e, r, what in zip(out[False], out[True],
                                   ("x", "b", "accepts", "refresh",
                                    "red_mh", "orf_mh", "joint_breakdowns",
                                    *stage))}
    same = all(torch.equal(e, r) for e, r in zip(out[False], out[True]))
    ok = same and bool(torch.isfinite(out[True][1]).all())
    exact = sum(t % drv.exact_every == 0 for t in range(it0, it0 + sweeps))
    print(f"phase {phase} graphs against eager, {label}, "
          f"{sweeps} steady sweeps from iteration {it0} ({exact} "
          f"of them refresh or exact b-draws) at {drv.C} chains, graphs "
          f"{sorted(drv.carry.graphs)}: "
          f"bitwise {'equal' if same else 'DIFFERENT'} (max |eager - graph| "
          + json.dumps(diffs) + f"); {wall[False]:.3f} ms per sweep eager, "
          f"{wall[True]:.3f} graphed; capture {drv.carry.capture_seconds:.3f}"
          f" s {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def graph_against_eager(cm, seed, outdir, facade="PTABlockGibbs",
                        nchains=NCHAINS, phase="3b"):
    """Phase 3b (7b): adapt an ``nchains`` sampler (the ``facade``) with
    a short eager run, then :func:`graphs_vs_eager` from its final state
    at iteration ``GRAPH_CHECK_FROM``."""
    import torch

    import pulsar_timing_gibbsspec_torch as ptt

    g = getattr(ptt, facade)(cm, nchains=nchains, device=cm.device,
                             seed=seed, warmup_sweeps=2, graphs=False,
                             progress=False,
                             white_adapt_iters=CHECK_ADAPT)
    g.sample(g.initial_sample(torch.Generator(device=cm.device).manual_seed(
        seed + 1)), outdir=outdir, niter=4)
    drv = g.driver
    return graphs_vs_eager(drv, torch.as_tensor(drv.x_cur, device=cm.device),
                           drv.b.to(cm.device), GRAPH_CHECK_FROM, phase,
                           facade)


def resume_check(cm, seed, outdir, facade="PTABlockGibbs", phase="7c",
                 warmup=RESUME_WARMUP, steady=RESUME_STEADY, split=None,
                 de_gate=False, **opts):
    """Phases 7c, 8c, 10c-16c: at ``RESUME_CHAINS`` chains of the
    ``facade`` (driver options ``opts``), a run whole, checkpointed at row
    ``split`` (a chunk boundary, by default halfway) and at its end; the
    checkpoint at ``split`` (its ``.bak`` generation, restored in a copy
    of the directory by ``integrity.rollback``) resumed in a fresh
    sampler; both through the graphs, they write bitwise equal
    ``chain.npy`` and ``bchain.npy``; with ``de_gate``, both runs must
    read a DE period from chain rows."""
    import shutil

    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    niter = warmup + 1 + steady
    split = split or warmup + 1 + steady // 2

    opts.setdefault("white_adapt_iters", CHECK_ADAPT)

    def gibbs():
        return getattr(ptt, facade)(cm, nchains=RESUME_CHAINS,
                                    device=cm.device, seed=seed,
                                    progress=False,
                                    warmup_sweeps=warmup,
                                    chunk_size=RESUME_CHUNK, **opts)

    def x0(g):
        return g.initial_sample(torch.Generator(
            device=cm.device).manual_seed(seed + 2))

    out = Path(outdir)
    t0 = time.perf_counter()
    whole = gibbs()
    # saves at ``split`` and at the end alone: the .bak is the split set
    whole.sample(x0(whole), outdir=out / "whole", niter=niter,
                 save_every=split)
    shutil.rmtree(out / "split", ignore_errors=True)
    shutil.copytree(out / "whole", out / "split")
    restored = (integrity.rollback(out / "split")
                and integrity.verify(out / "split")["rows"] == split)
    g = gibbs()
    g.sample(x0(g), outdir=out / "split", niter=niter, resume=True)
    same = {nm: bool(np.array_equal(np.load(out / "whole" / nm),
                                    np.load(out / "split" / nm)))
            for nm in ("chain.npy", "bchain.npy")}
    finite = bool(np.isfinite(np.load(out / "whole" / "bchain.npy")).all())
    ok = (all(same.values()) and finite and restored
          and g.driver.carry.graphed)
    de = ""
    if g.driver.do_red_mh:
        periods = (whole.driver.de_chain_periods, g.driver.de_chain_periods)
        ok &= all(periods) or not de_gate
        de = (f"; DE periods read from chain rows: whole {periods[0]}, "
              f"resumed {periods[1]}")
    print(f"phase {phase} resume, {facade}, at {RESUME_CHAINS} chains, "
          f"{warmup} warmup + {steady} steady sweeps, the checkpoint at row "
          f"{split} (chunks of {RESUME_CHUNK}) restored {restored} and "
          "resumed, through the graphs: bitwise equal "
          + json.dumps(same) + f"{de}; {time.perf_counter() - t0:.1f} s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def _busy_ms(spans):
    """Milliseconds of the union of ``(start, end)`` device intervals (in
    microseconds)."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def profile_steady(drv, t0):
    """Phase 5: steady sweeps of the driver's steady-chunk entry (the
    graphs phase 4 ran) from the main path's final carry, iterations
    ``t0 ..`` (no refresh among them), under ``torch.profiler``.  Window
    1 traces the device alone: its idle share is 1 - (union of the
    device's kernel and copy intervals) / (host wall of the window,
    synchronized at both ends), and its kernel time by name; the same
    sweeps' wall without the profiler gives a second idle share.  Window 2
    adds the host: the launch calls (``cudaGraphLaunch`` and
    ``cu*LaunchKernel*``) inside each ``block:<name>`` range give the
    host launches per block.  The profiler slows the host, so window
    1's idle share is an upper bound of the unprofiled run's.  In window
    1 the port's kernels, counted by name in the device trace, must equal
    the growth of their device counters and of the graphs' replayed
    launches (a trace that lost kernels while the counters and replays
    agree is taken once more); returns whether they do."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pulsar_timing_gibbsspec_torch.ops import kernels

    drv.steady_chunk(t0, 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    drv.steady_chunk(t0 + 1, PROFILE_SWEEPS)
    torch.cuda.synchronize()
    plain_wall = 1e3 * (time.perf_counter() - t1)
    graphs = drv.carry
    for attempt in (1, 2):
        dev0, rep0 = kernels.device_launches(), graphs.replayed_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            drv.steady_chunk(t0 + 1, PROFILE_SWEEPS)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t1)
        dev1, rep1 = kernels.device_launches(), graphs.replayed_launches()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kern = [e for e in dev
                if not e.name.startswith(("Memcpy", "Memset"))]
        if not kern:
            raise RuntimeError("the device trace holds no kernel")
        counted = {}
        for key, pat in TRACE_NAMES.items():
            counted[f"{key[0]}[{key[1]}]"] = [
                sum(pat in e.name for e in kern), dev1[key] - dev0[key],
                rep1.get(key, 0) - rep0.get(key, 0)]
        ok = all(a == b == c for a, b, c in counted.values()) and all(
            counted[f"{k}[{f}]"][0] > 0 for k, f in GRAPHED[:2])
        print(f"phase 5 port kernels in the device trace by name, their "
              f"device counters' growth and the graphs' replayed launches, "
              f"{PROFILE_SWEEPS} b_mh sweeps (trace {attempt}): "
              + json.dumps(counted) + f" {'ok' if ok else 'FAIL'}",
              flush=True)
        # the counters and the replays must agree; a trace that lost
        # kernels (the profiler drops some ctypes launches in some
        # traces, section 2 of PERF.md) is taken once more
        lost = all(b == c >= a for a, b, c in counted.values())
        if ok or not lost:
            break
    if not ok:
        print("phase 5 kernel names in the trace: " + json.dumps(sorted(
            {e.name[:120] for e in kern if "kernel<" in e.name})),
            flush=True)
    by_name = {}
    for e in kern:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += (e.time_range.end - e.time_range.start) / 1e3
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    busy = _busy_ms([(e.time_range.start, e.time_range.end) for e in dev])
    print(f"phase 5 device trace, {PROFILE_SWEEPS} steady b_mh sweeps "
          f"from the graphs: host wall {wall / PROFILE_SWEEPS:.3f} ms per "
          f"sweep, device busy {busy / PROFILE_SWEEPS:.3f} ms per sweep, "
          f"idle share {1.0 - busy / wall:.4f} ({1.0 - busy / plain_wall:.4f}"
          f" of the same sweeps' unprofiled wall, "
          f"{plain_wall / PROFILE_SWEEPS:.3f} ms per sweep); "
          f"{len(kern) / PROFILE_SWEEPS:.1f} kernels and "
          f"{(len(dev) - len(kern)) / PROFILE_SWEEPS:.1f} copies per sweep",
          flush=True)
    print("phase 5 kernel ms per sweep by name (count per sweep): "
          + json.dumps([[n[:80], round(t / PROFILE_SWEEPS, 4),
                         c / PROFILE_SWEEPS] for n, (t, c) in top]),
          flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drv.steady_chunk(t0 + 1 + PROFILE_SWEEPS, PROFILE_HOST_SWEEPS)
        torch.cuda.synchronize()
    evs = prof.events()
    ranges = [(e.name[len("block:"):], e.time_range) for e in evs
              if e.name.startswith("block:")
              and e.device_type == DeviceType.CPU]
    launches = [e.time_range.start for e in evs
                if e.device_type == DeviceType.CPU
                and ("LaunchKernel" in e.name or "GraphLaunch" in e.name)]
    per_block = dict.fromkeys(sorted({n for n, _ in ranges}), 0)
    for n, r in ranges:
        per_block[n] += sum(r.start <= t <= r.end for t in launches)
    # device work per block: the kernels and copies inside each block's
    # range on the device's own timeline (its device annotation)
    dspans = [(e.time_range.start, e.time_range.end) for e in evs
              if e.device_type == DeviceType.CUDA
              and not e.name.startswith("block:")]
    dbusy = dict.fromkeys(per_block, 0.0)
    for e in evs:
        if e.device_type == DeviceType.CUDA and e.name.startswith("block:"):
            a, b = e.time_range.start, e.time_range.end
            n = e.name[len("block:"):]
            dbusy[n] = dbusy.get(n, 0.0) + _busy_ms(
                [(max(a, s), min(b, t)) for s, t in dspans if t > a and s < b])
    print(f"phase 5 host trace, {PROFILE_HOST_SWEEPS} steady b_mh sweeps: "
          f"host launches per sweep {len(launches) / PROFILE_HOST_SWEEPS}"
          ", by block " + json.dumps(
              {k: v / PROFILE_HOST_SWEEPS for k, v in per_block.items()}),
          flush=True)
    print("phase 5 device busy ms per sweep by block (kernels inside each "
          "block's device range): " + json.dumps(
              {k: round(v / PROFILE_HOST_SWEEPS, 4)
               for k, v in sorted(dbusy.items())}), flush=True)
    return ok


def launch_counts(graphs):
    """The kernels' runs on the card since the counts were set to 0, the
    host's launches, the captures' launches times their replays, the
    launches recorded into the graphs, and the runs since the captures:
    each ``{(kernel, form): n}``."""
    from pulsar_timing_gibbsspec_torch.ops import kernels

    runs, host = kernels.device_launches(), kernels.launch_counts()
    replayed = graphs.replayed_launches()
    captured = {k: sum(c.get(k, 0) for c in graphs.launches.values())
                for k in runs}
    since = {k: runs[k] - graphs.device_at_capture[k] for k in runs}
    return runs, host, replayed, captured, since


def count_faults(counts, forms, graphed):
    """``(never run, not replayed as captured, runs other than eager
    launches plus replays)`` of a path's kernel forms."""
    runs, host, replayed, captured, since = counts
    missing = [f"{k}[{f}]" for k, f in forms if runs[(k, f)] == 0]
    unreplayed = [f"{k}[{f}]" for k, f in graphed
                  if not since[(k, f)] == replayed.get((k, f), 0) > 0]
    unaccounted = [f"{k}[{f}]" for (k, f) in runs if runs[(k, f)] != host[
        (k, f)] - captured[(k, f)] + replayed.get((k, f), 0)]
    return missing, unreplayed, unaccounted


def print_counts(phase, counts):
    runs, host, replayed, captured, since = counts

    def fmt(d):
        return json.dumps({f"{k}[{f}]": n for (k, f), n in d.items() if n})

    print(f"phase {phase} kernel runs counted on the card: " + fmt(runs)
          + "; of them replayed since the captures " + fmt(since)
          + ", the captures' launches times their replays " + fmt(replayed)
          + "; host launches " + fmt(host) + ", recorded into graphs "
          + fmt(captured), flush=True)


def single_pulsar_path(cm, seed, outdir, steady, forms):
    """Phase 7: ``PulsarBlockGibbs`` on the J1713+0747 Quick-start model
    through warmup, adaptation and ``steady`` sweeps replayed from the
    graphs, checkpointed every ``SAVE_EVERY`` sweeps, with the launch
    counts set to 0 just before it.  Returns ``(ok, runs)``, ``runs`` the
    kernels' device counts of the path."""
    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    C, niter = SINGLE_CHAINS, SIDE_WARMUP + 1 + steady
    kernels.reset_launches()
    t0 = time.perf_counter()
    g = ptt.PulsarBlockGibbs(cm, nchains=C, device=cm.device, seed=seed,
                             warmup_sweeps=SIDE_WARMUP, progress=False)
    x0 = g.initial_sample(torch.Generator(device=cm.device).manual_seed(
        seed))
    chain = g.sample(x0, outdir=outdir, niter=niter, save_every=SAVE_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drv, graphs = g.driver, g.driver.carry
    counts = launch_counts(graphs)
    missing, unreplayed, unaccounted = count_faults(counts, forms,
                                                    WIDE_GRAPHED)
    sps = drv.steady_sweeps / drv.steady_seconds
    acc = (drv.b_mh_accepts[:, 0] / max(drv.b_mh_sweeps, 1)).tolist()
    racc = (drv.b_refresh_accepts[:, 0]
            / max(drv.b_refresh_sweeps, 1)).tolist()
    rho = chain[SIDE_WARMUP + 1:, :, cm.rho_ix_x.cpu().numpy()]
    med = np.median(rho.reshape(-1, rho.shape[-1]), axis=0)
    ecorr = chain[SIDE_WARMUP + 1:, :, cm.idx.ecorr]
    rep = integrity.verify(outdir)
    print(f"phase 7 single-pulsar path ({cm.pulsars[0]}, Bmax {cm.Bmax}, "
          f"Nmax {cm.Nmax}, nx {cm.nx}, {cm.ec_cols.shape[1]} ECORR "
          f"columns): {niter} rows x {C} chains in {wall:.1f} s (warmup "
          f"{SIDE_WARMUP}); white sub-chain {drv.aclength_white} steps, ECORR "
          f"sub-chain {drv.aclength_ecorr} steps; steady "
          f"{drv.steady_sweeps} sweeps in {drv.steady_seconds:.3f} s = "
          f"{sps:.3f} sweeps/s = {sps * C:.1f} samples/s", flush=True)
    print(f"phase 7 CUDA graphs: {len(graphs.graphs)} captured in "
          f"{graphs.capture_seconds:.3f} s (with the warm-up pass), pool "
          f"{graphs.pool_bytes / 1e6:.1f} MB; by graph, capture s "
          + json.dumps({k: round(v, 3) for k, v in graphs.capture_by.items()})
          + ", pool MB " + json.dumps(
              {k: round(v / 1e6, 1) for k, v in graphs.pool_by.items()})
          + "; replays per sweep " + json.dumps(
              {"b_mh": len(drv.sweep_blocks(False)),
               "b_refresh": len(drv.sweep_blocks(True))}), flush=True)
    print("phase 7 per-block ms per steady sweep (CUDA events): "
          + json.dumps({k: round(v / drv.steady_sweeps, 4)
                        for k, v in sorted(drv.timer.ms.items())})
          + "; per refresh sweep b_refresh " + (
              f"{drv.timer.ms['b_refresh'] / drv.b_refresh_sweeps:.4f}"
              if drv.b_refresh_sweeps else "-"), flush=True)
    print("phase 7 warmup block ms in all (CUDA events, eager; "
          f"{SIDE_WARMUP} sweeps): " + json.dumps(
              {k: round(v, 1) for k, v in sorted(drv.warmup_ms.items())}),
          flush=True)
    busy = sum(g.store.seconds.values())
    print(f"phase 7 checkpoints every {SAVE_EVERY} sweeps: saves ran "
          f"{busy:.3f} s on their thread, the loop waited "
          f"{g.save_seconds:.3f} s; final manifest verified {rep['ok']} at "
          f"{rep['rows']} rows", flush=True)
    print("phase 7 draw_b_mh acceptance per chain: "
          + json.dumps([round(a, 4) for a in acc]) + f" over "
          f"{drv.b_mh_sweeps} sweeps; refresh acceptance per chain "
          + json.dumps([round(a, 4) for a in racc]) + f" over "
          f"{drv.b_refresh_sweeps} sweeps", flush=True)
    print("phase 7 log10_rho medians per bin: "
          + json.dumps([round(float(v), 3) for v in med])
          + "; log10_ecorr medians " + json.dumps(
              [round(float(v), 3) for v in np.median(
                  ecorr.reshape(-1, ecorr.shape[-1]), axis=0)]), flush=True)
    print_counts(7, counts)
    print(f"phase 7 non-finite Laplace blocks in warmup and adaptation: "
          f"{int(drv.laplace_nonfinite)}", flush=True)
    finite = bool(np.isfinite(chain).all() and np.isfinite(g.bchain).all())
    inside = bool(((med > -10.0) & (med < -4.0)).all())
    saved = rep["ok"] and rep["rows"] == niter and graphs.graphed
    ok = (finite and inside and not missing and not unreplayed
          and not unaccounted and saved)
    if not ok:
        print(f"chip_smoke: single-pulsar path failed (finite={finite}, "
              f"medians inside the prior={inside}, never run={missing}, "
              f"not replayed as captured={unreplayed}, runs other than "
              f"eager launches plus replays={unaccounted}, verified "
              f"checkpoint through the graphs={saved})", file=sys.stderr)
    return ok, counts[0]


def powerlaw_path(phase, cm, facade, C, warmup, steady, seed, outdir,
                  forms, graphed, de_gate=False, no_white=False,
                  backup=True, **opts):
    """Phases 8, 9, 9b, 11, 12: the ``facade`` on a model with the
    powerlaw hyper block, ``C`` chains through ``warmup`` sweeps, the
    adaptation and ``steady`` sweeps replayed from the graphs,
    checkpointed every ``SAVE_EVERY`` sweeps, with the launch counts set
    to 0 just before it.  Gates: every record finite; every common
    log10_rho median (if any) inside (-10, -4) and every powerlaw-family
    hyper's median (chromatic GPs' too) inside its prior; the final
    checkpoint verified; every kernel form of ``forms`` run on the card
    and each of ``graphed`` replayed as captured times replays; with
    ``de_gate``, a DE period read from chain rows; with ``no_white``
    (fixed white noise), no white or ECORR block in the steady sweep.
    ``opts`` are driver options; ``backup=False`` keeps no ``.bak``
    checkpoint.  Returns ``(ok, runs, sampler)``."""
    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    niter = warmup + 1 + steady
    kernels.reset_launches()
    t0 = time.perf_counter()
    g = getattr(ptt, facade)(cm, nchains=C, device=cm.device, seed=seed,
                             warmup_sweeps=warmup, progress=False, **opts)
    x0 = g.initial_sample(torch.Generator(device=cm.device).manual_seed(
        seed))
    chain = g.sample(x0, outdir=outdir, niter=niter, save_every=SAVE_EVERY,
                     backup=backup)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drv, graphs = g.driver, g.driver.carry
    counts = launch_counts(graphs)
    missing, unreplayed, unaccounted = count_faults(counts, forms, graphed)
    sps = drv.steady_sweeps / drv.steady_seconds
    racc = (drv.red_mh_accepts
            / max(drv.red_steps * drv.red_mh_sweeps, 1)).tolist()
    steady_rows = chain[warmup + 1:]
    red = [int(j) for j in cm.idx.red]
    rho_cols = cm.rho_ix_x.cpu().numpy()
    med_red, med_rho = (np.median(steady_rows[:, :, cols], axis=(0, 1))
                        if len(cols) else np.zeros(0)
                        for cols in (red, rho_cols))
    pa, pb = cm.pa.cpu().numpy()[red], cm.pb.cpu().numpy()[red]
    rep = integrity.verify(outdir)
    f64 = {f"{k}[{f}]": counts[0][(k, f)] for k, f in F64_FORMS}
    print(f"phase {phase} powerlaw path, {facade} ({', '.join(cm.pulsars[:2])}"
          f"{' ...' if cm.P_real > 2 else ''}; P {cm.P_real}, Bmax {cm.Bmax},"
          f" nx {cm.nx}, common {cm.gw_kind}, red {cm.red_kind}, "
          f"{len(red)} powerlaw hypers): {niter} rows x {C} chains in "
          f"{wall:.1f} s (warmup {warmup}); sweep "
          f"{drv.sweep_blocks(False)}; white sub-chain "
          f"{drv.aclength_white} steps, ECORR {drv.aclength_ecorr}; steady "
          f"{drv.steady_sweeps} sweeps in {drv.steady_seconds:.3f} s = "
          f"{sps:.3f} sweeps/s = {sps * C:.1f} samples/s", flush=True)
    print(f"phase {phase} adaptation of the powerlaw block: "
          f"{drv.red_adapt_iters} marginalized-likelihood MH steps in "
          f"{drv.red_adapt_seconds:.3f} s; float64 factor runs on the card "
          + json.dumps(f64) + "; DE periods read from chain rows "
          + json.dumps(drv.de_chain_periods), flush=True)
    print(f"phase {phase} per-block ms per steady sweep (CUDA events): "
          + json.dumps({k: round(v / drv.steady_sweeps, 4)
                        for k, v in sorted(drv.timer.ms.items())})
          + "; warmup and adaptation block ms in all " + json.dumps(
              {k: round(v, 1) for k, v in sorted(drv.warmup_ms.items())}),
          flush=True)
    print(f"phase {phase} CUDA graphs: {len(graphs.graphs)} captured in "
          f"{graphs.capture_seconds:.3f} s, pool "
          f"{graphs.pool_bytes / 1e6:.1f} MB; red_mh acceptance per chain "
          + json.dumps([round(a, 4) for a in racc]) + f" over "
          f"{drv.red_steps} x {drv.red_mh_sweeps} steps; b_mh acceptance "
          f"mean {(drv.b_mh_accepts[:, :cm.P_real] / max(drv.b_mh_sweeps, 1)).mean().item():.4f}",
          flush=True)
    print(f"phase {phase} powerlaw hyper medians "
          + json.dumps({cm.param_names[j]: round(float(m), 3)
                        for j, m in list(zip(red, med_red))[:8]})
          + (f" ... ({len(red)})" if len(red) > 8 else "")
          + "; by hyper over pulsars (min, median, max) " + json.dumps(
              by_hyper(cm, red, med_red))
          + "; common log10_rho medians " + json.dumps(
              [round(float(v), 3) for v in med_rho]), flush=True)
    print_counts(phase, counts)
    finite = bool(np.isfinite(chain).all() and np.isfinite(g.bchain).all())
    inside = bool(((med_rho > -10.0) & (med_rho < -4.0)).all()
                  and ((med_red > pa) & (med_red < pb)).all())
    saved = rep["ok"] and rep["rows"] == niter and graphs.graphed
    de = bool(drv.de_chain_periods) or not de_gate
    white = not (no_white and {"white", "ecorr"} & set(
        drv.sweep_blocks(False) + drv.sweep_blocks(True)))
    ok = (finite and inside and not missing and not unreplayed
          and not unaccounted and saved and de and white)
    if not ok:
        print(f"chip_smoke: powerlaw path {phase} failed (finite={finite}, "
              f"medians inside the priors={inside}, never run={missing}, "
              f"not replayed as captured={unreplayed}, runs other than "
              f"eager launches plus replays={unaccounted}, verified "
              f"checkpoint through the graphs={saved}, DE periods from "
              f"chain rows={drv.de_chain_periods}, no white or ECORR "
              f"block={white})", file=sys.stderr)
    return ok, counts[0], g


def by_hyper(cm, cols, med):
    """``{hyper: [min, median, max]}`` of the chains' medians ``med`` of
    the parameters ``cols`` over pulsars, a hyper being a parameter's name
    without its pulsar (``red_noise_log10_A``, ``dm_gp_gamma``; a common
    one keeps its name)."""
    import numpy as np

    groups = {}
    for j, m in zip(cols, med):
        nm = cm.param_names[j]
        key = nm if nm.startswith("gw_") else nm.split("_", 1)[1]
        groups.setdefault(key, []).append(float(m))
    return {k: [round(float(f(v)), 3) for f in (np.min, np.median, np.max)]
            for k, v in groups.items()}


def hd_path(cm, seed, outdir, steady, warmup=WARMUP, phase="10"):
    """Phase 10 (16): ``PTABlockGibbs`` on the Hellings-Downs model (with
    sampled ORF weights) through ``warmup`` sweeps, adaptation and
    ``steady`` sweeps replayed from the graphs, checkpointed every
    ``SAVE_EVERY`` sweeps, with the launch counts set to 0 just before
    it.  Gates: every record finite, every common log10_rho median inside
    (-10, -4), the final checkpoint verified, the Gram form of
    ``HD_FORMS`` run on the card, replayed as captured times replays and
    run as often as the eager launches plus replays; with sampled
    weights, those of :func:`orf_gates`.  Returns ``(ok, runs,
    sampler)``."""
    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    C, niter = HD_CHAINS, warmup + 1 + steady
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = ptt.PTABlockGibbs(cm, nchains=C, device=cm.device, seed=seed,
                          warmup_sweeps=warmup, progress=False,
                          white_adapt_iters=SIDE_WHITE_ADAPT)
    x0 = g.initial_sample(torch.Generator(device=cm.device).manual_seed(
        seed))
    chain = g.sample(x0, outdir=outdir, niter=niter, save_every=SAVE_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drv, graphs = g.driver, g.driver.carry
    counts = launch_counts(graphs)
    missing, unreplayed, unaccounted = count_faults(counts, HD_FORMS,
                                                    HD_FORMS)
    sps = drv.steady_sweeps / drv.steady_seconds
    rho = chain[warmup + 1:, :, cm.rho_ix_x.cpu().numpy()]
    med = np.median(rho.reshape(-1, rho.shape[-1]), axis=0)
    red = chain[warmup + 1:, :, cm.idx.red_rho]
    rep = integrity.verify(outdir)
    total = drv.b_joint_breakdowns.tolist()
    breakdowns = {**{f"{k} (float64)": v
                     for k, v in drv.kept_by_stage.items()},
                  "steady two-float": total[0] - drv.warmup_breakdowns[0],
                  "steady float64": total[1] - drv.warmup_breakdowns[1]}
    print(f"phase {phase} Hellings-Downs array ({cm.orf_name}, P "
          f"{cm.P_real}, Bmax {cm.Bmax}, Nmax {cm.Nmax}, nx {cm.nx}, K "
          f"{cm.K}, joint_mixed {drv.joint_mixed}, b-draw {drv.hd_kernel}): "
          f"{niter} rows x {C} chains in "
          f"{wall:.1f} s (warmup {warmup}); white sub-chain "
          f"{drv.aclength_white} steps; steady {drv.steady_sweeps} sweeps "
          f"in {drv.steady_seconds:.3f} s = {sps:.3f} sweeps/s = "
          f"{sps * C:.1f} samples/s", flush=True)
    print(f"phase {phase} per-block ms per steady sweep (CUDA events): "
          + json.dumps({k: round(v / drv.steady_sweeps, 4)
                        for k, v in sorted(drv.timer.ms.items())})
          + "; per sweep of its own: b_joint "
          f"{drv.timer.ms['b_joint'] / max(drv.b_mh_sweeps, 1):.4f}, "
          "b_joint_exact "
          f"{drv.timer.ms['b_joint_exact'] / max(drv.b_refresh_sweeps, 1):.4f}"
          f" ({drv.b_mh_sweeps} and {drv.b_refresh_sweeps} sweeps)",
          flush=True)
    print(f"phase {phase} warmup and adaptation block ms in all (CUDA "
          f"events, eager; {warmup} sweeps): " + json.dumps(
              {k: round(v, 1) for k, v in sorted(drv.warmup_ms.items())})
          + f"; {sum(drv.warmup_ms.values()):.1f} ms in all", flush=True)
    print(f"phase {phase} CUDA graphs: {len(graphs.graphs)} captured in "
          f"{graphs.capture_seconds:.3f} s (with the warm-up pass), pool "
          f"{graphs.pool_bytes / 1e6:.1f} MB; by graph, capture s "
          + json.dumps({k: round(v, 3) for k, v in graphs.capture_by.items()})
          + ", pool MB " + json.dumps(
              {k: round(v / 1e6, 1) for k, v in graphs.pool_by.items()})
          + f"; peak device memory {torch.cuda.max_memory_allocated() / 1e6:.1f}"
          " MB", flush=True)
    busy = sum(g.store.seconds.values())
    print(f"phase {phase} checkpoints every {SAVE_EVERY} sweeps: saves ran "
          f"{busy:.3f} s on their thread, the loop waited "
          f"{g.save_seconds:.3f} s; final manifest verified {rep['ok']} at "
          f"{rep['rows']} rows; joint draws that kept their b (not "
          f"finite) {json.dumps(breakdowns)} of {C} chains x 1, "
          f"{warmup}, 2, {drv.b_mh_sweeps}, {drv.b_refresh_sweeps} draws; "
          "gram_accumulate[f32_dot_f64_reduce] "
          f"runs on the card {counts[0][HD_FORMS[0]]}", flush=True)
    print(f"phase {phase} common log10_rho medians per bin: "
          + json.dumps([round(float(v), 3) for v in med])
          + "; red log10_rho medians, mean over pulsars per bin "
          + json.dumps([round(float(v), 3) for v in np.median(
              red.reshape(-1, red.shape[-1]), axis=0).reshape(
                  cm.P_real, -1).mean(0)]), flush=True)
    print_counts(phase, counts)
    finite = bool(np.isfinite(chain).all() and np.isfinite(g.bchain).all())
    inside = bool(((med > -10.0) & (med < -4.0)).all())
    saved = rep["ok"] and rep["rows"] == niter and graphs.graphed
    ok = (finite and inside and not missing and not unreplayed
          and not unaccounted and saved)
    if cm.orf_B is not None:
        ok &= orf_gates(cm, g, warmup, phase)
    if not ok:
        print(f"chip_smoke: Hellings-Downs path {phase} failed (finite="
              f"{finite}, "
              f"medians inside the prior={inside}, never run={missing}, "
              f"not replayed as captured={unreplayed}, runs other than "
              f"eager launches plus replays={unaccounted}, verified "
              f"checkpoint through the graphs={saved})", file=sys.stderr)
    return ok, counts[0], g


def orf_gates(cm, g, warmup, phase):
    """Phase 16's gates beyond phase 10's, printed with the ORF weights'
    MH ms and acceptance: G(theta) positive definite in every recorded
    row (host ``eigvalsh``), every weight moved in every chain over the
    steady rows, and every recorded weight inside (-1, 1)."""
    import numpy as np

    drv = g.driver
    th = g.chain[:, :, cm.orf_par_ix.cpu().numpy()]        # (rows, C, J)
    B = cm.orf_B.cpu().numpy()
    G = np.eye(cm.P) + np.einsum("rcj,jpq->rcpq", th, B)
    wmin = np.linalg.eigvalsh(G).min(-1)
    steady = th[warmup + 1:]
    pd = bool((wmin > 0).all())
    moved = bool((np.ptp(steady, axis=0) > 0).all())
    inside = bool((np.abs(th) < 1.0).all())
    acc = (drv.orf_mh_accepts / max(drv.orf_mh_sweeps * drv.red_steps, 1)
           ).cpu().numpy()
    names = [cm.param_names[j] for j in cm.orf_par_ix.tolist()]
    print(f"phase {phase} ORF weights ({len(names)}): orf_mh "
          f"{drv.timer.ms['orf_mh'] / max(drv.steady_sweeps, 1):.4f} ms per "
          f"steady sweep ({drv.red_steps} steps), acceptance per step mean "
          f"{acc.mean():.4f}, over chains {acc.min():.4f}-{acc.max():.4f}; "
          f"least eigenvalue of G over {wmin.size} recorded rows "
          f"{wmin.min():.4f} (positive definite {pd}); moved in every "
          f"chain {moved}, inside (-1, 1) {inside}; medians "
          + json.dumps({nm: round(float(v), 3) for nm, v in zip(
              names, np.median(steady.reshape(-1, len(names)), axis=0))}),
          flush=True)
    return pd and moved and inside


def alt_draw_path(cm, kern, seed, outdir):
    """Phase 16d: the Hellings-Downs model by ``PTABlockGibbs(nchains=
    HD_CHAINS)`` under ``PTGIBBS_HD_KERNEL=kern`` (read when the sampler
    is built), ``HD_ALT_WARMUP`` warmup and ``HD_ALT_STEADY`` steady
    sweeps from the graphs (the white block adapted on a record of
    ``CHECK_ADAPT`` steps), launch counts from 0; gates: every record
    finite, the common log10_rho medians inside (-10, -4), the Gram form
    run on the card and replayed as captured, and one steady sweep from
    the final state graphed equal to eager bitwise.  Returns ``(ok,
    runs)``."""
    import os

    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.ops import kernels

    C, niter = HD_CHAINS, HD_ALT_WARMUP + 1 + HD_ALT_STEADY
    kernels.reset_launches()
    t0 = time.perf_counter()
    before = os.environ.get("PTGIBBS_HD_KERNEL")
    os.environ["PTGIBBS_HD_KERNEL"] = kern
    try:
        g = ptt.PTABlockGibbs(cm, nchains=C, device=cm.device, seed=seed,
                              warmup_sweeps=HD_ALT_WARMUP, progress=False,
                              white_adapt_iters=CHECK_ADAPT)
    finally:
        if before is None:
            del os.environ["PTGIBBS_HD_KERNEL"]
        else:
            os.environ["PTGIBBS_HD_KERNEL"] = before
    drv = g.driver
    chain = g.sample(g.initial_sample(torch.Generator(
        device=cm.device).manual_seed(seed)), outdir=outdir, niter=niter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(drv.carry)
    missing, unreplayed, unaccounted = count_faults(counts, HD_FORMS,
                                                    HD_FORMS)
    sps = drv.steady_sweeps / drv.steady_seconds
    rho = chain[HD_ALT_WARMUP + 1:, :, cm.rho_ix_x.cpu().numpy()]
    med = np.median(rho.reshape(-1, rho.shape[-1]), axis=0)
    total = drv.b_joint_breakdowns.tolist()
    print(f"phase 16d PTGIBBS_HD_KERNEL={kern} (b-draw {drv.hd_kernel}): "
          f"{niter} rows x {C} chains in {wall:.1f} s (warmup "
          f"{HD_ALT_WARMUP}); steady {drv.steady_sweeps} sweeps in "
          f"{drv.steady_seconds:.3f} s = {sps:.3f} sweeps/s = "
          f"{sps * C:.1f} samples/s; per-block ms per steady sweep "
          + json.dumps({k: round(v / drv.steady_sweeps, 4)
                        for k, v in sorted(drv.timer.ms.items())})
          + "; warmup and adaptation block ms in all " + json.dumps(
              {k: round(v, 1) for k, v in sorted(drv.warmup_ms.items())})
          + f"; capture {drv.carry.capture_seconds:.3f} s, pool "
          f"{drv.carry.pool_bytes / 1e6:.1f} MB; draws that kept (some of) "
          f"their b {json.dumps(drv.kept_by_stage)}, steady two-float "
          f"{total[0] - drv.warmup_breakdowns[0]}, float64 "
          f"{total[1] - drv.warmup_breakdowns[1]}; common log10_rho medians "
          + json.dumps([round(float(v), 3) for v in med]), flush=True)
    print_counts("16d", counts)
    finite = bool(np.isfinite(chain).all() and np.isfinite(g.bchain).all())
    inside = bool(((med > -10.0) & (med < -4.0)).all())
    ok = (finite and inside and not missing and not unreplayed
          and not unaccounted and drv.hd_kernel == kern)
    ok &= graphs_vs_eager(drv, torch.as_tensor(drv.x_cur, device=cm.device),
                          drv.b.to(cm.device), niter, "16d",
                          f"PTGIBBS_HD_KERNEL={kern}", sweeps=1)
    if not ok:
        print(f"chip_smoke: phase 16d ({kern}) failed (finite={finite}, "
              f"medians inside the prior={inside}, never run={missing}, "
              f"not replayed as captured={unreplayed}, runs other than "
              f"eager launches plus replays={unaccounted})", file=sys.stderr)
    return ok, counts[0]


def orf_paths(args, psrs, gen, outdir, hd_rec):
    """Phases 16-16d: the sampled ORF weights and the alternative
    correlated-ORF b-draws.  Phase 2 first holds the Gram form at phase
    16's state (the shape of the Hellings-Downs row, ``hd_rec``, which
    times it).  Returns the ``kernels`` rows of the new paths, or None
    when a phase failed."""
    import torch

    import pulsar_timing_gibbsspec_torch as ptt

    dev = torch.device(DEVICE)
    opts = dict(tm_svd=True, white_vary=True, common_psd="spectrum",
                common_components=HD_BINS, red_psd="spectrum",
                red_components=HD_BINS, device=dev)
    cm16 = ptt.model_general(psrs, orf=ORF_SAMPLED, **opts)
    cm_hd = ptt.model_general(psrs, orf="hd", **opts)
    print(f"phase 16 model: P={cm16.P} Nmax={cm16.Nmax} Bmax={cm16.Bmax} "
          f"nx={cm16.nx}, orf {cm16.orf_name} with {len(cm16.idx.orf)} "
          f"sampled weights, K {cm16.K}, {HD_CHAINS} chains", flush=True)
    rec16, ok = gram_parity(cm16, parity_state(cm16, HD_CHAINS, gen), None,
                            forms=("f32_dot_f64_reduce",))
    torch.cuda.empty_cache()
    if not ok:
        print("chip_smoke: kernel parity at phase 16's state failed",
              file=sys.stderr)
        return None
    ok16, runs16, g16 = hd_path(cm16, args.seed, outdir / "orf", ORF_STEADY,
                                warmup=SIDE_WARMUP, phase="16")
    if not ok16:
        return None
    drv16 = g16.driver
    if not graphs_vs_eager(drv16, torch.as_tensor(drv16.x_cur, device=dev),
                           drv16.b.to(dev), ORF_GRAPH_CHECK_AT, "16b",
                           "PTABlockGibbs, sampled ORF weights, across the "
                           "refresh at 304"):
        print("chip_smoke: the sampled-ORF graph replay differs from the "
              "eager sweep", file=sys.stderr)
        return None
    del g16, drv16
    torch.cuda.empty_cache()
    if not resume_check(cm16, args.seed, outdir / "orf_resume",
                        "PTABlockGibbs", "16c", warmup=HD_RESUME_WARMUP,
                        steady=HD_RESUME_STEADY):
        print("chip_smoke: the resumed sampled-ORF run differs from the "
              "whole one", file=sys.stderr)
        return None
    torch.cuda.empty_cache()
    elapsed("phases 16-16c")
    runs = {"16": runs16}
    for kern in HD_ALT_KERNELS:
        ok_d, runs[kern] = alt_draw_path(cm_hd, kern, args.seed,
                                         outdir / f"hd_{kern}")
        torch.cuda.empty_cache()
        if not ok_d:
            return None
    elapsed("phase 16d")
    what = {"16": f"sampled ORF weights ({ORF_SAMPLED})",
            "pulsar": "PTGIBBS_HD_KERNEL=pulsar", "freq":
            "PTGIBBS_HD_KERNEL=freq"}
    key = HD_FORMS[0]
    k, f = key
    return [dict(name=f"{k}[{f}] (phase {'16' if nm == '16' else '16d'} "
                 f"path: {what[nm]}, B1 {cm16.Bmax + 1})", route="cuda",
                 source=SOURCES[k][0], replaces=REPLACES[k],
                 launches=runs[nm][key],
                 **{**hd_rec[key], "max_abs_err": (
                     rec16[key]["max_abs_err"] if nm == "16"
                     else hd_rec[key]["max_abs_err"])})
            for nm in ("16",) + HD_ALT_KERNELS]


def ke_woodbury_agreement(cm, cpu, seed):
    """Phase 13a: the kernel-ECORR Gram (the widening kernel minus the
    plain Woodbury correction, ``blocks.tnt_d_x``) on the card against
    the same function on the CPU model ``cpu`` (the plain Gram), at a
    seeded state of ``SINGLE_CHAINS`` chains and one float32 N (the
    CPU's, copied to the card: the two devices' float32 ``pow`` may round
    N apart by an ulp, which the cancellation of ``TNT - V^T w V``
    amplifies): the difference at the Jacobi scale of the diagonal Gram
    within 1e-10 (float64 sums in other orders), and every dummy epoch's
    ``w`` at most 1e-60."""
    import torch

    from pulsar_timing_gibbsspec_torch.sampler import blocks

    x = parity_state(cpu, SINGLE_CHAINS, torch.Generator().manual_seed(
        seed + 3))
    N0 = cpu.ndiag_fast(x)
    out = {}
    for m in (cm, cpu):
        xm, N = x.to(m.device), N0.to(m.device)
        TNT0, _ = blocks.tnt_d(m, N)
        TNT, d = blocks.tnt_d_x(m, xm, N)
        w = blocks.ke_weights(m, xm, N)[2]
        out[m.device.type] = [t.cpu() for t in (TNT0, TNT, d, w)]
    TNT0, TNTg, dg, w = out["cuda"]
    _, TNTc, dc, _ = out["cpu"]
    sc = torch.sqrt(torch.clamp(torch.diagonal(TNT0, dim1=-2, dim2=-1),
                                min=1e-300))
    err = ((TNTg - TNTc).abs() / (sc[..., :, None] * sc[..., None, :])).amax()
    err_d = ((dg - dc).abs() / sc).amax()
    live = cm.ke_U.sum(-1).cpu() > 0
    w_dummy = float(w[:, ~live].abs().max()) if (~live).any() else 0.0
    corr = ((TNT0 - TNTg).abs() / (sc[..., :, None] * sc[..., None, :])
            ).amax()
    ok = bool(err <= 1e-10 and err_d <= 1e-10 and w_dummy <= 1e-60
              and torch.isfinite(TNTg).all())
    print(f"phase 13a kernel-ECORR Gram (widening kernel minus the plain "
          f"Woodbury correction) card vs CPU at {SINGLE_CHAINS} chains: max "
          f"|TNT| difference / Jacobi scale {float(err):.3e}, |d| "
          f"{float(err_d):.3e} (tol 1e-10); the correction itself up to "
          f"{float(corr):.3e} of the scale; largest dummy-epoch w "
          f"{w_dummy:.3e} (tol 1e-60) {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def ke_path(cm, seed, outdir, steady):
    """Phase 13: README's Quick start from par/tim, compiled with kernel
    ECORR, by ``PulsarBlockGibbs(nchains=SINGLE_CHAINS,
    ecorrsample="kernel")`` through warmup, adaptation and ``steady``
    sweeps replayed from the graphs (one body: the exact b-draw every
    sweep), checkpointed every ``SAVE_EVERY`` sweeps, with the launch
    counts set to 0 just before it.  Gates: every record finite; every
    common log10_rho and log10_ecorr median inside its prior; the final
    checkpoint verified; the sweep ``white, ecorr, rho, b_exact``; the
    wide widening Gram run on the card, one launch in the b_exact graph,
    run once per steady sweep since the captures, replayed as captured
    times replays and run as often as the eager launches plus replays.
    Returns ``(ok, runs, sampler)``."""
    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    C, niter = SINGLE_CHAINS, SIDE_WARMUP + 1 + steady
    kernels.reset_launches()
    t0 = time.perf_counter()
    g = ptt.PulsarBlockGibbs(cm, nchains=C, device=cm.device, seed=seed,
                             warmup_sweeps=SIDE_WARMUP, ecorrsample="kernel",
                             progress=False,
                             white_adapt_iters=SIDE_WHITE_ADAPT)
    x0 = g.initial_sample(torch.Generator(device=cm.device).manual_seed(
        seed))
    chain = g.sample(x0, outdir=outdir, niter=niter, save_every=SAVE_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drv, graphs = g.driver, g.driver.carry
    counts = launch_counts(graphs)
    missing, unreplayed, unaccounted = count_faults(counts, KE_FORMS,
                                                    KE_FORMS)
    form = KE_FORMS[0]
    since = counts[4][form]
    per_sweep = (since == drv.steady_sweeps
                 and graphs.launches.get("b_exact") == {form: 1})
    sps = drv.steady_sweeps / drv.steady_seconds
    rows = chain[SIDE_WARMUP + 1:]
    med = np.median(rows[:, :, cm.rho_ix_x.cpu().numpy()], axis=(0, 1))
    ec = [int(j) for j in cm.idx.ecorr]
    med_ec = np.median(rows[:, :, ec], axis=(0, 1))
    pa, pb = cm.pa.cpu().numpy()[ec], cm.pb.cpu().numpy()[ec]
    rep = integrity.verify(outdir)
    blocks_ = drv.sweep_blocks(False)
    print(f"phase 13 Quick start from par/tim with kernel ECORR "
          f"({cm.pulsars[0]}, Bmax {cm.Bmax} (B1 {cm.Bmax + 1}), Nmax "
          f"{cm.Nmax}, nx {cm.nx}, {cm.ke_par_ix.shape[1]} ECORR epochs in "
          f"N): {niter} rows x {C} chains in {wall:.1f} s (warmup "
          f"{SIDE_WARMUP});"
          f" sweep {blocks_}; white sub-chain {drv.aclength_white} steps, "
          f"ECORR sub-chain {drv.aclength_ecorr} steps; steady "
          f"{drv.steady_sweeps} sweeps in {drv.steady_seconds:.3f} s = "
          f"{sps:.3f} sweeps/s = {sps * C:.1f} samples/s", flush=True)
    print("phase 13 per-block ms per steady sweep (CUDA events): "
          + json.dumps({k: round(v / drv.steady_sweeps, 4)
                        for k, v in sorted(drv.timer.ms.items())})
          + "; warmup and adaptation block ms in all (eager) " + json.dumps(
              {k: round(v, 1) for k, v in sorted(drv.warmup_ms.items())}),
          flush=True)
    busy = sum(g.store.seconds.values())
    print(f"phase 13 CUDA graphs: {len(graphs.graphs)} captured in "
          f"{graphs.capture_seconds:.3f} s, pool "
          f"{graphs.pool_bytes / 1e6:.1f} MB, launches per graph "
          + json.dumps({k: {"/".join(f): n for f, n in v.items()}
                        for k, v in graphs.launches.items() if v})
          + f"; checkpoints every {SAVE_EVERY} sweeps: saves ran "
          f"{busy:.3f} s on their thread, the loop waited "
          f"{g.save_seconds:.3f} s; final manifest verified {rep['ok']} at "
          f"{rep['rows']} rows", flush=True)
    print("phase 13 log10_rho medians per bin: "
          + json.dumps([round(float(v), 3) for v in med])
          + "; log10_ecorr medians " + json.dumps(
              [round(float(v), 3) for v in med_ec])
          + f"; {form[0]}[{form[1]}] runs since the captures {since} for "
          f"{drv.steady_sweeps} steady sweeps", flush=True)
    print_counts(13, counts)
    finite = bool(np.isfinite(chain).all() and np.isfinite(g.bchain).all())
    inside = bool(((med > -10.0) & (med < -4.0)).all()
                  and ((med_ec > pa) & (med_ec < pb)).all())
    saved = rep["ok"] and rep["rows"] == niter and graphs.graphed
    sweep = blocks_ == ["white", "ecorr", "rho", "b_exact"]
    ok = (finite and inside and not missing and not unreplayed
          and not unaccounted and saved and per_sweep and sweep)
    if not ok:
        print(f"chip_smoke: kernel-ECORR path failed (finite={finite}, "
              f"medians inside the priors={inside}, never run={missing}, "
              f"not replayed as captured={unreplayed}, runs other than "
              f"eager launches plus replays={unaccounted}, verified "
              f"checkpoint through the graphs={saved}, the wide widening "
              f"Gram once per steady sweep={per_sweep}, sweep={blocks_})",
              file=sys.stderr)
    return ok, counts[0], g


def tprocess_gates(cm, g, warmup):
    """Phase 14's gates beyond the powerlaw path's: every recorded
    t-process alpha finite and positive, and none left where it began
    (the conjugate draw ran).  Prints the alphas' medians by bin."""
    import numpy as np

    cols = [j for j, nm in enumerate(cm.param_names) if "_alphas_" in nm]
    a = g.chain[:, :, cols]
    steady = a[warmup + 1:]
    good = bool(np.isfinite(a).all() and (a > 0).all()
                and (steady[-1] != steady[0]).any())
    med = np.median(steady.reshape(-1, cm.P_real, len(cols) // cm.P_real),
                    axis=0)
    print(f"phase 14 t-process alphas ({len(cols)}): finite and positive "
          f"{bool(np.isfinite(a).all() and (a > 0).all())}, medians by bin "
          "(mean over pulsars) " + json.dumps(
              [round(float(v), 3) for v in med.mean(0)])
          + f", range of the medians [{med.min():.3g}, {med.max():.3g}] "
          f"{'ok' if good else 'FAIL'}", flush=True)
    return good


def infinitepower_check(cm, seed, outdir):
    """Phase 14d: ``red_psd="infinitepower"`` on the array by
    ``PTABlockGibbs(nchains=IP_CHAINS)``, ``IP_WARMUP`` warmup and
    ``IP_STEADY`` steady sweeps through the graphs: every record
    finite."""
    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt

    t0 = time.perf_counter()
    g = ptt.PTABlockGibbs(cm, nchains=IP_CHAINS, device=cm.device,
                          seed=seed, warmup_sweeps=IP_WARMUP, progress=False,
                          white_adapt_iters=SIDE_WHITE_ADAPT)
    chain = g.sample(g.initial_sample(torch.Generator(
        device=cm.device).manual_seed(seed)), outdir=outdir,
        niter=IP_WARMUP + 1 + IP_STEADY)
    ok = bool(np.isfinite(chain).all() and np.isfinite(g.bchain).all()
              and g.driver.carry.graphed)
    med = np.median(chain[IP_WARMUP + 1:, :, cm.rho_ix_x.cpu().numpy()],
                    axis=(0, 1))
    print(f"phase 14d infinitepower array (red {cm.red_kind}, "
          f"{IP_CHAINS} chains, {IP_WARMUP} + {IP_STEADY} sweeps, sweep "
          f"{g.driver.sweep_blocks(False)}): records finite {ok}; common "
          "log10_rho medians " + json.dumps(
              [round(float(v), 3) for v in med])
          + f"; {time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def grid_paths(args, psrs, gen, outdir):
    """Phases 15-15d: ``model_general``'s frequency-grid and selection
    options.  Phase 2 holds and times every kernel form at their shapes
    first.  15: the 45-pulsar array with ``Tspan`` the array's span,
    the log grid of ``logfreq=True, nmodes_log=10`` over 10 linear bins
    given as ``modes`` (common and red free spectra with one bin per grid
    frequency: the JAX ``compile_pta`` cannot compile a free spectrum
    under ``logfreq`` itself) and ``pshift=True, pseed=1``, by
    ``PTABlockGibbs(white_steps_max=32, exact_every=8)`` with no
    ``.bak`` checkpoint (red noise is a free spectrum: a powerlaw's
    variance at a hundredth of 1/Tspan leaves the log grid's lowest
    columns, nearly polynomials over the span, unregularized beside the
    timing model, and the b-systems are singular in float64 at gamma
    3-5); gates: the powerlaw path's, the white sub-chain
    at most 32, the refresh every 8th sweep, no ``.bak`` file; 15c
    graphed = eager bitwise across a refresh; 15d split and resumed
    bitwise.  15b: J1713+0747 with ``red_select="band"`` (two row-masked
    powerlaw red GPs, 360 TOAs each) by ``PulsarBlockGibbs``; gates: the
    powerlaw path's, and both bands' hypers move and stay inside their
    priors.  Returns the ``kernels`` rows of their shapes, or None when
    a phase failed."""
    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import (get_tspan,
                                                     load_enterprise_snapshot)
    from pulsar_timing_gibbsspec_torch.models.build import log_grid

    dev = torch.device(DEVICE)
    tspan = get_tspan(psrs)
    grid = log_grid(P15_BINS, P15_LOG_BINS, tspan)
    cm15 = ptt.model_general(
        psrs, tm_svd=True, white_vary=True, Tspan=tspan, modes=grid,
        common_psd="spectrum", common_components=len(grid),
        red_psd="spectrum", red_components=len(grid), pshift=True,
        pseed=P15_PSEED, device=dev)
    cm15b = ptt.model_general(
        [load_enterprise_snapshot(SNAPSHOT)], white_vary=True,
        common_psd="spectrum", common_components=SINGLE_BINS,
        red_psd="powerlaw", red_components=SINGLE_BINS, red_select="band",
        device=dev)
    print(f"phase 15 model: P={cm15.P} Nmax={cm15.Nmax} Bmax={cm15.Bmax} "
          f"nx={cm15.nx}, Tspan {tspan:.6g} s, {len(grid)} frequencies "
          f"from {grid[0]:.4g} to {grid[-1]:.4g} Hz, common {cm15.gw_kind} "
          f"({cm15.K}), red {cm15.red_kind} ({cm15.Kr}), "
          f"{len(cm15.idx.red)} powerlaw hypers, pshift seed {P15_PSEED}",
          flush=True)
    band = [j for j in cm15b.idx.red if "_red_noise_" in cm15b.param_names[j]]
    print(f"phase 15b model: {cm15b.pulsars[0]} Bmax={cm15b.Bmax} "
          f"nx={cm15b.nx}, components {[c.kind for c in cm15b.components]},"
          f" band hypers {[cm15b.param_names[j] for j in band]}", flush=True)
    recs, ok = {}, True
    for nm, m, nc in (("15", cm15, NCHAINS), ("15b", cm15b, SINGLE_CHAINS)):
        xs = parity_state(m, nc, gen)
        recs[nm], good = gram_parity(m, xs, time_ms)
        # the float64 factor runs in the powerlaw adaptation alone: 15b
        for rec, g2 in ((chol_parity(m, xs, gen, time_ms),)
                        + ((chol64_parity(m, xs, time_ms),)
                           if nm == "15b" else ())):
            recs[nm].update(rec)
            good &= g2
        ok &= good
        del xs
    torch.cuda.empty_cache()
    elapsed("phase 2 (phases 15-15b's kernel parity and timings)")
    if not ok:
        print("chip_smoke: kernel parity at phases 15-15b's shapes failed",
              file=sys.stderr)
        return None

    # ---- phase 15: the log grid, pshift and the driver options ------------
    out15 = outdir / "grid"
    ok15, runs15, g15 = powerlaw_path(
        "15", cm15, "PTABlockGibbs", NCHAINS, SIDE_WARMUP, P15_STEADY,
        args.seed,
        out15, list(recs["15"]), GRAPHED, backup=False,
        white_adapt_iters=SIDE_WHITE_ADAPT, **P15_OPTS)
    drv = g15.driver
    baks = sorted(p.name for p in out15.iterdir() if ".bak" in p.name)
    steady = range(drv._it_base(SIDE_WARMUP + 1 + P15_STEADY),
                   SIDE_WARMUP + 1 + P15_STEADY)
    cadence = drv.b_refresh_sweeps == sum(
        t % P15_OPTS["exact_every"] == 0 for t in steady)
    capped = drv.aclength_white <= P15_OPTS["white_steps_max"]
    print(f"phase 15 options: white sub-chain {drv.aclength_white} steps "
          f"(cap {drv.white_steps_max}), {drv.b_refresh_sweeps} refresh and "
          f"{drv.b_mh_sweeps} b_mh sweeps (exact_every {drv.exact_every}), "
          f".bak files {baks}", flush=True)
    if not (ok15 and capped and cadence and not baks):
        print(f"chip_smoke: phase 15 failed (path={ok15}, capped={capped}, "
              f"refresh cadence={cadence}, .bak files={baks})",
              file=sys.stderr)
        return None
    if not graphs_vs_eager(drv, torch.as_tensor(drv.x_cur, device=dev),
                           drv.b.to(dev), SIDE_WARMUP + 1 + P15_STEADY,
                           "15c",
                           "PTABlockGibbs, log grid and pshift, across a "
                           "refresh"):
        print("chip_smoke: phase 15's graph replay differs from the eager "
              "sweep", file=sys.stderr)
        return None
    del g15, drv
    torch.cuda.empty_cache()
    if not resume_check(cm15, args.seed, outdir / "grid_resume",
                        "PTABlockGibbs", "15d", warmup=SIDE_RESUME_WARMUP,
                        steady=SIDE_RESUME_STEADY, **P15_OPTS):
        print("chip_smoke: phase 15's resumed run differs from the whole "
              "one", file=sys.stderr)
        return None
    elapsed("phases 15-15d")

    # ---- phase 15b: red noise split by band --------------------------------
    ok15b, runs15b, g15b = powerlaw_path(
        "15b", cm15b, "PulsarBlockGibbs", SINGLE_CHAINS, P15B_WARMUP,
        P15B_STEADY, args.seed, outdir / "band", list(recs["15b"]),
        WIDE_GRAPHED, red_adapt_iters=SIDE_RED_ADAPT,
        white_adapt_iters=SIDE_WHITE_ADAPT)
    hyp = g15b.chain[P15B_WARMUP + 1:][:, :, band]          # (S, C, 4)
    pa = cm15b.pa.cpu().numpy()[band]
    pb = cm15b.pb.cpu().numpy()[band]
    moved = bool((np.ptp(hyp, axis=0) > 0).all())
    inside = bool(((hyp > pa) & (hyp < pb)).all())
    print(f"phase 15b band hypers: moved in every chain {moved}, every "
          f"steady value inside its prior {inside}; medians "
          + json.dumps({cm15b.param_names[j]: round(float(v), 3) for j, v in
                        zip(band, np.median(hyp, axis=(0, 1)))}), flush=True)
    del g15b
    torch.cuda.empty_cache()
    elapsed("phase 15b")
    if not (ok15b and moved and inside):
        print("chip_smoke: phase 15b failed", file=sys.stderr)
        return None
    what = {"15": (cm15, runs15, "log grid, pshift"),
            "15b": (cm15b, runs15b, "red noise split by band")}
    return [dict(name=f"{k}[{f}] (phase {nm} path: {what[nm][2]}, order "
                 f"{what[nm][0].Bmax})", route="cuda",
                 source=SOURCES[k][f.endswith("_wide")],
                 replaces=REPLACES[k], launches=what[nm][1][(k, f)], **r)
            for nm, rs in recs.items() for (k, f), r in rs.items()]


def supervised_path(cm, seed, outdir, niter, ref, ref_wall, sps):
    """Phase 17: phase 4's run (``ref``: its chain and bchain, ``ref_wall``
    its seconds, ``sps`` its steady sweeps per second) under
    ``run_supervised`` with one fault of each class (module docstring).
    Returns ``(ok, runs)``: the gates, and the kernel runs counted on the
    card from 0."""
    import shutil

    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import (
        DispatchWatchdog, faults, integrity, preemption, run_supervised,
        telemetry)

    out = Path(outdir)
    shutil.rmtree(out, ignore_errors=True)
    r1 = WARMUP + 1 + SAVE_EVERY          # the second steady chunk's start
    r2 = r1 + SAVE_EVERY                  # the third's
    chunk_s = SAVE_EVERY / sps
    woke = []

    def on_event(stage, info):
        if stage == "dump":       # before the stalled worker is detached
            box = wd._inbox

            def watch():          # when the abandoned worker ends its seam
                if box["done"].wait(300.0):
                    woke.append(time.time())

            threading.Thread(target=watch, daemon=True).start()

    wd = DispatchWatchdog(k=SUP_WD_K, floor_s=SUP_WD_FLOOR_S,
                          first_floor_s=120.0, soft_frac=SUP_WD_SOFT,
                          on_event=on_event)
    stall_s = SUP_WD_K * chunk_s + SUP_STALL_EXTRA_S
    faults.clear()
    telemetry.reset()
    preemption.reset()
    faults.inject("xla_error", point="dispatch.chunk", at_row=r1)
    faults.inject("stall", point="dispatch.chunk", at_row=r2,
                  seconds=stall_s)
    faults.inject("truncate_file", point="chainstore.post_save",
                  at_row=r1, path="chain.npy")
    faults.inject("nan_rows", at_row=r1 + SUP_NAN_OFFSET)
    faults.inject("sigterm_at_seam", point="sample.loop", at_row=r2,
                  seconds=120.0)
    kernels.reset_launches()
    delays = []
    g = ptt.PTABlockGibbs(cm, nchains=NCHAINS, device=cm.device, seed=seed,
                          warmup_sweeps=WARMUP, progress=False, watchdog=wd)
    x0 = g.initial_sample(torch.Generator(device=cm.device).manual_seed(
        seed))
    walls = []
    reps = []
    started = time.time()
    for _ in range(2):
        t0 = time.perf_counter()
        chain, rep = run_supervised(g, x0, out, niter, save_every=1,
                                    sleep=delays.append)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        reps.append(rep)
        preemption.reset()       # the next incarnation
    faults.clear()
    runs = kernels.device_launches()
    counters = telemetry.snapshot()
    with open(out / "metrics.jsonl") as fh:
        events = [json.loads(ln) for ln in fh]
    kinds = [(e["event"], e.get("row", e.get("rows")))
             for e in events if "event" in e]
    # attempt boundaries on the wall clock: each failure ends an attempt
    ends = [e["ts"] for e in events if e.get("event") in (
        "supervised_failure", "supervised_preempted")]
    want_counters = {"corrupt_checkpoints": 1, "preempt_drains": 1,
                     "preempt_requests": 1, "retries": 2, "rollbacks": 1,
                     "sentinel_trips": 1, "stall_retries": 1,
                     "watchdog_dumps": 1, "watchdog_soft": 1,
                     "watchdog_stalls": 1}
    got = [(r.status, r.attempts, r.retries, r.stall_retries, r.refolds,
            r.degradations, [f["kind"] for f in r.failures]) for r in reps]
    want = [("preempted", 4, 2, 1, 0, 0, ["device", "stall", "divergence"]),
            ("completed", 1, 0, 0, 0, 0, [])]
    bak = integrity.read_manifest(out, integrity.MANIFEST_BAK)
    verified = (integrity.verify(out)["ok"]
                and integrity.verify(out)["rows"] == niter
                and integrity.verify(out, bak, suffix=".bak")["ok"])
    same = {"chain": bool(np.array_equal(chain, ref[0])),
            "bchain": bool(np.array_equal(g.bchain, ref[1]))}
    forms = [("chol_solve_sample", "f32"), ("gram_accumulate", "f32"),
             ("gram_accumulate", "f32_dot_f64_reduce")]
    rose = {f"{k}[{f}]": runs[(k, f)] for k, f in forms}
    # the attempt the abandoned worker woke in (1-based; the stall ends 2)
    woke_in = (1 + sum(t < woke[0] for t in ends)) if woke else None
    print(f"phase 17 supervised run, {NCHAINS} chains x {niter} rows, "
          f"checkpoints every chunk, watchdog k {SUP_WD_K} floor "
          f"{SUP_WD_FLOOR_S} s (deadline {wd.deadline(SAVE_EVERY):.2f} s at "
          f"the end), stall {stall_s:.2f} s: incarnations "
          + json.dumps([round(w, 3) for w in walls]) + " s, recovery cost "
          f"{sum(walls) - ref_wall:.3f} s over phase 4's {ref_wall:.3f} s; "
          "reports " + json.dumps(got) + "; backoff delays "
          + json.dumps([round(d, 4) for d in delays]), flush=True)
    print("phase 17 telemetry " + json.dumps(counters) + "; events "
          + json.dumps(kinds), flush=True)
    print(f"phase 17 watchdog EMA {wd.ema:.5f} s per sweep of the host's "
          "guarded wait (the chunk's queueing takes the rest of its wall), "
          "chunk wait EMA "
          f"{telemetry.get_gauge('chunk_wait_ema_ms', float('nan')):.1f} ms "
          f"against {chunk_s * 1e3:.1f} ms of sampling per chunk",
          flush=True)
    print(f"phase 17 the abandoned worker ended its seam in attempt "
          f"{woke_in} (the stall ended attempt 2), "
          f"{woke[0] - ends[1] if woke else float('nan'):.1f} s after the "
          "stall; the first incarnation's attempts took " + json.dumps(
              [round(b - a, 3) for a, b in zip([started] + ends, ends)])
          + " s (ended by the device error, the stall, the divergence, the "
          "drain); chunk_health last "
          + json.dumps(g.driver.health_last) + f"; phase 4's sweeps/s with "
          f"the sentinels on {sps:.3f}", flush=True)
    print(f"phase 17 bitwise equal to phase 4 {json.dumps(same)}; final "
          f"checkpoint and .bak verified {verified}; kernel runs counted on "
          "the card " + json.dumps(rose), flush=True)
    ok = (all(same.values()) and verified and got == want
          and counters == want_counters and woke_in in (3, 4)
          and all(n > 0 for n in rose.values()))
    if not ok:
        print(f"chip_smoke: phase 17 failed (bitwise={same}, verified="
              f"{verified}, reports={got}, counters={counters}, worker "
              f"woke in attempt {woke_in}, runs={rose})", file=sys.stderr)
    del g
    torch.cuda.empty_cache()
    return ok, runs


def record_precision_pair(cm, seed, outdir):
    """Phase 17b: phase 4's model at 64 chains, ``REC_WARMUP`` +
    ``REC_STEADY`` sweeps, with float32 and bfloat16 records; returns the
    gates."""
    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt

    niter = REC_WARMUP + 1 + REC_STEADY
    res = {}
    for rp in ("f32", "bf16"):
        g = ptt.PTABlockGibbs(cm, nchains=NCHAINS, device=cm.device,
                              seed=seed, warmup_sweeps=REC_WARMUP,
                              white_adapt_iters=CHECK_ADAPT,
                              record_precision=rp, progress=False)
        x0 = g.initial_sample(torch.Generator(device=cm.device).manual_seed(
            seed))
        g.sample(x0, outdir=Path(outdir) / rp, niter=niter)
        res[rp] = (g.chain, g.bchain, g.driver.x_cur.copy(),
                   g.driver.b.clone())
        del g
    (c32, b32, x32, bb32), (c16, b16, x16, bb16) = res["f32"], res["bf16"]
    carries = bool(np.array_equal(x32, x16) and torch.equal(bb32, bb16))
    close = {}
    for nm, a32, a16 in (("chain", c32, c16), ("bchain", b32, b16)):
        ref = torch.as_tensor(a32, dtype=torch.float32).to(
            torch.bfloat16).double().numpy()
        close[nm] = float(np.isclose(a16, ref, rtol=2.0 ** -7,
                                     atol=1e-30).mean())
    rows = [r for r in range(niter) if r != REC_WARMUP]
    f32_rows = bool(np.array_equal(b32[rows], b32[rows].astype(np.float32)))
    ok = carries and min(close.values()) > 0.9999 and f32_rows
    print(f"phase 17b record precision, {NCHAINS} chains, {REC_WARMUP} + "
          f"{REC_STEADY} sweeps: final carries bitwise equal {carries}; "
          "bf16 rows within 1 ulp of the bf16 rounding of the f32 rows "
          + json.dumps(close) + f"; every f32 b row a float32 value "
          f"{f32_rows} {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def chain_medians(chain, cm, chains, burn=ENS_BURN):
    """Per common rho bin, the mean over ``chains`` of each chain's median
    over the steady rows past the first ``burn``, and its standard
    error (the chains' spread over sqrt(chains)): the statistic of
    ``tests/test_torch_sampler.py``."""
    import numpy as np

    rows = chain[WARMUP + 1 + burn:][:, list(chains)]
    med = np.median(rows[:, :, cm.rho_ix_x.cpu().numpy()], axis=0)
    return med.mean(0), med.std(0, ddof=1) / np.sqrt(med.shape[0])


def sketch_report(phase, g, chain, cold, sps):
    """Phases 4 and 18: the device sketch finalized (``obs_summary``)
    beside the host's Sokal ACT of the phase's own records.  Prints the
    common rho ACT of the cold chains (median over them and the rho
    channels, in sweeps), their rho ESS, ESS/s (cold chains x sweeps/s /
    ACT), ``rhat_max`` and ``window_saturated``; the host ACT of the same
    chains and rows (the float32 record, ``ops.acf``) and device / host.
    Returns the gate: the sketch folded every steady sweep and its ACT is
    finite and at least 1."""
    import numpy as np

    from pulsar_timing_gibbsspec_torch.obs.sketch import state_bytes
    from pulsar_timing_gibbsspec_torch.ops.acf import integrated_act_columns

    drv, cm = g.driver, g.cm
    cold = list(cold)
    t0 = time.perf_counter()
    s = g.obs_summary()
    fin_ms = 1e3 * (time.perf_counter() - t0)
    nrho = sum(1 for nm in drv.obs.names if "rho" in nm and "gw" in nm)
    act = float(np.median(s["act"][cold][:, :nrho]))
    n = s["n"]
    rows = chain[WARMUP + 1:][:, cold][:, :, cm.rho_ix_x.cpu().numpy()]
    host = float(np.median(integrated_act_columns(
        rows.reshape(rows.shape[0], -1))))
    ess = len(cold) * n / act
    print(f"phase {phase} device sketch ({drv.obs.D} channels, lags "
          f"{drv.obs.lags}, {state_bytes(drv.obs, drv.C) / 1e6:.2f} MB, "
          f"finalized in {fin_ms:.1f} ms): {n:.0f} sweeps folded; common rho "
          f"ACT of the {len(cold)} cold chains {act:.3f} sweeps (all chains "
          f"{s['act_rho_med']:.3f}), rho ESS {ess:.1f} per bin, ESS/s "
          f"{len(cold) * sps / act:.3f} per bin ({len(cold)} chains x "
          f"{sps:.3f} sweeps/s / ACT); rhat_max {s['rhat_max']}; "
          f"window_saturated {s['window_saturated']}; host Sokal ACT of "
          f"the phase's records (same chains, rows and bins) {host:.3f}, "
          f"device / host {act / host:.4f}", flush=True)
    return bool(n == drv.steady_sweeps and np.isfinite(act) and act >= 1.0)


def ensemble_paths(cm, seed, outdir, steady, gen, ref_stats, forms):
    """Phases 18-18c: ``bench.py``'s ``ensemble=True, pt_ladder=2`` on
    phase 4's model and seed, 64 chains (32 cold), the sketch on, through
    ``WARMUP`` warmup and ``steady`` steady sweeps from the graphs,
    checkpointed every ``SAVE_EVERY``, launch counts from 0; its gates
    (module docstring) against phase 4's per-bin statistic ``ref_stats``
    (:func:`chain_medians`); phase 2's row at a hot chain's state; 18b;
    18c.  Returns ``(records, runs)`` (the phase 2 row's records and the
    kernels' device counts of the run), or None when a phase failed."""
    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    C, T = NCHAINS, PT_LADDER
    niter = WARMUP + 1 + steady
    kernels.reset_launches()
    t0 = time.perf_counter()
    g = ptt.PTABlockGibbs(cm, nchains=C, device=cm.device, seed=seed,
                          warmup_sweeps=WARMUP, progress=False, obs=OBS,
                          ensemble=True, pt_ladder=T)
    x0 = g.initial_sample(torch.Generator(device=cm.device).manual_seed(
        seed))
    chain = g.sample(x0, outdir=Path(outdir) / "ensemble", niter=niter,
                     save_every=SAVE_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drv, graphs = g.driver, g.driver.carry
    counts = launch_counts(graphs)
    missing, unreplayed, unaccounted = count_faults(counts, forms, GRAPHED)
    sps = drv.steady_sweeps / drv.steady_seconds
    cold = range(0, C, T)
    rho = chain[WARMUP + 1:][:, list(cold)][:, :, cm.rho_ix_x.cpu().numpy()]
    med = np.median(rho.reshape(-1, rho.shape[-1]), axis=0)
    es = g.ensemble_summary()
    (m18, s18), (m4, s4) = chain_medians(chain, cm, cold), ref_stats
    zs = np.abs(m18 - m4) / np.sqrt(s18 ** 2 + s4 ** 2)
    rep = integrity.verify(Path(outdir) / "ensemble")
    print(f"phase 18 ensemble array (pt_ladder {T}, {C} chains, "
          f"{len(cold)} cold): {niter} rows in {wall:.1f} s (warmup "
          f"{WARMUP}); steady {drv.steady_sweeps} sweeps in "
          f"{drv.steady_seconds:.3f} s = {sps:.3f} sweeps/s = "
          f"{sps * len(cold):.1f} samples/s of the cold chains "
          f"({sps * C:.1f} of all); CUDA graphs {len(graphs.graphs)} "
          f"captured in {graphs.capture_seconds:.3f} s, pool "
          f"{graphs.pool_bytes / 1e6:.1f} MB", flush=True)
    print("phase 18 per-block ms per steady sweep (CUDA events): "
          + json.dumps({k: round(v / drv.steady_sweeps, 4)
                        for k, v in sorted(drv.timer.ms.items())}),
          flush=True)
    print("phase 18 ensemble summary " + json.dumps(es), flush=True)
    print("phase 18 cold chains' common log10_rho medians per bin: "
          + json.dumps([round(float(v), 3) for v in med]) + "; past the "
          f"first {ENS_BURN} steady rows, mean of per-chain medians "
          + json.dumps([round(float(v), 3) for v in m18]) + " against "
          "phase 4's " + json.dumps([round(float(v), 3) for v in m4])
          + ", in combined standard errors "
          + json.dumps([round(float(v), 2) for v in zs]), flush=True)
    print_counts(18, counts)
    sketch_ok = sketch_report("18", g, chain, cold, sps)
    finite = bool(np.isfinite(chain).all() and np.isfinite(g.bchain).all())
    inside = bool(((med > -10.0) & (med < -4.0)).all())
    law = bool((zs <= 5.0).all())
    ladder = (es["betas"][0] == 1.0 and 0.0 < es["betas"][1] < 1.0
              and all(0.0 < r < 1.0 for r in es["swap_rate"])
              and all(a > 0.0 for a in es["stretch_accept"])
              and es["sa_steps"] == drv.steady_sweeps)
    saved = rep["ok"] and rep["rows"] == niter and graphs.graphed
    ok = (finite and inside and law and ladder and saved and sketch_ok
          and not missing and not unreplayed and not unaccounted)
    if not ok:
        print(f"chip_smoke: ensemble path failed (finite={finite}, medians "
              f"inside the prior={inside}, rho law as phase 4's={law}, "
              f"ladder and rates={ladder}, verified checkpoint through the "
              f"graphs={saved}, sketch={sketch_ok}, never run={missing}, "
              f"not replayed as captured={unreplayed}, runs other than "
              f"eager launches plus replays={unaccounted})", file=sys.stderr)
        return None
    if not graphs_vs_eager(drv, torch.as_tensor(drv.x_cur, device=cm.device),
                           drv.b.to(cm.device), ENS_GRAPH_CHECK_AT, "18b",
                           "PTABlockGibbs, ensemble with pt_ladder 2 and "
                           "the sketch, across the refresh at 272"):
        print("chip_smoke: the ensemble graph replay differs from the "
              "eager sweep", file=sys.stderr)
        return None
    # phase 2 at a hot chain's state: the final carry's systems at N /
    # betas[1] (the tempered b_mh's Gram and factor)
    beta1 = es["betas"][1]
    xs = torch.as_tensor(drv.x_cur, device=cm.device)
    print(f"phase 2 at phase 18's final state, every chain at the hot "
          f"rung's beta = {beta1:.6f}:", flush=True)
    records, ok_g = gram_parity(cm, xs, time_ms, beta=beta1)
    rec_c, ok_c = chol_parity(cm, xs, gen, time_ms, beta=beta1)
    records.update(rec_c)
    runs = counts[0]
    del g, drv, graphs, chain, xs
    torch.cuda.empty_cache()
    if not (ok_g and ok_c):
        print("chip_smoke: kernel parity at phase 18's tempered state "
              "failed", file=sys.stderr)
        return None
    opts = dict(ensemble=True, pt_ladder=T, obs=OBS)
    res = Path(outdir) / "ensemble_resume"
    if not resume_check(cm, seed, res, "PTABlockGibbs", "18c", **opts):
        print("chip_smoke: the resumed ensemble run differs from the whole "
              "one", file=sys.stderr)
        return None
    g1 = ptt.PTABlockGibbs(cm, nchains=RESUME_CHAINS, device=cm.device,
                           seed=seed, progress=False, ensemble=True,
                           pt_ladder=1)
    try:
        g1.sample(np.zeros(cm.nx), outdir=res / "whole",
                  niter=RESUME_WARMUP + 1 + RESUME_STEADY, resume=True)
        refused = "nothing"
    except RuntimeError as exc:
        refused = str(exc)
    good = "pt_ladder=2" in refused
    print(f"phase 18c a resume of the pt_ladder {T} checkpoint with "
          f"pt_ladder 1 raises: {refused!r} {'ok' if good else 'FAIL'}",
          flush=True)
    if not good:
        return None
    return records, runs


def collapse_path(cm, seed, outdir, steady, gen, ref_stats, forms, timed):
    """Phases 19-19b: phase 4's model, seed and 64 chains with the
    partially collapsed rho draw (``PTGIBBS_RHO_COLLAPSE=1`` while the
    driver is built), ``WARMUP`` warmup and ``steady`` steady sweeps from
    the graphs, checkpointed every ``SAVE_EVERY``, launch counts from 0;
    its gates (module docstring) against phase 4's per-bin statistic
    ``ref_stats``; phase 2's row at its final state; 19b.  Returns
    ``(records, runs)`` or None when a phase failed."""
    import os

    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import integrity
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    C, niter = NCHAINS, WARMUP + 1 + steady
    kernels.reset_launches()
    t0 = time.perf_counter()
    os.environ["PTGIBBS_RHO_COLLAPSE"] = "1"
    try:
        g = ptt.PTABlockGibbs(cm, nchains=C, device=cm.device, seed=seed,
                              warmup_sweeps=WARMUP, progress=False)
    finally:
        del os.environ["PTGIBBS_RHO_COLLAPSE"]
    x0 = g.initial_sample(torch.Generator(device=cm.device).manual_seed(
        seed))
    chain = g.sample(x0, outdir=Path(outdir) / "collapsed", niter=niter,
                     save_every=SAVE_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drv, graphs = g.driver, g.driver.carry
    counts = launch_counts(graphs)
    missing, unreplayed, unaccounted = count_faults(counts, forms, GRAPHED)
    sps = drv.steady_sweeps / drv.steady_seconds
    order = drv.sweep_blocks(False)
    before = ("rho" in order and "red" in order
              and order.index("rho") < order.index("red"))
    per_block = {k: round(v / drv.steady_sweeps, 4)
                 for k, v in sorted(drv.timer.ms.items())}
    # every common and red log10_rho record inside its prior (the float32
    # grid's ends round within 1e-5 of the bounds)
    inside = True
    for ix, lo, hi in ((cm.rho_ix_x.cpu().numpy(), cm.rhomin, cm.rhomax),
                       (cm.idx.red_rho, cm.red_rhomin, cm.red_rhomax)):
        v = chain[:, :, ix]
        inside &= bool(((v >= 0.5 * math.log10(lo) - 1e-5)
                        & (v <= 0.5 * math.log10(hi) + 1e-5)).all())
    (m19, s19), (m4, s4) = (chain_medians(chain, cm, range(C),
                                          COLLAPSE_BURN), ref_stats)
    zs = np.abs(m19 - m4) / np.sqrt(s19 ** 2 + s4 ** 2)
    rep = integrity.verify(Path(outdir) / "collapsed")
    # the collapsed draw alone at the final state: its time against the
    # conditional draw's, and the memory its transient takes
    xs = torch.as_tensor(drv.x_cur, device=cm.device)
    bs = drv.b.to(cm.device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    blocks.rho_update(cm, xs, bs, drv.gen, collapse=True)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    rho_c = cuda_ms(lambda: blocks.rho_update(cm, xs, bs, drv.gen,
                                              collapse=True), reps=10)
    rho_p = cuda_ms(lambda: blocks.rho_update(cm, xs, bs, drv.gen),
                    reps=10)
    step = max(1, min(1000, blocks.RHO_COLLAPSE_CHUNK_BYTES
                      // (C * cm.P * blocks.RHO_COLLAPSE_J * 4)))
    print(f"phase 19 collapsed rho draw on the array ({C} chains, J "
          f"{blocks.RHO_COLLAPSE_J} red quadrature points, grid chunks of "
          f"{step} points): predicate {drv.rho_collapse}; {niter} rows in "
          f"{wall:.1f} s (warmup {WARMUP}); steady {drv.steady_sweeps} "
          f"sweeps in {drv.steady_seconds:.3f} s = {sps:.3f} sweeps/s = "
          f"{sps * C:.1f} samples/s; sweep order " + json.dumps(order)
          + f"; CUDA graphs {len(graphs.graphs)} captured in "
          f"{graphs.capture_seconds:.3f} s, pool "
          f"{graphs.pool_bytes / 1e6:.1f} MB", flush=True)
    print("phase 19 per-block ms per steady sweep (CUDA events): "
          + json.dumps(per_block) + f"; rho {per_block.get('rho')} ms, red "
          f"{per_block.get('red')} ms", flush=True)
    print(f"phase 19 the draw alone at the final state (CUDA events, "
          f"median of 10, eager): collapsed {rho_c:.4f} ms, the "
          f"conditional draw {rho_p:.4f} ms; the collapsed draw's peak "
          f"memory above the state {peak:.1f} MB, its largest "
          f"intermediate {C * cm.P * step * blocks.RHO_COLLAPSE_J * 4 / 1e6:.1f}"
          " MB", flush=True)
    print(f"phase 19 common log10_rho past the first {COLLAPSE_BURN} steady "
          "rows, mean of per-chain medians " + json.dumps(
              [round(float(v), 3) for v in m19]) + " against phase 4's "
          + json.dumps([round(float(v), 3) for v in m4]) + ", in combined "
          "standard errors " + json.dumps([round(float(v), 2) for v in zs]),
          flush=True)
    print_counts(19, counts)
    finite = bool(np.isfinite(chain).all() and np.isfinite(g.bchain).all())
    law = bool((zs <= 5.0).all())
    saved = rep["ok"] and rep["rows"] == niter and graphs.graphed
    ok = (drv.rho_collapse and before and finite and inside and law
          and saved and not missing and not unreplayed and not unaccounted)
    if not ok:
        print(f"chip_smoke: collapsed rho path failed (predicate="
              f"{drv.rho_collapse}, rho before red={before}, finite="
              f"{finite}, inside the priors={inside}, rho law as phase "
              f"4's={law}, verified checkpoint through the graphs={saved}, "
              f"never run={missing}, not replayed as captured={unreplayed}, "
              f"runs other than eager launches plus replays={unaccounted})",
              file=sys.stderr)
        return None
    if not graphs_vs_eager(drv, xs, bs, COLLAPSE_GRAPH_CHECK_AT, "19b",
                           "PTABlockGibbs, the collapsed rho draw, across "
                           "the refresh at 112"):
        print("chip_smoke: the collapsed-rho graph replay differs from the "
              "eager sweep", file=sys.stderr)
        return None
    print("phase 2 at phase 19's final state (phase 4's shapes: timed in "
          "those rows):", flush=True)
    records, ok_g = gram_parity(cm, xs, None)
    rec_c, ok_c = chol_parity(cm, xs, gen, None)
    records.update(rec_c)
    for key, rec in records.items():
        rec.update({m: v for m, v in timed[key].items()
                    if m != "max_abs_err"})
    runs = counts[0]
    del g, drv, graphs, chain, xs, bs
    torch.cuda.empty_cache()
    if not (ok_g and ok_c):
        print("chip_smoke: kernel parity at phase 19's state failed",
              file=sys.stderr)
        return None
    return records, runs


def oracle_card_path(cm, seed, outdir, forms, gen):
    """Phase 20a: the card's side of phase 20, README's Quick start at
    ``ORACLE_CARD_CHAINS`` chains through ``ORACLE_CARD_WARMUP`` warmup
    sweeps,
    adaptation and ``ORACLE_CARD_STEADY`` steady sweeps from the graphs,
    launch counts from 0, and phase 2 (held and timed) at its final
    state; then (20b) the ECORR block alone at each chain's final b
    (:func:`ecorr_conditional`).  Returns ``(ok, chain, rows)``: the
    kernels line's rows of its forms."""
    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    C, W = ORACLE_CARD_CHAINS, ORACLE_CARD_WARMUP
    niter = W + 1 + ORACLE_CARD_STEADY
    kernels.reset_launches()
    t0 = time.perf_counter()
    g = ptt.PulsarBlockGibbs(cm, nchains=C, device=cm.device, seed=seed,
                             warmup_sweeps=W, progress=False)
    x0 = g.initial_sample(torch.Generator(device=cm.device).manual_seed(
        seed))
    chain = g.sample(x0, outdir=outdir, niter=niter, save_every=SAVE_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drv = g.driver
    counts = launch_counts(drv.carry)
    missing, unreplayed, unaccounted = count_faults(counts, forms,
                                                    WIDE_GRAPHED)
    sps = drv.steady_sweeps / drv.steady_seconds
    rep = integrity.verify(outdir)
    print(f"phase 20a the card's Quick-start chains for phase 20: {niter} "
          f"rows x {C} chains in {wall:.1f} s (warmup {W}, its blocks' ms "
          "in all (CUDA events, eager) " + json.dumps(
              {k: round(v, 1) for k, v in sorted(drv.warmup_ms.items())})
          + "); "
          f"white sub-chain {drv.aclength_white} steps, ECORR sub-chain "
          f"{drv.aclength_ecorr} steps; steady {drv.steady_sweeps} sweeps "
          f"in {drv.steady_seconds:.3f} s = {sps:.3f} sweeps/s = "
          f"{sps * C:.1f} samples/s; per-block ms per steady sweep (CUDA "
          "events) " + json.dumps({k: round(v / drv.steady_sweeps, 4)
                                   for k, v in sorted(drv.timer.ms.items())}),
          flush=True)
    print_counts("20a", counts)
    ok = bool(np.isfinite(chain).all() and not missing and not unreplayed
              and not unaccounted and rep["ok"] and rep["rows"] == niter)
    print(f"phase 2 at phase 20a's shapes ({C} systems), its final state:",
          flush=True)
    x_end = torch.as_tensor(drv.x_cur, device=cm.device)
    recs, good = gram_parity(cm, x_end, time_ms)
    ok &= good
    rec, good = chol_parity(cm, x_end, gen, time_ms)
    recs.update(rec)
    ok &= good
    rows = [dict(name=f"{k}[{f}] (phase 20a path: the Quick start at {C} "
                 f"chains, order {cm.Bmax})", route="cuda",
                 source=SOURCES[k][1], replaces=REPLACES[k],
                 launches=counts[0][(k, f)], **r)
            for (k, f), r in recs.items()]
    ok_e = ecorr_conditional(drv, cm)
    del g, drv
    torch.cuda.empty_cache()
    if not ok:
        print(f"chip_smoke: phase 20a failed (never run={missing}, not "
              f"replayed as captured={unreplayed}, runs other than eager "
              f"launches plus replays={unaccounted}, verified "
              f"checkpoint={rep['ok']}; the kernel parity above)",
              file=sys.stderr)
    return ok and ok_e, chain, rows


def ecorr_conditional(drv, cm):
    """Phase 20b: the card's ECORR block against its exact conditional.
    Each chain's b held at its final state, the block runs
    ``ECORR_CHECK_CALLS`` times from the chain's x; given b, backend k's
    ``log10_ecorr`` has the density ``exp(-n_k ln10 e - S_k 10^(-2e) /
    2)`` on its prior, ``n_k`` its ECORR columns and ``S_k`` the sum of
    their squared coefficients (the columns and prior from the oracle's
    float64 host view).  Each draw's probability integral transform under
    that law is uniform: per hyper, past ``ECORR_CHECK_BURN`` calls, its
    mean within 5 standard errors of 1/2 and its variance within 5 of
    1/12, the errors from the multi-chain ESS.  Returns the gate."""
    import numpy as np
    import torch

    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_torch.sampler.host_model import host_view

    hv = host_view(cm)
    ec = hv.model(0).ecorr
    hyp = sorted(set(int(h) for h in ec.rho_ix))
    x = torch.as_tensor(drv.x_cur, device=cm.device)
    b = drv.b.to(cm.device)
    u = blocks.b_matvec(cm, b)
    t0 = time.perf_counter()
    draws = []
    for _ in range(ECORR_CHECK_CALLS):
        x, b, u = drv.block("ecorr", x, b, u)
        draws.append(x[:, hyp])
    e = torch.stack(draws).cpu().numpy()[ECORR_CHECK_BURN:].astype(np.float64)
    wall = time.perf_counter() - t0
    bc = b.reshape(b.shape[0], -1)[:, ec.cols].cpu().numpy().astype(
        np.float64)
    pit = np.empty_like(e)
    for i, h in enumerate(hyp):
        cols = ec.rho_ix == h
        n, S = int(cols.sum()), (bc[:, cols] ** 2).sum(-1)
        par = hv.params[h]
        grid = np.linspace(par.a, par.b, ECORR_CHECK_GRID)
        lp = (-n * np.log(10.0) * grid[None]
              - 0.5 * S[:, None] * 10.0 ** (-2.0 * grid[None]))
        dens = np.exp(lp - lp.max(-1, keepdims=True))
        cdf = np.concatenate([np.zeros((len(S), 1)), np.cumsum(
            0.5 * (dens[:, 1:] + dens[:, :-1]), -1)], -1)
        cdf /= cdf[:, -1:]
        for c in range(len(S)):
            pit[:, c, i] = np.interp(e[:, c, i], grid, cdf[c])
    ess = _multichain_ess(pit)
    mean, var = pit.mean((0, 1)), pit.var((0, 1))
    z_m = np.abs(mean - 0.5) / np.sqrt(1 / 12 / ess)
    z_v = np.abs(var - 1 / 12) / np.sqrt((1 / 80 - 1 / 144) / ess)
    names = [cm.param_names[h] for h in hyp]
    print(f"phase 20b the card's ECORR block alone at each chain's final b, "
          f"{ECORR_CHECK_CALLS} calls x {e.shape[1]} chains in {wall:.3f} s, "
          f"past {ECORR_CHECK_BURN}: its draws' transform under the exact "
          "conditional law, per hyper [mean, variance, ESS, z of the mean, "
          "z of the variance] " + json.dumps(
              {nm: [round(float(mean[i]), 4), round(float(var[i]), 5),
                    round(float(ess[i]), 1), round(float(z_m[i]), 2),
                    round(float(z_v[i]), 2)] for i, nm in enumerate(names)})
          + " (uniform: 0.5, 0.08333)", flush=True)
    ok = bool((z_m <= 5.0).all() and (z_v <= 5.0).all())
    if not ok:
        print("chip_smoke: the card's ECORR block differs from its exact "
              "conditional", file=sys.stderr)
    return ok


def oracle_child(outdir, seed):
    """Phase 20's child process (``--oracle-child DIR``): README's
    Quick-start model of the snapshot on the port's NumPy oracle
    (``backend="numpy"``, one chain, float64 on the host, one BLAS and
    one torch thread, at the lowest priority), the adaptation sweep and
    then ``ORACLE_SWEEPS``
    sweeps, checkpointed under ``DIR``; its timings and the host CPU's
    model name go to ``DIR/oracle.json``.  Returns the exit code."""
    import os

    import torch

    # the lowest priority and one thread: the card phases' host work runs
    # beside it
    os.nice(19)
    torch.set_num_threads(1)
    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import load_enterprise_snapshot

    out = Path(outdir)
    cm = ptt.model_general([load_enterprise_snapshot(SNAPSHOT)],
                           red_var=False, white_vary=True,
                           common_psd="spectrum",
                           common_components=SINGLE_BINS, device="cpu")
    g = ptt.PulsarBlockGibbs(cm, backend="numpy", seed=seed, progress=False)
    x0 = g.initial_sample(torch.Generator().manual_seed(seed))[0]
    t0 = time.perf_counter()
    g.sample(x0, outdir=out / "chains", niter=1, save_every=SAVE_EVERY)
    t1 = time.perf_counter()
    g = ptt.PulsarBlockGibbs(cm, backend="numpy", seed=seed, progress=False)
    g.sample(x0, outdir=out / "chains", niter=1 + ORACLE_SWEEPS,
             save_every=SAVE_EVERY, resume=True)
    t2 = time.perf_counter()
    import platform

    cpu = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            cpu = next((ln.split(":", 1)[1].strip() for ln in fh
                        if ln.split(":")[0].strip() in (
                            "model name", "Model", "cpu model")), cpu)
    except OSError:
        pass
    (out / "oracle.json").write_text(json.dumps({
        "first_sweep_s": t1 - t0, "sweeps": ORACLE_SWEEPS,
        "steady_s": t2 - t1, "sweeps_per_s": ORACLE_SWEEPS / (t2 - t1),
        "cpu": cpu, "aclength_white": g.driver.aclength_white,
        "aclength_ecorr": g.driver.aclength_ecorr}))
    return 0


def start_oracle(outdir, seed):
    """Start :func:`oracle_child` in a process of its own that sees no
    card and runs on one BLAS thread; returns ``(process, log file)``."""
    import os
    import shutil

    out = Path(outdir)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    log = open(out / "child.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--oracle-child",
         str(out), "--seed", str(seed)], env=env, stdout=log,
        stderr=subprocess.STDOUT)
    print(f"phase 20 the oracle started in process {proc.pid} (one BLAS "
          f"thread, no card): {ORACLE_SWEEPS} sweeps after its adaptation",
          flush=True)
    return proc, log


def _multichain_ess(x):
    """ESS per column of ``x`` (n, C, d): the rows over the Sokal ACT
    (``ops/acf.py``'s window) of the multi-chain autocorrelation ``rho_t
    = 1 - (W - mean_c acov_c(t)) / var+`` (W the mean within-chain
    variance, ``var+ = (n-1)/n W + B/n``), which counts chains that
    disagree, or have not resolved their ACT, as long correlations."""
    import numpy as np

    from pulsar_timing_gibbsspec_torch.ops.acf import act_from_rho

    n, C, _ = x.shape
    mean = x.mean(0)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x - mean, nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=0)[:n].real / n
    W = acov[0].mean(0) * n / (n - 1)
    var_plus = (n - 1) / n * W + mean.var(0, ddof=1)
    rho = 1.0 - (W - acov.mean(1)) / np.maximum(var_plus, 1e-300)
    return C * n / act_from_rho(rho.T)


def _posterior_z(card, oracle):
    """Per column, ``|median difference|`` over the combined standard
    error of the two medians, and each side's ESS.  ``card`` (n, C, d)
    holds the card's chains, ``oracle`` (m, d) the oracle's; a median's
    standard error is the interquartile range over sqrt(ESS) (exact for
    a flat posterior, 7.6% above the normal's); the ESS is the rows over
    the Sokal ACT of ``ops/acf.py``: of the card's chains together
    (:func:`_multichain_ess`), of the oracle's one chain."""
    import numpy as np

    from pulsar_timing_gibbsspec_torch.ops.acf import integrated_act_columns

    ess_c = _multichain_ess(card)
    ess_o = len(oracle) / integrated_act_columns(oracle)
    flat = card.reshape(-1, card.shape[-1])

    def se(x, ess):
        q75, q25 = np.percentile(x, [75, 25], axis=0)
        return (q75 - q25) / np.sqrt(ess)

    diff = np.median(flat, axis=0) - np.median(oracle, axis=0)
    comb = np.sqrt(se(flat, ess_c) ** 2 + se(oracle, ess_o) ** 2)
    z = np.abs(diff) / np.maximum(comb, 1e-12)
    return z, diff, ess_c, ess_o


def oracle_compare(proc, log, outdir, chain20, cm, sps4):
    """Phase 20: wait for the oracle (failing past ``ORACLE_DEADLINE_S``
    of the run's clock), then hold phase 20a's card chains (past
    ``ORACLE_CARD_BURN`` steady rows) against the oracle's chain (past
    ``ORACLE_BURN`` rows after its adaptation sweep): every common
    log10_rho bin and every white-noise hyper within 5 combined standard
    errors, each white-noise hyper with an ESS of at least
    ``ORACLE_MIN_ESS`` on both sides; the ECORR hypers' z printed, and
    gated where both sides' ESS reach ``ORACLE_MIN_ESS`` (phase 20b holds
    the card's ECORR block against its exact conditional).  Returns the
    gate."""
    import numpy as np

    left = ORACLE_DEADLINE_S - (time.perf_counter() - _RUN_START)
    try:
        rc = proc.wait(timeout=max(1.0, left))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    log.close()
    out = Path(outdir)
    if rc != 0:
        tail = (out / "child.log").read_text()[-2000:]
        print(f"chip_smoke: the oracle child {'ran out of time' if rc is None else f'exited {rc}'}"
              f"; its log ends: {tail}", file=sys.stderr)
        return False
    info = json.loads((out / "oracle.json").read_text())
    oracle = np.load(out / "chains" / "chain.npy")[1 + ORACLE_BURN:]
    card = chain20[ORACLE_CARD_WARMUP + 1 + ORACLE_CARD_BURN:]
    rix = cm.rho_ix_x.cpu().numpy()
    hyp = list(cm.idx.white) + list(cm.idx.ecorr)
    z, diff, ess_c, ess_o = _posterior_z(card[..., list(rix) + hyp],
                                         oracle[:, list(rix) + hyp])
    k, nw = len(rix), len(cm.idx.white)
    gated = (ess_c[k:] >= ORACLE_MIN_ESS) & (ess_o[k:] >= ORACLE_MIN_ESS)
    print(f"phase 20 the oracle (port, backend='numpy', one chain, float64 "
          f"on the host; CPU {info['cpu']}): adaptation sweep "
          f"{info['first_sweep_s']:.3f} s, then {info['sweeps']} sweeps in "
          f"{info['steady_s']:.3f} s = {info['sweeps_per_s']:.3f} sweeps/s; "
          f"white sub-chain {info['aclength_white']} steps, ECORR "
          f"{info['aclength_ecorr']}; done at "
          f"{time.perf_counter() - _RUN_START:.1f} s of the run; phase 4's "
          f"{sps4 * NCHAINS:.1f} samples/s with the oracle beside it "
          "(1687.3-1727.5 in runs N1 and N3 without it)", flush=True)
    print(f"phase 20 common log10_rho, phase 20a's {card.shape[1]} card chains "
          f"x {card.shape[0]} rows (past {ORACLE_CARD_BURN} steady rows) "
          f"against the oracle's {len(oracle)} rows (past {ORACLE_BURN}): "
          "median differences " + json.dumps(
              [round(float(v), 3) for v in diff[:k]]) + ", in combined "
          "standard errors " + json.dumps([round(float(v), 2)
                                          for v in z[:k]])
          + f" (largest {float(z[:k].max()):.2f}); ESS card "
          + json.dumps([round(float(v), 1) for v in ess_c[:k]])
          + ", oracle " + json.dumps([round(float(v), 1)
                                      for v in ess_o[:k]]), flush=True)
    print("phase 20 white-noise and ECORR hypers "
          + json.dumps({cm.param_names[j]: [round(float(z[k + i]), 2),
                                            round(float(ess_c[k + i]), 1),
                                            round(float(ess_o[k + i]), 1),
                                            bool(gated[i])]
                        for i, j in enumerate(hyp)})
          + f" ([z, ESS card, ESS oracle, gated at ESS >= "
          f"{ORACLE_MIN_ESS}])", flush=True)
    ok = bool((z[:k] <= 5.0).all() and (z[k:][gated] <= 5.0).all())
    if not ok:
        print("chip_smoke: the card's Quick-start posterior differs from "
              "the oracle's", file=sys.stderr)
    if not gated[:nw].all():
        print("chip_smoke: too few effective samples to hold the white-noise "
              "hypers against the oracle: " + json.dumps(
                  [cm.param_names[j] for i, j in enumerate(hyp[:nw])
                   if not gated[i]]), file=sys.stderr)
    return ok and bool(gated[:nw].all())


def retry_path(cm, seed, outdir, gen):
    """Phase 21: README's Quick start at one chain on the card, whole, and
    under ``run_supervised`` with the device-class fault injected at the
    ``sample.loop`` seam ``RETRY_AFTER`` times in a row (``degrade_after``,
    where the JAX package moves such a run to its NumPy oracle): the run
    stays on the card.  Gates (module docstring).  Then phase 2 at the
    one-chain shapes, at the run's final state.  Returns ``(records,
    runs)`` or None when a phase failed."""
    import shutil

    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import (faults, integrity,
                                                       preemption,
                                                       run_supervised,
                                                       telemetry)

    out = Path(outdir)
    shutil.rmtree(out, ignore_errors=True)
    niter = RETRY_WARMUP + 1 + RETRY_STEADY
    kw = dict(nchains=1, device=cm.device, seed=seed, progress=False,
              warmup_sweeps=RETRY_WARMUP, chunk_size=RETRY_CHUNK,
              white_adapt_iters=CHECK_ADAPT)
    x0 = ptt.PulsarBlockGibbs(cm, **kw).initial_sample(
        torch.Generator(device=cm.device).manual_seed(seed))[0]
    t0 = time.perf_counter()
    whole = ptt.PulsarBlockGibbs(cm, **kw)
    base = whole.sample(x0, outdir=out / "whole", niter=niter,
                        save_every=RETRY_CHUNK)
    wall0 = time.perf_counter() - t0
    faults.clear()
    telemetry.reset()
    preemption.reset()
    faults.inject("xla_error", point="sample.loop", at_row=RETRY_AT,
                  times=RETRY_AFTER)
    kernels.reset_launches()
    delays = []
    g = ptt.PulsarBlockGibbs(cm, **kw)
    t0 = time.perf_counter()
    chain, rep = run_supervised(g, x0, out / "supervised", niter,
                                save_every=RETRY_CHUNK,
                                degrade_after=RETRY_AFTER,
                                sleep=delays.append)
    wall = time.perf_counter() - t0
    faults.clear()
    runs = kernels.device_launches()
    with open(out / "supervised" / "metrics.jsonl") as fh:
        events = [json.loads(ln) for ln in fh]
    down = sum(e.get("event") == "backend_degraded" for e in events)
    layout = (integrity.read_manifest(out / "supervised") or {}).get(
        "layout") or {}
    verified = integrity.verify(out / "supervised")
    same = {"chain": bool(np.array_equal(chain, base)),
            "bchain": bool(np.array_equal(g.bchain, whole.bchain))}
    wide = [("chol_solve_sample", "f32_wide"), ("gram_accumulate", "f32_wide"),
            ("gram_accumulate", "widen_f64_wide")]
    ran = {f"{k}[{f}]": runs[(k, f)] for k, f in wide}
    print(f"phase 21 repeated device errors on the card: the Quick start at "
          f"one chain, {niter} rows (warmup {RETRY_WARMUP}, chunks of "
          f"{RETRY_CHUNK}); whole on the card {wall0:.3f} s; supervised "
          f"with the device error at sample.loop from row {RETRY_AT}, "
          f"{RETRY_AFTER} times (degrade_after {RETRY_AFTER}): "
          f"{wall:.3f} s, {wall - wall0:.3f} s over the whole run; report "
          + json.dumps(rep.as_dict()) + "; telemetry "
          + json.dumps(telemetry.snapshot()), flush=True)
    print(f"phase 21 the run stayed on the card: backend {rep.backend!r}, "
          f"degradations {rep.degradations}, backend_degraded events "
          f"{down}; bitwise the whole card run's " + json.dumps(same)
          + f"; final checkpoint verified {verified['ok']} at "
          f"{verified['rows']} rows, layout.backend "
          f"{layout.get('backend')!r}; kernel runs counted on the card "
          + json.dumps(ran), flush=True)
    ok = (rep.status == "completed" and rep.degradations == 0
          and rep.backend == "torch" and not telemetry.get("degradations")
          and down == 0
          and [f["kind"] for f in rep.failures] == ["device"] * RETRY_AFTER
          and all(same.values()) and verified["ok"]
          and verified["rows"] == niter and layout.get("backend") == "torch"
          and all(n > 0 for n in ran.values()))
    telemetry.reset()
    if not ok:
        print("chip_smoke: the one-chain run did not recover on the card",
              file=sys.stderr)
        return None
    print("phase 2 at the one-chain shapes (phase 21's final state):",
          flush=True)
    x1 = torch.as_tensor(chain[-1:], device=cm.device)
    records, ok_g = gram_parity(cm, x1, time_ms)
    rec_c, ok_c = chol_parity(cm, x1, gen, time_ms)
    records.update(rec_c)
    del g, whole
    torch.cuda.empty_cache()
    if not (ok_g and ok_c):
        print("chip_smoke: kernel parity at phase 21's shapes failed",
              file=sys.stderr)
        return None
    return records, runs


def _serve_datasets(seed, requests):
    from pulsar_timing_gibbsspec_torch.data import synthetic_array
    from pulsar_timing_gibbsspec_torch.serve import bench_dataset

    return {tag: bench_dataset(synthetic_array(npsr=n, seed=seed + off,
                                               ntoa_max=ntoa),
                               SERVE_MODES, SERVE_MODES)
            for tag, n, off, ntoa in requests}


def serve_path(seed, outdir):
    """Phases 22-22c: the tenant-multiplexed service on the card.

    22: ``BucketTable.ladder(10)``, ``SERVE_SLOTS`` slots, chunks of
    ``SERVE_CHUNK`` sweeps, a quantum of ``SERVE_QUANTUM`` chunks; the
    requests of ``SERVE_REQUESTS`` (two 45-pulsar arrays in the bucket
    (46, 1024, 60, 10), a 30-pulsar array padded into it under another
    signature, an 8-pulsar array in (8, 128, 60, 10)), a fifth 45-pulsar
    array once a job is done; ``SERVE_NITER`` sweeps a job, kernel
    counts from 0.  Gates: every job done, records finite, rho medians
    inside their prior, checkpoints verified, one graph capture per
    (bucket, signature, chunk) and none from the fifth admission on, the
    widening Gram's runs on the card equal to its eager launches plus
    each capture's launches times its replays.  22b: tenant A alone in a
    service of as many slots, bitwise equal to its multiplexed chain (in
    another slot, evicted once, next to others).  22c: the Gram at the
    stack's shape against its plain version, timed.  Returns ``(ok,
    rows, ctx)``: the kernels line's rows, and for phase 23 the bucket
    table, the arrays, 22b's chains and 22c's timing record."""
    import numpy as np
    import torch

    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import integrity
    from pulsar_timing_gibbsspec_torch.serve import (BucketTable,
                                                     ProgramCache,
                                                     SamplerService,
                                                     probe_shape)
    from pulsar_timing_gibbsspec_torch.serve.engine import group_key

    t_phase = time.perf_counter()
    table = BucketTable.ladder(SERVE_MODES)
    data = _serve_datasets(seed, SERVE_REQUESTS + (SERVE_FIFTH,))
    for tag, ds in data.items():
        shape = probe_shape(ds)
        print(f"phase 22 request {tag}: {shape.pulsars} pulsars, <= "
              f"{shape.toas} TOAs, basis <= {shape.basis}, {shape.modes} "
              f"modes -> bucket {table.route(shape).as_tuple()}", flush=True)
    cache = ProgramCache()
    svc = SamplerService(outdir / "mux", table, slots=SERVE_SLOTS,
                         chunk=SERVE_CHUNK, quantum=SERVE_QUANTUM,
                         save_every=SERVE_SAVE_EVERY, cache=cache)
    kernels.reset_launches()
    jobs = {tag: svc.submit(data[tag], SERVE_NITER, job_id=f"job{tag}",
                            tenant_id=ord(tag) - ord("A"))
            for tag, *_ in SERVE_REQUESTS}
    fifth = SERVE_FIFTH[0]
    t0 = time.perf_counter()
    at_fifth = first_admit = None
    while svc.step_supervised():
        if fifth not in jobs and any(j.state == "done"
                                     for j in jobs.values()):
            jobs[fifth] = svc.submit(data[fifth], SERVE_NITER,
                                     job_id=f"job{fifth}",
                                     tenant_id=ord(fifth) - ord("A"))
        if (at_fifth is None and fifth in jobs
                and jobs[fifth].admitted_at is not None):
            at_fifth = svc.captures()
            first_admit = jobs[fifth].admitted_at
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = svc.report()
    caps = svc.captures()
    groups = len({group_key(j.bucket, j.cm) for j in jobs.values()})
    runs = kernels.device_launches()
    host = kernels.launch_counts()
    key = ("gram_accumulate", "widen_f64")
    progs = list(cache._programs.values())
    replayed = sum(p.captured_launches.get(key, 0) * p.replays
                   for p in progs)
    recorded = sum(p.captured_launches.get(key, 0) for p in progs)
    expect = host[key] - recorded + replayed
    rows = sum(j.it for j in jobs.values())
    je = jobs[fifth]
    wait = 1e3 * (first_admit - je.submitted_at)
    warm = 1e3 * (je.first_sample_at - first_admit)
    ok = True
    for tag, j in jobs.items():
        cm = j.cm
        rho = cm.idx.rho
        med = np.median(j.chain[SERVE_BURN:, rho], axis=0)
        lo, hi = 0.5 * np.log10(cm.rhomin), 0.5 * np.log10(cm.rhomax)
        ver = integrity.verify(j.outdir)
        good = (j.state == "done" and bool(np.isfinite(j.chain).all())
                and bool(np.isfinite(j.bchain).all())
                and bool(np.all((med > lo) & (med < hi)))
                and ver["ok"] and ver["rows"] == SERVE_NITER)
        ok &= good
        print(f"phase 22 job {tag} (tenant {j.tenant_id}, bucket "
              f"{j.bucket.as_tuple()}, P_real {cm.P_real}): {j.state}, "
              f"{j.it} rows, first sample after "
              f"{j.time_to_first_sample_ms():.1f} ms, common log10_rho "
              f"medians {np.round(med, 3).tolist()}, checkpoint verified "
              f"{ver['ok']} ({ver['rows']} rows) {'ok' if good else 'FAIL'}",
              flush=True)
    good_caps = caps == groups and at_fifth == caps
    good_runs = runs[key] > 0 and runs[key] == expect
    ok &= good_caps and good_runs
    print(f"phase 22 the service: {len(jobs)} jobs, {rows} rows in "
          f"{wall:.3f} s = {rows / wall:.1f} aggregate samples/s, "
          f"{rep['chunks']} chunks, {rep['evictions']} evictions; the "
          f"fifth request queued {wait:.1f} ms, then its warm start "
          f"(admission onto the captured program to its first chunk's "
          f"rows) {warm:.1f} ms; warm_hit_rate {rep['warm_hit_rate']:.3f}, "
          f"dispatch seconds {svc.dispatch_seconds:.3f}; graph captures "
          f"{caps} for {groups} (bucket, signature) groups at "
          f"chunk {SERVE_CHUNK}, {at_fifth} when the fifth was admitted "
          f"{'ok' if good_caps else 'FAIL'}", flush=True)
    print(f"phase 22 kernel runs counted on the card: {key[0]}[{key[1]}] "
          f"{runs[key]} (host launches {host[key]}, recorded into graphs "
          f"{recorded}, replayed {replayed}) {'ok' if good_runs else 'FAIL'}",
          flush=True)
    launches = runs[key]

    # ---- 22b: the evicted array alone in a service of as many slots ------
    solo = SamplerService(outdir / "solo", table, slots=SERVE_SLOTS,
                          chunk=SERVE_CHUNK, quantum=SERVE_QUANTUM,
                          save_every=SERVE_SAVE_EVERY, cache=cache)
    jb = solo.submit(data["B"], SERVE_NITER, job_id="jobB", tenant_id=1)
    solo.run()
    caps_after = svc.captures()
    same = (jb.state == "done"
            and np.array_equal(jb.chain, jobs["B"].chain)
            and np.array_equal(jb.bchain, jobs["B"].bchain))
    evicted = rep["evictions"] >= 1
    ok &= same and evicted and caps_after == caps
    print(f"phase 22b request B alone in slot 0 of {SERVE_SLOTS} against "
          f"its chain in slot 1 beside A, evicted before its last chunk "
          f"({rep['evictions']} evictions in the run): bitwise {same}, "
          f"captures after {caps_after} "
          f"{'ok' if same and evicted else 'FAIL'}", flush=True)

    # ---- 22c: the Gram at the stack's shape ------------------------------
    prog = cache.program(group_key(jobs["A"].bucket, jobs["A"].cm),
                         SERVE_SLOTS, SERVE_CHUNK)
    recs, good = gram_parity(prog.stack, prog.x, time_ms,
                             forms=("widen_f64",),
                             seg_len=prog.stack.gram_seg_len_exact)
    ok &= good
    ctx = dict(table=table, data=data, recs=recs,
               ref_b=(jb.chain.copy(), jb.bchain.copy()))
    del svc, solo, progs, prog, cache
    torch.cuda.empty_cache()
    print(f"phase 22 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    if not ok:
        print("chip_smoke: phase 22 failed", file=sys.stderr)
    out = [dict(name=f"{k}[{f}] (phase 22 path: the tenant-multiplexed "
                f"service, {SERVE_SLOTS} slots x 46 pulsars, B1 61)",
                route="cuda", source=SOURCES[k][0], replaces=REPLACES[k],
                launches=launches, **r)
           for (k, f), r in recs.items()]
    return ok, out, ctx


def _gpu_events(path):
    """From a Perfetto file: ``{name: count}`` of the kernels and copies
    on the card's streams, the ``serve.*`` obs span names, the card's busy
    share between its first and last event (the union of their
    intervals over that window), and the host ms of each
    ``cudaGraphLaunch``."""
    doc = json.loads(Path(path).read_text())
    dev, spans, iv, launch = {}, set(), [], []
    for ev in doc.get("traceEvents", []):
        name = str(ev.get("name", ""))
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev[name] = dev.get(name, 0) + 1
            t = float(ev["ts"])
            iv.append((t, t + float(ev.get("dur", 0.0))))
        elif name == "cudaGraphLaunch":
            launch.append(float(ev.get("dur", 0.0)) / 1e3)
        elif name.startswith("serve.") and ev.get("ph") == "X":
            spans.add(name)
    busy, end = 0.0, None
    for a, b in sorted(iv):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    share = busy / (end - min(iv)[0]) if iv and end > min(iv)[0] else None
    return dev, spans, share, launch


def guards_path(outdir, ctx):
    """Phase 23: the serving guards (breaker, admission control,
    prewarm) and the perf observatory (``perf=True``, a flight recorder
    armed through a band breach) on phase 22's bucket table and arrays.
    Returns ``(ok, rows)``: the kernels line's row for the path."""
    import numpy as np
    import torch

    from pulsar_timing_gibbsspec_torch.obs import perf
    from pulsar_timing_gibbsspec_torch.obs import trace as otrace
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import (faults, integrity,
                                                       telemetry)
    from pulsar_timing_gibbsspec_torch.runtime.supervisor import CircuitOpen
    from pulsar_timing_gibbsspec_torch.serve import (ProgramCache,
                                                     SamplerService)

    t_phase = time.perf_counter()
    data, now = ctx["data"], [0.0]
    for prefix in ("dispatch_ms", "stage_band_breaches", "anomaly_captures",
                   "circuit_opens", "admission_", "serve_prewarms"):
        telemetry.reset(prefix)
    rec = perf.FlightRecorder(outdir / "flight", window_chunks=GUARD_WINDOW,
                              max_captures=1)
    agg = perf.StageAggregator(job="p23", band_k=GUARD_BAND_K,
                               recorder=rec).install()
    cache = ProgramCache()
    svc = SamplerService(outdir / "svc", ctx["table"], slots=SERVE_SLOTS,
                         chunk=SERVE_CHUNK, quantum=SERVE_NITER,
                         save_every=1, cache=cache, perf=True,
                         breaker=GUARD_BREAKER, admission=GUARD_ADMISSION,
                         prewarm=1, clock=lambda: now[0])
    faults.clear()
    faults.inject("poison_rows", tenant=0, at_row=1, times=1)
    faults.inject("stall", point="chainstore.post_save",
                  at_row=GUARD_STALL_ROW, times=1, seconds=GUARD_STALL_S)
    kernels.reset_launches()
    jobs = {"B": svc.submit(data["B"], SERVE_NITER, job_id="B",
                            tenant_id=1)}
    # two waves under max_queue: B, A, E take three slots at the first
    # step; A again takes the fourth at the second, with D queued behind
    # the full group
    waves = [(("A", "A", 0), ("E", "E", 4)), (("A2", "A", 5), ("D", "D", 3))]
    warmth, refusals, timeline, ok = [], [], [], True
    opened = None

    def note(chunk):
        """Tenant 0's breaker state, kept when it changed."""
        st = (svc.report()["breakers"].get(0) or {}).get("state", "closed")
        if not timeline or timeline[-1][1] != st:
            timeline.append((chunk, st))
        return st

    def mid_step(ev):
        # between a chunk's admissions and its write-back: a half-open
        # probe shows here, before its clean chunk closes the breaker
        if ev.get("ph") == "X" and ev.get("name") in (
                "serve.dispatch", "serve.compile_dispatch"):
            note(ev["args"]["chunk"])

    otrace.add_observer(mid_step)
    t0 = time.perf_counter()
    try:
        prev = None
        while True:
            for tag, ds, tenant in (waves.pop(0) if waves else ()):
                jobs[tag] = svc.submit(data[ds], GUARD_NITER, job_id=tag,
                                       tenant_id=tenant)
            if prev is None:
                prev = svc.report()
            worked = svc.step_supervised()
            rep = svc.report()
            if rep["prewarms"] and not warmth:
                warmth += [("before the step that prebuilt D", prev),
                           ("after it", rep)]
            prev = rep
            st = note(rep["chunks"])
            if st == "open" and not refusals:
                # the open tenant's re-submission, then one job more
                # fills the queue to max_queue and the next is refused
                for tag, ds, tenant, what in (
                        ("A'", "A", 0, "re-submission of tenant 0"),
                        ("X", "E", 6, None),
                        ("Y", "E", 7, "a fourth queued job")):
                    try:
                        jobs[tag] = svc.submit(data[ds], 2 * SERVE_CHUNK,
                                               job_id=tag,
                                               tenant_id=tenant)
                    except CircuitOpen as exc:
                        refusals.append((what, str(exc)))
                opened = rep["chunks"]
            if opened is not None and \
                    rep["chunks"] >= opened + GUARD_OPEN_CHUNKS:
                now[0] = 2.0 * GUARD_BREAKER["cooldown_s"]
            if not worked and not svc.queue:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = svc.report()
    finally:
        otrace.remove_observer(mid_step)
        faults.clear()
        agg.uninstall()
        svc.close()
    warmth.append(("at the end", rep))
    for label, r in warmth:
        print(f"phase 23 {label}: compile_stalls {r['compile_stalls']}, "
              f"warm_hit_rate {r['warm_hit_rate']:.4f}, prewarms "
              f"{r['prewarms']}", flush=True)
    summ = rep["stage_summary"]
    for stage in ("host_prep", "enqueue", "device", "writeback"):
        s = summ.get(stage)
        ok &= s is not None
        print(f"phase 23 dispatch_ms{{stage={stage!r},job='svc'}}: "
              + ("none" if s is None else
                 f"p50 {s['p50']:.4f} p90 {s['p90']:.4f} ema "
                 f"{s['ema']:.4f} over {s['n']} spans"), flush=True)
    if "enqueue" in summ:
        print("phase 23 dispatch_amortized: no gauge (the service's "
              "dispatch span carries no n=); the enqueue p50 over "
              f"{SERVE_CHUNK} sweeps is "
              f"{summ['enqueue']['p50'] / SERVE_CHUNK:.4f} ms a sweep",
              flush=True)
    print("phase 23 tenant 0's breaker by chunk: "
          + ", ".join(f"{st} at chunk {c}" for c, st in timeline)
          + f"; snapshot {rep['breakers'].get(0)}", flush=True)
    for what, msg in refusals:
        print(f"phase 23 refused ({what}): CircuitOpen: {msg}", flush=True)
    print(f"phase 23 admission {rep['admission']}, prewarms "
          f"{rep['prewarms']}, groups {rep['groups']}, quarantines "
          f"{rep['quarantines']} {rep['quarantine_log']}", flush=True)

    states = [st for _, st in timeline]
    good_br = (states[:1] == ["closed"] and "open" in states
               and "half_open" in states and states[-1] == "closed"
               and rep["breakers"][0]["opens"] == 1)
    good_ref = ([w for w, _ in refusals] == ["re-submission of tenant 0",
                                             "a fourth queued job"]
                and "tenant 0" in refusals[0][1]
                and "backpressure" in refusals[1][1]
                and rep["admission"]["rejections"] == 1)
    d_bucket = str(tuple(jobs["D"].bucket.as_tuple()))
    good_pre = (rep["prewarms"] == 1
                and rep["groups"][d_bucket]["misses"] == 0
                and len(warmth) == 3
                and warmth[1][1]["compile_stalls"] == rep["compile_stalls"]
                == 1)
    jb = jobs["B"]
    same = (np.array_equal(jb.chain, ctx["ref_b"][0])
            and np.array_equal(jb.bchain, ctx["ref_b"][1]))
    ok &= good_br and good_ref and good_pre and same
    rows = 0
    for tag, j in jobs.items():
        ver = integrity.verify(j.outdir)
        good = (j.state == "done" and bool(np.isfinite(j.chain).all())
                and bool(np.isfinite(j.bchain).all()) and ver["ok"]
                and ver["rows"] == j.niter)
        ok &= good
        rows += j.it
        print(f"phase 23 job {tag} (tenant {j.tenant_id}, bucket "
              f"{j.bucket.as_tuple()}): {j.state}, {j.it} rows, "
              f"{j.quarantines} quarantines, checkpoint verified "
              f"{ver['ok']} ({ver['rows']} rows) {'ok' if good else 'FAIL'}",
              flush=True)
    print(f"phase 23 B bitwise equal to 22b's lone B under perf=True, the "
          f"stall and the capture: {same}; breaker "
          f"{'ok' if good_br else 'FAIL'}, refusals "
          f"{'ok' if good_ref else 'FAIL'}, prewarm "
          f"{'ok' if good_pre else 'FAIL'}; {rows} rows in {wall:.3f} s, "
          f"{rep['chunks']} chunks, graph captures {svc.captures()}",
          flush=True)

    # each kernel form the path launched, run on the card as counted
    runs, host = kernels.device_launches(), kernels.launch_counts()
    progs = list(cache._programs.values())
    forms = {}
    for key, n in host.items():
        if not n:
            continue
        replayed = sum(p.captured_launches.get(key, 0) * p.replays
                       for p in progs)
        recorded = sum(p.captured_launches.get(key, 0) for p in progs)
        forms[key] = (runs[key], n - recorded + replayed)
    gram = ("gram_accumulate", "widen_f64")
    good_runs = gram in forms and all(r == e and r > 0
                                      for r, e in forms.values())
    ok &= good_runs
    print("phase 23 kernel runs counted on the card: " + ", ".join(
        f"{k}[{f}] {r} (expected {e})" for (k, f), (r, e) in forms.items())
        + f" {'ok' if good_runs else 'FAIL'}", flush=True)

    # the flight recorder's capture
    breaches = telemetry.snapshot("stage_band_breaches")
    cap = rec.captures[0] if rec.captures else None
    dev, spans, share, launch = (_gpu_events(cap) if cap
                                 else ({}, set(), None, []))
    gram_n = {}
    for nm, n in dev.items():
        hit = re.search(r"gram_\w+", nm)
        if hit:
            gram_n[hit.group(0)] = gram_n.get(hit.group(0), 0) + n
    good_cap = (len(rec.captures) == 1 and cap is not None and bool(dev)
                and {"serve.dispatch", "serve.d2h", "serve.writeback"}
                <= spans)
    ok &= good_cap
    print(f"phase 23 band breaches {breaches}; flight recorder captures "
          f"{rec.captures} (anomaly_captures "
          f"{telemetry.get('anomaly_captures')}); obs spans in it "
          f"{sorted(spans)}; device events by name "
          f"{json.dumps(dict(sorted(dev.items(), key=lambda kv: -kv[1])))}"
          f"; the Gram's kernels among them {gram_n}; the card busy "
          + ("n/a" if share is None else f"{share:.4f}")
          + " of the window between its first and last event; "
          f"{len(launch)} cudaGraphLaunch calls of "
          + (f"{sum(launch) / len(launch):.3f} ms mean on the host"
             if launch else "n/a")
          + f" {'ok' if good_cap else 'FAIL'}", flush=True)
    del svc, progs, cache
    torch.cuda.empty_cache()
    print(f"phase 23 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    if not ok:
        print("chip_smoke: phase 23 failed", file=sys.stderr)
    out = [dict(name=f"{k}[{f}] (phase 23 path: the guarded service with "
                f"perf=True, {SERVE_SLOTS} slots x 46 pulsars, B1 61; timed "
                "in 22c at the same shape)",
                route="cuda", source=SOURCES[k][0], replaces=REPLACES[k],
                launches=forms.get((k, f), (0, 0))[0], **r)
           for (k, f), r in ctx["recs"].items()]
    return ok, out


def mesh_rank(rank, kind, seed, outdir):
    """A rank of phases 25 (``kind`` ``"gloo"``: one of two gloo ranks
    sharing the card, pulsar mesh 2, the array padded to ``P25_PAD``,
    eager) and 25b (``"nccl"``: the one rank of an NCCL group on an
    explicit ``(1, 1)`` mesh, phase 4's array, CUDA graphs captured
    around the collectives).  Runs the array at 64 chains through W +
    ``P25_STEADY`` sweeps with its kernel counts set to 0 first, then
    counts the collectives of one more sweep and holds each kernel form
    against its plain version at the shard's shapes (the gloo ranks one
    after the other).  Returns the chains (rank 0), the counts, the
    parity rows and the timings."""
    import torch
    import torch.distributed as dist

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import synthetic_array
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.parallel import sharding
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    dev = torch.device(DEVICE)
    gloo = kind == "gloo"
    psrs = synthetic_array(npsr=45, seed=seed)
    cm = ptt.build_crn_spectrum(psrs, nbins=10, red_bins=10,
                                pad_pulsars=P25_PAD if gloo else None,
                                device=dev)
    mesh = sharding.make_mesh(2 if gloo else (1, 1), device=DEVICE)
    # 25 cuts its warmup and white adaptation as the side paths do; 25b
    # keeps phase 4's, whose rows it must equal
    warm = SIDE_WARMUP if gloo else WARMUP
    niter = warm + 1 + P25_STEADY
    sharding.reset_collectives()
    kernels.reset_launches()
    t0 = time.perf_counter()
    g = ptt.PTABlockGibbs(cm, nchains=NCHAINS, device=dev, seed=seed,
                          warmup_sweeps=warm, progress=False, mesh=mesh,
                          **({"chunk_size": P25_SAVE,
                              "white_adapt_iters": SIDE_WHITE_ADAPT}
                             if gloo else {}))
    x0 = g.initial_sample(torch.Generator(device=dev).manual_seed(seed))
    out = Path(outdir) / ("mesh2" if gloo else "mesh11")
    chain = g.sample(x0, outdir=out, niter=niter,
                     save_every=P25_SAVE if gloo else SAVE_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drv = g.driver
    runs = kernels.device_launches()
    host = kernels.launch_counts()
    run_coll = dict(sharding.COLLECTIVES)
    res = {"rank": rank, "wall": wall, "runs": runs, "host": host,
           "sps": drv.steady_sweeps / drv.steady_seconds,
           "steady_ms": {k: v / drv.steady_sweeps
                         for k, v in drv.timer.ms.items()},
           "graphs_off": drv.graphs_off, "graphed": drv.carry.graphed,
           "collectives_run": run_coll,
           "layout": sharding.mesh_layout(mesh),
           "shard": (drv.cm.p0, drv.cm.pn, drv.c0, drv.Cl),
           "verify": integrity.verify(out) if rank == 0 else None}
    if drv.carry.graphed:
        res["counts"] = launch_counts(drv.carry)
    c = drv.carry
    if not c.graphed:
        _, res["collectives_sweep"] = sharding.collective_report(
            lambda: drv._sweep(c.x, c.b, c.u, False, niter))
    if rank == 0:
        res["chain"], res["bchain"] = chain, g.bchain
    xs = torch.as_tensor(drv.x_cur[drv.c0:drv.c0 + drv.Cl],
                         dtype=cm.cdtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 25)
    recs, ok = {}, True
    for turn in range(mesh.size if gloo else 1):
        if turn == rank:
            print(f"phase 2 at phase 25{'' if gloo else 'b'}'s final "
                  f"state, rank {rank}'s shard ({drv.cm.pn} of "
                  f"{drv.cm.P} pulsars, {drv.Cl} chains):", flush=True)
            rg, okg = gram_parity(drv.cm, xs, time_ms,
                                  forms=tuple(f for k, f in P25_FORMS
                                              if k == "gram_accumulate"))
            rc, okc = chol_parity(drv.cm, xs, gen, time_ms)
            recs, ok = {**rg, **rc}, okg and okc
        if gloo:
            dist.barrier()
    res["recs"], res["parity_ok"] = recs, ok
    return res


def _first_difference(a, b):
    """``(first differing row, max |a - b|)`` of two chains, or ``(None,
    0.0)`` when they are bitwise equal."""
    import numpy as np

    if np.array_equal(a, b):
        return None, 0.0
    bad = np.argwhere((a != b).reshape(len(a), -1).any(-1))
    return int(bad[0][0]), float(np.nanmax(np.abs(a - b)))


def mesh_paths(args, psrs, head4, outdir):
    """Phases 25-25c (module docstring): the array padded to
    ``P25_PAD`` unsharded (eager, the reference), on two gloo ranks
    sharing the card (25), its mid-run checkpoint resumed on one rank
    by ``reshard_restore`` (25c, and again with
    ``device_count_change_on_resume`` armed), and phase 4's array on a
    one-rank NCCL ``(1, 1)`` mesh with graphs (25b) against ``head4``,
    phase 4's first rows.  Returns the kernels line's rows, or None when
    a phase failed."""
    import shutil

    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.parallel import sharding
    from pulsar_timing_gibbsspec_torch.runtime import faults, integrity
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    dev = torch.device(DEVICE)
    card = card_line()
    niter = SIDE_WARMUP + 1 + P25_STEADY
    cm = ptt.build_crn_spectrum(psrs, nbins=10, red_bins=10,
                                pad_pulsars=P25_PAD, device=dev)
    kw = dict(nchains=NCHAINS, device=dev, seed=args.seed,
              warmup_sweeps=SIDE_WARMUP, progress=False,
              white_adapt_iters=SIDE_WHITE_ADAPT)

    # ---- 25: the reference, then two gloo ranks sharing the card -------
    t0 = time.perf_counter()
    g = ptt.PTABlockGibbs(cm, graphs=False, chunk_size=P25_SAVE, **kw)
    x0 = g.initial_sample(torch.Generator(device=dev).manual_seed(
        args.seed))
    ref = g.sample(x0, outdir=outdir / "mesh_ref", niter=niter,
                   save_every=P25_SAVE)
    ref_b, drv = g.bchain, g.driver
    ref_sps = drv.steady_sweeps / drv.steady_seconds
    print(f"phase 25 reference: the array padded to {P25_PAD} pulsars, "
          f"unsharded, eager, {niter} rows x {NCHAINS} chains in "
          f"{time.perf_counter() - t0:.1f} s; steady {ref_sps:.3f} "
          f"sweeps/s = {ref_sps * NCHAINS:.1f} samples/s ({card})",
          flush=True)
    del g, drv
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = sharding.spawn(mesh_rank, 2, backend="gloo", device="cuda:0",
                           args=("gloo", args.seed, str(outdir)))
    r0 = ranks[0]
    chain, bchain = r0["chain"], r0["bchain"]
    row_x, dx = _first_difference(chain, ref)
    row_b, db = _first_difference(bchain, ref_b)
    bitwise = row_x is None and row_b is None
    finite = bool(np.isfinite(chain).all() and np.isfinite(bchain).all())
    if bitwise:
        law, zs = True, None
    else:
        # the class when not bitwise: the common rho law of both runs,
        # past P25_BURN steady rows (chain_medians counts from W + 1)
        burn = P25_BURN - (WARMUP - SIDE_WARMUP)
        (m1, s1), (m2, s2) = (chain_medians(chain, cm, range(NCHAINS),
                                            burn),
                              chain_medians(ref, cm, range(NCHAINS), burn))
        zs = np.abs(m1 - m2) / np.sqrt(s1 ** 2 + s2 ** 2 + 1e-300)
        law = bool((zs <= 5.0).all())
    rep = r0["verify"]
    sps = r0["sps"]
    print(f"phase 25 two gloo ranks sharing the card, pulsar mesh 2 (shards "
          + json.dumps([r["shard"] for r in ranks]) + " as (first pulsar, "
          f"pulsars, first chain, chains)), eager ({r0['graphs_off']} "
          f"collectives cannot be captured): {niter} rows x {NCHAINS} "
          f"chains, spawn to exit {time.perf_counter() - t0:.1f} s (rank "
          f"0's run {r0['wall']:.1f} s); steady {sps:.3f} sweeps/s = "
          f"{sps * NCHAINS:.1f} samples/s, "
          f"{sps / ref_sps:.3f} of the unsharded eager reference's "
          f"({card}); rows {len(chain)}, manifest verified {rep['ok']} at "
          f"{rep['rows']} rows", flush=True)
    print("phase 25 per-block ms per steady sweep, rank 0 (CUDA events): "
          + json.dumps({k: round(v, 4)
                        for k, v in sorted(r0["steady_ms"].items())}),
          flush=True)
    for r in ranks:
        print(f"phase 25 rank {r['rank']} kernel runs counted on the card "
              "(eager: the host's launches): " + json.dumps(
                  {f"{k}[{f}]": n for (k, f), n in r["runs"].items() if n})
              + "; collectives in the run " + json.dumps(
                  r["collectives_run"]) + ", in one steady sweep "
              + json.dumps(r["collectives_sweep"]), flush=True)
    # why a shard's chain may leave the reference's: whether a row sum's
    # and a batched product's bits on the card depend on how many rows or
    # systems the call is given (a shard gives half of them)
    pg = torch.Generator(device=dev).manual_seed(args.seed)
    ph, n = P25_PAD // 2, cm.Bmax
    a = torch.randn((NCHAINS * P25_PAD, cm.Nmax), dtype=cm.dtype,
                    device=dev, generator=pg)
    bb = torch.randn((NCHAINS, P25_PAD, n), dtype=cm.dtype, device=dev,
                     generator=pg)
    S = torch.randn((NCHAINS * P25_PAD, n, n), dtype=torch.float64,
                    device=dev, generator=pg)
    probes = {
        "row sums": torch.equal(a.sum(-1)[:NCHAINS * ph],
                                a[:NCHAINS * ph].sum(-1)),
        "u = T b": torch.equal(blocks.b_matvec(cm, bb)[:, :ph], torch.matmul(
            cm.T[:ph], bb[:, :ph, :, None])[..., 0]),
        "float64 products of the factor": torch.equal(
            torch.matmul(S, S)[:NCHAINS * ph],
            torch.matmul(S[:NCHAINS * ph], S[:NCHAINS * ph]))}
    # the Laplace step's eigendecompositions of the white blocks
    W = int(cm.white_par_ix.shape[1])
    E = S[:, :W, :W]
    E = E @ E.transpose(-1, -2) + torch.eye(W, dtype=E.dtype, device=dev)
    full, part = (torch.linalg.eigh(E), torch.linalg.eigh(
        E[:NCHAINS * ph]))
    probes[f"eigh of {W} x {W} blocks"] = (
        torch.equal(full[0][:NCHAINS * ph], part[0])
        and torch.equal(full[1][:NCHAINS * ph], part[1]))
    print(f"phase 25 the card's results for the first half of a call's rows "
          f"or systems, bitwise equal to the same half given alone: "
          + json.dumps(probes) + f" (rows of {cm.Nmax} TOAs, T b at "
          f"{NCHAINS} x {P25_PAD} pulsars, {NCHAINS * P25_PAD} float64 "
          f"products of order {n}, as many eigh)", flush=True)
    del a, bb, S, E, full, part
    print(f"phase 25 against the reference: chain "
          + ("bitwise equal" if bitwise else
             f"not bitwise (x from row {row_x}, max |dx| {dx:.3e}; b from "
             f"row {row_b}, max |db| {db:.3e}); the common rho law in "
             "combined standard errors " + json.dumps(
                 [round(float(v), 2) for v in zs]))
          + f" {'ok' if law else 'FAIL'}", flush=True)
    missing = [f"rank {r['rank']} {k}[{f}]" for r in ranks
               for k, f in P25_FORMS if r["runs"].get((k, f), 0) == 0]
    ok25 = (finite and law and rep["ok"] and rep["rows"] == niter
            and not missing and all(r["parity_ok"] for r in ranks)
            and r0["graphs_off"] == "gloo")
    if not ok25:
        print(f"chip_smoke: phase 25 failed (finite={finite}, as the "
              f"reference={law}, verified={rep['ok']}, never run={missing}"
              ", kernel parity "
              f"{[r['parity_ok'] for r in ranks]})", file=sys.stderr)
        return None
    rows = []
    for r in ranks:
        for key, rec in r["recs"].items():
            k, f = key
            rows.append(dict(
                name=f"{k}[{f}] (phase 25 path: rank {r['rank']} of two "
                f"gloo ranks sharing the card, pulsar mesh 2, its shard "
                f"{r['shard'][1]} of {P25_PAD} pulsars x {NCHAINS} chains)",
                route="cuda", source=SOURCES[k][f.endswith("_wide")],
                replaces=REPLACES[k], launches=r["runs"][key], **rec))
    elapsed("phase 25")

    # ---- 25c: the mid-run checkpoint resumed on one rank --------------
    mid = SIDE_WARMUP + 1 + P25_SAVE
    # the reference's own checkpoint: the resume replays the rest of the
    # uninterrupted reference bitwise
    dst = outdir / "mesh_ref_resume"
    shutil.copytree(outdir / "mesh_ref", dst)
    # the .bak generation is the checkpoint before the last: row mid
    rolled = integrity.rollback(dst)
    at = integrity.verify(dst)
    g = integrity.reshard_restore(dst, cm, devices=1, graphs=False,
                                  chunk_size=P25_SAVE, **{
                                      k: v for k, v in kw.items()
                                      if k != "nchains"})
    res = g.sample(x0, outdir=dst, niter=niter, resume=True,
                   save_every=P25_SAVE)
    row_x, dx = _first_difference(res, ref)
    row_b, db = _first_difference(g.bchain, ref_b)
    same = row_x is None and row_b is None
    print(f"phase 25c the reference's checkpoint at row {at['rows']} "
          f"(rolled back to .bak {rolled}) resumed by reshard_restore on "
          f"one rank, eager: {len(res)} rows, bitwise equal to the "
          "uninterrupted reference " + ("True" if same else
                                        f"False (x from row {row_x}, max "
                                        f"|dx| {dx:.3e}; b from row "
                                        f"{row_b}, max |db| {db:.3e})"),
          flush=True)
    if not (rolled and at["rows"] == mid and g.mesh is None and same):
        print("chip_smoke: phase 25c failed (the reference's resume)",
              file=sys.stderr)
        return None
    del g, res
    # phase 25's checkpoint, twice: the resumes run unsharded from one
    # checkpoint, bitwise equal to each other and to phase 25's rows
    # before it; to phase 25's whole chain where 25 was bitwise the
    # reference's
    got = []
    for tag, devices, fault in (("", 1, None), (" under the device-count "
                                               "fault (asked 2, given 1)",
                                               2, 1)):
        dst = outdir / f"mesh2_resume{devices}"
        shutil.copytree(outdir / "mesh2", dst)
        rolled = integrity.rollback(dst)
        at = integrity.verify(dst)
        if fault is not None:
            faults.inject("device_count_change_on_resume", devices=fault)
        g = integrity.reshard_restore(dst, cm, devices=devices,
                                      chunk_size=P25_SAVE, **{
                                          k: v for k, v in kw.items()
                                          if k != "nchains"})
        faults.clear()
        res = g.sample(x0, outdir=dst, niter=niter, resume=True,
                       save_every=P25_SAVE)
        prefix = (np.array_equal(res[:mid], chain[:mid])
                  and np.array_equal(g.bchain[:mid], bchain[:mid]))
        whole = (np.array_equal(res, chain)
                 and np.array_equal(g.bchain, bchain))
        twin = (not got or (np.array_equal(res, got[0][0])
                            and np.array_equal(g.bchain, got[0][1])))
        got.append((res, g.bchain))
        print(f"phase 25c phase 25's checkpoint at row {at['rows']} "
              f"(rolled back to .bak {rolled}) resumed by reshard_restore "
              f"on one rank{tag}: mesh {g.mesh}, graphs "
              f"{g.driver.carry.graphed}, {len(res)} rows; its first {mid} "
              f"rows bitwise phase 25's {prefix}, the whole chain {whole}"
              + ("" if len(got) == 1 else
                 f", bitwise equal to the resume without the fault {twin}"),
              flush=True)
        ok = (rolled and at["rows"] == mid and g.mesh is None and prefix
              and twin and bool(np.isfinite(res).all())
              and (whole or not bitwise))
        if not ok:
            print("chip_smoke: phase 25c failed", file=sys.stderr)
            return None
        del g
    del got
    elapsed("phase 25c")

    # ---- 25b: one NCCL rank on a (1, 1) mesh, graphs -------------------
    t0 = time.perf_counter()
    r = sharding.spawn(mesh_rank, 1, backend="nccl", device="cuda:0",
                       args=("nccl", args.seed, str(outdir)))[0]
    niter = WARMUP + 1 + P25_STEADY
    c4, b4 = head4
    same = (np.array_equal(r["chain"], c4)
            and np.array_equal(r["bchain"], b4))
    if not r["graphed"]:
        print("chip_smoke: phase 25b ran without CUDA graphs",
              file=sys.stderr)
        return None
    runs = r["counts"][0]
    missing, unreplayed, unaccounted = count_faults(
        r["counts"], P25_FORMS, GRAPHED)
    print(f"phase 25b one rank of an NCCL group on the (1, 1) mesh, CUDA "
          f"graphs {r['graphed']}: {niter} rows x {NCHAINS} chains of "
          f"phase 4's array, spawn to exit {time.perf_counter() - t0:.1f} "
          f"s; steady {r['sps']:.3f} sweeps/s = {r['sps'] * NCHAINS:.1f} "
          f"samples/s ({card}); collectives issued (captures included) "
          + json.dumps(r["collectives_run"]) + f"; bitwise equal to phase "
          f"4's first {niter} rows (unsharded, graphed) {same}", flush=True)
    print_counts("25b", r["counts"])
    if not (same and r["graphed"] and not missing and not unreplayed
            and not unaccounted and r["parity_ok"]):
        print(f"chip_smoke: phase 25b failed (bitwise={same}, graphed="
              f"{r['graphed']}, never run={missing}, not replayed="
              f"{unreplayed}, unaccounted={unaccounted})", file=sys.stderr)
        return None
    for key, rec in r["recs"].items():
        k, f = key
        rows.append(dict(
            name=f"{k}[{f}] (phase 25b path: one NCCL rank, (1, 1) mesh, "
            f"graphs, 45 pulsars x {NCHAINS} chains)", route="cuda",
            source=SOURCES[k][f.endswith("_wide")], replaces=REPLACES[k],
            launches=runs[key], **rec))
    elapsed("phase 25b")
    return rows


@contextlib.contextmanager
def environ(**env):
    """``os.environ`` with ``env`` set, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def precision_run(phase, cm, facade, C, warmup, steady, seed, outdir,
                  forms, graph_at, label, white_adapt=None):
    """One path of phase 24: ``facade`` on ``cm`` (built under its
    setting), ``warmup`` + ``steady`` sweeps from the graphs, checkpointed
    every ``SAVE_EVERY``, launch counts from 0.  Gates (module
    docstring) but the rho law; then the graphs-against-eager check from
    ``graph_at``.  Returns ``(ok, chain, drv, runs)``."""
    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    niter = warmup + 1 + steady
    kernels.reset_launches()
    t0 = time.perf_counter()
    kw = {} if white_adapt is None else {"white_adapt_iters": white_adapt}
    g = getattr(ptt, facade)(cm, nchains=C, device=cm.device, seed=seed,
                             warmup_sweeps=warmup, progress=False, **kw)
    x0 = g.initial_sample(torch.Generator(device=cm.device).manual_seed(
        seed))
    chain = g.sample(x0, outdir=outdir, niter=niter, save_every=SAVE_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drv, graphs = g.driver, g.driver.carry
    counts = launch_counts(graphs)
    runs = counts[0]
    missing, unreplayed, unaccounted = count_faults(counts, forms, forms)
    stray = [f"{k}[{f}]" for (k, f), n in runs.items()
             if n and (k, f) not in forms]
    sps = drv.steady_sweeps / drv.steady_seconds
    per_block = {k: round(v / drv.steady_sweeps, 4)
                 for k, v in sorted(drv.timer.ms.items())}
    # the medians of the common and red log10_rho and of every hyper with
    # a uniform prior, over the steady rows, inside that prior
    med = np.median(chain[warmup + 1:].reshape(-1, cm.nx), axis=0)
    uni = cm.pkind.cpu().numpy() == 0
    pa, pb = cm.pa.double().cpu().numpy(), cm.pb.double().cpu().numpy()
    inside = bool(((med[uni] > pa[uni]) & (med[uni] < pb[uni])).all())
    rho = med[cm.rho_ix_x.cpu().numpy()]
    rep = integrity.verify(outdir)
    finite = bool(np.isfinite(chain).all() and np.isfinite(g.bchain).all())
    saved = rep["ok"] and rep["rows"] == niter and graphs.graphed
    print(f"phase {phase} {label}: storage {cm.dtype}, compute "
          f"{cm.cdtype}, Gram segments {cm.gram_seg_len} / "
          f"{cm.gram_seg_len_exact} TOAs; {niter} rows x {C} chains in "
          f"{wall:.1f} s (warmup {warmup}); steady {drv.steady_sweeps} "
          f"sweeps in {drv.steady_seconds:.3f} s = {sps:.3f} sweeps/s = "
          f"{sps * C:.1f} samples/s; CUDA graphs {len(graphs.graphs)} "
          f"captured in {graphs.capture_seconds:.3f} s, pool "
          f"{graphs.pool_bytes / 1e6:.1f} MB; record {drv.rdtype}, carry "
          f"{drv.b.dtype}", flush=True)
    print(f"phase {phase} per-block ms per steady sweep (CUDA events): "
          + json.dumps(per_block), flush=True)
    print(f"phase {phase} common log10_rho medians per bin: "
          + json.dumps([round(float(v), 3) for v in rho]) + "; every "
          f"uniform-prior median inside its prior {inside}", flush=True)
    print_counts(phase, counts)
    ok = (finite and inside and saved and not missing and not unreplayed
          and not unaccounted and not stray)
    if not ok:
        print(f"chip_smoke: phase {phase} failed (finite={finite}, medians "
              f"inside the priors={inside}, verified checkpoint through "
              f"the graphs={saved}, never run={missing}, not replayed as "
              f"captured={unreplayed}, runs other than eager launches plus "
              f"replays={unaccounted}, forms other than the path's="
              f"{stray})", file=sys.stderr)
        return False, chain, drv, runs
    xs = torch.as_tensor(drv.x_cur, dtype=cm.cdtype, device=cm.device)
    if not graphs_vs_eager(drv, xs, drv.b.to(cm.device), graph_at, phase,
                           label):
        print(f"chip_smoke: phase {phase}'s graph replay differs from the "
              "eager sweep", file=sys.stderr)
        return False, chain, drv, runs
    return True, chain, drv, runs


def precision_paths(args, psrs, gen, outdir, ref_stats):
    """Phases 24-24c (module docstring): the array and the Quick start
    under ``PTGIBBS_PRECISION=f64``, the array under
    ``PTGIBBS_COMPUTE=f32`` with ``PTGIBBS_GRAM_SEG=48``; ``ref_stats``
    is phase 4's per-bin rho statistic.  Returns the kernels line's rows,
    or None when a phase failed."""
    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import load_enterprise_snapshot

    dev = torch.device(DEVICE)
    rows = []

    def row(key, rec, launches, what):
        k, f = key
        rows.append(dict(name=f"{k}[{f}] ({what})", route="cuda",
                         source=SOURCES[k][f.endswith("_wide")],
                         replaces=REPLACES[k], launches=launches, **rec))

    # ---- 24: the array, float64 storage ---------------------------------
    with environ(PTGIBBS_PRECISION="f64"):
        cm = ptt.build_crn_spectrum(psrs, nbins=10, red_bins=10,
                                    device=dev)
    ok, chain, drv, runs = precision_run(
        "24", cm, "PTABlockGibbs", NCHAINS, WARMUP, P24_STEADY, args.seed,
        outdir / "f64_array", P24_FORMS, P24_GRAPH_CHECK_AT,
        "the array, PTGIBBS_PRECISION=f64")
    if not ok:
        return None
    (m24, s24), (m4, s4) = (chain_medians(chain, cm, range(NCHAINS),
                                          P24_BURN), ref_stats)
    zs = np.abs(m24 - m4) / np.sqrt(s24 ** 2 + s4 ** 2)
    law = bool((zs <= 5.0).all())
    print(f"phase 24 common log10_rho past the first {P24_BURN} steady "
          "rows, mean of per-chain medians " + json.dumps(
              [round(float(v), 3) for v in m24]) + " against phase 4's "
          + json.dumps([round(float(v), 3) for v in m4]) + ", in combined "
          "standard errors " + json.dumps([round(float(v), 2) for v in zs])
          + f" {'ok' if law else 'FAIL'}", flush=True)
    xs = torch.as_tensor(drv.x_cur, dtype=cm.cdtype, device=dev)
    print("phase 2 at phase 24's final state:", flush=True)
    rg, okg = gram_parity(cm, xs, time_ms, forms=("f64",))
    rc, okc = chol64_parity(cm, xs, time_ms, gen=gen)
    if not (law and okg and okc):
        print("chip_smoke: phase 24 failed (rho law as phase 4's="
              f"{law}, kernel parity {okg and okc})", file=sys.stderr)
        return None
    what = (f"phase 24 path: PTGIBBS_PRECISION=f64, {NCHAINS} chains, "
            f"B1 {cm.Bmax + 1}")
    for key, rec in rg.items():
        row(key, rec, runs[key], what)
    for key, rec in rc.items():
        row(key, rec, runs[key], what + ", the steady proposal's systems")
    del cm, chain, drv, xs
    torch.cuda.empty_cache()
    elapsed("phase 24")

    # ---- 24b: the Quick start, float64 storage --------------------------
    with environ(PTGIBBS_PRECISION="f64"):
        cm1 = ptt.model_general([load_enterprise_snapshot(SNAPSHOT)],
                                red_var=False, white_vary=True,
                                common_psd="spectrum",
                                common_components=SINGLE_BINS, device=dev)
    ok, chain, drv, runs = precision_run(
        "24b", cm1, "PulsarBlockGibbs", SINGLE_CHAINS, SIDE_WARMUP,
        P24_STEADY, args.seed, outdir / "f64_single", P24B_FORMS,
        P24_GRAPH_CHECK_AT, "the J1713+0747 Quick start, "
        "PTGIBBS_PRECISION=f64", white_adapt=SIDE_WHITE_ADAPT)
    if not ok:
        return None
    xs = torch.as_tensor(drv.x_cur, dtype=cm1.cdtype, device=dev)
    print("phase 2 at phase 24b's final state (8 chains, then the first "
          "chain alone):", flush=True)
    rg, okg = gram_parity(cm1, xs, time_ms, forms=("f64",))
    rg1, okg1 = gram_parity(cm1, xs[:1], time_ms, forms=("f64",))
    rc, okc = chol64_parity(cm1, xs, time_ms, gen=gen)
    if not (okg and okg1 and okc):
        print("chip_smoke: kernel parity at phase 24b's state failed",
              file=sys.stderr)
        return None
    what = (f"phase 24b path: PTGIBBS_PRECISION=f64, B1 {cm1.Bmax + 1}")
    for key, rec in rg.items():
        row(key, rec, runs[key], what + f", {SINGLE_CHAINS} chains")
    for key, rec in rg1.items():
        row(key, rec, runs[key], what + ", at one chain (launches: 24b's "
            f"{SINGLE_CHAINS} chains)")
    for key, rec in rc.items():
        row(key, rec, runs[key], what + f", {SINGLE_CHAINS} chains, the "
            "steady proposal's systems")
    del cm1, chain, drv, xs
    torch.cuda.empty_cache()
    elapsed("phase 24b")

    # ---- 24c: the array, float32 compute, 48-TOA Gram segments ----------
    with environ(PTGIBBS_COMPUTE="f32", PTGIBBS_GRAM_SEG=str(P24C_SEG)):
        cm = ptt.build_crn_spectrum(psrs, nbins=10, red_bins=10,
                                    device=dev)
    ok, chain, drv, runs = precision_run(
        "24c", cm, "PTABlockGibbs", NCHAINS, P24C_WARMUP, P24C_STEADY,
        args.seed, outdir / "f32_compute", P24C_FORMS, P24C_GRAPH_CHECK_AT,
        f"the array, PTGIBBS_COMPUTE=f32, PTGIBBS_GRAM_SEG={P24C_SEG}",
        white_adapt=SIDE_WHITE_ADAPT)
    if not ok:
        return None
    xs = torch.as_tensor(drv.x_cur, dtype=cm.cdtype, device=dev)
    print("phase 2 at phase 24c's final state (the float32 factor at phase "
          "4's shape: timed in that row):", flush=True)
    rg, okg = gram_parity(cm, xs, time_ms, forms=("f32",))
    _, okc = chol_parity(cm, xs, gen, None)
    if not (okg and okc):
        print("chip_smoke: kernel parity at phase 24c's state failed",
              file=sys.stderr)
        return None
    for key, rec in rg.items():
        row(key, rec, runs[key], f"phase 24c path: PTGIBBS_COMPUTE=f32, "
            f"PTGIBBS_GRAM_SEG={P24C_SEG}, B1 {cm.Bmax + 1}")
    del cm, chain, drv, xs
    torch.cuda.empty_cache()
    elapsed("phase 24c")
    return rows


def earlier_paths(args, psrs, gen, outdir, extra):
    """Phases 2-12: the kernel parity at the shapes of the paths of
    earlier slices, then phases 3-12c with 19-19b after 18c and 21 after
    7c; ``extra`` receives phase 4's steady sweeps per second (``sps4``),
    the single-pulsar model on the card (``cm1``) and its wide kernel
    forms (``wide``) for phases 20a-20.  Returns ``(rows, timed, hd)``:
    the ``kernels`` JSON rows of those shapes, with their launches from
    their paths' runs, the records of the 45-pulsar shapes (the narrow
    forms at order 37, the float64 factor at 2880 x 37) and the
    Hellings-Downs path's Gram record, keyed by ``(kernel, form)``; or
    None when a phase failed."""
    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import (
        load_enterprise_snapshot, synthetic_noisedict)
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    dev = torch.device(DEVICE)
    C = NCHAINS
    cm = ptt.build_crn_spectrum(psrs, nbins=10, red_bins=10, device=dev)
    print(f"model: P={cm.P} Nmax={cm.Nmax} Bmax={cm.Bmax} nx={cm.nx}, "
          f"{C} chains", flush=True)
    cm1 = ptt.model_general([load_enterprise_snapshot(SNAPSHOT)],
                            red_var=False, white_vary=True,
                            common_psd="spectrum",
                            common_components=SINGLE_BINS, device=dev)
    print(f"single-pulsar model: {cm1.pulsars[0]} P={cm1.P} "
          f"Nmax={cm1.Nmax} Bmax={cm1.Bmax} nx={cm1.nx}, {SINGLE_CHAINS} "
          "chains", flush=True)
    # the powerlaw paths: R1 the reference's single-pulsar sweep, R2 the
    # array with powerlaw red noise, R3 model_general's defaults but white
    snap = load_enterprise_snapshot(SNAPSHOT)
    cm_r1 = ptt.model_general([snap], white_vary=True, common_psd="spectrum",
                              common_components=SINGLE_BINS,
                              red_psd="powerlaw",
                              red_components=SINGLE_BINS, device=dev)
    cm_r2 = ptt.model_general(psrs, tm_svd=True, white_vary=True,
                              common_psd="spectrum", common_components=10,
                              red_psd="powerlaw", red_components=10,
                              device=dev)
    cm_r3 = ptt.model_general([snap], white_vary=True, device=dev)
    for nm, m in (("R1", cm_r1), ("R2", cm_r2), ("R3", cm_r3)):
        print(f"powerlaw model {nm}: P={m.P} Nmax={m.Nmax} Bmax={m.Bmax} "
              f"nx={m.nx}, common {m.gw_kind} ({m.K}), red {m.red_kind} "
              f"({m.Kr}), {len(m.idx.red)} powerlaw hypers", flush=True)
    # the Hellings-Downs array: bench.py's HD model
    cm_hd = ptt.model_general(psrs, tm_svd=True, white_vary=True,
                              common_psd="spectrum",
                              common_components=HD_BINS, red_psd="spectrum",
                              red_components=HD_BINS, orf="hd", device=dev)
    print(f"Hellings-Downs model: P={cm_hd.P} Nmax={cm_hd.Nmax} "
          f"Bmax={cm_hd.Bmax} nx={cm_hd.nx}, orf {cm_hd.orf_name} (K "
          f"{cm_hd.K}), red {cm_hd.red_kind} ({cm_hd.Kr}), red on its own "
          f"columns {not cm_hd.red_shares_gw}, {HD_CHAINS} chains",
          flush=True)
    # the standard noise model: the array (phase 11) and the single
    # pulsar with the NANOGrav single-pulsar noise model (phase 12), white
    # noise fixed from seeded noise dictionaries
    cm_n11 = ptt.model_general(
        psrs, tm_svd=True, white_vary=False,
        noisedict=synthetic_noisedict(psrs, args.seed, ecorr=False),
        common_psd="spectrum", common_components=N11_BINS,
        red_psd="powerlaw", red_components=N11_BINS, dm_var=True,
        dm_components=N11_BINS, dm_annual=True, device=dev)
    cm_n12 = ptt.model_general(
        [snap], white_vary=False,
        noisedict=synthetic_noisedict([snap], args.seed),
        common_psd="turnover", gamma_common=13.0 / 3.0,
        common_components=N12_BINS, red_psd="powerlaw",
        red_components=N12_BINS, dm_var=True, dm_components=N12_BINS,
        bayesephem=True, device=dev)
    for nm, m in (("11", cm_n11), ("12", cm_n12)):
        print(f"standard noise model, phase {nm}: P={m.P} Nmax={m.Nmax} "
              f"Bmax={m.Bmax} nx={m.nx}, common {m.gw_kind} ({m.K}), red "
              f"{m.red_kind} ({m.Kr}), components "
              f"{[c.kind for c in m.components]}, {len(m.idx.red)} "
              f"powerlaw-family hypers, {len(m.idx.white)} white and "
              f"{len(m.idx.ecorr)} ECORR parameters sampled, "
              f"{m.ec_cols.shape[1]} ECORR columns, {m.const_pool.numel()} "
              "constants", flush=True)
    x = parity_state(cm, C, gen)
    records, ok_g = gram_parity(cm, x, time_ms)
    rec_c, ok_c = chol_parity(cm, x, gen, time_ms)
    records.update(rec_c)
    x1 = parity_state(cm1, SINGLE_CHAINS, gen)
    rec_g1, ok_g1 = gram_parity(cm1, x1, time_ms)
    rec_c1, ok_c1 = chol_parity(cm1, x1, gen, time_ms)
    records.update(rec_g1)
    records.update(rec_c1)
    rec_f64, ok_f64 = chol64_parity(cm_r2, parity_state(cm_r2, C, gen),
                                    time_ms)
    records.update(rec_f64)
    rec_f64w, ok_f64w = chol64_parity(
        cm_r1, parity_state(cm_r1, SINGLE_CHAINS, gen), time_ms)
    records.update(rec_f64w)
    # the Hellings-Downs path's Gram: the float32-product, float64-reduce
    # form at B1 = 58 (its own record: the key is the CRN row's)
    hd_records, ok_hd = gram_parity(
        cm_hd, parity_state(cm_hd, HD_CHAINS, gen), time_ms,
        forms=("f32_dot_f64_reduce",))
    # the standard noise model's shapes (their own records): the narrow
    # forms at order 59 / B1 = 60, the wide ones at order 744 / B1 = 745
    ok_n = True
    noise_records = {}
    for nm, m, nc in (("11", cm_n11, C), ("12", cm_n12, SINGLE_CHAINS)):
        xn = parity_state(m, nc, gen)
        recs, ok = gram_parity(m, xn, time_ms)
        for rec, good in (chol_parity(m, xn, gen, time_ms),
                          chol64_parity(m, xn, time_ms)):
            recs.update(rec)
            ok &= good
        noise_records[nm] = recs
        ok_n &= ok
        del xn
    del x, x1
    torch.cuda.empty_cache()
    elapsed("phase 2 (earlier paths' kernel parity and timings)")
    if not (ok_g and ok_c and ok_g1 and ok_c1 and ok_f64 and ok_f64w
            and ok_hd and ok_n):
        print("chip_smoke: kernel parity failed", file=sys.stderr)
        return None
    if not small_agreement(dev, args.seed):
        print("chip_smoke: small-input agreement failed", file=sys.stderr)
        return None
    if not graph_against_eager(cm, args.seed, outdir / "graph_check"):
        print("chip_smoke: graph replay differs from the eager sweep",
              file=sys.stderr)
        return None
    elapsed("phases 3-3b")

    # ---- phase 4: the main path, launch counts from 0 ----------------------
    niter = WARMUP + 1 + args.steady
    kernels.reset_launches()
    t0 = time.perf_counter()
    g = ptt.PTABlockGibbs(cm, nchains=C, device=dev, seed=args.seed,
                          warmup_sweeps=WARMUP, progress=False, obs=OBS)
    x0 = g.initial_sample(torch.Generator(device=dev).manual_seed(
        args.seed))
    chain = g.sample(x0, outdir=outdir / "main", niter=niter,
                     save_every=SAVE_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drv = g.driver
    graphs = drv.carry
    # kernel runs the card counted, eager and replayed, and the host's
    # launches (a capture's launch is recorded, not run)
    counts = launch_counts(graphs)
    runs = counts[0]
    narrow = [k for k in records if not k[1].endswith("_wide")
              and k not in F64_FORMS]
    missing, unreplayed, unaccounted = count_faults(counts, narrow, GRAPHED)
    sps = drv.steady_sweeps / drv.steady_seconds
    acc = drv.b_mh_accepts[:, :cm.P_real] / max(drv.b_mh_sweeps, 1)
    rho = chain[WARMUP + 1:, :, cm.rho_ix_x.cpu().numpy()]
    med = np.median(rho.reshape(-1, rho.shape[-1]), axis=0)
    per_block = {k: round(v / drv.steady_sweeps, 4)
                 for k, v in sorted(drv.timer.ms.items())}
    rep = integrity.verify(outdir / "main")
    print(f"phase 4 main path: {niter} rows x {C} chains in {wall:.1f} s "
          f"(warmup {WARMUP}); white sub-chain "
          f"{drv.aclength_white} steps; steady {drv.steady_sweeps} sweeps "
          f"in {drv.steady_seconds:.3f} s = {sps:.3f} sweeps/s = "
          f"{sps * C:.1f} samples/s", flush=True)
    print(f"phase 4 CUDA graphs: {len(graphs.graphs)} captured in "
          f"{graphs.capture_seconds:.3f} s, pool "
          f"{graphs.pool_bytes / 1e6:.1f} MB, replays per sweep "
          + json.dumps({"b_mh": len(drv.sweep_blocks(False)),
                        "b_refresh": len(drv.sweep_blocks(True))})
          + "; kernel launches per "
          "replay " + json.dumps({k: {"/".join(f): n for f, n in v.items()}
                                  for k, v in graphs.launches.items() if v}),
          flush=True)
    busy = sum(g.store.seconds.values())
    print(f"phase 4 checkpoints every {SAVE_EVERY} sweeps: saves ran "
          f"{busy:.3f} s on their thread ({busy / drv.steady_seconds:.4f} of "
          f"the {drv.steady_seconds:.3f} s steady wall), by step "
          + json.dumps({k: round(v, 3) for k, v in
                        sorted(g.store.seconds.items())})
          + f"; the sampling loop spent {g.save_seconds:.3f} s on them "
          f"({g.save_seconds / drv.steady_seconds:.4f}); final manifest "
          f"verified {rep['ok']} at {rep['rows']} rows; "
          f"chain {g.chain.shape} + bchain {g.bchain.shape} float64, "
          f"{(g.chain.nbytes + g.bchain.nbytes) / 1e6:.1f} MB", flush=True)
    print("phase 4 per-block ms per steady sweep (CUDA events): "
          + json.dumps(per_block), flush=True)
    print("phase 4 warmup block ms in all (CUDA events): " + json.dumps(
        {k: round(v, 1) for k, v in sorted(drv.warmup_ms.items())}),
        flush=True)
    print(f"phase 4 draw_b_mh acceptance: mean {acc.mean().item():.4f}, "
          f"min over (chain, pulsar) {acc.min().item():.4f}", flush=True)
    print("phase 4 common log10_rho medians per bin: "
          + json.dumps([round(float(v), 3) for v in med]), flush=True)
    print_counts(4, counts)
    print(f"phase 4 non-finite Laplace blocks in warmup and adaptation: "
          f"{int(drv.laplace_nonfinite)} of "
          f"{(WARMUP + 1) * C * cm.P_real}", flush=True)
    sketch_ok = sketch_report("4", g, chain, range(C), sps)
    finite = bool(np.isfinite(chain).all() and np.isfinite(g.bchain).all())
    inside = bool(((med > -10.0) & (med < -4.0)).all())
    saved = rep["ok"] and rep["rows"] == niter and graphs.graphed
    if (not finite or not inside or missing or unreplayed or unaccounted
            or not saved or not sketch_ok):
        print(f"chip_smoke: main path failed (finite={finite}, medians "
              f"inside the prior={inside}, never run={missing}, not "
              f"replayed as captured={unreplayed}, runs other than eager "
              f"launches plus replays={unaccounted}, verified checkpoint "
              f"through the graphs={saved}, sketch={sketch_ok})",
              file=sys.stderr)
        return None
    # phase 18's rho-law gate: per bin, the chains' medians past the burn
    rho_stats = chain_medians(chain, cm, range(C))
    extra["sps4"], extra["rho_stats"] = sps, rho_stats
    # phase 25b's reference: the first rows of this unsharded graphed run
    n25 = WARMUP + 1 + P25_STEADY
    extra["head4"] = (chain[:n25].copy(), g.bchain[:n25].copy())
    if not profile_steady(drv, 16 * (niter // 16 + 1)):
        print("chip_smoke: the device trace disagrees with the kernels' "
              "device counters", file=sys.stderr)
        return None
    ref = (chain, g.bchain)
    del g, drv, graphs
    torch.cuda.empty_cache()
    elapsed("phases 4-5")

    # ---- phases 17-17b: the resilient runtime on the main path ------------
    ok17, runs17 = supervised_path(cm, args.seed, outdir / "supervised",
                                   niter, ref, wall, sps)
    if not ok17:
        return None
    del ref, chain
    if not record_precision_pair(cm, args.seed, outdir / "records"):
        print("chip_smoke: the record-precision pair failed",
              file=sys.stderr)
        return None
    torch.cuda.empty_cache()
    elapsed("phases 17-17b")

    # ---- phases 18-18c: the ensemble array, launch counts from 0 ----------
    ens = ensemble_paths(cm, args.seed, outdir, args.steady, gen, rho_stats,
                         narrow)
    if ens is None:
        return None
    ens_records, runs18 = ens
    torch.cuda.empty_cache()
    elapsed("phases 18-18c")

    # ---- phases 19-19b: the collapsed rho draw, launch counts from 0 ------
    col = collapse_path(cm, args.seed, outdir, COLLAPSE_STEADY, gen,
                        rho_stats, narrow, records)
    if col is None:
        return None
    col_records, runs19 = col
    elapsed("phases 19-19b")

    # ---- phase 7: the single-pulsar path, launch counts from 0 -------------
    wide = [k for k in records if k[1].endswith("_wide")
            and k not in F64_FORMS]
    ok7, runs1 = single_pulsar_path(cm1, args.seed, outdir / "single",
                                    args.steady, wide)
    if not ok7:
        return None
    runs.update({k: runs1[k] for k in wide})
    if not graph_against_eager(cm1, args.seed, outdir / "single_graph_check",
                               "PulsarBlockGibbs", SINGLE_CHAINS, "7b"):
        print("chip_smoke: single-pulsar graph replay differs from the "
              "eager sweep", file=sys.stderr)
        return None
    if not resume_check(cm1, args.seed, outdir / "single_resume",
                        "PulsarBlockGibbs", "7c"):
        print("chip_smoke: the resumed single-pulsar run differs from the "
              "whole one", file=sys.stderr)
        return None
    torch.cuda.empty_cache()
    elapsed("phases 7-7c")

    # ---- phase 21: repeated device errors at one chain, on the card -------
    deg = retry_path(cm1, args.seed, outdir / "retry", gen)
    if deg is None:
        return None
    deg_records, runs21 = deg
    elapsed("phase 21")
    extra["cm1"], extra["wide"] = cm1, wide

    # ---- phases 8-9b: the powerlaw hyper block, launch counts from 0 -------
    wide64 = wide + [("chol_solve_sample", "f64_wide")]
    ok8, runs8, g8 = powerlaw_path("8", cm_r1, "PulsarBlockGibbs",
                                   SINGLE_CHAINS, SIDE_WARMUP, R1_STEADY,
                                   args.seed, outdir / "r1", wide64,
                                   WIDE_GRAPHED, de_gate=True,
                                   red_adapt_iters=SIDE_RED_ADAPT,
                                   white_adapt_iters=SIDE_WHITE_ADAPT)
    if not ok8:
        return None
    runs[("chol_solve_sample", "f64_wide")] = runs8[
        ("chol_solve_sample", "f64_wide")]
    drv8 = g8.driver
    if not graphs_vs_eager(drv8, torch.as_tensor(drv8.x_cur, device=dev),
                           drv8.b.to(dev), R1_GRAPH_CHECK_AT, "8b",
                           "PulsarBlockGibbs, R1, across the DE period "
                           "switch at 512"):
        print("chip_smoke: R1 graph replay differs from the eager sweep",
              file=sys.stderr)
        return None
    del g8, drv8
    torch.cuda.empty_cache()
    if not resume_check(cm_r1, args.seed, outdir / "r1_resume",
                        "PulsarBlockGibbs", "8c", steady=R1_RESUME_STEADY,
                        split=R1_RESUME_SPLIT, de_gate=True,
                        red_adapt_iters=R1_RESUME_ADAPT):
        print("chip_smoke: the resumed R1 run differs from the whole one",
              file=sys.stderr)
        return None
    elapsed("phases 8-8c")
    narrow64 = narrow + [("chol_solve_sample", "f64")]
    ok9, runs9, _ = powerlaw_path("9", cm_r2, "PTABlockGibbs", C, R2_WARMUP,
                                  R2_STEADY, args.seed, outdir / "r2",
                                  narrow64, GRAPHED,
                                  red_adapt_iters=SIDE_RED_ADAPT,
                                  white_adapt_iters=SIDE_WHITE_ADAPT)
    if not ok9:
        return None
    runs[("chol_solve_sample", "f64")] = runs9[("chol_solve_sample", "f64")]
    torch.cuda.empty_cache()
    ok9b, _, _ = powerlaw_path("9b", cm_r3, "PulsarBlockGibbs", SINGLE_CHAINS,
                               R3_WARMUP, R3_STEADY, args.seed, outdir / "r3",
                               wide64, WIDE_GRAPHED,
                               red_adapt_iters=SIDE_RED_ADAPT,
                               white_adapt_iters=SIDE_WHITE_ADAPT)
    if not ok9b:
        return None
    torch.cuda.empty_cache()
    elapsed("phases 9-9b")

    # ---- phases 10-10c: the Hellings-Downs array, launch counts from 0 ------
    ok10, runs10, g10 = hd_path(cm_hd, args.seed, outdir / "hd", HD_STEADY,
                                warmup=HD_WARMUP)
    if not ok10:
        return None
    drv10 = g10.driver
    if not graphs_vs_eager(drv10, torch.as_tensor(drv10.x_cur, device=dev),
                           drv10.b.to(dev), HD_GRAPH_CHECK_AT, "10b",
                           "PTABlockGibbs, Hellings-Downs, across the "
                           "refresh at 304"):
        print("chip_smoke: Hellings-Downs graph replay differs from the "
              "eager sweep", file=sys.stderr)
        return None
    del g10, drv10
    torch.cuda.empty_cache()
    if not resume_check(cm_hd, args.seed, outdir / "hd_resume",
                        "PTABlockGibbs", "10c", warmup=HD_RESUME_WARMUP,
                        steady=HD_RESUME_STEADY):
        print("chip_smoke: the resumed Hellings-Downs run differs from the "
              "whole one", file=sys.stderr)
        return None
    torch.cuda.empty_cache()
    elapsed("phases 10-10c")

    # ---- phases 11-12c: the standard noise model, launch counts from 0 -----
    ok11, runs11, g11 = powerlaw_path("11", cm_n11, "PTABlockGibbs", C,
                                      WARMUP, args.steady, args.seed,
                                      outdir / "n11", narrow64, GRAPHED,
                                      no_white=True,
                                      red_adapt_iters=SIDE_RED_ADAPT)
    if not ok11:
        return None
    drv11 = g11.driver
    if not graphs_vs_eager(drv11, torch.as_tensor(drv11.x_cur, device=dev),
                           drv11.b.to(dev), N11_GRAPH_CHECK_AT, "11b",
                           "PTABlockGibbs, standard noise model, across the "
                           "refresh at 304"):
        print("chip_smoke: the standard noise model's graph replay differs "
              "from the eager sweep", file=sys.stderr)
        return None
    del g11, drv11
    torch.cuda.empty_cache()
    if not resume_check(cm_n11, args.seed, outdir / "n11_resume",
                        "PTABlockGibbs", "11c", warmup=SIDE_RESUME_WARMUP,
                        steady=SIDE_RESUME_STEADY):
        print("chip_smoke: the resumed standard-noise array run differs "
              "from the whole one", file=sys.stderr)
        return None
    elapsed("phases 11-11c")
    ok12, runs12, _ = powerlaw_path("12", cm_n12, "PulsarBlockGibbs",
                                    SINGLE_CHAINS, SIDE_WARMUP, N12_STEADY,
                                    args.seed, outdir / "n12", wide64,
                                    WIDE_GRAPHED, de_gate=True,
                                    no_white=True,
                                    red_adapt_iters=SIDE_RED_ADAPT)
    if not ok12:
        return None
    torch.cuda.empty_cache()
    if not resume_check(cm_n12, args.seed, outdir / "n12_resume",
                        "PulsarBlockGibbs", "12c", warmup=SIDE_RESUME_WARMUP,
                        steady=SIDE_RESUME_STEADY):
        print("chip_smoke: the resumed NANOGrav single-pulsar run differs "
              "from the whole one", file=sys.stderr)
        return None
    elapsed("phases 12-12c")
    noise_runs = {"11": runs11, "12": runs12}
    noise_models = {"11": cm_n11, "12": cm_n12}
    timed = {k: r for k, r in {**records, **rec_f64}.items()
             if not k[1].endswith("_wide")}
    return [
        dict(name=f"{k}[{f}]", route="cuda", source=SOURCES[k][
            f.endswith("_wide")], replaces=REPLACES[k],
             launches=runs[(k, f)], **r)
        for (k, f), r in records.items()] + [
        dict(name=f"{k}[{f}] (phase 17 path: supervised run with faults, "
             f"order {cm.Bmax})", route="cuda", source=SOURCES[k][0],
             replaces=REPLACES[k], launches=runs17[(k, f)], **r)
        for (k, f), r in records.items()
        if (k, f) in narrow and runs17[(k, f)]] + [
        dict(name=f"{k}[{f}] (phase 18 path: ensemble, tempered state "
             f"beta = betas[1], order {cm.Bmax})", route="cuda",
             source=SOURCES[k][0], replaces=REPLACES[k],
             launches=runs18[(k, f)], **r)
        for (k, f), r in ens_records.items()] + [
        dict(name=f"{k}[{f}] (phase 19 path: the collapsed rho draw, "
             f"order {cm.Bmax})", route="cuda", source=SOURCES[k][0],
             replaces=REPLACES[k], launches=runs19[(k, f)], **r)
        for (k, f), r in col_records.items()] + [
        dict(name=f"{k}[{f}] (phase 21 path: one chain through three device errors, "
             f"order {cm1.Bmax})", route="cuda", source=SOURCES[k][1],
             replaces=REPLACES[k], launches=runs21[(k, f)], **r)
        for (k, f), r in deg_records.items()] + [
        dict(name=f"{k}[{f}] (Hellings-Downs path, B1 {cm_hd.Bmax + 1})",
             route="cuda", source=SOURCES[k][0], replaces=REPLACES[k],
             launches=runs10[(k, f)], **r)
        for (k, f), r in hd_records.items()] + [
        dict(name=f"{k}[{f}] (phase {nm} path, order "
             f"{noise_models[nm].Bmax})", route="cuda",
             source=SOURCES[k][f.endswith("_wide")], replaces=REPLACES[k],
             launches=noise_runs[nm][(k, f)], **r)
        for nm, recs in noise_records.items()
        for (k, f), r in recs.items()], timed, hd_records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--outdir", default="build/chip_smoke")
    ap.add_argument("--steady", type=int, default=STEADY)
    ap.add_argument("--oracle-child", metavar="DIR",
                    help="run phase 20's oracle into DIR (the script "
                    "starts this process itself)")
    args = ap.parse_args(argv)
    if args.oracle_child:
        return oracle_child(args.oracle_child, args.seed)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import pulsar_timing_gibbsspec_torch.ops.kernels.build  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run it "
              "from the repository root", file=sys.stderr)
        return 2

    oracle = start_oracle(Path(args.outdir) / "oracle", args.seed)
    try:
        return _run(args, oracle)
    finally:
        if oracle[0].poll() is None:
            oracle[0].kill()
            oracle[0].wait()
        oracle[1].close()


def _run(args, oracle):
    """The card phases of :func:`main`, the oracle child running."""
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import (load_pulsar,
                                                    synthetic_array)
    from pulsar_timing_gibbsspec_torch.ops.kernels import build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    global _RUN_START
    _RUN_START = t0
    build.library(verbose=True)
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s", flush=True)
    usage = resource_usage(build.BUILD_DIR / "ptg_torch_kernels.so")

    dev = torch.device(DEVICE)
    C = NCHAINS
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    psrs = synthetic_array(npsr=45, seed=args.seed)
    outdir = Path(args.outdir)

    # README's Quick start from par/tim with kernel ECORR (phase 13), the
    # t-process array (phase 14) and the infinitepower array (14d)
    par, tim = write_quickstart_partim(outdir / "partim")
    qs = load_pulsar(par, tim, inject=QS_INJECT)
    ke_opts = dict(red_var=False, white_vary=True, common_psd="spectrum",
                   common_components=SINGLE_BINS, kernel_ecorr=True)
    cm_ke = ptt.model_general([qs], device=dev, **ke_opts)
    cm_ke_cpu = ptt.model_general([qs], device="cpu", **ke_opts)
    print(f"phase 13 model from {par.name} / {tim.name}: {cm_ke.pulsars[0]} "
          f"P={cm_ke.P} Nmax={cm_ke.Nmax} Bmax={cm_ke.Bmax} nx={cm_ke.nx}, "
          f"{qs.Mmat.shape[1]} timing columns, backends {qs.backends()}, "
          f"{cm_ke.ke_par_ix.shape[1]} ECORR epochs in N, "
          f"{SINGLE_CHAINS} chains", flush=True)
    tp_opts = dict(tm_svd=True, white_vary=True, common_psd="spectrum",
                   common_components=TP_BINS, red_components=TP_BINS,
                   device=dev)
    cm_tp = ptt.model_general(psrs, red_psd="tprocess", **tp_opts)
    cm_ip = ptt.model_general(psrs, red_psd="infinitepower", **tp_opts)
    for nm, m in (("14", cm_tp), ("14d", cm_ip)):
        print(f"phase {nm} model: P={m.P} Nmax={m.Nmax} Bmax={m.Bmax} "
              f"nx={m.nx}, common {m.gw_kind} ({m.K}), red {m.red_kind} "
              f"({m.Kr}), {len(m.idx.red)} powerlaw hypers", flush=True)
    # phase 14's shapes are phase 4's (and R2's for the float64 factor):
    # held here at the t-process state, timed in those rows
    ke_records, ok_ke = gram_parity(
        cm_ke, parity_state(cm_ke, SINGLE_CHAINS, gen), time_ms,
        forms=("widen_f64",))
    xt = parity_state(cm_tp, C, gen)
    tp_records, ok_tp = gram_parity(cm_tp, xt, None)
    for rec, good in (chol_parity(cm_tp, xt, gen, None),
                      chol64_parity(cm_tp, xt, None)):
        tp_records.update(rec)
        ok_tp &= good
    del xt
    torch.cuda.empty_cache()
    if not (ok_ke and ok_tp):
        print("chip_smoke: kernel parity at phases 13-14's shapes failed",
              file=sys.stderr)
        return 1
    elapsed("phase 2 (phases 13-14's kernel parity)")

    extra = {}
    earlier = earlier_paths(args, psrs, gen, outdir, extra)
    if earlier is None:
        return 1
    rows, timed, hd_rec = earlier
    for key, rec in tp_records.items():
        rec.update({m: v for m, v in timed[key].items()
                    if m != "max_abs_err"})
    torch.cuda.empty_cache()

    # ---- phases 13-13c: the Quick start from par/tim, kernel ECORR ---------
    if not ke_woodbury_agreement(cm_ke, cm_ke_cpu, args.seed):
        print("chip_smoke: the kernel-ECORR Gram differs between the card "
              "and the CPU", file=sys.stderr)
        return 1
    del cm_ke_cpu
    ok13, runs13, g13 = ke_path(cm_ke, args.seed, outdir / "ke", KE_STEADY)
    if not ok13:
        return 1
    drv13 = g13.driver
    if not graphs_vs_eager(drv13, torch.as_tensor(drv13.x_cur, device=dev),
                           drv13.b.to(dev), SIDE_WARMUP + 1 + KE_STEADY,
                           "13b",
                           "PulsarBlockGibbs, kernel ECORR, the exact "
                           "b-draw every sweep"):
        print("chip_smoke: the kernel-ECORR graph replay differs from the "
              "eager sweep", file=sys.stderr)
        return 1
    del g13, drv13
    torch.cuda.empty_cache()
    if not resume_check(cm_ke, args.seed, outdir / "ke_resume",
                        "PulsarBlockGibbs", "13c", warmup=SIDE_RESUME_WARMUP,
                        steady=SIDE_RESUME_STEADY, ecorrsample="kernel"):
        print("chip_smoke: the resumed kernel-ECORR run differs from the "
              "whole one", file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    elapsed("phases 13-13c")

    # ---- phases 14-14d: the t-process array, launch counts from 0 ----------
    tp_forms = list(tp_records)
    ok14, runs14, g14 = powerlaw_path(
        "14", cm_tp, "PTABlockGibbs", C, SIDE_WARMUP, TP_STEADY, args.seed,
        outdir / "tp", tp_forms, GRAPHED, de_gate=True,
        red_adapt_iters=SIDE_RED_ADAPT,
        white_adapt_iters=SIDE_WHITE_ADAPT)
    ok14 &= tprocess_gates(cm_tp, g14, SIDE_WARMUP)
    if not ok14:
        print("chip_smoke: the t-process path failed", file=sys.stderr)
        return 1
    drv14 = g14.driver
    if not graphs_vs_eager(drv14, torch.as_tensor(drv14.x_cur, device=dev),
                           drv14.b.to(dev), TP_GRAPH_CHECK_AT, "14b",
                           "PTABlockGibbs, t-process, across the refresh "
                           "at 400"):
        print("chip_smoke: the t-process graph replay differs from the "
              "eager sweep", file=sys.stderr)
        return 1
    del g14, drv14
    torch.cuda.empty_cache()
    if not resume_check(cm_tp, args.seed, outdir / "tp_resume",
                        "PTABlockGibbs", "14c", warmup=SIDE_RESUME_WARMUP,
                        steady=SIDE_RESUME_STEADY):
        print("chip_smoke: the resumed t-process run differs from the "
              "whole one", file=sys.stderr)
        return 1
    if not infinitepower_check(cm_ip, args.seed, outdir / "ip"):
        print("chip_smoke: the infinitepower array failed", file=sys.stderr)
        return 1
    elapsed("phases 14-14d")

    # ---- phases 15-15d: the frequency-grid and selection options ----------
    rows15 = grid_paths(args, psrs, gen, outdir)
    if rows15 is None:
        return 1

    # ---- phases 16-16d: sampled ORF weights, the alternative HD draws ------
    rows16 = orf_paths(args, psrs, gen, outdir, hd_rec)
    if rows16 is None:
        return 1

    # ---- phases 20a-20b: the card's chains for phase 20, counts from 0 ----
    cm1 = extra["cm1"]
    ok20, chain20, rows20 = oracle_card_path(
        cm1, args.seed, outdir / "oracle_card", extra["wide"], gen)
    if not ok20:
        return 1
    elapsed("phases 20a-20b")

    # ---- phase 20: the card's Quick-start posterior against the oracle ----
    if not oracle_compare(*oracle, Path(args.outdir) / "oracle", chain20,
                          cm1, extra["sps4"]):
        return 1
    elapsed("phase 20")

    # ---- phases 22-22c: the tenant-multiplexed service, counts from 0 ------
    ok22, rows22, ctx22 = serve_path(args.seed, outdir / "serve")
    if not ok22:
        return 1
    elapsed("phases 22-22c")

    # ---- phase 23: the serving guards and perf=True, counts from 0 --------
    ok23, rows23 = guards_path(outdir / "guards", ctx22)
    del ctx22
    if not ok23:
        return 1
    elapsed("phase 23")

    # ---- phases 24-24c: the precision settings, counts from 0 -------------
    rows24 = precision_paths(args, psrs, gen, outdir, extra["rho_stats"])
    if rows24 is None:
        return 1

    # ---- phases 25-25c: the array sharded over ranks, counts from 0 -----
    rows25 = mesh_paths(args, psrs, extra.pop("head4"), outdir)
    if rows25 is None:
        return 1
    rows += [
        dict(name=f"{k}[{f}] (phase 13 path: kernel ECORR, B1 "
             f"{cm_ke.Bmax + 1})", route="cuda", source=SOURCES[k][1],
             replaces=REPLACES[k], launches=runs13[(k, f)], **r)
        for (k, f), r in ke_records.items()] + [
        dict(name=f"{k}[{f}] (phase 14 path: t-process, order "
             f"{cm_tp.Bmax})", route="cuda",
             source=SOURCES[k][f.endswith("_wide")], replaces=REPLACES[k],
             launches=runs14[(k, f)], **r)
        for (k, f), r in tp_records.items()] + (rows15 + rows16 + rows20
                                                 + rows22 + rows23 + rows24
                                                 + rows25)

    print("phase 1 kernel resources (cuobjdump -res-usage: registers, "
          "stack frame bytes, static shared memory bytes): " + (json.dumps(
              {n: [r, st, sh] for n, r, st, sh in usage})
              if usage else "not available"), flush=True)
    B1 = extra["cm1"].Bmax + 1
    for bt in (1, SINGLE_CHAINS, WIDE_CONFIG_SYSTEMS):
        print(f"phase 1 wide forms' launch configuration at {bt} systems "
              f"of B1 {B1} (ptg_wide_config; dynamic shared memory is not "
              "in cuobjdump's static count): "
              + json.dumps(wide_configs(build.library(), bt, B1)),
              flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
