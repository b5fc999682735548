#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only kernels   # device, build and kernels
    python3 chip_smoke.py --only federated # device, build, nuts, federated
    python3 chip_smoke.py --only models    # device, build, radon, logistic, lv_ode
    python3 chip_smoke.py --only samplers  # device, build, nuts, wide_logistic,
                                           # logistic, chees
    python3 chip_smoke.py --only slice6    # device, build, lgssm, gp, tempering
    python3 chip_smoke.py --only slice7    # device, build, families, model_check
    python3 chip_smoke.py --only slice8    # device, build, nuts, federated, pool
    python3 chip_smoke.py --only slice9    # device, build, gateway
    python3 chip_smoke.py --only slice10   # device, build, nuts, vi, particles,
                                           # sgld, sbc, checkpoint, demos
    python3 chip_smoke.py --only slice11   # device, build, nuts_large, optim, mesh
    python3 chip_smoke.py --only slice12   # device, build, nuts_large, multichain, seq
    python3 chip_smoke.py --only slice12 --multichain-seeds 21,22,23,24,25
                                           # the same, the multichain NUTS on 5 seeds
    python3 chip_smoke.py --only slice13   # device, build, nuts_large, zero,
                                           # parallel_axes, multihost, elastic
    python3 chip_smoke.py --only slice14   # device, build, fed
    python3 chip_smoke.py --only slice15   # device, build, ppl, ppl_zero
    python3 chip_smoke.py --only slice16   # device, build, linalg
    python3 chip_smoke.py --only slice17   # device, build, bridge

Run from the root of a checkout on a machine with an NVIDIA H100, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA.  With no arguments
it runs every phase and needs one card.  Phases, one JSON line each:

1. ``device``  — the card's name and power limit (``nvidia-smi``), the
   peak memory and float32 rates the bounds use, the TF32 settings.
2. ``build``   — every CUDA source of the port built by ``nvcc``, all
   started together, and timed; the ``ptxas -v`` report.
3. ``kernels`` — the kernel against its plain PyTorch version run in
   float64 on the same inputs, at every shape the tests and the main
   path use and at two realistic sizes; padding inertness; bitwise
   identical reruns, and the same bits from a grid capped to a few
   blocks; calls on two streams; CUDA launches per call (profiler);
   times (CUDA events, median; and the kernel's own duration from the
   profiler) beside the bound.  Then the chain axis: C in {1, 4, 16, 64}
   parameter sets against the same data at 8 x 64 and 8 x 131,072, each
   chain against the float64 plain version; each chain's bits in the
   batch equal to the chain called alone (C = 1: to the unbatched call);
   bitwise reruns and capped grids; one launch per call; times beside
   the bound.
4. ``autograd`` — value and gradient of ``prior + data_logp(kernel)`` at
   the flagship size against plain autograd and the sufficient-statistic
   form, at the origin and at a perturbed point; double backward raises.
5. ``nuts``    — ``sample()`` with NUTS on the flagship posterior through
   the kernel, 4 chains x 250 warmup + 250 draws in lockstep: every
   leaf is one batched evaluation of the four chains, replayed from a
   CUDA graph (``cuda_graph=True``).  A replay never reaches the kernel
   wrapper's host-side launch counter, so after the run the phase takes
   the run's own graph (``extra["graph"]``), holds its replays bit for
   bit against eager calls at 8 states, times 50 eager calls and 50
   replays, and counts the kernel nodes of the captured graph itself
   (the CUDA driver API's ``cuGraphGetNodes``): it must hold exactly one
   of the linreg kernel, one launch per replay.  The phase's launches
   are that count times the run's replays, plus the graph's eager
   warm-up calls.
6. ``nuts_large`` — the same at 8 x 131,072 observations, so the kernel
   moves real bytes on every leapfrog step: 1 chain x 300 warmup + 300
   draws with a dense mass matrix.  At this size the data pin every
   shard's intercept + offset to ~0.0014 while only the offsets' prior
   places the intercept (sd ~0.1): a ridge ~70x longer than it is wide.
   With a diagonal mass, the split R-hat of the intercept and offsets
   lands above 1.05 for many seeds (as with the JAX package's sampler on
   this posterior); a dense mass adapted over the warmup straightens the
   ridge.  Even then the draws move slowly along it: with 300 draws the
   split R-hat of the intercept and offsets varies around 1.05 from one
   trajectory to the next (a change in the last bits of a sum is enough
   to move it across; with 600 + 600 it read 1.011, with 900 draws
   1.029 on an H100).  The run was 600 + 600 until the families and
   model_check phases needed its time; PERF.md records each run's
   R-hat.  Replayed from a CUDA graph and gated as ``nuts``.
7. ``federated`` — the federation wire.  The kernel is built above,
   before any node starts.  Four node processes (forked from the fork
   server, ``_node_context``) each rebuild shards {2i, 2i+1} of the
   flagship data from its seed, on the card,
   and serve their logp+grad through the kernel with ``serve_tcp_once``,
   one port per size.  A driver on the CPU fans out to them with
   ``ParallelLogpGrad`` and adds the prior.  It checks the remote value
   and gradient against the in-process ones on the card at 8 x 131,072
   (three points, the autograd phase's tolerance); times a remote
   evaluation (median of 50) at 8 x 64 and 8 x 131,072, fanned out and
   with the nodes called in turn; splits one request's time into wire
   and node from the spans the nodes ship back (spans on for that short
   run only); and runs NUTS over the wire at 8 x 64, 1 chain x 150
   warmup + 150 draws, whose means must also lie within 4 combined MCSEs
   of the nuts phase's; its requests and replies are recorded for the
   pool phase.  Each node reports its GPU and as many kernel launches as
   requests.
8. ``pool`` — the replica pool and the colocated lanes.  Eight node
   processes (forked from the fork server), two replicas per group of
   shards {2g, 2g+1}:
   groups 0-1 serve one replica over shm (``serve_shm``) and one over
   ring (``serve_ring``), groups 2-3 one over shm and one over TCP; each
   node serves ``device_compute_fn(..., batched=True)`` over the kernel
   and runs the HTTP exporter.  The driver (on the CPU) holds one
   ``NodePool`` per group (p2c, a running probe thread) behind a
   ``PooledArraysClient``, fanned out by ``ParallelLogpGrad``.  The NUTS
   run is the federated phase's: its first 75% of evaluations (the
   warmup and the first draws) are answered from the federated phase's
   record of every group's requests and replies, each request held bit
   for bit to the recorded one, and the rest go through the pools.  Gates: the federated
   phase's values at 8 x 131,072 and its NUTS draws (its sha256), bit
   for bit, while group 0's shm replica is SIGKILLed a third of the way
   into the pooled evaluations and restarted on its ports; exactly one
   reply per pooled request; that replica's breaker open, then closed; every
   replica served before the kill; split R-hat < 1.05; windows of W in
   {4, 16, 64} requests through ``evaluate_many`` equal to each request
   alone, bit for bit, with kernel launches equal to the windows each
   node ran and no fallback; ``MicroBatcher`` over the kernel in the
   driver, 64 requests at once, one launch per window, bit for bit;
   a ``FleetCollector`` over the eight exporters whose merged request
   count equals the nodes' own; a watchdog bundle with a ``fleet``
   section; and no ``pftpu-arena-*`` file left once the nodes stop.
   Also printed: ``df`` of the arena directory and the arena size,
   ``os.cpu_count()``, the futex shim and the ring syscall counts, the
   critical path of a short traced run and an SLO burn verdict.
9. ``gateway`` — the gateway tier.  Two node processes (forked from the
   fork server) on the card, each serving all 8 shards of the flagship at 8 x 131,072
   through the kernel (``device_compute_fn(..., batched=True)``,
   ``max_batch=64``) with ``serve_tcp_once``, behind a ``NodePool(
   transport="tcp")`` (round robin, a probe thread) and a
   ``GatewayThread`` with a per-tenant quota of 384 requests/s (burst
   64).  Downstream, 128 connections write pipelined npwire frames,
   each stamped with one of 4 tenants, evenly over 4 s: 4,096 requests
   over 256 seeded parameter sets, half of them from a hog tenant (512/s
   offered), the rest from three mice at equal weights (~171/s each),
   plus 64 frames whose deadline is already spent.  Node A is SIGKILLed
   a third of the way in and restarted on its port.  The hog's denied
   requests are then retried at 256/s until answered.  Then an
   ``Autoscaler`` over the gateway's signals: bursts of unpaced requests
   from 32 tenants fill the fair queue, its spawn callback starts node C
   on the card, C takes a share of 512 more requests, and the scaler
   drains it on stop.  Gates: every reply that is not an error equal,
   bit for bit, to its parameter set sent alone to a node through
   ``TcpArraysClient``; each node's windows equal the windows the
   gateway had answered by it (the one window in flight on A when it
   was killed aside), one kernel launch each, and the gateway's window
   histogram counts each answered or failed window once, more than one
   request per window on average; every denial
   names the hog, carries ``OVERLOAD_ERROR_PREFIX`` and is answered when
   retried, and no mouse is denied; the 64 expired frames are shed at the
   gateway (``pftpu_gateway_shed_total{reason="expired_arrival"}`` grows
   by 64) and no node computes them; no reply hangs, and the restarted
   A serves windows; C scales up, serves windows and is drained.  Also
   printed: requests/s, requests and ms per window, p50/p99 latency per
   tenant, failed upstream attempts, in-band errors, the card's name and
   power limit, and the drive's stalls (write lateness per tenant, both
   event loops' lag, the garbage collector's pauses; the script's heap
   is frozen out of the collector for the phase, and each mouse
   denial's reason is kept).
10. ``radon`` — BASELINE.json config 3 (the hierarchical radon GLM, 16
   county shards) on the card: value and gradient at three points against
   the same model in float64 on the CPU; ms per logp+grad evaluation
   (median of 50); NUTS, 1 chain x 300 warmup + 200 draws, its
   evaluation replayed from a CUDA graph (``cuda_graph=True``: the eager
   run's draws, bit for bit, without its host dispatch), with finite
   draws, divergence share < 0.1, |median beta - truth| < 0.3 (the JAX
   package's test gate) and split R-hat < 1.1.
11. ``logistic`` — config 5 (64 shards x 64 observations x 8 features):
   the vmapped, sufficient-statistic and flattened forms behind
   bench_suite's equality gate; the vmapped form, its bf16 compute dtype
   and the hierarchical model against float64 on the CPU; ms per
   evaluation of each form at 64 x 64 x 8 and 64 x 16,384 x 8; then
   config 8 (bench_suite.py:982): NUTS on the vmapped form, 4 chains x
   200 warmup + 200 draws in lockstep, jitter 0.1, one run (bench_suite's
   cold run is an XLA compile, which the port does not have); samples/s
   and min-ESS/s; every
   w and b within 4 sd of the generating values, split R-hat < 1.1
   (and bench_suite's < 1.2).
12. ``lv_ode`` — config 4 (Lotka-Volterra, 8 shards, 128 RK4 steps):
   values against float64 on the CPU; ms (median of 20) and CUDA
   launches (profiler) per logp+grad evaluation; ``find_map`` for 25
   steps on the card against 25 steps in float64 on the CPU.  No NUTS:
   an evaluation is launch-bound at tens of ms.
13. ``wide_logistic`` — config 7 (bench_suite.py:878): the logistic
   regression at 8 shards x 4,096 observations x 512 features (X is 64
   MiB), 64 chains at init + 0.01 N(0, 1), one batched value+grad per
   form (float32 with TF32 off, bf16 compute dtype, float32_strict),
   each chain's value and gradient against the strict form at
   bench_suite's gates; ms per batched evaluation and its share of the
   matching dense peak.
14. ``chees`` — config 9 (bench_suite.py:1050): ChEES-HMC on config 5's
   posterior, 16 chains x 200 warmup + 200 draws, jitter 0.1;
   min-ESS/s against config 8's NUTS of the same run, leapfrog
   gradients/s, the adapted step size and trajectory length; split
   R-hat < 1.2 and finite draws.
15. ``lgssm`` — config 6 (bench_suite.py:814): the linear-Gaussian
   state-space model at T = 4,096 (seed 7, d = 2, k = 1): logp+grad of
   the sequential Kalman filter and of the parallel-in-time one (an
   associative scan), float32 with TF32 off; each against the other and
   against its float64 version on the CPU (value rtol 1e-4; gradient
   rtol 1e-3, atol 1e-4: the JAX tests' tolerances), the parallel
   smoother against the sequential one at T = 512; ms per evaluation of
   each form (the sequential one from one call at T / 4 after its gate
   call, times 4: it is launch-bound, linear in T, ~11 s a call at T),
   their ratio, CUDA launches and FLOPs per evaluation
   (the sequential form's counted at T = 32 and 64 and extrapolated:
   linear in T).
16. ``gp`` — config 10 (bench_suite.py:1125): the federated exact GP at 8
   shards x 256 points against float64 on the CPU (value rtol 1e-4,
   gradient 1e-3 |g| + 1e-4 max|g|), one warm evaluation under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); ms, FLOPs
   per evaluation and FLOP/s as a share of the float32 peaks, and the
   rate bench_suite's 5% MFU pass line would need (recorded, not
   gated); the sparse GP with 32 inducing points against float64 (value
   within 1e-4 |logp| + 1e-5 n: a sum of O(n) terms that crosses zero)
   and its ms.
17. ``tempering`` — config 12 (bench_suite.py:1435): parallel tempering
   on a 16-sigma bimodal in 8 dimensions, 2 stacks x 8 temperatures, 500
   warmup + 1,000 draws, against NUTS with 4 chains and jitter 5 at the
   lengths of 125 warmup + 250 draws; each timed run replays its
   evaluation from a CUDA graph (the eager run's draws), once after a
   20-iteration eager warm-up run; wall, rank-normalized min-ESS/s, max
   R-hat, per-chain mode-balance error, batched evaluations and CUDA
   launches per iteration; gates PT balance < 0.3 (the mean over 32 more
   runs in one graphed batch) and the NUTS control's > 0.35
   (bench_suite.py:1555-1558).

18. ``families`` — every GLM family of the port at config 5's shard
   layout, 64 shards x 64 observations x 8 features (bench_suite.py:750):
   Poisson, NB2, ZIP, ZINB, Student-t, Gamma, ordinal (5 categories),
   softmax (4 classes; raw and sufficient-statistic forms), hierarchical
   softmax and Weibull AFT, each from its own generator, and the Gaussian
   mixture (3 components) at 64 shards x 128: value and gradient at three
   points against the same model in float64 on the CPU (where float32
   itself misses the tolerance at a point, within twice the error of the
   model in float32 on the CPU there); ms (median of 30) and CUDA
   launches per logp+grad; the softmax forms behind bench.py's equality
   gate.
19. ``model_check`` — the JAX package's count-family comparison
   (tests/test_model_comparison.py:92) at width 8:
   ``generate_zi_count_data(16, n_obs=256, n_features=8, pi=0.35,
   seed=5)``; Poisson, NB2, ZIP and ZINB each fit by NUTS, 4 chains x 150
   warmup + 150 draws in lockstep; pointwise log-likelihoods (padding
   dropped), PSIS-LOO, WAIC and ``compare``; the top family's posterior
   predictive from 200 draws, its simulated share of zeros beside the
   observed one; the Laplace approximation of ZINB beside its NUTS
   posterior.  Gates: split R-hat < 1.05 on ZIP's and ZINB's slopes and
   own parameters and < 1.2 on their intercept hierarchy (see
   ``RHAT_HIERARCHY``); a zero-inflated family ranks first; Poisson's
   ``d_elpd`` beyond 2 of its ``d_se``; the observed share of zeros
   inside the predictive's central 90%; finite draws.

20. ``vi`` — mean-field and full-rank ADVI, the RealNVP flow, Pathfinder
   and multi-path Pathfinder on the flagship posterior through the kernel
   (the Monte Carlo draws of a step are one batched evaluation, one
   launch; Pathfinder's paths step in lockstep and the ELBO draws of every
   point of every path are one launch).  The ADVI fits start from the MAP;
   the flow fits the posterior whitened by the mean-field fit.  Each fit's
   draws against the nuts phase's posterior (mean within 0.5 posterior
   sd + 4 MCSE, sd within a factor 2; mean-field: the intercept's sd not
   gated), and its first steps in float32 on the card against float64 on
   the CPU with the same noise; launches equal batched evaluations.
21. ``particles`` — tempered SMC (2,048 particles, C = 2,048) and the
   ensemble sampler (64 walkers, C = 32) on the flagship through the
   kernel from the MAP: means within 4 combined Monte Carlo standard
   errors of the nuts phase's, SMC's final temperature 1, launches equal
   batched evaluations; SMC's stages and host syncs.
22. ``sgld`` — SGLD, pSGLD and SGHMC on the JAX tests' Gaussian targets at
   their gates, on the pooled draws of independent chains run as one (4,
   4 and 8 chains at a quarter of the JAX tests' draws), and
   shard-subsampled SGLD on the flagship
   (``logp_and_grad_minibatch`` over 4 of 8 shards) from the MAP, its
   slope within 2 posterior sd of the nuts phase's.
23. ``sbc`` — simulation-based calibration of NUTS on the JAX tests'
   conjugate normal model, 32 simulations in one lockstep batch: the
   uniformity screen passes, and the negative control's U-shaped ranks
   fail it.
24. ``checkpoint`` — ``sample_checkpointed`` on the flagship through the
   kernel, 1 chain x (50 + 75) in chunks of 25: a run interrupted after
   chunk 2 and resumed gives an uninterrupted run's draws bit for bit; a
   changed config restarts from chunk 0.
25. ``demos`` — ``run_node_pool`` in a child process starts three gRPC
   demo nodes on the card; while they start, ``run_local(draws=50)`` on
   the card recovers the slope through the kernel; ``run_remote(draws=
   200)`` recovers the slope over the nodes; SIGTERM to the pool's
   manager takes every node process and port away within 10 s.
26. ``optim`` — the sharded optimizer over the pool.  Four owner node
   processes (forked from the fork server; two over shm, two over TCP) each hold the
   flagship's 8 shards at 8 x 131,072 on the card and answer every
   versioned update request with the full gradient of the negative
   posterior through the kernel (one launch), Adam on their shard of the
   11 parameters and a checkpoint in a shared ``ShardStore`` before the
   reply.  A ``ShardedOptimizer`` with 4 shards over a ``NodePool`` takes
   200 Adam steps at lr 0.05; the owner of shard 0 is SIGKILLed after
   step 100 and its shard rebinds to a live replica, which restores it
   from the store.  Then a fresh run of 50 steps puts the 4 shards on 2
   replicas (two per replica, serialized on its client), over a second
   store.  Gates: the final parameters of each run equal, bit for bit,
   Adam on the whole gradient through the kernel on the card (the
   driver-centric control); per shard the driver's version, the store's
   version and Adam's step count equal the accepted steps; at most 3
   elements per reply; on every node kernel launches equal update
   requests; a gRPC replica is refused at bind.
27. ``mesh`` — the flagship at 8 x 131,072 over a 4-slot mesh of the
   one card (``make_mesh({"shards": 4}, devices=[cuda:0] * 4)``), on the
   plain per-shard path as the JAX package's mesh model runs it: value
   and gradient at three points against float64 on the CPU and against
   ``mesh=None`` (value rtol 1e-5, gradient 1e-4 |g| + 1e-5 max|g|), a
   rerun's bits, ``per_shard_logps``, ``sharded_compute(mesh=)`` and the
   minibatch estimator with fixed per-slot indices; the JAX package's
   error strings for a mesh that does not divide; ``find_map`` (30 steps)
   against float64 on the CPU; NUTS 1 x (100 + 100) with a dense mass,
   its evaluations replayed from a CUDA graph and counted by
   ``instrument_logp``, its means within 4 combined MCSEs of
   ``nuts_large``'s; ``get_load`` and ``healthy_devices``.  The four slots
   run one after another on the card's stream: the phase shows the
   partition, the per-slot work and the cross-slot sum, not concurrency
   across cards.
28. ``multichain`` — ``multichain_sample`` on the flagship at 8 x 131,072
   over a ``{"chains": 2, "shards": 2}`` mesh of the card, 2 chains x
   (100 + 100) of NUTS with a dense mass, its evaluations replayed from a
   CUDA graph, from the generating parameters with trees up to depth 8:
   each chain's value and gradient against the unsharded model on the
   card and against float64 on the CPU; split R-hat across the chains
   < 1.05 of what the data identify (slope, log_sigma, each shard's
   intercept + offset; the raw parameters' recorded); means within 4
   combined MCSEs of ``nuts_large``'s (``--multichain-seeds`` gates more
   seeds the same way); the run's own graph launches the kernel as an
   eager call does (its kernel nodes, as in ``nuts``; none here: the
   per-shard function is the plain path); a short run twice on one
   generator, bit for bit.  Then
   ``sample(chain_sharding=...)`` (4 chains over ``{"chains": 2}``,
   graphed, through the kernel: two launches per replay of the run's
   own graph, one per block, by its kernel nodes)
   and ``chees_sample(chain_sharding=...)`` (8 chains, eager, through the
   kernel) at 8 x 64, and ``pt_sample(temp_sharding=...)`` on the
   tempering phase's bimodal (8 rungs over ``{"temps": 8}``), each against
   the same run unsharded: the same bits, or means within 4 combined
   MCSEs where the bits differ.
29. ``seq`` — ``SeqShardedLGSSM`` at config 6's size (T = 4,096, d = 2,
   k = 1) over ``{"seq": 4}`` of the card, with no mask and with ~30% of
   the steps missing (t = 1 among them): logp and gradient against
   ``kalman_logp_parallel``, smoothed moments against
   ``kalman_smoother_parallel``, the forecast against
   ``kalman_forecast``, each on the card and in float64 on the CPU (the
   lgssm phase's tolerances); 64 simulation-smoother draws against the
   smoothed moments; ms and CUDA launches per logp+grad with and without
   the mesh; ``SeqShardedAR1`` at T = 4,096 against itself without the
   mesh and against float64; ``ring_attention`` at (4,096, 64), causal
   and not, and ``ring_all_pairs_sum`` against dense float64 on the CPU.
   Both phases show the partition and the cross-slot work on one card,
   not concurrency across cards.
30. ``zero`` — ``ZeroShardedLogpGrad`` on ``{"shards": 4}`` of the card:
   the flagship's data term at 8 x 131,072 through the kernel (the
   kernel's shard vmap rule: one launch per slot and evaluation) and
   config 7's wide logistic (8 x 4,096 x 512; the flat vector's 513
   entries pad to 516).  Gates: the scattered gradient's value equals
   ``FederatedLogp(mesh=same)``'s bit for bit and its gradient at float32
   rounding, and both hold against float64 on the CPU (the model gates'
   tolerances); each slice lies on its slot's device; 50 ``sgd_steps``
   and 50 ``adam_steps`` match the same loops on the replicated gradient;
   kernel launches per step equal the slot count.  ms per step, sharded
   and replicated.
31. ``parallel_axes`` — ``TensorParallelLogistic`` at config 7's rows
   pooled (32,768 x 512) on ``{"tp": 4}`` and ``{"shards": 2, "tp": 4}``;
   ``ExpertShardedMixture`` at 65,536 observations, K = 16, on
   ``{"experts": 4}``; ``ulysses_attention`` at (T, H, d) = (4,096, 8,
   64) on ``{"seq": 4}``, causal and not.  Each against its unsharded
   form on the card and against float64 on the CPU (attention: one head
   per mode), values and gradients; ms (and CUDA launches) per
   logp+grad (attention: per forward+backward) with and without the
   mesh.
32. ``multihost`` — two gloo ranks forked from the fork server, each
   driving 4 slots of the card, join one ``torch.distributed`` world
   (``initialize_multihost``) and evaluate the flagship at 8 x 131,072
   through the kernel over one ``make_multihost_mesh`` of 8 slots.
   Gates: both ranks' logp bits equal, and equal to the single-process
   8-slot mesh's; gradients equal the single-process mesh's and the
   unsharded one's (not x2); one kernel launch per local slot per
   evaluation; rank 1 is SIGKILLed in its work loop and rank 0 detects
   the death through its heartbeat probes within their limit, remeshes
   to its own 4 slots and reproduces the value.  Two ranks on one card
   show the partition and the cross-process sum, not NCCL or
   concurrency across cards.
33. ``elastic`` — ``elastic_sample`` over the flagship through the kernel
   on ``{"shards": 4}`` of the card at the checkpoint phase's size (1 x
   (50 + 75), chunks of 25, depth 3), a failure injected once chunk 0 is
   saved.  Gates: rebuilt over the same slots (the default remesh), the
   draws equal an uninterrupted run's bit for bit; shrunk to 2 slots by
   an ``on_failure`` policy (from a copy of that run's checkpoint after
   chunk 0), the first chunk's draws are unchanged and the rest finite;
   the ``sampler.segment_failed``, ``mesh.remesh`` and
   ``sampler.recovered`` flight events; one kernel launch per slot and
   evaluation.
34. ``fed`` — the ``fed`` layer.  The mesh lane: ``fed.FederatedLogpGrad``
   of the flagship's data term through the kernel
   (``linreg_shard_logp``) at 8 x 131,072 over ``{"shards": 4}`` of the
   card, at 8 seeded points against ``FederatedLogp(linreg_shard_logp,
   mesh=same)`` (gradients bit for bit: the same per-slot maps and
   cotangents) and against float64 on the CPU (values within float32
   rounding: ``fed_sum`` adds the eight per-shard values, FederatedLogp
   each slot's first); one kernel launch per slot and evaluation; ms per
   logp+grad of both (50 each).  The pool lane, bench_suite's config 14
   (64 shards x 16, window 32): two TCP nodes forked from the fork
   server, each serving the port's ``fed.make_node_compute`` of its
   per-shard logp on the card; ``fed.program(model, PoolPlacement)``
   against the direct ``evaluate_many`` fan-out (1e-4 relative), one
   ``fed.fused_window`` per evaluation, two independent ``fed_map``
   calls in one window, ``reduce=True`` through one
   ``fed.reduce_window`` within float32 rounding; shard evaluations per
   second of the program and of the direct lane, interleaved best of 3
   (recorded, not gated).  The mixed lane, 16 of the 64 shards on the
   pool, within float32 rounding of the all-mesh program; ``fedavg``, 50
   rounds over the 4 slots, against ``mesh=None`` bit for bit.
35. ``ppl`` — the ``ppl`` front end, bench_suite's config 20
   (bench_suite.py:3153-3443) on the card: one effectful radon model
   (``ppl.make_radon_example(16, seed=12)``, the radon phase's data)
   compiled with no placement.  Values and gradients at three points
   against the same model in float64 on the CPU (the radon phase's
   tolerances) and against ``HierarchicalRadonGLM`` on the same data
   (values shifted by 2 x 1/2 log(2/pi), the normalizing constants the
   hand-written model drops; gradients equal); the 4-slot mesh lane
   against the dense program; ms per logp+grad.  NUTS through
   ``compiled.logp``, 2 chains x (150 + 150) in lockstep, replayed from a
   CUDA graph, with the radon phase's gates; ``pt_sample`` over 4
   temperatures, 100 + 100, its posterior-mean RMSE against NUTS recorded;
   ``svi_fit``, 1,000 steps, n_mc 8, lr 0.02: the ELBO improves and the
   global means' RMSE against NUTS is at most 0.35, its wall beside
   NUTS's.  Two TCP nodes forked from the fork server serve
   ``compiled.node_compute()`` on the card: one pool window and one
   reduced window against the dense program; then streaming SVI through
   a ``GatewayThread`` over them (frame_items 16, tenant "svi"): 4
   warm-up steps, a deadline of 6 x their median (at least 1 s), 30
   batches of 8 counties; goodput >= 0.9, optimizer steps == accepted
   batches, the last third's mean ELBO above the first third's.
36. ``ppl_zero`` — sharded SVI, config 21 (bench_suite.py:3445-3700) at
   width 8: ``make_radon_example(64, mean_obs=8, seed=21)``; eight node
   processes forked from the fork server, each serving the model's
   ``node_compute()`` (the control's replicas) and a sharded-SVI owner
   (``make_sharded_update_compute`` over one shared ``ShardStore``) on
   the card.  The driver-centric ``StreamingSVI`` over a pooled client of
   the eight, then ``StreamingSVI(sharded=ShardedOptimizer(...))`` over
   the eight owners, each 3 warm-up steps, one instrumented step (the
   npwire decode_copy bytes) and 12 timed steps of 16 counties.  Gates:
   every step accepted; Adam's steps equal the accepted steps (per shard
   in the sharded run); no reply above ceil(total / 8) elements; the
   driver-side reply bytes per step at least 4x below the control's.
   Width 64 (64 node processes) does not run on the card.
37. ``linalg`` — blocked linear algebra, bench_suite config 23
   (bench_suite.py:4082-4320) at its own sizes: a = m m^T / n + I,
   n = 512 in 64 x 64 tiles (an 8 x 8 grid), float64, from
   ``default_rng(23)``.  Eight block-store node processes forked from the
   fork server, each serving ``make_block_store_compute`` with its tiles
   on the card over TCP.  Widths 2, 4 and 8 run ``BlockedCholesky`` on the
   first w nodes (the stores RESET between widths: config 23 starts
   fresh nodes per width), a warm factorization and 3 timed ones, each
   a full distribution.  Gates: every factor within 1e-8 of LAPACK;
   no restore; every lower tile shipped once per factorization and the
   distribution one lower triangle; the largest step's payload (config
   23's client-seam ledger) at most (w + 2) panel columns, and each
   replica's below the lower triangle.  Recorded: wall, GFLOP/s, bytes,
   and the ratio to ``torch.linalg.cholesky`` of the matrix on the card
   and on the CPU.  Recovery at width 4: node 1 is SIGKILLed just
   before its CHOL_PANEL(1) and restarted from the fork server; the
   factor equals the uninterrupted one bit for bit, only that node
   re-ships, and only columns >= 1.  Then config 23's GP lane (n = 384,
   lengthscale 0.5, jitter 1e-4, float64) through ``_posterior_chol``'s
   blocked route on the card against its dense route (rtol 2e-3, atol
   1e-4), and ``linalg.matmul`` (512 x 512 @ 512 x 512),
   ``block_quadratic_form`` and ``triangular_solve`` on a 4-slot mesh of
   the card in float64 against float64 on the CPU (1e-10 of the largest
   entry).
38. ``bridge`` — the PyTensor/PyMC bridge.  PyTensor and PyMC are not
   installed on the GPU host, so the port's real bridge glue and
   ``demos/demo_pymc.py`` run under the port's fakes
   (``tests/torch_pytensor_shim.py``, ``tests/torch_pymc_shim.py``; no
   JAX), the free variables on the card.  ``demo_pymc`` at its own size
   (8 shards x 64, seed 123): the potential and its gradients through the
   PyTorch linker's stand-in (the op's ``torch_fn``, the kernel) against
   the ``perform`` lane (``host_fn``: float32 across the numpy boundary,
   the kernel) within 1e-5 relative at 3 points; the federated model
   against ``build_native_model`` within 1e-4 max(1, |logp|); the MAP
   (slope within 0.1 of 2.0, intercept within 0.4 of 1.5, sigma in (0.3,
   0.8)); ``main()``'s NUTS, 2 x (200 + 200), random_seed 42, its slope
   median within 0.15 of 2.0.  The data term at 8 x 131,072 through
   ``federated_potential``'s torch lane against float64 on the CPU (the
   model phases' tolerances), one launch per evaluation.  The rewrite:
   three ``FederatedLogpGradOp``s over disjoint shard subsets of that
   data, each on the kernel through its ``host_fn``, fused by the rewriter
   registered in ``optdb`` (``fast_run``, position 90) into one
   ``ParallelFederatedOp``: the unfused graph's bits, 3 launches per
   fused evaluation, the same bits from a pickled and restored op; both
   graphs' wall clock recorded.  The ``fed`` lane: two
   ``FederatedLogpGrad`` potentials of the flagship's data term
   (``linreg_shard_logp``) over one 4-slot mesh of the card, composed by
   ``fused_torch_callable`` into one ``fed.program``: values and
   gradients within float32 rounding of the members evaluated apart
   (whether the bits are equal recorded), launches per evaluation
   recorded; the same program under ``torch.func.vmap`` over 3 chains
   with one backward through the chains' summed logps, each chain within
   float32 rounding of its own call and the backward's gradients equal
   to the returned ones.  Kernel launches over the phase above 0.

Phases 10-19, 27, 29, 31, 35, 36 and 37 launch no kernel of the port:
the JAX package computes these models outside Pallas, and so does the
port.

Every phase runs under a deadline of three times its expected seconds
(at least 60 s; ``PHASE_EXPECTED_S``), printed in its line.  At the
deadline the script dumps every thread's stack to stderr, terminates and
then kills every descendant process, prints a line naming the phase as
timed out and exits 1.  After each phase, any descendant process still
alive is reaped and fails the phase.  Before its last lines the script
prints a ``leftovers`` line (live multiprocessing children, descendant
processes, non-daemon threads other than the main one: all must be
empty) and a ``timing`` line with every phase's seconds and deadline and
the script's total.

Then the kernel record line, the ``nvidia-smi`` line and, last, the
device line.  With ``--only kernels`` it stops after the kernels phase,
with ``--only federated`` it runs the nuts and federated phases only,
with ``--only models`` the radon, logistic and lv_ode phases only, with
``--only samplers`` the nuts, wide_logistic, logistic and chees phases
only, with ``--only slice6`` the lgssm, gp and tempering phases only,
with ``--only slice7`` the families and model_check phases only, with
``--only slice8`` the nuts, federated and pool phases only, with
``--only slice9`` the gateway phase only, with ``--only slice10`` the nuts
phase (the reference posterior) and phases 20-25, with ``--only slice11``
the nuts_large phase (the mesh phase's reference posterior) and phases
26-27, with ``--only slice12`` the nuts_large phase (the multichain
phase's reference posterior) and phases 28-29, with ``--only slice13``
the nuts_large phase and phases 30-33, with ``--only slice14`` phase 34
only, with ``--only slice15`` phases 35-36 only, with ``--only slice16``
phase 37 only, with ``--only slice17`` phase 38 only;
none of these prints the kernel record line or the device line.  Any
failed phase makes the script exit non-zero; without
PyTorch, without CUDA, or without the package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import faulthandler
import hashlib
import json
import math
import multiprocessing
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# Peak device-memory rate (bytes/s) and float32 rate outside the tensor
# cores (FLOP/s) for the bounds (NVIDIA data sheets, dense).
_PEAK = {"H100 PCIe": (2.0e12, 51e12), "H100 SXM": (3.35e12, 67e12)}
# Float operations per observation in the kernel's inner loop (an FMA
# counts two): the residual 3, z^2 2, ll 4, gmu 2, gx 3, gz 3.
_FLOPS_PER_OBS = 17

# Kernel vs its float64 plain version.  Inputs are float32 and exact in
# float64; the kernel computes each term in float32 (residual error about
# eps * (|y| + |mu|), a few 1e-7 of a term here) and sums at most ~40
# terms deep at these shapes (16 per thread, a fixed tree over the 256
# threads of a tile, at most 8 tile partials per lane, a shuffle tree
# over 32 lanes), so the worst-case error of a sum is ~40 eps ~ 3e-6 of
# the sum of the terms' magnitudes.
TOL = {
    # ll: every term has the same sign, so relative to |ll| itself.
    "ll": ("rel", 2e-5),
    # gx: with the slope off its generating value, m*r*x has a systematic
    # part, so |gx| is a good fraction of sum|m r x| — relative, with room.
    "gx": ("rel", 1e-4),
    # gmu and gz cancel near the mode (sum of residuals, sum of z^2 - 1):
    # absolute, scaled by the sum of the terms' magnitudes.
    "gmu": ("abs_of_sum_abs", 2e-5),
    "gz": ("abs_of_sum_abs", 2e-5),
}
# gx of the slice-10 chain row (C = 2,560), against the sum of its terms'
# magnitudes as gmu and gz (see _errors).
GX_SUM_ABS = 2e-5
# bench.py's equality gate for logp+grad implementations.
AUTOGRAD_RTOL_VALUE, AUTOGRAD_RTOL_GRAD, AUTOGRAD_ATOL_GRAD = 2e-4, 2e-3, 1e-3

TEST_SHAPES = [(1, 8), (5, 70), (8, 512), (12, 700)]  # tests/test_pallas.py
FLAGSHIP = (8, 64)  # bench.py's flagship size
LARGE_PATH = (8, 131_072)  # the nuts_large phase
REALISTIC = [(8, 1_048_576), (64, 65_536)]
TRUE = {"intercept": 1.5, "slope": 2.0, "sigma": 0.5}
# The federated phase: 4 node processes, node i owning shards {2i, 2i+1};
# timed at both sizes, NUTS over the wire at the flagship size.  Four
# node processes share the one card, and an evaluation over the wire
# costs ~3x one in process: 2 chains x 300 + 300 took 307 s, so the phase
# runs 1 chain x 150 warmup + 150 draws (300 + 300 until the families and
# model_check phases needed its time) and times 50 calls per mode (100
# until the pool phase needed its time), to keep the whole script well
# inside its time limit.
FED_NODES = 4
FED_SIZES = (FLAGSHIP[1], LARGE_PATH[1])
FED_TIMED_CALLS = 50
FED_NUTS = (1, 150, 150)  # chains, warmup, draws
NUTS_LARGE = (1, 300, 300)  # chains, warmup, draws of the nuts_large phase

# BASELINE.json configs 3-5 at bench_suite.py's sizes: radon
# generate_radon_data(16, seed=12) (bench_suite.py:713); Lotka-Volterra
# make_lv_model(8) (bench_suite.py:722); logistic generate_logistic_data(
# n_shards=64, n_obs=64, n_features=8) (bench_suite.py:747), also timed
# at 16,384 observations per shard (X is 32 MiB).
RADON = dict(n_counties=16, seed=12)
LOGISTIC = dict(n_shards=64, n_obs=64, n_features=8)
LOGISTIC_LARGE_OBS = 16_384
LV_SHARDS = 8
MODEL_NUTS = (1, 300, 200)  # chains, warmup, draws (radon)
# A model's float32 value and gradient on the card against the same
# model run in float64 on the CPU.  At these sizes float32 on the CPU
# lands within 4e-7 of float64 on the value and 2e-6 relative on every
# gradient component not near zero; the gates leave ~25x room for the
# card's other summation orders: value rtol 1e-5, gradient within
# 1e-4 |g| + 1e-5 max|g of its leaf|.
MODEL_VALUE_RTOL, MODEL_GRAD_RTOL, MODEL_GRAD_ATOL_OF_MAX = 1e-5, 1e-4, 1e-5
# bf16 compute_dtype against float32 arithmetic: tests/test_mixed_precision.py's band.
BF16_VALUE_RTOL, BF16_GRAD_TOL = 2e-2, 5e-2
# The chain axis of the kernel: C parameter sets against one data set.
KERNEL_CHAINS = (1, 4, 16, 64)
# The flagship nuts phase, in lockstep: chains, warmup, draws (4 x (300 +
# 300) until the pool phase needed its time).
NUTS_FLAGSHIP = (4, 250, 250)
# Config 8 (bench_suite.py:982): NUTS on config 5, 4 chains x 200 + 200,
# jitter 0.1, one run with seed 1 (bench_suite's cold run before it is an
# XLA compile, which the port does not have).
CONFIG8_NUTS = (4, 200, 200)
CONFIG8_JITTER, CONFIG8_SEED = 0.1, 1
# Config 7 (bench_suite.py:878): wide logistic regression, 64 chains in one
# batched evaluation, at init + 0.01 N(0, 1); its gates, anchored on the
# float32_strict form, per chain: value rtol 2e-2, gradient rtol 5e-2 and
# atol 5e-2 max|g| (bench_suite.py:929-939).
WIDE = dict(n_shards=8, n_obs=4096, n_features=512, seed=77)
WIDE_CHAINS, WIDE_JITTER = 64, 0.01
WIDE_VALUE_RTOL, WIDE_GRAD_TOL = 2e-2, 5e-2
WIDE_TIMED_EVALS = 30
# Config 9 (bench_suite.py:1050): ChEES-HMC on config 5, 16 chains.
CONFIG9_CHEES = (16, 200, 200)
CONFIG9_JITTER, CONFIG9_SEED = 0.1, 1
_BF16_PEAK = 989e12  # dense bf16 tensor-core rate of the H100 SXM (data sheet)
# 25 steps (50 until the slice-10 phases needed the time: the card's
# steps took 10.7 s, each an eager RK4 evaluation; the float64 run on the
# CPU halves too).
LV_FIND_MAP = dict(num_steps=25, learning_rate=0.05)
LV_FIND_MAP_ATOL = 1e-4  # log_theta, card against float64 on the CPU (CPU float32: 7e-8)


def emit(obj) -> None:
    """One JSON line; keys starting with ``_`` stay in the process (a
    phase's record for a later phase)."""
    print(json.dumps({k: v for k, v in obj.items() if not k.startswith("_")}), flush=True)


# Each phase runs under a deadline of DEADLINE_FACTOR times its expected
# seconds, at least DEADLINE_MIN_S.  The expected seconds are the
# phases' times on the H100 host (PERF.md section 5),
# rounded up.
PHASE_EXPECTED_S = {
    "build": 10, "kernels": 20, "autograd": 5, "nuts": 35, "nuts_large": 55,
    "federated": 90, "pool": 105, "gateway": 60, "radon": 25, "logistic": 25,
    "lv_ode": 25, "wide_logistic": 5, "chees": 10, "lgssm": 50, "gp": 5,
    "tempering": 25, "families": 10, "model_check": 80,
    "vi": 20, "particles": 10, "sgld": 10, "sbc": 10, "checkpoint": 12, "demos": 40,
    "optim": 15, "mesh": 50, "multichain": 50, "seq": 15,
    "zero": 5, "parallel_axes": 3, "multihost": 12, "elastic": 20, "fed": 20,
    "ppl": 40, "ppl_zero": 20, "linalg": 30, "bridge": 30,
}
DEADLINE_FACTOR, DEADLINE_MIN_S = 3.0, 60.0
# A process left behind gets this long after SIGTERM before SIGKILL.
REAP_GRACE_S = 10.0


def _deadline_s(name: str) -> float:
    return max(DEADLINE_MIN_S, DEADLINE_FACTOR * PHASE_EXPECTED_S.get(name, 20))


def _helper_pids() -> set:
    """multiprocessing's helper processes: the resource tracker, and the
    fork server that node processes start from (``_node_context``).  Each
    starts once and exits when this process does (each reads until its
    pipe from here closes), so no check counts them."""
    from multiprocessing import forkserver, resource_tracker

    pids = {getattr(resource_tracker._resource_tracker, "_pid", None),
            getattr(forkserver._forkserver, "_forkserver_pid", None)}
    return pids - {None}


def _stop_helpers() -> None:
    """Stop multiprocessing's helper processes (``_helper_pids``) and wait
    for them: each would exit on its own only once it noticed this
    process gone, after the script's end."""
    from multiprocessing import forkserver, resource_tracker

    for helper in (forkserver._forkserver, resource_tracker._resource_tracker):
        stop = getattr(helper, "_stop", None)
        if stop is not None:
            stop()


def _node_context():
    """The multiprocessing context every node process of the script
    starts from: a fork server that has imported this script, torch and
    the port once, so that a node forks with them already imported
    instead of importing them anew (with ``spawn``, eight nodes importing
    torch at once on the host's 8 cores took ~20 s).  The server never
    touches CUDA; each node initialises CUDA for itself, as under
    ``spawn``."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", "torch", "pytensor_federated_torch"])
    return ctx


def _live_descendants() -> list:
    """PIDs of every live (not zombie) descendant of this process, read
    from /proc, multiprocessing's resource tracker aside.  ``main`` makes
    the script a child subreaper, so an orphaned grandchild is
    reparented to it and still counts."""
    parent_of, state_of = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        parent_of[int(entry)], state_of[int(entry)] = int(fields[1]), fields[0]
    children = {}
    for pid, ppid in parent_of.items():
        children.setdefault(ppid, []).append(pid)
    out, stack, helpers = [], [os.getpid()], _helper_pids()
    while stack:
        for pid in children.get(stack.pop(), []):
            stack.append(pid)
            if state_of[pid] not in ("Z", "X") and pid not in helpers:
                out.append(pid)
    return sorted(out)


def _close_thread_loop() -> list:
    """Close the event loop the port's sync transport wrappers keep for
    this thread (``utils.get_event_loop``), and its default executor's
    worker threads with it.  Returns the executor threads it joined."""
    from pytensor_federated_torch import utils

    loop = getattr(utils._thread_loops, "loop", None)
    if loop is None or loop.is_closed():
        return []
    before = {t.name for t in threading.enumerate()}
    loop.run_until_complete(loop.shutdown_default_executor())
    loop.close()
    return sorted(before - {t.name for t in threading.enumerate()})


def _reap(pids, grace=REAP_GRACE_S) -> list:
    """SIGTERM ``pids``, SIGKILL what is still alive after ``grace``
    seconds; returns the PIDs that needed the SIGKILL."""
    for pid in pids:
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    end = time.monotonic() + grace
    while time.monotonic() < end and set(pids) & set(_live_descendants()):
        time.sleep(0.1)
    killed = sorted(set(pids) & set(_live_descendants()))
    for pid in killed:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for child in multiprocessing.active_children():  # joins the dead ones
        child.join(timeout=1.0)
    return killed


class _Deadline:
    """Fail a phase loudly when it outlives ``seconds``: dump every
    thread's stack to stderr, terminate and then kill every descendant
    process, print a line naming the phase as timed out, and exit 1.  A
    hung phase thus ends the run with a name and a stack instead of on
    an outside clock.  The watch is a daemon thread."""

    def __init__(self, name: str, seconds: float):
        self.name, self.seconds = name, seconds
        self._done = threading.Event()

    def _watch(self):
        if self._done.wait(self.seconds):
            return
        sys.stderr.write(f"chip_smoke: phase {self.name} passed its deadline of "
                         f"{self.seconds:.0f} s; every thread's stack:\n")
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        left = _live_descendants()
        killed = _reap(left)
        emit({"phase": self.name, "ok": False, "timed_out": True, "deadline_s": self.seconds,
              "processes_reaped": left, "processes_killed": killed})
        sys.stderr.flush()
        os._exit(1)

    def __enter__(self):
        threading.Thread(target=self._watch, name=f"deadline-{self.name}", daemon=True).start()
        return self

    def __exit__(self, *exc):
        self._done.set()


def _leftovers() -> dict:
    """What would outlive the script: live multiprocessing children,
    live descendant processes and threads that are neither daemons nor
    the main thread."""
    return {
        "active_children": [p.name for p in multiprocessing.active_children()],
        "descendants": _live_descendants(),
        "non_daemon_threads": [t.name for t in threading.enumerate()
                               if not t.daemon and t is not threading.main_thread()],
    }


def _become_subreaper() -> bool:
    """PR_SET_CHILD_SUBREAPER (Linux): orphaned grandchildren are
    reparented to this process, so the leftover check sees them."""
    try:
        import ctypes

        return ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _peak(name: str) -> tuple[str, float, float]:
    key = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return (key, *_PEAK[key])


def _bound(S, N, bw, flops, chains=1):
    """Least time (ms) for one call at (S, N) with ``chains`` parameter
    sets, and what sets it: x, y and mask (12 S N bytes) read once, each
    chain's offsets and three scalars read once, each chain's (S, 4)
    result and four totals written once; 17 float operations per
    observation and chain."""
    nbytes = 12 * S * N + chains * (4 * S + 12 + 16 * (S + 1))
    t_bytes = nbytes / bw * 1e3
    t_ops = _FLOPS_PER_OBS * chains * S * N / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def _case(S, N, seed, device):
    """test_pallas.py's inputs at (S, N), made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((S, N), generator=g, device=device)
    y = 1.0 + 2.0 * x + 0.3 * torch.randn((S, N), generator=g, device=device)
    mask = (torch.rand((S, N), generator=g, device=device) > 0.25).float()
    offsets = torch.randn((S,), generator=g, device=device)
    scalars = torch.tensor([0.7, 1.8, -0.2], device=device)
    return scalars, offsets, x, y, mask


def _errors(got, inputs, gx_of_sum_abs=False):
    """Per-output error against the float64 plain version, as the ratio
    to its tolerance (<= 1 passes; with a chain axis, the worst chain's),
    and the largest absolute error.

    ``gx_of_sum_abs`` measures gx as gmu and gz are, against GX_SUM_ABS
    times the sum of its terms' magnitudes: among C = 2,560 random
    parameter sets some slope lands on its generating value, gx then
    cancels (-0.0018 against a sum of magnitudes of 7.98 in one shard),
    and its error relative to |gx| fails in float32 whatever computes it
    (the plain version in float32 on the CPU: 6.9 times the tolerance)."""
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions_ref

    scalars, offsets, x, y, mask = (t.double() for t in inputs)
    # Scalars (3,) or, with a chain axis, (C, 3); offsets (S,) or (C, S).
    intercept, slope, log_sigma = (v[..., None] for v in scalars.unbind(-1))
    ref = linreg_reductions_ref(scalars.unbind(-1), offsets, x, y, mask)
    inv_s2 = torch.exp(-2.0 * log_sigma)
    r = y - ((intercept[..., None] + offsets[..., None]) + slope[..., None] * x)
    sum_abs = {
        "gmu": (mask * r.abs()).sum(-1) * inv_s2,
        "gz": (mask * (r * r * inv_s2[..., None] - 1.0).abs()).sum(-1),
        "gx": (mask * (r * x).abs()).sum(-1) * inv_s2,
    }
    ratios, max_abs = {}, 0.0
    for name, k, rf in zip(("ll", "gmu", "gx", "gz"), got, ref):
        err = (k.double() - rf).abs()
        max_abs = max(max_abs, float(err.max()))
        kind, tol = ("abs_of_sum_abs", GX_SUM_ABS) if name == "gx" and gx_of_sum_abs else TOL[name]
        scale = rf.abs() if kind == "rel" else sum_abs[name]
        ratios[name] = float((err / (tol * scale.clamp_min(1e-30))).max())
    return ratios, max_abs


def _time_ms(fn, flush, *, reps=50):
    """Median of ``reps`` single-call CUDA-event timings, after warm-up.

    Before each call ``flush`` (2 GiB) is rewritten.  That evicts the
    inputs from the 50 MB L2, and the ~0.7 ms the card spends on it
    covers the host's enqueueing of the events and the call, so the
    events time the card's work alone and not a wait for the host."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# Idle time on both sides of the profiled calls: a kernel launched at once
# after the profiler starts is now and then left out of its record
# (``--profiler-window`` counts how often, padded and not).
PROFILE_PAD_S = 0.02


def _card_events(fn, reps, before=None, pad_s=PROFILE_PAD_S):
    """The profiler's record of what ran on the card during ``reps`` calls
    of ``fn`` (each after ``before()``, if given), after one warm-up call,
    in a window padded by ``pad_s`` on both sides."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def profiler_window(readings, calls=10):
    """How often the profiler leaves a kernel out of its record: at three
    shapes, ``readings`` profiles of ``calls`` calls of ``linreg_reductions``
    with no padding and with ``PROFILE_PAD_S``; for each, the histogram of
    kernels recorded per reading (``calls`` is a whole record)."""
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions

    dev = torch.device("cuda")
    cases = {
        "8x131072": _case(*LARGE_PATH, seed=300, device=dev),
        "8x131072_C1": _chain_case(*LARGE_PATH, 1, seed=401, device=dev),
        "8x64_C2560": _chain_case(*FLAGSHIP, 2560, seed=402, device=dev),
    }
    out = {}
    for name, inputs in cases.items():
        for pad_s in (0.0, PROFILE_PAD_S):
            hist = collections.Counter(
                len(_card_events(lambda: linreg_reductions(*inputs), calls, pad_s=pad_s))
                for _ in range(readings))
            out[f"{name}/pad={pad_s}"] = {
                "hist": dict(hist), "short": sum(n for k, n in hist.items() if k != calls)}
    return {"profiler_window": {"calls_per_reading": calls, "readings": readings,
                                "cases": out}}


def _device_ms(fn, flush, *, reps=30):
    """Median over ``reps`` calls of the card's own time in the kernel
    (the profiler's kernel durations, without the launch and the event
    overhead), with the inputs evicted from L2 before each call."""
    times = [e.device_time for e in _card_events(fn, reps, flush.zero_) if "linreg" in e.name]
    return statistics.median(times) / 1e3 if len(times) == reps else None


def _cuda_launches_per_call(fn, calls=10):
    """Device launches per call of ``fn``, counted by the profiler (the
    kernels, memsets and copies it records on the card), and their
    names; ``None`` when the profiler records no device activity.  A
    profile that recorded nothing at all, or a count that is not a whole
    number of launches per call, is taken again, up to 3 times in all:
    a reading whose window was not padded lost events now and then (9
    launches recorded over 10 calls, whose results were all right);
    every call launches the same kernels, so a whole count per call is
    never retaken, and the last reading stands."""
    on_card = []
    for _ in range(3):
        on_card = [e.name for e in _card_events(fn, calls)]
        if on_card and len(on_card) % calls == 0:
            break
    if not on_card:
        return None, []
    return len(on_card) / calls, sorted(set(on_card))


def phase_kernels(bw, flops):
    from pytensor_federated_torch.ops import linreg_kernel
    from pytensor_federated_torch.ops.linreg_kernel import (
        linreg_reductions,
        linreg_reductions_and_totals,
        linreg_reductions_ref,
    )

    dev = torch.device("cuda")
    lib = linreg_kernel._kernel_lib()
    flush = torch.empty(512 * 1024 * 1024, dtype=torch.float32, device=dev)  # 2 GiB
    records, ok = [], True
    shapes = TEST_SHAPES + [FLAGSHIP, LARGE_PATH] + REALISTIC
    for i, (S, N) in enumerate(shapes):
        inputs = _case(S, N, seed=i, device=dev)
        got, totals = linreg_reductions_and_totals(*inputs)
        again = linreg_reductions(*inputs)
        # The same call on a grid capped to 3 blocks: partials are kept per
        # tile and summed in tile order, so the bits must not change.
        capped = linreg_kernel._launch(inputs[0].unbind(), *inputs[1:], max_blocks=3)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        grid_bits = all(torch.equal(a, capped[:S, k]) for k, a in enumerate(got)) and torch.equal(
            totals, capped[S]
        )
        per_shard = torch.stack(got, dim=1).double()
        totals_ok = bool(
            ((totals.double() - per_shard.sum(0)).abs() <= 4e-6 * per_shard.abs().sum(0)).all()
        )
        ratios, max_abs = _errors(got, inputs)
        rec = {
            "shape": [S, N],
            "max_abs_err": max_abs,
            "err_over_tol": ratios,
            "bitwise_rerun": bitwise,
            "bits_equal_capped_grid": grid_bits,
            "totals_ok": totals_ok,
        }
        passed = bitwise and grid_bits and totals_ok and all(v <= 1.0 for v in ratios.values())
        if (S, N) in [FLAGSHIP, LARGE_PATH] + REALISTIC:
            rec["ms"] = _time_ms(lambda: linreg_reductions(*inputs), flush)
            rec["device_ms"] = _device_ms(lambda: linreg_reductions(*inputs), flush)
            rec["plain_ms"] = _time_ms(lambda: linreg_reductions_ref(*inputs), flush)
            rec["bound_ms"], rec["bound_by"], rec["bytes"] = _bound(S, N, bw, flops)
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["ok"] = passed
        ok &= passed
        records.append(rec)

    # Padding is inert: zero-padded observations and shards (mask 0)
    # change no real shard's result beyond the tolerance and give exact
    # zeros in the padded shards.
    scalars, offsets, x, y, mask = _case(5, 70, seed=100, device=dev)
    pad = lambda t: torch.nn.functional.pad(t, (0, 58, 0, 3))
    got = linreg_reductions(
        scalars, torch.nn.functional.pad(offsets, (0, 3)), pad(x), pad(y), pad(mask)
    )
    ratios, _ = _errors([g[:5] for g in got], (scalars, offsets, x, y, mask))
    pad_ok = all(v <= 1.0 for v in ratios.values()) and all(
        bool((g[5:] == 0).all()) for g in got
    )
    # Rows whose 16-byte alignment differs between x, y and mask take the
    # scalar path.
    storage = torch.empty(5 * 70 + 1, device=dev)
    storage[1:].copy_(x.reshape(-1))
    x_shifted = storage[1:].view(5, 70)
    got = linreg_reductions(scalars, offsets, x_shifted, y, mask)
    ratios_shift, _ = _errors(got, (scalars, offsets, x, y, mask))
    shift_ok = all(v <= 1.0 for v in ratios_shift.values())

    # Back-to-back calls on two streams, free to overlap on the card: each
    # stream keeps its own ticket, so every call gives the bits of a call
    # made alone.
    pair = [_case(*REALISTIC[0], seed=200 + k, device=dev) for k in range(2)]
    want = [linreg_reductions(*args) for args in pair]
    streams = [torch.cuda.Stream(dev) for _ in pair]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    results = [[], []]
    for _ in range(8):
        for k, (st, args) in enumerate(zip(streams, pair)):
            with torch.cuda.stream(st):
                results[k].append(linreg_reductions(*args))
    torch.cuda.synchronize()
    streams_ok = all(
        all(torch.equal(g, w) for g, w in zip(res, want[k]))
        for k in range(2) for res in results[k]
    )

    # CUDA launches per call, from the profiler: of the wrapper, and of the
    # main path's forward (data_logp under no_grad: the kernel alone).
    inputs = _case(*LARGE_PATH, seed=300, device=dev)
    per_call, names = _cuda_launches_per_call(lambda: linreg_reductions(*inputs))
    _, _, kern, _ = _flagship(FLAGSHIP[1])
    params = {"intercept": inputs[0][0], "slope": inputs[0][1], "log_sigma": inputs[0][2],
              "offsets": torch.zeros(8, device=dev)}

    def forward():
        with torch.no_grad():
            kern.data_logp(params)

    per_forward, forward_names = _cuda_launches_per_call(forward)
    launches_ok = per_call == 1 and per_forward == 1
    ok &= pad_ok and shift_ok and streams_ok and launches_ok
    chain_ok, chain_records = _kernel_chains(bw, flops, flush)
    ok &= chain_ok
    return ok, {
        "phase": "kernels",
        "kernel": "linreg_reductions",
        "tolerance": {k: {"kind": v[0], "value": v[1]} for k, v in TOL.items()},
        "totals_tolerance": "4e-6 x sum over shards of |per-shard output| (float64 sum)",
        "tile": lib.linreg_tile(),
        "persistent_blocks": {"one_chain": lib.linreg_persistent_blocks(),
                              "batched": lib.linreg_persistent_blocks_batched()},
        "shapes": records,
        "padding_inert": pad_ok,
        "scalar_path_ok": shift_ok,
        "two_streams_ok": streams_ok,
        "cuda_launches_per_call": per_call,
        "cuda_launches_per_forward": per_forward,
        "device_activity": sorted(set(names) | set(forward_names)),
        "chains": chain_records,
        "bound_note": "the larger of 12*S*N + C*(4*S + 12) bytes read and 16*C*(S+1) written "
                      f"over the peak memory rate and {_FLOPS_PER_OBS}*C*S*N float32 operations "
                      "over the peak float32 rate (C = 1 without a chain axis)",
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
    }


def _chain_case(S, N, chains, seed, device):
    """The kernel's inputs at (S, N) with ``chains`` parameter sets near
    test_pallas.py's: scalars (C, 3), offsets (C, S), shared data."""
    scalars, offsets, x, y, mask = _case(S, N, seed, device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    scalars = scalars + 0.1 * torch.randn((chains, 3), generator=g, device=device)
    offsets = offsets + torch.randn((chains, S), generator=g, device=device)
    return scalars, offsets, x, y, mask


def _kernel_chains(bw, flops, flush):
    """The chain axis: C parameter sets in one launch, at the flagship and
    the large size.  Each chain against the float64 plain version; each
    chain's bits against the same chain called alone (the unbatched call:
    for C = 1 that is the check that C = 1 equals the unbatched call);
    reruns and a capped grid bitwise; launches per call; times."""
    from pytensor_federated_torch.ops import linreg_kernel
    from pytensor_federated_torch.ops.linreg_kernel import (
        linreg_reductions,
        linreg_reductions_and_totals,
        linreg_reductions_ref,
    )

    dev = torch.device("cuda")
    records, ok = [], True
    for S, N in (FLAGSHIP, LARGE_PATH):
        for C in KERNEL_CHAINS + (SLICE10_LARGEST_C if (S, N) == FLAGSHIP else ()):
            inputs = _chain_case(S, N, C, seed=400 + C, device=dev)
            sc, off, x, y, m = inputs
            got, totals = linreg_reductions_and_totals(*inputs)
            again, totals2 = linreg_reductions_and_totals(*inputs)
            capped = linreg_kernel._launch(sc.unbind(-1), off, x, y, m, max_blocks=3)
            torch.cuda.synchronize()
            rerun = all(torch.equal(a, b) for a, b in zip(got + (totals,), again + (totals2,)))
            grid_bits = all(torch.equal(capped[..., :S, k], got[k]) for k in range(4)) and (
                torch.equal(capped[..., S, :], totals))
            alone_bits = True
            for c in range(C):
                one, one_totals = linreg_reductions_and_totals(sc[c], off[c], x, y, m)
                alone_bits &= all(torch.equal(a, b[c]) for a, b in zip(one, got)) and (
                    torch.equal(one_totals, totals[c]))
            worst, max_abs = _errors(got, inputs, gx_of_sum_abs=C in SLICE10_LARGEST_C)
            per_call, _ = _cuda_launches_per_call(lambda: linreg_reductions(*inputs))
            rec = {"shape": [S, N], "chains": C, "max_abs_err": max_abs, "err_over_tol": worst,
                   "bitwise_rerun": rerun, "bits_equal_capped_grid": grid_bits,
                   "bits_equal_chain_alone": alone_bits, "cuda_launches_per_call": per_call}
            rec["ms"] = _time_ms(lambda: linreg_reductions(*inputs), flush)
            rec["device_ms"] = _device_ms(lambda: linreg_reductions(*inputs), flush)
            rec["plain_ms"] = _time_ms(lambda: linreg_reductions_ref(*inputs), flush)
            rec["bound_ms"], rec["bound_by"], rec["bytes"] = _bound(S, N, bw, flops, C)
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            rec["ok"] = (rerun and grid_bits and alone_bits and per_call == 1
                         and all(v <= 1.0 for v in worst.values()))
            ok &= rec["ok"]
            records.append(rec)
    return ok, records


def _flat_close(a, b, value_rtol=AUTOGRAD_RTOL_VALUE, grad_rtol=AUTOGRAD_RTOL_GRAD,
                grad_atol=AUTOGRAD_ATOL_GRAD):
    """Value and gradient tree ``a`` against ``b`` (bench.py's gate by
    default): value within ``value_rtol |vb|``, each gradient entry within
    ``grad_atol + grad_rtol |gb|``; compared in float64 on the CPU."""
    from pytensor_federated_torch.samplers.util import ravel

    (va, ga), (vb, gb) = a, b
    ga, gb = (ravel(g)[0].detach().cpu().double() for g in (ga, gb))
    v_ok = abs(float(va) - float(vb)) <= value_rtol * abs(float(vb))
    g_ok = bool(((ga - gb).abs() <= grad_atol + grad_rtol * gb.abs()).all())
    rel = abs(float(va) - float(vb)) / abs(float(vb))
    return v_ok and g_ok and math.isfinite(float(va)), {
        "value_rel_err": rel, "grad_max_abs_err": float((ga - gb).abs().max())}


def _flagship(n_obs, dev="cuda"):
    import pytensor_federated_torch as pft

    data, _ = pft.generate_node_data(8, n_obs=n_obs, seed=123, device=dev)
    model = pft.FederatedLinearRegression(data)
    (x, y), mask = data.tree()
    kern = pft.linreg_logp_grad_fn(x, y, mask)

    def posterior(p):
        return model.prior_logp(p) + kern.data_logp(p)

    return data, model, kern, posterior


def phase_autograd():
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.samplers.util import ravel
    from pytensor_federated_torch.utils import value_and_grad

    data, model, _, posterior = _flagship(FLAGSHIP[1])
    model_ss = pft.FederatedLinearRegression(data, use_suffstats=True)
    flat0, unravel = ravel(model.init_params())
    flat1 = flat0 + 0.1 * torch.arange(flat0.shape[0], dtype=flat0.dtype, device=flat0.device)
    ok, points = True, []
    for name, flat in (("origin", flat0), ("perturbed", flat1)):
        p = unravel(flat)
        ref = model.logp_and_grad(p)
        k_ok, k_err = _flat_close(value_and_grad(posterior, p), ref)
        s_ok, s_err = _flat_close(model_ss.logp_and_grad(p), ref)
        ok &= k_ok and s_ok
        points.append({"point": name, "kernel_vs_autograd": k_err, "suffstats_vs_autograd": s_err,
                       "ok": k_ok and s_ok})
    try:
        p = {k: v.detach().requires_grad_(True) for k, v in model.init_params().items()}
        torch.autograd.grad(posterior(p), list(p.values()), create_graph=True)
        double_raises = False
    except RuntimeError:
        double_raises = True
    ok &= double_raises
    return ok, {
        "phase": "autograd",
        "size": list(FLAGSHIP),
        "tolerance": {"value_rtol": AUTOGRAD_RTOL_VALUE, "grad_rtol": AUTOGRAD_RTOL_GRAD,
                      "grad_atol": AUTOGRAD_ATOL_GRAD, "source": "bench.py equality gate"},
        "points": points,
        "double_backward_raises": double_raises,
    }


def _recovered(derived):
    """Posterior mean, sd and Monte Carlo standard error (sd / sqrt(ESS))
    of each derived quantity, against its generating value."""
    import pytensor_federated_torch as pft

    ess = pft.samplers.effective_sample_size(derived)
    out = {}
    for k, d in derived.items():
        mean, sd = float(d.mean()), float(d.std())
        out[k] = {"mean": mean, "sd": sd, "ess": float(ess[k]),
                  "mcse": sd / float(ess[k]) ** 0.5, "true": TRUE[k],
                  "within_4sd": abs(mean - TRUE[k]) <= 4 * sd}
    return out


NUTS_EAGER_EVALS = 50  # eager batched evaluations timed beside the graphed run
NUTS_BITS_POINTS = 8  # states at which a replay is held bit for bit against an eager call
# The CUDA driver API's kernel node type (CU_GRAPH_NODE_TYPE_KERNEL).
_CU_GRAPH_NODE_TYPE_KERNEL = 0


def _graph_kernel_names(cuda_graph):
    """The function name of every kernel node of a captured CUDA graph,
    read from the graph itself through the CUDA driver API
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphKernelNodeGetParams`` and ``cuFuncGetName`` or
    ``cuKernelGetName``).  Every replay launches exactly these kernels,
    so their count is the launches per replay, with no profiler in the
    way.  ``cuda_graph`` must keep its ``cudaGraph_t``
    (``CUDAGraph(keep_graph=True)``, as ``graph_batch_logp_and_grad``
    captures)."""
    import ctypes

    lib = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} failed with CUDA driver error {err}")

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                    ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    graph = ctypes.c_void_p(cuda_graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(lib.cuGraphGetNodes(graph, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != _CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        params = KernelNodeParams()
        check(lib.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            check(lib.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)),
                  "cuFuncGetName")
        else:
            check(lib.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)),
                  "cuKernelGetName")
        names.append(name.value.decode())
    return names


def _graph_points(flat0, chains, dev, seed):
    """NUTS_BITS_POINTS chain batches ``(chains, dim)`` near ``flat0``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return flat0 + 0.05 * torch.randn((NUTS_BITS_POINTS, chains) + flat0.shape, generator=g,
                                      device=flat0.device)


def _graph_check(replay, lg, points, expected, timed=NUTS_EAGER_EVALS):
    """The graph that a sampler's run replayed (``extra["graph"]``, the
    run's own graph, read after the run), against ``lg``, the same
    batched value+grad called eagerly: its replays held bit for bit
    against eager calls at ``points``; eager calls and replays timed
    (``timed`` of each; no eager timing when 0); and the linreg kernel's
    launches per replay, counted as the kernel nodes of the captured
    graph itself (a replay never reaches the wrapper's host-side
    counter).  ``launch_ok`` holds when that count is exactly
    ``expected``.  ``gate_s`` is what the check costs."""
    t0 = time.perf_counter()
    bits = True
    for x in points:
        (v0, g0), (v1, g1) = lg(x), replay(x)
        bits &= torch.equal(v0, v1) and torch.equal(g0, g1)
    t1 = time.perf_counter()
    names = _graph_kernel_names(replay.cuda_graph)
    per_replay = sum("linreg" in n for n in names)
    count_s = time.perf_counter() - t1
    dev = points.device
    out = {"replay_bits_equal_eager": bits, "bits_points": len(points),
           "kernel_launches_per_replay": per_replay,
           "expected_launches_per_replay": expected,
           "graph_kernel_nodes": len(names), "launch_ok": per_replay == expected,
           "count_s": count_s,
           "replay_ms_per_batched_eval": _ms_per_eval(lambda: replay(points[0]), dev,
                                                      max(timed, 5))}
    if timed:
        out.update(eager_ms_per_batched_eval=_ms_per_eval(lambda: lg(points[0]), dev, timed),
                   eager_evals_timed=timed)
    out["gate_s"] = time.perf_counter() - t0
    return out


def _graphed_launches(graph, host_launches, replays):
    """The linreg kernel's launches over a run that replayed a CUDA
    graph: its eager calls (the graph's three warm-up calls) launch on
    the card and count on the host; its capture counts a call's launches
    on the host and launches nothing; each replay launches the graph's
    kernel nodes."""
    per_replay = graph["expected_launches_per_replay"]
    return host_launches - per_replay + graph["kernel_launches_per_replay"] * replays


def phase_nuts(name, n_obs, chains, warmup, draws, dense_mass, seed=7, dev="cuda"):
    """NUTS through the kernel, its batched evaluation replayed from a
    CUDA graph (``sample(cuda_graph=True)``).  A replay never reaches the
    kernel wrapper's host-side launch counter, so the launch gate reads
    the graph: after the run, the run's own graph (``extra["graph"]``)
    must hold exactly one kernel node of the linreg kernel (one launch
    per replay); its replays are held bit for bit against eager calls at
    the same states, and eager calls and replays are timed.  The
    phase's launches are that count times the run's replays plus the
    graph's eager warm-up launches."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
    from pytensor_federated_torch.samplers.mcmc import (
        make_batch_logp_and_grad,
        make_flat_logp_and_grad,
    )

    cuda = torch.device(dev).type == "cuda"
    _, model, _, posterior = _flagship(n_obs, dev)
    flat_logp, flat0, unravel, _ = make_flat_logp_and_grad(posterior, model.init_params())
    lg = make_batch_logp_and_grad(flat_logp, unravel)
    points = _graph_points(flat0, chains, dev, seed + 1000)

    gen = torch.Generator(device=dev).manual_seed(seed)
    _sync(dev)
    linreg_reductions.launches = 0
    t0 = time.perf_counter()
    res = pft.samplers.sample(
        posterior, model.init_params(), generator=gen, num_warmup=warmup, num_samples=draws,
        num_chains=chains, dense_mass=dense_mass, cuda_graph=cuda,
    )
    _sync(dev)
    wall = time.perf_counter() - t0
    host_launches = linreg_reductions.launches
    if cuda:
        replays = grad_evals = res.extra["graph_replays"]
        graph = _graph_check(res.extra["graph"], lg, points, expected=1)
        launches = _graphed_launches(graph, host_launches, replays)
        launch_ok = graph["launch_ok"] and graph["replay_bits_equal_eager"] and replays > 0
        graph.update(graph_replays=replays, eager_kernel_launches=host_launches - 1)
    else:
        grad_evals = launches = host_launches
        launch_ok = host_launches > 0
        graph = {"eager_ms_per_batched_eval": _ms_per_eval(lambda: lg(points[0]), dev,
                                                           NUTS_EAGER_EVALS)}

    s = res.samples
    derived = {
        "intercept": s["intercept"],
        "slope": s["slope"],
        "sigma": torch.exp(s["log_sigma"]),
    }
    rhat = pft.samplers.split_rhat(s)
    max_rhat = max(float(v.max()) for v in rhat.values())
    recovered = _recovered(derived)
    finite = all(bool(torch.isfinite(v).all()) for v in s.values())
    depth = res.stats["depth"].float()
    ok = (
        launch_ok
        and max_rhat < 1.05
        and finite
        and all(r["within_4sd"] for r in recovered.values())
    )
    return ok, {
        "phase": name,
        "size": [8, n_obs],
        "chains": chains, "warmup": warmup, "draws": draws, "dense_mass": dense_mass,
        "cuda_graph": cuda,
        "wall_s": wall,
        # Evaluations of the whole chain batch (each one replay of the
        # graphed, vmapped posterior), and of single chains in them.
        "grad_evals": grad_evals,
        "chain_grad_evals": grad_evals * chains,
        "kernel_launches": launches,
        "launches_per_grad_eval": launches / max(grad_evals, 1),
        "ms_per_grad_eval": wall * 1e3 / max(grad_evals, 1),
        "ms_per_draw": wall * 1e3 / (chains * (warmup + draws)),
        "graph": graph,
        "mean_tree_depth": float(depth.mean()),
        # A lockstep transition runs as many leaves as its deepest chain.
        "mean_max_tree_depth": float(depth.max(dim=0).values.mean()),
        "divergences": int(res.stats["diverging"].sum()),
        "max_split_rhat": max_rhat,
        "recovered": recovered,
        "finite": finite,
    }


def _fed_node(rank, sizes, conn):
    """One federated node process.  It owns shards {2 rank, 2 rank + 1}
    of ``generate_node_data(8, n_obs, seed=123)`` for each size, rebuilt
    here from the seed (the driver never holds data), on the card; it
    serves their logp+grad, one kernel launch per request, on one TCP
    port per size, and answers the parent's commands on ``conn``."""
    sys.path.insert(0, str(ROOT))
    try:
        import threading

        import pytensor_federated_torch as pft
        from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
        from pytensor_federated_torch.service import _node_metrics, device_compute_fn, serve_tcp_once

        if not torch.cuda.is_available():
            raise RuntimeError(f"node {rank} found no GPU")
        own = slice(2 * rank, 2 * rank + 2)
        ports = {}
        for n_obs in sizes:
            data, _ = pft.generate_node_data(8, n_obs=n_obs, seed=123, device="cpu")
            (x, y), mask = data.tree()
            kern = pft.linreg_logp_grad_fn(*(t[own].to("cuda") for t in (x, y, mask)))

            def node_logp_grad(intercept, slope, log_sigma, offsets, kern=kern):
                logp, g = kern({"intercept": intercept, "slope": slope,
                                "log_sigma": log_sigma, "offsets": offsets})
                return logp, (g["intercept"], g["slope"], g["log_sigma"], g["offsets"])

            compute = device_compute_fn(pft.wrap_logp_grad_fn(node_logp_grad))
            bound = threading.Event()

            def on_ready(port, n_obs=n_obs, bound=bound):
                ports[n_obs] = port
                bound.set()

            threading.Thread(target=serve_tcp_once, args=(compute,), daemon=True,
                             kwargs={"port": 0, "concurrent": True, "ready_callback": on_ready}).start()
            if not bound.wait(60):
                raise RuntimeError(f"node {rank} did not bind a port")
        requests = _node_metrics.REQUESTS.labels(method="evaluate")
        conn.send({"rank": rank, "ports": ports, "device": torch.cuda.get_device_name(),
                   "cuda": str(compute.device)})
        earlier_launches, window_start = 0, requests.value
        while True:
            cmd = conn.recv()
            if cmd == "reset":  # counts to 0 just before a drive
                earlier_launches += linreg_reductions.launches
                linreg_reductions.launches = 0
                window_start = requests.value
            counts = {"window_requests": int(requests.value - window_start),
                      "window_launches": linreg_reductions.launches,
                      "requests": int(requests.value),
                      "launches": earlier_launches + linreg_reductions.launches}
            conn.send(counts)
            if cmd == "stop":
                return
    except Exception:
        conn.send({"error": traceback.format_exc()})


def _fed_ask(conns, cmd, timeout=120.0):
    """Send ``cmd`` to every node and collect one reply from each."""
    for c in conns:
        if cmd is not None:
            c.send(cmd)
    replies = []
    for c in conns:
        if not c.poll(timeout):
            raise TimeoutError(f"a node did not answer {cmd!r} within {timeout} s")
        msg = c.recv()
        if "error" in msg:
            raise RuntimeError(f"a node failed:\n{msg['error']}")
        replies.append(msg)
    return replies


def _request_key(arrays) -> bytes:
    import numpy as np

    return b"".join(np.ascontiguousarray(np.asarray(a)).tobytes() for a in arrays)


class _Recorded:
    """A client whose every request (its bytes) and reply go, in order,
    onto ``log``: the federated phase's record of its NUTS run, which the
    pool phase replays (``POOL_REPLAYED_SHARE``)."""

    def __init__(self, client, log):
        self.client, self.log = client, log

    def evaluate(self, *arrays):
        import numpy as np

        out = self.client.evaluate(*arrays)
        self.log.append((_request_key(arrays), [np.array(o, copy=True) for o in out]))
        return out

    def close(self):
        self.client.close()


def _remote_posterior(nodes, n_obs, parallel=True, tape=None):
    """The driver: one TCP client per node, adapted to ``(logp, grads)``,
    fanned out by ``ParallelLogpGrad``; logp = prior + the nodes' sum.
    It runs on the CPU and holds the 11 parameters only.  With
    ``parallel=False`` each node is a ``blackbox_logp_grad`` op called in
    turn (the JAX remote demo's ``--sequential``), which shows what a
    node's request costs while the other nodes are idle.  With ``tape`` (a
    list of one list per node) each node's requests and replies are
    recorded there."""
    from pytensor_federated_torch.service import TcpArraysClient

    clients = [TcpArraysClient("127.0.0.1", n["ports"][n_obs], timeout_s=120.0) for n in nodes]
    if tape is not None:
        clients = [_Recorded(c, log) for c, log in zip(clients, tape)]
    posterior, close_fan = _posterior_over(clients, parallel)

    def close():
        close_fan()
        for c in clients:
            c.close()

    return posterior, close


def _posterior_over(clients, parallel=True):
    """``(posterior, close)``: prior + the sum of the clients' replies,
    client i serving shards {2i, 2i+1}, in client order (so any clients
    that compute the same bits give the same posterior bits)."""
    import pytensor_federated_torch as pft

    def as_logp_grad(client):
        def call(*arrays):
            out = client.evaluate(*arrays)
            return out[0], out[1:]

        return call

    spec = pft.spec_of(*(torch.zeros((), dtype=torch.float32),) * 3,
                       torch.zeros(2, dtype=torch.float32))
    if parallel:
        fan = pft.ParallelLogpGrad([as_logp_grad(c) for c in clients], [spec] * len(clients))
        total = fan.total_logp
    else:
        ops = [pft.blackbox_logp_grad(as_logp_grad(c), spec) for c in clients]
        total = lambda per_node: sum(op.logp(*args) for op, args in zip(ops, per_node))

    def posterior(p):
        per_node = [(p["intercept"], p["slope"], p["log_sigma"], p["offsets"][2 * i:2 * i + 2])
                    for i in range(len(clients))]
        return pft.linreg_prior_logp(p) + total(per_node)

    def close():
        if parallel:
            fan.close()

    return posterior, close


def _wire_split(posterior, p, rounds=8, per_round=8):
    """Driver spans on for a short run: the per-request round trip
    (``rpc.evaluate``) against the node's own time (its shipped
    ``node.evaluate`` span plus the decode before it) and its compute
    (the ``compute`` span), medians in ms."""
    from pytensor_federated_torch.telemetry import reunion, spans
    from pytensor_federated_torch.utils import value_and_grad

    rpc, node, compute = [], [], []
    spans.set_enabled(True)
    try:
        for _ in range(rounds):  # rounds small enough for the trace rings
            spans.clear_traces()
            reunion.clear()
            for _ in range(per_round):
                value_and_grad(posterior, p)
            rpc += [t["duration_s"] for t in spans.recent_traces() if t["name"] == "rpc.evaluate"]
            for t in reunion.remote_traces():
                if t["name"] != "node.evaluate":
                    continue
                node.append(t["duration_s"] + t.get("attrs", {}).get("decode_s", 0.0))
                compute += [c["duration_s"] for c in t.get("children", []) if c["name"] == "compute"]
    finally:
        spans.set_enabled(False)
    med = lambda v: statistics.median(v) * 1e3 if v else None
    return {"requests": len(rpc), "node_spans": len(node), "rpc_ms": med(rpc), "node_ms": med(node),
            "node_compute_ms": med(compute),
            "wire_and_client_ms": med(rpc) - med(node) if rpc and node else None}


def phase_federated(nuts_line, seed=7):

    import pytensor_federated_torch as pft
    from pytensor_federated_torch.samplers.util import ravel
    from pytensor_federated_torch.telemetry import spans
    from pytensor_federated_torch.utils import resolve_device, value_and_grad

    cpu = resolve_device("cpu")  # the driver holds 11 floats
    spans.set_enabled(False)  # on only for the short span run
    ctx = _node_context()
    procs, conns, closers = [], [], []
    try:
        t0 = time.perf_counter()
        for rank in range(FED_NODES):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_fed_node, args=(rank, FED_SIZES, child), daemon=True)
            proc.start()
            procs.append(proc)
            conns.append(parent)
        nodes = _fed_ask(conns, None, timeout=300.0)
        spawn_s = time.perf_counter() - t0
        on_card = all(n["cuda"].startswith("cuda") and n["device"] for n in nodes)

        # Values at 8 x 131,072: remote against in-process on the card.
        _, true_offsets = pft.generate_node_data(8, n_obs=8, seed=123, device="cpu")
        init = {k: torch.zeros((8,) if k == "offsets" else (), dtype=torch.float32, device=cpu)
                for k in ("intercept", "slope", "log_sigma", "offsets")}
        flat0, unravel = ravel(init)
        truth = {"intercept": torch.tensor(TRUE["intercept"]), "slope": torch.tensor(TRUE["slope"]),
                 "log_sigma": torch.tensor(math.log(TRUE["sigma"])),
                 "offsets": torch.tensor(true_offsets, dtype=torch.float32)}
        points = {"origin": flat0, "perturbed": flat0 + 0.1 * torch.arange(11, dtype=torch.float32),
                  "truth": ravel(truth)[0]}
        remote, close = _remote_posterior(nodes, LARGE_PATH[1])
        closers.append(close)
        _, _, _, local = _flagship(LARGE_PATH[1])
        values, values_ok = [], True
        for name, flat in points.items():
            rv, rg = value_and_grad(remote, unravel(flat))
            lv, lg = value_and_grad(local, unravel(flat.cuda()))
            ok, err = _flat_close((rv, rg), (lv.cpu(), {k: v.cpu() for k, v in lg.items()}))
            values.append({"point": name, **err, "remote_logp": float(rv),
                           "remote_grad": ravel(rg)[0].tolist(), "ok": ok})
            values_ok &= ok

        # Time per remote evaluation, then the wire/node split from spans:
        # the fan-out, and each node called in turn while the others idle.
        timing = {}
        for n_obs in FED_SIZES:
            timing[f"8x{n_obs}"] = {}
            for mode in ("parallel", "sequential"):
                if n_obs == LARGE_PATH[1] and mode == "parallel":
                    post = remote
                else:
                    post, close = _remote_posterior(nodes, n_obs, parallel=mode == "parallel")
                    closers.append(close)
                for _ in range(20):
                    value_and_grad(post, truth)
                times = []
                for _ in range(FED_TIMED_CALLS):
                    ts = time.perf_counter()
                    value_and_grad(post, truth)
                    times.append(time.perf_counter() - ts)
                timing[f"8x{n_obs}"][mode] = {"calls": FED_TIMED_CALLS,
                                              "ms_per_eval": statistics.median(times) * 1e3,
                                              "spans": _wire_split(post, truth)}

        # NUTS over the wire at the flagship size; node counts from zero.
        # Its requests and replies are recorded for the pool phase.
        tape = [[] for _ in nodes]
        flagship, close = _remote_posterior(nodes, FLAGSHIP[1], tape=tape)
        closers.append(close)
        _fed_ask(conns, "reset")
        grad_evals = 0

        def counted(p):
            nonlocal grad_evals
            grad_evals += 1
            return flagship(p)

        gen = torch.Generator(device=cpu).manual_seed(seed)
        t0 = time.perf_counter()
        res = pft.samplers.sample(counted, init, generator=gen, num_warmup=FED_NUTS[1],
                                  num_samples=FED_NUTS[2], num_chains=FED_NUTS[0])
        wall = time.perf_counter() - t0
        counts = _fed_ask(conns, "counts")
        s = res.samples
        derived = {"intercept": s["intercept"], "slope": s["slope"], "sigma": torch.exp(s["log_sigma"])}
        max_rhat = max(float(v.max()) for v in pft.samplers.split_rhat(s).values())
        recovered = _recovered(derived)
        local_rec = nuts_line.get("recovered", {})
        for k, r in recovered.items():
            ref = local_rec.get(k)
            if ref is None or "mcse" not in ref:
                r["within_mcse_of_nuts"] = False
                continue
            limit = 4 * (r["mcse"] ** 2 + ref["mcse"] ** 2) ** 0.5
            r["nuts_mean"], r["mcse_limit"] = ref["mean"], limit
            r["within_mcse_of_nuts"] = abs(r["mean"] - ref["mean"]) <= limit
        finite = all(bool(torch.isfinite(v).all()) for v in s.values())
        launches = sum(c["window_launches"] for c in counts)
        per_request = all(c["window_launches"] == c["window_requests"] == grad_evals
                          and c["launches"] == c["requests"] for c in counts)
        ok = (
            on_card and values_ok and per_request and grad_evals > 0 and finite
            and max_rhat < 1.05
            and all(r["within_4sd"] and r["within_mcse_of_nuts"] for r in recovered.values())
        )
        return ok, {
            "phase": "federated",
            "nodes": [{"rank": n["rank"], "device": n["device"], "cuda": n["cuda"],
                       **{k: c[k] for k in ("requests", "launches")}} for n, c in zip(nodes, counts)],
            "spawn_s": spawn_s,
            "tolerance": {"value_rtol": AUTOGRAD_RTOL_VALUE, "grad_rtol": AUTOGRAD_RTOL_GRAD,
                          "grad_atol": AUTOGRAD_ATOL_GRAD, "source": "bench.py equality gate"},
            "values": {"size": list(LARGE_PATH), "points": values},
            "timing": timing,
            "nuts": {"size": list(FLAGSHIP), "chains": FED_NUTS[0], "warmup": FED_NUTS[1],
                     "draws": FED_NUTS[2], "wall_s": wall, "grad_evals": grad_evals,
                     "ms_per_grad_eval": wall * 1e3 / max(grad_evals, 1),
                     "in_process_ms_per_grad_eval": nuts_line.get("ms_per_grad_eval"),
                     "node_requests": [c["window_requests"] for c in counts],
                     "kernel_launches": launches,
                     "one_launch_per_request": per_request,
                     "mean_tree_depth": float(res.stats["depth"].float().mean()),
                     "divergences": int(res.stats["diverging"].sum()),
                     "max_split_rhat": max_rhat, "recovered": recovered, "finite": finite,
                     "draws_sha256": _draws_sha256(s)},
            "_nuts_tape": tape,
        }
    finally:
        for close in closers:
            close()
        for c in conns:
            try:
                c.send("stop")
            except (OSError, ValueError):
                pass
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()


# The pool phase: 4 groups x 2 replicas (8 node processes), group g
# owning the federated phase's shards {2g, 2g+1}.  Each group's first
# replica serves over shm; the second over ring (groups 0-1) or TCP
# (groups 2-3).  The NUTS run, its draws and its values are the
# federated phase's: the same kernel on the same shards, summed by the
# driver in the same order, so they must agree bit for bit.
POOL_GROUPS = 4
# The pool's NUTS replays this share of the federated run's evaluations
# (its warmup, ~63% of them, and the first draws) from the federated
# phase's record of each group's requests and replies, each request held
# bit for bit to the recorded one; the rest, with the SIGKILL a third of
# the way into them, go through the pools.
POOL_REPLAYED_SHARE = 0.75
POOL_SECOND_LANE = ("ring", "ring", "tcp", "tcp")
POOL_WINDOWS = (4, 16, 64)  # requests per evaluate_many, one window each
POOL_WINDOW_REPS = 3
POOL_MAX_BATCH = 64  # a node's padded-bucket ladder reaches one whole window
POOL_BATCHER_REQUESTS = 64
POOL_TRACED_EVALS = 16
# Each shm/ring connection maps two arenas.  tmpfs allocates pages as
# they are written, but writing past a full /dev/shm raises SIGBUS, not
# an error: when /dev/shm cannot hold every arena at the default size,
# the nodes map arenas of POOL_SMALL_ARENA bytes instead (a window of 64
# requests at 8 x 131,072 writes ~64 x 5 parameter arrays and as many
# replies, a few tens of kB; the ring's records take 256 kB).
POOL_SMALL_ARENA = 4 << 20
POOL_SLO_P99_S = 0.05
POOL_LANE_CALLS = 200  # timed single requests per lane, at the flagship size


def _pool_node(group, lane, sizes, arena_bytes, ports, dev, conn):
    """One pool replica process.  It owns shards {2 group, 2 group + 1}
    of ``generate_node_data(8, n_obs, seed=123)`` for each size, rebuilt
    here from the seed on ``dev``, served by ``device_compute_fn(...,
    batched=True)`` over the kernel on ``lane`` (one port per size; the
    given ``ports`` when restarted), with the HTTP exporter beside it; it
    answers the driver's commands on ``conn``."""
    sys.path.insert(0, str(ROOT))
    try:
        import threading

        import numpy as np

        import pytensor_federated_torch as pft
        from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
        from pytensor_federated_torch.service import (
            _node_metrics, batching, device_compute_fn, ring, serve_ring, serve_shm, serve_tcp_once,
        )
        from pytensor_federated_torch.telemetry import export

        if dev == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"pool node {group}/{lane} found no GPU")
        ports = dict(ports or {})
        own = slice(2 * group, 2 * group + 2)
        window_sizes, computes = [], {}
        for n_obs in sizes:
            data, _ = pft.generate_node_data(8, n_obs=n_obs, seed=123, device="cpu")
            (x, y), mask = data.tree()
            kern = pft.linreg_logp_grad_fn(*(t[own].to(dev) for t in (x, y, mask)))

            def node_logp_grad(intercept, slope, log_sigma, offsets, kern=kern):
                logp, g = kern({"intercept": intercept, "slope": slope,
                                "log_sigma": log_sigma, "offsets": offsets})
                return logp, (g["intercept"], g["slope"], g["log_sigma"], g["offsets"])

            compute = device_compute_fn(pft.wrap_logp_grad_fn(node_logp_grad), device=dev,
                                        batched=True, max_batch=POOL_MAX_BATCH)

            def recorded(requests, batch=compute.batch):
                window_sizes.append(len(requests))  # one window, one kernel launch
                return batch(requests)

            compute.batch = recorded
            computes[n_obs] = compute
        # A process's first vmapped call is slow (~1-2 s): pay it here, in
        # parallel with the other nodes' start, at every window shape the
        # windows part sends (a batch frame carries at most 32 requests).
        probe = (np.float32(1.5), np.float32(2.0), np.float32(-0.7), np.zeros(2, np.float32))
        for w in sorted({min(w, 32) for w in POOL_WINDOWS}):
            computes[sizes[-1]].batch([probe] * w)
        evaluate = _node_metrics.REQUESTS.labels(method="evaluate")
        kinds = {k: batching._BATCHES.labels(kind=k) for k in ("vmapped", "single", "serial",
                                                               "fallback")}

        def now():
            return {"evaluate": evaluate.value, "launches": linreg_reductions.launches,
                    "sizes": len(window_sizes), **{k: v.value for k, v in kinds.items()}}

        base = now()  # before any port is bound: every request served counts
        serve, kw = {"shm": (serve_shm, {"arena_bytes": arena_bytes}),
                     "ring": (serve_ring, {"arena_bytes": arena_bytes}),
                     "tcp": (serve_tcp_once, {})}[lane]
        for n_obs, compute in computes.items():
            bound = threading.Event()

            def on_ready(port, n_obs=n_obs, bound=bound):
                ports[n_obs] = port
                bound.set()

            threading.Thread(target=serve, args=(compute,), daemon=True,
                             kwargs={"port": ports.get(n_obs, 0), "ready_callback": on_ready,
                                     "concurrent": True, **kw}).start()
            if not bound.wait(60):
                raise RuntimeError(f"pool node {group}/{lane} did not bind a port")
        exporter = export.start_exporter(port=ports.get("exporter", 0))
        ports["exporter"] = exporter.port
        conn.send({"group": group, "lane": lane, "ports": ports, "pid": os.getpid(),
                   "device": torch.cuda.get_device_name() if dev == "cuda" else "cpu",
                   "cuda": str(compute.device)})
        while True:
            cmd = conn.recv()
            if cmd == "reset":  # counts to 0 just before a drive
                base = now()
            cur = now()
            served = export.snapshot()["metrics"].get("pftpu_server_requests_total", {})
            conn.send({
                "requests": int(cur["evaluate"] - base["evaluate"]),
                "launches": cur["launches"] - base["launches"],
                "windows": {k: int(cur[k] - base[k]) for k in kinds},
                "window_sizes": window_sizes[base["sizes"]:],
                "requests_total": sum(c["value"] for c in served.get("children", [])),
                "launches_total": linreg_reductions.launches,
                "syscalls": ring.syscall_counts() if lane == "ring" else None,
            })
            if cmd == "stop":
                exporter.close()
                return
    except Exception:
        conn.send({"error": traceback.format_exc()})


def _arena_budget(n_connections):
    """``(arena_bytes, report)``: the default arena size when /dev/shm
    can hold every connection's two arenas at it, else the small one."""
    from pytensor_federated_torch.service.arena import DEFAULT_ARENA_BYTES, arena_dir

    where = arena_dir()
    df = subprocess.run(["df", "-B1", where], capture_output=True, text=True, timeout=30).stdout
    free = os.statvfs(where)
    avail = free.f_bavail * free.f_frsize
    need = 2 * n_connections * DEFAULT_ARENA_BYTES
    arena_bytes = DEFAULT_ARENA_BYTES if avail >= 2 * need else POOL_SMALL_ARENA
    return arena_bytes, {"arena_dir": where, "df": df.strip().splitlines()[-1:], "avail_bytes": avail,
                         "connections": n_connections, "default_need_bytes": need,
                         "arena_bytes": arena_bytes}


def _arena_files(since):
    from pytensor_federated_torch.service.arena import arena_dir

    out = []
    for p in Path(arena_dir()).glob("pftpu-arena-*"):
        try:
            if p.stat().st_mtime >= since:
                out.append(p.name)
        except FileNotFoundError:
            pass
    return out


def _lane_client(lane, port):
    from pytensor_federated_torch.service import RingArraysClient, ShmArraysClient, TcpArraysClient

    cls = {"shm": ShmArraysClient, "ring": RingArraysClient, "tcp": TcpArraysClient}[lane]
    return cls("127.0.0.1", port, timeout_s=120.0)


def _median_ms(fn, calls, warm=10):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(calls):
        ts = time.perf_counter()
        fn()
        times.append(time.perf_counter() - ts)
    return statistics.median(times) * 1e3


def _flat_bits(value, grads):
    from pytensor_federated_torch.samplers.util import ravel

    return [float(value)] + ravel(grads)[0].tolist()


def phase_pool(fed_line, dev="cuda", nuts=FED_NUTS, sizes=FED_SIZES, windows=POOL_WINDOWS, seed=7):
    import asyncio
    import tempfile
    import threading

    import numpy as np

    import pytensor_federated_torch as pft
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
    from pytensor_federated_torch.routing import NodePool, PooledArraysClient
    from pytensor_federated_torch.samplers.util import ravel
    from pytensor_federated_torch.service import MicroBatcher, device_compute_fn, ring
    from pytensor_federated_torch.telemetry import (
        BurnRateEngine, FleetCollector, Slo, critpath, reunion, spans, watchdog,
    )
    from pytensor_federated_torch.utils import resolve_device, value_and_grad

    t_phase = time.time() - 1.0
    cpu = resolve_device("cpu")
    spans.set_enabled(False)  # on only for the short traced run
    small, large = sizes
    lanes = [(g, lane) for g in range(POOL_GROUPS) for lane in ("shm", POOL_SECOND_LANE[g])]
    n_arena_conns = 2 * sum(lane != "tcp" for _, lane in lanes) + 2  # both sizes, and a restart
    arena_bytes, arena = _arena_budget(n_arena_conns)
    ctx = _node_context()
    procs, conns, nodes, pools, closers = {}, {}, {}, [], []
    victim = (0, "shm")
    marks = {}  # seconds from the phase's start to the end of each part
    # Set once the NUTS run's pools stand; `aborted` tells a NUTS run still
    # waiting for them that they never will.
    pools_ready, aborted = threading.Event(), []

    def mark(name):
        marks[name] = time.perf_counter() - t0

    def start_node(key, ports=None):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_pool_node, args=(*key, sizes, arena_bytes, ports, dev, child),
                           daemon=True)
        proc.start()
        procs[key], conns[key] = proc, parent

    def ask(keys, cmd, timeout=120.0):
        return dict(zip(keys, _fed_ask([conns[k] for k in keys], cmd, timeout)))

    try:
        t0 = time.perf_counter()
        for key in lanes:
            start_node(key)

        # The NUTS run starts at once, on a thread of its own: its first
        # `replay_n` evaluations are answered from the federated run's
        # record of each group's requests and replies (each request held
        # bit for bit to the recorded one) and need no node, so they run
        # while the nodes start; its first pooled request waits until
        # this thread has built the pools and checked the values.
        tape = fed_line.get("_nuts_tape") or [[] for _ in range(POOL_GROUPS)]
        fed_evals = int(fed_line.get("nuts", {}).get("grad_evals") or 5_651)
        replay_n = min(int(POOL_REPLAYED_SHARE * fed_evals), *(len(t) for t in tape))
        # SIGKILL group 0's shm replica a third of the way into the pooled
        # evaluations and restart it on the same ports.
        kill_at = replay_n + max(1, (fed_evals - replay_n) // 3)
        replayed, replies, small_clients = [0] * POOL_GROUPS, [0] * POOL_GROUPS, []

        class Replayed:
            """Group ``g``'s client in the NUTS run: its first ``replay_n``
            requests answered from the record, then its pooled client,
            whose replies it counts."""

            def __init__(self, g):
                self.g = g

            def evaluate(self, *arrays):
                k = replayed[self.g]
                if k < replay_n:
                    key, reply = tape[self.g][k]
                    if _request_key(arrays) != key:
                        raise RuntimeError(f"group {self.g}'s request {k} differs from the "
                                           "federated run's: the trajectories diverged")
                    replayed[self.g] += 1
                    return [np.array(r, copy=True) for r in reply]
                if not pools_ready.wait(300) or aborted:
                    raise RuntimeError("the pools were not built")
                out = small_clients[self.g].evaluate(*arrays)
                replies[self.g] += 1
                return out

        small_post, close = _posterior_over([Replayed(g) for g in range(POOL_GROUPS)])
        closers.append(close)
        init = {k: torch.zeros((8,) if k == "offsets" else (), dtype=torch.float32, device=cpu)
                for k in ("intercept", "slope", "log_sigma", "offsets")}
        grad_evals, before_kill, restart, nuts_run, t_pooled = 0, {}, {}, {}, None

        def restart_victim():
            try:
                start_node(victim, nodes[victim]["ports"])
                restart.update(ask([victim], None, timeout=300.0)[victim])
            except Exception:
                restart["error"] = traceback.format_exc()

        def counted(p):
            nonlocal grad_evals, t_pooled
            grad_evals += 1
            if grad_evals == replay_n + 1:
                t_pooled = time.perf_counter()
            if grad_evals == kill_at:
                before_kill.update(ask(lanes, "counts"))
                restart["killed_at_s"] = time.perf_counter() - t0
                procs[victim].kill()  # SIGKILL: no shutdown, no unlink
                procs[victim].join(timeout=30)
                restart["thread"] = threading.Thread(target=restart_victim, daemon=True)
                restart["thread"].start()
            return small_post(p)

        def run_nuts():
            try:
                gen = torch.Generator(device=cpu).manual_seed(seed)
                t_nuts = time.perf_counter()
                nuts_run["res"] = pft.samplers.sample(
                    counted, init, generator=gen, num_warmup=nuts[1], num_samples=nuts[2],
                    num_chains=nuts[0])
                nuts_run["end"] = time.perf_counter()
                nuts_run["wall"] = nuts_run["end"] - t_nuts
            except Exception:
                nuts_run["error"] = traceback.format_exc()

        nuts_thread = threading.Thread(target=run_nuts, name="pool-nuts", daemon=True)
        nuts_thread.start()

        nodes.update(ask(lanes, None, timeout=300.0))
        spawn_s = time.perf_counter() - t0
        mark("spawn")
        on_card = all(n["cuda"].startswith(dev) for n in nodes.values())
        on_kernel = dev == "cuda"  # on the CPU the wrapper runs the plain version: no launches

        def make_pools(n_obs):
            out = []
            for g in range(POOL_GROUPS):
                # The default policy (p2c); a breaker trips on the first
                # failed call or probe, so the kill shows at once.
                pool = NodePool(transport="tcp", breaker_kwargs={"failure_threshold": 1})
                for key in lanes:
                    if key[0] == g:
                        pool.add_replica("127.0.0.1", nodes[key]["ports"][n_obs], transport=key[1],
                                         client_kwargs={"timeout_s": 120.0})
                pool.start()  # the probe thread
                pools.append(pool)
                out.append(pool)
            return out

        small_pools, large_pools = make_pools(small), make_pools(large)
        small_clients[:] = [PooledArraysClient(p) for p in small_pools]
        large_clients = [PooledArraysClient(p) for p in large_pools]

        # Values at 8 x 131,072: the federated phase's points, bit for bit.
        fed_points = {v["point"]: v for v in fed_line.get("values", {}).get("points", [])}
        flat0, unravel = ravel(init)
        _, true_offsets = pft.generate_node_data(8, n_obs=8, seed=123, device="cpu")
        truth = {"intercept": torch.tensor(TRUE["intercept"]), "slope": torch.tensor(TRUE["slope"]),
                 "log_sigma": torch.tensor(math.log(TRUE["sigma"])),
                 "offsets": torch.tensor(true_offsets, dtype=torch.float32)}
        points = {"origin": flat0, "perturbed": flat0 + 0.1 * torch.arange(11, dtype=torch.float32),
                  "truth": ravel(truth)[0]}
        large_post, close = _posterior_over(large_clients)
        closers.append(close)
        values = []
        for name, flat in points.items():
            bits = _flat_bits(*value_and_grad(large_post, unravel(flat)))
            ref = fed_points.get(name, {})
            want = [ref.get("remote_logp")] + list(ref.get("remote_grad", []))
            values.append({"point": name, "logp": bits[0], "bit_equal": bits == want})
        values_ok = len(values) == 3 and all(v["bit_equal"] for v in values)

        mark("values")
        victim_replica = small_pools[0].replica_at("127.0.0.1", nodes[victim]["ports"][small])
        breaker_log = []
        notify = victim_replica.breaker._on_transition

        def on_transition(old, new):
            breaker_log.append((round(time.perf_counter() - t0, 3), old, new))
            notify(old, new)

        victim_replica.breaker._on_transition = on_transition
        ask(lanes, "reset")
        pools_ready.set()
        nuts_thread.join(timeout=300)
        if nuts_thread.is_alive() or "error" in nuts_run:
            raise RuntimeError(f"the NUTS run failed:\n{nuts_run.get('error', 'still running')}")
        res, nuts_wall = nuts_run["res"], nuts_run["wall"]
        pooled_wall = nuts_run["end"] - t_pooled
        pooled = grad_evals - replay_n
        nuts_replies = list(replies)
        thread = restart.pop("thread", None)
        if thread is not None:
            thread.join(timeout=300)
        if "error" in restart:
            raise RuntimeError(f"the restarted node failed:\n{restart['error']}")
        after = ask(lanes, "counts")
        # The restarted replica's breaker closes (the probe thread or a call).
        deadline = time.perf_counter() + 60
        while victim_replica.breaker.state != "closed" and time.perf_counter() < deadline:
            value_and_grad(small_post, truth)
            time.sleep(0.05)
        s = res.samples
        max_rhat = max(float(v.max()) for v in pft.samplers.split_rhat(s).values())
        sha = _draws_sha256(s)
        served_before_kill = {f"{g}/{lane}": c["requests"] for (g, lane), c in before_kill.items()}
        # Node-side launches and requests: the victim's up to its kill,
        # everyone's (the restarted victim's from its start) after.
        node_requests = sum(c["requests"] for c in after.values()) + before_kill.get(victim, {}).get(
            "requests", 0)
        nuts_launches = sum(c["launches"] for c in after.values()) + before_kill.get(victim, {}).get(
            "launches", 0)
        # Open, then closed again: by a half-open trial call, or by a
        # probe of the restarted node (the probe thread closes an open
        # breaker whose node answers).
        states = [new for _, _, new in breaker_log]
        breaker_ok = ("open" in states and "closed" in states[states.index("open"):]
                      and victim_replica.breaker.state == "closed")
        # Exactly one reply per request, and each request computed once:
        # at the driver, every group's client returned one reply per
        # evaluation; at the nodes, the group's replicas served as many.
        one_reply = (all(r == pooled for r in nuts_replies) and pooled > 0
                     and node_requests == POOL_GROUPS * pooled
                     and replayed == [replay_n] * POOL_GROUPS)
        nuts_ok = (
            sha == fed_line.get("nuts", {}).get("draws_sha256") and one_reply and breaker_ok
            and len(before_kill) == len(lanes) and all(v >= 1 for v in served_before_kill.values())
            and max_rhat < 1.05 and (nuts_launches == node_requests or not on_kernel)
        )

        mark("nuts")
        # Windows at 8 x 131,072: W parameter sets per evaluate_many, each
        # reply against the same request alone; launches against windows.
        rng = np.random.default_rng(seed)
        window_reqs = {
            w: [(np.float32(1.5 + 0.1 * rng.normal()), np.float32(2.0 + 0.1 * rng.normal()),
                 np.float32(math.log(0.5) + 0.05 * rng.normal()),
                 (true_offsets + 0.05 * rng.normal(size=8)).astype(np.float32))
                for _ in range(w)] for w in windows}
        ask(lanes, "reset")
        window_ms, window_out = {}, {}
        for w, reqs in window_reqs.items():
            times = []
            for _ in range(POOL_WINDOW_REPS):
                for g, client in enumerate(large_clients):
                    share = [(a, b, c, o[2 * g:2 * g + 2]) for a, b, c, o in reqs]
                    ts = time.perf_counter()
                    out = client.evaluate_many(share, window=w)
                    times.append(time.perf_counter() - ts)
                    window_out.setdefault((w, g), []).append(out)
            window_ms[w] = statistics.median(times) * 1e3
        window_counts = ask(lanes, "counts")
        singles_ms, window_bits_ok = [], True
        for (w, g), outs in window_out.items():
            for i, (a, b, c, o) in enumerate(window_reqs[w]):
                ts = time.perf_counter()
                one = large_clients[g].evaluate(a, b, c, o[2 * g:2 * g + 2])
                singles_ms.append((time.perf_counter() - ts) * 1e3)
                for out in outs:
                    window_bits_ok &= all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
                                          for x, y in zip(out[i], one))
        per_replica = {
            f"{g}/{lane}": {"launches": c["launches"], **c["windows"], "window_sizes": c["window_sizes"]}
            for (g, lane), c in window_counts.items()}
        windows_launch_ok = sum(c["windows"]["vmapped"] for c in window_counts.values()) > 0 and all(
            c["windows"]["fallback"] == 0 and c["windows"]["serial"] == 0
            and (c["launches"] == c["windows"]["vmapped"] + c["windows"]["single"] or not on_kernel)
            for c in window_counts.values())
        window_launches = sum(c["launches"] for c in window_counts.values())

        mark("windows")
        # One request at the flagship size on each lane, straight through
        # its own client, and through a pool (group 1: shm + ring).
        probe = (np.float32(1.5), np.float32(2.0), np.float32(-0.7), np.zeros(2, np.float32))
        lane_ms = {}
        for lane, key in (("shm", (2, "shm")), ("ring", (1, "ring")), ("tcp", (2, "tcp"))):
            client = _lane_client(lane, nodes[key]["ports"][small])
            try:
                lane_ms[lane] = _median_ms(lambda: client.evaluate(*probe), POOL_LANE_CALLS)
            finally:
                client.close()
        lane_ms["pooled"] = _median_ms(lambda: small_clients[1].evaluate(*probe),
                                       POOL_LANE_CALLS)
        mark("lanes")
        # MicroBatcher in the driver's process, over the kernel on the card.
        data, _ = pft.generate_node_data(8, n_obs=large, seed=123, device="cpu")
        (x, y), mask = data.tree()
        kern = pft.linreg_logp_grad_fn(*(t.to(dev) for t in (x, y, mask)))

        def driver_logp_grad(intercept, slope, log_sigma, offsets):
            logp, g = kern({"intercept": intercept, "slope": slope, "log_sigma": log_sigma,
                            "offsets": offsets})
            return logp, (g["intercept"], g["slope"], g["log_sigma"], g["offsets"])

        compute = device_compute_fn(pft.wrap_logp_grad_fn(driver_logp_grad), device=dev,
                                    batched=True, max_batch=POOL_BATCHER_REQUESTS)
        batcher = MicroBatcher(compute, compute.batch, max_batch=POOL_BATCHER_REQUESTS)
        breqs = [(np.float32(1.5 + 0.1 * rng.normal()), np.float32(2.0 + 0.1 * rng.normal()),
                  np.float32(math.log(0.5) + 0.05 * rng.normal()),
                  (true_offsets + 0.05 * rng.normal(size=8)).astype(np.float32))
                 for _ in range(POOL_BATCHER_REQUESTS)]
        asyncio.run(MicroBatcher(compute, compute.batch, max_batch=POOL_BATCHER_REQUESTS)
                    .submit_many(breqs[::-1]))  # warm the vmapped call
        _sync(dev)
        linreg_reductions.launches = 0
        ts = time.perf_counter()
        bout = asyncio.run(batcher.submit_many(breqs))
        _sync(dev)
        batcher_ms = (time.perf_counter() - ts) * 1e3
        batcher_launches = linreg_reductions.launches
        bstats = batcher.stats()
        batcher_bits = all(not isinstance(o, Exception) and all(
            np.asarray(u).tobytes() == np.asarray(v).tobytes() for u, v in zip(o, compute(*r)))
            for o, r in zip(bout, breqs))
        batcher_ok = (batcher_bits and bstats["fallbacks_total"] == 0 and bstats["batches_total"] >= 1
                      and (batcher_launches == bstats["batches_total"] or not on_kernel))

        mark("batcher")
        # Fleet telemetry: the collector over the 8 exporters (probes off,
        # so no request moves while it scrapes).
        for pool in pools:
            pool.stop()
        nodes[victim].update(restart)
        fleet_counts = ask(lanes, "counts")
        targets = {f"127.0.0.1:{nodes[k]['ports'][small]}": ("127.0.0.1", nodes[k]["ports"]["exporter"])
                   for k in lanes}
        engine = BurnRateEngine(Slo(p99_s=POOL_SLO_P99_S), windows_s=(60.0,))
        collector = FleetCollector(http_targets=targets, interval_s=3600.0,
                                   observers=[engine.observe]).start()
        try:
            snap = collector.scrape_once()  # the engine's first sample too
            merged_requests = sum(
                c["value"] for a, sc in snap.replicas.items() if a in targets
                for c in sc.metrics.get("pftpu_server_requests_total", {}).get("children", []))
            own_requests = sum(c["requests_total"] for c in fleet_counts.values())
            # A short traced pooled run, then its critical path.
            spans.set_enabled(True)
            try:
                spans.clear_traces()
                reunion.clear()
                for _ in range(POOL_TRACED_EVALS):
                    value_and_grad(small_post, truth)
                report = critpath.analyze_recent()
            finally:
                spans.set_enabled(False)
            collector.scrape_once()  # the engine's second sample: the traced calls
            burn = engine.report() or {}
            bundle_dir = tempfile.mkdtemp(prefix="chip-smoke-bundle-")
            with open(watchdog.write_incident_bundle("pool-phase", dir=bundle_dir)) as fh:
                bundle = json.load(fh)
        finally:
            collector.stop()
        fleet_ok = (snap.complete and merged_requests == own_requests > 0
                    and isinstance(bundle.get("fleet"), list) and len(bundle["fleet"]) >= 1)
        mark("fleet")
        driver_syscalls = ring.syscall_counts()
        gates = {"on_card": on_card, "values": values_ok, "nuts": nuts_ok,
                 "window_bits": window_bits_ok, "window_launches": windows_launch_ok,
                 "batcher": batcher_ok, "fleet": fleet_ok}
        line = {
            "phase": "pool",
            "gates": gates,
            "nodes": [{"replica": f"{k[0]}/{k[1]}", "device": nodes[k]["device"],
                       "cuda": nodes[k]["cuda"], "pid": nodes[k]["pid"]} for k in lanes],
            "spawn_s": spawn_s, "marks_s": marks, "cpu_count": os.cpu_count(), "arena": arena,
            "futex_available": ring.futex_available(),
            "values": {"size": [8, large], "points": values, "bit_equal_to_federated": values_ok},
            "nuts": {"size": [8, small], "chains": nuts[0], "warmup": nuts[1], "draws": nuts[2],
                     "wall_s": nuts_wall, "grad_evals": grad_evals,
                     "replayed_evals": replay_n, "replayed_per_group": replayed,
                     "pooled_evals": pooled, "pooled_wall_s": pooled_wall,
                     "ms_per_grad_eval": pooled_wall * 1e3 / max(pooled, 1),
                     "federated_ms_per_grad_eval": fed_line.get("nuts", {}).get("ms_per_grad_eval"),
                     "draws_sha256": sha, "draws_equal_federated":
                         sha == fed_line.get("nuts", {}).get("draws_sha256"),
                     "replies_per_group": nuts_replies, "one_reply_per_request": one_reply,
                     "killed": f"{victim[0]}/{victim[1]}", "kill_at_eval": kill_at,
                     "killed_at_s": restart.get("killed_at_s"),
                     "served_before_kill": served_before_kill,
                     "breaker_transitions": breaker_log, "breaker_ok": breaker_ok,
                     "node_requests": node_requests,
                     "kernel_launches": nuts_launches, "max_split_rhat": max_rhat},
            "lanes_ms": {"size": [8, small], "calls": POOL_LANE_CALLS, **lane_ms},
            "windows": {"size": [8, large], "windows": list(windows), "reps": POOL_WINDOW_REPS,
                        "ms_per_window": window_ms,
                        "ms_per_request": {w: window_ms[w] / w for w in windows},
                        "single_ms": statistics.median(singles_ms),
                        "bit_equal_to_single": window_bits_ok, "per_replica": per_replica,
                        "launches_equal_windows": windows_launch_ok,
                        "kernel_launches": window_launches},
            "batcher": {"requests": POOL_BATCHER_REQUESTS, "kernel_launches": batcher_launches,
                        "ms": batcher_ms, "bit_equal_to_single": batcher_bits, "stats": bstats},
            "fleet": {"complete": snap.complete, "stale": snap.stale,
                      "merged_requests": merged_requests, "nodes_own_requests": own_requests,
                      "critpath": {k: report.get(k) for k in ("n_traces", "n_skipped",
                                                               "coverage_frac", "dominant_stage",
                                                               "stages")},
                      "slo": {"p99_s": POOL_SLO_P99_S, "burn_rate": burn.get("burn_rate"),
                              "violating": burn.get("violating")},
                      "bundle_fleet_sections": len(bundle.get("fleet") or [])},
            "syscalls": {"driver": driver_syscalls,
                         "ring_nodes": {f"{g}/{lane}": c["syscalls"] for (g, lane), c in
                                        fleet_counts.items() if lane == "ring"}},
            # Node-side launches of the NUTS run and the windows (the
            # kernel line adds them); the batcher's are the driver's.
            "kernel_launches": nuts_launches + window_launches,
        }
    finally:
        aborted.append(True)
        pools_ready.set()
        for close in closers:
            close()
        for pool in pools:
            pool.close()
        for c in conns.values():
            try:
                c.send("stop")
            except (OSError, ValueError):
                pass
        for proc in procs.values():
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
    mark("stop")
    # Every node has stopped (one of them by SIGKILL): no arena file of
    # this phase may remain.
    arena["left_after_stop"] = _arena_files(t_phase)
    gates["no_arena_left"] = not arena["left_after_stop"]
    return all(gates.values()), line


# The gateway phase: a tenant-fair front door (GatewayThread) over a
# NodePool of torch TCP nodes on the card, each serving the flagship
# logp+grad at 8 x 131,072 through the kernel, a window of requests per
# kernel launch.  Downstream: 128 connections of pipelined npwire frames
# from 4 tenants, offered at a fixed pace; the hog offers half of them,
# above its quota; 64 more frames carry spent deadlines.
GATEWAY_TENANTS = ("hog", "mouse-a", "mouse-b", "mouse-c")
GATEWAY_CONNECTIONS = 128  # even: the hog's; odd: a mouse's, in turn
GATEWAY_REQUESTS = 4096  # the hog 2,048; each mouse ~683
GATEWAY_EXPIRED = 64
GATEWAY_OFFER_S = 4.0  # the traffic is offered evenly over this many seconds
# Per-tenant quota: the hog offers 512/s against 384/s (denied about a
# quarter of its requests), a mouse ~171/s (never denied: its burst
# absorbs any bunching of its evenly paced frames).
GATEWAY_QUOTA = dict(quota_rate_per_s=384.0, quota_burst=64.0)
GATEWAY_RETRY_RATE = 256.0  # denied hog requests are retried at this pace (< quota)
GATEWAY_RETRY_ROUNDS = 6
GATEWAY_DISTINCT = 256  # distinct parameter sets; each is also sent alone
GATEWAY_MAX_BATCH = 64  # a node's padded-bucket ladder (a window holds at most 32)
GATEWAY_UPSTREAM_TIMEOUT_S = 10.0
GATEWAY_READ_TIMEOUT_S = 40.0  # a downstream reply later than this is a hang
GATEWAY_BURST = (32, 32)  # the autoscaler's pressure: tenants x requests, unpaced
GATEWAY_SCALE_UP_DEPTH = 16.0
GATEWAY_AFTER = 512  # requests offered after the scale-up, over 1 s


def _gateway_node(name, n_obs, port, dev, shared, conn):
    """One gateway replica process: all 8 shards of
    ``generate_node_data(8, n_obs, seed=123)``, rebuilt here on ``dev``,
    served by ``device_compute_fn(..., batched=True)`` over the kernel
    with ``serve_tcp_once`` on ``port`` (0: ephemeral).  It warms its
    vmapped path at every window shape, sets its launch count to 0,
    reports, and binds only when told to; ``shared`` holds its kernel
    launches, requests computed and windows since the last count reset,
    updated after each call returns (so they survive a SIGKILL).  A
    ``"reset"`` command sets them all to 0."""
    sys.path.insert(0, str(ROOT))
    try:
        import threading

        import numpy as np

        import pytensor_federated_torch as pft
        from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
        from pytensor_federated_torch.service import device_compute_fn, serve_tcp_once

        if dev == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"gateway node {name} found no GPU")
        data, _ = pft.generate_node_data(8, n_obs=n_obs, seed=123, device="cpu")
        (x, y), mask = data.tree()
        kern = pft.linreg_logp_grad_fn(*(t.to(dev) for t in (x, y, mask)))

        def node_logp_grad(intercept, slope, log_sigma, offsets):
            logp, g = kern({"intercept": intercept, "slope": slope, "log_sigma": log_sigma,
                            "offsets": offsets})
            return logp, (g["intercept"], g["slope"], g["log_sigma"], g["offsets"])

        compute = device_compute_fn(pft.wrap_logp_grad_fn(node_logp_grad), device=dev,
                                    batched=True, max_batch=GATEWAY_MAX_BATCH)
        probe = (np.float32(1.5), np.float32(2.0), np.float32(-0.7), np.zeros(8, np.float32))
        compute(*probe)
        for w in (2, 4, 8, 16, 32):  # every padded window shape up to a frame
            compute.batch([probe] * w)
        linreg_reductions.launches = 0
        single, batch = compute, compute.batch

        def count(n):
            with shared.get_lock():
                shared[0] = linreg_reductions.launches
                shared[1] += n
                shared[2] += 1

        def counted(*arrays):
            out = single(*arrays)
            count(1)
            return out

        def counted_batch(requests):
            out = batch(requests)
            count(len(requests))
            return out

        counted.batch = counted_batch
        conn.send({"name": name, "built": True})
        if conn.recv() != "bind":
            return
        bound, ports = threading.Event(), []
        threading.Thread(target=serve_tcp_once, args=(counted,), daemon=True,
                         kwargs={"port": port, "concurrent": True,
                                 "ready_callback": lambda p: (ports.append(p), bound.set())}).start()
        if not bound.wait(60):
            raise RuntimeError(f"gateway node {name} did not bind a port")
        conn.send({"name": name, "port": ports[0], "pid": os.getpid(),
                   "device": torch.cuda.get_device_name() if dev == "cuda" else "cpu",
                   "cuda": str(compute.device)})
        while conn.recv() == "reset":  # counts to 0 just before a drive
            with shared.get_lock():
                linreg_reductions.launches = 0
                shared[0] = shared[1] = shared[2] = 0
            conn.send({"reset": True})
    except Exception:
        conn.send({"error": traceback.format_exc()})


async def _loop_lag(stop, out, tick_s=0.005):
    """Until ``stop`` (a ``threading.Event``) is set: the running loop's
    lag past each ``tick_s`` sleep, its worst (``max_s``, at ``at``, a
    ``perf_counter`` time) and the ticks later than 0.1 s, in ``out``."""
    import asyncio

    out.setdefault("max_s", 0.0)
    out.setdefault("over_100ms", 0)
    while not stop.is_set():
        t = time.perf_counter()
        await asyncio.sleep(tick_s)
        lag = time.perf_counter() - t - tick_s
        if lag > out["max_s"]:
            out["max_s"], out["at"] = lag, t
        out["over_100ms"] += lag > 0.1


def _gc_pause_recorder(out):
    """A ``gc.callbacks`` entry that keeps, per generation, the number of
    collections, their worst pause and its ``perf_counter`` time in
    ``out``."""
    started = []

    def callback(phase, info):
        if phase == "start":
            started[:] = [time.perf_counter()]
            return
        if not started:
            return
        dt = time.perf_counter() - started[0]
        rec = out.setdefault(f"gen{info['generation']}", {"n": 0, "max_ms": 0.0})
        rec["n"] += 1
        if dt * 1e3 > rec["max_ms"]:
            rec["max_ms"], rec["at"] = dt * 1e3, started[0]

    return callback


async def _drive_gateway(port, conns, on_sent=None, late=None, lag=None):
    """One round of downstream traffic: ``conns`` holds, per connection,
    its items (``id``, ``at`` seconds after the start, the ``frame``),
    each connection writing its frames at their times and reading the
    replies in order (the npwire FIFO contract).  Returns ``{id:
    (reply bytes or None, seconds from write to reply)}``; a reply that
    does not come within the read timeout is ``None`` (a hang).  With a
    ``late`` dict, each id's write lateness in seconds (written minus
    planned time) is kept in it; with a ``lag`` dict, this loop's lag
    (``_loop_lag``) over the round."""
    import asyncio
    import struct

    results = {}
    t0 = time.perf_counter()

    async def one(items):
        reader, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), 30)
        sent = asyncio.Queue()

        async def write():
            for it in items:
                delay = t0 + it["at"] - time.perf_counter()
                if delay > 0:
                    await asyncio.sleep(delay)
                writer.write(struct.pack("<I", len(it["frame"])) + it["frame"])
                now = time.perf_counter()
                if late is not None:
                    late[it["id"]] = now - t0 - it["at"]
                sent.put_nowait((it["id"], now))
                if on_sent is not None:
                    on_sent()
                await writer.drain()

        async def read():
            for k in range(len(items)):
                rid, ts = await sent.get()
                try:
                    (n,) = struct.unpack("<I", await asyncio.wait_for(
                        reader.readexactly(4), GATEWAY_READ_TIMEOUT_S))
                    body = await asyncio.wait_for(reader.readexactly(n), GATEWAY_READ_TIMEOUT_S)
                except (asyncio.TimeoutError, asyncio.IncompleteReadError, OSError):
                    for it in items[k:]:
                        results[it["id"]] = (None, None)
                    return
                results[rid] = (body, time.perf_counter() - ts)

        try:
            await asyncio.gather(write(), read())
        finally:
            writer.close()

    stop = threading.Event()
    monitor = asyncio.ensure_future(_loop_lag(stop, lag)) if lag is not None else None
    try:
        await asyncio.gather(*(one(items) for items in conns if items))
    finally:
        if monitor is not None:
            stop.set()
            await monitor
    return results, time.perf_counter() - t0


def phase_gateway(dev="cuda", n_obs=LARGE_PATH[1], requests=GATEWAY_REQUESTS,
                  offer_s=GATEWAY_OFFER_S, seed=7):
    import asyncio
    import collections
    import gc
    import importlib.util
    import struct
    import threading

    import numpy as np

    import pytensor_federated_torch as pft
    from pytensor_federated_torch.gateway import (
        OVERLOAD_ERROR_PREFIX, Autoscaler, GatewayThread, TenantFairness, is_overload_error,
    )
    from pytensor_federated_torch.routing import NodePool
    from pytensor_federated_torch.service import TcpArraysClient
    from pytensor_federated_torch.service.deadline import is_deadline_error
    from pytensor_federated_torch.service.npwire import decode_arrays_all, encode_arrays
    from pytensor_federated_torch.telemetry import metrics, spans

    t_phase = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_phase

    ctx = _node_context()
    nodes = {}  # name -> {"proc", "conn", "shared", "info"}; lives kept in `lives`
    lives = collections.defaultdict(list)  # name -> [node record per life]

    def launch(name, port=0):
        parent, child = ctx.Pipe()
        shared = ctx.Array("q", 3)
        proc = ctx.Process(target=_gateway_node, args=(name, n_obs, port, dev, shared, child),
                           daemon=True)
        proc.start()
        rec = {"name": name, "proc": proc, "conn": parent, "shared": shared}
        lives[name].append(rec)
        nodes[name] = rec
        return rec

    def expect(rec, key, timeout=300.0):
        if not rec["conn"].poll(timeout):
            raise TimeoutError(f"gateway node {rec['name']} did not answer within {timeout} s")
        msg = rec["conn"].recv()
        if "error" in msg:
            raise RuntimeError(f"gateway node {rec['name']} failed:\n{msg['error']}")
        assert key in msg, msg
        return msg

    def bind(rec):
        rec["conn"].send("bind")
        rec["info"] = expect(rec, "port", timeout=120.0)
        return rec["info"]["port"]

    def counts(rec):
        with rec["shared"].get_lock():
            return {"launches": rec["shared"][0], "requests": rec["shared"][1],
                    "windows": rec["shared"][2]}

    def stop(rec):
        try:
            rec["conn"].send("stop")
        except (OSError, ValueError):
            pass
        rec["proc"].join(timeout=30)
        if rec["proc"].is_alive():
            rec["proc"].kill()
            rec["proc"].join()

    pool = gw = scaler = None
    spans_were = spans.enabled()
    try:
        for name in ("A", "B"):
            launch(name)
        for name in ("A", "B"):
            expect(nodes[name], "built")
        ports = {name: bind(nodes[name]) for name in ("A", "B")}
        mark("spawn")
        on_card = all(r["info"]["cuda"].startswith(dev) for r in nodes.values())

        # The requests' parameter sets, and each sent alone to a node.
        rng = np.random.default_rng(seed)
        _, true_offsets = pft.generate_node_data(8, n_obs=8, seed=123, device="cpu")
        params = [(np.float32(1.5 + 0.1 * rng.normal()), np.float32(2.0 + 0.1 * rng.normal()),
                   np.float32(math.log(0.5) + 0.05 * rng.normal()),
                   (true_offsets + 0.05 * rng.normal(size=8)).astype(np.float32))
                  for _ in range(GATEWAY_DISTINCT)]
        alone = {}
        for name in ("A", "B"):
            client = TcpArraysClient("127.0.0.1", ports[name], timeout_s=120.0)
            try:
                picks = range(GATEWAY_DISTINCT) if name == "A" else range(16)
                alone[name] = {d: b"".join(np.asarray(o).tobytes() for o in client.evaluate(*params[d]))
                               for d in picks}
            finally:
                client.close()
        replicas_agree = all(alone["B"][d] == alone["A"][d] for d in alone["B"])
        reference = alone["A"]
        mark("reference")

        # The pool (round robin, so every live replica takes windows; a
        # breaker opens on the first failed window; the probe thread
        # closes it once a restarted node answers) and the gateway.
        pool = NodePool([("127.0.0.1", ports[n]) for n in ("A", "B")], transport="tcp",
                        policy="round_robin", probe_interval_s=0.25,
                        breaker_kwargs={"failure_threshold": 1})
        ok_windows = collections.Counter()  # (replica port, life) -> windows answered
        ok_requests = collections.Counter()
        failed_windows = collections.Counter()
        life_of = {ports[n]: (n, 0) for n in ("A", "B")}
        record = pool.record_result

        def counting_record(replica, ok, *, latency_s=None, n_requests=1):
            # The gateway reports every upstream window here (the probe
            # thread does not): a success with its latency, a failure.
            key = life_of.get(replica.port, (replica.address, 0))
            if ok and latency_s is not None:
                ok_windows[key] += 1
                ok_requests[key] += n_requests
            elif not ok:
                failed_windows[key] += 1
            return record(replica, ok, latency_s=latency_s, n_requests=n_requests)

        pool.record_result = counting_record
        pool.start()
        spans.set_enabled(True)  # the gateway's metric families count with telemetry on
        gw = GatewayThread(pool, fairness=TenantFairness(**GATEWAY_QUOTA),
                           upstream_timeout_s=GATEWAY_UPSTREAM_TIMEOUT_S)
        gw_port = gw.start()
        hist = {k: metrics.REGISTRY.get(k) for k in ("pftpu_gateway_window_requests",
                                                      "pftpu_gateway_upstream_seconds",
                                                      "pftpu_gateway_queue_wait_seconds")}
        shed = metrics.REGISTRY.get("pftpu_gateway_shed_total").labels(reason="expired_arrival")
        base = {"windows": hist["pftpu_gateway_window_requests"].count,
                "window_reqs": hist["pftpu_gateway_window_requests"].sum,
                "upstream_n": hist["pftpu_gateway_upstream_seconds"].count,
                "upstream_s": hist["pftpu_gateway_upstream_seconds"].sum,
                "shed": shed.value}
        for name in ("A", "B"):  # counts to 0 just before the drive
            nodes[name]["conn"].send("reset")
            expect(nodes[name], "reset")

        uid_of = lambda rnd, rid: struct.pack("<QQ", rnd, rid)
        tenant_of, distinct_of, at_of = {}, {}, {}

        def plan(rnd, items_by_tenant, conn_ids, pace_s, deadline_s=None):
            """Connections' item lists: each tenant's items evenly over
            ``pace_s`` seconds, dealt round robin over its connections."""
            conns = {c: [] for ids in conn_ids.values() for c in ids}
            for tenant, items in items_by_tenant.items():
                ids = conn_ids[tenant]
                for i, (rid, d) in enumerate(items):
                    p = params[d]
                    frame = encode_arrays(list(p), uuid=uid_of(rnd, rid), tenant=tenant,
                                          deadline_s=deadline_s.get(rid) if deadline_s else None)
                    tenant_of[(rnd, rid)], distinct_of[(rnd, rid)] = tenant, d
                    at_of[(rnd, rid)] = i * pace_s / max(len(items), 1)
                    conns[ids[i % len(ids)]].append(
                        {"id": (rnd, rid), "at": at_of[(rnd, rid)], "frame": frame})
            for items in conns.values():
                items.sort(key=lambda it: it["at"])
            return list(conns.values())

        conn_ids = {"hog": [c for c in range(GATEWAY_CONNECTIONS) if c % 2 == 0]}
        for m, tenant in enumerate(GATEWAY_TENANTS[1:]):
            conn_ids[tenant] = [c for c in range(GATEWAY_CONNECTIONS) if c % 2 and (c // 2) % 3 == m]
        by_tenant = {t: [] for t in GATEWAY_TENANTS}
        for rid in range(requests):
            tenant = "hog" if rid % 2 == 0 else GATEWAY_TENANTS[1 + (rid // 2) % 3]
            by_tenant[tenant].append((rid, rid % GATEWAY_DISTINCT))
        expired = {}
        for k in range(GATEWAY_EXPIRED):  # spread over the tenants and the offer
            rid = requests + k
            tenant = GATEWAY_TENANTS[k % 4]
            by_tenant[tenant].insert((k * len(by_tenant[tenant])) // GATEWAY_EXPIRED,
                                     (rid, rid % GATEWAY_DISTINCT))
            expired[rid] = 0.0  # a spent budget

        # A third of the way in, SIGKILL node A and restart it on its port.
        sent = [0]
        kill = {}

        def restart_a():
            try:
                rec = launch("A", ports["A"])
                expect(rec, "built")
                life_of[ports["A"]] = ("A", 1)  # before it can serve a window
                bind(rec)
                kill["restarted_at_s"] = time.perf_counter() - t_phase
            except Exception:
                kill["error"] = traceback.format_exc()

        def on_sent():
            sent[0] += 1
            if sent[0] == requests // 3:
                kill["at_sent"] = sent[0]
                kill["killed_at_s"] = time.perf_counter() - t_phase
                lives["A"][0]["proc"].kill()  # SIGKILL: no shutdown
                kill["thread"] = threading.Thread(target=lambda: (lives["A"][0]["proc"].join(30),
                                                                  restart_a()), daemon=True)
                kill["thread"].start()

        main_conns = plan(0, by_tenant, conn_ids, offer_s, expired)
        # The script's heap (earlier phases' objects, the planned frames)
        # is frozen out of the cyclic collector until the phase ends: a full
        # collection over it stalls the gateway's thread and the traffic's
        # loop alike, and the frames it holds back reach the gateway as one
        # bunch, past a mouse's burst.  A gateway process of its own holds
        # no such heap.
        t_collect = time.perf_counter()
        gc.collect()
        full_collect_ms = 1e3 * (time.perf_counter() - t_collect)
        gc.freeze()
        mark("planned")
        # What could bunch a tenant's evenly paced frames past its burst:
        # each write's lateness, the client's and the gateway's event-loop
        # lag, and this process's garbage-collector pauses, over the drive.
        late, client_lag, gw_lag, gc_pauses = {}, {}, {}, {}
        gw_stop = threading.Event()
        gw_monitor = asyncio.run_coroutine_threadsafe(_loop_lag(gw_stop, gw_lag), gw._loop)
        gc_callback = _gc_pause_recorder(gc_pauses)
        gc.callbacks.append(gc_callback)
        t_traffic = time.perf_counter()
        try:
            results, main_wall = asyncio.run(_drive_gateway(gw_port, main_conns, on_sent,
                                                            late=late, lag=client_lag))
        finally:
            gc.callbacks.remove(gc_callback)
            gw_stop.set()
            gw_monitor.result(timeout=10)
        mark("traffic")

        def classify(rid_key, reply):
            if reply is None:
                return "hang", None
            arrays, uuid, error, _tid, _sp = decode_arrays_all(reply)
            if uuid != uid_of(*rid_key):
                return "uuid", error
            if error is None:
                got = b"".join(np.asarray(a).tobytes() for a in arrays)
                return ("ok" if got == reference[distinct_of[rid_key]] else "wrong"), None
            if is_deadline_error(error):
                return "deadline", error
            if is_overload_error(error) and f"[tenant {tenant_of[rid_key]}]" in error:
                return "denied", error
            if is_overload_error(error):
                return "upstream", error  # the gateway's failover ran out
            return "error", error

        outcome = {k: classify(k, body) for k, (body, _) in results.items()}
        lat = collections.defaultdict(list)
        for k, (body, dt) in results.items():
            if outcome[k][0] == "ok":
                lat[tenant_of[k]].append(dt)

        # The hog's denied requests, retried at a pace under its quota
        # until each is answered.
        retry_rounds = []
        final_of = {rid: (0, rid) for rid, _ in by_tenant["hog"] if rid < requests}
        pending = [k for k, (o, _) in outcome.items() if o == "denied" and tenant_of[k] == "hog"]
        for rnd in range(1, GATEWAY_RETRY_ROUNDS + 1):
            if not pending:
                break
            items = [(k[1], distinct_of[k]) for k in pending]
            final_of.update({rid: (rnd, rid) for rid, _ in items})
            conns = plan(rnd, {"hog": items}, {"hog": conn_ids["hog"]},
                         len(items) / GATEWAY_RETRY_RATE)
            res, _ = asyncio.run(_drive_gateway(gw_port, conns))
            got = {k: classify(k, body) for k, (body, _) in res.items()}
            outcome.update(got)
            retry_rounds.append(collections.Counter(o for o, _ in got.values()))
            pending = [k for k, (o, _) in got.items() if o == "denied"]
        mark("retries")

        thread = kill.pop("thread", None)
        if thread is not None:
            thread.join(timeout=300)
        if "error" in kill:
            raise RuntimeError(f"the restarted node failed:\n{kill['error']}")
        a_replica = pool.replica_at("127.0.0.1", ports["A"])
        deadline = time.perf_counter() + 60
        while a_replica.breaker.state != "closed" and time.perf_counter() < deadline:
            time.sleep(0.05)
        mark("restart")

        # Autoscaling: a burst of unpaced requests builds the fair queue
        # past the threshold; the scaler's spawn starts node C on the card.
        spawning = threading.Event()

        def spawn_replica():
            spawning.set()
            rec = launch("C")
            expect(rec, "built")
            rec_port = bind(rec)
            ports["C"] = rec_port
            life_of[rec_port] = ("C", 0)
            return ("127.0.0.1", rec_port, rec)

        scaler = Autoscaler(pool, gw.server.signals, spawn_replica, stop, min_replicas=2,
                            max_replicas=3, scale_up_queue_depth=GATEWAY_SCALE_UP_DEPTH,
                            scale_down_queue_depth=-1.0, consecutive=1, cooldown_up_s=0.0,
                            warmup_timeout_s=120.0, drain_grace_s=0.5, interval_s=0.01,
                            transport="tcp")
        scaler.start()
        n_t, n_r = GATEWAY_BURST
        burst_tenants = [f"burst-{i}" for i in range(n_t)]
        bursts, burst_rps = 0, []
        t_scale = time.perf_counter()
        while not scaler.owned and time.perf_counter() - t_scale < 120.0:
            if not spawning.is_set() and bursts < 8:  # stop pressing once the spawn runs
                items = {t: [(i * n_r + j, (i * n_r + j) % GATEWAY_DISTINCT) for j in range(n_r)]
                         for i, t in enumerate(burst_tenants)}
                conns = plan(100 + bursts, items, {t: [i] for i, t in enumerate(burst_tenants)}, 0.0)
                res, wall = asyncio.run(_drive_gateway(gw_port, conns))
                outcome.update({k: classify(k, body) for k, (body, _) in res.items()})
                burst_rps.append(len(res) / wall)
                bursts += 1
            else:
                time.sleep(0.1)
        scale_up_s = time.perf_counter() - t_scale
        scaled = bool(scaler.owned)
        mark("scale_up")
        # Traffic after the scale-up: the new replica takes its share.
        items = {t: [(i, i % GATEWAY_DISTINCT) for i in range(m, GATEWAY_AFTER, 3)]
                 for m, t in enumerate(GATEWAY_TENANTS[1:])}
        res, after_wall = asyncio.run(_drive_gateway(
            gw_port, plan(200, items, {t: conn_ids[t] for t in items}, 1.0)))
        outcome.update({k: classify(k, body) for k, (body, _) in res.items()})
        c_rec = lives["C"][0] if lives["C"] else None
        scaler.stop(drain_owned=True)  # leaves the pool, then stop() reaps it
        c_drained = (c_rec is not None and not c_rec["proc"].is_alive()
                     and pool.replica_at("127.0.0.1", ports.get("C") or -1) is None)
        mark("after")

        # Each node life's own counts (the shared counters outlive a
        # SIGKILL), read just after the drive.
        node_counts = {f"{name}{life}": counts(rec)
                       for name, recs in lives.items() for life, rec in enumerate(recs)}
        c_counts = node_counts.get("C0", {"launches": 0, "requests": 0, "windows": 0})
        windows_sent = hist["pftpu_gateway_window_requests"].count - base["windows"]
        window_reqs = hist["pftpu_gateway_window_requests"].sum - base["window_reqs"]
        upstream_n = hist["pftpu_gateway_upstream_seconds"].count - base["upstream_n"]
        upstream_s = hist["pftpu_gateway_upstream_seconds"].sum - base["upstream_s"]
        launches = sum(c["launches"] for c in node_counts.values())
        node_requests = sum(c["requests"] for c in node_counts.values())
        # The window on node A when it was killed (if any) ran on A but was
        # answered by B after the failover: A's first life may count one
        # window (and its requests) more than the gateway saw answered.
        a0 = node_counts.get("A0", {})
        lost_windows = a0.get("windows", 0) - ok_windows[("A", 0)]
        lost_requests = a0.get("requests", 0) - ok_requests[("A", 0)]
        per_life_ok = all(
            node_counts[f"{n}{life}"]["windows"] == ok_windows[(n, life)]
            and node_counts[f"{n}{life}"]["requests"] == ok_requests[(n, life)]
            for n, life in [("A", 1), ("B", 0), ("C", 0)] if f"{n}{life}" in node_counts)
        on_kernel = dev == "cuda"
        launch_ok = (
            per_life_ok and lost_windows in (0, 1) and 0 <= lost_requests <= 32
            and (lost_windows > 0 or lost_requests == 0)
            and upstream_n == sum(ok_windows.values())
            and windows_sent == upstream_n + sum(failed_windows.values())
            and all((c["launches"] == c["windows"]) or not on_kernel for c in node_counts.values())
        )
        kinds = collections.Counter(o for o, _ in outcome.values())
        main = {k: outcome[k] for k in results}
        main_kinds = collections.Counter(o for o, _ in main.values())
        ok_replies = kinds["ok"]
        by_tenant_kind = {t: dict(collections.Counter(o for k, (o, _) in main.items()
                                                      if tenant_of[k] == t))
                          for t in GATEWAY_TENANTS}
        denials = [e for k, (o, e) in main.items() if o == "denied"]
        hog_denials = [e for k, (o, e) in main.items() if o == "denied" and tenant_of[k] == "hog"]
        hog_final = [outcome[key][0] for key in final_of.values()]
        fairness_ok = (
            len(hog_denials) > 0 and len(denials) == len(hog_denials)
            and all(e.startswith(OVERLOAD_ERROR_PREFIX) and "[tenant hog]" in e for e in hog_denials)
            and all(o == "ok" for o in hog_final)
        )
        expired_kinds = collections.Counter(main[(0, requests + k)][0] for k in range(GATEWAY_EXPIRED))
        shed_delta = shed.value - base["shed"]
        shed_ok = (expired_kinds == {"deadline": GATEWAY_EXPIRED} and shed_delta == GATEWAY_EXPIRED
                   and node_requests - max(lost_requests, 0) == ok_replies)
        correct_ok = kinds["wrong"] == 0 and kinds["uuid"] == 0 and kinds["error"] == 0
        failover_ok = (kinds["hang"] == 0 and node_counts.get("A1", {}).get("windows", 0) >= 1
                       and "killed_at_s" in kill)
        scale_ok = scaled and c_counts["windows"] >= 1 and c_drained
        upstream_failed = sum(failed_windows.values())
        q = lambda v, p: float(np.quantile(v, p)) * 1e3 if v else None
        # Seconds are from the phase's start, as marks_s and failover are.
        since = lambda t: None if t is None else t - t_phase
        stalls = {
            "write_late_ms": {t: {"max": 1e3 * max((v for k, v in late.items() if tenant_of[k] == t),
                                                   default=0.0),
                                  "over_100ms": sum(v > 0.1 for k, v in late.items()
                                                    if tenant_of[k] == t)}
                              for t in GATEWAY_TENANTS},
            "client_loop_lag": {"max_ms": 1e3 * client_lag["max_s"],
                                "at_s": since(client_lag.get("at")),
                                "over_100ms": client_lag["over_100ms"]},
            "gateway_loop_lag": {"max_ms": 1e3 * gw_lag["max_s"], "at_s": since(gw_lag.get("at")),
                                 "over_100ms": gw_lag["over_100ms"]},
            "gc": {g: {**r, "at": since(r.get("at"))} for g, r in gc_pauses.items()},
            # The frozen heap, and one full collection over it (what a
            # collection during the drive would have stalled).
            "gc_frozen_objects": gc.get_freeze_count(),
            "gc_full_collection_ms": full_collect_ms,
            "mouse_denials": [{"tenant": tenant_of[k], "planned_s": since(t_traffic) + at_of[k],
                               "late_ms": 1e3 * late[k] if k in late else None, "error": e}
                              for k, (o, e) in main.items()
                              if o == "denied" and tenant_of[k] != "hog"][:16],
        }
        smi = _nvidia_smi() if dev == "cuda" else "cpu"
        gates = {"on_card": on_card, "replicas_agree": replicas_agree, "correct": correct_ok,
                 "one_launch_per_window": launch_ok,
                 "coalesced": window_reqs / max(windows_sent, 1) > 1.0, "fairness": fairness_ok,
                 "deadline_shed": shed_ok, "failover": failover_ok, "autoscale": scale_ok}
        line = {
            "phase": "gateway", "gates": gates, "card": smi, "size": [8, n_obs],
            # Whether grpcio is installed here (looked up, not imported:
            # this script runs no gRPC).
            "grpcio_installed": importlib.util.find_spec("grpc") is not None,
            "nodes": {f"{n}{i}": {k: r.get("info", {}).get(k) for k in ("pid", "device", "cuda")}
                      for n, recs in lives.items() for i, r in enumerate(recs)},
            "marks_s": marks, "cpu_count": os.cpu_count(),
            "traffic": {"connections": GATEWAY_CONNECTIONS, "requests": requests,
                        "expired": GATEWAY_EXPIRED, "offer_s": offer_s, "quota": GATEWAY_QUOTA,
                        "wall_s": main_wall, "requests_per_s": len(results) / main_wall,
                        "outcomes": dict(main_kinds), "by_tenant": by_tenant_kind},
            "latency_ms": {t: {"n": len(v), "p50": q(v, 0.5), "p99": q(v, 0.99)}
                           for t, v in lat.items()},
            "windows": {"sent": windows_sent, "answered": upstream_n,
                        "failed_attempts": dict((f"{n}{l}", v) for (n, l), v in failed_windows.items()),
                        "requests_per_window": window_reqs / max(windows_sent, 1),
                        "ms_per_window": upstream_s * 1e3 / max(upstream_n, 1),
                        # Bucketed quantiles over the whole phase: the fair
                        # queue's wait, and the upstream round trip (which
                        # includes the wait for the replica's connection,
                        # one window in flight on each).
                        "queue_wait_ms": {f"p{int(p * 100)}": 1e3 * hist[
                            "pftpu_gateway_queue_wait_seconds"].approx_quantile(p) for p in (0.5, 0.99)},
                        "upstream_ms": {f"p{int(p * 100)}": 1e3 * hist[
                            "pftpu_gateway_upstream_seconds"].approx_quantile(p) for p in (0.5, 0.99)},
                        "answered_per_node_life": {f"{n}{l}": v for (n, l), v in ok_windows.items()},
                        "lost_in_kill": {"windows": lost_windows, "requests": lost_requests}},
            "nodes_counts": node_counts,
            "failover": {"killed_at_s": kill.get("killed_at_s"), "at_sent": kill.get("at_sent"),
                         "restarted_at_s": kill.get("restarted_at_s"),
                         "upstream_failed": upstream_failed,
                         "in_band_upstream_errors": kinds["upstream"], "hangs": kinds["hang"],
                         "restarted_windows": node_counts.get("A1", {}).get("windows", 0)},
            "stalls": stalls,
            "retries": [dict(r) for r in retry_rounds],
            "deadline": {"shed_total_delta": shed_delta, "replies": dict(expired_kinds)},
            "autoscale": {"scaled_up": scaled, "seconds": scale_up_s, "bursts": bursts,
                          "burst_requests_per_s": burst_rps, "new_node": c_counts,
                          "drained": c_drained, "after_wall_s": after_wall},
            "replies": {"ok": ok_replies, **{k: v for k, v in kinds.items() if k != "ok"}},
            "node_requests": node_requests,
            "kernel_launches": launches,
        }
    finally:
        if scaler is not None:
            scaler.stop()
        if gw is not None:
            gw.stop()
        if pool is not None:
            pool.close()
        spans.set_enabled(spans_were)
        gc.unfreeze()
        for recs in lives.values():
            for rec in recs:
                if rec["proc"].is_alive():
                    stop(rec)
    mark("stop")
    return all(gates.values()), line


def _draws_sha256(samples):
    """sha256 of the draws' bytes, leaves in sorted order."""
    h = hashlib.sha256()
    for k in sorted(samples):
        h.update(samples[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _as_cpu(data, dtype=None):
    """A ``ShardedData``, a params dict or a tensor on the CPU, in
    ``dtype`` if given (float64: the inputs of a model's plain float64
    version)."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.utils import tree_map

    move = lambda t: t.detach().cpu() if dtype is None else t.detach().cpu().to(dtype)
    if torch.is_tensor(data):
        return move(data)
    if isinstance(data, dict):
        return tree_map(move, data)
    return pft.ShardedData(data=tree_map(move, data.data), mask=move(data.mask))


def _as_f64_cpu(data):
    return _as_cpu(data, torch.float64)


def _three_points(init, seed=5):
    """The origin (``init_params``), origin + 0.1 * arange, and a seeded
    normal perturbation of scale 0.3, as params trees."""
    from pytensor_federated_torch.samplers.util import ravel

    flat, unravel = ravel(init)
    gen = torch.Generator().manual_seed(seed)
    noise = 0.3 * torch.randn(flat.shape, generator=gen)
    steps = 0.1 * torch.arange(flat.shape[0], dtype=flat.dtype)
    return {"origin": init, "perturbed": unravel(flat + steps.to(flat.device)),
            "normal": unravel(flat + noise.to(flat.device))}


def _against_f64(model, model64, points, *, value_rtol=MODEL_VALUE_RTOL,
                 grad_rtol=MODEL_GRAD_RTOL, grad_atol_of_max=MODEL_GRAD_ATOL_OF_MAX,
                 value_atol=0.0):
    """A model's value and gradient on its device against its float64
    version on the CPU at each point; per point the relative value error,
    the largest gradient error as a share of its tolerance, and ok.  The
    value passes within ``value_rtol |v64| + value_atol``."""
    out, ok = [], True
    for name, p in points.items():
        v, g = model.logp_and_grad(p)
        v64, g64 = model64.logp_and_grad({k: t.detach().cpu().double() for k, t in p.items()})
        rel = abs(float(v) - float(v64)) / abs(float(v64))
        worst = 0.0
        for k in g64:
            err = (g[k].detach().cpu().double() - g64[k]).abs()
            tol = grad_rtol * g64[k].abs() + grad_atol_of_max * float(g64[k].abs().max())
            worst = max(worst, float((err / tol.clamp_min(1e-30)).max()))
        value_ok = abs(float(v) - float(v64)) <= value_rtol * abs(float(v64)) + value_atol
        point_ok = value_ok and worst <= 1.0 and math.isfinite(float(v))
        out.append({"point": name, "logp": float(v), "value_rel_err": rel,
                    "grad_err_over_tol": worst, "ok": point_ok})
        ok &= point_ok
    return ok, out


def _ms_per_eval(fn, dev, reps, warm=3):
    """Median host time of ``reps`` synchronised calls, after ``warm``
    warm-up calls."""
    for _ in range(warm):
        fn()
    _sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _launches(fn, dev, calls):
    """CUDA launches per call of ``fn`` by the profiler; None off the card."""
    return _cuda_launches_per_call(fn, calls)[0] if torch.device(dev).type == "cuda" else None


def _model_nuts(model, dev, seed, nuts=MODEL_NUTS, jitter=1.0, cuda_graph=False):
    """NUTS on ``model.logp`` with gradient evaluations (of the chain
    batch) counted; the run's draws, wall time, stats and min-ESS/s.
    With ``cuda_graph`` the evaluations replayed from the graph count
    too (beside the eager ones: the graph's warm-up and capture)."""
    import pytensor_federated_torch as pft

    grad_evals = 0

    def counted(p):
        nonlocal grad_evals
        grad_evals += 1
        return model.logp(p)

    chains, warmup, draws = nuts
    gen = torch.Generator(device=dev).manual_seed(seed)
    _sync(dev)
    t0 = time.perf_counter()
    res = pft.samplers.sample(counted, model.init_params(), generator=gen, num_warmup=warmup,
                              num_samples=draws, num_chains=chains, jitter=jitter,
                              cuda_graph=cuda_graph)
    _sync(dev)
    wall = time.perf_counter() - t0
    if cuda_graph:
        grad_evals += res.extra["graph_replays"]
    s = res.samples
    max_rhat = max(float(v.max()) for v in pft.samplers.split_rhat(s).values())
    min_ess = min(float(v.min()) for v in pft.samplers.effective_sample_size(s).values())
    return res, {
        "chains": chains, "warmup": warmup, "draws": draws, "jitter": jitter, "seed": seed,
        "wall_s": wall, "samples_per_s": chains * draws / wall,
        "min_ess": min_ess, "min_ess_per_s": min_ess / wall,
        "grad_evals": grad_evals, "ms_per_grad_eval": wall * 1e3 / max(grad_evals, 1),
        "mean_tree_depth": float(res.stats["depth"].float().mean()),
        "divergence_share": float(res.stats["diverging"].float().mean()),
        "max_split_rhat": max_rhat,
        "finite": all(bool(torch.isfinite(v).all()) for v in s.values()),
    }


def phase_radon(dev="cuda", nuts=MODEL_NUTS):
    """BASELINE config 3 on ``dev``: values against float64 on the CPU,
    time per evaluation, NUTS with the JAX test's recovery gate."""
    import pytensor_federated_torch as pft

    data, true = pft.generate_radon_data(**RADON, device=dev)
    model = pft.HierarchicalRadonGLM(data)
    model64 = pft.HierarchicalRadonGLM(_as_f64_cpu(data))
    values_ok, values = _against_f64(model, model64, _three_points(model.init_params()))
    p = model.init_params()
    ms = _ms_per_eval(lambda: model.logp_and_grad(p), dev, 50)
    launches = _launches(lambda: model.logp_and_grad(p), dev, 10)
    graph = torch.device(dev).type == "cuda"
    res, run = _model_nuts(model, dev, seed=11, nuts=nuts, cuda_graph=graph)
    run["cuda_graph"] = graph
    beta_median = float(res.samples["beta"].median())
    run["beta_median"], run["beta_true"] = beta_median, true["beta"]
    ok = (values_ok and run["finite"] and run["divergence_share"] < 0.1
          and abs(beta_median - true["beta"]) < 0.3 and run["max_split_rhat"] < 1.1)
    return ok, {
        "phase": "radon", "config": "BASELINE.json config 3, bench_suite.py:713",
        "size": {"counties": data.n_shards, "max_obs": data.max_len,
                 "observations": int(data.mask.sum()),
                 "params": sum(t.numel() for t in model.init_params().values())},
        "tolerance": {"value_rtol": MODEL_VALUE_RTOL, "grad_rtol": MODEL_GRAD_RTOL,
                      "grad_atol": f"{MODEL_GRAD_ATOL_OF_MAX} x max|grad of the leaf|",
                      "against": "the same model in float64 on the CPU"},
        "values": values,
        "ms_per_logp_and_grad": ms,
        "cuda_launches_per_logp_and_grad": launches,
        "nuts": run,
        "gates": "finite, divergence share < 0.1, |median beta - true| < 0.3, split R-hat < 1.1",
    }


def phase_logistic(dev="cuda", nuts=CONFIG8_NUTS, large_obs=LOGISTIC_LARGE_OBS):
    """BASELINE config 5 on ``dev``: the three exact forms behind
    bench_suite's equality gate, the hierarchical model and the bf16
    compute dtype against float64 on the CPU, times per evaluation at two
    sizes; then config 8, NUTS on the plain form with its chains in
    lockstep."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.samplers.util import ravel

    forms = {"vmapped": {}, "suffstats": {"use_suffstats": True}, "flat": {"flatten": True}}
    data, true = pft.generate_logistic_data(**LOGISTIC, device=dev)
    models = {name: pft.FederatedLogisticRegression(data, **kw) for name, kw in forms.items()}
    plain = models["vmapped"]
    flat0, unravel = ravel(plain.init_params())
    gate, gate_ok = [], True
    for name, x in (("x0", flat0), ("x0+0.1*arange", flat0 + 0.1 * torch.arange(
            flat0.shape[0], dtype=flat0.dtype, device=flat0.device))):
        ref = plain.logp_and_grad(unravel(x))
        for other in ("suffstats", "flat"):
            o_ok, err = _flat_close(models[other].logp_and_grad(unravel(x)), ref)
            gate.append({"point": name, "form": other, **err, "ok": o_ok})
            gate_ok &= o_ok

    data64 = _as_f64_cpu(data)
    plain_ok, plain_values = _against_f64(plain, pft.FederatedLogisticRegression(data64),
                                          _three_points(plain.init_params()))
    bf16 = pft.FederatedLogisticRegression(data, compute_dtype=torch.bfloat16)
    bf16_ok, bf16_values = _against_f64(
        bf16, pft.FederatedLogisticRegression(data64), _three_points(plain.init_params()),
        value_rtol=BF16_VALUE_RTOL, grad_rtol=BF16_GRAD_TOL, grad_atol_of_max=BF16_GRAD_TOL)
    hdata, _ = pft.generate_hier_logistic_data(**LOGISTIC, device=dev)
    hier = pft.HierarchicalLogisticRegression(hdata)
    hier_ok, hier_values = _against_f64(hier, pft.HierarchicalLogisticRegression(_as_f64_cpu(hdata)),
                                        _three_points(hier.init_params()))

    timing = {}
    for n_obs in (LOGISTIC["n_obs"], large_obs):
        tdata = data if n_obs == LOGISTIC["n_obs"] else pft.generate_logistic_data(
            **{**LOGISTIC, "n_obs": n_obs}, device=dev)[0]
        row = {"x_bytes": int(tdata.data[0].numel()) * 4}
        for name, kw in forms.items():
            m = models[name] if tdata is data else pft.FederatedLogisticRegression(tdata, **kw)
            p = m.init_params()
            row[name + "_ms"] = _ms_per_eval(lambda: m.logp_and_grad(p), dev, 50)
            row[name + "_cuda_launches"] = _launches(lambda: m.logp_and_grad(p), dev, 10)
        timing[f"{LOGISTIC['n_shards']}x{n_obs}x{LOGISTIC['n_features']}"] = row
        del tdata

    res, run = _model_nuts(plain, dev, seed=CONFIG8_SEED, nuts=nuts, jitter=CONFIG8_JITTER)
    run["max_rhat_w"] = float(pft.samplers.split_rhat(res.samples)["w"].max())
    recovered = {}
    for name, want in (("w", torch.as_tensor(true["w"], dtype=torch.float32)),
                       ("b", torch.tensor(true["b"], dtype=torch.float32))):
        d = res.samples[name].reshape(-1, *want.shape).cpu()
        mean, sd = d.mean(0), d.std(0)
        recovered[name] = {"mean": mean.tolist(), "sd": sd.tolist(), "true": want.tolist(),
                           "within_4sd": bool(((mean - want).abs() <= 4 * sd).all())}
    run["recovered"] = recovered
    ok = (gate_ok and plain_ok and bf16_ok and hier_ok and run["finite"]
          and run["max_split_rhat"] < 1.1 and run["max_rhat_w"] < 1.2
          and all(r["within_4sd"] for r in recovered.values()))
    return ok, {
        "phase": "logistic", "config": "BASELINE.json config 5, bench_suite.py:747",
        "size": LOGISTIC,
        "equality_gate": {"tolerance": {"value_rtol": AUTOGRAD_RTOL_VALUE,
                                        "grad_rtol": AUTOGRAD_RTOL_GRAD,
                                        "grad_atol": AUTOGRAD_ATOL_GRAD,
                                        "source": "bench_suite.py's equality gate"},
                          "points": gate},
        "tolerance": {"value_rtol": MODEL_VALUE_RTOL, "grad_rtol": MODEL_GRAD_RTOL,
                      "grad_atol": f"{MODEL_GRAD_ATOL_OF_MAX} x max|grad of the leaf|",
                      "bf16": {"value_rtol": BF16_VALUE_RTOL, "grad_rtol": BF16_GRAD_TOL,
                               "grad_atol": f"{BF16_GRAD_TOL} x max|grad of the leaf|"},
                      "against": "the plain form in float64 on the CPU"},
        "vmapped_vs_f64": plain_values,
        "bf16_vs_f64": bf16_values,
        "hierarchical_vs_f64": hier_values,
        "timing": timing,
        "nuts": {**run, "config": "bench_suite.py config 8 (:982)"},
        "gates": "equality gate, values, finite, split R-hat < 1.1 (and of w < 1.2, "
                 "bench_suite's), every w and b within 4 sd",
    }


def phase_lv_ode(dev="cuda", reps=20):
    """BASELINE config 4 on ``dev``: values against float64 on the CPU,
    time and CUDA launches per evaluation, and find_map against its
    float64 run on the CPU."""
    import pytensor_federated_torch as pft

    model, meta = pft.make_lv_model(LV_SHARDS, device=dev)
    model64 = pft.LotkaVolterraModel(_as_f64_cpu(model.observations), meta["y0"], meta["dt"],
                                     meta["n_steps"], meta["obs_idx"])
    values_ok, values = _against_f64(model, model64, _three_points(model.init_params()))
    p = model.init_params()
    ms = _ms_per_eval(lambda: model.logp_and_grad(p), dev, reps)
    launches = _launches(lambda: model.logp_and_grad(p), dev, 1)
    _sync(dev)
    t0 = time.perf_counter()
    est = model.find_map(**LV_FIND_MAP)
    _sync(dev)
    map_s = time.perf_counter() - t0
    est64 = pft.samplers.find_map(
        model64.logp, {k: v.cpu().double() for k, v in model.init_params().items()}, **LV_FIND_MAP)
    map_err = float((est["log_theta"].cpu().double() - est64["log_theta"]).abs().max())
    ok = values_ok and map_err <= LV_FIND_MAP_ATOL and (
        launches is not None or torch.device(dev).type != "cuda")
    return ok, {
        "phase": "lv_ode", "config": "BASELINE.json config 4, bench_suite.py:722",
        "size": {"shards": LV_SHARDS, "obs": len(meta["obs_idx"]), "species": 2,
                 "rk4_steps": meta["n_steps"]},
        "tolerance": {"value_rtol": MODEL_VALUE_RTOL, "grad_rtol": MODEL_GRAD_RTOL,
                      "grad_atol": f"{MODEL_GRAD_ATOL_OF_MAX} x max|grad of the leaf|",
                      "find_map_log_theta_atol": LV_FIND_MAP_ATOL,
                      "against": "the same model in float64 on the CPU"},
        "values": values,
        "ms_per_logp_and_grad": ms,
        "timed_evals": reps,
        "cuda_launches_per_logp_and_grad": launches,
        "find_map": {**LV_FIND_MAP, "wall_s": map_s, "log_theta": est["log_theta"].tolist(),
                     "log_theta_f64_cpu": est64["log_theta"].tolist(),
                     "max_abs_err": map_err, "theta_true": meta["theta"].tolist()},
    }


def phase_wide_logistic(dev="cuda", reps=WIDE_TIMED_EVALS, wide=WIDE, chains=WIDE_CHAINS):
    """Config 7: one batched value+grad of ``chains`` chains per form on
    the wide logistic regression, each chain against the float32_strict
    form at bench_suite's gates; time per batched evaluation and its
    share of the matching dense peak."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.samplers.mcmc import (
        make_batch_logp_and_grad,
        make_flat_logp_and_grad,
    )

    data, _ = pft.generate_logistic_data(**wide, device=dev)
    forms = {"f32": None, "bf16": torch.bfloat16, "f32_strict": "float32_strict"}
    lgs = {}
    for name, compute_dtype in forms.items():
        model = pft.FederatedLogisticRegression(data, compute_dtype=compute_dtype)
        flat_logp, flat0, unravel, _ = make_flat_logp_and_grad(model.logp, model.init_params())
        lgs[name] = make_batch_logp_and_grad(flat_logp, unravel)
    g = torch.Generator(device=dev).manual_seed(3)
    x = flat0[None] + WIDE_JITTER * torch.randn((chains, flat0.shape[0]), generator=g, device=dev)
    out = {name: lg(x) for name, lg in lgs.items()}
    v_s, g_s = (t.double() for t in out["f32_strict"])
    atol = WIDE_GRAD_TOL * float(g_s.abs().max())
    gates, gates_ok = {}, True
    for name in ("f32", "bf16"):
        v, gr = (t.double() for t in out[name])
        v_err = float(((v - v_s).abs() / v_s.abs()).max())
        g_ratio = float(((gr - g_s).abs() / (atol + WIDE_GRAD_TOL * g_s.abs())).max())
        finite = bool(torch.isfinite(v).all() and torch.isfinite(gr).all())
        gates[name] = {"value_max_rel_err": v_err, "grad_err_over_tol": g_ratio,
                       "ok": finite and v_err <= WIDE_VALUE_RTOL and g_ratio <= 1.0}
        gates_ok &= gates[name]["ok"]
    S, N, F = wide["n_shards"], wide["n_obs"], wide["n_features"]
    # X @ w for every chain forward, and the product behind d/dw backward.
    flop = 2 * (2 * S * N * F * chains)
    f32_peak = _peak(torch.cuda.get_device_name(0) if torch.device(dev).type == "cuda" else "")[2]
    timing = {}
    for name, lg in lgs.items():
        ms = _ms_per_eval(lambda: lg(x), dev, reps)
        peak = _BF16_PEAK if name == "bf16" else f32_peak
        timing[name] = {"ms_per_batched_eval": ms, "gflop_per_s": flop / (ms * 1e-3) / 1e9,
                        "share_of_peak": flop / (ms * 1e-3) / peak,
                        "peak": "bf16 tensor cores" if name == "bf16" else "float32, no tensor cores",
                        "cuda_launches_per_eval": _launches(lambda: lg(x), dev, 3)}
    return gates_ok, {
        "phase": "wide_logistic", "config": "bench_suite.py config 7 (:878)",
        "size": {**wide, "chains": chains, "x_bytes": S * N * F * 4},
        "flop_per_batched_eval": flop,
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
        "tolerance": {"value_rtol": WIDE_VALUE_RTOL, "grad_rtol": WIDE_GRAD_TOL,
                      "grad_atol": f"{WIDE_GRAD_TOL} x max|grad of f32_strict|",
                      "anchor": "f32_strict", "source": "bench_suite.py:929-939"},
        "gates": gates,
        "timing": timing,
    }


def phase_chees(nuts_line, dev="cuda", chees=CONFIG9_CHEES):
    """Config 9: ChEES-HMC on config 5's posterior; min-ESS/s against
    config 8's NUTS of the same run (``nuts_line``: the logistic phase's
    ``nuts`` record)."""
    import pytensor_federated_torch as pft

    data, _ = pft.generate_logistic_data(**LOGISTIC, device=dev)
    model = pft.FederatedLogisticRegression(data)
    chains, warmup, draws = chees
    gen = torch.Generator(device=dev).manual_seed(CONFIG9_SEED)
    _sync(dev)
    t0 = time.perf_counter()
    res = pft.samplers.chees_sample(model.logp, model.init_params(), generator=gen,
                                    num_warmup=warmup, num_samples=draws, num_chains=chains,
                                    jitter=CONFIG9_JITTER)
    _sync(dev)
    wall = time.perf_counter() - t0
    s = res.samples
    max_rhat = max(float(v.max()) for v in pft.samplers.split_rhat(s).values())
    min_ess = min(float(v.min()) for v in pft.samplers.effective_sample_size(s).values())
    # A lower bound: the leapfrog steps of the draw phase over the whole
    # wall time (warmup included), as bench_suite's config 9 counts them.
    grads = float(res.stats["n_steps"][0].sum()) * chains
    nuts_rate = nuts_line.get("min_ess_per_s")
    finite = all(bool(torch.isfinite(v).all()) for v in s.values())
    ok = finite and max_rhat < 1.2
    return ok, {
        "phase": "chees", "config": "bench_suite.py config 9 (:1050)",
        "size": LOGISTIC, "chains": chains, "warmup": warmup, "draws": draws,
        "jitter": CONFIG9_JITTER, "wall_s": wall,
        "min_ess": min_ess, "min_ess_per_s": min_ess / wall,
        "nuts_min_ess_per_s": nuts_rate,
        "ratio_to_nuts": (min_ess / wall) / nuts_rate if nuts_rate else None,
        "leapfrog_grads_per_s_lower_bound": grads / wall,
        "mean_leapfrog_steps": float(res.stats["n_steps"][0].float().mean()),
        "step_size": float(res.step_size[0]),
        "traj_len": float(res.extra["traj_len"]),
        "accept_prob": float(res.stats["accept_prob"].mean()),
        "max_split_rhat": max_rhat, "finite": finite,
        "gates": "finite draws, split R-hat < 1.2",
    }


# Config 6 (bench_suite.py:814): generate_lgssm_data(T=4096), seed 7, d=2,
# k=1; the sequential and the parallel-in-time filter at the same float32
# precision (TF32 off).  Gates are the JAX tests' tolerances
# (tests/test_statespace.py:91, :103): value rtol 1e-4; gradient rtol 1e-3,
# atol 1e-4; the smoothers compared at T=512.
LGSSM = dict(T=4096, seed=7, d=2, k=1)
LGSSM_VALUE_RTOL, LGSSM_GRAD_RTOL, LGSSM_GRAD_ATOL = 1e-4, 1e-3, 1e-4
LGSSM_SMOOTHER_T = 512
LGSSM_PAR_REPS = 30
LGSSM_SEQ_TIME_DIV = 4  # the sequential filter is timed at T / 4, scaled to T
LGSSM_COUNT_T = (32, 64)  # the sequential filter's launches and FLOPs, extrapolated
# Config 10 (bench_suite.py:1125): FederatedExactGP on generate_gp_data(8,
# n_obs=256, seed=9), sqexp; against float64 on the CPU at value rtol 1e-4
# and gradient 1e-3 |g| + 1e-4 max|g|; bench_suite's pass line is 5% MFU
# (recorded, not gated).  The sparse GP beside it: 32 inducing points
# evenly spaced on [-2, 2].
GP = dict(n_shards=8, n_obs=256, seed=9)
GP_VALUE_RTOL, GP_GRAD_RTOL, GP_GRAD_ATOL_OF_MAX = 1e-4, 1e-3, 1e-4
GP_INDUCING = 32
# The sparse bound is a sum of terms of size O(n) (n log 2πσ², the
# quadratic form, the log-determinant, the trace residual) whose total
# crosses zero: its float32 error scales with n, not with |logp|.  Value
# within 1e-4 |logp64| + 1e-5 n (n = 2,048 real observations).
GP_SPARSE_VALUE_ATOL_PER_OBS = 1e-5
GP_TARGET_MFU = 0.05
GP_TIMED_EVALS = 50
# Config 12 (bench_suite.py:1435): a 16-sigma bimodal in 8 dimensions
# (modes at +-4, width 0.5); parallel tempering, 2 stacks x 8 temperatures,
# beta_min 0.01, 8 leapfrog steps, 500 warmup + 1000 draws; the NUTS
# control, 4 chains with jitter 5 at the same lengths.  Each sampler runs
# once, after a 20-iteration warm-up run; bench_suite's gates
# (bench_suite.py:1555-1558): PT's mode-balance error (the worst chain's)
# < 0.3, NUTS's > 0.35.
BIMODAL = dict(dim=8, sep=4.0, width=0.5)
PT_RUN = dict(num_chains=2, num_temps=8, beta_min=0.01, num_leapfrog=8)
PT_LENGTHS, NUTS_LENGTHS = (500, 1000), (125, 250)
NUTS_CONTROL = dict(num_chains=4, jitter=5.0)
WARMUP_ITERS = 20
# The rated runs' generator seeds, bench_suite's own (:1499); the warm-up
# runs use 0.  One PT run of these lengths fails the balance gate about
# one time in three (PERF.md §6: of seeds 1-9 on an H100, 1, 5 and 6
# fail).  So PT's gate reads bench_suite's statistic on PT_GATE_RUNS more
# independent runs, made as one batched call of 2 x PT_GATE_RUNS stacks
# (every stack adapts alone), and holds their mean under 0.3; the rated
# run's own balance is recorded beside it.  On an H100 the 32 runs of
# seed 2 read a mean of 0.215, 9 of them at or over 0.3.
PT_SEED, NUTS_SEED, PT_GATE_SEED = 1, 1, 2
PT_GATE_RUNS = 32
PT_BALANCE_MAX, NUTS_BALANCE_MIN = 0.3, 0.35


def _close(got, want, rtol, atol):
    """``|got - want| <= atol + rtol |want|`` elementwise, float64 on the
    CPU; the largest error as a share of its tolerance."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    ratio = float(((got - want).abs() / (atol + rtol * want.abs()).clamp_min(1e-300)).max())
    return ratio <= 1.0 and bool(torch.isfinite(got).all()), ratio


def phase_lgssm(dev="cuda", lgssm=LGSSM, smoother_t=LGSSM_SMOOTHER_T, par_reps=LGSSM_PAR_REPS):
    """Config 6: the sequential and the parallel-in-time Kalman filter's
    logp+grad at T=4096 in the same run and precision: each against the
    other and against its float64 version on the CPU; ms per evaluation,
    their ratio (bench_suite's vs_baseline), CUDA launches and FLOPs per
    evaluation; the parallel smoother against the sequential one."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch import flopcount
    from pytensor_federated_torch.models import statespace as ss
    from pytensor_federated_torch.utils import value_and_grad

    y, params = pft.generate_lgssm_data(**lgssm, device=dev)
    y64, p64 = y.cpu().double(), {k: v.cpu().double() for k, v in params.items()}
    forms = {"seq": ss.kalman_logp_seq, "parallel": ss.kalman_logp_parallel}
    tol = (LGSSM_VALUE_RTOL, LGSSM_GRAD_RTOL, LGSSM_GRAD_ATOL)
    out, f64, gates = {}, {}, {}
    for name, fn in forms.items():
        t0 = time.perf_counter()
        out[name] = value_and_grad(lambda q, fn=fn: fn(q, y), params)
        _sync(dev)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        f64[name] = value_and_grad(lambda q, fn=fn: fn(q, y64), p64)
        gates[name + "_vs_f64_cpu"] = dict(zip(("ok", "errors"), _flat_close(out[name], f64[name], *tol)))
        gates[name + "_vs_f64_cpu"]["f64_cpu_s"] = time.perf_counter() - t0
        gates[name + "_vs_f64_cpu"]["first_call_s"] = first_s
    gates["parallel_vs_seq"] = dict(zip(("ok", "errors"), _flat_close(out["parallel"], out["seq"], *tol)))
    sm_seq = ss.kalman_smoother_seq(params, y[:smoother_t])
    sm_par = ss.kalman_smoother_parallel(params, y[:smoother_t])
    sm_ok, sm_ratio = zip(*(_close(a, b, LGSSM_GRAD_RTOL, LGSSM_GRAD_ATOL) for a, b in zip(sm_par, sm_seq)))
    gates["smoother_parallel_vs_seq"] = {"ok": all(sm_ok), "T": smoother_t,
                                         "err_over_tol": {"means": sm_ratio[0], "covs": sm_ratio[1]}}
    ok = all(g["ok"] for g in gates.values())

    timing = {}
    for name, fn in forms.items():
        call = lambda fn=fn, y=y: value_and_grad(lambda q: fn(q, y), params)
        t0 = time.perf_counter()
        if name == "seq":
            # One timed call at T / LGSSM_SEQ_TIME_DIV after the gate call,
            # its warm-up, scaled back to T: the same work repeats every
            # step, forward and backward, so its time, launches and FLOPs
            # are linear in T (the call at T = 4,096 took ~10.5 s).  The
            # launches and FLOPs are counted at two short lengths and
            # extrapolated: the profiler's record of ~660,000 launches at
            # T = 4,096 costs minutes to process.
            t_timed = y.shape[0] // LGSSM_SEQ_TIME_DIV
            value_and_grad(lambda q: fn(q, y[:t_timed]), params)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3 * (y.shape[0] / t_timed)
            counts = {}
            for t_small in LGSSM_COUNT_T:
                small = lambda t_small=t_small: value_and_grad(
                    lambda q: fn(q, y[:t_small]), params)
                counts[t_small] = (_launches(small, dev, 1), flopcount.flops_per_eval(small))
            (t1, c1), (t2, c2) = counts.items()
            launches, flops = (None if a is None else b + (b - a) / (t2 - t1) * (y.shape[0] - t2)
                               for a, b in zip(c1, c2))
            extra = {"counted_at": {str(k): {"cuda_launches": v[0], "flops": v[1]}
                                    for k, v in counts.items()},
                     "count_note": f"extrapolated linearly in T from T = {t1} and T = {t2}"}
        else:
            ms = _ms_per_eval(call, dev, par_reps)
            launches, flops, extra = _launches(call, dev, 3), flopcount.flops_per_eval(call), {}
        if name == "seq":
            extra["timed_at_t"] = t_timed
        timing[name] = {"ms_per_logp_and_grad": ms, "reps": 1 if name == "seq" else par_reps,
                        "cuda_launches_per_eval": launches, "flops_per_eval": flops, **extra,
                        "seconds": time.perf_counter() - t0}
    ratio = timing["seq"]["ms_per_logp_and_grad"] / timing["parallel"]["ms_per_logp_and_grad"]
    return ok, {
        "phase": "lgssm", "config": "bench_suite.py config 6 (:814)",
        "size": lgssm, "precision": "float32, TF32 off",
        "tolerance": {"value_rtol": LGSSM_VALUE_RTOL, "grad_rtol": LGSSM_GRAD_RTOL,
                      "grad_atol": LGSSM_GRAD_ATOL, "source": "tests/test_statespace.py:91, :103"},
        "gates": gates,
        "logp": {"seq": float(out["seq"][0]), "parallel": float(out["parallel"][0]),
                 "f64_cpu": float(f64["seq"][0])},
        "timing": timing,
        "vs_baseline": ratio,
        "vs_baseline_note": "sequential ms (one warm call at T / 4, times 4) over parallel ms "
                            "(median of the timed calls after 3 warm-ups) per logp+grad, same "
                            "run, same precision",
    }


def phase_gp(dev="cuda", gp=GP, inducing=GP_INDUCING, reps=GP_TIMED_EVALS):
    """Config 10: the federated exact GP's logp+grad against float64 on the
    CPU, with no host sync inside an evaluation; ms, FLOPs and the share
    of the float32 peaks; the sparse GP's value against float64 and its
    ms."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch import flopcount

    data, _ = pft.generate_gp_data(gp["n_shards"], n_obs=gp["n_obs"], seed=gp["seed"], device=dev)
    data64 = _as_f64_cpu(data)
    model, model64 = pft.FederatedExactGP(data), pft.FederatedExactGP(data64)
    points = _three_points(model.init_params())
    values_ok, values = _against_f64(model, model64, points, value_rtol=GP_VALUE_RTOL,
                                     grad_rtol=GP_GRAD_RTOL, grad_atol_of_max=GP_GRAD_ATOL_OF_MAX)
    p = model.init_params()
    call = lambda: model.logp_and_grad(p)
    call()
    _sync(dev)
    sync_free = None
    if torch.device(dev).type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
            sync_free = True
        except RuntimeError:
            sync_free = False
        finally:
            torch.cuda.set_sync_debug_mode(0)
    ms = _ms_per_eval(call, dev, reps)
    flops = flopcount.flops_per_eval(call)
    rate = flops / (ms * 1e-3) if flops else None
    if torch.device(dev).type == "cuda":
        peak, basis = flopcount.peak_flops(dev)
        measured = flopcount.measured_matmul_peak(dev)
    else:
        peak, basis, measured = None, "not measured off the card", None
    share = lambda pk: rate / pk if rate and pk else None

    z = torch.linspace(-2.0, 2.0, inducing)
    sparse = pft.FederatedSparseGP(data, z)
    sparse64 = pft.FederatedSparseGP(data64, z.double())
    n_obs = int(data.mask.sum())
    sp_ok, sp_values = _against_f64(sparse, sparse64, _three_points(sparse.init_params()),
                                    value_rtol=GP_VALUE_RTOL, grad_rtol=GP_GRAD_RTOL,
                                    grad_atol_of_max=GP_GRAD_ATOL_OF_MAX,
                                    value_atol=GP_SPARSE_VALUE_ATOL_PER_OBS * n_obs)
    sp = sparse.init_params()
    sp_ms = _ms_per_eval(lambda: sparse.logp_and_grad(sp), dev, reps)
    ok = values_ok and sp_ok and sync_free is not False and (
        sync_free is True or torch.device(dev).type != "cuda")
    return ok, {
        "phase": "gp", "config": "bench_suite.py config 10 (:1125)",
        "size": {**gp, "kernel": "sqexp", "params": 3},
        "tolerance": {"value_rtol": GP_VALUE_RTOL, "grad_rtol": GP_GRAD_RTOL,
                      "grad_atol": f"{GP_GRAD_ATOL_OF_MAX} x max|grad of the leaf|",
                      "against": "the same model in float64 on the CPU"},
        "values": values,
        "no_host_sync_in_eval": sync_free,
        "ms_per_logp_and_grad": ms,
        "cuda_launches_per_logp_and_grad": _launches(call, dev, 3),
        "flops_per_eval": flops,
        "flops_note": "matrix products and the linalg formulas of flopcount.py, forward and backward",
        "flop_per_s": rate,
        "peak": {"f32_flop_per_s": peak, "basis": basis, "measured_f32_matmul_flop_per_s": measured},
        "share_of_f32_peak": share(peak),
        "share_of_measured_matmul_peak": share(measured),
        "evals_per_s": 1e3 / ms,
        "evals_per_s_at_5pct_mfu": GP_TARGET_MFU * peak / flops if (peak and flops) else None,
        "mfu_line_note": "bench_suite's pass line for config 10 (5% MFU), recorded, not gated",
        "sparse": {"inducing": inducing, "values": sp_values, "ms_per_logp_and_grad": sp_ms,
                   "value_atol": GP_SPARSE_VALUE_ATOL_PER_OBS * n_obs,
                   "cuda_launches_per_logp_and_grad": _launches(lambda: sparse.logp_and_grad(sp),
                                                                dev, 3)},
    }


def _bimodal_logp(params):
    x = params["x"]
    la = -0.5 * torch.sum(((x + BIMODAL["sep"]) / BIMODAL["width"]) ** 2)
    lb = -0.5 * torch.sum(((x - BIMODAL["sep"]) / BIMODAL["width"]) ** 2)
    return torch.logaddexp(la, lb)


def _chain_balance(draws):
    """Each chain's mode-balance error: a draw's mode is the sign of its
    mean coordinate, the error |P(right) - 1/2|."""
    side = (draws.mean(dim=-1) > 0).double()
    return (side.mean(dim=1) - 0.5).abs()


def _balance_and_ess(res, wall):
    """bench_suite's mode-balance error (the worst chain's) and the
    rank-normalized min-ESS/s with the max split R-hat."""
    draws = res.samples["x"].detach().cpu()
    balance = float(_chain_balance(draws).max())
    summ = res.summary(rank_normalized=True)
    ess = min(float(v.min()) for v in summ["ess"].values())
    rhat = max(float(v.max()) for v in summ["rhat"].values())
    return {"wall_s": wall, "mode_balance_error": balance, "rank_min_ess": ess,
            "rank_min_ess_per_s": ess / wall, "max_split_rhat": rhat,
            "finite": bool(torch.isfinite(draws).all())}


def phase_tempering(dev="cuda", pt_lengths=PT_LENGTHS, nuts_lengths=NUTS_LENGTHS,
                    warm=WARMUP_ITERS):
    """Config 12: parallel tempering on the 16-sigma bimodal against NUTS
    with overdispersed inits; each run once after a short warm-up run,
    and PT's balance gate on PT_GATE_RUNS more runs in one batch."""
    import pytensor_federated_torch as pft

    init = {"x": torch.zeros(BIMODAL["dim"], device=dev)}
    evals = 0

    def counted(p):
        nonlocal evals
        evals += 1
        return _bimodal_logp(p)

    def run_pt(seed, warmup, draws, cuda_graph=False):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return pft.samplers.pt_sample(counted, init, generator=gen, num_warmup=warmup,
                                      num_samples=draws, cuda_graph=cuda_graph, **PT_RUN)

    def run_nuts(seed, warmup, draws, cuda_graph=False):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return pft.samplers.sample(counted, init, generator=gen, num_warmup=warmup,
                                   num_samples=draws, cuda_graph=cuda_graph, **NUTS_CONTROL)

    lines = {}
    for name, run, (warmup, draws) in (("pt", run_pt, pt_lengths), ("nuts", run_nuts, nuts_lengths)):
        _sync(dev)
        t0 = time.perf_counter()
        run(0, warm // 2, warm - warm // 2)
        _sync(dev)
        warm_s = time.perf_counter() - t0
        launches = None
        if torch.device(dev).type == "cuda":
            n_iter = 8
            on_card = _card_events(lambda: run(0, n_iter // 2, n_iter // 2), 1)
            launches = len(on_card) / n_iter
        evals = 0
        # Both timed runs replay their evaluation from a CUDA graph (the
        # eager runs' draws, bit for bit; PT's rated run took 37.9 s eager
        # against 5.9 s replayed on an H100, PERF.md section 5): the gates
        # are unchanged, the min-ESS/s are the graphed samplers'.
        graphed = torch.device(dev).type == "cuda"
        _sync(dev)
        t0 = time.perf_counter()
        res = run(PT_SEED if name == "pt" else NUTS_SEED, warmup, draws, cuda_graph=graphed)
        if graphed:
            evals += res.extra["graph_replays"]
        _sync(dev)
        wall = time.perf_counter() - t0
        line = {"seed": PT_SEED if name == "pt" else NUTS_SEED, "warmup": warmup, "draws": draws,
                "cuda_graph": graphed, "warm_up_run": {"iterations": warm, "wall_s": warm_s},
                "batched_evals": evals, "ms_per_batched_eval": wall * 1e3 / max(evals, 1),
                "cuda_launches_per_iteration": launches, **_balance_and_ess(res, wall)}
        if name == "pt":
            grads = PT_RUN["num_leapfrog"] * PT_RUN["num_temps"] * PT_RUN["num_chains"] * draws
            line.update(PT_RUN, grads_per_s_lower_bound=grads / wall,
                        swap_rate_per_pair=res.extra["swap_rate_per_pair"].tolist(),
                        swap_accept=float(res.stats["swap_accept"].mean()))
        else:
            line.update(NUTS_CONTROL, mean_tree_depth=float(res.stats["depth"].float().mean()),
                        mean_max_tree_depth=float(res.stats["depth"].max(dim=0).values.float().mean()))
        lines[name] = line

    # PT's gate: bench_suite's statistic on PT_GATE_RUNS independent
    # runs, stacks 2k and 2k+1 of one batched call being run k.
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(PT_GATE_SEED)
    res = pft.samplers.pt_sample(_bimodal_logp, init, generator=gen, num_warmup=pt_lengths[0],
                                 num_samples=pt_lengths[1],
                                 cuda_graph=torch.device(dev).type == "cuda",
                                 **{**PT_RUN, "num_chains": PT_RUN["num_chains"] * PT_GATE_RUNS})
    draws = res.samples["x"].detach().cpu()
    per_run = _chain_balance(draws).view(PT_GATE_RUNS, PT_RUN["num_chains"]).max(dim=1).values
    gate = {"seed": PT_GATE_SEED, "runs": PT_GATE_RUNS, "stacks": PT_RUN["num_chains"] * PT_GATE_RUNS,
            "mean_mode_balance_error": float(per_run.mean()),
            "median_mode_balance_error": float(per_run.median()),
            "runs_at_or_over_max": int((per_run >= PT_BALANCE_MAX).sum()),
            "finite": bool(torch.isfinite(draws).all()), "wall_s": time.perf_counter() - t0}
    ok = (lines["pt"]["finite"] and gate["finite"]
          and gate["mean_mode_balance_error"] < PT_BALANCE_MAX
          and lines["nuts"]["mode_balance_error"] > NUTS_BALANCE_MIN)
    return ok, {
        "phase": "tempering", "config": "bench_suite.py config 12 (:1435)",
        "target": BIMODAL,
        "pt": lines["pt"], "nuts": lines["nuts"], "pt_gate": gate,
        "ratio_pt_to_nuts_rank_min_ess_per_s": lines["pt"]["rank_min_ess_per_s"]
        / max(lines["nuts"]["rank_min_ess_per_s"], 1e-300),
        "gates": f"PT: the mean over {PT_GATE_RUNS} runs of the mode-balance error < "
                 f"{PT_BALANCE_MAX}; the NUTS control's > {NUTS_BALANCE_MIN} "
                 "(bench_suite.py:1555-1558)",
    }


# Slice 7: the GLM families at config 5's shard layout, 64 shards x 64
# observations x 8 features (bench_suite.py:750), the widest GLM layout the
# repo benchmarks; the Gaussian mixture at 64 shards x its generator's 128
# observations, 3 components.  No kernel: the JAX package computes these
# families outside Pallas, and so does the port.
FAMILY_LAYOUT = dict(n_shards=64, n_obs=64, n_features=8)
MIXTURE_LAYOUT = dict(n_shards=64, n_obs=128)
FAMILY_TIMED_EVALS = 30
# The model_check phase: the count-family comparison of the JAX package's
# tests/test_model_comparison.py:92 at width 8 on zero-inflated data, with
# config 3's 16 shards; each family fit by NUTS, 4 chains x 150 + 150 in
# lockstep; the top family's posterior predictive from 200 draws.
MODEL_CHECK_DATA = dict(n_shards=16, n_obs=256, n_features=8, pi=0.35, seed=5)
MODEL_CHECK_NUTS = (4, 150, 150)
MODEL_CHECK_SEED = 1
MODEL_CHECK_PREDICTIVE_DRAWS = 200
# Its R-hat gate.  The slopes and each family's own parameters must have
# mixed (< 1.05).  The intercept hierarchy (b0 + tau * b_raw) is a ridge
# that 150 + 150 draws do not resolve: the JAX package on the same data
# reads 1.05-1.10 there (tests/test_torch_model_comparison.py, run as a
# script), so it is held to bench_suite's < 1.2.
RHAT_MIXED, RHAT_HIERARCHY = 1.05, 1.2
HIERARCHY_LEAVES = ("b0", "b_raw", "log_tau")


def _family_cases():
    """(name, class, the function making its data, model kwargs) of each
    family of the families phase."""
    from pytensor_federated_torch import models as M

    L = FAMILY_LAYOUT
    return [
        ("poisson", M.FederatedPoissonGLM, lambda d: M.generate_count_data(**L, device=d), {}),
        ("negbin", M.FederatedNegBinGLM,
         lambda d: M.generate_count_data(**L, dispersion=4.0, device=d), {}),
        ("zip", M.FederatedZeroInflPoissonGLM,
         lambda d: M.generate_zi_count_data(**L, pi=0.3, device=d), {}),
        ("zinb", M.FederatedZeroInflNegBinGLM,
         lambda d: M.generate_zi_count_data(**L, pi=0.3, dispersion=4.0, device=d), {}),
        ("robust", M.FederatedRobustRegression, lambda d: M.generate_robust_data(**L, device=d), {}),
        ("gamma", M.FederatedGammaGLM, lambda d: M.generate_gamma_data(**L, device=d), {}),
        ("ordinal", M.FederatedOrdinalRegression,
         lambda d: M.generate_ordinal_data(**L, n_categories=5, device=d), {"n_categories": 5}),
        ("softmax", M.FederatedSoftmaxRegression,
         lambda d: M.generate_multinomial_data(**L, n_classes=4, device=d), {"n_classes": 4}),
        ("softmax_suffstats", M.FederatedSoftmaxRegression,
         lambda d: M.generate_multinomial_data(**L, n_classes=4, device=d),
         {"n_classes": 4, "use_suffstats": True}),
        ("hier_softmax", M.HierarchicalSoftmaxRegression,
         lambda d: M.generate_hier_multinomial_data(**L, n_classes=4, device=d), {"n_classes": 4}),
        ("weibull", M.FederatedWeibullAFT, lambda d: M.generate_survival_data(**L, device=d), {}),
        ("mixture", M.FederatedGaussianMixture,
         lambda d: M.generate_mixture_data(**MIXTURE_LAYOUT, device=d), {"n_components": 3}),
    ]


def phase_families(dev="cuda", reps=FAMILY_TIMED_EVALS):
    """Each GLM family and the Gaussian mixture on ``dev``: value and
    gradient at three points against the same model in float64 on the
    CPU; ms and CUDA launches per logp+grad; the softmax model's raw and
    sufficient-statistic forms behind bench.py's equality gate."""
    from pytensor_federated_torch.samplers.util import ravel

    rows, ok, datasets = {}, True, {}
    for name, cls, build, kw in _family_cases():
        base = name.replace("_suffstats", "")  # the two softmax forms share data
        if base not in datasets:
            datasets[base] = build(dev)[0]
        data = datasets[base]
        model = cls(data, **kw)
        model64 = cls(_as_f64_cpu(data), **kw)
        points = _three_points(model.init_params())
        values_ok, values = _against_f64(model, model64, points)
        # Where float32 arithmetic itself misses the gate (the Student-t's
        # nu-gradient at nu ~ 670 is a difference of digammas that cancels
        # to ~1e-3 of its terms), the card must land within twice the error
        # of the same model in float32 on the CPU at that point.
        _, cpu32 = _against_f64(cls(_as_cpu(data), **kw), model64,
                                {k: _as_cpu(v) for k, v in points.items()})
        for card, ref in zip(values, cpu32):
            card["cpu_f32_value_rel_err"] = ref["value_rel_err"]
            card["cpu_f32_grad_err_over_tol"] = ref["grad_err_over_tol"]
            if not card["ok"] and not ref["ok"] and math.isfinite(card["logp"]):
                card["ok"] = (card["grad_err_over_tol"] <= 2 * ref["grad_err_over_tol"]
                              and card["value_rel_err"] <= max(
                                  MODEL_VALUE_RTOL, 2 * ref["value_rel_err"]))
                card["gate"] = "within 2x the CPU float32 error"
        values_ok = all(v["ok"] for v in values)
        p = model.init_params()
        row = {
            "class": cls.__name__, **kw,
            "size": {"shards": data.n_shards, "max_obs": data.max_len,
                     "observations": int(data.mask.sum()),
                     "params": sum(t.numel() for t in p.values())},
            "values": values,
            "ms_per_logp_and_grad": _ms_per_eval(lambda: model.logp_and_grad(p), dev, reps),
            "cuda_launches_per_logp_and_grad": _launches(lambda: model.logp_and_grad(p), dev, 5),
            "ok": values_ok,
        }
        if name == "softmax_suffstats":
            raw = cls(data, n_classes=kw["n_classes"])
            flat0, unravel = ravel(p)
            gate = []
            for pname, x in (("x0", flat0), ("x0+0.1*arange", flat0 + 0.1 * torch.arange(
                    flat0.shape[0], dtype=flat0.dtype, device=flat0.device))):
                g_ok, err = _flat_close(model.logp_and_grad(unravel(x)),
                                        raw.logp_and_grad(unravel(x)))
                gate.append({"point": pname, **err, "ok": g_ok})
                row["ok"] &= g_ok
            row["equality_gate_vs_raw"] = gate
        rows[name] = row
        ok &= row["ok"]
    return ok, {
        "phase": "families",
        "layout": {"glm": {**FAMILY_LAYOUT, "source": "config 5, bench_suite.py:750"},
                   "mixture": {**MIXTURE_LAYOUT, "components": 3,
                               "source": "generate_mixture_data's n_obs"}},
        "tolerance": {"value_rtol": MODEL_VALUE_RTOL, "grad_rtol": MODEL_GRAD_RTOL,
                      "grad_atol": f"{MODEL_GRAD_ATOL_OF_MAX} x max|grad of the leaf|",
                      "against": "the same model in float64 on the CPU",
                      "softmax_forms": {"value_rtol": AUTOGRAD_RTOL_VALUE,
                                        "grad_rtol": AUTOGRAD_RTOL_GRAD,
                                        "grad_atol": AUTOGRAD_ATOL_GRAD,
                                        "source": "bench.py's equality gate"}},
        "families": rows,
        "gates": "every family's values against float64 (or within 2x the CPU float32 "
                 "error where float32 misses the tolerance); softmax suffstats == raw",
    }


def _zero_share(y, keep):
    return (y[..., keep] == 0).double().mean(-1)


MODEL_CHECK_FAMILIES = {"poisson": "FederatedPoissonGLM", "negbin": "FederatedNegBinGLM",
                        "zip": "FederatedZeroInflPoissonGLM", "zinb": "FederatedZeroInflNegBinGLM"}


def _model_check_data(data_kw, dev):
    from pytensor_federated_torch import models as M

    kw = dict(data_kw)
    return M.generate_zi_count_data(kw.pop("n_shards"), **kw, device=dev)[0]


def _model_check_fit(name, data_kw, nuts, dev, conn):
    """One family's fit in a process of its own: the data rebuilt from
    the seed on ``dev``, NUTS, the pointwise log-likelihood matrix
    (padding dropped) and the split R-hat of each leaf, sent back on
    ``conn`` with the draws."""
    sys.path.insert(0, str(ROOT))
    try:
        from pytensor_federated_torch import models as M
        from pytensor_federated_torch import samplers as S

        if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"the {name} fit found no GPU")
        torch.set_num_threads(1)  # four fits share the host's cores
        data = _model_check_data(data_kw, dev)
        m = getattr(M, MODEL_CHECK_FAMILIES[name])(data)
        res, run = _model_nuts(m, dev, seed=MODEL_CHECK_SEED, nuts=nuts,
                               cuda_graph=torch.device(dev).type == "cuda")
        run["cuda_graph"] = torch.device(dev).type == "cuda"
        t0 = time.perf_counter()
        ll = S.pointwise_loglik_matrix(m.pointwise_loglik, res.samples, mask=data.mask)
        run["loglik_matrix_s"] = time.perf_counter() - t0
        conn.send({"name": name, "run": run, "ll": ll,
                   "rhat": {k: float(v.max()) for k, v in S.split_rhat(res.samples).items()},
                   "samples": {k: v.cpu().numpy() for k, v in res.samples.items()},
                   "device": torch.cuda.get_device_name() if torch.cuda.is_available() else dev})
    except Exception:
        conn.send({"name": name, "error": traceback.format_exc()})
    finally:
        conn.close()


def phase_model_check(dev="cuda", nuts=MODEL_CHECK_NUTS, data_kw=MODEL_CHECK_DATA,
                      predictive_draws=MODEL_CHECK_PREDICTIVE_DRAWS, timeout=900.0):
    """The model-checking workflow on ``dev``: Poisson, NB2, ZIP and ZINB
    fit by NUTS to zero-inflated counts; pointwise log-likelihoods, PSIS-LOO,
    WAIC and the ranking; the top family's posterior predictive share of
    zeros against the observed one; the Laplace approximation of ZINB
    beside its NUTS posterior.

    The four fits are independent, and each is bound by its host thread
    (eager dispatch, ~100-180 launches per evaluation, the card idle most
    of the time), so each runs in a process of its own (forked from the fork server), all
    four at once on the one card, as a modeller would fit competing
    models; the ranking, the predictive and Laplace run here after."""

    import numpy as np

    from pytensor_federated_torch import models as M
    from pytensor_federated_torch import samplers as S

    ctx = _node_context()
    procs, conns = [], {}
    t0 = time.perf_counter()
    try:
        for name in MODEL_CHECK_FAMILIES:
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_model_check_fit, args=(name, data_kw, nuts, dev, child),
                               daemon=True)
            proc.start()
            procs.append(proc)
            conns[name] = parent
        replies = {}
        for name, conn in conns.items():
            if not conn.poll(max(1.0, timeout - (time.perf_counter() - t0))):
                raise RuntimeError(f"the {name} fit did not answer within {timeout} s")
            replies[name] = conn.recv()
            if "error" in replies[name]:
                raise RuntimeError(f"the {name} fit failed:\n{replies[name]['error']}")
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
    fits_s = time.perf_counter() - t0

    data = _model_check_data(data_kw, dev)
    (_X, y), mask = data.tree()
    keep = mask > 0
    obs_zero = float(_zero_share(y, keep))
    lls = {name: r["ll"] for name, r in replies.items()}
    rhat = {name: r["rhat"] for name, r in replies.items()}
    fits = {}
    for name, r in replies.items():
        loo, w = S.psis_loo(lls[name]), S.waic(lls[name])
        fits[name] = {"nuts": r["run"], "device": r["device"], "split_rhat": rhat[name],
                      "elpd_loo": loo["elpd_loo"], "p_loo": loo["p_loo"], "se": loo["se"],
                      "n_bad_k": loo["n_bad_k"], "elpd_waic": w["elpd_waic"],
                      "p_waic": w["p_waic"], "loglik_matrix": list(lls[name].shape)}
    rows = S.compare(lls)
    top = rows[0]["model"]
    samples = {name: {k: torch.as_tensor(v, device=dev) for k, v in r["samples"].items()}
               for name, r in replies.items()}
    models = {name: getattr(M, cls)(data) for name, cls in MODEL_CHECK_FAMILIES.items()}
    t1 = time.perf_counter()
    sims = S.posterior_predictive(models[top].predictive, samples[top],
                                  torch.Generator(device=dev).manual_seed(2),
                                  num_draws=predictive_draws)
    _sync(dev)
    predictive_s = time.perf_counter() - t1
    sim_zero = _zero_share(sims, keep).cpu().numpy()
    t1 = time.perf_counter()
    zinb = models["zinb"]
    lap = S.laplace_approximation(zinb.logp, zinb.init_params())
    laplace_s = time.perf_counter() - t1
    lap_sd = lap.stddev()

    def nuts_moments(k):
        d = samples["zinb"][k].reshape(-1, *lap.mode[k].shape)
        return d.mean(0).reshape(-1).tolist(), d.std(0).reshape(-1).tolist()

    beside = {k: dict(zip(("nuts_mean", "nuts_sd"), nuts_moments(k)),
                      laplace_mean=lap.mode[k].reshape(-1).tolist(),
                      laplace_sd=lap_sd[k].reshape(-1).tolist())
              for k in ("logit_pi", "log_phi", "b0", "w")}
    by_name = {r["model"]: r for r in rows}
    lo, hi = np.quantile(sim_zero, [0.05, 0.95])
    zi = [rhat["zip"], rhat["zinb"]]
    gates = {
        "rhat_zi_mixed_below_1.05": all(
            v < RHAT_MIXED for r in zi for k, v in r.items() if k not in HIERARCHY_LEAVES),
        "rhat_zi_hierarchy_below_1.2": all(
            v < RHAT_HIERARCHY for r in zi for k, v in r.items() if k in HIERARCHY_LEAVES),
        "zero_inflated_first": top in ("zip", "zinb"),
        "poisson_beyond_2_se": -by_name["poisson"]["d_elpd"] > 2 * by_name["poisson"]["d_se"],
        "zero_share_in_central_90": bool(lo <= obs_zero <= hi),
        "finite": all(f["nuts"]["finite"] for f in fits.values()) and bool(
            torch.isfinite(sims).all()),
    }
    return all(gates.values()), {
        "phase": "model_check",
        "data": {**data_kw, "observations": int(keep.sum()),
                 "source": "tests/test_model_comparison.py:92 at width 8, config 3's 16 shards"},
        "nuts": {"chains": nuts[0], "warmup": nuts[1], "draws": nuts[2], "seed": MODEL_CHECK_SEED},
        "fits_s": fits_s,
        "fits": fits,
        "compare": rows,
        "predictive": {"family": top, "draws": predictive_draws, "seconds": predictive_s,
                       "shape": list(sims.shape), "observed_zero_share": obs_zero,
                       "simulated_zero_share_mean": float(sim_zero.mean()),
                       "central_90": [float(lo), float(hi)]},
        "laplace_zinb": {"seconds": laplace_s, "logp_at_mode": lap.logp_at_mode,
                         "beside_nuts": beside},
        "gates": gates,
    }



# ---------------------------------------------------------------------------
# Slice 10: variational inference, particle samplers, SGLD, SBC,
# checkpointed sampling and the reference's demos, each on the flagship
# (8 x 64) through the kernel where the JAX package runs the flagship.
# Lengths are cut from the JAX defaults to fit each phase's budget
# (PERF.md section 5); every phase prints its batched evaluations.
# ---------------------------------------------------------------------------

# A variational fit's posterior mean against the nuts phase's: within
# VI_MEAN_SD of its posterior sd plus 4 of its Monte Carlo standard
# errors; its sd within a factor VI_SD_FACTOR (mean-field: slope and
# sigma only, since a factorized q understates the sd of the intercept,
# which the offsets' ridge correlates).
VI_MEAN_SD, VI_SD_FACTOR = 0.5, 2.0
# ADVI, full-rank ADVI and the flow start from the MAP (find_map, 300
# steps); their steps and learning rates are cut from the JAX defaults
# (2,000 at 1e-2; 3,000 at 5e-3; 3,000 at 3e-3).  The flow fits the
# posterior whitened by the mean-field fit (x = mean + sd * z), so that
# its N(0, I) base starts at the posterior's scale: from the raw
# coordinates (sds ~0.01-0.1 against the base's 1) it did not converge
# in 800 steps.
VI_MAP_STEPS = 300
VI_STEPS = dict(advi=500, fullrank=1200, flow=300, pathfinder=40)
VI_LR = dict(advi=2e-2, fullrank=1e-2, flow=5e-3)
VI_FLOW = dict(num_layers=6, hidden=32, n_mc=16)
# Full-rank ADVI draws 16 points per step (the JAX default 8): the Adam
# noise left in the 55 off-diagonal entries of L adds to every row norm,
# and at 8 draws and 800 steps it made the slope's sd 1.8-2.6 times the
# posterior's (3 seeds on the CPU, one card run); at 16 and 1,200,
# 1.3-1.6 (5 seeds).
VI_FULLRANK_MC = 16
VI_PATHS = 4
VI_DRAWS = 1000
# The card's float32 steps against the same steps in float64 on the CPU,
# with the same noise: a few Adam steps (each update moves a parameter
# by at most the learning rate; float32 gradients are exact to ~1e-6
# relative) and the first L-BFGS iterates.
VI_CHECK_STEPS, VI_CHECK_TOL = 5, dict(rtol=1e-3, atol=1e-4)
# SMC and the ensemble sampler start from the MAP (find_map, 300 steps),
# with the JAX defaults' particles and walkers.  SMC spreads its cloud by
# the JAX default's 1.0 N(0, 1) and mutates 20 times per stage (the JAX
# default's 5 random-walk steps, at ~15% acceptance, left the means up to
# 0.8 posterior sd off in two seeds); the ensemble starts at 0.01 N(0,
# 1) around the MAP (at its default 0.1 around the origin, 400 + 400
# steps had not reached the posterior).
SMC = dict(n_particles=2048, n_mutations=20, init_jitter=1.0)
ENSEMBLE = dict(n_walkers=64, num_warmup=400, num_samples=400, init_jitter=0.01)
PARTICLE_MCSE = 4.0  # means within 4 combined Monte Carlo standard errors
# SGLD on the JAX tests' Gaussian targets (tests/test_sgld.py:83-179) at
# their lengths, and shard-subsampled SGLD on the flagship.
SGLD_FED = dict(num_samples=600, num_burnin=200, num_shards=4, a=1e-4)  # from the MAP
# The Gaussian targets factorize and every update is elementwise, so
# independent chains run as one; the gates read their pooled draws.
# SGLD and SGHMC: SGLD_CHAINS chains, each a quarter of the JAX test's
# draws after its full burn-in.  pSGLD's single-run gate (sd within 45%,
# |mean| < 0.4 sd) fails about one run in twelve in either package (12
# seeds each on the CPU: JAX 11/12, port 11/12; PR 11 run 2's card run of
# one chain at the JAX test's length failed it at 0.53 sd), so it pools
# PSGLD_CHAINS chains of a quarter length; chain 0 is recorded too.
SGLD_CHAINS, PSGLD_CHAINS = 4, 8
# SBC on tests/test_sbc.py's conjugate model at a size that fits.
SBC = dict(n_sims=32, num_warmup=100, num_samples=64, thin=2, max_depth=4)
# Checkpointed NUTS on the flagship through the kernel.
# Trees are capped at depth 3 (8 leaves): the phase checks resumption,
# not mixing, and at depth 6 its four runs took ~10,000 evaluations.
# 50 warmup + 75 draws, three chunks (100 + 100 before: the gates
# are bits and chunk indices, which hold at any length).
CHECKPOINT = dict(num_warmup=50, num_samples=75, num_chains=1, checkpoint_every=25,
                  max_depth=3)
CHECKPOINT_CUT_AFTER = 2  # chunks persisted before the interruption
# The demos: three gRPC nodes on the card, the remote driver's draws,
# the local demo's draws, and how long the pool may take to go away.
DEMO_PORTS, DEMO_REMOTE_DRAWS, DEMO_LOCAL_DRAWS, DEMO_TEARDOWN_S = 3, 200, 50, 10.0
SLICE10 = ("vi", "particles", "sgld", "sbc", "checkpoint", "demos")
# The largest chain batch the slice-10 phases launch at the flagship
# size: multi-path Pathfinder's ELBO draws (paths x L-BFGS steps x 16
# draws) and SMC's particles; the kernels phase holds it like the others.
SLICE10_LARGEST_C = (max(VI_PATHS * VI_STEPS["pathfinder"] * 16, SMC["n_particles"]),)


def _flagship_posterior(dev, f64=False):
    """The flagship posterior through the kernel wrapper (the kernel on
    CUDA, its plain version on the CPU): ``(model, posterior, init)``."""
    import pytensor_federated_torch as pft

    data, _ = pft.generate_node_data(8, n_obs=FLAGSHIP[1], seed=123, device=dev)
    if f64:
        data = _as_f64_cpu(data)
    model = pft.FederatedLinearRegression(data)
    (x, y), mask = data.tree()
    kern = pft.linreg_logp_grad_fn(x, y, mask)
    init = model.init_params()
    if f64:
        init = {k: v.double() for k, v in init.items()}
    return model, (lambda p: model.prior_logp(p) + kern.data_logp(p)), init


def _counted(fn, counts, key="evals"):
    """``fn`` counting its calls: under ``vmap`` one call is one batched
    evaluation."""

    def counted(p):
        counts[key] = counts.get(key, 0) + 1
        return fn(p)

    return counted


def _moments(samples):
    """Mean and sd of intercept, slope and sigma over every draw."""
    derived = {"intercept": samples["intercept"], "slope": samples["slope"],
               "sigma": torch.exp(samples["log_sigma"])}
    return {k: {"mean": float(v.double().mean()), "sd": float(v.double().std())}
            for k, v in derived.items()}


def _against_nuts(moments, nuts_line, *, sd_keys=("intercept", "slope", "sigma")):
    """Each quantity's mean within VI_MEAN_SD posterior sd + 4 MCSE of the
    nuts phase's, and (for ``sd_keys``) its sd within VI_SD_FACTOR."""
    ref = nuts_line.get("recovered", {})
    out, ok = {}, bool(ref)
    for k, m in moments.items():
        r = ref.get(k)
        if r is None:
            ok = False
            continue
        mean_ok = abs(m["mean"] - r["mean"]) <= VI_MEAN_SD * r["sd"] + 4 * r["mcse"]
        ratio = m["sd"] / r["sd"]
        sd_ok = k not in sd_keys or 1 / VI_SD_FACTOR <= ratio <= VI_SD_FACTOR
        out[k] = {**m, "nuts_mean": r["mean"], "nuts_sd": r["sd"], "sd_ratio": ratio,
                  "mean_ok": mean_ok, "sd_ok": sd_ok}
        ok &= mean_ok and sd_ok
    return ok, out


def _vi_f64_checks(dev):
    """A few steps of each fit on ``dev`` in float32 against the same
    steps in float64 on the CPU with the same noise: mean-field and
    full-rank ADVI and the flow (Adam steps of their estimators), and
    the first L-BFGS iterates of Pathfinder."""
    from pytensor_federated_torch.ppl import elbo
    from pytensor_federated_torch.samplers import advi, flows
    from pytensor_federated_torch.samplers.util import flatten_logp
    import importlib

    pathfinder = importlib.import_module("pytensor_federated_torch.samplers.pathfinder")
    runs = {}
    for where, f64 in ((dev, False), ("cpu", True)):
        _, post, init = _flagship_posterior(where, f64)
        flat, x0, unravel = flatten_logp(post, init)
        x0 = x0.detach()
        d, dt = x0.shape[0], x0.dtype
        gen = torch.Generator().manual_seed(31)
        noise = lambda *shape: [torch.randn(shape, generator=gen, dtype=torch.float64).to(
            dtype=dt, device=where) for _ in range(VI_CHECK_STEPS)]
        batch = torch.func.vmap(flat)

        def fit(estimator, var0, draws, lr):
            it = iter(draws)
            return elbo.scan_vi(lambda v, _g: estimator(v, next(it)), var0, generator=None,
                                num_steps=VI_CHECK_STEPS, learning_rate=lr)

        out = {}
        mf = elbo.meanfield_neg_elbo(lambda x, _g: torch.mean(batch(x)), d, n_mc=8,
                                     split_keys=False)
        (mu, log_sd), _ = fit(mf, (x0, torch.full((d,), -2.0, dtype=dt, device=where)),
                              noise(8, d), 1e-2)
        out["advi"] = torch.cat([mu, log_sd])
        tril = tuple(torch.tril_indices(d, d, device=where))
        theta0 = torch.zeros(d * (d + 1) // 2, dtype=dt, device=where)
        theta0[(torch.arange(d, device=where) * (torch.arange(d, device=where) + 3)) // 2] = -2.0
        (mu, theta), _ = fit(advi.fullrank_neg_elbo(batch, d, 8, tril), (x0, theta0),
                             noise(8, d), 5e-3)
        out["fullrank"] = torch.cat([mu, theta])
        base = (torch.arange(d, device=where) % 2).to(dt)
        masks = torch.stack([base if i % 2 == 0 else 1.0 - base
                             for i in range(VI_FLOW["num_layers"])])
        w1 = noise(d, VI_FLOW["hidden"])[: VI_FLOW["num_layers"]]
        flow0 = [flows._mlp_init(w, d, VI_FLOW["hidden"], d, x0) for w in w1]
        flow, _ = fit(flows.flow_neg_elbo(batch, masks, x0, VI_FLOW["n_mc"]), flow0,
                      noise(VI_FLOW["n_mc"], d), 3e-3)
        out["flow"] = torch.cat([t.reshape(-1) for p in flow for t in p.values()])
        counter = {"evals": 0, "elbo_evals": 0, "syncs": 0}
        from pytensor_federated_torch.samplers.mcmc import make_batch_logp_and_grad

        xs, _ = pathfinder._lbfgs_paths(make_batch_logp_and_grad(flat, unravel), x0[None],
                                        3, counter)
        out["pathfinder_iterates"] = xs.reshape(-1)
        runs[where if not f64 else "f64"] = {k: v.detach().cpu().double() for k, v in out.items()}
    res, ok = {}, True
    for k, want in runs["f64"].items():
        got = runs[dev][k]
        err = (got - want).abs()
        tol = VI_CHECK_TOL["atol"] + VI_CHECK_TOL["rtol"] * want.abs()
        res[k] = {"max_abs_err": float(err.max()), "err_over_tol": float((err / tol).max())}
        ok &= res[k]["err_over_tol"] <= 1.0
    return ok, res


def phase_vi(nuts_line, dev="cuda", steps=VI_STEPS, draws=VI_DRAWS):
    """ADVI (mean-field and full-rank), the RealNVP flow, Pathfinder and
    multi-path Pathfinder on the flagship through the kernel: the Monte
    Carlo draws of a step (Pathfinder: the paths of an L-BFGS or line-
    search step, then every ELBO draw of every point) are one batched
    evaluation, one launch.  Each fit's draws against the nuts phase's
    posterior, and its first steps against float64 on the CPU."""
    import importlib

    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
    from pytensor_federated_torch.samplers import advi, find_map, flows

    pf = importlib.import_module("pytensor_federated_torch.samplers.pathfinder")
    _, post, init = _flagship_posterior(dev)
    fits, counts, ok = {}, {}, True
    gen = torch.Generator(device=dev).manual_seed(17)
    _sync(dev)
    linreg_reductions.launches = 0
    t_all = time.perf_counter()

    def run(name, fn, sd_keys=("intercept", "slope", "sigma")):
        nonlocal ok
        c = {}
        t0 = time.perf_counter()
        samples, extra = fn(_counted(post, c))
        _sync(dev)
        f_ok, vs = _against_nuts(_moments(samples), nuts_line, sd_keys=sd_keys)
        finite = all(bool(torch.isfinite(v).all()) for v in samples.values())
        fits[name] = {"seconds": time.perf_counter() - t0, "batched_evals": c.get("evals", 0),
                      "ok": f_ok and finite, "against_nuts": vs, **extra}
        counts[name] = c.get("evals", 0)
        ok &= f_ok and finite

    whiten = {}

    def map_point(lp):
        est = find_map(lp, init, num_steps=VI_MAP_STEPS, learning_rate=0.05)
        whiten["map"] = est
        return {k: v[None] for k, v in est.items()}, {"steps": VI_MAP_STEPS}

    def mf(lp):
        res, unravel = advi.advi_fit(lp, whiten["map"], generator=gen, num_steps=steps["advi"],
                                     learning_rate=VI_LR["advi"])
        whiten.update(loc=res.flat_mean.detach(), scale=torch.exp(res.flat_log_sd).detach(),
                      unravel=unravel)
        return res.sample(gen, draws, unravel), {
            "steps": steps["advi"], "learning_rate": VI_LR["advi"], "n_mc": 8,
            "final_elbo": float(res.elbo_trace[-1])}

    def fr(lp):
        res, unravel = advi.fullrank_advi_fit(lp, whiten["map"], generator=gen,
                                              num_steps=steps["fullrank"],
                                              learning_rate=VI_LR["fullrank"], n_mc=VI_FULLRANK_MC)
        return res.sample(gen, draws, unravel), {
            "steps": steps["fullrank"], "learning_rate": VI_LR["fullrank"], "n_mc": VI_FULLRANK_MC,
            "final_elbo": float(res.elbo_trace[-1])}

    def flow(lp):
        loc, scale, unravel = whiten["loc"], whiten["scale"], whiten["unravel"]
        res, z_unravel = flows.realnvp_advi_fit(
            lambda p: lp(unravel(loc + scale * p["z"])), {"z": torch.zeros_like(loc)},
            generator=gen, num_steps=steps["flow"], learning_rate=VI_LR["flow"], **VI_FLOW)
        z = res.sample(gen, draws, z_unravel)["z"]
        return unravel(loc + scale * z), {"steps": steps["flow"], "learning_rate": VI_LR["flow"],
                                          **VI_FLOW, "whitened_by": "advi",
                                          "final_elbo": float(res.elbo_trace[-1])}

    def path(lp, multi=False):
        c = {}
        kw = dict(num_steps=steps["pathfinder"], num_draws=draws, counter=c)
        res = (pf.multipath_pathfinder(lp, init, gen, num_paths=VI_PATHS, **kw) if multi
               else pf.pathfinder(lp, init, gen, **kw))
        return res.samples, {"lbfgs_steps": steps["pathfinder"], "elbo": float(res.elbo),
                             "best_iter": int(res.best_iter), "best_path": int(res.best_path),
                             "path_evals": c["evals"], "elbo_evals": c["elbo_evals"],
                             "host_syncs": c["syncs"],
                             "elbo_batch": (VI_PATHS if multi else 1) * steps["pathfinder"] * 16}

    c_map = {}
    t0 = time.perf_counter()
    map_point(_counted(post, c_map))
    fits["find_map"] = {"steps": VI_MAP_STEPS, "seconds": time.perf_counter() - t0,
                        "batched_evals": c_map["evals"]}
    counts["find_map"] = c_map["evals"]
    run("advi", mf, sd_keys=("slope", "sigma"))
    run("fullrank_advi", fr)
    run("realnvp", flow)
    run("pathfinder", path)
    run("multipath_pathfinder", lambda lp: path(lp, multi=True))
    wall = time.perf_counter() - t_all
    launches = linreg_reductions.launches
    evals = sum(counts.values())
    f64_ok, f64 = _vi_f64_checks(dev)
    launches_ok = launches == evals > 0 if dev == "cuda" else True
    ok &= f64_ok and launches_ok
    return ok, {
        "phase": "vi", "size": list(FLAGSHIP), "wall_s": wall,
        "tolerance": {"mean": f"{VI_MEAN_SD} nuts sd + 4 nuts mcse",
                      "sd_factor": VI_SD_FACTOR, "f64_cpu": VI_CHECK_TOL,
                      "f64_steps": VI_CHECK_STEPS},
        "fits": fits, "batched_evals": evals, "kernel_launches": launches,
        "launches_equal_batched_evals": launches_ok,
        "ms_per_batched_eval": wall * 1e3 / max(evals, 1), "f64_cpu": f64,
    }


def _ensemble_mcse(x):
    """Per-quantity Monte Carlo standard error of ensemble draws (steps,
    walkers): each walker read as a chain."""
    import pytensor_federated_torch as pft

    chains = x.transpose(0, 1)  # (walkers, steps)
    ess = float(pft.samplers.effective_sample_size({"q": chains})["q"])
    return float(x.double().std()) / math.sqrt(max(ess, 1.0)), ess


def phase_particles(nuts_line, dev="cuda", smc=SMC, ensemble=ENSEMBLE):
    """Tempered SMC and the ensemble sampler on the flagship through the
    kernel: a mutation is one batched evaluation of every particle (C =
    n_particles), a half-ensemble update one of n_walkers / 2.  Means
    within PARTICLE_MCSE combined Monte Carlo standard errors of the
    nuts phase's; kernel launches equal batched evaluations; SMC's
    stages and host syncs."""
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
    from pytensor_federated_torch.samplers import ensemble_sample, find_map, smc_sample

    _, post, init = _flagship_posterior(dev)
    ref = nuts_line.get("recovered", {})
    gen = torch.Generator(device=dev).manual_seed(23)
    out, ok = {"phase": "particles", "size": list(FLAGSHIP)}, bool(ref)
    c = {}
    _sync(dev)
    linreg_reductions.launches = 0
    t0 = time.perf_counter()
    init = find_map(_counted(post, c), init, num_steps=VI_MAP_STEPS, learning_rate=0.05)
    _sync(dev)
    out["find_map"] = {"steps": VI_MAP_STEPS, "seconds": time.perf_counter() - t0,
                       "batched_evals": c["evals"], "kernel_launches": linreg_reductions.launches}
    ok &= linreg_reductions.launches == c["evals"] or dev != "cuda"
    total_evals, launches_total = c["evals"], linreg_reductions.launches
    for name in ("smc", "ensemble"):
        c = {}
        _sync(dev)
        linreg_reductions.launches = 0
        t0 = time.perf_counter()
        if name == "smc":
            res = smc_sample(_counted(post, c), init, generator=gen, **smc)
            samples = res.samples
            extra = {**smc, "stages": int(res.n_stages), "final_beta": float(res.final_beta),
                     "host_syncs": res.host_syncs, "log_evidence": float(res.log_evidence),
                     "accept_rate": float(res.accept_rate)}
            stage_ok = float(res.final_beta) == 1.0
        else:
            res = ensemble_sample(_counted(post, c), init, generator=gen, **ensemble)
            samples = res.samples
            extra = {**ensemble, "accept_rate": float(res.accept_rate)}
            stage_ok = 0.05 < float(res.accept_rate) < 0.95
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = linreg_reductions.launches
        derived = {"intercept": samples["intercept"], "slope": samples["slope"],
                   "sigma": torch.exp(samples["log_sigma"])}
        flat = torch.cat([samples[k].reshape(samples[k].shape[0], -1) for k in sorted(samples)],
                         dim=1)
        distinct = torch.unique(flat, dim=0).shape[0]
        if name == "smc":
            extra["distinct_particles"] = distinct
        checks = {}
        for k, v in derived.items():
            mean = float(v.double().mean())
            if name == "smc":  # sd / sqrt(distinct particles): resampling duplicates some
                ess = float(distinct)
                mcse = float(v.double().std()) / math.sqrt(ess)
            else:
                mcse, ess = _ensemble_mcse(v)
            r = ref.get(k, {"mean": math.nan, "mcse": math.nan, "sd": math.nan})
            bound = PARTICLE_MCSE * math.hypot(mcse, r["mcse"])
            checks[k] = {"mean": mean, "sd": float(v.double().std()), "mcse": mcse, "ess": ess,
                         "nuts_mean": r["mean"], "nuts_sd": r["sd"], "bound": bound,
                         "ok": abs(mean - r["mean"]) <= bound}
        finite = all(bool(torch.isfinite(v).all()) for v in samples.values())
        launch_ok = launches == c["evals"] > 0 if dev == "cuda" else True
        p_ok = stage_ok and finite and launch_ok and all(v["ok"] for v in checks.values())
        out[name] = {"wall_s": wall, "batched_evals": c["evals"], "kernel_launches": launches,
                     "ms_per_batched_eval": wall * 1e3 / c["evals"], "against_nuts": checks,
                     "finite": finite, "ok": p_ok, **extra}
        ok &= p_ok
        total_evals += c["evals"]
        launches_total += launches
    out.update(batched_evals=total_evals, kernel_launches=launches_total,
               tolerance=f"{PARTICLE_MCSE} combined MCSE")
    return ok, out


def phase_sgld(nuts_line, dev="cuda"):
    """SGLD, pSGLD and SGHMC on the JAX tests' Gaussian targets at their
    gates (tests/test_sgld.py:83-179), independent chains pooled, and
    shard-subsampled
    SGLD on the flagship (``logp_and_grad_minibatch`` over 4 of 8 shards
    plus the prior), its slope against the nuts phase's."""
    from pytensor_federated_torch.samplers import (
        polynomial_decay,
        psgld_sample,
        sghmc_sample,
        sgld_sample,
    )
    import numpy as np

    from pytensor_federated_torch.utils import value_and_grad

    def gaussian(mu, var):
        def lg(p, _g):
            r = (p["x"] - mu) / var
            return -0.5 * torch.sum(r * (p["x"] - mu)), {"x": -r}

        return lg

    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    z = torch.zeros(SGLD_CHAINS, 2, device=dev)
    runs, ok = {}, True
    t0 = time.perf_counter()

    def pooled(res):
        return res.samples["x"].double().cpu().numpy().reshape(-1, 2)

    x = pooled(sgld_sample(gaussian(2.0, 0.25), {"x": z}, gen(0), num_samples=1000,
                           num_burnin=1000, step_size=0.01, thin=2))
    runs["sgld"] = {"chains": SGLD_CHAINS, "mean": x.mean(0).tolist(), "var": x.var(0).tolist(),
                    "ok": bool(np.allclose(x.mean(0), 2.0, atol=0.1, rtol=0)
                               and np.allclose(x.var(0), 0.25, rtol=0.25, atol=0))}
    x = pooled(sghmc_sample(gaussian(-1.0, 0.5), {"x": z}, gen(5), num_samples=750,
                            num_burnin=500, step_size=0.05, friction=2.0, thin=3))
    runs["sghmc"] = {"chains": SGLD_CHAINS, "mean": x.mean(0).tolist(), "var": x.var(0).tolist(),
                     "ok": bool(np.allclose(x.mean(0), -1.0, atol=0.1, rtol=0)
                                and np.allclose(x.var(0), 0.5, rtol=0.25, atol=0))}
    scales = torch.tensor([3.0, 0.1], device=dev).expand(PSGLD_CHAINS, 2)
    res = psgld_sample(
        lambda p, _g: (-0.5 * torch.sum((p["x"] / scales) ** 2), {"x": -p["x"] / scales**2}),
        {"x": scales.clone()}, gen(6), num_samples=1000, num_burnin=2000, step_size=0.02,
        beta=0.999, thin=3)
    x = res.samples["x"].double().cpu().numpy()  # (draws, chains, 2)
    pooled_x = x.reshape(-1, 2)
    sd = pooled_x.std(0)
    runs["psgld"] = {"chains": PSGLD_CHAINS, "mean": pooled_x.mean(0).tolist(), "sd": sd.tolist(),
                     "chain0": {"mean": x[:, 0].mean(0).tolist(), "sd": x[:, 0].std(0).tolist()},
                     "ok": bool(np.allclose(sd, [3.0, 0.1], rtol=0.45, atol=0)
                                and all(abs(pooled_x[:, i].mean()) < 0.4 * sd[i]
                                        for i in range(2)))}
    gauss_s = time.perf_counter() - t0

    import pytensor_federated_torch as pft

    data, _ = pft.generate_node_data(8, n_obs=FLAGSHIP[1], seed=123, device=dev)
    model = pft.FederatedLinearRegression(data)
    k = SGLD_FED["num_shards"]

    def oracle(p, g):
        lp, grads = model.fed.logp_and_grad_minibatch(p, g, num_shards=k)
        pv, pg = value_and_grad(model.prior_logp, p)
        return lp + pv, {n: grads[n] + pg[n] for n in grads}

    from pytensor_federated_torch.samplers import find_map

    t1 = time.perf_counter()
    start = find_map(model.logp, model.init_params(), num_steps=VI_MAP_STEPS, learning_rate=0.05)
    res = sgld_sample(oracle, start, gen(4), num_samples=SGLD_FED["num_samples"],
                      num_burnin=SGLD_FED["num_burnin"],
                      step_size=polynomial_decay(a=SGLD_FED["a"], gamma=0.55))
    _sync(dev)
    slope = res.samples["slope"].double()
    r = nuts_line.get("recovered", {}).get("slope", {"mean": math.nan, "sd": math.nan})
    # SGLD without a Metropolis correction is biased by its step size:
    # the slope's mean within 2 posterior sd of the nuts phase's.
    fed_ok = abs(float(slope.mean()) - r["mean"]) <= 2 * r["sd"] and bool(
        torch.isfinite(res.logps).all())
    runs["federated_sgld"] = {**SGLD_FED, "slope_mean": float(slope.mean()),
                              "slope_sd": float(slope.std()), "nuts_slope_mean": r["mean"],
                              "nuts_slope_sd": r["sd"], "seconds": time.perf_counter() - t1,
                              "ok": fed_ok}
    ok = all(v["ok"] for v in runs.values())
    return ok, {"phase": "sgld", "gaussian_s": gauss_s, "runs": runs,
                "gates": "tests/test_sgld.py:83-179; federated: 2 nuts sd"}


def phase_sbc(dev="cuda", sbc=SBC):
    """Simulation-based calibration of the port's NUTS on tests/
    test_sbc.py's conjugate normal model, every simulation one chain of
    one lockstep batch; the uniformity verdict passes, and the negative
    control of tests/test_sbc.py:54 fails."""
    import numpy as np

    from pytensor_federated_torch.samplers import SBCResult, sbc_ranks, sbc_uniformity

    n_obs = 16

    def prior_sample(g):
        return {"mu": torch.randn((), generator=g, device=dev)}

    def simulate(g, params):
        return params["mu"] + torch.randn((n_obs,), generator=g, device=dev)

    def logp(params, data):
        mu = params["mu"]
        return -0.5 * mu**2 - 0.5 * torch.sum((data - mu) ** 2)

    c = {}
    t0 = time.perf_counter()
    res = sbc_ranks(prior_sample, simulate, logp, generator=torch.Generator(
        device=dev).manual_seed(0), counter=c, **sbc)
    _sync(dev)
    wall = time.perf_counter() - t0
    stats, dof = sbc_uniformity(res)
    limit = dof + 4.0 * math.sqrt(2.0 * dof)
    rng = np.random.default_rng(0)
    levels = 33
    bad = np.where(rng.uniform(size=128) < 0.5, rng.integers(0, 4, size=128),
                   rng.integers(levels - 4, levels, size=128))[:, None]
    bad_stats, bad_dof = sbc_uniformity(SBCResult(torch.as_tensor(bad), levels, ["mu"]))
    bad_limit = bad_dof + 4.0 * math.sqrt(2.0 * bad_dof)
    passes = bool(stats[0] < limit)
    control_fails = bool(bad_stats[0] > bad_limit)
    return passes and control_fails, {
        "phase": "sbc", **sbc, "wall_s": wall, "batched_evals": c["evals"],
        "ms_per_batched_eval": wall * 1e3 / c["evals"],
        "n_levels": res.n_levels, "chi2": float(stats[0]), "dof": dof, "limit": limit,
        "calibrated_passes": passes, "negative_control": {"chi2": float(bad_stats[0]),
                                                          "limit": bad_limit,
                                                          "fails": control_fails},
    }


class _Interrupted(Exception):
    pass


def phase_checkpoint(dev="cuda", ck=CHECKPOINT, cut_after=CHECKPOINT_CUT_AFTER):
    """``sample_checkpointed`` on the flagship through the kernel: an
    uninterrupted run, a run interrupted after chunk ``cut_after`` (an
    exception raised in the chunk callback) and resumed; the resumed
    draws equal the uninterrupted ones bit for bit; a changed config
    (a 10-transition warmup) restarts from chunk 0."""
    import tempfile

    from pytensor_federated_torch import sample_checkpointed
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions

    _, post, init = _flagship_posterior(dev)
    c = {}
    lp = _counted(post, c)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    _sync(dev)
    linreg_reductions.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as d:
        full = sample_checkpointed(lp, init, generator=gen(9),
                                   checkpoint_path=os.path.join(d, "full.npz"), **ck)
        path = os.path.join(d, "cut.npz")

        def cut(i):
            if i + 1 == cut_after:
                raise _Interrupted

        try:
            sample_checkpointed(lp, init, generator=gen(9), checkpoint_path=path, on_chunk=cut,
                                **ck)
            interrupted = False
        except _Interrupted:
            interrupted = True
        resumed_chunks = []
        res = sample_checkpointed(lp, init, generator=gen(9), checkpoint_path=path,
                                  on_chunk=resumed_chunks.append, **ck)
        restarted = []

        def first(i):
            restarted.append(i)
            raise _Interrupted

        try:
            sample_checkpointed(lp, init, generator=gen(9), checkpoint_path=path,
                                on_chunk=first, **{**ck, "num_warmup": 10})
        except _Interrupted:
            pass
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = linreg_reductions.launches
    n_chunks = -(-ck["num_samples"] // ck["checkpoint_every"])
    same = all(torch.equal(res.samples[k], full.samples[k]) for k in full.samples)
    gates = {
        "interrupted": interrupted,
        "resumed_from_chunk": resumed_chunks[:1] == [cut_after]
        and resumed_chunks == list(range(cut_after, n_chunks)),
        "bits_equal_uninterrupted": same,
        "stats_equal": all(torch.equal(res.stats[k], full.stats[k]) for k in full.stats),
        "changed_config_restarts": restarted == [0],
        "finite": all(bool(torch.isfinite(v).all()) for v in res.samples.values()),
        "launches_equal_batched_evals": launches == c["evals"] > 0 if dev == "cuda" else True,
    }
    return all(gates.values()), {
        "phase": "checkpoint", **ck, "cut_after_chunk": cut_after, "wall_s": wall,
        "batched_evals": c["evals"], "kernel_launches": launches,
        "ms_per_batched_eval": wall * 1e3 / c["evals"],
        "draws_sha256": _draws_sha256(res.samples), "gates": gates,
    }


def _free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _port_open(port):
    import socket

    with socket.socket() as s:
        s.settimeout(1.0)
        return s.connect_ex(("127.0.0.1", port)) == 0


def phase_demos(dev="cuda", n_ports=DEMO_PORTS, remote_draws=DEMO_REMOTE_DRAWS,
                local_draws=DEMO_LOCAL_DRAWS):
    """The reference's demo pair on the card.  ``run_node_pool`` in a
    child process starts one gRPC node per port (each a grandchild of
    this script, computing on the card); while they start, ``run_local``
    on the card recovers the slope through the kernel; ``run_remote``
    samples against the nodes from the CPU and recovers the slope
    (tests/test_e2e_remote.py:50's gate); the pool is torn down by
    SIGTERM to its manager and every node process and port is gone
    within DEMO_TEARDOWN_S."""
    import functools

    from pytensor_federated_torch.demos import demo_model, demo_node
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
    from pytensor_federated_torch.service import _grpc

    _grpc.grpc.aio  # the demos need grpcio; a missing one fails the phase
    ports = _free_ports(n_ports)
    ctx = _node_context()
    manager = ctx.Process(target=functools.partial(demo_node.run_node_pool, device=dev),
                          args=("127.0.0.1", ports), name="demo-pool")
    t0 = time.perf_counter()
    manager.start()
    out, nodes, gone_s, exitcode, left = {"phase": "demos", "ports": ports}, [], None, None, []
    try:
        # run_local on the card while the pool's nodes start.
        _sync(dev)
        linreg_reductions.launches = 0
        t3 = time.perf_counter()
        res = demo_model.run_local(draws=local_draws, device=dev)
        _sync(dev)
        slope = res.samples["slope"].double()
        launches = linreg_reductions.launches
        out["local"] = {"draws": local_draws, "chains": 2, "seconds": time.perf_counter() - t3,
                        "median_slope": float(slope.median()), "kernel_launches": launches,
                        "ok": abs(float(slope.median()) - 2.0) < 0.15
                        and (launches > 0 or dev != "cuda")}
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not all(_port_open(p) for p in ports):
            if not manager.is_alive():
                raise RuntimeError(f"the demo pool exited with {manager.exitcode}")
            time.sleep(0.2)
        out["pool_up_s"] = time.perf_counter() - t0
        nodes = [pid for pid in _live_descendants() if pid != manager.pid]
        t1 = time.perf_counter()
        res = demo_model.run_remote("127.0.0.1", ports, draws=remote_draws)
        slope = res.samples["slope"].double()
        out["remote"] = {"draws": remote_draws, "seconds": time.perf_counter() - t1,
                         "median_slope": float(slope.median()),
                         "ok": abs(float(slope.median()) - 2.0) < 0.15}
    finally:
        t2 = time.perf_counter()
        manager.terminate()  # SIGTERM: the pool's handler terminates its nodes
        manager.join(timeout=DEMO_TEARDOWN_S)
        end = time.monotonic() + DEMO_TEARDOWN_S
        while time.monotonic() < end and (set(nodes) & set(_live_descendants())
                                          or any(_port_open(p) for p in ports)):
            time.sleep(0.1)
        gone_s = time.perf_counter() - t2
        left = sorted(set(nodes) & set(_live_descendants()))
        exitcode = manager.exitcode
        if manager.is_alive() or left:
            _reap(left + ([manager.pid] if manager.is_alive() else []))
            manager.join(timeout=5)
    out["teardown"] = {"node_pids": nodes, "manager_exitcode": exitcode, "seconds": gone_s,
                       "nodes_left": left, "ports_open": [p for p in ports if _port_open(p)],
                       "ok": (exitcode == 128 + signal.SIGTERM and not left
                              and len(nodes) == n_ports and gone_s <= DEMO_TEARDOWN_S
                              and not any(_port_open(p) for p in ports))}
    out["kernel_launches"] = launches
    ok = out["remote"]["ok"] and out["teardown"]["ok"] and out["local"]["ok"]
    return ok, out


# The optim phase: the sharded optimizer over a pool of owner nodes on the
# card.  Four node processes (two over shm, two over TCP, as the pool
# phase builds its lanes) each hold the flagship's 8 shards at 8 x 131,072
# and compute the full gradient of the negative posterior through the
# kernel for every update request (one launch each); a ShardedOptimizer
# splits the 11 parameters into 4 shards over a NodePool.  Adam at lr
# 0.05 for OPTIM_STEPS steps, one owner SIGKILLed after OPTIM_KILL_AFTER
# of them (its shard rebinds to a live replica, which restores it from
# the shared ShardStore); then OPTIM_SHARED_STEPS steps of a fresh run
# with 4 shards over 2 replicas (two shards per replica, serialized on
# its client), over a second store.  Evaluations: 4 per step and the
# driver-centric control's one per step.
OPTIM_LANES = ("shm", "shm", "tcp", "tcp")
OPTIM_SHARDS, OPTIM_LR = 4, 0.05
OPTIM_STEPS, OPTIM_KILL_AFTER, OPTIM_SHARED_STEPS = 200, 100, 50


def _optim_grad_fn(dev, n_obs):
    """``(grad_fn, flat0)``: the flagship's negative posterior at 8 x
    ``n_obs`` and its full flat gradient through the kernel wrapper (one
    launch per call), from a flat float32 parameter vector, returned as
    numpy; and the model's initial flat parameters.  The owners'
    ``grad_fn`` and the driver-centric control's."""
    import numpy as np

    import pytensor_federated_torch as pft
    from pytensor_federated_torch.samplers.util import ravel

    data, _ = pft.generate_node_data(8, n_obs=n_obs, seed=123, device=dev)
    model = pft.FederatedLinearRegression(data)
    (x, y), mask = data.tree()
    kern = pft.linreg_logp_grad_fn(x, y, mask)
    flat0, unravel = ravel(model.init_params())

    def grad_fn(params, *_):
        flat = torch.as_tensor(np.array(params, np.float32), device=dev).requires_grad_(True)
        p = unravel(flat)
        loss = -(model.prior_logp(p) + kern.data_logp(p))
        (g,) = torch.autograd.grad(loss, flat)
        return loss.detach().cpu().numpy(), g.cpu().numpy()

    return grad_fn, flat0.cpu().numpy()


def _optim_node(lane, n_obs, roots, dev, conn):
    """One owner replica process: ``make_update_compute`` over the
    flagship's gradient on ``dev``, one per store root in ``roots``, each
    served on a port of its own over ``lane``.  It answers the driver's
    commands on ``conn`` with its update and refresh requests and kernel
    launches since the last ``reset``."""
    sys.path.insert(0, str(ROOT))
    try:
        import threading

        import numpy as np

        from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
        from pytensor_federated_torch.optim import ShardStore, make_update_compute
        from pytensor_federated_torch.optim._adam import adam
        from pytensor_federated_torch.service import serve_shm, serve_tcp_once

        if dev == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"optim node {lane} found no GPU")
        grad_fn, _ = _optim_grad_fn(dev, n_obs)
        counts, lock, ports = {"updates": 0, "refreshes": 0}, threading.Lock(), []
        for root in roots:
            compute = make_update_compute(grad_fn, adam(OPTIM_LR), ShardStore(root),
                                          params_of=lambda arrays: np.asarray(arrays[0]).ravel())

            def versioned_update(arrays, part, version, inner=compute.versioned_update):
                with lock:
                    counts["updates" if len(arrays) else "refreshes"] += 1
                return inner(arrays, part, version)

            compute.versioned_update = versioned_update
            bound = threading.Event()

            def on_ready(port, bound=bound):
                ports.append(port)
                bound.set()

            threading.Thread(target=serve_shm if lane == "shm" else serve_tcp_once,
                             args=(compute,), daemon=True,
                             kwargs={"port": 0, "ready_callback": on_ready,
                                     "concurrent": True}).start()
            if not bound.wait(60):
                raise RuntimeError(f"optim node {lane} did not bind a port")
        conn.send({"lane": lane, "ports": ports, "pid": os.getpid(),
                   "device": torch.cuda.get_device_name() if dev == "cuda" else "cpu"})

        def now():
            with lock:
                return {**counts, "launches": linreg_reductions.launches}

        base = now()
        while True:
            cmd = conn.recv()
            cur = now()
            if cmd == "reset":  # counts to 0 just before a drive
                base = cur
            conn.send({k: cur[k] - base[k] for k in cur})
            if cmd == "stop":
                return
    except Exception:
        conn.send({"error": traceback.format_exc()})


def _optim_run(pool, params, steps, on_step=None):
    """``steps`` sharded Adam steps from ``params`` over ``pool``:
    ``(optimizer, params, accepted per shard, statuses, owners per
    step)``; ``on_step(step, optimizer)`` runs before each step."""
    from pytensor_federated_torch.optim import ShardedOptimizer

    opt = ShardedOptimizer(params.size, pool=pool, count=OPTIM_SHARDS)
    accepted, statuses, owners = [0] * OPTIM_SHARDS, {}, []
    for step in range(1, steps + 1):
        if on_step is not None:
            on_step(step, opt)
        results = opt.step([params])
        for r in results:
            statuses[r.status] = statuses.get(r.status, 0) + 1
            accepted[r.index] += r.accepted
        params, _ = opt.apply(params, results)
        owners.append([o.address for o in opt._owners])
    return opt, params, accepted, statuses, owners


def _opt_steps_gate(opt, store, accepted):
    """Per shard: the driver's version, the store's version and the Adam
    count in its checkpoint all equal the accepted steps."""
    out = []
    for k, part in enumerate(opt.parts):
        state = store.load(part)
        out.append({"shard": k, "accepted": accepted[k], "driver_version": opt.versions[k],
                    "store_version": state.version, "opt_steps": int(state.opt_leaves[0])})
    return all(r["accepted"] == r["driver_version"] == r["store_version"] == r["opt_steps"]
               for r in out), out


def phase_optim(dev="cuda", n_obs=LARGE_PATH[1], steps=OPTIM_STEPS, kill_after=OPTIM_KILL_AFTER,
                shared_steps=OPTIM_SHARED_STEPS):
    import shutil
    import tempfile

    import numpy as np

    from pytensor_federated_torch.optim import ShardStore, ShardedOptimizer
    from pytensor_federated_torch.optim._adam import adam
    from pytensor_federated_torch.optim.sharded import SHARD_UPDATES
    from pytensor_federated_torch.routing import NodePool

    planned = {"owner_evals": OPTIM_SHARDS * (steps + shared_steps), "control_evals": steps}
    roots = [tempfile.mkdtemp(prefix="chip-smoke-optim-") for _ in range(2)]
    ctx = _node_context()
    procs, conns, pools, out = [], [], [], {"phase": "optim", "size": [8, n_obs],
                                            "planned": planned}
    try:
        t0 = time.perf_counter()
        for lane in OPTIM_LANES:
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_optim_node, args=(lane, n_obs, roots, dev, child),
                               daemon=True)
            proc.start()
            procs.append(proc)
            conns.append(parent)
        # The driver-centric control while the nodes start: the same
        # gradient on this process's card, Adam on the whole vector.
        grad_fn, flat0 = _optim_grad_fn(dev, n_obs)
        opt = adam(OPTIM_LR)
        state = opt.init(torch.from_numpy(flat0))
        params, control, losses = flat0.copy(), {}, []
        tc = time.perf_counter()
        for step in range(1, steps + 1):
            loss, g = grad_fn(params)
            upd, state = opt.update(torch.from_numpy(g), state)
            params = params + upd.numpy()
            losses.append(float(loss))
            if step in (shared_steps, steps):
                control[step] = params
        out["control_s"] = time.perf_counter() - tc
        nodes = _fed_ask(conns, None, timeout=300.0)
        out["spawn_s"] = time.perf_counter() - t0
        out["nodes"] = [{"lane": n["lane"], "device": n["device"]} for n in nodes]

        # Run 1: 4 shards over 4 replicas, an owner SIGKILLed after
        # kill_after steps.
        pool = NodePool(transport="tcp", probe_interval_s=60.0,
                        breaker_kwargs={"failure_threshold": 1})
        pools.append(pool)
        for n in nodes:
            pool.add_replica("127.0.0.1", n["ports"][0], transport=n["lane"])
        addresses = [f"127.0.0.1:{n['ports'][0]}" for n in nodes]
        killed = {}

        def kill_owner(step, opt):
            if step != kill_after + 1:
                return
            victim = addresses.index(opt._owners[0].address)
            killed.update(index=victim, lane=nodes[victim]["lane"],
                          counts=_fed_ask([conns[victim]], "counts")[0])
            procs[victim].kill()
            procs[victim].join(timeout=10)
            killed["exitcode"] = procs[victim].exitcode

        _fed_ask(conns, "reset")
        applied0 = SHARD_UPDATES.labels(outcome="applied").value
        t1 = time.perf_counter()
        opt1, params1, accepted1, statuses1, owners1 = _optim_run(
            pool, flat0.copy(), steps, kill_owner)
        run1_s = time.perf_counter() - t1
        live = [k for k in range(len(procs)) if k != killed.get("index")]
        counts1 = dict(zip(live, _fed_ask([conns[k] for k in live], "counts")))
        counts1[killed["index"]] = killed["counts"]
        opt_ok1, opt_steps1 = _opt_steps_gate(opt1, ShardStore(roots[0]), accepted1)
        victim_addr = addresses[killed["index"]]
        after = owners1[kill_after:]
        run1 = {
            "steps": steps, "seconds": run1_s, "ms_per_step": run1_s * 1e3 / steps,
            "statuses": statuses1, "killed": {k: v for k, v in killed.items() if k != "counts"},
            "shards_on_victim_before_kill": sum(a == victim_addr for a in owners1[kill_after - 1]),
            "owners_after_kill": after[-1], "node_counts": [counts1[k] for k in range(len(procs))],
            "opt_steps": opt_steps1, "max_reply_elems": opt1.max_reply_elems,
            "applied_metric_delta": SHARD_UPDATES.labels(outcome="applied").value - applied0,
        }
        launches1 = sum(c["launches"] for c in counts1.values())
        run1["gates"] = {
            "bits_equal_driver_centric": bool(np.array_equal(params1, control[steps])),
            "opt_steps_equal_accepted": opt_ok1 and accepted1 == [steps] * OPTIM_SHARDS,
            "max_reply_elems_le_3": opt1.max_reply_elems <= 3,
            "launches_equal_update_requests": (
                all(c["launches"] == c["updates"] for c in counts1.values())
                and launches1 == statuses1.get("applied", 0) + statuses1.get("recovered", 0)
                if dev == "cuda" else True),
            "killed_by_sigkill": killed.get("exitcode") == -signal.SIGKILL,
            "rebound_off_the_victim": all(a != victim_addr for step in after for a in step),
            "loss_decreased": losses[-1] < losses[0],
        }

        # Run 2: a fresh optimizer, 4 shards over 2 replicas, second store.
        pool2 = NodePool(transport="tcp", probe_interval_s=60.0)
        pools.append(pool2)
        pair = live[:2]
        for k in pair:
            pool2.add_replica("127.0.0.1", nodes[k]["ports"][1], transport=nodes[k]["lane"])
        _fed_ask([conns[k] for k in live], "reset")
        t2 = time.perf_counter()
        opt2, params2, accepted2, statuses2, owners2 = _optim_run(pool2, flat0.copy(), shared_steps)
        run2_s = time.perf_counter() - t2
        counts2 = _fed_ask([conns[k] for k in live], "counts")
        opt_ok2, opt_steps2 = _opt_steps_gate(opt2, ShardStore(roots[1]), accepted2)
        launches2 = sum(c["launches"] for c in counts2)
        run2 = {
            "steps": shared_steps, "replicas": 2, "seconds": run2_s,
            "ms_per_step": run2_s * 1e3 / shared_steps, "statuses": statuses2,
            "owners": owners2[-1], "shards_per_replica": sorted(
                owners2[-1].count(a) for a in set(owners2[-1])), "node_counts": counts2, "opt_steps": opt_steps2,
            "max_reply_elems": opt2.max_reply_elems,
        }
        run2["gates"] = {
            "bits_equal_driver_centric": bool(np.array_equal(params2, control[shared_steps])),
            "opt_steps_equal_accepted": opt_ok2 and accepted2 == [shared_steps] * OPTIM_SHARDS,
            "max_reply_elems_le_3": opt2.max_reply_elems <= 3,
            "launches_equal_update_requests": (
                all(c["launches"] == c["updates"] for c in counts2)
                and launches2 == statuses2.get("applied", 0) if dev == "cuda" else True),
        }

        # A gRPC replica has no versioned lane: refused at bind.
        pool3 = NodePool(transport="grpc", probe_interval_s=60.0)
        pools.append(pool3)
        pool3.add_replica("127.0.0.1", nodes[live[0]]["ports"][0])
        try:
            ShardedOptimizer(flat0.size, pool=pool3, count=1).step([flat0])
            grpc = {"refused": False}
        except TypeError as e:
            grpc = {"refused": "no versioned-update lane" in str(e), "error": str(e)}

        _fed_ask([conns[k] for k in live], "stop")
        for k in live:
            procs[k].join(timeout=10)
        out.update({
            "shards": OPTIM_SHARDS, "lr": OPTIM_LR, "lanes": list(OPTIM_LANES),
            "run1": run1, "run2": run2, "grpc_refused_at_bind": grpc,
            "kernel_launches": launches1 + launches2,
            "final_params": params1.tolist(), "final_loss": losses[-1],
        })
        ok = (all(run1["gates"].values()) and all(run2["gates"].values()) and grpc["refused"])
        return ok, out
    finally:
        for pool in pools:
            pool.close()
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)


# The mesh phase: the flagship at 8 x 131,072 over a 4-slot mesh of one
# card ([cuda:0] * 4: the slots run one after another on its stream, so
# the phase shows the partition, the per-slot work and the cross-slot
# sum, not concurrency across cards), on the plain per-shard path as the
# JAX package's mesh model runs it.  MESH_FIND_MAP steps of find_map and
# NUTS 1 x (100 + 100) with a dense mass, its evaluations replayed from
# a CUDA graph.  NUTS took 13,574 evaluations in a run on the CPU (68 per
# transition: the intercept ridge), ~25-50 s at the eager leaf's 2-4 ms
# of host time.  Trees capped at depth 4 took a fifth of that but did
# not reach the posterior in 100 warmup transitions (sigma 0.652 against
# 0.500 for one seed), so the trees are not capped.
MESH_SLOTS = 4
MESH_NUTS = (1, 100, 100)  # chains, warmup, draws
MESH_FIND_MAP = dict(num_steps=30, learning_rate=0.05)
# Each slot's local shard (of its two) in the minibatch estimate.
MESH_MINIBATCH_LOCAL = [[0], [1], [1], [0]]
MESH_TIMED_EVALS = 20
# find_map on the card's mesh against find_map in float64 on the CPU
# without one, per parameter.
MESH_FIND_MAP_ATOL = 1e-4
# The JAX package's refusals (pytensor_federated_tpu/parallel/sharded.py
# :131-135, :251-254, :360-362), for 8 shards over 3 slots and a
# minibatch of 2 over 4.
MESH_ERRORS = {
    "federated_logp": "n_shards=8 not divisible by mesh axis 'shards' of size 3",
    "minibatch": "num_shards=2 not divisible by mesh axis 'shards' of size 4",
    "sharded_compute": "n_shards=8 not divisible by mesh axis size 3",
}


def _against_no_mesh(got, want):
    """The mesh's value and gradient against ``mesh=None``'s on the same
    device, at the float64 gates' tolerances (the two differ in the
    order of summation only)."""
    (v, g), (v0, g0) = got, want
    worst = 0.0
    for k in g0:
        err = (g[k] - g0[k]).double().abs()
        tol = MODEL_GRAD_RTOL * g0[k].double().abs() + MODEL_GRAD_ATOL_OF_MAX * float(
            g0[k].double().abs().max())
        worst = max(worst, float((err / tol.clamp_min(1e-30)).max()))
    rel = abs(float(v) - float(v0)) / abs(float(v0))
    return rel <= MODEL_VALUE_RTOL and worst <= 1.0, {"value_rel_err": rel,
                                                      "grad_err_over_tol": worst}


def phase_mesh(nuts_line, dev="cuda", n_obs=LARGE_PATH[1], slots=MESH_SLOTS, nuts=MESH_NUTS,
               find_map_steps=MESH_FIND_MAP["num_steps"]):
    import dataclasses

    import pytensor_federated_torch as pft
    from pytensor_federated_torch.diagnostics import Metrics
    from pytensor_federated_torch.parallel.sharded import sharded_compute
    from pytensor_federated_torch.samplers import find_map

    cuda = torch.device(dev).type == "cuda"
    card = torch.device("cuda", 0) if cuda else torch.device("cpu")
    data, _ = pft.generate_node_data(8, n_obs=n_obs, seed=123, device=card)
    mesh = pft.make_mesh({"shards": slots}, devices=[card] * slots)
    model = pft.FederatedLinearRegression(data, mesh=mesh)
    plain = pft.FederatedLinearRegression(data)
    data64 = _as_f64_cpu(data)
    model64 = pft.FederatedLinearRegression(data64)
    points = _three_points(model.init_params())
    out = {"phase": "mesh", "size": [8, n_obs], "mesh": dict(mesh.shape),
           "devices": [str(d) for d in mesh.devices.reshape(-1)],
           "planned_evals": {"gates": 12 + 2 * MESH_TIMED_EVALS, "find_map": find_map_steps,
                             "nuts": 68 * sum(nuts[1:])}}

    # Values and gradients: against float64 on the CPU, against mesh=None
    # on the card, and bit for bit against a rerun.
    ok64, against64 = _against_f64(model, model64, points)
    p = points["normal"]
    v, g = model.logp_and_grad(p)
    okp, against_plain = _against_no_mesh((v, g), plain.logp_and_grad(p))
    v2, g2 = model.logp_and_grad(p)
    rerun_bits = torch.equal(v, v2) and all(torch.equal(g[k], g2[k]) for k in g)
    per_shard = model.fed.per_shard_logps(p)
    per_shard64 = model64.fed.per_shard_logps(_as_f64_cpu(p))
    computed = sharded_compute(model.fed.per_shard_logp, model.fed.data, mesh=mesh)(p)
    rel = lambda a, b: float(((a.detach().cpu().double() - b).abs() / b.abs()).max())
    idx = torch.tensor(MESH_MINIBATCH_LOCAL, device=card)
    global_idx = torch.tensor([j * (8 // slots) + i for j, row in enumerate(MESH_MINIBATCH_LOCAL)
                               for i in row])
    mb = model.fed._minibatch_estimate(p, idx)
    mb64 = model64.fed._minibatch_estimate(_as_f64_cpu(p), global_idx)
    gen = torch.Generator(device=card).manual_seed(1)
    drawn = model.fed._draw_shards(gen, 4)
    values = {
        "against_f64": against64, "against_no_mesh": against_plain, "rerun_bits": rerun_bits,
        "per_shard_rel_err": rel(per_shard, per_shard64),
        "sharded_compute_equals_per_shard": torch.equal(computed, per_shard),
        "minibatch_rel_err": rel(mb, mb64),
        "minibatch_draw_shape": list(drawn.shape),
    }
    values_ok = (ok64 and okp and rerun_bits and values["per_shard_rel_err"] <= MODEL_VALUE_RTOL
                 and values["sharded_compute_equals_per_shard"]
                 and values["minibatch_rel_err"] <= MODEL_VALUE_RTOL
                 and values["minibatch_draw_shape"] == [slots, 4 // slots])
    out["values"] = values
    out["ms_per_logp_and_grad"] = {
        "mesh": _ms_per_eval(lambda: model.logp_and_grad(p), dev, MESH_TIMED_EVALS),
        "no_mesh": _ms_per_eval(lambda: plain.logp_and_grad(p), dev, MESH_TIMED_EVALS),
    }
    out["cuda_launches_per_logp_and_grad"] = {
        "mesh": _launches(lambda: model.logp_and_grad(p), dev, 3),
        "no_mesh": _launches(lambda: plain.logp_and_grad(p), dev, 3),
    }

    # The JAX package's error strings for meshes that do not divide.
    errors = {}
    three = pft.make_mesh({"shards": 3}, devices=[card] * 3)
    for name, call in (
        ("federated_logp", lambda: pft.FederatedLinearRegression(data, mesh=three)),
        ("minibatch", lambda: model.fed.logp_minibatch(p, gen, 2)),
        ("sharded_compute", lambda: sharded_compute(model.fed.per_shard_logp, model.fed.data,
                                                    mesh=three)),
    ):
        try:
            call()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    errors_ok = errors == MESH_ERRORS

    # find_map on the mesh against find_map in float64 on the CPU.
    t0 = time.perf_counter()
    est = find_map(model.logp, model.init_params(), num_steps=find_map_steps,
                   learning_rate=MESH_FIND_MAP["learning_rate"])
    _sync(dev)
    map_s = time.perf_counter() - t0
    est64 = find_map(model64.logp, _as_f64_cpu(model.init_params()), num_steps=find_map_steps,
                     learning_rate=MESH_FIND_MAP["learning_rate"])
    map_err = max(float((est[k].detach().cpu().double() - est64[k]).abs().max()) for k in est64)
    out["find_map"] = {"steps": find_map_steps, "seconds": map_s, "max_abs_err_vs_f64": map_err,
                       "atol": MESH_FIND_MAP_ATOL, "slope": float(est["slope"])}
    map_ok = map_err <= MESH_FIND_MAP_ATOL

    # NUTS on the mesh, its evaluations replayed from a CUDA graph.
    metrics = Metrics()
    lp = pft.instrument_logp(model.logp, "mesh.logp", registry=metrics)
    chains, warmup, draws = nuts
    gen = torch.Generator(device=card).manual_seed(11)
    _sync(dev)
    t0 = time.perf_counter()
    res = pft.samplers.sample(lp, model.init_params(), generator=gen, num_warmup=warmup,
                              num_samples=draws, num_chains=chains, dense_mass=True,
                              cuda_graph=cuda)
    _sync(dev)
    wall = time.perf_counter() - t0
    eager = metrics.snapshot()["counters"].get("mesh.logp.evals", 0)
    replays = res.extra["graph_replays"] if cuda else 0
    s = res.samples
    derived = {"intercept": s["intercept"], "slope": s["slope"], "sigma": torch.exp(s["log_sigma"])}
    ess = pft.samplers.effective_sample_size(derived)
    ref = nuts_line.get("recovered", {})
    moments, nuts_ok = {}, bool(ref)
    for k, d in derived.items():
        mean, sd = float(d.double().mean()), float(d.double().std())
        mcse = sd / float(ess[k]) ** 0.5
        r = ref.get(k, {})
        combined = math.sqrt(mcse**2 + r.get("mcse", float("inf")) ** 2)
        within = abs(mean - r.get("mean", float("inf"))) <= 4 * combined
        moments[k] = {"mean": mean, "sd": sd, "ess": float(ess[k]), "mcse": mcse,
                      "nuts_large_mean": r.get("mean"), "nuts_large_mcse": r.get("mcse"),
                      "within_4_combined_mcse": within}
        nuts_ok &= within
    finite = all(bool(torch.isfinite(v).all()) for v in s.values())
    out["nuts"] = {
        "chains": chains, "warmup": warmup, "draws": draws, "dense_mass": True,
        "cuda_graph": cuda, "wall_s": wall, "eager_evals": eager, "graph_replays": replays,
        "ms_per_grad_eval": wall * 1e3 / max(eager + replays, 1),
        "mean_tree_depth": float(res.stats["depth"].float().mean()),
        "divergences": int(res.stats["diverging"].sum()),
        "max_split_rhat": max(float(v.max()) for v in pft.samplers.split_rhat(s).values()),
        "moments": moments, "finite": finite,
    }

    # The device report and the probe.
    loads = pft.get_load() if cuda else pft.get_load([card])
    healthy = pft.healthy_devices() if cuda else pft.healthy_devices([card])
    out["get_load"] = [dataclasses.asdict(x) for x in loads]
    out["healthy_devices"] = [str(d) for d in healthy]
    load_ok = (not cuda) or (loads[0].platform == "gpu" and (loads[0].bytes_limit or 0) > 0
                             and (loads[0].bytes_in_use or 0) > 0 and healthy == [card])
    out["gates"] = {"values": values_ok, "errors": errors_ok, "find_map": map_ok,
                    "nuts_means": nuts_ok and finite, "instrument_logp": eager > 0,
                    "device_report": load_ok}
    return all(out["gates"].values()), out


# Slice 12: the chains and sequence axes on the single-controller mesh.
# A mesh of [cuda:0] * n shows the partition and the cross-slot work on
# one card, not concurrency across cards.
#
# multichain: the flagship at 8 x 131,072 (the mesh phase's model) on a
# {"chains": 2, "shards": 2} mesh, 2 chains x (100 warmup + 100 draws)
# of NUTS with a dense mass, every evaluation replayed from a CUDA graph:
# the plain per-shard path, as the JAX package's multichain_sample
# evaluates the caller's function.  The chains start at the generating
# parameters plus the default jitter (0.5 N(0, 1)), with trees up to
# depth 8: on the card (PERF.md section 6) chains from the origin did
# not all reach the posterior in 100 warmup transitions, and at the JAX
# default depth 6 two chains from the generating point stayed apart on
# the intercept/offsets ridge (split R-hat 7-9).  That ridge is set by
# the offsets' prior alone (the data pin each shard's intercept +
# offset to ~0.0014): in 100 draws a chain moves along it by a fraction
# of its length, and split R-hat across the chains of the raw intercept
# read 1.021 and 1.091 for two seeds.  So the R-hat gate reads what the
# data identify: slope, log_sigma and each shard's intercept + offset;
# the raw parameters' R-hat is recorded beside it.  It does not hold the
# raw parameters to R-hat < 1.05.
# Then short sharded runs held against the same runs unsharded: sample()
# (4 chains over {"chains": 2}, through the kernel, graphed) and
# chees_sample() (8 chains over {"chains": 2}, eager, through the kernel)
# at 8 x 64, and pt_sample() on the tempering phase's bimodal, one stack's
# 8 rungs over {"temps": 8}.
MULTICHAIN_MESH = {"chains": 2, "shards": 2}
MULTICHAIN_NUTS = (100, 100)  # warmup, draws per chain
MULTICHAIN_SEEDS = (21,)  # the NUTS run's seeds (--multichain-seeds runs more)
MULTICHAIN_MAX_DEPTH = 8
MULTICHAIN_TIMED_EVALS = 10
MULTICHAIN_RERUN = (3, 3)  # the rerun-bits check: warmup, draws, twice
MULTICHAIN_SAMPLE = dict(num_chains=4, num_warmup=15, num_samples=15)
MULTICHAIN_CHEES = dict(num_chains=8, num_warmup=6, num_samples=6, max_leapfrogs=16)
MULTICHAIN_PT = dict(num_temps=8, num_warmup=25, num_samples=50, num_leapfrog=4, beta_min=0.01)
# seq: config 6's model (LGSSM, T = 4,096) over {"seq": 4}, with no mask
# and with ~30% of the steps missing (t = 1 among them); the AR(1) at
# T = 4,096; ring attention at (T, d) = (4,096, 64), causal and not; the
# all-pairs sum over 1,024 points in 3 dimensions.
SEQ_SLOTS = 4
SEQ_MISSING, SEQ_MASK_SEED = 0.3, 12
SEQ_HORIZON = 16
SEQ_DRAWS = 64  # simulation-smoother draws, one vmapped batch
SEQ_TIMED_EVALS = 3
SEQ_ATTENTION = (4096, 64)
SEQ_PAIRS = (1024, 3)
SEQ_FORECAST_RTOL, SEQ_FORECAST_ATOL = 1e-4, 1e-6  # tests/test_statespace.py
# Draw means within SEQ_DRAW_Z standard errors of the smoothed means at
# every step and coordinate (8,192 of them: P(|z| > 6) ~ 2e-9 each), and
# the draws' variance over the smoothed variance, averaged over steps and
# coordinates, within 1 +- SEQ_VAR_BAND.
SEQ_DRAW_Z, SEQ_VAR_BAND = 6.0, 0.1
# Attention and the all-pairs sum in float32 on the card against float64
# on the CPU.
SEQ_ATTENTION_ATOL, SEQ_PAIRS_RTOL = 1e-4, 1e-4
# The AR(1) off its generating point (mu 0.5, phi 0.8, sigma 0.3), where
# no gradient component cancels: value rtol 1e-5 (a float32 sum of 4,096
# terms), gradient 1e-3 |g| + 1e-2 (the slots sum in another order).
SEQ_AR1_POINT = {"mu": 0.0, "arctanh_phi": 0.5, "log_sigma": -0.5}
SEQ_AR1_TOL = (1e-5, 1e-3, 1e-2)


def _flat_against(v, g, v_ref, g_ref):
    """A chain batch's values ``(C,)`` and flat gradients ``(C, d)``
    against a reference, at the float64 gates' tolerances (value rtol
    MODEL_VALUE_RTOL; gradient within MODEL_GRAD_RTOL |g| +
    MODEL_GRAD_ATOL_OF_MAX max|g| of the chain)."""
    v, g = v.detach().cpu().double(), g.detach().cpu().double()
    v_ref, g_ref = v_ref.detach().cpu().double(), g_ref.detach().cpu().double()
    rel = float(((v - v_ref).abs() / v_ref.abs()).max())
    tol = MODEL_GRAD_RTOL * g_ref.abs() + MODEL_GRAD_ATOL_OF_MAX * g_ref.abs().max(
        dim=-1, keepdim=True).values
    worst = float(((g - g_ref).abs() / tol.clamp_min(1e-30)).max())
    return rel <= MODEL_VALUE_RTOL and worst <= 1.0, {"value_rel_err": rel,
                                                      "grad_err_over_tol": worst}


def _bits_or_moments(a, b):
    """Two runs' draws (params trees, leading (chains, draws)): equal bit
    for bit, or, where the bits differ, every parameter's mean within 4
    combined Monte Carlo standard errors."""
    import pytensor_federated_torch as pft

    bits = all(torch.equal(a[k], b[k]) for k in a)
    if bits:
        return True, {"bits_equal": True}
    worst = 0.0
    ess_a = pft.samplers.effective_sample_size(a)
    ess_b = pft.samplers.effective_sample_size(b)
    for k in a:
        da, db = a[k].double(), b[k].double()
        se = torch.sqrt(da.var(dim=(0, 1)) / ess_a[k] + db.var(dim=(0, 1)) / ess_b[k])
        diff = (da.mean(dim=(0, 1)) - db.mean(dim=(0, 1))).abs()
        worst = max(worst, float((diff / se.clamp_min(1e-30)).max()))
    return worst <= 4.0, {"bits_equal": False, "max_mean_diff_over_combined_mcse": worst}


def phase_multichain(nuts_line, dev="cuda", n_obs=LARGE_PATH[1], nuts=MULTICHAIN_NUTS,
                     rerun=MULTICHAIN_RERUN, seeds=MULTICHAIN_SEEDS):
    """Slice 12, the chains axis: multichain_sample on a 2-D mesh of the
    card (its NUTS run once for each of ``seeds``, every run gated), and
    chain and temperature sharding in the samplers."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
    from pytensor_federated_torch.parallel.mesh import NamedSharding
    from pytensor_federated_torch.parallel.multichain import (
        multichain_logp_and_grad,
        multichain_sample,
    )
    from pytensor_federated_torch.samplers.chees import chees_sample
    from pytensor_federated_torch.samplers.mcmc import (
        make_batch_logp_and_grad,
        make_flat_logp_and_grad,
    )
    from pytensor_federated_torch.samplers.tempering import pt_sample
    from pytensor_federated_torch.samplers.util import ravel

    cuda = torch.device(dev).type == "cuda"
    card = torch.device("cuda", 0) if cuda else torch.device("cpu")
    slots = math.prod(MULTICHAIN_MESH.values())
    mesh = pft.make_mesh(MULTICHAIN_MESH, devices=[card] * slots)
    data, true_offsets = pft.generate_node_data(8, n_obs=n_obs, seed=123, device=card)
    model = pft.FederatedLinearRegression(data)
    model64 = pft.FederatedLinearRegression(_as_f64_cpu(data))
    start = {"intercept": torch.tensor(TRUE["intercept"], device=card),
             "slope": torch.tensor(TRUE["slope"], device=card),
             "log_sigma": torch.tensor(math.log(TRUE["sigma"]), device=card),
             "offsets": torch.as_tensor(true_offsets, dtype=torch.float32, device=card)}
    flat0, unravel = ravel(model.init_params())
    shard_fn, prior = model.fed.per_shard_logp, model.prior_logp
    lg = multichain_logp_and_grad(shard_fn, model.fed.data, unravel, mesh=mesh, prior_logp=prior)
    out = {"phase": "multichain", "size": [8, n_obs], "mesh": dict(mesh.shape),
           "devices": [str(d) for d in mesh.devices.reshape(-1)],
           "note": "a mesh of one card shows the partition and the cross-slot sum, "
                   "not concurrency across cards"}

    # Each chain's value and gradient on the mesh: against the unsharded
    # model on the card and against float64 on the CPU.
    points = _three_points(model.init_params())
    X = torch.stack([ravel(points[k])[0] for k in ("perturbed", "normal")])
    v, g = lg(X)
    v0, g0 = zip(*(model.logp_and_grad(unravel(x)) for x in X))
    v64, g64 = zip(*(model64.logp_and_grad(_as_f64_cpu(unravel(x))) for x in X))
    ok_plain, against_plain = _flat_against(v, g, torch.stack(v0),
                                            torch.stack([ravel(t)[0] for t in g0]))
    ok64, against64 = _flat_against(v, g, torch.stack(v64),
                                    torch.stack([ravel(t)[0] for t in g64]))
    out["values"] = {"against_no_mesh": against_plain, "against_f64": against64}
    out["ms_per_logp_and_grad"] = {
        "mesh": _ms_per_eval(lambda: lg(X), dev, MULTICHAIN_TIMED_EVALS),
        "no_mesh": _ms_per_eval(lambda: [model.logp_and_grad(unravel(x)) for x in X], dev,
                                MULTICHAIN_TIMED_EVALS)}
    out["cuda_launches_per_logp_and_grad"] = {
        "mesh": _launches(lambda: lg(X), dev, 3),
        "no_mesh": _launches(lambda: [model.logp_and_grad(unravel(x)) for x in X], dev, 3)}

    def run(seed, warmup, draws):
        gen = torch.Generator(device=card).manual_seed(seed)
        return multichain_sample(shard_fn, model.fed.data, start, mesh=mesh, generator=gen,
                                 num_warmup=warmup, num_samples=draws, dense_mass=True,
                                 prior_logp=prior, max_depth=MULTICHAIN_MAX_DEPTH,
                                 cuda_graph=cuda, return_extra=True)

    ref = nuts_line.get("recovered", {})

    def readings(draws, accept):
        """R-hat across the chains of what the data identify (the gate)
        and of the raw parameters, and the derived moments against
        nuts_large's within 4 combined MCSEs."""
        samples = unravel(draws)
        derived = {"intercept": samples["intercept"], "slope": samples["slope"],
                   "sigma": torch.exp(samples["log_sigma"])}
        identified = {"slope": samples["slope"], "log_sigma": samples["log_sigma"],
                      "shard_intercepts": samples["intercept"][..., None] + samples["offsets"]}
        ess = pft.samplers.effective_sample_size(derived)
        moments, moments_ok = {}, bool(ref)
        for k, d in derived.items():
            mean, sd = float(d.double().mean()), float(d.double().std())
            mcse = sd / float(ess[k]) ** 0.5
            r = ref.get(k, {})
            combined = math.sqrt(mcse**2 + r.get("mcse", float("inf")) ** 2)
            within = abs(mean - r.get("mean", float("inf"))) <= 4 * combined
            moments[k] = {"mean": mean, "sd": sd, "ess": float(ess[k]), "mcse": mcse,
                          "nuts_large_mean": r.get("mean"), "nuts_large_mcse": r.get("mcse"),
                          "within_4_combined_mcse": within}
            moments_ok &= within
        return {"accept_prob": float(accept.mean()),
                "max_split_rhat_identified": max(
                    float(r.max()) for r in pft.samplers.split_rhat(identified).values()),
                "split_rhat_raw": {k: float(r.max())
                                   for k, r in pft.samplers.split_rhat(samples).items()},
                "moments": moments, "moments_ok": moments_ok,
                "finite": bool(torch.isfinite(draws).all())}

    # The kernel's launches in one eager call of the mesh's evaluation:
    # what each replay of the run's graph must launch on the card.
    linreg_reductions.launches = 0
    lg(X)
    per_call = linreg_reductions.launches
    _sync(dev)
    linreg_reductions.launches = 0
    t0 = time.perf_counter()
    draws, accept, _, extra = run(seeds[0], *nuts)
    _sync(dev)
    wall = time.perf_counter() - t0
    host_launches = linreg_reductions.launches
    main = readings(draws, accept)
    replays = extra.get("graph_replays", 0)
    if cuda:
        flat_start = ravel(start)[0]
        graph = _graph_check(extra["graph"], lg, _graph_points(flat_start, X.shape[0], dev, 41),
                             expected=per_call, timed=0)
        launches = _graphed_launches(graph, host_launches, replays)
        graph_ok = graph["launch_ok"] and graph["replay_bits_equal_eager"] and replays > 0
    else:
        graph, launches, graph_ok = {}, host_launches, True  # no graph off the card
    del extra
    others = {}
    for seed in seeds[1:]:
        t1 = time.perf_counter()
        d, a, _, _ = run(seed, *nuts)
        others[str(seed)] = {**readings(d, a), "wall_s": time.perf_counter() - t1}
    rerun_bits = torch.equal(run(5, *rerun)[0], run(5, *rerun)[0])
    out["nuts"] = {"chains": MULTICHAIN_MESH["chains"], "warmup": nuts[0], "draws": nuts[1],
                   "dense_mass": True, "max_depth": MULTICHAIN_MAX_DEPTH, "seed": seeds[0],
                   "start": "generating parameters + 0.5 N(0, 1)", "cuda_graph": cuda,
                   "wall_s": wall, "graph_replays": replays,
                   "ms_per_grad_eval": wall * 1e3 / max(replays, 1),
                   "kernel_launches_per_eager_call": per_call, "kernel_launches": launches,
                   "graph": graph, **main, "other_seeds": others,
                   "rerun": {"warmup": rerun[0], "draws": rerun[1], "bits_equal": rerun_bits}}
    runs = [main, *others.values()]

    # Chain and temperature sharding against the same runs unsharded.
    # The sample and chees runs go through the kernel; the launches of
    # the graphed sample runs are the graph's count per replay times
    # the replays (see phase_nuts), those of the eager chees runs the
    # wrapper's count.
    sharding = NamedSharding(pft.make_mesh({"chains": 2}, devices=[card] * 2), "chains")
    _, fmodel, _, posterior = _flagship(FLAGSHIP[1], dev)
    flat_logp, fflat0, funravel, _ = make_flat_logp_and_grad(posterior, fmodel.init_params())
    batch_lg = make_batch_logp_and_grad(flat_logp, funravel)
    points = _graph_points(fflat0, MULTICHAIN_SAMPLE["num_chains"], dev, 31)
    sharded_runs, graphs = {}, {}
    # One launch per block of chains.
    for name, sh, per_replay in (("unsharded", None, 1), ("sharded", sharding, 2)):
        linreg_reductions.launches = 0
        gen = torch.Generator(device=card).manual_seed(13)
        t0 = time.perf_counter()
        res = pft.samplers.sample(posterior, fmodel.init_params(), generator=gen,
                                  cuda_graph=cuda, chain_sharding=sh, **MULTICHAIN_SAMPLE)
        _sync(dev)
        wall = time.perf_counter() - t0
        host_launches = linreg_reductions.launches  # before the check's eager calls
        if cuda:
            replays = res.extra["graph_replays"]
            graphs[name] = _graph_check(res.extra["graph"],
                                        batch_lg if sh is None else sh.map_blocks(batch_lg),
                                        points, expected=per_replay, timed=5)
            n = _graphed_launches(graphs[name], host_launches, replays)
            graph_ok &= graphs[name]["launch_ok"] and graphs[name]["replay_bits_equal_eager"]
        else:
            replays, n, graphs[name] = 0, host_launches, {}
        launches += n
        sharded_runs[name] = res.samples
        graphs[name].update(wall_s=wall, graph_replays=replays, kernel_launches=n)
    ok_sample, sample_cmp = _bits_or_moments(sharded_runs["unsharded"], sharded_runs["sharded"])
    chees_runs = {}
    for name, sh in (("unsharded", None), ("sharded", sharding)):
        linreg_reductions.launches = 0
        gen = torch.Generator(device=card).manual_seed(17)
        chees_runs[name] = chees_sample(posterior, fmodel.init_params(), generator=gen,
                                        chain_sharding=sh, **MULTICHAIN_CHEES).samples
        launches += linreg_reductions.launches
    ok_chees, chees_cmp = _bits_or_moments(chees_runs["unsharded"], chees_runs["sharded"])
    temps = NamedSharding(pft.make_mesh({"temps": MULTICHAIN_PT["num_temps"]},
                                        devices=[card] * MULTICHAIN_PT["num_temps"]), "temps")
    init = {"x": torch.zeros(BIMODAL["dim"], device=card)}
    pt_runs = {name: pt_sample(_bimodal_logp, init, generator=torch.Generator(
        device=card).manual_seed(19), temp_sharding=sh, **MULTICHAIN_PT).samples
        for name, sh in (("unsharded", None), ("sharded", temps))}
    ok_pt, pt_cmp = _bits_or_moments(pt_runs["unsharded"], pt_runs["sharded"])
    out["sharding"] = {
        "sample": {"size": list(FLAGSHIP), **MULTICHAIN_SAMPLE, "mesh": {"chains": 2},
                   "graphs": graphs, **sample_cmp},
        "chees": {"size": list(FLAGSHIP), **MULTICHAIN_CHEES, "mesh": {"chains": 2},
                  **chees_cmp},
        "pt": {"target": BIMODAL, **MULTICHAIN_PT, "mesh": {"temps": MULTICHAIN_PT["num_temps"]},
               **pt_cmp},
    }
    out["kernel_launches"] = launches
    out["gates"] = {"values": ok_plain and ok64,
                    "rhat": all(r["max_split_rhat_identified"] < 1.05 for r in runs),
                    "moments": all(r["moments_ok"] and r["finite"] for r in runs),
                    "rerun_bits": rerun_bits, "graph_launches": graph_ok,
                    "sample_sharding": ok_sample, "chees_sharding": ok_chees,
                    "pt_sharding": ok_pt}
    return all(out["gates"].values()), out


def phase_seq(dev="cuda", lgssm=LGSSM, slots=SEQ_SLOTS, draws=SEQ_DRAWS,
              attention=SEQ_ATTENTION, pairs=SEQ_PAIRS):
    """Slice 12, the sequence axis: SeqShardedLGSSM, SeqShardedAR1 and the
    ring collectives over a {"seq": 4} mesh of the card."""
    import numpy as np

    import pytensor_federated_torch as pft
    from pytensor_federated_torch.models import statespace as ss
    from pytensor_federated_torch.models.timeseries import SeqShardedAR1, generate_ar1_data
    from pytensor_federated_torch.parallel import ring
    from pytensor_federated_torch.utils import value_and_grad

    cuda = torch.device(dev).type == "cuda"
    card = torch.device("cuda", 0) if cuda else torch.device("cpu")
    mesh = pft.make_mesh({"seq": slots}, devices=[card] * slots)
    y, params = pft.generate_lgssm_data(**lgssm, device=card)
    T = y.shape[0]
    mask = (np.random.default_rng(SEQ_MASK_SEED).uniform(size=T) >= SEQ_MISSING).astype(
        np.float32)
    mask[0] = 0.0  # t = 1 masked: the first slot's prior element, unconditioned
    y64, p64 = y.cpu().double(), {k: v.cpu().double() for k, v in params.items()}
    tol = (LGSSM_VALUE_RTOL, LGSSM_GRAD_RTOL, LGSSM_GRAD_ATOL)
    out = {"phase": "seq", "size": lgssm, "mesh": dict(mesh.shape),
           "devices": [str(d) for d in mesh.devices.reshape(-1)],
           "missing_share": float(1.0 - mask.mean()),
           "note": "a mesh of one card shows the partition and the cross-slot work, "
                   "not concurrency across cards"}
    gates, cases = {}, {}
    for name, m in (("no_mask", None), ("mask", mask)):
        mt = None if m is None else torch.as_tensor(m, device=card)
        m64 = None if m is None else torch.as_tensor(m, dtype=torch.float64)
        model = ss.SeqShardedLGSSM(y, mesh, mask=m)
        vg = model.logp_and_grad(params)
        vg_card = value_and_grad(lambda q: ss.kalman_logp_parallel(q, y, mt), params)
        vg64 = value_and_grad(lambda q: ss.kalman_logp_parallel(q, y64, m64), p64)
        c = {"logp": float(vg[0]), "logp_f64": float(vg64[0])}
        ok_card, c["logp_grad_vs_card"] = _flat_close(vg, vg_card, *tol)
        ok64, c["logp_grad_vs_f64"] = _flat_close(vg, vg64, *tol)
        sm = model.smoothed_moments(params)
        sm_card = ss.kalman_smoother_parallel(params, y, mt)
        sm64 = ss.kalman_smoother_parallel(p64, y64, m64)
        sm_ok, c["smoothed_err_over_tol"] = True, {}
        for label, ref in (("card", sm_card), ("f64", sm64)):
            oks, ratios = zip(*(_close(a, b, LGSSM_GRAD_RTOL, LGSSM_GRAD_ATOL)
                                for a, b in zip(sm, ref)))
            sm_ok &= all(oks)
            c["smoothed_err_over_tol"][label] = {"means": ratios[0], "covs": ratios[1]}
        fc = model.forecast(params, SEQ_HORIZON)
        fc_ok, c["forecast_err_over_tol"] = True, {}
        for label, ref in (("card", ss.kalman_forecast(params, y, SEQ_HORIZON, mt)),
                           ("f64", ss.kalman_forecast(p64, y64, SEQ_HORIZON, m64))):
            oks, ratios = zip(*(_close(a, b, SEQ_FORECAST_RTOL, SEQ_FORECAST_ATOL)
                                for a, b in zip(fc, ref)))
            fc_ok &= all(oks)
            c["forecast_err_over_tol"][label] = {"means": ratios[0], "covs": ratios[1]}
        gates[name] = ok_card and ok64 and sm_ok and fc_ok
        cases[name] = (model, c, sm)
    # Time and launches per logp+grad, with the mask (the same work as
    # without it), with and without the mesh; both ran in the gates
    # above, so one warm-up call each.
    model = cases["mask"][0]
    mt = torch.as_tensor(mask, device=card)
    plain = lambda: value_and_grad(lambda q: ss.kalman_logp_parallel(q, y, mt), params)
    out["ms_per_logp_and_grad"] = {
        "mesh": _ms_per_eval(lambda: model.logp_and_grad(params), dev, SEQ_TIMED_EVALS, warm=1),
        "no_mesh": _ms_per_eval(plain, dev, SEQ_TIMED_EVALS, warm=1)}
    out["cuda_launches_per_logp_and_grad"] = {
        "mesh": _launches(lambda: model.logp_and_grad(params), dev, 1),
        "no_mesh": _launches(plain, dev, 1)}
    # The simulation smoother's draws against the smoothed moments.
    model, c, (sm_mean, sm_cov) = cases["mask"]
    t0 = time.perf_counter()
    zs = model.sample_latents(params, torch.Generator(device=card).manual_seed(3), draws)
    _sync(dev)
    zs, sm_mean, sm_cov = zs.cpu().double(), sm_mean.cpu().double(), sm_cov.cpu().double()
    sd = torch.sqrt(torch.diagonal(sm_cov, dim1=-2, dim2=-1))
    z = float(((zs.mean(0) - sm_mean).abs() / (sd / math.sqrt(draws))).max())
    var_ratio = float((zs.var(0) / sd**2).mean())
    c["sample_latents"] = {"draws": draws, "seconds": time.perf_counter() - t0,
                           "max_mean_z": z, "mean_var_ratio": var_ratio}
    gates["sample_latents"] = (z <= SEQ_DRAW_Z and abs(var_ratio - 1.0) <= SEQ_VAR_BAND
                               and bool(torch.isfinite(zs).all()))
    out["lgssm"] = {name: cases[name][1] for name in cases}

    # The AR(1) at T = 4,096, with the mesh against without it on the
    # card and against float64 on the CPU.
    y_ar = generate_ar1_data(T, seed=7)
    ar_mesh, ar_plain = SeqShardedAR1(y_ar, mesh=mesh), SeqShardedAR1(y_ar, device=card)
    ar64 = SeqShardedAR1(y_ar.astype(np.float64), device="cpu")
    p_ar = {k: torch.tensor(v, device=card) for k, v in
            SEQ_AR1_POINT.items()}
    vg_ar = ar_mesh.logp_and_grad(p_ar)
    ok_ar, ar_card = _flat_close(vg_ar, ar_plain.logp_and_grad(p_ar), *SEQ_AR1_TOL)
    ok_ar64, ar_f64 = _flat_close(vg_ar, ar64.logp_and_grad(_as_f64_cpu(p_ar)), *SEQ_AR1_TOL)
    out["ar1"] = {"T": T, "logp": float(vg_ar[0]), "vs_no_mesh": ar_card, "vs_f64": ar_f64,
                  "ms_per_logp_and_grad": {
                      "mesh": _ms_per_eval(lambda: ar_mesh.logp_and_grad(p_ar), dev,
                                           SEQ_TIMED_EVALS),
                      "no_mesh": _ms_per_eval(lambda: ar_plain.logp_and_grad(p_ar), dev,
                                              SEQ_TIMED_EVALS)}}
    gates["ar1"] = ok_ar and ok_ar64

    # Ring attention and the all-pairs sum against dense float64 on the CPU.
    g = torch.Generator(device=card).manual_seed(8)
    q, k, v = (torch.randn(attention, generator=g, device=card) for _ in range(3))
    q64, k64, v64 = (t.cpu().double() for t in (q, k, v))
    att = {}
    for causal in (False, True):
        t0 = time.perf_counter()
        o = ring.ring_attention(q, k, v, mesh=mesh, causal=causal)
        _sync(dev)
        s = (q64 @ k64.T) / math.sqrt(attention[1])
        if causal:
            s = s.masked_fill(~torch.tril(torch.ones(s.shape, dtype=torch.bool)), -torch.inf)
        ref = torch.softmax(s, dim=-1) @ v64
        err = float((o.cpu().double() - ref).abs().max())
        att["causal" if causal else "full"] = {"max_abs_err": err, "seconds":
                                               time.perf_counter() - t0}
    out["ring_attention"] = {"shape": list(attention), "atol": SEQ_ATTENTION_ATOL, **att}
    gates["ring_attention"] = all(a["max_abs_err"] <= SEQ_ATTENTION_ATOL for a in att.values())
    x = torch.randn(pairs, generator=g, device=card)
    pair = lambda a, b: torch.sum(torch.exp(-torch.sum((a[:, None] - b[None]) ** 2, dim=-1)))
    x64 = x.cpu().double()
    pair_out = {}
    for include_self in (True, False):
        got = float(ring.ring_all_pairs_sum(pair, x, mesh=mesh, include_self=include_self))
        want = pair(x64, x64)
        if not include_self:
            want = want - sum(pair(b, b) for b in x64.split(pairs[0] // slots))
        pair_out["with_self" if include_self else "without_self"] = {
            "value": got, "f64": float(want), "rel_err": abs(got - float(want)) / float(want)}
    out["ring_all_pairs_sum"] = {"shape": list(pairs), "rtol": SEQ_PAIRS_RTOL, **pair_out}
    gates["ring_all_pairs_sum"] = all(p["rel_err"] <= SEQ_PAIRS_RTOL for p in pair_out.values())
    out["gates"] = gates
    return all(gates.values()), out


# Slice 13: the rest of the parallel axes (ZeRO, tensor, expert,
# Ulysses), the multi-process mesh and elastic sampling.  Meshes of
# [cuda:0] * n show the partition and the cross-slot work on one card;
# the multihost phase's two gloo ranks share the card too, so it shows
# the partition and the cross-process sum, not NCCL or concurrency
# across cards.
#
# zero: ZeroShardedLogpGrad on {"shards": 4}: the flagship's data term at
# 8 x 131,072 through the kernel (one launch per slot and evaluation)
# and config 7's wide logistic (8 x 4,096 x 512: dim 513 pads to 516);
# the scattered gradient against FederatedLogp(mesh=same) and against
# float64 on the CPU, then ZERO_STEPS SGD and Adam steps against the
# same loops on the replicated gradient.  The flagship's SGD rate sits
# below 2 / the curvature of its data term at the origin (~3e7 in
# log_sigma), the wide model's below 2 / ~1e4.
SLICE13 = ("zero", "parallel_axes", "multihost", "elastic")
ZERO_SLOTS = 4
ZERO_STEPS = 50
ZERO_SGD_LR = {"flagship": 1e-8, "wide": 1e-5}
ZERO_ADAM_LR = 0.01
# The sharded and replicated loops take the same steps from gradients
# summed in different orders (the slots' slices in slot order; autograd's
# accumulation): float32 rounding, carried over the steps.
ZERO_LOOP_RTOL, ZERO_LOOP_ATOL_OF_MAX = 1e-4, 1e-5
ZERO_GRAD_RTOL, ZERO_GRAD_ATOL_OF_MAX = 1e-6, 1e-6  # against FederatedLogp, one evaluation
# parallel_axes: TP at config 7's rows pooled (32,768 x 512) on {"tp": 4}
# and {"shards": 2, "tp": 4}; EP at 65,536 observations, K = 16 on
# {"experts": 4}; Ulysses at (T, H, d) = (4,096, 8, 64) on {"seq": 4},
# causal and not, its float64 check on the CPU on one head per mode (a
# head's output and gradient depend on that head alone; all 8 in float64
# cost ~1 GiB and tens of seconds of CPU).
AXES_SLOTS = 4
AXES_EP = dict(n_obs=65_536, k=16, seed=23)
AXES_ULYSSES = (4096, 8, 64)
AXES_F64_HEADS = {False: 1, True: 6}  # causal -> the head checked in float64
AXES_TIMED_EVALS = 10
AXES_ATTENTION_ATOL = 1e-4  # float32 on the card against float64 (SEQ_ATTENTION_ATOL)
# multihost: two gloo ranks forked from the fork server, each driving 4
# slots of cuda:0, the flagship at 8 x 131,072 through the kernel; rank
# 1 is SIGKILLed in its work loop and rank 0 probes it.  A sweep of
# detect_dead_peers fails a dead port in 2 x retry_wait; the limit is two
# whole sweeps of live-peer timeouts.
MULTIHOST_RANKS, MULTIHOST_SLOTS = 2, 4
MULTIHOST_TIMED_EVALS = 5
MULTIHOST_PROBE = dict(timeout=0.5, retries=3, retry_wait=0.2)
MULTIHOST_DETECT_LIMIT_S = 2 * (3 * 0.5 + 2 * 0.2)
MULTIHOST_WAIT_S = 90.0  # any one message from a rank
# elastic: elastic_sample at the checkpoint phase's size with a failure
# after chunk 0: rebuilt over the same 4 slots (default remesh policy),
# and shrunk to 2 slots by an on_failure policy, resumed from a copy of
# the first run's checkpoint after chunk 0.
ELASTIC_SLOTS, ELASTIC_SHRUNK = 4, 2


def _kernel_flagship(card, n_obs):
    """The flagship's data tree in the kernel's per-shard form, on ``card``."""
    import pytensor_federated_torch as pft

    data, _ = pft.generate_node_data(8, n_obs=n_obs, seed=123, device=card)
    (x, y), mask = data.tree()
    return ((x, y), mask, torch.arange(8, device=card))


def _err_over_tol(got, want, rtol, atol_of_max):
    """The largest error of a tree of tensors against another (leaves
    by key), as a share of ``rtol |want| + atol_of_max max|want|`` of
    its leaf (<= 1 passes)."""
    worst = 0.0
    for k in want:
        g = torch.as_tensor(got[k]).detach().cpu().double()
        w = torch.as_tensor(want[k]).detach().cpu().double()
        tol = rtol * w.abs() + atol_of_max * float(w.abs().max())
        worst = max(worst, float(((g - w).abs() / tol.clamp_min(1e-30)).max()))
    return worst


def _replicated_loop(fed, params, lr, steps, adam):
    """SGD (``p + lr g``) or Adam (``scale_by_adam``, float32 moments, then
    ``p + lr u``) on the replicated gradient of ``fed.logp``: the loop the
    sharded one must match."""
    from pytensor_federated_torch.ppl.elbo import adam_updates
    from pytensor_federated_torch.samplers.util import ravel
    from pytensor_federated_torch.utils import value_and_grad

    vec, unravel = ravel(params)
    vec = vec.detach()
    lr = torch.tensor(lr, dtype=torch.float32, device=vec.device)
    mu = nu = torch.zeros(vec.shape, dtype=torch.float32, device=vec.device)
    for t in range(1, steps + 1):
        _, g = value_and_grad(fed.logp, unravel(vec))
        g = ravel(g)[0]
        if adam:
            (u,), (mu,), (nu,) = adam_updates([g.float()], [mu], [nu], t, -1.0,
                                              correction_dtype=vec.dtype)
            g = u
        vec = (vec + lr * g).to(vec.dtype)
    return unravel(vec)


def _zero_case(name, per_shard, tree, params, tree64, params64, card, lr, slots=ZERO_SLOTS,
               steps=ZERO_STEPS):
    """One ZeRO case: the scattered gradient against FederatedLogp(mesh=
    same) on the card and against float64 on the CPU; SGD and Adam loops
    against the replicated ones; kernel launches per step; ms per step."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
    from pytensor_federated_torch.utils import value_and_grad

    _sync(card)
    case_start = linreg_reductions.launches
    mesh = pft.make_mesh({"shards": slots}, devices=[card] * slots)
    z = pft.parallel.ZeroShardedLogpGrad(per_shard, tree, params, mesh=mesh)
    fed = pft.FederatedLogp(per_shard, tree, mesh=mesh)
    cpu4 = pft.make_mesh({"shards": slots}, devices=["cpu"] * slots)
    z64 = pft.parallel.ZeroShardedLogpGrad(per_shard, tree64, params64, mesh=cpu4)
    sg = z.logp_and_scattered_grad(params)
    g = z.gather_grad(sg)
    v_ref, g_ref = value_and_grad(fed.logp, params)
    sg64 = z64.logp_and_scattered_grad(params64)
    g64 = z64.gather_grad(sg64)
    value_bits_equal = torch.equal(sg.logp, v_ref)
    grad_over_tol = _err_over_tol(g, g_ref, ZERO_GRAD_RTOL, ZERO_GRAD_ATOL_OF_MAX)
    v64 = float(sg64.logp)
    rel64 = abs(float(sg.logp) - v64) / abs(v64)
    worst64 = _err_over_tol(g, g64, MODEL_GRAD_RTOL, MODEL_GRAD_ATOL_OF_MAX)
    slices_on_slots = [s.device for s in sg.grad_slices] == mesh.slot_devices("shards")
    loops, launches = {}, {}
    for kind, rate in (("sgd", lr), ("adam", ZERO_ADAM_LR)):
        run = z.adam_steps if kind == "adam" else z.sgd_steps
        _sync(card)
        loop_start = linreg_reductions.launches
        t0 = time.perf_counter()
        final, trace = run(params, learning_rate=rate, num_steps=steps)
        _sync(card)
        sharded_s = time.perf_counter() - t0
        launches[kind] = linreg_reductions.launches - loop_start
        t0 = time.perf_counter()
        want = _replicated_loop(fed, params, rate, steps, adam=kind == "adam")
        _sync(card)
        replicated_s = time.perf_counter() - t0
        loops[kind] = {
            "learning_rate": rate, "steps": steps, "err_over_tol": _err_over_tol(
                final, want, ZERO_LOOP_RTOL, ZERO_LOOP_ATOL_OF_MAX),
            "logp_first": float(trace[0]), "logp_last": float(trace[-1]),
            "finite": all(bool(torch.isfinite(v).all()) for v in final.values()),
            "ms_per_step": sharded_s * 1e3 / steps,
            "replicated_ms_per_step": replicated_s * 1e3 / steps,
        }
    _sync(card)
    # Every launch of the case: the gate evaluations, both sharded loops
    # and the replicated loops they are held against.
    case_launches = linreg_reductions.launches - case_start
    kernel = per_shard.__name__ == "linreg_shard_logp"
    gates = {
        "value_bits_equal_federated_logp": value_bits_equal,
        "grad_against_federated_logp": grad_over_tol <= 1.0,
        "against_f64": rel64 <= MODEL_VALUE_RTOL and worst64 <= 1.0,
        "slices_on_their_slots": slices_on_slots,
        "padding": z.padded_dim == -(-z.dim // slots) * slots,
        "loops_match_replicated": all(l["err_over_tol"] <= 1.0 and l["finite"]
                                      for l in loops.values()),
        "launches_per_step_equal_slots": (
            all(n == slots * steps for n in launches.values()) if kernel and card.type == "cuda"
            else True),
    }
    return all(gates.values()), {
        "case": name, "dim": z.dim, "padded_dim": z.padded_dim, "slice_len": z.slice_len,
        "logp": float(sg.logp), "grad_err_over_tol": grad_over_tol,
        "f64": {"value_rel_err": rel64, "grad_err_over_tol": worst64},
        "loops": loops, "kernel_launches": case_launches if kernel else 0,
        "launches": launches, "gates": gates,
    }


def phase_zero(dev="cuda", n_obs=LARGE_PATH[1], wide=WIDE, steps=ZERO_STEPS):
    """Slice 13, ZeRO: the scattered gradient and the sharded SGD / Adam
    loops on {"shards": 4} of the card, the flagship through the kernel
    and config 7's wide logistic on the plain per-shard path."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.ops.linreg_kernel import linreg_shard_logp
    from pytensor_federated_torch.utils import tree_map

    card = torch.device("cuda", 0) if torch.device(dev).type == "cuda" else torch.device("cpu")
    tree = _kernel_flagship(card, n_obs)
    tree64 = tree_map(lambda t: t.cpu().double() if t.is_floating_point() else t.cpu(), tree)
    z0 = lambda dt, d: torch.zeros((), dtype=dt, device=d)
    p = {"intercept": z0(torch.float32, card), "slope": z0(torch.float32, card),
         "log_sigma": z0(torch.float32, card),
         "offsets": torch.zeros(8, dtype=torch.float32, device=card)}
    p64 = tree_map(lambda t: t.cpu().double(), p)
    ok1, flagship = _zero_case("flagship", linreg_shard_logp, tree, p, tree64, p64, card,
                               ZERO_SGD_LR["flagship"], steps=steps)
    data, _ = pft.generate_logistic_data(**wide, device=card)
    model = pft.FederatedLogisticRegression(data)
    model64 = pft.FederatedLogisticRegression(_as_f64_cpu(data))
    wp = model.init_params()
    ok2, wide_case = _zero_case("wide_logistic", model.fed.per_shard_logp, model.fed.data, wp,
                                model64.fed.data, tree_map(lambda t: t.cpu().double(), wp), card,
                                ZERO_SGD_LR["wide"], steps=steps)
    out = {"phase": "zero", "mesh": {"shards": ZERO_SLOTS},
           "devices": [str(card)] * ZERO_SLOTS, "cases": [flagship, wide_case],
           "kernel_launches": flagship["kernel_launches"]}
    out["gates"] = {f"{c['case']}.{k}": v for c in out["cases"] for k, v in c["gates"].items()}
    return ok1 and ok2, out


def _attention_f64_head(q, k, v, head, causal):
    """One head's attention output and d sum(out^2)/dq in float64 on the CPU."""
    from pytensor_federated_torch.parallel.ulysses import _dense_heads_attention

    qs = [t[:, head:head + 1].detach().cpu().double() for t in (q, k, v)]
    qs[0].requires_grad_(True)
    out = _dense_heads_attention(*qs, causal=causal)
    (gq,) = torch.autograd.grad(torch.sum(out**2), qs[0])
    return out.detach(), gq


def phase_parallel_axes(dev="cuda", wide=WIDE, ep=AXES_EP, ulysses=AXES_ULYSSES,
                        reps=AXES_TIMED_EVALS):
    """Slice 13, the tensor, expert and Ulysses axes on meshes of the card:
    each against its unsharded form on the card and float64 on the CPU;
    ms per logp+grad (attention: per forward+backward) with and without
    the mesh."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.parallel.expert import generate_expert_mixture_data
    from pytensor_federated_torch.parallel.ulysses import _dense_heads_attention
    from pytensor_federated_torch.utils import tree_map

    cuda = torch.device(dev).type == "cuda"
    card = torch.device("cuda", 0) if cuda else torch.device("cpu")
    mesh = lambda shape: pft.make_mesh(shape, devices=[card] * math.prod(shape.values()))
    flat = lambda x: torch.cat([b.reshape(-1).to(card) for b in x]) if isinstance(
        x, tuple) else x
    out, gates = {"phase": "parallel_axes"}, {}

    def against(model, plain, model64, params, whole):
        """Value and gradient (blocks concatenated) on the mesh against
        the unsharded model on the card and float64 on the CPU."""
        v, g = model.logp_and_grad(params)
        g = {k: flat(t) for k, t in g.items()}
        res, ok = {}, True
        for name, ref, p in (("no_mesh", plain, whole),
                             ("f64", model64, tree_map(lambda t: t.cpu().double(), whole))):
            v_ref, g_ref = ref.logp_and_grad(p)
            rel = abs(float(v) - float(v_ref)) / abs(float(v_ref))
            worst = _err_over_tol(g, g_ref, MODEL_GRAD_RTOL, MODEL_GRAD_ATOL_OF_MAX)
            res[name] = {"value_rel_err": rel, "grad_err_over_tol": worst}
            ok &= rel <= MODEL_VALUE_RTOL and worst <= 1.0
        return ok, res

    # Tensor parallelism at config 7's rows pooled.
    data, _ = pft.generate_logistic_data(**wide, device="cpu")
    (X, y), _mask = data.tree()
    X = X.reshape(-1, X.shape[-1]).numpy()
    y = y.reshape(-1).numpy()
    plain = pft.parallel.TensorParallelLogistic(X, y, device=card)
    tp64 = pft.parallel.TensorParallelLogistic(X, y, device="cpu", dtype=torch.float64)
    whole = {"w": torch.full((X.shape[1],), 0.02, device=card),
             "b": torch.tensor(0.1, device=card)}
    tp_out = {"size": list(X.shape)}
    for name, shape, rows in (("tp4", {"tp": AXES_SLOTS}, None),
                              ("rows2_tp4", {"shards": 2, "tp": AXES_SLOTS}, "shards")):
        model = pft.parallel.TensorParallelLogistic(X, y, mesh=mesh(shape), rows_axis=rows)
        params = {"w": model._place({"w": whole["w"].chunk(AXES_SLOTS), "b": whole["b"]})["w"],
                  "b": whole["b"]}
        ok, res = against(model, plain, tp64, params, whole)
        tp_out[name] = {"mesh": shape, "tile_shape": list(model.tile_shape), **res,
                        "ms_per_logp_and_grad": _ms_per_eval(
                            lambda: model.logp_and_grad(params), dev, reps),
                        "cuda_launches_per_logp_and_grad": _launches(
                            lambda: model.logp_and_grad(params), dev, 3)}
        gates[f"tp.{name}"] = ok
    tp_out["no_mesh_ms_per_logp_and_grad"] = _ms_per_eval(lambda: plain.logp_and_grad(whole),
                                                          dev, reps)
    out["tp"] = tp_out

    # Expert parallelism.
    yy, _ = generate_expert_mixture_data(ep["n_obs"], seed=ep["seed"])
    model = pft.parallel.ExpertShardedMixture(yy, ep["k"], mesh=mesh({"experts": AXES_SLOTS}))
    plain = pft.parallel.ExpertShardedMixture(yy, ep["k"], device=card)
    ep64 = pft.parallel.ExpertShardedMixture(yy, ep["k"], device="cpu", dtype=torch.float64)
    whole = {k: v + 0.1 for k, v in plain.init_params().items()}
    params = model._place(whole)
    ok, res = against(model, plain, ep64, params, whole)
    out["ep"] = {"n_obs": ep["n_obs"], "k": ep["k"], "mesh": {"experts": AXES_SLOTS}, **res,
                 "ms_per_logp_and_grad": {
                     "mesh": _ms_per_eval(lambda: model.logp_and_grad(params), dev, reps),
                     "no_mesh": _ms_per_eval(lambda: plain.logp_and_grad(whole), dev, reps)},
                 "cuda_launches_per_logp_and_grad": {
                     "mesh": _launches(lambda: model.logp_and_grad(params), dev, 3),
                     "no_mesh": _launches(lambda: plain.logp_and_grad(whole), dev, 3)}}
    gates["ep"] = ok

    # Ulysses attention.
    T, H, d = ulysses
    gen = torch.Generator(device=card).manual_seed(17)
    q, k, v = (torch.randn((T, H, d), generator=gen, device=card) for _ in range(3))
    seq = mesh({"seq": AXES_SLOTS})
    u_out = {"shape": [T, H, d], "mesh": {"seq": AXES_SLOTS}, "atol": AXES_ATTENTION_ATOL}
    for causal in (False, True):
        qq = q.clone().requires_grad_(True)
        o = pft.parallel.ulysses_attention(qq, k, v, mesh=seq, causal=causal)
        (gq,) = torch.autograd.grad(torch.sum(o**2), qq)
        qd = q.clone().requires_grad_(True)
        od = _dense_heads_attention(qd, k, v, causal=causal)
        (gd,) = torch.autograd.grad(torch.sum(od**2), qd)
        head = AXES_F64_HEADS[causal]
        o64, g64 = _attention_f64_head(q, k, v, head, causal)
        o, od = o.detach(), od.detach()
        errs = {
            "out_vs_no_mesh": float((o - od).abs().max()),
            "grad_vs_no_mesh_of_max": float((gq - gd).abs().max() / gd.abs().max()),
            f"out_vs_f64_head{head}": float((o[:, head:head + 1].cpu().double() - o64).abs().max()),
            f"grad_vs_f64_head{head}_of_max": float(
                (gq[:, head:head + 1].cpu().double() - g64).abs().max() / g64.abs().max()),
        }

        def step(fn, causal=causal):
            x = q.clone().requires_grad_(True)
            torch.autograd.grad(torch.sum(fn(x) ** 2), x)

        mode = "causal" if causal else "full"
        u_out[mode] = {**errs, "ms_per_forward_backward": {
            "mesh": _ms_per_eval(lambda: step(lambda x: pft.parallel.ulysses_attention(
                x, k, v, mesh=seq, causal=causal)), dev, reps),
            "no_mesh": _ms_per_eval(lambda: step(lambda x: _dense_heads_attention(
                x, k, v, causal=causal)), dev, reps)}}
        gates[f"ulysses.{mode}"] = all(e <= AXES_ATTENTION_ATOL for e in errs.values())
    out["ulysses"] = u_out
    out["gates"] = gates
    return all(gates.values()), out


def _multihost_rank(rank, coord_port, hb_base, n_obs, dev, conn):
    """One gloo rank of the multihost phase, in a process of its own
    forked from the fork server (no CUDA there; this process initialises
    its own).  Sends ("a", ...) after the cross-process evaluations; rank
    1 then loops on local evaluations until it is killed; rank 0 probes
    it, sends ("alive", ...) and, after the death, ("b", ...)."""
    # The ranks meet on this host's loopback.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        import pytensor_federated_torch as pft
        from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions, linreg_shard_logp
        from pytensor_federated_torch.parallel import (
            HeartbeatServer,
            detect_dead_peers,
            initialize_multihost,
            make_multihost_mesh,
            probe_peer,
            remesh_after_failure,
        )
        from pytensor_federated_torch.utils import value_and_grad

        card = torch.device("cuda", 0) if dev == "cuda" else torch.device("cpu")
        world = initialize_multihost(f"127.0.0.1:{coord_port}", num_processes=MULTIHOST_RANKS,
                                     process_id=rank, backend="gloo", timeout_s=60.0)
        hb = HeartbeatServer(port=hb_base + rank, process_index=rank)
        tree = _kernel_flagship(card, n_obs)
        mesh = make_multihost_mesh(devices=[card] * MULTIHOST_SLOTS)
        fed = pft.FederatedLogp(linreg_shard_logp, tree, mesh=mesh)
        post = lambda p: pft.linreg_prior_logp(p) + fed.logp(p)
        points = _multihost_points(card)
        _sync(card)
        linreg_reductions.launches = 0
        evals = [value_and_grad(post, p) for p in points]
        _sync(card)
        launches = linreg_reductions.launches
        ms = _ms_per_eval(lambda: value_and_grad(post, points[0]), dev, MULTIHOST_TIMED_EVALS)
        _sync(card)
        conn.send(("a", {
            "rank": rank, "world": world, "mesh": dict(mesh.shape),
            "processes": mesh.processes.reshape(-1).tolist(),
            "process_index": pft.get_load([card])[0].process_index,
            "logp": [float(v).hex() for v, _ in evals],
            "grads": [{k: g[k].detach().cpu().reshape(-1).tolist() for k in sorted(g)}
                      for _, g in evals],
            "kernel_launches": launches, "evaluations": len(points),
            "launches_through_timing": linreg_reductions.launches,
            "ms_per_logp_and_grad": ms}))
        if rank != 0:
            local = pft.FederatedLogp(linreg_shard_logp, tree,
                                      mesh=pft.make_mesh({"shards": 4}, devices=[card] * 4))
            conn.send(("serving", {}))
            while True:  # the work loop: only the SIGKILL ends it
                local.logp(points[0])
                _sync(card)
                time.sleep(0.01)
        peer = {1: ("127.0.0.1", hb_base + 1)}
        end = time.monotonic() + MULTIHOST_WAIT_S
        while not probe_peer(peer[1], timeout=0.5, expect_process_index=1):
            if time.monotonic() > end:
                raise TimeoutError("rank 1's heartbeat never answered")
            time.sleep(0.05)
        conn.send(("alive", {}))
        sweeps, end = 0, time.monotonic() + MULTIHOST_WAIT_S
        while detect_dead_peers(peer, **MULTIHOST_PROBE) != [1]:
            sweeps += 1
            if time.monotonic() > end:
                raise TimeoutError("rank 1's death was never detected")
            time.sleep(0.05)
        detected_at = time.time()
        survivors = remesh_after_failure(mesh, axis="shards", dead_process_ids=[1])
        fed2 = pft.FederatedLogp(linreg_shard_logp, tree, mesh=survivors)
        v2 = pft.linreg_prior_logp(points[0]) + fed2.logp(points[0])
        _sync(card)
        hb.stop()
        conn.send(("b", {"detected_at": detected_at, "live_sweeps": sweeps,
                         "launches_at_end": linreg_reductions.launches,
                         "mesh": dict(survivors.shape), "multiprocess": survivors.is_multiprocess,
                         "logp": float(v2)}))
    except Exception:  # noqa: BLE001 — reported to the phase, which fails
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()
        os._exit(0)  # no process-group teardown with a dead peer


def _multihost_points(card):
    """The origin and two points off it: the phase's evaluation points."""
    base = {"intercept": 0.0, "slope": 0.0, "log_sigma": 0.0}
    pts = []
    for shift in (0.0, 0.3, -0.2):
        p = {k: torch.tensor(v + shift, device=card) for k, v in base.items()}
        p["offsets"] = shift * torch.linspace(-1.0, 1.0, 8, device=card)
        pts.append(p)
    return pts


def phase_multihost(dev="cuda", n_obs=LARGE_PATH[1]):
    """Slice 13, the multi-process mesh: two gloo ranks, each driving 4
    slots of the card, evaluate the flagship's posterior over one
    {"shards": 8} mesh; rank 1 is killed and rank 0 detects it, remeshes
    and reproduces the value.  One card shows the partition and the
    cross-process sum, not NCCL or concurrency across cards."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.ops.linreg_kernel import linreg_shard_logp
    from pytensor_federated_torch.utils import value_and_grad

    card = torch.device("cuda", 0) if dev == "cuda" else torch.device("cpu")
    ctx = _node_context()
    coord, hb_base = _free_ports(1)[0], _free_hb_base()
    conns, procs = [], []
    for rank in range(MULTIHOST_RANKS):
        parent, child = ctx.Pipe()
        procs.append(ctx.Process(target=_multihost_rank, args=(rank, coord, hb_base, n_obs, dev, child),
                                 name=f"multihost-rank{rank}"))
        conns.append(parent)
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    msgs = {}

    def recv(rank, want):
        if not conns[rank].poll(MULTIHOST_WAIT_S):
            raise TimeoutError(f"rank {rank} sent no {want!r} within {MULTIHOST_WAIT_S} s")
        tag, body = conns[rank].recv()
        if tag == "error":
            raise RuntimeError(f"rank {rank} failed:\n{body}")
        if tag != want:
            raise RuntimeError(f"rank {rank} sent {tag!r}, expected {want!r}")
        msgs[(rank, tag)] = body
        return body

    try:
        a = [recv(r, "a") for r in range(MULTIHOST_RANKS)]
        recv(1, "serving")
        recv(0, "alive")
        killed_at = time.time()
        os.kill(procs[1].pid, signal.SIGKILL)
        procs[1].join(timeout=10)
        b = recv(0, "b")
        procs[0].join(timeout=10)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    wall = time.perf_counter() - t0

    # The single-process 8-slot mesh and no mesh, on the card, here.
    tree = _kernel_flagship(card, n_obs)
    one = pft.FederatedLogp(linreg_shard_logp, tree,
                            mesh=pft.make_mesh({"shards": 8}, devices=[card] * 8))
    none = pft.FederatedLogp(linreg_shard_logp, tree)
    points = _multihost_points(card)
    single, unsharded = [], []
    for fed, sink in ((one, single), (none, unsharded)):
        for p in points:
            v, g = value_and_grad(lambda q: pft.linreg_prior_logp(q) + fed.logp(q), p)
            sink.append((float(v), {k: g[k].detach().cpu().double().reshape(-1) for k in g}))
    worst = {"single_process": 0.0, "no_mesh": 0.0}
    value_rel = {"single_process": 0.0, "no_mesh": 0.0}
    for i, grads in enumerate(a[0]["grads"]):
        v = float.fromhex(a[0]["logp"][i])
        for name, ref in (("single_process", single), ("no_mesh", unsharded)):
            v_ref, g_ref = ref[i]
            value_rel[name] = max(value_rel[name], abs(v - v_ref) / abs(v_ref))
            worst[name] = max(worst[name], _err_over_tol(grads, g_ref, ZERO_GRAD_RTOL,
                                                         ZERO_GRAD_ATOL_OF_MAX))
    detect_s = b["detected_at"] - killed_at
    remesh_rel = abs(b["logp"] - float.fromhex(a[0]["logp"][0])) / abs(float.fromhex(
        a[0]["logp"][0]))
    gates = {
        "world": [x["world"] for x in a] == [2, 2]
        and [x["process_index"] for x in a] == [0, 1]
        and a[0]["processes"] == [0] * 4 + [1] * 4,
        "ranks_logp_bits_equal": a[0]["logp"] == a[1]["logp"],
        "ranks_grads_equal": a[0]["grads"] == a[1]["grads"],
        "value_bits_equal_single_process": a[0]["logp"] == [v.hex() for v, _ in single],
        "grads_match_single_process": worst["single_process"] <= 1.0,
        "matches_no_mesh": value_rel["no_mesh"] <= ZERO_GRAD_RTOL and worst["no_mesh"] <= 1.0,
        "one_launch_per_slot_per_evaluation": all(
            x["kernel_launches"] == MULTIHOST_SLOTS * x["evaluations"] for x in a)
        if card.type == "cuda" else True,
        "death_detected_within_limit": 0.0 <= detect_s <= MULTIHOST_DETECT_LIMIT_S,
        "remeshed_to_own_slots": b["mesh"] == {"shards": 4} and not b["multiprocess"],
        "value_reproduced": remesh_rel <= ZERO_GRAD_RTOL,
    }
    return all(gates.values()), {
        "phase": "multihost", "backend": "gloo", "ranks": MULTIHOST_RANKS,
        "slots_per_rank": MULTIHOST_SLOTS, "size": [8, n_obs],
        "note": "two ranks on one card: the partition and the cross-process sum, "
                "not NCCL or concurrency across cards",
        "wall_s": wall, "ms_per_logp_and_grad": [x["ms_per_logp_and_grad"] for x in a],
        "value_rel_err": value_rel, "grad_err_over_tol": worst,
        "detect_s": detect_s, "detect_limit_s": MULTIHOST_DETECT_LIMIT_S,
        "live_sweeps_before_death": b["live_sweeps"], "remesh_value_rel_err": remesh_rel,
        "gated_kernel_launches": sum(x["kernel_launches"] for x in a),
        # Rank 0's launches to the end of its work, rank 1's through its
        # timed evaluations: its work loop until the SIGKILL is not read.
        "kernel_launches": b["launches_at_end"] + a[1]["launches_through_timing"],
        "gates": gates,
    }


def _free_hb_base():
    """A port with the next one free too: rank r's heartbeat on base + r."""
    import socket

    for _ in range(50):
        base = _free_ports(1)[0]
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", base + 1))
                return base
            except OSError:
                continue
    raise RuntimeError("no two consecutive free ports")


def phase_elastic(dev="cuda", n_obs=FLAGSHIP[1], ck=CHECKPOINT):
    """Slice 13, elastic sampling: ``elastic_sample`` over the flagship
    through the kernel on {"shards": 4} of the card, a failure injected
    once chunk 0 is saved.  Rebuilt over the same slots, the draws equal
    an uninterrupted run's bit for bit; shrunk to 2 slots (resumed from
    the first run's checkpoint after chunk 0), the draws before the
    failure are unchanged and the rest finite; the flight events are
    recorded."""
    import shutil
    import tempfile

    import pytensor_federated_torch as pft
    from pytensor_federated_torch.checkpoint import sample_checkpointed
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions, linreg_shard_logp
    from pytensor_federated_torch.telemetry import flightrec, spans

    card = torch.device("cuda", 0) if torch.device(dev).type == "cuda" else torch.device("cpu")
    tree = _kernel_flagship(card, n_obs)
    mesh4 = pft.make_mesh({"shards": ELASTIC_SLOTS}, devices=[card] * ELASTIC_SLOTS)
    mesh2 = pft.make_mesh({"shards": ELASTIC_SHRUNK}, devices=[card] * ELASTIC_SHRUNK)
    init = {"intercept": torch.tensor(0.0, device=card), "slope": torch.tensor(0.0, device=card),
            "log_sigma": torch.tensor(0.0, device=card), "offsets": torch.zeros(8, device=card)}
    gen = lambda: torch.Generator(device=card).manual_seed(9)
    built, evals = [], {}  # evaluations per slot count

    def build(fail, chunk0=None):
        def build_logp(mesh):
            built.append(dict(mesh.shape))
            slots = mesh.shape["shards"]
            fed = pft.FederatedLogp(linreg_shard_logp, tree, mesh=mesh)

            def logp(p):
                if fail["armed"] and os.path.exists(chunk0):
                    fail["armed"], fail["fired"] = False, True
                    raise RuntimeError("injected slot failure")
                evals[slots] = evals.get(slots, 0) + 1
                return pft.linreg_prior_logp(p) + fed.logp(p)

            return logp

        return build_logp

    prev = spans.set_enabled(True), flightrec.set_enabled(True)
    flightrec.clear()
    _sync(card)
    linreg_reductions.launches = 0
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-elastic-") as d:
            clean = sample_checkpointed(build({"armed": False})(mesh4), init, generator=gen(),
                                        checkpoint_path=os.path.join(d, "clean.npz"), **ck)
            path = os.path.join(d, "same.npz")
            snap = os.path.join(d, "snapshot")
            fail = {"armed": True, "fired": False}

            def snapshot(i):
                # The first run's checkpoint after chunk 0, the shrink run's start.
                if i == 0:
                    os.makedirs(snap)
                    for f in (path, path + ".chunk0000.npz"):
                        shutil.copy(f, snap)

            same = pft.samplers.elastic_sample(
                build(fail, path + ".chunk0000.npz"), init, generator=gen(),
                checkpoint_path=path, mesh=mesh4, **ck, on_chunk=snapshot)
            same_events = [e["kind"] for e in flightrec.events()]
            shrunk_path = os.path.join(d, "shrunk.npz")
            for f in os.listdir(snap):
                shutil.copy(os.path.join(snap, f), os.path.join(d, f.replace("same", "shrunk")))
            fail2 = {"armed": True, "fired": False}
            policy = []
            shrunk = pft.samplers.elastic_sample(
                build(fail2, shrunk_path + ".chunk0000.npz"), init, generator=gen(),
                checkpoint_path=shrunk_path, mesh=mesh4,
                on_failure=lambda m, dead: policy.append(dict(m.shape)) or mesh2, **ck)
    finally:
        spans.set_enabled(prev[0])
        flightrec.set_enabled(prev[1])
    _sync(card)
    wall = time.perf_counter() - t0
    launches = linreg_reductions.launches
    events = [e["kind"] for e in flightrec.events()]
    flightrec.clear()
    first = ck["checkpoint_every"]
    gates = {
        "failure_fired": fail["fired"] and fail2["fired"],
        "same_layout_bits_equal_uninterrupted": all(
            torch.equal(same.samples[k], clean.samples[k]) for k in clean.samples),
        "same_layout_rebuilt_over_4_slots": built[1:3] == [{"shards": 4}] * 2,
        "shrunk_to_2_slots": policy == [{"shards": 4}] and built[-1] == {"shards": 2},
        "shrunk_chunk0_unchanged": all(
            torch.equal(shrunk.samples[k][:, :first], clean.samples[k][:, :first])
            for k in clean.samples),
        "shrunk_rest_finite": all(bool(torch.isfinite(v).all()) for v in shrunk.samples.values()),
        "flight_events": (["sampler.segment_failed", "mesh.remesh", "sampler.recovered"]
                          == [k for k in same_events if k.startswith(("sampler.", "mesh."))]
                          and events.count("sampler.segment_failed") == 2
                          and events.count("sampler.recovered") == 2),
        # One launch per slot and evaluation, the clean run's included.
        "launches_equal_slots_per_eval": (launches == sum(n * c for n, c in evals.items())
                                          if card.type == "cuda" else True),
    }
    return all(gates.values()), {
        "phase": "elastic", **ck, "size": [8, n_obs], "mesh": {"shards": ELASTIC_SLOTS},
        "shrunk_mesh": {"shards": ELASTIC_SHRUNK}, "builds": built, "wall_s": wall,
        "evaluations_by_slots": evals, "kernel_launches": launches,
        "ms_per_eval": wall * 1e3 / max(sum(evals.values()), 1), "flight_events": events,
        "draws_sha256": _draws_sha256(same.samples), "gates": gates,
    }


# fed (slice 14): one federated model over a mesh, a node pool and both.
# The mesh lane: the flagship's data term at 8 x 131,072 through the
# kernel as FederatedLogpGrad over {"shards": 4} of the card, against
# FederatedLogp(linreg_shard_logp, mesh=same) at FED_POINTS seeded
# points and against float64 on the CPU.  The gradients take the same
# per-slot maps and cotangents in both, so their bits must agree; the
# values add the shards in different orders (fed_sum adds the eight
# per-shard values, FederatedLogp each slot's two first), so each must
# lie within float32 rounding of the float64 value (MODEL_VALUE_RTOL).
# The pool lane: bench_suite.py's config 14 (64 shards x 16, window 32,
# 1751-1870) over two TCP nodes on the card; its equality gate (1e-4
# relative against the direct evaluate_many fan-out) and its rates,
# interleaved best of FED_RATE_PASSES passes of FED_RATE_BUDGET_S each
# (recorded, not gated; the JAX package accepted >= 0.9x).  The mixed
# lane at the pool lane's shapes, FED_POOL_SHARDS of them on the pool,
# against the all-mesh program; fedavg over 4 slots against mesh=None,
# bit for bit (the same sums in the same order).
SLICE14 = ("fed",)
FED_SLOTS = 4
FED_POINTS = 8
FED_TIMED_EVALS = 50
FED_C14 = dict(n_shards=64, dim=16, window=32, seed=14)
FED_POOL_SHARDS = 16
FED_RATE_BUDGET_S, FED_RATE_PASSES = 1.0, 3
FED_C14_RTOL = 1e-4  # config 14's equality gate
FED_F32_RTOL, FED_F32_GTOL = 1e-5, 1e-4  # the JAX fed tests' float32 tolerances
FEDAVG = dict(rounds=50, local_steps=5, learning_rate=0.1)


def _c14_shard_logp(p, xs, ys):
    """bench_suite config 14's per-shard logp."""
    return -torch.sum((ys - p[0] - p[1] * xs) ** 2)


def _fed_c14_node(dev, conn):
    """One config-14 node: the port's ``fed.make_node_compute`` of the
    per-shard logp on ``dev``, served with ``serve_tcp_once``.  Answers
    the driver's commands on ``conn`` with its requests since the last
    ``reset``."""
    sys.path.insert(0, str(ROOT))
    try:
        from pytensor_federated_torch import fed
        from pytensor_federated_torch.service import serve_tcp_once

        if dev == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("fed node found no GPU")
        base = fed.make_node_compute(_c14_shard_logp, device=dev)
        lock, count, bound, ports = threading.Lock(), [0], threading.Event(), []

        def compute(*arrays):
            with lock:
                count[0] += 1
            return base(*arrays)

        threading.Thread(target=serve_tcp_once, args=(compute,), daemon=True,
                         kwargs={"port": 0, "concurrent": True,
                                 "ready_callback": lambda p: (ports.append(p), bound.set())}
                         ).start()
        if not bound.wait(60):
            raise RuntimeError("fed node did not bind a port")
        conn.send({"port": ports[0], "pid": os.getpid(),
                   "device": torch.cuda.get_device_name() if dev == "cuda" else "cpu"})
        base_count = 0
        while True:
            cmd = conn.recv()
            with lock:
                cur = count[0]
            if cmd == "reset":
                base_count = cur
            conn.send({"requests": cur - base_count})
            if cmd == "stop":
                return
    except Exception:
        conn.send({"error": traceback.format_exc()})


def _fed_mesh_lane(card, n_obs, slots, points, timed):
    """The mesh lane through the kernel: FederatedLogpGrad against
    FederatedLogp on the same mesh and against float64 on the CPU;
    launches per evaluation; ms per logp+grad of both."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch import fed
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions, linreg_shard_logp
    from pytensor_federated_torch.utils import tree_map, value_and_grad

    tree = _kernel_flagship(card, n_obs)
    tree64 = tree_map(lambda t: t.cpu().double() if t.is_floating_point() else t.cpu(), tree)
    mesh = pft.make_mesh({"shards": slots}, devices=[card] * slots)
    ev = fed.FederatedLogpGrad(linreg_shard_logp, tree, placement=fed.MeshPlacement(mesh),
                               device=card)
    fl = pft.FederatedLogp(linreg_shard_logp, tree, mesh=mesh)
    fl64 = pft.FederatedLogp(linreg_shard_logp, tree64)
    g = torch.Generator(device="cpu").manual_seed(14)
    base = {"intercept": 1.5, "slope": 2.0, "log_sigma": math.log(0.5)}
    pts = []
    for _ in range(points):
        p = {k: torch.tensor(v + 0.05 * float(torch.randn((), generator=g))) for k, v in base.items()}
        p["offsets"] = 0.3 * torch.randn(8, generator=g)
        pts.append(p)
    ev.logp_and_grad(tree_map(lambda t: t.to(card), pts[0]))  # records the program
    _sync(card)
    linreg_reductions.launches = 0
    rows = []
    for p in pts:
        pc = tree_map(lambda t: t.to(card), p)
        before = linreg_reductions.launches
        v, (gr,) = ev.logp_and_grad(pc)
        _sync(card)
        launches = linreg_reductions.launches - before
        v_fl, g_fl = value_and_grad(fl.logp, pc)
        v64, g64 = value_and_grad(fl64.logp, tree_map(lambda t: t.double(), p))
        rows.append({
            "launches": launches, "value_bits_equal": torch.equal(v, v_fl),
            "grad_bits_equal": all(torch.equal(gr[k], g_fl[k]) for k in gr),
            "value_rel_err_f64": abs(float(v) - float(v64)) / abs(float(v64)),
            "federated_logp_value_rel_err_f64": abs(float(v_fl) - float(v64)) / abs(float(v64)),
            "grad_err_over_tol_f64": _err_over_tol(gr, g64, MODEL_GRAD_RTOL,
                                                   MODEL_GRAD_ATOL_OF_MAX),
        })
    p0 = tree_map(lambda t: t.to(card), pts[0])
    ms = {"fed": _ms_per_eval(lambda: ev.logp_and_grad(p0), card, timed),
          "federated_logp": _ms_per_eval(lambda: value_and_grad(fl.logp, p0), card, timed)}
    _sync(card)
    launches = linreg_reductions.launches
    on_card = card.type == "cuda"
    gates = {
        "grad_bits_equal_federated_logp": all(r["grad_bits_equal"] for r in rows),
        "values_within_f32_of_f64": all(
            r["value_rel_err_f64"] <= MODEL_VALUE_RTOL
            and r["federated_logp_value_rel_err_f64"] <= MODEL_VALUE_RTOL for r in rows),
        "grads_against_f64": all(r["grad_err_over_tol_f64"] <= 1.0 for r in rows),
        "one_launch_per_slot": all(r["launches"] == slots for r in rows) if on_card else True,
    }
    return gates, {
        "size": [8, n_obs], "slots": slots, "points": rows,
        "value_bits_equal_points": sum(r["value_bits_equal"] for r in rows),
        "ms_per_logp_and_grad": ms, "timed_evals": timed, "kernel_launches": launches,
    }


def _fed_pool_lanes(card, client, mesh, c14):
    """Config 14 through fed.program(PoolPlacement) against the direct
    evaluate_many fan-out; one window per evaluation; two maps in one
    window; reduce=True; the mixed lane; the rates."""
    import numpy as np

    from pytensor_federated_torch import fed
    from pytensor_federated_torch.telemetry import flightrec, spans

    n, window = c14["n_shards"], c14["window"]
    rng = np.random.default_rng(c14["seed"])
    x_np = rng.normal(size=(n, c14["dim"])).astype(np.float32)
    y_np = rng.normal(size=(n, c14["dim"])).astype(np.float32)
    p_np = np.float32([0.3, -0.8])
    x, y, p = (torch.as_tensor(a, device=card) for a in (x_np, y_np, p_np))

    def model(q):
        pb = fed.fed_broadcast(q, n)
        return fed.fed_sum(fed.fed_map(lambda s: _c14_shard_logp(s[0], s[1], s[2]), (pb, x, y)))

    def two_maps(q):
        pb = fed.fed_broadcast(q, n)
        a = fed.fed_sum(fed.fed_map(lambda s: _c14_shard_logp(*s), (pb, x, y)))
        return a + fed.fed_sum(fed.fed_map(lambda s: _c14_shard_logp(*s), (pb, x + 0.5, y)))

    requests = [(p_np, x_np[i], y_np[i]) for i in range(n)]

    def direct_eval():
        replies = client.evaluate_many(requests, window=window)
        return float(np.sum([r[0] for r in replies]))

    def value_and_grad(run):
        q = p.clone().requires_grad_(True)
        v = run(q)
        (gq,) = torch.autograd.grad(v, q)
        return float(v), gq.cpu().numpy()

    run = fed.program(model, fed.PoolPlacement(client, window=window))
    v_prog, v_direct = float(run(p)), direct_eval()  # warms both lanes and records
    prev = spans.set_enabled(True), flightrec.set_enabled(True)
    try:
        flightrec.clear()
        evals = 5
        for _ in range(evals):
            value_and_grad(run)
        windows = [e for e in flightrec.events() if e["kind"] == "fed.fused_window"]
        flightrec.clear()
        v_two = float(fed.program(two_maps, fed.PoolPlacement(client, window=window))(p))
        two = [e for e in flightrec.events() if e["kind"] == "fed.fused_window"]
        vg = value_and_grad(run)
        flightrec.clear()
        vg_reduced = value_and_grad(fed.program(
            model, fed.PoolPlacement(client, window=window, reduce=True)))
        reduced = sorted({e["kind"] for e in flightrec.events() if e["kind"].startswith("fed.")})
    finally:
        spans.set_enabled(prev[0])
        flightrec.set_enabled(prev[1])
    vg_mixed = value_and_grad(fed.program(model, fed.MixedPlacement(
        fed.MeshPlacement(mesh), fed.PoolPlacement(client, window=window),
        pool_shards=FED_POOL_SHARDS)))
    vg_mesh = value_and_grad(fed.program(model, fed.MeshPlacement(mesh)))
    v_two_direct = direct_eval() + float(np.sum([r[0] for r in client.evaluate_many(
        [(p_np, x_np[i] + np.float32(0.5), y_np[i]) for i in range(n)], window=window)]))

    def rate_once(fn):
        t0, k = time.perf_counter(), 0
        while time.perf_counter() - t0 < FED_RATE_BUDGET_S:
            fn()
            k += n
        return k / (time.perf_counter() - t0)

    rates_direct, rates_prog = [], []
    for _ in range(FED_RATE_PASSES):
        rates_direct.append(rate_once(direct_eval))
        rates_prog.append(rate_once(lambda: run(p)))

    def close(a, b):
        return (abs(a[0] - b[0]) <= FED_F32_RTOL * abs(b[0])
                and bool(np.all(np.abs(a[1] - b[1]) <= FED_F32_GTOL * np.abs(b[1]))))

    gates = {
        "program_equals_direct": abs(v_prog - v_direct) <= FED_C14_RTOL * max(1.0, abs(v_direct)),
        "one_window_per_evaluation": len(windows) == evals and all(
            w["calls"] == 1 and w["requests"] == n for w in windows),
        "two_maps_one_window": len(two) == 1 and two[0]["calls"] == 2
        and two[0]["requests"] == 2 * n,
        "two_maps_equal_direct": abs(v_two - v_two_direct) <= FED_C14_RTOL * abs(v_two_direct),
        "reduce_one_reduced_window": reduced == ["fed.reduce_window"],
        "reduce_within_f32": close(vg_reduced, vg),
        "mixed_within_f32_of_mesh": close(vg_mixed, vg_mesh),
    }
    rate_prog, rate_direct = max(rates_prog), max(rates_direct)
    return gates, {
        "config": {**c14, "source": "bench_suite.py:1751-1870 (config 14)"},
        "value": {"program": v_prog, "direct": v_direct, "two_maps": v_two,
                  "two_maps_direct": v_two_direct},
        "windows_per_evaluation": len(windows) / evals,
        "reduce": {"value": vg_reduced[0], "per_shard_value": vg[0],
                   "grad": vg_reduced[1].tolist(), "per_shard_grad": vg[1].tolist()},
        "mixed": {"pool_shards": FED_POOL_SHARDS, "value": vg_mixed[0], "mesh_value": vg_mesh[0],
                  "grad": vg_mixed[1].tolist(), "mesh_grad": vg_mesh[1].tolist()},
        "shard_evals_per_s": {"program": rate_prog, "direct": rate_direct,
                              "ratio": rate_prog / rate_direct,
                              "jax_package_acceptance_ratio": 0.9,
                              "passes": {"program": rates_prog, "direct": rates_direct}},
    }


def _fedavg_case(card, mesh):
    """fedavg over the slots of ``mesh`` against mesh=None: the JAX
    package's test model (tests/test_federated_primitives.py).  The
    slots' local steps and the weighted mean add in the same order as
    without a mesh, so the final parameters and the loss history must
    agree bit for bit (within float32 rounding is recorded too)."""
    import numpy as np

    from pytensor_federated_torch.parallel import fedavg

    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    y = (1.0 + 2.0 * x + 0.2 * rng.normal(size=(8, 64))).astype(np.float32)
    data = tuple(torch.as_tensor(a, device=card) for a in (x, y))

    def mse(params, shard):
        return torch.mean((shard[1] - (params["a"] + params["b"] * shard[0])) ** 2)

    init = {"a": torch.zeros((), device=card), "b": torch.zeros((), device=card)}
    runs = {}
    for name, m in (("no_mesh", None), ("mesh", mesh)):
        t0 = time.perf_counter()
        final, history = fedavg(mse, data, init, mesh=m, **FEDAVG)
        _sync(card)
        runs[name] = (final, history, time.perf_counter() - t0)
    (fm, hm, sm), (fo, ho, so) = runs["mesh"], runs["no_mesh"]
    bits = all(torch.equal(fm[k], fo[k]) for k in fm) and torch.equal(hm, ho)
    within = (all(abs(float(fm[k]) - float(fo[k])) <= FED_F32_RTOL * abs(float(fo[k])) for k in fm)
              and bool(torch.all((hm - ho).abs() <= FED_F32_RTOL * ho.abs())))
    b_ols, a_ols = np.polyfit(x.ravel(), y.ravel(), 1)
    return {"bits_equal_no_mesh": bits}, {
        **FEDAVG, "slots": mesh.shape["shards"], "bits_equal_no_mesh": bits,
        "within_f32_of_no_mesh": within,
        "final": {k: float(v) for k, v in fm.items()}, "pooled_ols": {"a": a_ols, "b": b_ols},
        "loss_first_last": [float(hm[0]), float(hm[-1])], "wall_s": {"mesh": sm, "no_mesh": so},
    }


def phase_fed(dev="cuda", n_obs=LARGE_PATH[1], slots=FED_SLOTS, points=FED_POINTS,
              timed=FED_TIMED_EVALS, c14=FED_C14):
    """Slice 14, the fed layer: FederatedLogpGrad over a 4-slot mesh of
    the card through the kernel, config 14 over a pool of two TCP nodes
    on the card, the mixed placement and fedavg."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.routing import NodePool, PooledArraysClient

    card = torch.device("cuda", 0) if torch.device(dev).type == "cuda" else torch.device("cpu")
    ctx = _node_context()
    procs, conns, out = [], [], {"phase": "fed"}
    pool = client = None
    try:
        t0 = time.perf_counter()
        for _ in range(2):  # the nodes start while the mesh lane runs
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_fed_c14_node, args=(card.type, child), daemon=True)
            proc.start()
            procs.append(proc)
            conns.append(parent)
        t_mesh = time.perf_counter()
        mesh_gates, out["mesh"] = _fed_mesh_lane(card, n_obs, slots, points, timed)
        out["mesh"]["wall_s"] = time.perf_counter() - t_mesh
        nodes = _fed_ask(conns, None, timeout=300.0)
        out["spawn_s"] = time.perf_counter() - t0
        out["nodes"] = [n["device"] for n in nodes]
        pool = NodePool([("127.0.0.1", n["port"]) for n in nodes], transport="tcp")
        client = PooledArraysClient(pool)
        mesh = pft.make_mesh({"shards": slots}, devices=[card] * slots)
        t_pool = time.perf_counter()
        _fed_ask(conns, "reset")
        pool_gates, out["pool"] = _fed_pool_lanes(card, client, mesh, c14)
        out["pool"]["node_requests"] = [r["requests"] for r in _fed_ask(conns, "counts")]
        out["pool"]["wall_s"] = time.perf_counter() - t_pool
        t_avg = time.perf_counter()
        avg_gates, out["fedavg"] = _fedavg_case(card, mesh)
        out["fedavg"]["phase_wall_s"] = time.perf_counter() - t_avg
        _fed_ask(conns, "stop")
    finally:
        if client is not None:
            client.close()
            pool.close()
        _join_nodes(procs)
    out["kernel_launches"] = out["mesh"]["kernel_launches"]
    out["gates"] = {**{f"mesh.{k}": v for k, v in mesh_gates.items()},
                    **{f"pool.{k}": v for k, v in pool_gates.items()},
                    "fedavg.bits_equal_no_mesh": avg_gates["bits_equal_no_mesh"]}
    return all(out["gates"].values()), out


SLICE15 = ("ppl", "ppl_zero")
PPL_RADON = dict(n_counties=16, seed=12)  # config 20's data (= RADON)
PPL_MESH_SLOTS = 4
# chains, warmup, draws (config 20: 2 x (300 + 300)); at 2 x (100 + 100)
# the split R-hat read 1.127 on the card, above the gate's 1.1.
PPL_NUTS = (2, 150, 150)
PPL_PT = (100, 100)  # warmup, draws of pt_sample over 4 temperatures (config 20: 150 + 150)
PPL_PT_TEMPS = 4
PPL_SVI = dict(num_steps=1000, n_mc=8, learning_rate=2e-2)  # config 20's batch SVI
PPL_SVI_RMSE = 0.35  # config 20's gate on the global posterior means against NUTS
PPL_GLOBALS = ("mu_alpha", "beta", "log_sigma", "log_sigma_alpha")
PPL_STREAM = dict(warm=4, batches=30, batch=8, n_mc=2, learning_rate=5e-2)  # config 20: 60
PPL_TIMED_EVALS = 20
# The HalfNormal normalizing constants the ppl model keeps and the
# hand-written GLM drops: two scales, each 1/2 log(2/pi).
PPL_GLM_SHIFT = 2 * 0.5 * math.log(2.0 / math.pi)
PPL_ZERO = dict(n_counties=64, mean_obs=8, seed=21)  # config 21's data
PPL_ZERO_WIDTH = 8
PPL_ZERO_STEPS = (3, 12)  # warm-up, timed steps (config 21: 3, 12), plus one instrumented
PPL_ZERO_BATCH = 16


def _ppl_node(data_kw, roots, dev, conn):
    """One node of the ppl phases: the ppl radon model built from
    ``data_kw`` on ``dev``, its ``compiled.node_compute()`` served with
    ``serve_tcp_once`` on one port and, for each store root in
    ``roots``, a sharded-SVI owner (``make_sharded_update_compute``) on
    a port of its own.  Answers the driver's commands on ``conn`` with
    its requests and updates since the last ``reset``."""
    sys.path.insert(0, str(ROOT))
    try:
        from pytensor_federated_torch import ppl
        from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
        from pytensor_federated_torch.optim import ShardStore
        from pytensor_federated_torch.ppl.svi import make_sharded_update_compute
        from pytensor_federated_torch.service import serve_tcp_once

        if dev == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ppl node found no GPU")
        model, args, _ = ppl.make_radon_example(**data_kw, device=dev)
        compiled = ppl.compile(model, args)
        lock, counts, ports = threading.Lock(), {"requests": 0, "updates": 0}, []

        def counted(fn, key):
            def run(*a):
                with lock:
                    counts[key] += 1
                return fn(*a)
            return run

        servers = [counted(compiled.node_compute(), "requests")]
        for root in roots:
            owner = make_sharded_update_compute(compiled, ShardStore(root),
                                                learning_rate=PPL_STREAM["learning_rate"],
                                                n_mc=PPL_STREAM["n_mc"])
            owner.versioned_update = counted(owner.versioned_update, "updates")
            servers.append(owner)
        for compute in servers:
            bound = threading.Event()

            def on_ready(port, bound=bound):
                ports.append(port)
                bound.set()

            threading.Thread(target=serve_tcp_once, args=(compute,), daemon=True,
                             kwargs={"port": 0, "concurrent": True, "ready_callback": on_ready}
                             ).start()
            if not bound.wait(60):
                raise RuntimeError("ppl node did not bind a port")
        conn.send({"ports": ports, "pid": os.getpid(),
                   "device": torch.cuda.get_device_name() if dev == "cuda" else "cpu"})

        def now():
            with lock:
                return {**counts, "launches": linreg_reductions.launches}

        base = now()
        while True:
            cmd = conn.recv()
            cur = now()
            if cmd == "reset":
                base = cur
            conn.send({k: cur[k] - base[k] for k in cur})
            if cmd == "stop":
                return
    except Exception:
        conn.send({"error": traceback.format_exc()})


def _start_ppl_nodes(n, data_kw, roots, card):
    ctx = _node_context()
    procs, conns = [], []
    for _ in range(n):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_ppl_node, args=(data_kw, roots, card.type, child), daemon=True)
        proc.start()
        procs.append(proc)
        conns.append(parent)
    return procs, conns


def _join_nodes(procs):
    for proc in procs:
        proc.join(timeout=10)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)


def _rmse(a, b):
    return math.sqrt(sum((a[k] - b[k]) ** 2 for k in PPL_GLOBALS) / len(PPL_GLOBALS))


def _ppl_values(card, model, args, compiled, points):
    """The ppl radon model on the card against itself in float64 on the
    CPU and against the hand-written ``HierarchicalRadonGLM``, and the
    mesh lane against the dense program."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch import fed, ppl

    c64 = ppl.compile(model, tuple(a.detach().cpu().double() for a in args))
    f64_ok, f64 = _against_f64(compiled, c64, points)
    glm = pft.HierarchicalRadonGLM(pft.generate_radon_data(**PPL_RADON, device=card)[0])
    mesh = pft.make_mesh({"shards": PPL_MESH_SLOTS}, devices=[card] * PPL_MESH_SLOTS)
    meshed = ppl.compile(model, args, placement=fed.MeshPlacement(mesh))
    glm_rows, mesh_rows, glm_ok, mesh_ok = [], [], True, True
    for name, p in points.items():
        v, g = compiled.logp_and_grad(p)
        vg, gg = glm.logp_and_grad(p)
        rel = abs(float(v) - (float(vg) + PPL_GLM_SHIFT)) / abs(float(v))
        worst = _err_over_tol(g, gg, MODEL_GRAD_RTOL, MODEL_GRAD_ATOL_OF_MAX)
        glm_ok &= rel <= MODEL_VALUE_RTOL and worst <= 1.0
        glm_rows.append({"point": name, "value_rel_err_shifted": rel, "grad_err_over_tol": worst})
        ok, row = _against_no_mesh(meshed.logp_and_grad(p), (v, g))
        mesh_ok &= ok
        mesh_rows.append({"point": name, **row})
    p0 = points["origin"]
    ms = {"dense": _ms_per_eval(lambda: compiled.logp_and_grad(p0), card, PPL_TIMED_EVALS),
          "mesh": _ms_per_eval(lambda: meshed.logp_and_grad(p0), card, PPL_TIMED_EVALS),
          "hand_written_glm": _ms_per_eval(lambda: glm.logp_and_grad(p0), card, PPL_TIMED_EVALS)}
    gates = {"values_against_f64": f64_ok, "glm_shifted_values_equal_grads": glm_ok,
             "mesh_equals_dense": mesh_ok}
    return gates, {"against_f64": f64, "against_hand_written_glm": glm_rows,
                   "glm_shift": PPL_GLM_SHIFT, "mesh": {"slots": PPL_MESH_SLOTS, "points": mesh_rows},
                   "ms_per_logp_and_grad": ms, "timed_evals": PPL_TIMED_EVALS}


def _ppl_pool(model, args, compiled, point, client):
    """One pool window and one reduced window against the dense program."""
    from pytensor_federated_torch import fed, ppl
    from pytensor_federated_torch.telemetry import flightrec, spans

    want = compiled.logp_and_grad(point)
    prev = spans.set_enabled(True), flightrec.set_enabled(True)
    rows, kinds = {}, {}
    try:
        for name, placement in (("window", fed.PoolPlacement(client, window=8)),
                                ("reduced", fed.PoolPlacement(client, window=8, reduce=True))):
            flightrec.clear()
            t0 = time.perf_counter()
            got = ppl.compile(model, args, placement=placement).logp_and_grad(point)
            ok, rows[name] = _against_no_mesh(got, want)
            rows[name]["ok"], rows[name]["wall_s"] = ok, time.perf_counter() - t0
            kinds[name] = sorted({e["kind"] for e in flightrec.events()
                                  if e["kind"].startswith("fed.")})
    finally:
        spans.set_enabled(prev[0])
        flightrec.set_enabled(prev[1])
    gates = {"window_equals_dense": rows["window"]["ok"],
             "reduced_equals_dense": rows["reduced"]["ok"],
             "reduced_lowered_to_one_reduced_window": kinds["reduced"] == ["fed.reduce_window"]}
    return gates, {**rows, "flight_kinds": kinds}


def _ppl_stream(model, args, pool, card, stream=PPL_STREAM):
    """Config 20's streaming SVI through a GatewayThread over the pool."""
    import numpy as np

    from pytensor_federated_torch import fed, ppl
    from pytensor_federated_torch.gateway import GatewayThread, TenantFairness
    from pytensor_federated_torch.service import TcpArraysClient

    gw = GatewayThread(pool, fairness=TenantFairness(), frame_items=16)
    gw.start()
    cli = TcpArraysClient("127.0.0.1", gw.port, tenant="svi")
    try:
        pc = ppl.compile(model, args, placement=fed.PoolPlacement(cli, window=8, tag="svi"))
        svi = ppl.StreamingSVI(pc, generator=3, n_mc=stream["n_mc"],
                               learning_rate=stream["learning_rate"], deadline_s=None)
        rng = np.random.default_rng(20)
        n = pc.n_shards

        def batch():
            return rng.choice(n, size=stream["batch"], replace=False)

        walls = []
        for _ in range(stream["warm"]):
            t0 = time.perf_counter()
            svi.step(batch())
            walls.append(time.perf_counter() - t0)
        svi.deadline_s = max(1.0, 6.0 * statistics.median(walls))
        base_offered, base_accepted = svi.offered, svi.accepted
        t0 = time.perf_counter()
        for _ in range(stream["batches"]):
            svi.step(batch())
        wall = time.perf_counter() - t0
    finally:
        cli.close()
        gw.stop()
    offered, accepted = svi.offered - base_offered, svi.accepted - base_accepted
    goodput = accepted / offered
    third = max(1, len(svi.elbo_trace) // 3)
    first, last = (float(np.mean(svi.elbo_trace[:third])), float(np.mean(svi.elbo_trace[-third:])))
    gates = {"goodput_at_least_0.9": goodput >= 0.9, "opt_steps_equal_accepted":
             svi.opt_steps == svi.accepted, "elbo_last_third_above_first": last > first}
    return gates, {**stream, "tenant": "svi", "frame_items": 16, "warm_step_s": walls,
                   "deadline_s": svi.deadline_s, "offered": offered, "accepted": accepted,
                   "goodput": goodput, "skipped": dict(svi.skipped), "opt_steps": svi.opt_steps,
                   "wall_s": wall, "steps_per_s": accepted / wall,
                   "elbo_first_third": first, "elbo_last_third": last}


def phase_ppl(dev="cuda", nuts=PPL_NUTS, pt=PPL_PT, svi=PPL_SVI, stream=PPL_STREAM):
    """Slice 15, the ppl front end: bench_suite config 20 on the card —
    one effectful radon model in every mode."""
    from pytensor_federated_torch import ppl
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
    from pytensor_federated_torch.routing import NodePool, PooledArraysClient
    from pytensor_federated_torch.samplers import pt_sample

    card = torch.device("cuda", 0) if torch.device(dev).type == "cuda" else torch.device("cpu")
    launches0 = linreg_reductions.launches
    out = {"phase": "ppl", "config": "bench_suite.py:3153-3443 (config 20)",
           "data": {**PPL_RADON, "mean_obs": 24}}
    procs, conns = _start_ppl_nodes(2, {**PPL_RADON}, [], card)
    pool = client = None
    gates = {}
    try:
        t0 = time.perf_counter()
        model, args, true = ppl.make_radon_example(**PPL_RADON, device=card)
        compiled = ppl.compile(model, args)
        points = _three_points(compiled.init_params())
        g, out["values"] = _ppl_values(card, model, args, compiled, points)
        gates.update({f"values.{k}": v for k, v in g.items()})
        out["values"]["wall_s"] = time.perf_counter() - t0

        graph = card.type == "cuda"
        res, run = _model_nuts(compiled, card, seed=11, nuts=nuts, cuda_graph=graph)
        run["cuda_graph"] = graph
        nuts_means = {k: float(res.samples[k].mean()) for k in PPL_GLOBALS}
        run["beta_median"], run["beta_true"] = float(res.samples["beta"].median()), true["beta"]
        run["means"] = nuts_means
        out["nuts"] = run
        gates["nuts.finite"] = run["finite"]
        gates["nuts.divergence_share_below_0.1"] = run["divergence_share"] < 0.1
        gates["nuts.beta_within_0.3"] = abs(run["beta_median"] - true["beta"]) < 0.3
        gates["nuts.split_rhat_below_1.1"] = run["max_split_rhat"] < 1.1

        _sync(card)
        t0 = time.perf_counter()
        pt_res = pt_sample(compiled.logp, compiled.init_params(),
                           generator=torch.Generator(device=card).manual_seed(1),
                           num_warmup=pt[0], num_samples=pt[1], num_temps=PPL_PT_TEMPS,
                           cuda_graph=graph)
        _sync(card)
        pt_means = {k: float(pt_res.samples[k].mean()) for k in PPL_GLOBALS}
        out["tempering"] = {"warmup": pt[0], "draws": pt[1], "temps": PPL_PT_TEMPS,
                            "cuda_graph": graph, "wall_s": time.perf_counter() - t0,
                            "means": pt_means, "rmse_vs_nuts": _rmse(pt_means, nuts_means)}

        _sync(card)
        t0 = time.perf_counter()
        svi_res, _ = ppl.svi_fit(compiled, generator=torch.Generator(device=card).manual_seed(2),
                                 **svi)
        _sync(card)
        svi_wall = time.perf_counter() - t0
        svi_means = {k: float(svi_res.mean[k]) for k in PPL_GLOBALS}
        elbo = svi_res.elbo_trace
        out["svi"] = {**svi, "wall_s": svi_wall, "nuts_wall_s": run["wall_s"],
                      "speedup_vs_nuts": run["wall_s"] / svi_wall, "means": svi_means,
                      "rmse_vs_nuts": _rmse(svi_means, nuts_means),
                      "elbo_first": float(elbo[0]), "elbo_last": float(elbo[-1])}
        gates["svi.elbo_improves"] = float(elbo[-1]) > float(elbo[0])
        gates["svi.rmse_vs_nuts_within_0.35"] = out["svi"]["rmse_vs_nuts"] <= PPL_SVI_RMSE

        nodes = _fed_ask(conns, None, timeout=300.0)
        out["nodes"] = [n["device"] for n in nodes]
        pool = NodePool([("127.0.0.1", n["ports"][0]) for n in nodes], transport="tcp")
        client = PooledArraysClient(pool)
        _fed_ask(conns, "reset")
        g, out["pool"] = _ppl_pool(model, args, compiled, points["normal"], client)
        gates.update({f"pool.{k}": v for k, v in g.items()})
        pool.start()
        g, out["stream"] = _ppl_stream(model, args, pool, card, stream)
        gates.update({f"stream.{k}": v for k, v in g.items()})
        out["node_counts"] = _fed_ask(conns, "stop")
    finally:
        if client is not None:
            client.close()
        if pool is not None:
            pool.close()
        _join_nodes(procs)
    out["kernel_launches"] = linreg_reductions.launches - launches0
    out["gates"] = gates
    return all(gates.values()), out


def _ppl_zero_measure(svi, schedule, steps=PPL_ZERO_STEPS):
    """Config 21's measure: warm-up steps, then the driver-side reply
    bytes of ONE instrumented step (the npwire decode_copy counter counts
    only with telemetry on), then the accepted steps/s of timed steps."""
    from pytensor_federated_torch.service.npwire import WIRE_BYTES_COPIED
    from pytensor_federated_torch.telemetry import spans

    decode = WIRE_BYTES_COPIED.labels(lane="npwire", stage="decode_copy")
    it = iter(schedule)
    outcomes = [svi.step(next(it)) for _ in range(steps[0])]
    was = spans.set_enabled(True)
    try:
        b0 = decode.value
        outcomes.append(svi.step(next(it)))
        nbytes = decode.value - b0
    finally:
        spans.set_enabled(was)
    t0 = time.perf_counter()
    outcomes += [svi.step(next(it)) for _ in range(steps[1])]
    wall = time.perf_counter() - t0
    return {"accepted_all": outcomes.count("accepted") == len(outcomes),
            "steps_per_s": steps[1] / wall, "reply_bytes_per_step": nbytes}


def phase_ppl_zero(dev="cuda", width=PPL_ZERO_WIDTH, data_kw=PPL_ZERO, steps=PPL_ZERO_STEPS):
    """Slice 15, sharded SVI: bench_suite config 21 at width 8 on the
    card — the driver-centric streaming control against ZeRO-sharded
    streaming SVI over the same eight node processes."""
    import shutil
    import tempfile

    import numpy as np

    from pytensor_federated_torch import fed, ppl
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
    from pytensor_federated_torch.optim import ShardedOptimizer
    from pytensor_federated_torch.routing import PooledArraysClient
    from pytensor_federated_torch.service import TcpArraysClient

    card = torch.device("cuda", 0) if torch.device(dev).type == "cuda" else torch.device("cpu")
    launches0 = linreg_reductions.launches
    root = tempfile.mkdtemp(prefix="ppl-zero-")
    procs, conns = _start_ppl_nodes(width, dict(data_kw), [root], card)
    out = {"phase": "ppl_zero", "config": "bench_suite.py:3445-3700 (config 21), width 8",
           "data": dict(data_kw), "width": width}
    clients, opt = [], None
    try:
        model, args, _ = ppl.make_radon_example(**data_kw, device=card)
        plain = ppl.compile(model, args)
        dim = sum(t.numel() for t in plain.init_params().values())
        total = 2 * dim
        rng = np.random.default_rng(16)
        schedule = [rng.choice(data_kw["n_counties"], size=PPL_ZERO_BATCH, replace=False)
                    .astype(np.int32) for _ in range(sum(steps) + 1)]
        t0 = time.perf_counter()
        nodes = _fed_ask(conns, None, timeout=300.0)
        out["spawn_s"] = time.perf_counter() - t0
        out["nodes"] = [n["device"] for n in nodes]
        _fed_ask(conns, "reset")
        kw = dict(n_mc=PPL_STREAM["n_mc"], learning_rate=PPL_STREAM["learning_rate"])

        control_client = PooledArraysClient([("127.0.0.1", n["ports"][0]) for n in nodes],
                                            transport="tcp")
        clients.append(control_client)
        control = ppl.StreamingSVI(ppl.compile(model, args, placement=fed.PoolPlacement(
            control_client, window=8, tag="svi")), generator=5, **kw)
        out["control"] = _ppl_zero_measure(control, schedule, steps)
        out["control"].update(opt_steps=control.opt_steps, accepted=control.accepted,
                              resident_elems=4 * total)

        clients += [TcpArraysClient("127.0.0.1", n["ports"][1]) for n in nodes]
        opt = ShardedOptimizer(total, clients=clients[1:])
        sharded = ppl.StreamingSVI(plain, generator=5, sharded=opt, **kw)
        out["sharded"] = _ppl_zero_measure(sharded, schedule, steps)
        ceil_shard = -(-total // width)
        out["sharded"].update(shard_opt_steps=sharded.shard_opt_steps,
                              shard_accepted=sharded.shard_accepted,
                              max_reply_elems=opt.max_reply_elems, ceil_shard=ceil_shard,
                              resident_elems=total + opt.max_reply_elems,
                              driver_optimizer=sharded._opt is not None)
        out["model_flat_elems"] = total
        out["node_counts"] = _fed_ask(conns, "stop")
        reduction = out["control"]["reply_bytes_per_step"] / max(
            1, out["sharded"]["reply_bytes_per_step"])
        out["reply_bytes_reduction"] = reduction
        out["gates"] = {
            "control.accepted_all": out["control"]["accepted_all"],
            "control.opt_steps_equal_accepted": control.opt_steps == control.accepted,
            "sharded.accepted_all": out["sharded"]["accepted_all"],
            "sharded.shard_opt_steps_equal_accepted":
                sharded.shard_opt_steps == sharded.shard_accepted,
            "sharded.max_reply_elems_within_ceil_total_over_width":
                opt.max_reply_elems <= ceil_shard,
            "reply_bytes_4x_below_control": reduction >= 4.0,
        }
    finally:
        for c in clients:
            c.close()
        if opt is not None and opt._executor is not None:
            opt._executor.shutdown()
        _join_nodes(procs)
        shutil.rmtree(root, ignore_errors=True)
    out["kernel_launches"] = linreg_reductions.launches - launches0
    return all(out["gates"].values()), out


# Slice 16: bench_suite config 23 (bench_suite.py:4082-4320), blocked
# Cholesky over block-store nodes, at its own sizes.  The one departure:
# the eight nodes start once and every width runs on the first w of them,
# their stores RESET between widths (config 23 spawns fresh nodes per
# width; a store holds tiles by coordinate and never reads the width).
SLICE16 = ("linalg",)
LINALG = dict(n=512, block=64, seed=23)  # config 23's matrix: a = m m^T / n + I
LINALG_WIDTHS = (2, 4, 8)
LINALG_TIMED = 3  # full factorizations per width after one warm one (config 23: 3)
LINALG_ATOL = 1e-8  # config 23's gate against LAPACK (bench_suite.py:4246)
LINALG_RECOVERY = dict(width=4, victim=1, kill_before_call=4)  # its CHOL_PANEL(1)
LINALG_TIMED_CALLS = 5  # the controls', the GP lane's and the fed ops' medians
LINALG_GP = dict(n=384, lengthscale=0.5, jitter=1e-4, block=128)  # bench_suite.py:4255-4290
LINALG_GP_TOL = dict(rtol=2e-3, atol=1e-4)
LINALG_FED = dict(n=512, n_shards=4, slots=4, block=64)
LINALG_FED_RTOL = 1e-10  # float64 on the card against float64 on the CPU, of max |ref|


def _linalg_node(lay_args, dev, conn):
    """One block-store node: ``make_block_store_compute`` over
    ``BlockLayout(*lay_args)`` with its tiles on ``dev``, served with
    ``serve_tcp_once``; answers the driver's ``stop`` on ``conn``."""
    sys.path.insert(0, str(ROOT))
    try:
        from pytensor_federated_torch.linalg import BlockLayout, make_block_store_compute
        from pytensor_federated_torch.linalg.service import chol_kernel, dot_kernel, trsm_kernel
        from pytensor_federated_torch.service import serve_tcp_once

        compute = make_block_store_compute(BlockLayout(*lay_args), device=dev)
        # CUDA, cuBLAS and cuSOLVER start here, on every node at once,
        # not in the first factorization of each width.
        warm = torch.eye(2, dtype=torch.float64, device=compute.store.device)
        dot_kernel(trsm_kernel(warm, chol_kernel(warm)), warm).cpu()
        bound, ports = threading.Event(), []
        threading.Thread(target=serve_tcp_once, args=(compute,), daemon=True,
                         kwargs={"port": 0, "concurrent": True,
                                 "ready_callback": lambda p: (ports.append(p), bound.set())}
                         ).start()
        if not bound.wait(60):
            raise RuntimeError("linalg node did not bind a port")
        conn.send({"port": ports[0], "pid": os.getpid(),
                   "device": torch.cuda.get_device_name() if dev == "cuda" else "cpu",
                   "store_device": str(compute.store.device)})
        while conn.recv() != "stop":
            tiles = list(compute.store.tiles.values())
            conn.send({"tiles": len(tiles), "tile_devices": sorted({str(t.device) for t in tiles})})
        conn.send({"stopped": True})
    except Exception:
        conn.send({"error": traceback.format_exc()})


class _LinalgClient:
    """A node's TCP client with config 23's ledger: payload array bytes
    (requests and replies) by (opcode, step), counted at the driver's
    client seam, as bench_suite's ``CountingClient``.  ``kill_before``
    SIGKILLs the node process just before that call goes out."""

    def __init__(self, port, proc=None, kill_before=None):
        from pytensor_federated_torch.service import TcpArraysClient

        self.inner = TcpArraysClient("127.0.0.1", port, timeout_s=120.0)
        self.by_op, self.calls, self.proc, self.kill_before = {}, 0, proc, kill_before

    def evaluate(self, *arrays):
        import numpy as np

        from pytensor_federated_torch.linalg.blocks import decode_op_header

        self.calls += 1
        if self.calls == self.kill_before:
            self.proc.kill()  # SIGKILL: the store and its tiles are gone
            self.proc.join(timeout=30)
        opcode, step, _ = decode_op_header(np.asarray(arrays[0]))
        out = self.inner.evaluate(*arrays)
        nbytes = sum(np.asarray(x).nbytes for x in arrays) + sum(np.asarray(x).nbytes for x in out)
        self.by_op[(opcode, step)] = self.by_op.get((opcode, step), 0) + nbytes
        return out

    def reset(self):
        """Drop the node's tiles (not counted) and the ledger."""
        from pytensor_federated_torch.linalg.blocks import OPCODES, encode_op_header

        self.inner.evaluate(encode_op_header(OPCODES["RESET"]))
        self.by_op.clear()

    def close(self):
        self.inner.close()


def _linalg_width(lay, a, ref, clients, card, timed):
    """Config 23's pool lane at one width: a warm factorization, then
    ``timed`` full ones (distribution included), each against LAPACK;
    the ledger's bytes per factorization and per step."""
    import numpy as np

    from pytensor_federated_torch.linalg import BlockedCholesky
    from pytensor_federated_torch.linalg.blocks import OPCODES

    width = len(clients)
    for c in clients:
        c.reset()
    chol = BlockedCholesky(lay, clients, device=card)
    factors, walls, shipped_once = [chol.factor(a)], [], []
    shipped_once.append(sorted(c for _, c in chol.shipped) == sorted(lay.lower_coords()))
    for c in clients:
        c.by_op.clear()
    for _ in range(timed):
        _sync(card)
        t0 = time.perf_counter()
        factors.append(chol.factor(a))
        _sync(card)
        walls.append(time.perf_counter() - t0)
        shipped_once.append(sorted(c for _, c in chol.shipped) == sorted(lay.lower_coords()))
    errs = [float(np.abs(f.cpu().numpy() - ref).max()) for f in factors]
    put, g = OPCODES["PUT"], lay.grid_rows
    step_bytes = [sum(v for c in clients for (op, s), v in c.by_op.items() if op != put and s == k)
                  // timed for k in range(g)]
    replica_step_max = max(sum(v for (op, s), v in c.by_op.items() if op != put and s == k) // timed
                           for c in clients for k in range(g))
    dist_bytes = sum(v for c in clients for (op, _), v in c.by_op.items() if op == put) // timed
    best = min(walls)
    return factors, {
        "width": width, "walls_s": walls, "wall_s": best,
        "gflop_per_s": lay.rows ** 3 / 3.0 / best / 1e9,
        "max_abs_err_vs_lapack": max(errs),
        "factors_bit_equal": all(bool((f == factors[0]).all()) for f in factors),
        "restores": chol.restores, "reshipped": len(chol.reshipped),
        "every_lower_tile_shipped_once": all(shipped_once),
        "distribution_bytes": dist_bytes, "steady_step_bytes": step_bytes,
        "steady_step_bytes_max": max(step_bytes), "replica_step_bytes_max": replica_step_max,
    }


def _linalg_gp(card):
    """Config 23's GP-posterior dispatch lane on the card: the blocked
    route of ``_posterior_chol`` against the dense one forced by
    ``_BLOCKED_CHOL_MIN = 10**9``."""
    import numpy as np

    from pytensor_federated_torch.models import gp as gp_mod

    n = LINALG_GP["n"]
    xs = np.linspace(0.0, 8.0, n)
    cov = np.exp(-0.5 * ((xs[:, None] - xs[None, :]) / LINALG_GP["lengthscale"]) ** 2)
    cov = torch.tensor(cov + LINALG_GP["jitter"] * np.eye(n), dtype=torch.float64, device=card)
    run = lambda: gp_mod._posterior_chol(cov, LINALG_GP["jitter"], None, block=LINALG_GP["block"])
    out = {}
    saved = gp_mod._BLOCKED_CHOL_MIN
    try:
        for name, minimum in (("blocked", saved), ("dense", 10**9)):
            gp_mod._BLOCKED_CHOL_MIN = minimum
            out[name] = run()
            out[f"{name}_ms"] = _ms_per_eval(run, card, LINALG_TIMED_CALLS, warm=0)
    finally:
        gp_mod._BLOCKED_CHOL_MIN = saved
    blocked, dense = out.pop("blocked"), out.pop("dense")
    close = torch.allclose(blocked, dense, **LINALG_GP_TOL)
    return close and blocked.device == cov.device, {
        **LINALG_GP, "blocked_min": saved, "tolerance": LINALG_GP_TOL, **out,
        "max_abs_err": float((blocked - dense).abs().max()), "on_card": blocked.device == cov.device}


def _linalg_fed(card, a):
    """The fed-program ops on a 4-slot mesh of the card, float64,
    against float64 on the CPU."""
    import numpy as np

    from pytensor_federated_torch import fed, linalg
    from pytensor_federated_torch.parallel import make_mesh

    k = LINALG_FED
    placement = fed.MeshPlacement(make_mesh({"shards": k["slots"]}, devices=[card] * k["slots"]))
    rng = np.random.default_rng(LINALG["seed"] + 1)
    b = rng.normal(size=(k["n"], k["n"]))
    x = rng.normal(size=k["n"])
    l = np.linalg.cholesky(a)
    cases = {
        "matmul": (lambda: linalg.matmul(a, b, n_shards=k["n_shards"], placement=placement,
                                         device=card), a @ b),
        "block_quadratic_form": (lambda: linalg.block_quadratic_form(
            a, x, n_shards=k["n_shards"], placement=placement, device=card), x @ a @ x),
        "triangular_solve": (lambda: linalg.triangular_solve(
            l, x, block=k["block"], placement=placement, n_shards=k["n_shards"], device=card),
            np.linalg.solve(l, x)),
    }
    rows, ok = {}, True
    for name, (fn, ref) in cases.items():
        got = fn()
        err = float(np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max())
        good = got.device.type == card.type and err <= LINALG_FED_RTOL
        ok &= good
        rows[name] = {"rel_err": err, "on_card": got.device.type == card.type,
                      "ms": _ms_per_eval(fn, card, LINALG_TIMED_CALLS, warm=0)}
    return ok, {**k, "rtol_of_max": LINALG_FED_RTOL, "ops": rows}


def phase_linalg(dev="cuda", widths=LINALG_WIDTHS, timed=LINALG_TIMED):
    """Slice 16, ``linalg``: bench_suite config 23 on the card."""
    import numpy as np

    from pytensor_federated_torch.linalg import BlockedCholesky, BlockLayout
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions

    card = torch.device("cuda", 0) if torch.device(dev).type == "cuda" else torch.device("cpu")
    launches0 = linreg_reductions.launches
    n, b = LINALG["n"], LINALG["block"]
    lay = BlockLayout(n, n, b, b)
    rng = np.random.default_rng(LINALG["seed"])
    m = rng.normal(size=(n, n))
    a = m @ m.T / n + np.eye(n)
    ref = np.linalg.cholesky(a)
    ctx = _node_context()
    procs, conns, clients = [], [], []

    def start_node():
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_linalg_node, args=((n, n, b, b), card.type, child), daemon=True)
        proc.start()
        procs.append(proc)
        conns.append(parent)
        return proc, parent

    out = {"phase": "linalg", "config": "bench_suite.py:4082-4320 (config 23)",
           "n": n, "block": b, "grid": lay.grid_rows, "seed": LINALG["seed"],
           "departure": "8 nodes started once; widths on the first w, stores RESET between"}
    gates, marks = {}, {}
    out["marks_s"] = marks  # seconds from the phase's start to the end of each part
    try:
        t0 = time.perf_counter()
        for _ in range(max(widths)):
            start_node()
        nodes = _fed_ask(conns, None, timeout=300.0)
        out["spawn_s"] = marks["spawn"] = time.perf_counter() - t0
        out["nodes"] = [nd["device"] for nd in nodes]
        gates["nodes_store_on_card"] = all(nd["store_device"].startswith(card.type) for nd in nodes)
        clients[:] = [_LinalgClient(nd["port"]) for nd in nodes]

        tile_bytes = b * b * 8
        panel0 = (lay.grid_rows - 1) * tile_bytes
        lower = sum(1 for _ in lay.lower_coords()) * tile_bytes
        out["panel0_bytes"], out["lower_triangle_bytes"] = panel0, lower
        a_card = torch.tensor(a, device=card)
        a_cpu = torch.tensor(a)
        out["control"] = {
            "card_ms": _ms_per_eval(lambda: torch.linalg.cholesky(a_card), card, LINALG_TIMED_CALLS),
            "cpu_ms": _ms_per_eval(lambda: torch.linalg.cholesky(a_cpu), "cpu", LINALG_TIMED_CALLS),
            "cpu_threads": torch.get_num_threads(),
        }
        lanes, factors = [], {}
        for w in widths:
            factors[w], lane = _linalg_width(lay, a, ref, clients[:w], card, timed)
            lane["vs_card_control"] = out["control"]["card_ms"] / 1e3 / lane["wall_s"]
            lane["vs_cpu_control"] = out["control"]["cpu_ms"] / 1e3 / lane["wall_s"]
            lanes.append(lane)
            gates[f"w{w}.within_1e-8_of_lapack"] = lane["max_abs_err_vs_lapack"] <= LINALG_ATOL
            gates[f"w{w}.no_restores"] = lane["restores"] == 0 and lane["reshipped"] == 0
            gates[f"w{w}.every_lower_tile_shipped_once"] = lane["every_lower_tile_shipped_once"]
            gates[f"w{w}.step_bytes_within_w_plus_2_panels"] = (
                lane["steady_step_bytes_max"] <= (w + 2) * panel0)
            gates[f"w{w}.replica_step_bytes_below_lower_triangle"] = (
                lane["replica_step_bytes_max"] < lower)
            gates[f"w{w}.distribution_ships_the_lower_triangle_once"] = (
                lower <= lane["distribution_bytes"] < 2 * lower)
        out["lanes"] = lanes
        marks["widths"] = time.perf_counter() - t0
        tiles = _fed_ask(conns, "tiles")
        gates["tiles_on_card"] = all(t["tile_devices"] == [str(card)] or not t["tiles"]
                                     for t in tiles)

        # Recovery: SIGKILL one width-4 node just before its CHOL_PANEL(1)
        # and restart it from the fork server; the driver restores it.
        rec = LINALG_RECOVERY
        w, v = rec["width"], rec["victim"]
        for c in clients[:w]:
            c.reset()
        victim_proc = procs[v]
        rclients = list(clients[:w])
        rclients[v] = _LinalgClient(nodes[v]["port"], victim_proc, rec["kill_before_call"])
        restarted = []

        def reconnect(p):
            proc, conn = start_node()
            (fresh,) = _fed_ask([conn], None, timeout=120.0)
            restarted.append(fresh)
            return _LinalgClient(fresh["port"])

        clients.append(rclients[v])  # closed below with the rest
        flight = []
        from pytensor_federated_torch.telemetry import flightrec

        was = flightrec.set_enabled(True)
        flightrec.clear()
        try:
            t_rec = time.perf_counter()
            chol = BlockedCholesky(lay, rclients, reconnect=reconnect, device=card)
            l_rec = chol.factor(a)
            rec_wall = time.perf_counter() - t_rec
            flight = [e["kind"] for e in flightrec.events() if e["kind"].startswith("linalg.")]
        finally:
            flightrec.set_enabled(was)
        if chol.clients[v] is not rclients[v]:
            clients.append(chol.clients[v])  # the restarted node's client
        bit_equal = bool((l_rec == factors[w][0]).all())
        out["recovery"] = {**rec, "wall_s": rec_wall, "restores": chol.restores,
                           "reshipped": [[p, list(c)] for p, c in chol.reshipped],
                           "victim_exit": victim_proc.exitcode, "restarted": len(restarted),
                           "flight": flight, "bit_equal_uninterrupted": bit_equal,
                           "max_abs_err_vs_lapack": float(np.abs(l_rec.cpu().numpy() - ref).max())}
        gates["recovery.victim_sigkilled"] = victim_proc.exitcode == -signal.SIGKILL
        gates["recovery.restored"] = chol.restores >= 1 and len(restarted) == chol.restores
        gates["recovery.only_victim_reships_columns_from_the_failed_step"] = bool(
            chol.reshipped) and all(p == v and c[1] >= 1 for p, c in chol.reshipped)
        gates["recovery.bit_equal_uninterrupted"] = bit_equal
        marks["recovery"] = time.perf_counter() - t0

        ok, out["gp"] = _linalg_gp(card)
        gates["gp.blocked_within_tolerance_of_dense"] = ok
        marks["gp"] = time.perf_counter() - t0
        ok, out["fed"] = _linalg_fed(card, a)
        gates["fed.ops_match_float64_cpu"] = ok
        marks["fed"] = time.perf_counter() - t0
        out["node_stops"] = _fed_ask([c for c, p in zip(conns, procs) if p.is_alive()], "stop")
    finally:
        for c in clients:
            c.close()
        _join_nodes(procs)
    out["kernel_launches"] = linreg_reductions.launches - launches0
    out["gates"] = gates
    return all(gates.values()), out


# Slice 17: the PyTensor/PyMC bridge.  PyTensor and PyMC are not
# installed on this host, so the phase runs the port's REAL bridge glue
# and demos/demo_pymc.py under the port's fakes (tests/torch_pytensor_shim.py,
# tests/torch_pymc_shim.py; they import no JAX), with the free variables
# on the card.  Four lanes:
# - demo_pymc at the demo's own size (8 shards x 64, seed 123): the
#   potential and its gradients through the PyTorch linker's stand-in
#   (the op's torch_fn: the kernel on the card) against the perform lane
#   (host_fn: float32 across the numpy boundary, the kernel again) at
#   BRIDGE_POINTS points; the federated model against build_native_model
#   (tests/test_demo_pymc_shim.py's tolerance); find_MAP; main()'s NUTS,
#   2 x (200 + 200), random_seed 42.
# - the data term at the flagship's width, 8 x 131,072, through
#   federated_potential's torch lane against a float64 plain evaluation
#   on the CPU (the model phases' tolerances).
# - the rewrite: three FederatedLogpGradOps over disjoint shard subsets of
#   that data, each backed by the kernel through its host_fn, fused by the
#   optdb-registered rewriter into one ParallelFederatedOp: the same bits
#   as the unfused graph, one launch per member and evaluation, the same
#   bits from a pickled and restored op; wall clock of both recorded.
# - the fed lane: two FederatedLogpGrad potentials of the flagship's data
#   term (linreg_shard_logp; the second's y shifted by 0.25) over one
#   4-slot mesh of the card, each with its own MeshPlacement, composed by
#   fused_torch_callable into ONE fed.program: values and gradients
#   against the members evaluated apart.
SLICE17 = ("bridge",)
BRIDGE_DEMO = dict(n_shards=8, n_obs=64, draws=200, tune=200, chains=2)  # demo_pymc's defaults
BRIDGE_POINTS = 3
BRIDGE_LANES_RTOL = 1e-5
BRIDGE_NATIVE_RTOL = 1e-4  # tests/test_demo_pymc_shim.py: 1e-4 max(1, |logp|)
BRIDGE_SUBSETS = ((0, 1, 2), (3, 4, 5), (6, 7))
BRIDGE_TIMED = 20  # evaluations timed per lane (median)
BRIDGE_FED_SHIFT = 0.25
BRIDGE_FED_CHAINS = 3  # the fed lane's chain batch under torch.func.vmap, as a sampler's


def _bridge_fakes():
    """The port's fake pymc (and through it the fake pytensor), from the
    checkout's ``tests/``."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_pymc_shim

    return torch_pymc_shim


def _rel(got, want) -> float:
    """Largest elementwise |got - want| / |want| (0 where both are 0)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    return float(np.max(np.where(err == 0, 0.0, err / np.maximum(np.abs(want), 1e-300))))


def _bridge_demo(ns, card, demo):
    """demo_pymc under the fakes: the two lanes, the native model, the MAP
    and main()'s NUTS.  On the card the NUTS run replays its batched
    evaluation from a CUDA graph (the fakes' ``cuda_graph``): a replay
    never reaches the kernel wrapper's host-side counter, so, as in the
    nuts phase, the run's own graph is held bit for bit against eager
    calls of the same model and its kernel nodes are counted."""
    import contextlib
    import io

    import numpy as np

    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
    from pytensor_federated_torch.samplers.mcmc import (
        make_batch_logp_and_grad,
        make_flat_logp_and_grad,
    )

    dm = ns.demo
    data, _ = dm.generate_node_data(demo["n_shards"], n_obs=demo["n_obs"], seed=123, device=card)
    torch_model = dm.build_model(data)
    host_model = dm.build_model(data, use_torch_fn=False)
    native = dm.build_native_model(data)
    funcify = sys.modules["pytensor.link.pytorch.dispatch"].pytorch_funcify
    outputs = torch_model.potentials[0].owner.outputs
    lane_fn = ns.bridge.compile_graph_to_torch(outputs, [rv.var for rv in torch_model.free_rvs],
                                               funcify)
    host_outputs = host_model.potentials[0].owner.outputs
    fed_logp, native_logp = torch_model.logp_fn(), native.logp_fn()
    rng = np.random.default_rng(17)
    lanes, parity = [], []
    for _ in range(BRIDGE_POINTS):
        point = {"intercept": np.float32(rng.normal(1.5, 0.3)),
                 "offsets": rng.normal(0.0, 0.2, size=demo["n_shards"]).astype(np.float32),
                 "slope": np.float32(rng.normal(2.0, 0.3)),
                 "sigma": np.float32(np.exp(rng.normal(-0.5, 0.2)))}
        names = [rv.name for rv in torch_model.free_rvs]
        t_parts = [t.detach().cpu().double().numpy()
                   for t in lane_fn(*[torch.as_tensor(point[n], device=card) for n in names])]
        h_parts = ns.bridge.eval_graph(
            host_outputs, {rv.var: point[rv.name] for rv in host_model.free_rvs})
        lanes.append({"rel_err": max(_rel(t, h) for t, h in zip(t_parts, h_parts)),
                      "bits_equal": all(np.array_equal(np.float32(t), np.float32(h))
                                        for t, h in zip(t_parts, h_parts))})
        u = {n: torch.as_tensor(point[n], device=card) for n in names}
        u["sigma"] = torch.log(u["sigma"])
        a, b = float(fed_logp(u).detach()), float(native_logp(u).detach())
        parity.append({"federated": a, "native": b, "abs_err": abs(a - b),
                       "limit": BRIDGE_NATIVE_RTOL * max(1.0, abs(a))})
    t0 = time.perf_counter()
    with torch_model:
        map_est = ns.pymc.find_MAP(progressbar=False)
    map_s = time.perf_counter() - t0
    args = ["--n-shards", str(demo["n_shards"]), "--n-obs", str(demo["n_obs"]),
            "--draws", str(demo["draws"]), "--tune", str(demo["tune"]),
            "--chains", str(demo["chains"]), "--device", str(card)]
    printed = io.StringIO()
    _sync(card)
    before = linreg_reductions.launches
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        idata = dm.main(args)
    _sync(card)
    main_s = time.perf_counter() - t0
    host_launches = linreg_reductions.launches - before  # before the check's eager calls
    res = idata.result
    graph, launches, check_launches = {}, host_launches, 0
    if card.type == "cuda":
        flat_logp, flat0, unravel, _ = make_flat_logp_and_grad(
            torch_model.logp_fn(), torch_model.initial_unconstrained())
        lg = make_batch_logp_and_grad(flat_logp, unravel)
        before = linreg_reductions.launches
        graph = _graph_check(res.extra["graph"], lg,
                             _graph_points(flat0, demo["chains"], card, 1042), expected=1,
                             timed=5)
        check_launches = linreg_reductions.launches - before
        launches = _graphed_launches(graph, host_launches, res.extra["graph_replays"])
        graph["graph_replays"] = res.extra["graph_replays"]
    post = idata.posterior
    slope_median = float(post["slope"].median())
    depth = res.stats["depth"].float()
    gates = {
        "lanes_agree": all(r["rel_err"] <= BRIDGE_LANES_RTOL for r in lanes),
        "federated_equals_native": all(r["abs_err"] <= r["limit"] for r in parity),
        "map_slope": abs(map_est["slope"] - 2.0) < 0.1,
        "map_intercept": abs(map_est["intercept"] - 1.5) < 0.4,
        "map_sigma": 0.3 < map_est["sigma"] < 0.8,
        "nuts_slope_median": abs(slope_median - 2.0) < 0.15,
        "nuts_finite": all(np.isfinite(np.asarray(v)).all() for v in post.values()),
        "nuts_graph_one_launch_per_replay": (
            graph.get("launch_ok", False) and graph.get("replay_bits_equal_eager", False)
            and graph.get("graph_replays", 0) > 0) if card.type == "cuda" else True,
    }
    return gates, {
        "size": [demo["n_shards"], demo["n_obs"]], "lanes": lanes, "native": parity,
        "map": {k: float(v) for k, v in map_est.items() if np.ndim(v) == 0}, "map_s": map_s,
        "main_args": args, "main_printed": printed.getvalue().splitlines(), "main_s": main_s,
        "nuts": {"chains": demo["chains"], "tune": demo["tune"], "draws": demo["draws"],
                 "slope_median": slope_median,
                 "intercept_median": float(post["intercept"].median()),
                 "sigma_median": float(post["sigma"].median()),
                 "mean_depth": float(depth.mean()), "max_depth": int(depth.max()),
                 "divergences": int(res.stats["diverging"].sum()),
                 "cuda_graph": card.type == "cuda", "graph": graph,
                 "host_kernel_launches": host_launches, "kernel_launches": launches,
                 "check_launches": check_launches},
    }


def _bridge_float64_term(data, A, slope, sigma):
    """The data term and its gradients w.r.t. (A, slope, sigma) in float64
    on the CPU, by the kernel's plain version."""
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions_ref

    (x, y), mask = data.tree()
    A, slope, sigma = (torch.as_tensor(t).detach().cpu().double() for t in (A, slope, sigma))
    ll, gmu, gx, gz = linreg_reductions_ref(
        (torch.zeros((), dtype=torch.float64), slope, torch.log(sigma)), A,
        *(t.detach().cpu().double() for t in (x, y, mask)))
    return [ll.sum(), gmu, gx.sum(), gz.sum() / sigma]


def _bridge_data_term(ns, card, n_obs):
    """The data term at 8 x ``n_obs`` through federated_potential's torch
    lane against float64 on the CPU; ms and launches per evaluation."""
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions

    data, offsets = ns.demo.generate_node_data(8, n_obs=n_obs, seed=123, device=card)
    torch_fn, host_fn = ns.demo.make_federated_data_logp(data)
    TT = ns.bridge.TensorType
    A, slope, sigma = TT("float32", (8,))(), TT("float32", ())(), TT("float32", ())()
    pot = ns.bridge.pytensor_ops.federated_potential(host_fn, A, slope, sigma, torch_fn=torch_fn)
    funcify = sys.modules["pytensor.link.pytorch.dispatch"].pytorch_funcify
    fn = ns.bridge.compile_graph_to_torch(pot.owner.outputs, [A, slope, sigma], funcify)
    rows = []
    for shift in (0.05, -0.08):
        At = torch.as_tensor(1.5 + offsets + shift, dtype=torch.float32, device=card)
        st = torch.tensor(2.0 - 2 * shift, device=card)
        sg = torch.tensor(0.5 + shift, device=card)
        before = linreg_reductions.launches
        got = fn(At, st, sg)
        _sync(card)
        launches = linreg_reductions.launches - before
        ref = _bridge_float64_term(data, At, st, sg)
        rows.append({
            "launches": launches,
            "value_rel_err_f64": abs(float(got[0]) - float(ref[0])) / abs(float(ref[0])),
            "grad_err_over_tol_f64": _err_over_tol(dict(enumerate(got[1:])), dict(enumerate(ref[1:])),
                                                   MODEL_GRAD_RTOL, MODEL_GRAD_ATOL_OF_MAX),
        })
    args = (torch.as_tensor(1.5 + offsets, dtype=torch.float32, device=card),
            torch.tensor(2.0, device=card), torch.tensor(0.5, device=card))
    ms = _ms_per_eval(lambda: fn(*args), card, BRIDGE_TIMED)
    gates = {
        "value_within_f32_of_f64": all(r["value_rel_err_f64"] <= MODEL_VALUE_RTOL for r in rows),
        "grads_within_f32_of_f64": all(r["grad_err_over_tol_f64"] <= 1.0 for r in rows),
        "one_launch_per_evaluation": all(r["launches"] == (card.type == "cuda") for r in rows),
    }
    return gates, {"size": [8, n_obs], "points": rows, "ms_per_eval": ms}


def _bridge_graph(ns, terms):
    """Three FederatedLogpGradOps over disjoint shard subsets, their logps
    added; inputs [A_0, A_1, A_2, slope, sigma]."""
    TT = ns.bridge.TensorType
    As = [TT("float32", (len(s),))() for s in BRIDGE_SUBSETS]
    slope, sigma = TT("float32", ())(), TT("float32", ())()
    lps, grads = [], []
    for A, (_, host_fn) in zip(As, terms):
        lp, *g = ns.bridge.pytensor_ops.FederatedLogpGradOp(host_fn)(A, slope, sigma)
        lps.append(lp)
        grads += g
    total = lps[0]
    for lp in lps[1:]:
        total = total + lp
    return ns.bridge.FunctionGraph([*As, slope, sigma], [total, *grads])


def _bridge_rewrite(ns, card, n_obs, timed):
    """The fusion rewrite over three kernel-backed ops: bits, launches,
    pickling, wall clock."""
    import pickle

    import numpy as np

    import pytensor_federated_torch as pft
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions

    data, offsets = ns.demo.generate_node_data(8, n_obs=n_obs, seed=123, device=card)
    (x, y), mask = data.tree()
    terms = []
    for subset in BRIDGE_SUBSETS:
        idx = torch.as_tensor(subset, device=card)
        part = pft.ShardedData(data=(x[idx], y[idx]), mask=mask[idx])
        terms.append(ns.demo.make_federated_data_logp(part))
    values = [np.float32(1.5 + offsets[list(s)] + 0.05) for s in BRIDGE_SUBSETS]
    values += [np.float32(1.9), np.float32(0.55)]
    unfused, fused_fg = _bridge_graph(ns, terms), _bridge_graph(ns, terms)
    ns.bridge.optdb.query("federated_parallel_fusion")["obj"].rewrite(fused_fg)
    fused = [n for n in fused_fg.toposort()
             if isinstance(n.op, ns.bridge.fusion.ParallelFederatedOp)]
    run = lambda fg: ns.bridge.eval_graph(fg.outputs, dict(zip(fg.inputs, values)))
    want = run(unfused)
    before = linreg_reductions.launches
    got = run(fused_fg)
    _sync(card)
    launches = linreg_reductions.launches - before
    got2 = run(fused_fg)
    node = fused[0] if len(fused) == 1 else None
    pickled_bits, ops = False, [n.op for n in fused]
    if node is not None:
        op2 = pickle.loads(pickle.dumps(node.op))
        ops.append(op2)
        TT = ns.bridge.TensorType
        new_in = [TT(v.type.dtype, v.type.shape)() for v in node.inputs]
        outs = op2(*new_in)
        given = {v: values[fused_fg.inputs.index(v)] for v in node.inputs}
        direct = ns.bridge.eval_graph(node.outputs, given)
        restored = ns.bridge.eval_graph(outs, dict(zip(new_in, [given[v] for v in node.inputs])))
        pickled_bits = all(np.array_equal(a, b) for a, b in zip(direct, restored))
    ms = {"unfused": _ms_per_eval(lambda: run(unfused), card, timed),
          "fused": _ms_per_eval(lambda: run(fused_fg), card, timed)}
    for op in ops:  # the fused ops' member threads end with the lane
        pool = op.__dict__.get("_pool")
        if pool is not None:
            pool.shutdown()
    gates = {
        "one_fused_op_of_three": node is not None and len(node.op.members) == 3,
        "registered_at_90_fast_run": (
            ns.bridge.optdb.query("federated_parallel_fusion")["position"] == 90
            and "fast_run" in ns.bridge.optdb.query("federated_parallel_fusion")["tags"]),
        "bits_equal_unfused": all(np.array_equal(a, b) for a, b in zip(got, want)),
        "bits_equal_rerun": all(np.array_equal(a, b) for a, b in zip(got, got2)),
        "launches_per_fused_evaluation": launches == (3 if card.type == "cuda" else 0),
        "pickled_op_same_bits": pickled_bits,
    }
    return gates, {"size": [8, n_obs], "subsets": [list(s) for s in BRIDGE_SUBSETS],
                   "launches_per_fused_evaluation": launches, "ms_per_eval": ms,
                   "timed_evals": timed}


def _bridge_fed_lane(card, n_obs, slots, timed):
    """Two FederatedLogpGrad potentials composed into one fed.program by
    fused_torch_callable, against the members apart."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch import fed
    from pytensor_federated_torch.bridge.core import fused_torch_callable, member_torch_callable
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions, linreg_shard_logp

    (xy, mask, sid) = _kernel_flagship(card, n_obs)
    trees = [(xy, mask, sid), ((xy[0], xy[1] + BRIDGE_FED_SHIFT), mask, sid)]
    mesh = pft.make_mesh({"shards": slots}, devices=[card] * slots)
    evs = [fed.FederatedLogpGrad(linreg_shard_logp, t, placement=fed.MeshPlacement(mesh),
                                 device=card) for t in trees]
    fused = fused_torch_callable(
        [member_torch_callable("logp_grad", ev.torch_fn, name=f"m{i}") for i, ev in enumerate(evs)],
        [1, 1])
    composed = fused.__qualname__.startswith("_fused_fed_callable")
    g = torch.Generator(device="cpu").manual_seed(17)
    params = []
    for _ in evs:
        p = {k: torch.tensor(v + 0.05 * float(torch.randn((), generator=g)), device=card)
             for k, v in (("intercept", 1.5), ("slope", 2.0), ("log_sigma", math.log(0.5)))}
        p["offsets"] = (0.3 * torch.randn(8, generator=g)).to(card)
        params.append(p)
    fused(*params)  # records the joint program
    for ev, p in zip(evs, params):
        ev.torch_fn(p)
    _sync(card)
    before = linreg_reductions.launches
    lp_a, g_a, lp_b, g_b = fused(*params)
    _sync(card)
    launches_fused = linreg_reductions.launches - before
    before = linreg_reductions.launches
    apart = [ev.torch_fn(p) for ev, p in zip(evs, params)]
    _sync(card)
    launches_apart = linreg_reductions.launches - before
    rows = []
    for lp, gr, (lp0, (gr0,)) in ((lp_a, g_a, apart[0]), (lp_b, g_b, apart[1])):
        rows.append({
            "value_rel_err": abs(float(lp.detach()) - float(lp0.detach())) / abs(float(lp0.detach())),
            "grad_err_over_tol": _err_over_tol(gr, gr0, MODEL_GRAD_RTOL, MODEL_GRAD_ATOL_OF_MAX),
            "value_bits_equal": torch.equal(lp.detach(), lp0.detach()),
            "grad_bits_equal": all(torch.equal(gr[k], gr0[k]) for k in gr),
        })
    ms = {"fused": _ms_per_eval(lambda: fused(*params), card, timed),
          "apart": _ms_per_eval(lambda: [ev.torch_fn(p) for ev, p in zip(evs, params)],
                                card, timed)}
    chains = _bridge_fed_chains(fused, params, card, g)
    gates = {
        "composed_one_program": composed,
        "values_within_f32": all(r["value_rel_err"] <= MODEL_VALUE_RTOL for r in rows),
        "grads_within_f32": all(r["grad_err_over_tol"] <= 1.0 for r in rows),
        "chains_within_f32": (chains["value_rel_err"] <= MODEL_VALUE_RTOL
                              and chains["grad_err_over_tol"] <= 1.0),
        "chains_backward_first_order": chains["backward_err_over_tol"] <= 1.0,
    }
    return gates, {"size": [8, n_obs], "slots": slots, "members": rows,
                   "launches_per_fused_evaluation": launches_fused,
                   "launches_per_evaluation_apart": launches_apart, "chains": chains,
                   "ms_per_eval": ms, "timed_evals": timed}


def _bridge_fed_chains(fused, params, card, g):
    """The fused program under ``torch.func.vmap`` over a chain batch, as
    a sampler batches it, then one ``torch.autograd.grad`` of the chains'
    summed logps: each chain within float32 rounding of its own fused
    call, and the backward (the kernel's, first order) equal to the
    gradients the program returned."""
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions

    C = BRIDGE_FED_CHAINS
    batch = [{k: (v.expand(C, *v.shape) + 0.01 * torch.randn(C, *v.shape, generator=g).to(card)
                  ).requires_grad_(True) for k, v in p.items()} for p in params]
    before = linreg_reductions.launches
    outs = torch.func.vmap(fused)(*batch)
    leaves = [t for p in batch for t in p.values()]
    back = torch.autograd.grad(sum(lp.sum() for lp in outs[0::2]), leaves)
    _sync(card)
    launches = linreg_reductions.launches - before
    back = iter(back)
    backward_err = max(_err_over_tol({k: next(back) for k in p}, gr, MODEL_GRAD_RTOL,
                                     MODEL_GRAD_ATOL_OF_MAX)
                       for p, gr in zip(batch, outs[1::2]))
    value_err = grad_err = 0.0
    for c in range(C):
        one = fused(*[{k: v[c].detach() for k, v in p.items()} for p in batch])
        for lp, gr, lp1, gr1 in zip(outs[0::2], outs[1::2], one[0::2], one[1::2]):
            value_err = max(value_err, abs(float(lp[c].detach()) - float(lp1.detach()))
                            / abs(float(lp1.detach())))
            grad_err = max(grad_err, _err_over_tol({k: v[c] for k, v in gr.items()}, gr1,
                                                   MODEL_GRAD_RTOL, MODEL_GRAD_ATOL_OF_MAX))
    return {"chains": C, "launches": launches, "value_rel_err": value_err,
            "grad_err_over_tol": grad_err, "backward_err_over_tol": backward_err}


def phase_bridge(dev="cuda", demo=BRIDGE_DEMO, n_obs=LARGE_PATH[1], slots=FED_SLOTS,
                 timed=BRIDGE_TIMED):
    """Slice 17, the PyTensor/PyMC bridge under the port's fakes:
    demo_pymc, the data term at the flagship's width, the fusion rewrite
    and the fed lane, every kernel-backed evaluation on ``dev``."""
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions

    card = torch.device("cuda", 0) if torch.device(dev).type == "cuda" else torch.device("cpu")
    shims = _bridge_fakes()
    out, gates = {"phase": "bridge"}, {}
    launches0 = linreg_reductions.launches
    with shims.demo_pymc_under_torch_shims(card, cuda_graph=card.type == "cuda") as ns:
        for lane, run in (("demo", lambda: _bridge_demo(ns, card, demo)),
                          ("data_term", lambda: _bridge_data_term(ns, card, n_obs)),
                          ("rewrite", lambda: _bridge_rewrite(ns, card, n_obs, timed))):
            t0 = time.perf_counter()
            lane_gates, out[lane] = run()
            out[lane]["wall_s"] = time.perf_counter() - t0
            gates.update({f"{lane}.{k}": v for k, v in lane_gates.items()})
    t0 = time.perf_counter()
    lane_gates, out["fed"] = _bridge_fed_lane(card, n_obs, slots, timed)
    out["fed"]["wall_s"] = time.perf_counter() - t0
    gates.update({f"fed.{k}": v for k, v in lane_gates.items()})
    # The host counter over the phase, with the NUTS run's replays in
    # place of its host count (a replay does not reach the counter; the
    # graph check's eager calls are left out).
    nuts = out["demo"]["nuts"]
    out["kernel_launches"] = (linreg_reductions.launches - launches0 - nuts["check_launches"]
                              - nuts["host_kernel_launches"] + nuts["kernel_launches"])
    gates["kernel_launched"] = out["kernel_launches"] > 0 if card.type == "cuda" else True
    out["gates"] = gates
    return all(gates.values()), out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=["kernels", "federated", "models", "samplers", "slice6",
                                           "slice7", "slice8", "slice9", "slice10", "slice11",
                                           "slice12", "slice13", "slice14", "slice15", "slice16",
                                           "slice17"],
                        help="kernels: device, build and kernels only; federated: device, "
                             "build, nuts and federated only; models: device, build, radon, "
                             "logistic and lv_ode only; samplers: device, build, nuts, "
                             "wide_logistic, logistic and chees only; slice6: device, build, "
                             "lgssm, gp and tempering only; slice7: device, build, families "
                             "and model_check only; slice8: device, build, nuts, federated "
                             "and pool only; slice9: device, build and gateway only; "
                             "slice10: device, build, nuts, vi, particles, sgld, sbc, "
                             "checkpoint and demos only; slice11: device, build, nuts_large, "
                             "optim and mesh only; slice12: device, build, nuts_large, "
                             "multichain and seq only; slice13: device, build, nuts_large, "
                             "zero, parallel_axes, multihost and elastic only; slice14: "
                             "device, build and fed only; slice15: device, build, ppl and "
                             "ppl_zero only; slice16: device, build and linalg only; "
                             "slice17: device, build and bridge only")
    parser.add_argument("--multichain-seeds", default=",".join(map(str, MULTICHAIN_SEEDS)),
                        type=lambda v: tuple(int(x) for x in v.split(",")),
                        help="comma-separated seeds of the multichain phase's NUTS runs, "
                             "each gated (default: %(default)s); each seed after the first "
                             "adds 30 s to the phase's expected seconds")
    parser.add_argument("--profiler-window", type=int, metavar="READINGS",
                        help="instead of the phases, count how often the profiler leaves "
                             "a kernel out of READINGS readings, padded and not")
    args = parser.parse_args()
    PHASE_EXPECTED_S["multichain"] += 30 * (len(args.multichain_seeds) - 1)
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "pytensor_federated_torch").is_dir():
        print(f"chip_smoke: no pytensor_federated_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.profiler_window:
        emit(profiler_window(args.profiler_window))
        return 0
    subreaper = _become_subreaper()

    # The dense mass matrix's matvecs (nuts_large) are the port's only
    # float32 matmuls: full float32, TF32 held off for matmuls and cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    part, bw, flops = _peak(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count(),
          "peak": {"part": part, "bytes_per_s": bw, "f32_flop_per_s": flops},
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})

    from pytensor_federated_torch.ops import _build

    t0 = time.perf_counter()
    with _Deadline("build", _deadline_s("build")):
        build_s = _build.build_all()
    timing = {"build": {"phase_s": time.perf_counter() - t0, "deadline_s": _deadline_s("build")}}
    emit({"phase": "build", "seconds": build_s, "wall_s": time.perf_counter() - t0,
          "deadline_s": _deadline_s("build"),
          "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                    for k, v in _build.build_logs.items()}})

    phases = [
        ("kernels", lambda: phase_kernels(bw, flops)),
        ("autograd", phase_autograd),
        ("nuts", lambda: phase_nuts("nuts", FLAGSHIP[1], *NUTS_FLAGSHIP,
                                    dense_mass=False)),
        ("nuts_large",
         lambda: phase_nuts("nuts_large", LARGE_PATH[1], *NUTS_LARGE, dense_mass=True)),
        ("federated", lambda: phase_federated(lines.get("nuts", {}))),
        ("pool", lambda: phase_pool(lines.get("federated", {}))),
        ("gateway", phase_gateway),
        ("radon", phase_radon),
        ("logistic", phase_logistic),
        ("lv_ode", phase_lv_ode),
        ("wide_logistic", phase_wide_logistic),
        ("chees", lambda: phase_chees(lines.get("logistic", {}).get("nuts", {}))),
        ("lgssm", phase_lgssm),
        ("gp", phase_gp),
        ("tempering", phase_tempering),
        ("families", phase_families),
        ("model_check", phase_model_check),
        ("vi", lambda: phase_vi(lines.get("nuts", {}))),
        ("particles", lambda: phase_particles(lines.get("nuts", {}))),
        ("sgld", lambda: phase_sgld(lines.get("nuts", {}))),
        ("sbc", phase_sbc),
        ("checkpoint", phase_checkpoint),
        ("demos", phase_demos),
        ("optim", phase_optim),
        ("mesh", lambda: phase_mesh(lines.get("nuts_large", {}))),
        ("multichain", lambda: phase_multichain(lines.get("nuts_large", {}),
                                                 seeds=args.multichain_seeds)),
        ("seq", phase_seq),
        ("zero", phase_zero),
        ("parallel_axes", phase_parallel_axes),
        ("multihost", phase_multihost),
        ("elastic", phase_elastic),
        ("fed", phase_fed),
        ("ppl", phase_ppl),
        ("ppl_zero", phase_ppl_zero),
        ("linalg", phase_linalg),
        ("bridge", phase_bridge),
    ]
    if args.only == "kernels":
        phases = phases[:1]
    elif args.only == "federated":
        phases = [ph for ph in phases if ph[0] in ("nuts", "federated")]
    elif args.only == "models":
        phases = [ph for ph in phases if ph[0] in ("radon", "logistic", "lv_ode")]
    elif args.only == "samplers":
        phases = [ph for ph in phases
                  if ph[0] in ("nuts", "wide_logistic", "logistic", "chees")]
    elif args.only == "slice6":
        phases = [ph for ph in phases if ph[0] in ("lgssm", "gp", "tempering")]
    elif args.only == "slice7":
        phases = [ph for ph in phases if ph[0] in ("families", "model_check")]
    elif args.only == "slice8":
        phases = [ph for ph in phases if ph[0] in ("nuts", "federated", "pool")]
    elif args.only == "slice9":
        phases = [ph for ph in phases if ph[0] == "gateway"]
    elif args.only == "slice10":
        phases = [ph for ph in phases if ph[0] in ("nuts",) + SLICE10]
    elif args.only == "slice11":
        phases = [ph for ph in phases if ph[0] in ("nuts_large", "optim", "mesh")]
    elif args.only == "slice12":
        phases = [ph for ph in phases if ph[0] in ("nuts_large", "multichain", "seq")]
    elif args.only == "slice13":
        phases = [ph for ph in phases if ph[0] in ("nuts_large",) + SLICE13]
    elif args.only == "slice14":
        phases = [ph for ph in phases if ph[0] in SLICE14]
    elif args.only == "slice15":
        phases = [ph for ph in phases if ph[0] in SLICE15]
    elif args.only == "slice16":
        phases = [ph for ph in phases if ph[0] in SLICE16]
    elif args.only == "slice17":
        phases = [ph for ph in phases if ph[0] in SLICE17]
    all_ok, lines = True, {}
    for pname, fn in phases:
        t0 = time.perf_counter()
        deadline = _deadline_s(pname)
        with _Deadline(pname, deadline):
            try:
                ok, line = fn()
            except Exception:
                traceback.print_exc()
                ok, line = False, {"phase": pname, "error": traceback.format_exc(limit=3)}
            # Nothing a phase started may outlive it: a process left
            # behind is reaped here and fails the phase; the transports'
            # cached event loop is closed with its executor threads.
            line["executor_threads_joined"] = _close_thread_loop()
            threads = [t.name for t in threading.enumerate()
                       if not t.daemon and t is not threading.main_thread()]
            if threads:
                line["non_daemon_threads"] = threads
            left = _live_descendants()
            if left:
                line["processes_left"] = left
                line["processes_killed"] = _reap(left)
                ok = False
        line["phase_s"] = time.perf_counter() - t0
        line["deadline_s"] = deadline
        line["ok"] = ok
        emit(line)
        lines[pname] = line
        timing[pname] = {"phase_s": line["phase_s"], "deadline_s": deadline}
        all_ok &= ok
    left = _leftovers()
    clean = not any(left.values())
    emit({"phase": "leftovers", "ok": clean, "subreaper": subreaper, **left})
    all_ok &= clean
    emit({"timing": {"phases": timing, "total_s": time.perf_counter() - t_script}})
    _stop_helpers()
    if args.only:
        if not all_ok:
            print("chip_smoke: a phase failed: " + json.dumps(
                [p for p, line in lines.items() if not line.get("ok")]), file=sys.stderr)
        return 0 if all_ok else 1

    large = next(
        (r for r in lines["kernels"].get("shapes", []) if r["shape"] == list(LARGE_PATH)), {}
    )
    emit({"kernels": [{
        "name": "linreg_reductions",
        "route": "cuda",
        "source": "pytensor_federated_torch/ops/csrc/linreg_reductions.cu",
        "replaces": "pytensor_federated_tpu/ops/pallas_kernels.py:78",
        # Counted from zero just before each NUTS phase, read just after
        # (in the federated phase, by the four node processes; in the pool
        # phase, by the eight nodes, over its NUTS run and its windows; in
        # the gateway phase, by its nodes over the gateway's traffic; in
        # the slice-10 phases, over their fits and runs, the checks
        # against float64 excluded; in the optim phase, by the owner
        # nodes over both sharded runs, the driver-centric control
        # excluded; in the nuts, nuts_large and multichain phases, whose
        # NUTS runs replay a CUDA graph, the graph's launches per
        # replay times the replays plus the graph's eager warm-up calls;
        # in the zero phase over the whole flagship case, the gate
        # evaluations, the sharded loops and the replicated loops they
        # are held against; in the multihost phase by rank 0 to the end
        # of its work and by rank 1 through its timed evaluations, its
        # work loop until the SIGKILL not read; in the elastic phase over
        # its three runs; in the fed phase over the mesh lane's gate and
        # timed evaluations, FederatedLogpGrad's and FederatedLogp's; the
        # ppl and ppl_zero phases count theirs, 0: the kernel is not on
        # the ppl model's path; so does linalg, 0: the block stores and
        # the fed ops compute outside the kernel, as in the JAX package;
        # in the bridge phase over all of its lanes: demo_pymc's checks,
        # MAP and NUTS, the data term, the rewrite and the fed lane).
        "launches": sum(lines[p].get("kernel_launches", 0)
                        for p in ("nuts", "nuts_large", "pool", "gateway", "optim", "multichain")
                        + SLICE10 + SLICE13 + SLICE14 + SLICE15 + SLICE16 + SLICE17)
                    + lines["federated"].get("nuts", {}).get("kernel_launches", 0),
        "cuda_launches_per_call": lines["kernels"].get("cuda_launches_per_call"),
        "shape": list(LARGE_PATH),
        "max_abs_err": large.get("max_abs_err"),
        "ms": large.get("ms"),
        "device_ms": large.get("device_ms"),
        "plain_ms": large.get("plain_ms"),
        "bound_ms": large.get("bound_ms"),
        "bound_by": large.get("bound_by"),
        "library_ms": None,
        # The chain axis: one launch for C parameter sets, at 8 x 131,072.
        "chain_batched": [
            {k: r.get(k) for k in ("chains", "ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "max_abs_err", "cuda_launches_per_call")}
            for r in lines["kernels"].get("chains", []) if r["shape"] == list(LARGE_PATH)
        ],
        # The largest chain batch of the slice-10 phases, at 8 x 64.
        "chain_batched_flagship": [
            {k: r.get(k) for k in ("chains", "ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "max_abs_err", "cuda_launches_per_call")}
            for r in lines["kernels"].get("chains", [])
            if r["shape"] == list(FLAGSHIP) and r["chains"] in SLICE10_LARGEST_C
        ],
    }]})
    if not all_ok:
        failed = {p: sorted(g for g, v in line.get("gates", {}).items() if not v)
                  for p, line in lines.items() if not line.get("ok")}
        print(f"chip_smoke: a phase failed: {json.dumps(failed)}"
              f"{'' if clean else ' (and the leftovers check)'}", file=sys.stderr)
        return 1
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
