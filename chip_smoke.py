#!/usr/bin/env python3
"""Build and drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit, no result line):

1. device: CUDA must be present; prints the card's name and power limit
   and turns TF32 off for float32 products;
2. build: compiles every kernel source of the port from ``csrc/`` with
   ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started together,
   and logs each source's build seconds, ptxas's registers and spills per
   kernel and its wgmma performance notes (C75xx: a product made
   synchronous), and the SSD kernel's Hopper design per instantiation
   with the shared memory it asks for, failing on a spill or a note there
   or on a layout other than ``ssd_chunk.hopper_layout``'s;
3. the flash kernel against its plain version, on the card: the serving
   path's prefill shape and the kernel test matrix (MHA, GQA 4:1, ragged
   MQA, D = 128, windows, non-causal, an empty-row case), the head dims
   16, 48, 80, 96 and 112 (zamba2-7b's), the slot lane's admission (q 1 ×
   512) and prefix-replay prefills (1 × 512 + e, e = 1, 17, 63), and the
   edges of the bf16 route's tiles (128 query rows, or 64 where 128-row
   tiles would be fewer than the SMs; 128 keys; 64-column panels): S a
   multiple of 64 but not of 128, ragged Sk below one tile (1, 33), H/KV 7
   on 128-row tiles, windows ending inside a tile, q tiles that visit no
   key tile, q_offsets off the tiles, a BSHD view with a size-1 batch; in
   f32 (CUDA-core route) and bf16 (tensor-core route: wgmma on TMA-fed
   tiles) at the kernel suite's tolerances, every output finite; then at
   every shape of PERF.md's flash row (the main path, D 112 and 128, the
   audio and vlm shapes, the model-2 ranks', the batch-1 admissions', the
   sequence-parallel ranks' q_offset shapes) the kernel and
   ``scaled_dot_product_attention`` (a yardstick only: the port never
   calls it) are timed on the device (CUDA graph replay,
   :func:`device_ms`) beside the bound, with the plain version at the
   main path and D 112, and the kernel's eager calls and the host time of
   its three TMA tensor-map encodes at the main path;
4. the serving main path at full width: ``run(ExperimentSpec(objective=
   ServeJob(arch="qwen2-0.5b", reduced=False, batch=4, prompt_len=1024,
   ...)))`` with the flash kernel on, which must launch it once per layer
   and hand it bf16 q/k/v (its tensor-core route); then prefill again on the
   same params with and without the kernel, whose last-token logits must
   agree to bf16 tolerance;
5. the six update kernels against their plain versions, on the card:
   sizes 1, 127, 128·256, 128·256 + 1, 1,000,003 and the 14 leaf sizes of
   qwen2-0.5b, f32 and bf16 params, count 1 and 7, weight decay 0 and 0.1,
   at the tolerances of ``tests/test_kernels.py``, with gbuf′ equal to g
   bit for bit, and each case again at run flag 0 (the guard rails' skip)
   on NaN g, where every operand must keep its bits; then over one
   round's 14 leaves the kernels, their plain
   versions and a yardstick the port never calls (``torch._foreach_add_``,
   ``torch.optim.SGD(momentum=0.9, fused=True)``,
   ``torch.optim.Adam(fused=True)``) are timed with CUDA events;
6. the training main path at full width: ``run(ExperimentSpec(objective=
   TrainJob(arch="qwen2-0.5b", reduced=False, global_batch=8, seq_len=512,
   update_impl="pallas"), n_workers=4, T=8, runtime="scan",
   rounds_per_launch=4, ...))``, which must launch ``fused_adam_delayed``
   8 × 14 times, give finite curves, and match the loss curve of the same
   spec under ``update_impl="reference"`` to rtol 5e-3; then a warm timed
   run of the same spec;
7. the other three update kernels' paths, at full width and 2 layers, T 2:
   sgd delayed (``async_update``), sgd synchronous (``sgd_step``) and adam
   synchronous (``fused_adam``), each launching its kernel rounds × 14 times;
8. the two heavy-ball paths at the same size: ``AsyncTrainer`` with
   ``OptConfig(name="sgd", momentum=0.9, clip_norm=1.0,
   update_impl="pallas")`` driven by the plan executor at delay 1
   (``sgd_momentum_delayed``) and delay 0 (``sgd_momentum_step``), each
   launching its kernel rounds × 14 times, with a loss curve within 5e-3 of
   ``update_impl="reference"`` (``TrainJob`` has no momentum field);
9. the SSD chunk kernel against its plain version, on the card: the case
   matrix of ``tests/test_kernels.py``, the serving shape of mamba2-370m
   (x (4, 8, 128, 32, 64), B/C (4, 8, 128, 128)), the edges of the bf16
   route's tiles (one cell, H = 6, c 32 and 128 with N = 64, c 16 with
   N = 128), the reduced configs' chunk, the model-2 and model-4 ranks'
   and batch-1 admissions' shapes, zamba2-7b's, and a layout no tensor
   map describes (P 20, N 10: the mma.sync design), f32 (CUDA-core route)
   and bf16 (tensor-core route: the Hopper design), at that file's
   tolerances (1e-3, 4e-2); at the serving shape the kernel and its plain
   version are timed on the device as in phase 3 (no single PyTorch call
   computes this function); then every SSD shape the paths launch
   (``SSD_TIMED``) in bf16: the Hopper design's device time against the
   mma.sync design's on the same inputs, the bound and the share, a
   table (``timed_shapes`` in the kernels line; the earlier recorded
   time beside each row in the log only);
10. the SSM serving main path at full width: ``run(ExperimentSpec(
    objective=ServeJob(arch="mamba2-370m", reduced=False, batch=4,
    prompt_len=1024, arch_overrides=(("use_ssd_kernel", True),)),
    T=32))``, which must launch the SSD kernel once per layer (48) and
    hand it bf16 x, B and C (its tensor-core route), every launch on the
    Hopper design (as on phases 12, 17, 22 and 23: no SSD launch on a path
    takes the mma.sync design; bf16 ones take the Hopper design, the f32
    depth gates the CUDA cores); then prefill again on
    the same params: through the kernel and through its plain version in
    the same branch, whose last-token logits must agree to bf16 tolerance;
    the gap to the einsum branch (``use_ssd_kernel=False``),
    gated at 2 layers as the JAX suite gates it and reported at 48; warm
    prefill and decode times;
11. the guards: the flash and SSD kernels' CUDA routes raise for an input
    that requires grad, where they would otherwise drop the gradient;
12. the slot lane (continuous batching), at full width in bf16:
    ``run(ExperimentSpec(objective=ServeJob(n_slots=8, ...)))`` on
    qwen2-0.5b (32 requests, prompts of 512, T = 64, ``poisson:gap=2``
    arrivals, ``pure`` admission, 8 decode steps per captured chunk; flash
    on) and mamba2-370m (16 requests, T = 32; the SSD kernel on): every
    request served once with T tokens in the vocabulary, the prefill kernel
    launched requests × layers times on its tensor-core route, one tap row
    per decode step; then the same serve on one ``SlotServer`` (its tokens
    equal ``run``'s), timed warm (wall, tokens/s, the chunk replays' device
    time per decode step from CUDA events, host waits per chunk, occupancy,
    mean TTFT, peak memory), once under ``torch.profiler`` (the device
    idle share over the serve), qwen2-0.5b again with ``fedbuff:b=2``
    admission on the same server (one chunk capture after every serve),
    and with ``capture=False``, whose tokens must equal the graph route's
    bit for bit; then the slot lane against the lock-step lane through
    ``run`` at full width and 2 layers in f32 with TF32 off, 4 requests in
    4 slots: equal token matrices (a difference fails, naming the first
    diverging (request, step)); prints a ``{"slot_lane": [...], ...}``
    line;
13. the theory tier (no kernel of its own: its steps are torch ops replayed
    as CUDA graph chunks): the paper's Fig. 1 cell — the w7a stand-in
    (n = 10, m = 2505, d = 300), ``LogRegProblem(lam=0.1)``, the paper's
    7-γ grid, T = 3000 — through ``run(ExperimentSpec(...))`` for
    ``pure``, ``random`` and ``shuffled`` under ``fixed:slow=8`` and
    ``poisson:slow=8``, each with one host sync and finite grad norms; the
    chosen γ's trajectory bit-identical to a solo ``replay``, and the graph
    route bit-identical to the eager loop (``capture=False``) at T = 3000;
    the card against ``device="cpu"`` at T = 300 for the full-gradient and
    the stochastic lane (shared mini-batch table), x and grad norms within
    rtol 1e-4 / atol 1e-6; the Fig. 2 stochastic cell (Syn(1, 1), m = 200,
    batch 20, ``poisson:slow=8``, T = 3000) for the three schedulers; one
    scenario world (``straggler:k=2,factor=8,every=16,span=4``), whose
    schedule equals a separate host realisation bit for bit; it prints a
    ``{"theory_tier": [...]}`` line and the paper's ordering (shuffled ≤
    1.5 × random, random ≤ pure; reported, not gated);
14. durability, at full width on the slot lane's cells and the training
    main path, every kernel count set to 0 before each path and read after
    it (each must have launched), snapshots under ``build/`` removed
    however the phase ends: on qwen2-0.5b, retry armed on a clean world
    (tokens bit-identical to the unarmed serve); a chaos run (``CHAOS``:
    rid 1 poisoned every step from 3, rid 5 at step 40, a driver
    preemption at 96; two attempts, a drop-oldest queue of 16, snapshots
    every 16 steps) resumed once from the newest snapshot, every request in
    exactly one bucket and rid 5 completing its row through prefix replay;
    crash-resume: preempted at 96, resumed on a fresh ``SlotServer`` (a new
    capture), tokens and TTFT bit-identical to the uninterrupted serve;
    ``drain_after=64``: the queued requests drained, the rest finished; on
    mamba2-370m, crash-resume at 32 likewise, shedding, a poison without
    retry (a terminal eviction) and the prefix replay refused (its length
    is not a multiple of the SSD chunk); the training main path at 6 of
    its 24 layers through the plan executor with
    ``AsyncSnapshotter(every=4, keep=2)``: the
    snapshotted run bit-identical to a plain one, then restored at round 4
    and resumed, bit-identical again (a difference names the first leaf);
    prints a ``{"durability": ...}`` line with the card, snapshot bytes,
    host ms per offer, finalise seconds and ms per round with and without
    snapshots;
15. scenario worlds and guard rails on the training main path at full
    width and depth: the main path's spec with ``guards=True``, T = 16 and
    ``FAULT_SCENARIO`` (elastic availability, a drifting data law,
    sparsified grads at density 0.5, NaN receipts), every kernel count set
    to 0 before it: ``fused_adam_delayed`` launched 16 × 14 times (a
    skipped round launches at run flag 0), ``skipped`` 1 exactly on the
    rounds whose participants the plan poisons, the health vector and
    every round's gscale equal to a numpy replay of JAX's rule, finite
    params, scan ≡ eager bit for bit, the loss curve within 5e-3 of
    ``update_impl="reference"``, the unguarded spec ending with non-finite
    params, the first skipped round run eagerly leaving params, m, v, gbuf
    and count bit-identical, and a traced run bit-identical to the
    untraced one, its trace valid under the port's schema with one
    ``guard_skip`` instant per skipped round; the sparsifier timed over
    the 14 leaves; then one traced serve on the qwen2-0.5b slot cell:
    tokens equal to the untraced serve's, one ``admit`` span per
    admission, one chunk capture; prints a ``{"faults": ...}`` line;
16. the trainer's lanes, at full width on qwen2-0.5b, every kernel count
    set to 0 before each path and read after it: the six update kernels
    against their plain versions at the pool shapes their paths give them
    (``fused_adam_delayed`` over the main path's one bf16 pool of
    494,032,768 elements, the other five over their paths' 2-layer pool)
    and timed as one launch over the main path's pool; the grad pooling's
    device time; (a) the main path with ``update_impl="pallas_pooled"``:
    ``fused_adam_delayed`` launched exactly 8 times (one pool × 8 rounds),
    the curve within 5e-3 of the reference, its distance to the per-leaf
    curve, finite params, warm ms per round, and a run snapshotted at
    round 4, restored and resumed bit for bit; (b) the other five kernels
    through pools at 2 layers, T 2 (one launch per round, curves within
    5e-3 of their per-leaf routes); (c) phase 15's scenario cell on the
    pooled route at 2 layers (16 launches, a skipped round leaving every
    pool and the count bit-identical); (d) ``metrics="tap"`` rows bit-equal
    to ``"chunk"``'s with no host sync and ms per round against chunk, then
    ``DivergenceBreaker(window=3, factor=5)`` on
    ``corrupt_receipt:k=3,scale=1e4,every=4,span=2`` (unguarded, T 16, K 4)
    tripping, the curve whole chunks past the trip; (e) the grid lane
    (γ ∈ {1e-4, 3e-4, 1e-3}, T 4, K 2): every point's curve and final
    state bit-identical to its solo run, seconds against the three solo
    runs, and ``run`` taking the lane; (f) ``remat="full"``: the curve
    within 1e-6 relative of ``remat="none"``'s and a lower peak memory;
    prints a ``{"trainer_lanes": ...}`` line;
17. the hybrid (zamba2-7b) and MoE (deepseek-moe-16b) families at full
    width, bf16, both kernel switches on, after the earlier phases'
    memory is freed: flash at each family's prefill shape ((4, 1024, 32,
    112) and (4, 1024, 16, 128)) and SSD at zamba2-7b's (x (4, 8, 128,
    112, 64), N 64) against their plain versions in f32 and bf16, timed
    (kernel, plain, bound, SDPA as a yardstick); per arch,
    ``run(ServeJob(arch, reduced=False, batch=4, prompt_len=1024))`` with
    T 16 (one flash launch per attention block: 13 insertions on
    zamba2-7b, 28 layers on deepseek-moe-16b; one SSD launch per Mamba2
    layer: 81; on the tensor-core routes; finite logits, 16 tokens a row)
    and the slot lane through ``run(ServeJob(n_slots=8))`` (12 requests
    of 512, T 16, ``poisson:gap=2``, K 8: 12 × those launches, one chunk
    capture), then on params built once (``init_params`` host seconds):
    a warm prefill and 8 lock-step decode steps under the profiler, the
    prefill at full width and reduced depth with the kernels against
    their plain versions in the same branches and against both switches
    off: gated in f32 at 9 layers (one insertion and a 3-layer tail) and
    4 (2e-4), and on zamba2-7b in bf16 against the plain versions at 2
    layers (an insertion before each; 3e-2); the other bf16 comparisons
    reported (an ulp of difference moves the MoE's routing), one slot
    server's two serves (tokens equal to ``run``'s), a
    profiled serve and the eager route (bit for bit); on zamba2-7b the
    slot lane ≡ the lock-step lane through ``run`` at 9 layers in f32;
    prints a ``{"families": ...}`` line;
18. the ssm, hybrid, MoE, audio and vlm families trained and the audio
    and vlm families served at the model level, after phase 17's memory
    is freed: flash at the new shapes (seamless-m4t-large-v2's encoder
    (4, 1024, 16, 64) non-causal, its cross-attention 256 × 1024
    non-causal, its decoder 256 × 256 causal; pixtral-12b's (4, 1024, 32
    heads, 8 kv heads, 128) causal) against its plain version in f32 and
    bf16 and timed (kernel, plain, bound, SDPA as a yardstick); each of
    mamba2-370m (12 of its 48 layers), zamba2-7b (7 layers: one group and
    a one-layer tail),
    deepseek-moe-16b (4 layers), seamless-m4t-large-v2 and pixtral-12b
    (4 layers) at full width on the training main path's settings with
    ``update_impl="pallas_pooled"`` (8 × 512 tokens, audio frames 8 ×
    512 and tokens 8 × 128): ``fused_adam_delayed`` launched once per
    dtype pool a round, finite curves, warm ms a round and peak memory,
    the eager runtime bit-identical to scan, the update kernel over the
    run's bf16 pool held to its plain version at both ends and timed, a
    profiled chunk (device ms, idle share, the update's ms), and the
    pooled curve within 5e-3 of ``update_impl="reference"`` at 2 layers;
    seamless-m4t-large-v2 and pixtral-12b at full width and depth in bf16
    with flash on through ``prefill`` (4 × 1024 frames and 256 tokens; 4 ×
    1024 tokens with 256 patches) and ``Server.generate`` for 16 steps:
    72 and 40 flash launches a prefill on the tensor-core route, a second
    run's greedy tokens equal, warm and profiled times, the prefill with
    the kernel against its plain version in f32 at 4 layers (the phase-3
    tolerance) and in bf16 at 2 (3e-2), and ``run(ServeJob)`` refused;
    prints a ``{"new_families": ...}`` line;
19. the launch tier, after phase 18's memory is freed: four steps of the
    main paths, each built by ``launch/dryrun.py``'s ``build_step`` —
    qwen2-0.5b's training round (8 × 512, 4 workers, Adam, delay 1,
    ``pallas_pooled``, one eager step), its prefill (4 × 1024, flash on)
    and one decode step (ctx 1024, batch 4), and mamba2-370m's prefill (4
    × 1024, the SSD kernel on) — traced on ``meta`` by ``dryrun.run_one``
    and run on the card under the same ``launch/op_cost.py`` tally: (a)
    the two tallies' dot flops and bytes equal exactly; (b) the estimated
    peak within 15 % of ``torch.cuda.max_memory_allocated`` over the step
    (from the memory allocated before its inputs were made); (c) the warm
    step's time (CUDA events) at least its roofline bound, max(dot flops
    at the bf16 peak, bytes at the HBM rate); (d) each kernel launched
    (``fused_adam_delayed`` once per pool, flash once per layer, SSD once
    per layer) tallied once per launch with its formula; prints each
    step's counts, peaks, time, bound and share (bound / time) and a
    ``{"launch_tier": ...}`` line;
20. data-parallel training over ``torch.distributed``, after phase 19's
    memory is freed: (a) the pooled training main path (qwen2-0.5b at
    full width and depth, 8 × 512, 4 workers, Adam, delay 1, T 8) through
    ``TrainerBackend(mesh=...)`` on a NCCL process group of one rank in
    this process (``launch.mesh.init_process_group``: a file store), on
    the params of the no-mesh trainer's run beside it: ``fused_adam_
    delayed`` launched 8 times in each, curves and final state bit for
    bit, each round's collectives (launches and operand bytes) equal to
    the hand count, warm ms a round both ways, and a sparsified round
    (``grad_density`` 0.5) timed both ways; (b) what a 2-rank round
    gives the card, in this process: the main path's pool in the layout
    of 2 shards, ``fused_adam_delayed`` on each rank's rows (``p`` a row
    view of the whole pool) against its plain version and timed, and the
    copy that views a 2-shard pool's params (``unpool_tree``) timed; (c)
    the per-leaf routes' ZeRO blocks: for R = 2 and 4 data ranks, each
    rank's blocks of qwen2-0.5b's 14 leaves at full width
    (``NamedSharding.local(t, rank=r)`` under ``tree_shardings(...,
    Mesh({"data": R, "model": 1}), zero=True)``, each made contiguous),
    ``fused_adam_delayed`` on every block with the whole tree's scalars
    (the clip scale from the whole buffer's norm): each output block equal
    bit for bit to the same block of the whole-leaf kernel's outputs and
    within tolerance of its plain version, 14 launches a rank (counted
    from 0 around the rank's blocks), and a rank's 14 launches timed as
    device time against their bytes bound, with its plain version and
    the library yardstick.  Two ranks on the one card are not run: NCCL
    refuses two ranks on one device, and gloo's all-gather of CUDA
    tensors ends the process with SIGSEGV on the card's torch 2.11
    (PERF.md); R ≥ 2 is held on the CPU (``tests/test_torch_dp_*.py``,
    ``tests/test_torch_zero_*.py``) and on four cards (``measure_tp.sh
    OUT zero``).  Prints a ``{"data_parallel": ...}`` line;
21. tensor parallelism over the model axis, after phase 20's memory is
    freed, on the one card (two ranks cannot share it, as in phase 20):
    the ranks run as threads of this process (``models.tp.ThreadRanks``),
    each driving the port's own entry points (``forward_logits``,
    ``prefill``, ``decode_step``) on its blocks of every leaf
    (``NamedSharding.local``) under its own ``TP``, whose operators
    combine the ranks' tensors where the collectives would (a sum, a
    max, a concatenation): (a) qwen2-0.5b at full width, 12 of its 24
    layers, at model 2 (head-parallel, flash on 7 heads a rank) and at
    model 4 (its 14 heads do not divide: attention gathered, the ring
    split on ctx and decoded by the distributed softmax), and (b)
    deepseek-moe-16b at full width, 4 of its 28 layers, at model 2 (32
    experts a rank): the logits of 4 × 1024 tokens in f32 within 1e-4
    relative L2 of the unsharded model's on every rank (flash launched
    model × layers times), in bf16 at 2 layers within 3e-2, and each
    rank's first token and 8 greedy decode steps equal to the unsharded
    ``Server``'s; (c) flash at the ranks' local shapes ((4, 1024, 7, 64)
    on (4, 1024, 1, 64), GQA 7; (4, 1024, 8, 128) MHA) against its plain
    version in f32 and bf16, timed with its bound and SDPA as a
    yardstick; (d) ``fused_adam_delayed`` on rank 0's block of each of
    qwen2-0.5b's 14 leaves (the per-leaf route at model 2) against its
    plain version, its launches counted (one a block), timed against its
    bytes bound; prints a ``{"tensor_parallel": ...}`` line;
22. the model axis for the ssm, hybrid, audio and vlm families, as phase
    21 (the ranks as threads through the entry points, the SSD and flash
    kernels on each rank's heads): mamba2-370m at full width, 12 of its
    48 layers, at model 2 and 4 (16 / 8 SSM heads a rank), zamba2-7b at
    full width, 9 of its 81 layers (a group of six and a three-layer tail), at
    model 2, seamless-m4t-large-v2 (4 encoder and 4 decoder layers) and
    pixtral-12b (4 layers) at full width at model 2, on 4 × 1024 inputs
    (frames, patches): the f32 logits within 1e-4 relative L2 of the
    unsharded model's on every rank, SSD and flash launched model ×
    their layers times (counted from 0 around the split), bf16 at 2
    layers within 3e-2, each rank's 9 greedy tokens of prefill and
    decode equal to the unsharded ``Server``'s; then SSD at the ranks'
    local shapes ((4, 8, 128, 16, 64) N 128, (4, 8, 128, 56, 64) N 64)
    and flash at theirs ((4, 1024, 16, 112), (4, 1024, 8, 64) non-causal,
    (4, 1024, 16 / 4, 128)) against their plain versions, timed with
    their bounds and (flash) SDPA; prints a ``{"tensor_parallel_families":
    ...}`` line;
23. the slot lane over the model axis on one card, the ranks as threads
    (as phases 21–22): each rank drives the slot lane's own ``_Lanes``
    (the admission write, the ragged step with its masks and tap rows) on
    its blocks, each admission a batch-1 ``prefill`` on the rank's heads
    and each decode step a ragged ``decode_step`` with ``tp=``, under the
    ``SlotServer``'s admission rule: 8 slots, 6 requests of 512-token
    prompts arriving in pairs a chunk apart, 12 tokens each, K 8, f32 at
    full width: qwen2-0.5b at model 2 and 4 (6 layers; at 4 its
    ragged ring split on ctx), mamba2-370m (12 layers), zamba2-7b (9
    layers) and deepseek-moe-16b (4 layers) at model 2.  Every request's greedy tokens
    on every rank equal the unsharded ``SlotServer``'s on the card, each
    decode step's logits are within 2e-5 relative L2 of the whole model's
    lane, and flash and SSD are launched on the ranks' heads requests ×
    ranks × layers times (counted from 0 around the ranks' run); then
    flash and SSD at the admissions' batch-1 shapes on a rank against
    their plain versions, timed with their bounds and (flash) SDPA;
    prints a ``{"tensor_parallel_slots": ...}`` line;
24. sequence parallelism over the model axis on one card, the ranks as
    threads under ``SEQ_PARALLEL_RULES``: qwen2-0.5b at full width and
    depth at model 4, each rank holding 256 of a 4 × 1024 batch's rows
    between blocks: (a) ``loss_fn`` and its grads, with autograd on over
    the threads (``ThreadRanks.run(grad=True)``: the operators' backward
    collectives run too), the f32 loss and whole gradient within 1e-4
    relative of the unsharded model's and every rank's gradient leaf
    within 1.7e-4 relative L2 of its block, bf16 at 2 layers reported;
    (b) the prefill, flash launched 96 times (4 ranks × 24 layers) on
    each rank's 256 query rows at its offset against k / v of the
    gathered sequence, f32 last-token logits within 1e-4 relative L2 of
    the unsharded prefill's and 9 greedy tokens of prefill and decode
    equal to the unsharded ``Server``'s on every rank, bf16 reported;
    (c) flash at ``q_offset`` > 0 on the last rank's rows at the
    prefill's shape ((4, 256, 14, 64) against (4, 1024, 2, 64)) and at
    prefill_32k's on a rank of ``32x8`` ((1, 4096, 14, 64) against (1,
    32768, 2, 64)), f32 and bf16, against its plain version and the same
    rows of a whole-sequence launch, timed with its bound and SDPA with
    the rows' explicit mask; prints a ``{"sequence_parallel": ...}``
    line, and a ``{"phase_seconds": ...}`` line with every phase's wall
    seconds;
25. prints a ``{"kernels": [...]}`` line (each update kernel's
    ``launches`` from its pooled path; flash's and SSD's launches on
    phase 17's and 18's paths and ``fused_adam_delayed``'s on phase 18's
    under ``family_launches``; flash's times at phase 18's shapes under
    ``family_shapes``, ``fused_adam_delayed``'s over phase 18's pools
    under ``family_pools``, phase 20's launches and row times under
    ``data_parallel``, phases 21's, 22's and 23's launches,
    local-shape times and block times under ``tensor_parallel`` and phase
    24's launches and offset-shape times under ``seq_parallel``) and,
    last, the
    ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import re
import resource
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np                                            # noqa: E402
import torch                                                  # noqa: E402
import torch.nn.functional as F                               # noqa: E402

from repro_torch.api import (ExperimentSpec, ServeJob,        # noqa: E402
                             SimulatorBackend, TrainerBackend, TrainJob,
                             run)
from repro_torch.checkpoint import (AsyncSnapshotter,         # noqa: E402
                                    load_meta, restore)
from repro_torch.configs import InputShape, get_arch          # noqa: E402
from repro_torch.distributed import (AsyncConfig,             # noqa: E402
                                     AsyncTrainer, OverloadPolicy,
                                     RetryPolicy, Server, ServeConfig,
                                     ServePreempted, SlotConfig, SlotServer,
                                     draw_arrivals)
from repro_torch.faults import (DivergenceBreaker,           # noqa: E402
                                GuardConfig, ServeFaults,
                                realise_serve_faults)
from repro_torch.kernels import _build, ops                   # noqa: E402
from repro_torch.kernels import async_update as AU            # noqa: E402
from repro_torch.kernels import flash_attention as FA         # noqa: E402
from repro_torch.kernels import ssd_chunk as SSD              # noqa: E402
from repro_torch.launch import dryrun, op_cost                # noqa: E402
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,  # noqa: E402
                                     PEAK_FLOPS_F32)
from repro_torch.launch.roofline import terms as roofline_terms  # noqa: E402
from repro_torch.launch.profile_serve import (idle_share,  # noqa: E402
                                              model_batch, profiled)
from repro_torch.core import replay                            # noqa: E402
from repro_torch.models import init_params, param_specs, prefill  # noqa: E402
from repro_torch.models.model import forward_logits            # noqa: E402
from repro_torch.models.specs import (DEVICE_DRAW_MIN, Spec,  # noqa: E402
                                      materialize)
from repro_torch.objectives import (LogRegProblem,            # noqa: E402
                                    make_libsvm_like, make_synthetic)
from repro_torch.optim import (OptConfig, build_layout,       # noqa: E402
                               pool_tree)
from repro_torch.runtime import (METRICS, PlanExecutor,       # noqa: E402
                                 compile_plan, execute)
from repro_torch.scenarios import parse_scenario, realise_world  # noqa: E402
from repro_torch.tree import (tree_leaves,                     # noqa: E402
                              tree_leaves_with_path, tree_map)

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float32: PEAK_FLOPS_F32}

TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}     # tests/test_kernels.py

#: (label, B, Sq, Sk, H, KV, D, causal, window): the serving path's prefill
#: shape first (timed too), then the kernel test matrix
CASES = [
    ("main_path", 4, 1024, 1024, 14, 2, 64, True, None),
    ("mha", 1, 128, 128, 4, 4, 64, True, None),
    ("gqa4", 2, 256, 256, 8, 2, 64, True, None),
    ("ragged_mqa", 1, 96, 160, 4, 1, 32, True, None),
    ("d128", 1, 512, 512, 2, 2, 128, True, None),
    ("window16", 1, 256, 256, 4, 4, 64, True, 16),
    ("window64", 1, 256, 256, 4, 4, 64, True, 64),
    ("window1000", 1, 256, 256, 4, 4, 64, True, 1000),
    ("noncausal", 2, 128, 192, 4, 4, 64, False, None),
    ("empty_rows", 1, 128, 32, 2, 2, 32, False, 16),
    ("sq1000", 1, 1000, 1000, 2, 2, 64, True, None),
    ("gqa7", 2, 192, 192, 7, 1, 64, True, None),
    ("window100", 1, 512, 512, 4, 4, 64, True, 100),
    ("noncausal_ragged", 2, 200, 300, 4, 2, 64, False, None),
    ("empty_tiles", 1, 256, 32, 2, 2, 64, False, 16),
    ("empty_tiles_causal", 1, 512, 64, 2, 2, 64, True, 100),
    # every head dim beyond 32/64/128 that the kernel is built for
    ("d16", 1, 256, 256, 4, 2, 16, True, None),
    ("d48", 1, 256, 256, 4, 2, 48, True, 64),
    ("d80", 2, 200, 200, 4, 2, 80, True, None),
    ("d80_noncausal", 1, 130, 190, 2, 1, 80, False, None),
    ("d96", 1, 256, 256, 4, 4, 96, True, None),
    ("d112", 2, 200, 200, 4, 2, 112, True, None),
    ("d112_window", 1, 512, 512, 4, 4, 112, True, 100),
    # the slot lane's batch-1 prefill on qwen2-0.5b (one admission)
    ("slot_prefill", 1, 512, 512, 14, 2, 64, True, None),
    # a retried request's prefix replay: prompt 512 + e emitted tokens
    ("replay_e1", 1, 513, 513, 14, 2, 64, True, None),
    ("replay_e17", 1, 529, 529, 14, 2, 64, True, None),
    ("replay_e63", 1, 575, 575, 14, 2, 64, True, None),
    # the edges of the bf16 route's tiles: 128 query rows (64 where 128-row
    # tiles would be fewer than the SMs), 128 keys, 64-column panels
    ("sq192", 1, 192, 192, 4, 2, 64, True, None),
    ("sq320", 1, 320, 320, 4, 2, 64, True, None),
    ("sq320_sk192_noncausal", 2, 320, 192, 4, 2, 64, False, None),
    ("sk1", 1, 64, 1, 4, 2, 64, False, None),
    ("sk33", 1, 100, 33, 4, 2, 64, False, None),
    ("sk33_causal", 1, 33, 33, 4, 1, 64, True, None),
    ("gqa7_128_rows", 4, 640, 640, 7, 1, 64, True, None),
    ("window300_128_rows", 4, 1024, 1024, 8, 2, 64, True, 300),
    ("window200", 2, 700, 700, 8, 2, 64, True, 200),
    ("empty_tiles_128_rows", 4, 1024, 64, 14, 2, 64, False, 16),
    ("sq1", 1, 1, 40, 4, 2, 64, False, None),
    ("d80_128_rows", 4, 300, 300, 32, 8, 80, False, None),
]
#: (label, B, Sq, Sk, H, KV, D, window, q_offset): causal at a q_offset
#: that is not a multiple of the tiles (the q rows a block of a longer
#: sequence), with 64- and 128-row tiles
OFFSET_CASES = [
    ("offset77", 2, 200, 400, 4, 2, 64, None, 77),
    ("offset333_128_rows", 4, 384, 1024, 14, 2, 64, None, 333),
    ("offset333_window150_d112", 4, 384, 1024, 14, 2, 112, 150, 333),
]
#: the shapes of PERF.md's flash row, bf16, each timed against SDPA and
#: its bound: (label, B, Sq, Sk, H, KV, D, causal, q_offset); the serving
#: path's prefill first (the kernels line), zamba2-7b's D = 112 second
FLASH_TIMED = [
    ("main_path", 4, 1024, 1024, 14, 2, 64, True, 0),
    ("d112_zamba2", 4, 1024, 1024, 32, 32, 112, True, 0),
    ("d128_deepseek", 4, 1024, 1024, 16, 16, 128, True, 0),
    ("seamless_encoder", 4, 1024, 1024, 16, 16, 64, False, 0),
    ("seamless_cross", 4, 256, 1024, 16, 16, 64, False, 0),
    ("seamless_decoder", 4, 256, 256, 16, 16, 64, True, 0),
    ("pixtral", 4, 1024, 1024, 32, 8, 128, True, 0),
    ("qwen2_model2", 4, 1024, 1024, 7, 1, 64, True, 0),
    ("deepseek_model2", 4, 1024, 1024, 8, 8, 128, True, 0),
    ("zamba2_model2", 4, 1024, 1024, 16, 16, 112, True, 0),
    ("seamless_encoder_model2", 4, 1024, 1024, 8, 8, 64, False, 0),
    ("pixtral_model2", 4, 1024, 1024, 16, 4, 128, True, 0),
    ("admission_qwen2_model2", 1, 512, 512, 7, 1, 64, True, 0),
    ("admission_qwen2", 1, 512, 512, 14, 2, 64, True, 0),
    ("admission_zamba2_model2", 1, 512, 512, 16, 16, 112, True, 0),
    ("admission_deepseek_model2", 1, 512, 512, 8, 8, 128, True, 0),
    ("offset_prefill_model4", 4, 256, 1024, 14, 2, 64, True, 768),
    ("offset_prefill_32k_model8", 1, 4096, 32768, 14, 2, 64, True, 28672),
]
SERVE = dict(arch="qwen2-0.5b", reduced=False, batch=4, prompt_len=1024,
             T=32, seed=0)

SOURCES = ("flash_attention", "async_update", "ssd_chunk")

#: update kernels: the sizes of the test matrix (the main path's 14 leaf
#: sizes are added), tolerances of tests/test_kernels.py as (rtol, atol)
UPDATE_SIZES = (1, 127, 128 * 256, 128 * 256 + 1, 1_000_003)
UPDATE_TOL = {"sgd": {torch.float32: (2e-4, 2e-4),
                      torch.bfloat16: (3e-2, 3e-2)},
              "adam": {torch.float32: (1e-5, 1e-6),
                       torch.bfloat16: (3e-2, 3e-2)}}
UPDATE_LR = {"sgd": 0.01, "adam": 1e-3}
#: the TPU kernel each update kernel replaces
REPLACES = {"async_update": "src/repro/kernels/async_update.py:71",
            "sgd_step": "src/repro/kernels/async_update.py:114",
            "sgd_momentum_step": "src/repro/kernels/async_update.py:152",
            "sgd_momentum_delayed": "src/repro/kernels/async_update.py:206",
            "fused_adam": "src/repro/kernels/async_update.py:276",
            "fused_adam_delayed": "src/repro/kernels/async_update.py:348"}
CLIP, DELAY_SCALE, MOMENTUM = 0.5, 0.25, 0.9

#: the training main path and the reduced-depth paths of the other kernels
TRAIN_JOB = dict(arch="qwen2-0.5b", reduced=False, global_batch=8,
                 seq_len=512, update_impl="pallas")
TRAIN_SPEC = dict(scheduler="pure", timing="fixed:slow=5", n_workers=4, T=8,
                  stepsize=3e-4, seed=0, runtime="scan", rounds_per_launch=4)
OTHER_PATHS = (("async_update", "sgd", 1), ("sgd_step", "sgd", 0),
               ("fused_adam", "adam", 0))
#: the heavy-ball paths: (kernel, delay_rounds)
MOMENTUM_PATHS = (("sgd_momentum_delayed", 1), ("sgd_momentum_step", 0))

#: the SSD chunk kernel: (label, B, nc, c, H, P, N), the serving shape of
#: mamba2-370m first (timed too), then the kernel test matrix; tolerances
#: of tests/test_kernels.py
SSD_CASES = [("main_path", 4, 8, 128, 32, 64, 128),
             ("c16", 1, 1, 16, 2, 32, 16), ("c64", 1, 1, 64, 4, 64, 32),
             ("g1", 1, 1, 128, 8, 64, 128), ("h6", 1, 2, 64, 6, 64, 64),
             ("c32_n64", 2, 2, 32, 8, 64, 64),
             ("c128_n64", 2, 2, 128, 8, 64, 64),
             ("c16_n128", 1, 2, 16, 4, 64, 128),
             # the slot lane's batch-1 prefill on mamba2-370m (one admission)
             ("slot_prefill", 1, 4, 128, 32, 64, 128),
             # the reduced configs' chunk, a rank's shapes at model 2 and 4,
             # the ranks' batch-1 admissions (split tiles), zamba2-7b
             ("reduced", 2, 4, 16, 16, 32, 32),
             ("tp2", 4, 8, 128, 16, 64, 128), ("tp4", 4, 8, 128, 8, 64, 128),
             ("tp2_zamba", 4, 8, 128, 56, 64, 64),
             ("admit_tp2", 1, 4, 128, 16, 64, 128),
             ("admit_tp4", 1, 4, 128, 8, 64, 128),
             ("admit_tp2_zamba", 1, 4, 128, 56, 64, 64),
             ("zamba", 4, 8, 128, 112, 64, 64),
             # a layout no tensor map describes: the mma.sync design
             ("ragged", 2, 3, 13, 3, 20, 10)]
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 4e-2}
#: every SSD shape the paths launch, timed in bf16 in phase 9: (label, B,
#: nc, c, H, P, N, the earlier time in ms that PERF.md's row 8 records, or
#: None)
SSD_TIMED = [
    ("mamba2-370m prefill", 4, 8, 128, 32, 64, 128, 0.0476),
    ("zamba2-7b prefill", 4, 8, 128, 112, 64, 64, 0.1297),
    ("mamba2-370m at model 2", 4, 8, 128, 16, 64, 128, 0.0352),
    ("mamba2-370m at model 4", 4, 8, 128, 8, 64, 128, None),
    ("zamba2-7b at model 2", 4, 8, 128, 56, 64, 64, 0.0710),
    ("admission, mamba2-370m", 1, 4, 128, 32, 64, 128, None),
    ("admission, mamba2-370m at model 2", 1, 4, 128, 16, 64, 128, 0.0341),
    ("admission, mamba2-370m at model 4", 1, 4, 128, 8, 64, 128, 0.0339),
    ("admission, zamba2-7b at model 2", 1, 4, 128, 56, 64, 64, 0.0260)]
SSM_SERVE = dict(arch="mamba2-370m", reduced=False, batch=4, prompt_len=1024,
                 T=32, seed=0)

#: the theory tier: the paper's stepsize grid (App. A.1), the Fig. 1 and
#: Fig. 2 cells, and the card-against-CPU tolerance on x and grad norms
PAPER_GRID = (0.005, 0.004, 0.003, 0.002, 0.001, 0.0005, 0.0001)
THEORY_SCHEDULERS = ("pure", "random", "shuffled")
THEORY_TIMINGS = ("fixed:slow=8", "poisson:slow=8")
THEORY_T, THEORY_CPU_T = 3000, 300
THEORY_TOL = dict(rtol=1e-4, atol=1e-6)
THEORY_SCENARIO = "straggler:k=2,factor=8,every=16,span=4"


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def _dtypes_seen(module, name):
    """Collects, while it is open, the dtypes of the tensors each call of
    ``module.<name>`` receives (as a set of tuples)."""
    fn, seen = getattr(module, name), set()

    @functools.wraps(fn)
    def recording(*args, **kw):
        seen.add(tuple(str(a.dtype)[6:] for a in args
                       if isinstance(a, torch.Tensor)))
        return fn(*args, **kw)

    setattr(module, name, recording)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed back to back and timed with CUDA events, so what the
    host spends issuing a call (a wrapper's checks, ``ctypes``) drops out.
    Kernels of tens of microseconds sit below their wrappers' host cost, so
    :func:`time_ms` over eager calls would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = time_ms(graph.replay, iters=5, warmup=1) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


def flash_bound(q, k, causal, window):
    """(bound_ms, bound_by) of one flash attention call on these inputs:
    ``op_cost.flash_cost``'s operations at the peak of q's dtype."""
    return op_cost.bound_ms(*op_cost.flash_cost(q, k, causal, window),
                            PEAK_FLOPS[q.dtype])


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on a card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return torch.cuda.get_device_name(0), card


def phase_build() -> None:
    """One nvcc per source, all started together."""
    def build(name):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(build, SOURCES)))
    log(f"build: {len(SOURCES)} sources in {time.perf_counter() - t0:.2f} s")
    for name, (lib, secs) in built.items():
        log(f"  {name}.cu in {secs:.2f} s")
        report = lib.with_suffix(".log").read_text()
        for kernel, regs, spill in _ptxas_report(report):
            log(f"  ptxas: {kernel}: {regs} registers; {spill}")
        # ptxas's "Potential Performance Loss" notes (C75xx: wgmma made
        # synchronous, waits injected)
        notes = re.findall(r"\((C75\d\d)\)", report)
        log(f"  ptxas: {len(notes)} wgmma performance notes "
            f"{sorted(set(notes))}")
        if name == "ssd_chunk":
            _ssd_hopper_report(report, notes, lib)


def _ssd_hopper_report(report, notes, lib) -> None:
    """The SSD kernel's Hopper design, one line per instantiation (c, N
    and P padded, consumer warpgroups): registers, spills and the shared
    memory the built kernel asks for; it fails on a spill, a wgmma
    performance note (a product made synchronous) or shared memory other
    than ``SSD.hopper_layout``'s."""
    query = ctypes.CDLL(str(lib)).ssd_chunk_hopper_smem
    query.restype = ctypes.c_int
    query.argtypes = [ctypes.c_int] * 4
    rows = [(tuple(map(int, re.search(r"CfgILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)",
                                      k).groups())), regs, spill)
            for k, regs, spill in _ptxas_report(report) if "ssd_hopper" in k]
    astray = []
    for (cp, np_, pp, nwg), regs, spill in rows:
        smem = query(cp, pp, np_, nwg)
        want = SSD.hopper_layout(cp, pp, np_, nwg)["total"]
        log(f"  ssd hopper c {cp} N {np_} P {pp}, {nwg} consumer "
            f"warpgroup(s): {regs} registers at entry; {spill}; {smem} "
            f"bytes of shared memory (hopper_layout {want})")
        if smem != want:
            astray.append((cp, np_, pp, nwg, smem, want))
    spilled = [r for r in rows if not r[2].startswith("0 bytes stack frame, "
                                                     "0 bytes spill stores")]
    if not rows or spilled or notes or astray:
        raise AssertionError(f"ssd hopper kernels: {len(rows)} built, spills "
                             f"{spilled}, wgmma notes {notes}, layouts other "
                             f"than hopper_layout {astray}")


def _ptxas_report(text):
    """[(kernel, registers, spill line)] from ptxas's ``-v`` report."""
    rows, kernel, spill = [], "", ""
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernel = m.group(1)
        elif "spill" in line:
            spill = line.split(":")[-1].strip()
        elif m := re.search(r"Used (\d+) registers", line):
            rows.append((kernel, int(m.group(1)), spill))
    return rows


def _compare(got, want, tol):
    """(max abs error, count of elements outside ``atol = rtol = tol``)."""
    err = (got.float() - want.float()).abs()
    bad = int((err > tol + tol * want.float().abs()).sum())
    return err.max().item(), bad


def _qkv(B, Sq, Sk, H, KV, D, dtype, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    return (torch.randn((B, Sq, H, D), generator=g, device=device).to(dtype),
            torch.randn((B, Sk, KV, D), generator=g, device=device).to(dtype),
            torch.randn((B, Sk, KV, D), generator=g, device=device).to(dtype))


def _check_flash(label, q, k, v, **kw) -> float:
    """One launch against the plain version at the kernel suite's
    tolerance; returns the max abs error."""
    got = FA.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    want = FA.flash_attention_plain(q, k, v, **kw)
    if got.dtype != q.dtype or got.shape != q.shape:
        raise AssertionError(f"{label}: got {got.dtype} {tuple(got.shape)}")
    err, bad = _compare(got, want, TOL[q.dtype])
    log(f"kernel {label} {str(q.dtype)[6:]}: max_abs_err={err:.3e} "
        f"(tol {TOL[q.dtype]:g}) bad={bad}")
    if bad or not torch.isfinite(got.float()).all():
        raise AssertionError(f"flash kernel disagrees with its plain "
                             f"version on {label} {q.dtype}")
    return err


def _flash_timed(device, label, B, Sq, Sk, H, KV, D, causal, q_offset):
    """bf16 at one shape: the kernel, SDPA (with the rows' explicit mask at
    a q_offset) and the bound, device time per call."""
    from repro_torch.kernels.ref import attention_mask

    q, k, v = _qkv(B, Sq, Sk, H, KV, D, torch.bfloat16, device)
    kw = dict(causal=causal, q_offset=q_offset)
    row = {"label": label, "shape": [B, Sq, Sk, H, KV, D], "causal": causal,
           "q_offset": q_offset,
           "ms": device_ms(lambda: FA.flash_attention_cuda(q, k, v, **kw))}
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q_offset:
        mask = attention_mask(Sq, Sk, causal, None, device, q_offset)
        row["sdpa_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=5)
    else:
        row["sdpa_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
    row["bound_ms"], row["bound_by"] = op_cost.bound_ms(
        *op_cost.flash_cost(q, k, causal, None, q_offset), PEAK_FLOPS[q.dtype])
    if label in ("main_path", "d112_zamba2"):
        row["plain_ms"] = device_ms(
            lambda: FA.flash_attention_plain(q, k, v, **kw),
            iters=5 if label == "main_path" else 2)
    log(f"flash {label} q {tuple(q.shape)} k/v {tuple(k.shape)} causal="
        f"{causal} q_offset={q_offset} bf16: device time per call: kernel "
        f"{row['ms']:.4f} ms, sdpa {row['sdpa_ms']:.4f} ms "
        f"({row['ms'] / row['sdpa_ms']:.2f}x sdpa), bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
        f"{row['bound_ms'] / row['ms']:.0%} of it)"
        + (f", plain {row['plain_ms']:.4f} ms" if "plain_ms" in row else ""))
    return row, (q, k, v, kw)


def phase_kernels(device) -> dict:
    """Each case in f32 and bf16, kernel against plain, then bf16 timed at
    every shape of :data:`FLASH_TIMED`; returns the entry for the kernels
    line (launches filled in after the main path)."""
    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:110"}
    for label, B, Sq, Sk, H, KV, D, causal, window in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(B, Sq, Sk, H, KV, D, dtype, device)
            err = _check_flash(label, q, k, v, causal=causal, window=window)
            if label == "main_path" and dtype == torch.bfloat16:
                entry["max_abs_err"] = err
    for label, B, Sq, Sk, H, KV, D, window, q_offset in OFFSET_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(B, Sq, Sk, H, KV, D, dtype, device)
            _check_flash(label, q, k, v, causal=True, window=window,
                         q_offset=q_offset)
    # a BSHD view with a size-1 batch: batch row 1 of a fused (2, S, H + 2
    # KV, D) projection, its dims of size 1 passed with stride 0
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device).manual_seed(1)
        qkv = torch.randn((2, 300, 14 + 2 * 2, 64), generator=g,
                          device=device).to(dtype)
        q, k, v = qkv[1:2, :, :14], qkv[1:2, :, 14:16], qkv[1:2, :, 16:]
        _check_flash("fused_view_batch1", q, k, v, causal=True, window=100)

    rows = []
    for shape in FLASH_TIMED:
        row, (q, k, v, kw) = _flash_timed(device, *shape)
        rows.append(row)
        if row["label"] == "main_path":
            kernel = lambda: FA.flash_attention_cuda(q, k, v, **kw)
            row["eager_ms"] = time_ms(kernel)
            row["encode_us"] = FA.encode_us(q, k, v)
            log(f"flash main-path shape ({FA.route(q.dtype)} route): eager "
                f"calls back to back {row['eager_ms']:.4f} ms each; the "
                f"three tensor-map encodes {row['encode_us']:.2f} us of "
                f"host time a call")
        del q, k, v
    torch.cuda.empty_cache()
    main = rows[0]
    entry.update(ms=main["ms"], plain_ms=main["plain_ms"],
                 library_ms=main["sdpa_ms"], bound_ms=main["bound_ms"],
                 bound_by=main["bound_by"], timed_shapes=rows)
    return entry


def phase_main_path(device, entry: dict) -> None:
    s = SERVE
    job = ServeJob(arch=s["arch"], reduced=s["reduced"], batch=s["batch"],
                   prompt_len=s["prompt_len"],
                   arch_overrides=(("use_flash_attention", True),))
    spec = ExperimentSpec(objective=job, T=s["T"], seed=s["seed"])
    cfg = job.make_arch()
    torch.cuda.reset_peak_memory_stats()

    FA.launches = 0
    with _dtypes_seen(FA, "flash_attention_cuda") as seen:
        res = run(spec, device=device)
    entry["launches"] = FA.launches
    routes = sorted({FA.route(getattr(torch, d[0])) for d in seen})
    log(f"main path hands the flash kernel q/k/v of dtypes {sorted(seen)}: "
        f"route {routes}")
    if routes != ["tensor_cores"]:
        raise AssertionError(f"main path took the flash routes {routes}, "
                             f"want the tensor cores'")

    log(f"main path: {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"vocab={cfg.vocab} batch={s['batch']} prompt={s['prompt_len']} "
        f"T={s['T']}: flash launches {entry['launches']}, prefill "
        f"{res.extra['prefill_seconds'] * 1e3:.1f} ms (first call), decode "
        f"{res.extra['tok_per_s']:.1f} tok/s over {s['T'] - 1} steps, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if entry["launches"] != cfg.n_layers or \
            res.extra["flash_launches"] != cfg.n_layers:
        raise AssertionError(f"flash kernel launched {entry['launches']} "
                             f"times, want one per layer ({cfg.n_layers})")
    if not res.extra["logits_finite"]:
        raise AssertionError("non-finite logits on the main path")
    x = res.x
    if x.shape != (s["batch"], s["T"]) or x.dtype.kind != "i" or \
            x.min() < 0 or x.max() >= cfg.vocab:
        raise AssertionError(f"bad token matrix {x.dtype} {x.shape}")

    params = init_params(cfg, s["seed"], device)
    # prefill below runs outside torch.no_grad(): the flash kernel's guard
    # stays quiet only because no param requires grad
    if any(p.requires_grad for p in tree_leaves(params)):
        raise AssertionError("init_params returned params that require grad")
    tokens = torch.as_tensor(res.extra["prompts"], dtype=torch.int64,
                             device=device)
    ctx = s["prompt_len"] + s["T"]
    logits = {}
    for flash in (True, False):
        c = cfg.with_(use_flash_attention=flash)
        logits[flash], _ = prefill(c, params, {"tokens": tokens}, ctx_len=ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(c, params, {"tokens": tokens}, ctx_len=ctx)
        torch.cuda.synchronize()
        log(f"prefill (warm, flash={flash}): "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    a, b = logits[True].float(), logits[False].float()
    err, bad = _compare(a, b, TOL[torch.bfloat16])
    log(f"prefill last-token logits, flash vs plain attention: max_abs_err "
        f"{err:.3e} (|logit| max {b.abs().max().item():.3f}, tol "
        f"{TOL[torch.bfloat16]:g}) bad={bad}; argmax agree "
        f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{a.shape[0]}")
    if bad or not torch.isfinite(a).all():
        raise AssertionError("flash and plain prefill logits disagree")


def _update_inputs(n, dtype, device, seed=0):
    """p (dtype), m (f32 normal · 0.1), v (f32 uniform · 0.01), gbuf and g
    (dtype), as in tests/test_kernels.py."""
    gen = torch.Generator(device).manual_seed(seed)
    rn = lambda: torch.randn(n, generator=gen, device=device)
    return {"p": rn().to(dtype), "m": rn() * 0.1,
            "v": torch.rand(n, generator=gen, device=device) * 0.01,
            "gb": rn().to(dtype), "g": rn().to(dtype)}


def _kind(name):
    return "adam" if "adam" in name else "sgd"


def _scalar_sets(name, device):
    """[(label, scal)]: SGD one eff; heavy ball one [lr_eff, clip]; Adam
    count ∈ {1, 7} × wd ∈ {0, 0.1}; every block with run flag 1."""
    lr = UPDATE_LR[_kind(name)]
    if "momentum" in name:
        return [("", AU.momentum_scalars(lr, CLIP, DELAY_SCALE, device))]
    if _kind(name) == "sgd":
        return [("", AU.sgd_scalars(lr, CLIP, DELAY_SCALE, device))]
    out = []
    for count in (1, 7):
        c = torch.tensor(count, dtype=torch.int32, device=device)
        bc1, bc2 = AU.adam_bias_corrections(0.9, 0.95, c)
        for wd in (0.0, 0.1):
            out.append((f" count={count} wd={wd}",
                        AU.adam_scalars(lr, bc1, bc2, CLIP, wd, device)))
    return out


def _apply(name, route, t, scal):
    """Run ``AU.<name>_<route>`` in place on the operands of ``t``."""
    fn = getattr(AU, f"{name}_{route}")
    if name == "async_update":
        fn(t["p"], t["gb"], t["g"], scal)
    elif name == "sgd_step":
        fn(t["p"], t["g"], scal)
    elif name == "sgd_momentum_step":
        fn(t["p"], t["m"], t["g"], scal, momentum=MOMENTUM)
    elif name == "sgd_momentum_delayed":
        fn(t["p"], t["m"], t["gb"], t["g"], scal, momentum=MOMENTUM)
    elif name == "fused_adam":
        fn(t["p"], t["m"], t["v"], t["g"], scal)
    else:
        fn(t["p"], t["m"], t["v"], t["gb"], t["g"], scal)
    return t


def _main_leaves():
    """The numels of qwen2-0.5b's 14 param leaves, in tree order."""
    return [int(np.prod(s.shape)) for s in
            tree_leaves(param_specs(get_arch(SERVE["arch"])))]


def _delayed(name):
    """Whether the kernel swaps the buffer (gbuf′ = g)."""
    return name in ("async_update", "sgd_momentum_delayed",
                    "fused_adam_delayed")


def _state_keys(name):
    """The float state each kernel writes besides the buffer."""
    if _kind(name) == "adam":
        return ("p", "m", "v")
    return ("p", "m") if "momentum" in name else ("p",)


def _bits(t):
    """A float tensor's bits as integers (so NaN equals itself)."""
    return t.view(torch.int16) if t.element_size() == 2 else \
        t.view(torch.int32)


def _skip_case(name, base, device):
    """Run flag 0 on NaN g: every operand must keep its bits."""
    scal = _scalar_sets(name, device)[-1][1].clone()
    scal[-1] = 0.0
    t = tree_map(torch.clone, base)
    t["g"][::3] = float("nan")
    g = t["g"].clone()
    _apply(name, "cuda", t, scal)
    torch.cuda.synchronize()
    for key in ("p", "m", "v", "gb"):
        if not torch.equal(_bits(t[key]), _bits(base[key])):
            raise AssertionError(f"{name}: run flag 0 changed {key} at "
                                 f"n={base['p'].numel()} {base['p'].dtype}")
    if not torch.equal(_bits(t["g"]), _bits(g)):
        raise AssertionError(f"{name}: run flag 0 changed g")


def phase_update_kernels(device) -> dict:
    """The six kernels against their plain versions over the matrix, then
    timed over one round's 14 leaves; returns the kernels-line entries."""
    entries = {name: {"name": name, "route": "cuda",
                      "source": "src/repro_torch/csrc/async_update.cu",
                      "replaces": REPLACES[name], "max_abs_err": 0.0}
               for name in AU.KERNELS}
    leaves = _main_leaves()
    checked = skipped = 0
    for n in UPDATE_SIZES + tuple(leaves):
        for dtype in (torch.float32, torch.bfloat16):
            base = _update_inputs(n, dtype, device, seed=n % 9973)
            for name in AU.KERNELS:
                rtol, atol = UPDATE_TOL[_kind(name)][dtype]
                for label, scal in _scalar_sets(name, device):
                    got = _apply(name, "cuda", tree_map(torch.clone, base),
                                 scal)
                    torch.cuda.synchronize()
                    want = _apply(name, "plain",
                                  tree_map(torch.clone, base), scal)
                    worst = 0.0
                    for key in _state_keys(name):
                        a, b = got[key].float(), want[key].float()
                        err = (a - b).abs()
                        bad = int((err > atol + rtol * b.abs()).sum())
                        if bad or not torch.isfinite(a).all():
                            raise AssertionError(
                                f"{name} {key} disagrees with its plain "
                                f"version at n={n} {dtype}{label}: {bad} "
                                f"elements, max abs err {err.max().item():.3e}")
                        worst = max(worst, err.max().item())
                    if _delayed(name) and not (
                            torch.equal(got["gb"], base["g"])
                            and torch.equal(want["gb"], base["g"])):
                        raise AssertionError(f"{name}: gbuf' != g bitwise at "
                                             f"n={n} {dtype}{label}")
                    if got["p"].dtype != dtype:
                        raise AssertionError(f"{name}: p dtype {got['p'].dtype}")
                    if n in leaves and dtype == torch.bfloat16:
                        e = entries[name]
                        e["max_abs_err"] = max(e["max_abs_err"], worst)
                    checked += 1
                _skip_case(name, base, device)
                skipped += 1
            del base
    log(f"update kernels: {checked} cases against their plain versions, all "
        f"within tolerance, gbuf' bitwise; {skipped} cases at run flag 0 on "
        f"NaN g, every operand bit-identical to its input; max abs err on "
        f"the main-path leaves in bf16: " + ", ".join(
            f"{k} {e['max_abs_err']:.3e}" for k, e in entries.items()))

    # one round over the 14 main-path leaves: bf16 p / gbuf / g, f32 m / v
    bf16 = torch.bfloat16
    state = [_update_inputs(n, bf16, device, seed=i)
             for i, n in enumerate(leaves)]
    n_total = sum(leaves)
    for name in AU.KERNELS:
        scal = _scalar_sets(name, device)[-1][1]
        e = entries[name]
        e["ms"] = time_ms(lambda: [_apply(name, "cuda", t, scal)
                                   for t in state], iters=10)
        e["plain_ms"] = time_ms(lambda: [_apply(name, "plain", t, scal)
                                         for t in state], iters=5)
        e["library_ms"] = _update_library_ms(name, state)
        e["bound_ms"], e["bound_by"] = op_cost.bound_ms(
            n_total * op_cost.UPDATE_OPS[name],
            n_total * op_cost.update_bytes_per_elem(name, 2, 2),
            PEAK_FLOPS_F32)
        log(f"{name} over one round ({n_total:,} elements, {len(leaves)} "
            f"leaves): "
            f"kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, library "
            f"{e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']})")
    del state
    torch.cuda.empty_cache()
    return entries


def _update_library_ms(name, state):
    """One PyTorch call over the round, a yardstick the port never calls:
    ``torch._foreach_add_`` for the SGD kernels (p −= eff·buffer; for
    async_update it leaves out the buffer swap),
    ``torch.optim.SGD(momentum=0.9, fused=True)`` for the heavy-ball
    kernels and ``torch.optim.Adam(fused=True)`` for the Adam kernels.  The
    fused optimizers keep their buffers in the params' dtype, so they cannot
    take bf16 params with f32 buffers: they run on f32 copies of p and g
    (no clip, no swap)."""
    if "momentum" in name:
        params = [torch.nn.Parameter(t["p"].float()) for t in state]
        for prm, t in zip(params, state):
            prm.grad = t["g"].float()
        opt = torch.optim.SGD(params, lr=UPDATE_LR["sgd"], momentum=MOMENTUM,
                              fused=True)
        log(f"  {name} library yardstick: torch.optim.SGD(momentum="
            f"{MOMENTUM}, fused=True) in f32 (it keeps the momentum in the "
            "params' dtype)")
        ms = time_ms(opt.step, iters=10)
        del opt, params
        torch.cuda.empty_cache()
        return ms
    if _kind(name) == "sgd":
        ps = [t["p"] for t in state]
        gs = [t["gb" if name == "async_update" else "g"] for t in state]
        eff = UPDATE_LR["sgd"] * CLIP * DELAY_SCALE
        return time_ms(lambda: torch._foreach_add_(ps, gs, alpha=-eff),
                       iters=10)
    params = [torch.nn.Parameter(t["p"].float()) for t in state]
    for prm, t in zip(params, state):
        prm.grad = t["g"].float()
    opt = torch.optim.Adam(params, lr=UPDATE_LR["adam"], betas=(0.9, 0.95),
                           eps=1e-8, fused=True)
    log(f"  {name} library yardstick: torch.optim.Adam(fused=True) in f32 "
        "(it keeps moments in the params' dtype, so bf16 params with f32 "
        "moments are not expressible)")
    ms = time_ms(opt.step, iters=10)
    del opt, params
    torch.cuda.empty_cache()
    return ms


def _train_spec(T=None, **job_kw):
    job = TrainJob(**{**TRAIN_JOB, **job_kw})
    return ExperimentSpec(objective=job, **{**TRAIN_SPEC, "T": T or
                                            TRAIN_SPEC["T"]})


def _check_curves(res, label):
    if res.losses is None or not (np.isfinite(res.losses).all()
                                  and np.isfinite(res.grad_norms).all()):
        raise AssertionError(f"{label}: non-finite or missing curves")


def phase_train_main(device, entry: dict) -> dict:
    """The training main path, its reference twin and a warm timed run;
    returns the warm ms per round (``warm_ms``) and the two loss curves
    (``losses``, ``ref_losses``)."""
    spec = _train_spec()
    cfg = spec.objective.make_arch()
    rounds = spec.T
    torch.cuda.reset_peak_memory_stats()
    AU.reset_launches()
    t0 = time.perf_counter()
    res = run(spec, device=device)
    secs = time.perf_counter() - t0
    launched = dict(AU.launches)
    entry["launches"] = launched["fused_adam_delayed"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_leaves = len(tree_leaves(res.x["params"]))
    want = {k: 0 for k in AU.KERNELS}
    want["fused_adam_delayed"] = rounds * n_leaves
    if launched != want or res.extra["update_launches"] != want:
        raise AssertionError(f"update launches {launched} (extra "
                             f"{res.extra['update_launches']}), want {want}")
    _check_curves(res, "training main path")
    log(f"train main path: {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"vocab={cfg.vocab} batch={TRAIN_JOB['global_batch']} "
        f"seq={TRAIN_JOB['seq_len']} T={rounds} (first call, {secs:.2f} s): "
        f"fused_adam_delayed launches {entry['launches']} = {rounds} rounds "
        f"x {n_leaves} leaves; loss {res.losses[0]:.5f} -> "
        f"{res.losses[-1]:.5f}; grad_norm {res.grad_norms[-1]:.4f}; "
        f"launches {res.extra['launches']} host_syncs "
        f"{res.extra['host_syncs']}; peak memory {peak:.2f} GiB")
    losses = res.losses
    res = None
    torch.cuda.empty_cache()

    base = init_params(cfg, TRAIN_SPEC["seed"], device)
    same_init = lambda cfg, dev: tree_map(torch.clone, base)
    ref_spec = dataclasses.replace(spec, objective=dataclasses.replace(
        spec.objective, update_impl="reference"))
    ref = TrainerBackend(device, params_fn=same_init).run(ref_spec)
    _check_curves(ref, "reference run")
    rel = np.abs(losses - ref.losses) / np.abs(ref.losses)
    log(f"loss curve, pallas vs reference: max rel diff {rel.max():.3e} "
        f"(rtol 5e-3); reference {ref.losses[0]:.5f} -> {ref.losses[-1]:.5f}")
    if not (rel <= 5e-3).all():
        raise AssertionError("pallas and reference loss curves disagree")
    ref_losses = ref.losses
    ref = None
    torch.cuda.empty_cache()

    stamps = {}
    timed = TrainerBackend(device, params_fn=same_init, on_step=lambda i, s, m:
                           stamps.setdefault(i, time.perf_counter()))
    timed.run(spec)
    k = TRAIN_SPEC["rounds_per_launch"]
    warm = (stamps[2 * k - 1] - stamps[k - 1]) / k * 1e3
    log(f"train main path warm: {warm:.3f} ms per round (host clock over "
        f"rounds {k}..{2 * k - 1}, chunk-boundary reads)")
    return {"warm_ms": warm, "losses": losses, "ref_losses": ref_losses}


def phase_train_others(device, entries: dict) -> None:
    """sgd delayed / sgd sync / adam sync at full width and 2 layers."""
    T = 2
    for name, opt, delay in OTHER_PATHS:
        spec = _train_spec(T=T, opt=opt, delay_rounds=delay,
                           arch_overrides=(("n_layers", 2),))
        AU.reset_launches()
        res = run(spec, device=device)
        launched = dict(AU.launches)
        n_leaves = len(tree_leaves(res.x["params"]))
        want = {k: 0 for k in AU.KERNELS}
        want[name] = T * n_leaves
        if launched != want or res.extra["update_launches"] != want:
            raise AssertionError(f"{name} path: launches {launched}, want "
                                 f"{want}")
        _check_curves(res, f"{name} path")
        entries[name]["launches"] = launched[name]
        log(f"{name} path (opt={opt}, delay_rounds={delay}, 2 layers, T={T}):"
            f" {launched[name]} launches; loss {res.losses[0]:.5f} -> "
            f"{res.losses[-1]:.5f}")
        res = None
        torch.cuda.empty_cache()


def _momentum_spec(delay):
    """The heavy-ball paths' spec: the training job at 2 layers, T 2."""
    job = TrainJob(**{**TRAIN_JOB, "opt": "sgd", "delay_rounds": delay,
                      "arch_overrides": (("n_layers", 2),)})
    return ExperimentSpec(objective=job, **{**TRAIN_SPEC, "T": 2})


def _momentum_curve(device, delay, impl, base):
    """Heavy-ball SGD through ``AsyncTrainer`` and the plan executor (the
    JAX package's entry point for it: ``TrainJob`` has no momentum field)
    from the params ``base``; returns the loss curve."""
    spec = _momentum_spec(delay)
    job = spec.objective
    groups = spec.n_workers
    cfg = job.make_arch()
    tr = AsyncTrainer(cfg, opt=OptConfig(name="sgd", lr=spec.stepsize.gamma,
                                         momentum=MOMENTUM, clip_norm=1.0,
                                         update_impl=impl),
                      async_cfg=AsyncConfig(delay_rounds=delay), device=device)
    tr.n_groups = groups
    _, schedule = TrainerBackend.masks_for(spec, groups)
    plan = compile_plan(schedule, job, rounds=spec.T, n_groups=groups,
                        seed=spec.seed)
    state = tr.init_state(params=tree_map(torch.clone, base))
    res = execute(tr, plan, state, runtime="scan",
                  rounds_per_launch=spec.rounds_per_launch)
    return np.asarray(res.metrics["loss"], np.float64)


def phase_momentum_paths(device, entries: dict) -> None:
    """The two heavy-ball kernels' paths, each against the reference."""
    base = init_params(_momentum_spec(0).objective.make_arch(),
                       TRAIN_SPEC["seed"], device)
    n_leaves = len(tree_leaves(base))
    for name, delay in MOMENTUM_PATHS:
        AU.reset_launches()
        losses = _momentum_curve(device, delay, "pallas", base)
        launched = dict(AU.launches)
        want = {k: 0 for k in AU.KERNELS}
        want[name] = 2 * n_leaves
        if launched != want:
            raise AssertionError(f"{name} path: launches {launched}, want "
                                 f"{want}")
        ref = _momentum_curve(device, delay, "reference", base)
        rel = np.abs(losses - ref) / np.abs(ref)
        if not (np.isfinite(losses).all() and (rel <= 5e-3).all()):
            raise AssertionError(f"{name} path: loss {losses} against the "
                                 f"reference {ref}")
        entries[name]["launches"] = launched[name]
        log(f"{name} path (sgd momentum={MOMENTUM}, delay_rounds={delay}, 2 "
            f"layers, T=2): {launched[name]} launches; loss {losses[0]:.5f} "
            f"-> {losses[-1]:.5f}; max rel diff to the reference "
            f"{rel.max():.3e} (rtol 5e-3)")
    del base
    torch.cuda.empty_cache()


def _ssd_inputs(B, nc, c, H, P, N, dtype, device, seed=3):
    """x · 0.5, dt ∈ [0.01, 0.2], A ∈ −[0.5, 2], B/C · 0.3 (B and C in x's
    dtype, as the model hands them over), as in tests/test_kernels.py."""
    g = torch.Generator(device).manual_seed(seed)
    u = lambda shape, lo, hi: torch.rand(shape, generator=g,
                                         device=device) * (hi - lo) + lo
    rn = lambda shape: torch.randn(shape, generator=g, device=device)
    return ((rn((B, nc, c, H, P)) * 0.5).to(dtype), u((B, nc, c, H), 0.01, 0.2),
            -u((H,), 0.5, 2.0), (rn((B, nc, c, N)) * 0.3).to(dtype),
            (rn((B, nc, c, N)) * 0.3).to(dtype))


def _zero_ssd() -> None:
    """The SSD kernel's launch counts, overall and by design, set to 0."""
    SSD.launches = 0
    SSD.design_launches.update(dict.fromkeys(SSD.design_launches, 0))


def _ssd_designs(label, bf16=True) -> dict:
    """The SSD launches since :func:`_zero_ssd`, by design: none on the
    mma.sync design, and every one on the Hopper design where the path
    hands the kernel bf16 (``bf16``), none where it hands it f32 (the
    depth gates: the CUDA cores)."""
    d = dict(SSD.design_launches)
    want = SSD.launches if bf16 else 0
    if d["mma_sync"] or sum(d.values()) != SSD.launches or d["hopper"] != want:
        raise AssertionError(f"{label}: ssd launches by design {d} of "
                             f"{SSD.launches}, want {want} on the Hopper "
                             f"design and none on mma.sync")
    log(f"{label}: ssd launches by design {d}")
    return d


def _ssd_mma_sync(x, dt, A, B_, C_):
    """The first tensor-core design (mma.sync) on the same inputs,
    through the C entry the wrapper keeps for layouts no tensor map
    describes: a yardstick in phase 9 only, uncounted."""
    (x, x_rs), (B_, b_rs), (C_, c_rs), _ = SSD._operands(x, B_, C_)
    Bb, nc, c, H, P = x.shape
    N = B_.shape[-1]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    st = torch.empty((Bb, nc, H, N, P), dtype=torch.float32, device=x.device)
    err = SSD._kernel()(x.data_ptr(), dt.contiguous().data_ptr(),
                        A.contiguous().data_ptr(), B_.data_ptr(),
                        C_.data_ptr(), y.data_ptr(), st.data_ptr(), Bb * nc,
                        c, H, P, N, x_rs, b_rs, c_rs, 1, 1,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd mma.sync launch failed: cudaError_t {err}")
    return y, st


def ssd_bound(x, B_):
    """(bound_ms, bound_by) of one SSD chunk call: ``op_cost.ssd_cost``'s
    operations at the bf16 tensor-core peak."""
    return op_cost.bound_ms(*op_cost.ssd_cost(x, B_), PEAK_FLOPS_BF16)


def phase_ssd_kernel(device) -> dict:
    """Each SSD case in f32 and bf16, kernel against plain; the serving
    shape timed.  Returns the kernels-line entry (launches filled in by the
    SSM main path)."""
    entry = {"name": "ssd_chunk", "route": "cuda",
             "source": "src/repro_torch/csrc/ssd_chunk.cu",
             "replaces": "src/repro/kernels/ssd_chunk.py:74"}
    for label, B, nc, c, H, P, N in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(B, nc, c, H, P, N, dtype, device)
            kind = SSD.design_of(args[0], args[3], args[4])
            y, st = SSD.ssd_chunk_cuda(*args)
            torch.cuda.synchronize()
            wy, wst = SSD.ssd_chunk_plain(*args)
            if y.dtype != dtype or st.shape != (B, nc, H, N, P):
                raise AssertionError(f"ssd {label}: got {y.dtype} "
                                     f"{tuple(st.shape)}")
            tol = SSD_TOL[dtype]
            err_y, bad_y = _compare(y, wy, tol)
            err_s, bad_s = _compare(st, wst, tol)
            log(f"ssd kernel {label} {str(dtype)[6:]} ({kind}): max_abs_err "
                f"y {err_y:.3e} states {err_s:.3e} (tol {tol:g}) "
                f"bad={bad_y + bad_s}")
            if bad_y or bad_s or not (torch.isfinite(y.float()).all()
                                      and torch.isfinite(st).all()):
                raise AssertionError(f"ssd kernel disagrees with its plain "
                                     f"version on {label} {dtype}")
            if label == "main_path" and dtype == torch.bfloat16:
                entry["max_abs_err"] = max(err_y, err_s)
            del args, y, st, wy, wst
    args = _ssd_inputs(*SSD_CASES[0][1:], torch.bfloat16, device)
    kernel = lambda: SSD.ssd_chunk_cuda(*args)
    entry["ms"] = device_ms(kernel)
    eager = time_ms(kernel)
    entry["plain_ms"] = device_ms(lambda: SSD.ssd_chunk_plain(*args), iters=5)
    entry["library_ms"] = None
    entry["bound_ms"], entry["bound_by"] = ssd_bound(args[0], args[3])
    log(f"ssd main-path shape bf16 ({SSD.route(args[0].dtype, args[3].dtype)} "
        f"route): device time per call: kernel {entry['ms']:.4f} ms, plain "
        f"{entry['plain_ms']:.4f} ms, no library call, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}); eager "
        f"calls back to back {eager:.4f} ms each")
    del args
    torch.cuda.empty_cache()
    entry["timed_shapes"] = _ssd_timed(device)
    return entry


def _ssd_timed(device) -> list:
    """Every SSD shape the paths launch (``SSD_TIMED``) in bf16: the Hopper
    design's device time against the mma.sync design's on the same inputs
    (both held to each other), the bound and the share; returns the
    table's rows, each number measured or computed in this run (the
    earlier recorded time stands beside them in the log only)."""
    rows = []
    log("ssd timed (bf16): shape | design | ms | mma.sync ms | earlier ms "
        "| bound ms | share of bound")
    for label, B, nc, c, H, P, N, earlier in SSD_TIMED:
        args = _ssd_inputs(B, nc, c, H, P, N, torch.bfloat16, device)
        kind = SSD.design_of(args[0], args[3], args[4])
        if kind != "hopper":
            raise AssertionError(f"ssd {label} takes the {kind} design")
        (y, st), (wy, wst) = SSD.ssd_chunk_cuda(*args), _ssd_mma_sync(*args)
        err = max(_compare(y, wy, SSD_TOL[torch.bfloat16])[0],
                  _compare(st, wst, SSD_TOL[torch.bfloat16])[0])
        if err > SSD_TOL[torch.bfloat16]:
            raise AssertionError(f"ssd {label}: the designs differ by {err}")
        ms = device_ms(lambda: SSD.ssd_chunk_cuda(*args))
        mma_ms = device_ms(lambda: _ssd_mma_sync(*args))
        bound, by = ssd_bound(args[0], args[3])
        rows.append({"shape": label, "x": [B, nc, c, H, P], "N": N,
                     "design": kind, "ms": ms, "mma_sync_ms": mma_ms,
                     "bound_ms": bound, "bound_by": by, "share": bound / ms})
        log(f"  {label} x ({B}, {nc}, {c}, {H}, {P}) N {N} | {kind} | "
            f"{ms:.4f} | {mma_ms:.4f} | "
            f"{'not measured' if earlier is None else earlier}"
            f" | {bound:.4f} ({by}) | {bound / ms:.2f}")
        del args, y, st, wy, wst
    torch.cuda.empty_cache()
    return rows


def _prefill_plain_ssd(cfg, params, tokens, ctx):
    """Last-token logits of a prefill whose ``ops.ssd_chunk`` calls go to the
    kernel's plain version: the same branch and bf16 casts as the kernel's
    prefill, on the card."""
    routed = ops.ssd_chunk
    ops.ssd_chunk = SSD.ssd_chunk_plain
    try:
        return prefill(cfg, params, {"tokens": tokens}, ctx_len=ctx)[0]
    finally:
        ops.ssd_chunk = routed


def phase_ssm_main_path(device, entry: dict) -> None:
    """mamba2-370m at full width through run(ServeJob), then prefill with
    and without the kernel, and warm times."""
    s = SSM_SERVE
    job = ServeJob(arch=s["arch"], reduced=s["reduced"], batch=s["batch"],
                   prompt_len=s["prompt_len"],
                   arch_overrides=(("use_ssd_kernel", True),))
    spec = ExperimentSpec(objective=job, T=s["T"], seed=s["seed"])
    cfg = job.make_arch()
    torch.cuda.reset_peak_memory_stats()

    _zero_ssd()
    with _dtypes_seen(SSD, "ssd_chunk_cuda") as seen:
        res = run(spec, device=device)
    entry["launches"] = SSD.launches
    entry["designs"] = _ssd_designs("ssm main path")
    routes = sorted({SSD.route(getattr(torch, d[0]), getattr(torch, d[3]))
                     for d in seen})
    log(f"ssm main path hands the ssd kernel x/dt/A/B/C of dtypes "
        f"{sorted(seen)}: route {routes}")
    if routes != ["tensor_cores"]:
        raise AssertionError(f"ssm main path took the ssd routes {routes}, "
                             f"want the tensor cores'")

    log(f"ssm main path: {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"d_inner={cfg.d_inner} heads={cfg.ssm_heads}x{cfg.ssm_head_dim} "
        f"state={cfg.ssm_state} vocab={cfg.vocab} batch={s['batch']} "
        f"prompt={s['prompt_len']} T={s['T']}: ssd launches "
        f"{entry['launches']}, prefill "
        f"{res.extra['prefill_seconds'] * 1e3:.1f} ms (first call), decode "
        f"{res.extra['tok_per_s']:.1f} tok/s over {s['T'] - 1} steps, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if entry["launches"] != cfg.n_layers or \
            res.extra["ssd_launches"] != cfg.n_layers:
        raise AssertionError(f"ssd kernel launched {entry['launches']} "
                             f"times, want one per layer ({cfg.n_layers})")
    if not res.extra["logits_finite"]:
        raise AssertionError("non-finite logits on the ssm main path")
    x = res.x
    if x.shape != (s["batch"], s["T"]) or x.dtype.kind != "i" or \
            x.min() < 0 or x.max() >= cfg.vocab:
        raise AssertionError(f"bad token matrix {x.dtype} {x.shape}")

    params = init_params(cfg, s["seed"], device)
    tokens = torch.as_tensor(res.extra["prompts"], dtype=torch.int64,
                             device=device)
    ctx = s["prompt_len"] + s["T"]
    logits, caches = {}, {}
    for kernel in (True, False):
        c = cfg.with_(use_ssd_kernel=kernel)
        logits[kernel], caches[kernel] = prefill(c, params,
                                                 {"tokens": tokens},
                                                 ctx_len=ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(c, params, {"tokens": tokens}, ctx_len=ctx)
        torch.cuda.synchronize()
        log(f"ssm prefill (warm, ssd_kernel={kernel}): "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    tol = TOL[torch.bfloat16]
    a = logits[True].float()
    if not torch.isfinite(a).all():
        raise AssertionError("non-finite ssm prefill logits")
    # the kernel at full depth, against its plain version in the same branch
    plain = _prefill_plain_ssd(cfg.with_(use_ssd_kernel=True), params, tokens,
                               ctx).float()
    err, bad = _compare(a, plain, tol)
    log(f"ssm prefill last-token logits, {cfg.n_layers} layers, ssd kernel vs "
        f"its plain version in the kernel branch: max_abs_err {err:.3e} (tol "
        f"{tol:g}) bad={bad}")
    if bad:
        raise AssertionError("ssd kernel prefill disagrees with its plain "
                             "version")
    # the kernel branch rounds each layer's intra-chunk y to bf16 (as the JAX
    # package does), the einsum branch does not: the gap compounds with depth,
    # so it is gated at 2 layers (the JAX suite's depth for this check) and
    # reported at full depth
    b = logits[False].float()
    err, bad = _compare(a, b, tol)
    log(f"ssm prefill last-token logits, {cfg.n_layers} layers, kernel branch "
        f"vs einsum branch (reported): max_abs_err {err:.3e} (|logit| max "
        f"{b.abs().max().item():.3f}) outside {tol:g}: {bad}; argmax agree "
        f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{a.shape[0]}")
    two = cfg.with_(n_layers=2)
    p2 = init_params(two, s["seed"], device)
    a2 = prefill(two.with_(use_ssd_kernel=True), p2, {"tokens": tokens})[0]
    b2 = prefill(two.with_(use_ssd_kernel=False), p2, {"tokens": tokens})[0]
    err, bad = _compare(a2.float(), b2.float(), tol)
    log(f"ssm prefill last-token logits, 2 layers at full width, kernel "
        f"branch vs einsum branch: max_abs_err {err:.3e} (tol {tol:g}) "
        f"bad={bad}")
    if bad:
        raise AssertionError("ssd kernel and einsum prefill logits disagree "
                             "at 2 layers")
    del p2
    server = Server(cfg, ServeConfig(batch=s["batch"], ctx_len=ctx),
                    device=device)
    first = a.argmax(-1).cpu().numpy()
    steps = 8
    server.generate(params, first, 2, start_pos=s["prompt_len"],
                    cache=caches[False])                        # warm-up
    t0 = time.perf_counter()
    server.generate(params, first, steps, start_pos=s["prompt_len"] + 2,
                    cache=caches[True])
    dt = time.perf_counter() - t0
    log(f"ssm decode (warm): {dt / steps * 1e3:.2f} ms/step = "
        f"{s['batch'] * steps / dt:.1f} tok/s over {steps} steps")
    del params, caches
    torch.cuda.empty_cache()


def _expect_raise(fn, exc):
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"{fn} did not raise {exc.__name__}")


def phase_guards(device) -> None:
    """The flash and SSD kernels' CUDA routes raise for inputs that require
    grad, and launch under ``torch.no_grad()``."""
    q, k, v = _qkv(1, 64, 64, 2, 2, 64, torch.bfloat16, device)
    q.requires_grad_(True)
    before = FA.launches
    _expect_raise(lambda: FA.flash_attention_cuda(q, k, v), NotImplementedError)
    _expect_raise(lambda: ops.flash_attention(q, k, v), NotImplementedError)
    if FA.launches != before:
        raise AssertionError("the flash guard raised after a launch")
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    if FA.launches != before + 1:
        raise AssertionError("flash kernel did not launch under no_grad")
    log("flash guard: the CUDA route raises NotImplementedError for a q that "
        "requires grad and launches under torch.no_grad()")
    x, dt, A, B_, C_ = _ssd_inputs(1, 1, 16, 2, 32, 16, torch.bfloat16, device)
    x.requires_grad_(True)
    before = SSD.launches
    _expect_raise(lambda: SSD.ssd_chunk_cuda(x, dt, A, B_, C_),
                  NotImplementedError)
    _expect_raise(lambda: ops.ssd_chunk(x, dt, A, B_, C_), NotImplementedError)
    if SSD.launches != before:
        raise AssertionError("the ssd guard raised after a launch")
    with torch.no_grad():
        ops.ssd_chunk(x, dt, A, B_, C_)
    torch.cuda.synchronize()
    if SSD.launches != before + 1:
        raise AssertionError("ssd kernel did not launch under no_grad")
    log("ssd guard: the CUDA route raises NotImplementedError for an x that "
        "requires grad and launches under torch.no_grad()")


#: the slot lane's cells (phase 13): full width, bf16, the prefill kernel
#: on; each serves ``n_requests`` through ``n_slots`` lanes, K = 8 decode
#: steps per captured chunk, with ``admissions[0]`` through ``run`` and on
#: one server instance, then the other admissions on that instance
SLOT_CELLS = (
    dict(arch="qwen2-0.5b", kernel="flash", n_slots=8, n_requests=32,
         prompt_len=512, T=64, arrival="poisson:gap=2",
         admissions=("pure", "fedbuff:b=2")),
    dict(arch="mamba2-370m", kernel="ssd", n_slots=8, n_requests=16,
         prompt_len=512, T=32, arrival="poisson:gap=2", admissions=("pure",)),
)
SLOT_K, SLOT_SEED = 8, 0
#: slot lane ≡ lock-step on the card: full width, 2 layers, f32, TF32 off
SLOT_PARITY = dict(arch="qwen2-0.5b", n_layers=2, batch=4, prompt_len=512,
                   T=32)
_SLOT_KERNELS = {"flash": (FA, "flash_attention_cuda", "use_flash_attention"),
                 "ssd": (SSD, "ssd_chunk_cuda", "use_ssd_kernel")}


def _check_served(label, tokens, res, cfg, n_req, T):
    """Every request served once, T tokens in the vocabulary each, and
    one tap row per decode step."""
    if tokens.shape != (n_req, T) or tokens.dtype != np.int32 or \
            tokens.min() < 0 or tokens.max() >= cfg.vocab:
        raise AssertionError(f"{label}: bad token matrix {tokens.dtype} "
                             f"{tokens.shape} [{tokens.min()}, {tokens.max()}]")
    workers = sorted(np.asarray(res.schedule.workers).tolist())
    if workers != list(range(n_req)):
        raise AssertionError(f"{label}: schedule rows {workers}")
    if res.tap_rows != res.decode_steps or res.evictions or res.timeouts:
        raise AssertionError(f"{label}: tap rows {res.tap_rows} for "
                             f"{res.decode_steps} steps, evictions "
                             f"{res.evictions}, timeouts {res.timeouts}")


def phase_slot_cell(device, cell) -> dict:
    """One slot-lane cell: ``run`` with ``n_slots`` (the entry point), the
    same serve on one ``SlotServer`` (graph route), timed warm, profiled,
    the other admissions, and the eager route; returns the cell's row."""
    mod, cuda_fn, switch = _SLOT_KERNELS[cell["kernel"]]
    n_req, T, plen = cell["n_requests"], cell["T"], cell["prompt_len"]
    job = ServeJob(arch=cell["arch"], reduced=False, batch=cell["n_slots"],
                   prompt_len=plen, arch_overrides=((switch, True),),
                   n_slots=cell["n_slots"], n_requests=n_req,
                   admission=cell["admissions"][0], arrival=cell["arrival"],
                   steps_per_launch=SLOT_K)
    spec = ExperimentSpec(objective=job, T=T, seed=SLOT_SEED)
    cfg = job.make_arch()
    want_launches = n_req * cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    mod.launches = 0
    _zero_ssd()
    with _dtypes_seen(mod, cuda_fn) as seen:
        t0 = time.perf_counter()
        res = run(spec, device=device)
        cold = time.perf_counter() - t0
    launches = mod.launches
    if mod is SSD:
        _ssd_designs(f"slot lane {cfg.name}")
    e = res.extra
    routes = sorted({FA.route(getattr(torch, d[0])) if mod is FA else
                     SSD.route(getattr(torch, d[0]), getattr(torch, d[3]))
                     for d in seen})
    if routes != ["tensor_cores"]:
        raise AssertionError(f"slot lane {cfg.name}: kernel routes {routes}")
    if launches != want_launches or e[f"{cell['kernel']}_launches"] != \
            want_launches:
        raise AssertionError(f"slot lane {cfg.name}: {cell['kernel']} "
                             f"launched {launches} times, want {n_req} "
                             f"requests x {cfg.n_layers} layers")
    if e["compile_counts"]["chunk"] != 1 or e["graph_replays"] != e["chunks"]:
        raise AssertionError(f"slot lane {cfg.name}: {e['compile_counts']}, "
                             f"{e['graph_replays']} replays")
    if e["tap_rows"] != e["decode_steps"]:
        raise AssertionError(f"slot lane {cfg.name}: tap rows")
    log(f"slot lane {cfg.name} L={cfg.n_layers} d={cfg.d_model} through run"
        f"(ServeJob(n_slots={cell['n_slots']})): {n_req} requests, prompt "
        f"{plen}, T={T}, {cell['arrival']}, {job.admission}: {cell['kernel']} "
        f"launches {launches} on the {routes[0]} route, {e['chunks']} graph "
        f"replays of {SLOT_K} steps, cold {cold:.2f} s (params, capture)")

    params = init_params(cfg, SLOT_SEED, device)
    prompts, arrivals = e["prompts"], e["arrivals"]
    slots = SlotConfig(n_slots=cell["n_slots"], ctx_len=plen + T,
                       seed=SLOT_SEED, steps_per_launch=SLOT_K)
    server = SlotServer(cfg, slots, device=device)

    def serve(srv, admission, label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.launches = 0
        _zero_ssd()
        r = srv.serve(params, prompts, T, admission=admission,
                      arrivals=arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_served(f"{cfg.name} {label}", r.tokens, r, cfg, n_req, T)
        if mod.launches != want_launches:
            raise AssertionError(f"{cfg.name} {label}: {mod.launches} "
                                 f"{cell['kernel']} launches")
        if mod is SSD:
            _ssd_designs(f"slot server {cfg.name} {label}")
        return r, wall

    first, _ = serve(server, "pure", "graph")
    if not np.array_equal(first.tokens, res.x):
        raise AssertionError(f"{cfg.name}: SlotServer and run() disagree")
    warm, wall = serve(server, "pure", "graph, warm")
    if not np.array_equal(warm.tokens, first.tokens):
        raise AssertionError(f"{cfg.name}: a second serve changed tokens")
    _, prof_wall, kernels, _ = profiled(
        lambda: serve(server, "pure", "graph, profiled"))
    busy = sum(ms for ms, _ in kernels.values())
    idle = idle_share(kernels, prof_wall)
    for admission in cell["admissions"][1:]:
        other, _ = serve(server, admission, admission)
        log(f"slot lane {cfg.name} {admission}: {other.decode_steps} decode "
            f"steps, occupancy {other.occupancy:.3f}, mean ttft "
            f"{other.ttft_steps.mean():.2f} steps, {cell['kernel']} launches "
            f"{want_launches}, every request served once")
    counts = server.compile_counts()
    if counts != {"chunk": 1}:
        raise AssertionError(f"{cfg.name}: compile counts {counts}")
    eager, eager_wall = serve(SlotServer(cfg, slots, device=device,
                                         capture=False), "pure", "eager")
    if not np.array_equal(eager.tokens, first.tokens):
        bad = np.argwhere(eager.tokens != first.tokens)
        raise AssertionError(f"{cfg.name}: graph route and eager route "
                             f"disagree at (request, token) {bad[:5].tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    row = {"arch": cfg.name, "n_slots": cell["n_slots"], "n_requests": n_req,
           "prompt_len": plen, "T": T, "arrival": cell["arrival"],
           "admission": "pure", "steps_per_launch": SLOT_K,
           "kernel_launches": want_launches, "wall_s": wall,
           "tok_per_s": n_req * T / wall, "decode_steps": warm.decode_steps,
           "chunks": warm.chunks,
           "chunk_ms_per_step": warm.chunk_device_ms / warm.decode_steps,
           "profiled_wall_s": prof_wall, "profiled_device_ms": busy,
           "idle_share": idle,
           "host_waits": warm.host_waits,
           "host_waits_per_chunk": warm.host_waits / warm.chunks,
           "occupancy": warm.occupancy,
           "mean_ttft_steps": float(warm.ttft_steps.mean()),
           "eager_wall_s": eager_wall, "peak_gib": peak,
           "compile_counts": counts}
    log(f"slot lane {cfg.name} (warm, graph route): serve {wall * 1e3:.1f} ms"
        f", {row['tok_per_s']:.1f} tok/s ({n_req} x {T} tokens), "
        f"{warm.decode_steps} decode steps in {warm.chunks} replays, chunk "
        f"device time {row['chunk_ms_per_step']:.4f} ms per decode step, "
        f"host waits {warm.host_waits} ({row['host_waits_per_chunk']:.3f} per "
        f"chunk), occupancy {warm.occupancy:.3f}, mean ttft "
        f"{row['mean_ttft_steps']:.2f} steps, peak memory {peak:.2f} GiB; "
        f"profiled: {busy:.1f} ms of device work in {prof_wall * 1e3:.1f} ms, "
        f"idle share {idle:.3f}; eager route {eager_wall * 1e3:.1f} ms, tokens "
        f"bit-identical to the graph route")
    del params, server
    torch.cuda.empty_cache()
    return row


def phase_slot_parity(device) -> dict:
    """The slot lane against the lock-step lane through ``run``: full width,
    2 layers, f32 (TF32 off), n_slots = n_requests = batch, no arrivals,
    greedy.  The token matrices must be equal; a difference fails, naming
    the first diverging (request, step)."""
    p = SLOT_PARITY
    over = (("n_layers", p["n_layers"]), ("dtype", "float32"),
            ("use_flash_attention", True))
    base = dict(arch=p["arch"], reduced=False, batch=p["batch"],
                prompt_len=p["prompt_len"], arch_overrides=over)
    lock = run(ExperimentSpec(objective=ServeJob(**base), T=p["T"],
                              seed=SLOT_SEED), device=device)
    slot = run(ExperimentSpec(objective=ServeJob(
        **base, n_slots=p["batch"], steps_per_launch=SLOT_K), T=p["T"],
        seed=SLOT_SEED), device=device)
    if not np.array_equal(lock.extra["prompts"], slot.extra["prompts"]):
        raise AssertionError("slot and lock-step lanes drew other prompts")
    if not np.array_equal(lock.x, slot.x):
        diff = np.argwhere(lock.x != slot.x)
        step = int(diff[:, 1].min())
        rid = int(diff[diff[:, 1] == step][0, 0])
        raise AssertionError(f"slot lane diverged from the lock-step lane at "
                             f"request {rid}, step {step}")
    log(f"slot lane ≡ lock-step lane ({p['arch']} full width, "
        f"{p['n_layers']} layers, f32, TF32 off, batch {p['batch']}, "
        f"prompt {p['prompt_len']}, T={p['T']}): token matrices "
        "bit-identical")
    return {"equal": True}


#: the durability phase (14): serving resilience on the slot lane's cells
#: (SLOT_CELLS, the same prompts, arrivals and K) and the training main
#: path snapshotted and resumed.  Snapshots go under the checkout's
#: ignored build directory and are removed when the phase ends.
SNAP_ROOT = ROOT / "build" / "chip_smoke_snapshots"
CHAOS = ("slot_poison:rid=1,step=3,every=1;slot_poison:rid=5,step=40,"
         "every=0;serve_preempt:at=96,every=0")
CHAOS_RETRY = dict(max_attempts=2, backoff_base=2)
#: a queue of 16, not 8: with this cell's arrivals a queue of 8 sheds rid
#: 5's retry (eligible at 42, still queued at 56) under drop-oldest, in
#: the JAX package's bookkeeping as in the port's
#: (tests/test_torch_resilience.py::test_chaos_cell_bookkeeping_matches_jax)
CHAOS_OVERLOAD = (16, "drop-oldest")
SERVE_SNAP_EVERY, SERVE_SNAP_KEEP = 16, 3
#: the serve preemption of each cell's crash-resume gate (decode step)
PREEMPT_AT = {"qwen2-0.5b": 96, "mamba2-370m": 32}
DRAIN_AFTER = 64
#: mamba2-370m's shedding gate (the admission queue bound) and its poisoned
#: (rid, step) cell: rid 1 is admitted at step 8 and decodes to step 39
SSM_QUEUE_CAP, SSM_POISON = 2, (1, 10)
TRAIN_SNAP_EVERY, TRAIN_SNAP_KEEP = 4, 2


class _TimedSnapshotter(AsyncSnapshotter):
    """The snapshotter with the host time of each offer and of each
    finalise (the wait for the fetch plus the atomic save) recorded."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.offer_ms, self.finalise_s = [], []

    def offer(self, *args, **kw):
        t0 = time.perf_counter()
        n = len(self.finalise_s)
        super().offer(*args, **kw)
        # an offer finalises the one before: count only its own part
        self.offer_ms.append((time.perf_counter() - t0
                              - sum(self.finalise_s[n:])) * 1e3)

    def _write_oldest(self):
        t0 = time.perf_counter()
        super()._write_oldest()
        self.finalise_s.append(time.perf_counter() - t0)


def _slot_setup(device, cell):
    """A slot cell's config, params, prompts, arrivals and SlotConfig: the
    ones ``run(ServeJob(n_slots=...))`` builds for it."""
    mod, _, switch = _SLOT_KERNELS[cell["kernel"]]
    job = ServeJob(arch=cell["arch"], reduced=False, batch=cell["n_slots"],
                   prompt_len=cell["prompt_len"],
                   arch_overrides=((switch, True),), n_slots=cell["n_slots"],
                   n_requests=cell["n_requests"], arrival=cell["arrival"],
                   steps_per_launch=SLOT_K)
    cfg = job.make_arch()
    n_req = cell["n_requests"]
    prompts = np.random.default_rng(SLOT_SEED).integers(
        0, cfg.vocab, (n_req, cell["prompt_len"])).astype(np.int32)
    arrivals = draw_arrivals(n_req, cell["arrival"], seed=SLOT_SEED)
    slots = SlotConfig(n_slots=cell["n_slots"],
                       ctx_len=cell["prompt_len"] + cell["T"],
                       seed=SLOT_SEED, steps_per_launch=SLOT_K)
    return mod, cfg, init_params(cfg, SLOT_SEED, device), prompts, arrivals, \
        slots


def _buckets(label, res, n_req, T):
    """Every request in exactly one bucket: a full row (completed),
    evicted, timed out, shed or drained."""
    out = {}
    for rid in range(n_req):
        hits = [name for name, m in (("evicted", res.evictions),
                                     ("timed_out", res.timeouts),
                                     ("shed", res.shed),
                                     ("drained", res.drained)) if rid in m]
        if len(hits) > 1:
            raise AssertionError(f"{label}: request {rid} in {hits}")
        if not hits and not (res.tokens[rid] >= 0).all():
            raise AssertionError(f"{label}: request {rid} in no bucket "
                                 f"and not a full row of {T}")
        out[rid] = hits[0] if hits else "completed"
    return out


def _fault_horizon(arrivals, n_req, T, attempts):
    """``ServeBackend``'s horizon for realising serve faults."""
    return 2 * (int(arrivals.max(initial=0)) + n_req * T * attempts
                + SLOT_K) + 4 * SLOT_K


def _serve_until_done(srv, params, prompts, T, snapdir, **kw):
    """Serve; on a ServePreempted resume from the newest snapshot on the
    same server.  Returns (result, hops)."""
    resume, hops = None, 0
    while True:
        try:
            return srv.serve(params, prompts, T, resume_from=resume,
                             snapshot=_TimedSnapshotter(
                                 snapdir, SERVE_SNAP_EVERY,
                                 keep=SERVE_SNAP_KEEP), **kw), hops
        except ServePreempted:
            hops += 1
            if hops > 1:
                raise AssertionError("a second preemption")
            resume = AsyncSnapshotter.latest(snapdir)[1]


def _crash_resume(label, device, cfg, slots, params, prompts, arrivals, T,
                  clean, at, snapdir):
    """Preempt a snapshotted serve at ``at``, resume on a fresh server (a
    new capture); tokens and TTFT must equal ``clean``'s bit for bit."""
    faults = ServeFaults(preempt_steps=(at,))
    snap = _TimedSnapshotter(snapdir, SERVE_SNAP_EVERY, keep=SERVE_SNAP_KEEP)
    try:
        SlotServer(cfg, slots, device=device).serve(
            params, prompts, T, arrivals=arrivals, faults=faults,
            snapshot=snap)
    except ServePreempted as e:
        step = e.step
    else:
        raise AssertionError(f"{label}: no preemption at {at}")
    r, latest = AsyncSnapshotter.latest(snapdir)
    fresh = SlotServer(cfg, slots, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fresh.serve(params, prompts, T, arrivals=arrivals, faults=faults,
                      resume_from=latest)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    if (r != step or res.resumed_from != r
            or fresh.compile_counts() != {"chunk": 1}):
        raise AssertionError(f"{label}: snapshot {r}, preempted at {step}, "
                             f"resumed from {res.resumed_from}, "
                             f"{fresh.compile_counts()}")
    if not (np.array_equal(res.tokens, clean.tokens)
            and np.array_equal(res.ttft_steps, clean.ttft_steps)):
        bad = np.argwhere(res.tokens != clean.tokens)
        raise AssertionError(f"{label}: the resumed serve differs from the "
                             f"uninterrupted one at {bad[:5].tolist()}")
    log(f"durability {label}: preempted at step {step} (scheduled {at}), "
        f"resumed on a fresh server (one new capture) from snapshot {r}: "
        f"tokens and ttft bit-identical to the uninterrupted serve; "
        f"{len(snap.offer_ms)} offers, host ms per offer "
        f"{np.mean(snap.offer_ms):.3f}, finalise s "
        f"{np.mean(snap.finalise_s):.4f}; resumed serve {resume_s:.2f} s")
    return {"preempted_at": step, "resumed_from": r,
            "offers": len(snap.offer_ms),
            "offer_host_ms": snap.offer_ms, "finalise_s": snap.finalise_s,
            "snapshot_bytes": load_meta(latest)["state_nbytes"],
            "resumed_serve_s": resume_s}


def _durability_dense(device) -> dict:
    """qwen2-0.5b: the clean-world no-op, the chaos run, crash-resume on a
    fresh server, drain."""
    cell = SLOT_CELLS[0]
    mod, cfg, params, prompts, arrivals, slots = _slot_setup(device, cell)
    n_req, T, plen = cell["n_requests"], cell["T"], cell["prompt_len"]
    label = cfg.name
    srv = SlotServer(cfg, slots, device=device)
    lengths = []
    prefill_fn = srv.prefill_fn
    srv.prefill_fn = lambda n: (lengths.append(n), prefill_fn(n))[1]
    mod.launches = 0
    clean = srv.serve(params, prompts, T, arrivals=arrivals)
    armed = srv.serve(params, prompts, T, arrivals=arrivals,
                      retry=RetryPolicy(max_attempts=3))
    if not np.array_equal(armed.tokens, clean.tokens) or armed.attempts:
        raise AssertionError(f"{label}: retry on a clean world changed the "
                             f"serve (attempts {armed.attempts})")
    log(f"durability {label}: retry armed on a clean world: tokens "
        f"bit-identical to the unarmed serve")

    faults = realise_serve_faults(CHAOS, n_req, _fault_horizon(
        arrivals, n_req, T, CHAOS_RETRY["max_attempts"]), seed=SLOT_SEED)
    del lengths[:]
    chaos, hops = _serve_until_done(
        srv, params, prompts, T, str(SNAP_ROOT / "chaos"),
        arrivals=arrivals, faults=faults, retry=RetryPolicy(**CHAOS_RETRY),
        overload=OverloadPolicy(*CHAOS_OVERLOAD))
    buckets = _buckets(f"{label} chaos", chaos, n_req, T)
    replays = sorted(n - plen for n in lengths if n != plen)
    counts = {b: sum(1 for v in buckets.values() if v == b)
              for b in ("completed", "evicted", "timed_out", "shed",
                        "drained")}
    if (hops != 1 or buckets[5] != "completed" or chaos.attempts.get(5) != 1
            or buckets[1] == "completed" or not replays):
        raise AssertionError(f"{label} chaos: {hops} hops, rid 5 "
                             f"{buckets[5]} after {chaos.attempts.get(5)} "
                             f"failed attempts, rid 1 {buckets[1]}, replay "
                             f"prefixes {replays}")
    log(f"durability {label} chaos ({CHAOS}; RetryPolicy{CHAOS_RETRY}, "
        f"OverloadPolicy{CHAOS_OVERLOAD}): one preemption hop resumed from "
        f"step {chaos.resumed_from}; buckets {counts}; attempts "
        f"{chaos.attempts}; rid 5 completed its row through prefix replay; "
        f"replayed prefixes e = {replays}")

    crash = _crash_resume(label, device, cfg, slots, params, prompts,
                          arrivals, T, clean, PREEMPT_AT[cfg.name],
                          str(SNAP_ROOT / "crash"))
    drain = srv.serve(params, prompts, T, arrivals=arrivals,
                      drain_after=DRAIN_AFTER)
    buckets = _buckets(f"{label} drain", drain, n_req, T)
    queued = {r for r in range(n_req) if clean.ttft_steps[r] + arrivals[r]
              >= DRAIN_AFTER}
    if (set(drain.drained) != queued
            or set(drain.drained.values()) - {DRAIN_AFTER}
            or {r for r, b in buckets.items() if b != "completed"} != queued):
        raise AssertionError(f"{label} drain: drained {drain.drained}, "
                             f"queued at {DRAIN_AFTER}: {sorted(queued)}")
    launches = mod.launches
    if launches == 0 or launches % cfg.n_layers:
        raise AssertionError(f"{label}: {launches} flash launches")
    log(f"durability {label} drain_after={DRAIN_AFTER}: {len(queued)} queued "
        f"requests drained, {n_req - len(queued)} in flight finished; flash "
        f"launches over the resilient serves {launches} "
        f"({launches // cfg.n_layers} prefills incl. {len(replays)} replays "
        f"x {cfg.n_layers} layers)")
    del params, srv
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "flash_launches": launches,
            "chaos": {"hops": hops, "resumed_from": chaos.resumed_from,
                      "buckets": counts, "attempts": chaos.attempts,
                      "replay_prefixes": replays},
            "crash_resume": crash, "drained": len(queued)}


def _durability_ssm(device) -> dict:
    """mamba2-370m: crash-resume on a fresh server, shedding, a poison
    without retry (terminal), and the refused prefix replay."""
    cell = SLOT_CELLS[1]
    mod, cfg, params, prompts, arrivals, slots = _slot_setup(device, cell)
    n_req, T = cell["n_requests"], cell["T"]
    label = cfg.name
    srv = SlotServer(cfg, slots, device=device)
    mod.launches = 0
    clean = srv.serve(params, prompts, T, arrivals=arrivals)
    crash = _crash_resume(label, device, cfg, slots, params, prompts,
                          arrivals, T, clean, PREEMPT_AT[cfg.name],
                          str(SNAP_ROOT / "crash_ssm"))
    shed = srv.serve(params, prompts, T, arrivals=arrivals,
                     overload=OverloadPolicy(SSM_QUEUE_CAP, "reject-new"))
    b = _buckets(f"{label} shedding", shed, n_req, T)
    if not shed.shed or set(b.values()) != {"completed", "shed"}:
        raise AssertionError(f"{label} shedding: {shed.shed}")
    poison = ServeFaults(poisons=(SSM_POISON,))
    evicted = srv.serve(params, prompts, T, arrivals=arrivals, faults=poison)
    if evicted.evictions != {SSM_POISON[0]: SSM_POISON[1]} or \
            _buckets(f"{label} poison", evicted, n_req, T)[1] != "evicted":
        raise AssertionError(f"{label} poison: {evicted.evictions}")
    try:
        srv.serve(params, prompts, T, arrivals=arrivals, faults=poison,
                  retry=RetryPolicy(max_attempts=2))
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError(f"{label}: prefix replay was not refused")
    if "multiple of the chunk" not in refusal:
        raise AssertionError(f"{label}: refused with {refusal!r}")
    launches = mod.launches
    if launches == 0 or launches % cfg.n_layers:
        raise AssertionError(f"{label}: {launches} SSD launches")
    log(f"durability {label}: OverloadPolicy({SSM_QUEUE_CAP}, reject-new) "
        f"shed {sorted(shed.shed)}; slot_poison (rid, step) {SSM_POISON} "
        f"without retry: "
        f"terminal eviction {evicted.evictions}; with retry the prefix "
        f"replay is refused ({refusal}); SSD launches {launches}")
    del params, srv
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "ssd_launches": launches,
            "crash_resume": crash, "shed": len(shed.shed),
            "replay_refused": refusal}


def _first_difference(a, b):
    """The path of the first leaf where two states differ bitwise."""
    for (path, x), (_, y) in zip(tree_leaves_with_path(a),
                                 tree_leaves_with_path(b)):
        if x.dtype != y.dtype or not torch.equal(
                x.reshape(-1).view(torch.uint8), y.reshape(-1).view(
                    torch.uint8)):
            return path
    return None


#: the durability training's depth: 6 of qwen2-0.5b's 24 layers (its 14
#: leaves, so its launches, unchanged), cut from full depth to make room
#: for phase 23
DURABILITY_TRAIN_LAYERS = 6


def _durability_training(device) -> dict:
    """The training main path through the plan executor at
    ``DURABILITY_TRAIN_LAYERS``: without snapshots, with snapshots (the
    two uninterrupted runs must match bit for bit), then restored from
    round 4 and resumed (bit for bit)."""
    spec = _train_spec(arch_overrides=(("n_layers",
                                        DURABILITY_TRAIN_LAYERS),))
    job = spec.objective
    cfg = job.make_arch()
    groups, K = spec.n_workers, spec.rounds_per_launch
    tr = AsyncTrainer(cfg, opt=OptConfig(name=job.opt,
                                         lr=spec.stepsize.gamma,
                                         clip_norm=job.clip_norm,
                                         update_impl=job.update_impl),
                      async_cfg=AsyncConfig(delay_rounds=job.delay_rounds,
                                            microbatches=job.microbatches),
                      device=device)
    tr.n_groups = groups
    _, schedule = TrainerBackend.masks_for(spec, groups)
    plan = compile_plan(schedule, job, rounds=spec.T, n_groups=groups,
                        seed=spec.seed)
    ex = PlanExecutor(tr, plan)
    base = init_params(cfg, spec.seed, device)
    fresh = lambda: tr.init_state(params=tree_map(torch.clone, base))

    def timed(state, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ex.run_scan(state, rounds_per_launch=K, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    AU.reset_launches()
    plain, plain_s = timed(fresh())
    launches = AU.launches["fused_adam_delayed"]
    n_leaves = len(tree_leaves(base))
    if launches != spec.T * n_leaves:
        raise AssertionError(f"training: {launches} fused_adam_delayed "
                             f"launches, want {spec.T} x {n_leaves}")
    snapdir = str(SNAP_ROOT / "train")
    snap = _TimedSnapshotter(snapdir, TRAIN_SNAP_EVERY, keep=TRAIN_SNAP_KEEP)
    snapped, snap_s = timed(fresh(), snapshot=snap)
    diff = _first_difference(plain.state, snapped.state)
    if diff is not None or snapped.stats.snapshots != 2:
        raise AssertionError(f"training: two uninterrupted runs differ "
                             f"first at {diff} ({snapped.stats.snapshots} "
                             "snapshots)")
    snapped = None
    mid = snap.round_dir(TRAIN_SNAP_EVERY)
    t0 = time.perf_counter()
    restored = restore(mid, plain.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if int(restored["step"]) != TRAIN_SNAP_EVERY:
        raise AssertionError(f"training: restored step {restored['step']}")
    tail, _ = timed(restored, start_round=TRAIN_SNAP_EVERY)
    diff = _first_difference(plain.state, tail.state)
    if diff is not None:
        raise AssertionError(f"training: the resumed run differs from the "
                             f"uninterrupted one first at {diff}")
    nbytes = [load_meta(snap.round_dir(r))["state_nbytes"]
              for r in (TRAIN_SNAP_EVERY, spec.T)]
    finalise = sum(snap.finalise_s)
    row = {"arch": cfg.name, "rounds": spec.T, "snapshot_every": TRAIN_SNAP_EVERY,
           "fused_adam_delayed_launches": launches,
           "snapshot_bytes": nbytes, "offer_host_ms": snap.offer_ms,
           "finalise_s": snap.finalise_s, "restore_s": restore_s,
           "round_ms_plain": plain_s / spec.T * 1e3,
           "round_ms_snapshotted": snap_s / spec.T * 1e3,
           "round_ms_snapshotted_excl_finalise":
               (snap_s - finalise) / spec.T * 1e3}
    log(f"durability training ({cfg.name} L={cfg.n_layers} d={cfg.d_model}"
        f", {spec.T} rounds, "
        f"{K} per launch, AsyncSnapshotter every {TRAIN_SNAP_EVERY}, keep "
        f"{TRAIN_SNAP_KEEP}): fused_adam_delayed launches {launches}; the "
        f"snapshotted and the plain run bit-identical; restored round "
        f"{TRAIN_SNAP_EVERY} ({restore_s:.2f} s) and resumed: final state "
        f"bit-identical; snapshots {nbytes} bytes; host ms per offer "
        f"{[round(x, 3) for x in snap.offer_ms]}; finalise s "
        f"{[round(x, 3) for x in snap.finalise_s]}; per round: plain "
        f"{row['round_ms_plain']:.1f} ms, snapshotted "
        f"{row['round_ms_snapshotted']:.1f} ms "
        f"({row['round_ms_snapshotted_excl_finalise']:.1f} ms without the "
        "finalises)")
    del plain, tail, restored, base, ex, tr
    torch.cuda.empty_cache()
    return row


def phase_durability(device, card: str) -> dict:
    """Serving resilience on both slot cells and the training main path
    snapshotted and resumed, at full width; the snapshot directory is
    removed however the phase ends."""
    shutil.rmtree(SNAP_ROOT, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        out = {"card": card, "serve": [_durability_dense(device),
                                       _durability_ssm(device)],
               "training": _durability_training(device)}
        log(f"durability: every gate passed in "
            f"{time.perf_counter() - t0:.1f} s")
        return out
    finally:
        shutil.rmtree(SNAP_ROOT, ignore_errors=True)


def _fig1_problem(device):
    A, b = make_libsvm_like("w7a", n=10, seed=0)
    return LogRegProblem(A, b, lam=0.1, device=device)


def _fig2_problem(device):
    A, b = make_synthetic(1.0, 1.0, n=10, m=200, d=300, seed=0)
    return LogRegProblem(A, b, lam=0.1, batch_size=20, device=device)


def _theory_spec(prob, scheduler, timing, T, **kw):
    return ExperimentSpec(scheduler=scheduler, timing=timing, objective=prob,
                          T=T, stepsize=PAPER_GRID, log_every=100, seed=0,
                          **kw)


def _theory_run(label, spec, device, rows, data, backend=None):
    """One grid run through ``run``: timed, checked (finite grad norms, one
    host sync) and recorded in ``rows`` with ``data`` (the dataset's name
    and ζ(0))."""
    t0 = time.perf_counter()
    res = run(spec, backend=backend, device=device)
    wall = time.perf_counter() - t0
    e = res.extra
    finite = all(np.isfinite(g["grad_norms"]).all()
                 for g in res.grid.values())
    if not finite or not np.isfinite(res.x).all():
        raise AssertionError(f"{label}: non-finite iterate or grad norm")
    if e["host_syncs"] != 1:
        raise AssertionError(f"{label}: {e['host_syncs']} host syncs, not 1")
    row = {"cell": label, **data, "scheduler": spec.scheduler,
           "timing": spec.timing,
           "scenario": spec.scenario, "T": spec.T,
           "stochastic": spec.stochastic, "wall_s": wall,
           "loop_ms": e.get("loop_ms"), "runtime": e["runtime"],
           "graph_replays": e["graph_replays"], "host_syncs": e["host_syncs"],
           "gamma": res.gamma, "final_grad_norm": res.final_grad_norm,
           "tau_max": res.trace["tau_max"], "tau_c": res.trace["tau_c"]}
    rows.append(row)
    log(f"{label} {spec.scheduler} / {spec.timing}"
        f"{' / ' + spec.scenario if spec.scenario else ''}: wall "
        f"{wall:.3f} s, loop {row['loop_ms']} ms, {e['runtime']} route, "
        f"{e['graph_replays']} replays, γ = {res.gamma}, final grad norm "
        f"{res.final_grad_norm:.6g}")
    return res


def _same(label, got, want, fields=("x", "xs", "grad_norms")):
    for f in fields:
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{label}: {f} not bit-identical")


def _close(label, got, want):
    for f in ("x", "grad_norms"):
        a, b = getattr(got, f), getattr(want, f)
        if not np.allclose(a, b, **THEORY_TOL):
            raise AssertionError(
                f"{label}: {f} card against CPU off by "
                f"{np.max(np.abs(a - b)):.3g} (rtol 1e-4, atol 1e-6)")
        log(f"{label}: {f} card against CPU max abs err "
            f"{np.max(np.abs(a - b)):.3g}")


def _paper_ordering(label, results) -> None:
    """Logs the survey's ordering of the final grad norms (reported, not
    gated: the stand-in data decides it); ``results`` in the order of
    ``THEORY_SCHEDULERS``."""
    pure, rand, shuf = (r.final_grad_norm for r in results)
    log(f"paper ordering ({label}): shuffled {shuf:.6g} ≤ 1.5 × random "
        f"{rand:.6g}: {shuf <= 1.5 * rand}; random ≤ pure {pure:.6g}: "
        f"{rand <= pure}")


def phase_theory_tier(device) -> list:
    """The theory tier on the card (phase 13 of the module docstring)."""
    t0 = time.perf_counter()
    rows = []
    fig1 = _fig1_problem(device)
    w7a = {"dataset": "w7a stand-in", "zeta0": fig1.zeta(np.zeros(fig1.d))}
    log(f"w7a stand-in: zeta(0) = {w7a['zeta0']:.6g}")
    runs = {}
    for timing in THEORY_TIMINGS:
        for sched in THEORY_SCHEDULERS:
            res = runs[sched, timing] = _theory_run(
                "fig1", _theory_spec(fig1, sched, timing, THEORY_T), device,
                rows, w7a)
            # (b) the chosen γ's trajectory ≡ a solo replay of the schedule
            solo = replay(res.schedule, fig1.grad_fn(), np.zeros(fig1.d),
                          res.gamma, log_every=100,
                          full_grad_fn=fig1.full_grad, device=device)
            _same(f"fig1 {sched} / {timing}: grid ≡ solo", res, solo)
    log("fig1: the chosen γ's trajectory is bit-identical to a solo replay "
        "in all six runs")
    for timing in THEORY_TIMINGS:
        _paper_ordering(f"fig1 {timing}", [runs[s, timing]
                                           for s in THEORY_SCHEDULERS])

    # (b) graph route ≡ eager loop on the card, T = 3000
    graph = runs["shuffled", "poisson:slow=8"]
    eager = _theory_run("fig1_eager", graph.spec, device, rows, w7a,
                        backend=SimulatorBackend(device, capture=False))
    for g in PAPER_GRID:
        for f in ("grad_norms", "losses"):
            if not np.array_equal(graph.grid[g][f], eager.grid[g][f]):
                raise AssertionError(f"graph ≢ eager: γ {g} {f}")
    _same("graph ≡ eager", graph, eager, ("x", "xs", "grad_norms", "losses"))
    log("fig1: the graph route is bit-identical to capture=False at T = "
        f"{THEORY_T} (every γ's grad norms and losses)")

    # (c) the card against the CPU, full-gradient and stochastic lanes
    fig2 = _fig2_problem(device)
    syn = {"dataset": "Syn(1, 1)", "zeta0": fig2.zeta(np.zeros(fig2.d))}
    lanes = (("cpu_full", fig1, _fig1_problem, False, w7a),
             ("cpu_stochastic", fig2, _fig2_problem, True, syn))
    for label, prob, make, stochastic, data in lanes:
        spec = _theory_spec(prob, "shuffled", "poisson:slow=8", THEORY_CPU_T,
                            stochastic=stochastic)
        card = _theory_run(label, spec, device, rows, data)
        cpu = run(dataclasses.replace(spec, objective=make("cpu")),
                  device="cpu")
        if cpu.gamma != card.gamma:
            raise AssertionError(f"{label}: γ {card.gamma} on the card, "
                                 f"{cpu.gamma} on the CPU")
        _close(label, card, cpu)

    # (d) the Fig. 2 stochastic cell
    log(f"Syn(1, 1): zeta(0) = {syn['zeta0']:.6g}")
    _paper_ordering("fig2 poisson:slow=8", [
        _theory_run("fig2", _theory_spec(fig2, sched, "poisson:slow=8",
                                         THEORY_T, stochastic=True),
                    device, rows, syn)
        for sched in THEORY_SCHEDULERS])

    # (e) one scenario world through SimulatorBackend
    spec = _theory_spec(fig1, "pure", "poisson:slow=8", THEORY_T,
                        scenario=THEORY_SCENARIO)
    res = _theory_run("scenario", spec, device, rows, w7a,
                      backend=SimulatorBackend(device))
    world = realise_world(parse_scenario(THEORY_SCENARIO),
                          spec.make_scheduler(), spec.make_timing(),
                          THEORY_T, seed=spec.seed).schedule
    for f in ("workers", "assign_iters", "unfinished_assign_iters"):
        if not np.array_equal(getattr(res.schedule, f), getattr(world, f)):
            raise AssertionError(f"scenario schedule: {f} differs from "
                                 "the host realisation")
    log(f"scenario: the schedule equals the host realisation bit for bit "
        f"(tau_max {world.tau_max()}, tau_c {world.tau_c()})")
    del fig1, fig2
    torch.cuda.empty_cache()
    log(f"theory tier: {len(rows)} runs in {time.perf_counter() - t0:.1f} s")
    return rows


#: the scenario world on the training main path: every plan channel
#: (elastic availability, drifting data law, sparsified grads, NaN
#: receipts) and the guard rails
FAULT_SCENARIO = ("elastic:k=1,every=8,span=2;data_drift:a0=1.2,a1=2.0;"
                  "sparsify:frac=0.5;nan_grad:k=1,every=4,span=1")
FAULT_T = 16


def _fault_spec(**job_kw):
    job = TrainJob(**{**TRAIN_JOB, "guards": True, **job_kw})
    return ExperimentSpec(objective=job, **{**TRAIN_SPEC, "T": FAULT_T,
                                            "scenario": FAULT_SCENARIO})


def _health_replay(masks, bad, backoff=0.5, recover=1.25, min_scale=0.1):
    """JAX's health rule (src/repro/distributed/async_trainer.py) in numpy
    f32 over the run's masks and bad flags: (gscale per round, final
    health)."""
    f32 = np.float32
    h = np.ones(masks.shape[1], f32)
    gscale = []
    for part, b in zip(masks.astype(f32), bad):
        gscale.append(np.sum(h * part, dtype=f32) / max(np.sum(part), f32(1)))
        nxt = np.where(b, h * f32(backoff),
                       np.minimum(h * f32(recover), f32(1)))
        h = np.clip(np.where(part > 0, nxt, h), f32(min_scale), f32(1))
    return np.asarray(gscale, f32), h


def _sparsify_ms(device) -> float:
    """One round of the sparsifier over qwen2-0.5b's 14 bf16 grad leaves
    at density 0.5 (a sort per leaf), device time by events."""
    from repro_torch.distributed.async_trainer import sparsify

    gen = torch.Generator(device).manual_seed(5)
    grads = [torch.randn(n, generator=gen, device=device).bfloat16()
             for n in _main_leaves()]
    ms = time_ms(lambda: [sparsify(g, 0.5) for g in grads], iters=3,
                 warmup=1)
    del grads
    torch.cuda.empty_cache()
    return ms


def phase_faults(device, entry: dict, card: str, plain_ms: float) -> dict:
    """The training main path under a scenario world with every plan
    channel and the guard rails, at full width and depth, then one traced
    serve on the qwen2-0.5b slot cell; returns the ``faults`` line."""
    from repro_torch.obs import Recorder, validate_chrome_trace

    t0 = time.perf_counter()
    spec = _fault_spec()
    cfg = spec.objective.make_arch()
    groups, K, T = spec.n_workers, spec.rounds_per_launch, spec.T
    world = TrainerBackend.world_for(spec, groups)
    plan = compile_plan(world.schedule, spec.objective, rounds=T,
                        n_groups=groups, seed=spec.seed,
                        availability=world.availability,
                        zipf_as=world.zipf_as,
                        grad_density=world.grad_density,
                        fault_gain=world.fault_gain)
    poisoned = (np.isnan(plan.fault_gain) & (plan.masks > 0)).any(axis=1)
    if not poisoned.any() or not plan.summary()["sparsified"] or \
            plan.summary()["n_cdf_phases"] < 2 or \
            not (world.availability[:T] == 0).any():
        raise AssertionError(f"faults: the world lights too few channels: "
                             f"{plan.summary()}, poisoned {poisoned}")
    base = init_params(cfg, spec.seed, device)
    same = lambda c, d: tree_map(torch.clone, base)

    # (a) the guarded run: launches, skips, health, finite, timed warm
    stamps = {}
    AU.reset_launches()
    res = TrainerBackend(device, params_fn=same, on_step=lambda i, s, m:
                         stamps.setdefault(i, time.perf_counter())).run(spec)
    launched = dict(AU.launches)
    entry["launches"] = launched["fused_adam_delayed"]
    n_leaves = len(tree_leaves(res.x["params"]))
    want = dict.fromkeys(AU.KERNELS, 0)
    want["fused_adam_delayed"] = T * n_leaves
    if launched != want or res.extra["update_launches"] != want:
        raise AssertionError(f"faults: update launches {launched}, want "
                             f"{want}")
    rows = res.extra["metrics"]
    skipped = np.asarray([r["skipped"] for r in rows])
    if not np.array_equal(skipped, poisoned.astype(np.float64)):
        raise AssertionError(f"faults: skipped {skipped.tolist()}, the plan "
                             f"poisons {poisoned.astype(int).tolist()}")
    gscale, health = _health_replay(plan.masks, poisoned)
    got_h = res.x["guard"]["health"].cpu().numpy()
    got_g = np.asarray([r["gscale"] for r in rows], np.float32)
    if not (np.array_equal(got_h, health)
            and np.allclose(got_g, gscale, rtol=1e-6, atol=0)):
        raise AssertionError(f"faults: health {got_h} / gscale {got_g}, "
                             f"the replay {health} / {gscale}")
    losses = res.losses
    if not np.isfinite(losses[~poisoned]).all() or not all(
            torch.isfinite(t).all() for t in tree_leaves(res.x["params"])):
        raise AssertionError(f"faults: non-finite losses {losses} or params")
    warm = (stamps[2 * K - 1] - stamps[K - 1]) / K * 1e3
    log(f"faults: {cfg.name} L={cfg.n_layers} d={cfg.d_model}, T={T}, "
        f"{FAULT_SCENARIO}, guards: fused_adam_delayed launches "
        f"{entry['launches']} = {T} x {n_leaves} (skipped rounds launch at "
        f"run flag 0); skipped rounds {np.nonzero(poisoned)[0].tolist()} = "
        f"the plan's poisoned participants; health {got_h.tolist()} and "
        f"every round's gscale equal to the numpy replay of JAX's rule; "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; warm {warm:.3f} ms per "
        f"round (plain main path {plain_ms:.3f})")
    final = res.x
    res = None

    # (b) scan ≡ eager, bit for bit, every channel on
    eager = TrainerBackend(device, params_fn=same, runtime="eager").run(spec)
    diff = _first_difference(final, eager.x)
    if diff is not None or not np.array_equal(eager.losses, losses,
                                              equal_nan=True):
        raise AssertionError(f"faults: scan and eager differ first at {diff}")
    eager = None
    torch.cuda.empty_cache()

    # (c) the same spec on the reference update: curves within 5e-3
    ref = TrainerBackend(device, params_fn=same).run(_fault_spec(
        update_impl="reference"))
    ok = ~poisoned
    rel = np.abs(losses[ok] - ref.losses[ok]) / np.abs(ref.losses[ok])
    if not (np.isnan(ref.losses) == ~ok).all() or not (rel <= 5e-3).all():
        raise AssertionError(f"faults: pallas {losses} against reference "
                             f"{ref.losses}")
    log(f"faults: scan ≡ eager bit for bit; loss curve against "
        f"update_impl='reference' max rel diff {rel.max():.3e} (rtol 5e-3)")
    ref = None
    torch.cuda.empty_cache()

    # (d) unguarded, the same world poisons the params (the JAX contract)
    bare = TrainerBackend(device, params_fn=same).run(_fault_spec(
        guards=False))
    if all(torch.isfinite(t).all() for t in tree_leaves(bare.x["params"])):
        raise AssertionError("faults: the unguarded run stayed finite")
    bare = None
    torch.cuda.empty_cache()

    # (e) a skipped round, run eagerly: every leaf keeps its bits
    tr = AsyncTrainer(cfg, opt=OptConfig(lr=spec.stepsize.gamma,
                                         clip_norm=1.0,
                                         update_impl="pallas"),
                      async_cfg=AsyncConfig(
                          delay_rounds=1, guards=GuardConfig()),
                      device=device)
    tr.n_groups = groups
    ex = PlanExecutor(tr, plan)
    state = tr.init_state(params=tree_map(torch.clone, base))
    q = int(np.nonzero(poisoned)[0][0])
    for r in range(q):
        state, _ = ex._round(state, r)
    kept = {k: [t.clone() for t in tree_leaves(state[k])]
            for k in ("params", "opt", "gbuf")}
    AU.reset_launches()
    state, row = ex._round(state, q)
    torch.cuda.synchronize()
    if AU.launches["fused_adam_delayed"] != n_leaves or \
            row[METRICS.index("skipped")].item() != 1.0:
        raise AssertionError(f"faults: round {q} was not skipped")
    for k, old in kept.items():
        for i, (a, b) in enumerate(zip(tree_leaves(state[k]), old)):
            if not torch.equal(_bits(a) if a.is_floating_point() else a,
                               _bits(b) if b.is_floating_point() else b):
                raise AssertionError(f"faults: skipped round {q} changed "
                                     f"{k} leaf {i}")
    log(f"faults: round {q} run eagerly is skipped: {n_leaves} launches at "
        "run flag 0, params, m, v, gbuf and count bit-identical")
    del state, kept, ex, tr
    torch.cuda.empty_cache()

    # (f) a recorder changes nothing and traces every skip
    rec = Recorder()
    traced = TrainerBackend(device, params_fn=same, recorder=rec).run(spec)
    diff = _first_difference(final, traced.x)
    if diff is not None or not np.array_equal(traced.losses, losses,
                                              equal_nan=True):
        raise AssertionError(f"faults: the traced run differs at {diff}")
    events = validate_chrome_trace(rec.tracer.chrome_trace())
    skips = [e for e in rec.tracer.chrome_trace()["traceEvents"]
             if e["name"] == "guard_skip"]
    if len(skips) != int(poisoned.sum()):
        raise AssertionError(f"faults: {len(skips)} guard_skip instants")
    traced = final = None
    torch.cuda.empty_cache()
    sparsify_ms = _sparsify_ms(device)

    # (g) one traced serve on the qwen2-0.5b slot cell
    cell = SLOT_CELLS[0]
    mod, scfg, params, prompts, arrivals, slots = _slot_setup(device, cell)
    plain = SlotServer(scfg, slots, device=device).serve(
        params, prompts, cell["T"], arrivals=arrivals)
    srec = Recorder()
    server = SlotServer(scfg, slots, device=device, recorder=srec)
    served = server.serve(params, prompts, cell["T"], arrivals=arrivals)
    if not np.array_equal(served.tokens, plain.tokens):
        raise AssertionError("faults: the traced serve changed tokens")
    sevents = validate_chrome_trace(srec.tracer.chrome_trace())
    phases = srec.tracer.phase_table()
    admits = len(served.schedule.workers)
    if phases["admit"]["count"] != admits or \
            server.compile_counts() != {"chunk": 1}:
        raise AssertionError(f"faults: {phases['admit']['count']} admit "
                             f"spans for {admits} admissions, captures "
                             f"{server.compile_counts()}")
    del params, server
    torch.cuda.empty_cache()
    out = {"card": card, "arch": cfg.name, "T": T,
           "scenario": FAULT_SCENARIO, "plan": plan.summary(),
           "skipped_rounds": np.nonzero(poisoned)[0].tolist(),
           "fused_adam_delayed_launches": entry["launches"],
           "round_ms_scenario": warm, "round_ms_plain": plain_ms,
           "sparsify_ms_per_round": sparsify_ms,
           "train_trace_events": events,
           "serve_trace_events": sevents,
           "serve_admit_spans": phases["admit"]["count"]}
    log(f"faults: sparsifier {sparsify_ms:.3f} ms per round (14 leaves, "
        f"density 0.5); the traced run bit-identical to the untraced one, "
        f"{len(skips)} guard_skip instants, trace {events}; traced serve "
        f"({cfg.name} slot cell): tokens equal the untraced serve's, "
        f"{admits} admit spans, 1 capture, trace {sevents}; "
        f"{time.perf_counter() - t0:.1f} s")
    return out


#: phase 16, the trainer's lanes: the grid lane's γs and size, the
#: breaker's world
LANE_GRID = (1e-4, 3e-4, 1e-3)
LANE_GRID_T, LANE_GRID_K = 4, 2
BREAKER_SCENARIO = "corrupt_receipt:k=3,scale=1e4,every=4,span=2"
BREAKER_T = 16
POOLED = "pallas_pooled"


def _lane_trainer(cfg, device, lr, impl=POOLED, groups=4, mesh=None,
                  **async_kw):
    """An ``AsyncTrainer`` built as ``TrainerBackend`` builds the main
    path's (Adam, clip 1, delay 1), over ``mesh``'s ranks if one is
    given."""
    tr = AsyncTrainer(cfg, opt=OptConfig(lr=lr, clip_norm=1.0,
                                         update_impl=impl),
                      async_cfg=AsyncConfig(delay_rounds=1, **async_kw),
                      device=device, mesh=mesh)
    tr.n_groups = groups
    return tr


def _lane_plan(spec, rounds=None, **kw):
    world = TrainerBackend.world_for(spec, spec.n_workers)
    return world, compile_plan(
        world.schedule, spec.objective, rounds=rounds or spec.T,
        n_groups=spec.n_workers, seed=spec.seed,
        availability=world.availability, zipf_as=world.zipf_as,
        grad_density=world.grad_density, fault_gain=world.fault_gain, **kw)


def _pool_cols(cfg):
    lay = build_layout(param_specs(cfg), 1)
    if list(lay.cols) != ["bfloat16"]:
        raise AssertionError(f"{cfg.name}: pools {lay.cols}, want one bf16")
    return lay.cols["bfloat16"], lay


def _pooled_kernels(device, entries, lay, n_two) -> dict:
    """Each update kernel against its plain version at the pool shape its
    path gives it (``fused_adam_delayed``: the main path's pool, full
    depth; the other five: their paths' 2-layer pool), then timed on one
    main-path pool: one launch over all of it against 14 launches over its
    leaves' bands (the per-leaf route's calls), alternately, twice."""
    bf16 = torch.bfloat16
    n_main = lay.cols["bfloat16"]
    out = {}
    for name in AU.KERNELS:
        n = n_main if name == "fused_adam_delayed" else n_two
        base = _update_inputs(n, bf16, device, seed=11)
        scal = _scalar_sets(name, device)[-1][1]
        got = _apply(name, "cuda", tree_map(torch.clone, base), scal)
        torch.cuda.synchronize()
        want = _apply(name, "plain", tree_map(torch.clone, base), scal)
        rtol, atol = UPDATE_TOL[_kind(name)][bf16]
        worst = 0.0
        for key in _state_keys(name):
            err = (got[key].float() - want[key].float()).abs()
            bad = int((err > atol + rtol * want[key].float().abs()).sum())
            if bad or not torch.isfinite(got[key]).all():
                raise AssertionError(f"{name} at the pool shape n={n}: {key}"
                                     f" {bad} elements off its plain version")
            worst = max(worst, err.max().item())
            del err
        if _delayed(name) and not torch.equal(got["gb"], base["g"]):
            raise AssertionError(f"{name} at n={n}: gbuf' != g bitwise")
        del base, want, got
        torch.cuda.empty_cache()
        out[name] = {"checked_elements": n, "max_abs_err": worst}
    pool = _update_inputs(n_main, bf16, device, seed=12)
    bands = [{k: v[s.col:s.col + s.size] for k, v in pool.items()}
             for s in lay.groups["bfloat16"]]
    for name in AU.KERNELS:
        scal = _scalar_sets(name, device)[-1][1]
        ms = {}
        for route in ("leaves", "pool", "leaves", "pool"):  # 2nd of each
            ms[route] = time_ms(
                (lambda: _apply(name, "cuda", pool, scal)) if route == "pool"
                else (lambda: [_apply(name, "cuda", b, scal) for b in bands]),
                iters=10)
        out[name].update(pooled_ms=ms["pool"], per_leaf_ms=ms["leaves"],
                         bound_ms=entries[name]["bound_ms"])
        log(f"{name} pooled: n={out[name]['checked_elements']:,} against its"
            f" plain version, max abs err {out[name]['max_abs_err']:.3e}; "
            f"over one {n_main:,}-element pool: one launch "
            f"{ms['pool']:.4f} ms, 14 launches over its leaves "
            f"{ms['leaves']:.4f} ms (bound {entries[name]['bound_ms']:.4f} "
            "ms)")
    del pool, bands
    torch.cuda.empty_cache()
    return out


def _timed_scan(ex, state, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ex.run_scan(state, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _lane_pooled_main(device, entries, train, base, spec, cfg, out):
    """(a) the pooled main path: launches, curves, finite params, warm
    ms per round; then a run snapshotted at round 4, restored and
    resumed, bit for bit.  Returns the final state."""
    T, K = spec.T, spec.rounds_per_launch
    same = lambda c, d: tree_map(torch.clone, base)
    stamps = {}
    AU.reset_launches()
    res = TrainerBackend(device, params_fn=same, on_step=lambda i, s, m:
                         stamps.setdefault(i, time.perf_counter())).run(spec)
    launched = dict(AU.launches)
    want = {**dict.fromkeys(AU.KERNELS, 0), "fused_adam_delayed": T}
    if launched != want or res.extra["update_launches"] != want:
        raise AssertionError(f"lanes: pooled launches {launched}, want "
                             f"{want}")
    entries["fused_adam_delayed"]["launches"] = T
    _check_curves(res, "pooled main path")
    rel = np.abs(res.losses - train["ref_losses"]) / np.abs(
        train["ref_losses"])
    if not (rel <= 5e-3).all():
        raise AssertionError(f"lanes: pooled {res.losses} against the "
                             f"reference {train['ref_losses']}")
    per_leaf = float(np.abs(res.losses - train["losses"]).max())
    tr = _lane_trainer(cfg, device, spec.stepsize.gamma)
    if not all(torch.isfinite(t).all() for t in
               tree_leaves(tr.params_of(res.x))):
        raise AssertionError("lanes: pooled params not finite")
    warm = (stamps[2 * K - 1] - stamps[K - 1]) / K * 1e3
    out.update(pooled_launches=T, per_leaf_launches=T * 14,
               round_ms_pooled=warm, round_ms_per_leaf=train["warm_ms"],
               max_rel_pooled_vs_reference=float(rel.max()),
               max_abs_pooled_vs_per_leaf=per_leaf)
    log(f"lanes (a): pooled main path {cfg.name} L={cfg.n_layers}: "
        f"fused_adam_delayed launches {T} (one bf16 pool x {T} rounds, "
        f"per leaf {T * 14}); max rel diff to the reference {rel.max():.3e}"
        f" (rtol 5e-3); max abs diff to the per-leaf curve {per_leaf:.3e};"
        f" params finite; warm {warm:.3f} ms per round (per leaf "
        f"{train['warm_ms']:.3f})")
    final, losses = res.x, res.losses
    res = None

    # snapshotted at round 4 (a 4-round head of the same plan), restored,
    # resumed: the uninterrupted run's state bit for bit
    _, head = _lane_plan(spec, rounds=4)
    _, plan = _lane_plan(spec)
    snapdir = SNAP_ROOT / "lanes"
    shutil.rmtree(snapdir, ignore_errors=True)
    try:
        snap = AsyncSnapshotter(str(snapdir), 4, keep=1)
        PlanExecutor(tr, head).run_scan(
            tr.init_state(params=tree_map(torch.clone, base)),
            rounds_per_launch=K, metrics="none", snapshot=snap)
        r, path = AsyncSnapshotter.latest(str(snapdir))
        restored = restore(path, final)
        tail = PlanExecutor(tr, plan).run_scan(
            restored, rounds_per_launch=K, start_round=r)
    finally:
        shutil.rmtree(snapdir, ignore_errors=True)
    diff = _first_difference(final, tail.state)
    if r != 4 or diff is not None or not np.array_equal(
            tail.metrics["loss"], losses[4:]):
        raise AssertionError(f"lanes: the pooled run resumed at {r} differs"
                             f" first at {diff}")
    log("lanes (a): a pooled run snapshotted at round 4, restored and "
        "resumed: final pools, count and step bit-identical, curve equal")
    del tail, restored
    torch.cuda.empty_cache()
    return final, losses


def _lane_other_kernels(device, entries, out):
    """(b) the other five kernels through pools at 2 layers, T 2: one
    launch per round each, curve within 5e-3 of its per-leaf route."""
    rows = {}
    base = init_params(_momentum_spec(0).objective.make_arch(),
                       TRAIN_SPEC["seed"], device)
    same = lambda c, d: tree_map(torch.clone, base)
    for name, opt, delay in OTHER_PATHS:
        spec = _train_spec(T=2, opt=opt, delay_rounds=delay,
                           arch_overrides=(("n_layers", 2),),
                           update_impl=POOLED)
        AU.reset_launches()
        res = TrainerBackend(device, params_fn=same).run(spec)
        pooled, launched = res.losses, dict(AU.launches)
        leaf = TrainerBackend(device, params_fn=same).run(
            dataclasses.replace(spec, objective=dataclasses.replace(
                spec.objective, update_impl="pallas"))).losses
        rows[name] = (launched, pooled, leaf)
    for name, delay in MOMENTUM_PATHS:
        AU.reset_launches()
        pooled = _momentum_curve(device, delay, POOLED, base)
        launched = dict(AU.launches)
        rows[name] = (launched, pooled, _momentum_curve(device, delay,
                                                        "pallas", base))
    for name, (launched, pooled, leaf) in rows.items():
        want = {**dict.fromkeys(AU.KERNELS, 0), name: 2}
        rel = np.abs(pooled - leaf) / np.abs(leaf)
        if launched != want or not (np.isfinite(pooled).all()
                                    and (rel <= 5e-3).all()):
            raise AssertionError(f"lanes (b): {name} pooled launches "
                                 f"{launched}, curve {pooled} against the "
                                 f"per-leaf {leaf}")
        entries[name]["launches"] = 2
        out.setdefault("other_paths", {})[name] = {
            "launches": 2, "max_rel_vs_per_leaf": float(rel.max())}
        log(f"lanes (b): {name} through its pool (2 layers, T 2): 2 "
            f"launches; max rel diff to the per-leaf route {rel.max():.3e}")
    del base
    torch.cuda.empty_cache()


def _lane_skip_gate(device, out):
    """(c) the scenario cell of phase 15 on the pooled route at 2 layers:
    16 launches, skipped = the poisoned rounds, and a skipped round run
    eagerly leaves every pool and the count bit-identical."""
    spec = _fault_spec(update_impl=POOLED,
                       arch_overrides=(("n_layers", 2),))
    cfg = spec.objective.make_arch()
    _, plan = _lane_plan(spec)
    poisoned = (np.isnan(plan.fault_gain) & (plan.masks > 0)).any(axis=1)
    base = init_params(cfg, spec.seed, device)
    AU.reset_launches()
    res = TrainerBackend(device, params_fn=lambda c, d: tree_map(
        torch.clone, base)).run(spec)
    launched = dict(AU.launches)
    skipped = np.asarray([r["skipped"] for r in res.extra["metrics"]])
    if launched["fused_adam_delayed"] != FAULT_T or \
            not np.array_equal(skipped, poisoned.astype(np.float64)):
        raise AssertionError(f"lanes (c): launches {launched}, skipped "
                             f"{skipped}, poisoned {poisoned}")
    res = None
    tr = _lane_trainer(cfg, device, spec.stepsize.gamma,
                       guards=GuardConfig())
    ex = PlanExecutor(tr, plan)
    state = tr.init_state(params=tree_map(torch.clone, base))
    q = int(np.nonzero(poisoned)[0][0])
    for r in range(q):
        state, _ = ex._round(state, r)
    kept = [t.clone() for t in tree_leaves({"pools": state["pools"],
                                            "opt": state["opt"]})]
    AU.reset_launches()
    state, row = ex._round(state, q)
    torch.cuda.synchronize()
    now = tree_leaves({"pools": state["pools"], "opt": state["opt"]})
    if AU.launches["fused_adam_delayed"] != 1 or \
            row[METRICS.index("skipped")].item() != 1.0 or not all(
                torch.equal(_bits(a) if a.is_floating_point() else a,
                            _bits(b) if b.is_floating_point() else b)
                for a, b in zip(now, kept)):
        raise AssertionError(f"lanes (c): round {q} through the pools was "
                             "not skipped bit for bit")
    out["skip_gate"] = {"launches": FAULT_T,
                        "skipped_rounds": np.nonzero(poisoned)[0].tolist()}
    log(f"lanes (c): {FAULT_SCENARIO} guarded on the pooled route (2 layers,"
        f" T {FAULT_T}): {FAULT_T} launches, skipped rounds "
        f"{np.nonzero(poisoned)[0].tolist()}; round {q} run eagerly: one "
        "launch at run flag 0, every pool and the count bit-identical")
    del state, kept, now, ex, tr, base
    torch.cuda.empty_cache()


def _lane_tap(device, base, spec, cfg, out):
    """(d) tap at full width: rows bit-equal to chunk's, no host sync, a
    row per round, ms per round against chunk; then the breaker on a
    corrupted world trips and the curve covers whole chunks only."""
    T, K = spec.T, spec.rounds_per_launch
    tr = _lane_trainer(cfg, device, spec.stepsize.gamma)
    _, plan = _lane_plan(spec)
    ex = PlanExecutor(tr, plan)
    fresh = lambda: tr.init_state(params=tree_map(torch.clone, base))
    runs = {"chunk": [], "tap": []}
    for mode in ("chunk", "tap") * 3:            # alternately; the median
        runs[mode].append(_timed_scan(ex, fresh(), rounds_per_launch=K,
                                      metrics=mode))
    chunk, tap = runs["chunk"][-1][0], runs["tap"][-1][0]
    chunk_s = float(np.median([secs for _, secs in runs["chunk"]]))
    tap_s = float(np.median([secs for _, secs in runs["tap"]]))
    if any(not np.array_equal(tap.metrics[k], chunk.metrics[k])
           for k in METRICS) or (tap.host_syncs, tap.tap_events,
                                 tap.launches) != (0, T, T // K):
        raise AssertionError(f"lanes (d): tap rows differ from chunk's or "
                             f"accounting {tap.stats}")
    out.update(round_ms_tap=tap_s / T * 1e3, round_ms_chunk=chunk_s / T *
               1e3, tap_waits=tap.stats.tap_waits)
    log(f"lanes (d): tap at full width: {T} rows bit-equal to chunk's, "
        f"host_syncs 0, tap_events {T}, launches {T // K}, ring waits "
        f"{tap.stats.tap_waits}; {tap_s / T * 1e3:.3f} ms per round against "
        f"chunk {chunk_s / T * 1e3:.3f} (median of 3 alternate runs each; "
        f"tap {[round(x / T * 1e3, 3) for _, x in runs['tap']]}, chunk "
        f"{[round(x / T * 1e3, 3) for _, x in runs['chunk']]})")
    runs = chunk = tap = None
    torch.cuda.empty_cache()

    bspec = dataclasses.replace(_train_spec(T=BREAKER_T, update_impl=POOLED),
                                scenario=BREAKER_SCENARIO)
    br = DivergenceBreaker(window=3, factor=5.0)
    res = TrainerBackend(device, params_fn=lambda c, d: tree_map(
        torch.clone, base), metrics="tap", breaker=br).run(bspec)
    n, trip = len(res.losses), res.extra["tripped_round"]
    if trip is None or trip != br.tripped_round or n % K or \
            not trip < n <= BREAKER_T or res.extra["tap_events"] != n or \
            res.extra["launches"] != n // K:
        raise AssertionError(f"lanes (d): breaker trip {trip}, {n} rounds, "
                             f"extra {res.extra['launches']} launches")
    out["breaker"] = {"scenario": BREAKER_SCENARIO, "tripped_round": trip,
                      "rounds_launched": n, "of": BREAKER_T,
                      "tap_waits": res.extra["tap_waits"]}
    log(f"lanes (d): breaker (window 3, factor 5) on {BREAKER_SCENARIO}, "
        f"unguarded, T {BREAKER_T}, K {K}: tripped at round {trip}; {n} "
        f"rounds launched in {n // K} whole chunks; loss max "
        f"{res.losses.max():.4g}")
    del res, tr, ex
    torch.cuda.empty_cache()


def _lane_grid(device, base, cfg, out):
    """(e) the grid lane at full width: every point's curve and final
    state bit-identical to its solo run; the lane's seconds against the
    three solo runs'; the same spec through ``run`` takes the lane."""
    spec = dataclasses.replace(
        _train_spec(T=LANE_GRID_T, update_impl=POOLED),
        stepsize=LANE_GRID, rounds_per_launch=LANE_GRID_K)
    _, gplan = _lane_plan(spec, grid_gammas=LANE_GRID)
    _, plan = _lane_plan(spec)
    tr = _lane_trainer(cfg, device, LANE_GRID[0])
    ex = PlanExecutor(tr, gplan)
    for _ in range(2):                           # the second is warm
        grid_res = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid_res = ex.run_grid(tr.init_state(params=tree_map(torch.clone,
                                                             base)),
                               rounds_per_launch=LANE_GRID_K)
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
    solo_s = []
    for i, g in enumerate(LANE_GRID):
        tri = _lane_trainer(cfg, device, g)
        solo, secs = _timed_scan(
            PlanExecutor(tri, plan),
            tri.init_state(params=tree_map(torch.clone, base)),
            rounds_per_launch=LANE_GRID_K)
        solo_s.append(secs)
        for k in METRICS:
            if not np.array_equal(grid_res.metrics[k][i], solo.metrics[k]):
                raise AssertionError(f"lanes (e): γ={g} {k} "
                                     f"{grid_res.metrics[k][i]} against solo"
                                     f" {solo.metrics[k]}")
        for (path, a), b in zip(tree_leaves_with_path(grid_res.state),
                                tree_leaves(solo.state)):
            if not torch.equal(a[i], b):
                raise AssertionError(f"lanes (e): γ={g} differs from its "
                                     f"solo run at {path}")
        del solo, tri
    losses = grid_res.metrics["loss"]
    grid_res = ex = None
    torch.cuda.empty_cache()
    res = TrainerBackend(device, params_fn=lambda c, d: tree_map(
        torch.clone, base)).run(spec)
    best = LANE_GRID.index(res.gamma)
    if not res.extra.get("grid_lane") or not np.array_equal(
            res.losses, losses[best]):
        raise AssertionError(f"lanes (e): run() took {res.extra.get('grid_lane')}"
                             f", best γ {res.gamma}")
    res = None
    torch.cuda.empty_cache()
    out["grid"] = {"gammas": list(LANE_GRID), "T": LANE_GRID_T,
                   "K": LANE_GRID_K, "lane_s": grid_s, "solo_s": solo_s,
                   "best_gamma": LANE_GRID[best]}
    log(f"lanes (e): grid lane {LANE_GRID} at full width, T {LANE_GRID_T}, "
        f"K {LANE_GRID_K}: every point's curve and final pools "
        f"bit-identical to its solo run; lane {grid_s:.2f} s against solo "
        f"{sum(solo_s):.2f} s ({[round(x, 2) for x in solo_s]}); run() took"
        f" the lane, best γ {LANE_GRID[best]}")


def _lane_remat(device, base, spec, out):
    """(f) remat="full" on the pooled main path: the curve within 1e-6
    relative of remat="none"'s, and a lower peak."""
    same = lambda c, d: tree_map(torch.clone, base)
    K = spec.rounds_per_launch
    curves, peaks, warm = {}, {}, {}
    for remat in ("none", "full"):
        rspec = dataclasses.replace(spec, objective=dataclasses.replace(
            spec.objective, remat=remat))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stamps = {}
        res = TrainerBackend(device, params_fn=same, on_step=lambda i, s, m:
                             stamps.setdefault(i, time.perf_counter())).run(
            rspec)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2**30
        warm[remat] = (stamps[2 * K - 1] - stamps[K - 1]) / K * 1e3
        curves[remat] = res.losses
        res = None
    rel = np.abs(curves["full"] - curves["none"]) / np.abs(curves["none"])
    if not (rel <= 1e-6).all() or not peaks["full"] < peaks["none"]:
        raise AssertionError(f"lanes (f): remat curve {curves['full']} "
                             f"against {curves['none']}, peaks {peaks}")
    out.update(peak_gib_remat=peaks["full"], peak_gib_no_remat=peaks["none"],
               round_ms_remat=warm["full"], round_ms_no_remat=warm["none"],
               max_rel_remat=float(rel.max()))
    log(f"lanes (f): remat='full' on the pooled main path: max rel diff to "
        f"remat='none' {rel.max():.3e} (1e-6); peak {peaks['full']:.2f} GiB "
        f"against {peaks['none']:.2f} GiB; warm {warm['full']:.3f} ms per "
        f"round against {warm['none']:.3f}")


def phase_trainer_lanes(device, entries: dict, card: str,
                        train: dict) -> dict:
    """The trainer's lanes at full width: the pooled update (its kernels
    at the pool shapes, the main path, the other five kernels, the skip
    gate), tap and the breaker, the grid lane and remat; returns the
    ``trainer_lanes`` line."""
    t0 = time.perf_counter()
    spec = _train_spec(update_impl=POOLED)
    cfg = spec.objective.make_arch()
    n_main, lay = _pool_cols(cfg)
    n_two, _ = _pool_cols(cfg.with_(n_layers=2))
    out = {"card": card, "arch": cfg.name, "pool_elements": n_main,
           "pool_leaves": lay.n_leaves}
    out["kernels"] = _pooled_kernels(device, entries, lay, n_two)

    # the grad pooling's device time: the round's 14 bf16 grads → one pool
    gen = torch.Generator(device).manual_seed(13)
    grads = tree_map(lambda s: torch.randn(s.shape, generator=gen,
                                           device=device).bfloat16(),
                     param_specs(cfg))
    out["grad_pool_ms"] = time_ms(lambda: pool_tree(lay, grads), iters=10)
    log(f"lanes: pooling one round's {lay.n_leaves} grads ({n_main:,} bf16 "
        f"elements) {out['grad_pool_ms']:.4f} ms")
    del grads
    torch.cuda.empty_cache()

    base = init_params(cfg, spec.seed, device)
    final, _ = _lane_pooled_main(device, entries, train, base, spec, cfg,
                                 out)
    del final
    torch.cuda.empty_cache()
    _lane_other_kernels(device, entries, out)
    _lane_skip_gate(device, out)
    _lane_tap(device, base, spec, cfg, out)
    _lane_grid(device, base, cfg, out)
    _lane_remat(device, base, spec, out)
    del base
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"trainer lanes: every gate passed in {out['seconds']:.1f} s")
    return out


#: the hybrid and MoE families (phase 17): full width, bf16, both kernel
#: switches on (the SSD switch is inert on the MoE)
FAMILY_ARCHS = ("zamba2-7b", "deepseek-moe-16b")
FAMILY_REDUCED = False
FAMILY_SWITCHES = (("use_flash_attention", True), ("use_ssd_kernel", True))
FAMILY_LOCK = dict(batch=4, prompt_len=1024, T=16, seed=0)
FAMILY_DECODE_STEPS = 8
#: the depth at which each arch's prefill is held kernels ≡ plain in f32
#: (zamba2-7b: one insertion of the shared block and a 3-layer tail); bf16
#: is held at 2 layers and reported at this depth
FAMILY_PLAIN_LAYERS = {"zamba2-7b": 9, "deepseek-moe-16b": 4}
#: (T 16 and 12 requests, not 32 and 16, keep the whole script inside its
#: 1200 s; 12 requests in 8 slots still reuse slots)
FAMILY_SLOT = dict(n_slots=8, n_requests=12, prompt_len=512, T=16,
                   arrival="poisson:gap=2")
#: slot ≡ lock-step on the hybrid: full width, 9 layers, f32, TF32 off
#: (T 16, not 32, for the script's time)
FAMILY_PARITY = dict(arch="zamba2-7b", n_layers=9, batch=4, prompt_len=512,
                     T=16)
#: (arch, B, Sq, Sk, H, KV, D, causal, window): each family's prefill
FAMILY_FLASH_SHAPES = (
    ("zamba2-7b", 4, 1024, 1024, 32, 32, 112, True, None),
    ("deepseek-moe-16b", 4, 1024, 1024, 16, 16, 128, True, None))
#: (arch, B, nc, c, H, P, N): zamba2-7b's prefill
FAMILY_SSD_SHAPE = ("zamba2-7b", 4, 8, 128, 112, 64, 64)


def _family_counts(cfg) -> dict:
    """Flash and SSD launches of one prefill: one flash per attention
    block (the hybrid's g insertions), one SSD per Mamba2 layer."""
    if cfg.family == "hybrid":
        return {"flash": cfg.n_layers // cfg.attn_every, "ssd": cfg.n_layers}
    return {"flash": cfg.n_layers, "ssd": 0}


def _cut_depth(params, cfg):
    """Views of full-depth params at ``cfg``'s smaller depth: each stacked
    leaf's first rows (the hybrid's tail keeps its own layers)."""
    return tree_map(lambda s, p: p if tuple(p.shape) == s.shape
                    else p[:s.shape[0]], param_specs(cfg), params)


def _prefill_plain_kernels(cfg, params, batch):
    """Last-token logits of a prefill of ``batch`` whose
    ``ops.flash_attention`` and ``ops.ssd_chunk`` calls go to the kernels'
    plain versions: the same branches and casts as the kernels' prefill,
    on the card."""
    routed = ops.flash_attention, ops.ssd_chunk
    ops.flash_attention = FA.flash_attention_plain
    ops.ssd_chunk = SSD.ssd_chunk_plain
    try:
        return prefill(cfg, params, batch)[0]
    finally:
        ops.flash_attention, ops.ssd_chunk = routed


def _routes(fseen, sseen) -> dict:
    return {"flash": sorted({FA.route(getattr(torch, d[0])) for d in fseen}),
            "ssd": sorted({SSD.route(getattr(torch, d[0]),
                                     getattr(torch, d[3])) for d in sseen})}


def _counted_run(label, spec, device, want) -> tuple:
    """``run(spec)`` with both kernels' counts set to 0 before and read
    after; each must equal ``want`` and every launch take the tensor-core
    route.  Returns (result, launches, peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    FA.launches = 0
    _zero_ssd()
    with _dtypes_seen(FA, "flash_attention_cuda") as fseen, \
            _dtypes_seen(SSD, "ssd_chunk_cuda") as sseen:
        res = run(spec, device=device)
    got = {"flash": FA.launches, "ssd": SSD.launches}
    if want["ssd"]:
        _ssd_designs(label)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if got != want or {"flash": res.extra["flash_launches"],
                       "ssd": res.extra["ssd_launches"]} != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    routes = _routes(fseen, sseen)
    for name in ("flash", "ssd"):
        if routes[name] != (["tensor_cores"] if want[name] else []):
            raise AssertionError(f"{label}: {name} routes {routes[name]}")
    return res, got, peak


def _flash_rows(device, shapes, tag) -> list:
    """Flash at each of ``shapes`` ((label, B, Sq, Sk, H, KV, D, causal,
    window)) against its plain version (f32 and bf16), then bf16 timed on
    the device with its plain version, its bound and SDPA (GQA)."""
    rows = []
    for label, B, Sq, Sk, H, KV, D, causal, window in shapes:
        kw = dict(causal=causal, window=window)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(B, Sq, Sk, H, KV, D, dtype, device)
            err, bad = _compare(FA.flash_attention_cuda(q, k, v, **kw),
                                FA.flash_attention_plain(q, k, v, **kw),
                                TOL[dtype])
            log(f"{tag}: flash {label} {str(dtype)[6:]}: max_abs_err="
                f"{err:.3e} (tol {TOL[dtype]:g}) bad={bad}")
            if bad:
                raise AssertionError(f"flash disagrees with its plain "
                                     f"version at {label}'s shape {dtype}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {"kernel": "flash_attention", "arch": label,
               "shape": [B, Sq, Sk, H, KV, D], "causal": causal,
               "max_abs_err": err,
               "ms": device_ms(lambda: FA.flash_attention_cuda(q, k, v, **kw)),
               "plain_ms": device_ms(
                   lambda: FA.flash_attention_plain(q, k, v, **kw), iters=2),
               "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=True))}
        row["bound_ms"], row["bound_by"] = flash_bound(q, k, **kw)
        rows.append(row)
        del q, k, v, qt, kt, vt
    return rows


def _ssd_rows(device, shapes, tag) -> list:
    """SSD at each of ``shapes`` ((label, B, nc, c, H, P, N)) against its
    plain version (f32 and bf16), then bf16 timed on the device with its
    plain version and its bound."""
    rows = []
    for label, *shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(*shape, dtype, device)
            (y, st), (wy, wst) = (SSD.ssd_chunk_cuda(*args),
                                  SSD.ssd_chunk_plain(*args))
            (ey, by), (es, bs) = (_compare(y, wy, SSD_TOL[dtype]),
                                  _compare(st, wst, SSD_TOL[dtype]))
            log(f"{tag}: ssd {label} {str(dtype)[6:]}: max_abs_err y "
                f"{ey:.3e} states {es:.3e} (tol {SSD_TOL[dtype]:g}) "
                f"bad={by + bs}")
            if by or bs:
                raise AssertionError(f"ssd disagrees with its plain version "
                                     f"at {label}'s shape {dtype}")
            del y, st, wy, wst
        row = {"kernel": "ssd_chunk", "arch": label, "shape": shape,
               "max_abs_err": max(ey, es),
               "ms": device_ms(lambda: SSD.ssd_chunk_cuda(*args)),
               "plain_ms": device_ms(lambda: SSD.ssd_chunk_plain(*args),
                                     iters=5),
               "sdpa_ms": None}
        row["bound_ms"], row["bound_by"] = ssd_bound(args[0], args[3])
        rows.append(row)
        del args
    return rows


def _family_kernel_rows(device) -> list:
    """Flash at each family's prefill shape and SSD at zamba2-7b's: each
    against its plain version (f32 and bf16), then bf16 timed on the
    device with its plain version, its bound and (flash) SDPA."""
    rows = (_flash_rows(device, FAMILY_FLASH_SHAPES, "families")
            + _ssd_rows(device, (FAMILY_SSD_SHAPE,), "families"))
    for r in rows:
        log(f"families: {r['kernel']} at {r['arch']}'s shape {r['shape']} "
            f"bf16: device time per call: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, sdpa {r['sdpa_ms']}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()
    return rows


def _family_lockstep(device, arch, out) -> tuple:
    """The lock-step lane through ``run``: launches per prefill, routes,
    finite logits and the token matrix; appends the lane's row to
    ``out["rows"]`` and returns (cfg, prompts)."""
    s = FAMILY_LOCK
    job = ServeJob(arch=arch, reduced=FAMILY_REDUCED, batch=s["batch"],
                   prompt_len=s["prompt_len"], arch_overrides=FAMILY_SWITCHES)
    cfg = job.make_arch()
    want = _family_counts(cfg)
    res, launches, peak = _counted_run(
        f"{arch} lock-step", ExperimentSpec(objective=job, T=s["T"],
                                            seed=s["seed"]), device, want)
    if not res.extra["logits_finite"]:
        raise AssertionError(f"{arch}: non-finite logits")
    x = res.x
    if x.shape != (s["batch"], s["T"]) or x.min() < 0 or x.max() >= cfg.vocab:
        raise AssertionError(f"{arch}: bad token matrix {x.shape}")
    log(f"families: {arch} L={cfg.n_layers} d={cfg.d_model} lock-step "
        f"through run: batch {s['batch']}, prompt {s['prompt_len']}, "
        f"T={s['T']}: launches {launches} per prefill on the tensor-core "
        f"routes, {res.extra['tok_per_s']:.1f} tok/s, peak {peak:.2f} GiB")
    out["rows"].append(dict(arch=arch, lane="lockstep", **launches,
                            run_tok_per_s=res.extra["tok_per_s"],
                            peak_gib=peak))
    prompts = res.extra["prompts"]
    del res
    return cfg, prompts


def _family_profile(device, cfg, params, prompts, row) -> None:
    """A warm prefill and ``FAMILY_DECODE_STEPS`` lock-step decode steps
    timed with the host clock, then the same under the profiler (its
    device time and idle share; the profiler slows the host)."""
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                       device=device)}
    _serve_profile(cfg, params, batch, FAMILY_DECODE_STEPS, row, "families")


def _serve_profile(cfg, params, batch, steps, row, tag) -> None:
    """``_family_profile`` on any prefill ``batch`` (tokens, plus frames or
    patches): a warm prefill and ``steps`` decode steps from its cache."""
    n, plen = batch["tokens"].shape
    ctx = plen + steps
    server = Server(cfg, ServeConfig(batch=n, ctx_len=ctx),
                    device=batch["tokens"].device)

    def pre():
        last, cache = prefill(cfg, params, batch, ctx_len=ctx)
        return torch.argmax(last, dim=-1).cpu().numpy(), cache

    def dec(first, cache):
        return lambda: server.generate(params, first, steps, start_pos=plen,
                                       cache=cache)

    first, cache = pre()                                         # warm-up
    dec(first, cache)()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, cache = pre()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dec(first, cache)()
    t2 = time.perf_counter()
    (first, cache), pre_wall, pre_k, _ = profiled(pre)
    _, dec_wall, dec_k, _ = profiled(dec(first, cache))
    row.update(
        prefill_wall_ms=(t1 - t0) * 1e3,
        decode_wall_ms_per_step=(t2 - t1) / steps * 1e3,
        tok_per_s=n * steps / (t2 - t1),
        prefill_device_ms=sum(ms for ms, _ in pre_k.values()),
        prefill_idle_share=idle_share(pre_k, pre_wall),
        decode_device_ms_per_step=sum(ms for ms, _ in dec_k.values()) / steps,
        decode_idle_share=idle_share(dec_k, dec_wall))
    log(f"{tag}: {cfg.name} lock-step (warm): prefill "
        f"{row['prefill_wall_ms']:.2f} ms, decode "
        f"{row['decode_wall_ms_per_step']:.2f} ms/step = "
        f"{row['tok_per_s']:.1f} tok/s; profiled: prefill "
        f"{row['prefill_device_ms']:.2f} ms device, idle "
        f"{row['prefill_idle_share']:.3f}; decode "
        f"{row['decode_device_ms_per_step']:.3f} ms/step device, idle "
        f"{row['decode_idle_share']:.3f}")
    del cache, server


def _family_plain_gate(device, cfg, params, prompts) -> dict:
    """The prefill at full width and reduced depth with the kernels,
    against their plain versions in the same branches and against both
    switches off.  Gated in f32 (the kernels' CUDA-core routes) at
    ``FAMILY_PLAIN_LAYERS`` (zamba2-7b: one insertion and a 3-layer tail),
    within the f32 tolerance, and on the hybrid in bf16 (the tensor-core
    routes) against the plain versions at 2 layers, within 3e-2; reported
    otherwise.  Each kernel's bf16 output is within an ulp of its plain
    version's (the kernel checks above), but the model amplifies that:
    through 9 Mamba2 layers to 6.25e-2, and on the MoE an ulp moves a
    token across a routing or capacity boundary (1.09 at 4 layers, the
    argmax unchanged); the switches-off branches round bf16 at other
    places besides (P before P·V, the SSD's y)."""
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device=device)
    two = (cfg.with_(n_layers=2, attn_every=1) if cfg.family == "hybrid"
           else cfg.with_(n_layers=2))
    deep = cfg.with_(n_layers=FAMILY_PLAIN_LAYERS[cfg.name])
    gate = {}
    for cut, dtype in ((deep, "float32"), (deep, "bfloat16"),
                       (two, "bfloat16")):
        cut = cut.with_(dtype=dtype)
        pc = _cut_depth(params, cut)
        FA.launches = 0
        _zero_ssd()
        a = prefill(cut, pc, {"tokens": tokens})[0].float()
        got = {"flash": FA.launches, "ssd": SSD.launches}
        if got["ssd"]:
            _ssd_designs(f"{cut.name} {dtype} at {cut.n_layers} layers",
                         dtype == "bfloat16")
        if got != _family_counts(cut):
            raise AssertionError(f"{cut.name} at {cut.n_layers} layers: "
                                 f"launches {got}")
        tol = TOL[getattr(torch, dtype)]
        for name, b in (
                ("plain_versions", _prefill_plain_kernels(
                    cut, pc, {"tokens": tokens})),
                ("switches_off", prefill(cut.with_(
                    use_flash_attention=False, use_ssd_kernel=False), pc,
                    {"tokens": tokens})[0])):
            gated = dtype == "float32" or (
                cfg.family == "hybrid" and cut.n_layers == 2
                and name == "plain_versions")
            b = b.float()
            err, bad = _compare(a, b, tol)
            gate[f"{dtype}_{cut.n_layers}_layers_{name}"] = {
                "max_abs_err": err, "outside_tol": bad, "tol": tol,
                "argmax_agree": int((a.argmax(-1) == b.argmax(-1)).sum()),
                "gated": gated}
            log(f"families: {cut.name} prefill at full width, {cut.n_layers} "
                f"layers, {dtype}, kernels vs {name.replace('_', ' ')}: "
                f"last-token logits max_abs_err {err:.3e} (|logit| max "
                f"{b.abs().max().item():.3f}) outside {tol:g}: {bad} of "
                f"{b.numel()}; argmax agree "
                f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{a.shape[0]}"
                f"{'' if gated else ' (reported)'}")
            if not torch.isfinite(a).all() or (gated and bad):
                raise AssertionError(f"{cut.name}: kernel prefill disagrees "
                                     f"with {name} ({dtype}, {cut.n_layers} "
                                     f"layers)")
        del pc, a, b
    return gate


def _family_slot(device, cfg) -> tuple:
    """The slot lane through ``run``: launches (requests × one prefill's),
    one chunk capture, a graph replay per chunk.  Run before the phase
    builds its own params, since the graph route holds a copy of the
    params it serves.  Returns (the lane's row, prompts, arrivals,
    tokens)."""
    s, arch = FAMILY_SLOT, cfg.name
    n_req, T, plen = s["n_requests"], s["T"], s["prompt_len"]
    job = ServeJob(arch=arch, reduced=FAMILY_REDUCED, batch=s["n_slots"],
                   prompt_len=plen, arch_overrides=FAMILY_SWITCHES,
                   n_slots=s["n_slots"], n_requests=n_req,
                   arrival=s["arrival"], steps_per_launch=SLOT_K)
    want = {k: n_req * v for k, v in _family_counts(cfg).items()}
    res, launches, peak = _counted_run(
        f"{arch} slot lane", ExperimentSpec(objective=job, T=T,
                                            seed=SLOT_SEED), device, want)
    e = res.extra
    if e["compile_counts"]["chunk"] != 1 or e["graph_replays"] != e["chunks"]:
        raise AssertionError(f"{arch} slot lane: {e['compile_counts']}, "
                             f"{e['graph_replays']} replays")
    prompts, arrivals, tokens = e["prompts"], e["arrivals"], res.x
    del res
    torch.cuda.empty_cache()
    return dict(arch=arch, lane="slot", n_slots=s["n_slots"],
                n_requests=n_req, prompt_len=plen, T=T,
                arrival=s["arrival"], **launches, run_peak_gib=peak), \
        prompts, arrivals, tokens


def _family_slot_serves(device, cfg, params, row, prompts, arrivals,
                        tokens) -> None:
    """On ``params``: one graph-route server serves twice (tokens equal to
    ``run``'s), once profiled, then the eager route (equal bit for bit)."""
    s = FAMILY_SLOT
    n_req, T = s["n_requests"], s["T"]
    slots = SlotConfig(n_slots=s["n_slots"], ctx_len=s["prompt_len"] + T,
                       seed=SLOT_SEED, steps_per_launch=SLOT_K)

    def serve(srv, label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = srv.serve(params, prompts, T, arrivals=arrivals)
        torch.cuda.synchronize()
        _check_served(f"{cfg.name} {label}", r.tokens, r, cfg, n_req, T)
        return r, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    server = SlotServer(cfg, slots, device=device)
    first, _ = serve(server, "graph")
    warm, wall = serve(server, "graph, again")
    for got, what in ((first.tokens, "run()"), (warm.tokens, "a second serve")):
        if not np.array_equal(got, tokens):
            raise AssertionError(f"{cfg.name}: the slot server's tokens "
                                 f"differ from {what}'s")
    _, prof_wall, kernels, _ = profiled(lambda: serve(server, "profiled"))
    if server.compile_counts() != {"chunk": 1}:
        raise AssertionError(f"{cfg.name}: {server.compile_counts()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del server
    torch.cuda.empty_cache()
    eager, eager_wall = serve(SlotServer(cfg, slots, device=device,
                                         capture=False), "eager")
    if not np.array_equal(eager.tokens, tokens):
        bad = np.argwhere(eager.tokens != tokens)
        raise AssertionError(f"{cfg.name}: graph route and eager route "
                             f"disagree at (request, token) {bad[:5].tolist()}")
    row.update(wall_s=wall, tok_per_s=n_req * T / wall,
               decode_steps=warm.decode_steps, chunks=warm.chunks,
               decode_device_ms_per_step=warm.chunk_device_ms
               / warm.decode_steps,
               profiled_wall_s=prof_wall,
               profiled_device_ms=sum(ms for ms, _ in kernels.values()),
               idle_share=idle_share(kernels, prof_wall),
               host_waits=warm.host_waits, occupancy=warm.occupancy,
               eager_wall_s=eager_wall, peak_gib=peak)
    log(f"families: {cfg.name} slot lane ({s['n_slots']} slots, {n_req} "
        f"requests, prompt {s['prompt_len']}, T={T}, {s['arrival']}, K="
        f"{SLOT_K}): launches flash {row['flash']} ssd {row['ssd']}; warm "
        f"serve {wall * 1e3:.1f} ms, {row['tok_per_s']:.1f} tok/s, chunk "
        f"device time {row['decode_device_ms_per_step']:.4f} ms per decode "
        f"step, host waits {warm.host_waits}, idle share "
        f"{row['idle_share']:.3f}, peak {peak:.2f} GiB; graph ≡ run() ≡ a "
        f"second serve ≡ eager, bit for bit")


def _family_parity(device) -> dict:
    """The hybrid's slot lane against its lock-step lane through ``run``:
    full width, 9 layers, f32 (TF32 off), both kernels on (their f32
    routes), n_slots = n_requests = batch, greedy: equal token matrices."""
    p = FAMILY_PARITY
    over = (("n_layers", p["n_layers"]), ("dtype", "float32")) + \
        FAMILY_SWITCHES
    base = dict(arch=p["arch"], reduced=FAMILY_REDUCED, batch=p["batch"],
                prompt_len=p["prompt_len"], arch_overrides=over)
    lock = run(ExperimentSpec(objective=ServeJob(**base), T=p["T"],
                              seed=SLOT_SEED), device=device)
    slot = run(ExperimentSpec(objective=ServeJob(
        **base, n_slots=p["batch"], steps_per_launch=SLOT_K), T=p["T"],
        seed=SLOT_SEED), device=device)
    if not np.array_equal(lock.x, slot.x):
        diff = np.argwhere(lock.x != slot.x)
        step = int(diff[:, 1].min())
        rid = int(diff[diff[:, 1] == step][0, 0])
        raise AssertionError(f"{p['arch']}: slot lane diverged from the "
                             f"lock-step lane at request {rid}, step {step}")
    log(f"families: slot lane ≡ lock-step lane ({p['arch']} full width, "
        f"{p['n_layers']} layers, f32, batch {p['batch']}, prompt "
        f"{p['prompt_len']}, T={p['T']}): token matrices bit-identical")
    return {"arch": p["arch"], "layers": p["n_layers"], "equal": True}


def phase_families(device, card: str, entries: dict) -> dict:
    """The hybrid (zamba2-7b) and MoE (deepseek-moe-16b) families at full
    width on both serving lanes, with the kernels at their new shapes;
    returns the ``families`` line and adds each path's launches to the
    flash and SSD entries of the kernels line."""
    t0 = time.perf_counter()
    out = {"card": card, "rows": [], "init": {}, "plain_gates": {}}
    out["kernel_shapes"] = _family_kernel_rows(device)
    # the host's draw rate, which the init of a leaf below
    # specs.DEVICE_DRAW_MIN runs at (the larger ones draw on the card)
    n = 1 << 26
    t_draw = time.perf_counter()
    materialize(Spec((n,), (None,), "fan_in"), torch.Generator().manual_seed(0))
    out["host_draw_per_s"] = n / (time.perf_counter() - t_draw)
    log(f"families: the host draws {out['host_draw_per_s'] / 1e6:.1f} M "
        f"normals/s into a bf16 leaf")
    for arch in FAMILY_ARCHS:
        cfg, prompts = _family_lockstep(device, arch, out)
        lock_row = out["rows"][-1]
        slot_row, sprompts, arrivals, stokens = _family_slot(device, cfg)
        torch.cuda.synchronize()
        t_init = time.perf_counter()
        params = init_params(cfg, FAMILY_LOCK["seed"], device)
        torch.cuda.synchronize()
        specs = [sp for _, sp in tree_leaves_with_path(param_specs(cfg))]
        out["init"][arch] = {
            "host_s": time.perf_counter() - t_init,
            "max_rss_gib": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 2**20,
            "elements": sum(math.prod(sp.shape) for sp in specs),
            "card_drawn": sum(math.prod(sp.shape) for sp in specs
                              if math.prod(sp.shape) > DEVICE_DRAW_MIN)}
        log(f"families: init_params({arch}, full width) "
            f"{out['init'][arch]['host_s']:.2f} s, "
            f"{out['init'][arch]['card_drawn']:,} of "
            f"{out['init'][arch]['elements']:,} elements drawn on the card; "
            f"process peak host RSS {out['init'][arch]['max_rss_gib']:.2f} GiB")
        _family_profile(device, cfg, params, prompts, lock_row)
        out["plain_gates"][arch] = _family_plain_gate(device, cfg, params,
                                                      prompts)
        _family_slot_serves(device, cfg, params, slot_row, sprompts,
                            arrivals, stokens)
        out["rows"].append(slot_row)
        del params
        torch.cuda.empty_cache()
        if arch == FAMILY_PARITY["arch"]:
            out["slot_parity"] = _family_parity(device)
    for name, entry in (("flash", entries["flash"]), ("ssd", entries["ssd"])):
        entry["family_launches"] = {f"{r['arch']}/{r['lane']}": r[name]
                                    for r in out["rows"] if r[name]}
    out["seconds"] = time.perf_counter() - t0
    log(f"families: every gate passed in {out['seconds']:.1f} s")
    return out


#: phase 18: the ssm, hybrid, MoE, audio and vlm families trained on the
#: training main path's settings (bf16, 8 × 512 tokens — audio: frames 8 ×
#: 512 and tokens 8 × 128 — over 4 workers, Adam, delay 1, the pooled
#: update, T 8, scan) at full width; depth is cut where the state (12 bytes
#: a param) would not fit one card: zamba2-7b ≈81, deepseek-moe-16b ≈203
#: and pixtral-12b ≈147 GB at full depth; mamba2-370m and zamba2-7b are cut
#: further to keep the whole script inside its time limit (the gates run at
#: the cuts of ``NEW_REF_CUT``, whatever the depth)
NEW_REDUCED = False
NEW_TRAIN = (("mamba2-370m", (("n_layers", 12),)),
             ("zamba2-7b", (("n_layers", 7),)),         # 1 group + a tail
             ("deepseek-moe-16b", (("n_layers", 4),)),
             ("seamless-m4t-large-v2", ()),
             ("pixtral-12b", (("n_layers", 4),)))
#: the cut at which each family's scan run is held to its eager run bit
#: for bit and its pooled curve to the reference update's: 2 layers (the
#: hybrid with its shared block before each, the audio family's encoder
#: cut too); pixtral-12b 1, since the reference update holds two states
#: at once and its 2 × 0.67 B embed and head leave no room for a second
#: layer's on the card
NEW_REF_CUT = {"zamba2-7b": (("n_layers", 2), ("attn_every", 1)),
               "seamless-m4t-large-v2": (("n_layers", 2), ("enc_layers", 2)),
               "pixtral-12b": (("n_layers", 1),)}
#: the audio and vlm families served at the model level (phase 18), full
#: width and depth, bf16, flash on: frames / tokens of ``batch_specs(cfg,
#: 4, 1024)`` (seamless: 4 × 1024 frames, 256 tokens; pixtral: 4 × 1024
#: tokens, 256 of them patches), 16 decode steps
NEW_SERVE = ("seamless-m4t-large-v2", "pixtral-12b")
NEW_SERVE_SHAPE = dict(batch=4, seq=1024, steps=16, seed=0)
#: depth of the f32 kernel ≡ plain gate (audio: both stacks); bf16 at 2
NEW_PLAIN_LAYERS = 4
#: (label, B, Sq, Sk, H, KV, D, causal, window): the new flash shapes
NEW_FLASH_SHAPES = (
    ("seamless-m4t-large-v2/encoder", 4, 1024, 1024, 16, 16, 64, False,
     None),
    ("seamless-m4t-large-v2/cross", 4, 256, 1024, 16, 16, 64, False, None),
    ("seamless-m4t-large-v2/decoder", 4, 256, 256, 16, 16, 64, True, None),
    ("pixtral-12b", 4, 1024, 1024, 32, 8, 128, True, None))
#: elements at each end of a pool whose update-kernel result is held to
#: the plain version (the far end lies past 2^31 on the largest pool)
POOL_CHECK = 1 << 24


def _new_train_spec(arch, over, **job_kw):
    return _train_spec(arch=arch, reduced=NEW_REDUCED, arch_overrides=over,
                       update_impl=POOLED, **job_kw)


def _pool_kernel(device, pools) -> dict:
    """``fused_adam_delayed`` over a trained state's bf16 pool: one launch
    held to its plain version at both ends of the pool (the far end past
    2^31 elements on the largest pool), then timed over the whole pool
    with CUDA events; the bound moves each operand once."""
    name = "fused_adam_delayed"
    grp = pools["bfloat16"]
    n = grp["p"].numel()
    gen = torch.Generator(device).manual_seed(21)
    t = {"p": grp["p"][0], "m": grp["m"][0], "v": grp["v"][0],
         "gb": grp["gbuf"][0],
         "g": torch.randn(n, generator=gen, device=device,
                          dtype=torch.bfloat16)}
    scal = _scalar_sets(name, device)[-1][1]
    k = min(POOL_CHECK, n // 2)
    ends = (slice(0, k), slice(n - k, n))
    want = [_apply(name, "plain", {key: x[sl].clone() for key, x in t.items()},
                   scal) for sl in ends]
    g_ends = [t["g"][sl].clone() for sl in ends]
    _apply(name, "cuda", t, scal)
    torch.cuda.synchronize()
    rtol, atol = UPDATE_TOL["adam"][torch.bfloat16]
    worst = 0.0
    for sl, w, g in zip(ends, want, g_ends):
        for key in _state_keys(name):
            err = (t[key][sl].float() - w[key].float()).abs()
            if (err > atol + rtol * w[key].float().abs()).any():
                raise AssertionError(f"{name} over a {n:,}-element pool: "
                                     f"{key} off its plain version at "
                                     f"[{sl.start}, {sl.stop})")
            worst = max(worst, err.max().item())
        if not torch.equal(t["gb"][sl], g):
            raise AssertionError(f"{name} over the pool: gbuf' != g")
    ms = time_ms(lambda: _apply(name, "cuda", t, scal), iters=5, warmup=1)
    nbytes = n * op_cost.update_bytes_per_elem(name, 2, 2)
    del t, want, g_ends
    return {"elements": n, "ms": ms, "bound_ms": nbytes / HBM_BW * 1e3,
            "bound_by": "bytes", "max_abs_err_ends": worst}


def _train_new_family(device, arch, over, card) -> tuple:
    """One family on the training main path's settings.  At the cut of
    ``NEW_REF_CUT``: the scan run's final state and curve equal the eager
    run's bit for bit, and its curve is within 5e-3 of the reference
    update's.  At the cell's depth: launches (one per dtype pool a
    round), finite curves, warm ms a round, peak memory; the update
    kernel over its bf16 pool; a profiled warm chunk (device ms, idle
    share, the update's ms).  Returns (the row, the initial params)."""
    t_arch = time.perf_counter()
    spec = _new_train_spec(arch, over)
    cfg = spec.objective.make_arch()
    T, K = spec.T, spec.rounds_per_launch
    row = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "card": card}
    # first, while the card is empty (the reference update keeps two
    # states alive at once, the old one and the new one it builds); every
    # run draws the same params from the seed, and none is kept between
    cut = _new_train_spec(arch, over + NEW_REF_CUT.get(
        arch, (("n_layers", 2),)))
    scan = run(cut, device=device)
    eager = TrainerBackend(device, runtime="eager").run(cut)
    diff = _first_difference(scan.x, eager.x)
    if diff is not None or not np.array_equal(eager.losses, scan.losses):
        raise AssertionError(f"{arch}: scan and eager differ (first leaf "
                             f"{diff})")
    pooled = scan.losses
    del scan, eager
    torch.cuda.empty_cache()
    ref = run(dataclasses.replace(cut, objective=dataclasses.replace(
        cut.objective, update_impl="reference")), device=device).losses
    if not np.isfinite(ref).all():
        raise AssertionError(f"{arch}: non-finite reference curve")
    rel = np.abs(pooled - ref) / np.abs(ref)
    if not (rel <= 5e-3).all():
        raise AssertionError(f"{arch}: pooled {pooled} against the "
                             f"reference {ref} at the cut")
    row["cut_layers"] = cut.objective.make_arch().n_layers
    row["max_rel_vs_reference_at_cut"] = float(rel.max())
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = init_params(cfg, spec.seed, device)
    torch.cuda.synchronize()
    row.update(params=sum(p.numel() for p in tree_leaves(base)),
               init_s=time.perf_counter() - t0)
    same = lambda c, d: tree_map(torch.clone, base)
    torch.cuda.reset_peak_memory_stats()
    AU.reset_launches()
    stamps = {}
    t0 = time.perf_counter()
    res = TrainerBackend(device, params_fn=same, on_step=lambda i, s, m:
                         stamps.setdefault(i, time.perf_counter())).run(spec)
    row["first_run_s"] = time.perf_counter() - t0
    launched = dict(AU.launches)
    n_pools = len(res.x["pools"])
    want = {**dict.fromkeys(AU.KERNELS, 0), "fused_adam_delayed": T * n_pools}
    if launched != want or res.extra["update_launches"] != want:
        raise AssertionError(f"{arch}: update launches {launched}, want "
                             f"{want}")
    _check_curves(res, f"{arch} training")
    row.update(pools=n_pools, launches=T * n_pools,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               warm_ms=(stamps[2 * K - 1] - stamps[K - 1]) / K * 1e3,
               loss_first=float(res.losses[0]),
               loss_last=float(res.losses[-1]))
    row["pool_kernel"] = _pool_kernel(device, res.x["pools"])
    del res
    torch.cuda.empty_cache()

    # a profiled chunk of K rounds; the process is warm from the runs above
    tr, _, _ = TrainerBackend(device)._make_trainer(
        spec, spec.objective, spec.stepsize.gamma, False, device)
    ex = PlanExecutor(tr, _lane_plan(spec, rounds=K)[1])
    state = tr.init_state(params=same(None, None))
    _, wall, kernels, _ = profiled(
        lambda: ex.run_scan(state, rounds_per_launch=K))
    dev = sum(ms for ms, _ in kernels.values())
    row.update(profiled_ms=wall * 1e3 / K, device_ms=dev / K,
               idle_share=idle_share(kernels, wall),
               update_kernel_ms=sum(ms for name, (ms, _) in kernels.items()
                                    if "adam_kernel" in name) / K)
    del state, ex, tr
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t_arch
    pk = row["pool_kernel"]
    log(f"new families: train {arch} L={cfg.n_layers} d={cfg.d_model} "
        f"({row['params'] / 1e9:.3f} B params, init {row['init_s']:.2f} s): "
        f"fused_adam_delayed launches {row['launches']} = {T} rounds x "
        f"{n_pools} pools; loss {row['loss_first']:.5f} -> "
        f"{row['loss_last']:.5f}; warm {row['warm_ms']:.3f} ms/round; "
        f"profiled {row['profiled_ms']:.3f} ms/round, device "
        f"{row['device_ms']:.3f} ms, idle {row['idle_share']:.3f}, update "
        f"{row['update_kernel_ms']:.3f} ms; peak {row['peak_gib']:.2f} GiB; "
        f"at {row['cut_layers']} layers scan = eager bit for bit, pooled "
        f"vs reference max rel {rel.max():.3e} (5e-3); update kernel over the {pk['elements']:,}"
        f"-element bf16 pool {pk['ms']:.4f} ms (bound {pk['bound_ms']:.4f} "
        f"ms), ends within the update tolerance (max abs "
        f"{pk['max_abs_err_ends']:.3e}); {row['seconds']:.1f} s")
    return row, base


def _serve_new_family(device, arch, params, card) -> dict:
    """An audio or vlm arch at full width and depth at the model level,
    flash on: ``prefill`` (one flash launch per attention: audio's encoder
    self, decoder self and cross; on the tensor-core route) then
    ``Server.generate`` from its cache; a second run's tokens equal the
    first's; warm and profiled times; the prefill at 4 layers in f32
    with the kernel against its plain version (the phase-3 tolerance) and
    at 2 layers in bf16 (3e-2); ``run(ServeJob)`` refused."""
    t_arch = time.perf_counter()
    s = NEW_SERVE_SHAPE
    cfg = get_arch(arch)
    if NEW_REDUCED:
        cfg = cfg.reduced()
    cfg = cfg.with_(use_flash_attention=True)
    row = {"arch": arch, "layers": cfg.n_layers, "card": card}
    if params is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = init_params(cfg, s["seed"], device)
        torch.cuda.synchronize()
        row["init_s"] = time.perf_counter() - t0
    batch = model_batch(cfg, s["batch"], s["seq"], s["seed"], device)
    plen, steps = batch["tokens"].shape[1], s["steps"]
    want = (cfg.enc_layers + 2 * cfg.n_layers if cfg.family == "audio"
            else cfg.n_layers)

    def serve():
        FA.launches = 0
        with _dtypes_seen(FA, "flash_attention_cuda") as seen:
            last, cache = prefill(cfg, params, batch, ctx_len=plen + steps)
            got = FA.launches
        server = Server(cfg, ServeConfig(batch=s["batch"],
                                         ctx_len=plen + steps), device=device)
        toks = server.generate(params, torch.argmax(last, -1).cpu().numpy(),
                               steps, start_pos=plen, cache=cache)
        return got, seen, cache, toks, server.logits_finite

    torch.cuda.reset_peak_memory_stats()
    got, seen, cache, toks, finite = serve()
    routes = sorted({FA.route(getattr(torch, d[0])) for d in seen})
    if got != want or routes != ["tensor_cores"]:
        raise AssertionError(f"{arch}: {got} flash launches per prefill on "
                             f"{routes}, want {want} on the tensor cores")
    if not finite or toks.shape != (s["batch"], steps) or toks.min() < 0 \
            or toks.max() >= cfg.vocab:
        raise AssertionError(f"{arch}: bad decode {toks.shape}, finite "
                             f"{finite}")
    if cfg.family == "audio" and tuple(cache["cross_k"].shape[:3]) != (
            cfg.n_layers, s["batch"], s["seq"]):
        raise AssertionError(f"{arch}: cross k {cache['cross_k'].shape}")
    del cache
    again = serve()[3]
    if not np.array_equal(again, toks):
        raise AssertionError(f"{arch}: a second run's tokens differ")
    row.update(flash_launches=got, peak_gib=torch.cuda.max_memory_allocated()
               / 2**30, inputs={k: list(v.shape) for k, v in batch.items()})
    _serve_profile(cfg, params, batch, steps, row, "new families")

    gates = {}
    deep = {"n_layers": NEW_PLAIN_LAYERS}
    two = {"n_layers": 2}
    if cfg.family == "audio":
        deep["enc_layers"], two["enc_layers"] = NEW_PLAIN_LAYERS, 2
    for cut, dtype in ((deep, "float32"), (two, "bfloat16")):
        c = cfg.with_(dtype=dtype, **cut)
        pc = _cut_depth(params, c)
        with torch.no_grad():
            a = prefill(c, pc, batch)[0].float()
            b = _prefill_plain_kernels(c, pc, batch).float()
        tol = TOL[getattr(torch, dtype)]
        err, bad = _compare(a, b, tol)
        gates[f"{dtype}_{c.n_layers}_layers"] = {
            "max_abs_err": err, "outside_tol": bad, "tol": tol,
            "argmax_agree": int((a.argmax(-1) == b.argmax(-1)).sum())}
        log(f"new families: {arch} prefill at full width, {c.n_layers} "
            f"layers, {dtype}, kernel vs plain version: last-token logits "
            f"max_abs_err {err:.3e} (|logit| max {b.abs().max().item():.3f})"
            f" outside {tol:g}: {bad} of {b.numel()}")
        if bad or not torch.isfinite(a).all():
            raise AssertionError(f"{arch}: kernel prefill disagrees with its"
                                 f" plain version ({dtype}, {c.n_layers} "
                                 "layers)")
        del pc, a, b
    row["plain_gates"] = gates
    _expect_raise(lambda: run(ExperimentSpec(objective=ServeJob(
        arch=arch, reduced=NEW_REDUCED), T=4), device=device),
        NotImplementedError)
    row["seconds"] = time.perf_counter() - t_arch
    log(f"new families: {arch} L={cfg.n_layers} model-level serve, inputs "
        f"{row['inputs']}: {got} flash launches per prefill on the tensor "
        f"cores, {steps} greedy tokens a row, a second run's tokens equal; "
        f"peak {row['peak_gib']:.2f} GiB; run(ServeJob) refused; "
        f"{row['seconds']:.1f} s")
    del params
    torch.cuda.empty_cache()
    return row


def phase_new_families(device, card: str, entries: dict) -> dict:
    """Phase 18: the five families trained, the audio and vlm families
    served at the model level, flash at their new shapes; returns the
    ``new_families`` line and adds each path's launches to the flash and
    ``fused_adam_delayed`` entries of the kernels line."""
    t0 = time.perf_counter()
    out = {"card": card, "train": [], "serve": []}
    out["flash_shapes"] = _flash_rows(device, NEW_FLASH_SHAPES,
                                      "new families")
    for r in out["flash_shapes"]:
        log(f"new families: flash at {r['arch']} {r['shape']} causal="
            f"{r['causal']} bf16: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, sdpa {r['sdpa_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()
    for arch, over in NEW_TRAIN:
        row, base = _train_new_family(device, arch, over, card)
        out["train"].append(row)
        if arch in NEW_SERVE and not over:       # full depth: serve these
            out["serve"].append(_serve_new_family(device, arch, base, card))
        del base
        torch.cuda.empty_cache()
    for arch in NEW_SERVE:
        if arch not in {r["arch"] for r in out["serve"]}:
            out["serve"].append(_serve_new_family(device, arch, None, card))
    fl = entries["flash"]
    fl.setdefault("family_launches", {}).update(
        {f"{r['arch']}/prefill": r["flash_launches"] for r in out["serve"]})
    fl["family_shapes"] = [
        {"arch": r["arch"], "shape": r["shape"], "causal": r["causal"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["sdpa_ms"]}
        for r in out["flash_shapes"]]
    upd = entries["fused_adam_delayed"]
    upd.setdefault("family_launches", {}).update(
        {f"{r['arch']}/train": r["launches"] for r in out["train"]})
    upd["family_pools"] = [{"arch": r["arch"], **r["pool_kernel"]}
                           for r in out["train"]]
    out["seconds"] = time.perf_counter() - t0
    log(f"new families: every gate passed in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 19: the launch tier (meta trace ≡ card tally, the step's roofline)
# ---------------------------------------------------------------------------

#: (label, arch, overrides, shape, update_impl, timed calls): the main
#: paths' steps, as ``dryrun.build_step`` builds them
LAUNCH_STEPS = (
    ("train", "qwen2-0.5b", (("remat", "none"),),
     InputShape("main_train", 512, 8, "train"), "pallas_pooled", 3),
    ("prefill", "qwen2-0.5b", (("use_flash_attention", True),),
     InputShape("main_prefill", 1024, 4, "prefill"), "reference", 5),
    ("decode", "qwen2-0.5b", (),
     InputShape("main_decode", 1024, 4, "decode"), "reference", 10),
    ("ssm_prefill", "mamba2-370m", (("use_ssd_kernel", True),),
     InputShape("ssm_prefill", 1024, 4, "prefill"), "reference", 5),
)
LAUNCH_WORKERS = 4
#: the estimated peak's largest relative gap to the measured one
LAUNCH_PEAK_TOL = 0.15


def _launch_kernels_expected(label, cfg, shape, args) -> dict:
    """{kernel: [launches, flops, bytes]} the step must tally: the pooled
    update once per dtype pool, flash once per attention layer, SSD once
    per Mamba2 layer, each with its formula at the step's shapes."""
    meta = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt,
                                                     device="meta")
    B, S = shape.global_batch, shape.seq_len
    out = {}

    def add(name, n, flops, nbytes):
        row = out.setdefault(name, [0, 0, 0])
        for i, x in enumerate((n, n * flops, n * nbytes)):
            row[i] += x
    if label == "train":
        for b in args[0]["pools"].values():
            add("fused_adam_delayed", 1,
                *op_cost.update_cost("fused_adam_delayed", b["p"], b["gbuf"]))
    if cfg.use_flash_attention:
        q = meta(B, S, cfg.n_heads, cfg.d_head)
        k = meta(B, S, cfg.n_kv_heads, cfg.d_head)
        add("flash_attention", cfg.n_layers,
            *op_cost.flash_cost(q, k, True, cfg.sliding_window))
    if cfg.use_ssd_kernel:
        c = min(cfg.ssm_chunk, S)
        x = meta(B, S // c, c, cfg.ssm_heads, cfg.ssm_head_dim)
        add("ssd_chunk", cfg.n_layers,
            *op_cost.ssd_cost(x, meta(B, S // c, c, cfg.ssm_state)))
    return out


def _launch_counts() -> dict:
    return {"flash_attention": FA.launches, "ssd_chunk": SSD.launches,
            **AU.launches}


def _tally_diff(meta_cost, card_cost) -> str:
    rows = [f"{k}: meta {meta_cost.ops.get(k)} card {card_cost.ops.get(k)}"
            for k in sorted(set(meta_cost.ops) | set(card_cost.ops))
            if meta_cost.ops.get(k) != card_cost.ops.get(k)]
    return "; ".join(rows[:12])


def _launch_step(device, label, arch, over, shape, impl, iters) -> dict:
    """One step: traced on meta by the dry-run, then run on the card warm,
    under the tally (gates a and d), for its peak (gate b) and timed
    (gate c)."""
    cfg = get_arch(arch).with_(**dict(over))
    kw = dict(update_impl=impl, n_groups=LAUNCH_WORKERS)
    rec = dryrun.run_one(cfg, shape, verbose=False, **kw)
    if not rec["ok"]:
        raise AssertionError(f"launch tier: {label} did not trace on meta: "
                             f"{rec['error']}\n{rec['traceback']}")
    meta = rec["op_cost"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    fn, args = dryrun.build_step(cfg, shape, device, **kw)
    fn(*args)                                       # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = time_ms(lambda: fn(*args), iters=iters, warmup=1)
    before = _launch_counts()
    card = op_cost.analyze(fn, *args)
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in _launch_counts().items()
                if n != before[k]}
    # (a) the meta trace and the card's tally count the same step
    if (card.dot_flops, card.hbm_bytes) != (meta["dot_flops"],
                                            meta["hbm_bytes"]):
        meta_fn, meta_args = dryrun.build_step(cfg, shape, "meta", **kw)
        again = op_cost.analyze(meta_fn, *meta_args)
        raise AssertionError(
            f"launch tier: {label}: meta dot flops {meta['dot_flops']} bytes "
            f"{meta['hbm_bytes']}, card {card.dot_flops} {card.hbm_bytes}; "
            f"{_tally_diff(again, card)}")
    # (d) each kernel launched is tallied once per launch, with its formula
    want = _launch_kernels_expected(label, cfg, shape, args)
    got = {k: list(v) for k, v in card.kernels.items()}
    metak = {k: [v["launches"], v["flops"], v["bytes"]]
             for k, v in meta["kernels"].items()}
    if not (got == metak == want
            and launched == {k: v[0] for k, v in want.items()}):
        raise AssertionError(f"launch tier: {label}: kernels tallied {got}, "
                             f"on meta {metak}, by formula {want}, launched "
                             f"{launched}")
    # (b) the estimated peak against the allocator's
    est = rec["memory"]["peak_bytes_est"]
    gap = abs(est - peak) / peak
    if gap > LAUNCH_PEAK_TOL:
        raise AssertionError(f"launch tier: {label}: estimated peak {est} "
                             f"bytes, measured {peak} ({gap:.1%} apart)")
    # (c) the card never beats the step's bound
    t = roofline_terms(meta)
    dom = max(t, key=t.get)
    bound = t[dom] * 1e3
    if ms < bound:
        raise AssertionError(f"launch tier: {label}: {ms:.3f} ms beats its "
                             f"bound {bound:.3f} ms: the count is wrong")
    row = {"step": label, "arch": arch, "overrides": dict(over),
           "shape": [shape.global_batch, shape.seq_len], "kind": shape.kind,
           "update_impl": impl, "dot_flops": card.dot_flops,
           "hbm_bytes": card.hbm_bytes, "n_ops": card.n_ops,
           "peak_est_bytes": est, "peak_measured_bytes": peak,
           "peak_gap": gap, "ms": ms, "bound_ms": bound,
           "bound_by": {"compute": "operations", "memory": "bytes"}.get(dom,
                                                                        dom),
           "compute_ms": t["compute"] * 1e3, "memory_ms": t["memory"] * 1e3,
           "share": bound / ms, "kernels": got, "trace_s": rec["trace_s"],
           "top_bytes": card.top("bytes", 6)}
    log(f"launch tier: {label} ({arch} {shape.global_batch} x "
        f"{shape.seq_len}, {impl}): meta = card: {card.dot_flops:,} dot "
        f"flops, {card.hbm_bytes:,} bytes, kernels {got}; peak est "
        f"{est / 2**30:.3f} GiB, measured {peak / 2**30:.3f} GiB "
        f"({gap:.1%}); warm {ms:.3f} ms against a bound of {bound:.3f} ms "
        f"({row['bound_by']}; compute {row['compute_ms']:.3f}, memory "
        f"{row['memory_ms']:.3f}): share {row['share']:.3f}; meta trace "
        f"{rec['trace_s']} s")
    del fn, args
    torch.cuda.empty_cache()
    return row


def phase_launch_tier(device, card: str) -> dict:
    """Phase 19: each of the main paths' steps traced on meta by the
    dry-run and held to the same step on the card."""
    t0 = time.perf_counter()
    rows = [_launch_step(device, *step) for step in LAUNCH_STEPS]
    out = {"card": card, "steps": rows,
           "seconds": time.perf_counter() - t0}
    log(f"launch tier: every gate passed in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: data-parallel training over torch.distributed
# ---------------------------------------------------------------------------
#: the ranks whose rows (b) gives the update kernel
DP_ROWS = 2


def _dp_round_hand_count(cols: int, esize: int) -> dict:
    """One ranked round's collectives on one bf16 pool at one rank: the
    pool's reduce-scatter and its p all-gather (cols · esize bytes each),
    the norm's per-pool norms (4 B), the loss's global Σ mask (4 B) and
    its three shares (12 B)."""
    return {"all_reduce": [2, 16], "all_gather": [2, cols * esize + 4],
            "reduce_scatter": [1, cols * esize]}


def _dp_one_rank(device, card: str, base) -> dict:
    """(a) the pooled training main path at full width and depth through a
    NCCL process group of one rank (in this process, a file store), on the
    same params as the no-mesh trainer: curves and final state bit for
    bit, the update kernel launched once per round, each round's
    collectives equal to the hand count; warm ms a round, both."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import ProcessMesh, init_process_group

    spec = _train_spec(update_impl=POOLED)
    cfg = spec.objective.make_arch()
    T, K = spec.T, spec.rounds_per_launch
    same = lambda c, d: tree_map(torch.clone, base)

    def timed(**kw):
        stamps = {}
        AU.reset_launches()
        res = TrainerBackend(device, params_fn=same, on_step=lambda i, s, m:
                             stamps.setdefault(i, time.perf_counter()),
                             **kw).run(spec)
        _check_curves(res, f"data-parallel (a) {kw or 'no mesh'}")
        return (res, dict(AU.launches),
                (stamps[2 * K - 1] - stamps[K - 1]) / K * 1e3)

    want = {**dict.fromkeys(AU.KERNELS, 0), "fused_adam_delayed": T}
    plain, plain_launched, plain_ms = timed()
    init_process_group(device)
    try:
        mesh = ProcessMesh({"data": 1, "model": 1})
        ranked, launched, ranked_ms = timed(mesh=mesh)
        backend = dist.get_backend()
        sparse = _dp_sparsified(device, cfg, base, mesh)
    finally:
        dist.destroy_process_group()
    if plain_launched != want or launched != want:
        raise AssertionError(f"data-parallel (a): update launches "
                             f"{launched} (no mesh {plain_launched}), want "
                             f"{want}")
    diff = _first_difference(plain.x, ranked.x)
    if diff is not None or not (
            np.array_equal(plain.losses, ranked.losses)
            and np.array_equal(plain.grad_norms, ranked.grad_norms)):
        raise AssertionError(f"data-parallel (a): one NCCL rank differs from"
                             f" the no-mesh trainer (first leaf {diff}; "
                             f"losses {ranked.losses} / {plain.losses})")
    p = ranked.x["pools"]["bfloat16"]["p"]
    cols, esize = p.shape[1], p.element_size()
    per_round = {k: [int(n), int(b)] for k, (n, b) in
                 ranked.extra["collectives"].items()}
    hand = _dp_round_hand_count(cols, esize)
    if per_round != hand or ranked.extra["ranks"] != 1:
        raise AssertionError(f"data-parallel (a): collectives a round "
                             f"{per_round}, by hand {hand}")
    out = {"backend": backend, "rounds": T,
           "fused_adam_delayed_launches": launched["fused_adam_delayed"],
           "pool_elements": cols, "bitwise_equal": True,
           "collectives_per_round": per_round,
           "collective_bytes_per_round": sum(b for _, b in
                                             per_round.values()),
           "round_ms_ranked": ranked_ms, "round_ms_no_mesh": plain_ms,
           "sparsified": sparse}
    log(f"data-parallel (a): {cfg.name} L={cfg.n_layers} pooled, T={T}, one "
        f"{backend} rank: curves and final state bit-identical to the "
        f"no-mesh trainer; fused_adam_delayed launches {T}; collectives a "
        f"round {per_round} = {out['collective_bytes_per_round']:,} bytes "
        f"(the hand count); warm {ranked_ms:.3f} ms a round against "
        f"{plain_ms:.3f} ms without a mesh; sparsified at density 0.5: "
        f"{sparse['round_ms_ranked']:.3f} ms a round against "
        f"{sparse['round_ms_no_mesh']:.3f} ms, collectives a round "
        f"{sparse['collectives_per_round']}")
    return out


def _dp_sparsified(device, cfg, base, mesh) -> dict:
    """A sparsified round (``grad_density`` 0.5) on one rank against the
    no-mesh trainer's, warm, on the same batch: over ranks the leaves are
    all-reduced before the quantile (each leaf's threshold is over the
    whole gradient), in place of the pooled reduce-scatter."""
    from repro_torch.distributed import collectives as C

    gen = torch.Generator(device).manual_seed(5)
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (TRAIN_JOB["global_batch"], TRAIN_JOB["seq_len"]),
        generator=gen, device=device)}
    mask = torch.ones(TRAIN_SPEC["n_workers"], device=device)
    out = {}
    for label, kw in (("no_mesh", {}), ("ranked", {"mesh": mesh})):
        tr = _lane_trainer(cfg, device, TRAIN_SPEC["stepsize"], **kw)
        state = tr.init_state(params=tree_map(torch.clone, base))
        step = tr.train_step_fn()

        def one():
            nonlocal state
            state, _ = step(state, batch, mask, grad_density=0.5)
        one()
        before = C.snapshot()
        out[f"round_ms_{label}"] = time_ms(one, iters=3, warmup=1)
        if label == "ranked":
            out["collectives_per_round"] = {
                k: [n // 4, b // 4] for k, (n, b) in C.since(before).items()}
        del state, step, tr
        torch.cuda.empty_cache()
    return out


def _dp_rows(device, base) -> dict:
    """(b) what a round of DP_ROWS ranks gives the card, in one process:
    the main path's pool in the layout of DP_ROWS shards, the update kernel
    on each rank's rows (p a row view of the whole pool, m, v and gbuf the
    rank's own row) against its plain version and timed, and the copy that
    views the params of such a pool (``unpool_tree``), timed."""
    from repro_torch.optim.pool import unpool_tree

    cfg = _train_spec(update_impl=POOLED).objective.make_arch()
    lay = build_layout(param_specs(cfg), DP_ROWS)
    cols = lay.cols["bfloat16"]
    p = pool_tree(lay, base)["bfloat16"]
    unpool_ms = time_ms(lambda: unpool_tree(lay, {"bfloat16": p}), iters=10)
    unpool_bytes = 2 * p.numel() * p.element_size()
    scal = _scalar_sets("fused_adam_delayed", device)[-1][1]
    rtol, atol = UPDATE_TOL["adam"][torch.bfloat16]
    worst, row_ms = 0.0, []
    for r in range(DP_ROWS):
        row = _update_inputs(cols, torch.bfloat16, device, seed=20 + r)
        p[r].copy_(row.pop("p"))
        state = {"p": p[r], **row}
        keep = tree_map(torch.clone, state)
        got = _apply("fused_adam_delayed", "cuda", state, scal)
        torch.cuda.synchronize()
        want = _apply("fused_adam_delayed", "plain",
                      tree_map(torch.clone, keep), scal)
        for key in ("p", "m", "v"):
            err = (got[key].float() - want[key].float()).abs()
            if int((err > atol + rtol * want[key].float().abs()).sum()) or \
                    not torch.isfinite(got[key]).all():
                raise AssertionError(f"data-parallel (b): the kernel on rank "
                                     f"{r}'s rows, {key}, off its plain "
                                     "version")
            worst = max(worst, err.max().item())
            del err
        if not torch.equal(got["gb"], keep["g"]):
            raise AssertionError(f"data-parallel (b): rank {r}'s gbuf' != g")
        del want, keep
        row_ms.append(time_ms(lambda: _apply("fused_adam_delayed", "cuda",
                                             state, scal), iters=10))
        del state, got
    del p
    torch.cuda.empty_cache()
    bound = op_cost.bound_ms(
        cols * op_cost.UPDATE_OPS["fused_adam_delayed"],
        cols * op_cost.update_bytes_per_elem("fused_adam_delayed", 2, 2),
        PEAK_FLOPS_F32)[0]
    out = {"ranks": DP_ROWS, "row_elements": cols, "max_abs_err": worst,
           "row_ms": row_ms, "row_bound_ms": bound,
           "unpool_ms": unpool_ms, "unpool_bytes": unpool_bytes}
    log(f"data-parallel (b): the main path's pool at {DP_ROWS} shards "
        f"({cols:,} columns a row): fused_adam_delayed on each rank's rows "
        f"against its plain version, max abs err {worst:.3e}; "
        f"{', '.join(f'{t:.4f}' for t in row_ms)} ms a row (bound "
        f"{bound:.4f} ms); the params view of the pool (unpool_tree) "
        f"{unpool_ms:.3f} ms for {unpool_bytes:,} bytes")
    return out


#: the data-rank counts whose per-leaf ZeRO blocks (c) gives the kernel
ZERO_RANKS = (2, 4)


def _zero_scalars(whole, device):
    """The Adam scalar block of the whole tree: count 7, wd 0.1 and the
    clip scale from the whole stale buffer's global norm (clip 1), as the
    delayed apply forms it."""
    from repro_torch.optim import clip_scale_from_norm, global_norm

    clip = clip_scale_from_norm(global_norm(
        {i: t["gb"] for i, t in enumerate(whole)}), 1.0)
    c = torch.tensor(7, dtype=torch.int32, device=device)
    bc1, bc2 = AU.adam_bias_corrections(0.9, 0.95, c)
    return AU.adam_scalars(UPDATE_LR["adam"], bc1, bc2, clip, 0.1, device)


def _dp_zero_blocks(device) -> dict:
    """(c) ``fused_adam_delayed`` on each data rank's per-leaf ZeRO blocks
    of qwen2-0.5b's 14 leaves, for R in :data:`ZERO_RANKS`: bit for bit
    the whole-leaf kernel's blocks, within tolerance of the plain version,
    14 launches a rank; rank 0's launches timed."""
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.launch.mesh import Mesh

    name, keys = "fused_adam_delayed", ("p", "m", "v", "gb", "g")
    specs = tree_leaves(param_specs(get_arch(SERVE["arch"])))
    whole = [{k: t.reshape(s.shape) for k, t in _update_inputs(
        int(np.prod(s.shape)), torch.bfloat16, device, seed=60 + i).items()}
        for i, s in enumerate(specs)]
    scal = _zero_scalars(whole, device)
    # the whole-leaf kernel's outputs, which every rank's blocks must equal
    after = [_apply(name, "cuda", tree_map(torch.clone, t), scal)
             for t in whole]
    rtol, atol = UPDATE_TOL["adam"][torch.bfloat16]
    out = {}
    for R in ZERO_RANKS:
        sh = tree_leaves(tree_shardings(param_specs(get_arch(SERVE["arch"])),
                                        Mesh({"data": R, "model": 1}),
                                        zero=True))
        worst, launches = 0.0, []
        for r in range(R):
            blocks = [{k: s.local(t[k], rank=r).clone(
                memory_format=torch.contiguous_format) for k in keys}
                for t, s in zip(whole, sh)]
            keep = [tree_map(torch.clone, b) for b in blocks]
            AU.reset_launches()
            for b in blocks:
                _apply(name, "cuda", b, scal)
            torch.cuda.synchronize()
            launches.append(AU.launches[name])
            for i, (b, k, s, w) in enumerate(zip(blocks, keep, sh, after)):
                if not all(torch.equal(_bits(b[key]), _bits(
                        s.local(w[key], rank=r))) for key in keys):
                    raise AssertionError(f"data-parallel (c): rank {r} of "
                                         f"{R}, leaf {i}: the block's outputs "
                                         "differ from the whole leaf's")
                want = _apply(name, "plain", k, scal)
                for key in ("p", "m", "v"):
                    err = (b[key].float() - want[key].float()).abs()
                    if int((err > atol + rtol * want[key].float().abs()
                            ).sum()):
                        raise AssertionError(f"data-parallel (c): rank {r} "
                                             f"of {R}, leaf {i}, {key}: off "
                                             "its plain version")
                    worst = max(worst, err.max().item())
                del want
            if r == 0:
                n = sum(b["p"].numel() for b in blocks)
                ms = device_ms(lambda: [_apply(name, "cuda", b, scal)
                                        for b in blocks], iters=10)
                plain_ms = time_ms(lambda: [_apply(name, "plain", b, scal)
                                            for b in blocks], iters=3)
                library_ms = _update_library_ms(name, blocks)
            del blocks, keep
            torch.cuda.empty_cache()
        if launches != [len(specs)] * R:
            raise AssertionError(f"data-parallel (c): launches {launches} at "
                                 f"{R} ranks, want {len(specs)} a rank")
        bound = op_cost.bound_ms(
            n * op_cost.UPDATE_OPS[name],
            n * op_cost.update_bytes_per_elem(name, 2, 2), PEAK_FLOPS_F32)[0]
        out[str(R)] = {"ranks": R, "leaves": len(specs),
                       "launches_per_rank": launches[0],
                       "block_elements": n, "max_abs_err": worst, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound, "bound_by": "bytes"}
        log(f"data-parallel (c): per-leaf ZeRO at {R} data ranks: "
            f"{name} on every rank's blocks of the {len(specs)} leaves bit "
            f"for bit the whole-leaf kernel's blocks, max abs err {worst:.3e} "
            f"against its plain version, {launches} launches; rank 0 "
            f"({n:,} elements): {ms:.4f} ms device time (bound {bound:.4f} "
            f"ms, bytes), plain {plain_ms:.4f} ms, library {library_ms:.4f} "
            "ms")
    del whole, after
    torch.cuda.empty_cache()
    return out


def phase_data_parallel(device, card: str) -> dict:
    """Phase 20: (a) one NCCL rank ≡ the no-mesh trainer at full width;
    (b) the update kernel on the rows a 2-rank round gives it, and its
    params view's copy; (c) the update kernel on per-leaf ZeRO's
    blocks."""
    t0 = time.perf_counter()
    cfg = _train_spec(update_impl=POOLED).objective.make_arch()
    base = init_params(cfg, TRAIN_SPEC["seed"], device)
    out = {"card": card, "one_rank": _dp_one_rank(device, card, base)}
    torch.cuda.empty_cache()
    out["two_rank_rows"] = _dp_rows(device, base)
    del base
    torch.cuda.empty_cache()
    out["zero_blocks"] = _dp_zero_blocks(device)
    out["seconds"] = time.perf_counter() - t0
    log(f"data-parallel: every gate passed in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 21: tensor parallelism over the model axis, decomposed on one card
# ---------------------------------------------------------------------------
#: (arch, depth: None for the config's own, model axis) of the split ≡
#: unsharded cells: qwen2-0.5b head-parallel at model 2; at model 4 its 14
#: heads do not divide, so its attention leaves are gathered and its ring
#: is split on ctx; deepseek-moe-16b expert-parallel at model 2 (qwen2-0.5b
#: at 12 of its 24 layers: the depths keep the whole script inside its
#: 1200 s)
TP_CELLS = (("qwen2-0.5b", 12, 2), ("qwen2-0.5b", 12, 4),
            ("deepseek-moe-16b", 4, 2))
TP_M = 2                       # the model axis of (c) and (d)
TP_SHAPE = dict(batch=4, prompt_len=1024, steps=8, seed=0)
TP_F32_TOL = 1e-4              # relative L2 of the logits, f32
TP_BF16_LAYERS = 2
#: flash at the rank's heads at model 2: (label, B, Sq, Sk, H, KV, D,
#: causal, window)
TP_FLASH_SHAPES = (
    ("qwen2-0.5b at model 2", 4, 1024, 1024, 7, 1, 64, True, None),
    ("deepseek-moe-16b at model 2", 4, 1024, 1024, 8, 8, 128, True, None))
TP_REDUCED = False             # True rehearses the phase at reduced size


def _tp_cfg(arch, layers, **kw):
    cfg = get_arch(arch)
    cfg = cfg.reduced() if TP_REDUCED else cfg
    if layers is not None:
        kw["n_layers"] = layers
    return cfg.with_(use_flash_attention=True, remat="none", **kw)


def _tp_blocks(cfg, params, M) -> list:
    """Each rank's blocks of ``params`` (views) at a model axis of ``M``,
    the split ``logical_pspec`` gives."""
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.launch.mesh import Mesh

    sh = tree_shardings(param_specs(cfg), Mesh({"model": M}))
    return [tree_map(lambda t, s, r=r: s.local(t, rank=r), params, sh)
            for r in range(M)]


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _tp_forward(cfg, blocks, tokens, M) -> list:
    """Every rank's whole logits of the prompt: ``forward_logits`` on the
    rank's blocks under its ``TP`` (the ranks as threads, their operators
    combining the ranks' tensors)."""
    from repro_torch.models.tp import ThreadRanks

    return ThreadRanks(cfg, M).run(lambda tp: forward_logits(
        cfg, blocks[tp.rank], {"tokens": tokens}, tp=tp)[0])


def _tp_greedy(cfg, blocks, batch, T, ctx, M) -> list:
    """Every rank's greedy tokens: ``prefill`` of ``batch`` (tokens, and
    frames or patches) then ``T`` ``decode_step`` calls on the rank's
    blocks of the params and of the cache."""
    from repro_torch.models.model import decode_step
    from repro_torch.models.tp import ThreadRanks

    S = batch["tokens"].shape[1]

    def rank(tp):
        params = blocks[tp.rank]
        last, cache = prefill(cfg, params, batch, ctx_len=ctx, tp=tp)
        toks = [last.argmax(-1)]
        for i in range(T):
            lg, cache = decode_step(cfg, params, cache, toks[-1], S + i, ctx,
                                    tp=tp)
            toks.append(lg.argmax(-1))
        return torch.stack(toks, 1).cpu().numpy()

    return ThreadRanks(cfg, M).run(rank)


def _tp_cell(device, arch, layers, M) -> dict:
    """(a)/(b): the split ≡ the unsharded model for one arch at a model
    axis of ``M``, through the port's own entry points and ``TP`` layers
    on each rank's blocks: f32 logits of the whole prompt at the cell's
    depth, bf16 at TP_BF16_LAYERS, and greedy tokens of prefill and
    decode against the unsharded server's (f32)."""
    from repro_torch.models.tp import TP, ThreadRanks, cache_split

    B, S, T = TP_SHAPE["batch"], TP_SHAPE["prompt_len"], TP_SHAPE["steps"]
    cfg = _tp_cfg(arch, layers)
    base = init_params(cfg, TP_SHAPE["seed"], device)
    gen = torch.Generator(device).manual_seed(TP_SHAPE["seed"] + 11)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=device)
    ctx = -(-(S + T + 1) // 8) * 8     # divides over 4 ranks: ctx splits
    heads = TP(cfg, None, M, 0, None).heads_split()
    out = {"arch": arch, "n_layers": cfg.n_layers, "model_axis": M,
           "batch": B, "prompt_len": S,
           "attention": "heads" if heads else "gathered",
           "ring_split": {None: "none", 1: "ctx", 2: "kv_heads"}[
               cache_split(cfg, M, B, ctx)["ring"]]}
    with torch.no_grad():
        # f32 at the cell's depth
        cfg32 = cfg.with_(dtype="float32")
        params = tree_map(lambda t: t.float(), base)
        blocks = _tp_blocks(cfg32, params, M)
        want = forward_logits(cfg32, params, {"tokens": tokens})[0]
        FA.launches = 0
        with _dtypes_seen(FA, "flash_attention_cuda") as seen:
            got = _tp_forward(cfg32, blocks, tokens, M)
        out["flash_launches_split"] = FA.launches
        out["flash_routes_split"] = sorted(
            {FA.route(getattr(torch, d[0])) for d in seen})
        if FA.launches != M * cfg.n_layers:
            raise AssertionError(f"tensor parallel: {arch} at model {M}: "
                                 f"the split launched flash {FA.launches} "
                                 f"times, want {M * cfg.n_layers}")
        errs = [_rel_l2(g, want) for g in got]
        out["f32_logits_rel_l2"] = max(errs)
        if not (max(errs) <= TP_F32_TOL
                and all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(f"tensor parallel: {arch} at model {M}: "
                                 f"f32 logits of the ranks {errs} from the "
                                 f"unsharded model's (tol {TP_F32_TOL})")
        del got, want
        # greedy tokens of prefill and decode, f32: each rank against the
        # unsharded server
        split_toks = _tp_greedy(cfg32, blocks, {"tokens": tokens}, T, ctx,
                                M)
        last, cache = prefill(cfg32, params, {"tokens": tokens}, ctx_len=ctx)
        first = last.argmax(-1)
        served = Server(cfg32, ServeConfig(batch=B, ctx_len=ctx),
                        device=device).generate(
            params, first.cpu().numpy(), T, start_pos=S, cache=cache)
        whole_toks = np.concatenate([first.cpu().numpy()[:, None], served], 1)
        del cache, params, blocks
        torch.cuda.empty_cache()
        for r, toks in enumerate(split_toks):
            if not np.array_equal(toks, whole_toks):
                raise AssertionError(
                    f"tensor parallel: {arch} at model {M}: rank {r}'s "
                    f"greedy tokens {toks.tolist()} != the server's "
                    f"{whole_toks.tolist()}")
        out["greedy_tokens_equal"] = T + 1
        # bf16 at TP_BF16_LAYERS
        cfg16 = cfg.with_(n_layers=TP_BF16_LAYERS, dtype="bfloat16")
        params = _cut_depth(base, cfg16)
        blocks = _tp_blocks(cfg16, params, M)
        want = forward_logits(cfg16, params, {"tokens": tokens})[0]
        FA.launches = 0
        with _dtypes_seen(FA, "flash_attention_cuda") as seen:
            got = _tp_forward(cfg16, blocks, tokens, M)[0]
        out["flash_launches_split_bf16"] = FA.launches
        out["flash_routes_split_bf16"] = sorted(
            {FA.route(getattr(torch, d[0])) for d in seen})
        err = _rel_l2(got, want)
        out["bf16_logits_rel_l2"] = err
        if cfg.family == "moe":
            # an ulp between the two sums moves the MoE's routing (as in
            # phase 17), so its whole-model bf16 logits are reported and
            # each block is gated on the same input instead
            out["bf16_blocks_rel_l2"] = err = _tp_blocks_bf16(
                cfg16, params, blocks, tokens, M)
        if not (err <= TOL[torch.bfloat16] and torch.isfinite(got).all()):
            raise AssertionError(f"tensor parallel: {arch} at model {M}: "
                                 f"bf16 at {TP_BF16_LAYERS} layers "
                                 f"{err:.3e} from the unsharded model (tol "
                                 f"{TOL[torch.bfloat16]})")
        del got, want, params, blocks, base
    torch.cuda.empty_cache()
    log(f"tensor parallel: {arch} L={cfg.n_layers} over {M} ranks "
        f"(attention {out['attention']}, ring split on "
        f"{out['ring_split']}) ≡ unsharded: f32 logits of {B} x {S} rel L2 "
        f"{out['f32_logits_rel_l2']:.3e} (worst rank), bf16 at "
        f"{TP_BF16_LAYERS} layers {out['bf16_logits_rel_l2']:.3e}"
        + (f" (blocks on the same input {out['bf16_blocks_rel_l2']:.3e})"
           if "bf16_blocks_rel_l2" in out else "")
        + f"; {T + 1} greedy tokens of prefill and decode equal on every "
        f"rank; flash launched {out['flash_launches_split']} times on the "
        f"ranks' heads ({out['flash_routes_split']}, bf16 "
        f"{out['flash_routes_split_bf16']})")
    return out


def _tp_blocks_bf16(cfg, params, blocks, tokens, M) -> float:
    """The largest relative L2 gap, over the first layer's attention block
    and MoE block each fed the unsharded model's input, between the
    ranks' ``TP`` blocks and the unsharded block (bf16)."""
    from repro_torch.models import model as MM
    from repro_torch.models.tp import ThreadRanks

    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h = MM._embed(cfg, params, tokens)
    P = MM._layer(params["blocks"], 0)
    want = MM._apply_attn(cfg, P["attn"], h, positions=positions)
    want_moe = MM._apply_moe(cfg, P["moe"], want)[0]

    def rank(tp):
        b = MM._layer(blocks[tp.rank]["blocks"], 0)
        return (MM._apply_attn(cfg, b["attn"], h, positions=positions,
                               tp=tp),
                MM._apply_moe(cfg, b["moe"], want, tp)[0])

    outs = ThreadRanks(cfg, M).run(rank)
    return max(max(_rel_l2(a, want), _rel_l2(m, want_moe))
               for a, m in outs)


def _tp_update_blocks(device) -> dict:
    """(d) fused_adam_delayed on rank 0's block of each qwen2-0.5b leaf
    (the per-leaf route at model 2) against its plain version, its
    launches counted over that comparison, then each block timed as
    device time with its bytes bound."""
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.launch.mesh import Mesh

    cfg = _tp_cfg("qwen2-0.5b", None)
    sh = tree_shardings(param_specs(cfg), Mesh({"model": TP_M}))
    specs = tree_leaves(param_specs(cfg))
    numels = [int(np.prod(psh.shard_shape(s.shape)))
              for s, psh in zip(specs, tree_leaves(sh))]
    scal = _scalar_sets("fused_adam_delayed", device)[-1][1]
    rtol, atol = UPDATE_TOL["adam"][torch.bfloat16]
    worst = 0.0
    AU.reset_launches()
    for i, numel in enumerate(numels):
        state = _update_inputs(numel, torch.bfloat16, device, seed=40 + i)
        keep = tree_map(torch.clone, state)
        got = _apply("fused_adam_delayed", "cuda", state, scal)
        want = _apply("fused_adam_delayed", "plain", keep, scal)
        for key in ("p", "m", "v"):
            err = (got[key].float() - want[key].float()).abs()
            if int((err > atol + rtol * want[key].float().abs()).sum()):
                raise AssertionError(f"tensor parallel (d): the kernel on a "
                                     f"block of leaf {i}, {key}, off its "
                                     "plain version")
            worst = max(worst, err.max().item())
        del state, keep, got, want
    launched = AU.launches["fused_adam_delayed"]
    if launched != len(specs):
        raise AssertionError(f"tensor parallel (d): {launched} launches over "
                             f"{len(specs)} blocks, want one a block")
    ms, bound = 0.0, 0.0
    for i, numel in enumerate(numels):
        state = _update_inputs(numel, torch.bfloat16, device, seed=40 + i)
        ms += device_ms(lambda: _apply("fused_adam_delayed", "cuda", state,
                                       scal), iters=10)
        bound += op_cost.bound_ms(
            numel * op_cost.UPDATE_OPS["fused_adam_delayed"],
            numel * op_cost.update_bytes_per_elem("fused_adam_delayed", 2, 2),
            PEAK_FLOPS_F32)[0]
        del state
    torch.cuda.empty_cache()
    n = sum(numels)
    out = {"leaves": len(specs), "launches": launched, "block_elements": n,
           "max_abs_err": worst, "ms": ms, "bound_ms": bound,
           "bound_by": "bytes"}
    log(f"tensor parallel (d): fused_adam_delayed on rank 0's block of each "
        f"of {len(specs)} qwen2-0.5b leaves ({n:,} elements): {launched} "
        f"launches, max abs err {worst:.3e}; {ms:.4f} ms device time over "
        f"the blocks against a bytes bound of {bound:.4f} ms")
    return out


def phase_tensor_parallel(device, card: str) -> dict:
    """Phase 21: the model axis on one card.  Two ranks cannot share the
    card (NCCL refuses; gloo's all-gather of CUDA tensors faults), so the
    ranks run as threads of this process (``models.tp.ThreadRanks``):
    each drives the port's entry points (``forward_logits``, ``prefill``,
    ``decode_step``) on its blocks (``NamedSharding.local``) under its own
    ``TP``, whose operators combine the ranks' tensors where the
    collectives would.  Against the unsharded model: (a) qwen2-0.5b at
    full width and depth, at model 2 (head-parallel) and 4 (attention
    gathered, ring split on ctx), (b) deepseek-moe-16b at full width, 4
    of its 28 layers, at model 2; (c) flash at the ranks' local head
    shapes; (d) the update kernel on a rank's blocks."""
    t0 = time.perf_counter()
    cells = [_tp_cell(device, *cell) for cell in TP_CELLS]
    flash = _flash_rows(device, TP_FLASH_SHAPES, "tensor parallel (c)")
    update = _tp_update_blocks(device)
    out = {"card": card, "cells": cells, "flash_local": flash,
           "fused_adam_delayed_blocks": update,
           "seconds": time.perf_counter() - t0}
    log(f"tensor parallel: every gate passed in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 22: the model axis for the ssm, hybrid, audio and vlm families
# ---------------------------------------------------------------------------
#: (arch, arch overrides, model axis) of the split ≡ unsharded cells:
#: mamba2-370m at 12 of its 48 layers; zamba2-7b at a group of six and a
#: three-layer tail; seamless and pixtral with their depth cut (the
#: depths keep the whole script inside its 1200 s)
TPF_CELLS = (("mamba2-370m", (("n_layers", 12),), 2),
             ("mamba2-370m", (("n_layers", 12),), 4),
             ("zamba2-7b", (("n_layers", 9),), 2),
             ("seamless-m4t-large-v2", (("n_layers", 4), ("enc_layers", 4)),
              2),
             ("pixtral-12b", (("n_layers", 4),), 2))
#: the bf16 gate's 2 layers (the hybrid's shared block before each, the
#: audio encoder cut too)
TPF_BF16_CUT = {"zamba2-7b": (("n_layers", 2), ("attn_every", 1)),
                "seamless-m4t-large-v2": (("n_layers", 2),
                                          ("enc_layers", 2))}
#: SSD at the ranks' local shapes at model 2: (label, B, nc, c, H, P, N)
TPF_SSD_SHAPES = (("mamba2-370m at model 2", 4, 8, 128, 16, 64, 128),
                  ("zamba2-7b at model 2", 4, 8, 128, 56, 64, 64))
#: flash at the ranks' local shapes at model 2: (label, B, Sq, Sk, H, KV,
#: D, causal, window)
TPF_FLASH_SHAPES = (
    ("zamba2-7b at model 2", 4, 1024, 1024, 16, 16, 112, True, None),
    ("seamless-m4t-large-v2/encoder at model 2", 4, 1024, 1024, 8, 8, 64,
     False, None),
    ("pixtral-12b at model 2", 4, 1024, 1024, 16, 4, 128, True, None))


def _split_counts(cfg) -> dict:
    """Flash and SSD launches of one forward of ``cfg``: one flash per
    attention block (the hybrid's insertions; the audio encoder's, the
    decoder's self- and cross-attention), one SSD per Mamba2 layer."""
    flash = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
             "audio": cfg.enc_layers + 2 * cfg.n_layers}.get(
        cfg.family, cfg.n_layers)
    ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    return {"flash": flash, "ssd": ssd}


def _tpf_split_forward(label, cfg, blocks, batch, M) -> tuple:
    """Every rank's logits of ``batch`` through ``forward_logits`` on its
    blocks, with both kernels' counts set to 0 before and read after:
    each must be ``M`` × the forward's (:func:`_split_counts`), on the
    route of ``cfg``'s dtype.  Returns (logits, launches, routes)."""
    from repro_torch.models.tp import ThreadRanks

    FA.launches = 0
    _zero_ssd()
    with _dtypes_seen(FA, "flash_attention_cuda") as fseen, \
            _dtypes_seen(SSD, "ssd_chunk_cuda") as sseen:
        got = ThreadRanks(cfg, M).run(lambda tp: forward_logits(
            cfg, blocks[tp.rank], batch, tp=tp)[0])
    launched = {"flash": FA.launches, "ssd": SSD.launches}
    if launched["ssd"]:
        _ssd_designs(label, all(d[0] == "bfloat16" for d in sseen))
    want = {k: M * v for k, v in _split_counts(cfg).items()}
    if launched != want:
        raise AssertionError(f"{label}: the split launched {launched}, "
                             f"want {want}")
    routes = _routes(fseen, sseen)
    return got, launched, routes


def _tpf_cell(device, arch, over, M) -> dict:
    """One cell: the split ≡ the unsharded model at a model axis of
    ``M`` through the entry points on each rank's blocks, f32 logits at
    the cell's depth (kernels counted), greedy tokens against the
    unsharded ``Server``, bf16 at 2 layers."""
    B, S, T = TP_SHAPE["batch"], TP_SHAPE["prompt_len"], TP_SHAPE["steps"]
    cfg = _tp_cfg(arch, None, use_ssd_kernel=True, **dict(over))
    base = init_params(cfg, TP_SHAPE["seed"], device)
    batch = model_batch(cfg, B, S, TP_SHAPE["seed"] + 11, device)
    S_tok = batch["tokens"].shape[1]
    ctx = -(-(S_tok + T + 1) // 8) * 8
    label = f"tensor parallel families: {arch} at model {M}"
    out = {"arch": arch, "n_layers": cfg.n_layers, "model_axis": M,
           "inputs": {k: list(v.shape) for k, v in batch.items()}}
    with torch.no_grad():
        cfg32 = cfg.with_(dtype="float32")
        params = tree_map(lambda t: t.float(), base)
        blocks = _tp_blocks(cfg32, params, M)
        want = forward_logits(cfg32, params, batch)[0]
        got, out["launches_split"], out["routes_split"] = \
            _tpf_split_forward(label, cfg32, blocks, batch, M)
        errs = [_rel_l2(g, want) for g in got]
        out["f32_logits_rel_l2"] = max(errs)
        if not (max(errs) <= TP_F32_TOL
                and all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(f"{label}: f32 logits of the ranks {errs} "
                                 f"from the unsharded model's (tol "
                                 f"{TP_F32_TOL})")
        del got, want
        split_toks = _tp_greedy(cfg32, blocks, batch, T, ctx, M)
        last, cache = prefill(cfg32, params, batch, ctx_len=ctx)
        first = last.argmax(-1)
        served = Server(cfg32, ServeConfig(batch=B, ctx_len=ctx),
                        device=device).generate(
            params, first.cpu().numpy(), T, start_pos=S_tok, cache=cache)
        whole_toks = np.concatenate([first.cpu().numpy()[:, None], served], 1)
        del cache, params, blocks
        torch.cuda.empty_cache()
        for r, toks in enumerate(split_toks):
            if not np.array_equal(toks, whole_toks):
                raise AssertionError(
                    f"{label}: rank {r}'s greedy tokens {toks.tolist()} != "
                    f"the server's {whole_toks.tolist()}")
        out["greedy_tokens_equal"] = T + 1
        cut = dict(TPF_BF16_CUT.get(arch, (("n_layers", TP_BF16_LAYERS),)))
        cfg16 = cfg.with_(dtype="bfloat16", **cut)
        params = _cut_depth(base, cfg16)
        blocks = _tp_blocks(cfg16, params, M)
        want = forward_logits(cfg16, params, batch)[0]
        got, out["launches_split_bf16"], out["routes_split_bf16"] = \
            _tpf_split_forward(label + " (bf16)", cfg16, blocks, batch, M)
        err = max(_rel_l2(g, want) for g in got)
        out["bf16_logits_rel_l2"] = err
        if not (err <= TOL[torch.bfloat16]
                and all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(f"{label}: bf16 at 2 layers {err:.3e} from "
                                 f"the unsharded model (tol "
                                 f"{TOL[torch.bfloat16]})")
        for name, n in out["launches_split_bf16"].items():
            if n and out["routes_split_bf16"][name] != ["tensor_cores"]:
                raise AssertionError(f"{label}: bf16 {name} routes "
                                     f"{out['routes_split_bf16'][name]}")
        del got, want, params, blocks, base
    torch.cuda.empty_cache()
    log(f"{label}: L={cfg.n_layers} inputs {out['inputs']} ≡ unsharded: "
        f"f32 logits rel L2 {out['f32_logits_rel_l2']:.3e} (worst rank), "
        f"bf16 at 2 layers {err:.3e}; {T + 1} greedy tokens equal on every "
        f"rank; launched on the ranks' heads {out['launches_split']} "
        f"({out['routes_split']}), bf16 {out['launches_split_bf16']} "
        f"({out['routes_split_bf16']})")
    return out


def phase_tp_families(device, card: str) -> dict:
    """Phase 22: the model axis for the ssm, hybrid, audio and vlm
    families on one card, the ranks as threads (as phase 21): the cells of
    ``TPF_CELLS``, then SSD and flash at the ranks' local shapes."""
    t0 = time.perf_counter()
    cells = []
    for cell in TPF_CELLS:
        cells.append(_tpf_cell(device, *cell))
        torch.cuda.empty_cache()
    tag = "tensor parallel families (local shapes)"
    rows = (_flash_rows(device, TPF_FLASH_SHAPES, tag)
            + _ssd_rows(device, TPF_SSD_SHAPES, tag))
    for r in rows:
        log(f"{tag}: {r['kernel']} at {r['arch']}'s shape {r['shape']} "
            f"bf16: device time per call: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, sdpa {r['sdpa_ms']}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()
    out = {"card": card, "cells": cells, "local_shapes": rows,
           "seconds": time.perf_counter() - t0}
    log(f"tensor parallel families: every gate passed in "
        f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 23: the slot lane over the model axis
# ---------------------------------------------------------------------------
#: (arch, arch overrides, model axis) of the slot-lane cells: qwen2-0.5b at
#: model 2 (its two kv heads split) and at model 4 (attention gathered,
#: the ragged ring split on ctx) at 6 of its 24 layers, mamba2-370m at 12
#: of its 48, zamba2-7b at phase 22's 9 layers and deepseek-moe-16b at
#: phase 21's 4, at model 2 (the depths keep the whole script inside its
#: 1200 s)
TPS_CELLS = (("qwen2-0.5b", (("n_layers", 6),), 2),
             ("qwen2-0.5b", (("n_layers", 6),), 4),
             ("mamba2-370m", (("n_layers", 12),), 2),
             ("zamba2-7b", (("n_layers", 9),), 2),
             ("deepseek-moe-16b", (("n_layers", 4),), 2))
#: each cell's serve: 8 slots, 6 requests of 512-token prompts arriving in
#: pairs a chunk apart (rows at two positions in every chunk, the first
#: pair's slots reused by the third), T tokens each, K decode steps a
#: chunk, pure admission, greedy
TPS_SERVE = dict(n_slots=8, n_requests=6, prompt_len=512, T=12, K=8,
                 seed=0)
TPS_F32_TOL = 2e-5             # relative L2 of a decode step's logits, f32
#: the admissions' batch-1 prefill shapes on a rank: flash (label, B, Sq,
#: Sk, H, KV, D, causal, window), SSD (label, B, nc, c, H, P, N)
TPS_FLASH_SHAPES = (
    ("qwen2-0.5b admission at model 2", 1, 512, 512, 7, 1, 64, True, None),
    ("qwen2-0.5b admission at model 4 (gathered)", 1, 512, 512, 14, 2, 64,
     True, None),
    ("zamba2-7b admission at model 2", 1, 512, 512, 16, 16, 112, True,
     None),
    ("deepseek-moe-16b admission at model 2", 1, 512, 512, 8, 8, 128,
     True, None))
TPS_SSD_SHAPES = (
    ("mamba2-370m admission at model 2", 1, 4, 128, 16, 64, 128),
    ("mamba2-370m admission at model 4", 1, 4, 128, 8, 64, 128),
    ("zamba2-7b admission at model 2", 1, 4, 128, 56, 64, 64))
TPS_REDUCED = False            # True rehearses the phase at reduced size


def _tps_drive(cfg, params, prompts, arrivals, ctx, tp=None, want=None):
    """The slot lane's admissions and decode chunks, driven through its own
    ``_Lanes`` (the admission write, the ragged step with its masks and
    tap rows), on one rank's blocks under ``tp`` or on the whole model
    (``tp`` None).  The host side is the ``SlotServer``'s for this cell:
    at each chunk boundary the completed lanes free their slots and the
    arrived requests, in request order, take the lowest free ones, each
    through a batch-1 ``prefill`` (on the rank's heads under ``tp``).
    ``want``: the whole model's logits of each decode step, which the
    rank's are held to (relative L2 over the active rows).  Returns
    (tokens (n_requests, T), the logits of each step with its active rows
    (``want`` None) or the worst relative L2)."""
    from repro_torch.distributed.slot_serve import _Lanes
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import cache_specs, decode_step

    n, plen = prompts.shape
    S, K, T = TPS_SERVE["n_slots"], TPS_SERVE["K"], TPS_SERVE["T"]
    lanes = _Lanes(cfg, SlotConfig(n_slots=S, ctx_len=ctx, seed=0,
                                   steps_per_launch=K), prompts.device)
    if tp is not None:
        sh = tree_shardings(cache_specs(cfg, S, ctx, ragged=True),
                            Mesh({"model": tp.M}))
        lanes.cache = tree_map(lambda t, s: s.local(t, rank=tp.rank)
                               .clone(), lanes.cache, sh)
    logs, worst = [], [0.0]

    def decode(cfg_, p, cache, toks, pos, ctx_):
        act = lanes.active.clone()
        lg, cache = decode_step(cfg_, p, cache, toks, pos, ctx_, tp=tp)
        if want is None:
            logs.append((lg.clone(), act))
        else:
            w, wact = want[len(logs)]
            logs.append(None)
            if not torch.equal(act, wact):
                raise AssertionError("the ranks' active lanes differ from "
                                     "the whole model's")
            worst[0] = max(worst[0], _rel_l2(lg[act], w[act]))
        return lg, cache

    lanes.decode = decode
    lanes.reset()
    rid_of, fin = [-1] * S, [0] * S
    out = {r: [] for r in range(n)}
    t, nxt = 0, 0
    while nxt < n or any(r >= 0 for r in rid_of):
        for s in range(S):
            if rid_of[s] >= 0 and fin[s] <= t:
                rid_of[s] = -1
        free = [s for s in range(S) if rid_of[s] < 0]
        while free and nxt < n and arrivals[nxt] <= t:
            s = free.pop(0)
            last, row = prefill(cfg, params, {"tokens": prompts[nxt:nxt + 1]},
                                ctx_len=ctx, tp=tp)
            tok0 = torch.argmax(last, dim=-1)
            lanes.admit(s, row, tok0, plen, T - 1, nxt)
            out[nxt].append(int(tok0))
            rid_of[s], fin[s] = nxt, t + T - 1
            nxt += 1
        if all(r < 0 for r in rid_of):
            t += K
            continue
        owner = list(rid_of)
        for j in range(K):
            lanes.step(params, j)
        tap = lanes.tap.cpu().numpy()
        for j in range(K):
            for s in range(S):
                if tap[j, 1, s]:
                    out[owner[s]].append(int(tap[j, 0, s]))
        t += K
    toks = np.array([out[r] for r in range(n)], dtype=np.int32)
    return toks, (logs if want is None else worst[0])


def _tps_cell(device, arch, over, M) -> dict:
    """One cell: the slot lane on each rank's blocks at a model axis of
    ``M`` (the ranks as threads) against the whole model's lane and the
    unsharded ``SlotServer`` on the card, in f32: every request's greedy
    tokens equal, each decode step's logits within ``TPS_F32_TOL``, flash
    and SSD launched on the ranks' heads requests × ranks × layers
    times."""
    from repro_torch.models.tp import ThreadRanks

    n, plen, T = (TPS_SERVE["n_requests"], TPS_SERVE["prompt_len"],
                  TPS_SERVE["T"])
    S, K = TPS_SERVE["n_slots"], TPS_SERVE["K"]
    cfg = get_arch(arch)
    cfg = (cfg.reduced() if TPS_REDUCED else cfg).with_(
        use_flash_attention=True, use_ssd_kernel=True, remat="none",
        dtype="float32", **dict(over))
    ctx = -(-(plen + T) // 8) * 8
    label = f"slot lane over the model axis: {arch} at model {M}"
    prompts_np = np.random.default_rng(TPS_SERVE["seed"] + 23).integers(
        0, cfg.vocab, (n, plen))
    prompts = torch.as_tensor(prompts_np, dtype=torch.int64, device=device)
    arrivals = np.arange(n, dtype=np.int64) // 2 * K
    out = {"arch": arch, "n_layers": cfg.n_layers, "model_axis": M,
           "slots": S, "requests": n, "prompt_len": plen, "T": T, "K": K}
    with torch.no_grad():
        params = tree_map(lambda t: t.float(),
                          init_params(cfg, TPS_SERVE["seed"], device))
        srv = SlotServer(cfg, SlotConfig(n_slots=S, ctx_len=ctx, seed=0,
                                         steps_per_launch=K), device=device)
        res = srv.serve(params, prompts_np, T, admission="pure",
                        arrivals=arrivals)
        del srv
        torch.cuda.empty_cache()
        whole_toks, want = _tps_drive(cfg, params, prompts, arrivals, ctx)
        if not np.array_equal(whole_toks, res.tokens):
            raise AssertionError(f"{label}: the whole model's lane "
                                 f"{whole_toks.tolist()} != the SlotServer's "
                                 f"{res.tokens.tolist()}")
        blocks = _tp_blocks(cfg, params, M)
        FA.launches = 0
        _zero_ssd()
        t0 = time.perf_counter()
        with _dtypes_seen(FA, "flash_attention_cuda") as fseen, \
                _dtypes_seen(SSD, "ssd_chunk_cuda") as sseen:
            ranks = ThreadRanks(cfg, M).run(lambda tp: _tps_drive(
                cfg, blocks[tp.rank], prompts, arrivals, ctx, tp, want))
        out["ranks_s"] = time.perf_counter() - t0
        launched = {"flash": FA.launches, "ssd": SSD.launches}
        if launched["ssd"]:
            out["ssd_designs"] = _ssd_designs(
                label, all(d[0] == "bfloat16" for d in sseen))
        per = _split_counts(cfg)
        hand = {k: n * M * v for k, v in per.items()}
        out["launches_split"], out["launches_hand"] = launched, hand
        out["routes_split"] = _routes(fseen, sseen)
        if launched != hand:
            raise AssertionError(f"{label}: the ranks launched {launched}, "
                                 f"want {hand} (requests × ranks × layers)")
        errs = [e for _, e in ranks]
        out["f32_logits_rel_l2"] = max(errs)
        out["decode_steps"] = len(want)
        if not max(errs) <= TPS_F32_TOL:
            raise AssertionError(f"{label}: the ranks' decode logits {errs} "
                                 f"from the whole model's (tol "
                                 f"{TPS_F32_TOL})")
        for r, (toks, _) in enumerate(ranks):
            if not np.array_equal(toks, res.tokens):
                d = np.argwhere(toks != res.tokens)[0].tolist()
                raise AssertionError(f"{label}: rank {r}'s tokens differ "
                                     f"from the SlotServer's first at "
                                     f"(request, token) {d}")
        out["greedy_tokens_equal"] = int(res.tokens.size)
        del params, blocks, want, ranks
    torch.cuda.empty_cache()
    log(f"{label}: L={cfg.n_layers} {S} slots, {n} requests of {plen} "
        f"tokens, T {T}, K {K}: {out['greedy_tokens_equal']} greedy tokens "
        f"equal to the unsharded SlotServer's on every rank; "
        f"{out['decode_steps']} decode steps' f32 logits within "
        f"{out['f32_logits_rel_l2']:.3e} rel L2 (worst rank); admissions "
        f"launched on the ranks' heads {launched} (hand count {hand}, "
        f"routes {out['routes_split']}); ranks {out['ranks_s']:.1f} s")
    return out


def phase_tp_slots(device, card: str) -> dict:
    """Phase 23: the slot lane over the model axis on one card, the ranks
    as threads (as phases 21–22): the cells of ``TPS_CELLS``, then flash
    and SSD at the admissions' batch-1 shapes on a rank."""
    t0 = time.perf_counter()
    cells = []
    for cell in TPS_CELLS:
        cells.append(_tps_cell(device, *cell))
        torch.cuda.empty_cache()
    tag = "slot lane over the model axis (admission shapes)"
    rows = (_flash_rows(device, TPS_FLASH_SHAPES, tag)
            + _ssd_rows(device, TPS_SSD_SHAPES, tag))
    for r in rows:
        log(f"{tag}: {r['kernel']} at {r['arch']}'s shape {r['shape']} "
            f"bf16: device time per call: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, sdpa {r['sdpa_ms']}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()
    out = {"card": card, "cells": cells, "local_shapes": rows,
           "seconds": time.perf_counter() - t0}
    log(f"slot lane over the model axis: every gate passed in "
        f"{out['seconds']:.1f} s")
    return out


#: wall seconds of each phase of this run, by name, in order
PHASE_SECONDS: dict = {}


# ---------------------------------------------------------------------------
# phase 24: sequence parallelism over the model axis
# ---------------------------------------------------------------------------
#: qwen2-0.5b at full width under SEQ_PARALLEL_RULES at model 4: its 14
#: heads do not divide the axis, so each rank computes q for its 256 rows
#: of a 1024-token prompt against k / v of the gathered sequence
SEQ_ARCH = "qwen2-0.5b"
SEQ_M = 4
SEQ_SHAPE = dict(batch=4, prompt_len=1024, steps=8, seed=0)
#: the depth of the f32 loss-and-grads gate (None: the config's own)
SEQ_GRAD_LAYERS = None
#: f32 relative L2 of each gradient leaf (the port's grads against JAX's,
#: PERF.md section 2); the loss, the whole gradient and the logits are
#: held at phase 21's TP_F32_TOL
SEQ_LEAF_TOL = 1.7e-4
#: flash at q_offset > 0 on a rank's block of the query rows: (label, B,
#: rows, Sk, H, KV, D, ranks); the prefill at model 4, and prefill_32k's
#: at model 8 (the dry-run's rank of 32x8)
SEQ_FLASH_SHAPES = (
    ("qwen2-0.5b prefill at model 4", 4, 256, 1024, 14, 2, 64, 4),
    ("qwen2-0.5b prefill_32k at model 8", 1, 4096, 32768, 14, 2, 64, 8))
SEQ_REDUCED = False            # True rehearses the phase at reduced size


def _seq_cfg(layers=None, **kw):
    cfg = get_arch(SEQ_ARCH)
    cfg = cfg.reduced() if SEQ_REDUCED else cfg
    if layers is not None:
        kw["n_layers"] = layers
    return cfg.with_(remat="none", **kw)


def _seq_blocks(cfg, params, M) -> list:
    """Each rank's blocks of ``params`` under SEQ_PARALLEL_RULES (the
    params' split is the default rules'; only the activations differ)."""
    from repro_torch.distributed.sharding import (SEQ_PARALLEL_RULES,
                                                  tree_shardings)
    from repro_torch.launch.mesh import Mesh

    sh = tree_shardings(param_specs(cfg), Mesh({"model": M}),
                        SEQ_PARALLEL_RULES)
    return [tree_map(lambda t, s, r=r: s.local(t, rank=r), params, sh)
            for r in range(M)], sh


def _seq_grads(cfg, base, tokens, M) -> dict:
    """loss_fn and its grads on the ranks (threads with autograd on,
    ``ThreadRanks.run(grad=True)``: the operators' backward collectives
    run over the threads) against the unsharded model's, each rank's
    gradient against its block of the whole one: (loss rel err, the
    whole gradient's rel L2, the worst leaf's rel L2 and path)."""
    from repro_torch.distributed.sharding import SEQ_PARALLEL_RULES
    from repro_torch.models.model import loss_fn
    from repro_torch.models.tp import ThreadRanks
    from repro_torch.tree import tree_leaves_with_path

    dt = getattr(torch, cfg.dtype)
    params = tree_map(lambda t: t.to(dt), base)
    batch = {"tokens": tokens}
    whole = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    leaves = [t for _, t in tree_leaves_with_path(whole)]
    loss = loss_fn(cfg, whole, batch)[0]
    want = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    del whole, leaves
    blocks, sh = _seq_blocks(cfg, params, M)
    blocks = [tree_map(lambda t: t.detach().clone().requires_grad_(), b)
              for b in blocks]
    del params

    def rank(tp):
        b = blocks[tp.rank]
        lo = loss_fn(cfg, b, batch, tp=tp)[0]
        g = torch.autograd.grad(lo, [t for _, t in tree_leaves_with_path(b)])
        return lo.detach(), g

    outs = ThreadRanks(cfg, M, SEQ_PARALLEL_RULES).run(rank, grad=True)
    del blocks
    paths = [p for p, _ in tree_leaves_with_path(base)]
    shs = tree_leaves(sh)
    loss_err, num, den, worst, worst_path = 0.0, 0.0, 0.0, 0.0, ""
    for r, (lo, grads) in enumerate(outs):
        loss_err = max(loss_err, abs(float(lo) - float(loss))
                       / abs(float(loss)))
        for path, g, w, s in zip(paths, grads, want, shs):
            w = s.local(w, rank=r)
            d2 = float((g.double() - w.double()).square().sum())
            n2 = float(w.double().square().sum())
            num, den = num + d2, den + n2
            e = math.sqrt(d2 / max(n2, 1e-300))
            if e > worst:
                worst, worst_path = e, f"rank {r} {path}"
    torch.cuda.empty_cache()
    return {"loss": float(loss), "loss_rel_err": loss_err,
            "grads_rel_l2": math.sqrt(num / den), "worst_leaf_rel_l2": worst,
            "worst_leaf": worst_path}


def _seq_greedy(cfg, blocks, tokens, T, ctx, M) -> list:
    """Every rank's (last-token logits of the prefill, greedy tokens of
    it and ``T`` decode steps) under SEQ_PARALLEL_RULES."""
    from repro_torch.distributed.sharding import SEQ_PARALLEL_RULES
    from repro_torch.models.model import decode_step
    from repro_torch.models.tp import ThreadRanks

    S = tokens.shape[1]

    def rank(tp):
        params = blocks[tp.rank]
        last, cache = prefill(cfg, params, {"tokens": tokens}, ctx_len=ctx,
                              tp=tp)
        toks = [last.argmax(-1)]
        for i in range(T):
            lg, cache = decode_step(cfg, params, cache, toks[-1], S + i, ctx,
                                    tp=tp)
            toks.append(lg.argmax(-1))
        return last, torch.stack(toks, 1).cpu().numpy()

    return ThreadRanks(cfg, M, SEQ_PARALLEL_RULES).run(rank)


@contextlib.contextmanager
def _flash_offsets():
    """The ``q_offset`` of every flash kernel launch while it is open."""
    fn, seen = FA.flash_attention_cuda, []

    @functools.wraps(fn)
    def recording(*args, **kw):
        seen.append(kw.get("q_offset", 0))
        return fn(*args, **kw)

    FA.flash_attention_cuda = recording
    try:
        yield seen
    finally:
        FA.flash_attention_cuda = fn


def _seq_prefill(cfg, base, tokens, M) -> dict:
    """The seq-split prefill (flash at the ranks' offsets) and greedy
    decode against the unsharded prefill and server, f32; bf16 logits
    reported."""
    B, S, T = tokens.shape[0], tokens.shape[1], SEQ_SHAPE["steps"]
    ctx = -(-(S + T + 1) // 8) * 8
    out = {}
    cfg32 = cfg.with_(dtype="float32", use_flash_attention=True)
    params = tree_map(lambda t: t.float(), base)
    blocks, _ = _seq_blocks(cfg32, params, M)
    want, cache = prefill(cfg32, params, {"tokens": tokens}, ctx_len=ctx)
    first = want.argmax(-1)
    served = Server(cfg32, ServeConfig(batch=B, ctx_len=ctx),
                    device=tokens.device).generate(
        params, first.cpu().numpy(), T, start_pos=S, cache=cache)
    whole_toks = np.concatenate([first.cpu().numpy()[:, None], served], 1)
    del cache
    FA.launches = 0
    with _dtypes_seen(FA, "flash_attention_cuda") as seen, \
            _flash_offsets() as offsets:
        outs = _seq_greedy(cfg32, blocks, tokens, T, ctx, M)
    out["flash_launches_split"] = FA.launches
    out["flash_routes_split"] = sorted(
        {FA.route(getattr(torch, d[0])) for d in seen})
    out["flash_offsets"] = sorted(set(offsets))
    from repro_torch.models.tp import TP

    want_offsets = [0] if TP(cfg, None, M, 0, None).heads_split() else \
        [r * (S // M) for r in range(M)]
    if FA.launches != M * cfg.n_layers or \
            out["flash_offsets"] != want_offsets:
        raise AssertionError(
            f"sequence parallel: the prefill launched flash {FA.launches} "
            f"times at offsets {out['flash_offsets']}, want "
            f"{M * cfg.n_layers} at {want_offsets}")
    errs = [_rel_l2(last, want) for last, _ in outs]
    out["f32_logits_rel_l2"] = max(errs)
    if not (max(errs) <= TP_F32_TOL
            and all(torch.isfinite(last).all() for last, _ in outs)):
        raise AssertionError(f"sequence parallel: f32 prefill logits of the "
                             f"ranks {errs} from the unsharded model's (tol "
                             f"{TP_F32_TOL})")
    for r, (_, toks) in enumerate(outs):
        if not np.array_equal(toks, whole_toks):
            raise AssertionError(
                f"sequence parallel: rank {r}'s greedy tokens "
                f"{toks.tolist()} != the server's {whole_toks.tolist()}")
    out["greedy_tokens_equal"] = T + 1
    del outs, blocks, params
    torch.cuda.empty_cache()
    # bf16, the tensor-core route at the offsets: reported
    cfg16 = cfg.with_(use_flash_attention=True)
    blocks, _ = _seq_blocks(cfg16, base, M)
    want16, _ = prefill(cfg16, base, {"tokens": tokens}, ctx_len=ctx)
    FA.launches = 0
    outs = _seq_greedy(cfg16, blocks, tokens, 0, ctx, M)
    out["flash_launches_split_bf16"] = FA.launches
    out["bf16_logits_rel_l2"] = max(_rel_l2(last, want16) for last, _ in outs)
    del outs, blocks
    torch.cuda.empty_cache()
    return out


def _seq_flash_rows(device) -> list:
    """Flash at ``q_offset`` > 0 (a rank's block of the rows against the
    whole sequence's k / v, causal) against its plain version (f32 and
    bf16) and against the same rows of a whole-sequence launch; then bf16
    timed on the device with its plain version, its bound (the pairs its
    rows see) and SDPA with the rows' explicit mask."""
    from repro_torch.kernels.ref import attention_mask

    rows_out = []
    for label, B, n, Sk, H, KV, D, ranks in SEQ_FLASH_SHAPES:
        lo = (ranks - 1) * n                  # the last rank's rows
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(B, Sk, Sk, H, KV, D, dtype, device)
            whole = FA.flash_attention_cuda(q, k, v, causal=True)
            qs = q[:, lo:lo + n]
            got = FA.flash_attention_cuda(qs, k, v, causal=True,
                                          q_offset=lo)
            err, bad = _compare(got, FA.flash_attention_plain(
                qs, k, v, causal=True, q_offset=lo), TOL[dtype])
            werr, wbad = _compare(got, whole[:, lo:lo + n], TOL[dtype])
            log(f"sequence parallel: flash {label}, rows {lo}…{lo + n - 1} "
                f"of {Sk}, {str(dtype)[6:]}: max_abs_err={err:.3e} against "
                f"plain, {werr:.3e} against the whole launch's rows (tol "
                f"{TOL[dtype]:g}) bad={bad + wbad}")
            if bad or wbad:
                raise AssertionError(f"sequence parallel: flash at q_offset "
                                     f"{lo} off at {label} {dtype}")
            del whole, got
        q, k, v = qs.contiguous(), k, v
        del qs
        kw = dict(causal=True, q_offset=lo)
        mask = attention_mask(n, Sk, True, None, device, lo)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {"kernel": "flash_attention", "arch": label,
               "shape": [B, n, Sk, H, KV, D], "q_offset": lo,
               "max_abs_err": err, "whole_rows_max_abs_err": werr,
               "ms": device_ms(lambda: FA.flash_attention_cuda(q, k, v,
                                                               **kw)),
               "plain_ms": device_ms(
                   lambda: FA.flash_attention_plain(q, k, v, **kw), iters=2),
               "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=5)}
        row["bound_ms"], row["bound_by"] = op_cost.bound_ms(
            *op_cost.flash_cost(q, k, True, None, lo), PEAK_FLOPS[q.dtype])
        log(f"sequence parallel: flash {label} q {tuple(q.shape)} at offset "
            f"{lo}, k/v {tuple(k.shape)} bf16: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, sdpa (explicit mask) "
            f"{row['sdpa_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
        rows_out.append(row)
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return rows_out


def phase_seq_parallel(device, card: str) -> dict:
    """Phase 24: sequence parallelism on one card, the ranks as threads
    (``models.tp.ThreadRanks``) under ``SEQ_PARALLEL_RULES``: qwen2-0.5b
    at full width at model 4, each rank holding 256 of the 1024 rows
    between blocks.  (a) ``loss_fn`` and its grads (the operators'
    backward collectives over the threads) ≡ the unsharded model's, f32
    gated, bf16 at TP_BF16_LAYERS reported; (b) a 4 × 1024 prefill (flash
    at each rank's offset, 96 launches) and greedy decode ≡ the unsharded
    prefill and server in f32, bf16 reported; (c) flash at q_offset > 0
    at the prefill's and prefill_32k's rank shapes."""
    t0 = time.perf_counter()
    B, S, M = SEQ_SHAPE["batch"], SEQ_SHAPE["prompt_len"], SEQ_M
    cfg = _seq_cfg()
    base = init_params(cfg, SEQ_SHAPE["seed"], device)
    gen = torch.Generator(device).manual_seed(SEQ_SHAPE["seed"] + 11)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=device)
    out = {"card": card, "arch": SEQ_ARCH, "model_axis": M, "batch": B,
           "prompt_len": S, "rows_a_rank": S // M}
    gcfg = _seq_cfg(SEQ_GRAD_LAYERS, dtype="float32")
    grads = _seq_grads(gcfg, _cut_depth(base, gcfg), tokens, M)
    grads["n_layers"] = gcfg.n_layers
    if not (grads["loss_rel_err"] <= TP_F32_TOL
            and grads["grads_rel_l2"] <= TP_F32_TOL
            and grads["worst_leaf_rel_l2"] <= SEQ_LEAF_TOL):
        raise AssertionError(f"sequence parallel: f32 loss / grads off the "
                             f"unsharded model's: {grads}")
    c16 = _seq_cfg(TP_BF16_LAYERS)
    g16 = _seq_grads(c16, _cut_depth(base, c16), tokens, M)
    out["grads_f32"] = grads
    out["grads_bf16"] = {**g16, "n_layers": TP_BF16_LAYERS}
    log(f"sequence parallel (a): {SEQ_ARCH} L={gcfg.n_layers} over {M} "
        f"ranks, {B} x {S} ({S // M} rows a rank): f32 loss "
        f"{grads['loss']:.6f}, rel err {grads['loss_rel_err']:.3e}; grads "
        f"rel L2 {grads['grads_rel_l2']:.3e} (worst leaf "
        f"{grads['worst_leaf_rel_l2']:.3e}, {grads['worst_leaf']}); bf16 at "
        f"{TP_BF16_LAYERS} layers: loss rel err {g16['loss_rel_err']:.3e}, "
        f"grads rel L2 {g16['grads_rel_l2']:.3e} (reported)")
    out["prefill"] = _seq_prefill(cfg, base, tokens, M)
    p = out["prefill"]
    log(f"sequence parallel (b): {SEQ_ARCH} L={cfg.n_layers} prefill of "
        f"{B} x {S} over {M} ranks: flash launched "
        f"{p['flash_launches_split']} times at offsets "
        f"{p['flash_offsets']} ({p['flash_routes_split']}); f32 logits rel "
        f"L2 {p['f32_logits_rel_l2']:.3e} (worst rank); "
        f"{p['greedy_tokens_equal']} greedy tokens equal on every rank; "
        f"bf16 logits rel L2 "
        f"{p['bf16_logits_rel_l2']:.3e} (reported)")
    del base, tokens
    torch.cuda.empty_cache()
    out["flash_offset_shapes"] = _seq_flash_rows(device)
    out["seconds"] = time.perf_counter() - t0
    log(f"sequence parallel: every gate passed in {out['seconds']:.1f} s")
    return out


def run_phase(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds logged and kept under
    ``name`` in :data:`PHASE_SECONDS`."""
    t = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_SECONDS[name] = round(time.perf_counter() - t, 1)
    log(f"phase {name}: {PHASE_SECONDS[name]} s")
    return out


def main() -> None:
    t0 = time.perf_counter()
    kind, card = run_phase("1 device", phase_device)
    device = torch.device("cuda")
    run_phase("2 build", phase_build)
    flash = run_phase("3 flash", phase_kernels, device)
    run_phase("4 main path", phase_main_path, device, flash)
    updates = run_phase("5 update kernels", phase_update_kernels, device)
    train = run_phase("6 train main", phase_train_main, device,
                      updates["fused_adam_delayed"])
    plain_ms = train["warm_ms"]
    run_phase("7 train others", phase_train_others, device, updates)
    run_phase("8 momentum", phase_momentum_paths, device, updates)
    ssd = run_phase("9 ssd", phase_ssd_kernel, device)
    run_phase("10 ssm main path", phase_ssm_main_path, device, ssd)
    run_phase("11 guards", phase_guards, device)
    slot_rows = run_phase("12 slot lane", lambda: [
        phase_slot_cell(device, cell) for cell in SLOT_CELLS])
    slot_parity = run_phase("12 slot parity", phase_slot_parity, device)
    theory = run_phase("13 theory tier", phase_theory_tier, device)
    durability = run_phase("14 durability", phase_durability, device, card)
    faults = run_phase("15 faults", phase_faults, device,
                       updates["fused_adam_delayed"], card, plain_ms)
    lanes = run_phase("16 trainer lanes", phase_trainer_lanes, device,
                      updates, card, train)
    torch.cuda.empty_cache()
    families = run_phase("17 families", phase_families, device, card,
                         {"flash": flash, "ssd": ssd})
    torch.cuda.empty_cache()
    new = run_phase("18 new families", phase_new_families, device, card, {
        "flash": flash, "fused_adam_delayed": updates["fused_adam_delayed"]})
    torch.cuda.empty_cache()
    launch = run_phase("19 launch tier", phase_launch_tier, device, card)
    torch.cuda.empty_cache()
    data_parallel = run_phase("20 data parallel", phase_data_parallel,
                              device, card)
    torch.cuda.empty_cache()
    tensor_parallel = run_phase("21 tensor parallel",
                                phase_tensor_parallel, device, card)
    torch.cuda.empty_cache()
    tp_families = run_phase("22 tp families", phase_tp_families, device,
                            card)
    torch.cuda.empty_cache()
    tp_slots = run_phase("23 tp slots", phase_tp_slots, device, card)
    torch.cuda.empty_cache()
    seq = run_phase("24 sequence parallel", phase_seq_parallel, device,
                    card)
    local = lambda rows, kernel: [
        {k: r[k] for k in ("arch", "shape", "ms", "plain_ms", "bound_ms",
                           "sdpa_ms")} for r in rows if r["kernel"] == kernel]
    split = lambda kernel: {
        f"{c['arch']}@model{c['model_axis']}": c["launches_split"][kernel]
        for c in tp_families["cells"] if c["launches_split"][kernel]}
    slot_split = lambda kernel: {
        f"{c['arch']}@model{c['model_axis']}": c["launches_split"][kernel]
        for c in tp_slots["cells"] if c["launches_split"][kernel]}
    flash["tensor_parallel"] = {
        "launches_split": {**{f"{c['arch']}@model{c['model_axis']}":
                              c["flash_launches_split"]
                              for c in tensor_parallel["cells"]},
                           **split("flash")},
        "slot_lane_launches_split": slot_split("flash"),
        "local_shapes": (local(tensor_parallel["flash_local"],
                               "flash_attention")
                         + local(tp_families["local_shapes"],
                                 "flash_attention")
                         + local(tp_slots["local_shapes"],
                                 "flash_attention"))}
    flash["seq_parallel"] = {
        "launches_split": {f"{SEQ_ARCH}@model{SEQ_M}":
                           seq["prefill"]["flash_launches_split"]},
        "offset_shapes": [
            {k: r[k] for k in ("arch", "shape", "q_offset", "ms", "plain_ms",
                               "bound_ms", "sdpa_ms")}
            for r in seq["flash_offset_shapes"]]}
    ssd["tensor_parallel"] = {
        "launches_split": split("ssd"),
        "slot_lane_launches_split": slot_split("ssd"),
        "local_shapes": (local(tp_families["local_shapes"], "ssd_chunk")
                         + local(tp_slots["local_shapes"], "ssd_chunk"))}
    updates["fused_adam_delayed"]["tensor_parallel"] = {
        k: tensor_parallel["fused_adam_delayed_blocks"][k]
        for k in ("leaves", "launches", "block_elements", "ms", "bound_ms")}
    updates["fused_adam_delayed"]["data_parallel"] = {
        "launches_one_rank": data_parallel["one_rank"][
            "fused_adam_delayed_launches"],
        "row_elements": data_parallel["two_rank_rows"]["row_elements"],
        "row_ms": data_parallel["two_rank_rows"]["row_ms"],
        "row_bound_ms": data_parallel["two_rank_rows"]["row_bound_ms"],
        "zero_blocks": data_parallel["zero_blocks"]}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entries = [flash] + [updates[k] for k in AU.KERNELS] + [ssd]
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"slot_lane": slot_rows, "slot_parity": slot_parity}))
    print(json.dumps({"theory_tier": theory}))
    print(json.dumps({"durability": durability}))
    print(json.dumps({"faults": faults}))
    print(json.dumps({"trainer_lanes": lanes}))
    print(json.dumps({"families": families}))
    print(json.dumps({"new_families": new}))
    print(json.dumps({"launch_tier": launch}))
    print(json.dumps({"data_parallel": data_parallel}))
    print(json.dumps({"tensor_parallel": tensor_parallel}))
    print(json.dumps({"tensor_parallel_families": tp_families}))
    print(json.dumps({"tensor_parallel_slots": tp_slots}))
    print(json.dumps({"sequence_parallel": seq}))
    print(json.dumps({"phase_seconds": PHASE_SECONDS}))
    print(json.dumps({"kernels": [
        {**{k: e[k] for k in keys},
         **{k: e[k] for k in ("timed_shapes", "family_launches",
                               "family_shapes", "family_pools",
                               "data_parallel", "tensor_parallel",
                               "seq_parallel")
            if k in e}}
        for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
