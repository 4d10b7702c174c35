#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``pytorch_distributed_training_tpu_torch``).

    python3 chip_smoke.py              # needs one CUDA card
    python3 chip_smoke.py --profile    # also: torch.profiler breakdowns of one
                                       # serving batch and one step of each trainer
                                       # (phases 8, 11, 12 and 14)
    python3 chip_smoke.py --f32-runner # phases 1, 2 and 12 only: the f32 trainer,
                                       # to time it against another tree in turns
                                       # (with --profile: and its step's breakdown)
    python3 chip_smoke.py --resnet     # phases 1, 2 and 13 to 17 only: the ResNet
                                       # path (with --profile: its steps' breakdowns)
    python3 chip_smoke.py --accum-faults  # phases 1, 2, 18 and 19 only
    python3 chip_smoke.py --serve      # phases 1, 2, 5, 20 and 21 only: serving (with
                                       # --profile: decode ticks, sync and async, and
                                       # of each decode mode)
    python3 chip_smoke.py --vit        # phases 1, 2, 17, 22 and 23 only: ViT-B16 training
                                       # and classification serving (with --profile:
                                       # the ViT step by op class)
    python3 chip_smoke.py --fleet      # phases 1, 2 and 24 only: the fleet tier
    python3 chip_smoke.py --moe        # phases 1, 2 and 25 only: the MoE LM (with
                                       # --profile: its step's device time by class)
    python3 chip_smoke.py --sp         # phases 1, 2 and 26 only: flash_attention_lse,
                                       # ring and Ulysses attention on virtual ranks
    python3 chip_smoke.py --tp         # phases 1, 2 and 27 only: Megatron tensor and
                                       # expert parallelism, 4 gloo ranks on the card
    python3 chip_smoke.py --zero       # phases 1, 2 and 28 only: ZeRO-1/2/3, 4 gloo
                                       # ranks on the card, (b) at full depth
    python3 chip_smoke.py --pp         # phases 1, 2 and 29 only: the pipeline (GPipe,
                                       # 1F1B), 4 gloo stages on the card, (b) at full
                                       # depth for 1 + 3 steps

Phases, in order; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit), the torch/CUDA versions,
   gloo's ``all_reduce`` of CUDA bf16 tensors over two ranks (phase 27's
   exchanges; it raises if gloo refuses bf16) and gloo's reduce-scatter and
   all-gather of CUDA f32 and bf16 tensors through the port's ZeRO
   exchanges (phase 28's; it raises if gloo refuses one or sums wrong), and
   CUDA f32 and bf16 tensors hopping between two processes through the
   port's stage exchange (phase 29's; gloo's own send of a CUDA tensor
   fails, so the exchange stages through pinned host memory; it raises if
   a value arrives wrong);
2. build every hand-written kernel from ``csrc/`` with nvcc for sm_90a
   (one nvcc per library, all started together), with ptxas's registers
   and spills for each kernel;
3. the elementwise kernels (K3 add+LayerNorm, K4 bias+GELU) against their
   plain PyTorch twins on the card, in bf16 and f32: at the LM-1024 step's
   shapes ([16384, 1024] and [16384, 4096], bf16), serving's prefill and
   decode shapes, [37, 1000], a ragged [37, 1001], a misaligned [37,
   1024] view, [4133, 1000] (partial blocks and row groups) and, for K3,
   [37, 4096] and [37, 4095] (a block a row); s bitwise equal, y within the norm-relative limits of
   ``tools/elementwise_checks.py``, whose wrong kernels (unwritten vectors
   or rows, the variance over E - 1, the neighbouring vector's scale, bias
   or GELU bias, tanh GELU) must all be rejected; the time of each (CUDA
   events, median of 20 launches after warm-up, L2 flushed before each)
   beside its bound, its share of it and the host time per call; inputs
   the kernels do not take must raise;
4. the model at full width (depth 2, float32, TF32 off) on the card with the
   kernels against the same weights on the CPU with the plain twins:
   prefill and one decode step's logits;
5. the serving main path: ``InferenceEngine.from_config`` on the full-width
   config (TransformerLM 1024 wide, 16 blocks, 32768 tokens, bf16, fused
   tails), ``warmup()``, then 16 requests with seeded prompt lengths in
   [1, 512]; every request generates 32 tokens in range, K3 and K4 each
   launch exactly 16 x (1 + 31) = 512 times per batch, and nothing else
   (no flash, no CE launch: serving keeps the einsum attention);
6. the training kernels against their twins, timed as in phase 3, beside
   their bound and one PyTorch call computing the same function
   (``F.cross_entropy``, ``F.scaled_dot_product_attention``, timed here
   only): K1a/K1b at [16384, 32768] and [65536, 8192] f32, ResNet's [64,
   1000] f32, the LARS recipe's [256, 1000] bf16, and [37, 1000] in bf16
   and f32 with an out-of-range label, ViT-B16's [256, 1000] f32;
   flash forward/backward at B 8,
   H 16, S 2048, D 64 bf16 causal (the backward also as its dK/dV and dQ
   launches apart), plus D = 128 bf16 causal at [1, 8, 4096, 128], a
   non-causal case, bf16 causal at [2, 4, 384, 128] and [2, 4, 640, 64] (3
   and 5 tiles of 128 rows), and f32 at [2, 4, 256, 64] causal and [2, 4,
   512, 128] non-causal; wrong variants of each flash kernel must be
   rejected (in f32 also the forward, dK/dV and dQ in one TF32 product,
   ``tools/flash_checks.py``, whose 3xTF32 emulations are read only,
   dK/dV with a Q tile or the diagonal blocks left out, and the dQ
   variants of phase 9), and two dQ and
   two dK/dV launches must be bitwise equal; f32 flash bounds at the
   3xTF32 tensor-core rate, with the share of the FFMA bound beside them;
   wrong dtype, wrong device and an unsupported head dim must raise;
7. one training step at full width (depth 2, float32, TF32 off) on the card
   against the CPU on the same weights and batch: loss and the gradient of
   every parameter;
8. the training main path: the ``train_distributed`` runner on
   ``configs/train-lm-1024.yml`` (full width, 16 blocks, bf16) for 6 steps
   and one validation of 2 batches; every loss finite, and per step exactly
   1 K1a, 1 K1b, 16 flash forwards (K2a), 2 x 16 flash backward launches
   (K2c) and 16 each of K3/K4; the validation adds per batch 1 K1a, 16
   flash forwards and 16 each of K3/K4.  Prints step ms, tokens/s, MFU and
   peak memory;
9. the long-context flash kernels against their twins: bf16 and f32 causal
   at B 2, H 8, S 32768, D 64, where the JAX package streams K/V (K2b,
   K2f, K2g), and f32 at B 8, H 16, S 2048, D 64 (its resident split
   kernels K2a, K2d, K2e); each launch timed (fewer repeats at S = 32768)
   beside its bound, the twins and SDPA; wrong variants that leave out the
   64-row block on the diagonal, a middle block of 64 keys, the last 64
   query rows or (dQ) the diagonal block of the odd 64-row blocks or each
   query's own key, and in f32 the forward, dK/dV and dQ in one TF32
   product, must all be rejected,
   and two dQ and two dK/dV launches must be bitwise equal;
10. one f32 training step of the long-context model at its widths (512, 8
    heads, vocab 8192), depth 2, seq 2048, remat on, TF32 off, card against
    CPU: loss within rtol 1e-5, every gradient within 1e-4 of its largest
    magnitude, and the f32 kernels launched (K2a 4, K2d 2, K2e 2);
11. the long-context main path: the runner on ``configs/train-lm-longctx.yml``
    (seq 32768, embed 512, 8 blocks, block remat, bf16) for 6 steps and one
    validation of 2 batches; every loss finite and per step exactly 1 K1a,
    1 K1b, 16 flash forwards (8 blocks, each run again by remat) and 16
    flash backward launches, all counted under K2b / K2f / K2g, no K3/K4.
    Prints step ms, tokens/s, MFU and peak memory;
12. the training main path at the trainer's default dtype: the runner on
    ``configs/train-lm-1024.yml`` with ``training.dtype`` set to float32 in
    memory (full width, 16 blocks) for 3 steps and one validation of 2
    batches; per step exactly 16 f32 flash forwards (K2a,
    ``flash_fwd_3xtf32_kernel``), 16 K2d (``flash_bwd_dq_3xtf32_kernel``)
    and 16 K2e (``flash_bwd_dkv_3xtf32_kernel``) launches, besides
    K1a/K1b and 16 each of K3/K4.  Prints step ms, tokens/s and peak memory;
13. one training step of ResNet-50 at full width (f32, TF32 off for matmul
    and cuDNN, ``sync_bn`` on at world size 1: raw-moment statistics) on the
    card against the same weights and a seeded batch of 4 images at 224^2
    on the CPU: the loss within rtol 1e-5, the logits and every BatchNorm
    running statistic after the step within 1e-4 of their largest
    magnitude, every gradient as close to a float64 run on the CPU as the
    CPU's f32 one (the f32 backward of this network amplifies rounding to
    ~2.5%), and exactly 1 K1a and 1 K1b launch;
14. the ResNet main path: the runner on ``config/test-sync.yml`` as it is
    (ResNet-50, synthetic 224^2, 1000 classes, batch 64, SGD, multi_step,
    ``sync_bn``, f32) with only ``train_iters`` (8) and the dataset size (2
    validation batches) set in memory, then the same at
    ``training.dtype: bfloat16``; the loader in ``thread`` mode with the
    config's 8 threads, batches staged on the card two ahead
    (``device_prefetch``, pinned buffers); every loss finite and exactly 1
    K1a + 1 K1b a step and 1 K1a a validation batch.  Prints step ms,
    images/s, peak memory, the TF32 flags in force (torch's defaults),
    model FLOP an image and the rate reached; then the loader's host time a
    batch alone, the host-to-device bytes a batch, and the step on one
    batch held on the card (no loader) in ``channels_last`` as the runner
    runs it, in contiguous NCHW and with ``cudnn.benchmark``;
15. the same config through the process loader (``training.worker_mode:
    process``, 8 spawned workers filling shared-memory slots) with
    ``validation.exact``, f32, 6 steps over a set of 300 samples; the same
    launch checks and readings (``nproc`` too), the exact validation's
    count n = 300 held, and the parity validation of the same weights
    beside it (its wrap-padded tail counted again).  The card's host has no
    libjpeg, so the native decoder does not build there: ImageFolder,
    native decode and ``device_normalize`` are held on the CPU only (the
    tests), which the phase prints;
16. the LARS recipe: the runner on ``config/ResNet50-lars8k.yml`` (ResNet-50,
    LARS lr 10, ``poly`` power 2 with warmup, bf16, ``sync_bn``, 32 loader
    threads) with, in memory, synthetic data (no libjpeg on the card's
    host), batch 8192 -> 256 (a card's share at 32 cards), 6500 -> 8 steps
    with a 3-step warmup and validation at the 8th: (a) as it is, (b) with
    the space-to-depth stem, bf16 BatchNorm statistics and the weight EMA
    (0.999; validation on the EMA).  Held first: the s2d ResNet-50 with the
    folded stem against the 7x7 model with the unfolded weights in f32
    (within 3x the CPU pair's f32 error from float64), and one LARS step of
    ResNet-50 on the card against the CPU; then each step's lr against
    ``poly_lr``, 1 K1a + 1 K1b a step ([256, 1000] bf16) and 1 K1a a
    validation batch.  Prints as phase 14 (device-resident in
    ``channels_last`` only), the EMA update's ms, LARS's and SGD's update
    ms, and the device-resident step in four forms (7x7 or s2d stem, f32
    or bf16 statistics) in turns;
17. checkpoint, resume and preemption: ``config/test-sync.yml`` in f32 with
    ``training.checkpoint`` (every 3 steps under ``run/chip_smoke/ckpt``) and
    the EMA, 6 steps straight, killed after step 2's save and resumed by a
    new runner, and stopped by its own SIGTERM at step 4 (a save at 4) and
    relaunched; deterministic algorithms, ``cudnn.benchmark`` off and
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set in the phase, the resumed runs'
    parameters, BatchNorm buffers, momentum, EMA and losses of steps 3-5
    equal the straight run's bit for bit.  Prints the bytes of a step on
    disk, the save and restore ms and a sidecar.
18. the LM at the source batch: ``configs/train-lm-1024-accum.yml`` (batch 64
    as 8 micro-batches over a written token file, ``remat: dots``, the guard
    armed), its f32 checks, the four remat forms, LAMB against AdamW;
19. fault tolerance: ResNet-50 f32 under ``nan_batch``, a rollback,
    ``ckpt_fail``, ``kill_worker`` and ``stall_step``, bitwise;
20. the serving scheduler's main path, ``configs/serve-lm-1024-sched.yml``
    (full width, bf16, the continuous scheduler over the paged KV pool):
    (a) ``InferenceEngine.from_config``, ``warmup()``, 32 requests with
    seeded prompt lengths in [1, 512] and ``max_new_tokens`` in [1, 32],
    every 4th sharing a 256-token prefix: every request generates its cap
    in range, ``retired == admitted == 32``, prefix hits > 0, and K3 and
    K4 each launch exactly 16 x (prefill calls + decode steps) as the
    scheduler counts them, no flash and no CE launch; (b) depth 2, f32,
    TF32 off: 8 greedy requests through the batcher engine and the
    scheduler engine on the same weights give identical tokens (and at
    bf16, full depth, the share of identical tokens is printed); (c)
    ``async_depth`` 2 against 0 on (a)'s requests, greedy and sampled,
    bitwise; (d) on 8 requests: ``serve_device_lost`` restarts once and the
    replayed streams equal the clean run's, ``serve_nan`` and
    ``serve_raise`` fail only their request, the others equal; the restart
    ms; (e) the runner trains ``configs/train-lm-1024.yml`` cut to depth 2
    for 2 steps with a checkpoint, the phase adds a step whose payload
    carries an EMA of the two, and an engine restored through
    ``serving.checkpoint`` gives the greedy tokens of one built from those
    EMA weights in memory; (f) readings beside the card: TTFT p50/p99,
    tokens/s, slot occupancy, block utilisation, prefix-hit rate and host
    ms a tick, sync, async and through the batcher;
21. the scheduler's decode modes, each built by ``InferenceEngine.from_config``
    from ``configs/serve-lm-1024-sched.yml`` with the keys of JAX
    ``config/serve-lm.yml``'s commented example: (a) ``quant``; (b)
    ``lora`` rank 8, tenant-a (seed 0) and tenant-b (seed 1); (c)
    ``speculative`` k 4 with the target drafting for itself; (d) the same
    with ``draft: {depth: 1}``, ``draft_seed`` 0, ``min_acceptance`` 0.2.
    Gates at f32, depth 2, TF32 off, on 8 of phase 20's requests: (a) the
    card's int8 greedy streams equal the port's own on the CPU; (b) with
    adapters cycling tenant-a, base, tenant-b, each tenant's streams equal
    a merged-weights (W + A B) engine's and base rows the plain engine's,
    and a tenant stream differs from base (the factors scaled x30, as the
    JAX oracle does, if the random delta flips none); (c) streams equal
    plain greedy with acceptance 1.0; (d) streams equal plain greedy.
    Readings at bf16, full depth, on phase 20's 32 requests: every request
    its cap, K3 and K4 each launched exactly 16 x the target's paged calls
    + the draft's depth x its own (the ``serving_modes`` counts of the
    kernels line), and tokens/s, TTFT, host ms a tick against phase 20's;
    int8 and scale bytes and dequant launches a tick; prefix hits across
    tenants; acceptance, the floor warning and the draft pool's MiB.
22. ViT-B16: (a) one f32 training step at full width (TF32 off, batch 2)
    on the card against the CPU, both against a plain float64 twin; the
    card's logits and gradients within 3x the CPU's f32 error from float64
    (as phase 13), 1 K1a and 1 K1b; (b) the runner on ``config/ViT-B16.yml``
    (batch 256, bf16, ``device_normalize``, AdamW, cosine warmup) over a
    seeded JPEG tree it writes (PIL in ``worker_mode: thread``: the card's
    host has no libjpeg), 8 steps and 2 validation batches: step ms
    loader-fed and device-resident, images/s, peak memory; (c)
    ``model.pretrained`` of a torchvision-layout ViT-B16 it writes from a
    seed, the parameters before step 1 equal to its own mapping bit for
    bit; (d) exactly 1 K1a + 1 K1b ([256, 1000] f32) a step and 1 K1a a
    validation batch (with ``--profile``: the device-resident step's time
    by op class, the f32 attention einsums named);
23. classification serving: (a) the serving CLI on
    ``config/serve-resnet50.yml`` as it is and on a copy with ``model.name:
    ViT-B16``; (b) each engine warmed up, 128 uint8 requests at once:
    images/s, latency p50/p99, batch fill, host ms a batch, no
    hand-written kernel launched; (c) ResNet-50 served from phase 17's
    checkpoint (with an EMA) at f32, TF32 off, within 1e-5 of the largest
    logit of the runner's own eval of the EMA weights.
24. the fleet tier, ``configs/serve-lm-1024-fleet.yml``: (a) gates at
    depth 2, f32, TF32 off, on 8 of phase 20's requests at cap 32: the
    streams of ``ServingFleet.from_config``'s 2 replicas equal one
    scheduler's on the same model and keys, greedy and at temperature 0.8;
    replica 0 hard-killed mid-stream, every stream still equals it,
    ``on_token`` once a token, ``replay_parity_mismatch`` 0; a prefix's
    blocks exported and imported into another scheduler hold the K/V rows
    of a recompute byte for byte and give its tokens; a corrupted block is
    rejected by its CRC and the suffix recomputed; a prefill replica killed
    mid-transfer (``prefill_replica_down``) falls back to a recompute.  (b)
    Readings at bf16, full width (4 blocks in the whole script's run, 16
    with ``--fleet``), on phase 20's 32 requests: one scheduler on the
    fleet's model, then 2 replicas behind the router (K3 and K4 each
    launched exactly depth x the paged calls summed over the replicas):
    tokens/s, TTFT, host ms a tick per replica; ``add_replica``'s
    ``scale_up_ready_ms`` and pool bytes; the disaggregated fleet (1
    prefill replica) with its directory and a block's bytes, export and
    import ms; through the fleet's and the disaggregated readings no live
    replica is marked down, and each replica's largest heartbeat age is
    printed beside the config's 2 s limit; replica 0 killed mid-trace: ms
    to the survivor's first new token, replayed tokens, any bf16
    ``replay_parity_mismatch``.
25. the Mixture-of-Experts LM: (a) a MoE LM at full width, depth 2 (one
    dense block, one MoE block of 8 experts, top 2), f32 with TF32 off,
    batch 2 x 256, on the card against the CPU on the same weights, one
    backward of the runner's step objective (``TPLMTrainStep.micro_loss``,
    CE + every MoE block's aux term): logits
    and every gradient within 1e-4 of their largest magnitude, the loss
    with its aux term and the aux term within rtol 1e-5, the chosen experts
    (top 2, in order) identical, the smallest top-1/top-2 and top-2/top-3
    probability gaps printed; three wrong variants on the card (gates not
    renormalised, a capacity counted without k, no aux term) must each
    fall outside; (b) the runner on ``configs/train-lm-moe.yml``
    (``config/TransformerLM-moe.yml`` at expert-parallel degree 1: 8
    experts on the card, d 1024, depth 16 (4 in the whole script's run, 16
    with ``--moe``), every 2nd block MoE, bf16, batch 64 as 8 micro-batches
    of 8, block remat, fused tails) for a warm-up and 3 timed steps and one
    validation of 2 batches; exact launch counts a step (at 16 blocks:
    K1a/K1b 8, K2a/K2c 8 x 32, K3/K4 8 x 16, the 8 dense blocks only) and a
    validation batch; step ms, tokens/s, peak
    memory, MFU on the executed products (dispatch and combine included)
    and on the active parameters; (c) with ``--profile``, one step's device
    time by class: expert ``bmm``s, dispatch and combine ``bmm``s, routing
    (one-hot, cumsum, scatter, top-k, softmax), the flash kernels, the head.

26. sequence parallelism at ``config/TransformerLM-sp.yml``'s shapes (B 2,
    S 32768, 8 heads of 64, a ring of 4): (a) ``flash_attention_lse`` on
    the ring's block, [2, 8192, 8, 64] bf16 in, f32 dots, f32 o, causal and
    not, with a seeded cotangent on lse: one K2a forward and one K2d + K2e
    backward through autograd, equal to its kernels' f32 outputs bit for
    bit, those within the f32 flash limits of the twin; the backward without
    the lse cotangent and the bf16 kernels' arithmetic must fall outside;
    each launch timed beside its 3xTF32 bound, the twin and SDPA's f32
    (efficient) forward and backward, with the ``out_f32`` upcasts' cost;
    (b) ring attention over S = 32768 as 4 virtual ranks of 8192 in one
    process (``parallel.sequence.loopback``), causal, forward and backward,
    held against the whole sequence's bf16 ``flash_attention`` (o, dq, dk,
    dv), launches exactly 4 causal + 6 full forwards (K2a) and 10 backward
    pairs (K2d, K2e); (c) Ulysses likewise, 4 bf16 flash calls over [2,
    32768, 2, 64] (K2b, K2f, K2g); each part's wall time beside the whole
    sequence's, with the card's name and power limit.  NCCL refuses two
    ranks on one card, so the multi-rank SP step itself runs only on gloo
    ranks on the CPU (``tests/test_torch_sp_step.py``).

27. Megatron tensor parallelism and expert parallelism at degree 4, as 4
    gloo ranks, each a process of its own on the one card (NCCL refuses two
    ranks on one device): (a) f32, TF32 off, full width (d 1024, 16 heads,
    vocab 32768), depth 2, batch 2 x 256, seeded full weights with random
    biases: dense at T = 4 and MoE at EP = 4 (8 experts, 2 a rank) each take
    2 SGD steps, held against the one-rank step on the card: the losses
    within rtol 1e-6, every gathered gradient within 1e-5 and every
    gathered parameter within 1e-6 of its largest magnitude (the limits of
    ``tests/test_torch_tensor_parallel.py``), which a row-parallel bias
    added on every rank and a *reduce* with an all-reducing backward must
    fail; each rank's launches exact.  (b) bf16: the runner on
    ``configs/train-lm-tp.yml`` and ``configs/train-lm-moe-ep.yml``
    (``tensor_parallelism: 4`` kept, batch 64 as 8 micro-batches, block
    remat; at 2 blocks and 1 + 1 steps in the whole script's run, which 16
    blocks' ~11 min through gloo would carry past its limit, at 16 and 1 +
    3 steps with ``--tp``) and one validation batch through ``Runner(num_nodes=4,
    rank=r, device="cuda", dist_backend="gloo")``: each rank's launches
    exact a step and in the validation, with their shapes (K1a/K1b
    [16384, 32768], the flash pair at [8, 2048, 4, 64], K3 [16384, 1024]
    after the reduce, K4 on the fc1 slice [16384, 1024]); step ms, tokens/s,
    each process's peak memory and the share of the step the gloo
    exchanges take, beside the card's name and power limit.  These cross
    the host through gloo: they describe no NCCL run and no multi-card
    speed.
28. ZeRO-1/2/3 over the data group, as 4 gloo processes on the card: (a)
    f32, TF32 off, full width, depth 2, a rank's batch 2 x 256, seeded full
    weights with random biases (the expert banks' too): ZeRO-1, ZeRO-2 (2
    micro-batches) and ZeRO-3
    at data 4 x model 1, and ZeRO-3 at data 2 x model 2 with the MoE block,
    2 SGD-momentum steps each, held against the one-rank step on the card
    over the whole batch within phase 27's limits (each rank's momentum
    slice against its elements of the one-rank momentum within the
    gradients' limit); each rank keeping its local gradient slice, stale
    shards after the update and slices taken one rank over must fail; each
    rank's launches exact and its state bytes the rule's.  (b) bf16: the
    runner on ``configs/train-lm-fsdp.yml`` (ZeRO-3 over 4 data ranks, batch
    64 as 8 micro-batches, block remat; 2 blocks in the whole script's run,
    16 with ``--zero``), 1 + 3 steps and one validation batch: launches
    exact a step and in the validation, losses equal on the ranks; step ms,
    global tokens/s, the exchanges' calls, bytes and share of the step,
    each process's peak memory; then one step each of the runner's steps
    at stages 0, 1 and 2 on the config's model: each rank's bytes of
    parameters, gradients and AdamW moments at stages 0-3 equal to the
    rule's.  (a) and (b) run in one spawn of four processes.  Gloo through
    the host on one card, as in 27.
29. pipeline parallelism over the stage group, as 4 gloo processes on the
    card: (a) f32, TF32 off, full width, 4 blocks (unfused tails, as JAX's
    stage blocks), a batch of 8 x 256, seeded full weights with random
    biases: GPipe over 4 microbatches and 1F1B over 8 at (data 1, stage 4),
    1F1B over 4 at (data 2, stage 2), 2 SGD-momentum steps each, held
    against the one-rank step on the card over the whole batch within phase
    27's limits (gradients and parameters gathered over the stages), which
    the received cotangent dropped, the shared leaves not summed over the
    stages, microbatch m - 1's activation fed for m and the loss normalised
    a microbatch must fail; each rank's launches exact.  (b) bf16: the
    runner on ``config/TransformerLM-pp.yml`` as it is (4 stages, 1F1B over
    8 microbatches of 8 x 2048, block remat, 16 blocks, 1 + 3 steps; with
    ``--pp`` only: the whole script runs (a) alone) and one validation
    batch: each rank's launches exact a step and in the validation (K2a
    three times a block a microbatch, the K2c pair once, K1a twice and K1b
    once a microbatch on the last stage), losses and validation equal on
    the ranks; step ms, global tokens/s, the hops' and all-reduces' calls,
    bytes, synced ms and share of the step, each process's peak memory.  (a)
    and (b) run in one spawn.  Gloo through the host on one card: no NCCL,
    no bubble of separate cards.

The line before the last lists every TPU kernel (K1a ... K4) with the CUDA
kernel that stands for it, its launches on the path that runs it (and on
every path, ``launches_by_path``), its error
against the plain twin, and its times.  The last line is ``{"ok": true,
"device": {...}}``.  With no card the script prints no result and exits 1.
It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (FFMA)
TF32_FLOPS = 494.7e12  # H100 SXM TF32 tensor cores, dense
# H100 SXM f32-accurate products on the tensor cores: 3 TF32 products each,
# the f32 flash kernels' bound
TF32X3_FLOPS = TF32_FLOPS / 3
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's 1.98 GHz: covers any host enqueue
_HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(_HERE, "pytorch_distributed_training_tpu_torch", "configs",
                      "serve-lm-1024.yml")
SCHED_CONFIG = os.path.join(_HERE, "pytorch_distributed_training_tpu_torch", "configs",
                            "serve-lm-1024-sched.yml")
# phase 20 (e): the port training checkpoint that serving restores
SERVE_CKPT_DIR = os.path.join(_HERE, "run", "chip_smoke", "serve_ckpt")
TRAIN_CONFIG = os.path.join(_HERE, "pytorch_distributed_training_tpu_torch", "configs",
                            "train-lm-1024.yml")
LONGCTX_CONFIG = os.path.join(_HERE, "pytorch_distributed_training_tpu_torch", "configs",
                              "train-lm-longctx.yml")
RESNET_CONFIG = os.path.join(_HERE, "config", "test-sync.yml")
# phases 22 and 23: the ViT-B16 recipe and the classification serving config
VIT_CONFIG = os.path.join(_HERE, "config", "ViT-B16.yml")
SERVE_RESNET_CONFIG = os.path.join(_HERE, "config", "serve-resnet50.yml")
VIT_DIR = os.path.join(_HERE, "run", "chip_smoke", "vit")
LARS_CONFIG = os.path.join(_HERE, "config", "ResNet50-lars8k.yml")
# phase 16's cuts of the LARS recipe: the per-card share of batch 8192 at 32
# cards; 8 steps with a 3-step warmup, so warmup, hand-over and decay all run
LARS_BATCH, LARS_STEPS, LARS_WARMUP = 256, 8, 3
# phase 17: checkpoints of config/test-sync.yml, each run in its own directory
CKPT_DIR = os.path.join(_HERE, "run", "chip_smoke", "ckpt")
# phase 18: the fsdp config's batch of 64 as 8 micro-batches, over a token
# corpus written here from a seed (4 train batches, 2 validation batches)
ACCUM_CONFIG = os.path.join(_HERE, "pytorch_distributed_training_tpu_torch", "configs",
                            "train-lm-1024-accum.yml")
TOKENS_DIR = os.path.join(_HERE, "run", "chip_smoke", "tokens")
# phase 19: the fault scenarios' checkpoints, each run in its own directory
FAULTS_DIR = os.path.join(_HERE, "run", "chip_smoke", "faults")
# phase 18's f32 checks: an accumulated step against a plain one, each
# gradient within this share of its largest magnitude (f32 sums taken in
# another order; phase 7's limit for card against CPU)
ACCUM_GRAD_LIMIT = 1e-4
_CSRC = "pytorch_distributed_training_tpu_torch/csrc/"
_TPU = "pytorch_distributed_training_tpu/ops/"
_FA = _TPU + "flash_attention.py:"
# TPU kernel -> (file:line of it, source of the port's kernel, the CUDA
# kernel that stands for it, the phase-6/9 case whose times the kernels
# line reports, the path whose launch counts it reports)
TPU_KERNELS = {
    "K1a": (_TPU + "fused_ce.py:56", "fused_ce.cu", "ce_fwd_kernel", ("ce_fwd", 1), "longctx"),
    "K1b": (_TPU + "fused_ce.py:70", "fused_ce.cu", "ce_bwd_kernel", ("ce_bwd", 1), "longctx"),
    "K2a": (_FA + "178", "flash_attention.cu",
            "flash_fwd_bf16_kernel (bf16) / flash_fwd_3xtf32_kernel (f32)", ("flash_fwd", 0),
            "training"),
    "K2b": (_FA + "407", "flash_attention.cu",
            "flash_fwd_bf16_kernel (bf16) / flash_fwd_3xtf32_kernel (f32)",
            ("long_fwd", 0), "longctx"),
    "K2c": (_FA + "278", "flash_attention.cu",
            "flash_bwd_dkv_bf16_kernel + flash_bwd_dq_bf16_kernel", ("flash_bwd", 0),
            "training"),
    "K2d": (_FA + "233", "flash_attention.cu", "flash_bwd_dq_3xtf32_kernel", ("long_dq", 2),
            "f32_runner"),
    "K2e": (_FA + "348", "flash_attention.cu", "flash_bwd_dkv_3xtf32_kernel", ("long_dkv", 2),
            "f32_runner"),
    "K2f": (_FA + "460", "flash_attention.cu",
            "flash_bwd_dq_bf16_kernel (bf16) / flash_bwd_dq_3xtf32_kernel (f32)", ("long_dq", 0),
            "longctx"),
    "K2g": (_FA + "506", "flash_attention.cu",
            "flash_bwd_dkv_bf16_kernel (bf16) / flash_bwd_dkv_3xtf32_kernel (f32)",
            ("long_dkv", 0), "longctx"),
    "K3": (_TPU + "fused_elementwise.py:88", "fused_elementwise.cu", "add_layernorm_kernel",
           ("add_layernorm", 0), "training"),
    "K4": (_TPU + "fused_elementwise.py:203", "fused_elementwise.cu", "bias_gelu_kernel",
           ("bias_gelu", 0), "training"),
}
# other cases reported beside a row's own: the other main paths' CE shapes,
# flash at D = 128 and the f32 flash kernels, K2c's two launches apart, and
# K3/K4 at serving's prefill and decode shapes
ALSO = {"K1a": [("ce_fwd", 0), ("ce_fwd", 4), ("ce_fwd", 5), ("ce_fwd", 6)],
        "K1b": [("ce_bwd", 0), ("ce_bwd", 4), ("ce_bwd", 5), ("ce_bwd", 6)],
        "K2a": [("flash_fwd", 1), ("long_fwd", 2), ("flash_fwd", 3), ("lse_fwd", 0),
                ("lse_fwd", 1)],
        "K2c": [("flash_dkv", 0), ("flash_dq", 0), ("flash_bwd", 1)],
        "K2b": [("long_fwd", 1)], "K2f": [("long_dq", 1)], "K2g": [("long_dkv", 1)],
        # phase 26 (a): flash_attention_lse's f32 dots on bf16 input, causal and not
        "K2d": [("lse_dq", 0), ("lse_dq", 1)], "K2e": [("lse_dkv", 0), ("lse_dkv", 1)],
        "K3": [("add_layernorm", 1), ("add_layernorm", 2)],
        "K4": [("bias_gelu", 1), ("bias_gelu", 2)]}
# the port's wrappers whose launches stand for K1a/K1b/K3/K4 (flash is
# counted by TPU kernel in ops/flash_attention.py itself)
WRAPPER_OF = {"K1a": "ce_fwd", "K1b": "ce_bwd", "K3": "add_layernorm", "K4": "bias_gelu"}
# arithmetic per logit for the CE operations bound: max compare, subtract,
# exp, add (forward); subtract, exp, subtract the one-hot, scale (backward)
CE_FLOPS_PER_ELEMENT = 4
# card vs twin limits.  Elementwise: |kernel - twin| <= atol + rtol |twin|;
# for flash also ||kernel - twin|| / ||twin|| per tensor.  K1b's dlogits
# are (p - onehot) * scale, |p| <= 1: atol is tied to the scale, so every
# entry is held to its own size, not only the label column and the largest
# probabilities.  f32: summation order only; bf16: one ulp is 2^-8 (3.9e-3)
# relative, so rtol 1e-2 allows an f32 sum taken in another order to round
# to the neighbouring bf16 value.
CE_BWD_ATOL_PER_SCALE = 1e-7
CE_BWD_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
# flash bf16: at the LM's shape a typical |o|, |dq|, |dk| is 0.04-0.05;
# atol 5e-3 is a tenth of that, and the norm limits below hold each tensor
# as a whole (the kernel rounds p in the forward against a running max, the
# twin against the row's final max: o differs by more than the gradients,
# whose p and ds both sides compute from the same lse)
FLASH_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=5e-3, rtol=1e-2)}
# f32 at S = 32768: a dK/dV (or dQ) row sums up to 32768 terms, in 64-row
# tiles on the card and 128-row GEMM chunks in the twin; f32 rounding in a
# sum of n terms grows like eps sqrt(n) (~1e-5 relative at n = 32768), so
# the elementwise rtol is 1e-4 there; the norm limits stay as they are
FLASH_TOL_LONG = {"float32": dict(atol=1e-5, rtol=1e-4),
                  "bfloat16": FLASH_TOL["bfloat16"]}
FLASH_NORM_LIMIT = {"float32": {"o": 1e-5, "dq": 1e-5, "dk": 1e-5, "dv": 1e-5},
                    "bfloat16": {"o": 3e-3, "dq": 1e-3, "dk": 1e-3, "dv": 1e-3}}
# row granularity of the flash wrong variants: each leaves out blocks of 64
# query or key rows.  The bf16 kernels' tiles are 128 rows (64-row Q tiles in
# dK/dV), so a variant that drops 64 rows is stricter than one that drops a
# whole kernel tile
VARIANT_ROWS = 64
LONG_REPS = 5  # timed launches at S = 32768 (a bf16 backward is ~70 ms)
# arithmetic per element, for the operations bound: add, two reductions
# (sum, sum of squares), centre, scale by rstd, affine / add, scale,
# erf, add, two products
FLOPS_PER_ELEMENT = {"add_layernorm": 8, "bias_gelu": 6}


def say(*parts) -> None:
    print(*parts, flush=True)


_PHASE_CLOCK = []  # (name, start) of the phase in progress


def phase(title) -> None:
    """Close the phase in progress with its wall time, and open ``title``
    (``None``: open none)."""
    now = time.perf_counter()
    if _PHASE_CLOCK:
        name, t0 = _PHASE_CLOCK.pop()
        say(f"  ({name} took {now - t0:.1f} s)")
    if title is not None:
        _PHASE_CLOCK.append((title.split(":")[0], now))
        say(f"== {title}")


def bound_of(nbytes: float, flops: float, flops_per_s: float):
    """The least time (ms) for ``nbytes`` of traffic and ``flops`` of
    arithmetic, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound(fa, bh: int, s_len: int, d: int, dtype, causal: bool, backward: bool = False,
                part=None) -> dict:
    """A flash launch's bound: bf16 at the bf16 tensor-core rate, f32 at the
    3xTF32 one, and for f32 also the bound of the same work as FFMA on the
    CUDA cores (``ffma_bound_ms``)."""
    import torch

    flops = fa.flash_flops(bh, s_len, d, causal, backward, part)
    nbytes = fa.flash_bytes(bh, s_len, d, dtype, backward, part)
    f32 = dtype == torch.float32
    b_ms, b_by = bound_of(nbytes, flops, TF32X3_FLOPS if f32 else BF16_FLOPS)
    return dict(bound_ms=b_ms, bound_by=b_by,
                ffma_bound_ms=bound_of(nbytes, flops, F32_FLOPS)[0] if f32 else None)


def shares(row: dict) -> str:
    """The share of the bound a timed row reached, and of the FFMA bound for
    an f32 flash row."""
    text = f"share_of_bound={row['bound_ms'] / row['ms']:.4f}"
    if row.get("ffma_bound_ms"):
        text += f" ffma_share={row['ffma_bound_ms'] / row['ms']:.4f}"
    return text


def tf32_checks(fc, q, k, v, causal: bool, scale: float, o_want, tol: dict, limit: float,
                label: str) -> list:
    """Checks of the f32 forward with each product in 3 TF32 products (the
    kernel's arithmetic: read only) and in 1 (a kernel that ran plain TF32:
    a wrong variant the limits must reject)."""
    return [(f"flash o {label}, {terms}xTF32 emulated",
             readings(fc.flash_fwd_emulated(q, k, v, causal, scale, terms)[0], o_want, **tol),
             limit, sound)
            for terms, sound in ((3, None), (1, False))]


def dkv_tf32_checks(fc, q, k, v, do, lse, delta, causal: bool, scale: float, want, tol: dict,
                    limit: dict, label: str) -> list:
    """The same for the f32 dK/dV: dk and dv of ``tools/flash_checks.py``'s
    emulation with each of the four products in 3 TF32 products (read only)
    and in 1 (a wrong variant), against ``want = (dk, dv)`` of the twin."""
    checks = []
    for terms, sound in ((3, None), (1, False)):
        got = fc.flash_bwd_emulated(q, k, v, do, lse, delta, causal, scale, terms)
        for what, a, c in zip(("dk", "dv"), got, want):
            checks.append((f"flash {what} {label}, {terms}xTF32 emulated",
                           readings(a, c, **tol), limit[what], sound))
    return checks


def dq_tf32_checks(fc, q, k, v, do, lse, delta, causal: bool, scale: float, want, tol: dict,
                   limit: float, label: str) -> list:
    """The same for the f32 dQ: dq of ``tools/flash_checks.py``'s emulation
    with each of its three products in 3 TF32 products (read only) and in 1
    (a wrong variant), against ``want``, the twin's dq."""
    return [(f"flash dq {label}, {terms}xTF32 emulated",
             readings(fc.flash_dq_emulated(q, k, v, do, lse, delta, causal, scale, terms), want,
                      **tol), limit, sound)
            for terms, sound in ((3, None), (1, False))]


def all_counts(modules) -> dict:
    """Launch counts by wrapper, and flash's by TPU kernel (K2a ... K2g)."""
    counts = {}
    for m in modules:
        counts.update(m.launch_counts())
        if hasattr(m, "tpu_launch_counts"):
            counts.update(m.tpu_launch_counts())
    return counts


def ptxas_report(log: str) -> list:
    """One line per kernel of nvcc's ``-Xptxas -v`` output: the kernel (its
    name and template argument, read from the length-prefixed parts of the
    mangled name), its registers, its spills and ptxas's performance
    notes on it."""
    import re

    def kernel(mangled: str) -> str:
        for m in re.finditer(r"\d+", mangled):
            name = mangled[m.end():m.end() + int(m.group())]
            if name.endswith("_kernel"):
                arg = re.match(r"ILi(\d+)E", mangled[m.end() + len(name):])
                return name + (f"<{arg.group(1)}>" if arg else "")
        return mangled

    # ptxas's performance notes (e.g. C7512, wgmma serialised) by kernel
    notes = {}
    for m in re.finditer(r"\((C\d+)\) Potential Performance Loss: (.*?) (?:for|in) the "
                         r"function '(\w+)'", log):
        notes.setdefault(kernel(m.group(3)), []).append(f"{m.group(1)} {m.group(2)}")
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel(entry.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            note = "".join(f"; {n}" for n in notes.get(name, ()))
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}{note}")
            name, spill = None, ""
    return lines


def by_tpu_kernel(counts: dict) -> dict:
    return {k: counts[WRAPPER_OF.get(k, k)] for k in TPU_KERNELS}


def check_launches(what: str, got: dict, want: dict) -> None:
    """``got`` must equal ``want`` on every key, a key missing from
    ``want`` counting 0."""
    want = {k: want.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def time_ms(torch, fn, flush, reps: int = 20, warm: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches after ``warm``
    untimed ones, each after the L2 cache was flushed by writing a buffer
    larger than it.  A spin kernel queued ahead of the start event keeps the
    device busy while the host enqueues ``fn``, so the events bracket device
    work only, not the wrapper's Python."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def call_ms(torch, fn, calls: int = 50) -> float:
    """Host wall time per call of ``fn``, back to back, synchronised once at
    the end: what a caller's thread spends per call when the device keeps
    up (the decode loop's regime)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def readings(got, want, atol: float, rtol: float) -> dict:
    """How far ``got`` lies from ``want``: the largest |got - want|, the
    largest |got - want| / (atol + rtol |want|) (``worst``: at most 1
    passes), and ||got - want|| / ||want|| (``norm_rel``)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return dict(max_abs_err=diff.max().item(),
                worst=(diff / (atol + rtol * w.abs())).max().item(),
                norm_rel=(diff.norm() / w.norm()).item())


def within(r: dict, norm_limit=None) -> bool:
    return r["worst"] <= 1.0 and (norm_limit is None or r["norm_rel"] <= norm_limit)


def judge(checks) -> None:
    """Print every (what, readings, norm limit, sound) first, then fail on
    the first kernel output (sound True) outside its limits or the first
    wrong variant (sound False) inside them: a check that a wrong kernel
    would pass.  Sound None is a variant that is only read."""
    kinds = {True: "card vs twin", False: "wrong variant", None: "variant, read only"}
    for what, r, limit, sound in checks:
        say(f"  {kinds[sound]} {what}: "
            f"max_abs_err={r['max_abs_err']} worst={r['worst']} norm_rel={r['norm_rel']} "
            f"(norm limit {limit}) -> {'within' if within(r, limit) else 'outside'}")
    for what, r, limit, sound in checks:
        if sound is not None and within(r, limit) != sound:
            raise AssertionError(f"{what}: {'outside' if sound else 'within'} its limits: {r}")


def attention_dropping(torch, q, k, v, scale: float, drop, do=None, lse=None, delta=None,
                       causal: bool = True):
    """Attention of ``[BH, S, D]`` in f32 (causal unless said otherwise)
    with the (query, key) pairs where ``drop(rows, cols)`` is True left
    out: without ``do``, the ``o`` a forward kernel that skipped those
    pairs would return; with
    ``do``, ``lse`` and ``delta``, the ``(dq, dk, dv)`` of a backward kernel
    that skipped them (p from the given lse).  Chunked over heads and query
    rows, as the plain twins are, so that S = 32768 fits."""
    bh, s_len, _ = q.shape
    rows = max(1, min(s_len, (1 << 26) // (16 * s_len)))
    cols = torch.arange(s_len, device=q.device)
    out = [torch.empty_like(q)] if do is None else [torch.empty_like(x) for x in (q, k, v)]
    for h in range(0, bh, 16):
        hs = slice(h, h + 16)
        kc, vc = k[hs].float(), v[hs].float()
        dk32, dv32 = torch.zeros_like(kc), torch.zeros_like(vc)
        for r in range(0, s_len, rows):
            rs = slice(r, r + rows)
            ridx = torch.arange(r, min(r + rows, s_len), device=q.device)[:, None]
            keep = ~drop(ridx, cols[None, :])
            if causal:
                keep &= cols[None, :] <= ridx
            qc = q[hs, rs].float()
            sc = torch.matmul(qc, kc.transpose(-1, -2)) * scale
            if do is None:
                p = torch.softmax(sc.masked_fill(~keep, -1e30), dim=-1)
                out[0][hs, rs] = torch.matmul(p, vc).to(q.dtype)
                continue
            p = torch.exp(sc - lse[hs, rs][..., None]) * keep
            dc = do[hs, rs].float()
            dv32 += torch.matmul(p.transpose(-1, -2), dc)
            ds = p * (torch.matmul(dc, vc.transpose(-1, -2)) - delta[hs, rs][..., None]) * scale
            dk32 += torch.matmul(ds.transpose(-1, -2), qc)
            out[0][hs, rs] = torch.matmul(ds, kc).to(q.dtype)
        if do is not None:
            out[1][hs], out[2][hs] = dk32.to(k.dtype), dv32.to(v.dtype)
    return out[0] if do is None else tuple(out)


def tile_of(idx):
    return idx // VARIANT_ROWS


def dq_variants(torch, q, k, v, do, lse, delta, scale, causal: bool = True) -> list:
    """``(what, dq)`` of three wrong dQ kernels the limits must reject: one
    whose K loop leaves out a middle block of 64 keys, one that leaves out
    the diagonal 64-key block of the odd 64-row blocks only (the diagonal
    tile of the bf16 kernel's second consumer warpgroup), and one whose mask
    is off by one: each query's own key left out."""
    mid = q.shape[1] // VARIANT_ROWS // 2
    return [(what, attention_dropping(torch, q, k, v, scale, drop, do, lse, delta, causal)[0])
            for what, drop in (
                (f"K tile {mid} skipped", lambda r, c: (tile_of(c) == mid) & (tile_of(r) > mid)),
                ("second diagonal block skipped",
                 lambda r, c: (tile_of(c) == tile_of(r)) & (tile_of(r) % 2 == 1)),
                ("own key dropped", lambda r, c: r == c))]


def dq_repeats(torch, fa, got, args, label: str) -> None:
    """A second dQ launch on ``args`` must give ``got`` bit for bit: one
    block owns each query row, no atomics."""
    if not torch.equal(fa.flash_backward_dq(*args), got):
        raise AssertionError(f"flash dq {label}: two launches differ")
    say(f"  flash dq {label}: two launches bitwise equal")


def dkv_repeats(torch, fa, got, args, label: str) -> None:
    """A second dK/dV launch on ``args`` must give ``got = (dk, dv)`` bit
    for bit: one block owns each key row, no atomics."""
    again = fa.flash_backward_dkv(*args)
    if not all(torch.equal(a, b) for a, b in zip(again, got)):
        raise AssertionError(f"flash dk/dv {label}: two launches differ")
    say(f"  flash dk/dv {label}: two launches bitwise equal")


def expect_raise(exc, fn, what: str) -> None:
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"{what}: expected {exc.__name__}")


def phase_kernels(torch, fe):
    """Phase 3: each kernel against its plain twin; returns per-kernel rows.

    The rows of each kernel start with bf16 at the LM-1024 step's shape, the
    prefill shape and the decode shape (the kernels line reports the first
    and keeps the other two in ``also``).  Each kernel's ``s`` must equal the
    twin's bitwise and its ``y`` lie within ``elementwise_checks.TOL`` and
    ``NORM_LIMIT``; the wrong kernels of ``elementwise_checks`` must lie
    outside them in the dtypes that module names (read only in the others).
    [37, 1001] is ragged and [37, 1024] a view one element into a flat
    buffer: both take the kernels' scalar accesses."""
    from pytorch_distributed_training_tpu_torch.tools import elementwise_checks as ec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = {"add_layernorm": [], "bias_gelu": []}
    checks = []

    def randn(shape, dtype, scale=1.0, shift=0.0, misaligned=False):
        if not misaligned:
            return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)
        flat = randn(shape[0] * shape[1] + 1, dtype, scale, shift)
        return flat[1:].view(shape)  # contiguous, E % 8 == 0, 2 or 4 bytes off 16

    def record(name, shape, dtype, layout, kernel, plain, nbytes, got, want):
        dt = str(dtype).replace("torch.", "")
        what = f"{name} {list(shape)} {dt}{' ' + layout if layout else ''}"
        r = readings(got, want, **ec.TOL[dt])
        checks.append((what, r, ec.NORM_LIMIT[dt], True))
        k_ms, c_ms = time_ms(torch, kernel, flush), call_ms(torch, kernel)
        p_ms = time_ms(torch, plain, flush)
        b_ms, b_by = bound_of(nbytes, FLOPS_PER_ELEMENT[name] * shape[0] * shape[1], F32_FLOPS)
        rows[name].append(dict(
            shape=list(shape), dtype=dt, layout=layout or "aligned", max_abs_err=r["max_abs_err"],
            norm_rel=r["norm_rel"], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            share_of_bound=b_ms / k_ms, call_ms=c_ms))

    def variants(dt, shape, built, want):
        for what, wrong in built:
            sound = False if dt in ec.REJECT_IN[what] else None
            checks.append((f"{what} {list(shape)} {dt}", readings(wrong, want, **ec.TOL[dt]),
                           ec.NORM_LIMIT[dt], sound))

    # rows at the main paths' widths: the LM-1024 step (bf16 only), prefill
    # and decode; then (rows, E, layout) at the edges.  4133 rows: K3's last
    # block of 8 warps holds 5 rows, K4's vectors walk 4 rows a thread, the
    # last group 1 row, in a column block of 125 vectors.  E > 1024: K3's
    # block-a-row kernel, with vectors (4096) and scalars (4095)
    main_rows = {torch.bfloat16: (16384, 4096, 8), torch.float32: (4096, 8)}
    edge = [(37, 1000, None), (37, 1001, "ragged"), (37, 1024, "misaligned"), (4133, 1000, None)]
    wide = {"add_layernorm": [(37, 4096, None), (37, 4095, "ragged")], "bias_gelu": []}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for width, name in ((1024, "add_layernorm"), (4096, "bias_gelu")):
            cases = [(r, width, None) for r in main_rows[dtype]] + edge + wide[name]
            for r, e, layout in cases:
                lay = layout == "misaligned"
                # the wrong kernels are read at the largest shape and at 37 rows
                probe = (r, e) in ((37, 1000), (main_rows[dtype][0], width))
                if name == "add_layernorm":
                    x, d = randn((r, e), dtype, 2.0, misaligned=lay), randn((r, e), dtype, misaligned=lay)
                    scale, bias = randn(e, torch.float32, 0.3, 1.0), randn(e, torch.float32, 0.1)
                    s_k, y_k = fe.fused_add_layernorm(x, d, scale, bias, out_dtype=dtype)
                    s_p, y_p = fe.add_layernorm_plain(x, d, scale, bias, out_dtype=dtype)
                    torch.cuda.synchronize()
                    if not torch.equal(s_k, s_p):
                        raise AssertionError(f"add_layernorm {r}x{e} {dt} {layout}: s not bitwise equal")
                    record(name, (r, e), dtype, layout,
                           lambda: fe.fused_add_layernorm(x, d, scale, bias, out_dtype=dtype),  # noqa: B023
                           lambda: fe.add_layernorm_plain(x, d, scale, bias, out_dtype=dtype),  # noqa: B023
                           fe.add_layernorm_bytes(r, e, dtype, dtype), y_k, y_p)
                    if probe:
                        variants(dt, (r, e), ec.add_layernorm_variants(
                            x, d, scale, bias, out_dtype=dtype), y_p)
                else:
                    u, b = randn((r, e), dtype, 2.0, misaligned=lay), randn(e, dtype, 0.5)
                    y_k, y_p = fe.fused_bias_gelu(u, b), fe.bias_gelu_plain(u, b)
                    torch.cuda.synchronize()
                    record(name, (r, e), dtype, layout,
                           lambda: fe.fused_bias_gelu(u, b),  # noqa: B023
                           lambda: fe.bias_gelu_plain(u, b),  # noqa: B023
                           fe.bias_gelu_bytes(r, e, dtype), y_k, y_p)
                    if probe:
                        variants(dt, (r, e), ec.bias_gelu_variants(u, b), y_p)
    for name, cases in rows.items():
        for c in cases:
            say(f"  {name} {c['shape']} {c['dtype']} {c['layout']}: kernel_ms={c['ms']} "
                f"plain_ms={c['plain_ms']} bound_ms={c['bound_ms']} ({c['bound_by']}) "
                f"share_of_bound={c['share_of_bound']:.3f} call_ms={c['call_ms']} "
                f"max_abs_err={c['max_abs_err']} norm_rel={c['norm_rel']}")
    judge(checks)
    # what the kernels do not take raises; nothing falls back to the plain twin
    x = torch.zeros(4, 64, device=dev, dtype=torch.float64)
    p32 = torch.ones(64, device=dev)
    expect_raise(TypeError, lambda: fe.fused_add_layernorm(x, x, p32, p32), "add_layernorm f64")
    xb = torch.zeros(4, 64, device=dev, dtype=torch.bfloat16)
    expect_raise(ValueError, lambda: fe.fused_add_layernorm(xb, xb, p32.cpu(), p32.cpu()),
                 "add_layernorm params on the CPU")
    expect_raise(TypeError, lambda: fe.fused_bias_gelu(x, x[0]), "bias_gelu f64")
    expect_raise(ValueError, lambda: fe.fused_bias_gelu(xb, xb[0].cpu()), "bias_gelu bias on the CPU")
    say("  wrong dtype / wrong device raise: ok")
    del flush
    return rows


def phase_model_vs_cpu(torch, fe):
    """Phase 4: full width, depth 2, f32: card (kernels) vs CPU (plain)."""
    from pytorch_distributed_training_tpu_torch.models import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"  allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    cpu = TransformerLM(32768, max_len=2048, embed_dim=1024, depth=2, num_heads=16,
                        fused_tails=True).eval()
    cpu.reset_parameters(torch.Generator().manual_seed(1))
    gpu = TransformerLM(32768, max_len=2048, embed_dim=1024, depth=2, num_heads=16,
                        fused_tails=True).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.cuda()
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, 32768, (2, 64), generator=gen)
    nxt = torch.randint(0, 32768, (2, 1), generator=gen)
    pos = torch.tensor([64, 64])
    before = fe.launch_counts()
    worst = 0.0
    with torch.inference_mode():
        c_cache, g_cache = cpu.new_cache(2), gpu.new_cache(2)
        c_pre, c_cache = cpu(tokens, c_cache)
        g_pre, g_cache = gpu(tokens.cuda(), g_cache)
        c_cache.live_len = g_cache.live_len = 65
        c_step, _ = cpu(nxt, c_cache, pos)
        g_step, _ = gpu(nxt.cuda(), g_cache, pos.cuda())
        for what, c, g in (("prefill", c_pre, g_pre), ("decode step", c_step, g_step)):
            g = g.cpu()
            if not torch.isfinite(g).all():
                raise AssertionError(f"{what}: non-finite logits on the card")
            err = (g - c).abs().max().item()
            say(f"  {what} logits {tuple(g.shape)}: max |card - cpu| = {err:.3g}")
            torch.testing.assert_close(g, c, atol=2e-3, rtol=0.0)
            worst = max(worst, err)
    after = fe.launch_counts()
    if any(after[k] - before[k] != 4 for k in after):  # 2 blocks x (prefill + step)
        raise AssertionError(f"model on the card did not run the kernels: {before} -> {after}")
    del cpu, gpu, c_cache, g_cache
    torch.cuda.empty_cache()
    return worst


def phase_main_path(torch, fe, np, modules):
    """Phase 5: the serving batcher path at full width."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_serve_cfg
    from pytorch_distributed_training_tpu_torch.serving import InferenceEngine

    cfg = get_serve_cfg(CONFIG)
    vocab, max_new = cfg["dataset"]["n_classes"], cfg["serving"]["max_new_tokens"]
    depth = cfg["model"]["depth"]
    t0 = time.perf_counter()
    engine = InferenceEngine.from_config(cfg)
    say(f"  engine built in {time.perf_counter() - t0:.1f} s on {engine.device}; "
        f"{sum(p.numel() for p in engine.model.parameters()) / 1e6:.1f} M parameters")
    with engine:
        warm = engine.warmup()
        say(f"  warmup: {warm['warmup_ms']:.0f} ms over {warm['pairs']:.0f} bucket pairs")
        torch.cuda.reset_peak_memory_stats()
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, vocab, int(rng.integers(1, 513))).astype(np.int32)
                   for _ in range(16)]
        for m in modules:
            m.reset_launch_counts()
        futures = [engine.submit(p) for p in prompts]
        results = [f.result(timeout=600) for f in futures]
        counts = all_counts(modules)
        others = {k: v for k, v in counts.items() if k not in fe.KERNELS}
        launches = fe.launch_counts()
        snap = engine.snapshot()
    if any(others.values()):
        raise AssertionError(f"serving launched training kernels: {others}")
    for r in results:
        if r["gen_len"] != max_new:
            raise AssertionError(f"gen_len {r['gen_len']} != {max_new}")
        toks = r["tokens"]
        if toks.shape != (max_new,) or toks.min() < 0 or toks.max() >= vocab:
            raise AssertionError(f"tokens out of range or shape: {toks}")
    per_batch = depth * (1 + (max_new - 1))
    want = per_batch * snap["batches"]
    for name, n in launches.items():
        if n != want:
            raise AssertionError(
                f"{name}: {n} launches, expected {per_batch} x {snap['batches']} batches"
            )
    say(f"  16 requests in {snap['batches']} batches; launches {launches} "
        f"= {per_batch} x {snap['batches']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say("serving: " + json.dumps(snap))
    return counts, engine


def profile_window(torch, label: str, fn, top: int) -> None:
    """Run ``fn`` once under ``torch.profiler``; print its wall time, the
    device kernel time and the device's busy share of that wall time, the
    kernel launches, and the ``top`` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    say(f"  profile {label}: wall {wall_ms} ms, device kernel time {busy_ms} ms, busy "
        f"share {busy_ms / wall_ms}, kernel launches {sum(e.count for e in events)}")
    for e in sorted(events, key=lambda e: -device_us(e))[:top]:
        say(f"    {device_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")


def phase_profile(torch, engine, np):
    """``--profile``: one batch's prefill and its decode loop at the larger
    seq bucket."""
    bb, sb = engine.batch_buckets[-1], engine.seq_buckets[-1]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, engine.vocab_size, (bb, sb)).astype(np.int32)
    plen = np.full((bb,), sb, np.int32)
    carry = []
    profile_window(torch, f"prefill [{bb}x{sb}]",
                   lambda: carry.append(engine._generate.prefill(tokens, plen)), 15)
    profile_window(torch, f"decode [{bb}x{sb}]",
                   lambda: engine._generate.decode(plen, carry[0]), 15)


def phase_train_kernels(torch, ce, fa):
    """Phase 6: K1a/K1b and the flash pair against their plain twins."""
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.tools import flash_checks as fc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = {"ce_fwd": [], "ce_bwd": [], "flash_fwd": [], "flash_bwd": [], "flash_dkv": [],
            "flash_dq": []}

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    checks = []
    # --- K1a / K1b: the main paths' [16384, 32768] (phase 8) and [65536,
    # 8192] (phase 11) f32, then ragged rows, then ResNet's [64, 1000] f32
    # (phase 14), the LARS recipe's [256, 1000] bf16 (phase 16) and ViT-B16's
    # [256, 1000] f32 (phase 22: its head is f32)
    for r, c, dtype in ((16384, 32768, torch.float32), (65536, 8192, torch.float32),
                        (37, 1000, torch.bfloat16), (37, 1000, torch.float32),
                        (64, 1000, torch.float32), (256, 1000, torch.bfloat16),
                        (256, 1000, torch.float32)):
        x = (torch.randn(r, c, generator=gen, device=dev) * 2.0).to(dtype)
        labels = torch.randint(0, c, (r,), generator=gen, device=dev)
        main = r != 37
        if not main:
            labels[5] = c + 7  # out of range: true logit 0, no raise
        scale = torch.full((1,), 1.0 / r, device=dev)
        nll_k, lse_k = ce.fused_ce_forward(x, labels)
        nll_p, lse_p = ce.ce_forward_plain(x, labels)
        d_k = ce.fused_ce_backward(x, labels, lse_p, scale)
        d_p = ce.ce_backward_plain(x, labels, lse_p, scale)
        torch.cuda.synchronize()
        # f32 statistics over a row: summation order only
        torch.testing.assert_close(nll_k, nll_p, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(lse_k, lse_p, atol=1e-4, rtol=1e-5)
        shape, dt = [r, c], str(dtype).replace("torch.", "")
        ce_tol = dict(atol=CE_BWD_ATOL_PER_SCALE / r, rtol=CE_BWD_RTOL[dt])
        checks.append((f"ce_bwd {shape} {dt}", readings(d_k, d_p, **ce_tol), None, True))
        if r == 16384:
            # wrong variants the limits must reject: dlogits through bf16
            # (p at 8 bits), and the last 16 bytes of every row unwritten
            checks.append(("ce_bwd through bf16", readings(
                d_p.to(torch.bfloat16), d_p, **ce_tol), None, False))
            tail = d_k.clone()
            tail[:, -4:] = 0
            checks.append(("ce_bwd last 4 columns unwritten",
                           readings(tail, d_p, **ce_tol), None, False))
            del tail
        fwd = lambda: ce.fused_ce_forward(x, labels)  # noqa: E731
        bwd = lambda: ce.fused_ce_backward(x, labels, lse_p, scale)  # noqa: E731
        n = r * c
        for name, kernel, plain, e, nbytes in (
            ("ce_fwd", fwd, lambda: ce.ce_forward_plain(x, labels),
             max(err(nll_k, nll_p), err(lse_k, lse_p)), ce.ce_forward_bytes(r, c, dtype)),
            ("ce_bwd", bwd, lambda: ce.ce_backward_plain(x, labels, lse_p, scale),
             err(d_k, d_p), ce.ce_backward_bytes(r, c, dtype)),
        ):
            b_ms, b_by = bound_of(nbytes, CE_FLOPS_PER_ELEMENT * n, F32_FLOPS)
            lib_ms = None
            if main:  # in-range labels only: F.cross_entropy asserts on the card
                if name == "ce_fwd":
                    lib = lambda: F.cross_entropy(x, labels, reduction="none")  # noqa: E731
                else:
                    xg = x.detach().requires_grad_(True)
                    lib_loss = F.cross_entropy(xg, labels)
                    lib = lambda: torch.autograd.grad(lib_loss, xg, retain_graph=True)  # noqa: E731
                lib_ms = time_ms(torch, lib, flush)
            rows[name].append(dict(
                shape=shape, dtype=dt, max_abs_err=e, ms=time_ms(torch, kernel, flush),
                call_ms=call_ms(torch, kernel), plain_ms=time_ms(torch, plain, flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        del x, d_k, d_p
    torch.cuda.empty_cache()

    # --- flash: the main path's B 8 H 16 S 2048 D 64 bf16 causal first, then
    # D = 128 causal over 32 tiles and non-causal, f32, two causal shapes
    # whose 128-row tile counts (3 and 5) are not powers of two, and f32 at
    # D = 128 non-causal
    for b, h, s_len, d, dtype, causal in ((8, 16, 2048, 64, torch.bfloat16, True),
                                          (1, 8, 4096, 128, torch.bfloat16, True),
                                          (2, 4, 512, 128, torch.bfloat16, False),
                                          (2, 4, 256, 64, torch.float32, True),
                                          (2, 4, 384, 128, torch.bfloat16, True),
                                          (2, 4, 640, 64, torch.bfloat16, True),
                                          (2, 4, 512, 128, torch.float32, False)):
        bh = b * h
        q, k, v, do = (torch.randn(bh, s_len, d, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        scale = 1.0 / d ** 0.5
        o_k, lse_k = fa.flash_forward(q, k, v, causal, scale)
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        delta = (do.float() * o_p.float()).sum(-1)
        g_k = fa.flash_backward(q, k, v, do, lse_p, delta, causal, scale)
        g_p = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, causal, scale)
        torch.cuda.synchronize()
        shape, dt = [b, h, s_len, d], str(dtype).replace("torch.", "")
        tol, limit = FLASH_TOL[dt], FLASH_NORM_LIMIT[dt]
        torch.testing.assert_close(lse_k, lse_p, atol=1e-4, rtol=1e-5)
        for what, a, c in zip(("o", "dq", "dk", "dv"), (o_k, *g_k), (o_p, *g_p)):
            checks.append((f"flash {what} {shape} {dt} causal={causal}",
                           readings(a, c, **tol), limit[what], True))
        if dtype == torch.float32:
            label = f"{shape} {dt} causal={causal}"
            checks += tf32_checks(fc, q, k, v, causal, scale, o_p, tol, limit["o"], label)
            checks += dkv_tf32_checks(fc, q, k, v, do, lse_p, delta, causal, scale, g_p[1:], tol,
                                      limit, label)
            checks += dq_tf32_checks(fc, q, k, v, do, lse_p, delta, causal, scale, g_p[0], tol,
                                     limit["dq"], label)
            for what, a in dq_variants(torch, q, k, v, do, lse_p, delta, scale, causal):
                checks.append((f"flash dq {label}, {what}", readings(a, g_p[0], **tol),
                               limit["dq"], False))
            # wrong variants: 64 query rows left out of dK/dV's Q loop, and
            # the diagonal 64-row blocks left out of both backward loops
            tile = s_len // VARIANT_ROWS // 2
            q_rows = slice(tile * VARIANT_ROWS, (tile + 1) * VARIANT_ROWS)
            do_cut, delta_cut = do.clone(), delta.clone()
            do_cut[:, q_rows], delta_cut[:, q_rows] = 0, 0
            cut = fa.flash_backward_dkv(q, k, v, do_cut, lse_p, delta_cut, causal, scale)
            for what, a, c in zip(("dk", "dv"), cut, g_p[1:]):
                checks.append((f"flash {what} {label}, one Q tile skipped",
                               readings(a, c, **tol), limit[what], False))
            wrong = attention_dropping(torch, q, k, v, scale, lambda r, c: tile_of(r) == tile_of(c),
                                       do, lse_p, delta, causal)
            for what, a, c in zip(("dq", "dk", "dv"), wrong, g_p):
                checks.append((f"flash {what} {label}, diagonal tile skipped",
                               readings(a, c, **tol), limit[what], False))
            dq_repeats(torch, fa, g_k[0], (q, k, v, do, lse_p, delta, causal, scale), label)
            dkv_repeats(torch, fa, g_k[1:], (q, k, v, do, lse_p, delta, causal, scale), label)
            del do_cut, delta_cut, cut, wrong
        if (b, h, s_len) == (8, 16, 2048):
            # wrong variants the limits must reject: 64 key rows left out
            # of the forward's K loop, 64 query rows out of dK/dV's Q loop,
            # and the bf16 roundings of p and ds left out
            tile = s_len // VARIANT_ROWS // 2
            skip = attention_dropping(torch, q, k, v, scale,
                                      lambda r, c: (tile_of(c) == tile) & (tile_of(r) > tile))
            checks.append(("flash o, one K tile skipped", readings(skip, o_p, **tol),
                           limit["o"], False))
            del skip
            # read only: the kernel rounds p against a running max and the
            # twin against the row's final max, so o differs from the twin
            # by about what leaving the rounding out does
            o_unrounded = fa.flash_fwd_plain(q.float(), k.float(), v.float(), causal, scale)[0]
            checks.append(("flash o, p not rounded to bf16", readings(
                o_unrounded.to(dtype), o_p, **tol), limit["o"], None))
            cut = slice(tile * VARIANT_ROWS, (tile + 1) * VARIANT_ROWS)
            do_cut, delta_cut = do.clone(), delta.clone()
            do_cut[:, cut], delta_cut[:, cut] = 0, 0
            _, dk_cut, dv_cut = fa.flash_backward(q, k, v, do_cut, lse_p, delta_cut, causal, scale)
            for what, a, c in (("dk", dk_cut, g_p[1]), ("dv", dv_cut, g_p[2])):
                checks.append((f"flash {what}, one Q tile skipped", readings(a, c, **tol),
                               limit[what], False))
            unrounded = fa.flash_bwd_plain(q.float(), k.float(), v.float(), do.float(), lse_p,
                                           delta, causal, scale)
            for what, a, c in zip(("dq", "dk", "dv"), unrounded, g_p):
                checks.append((f"flash {what}, p and ds not rounded to bf16", readings(
                    a.to(dtype), c, **tol), limit[what], False))
            for what, a in dq_variants(torch, q, k, v, do, lse_p, delta, scale):
                checks.append((f"flash dq, {what}", readings(a, g_p[0], **tol), limit["dq"],
                               False))
            # one owner a row, no atomics: dq, dk and dv repeat bit for bit
            dq_repeats(torch, fa, g_k[0], (q, k, v, do, lse_p, delta, causal, scale),
                       f"{shape} {dt}")
            dkv_repeats(torch, fa, g_k[1:], (q, k, v, do, lse_p, delta, causal, scale),
                        f"{shape} {dt}")
            del do_cut, delta_cut, dk_cut, dv_cut, unrounded, o_unrounded
        fwd = lambda: fa.flash_forward(q, k, v, causal, scale)  # noqa: E731
        bwd = lambda: fa.flash_backward(q, k, v, do, lse_p, delta, causal, scale)  # noqa: E731
        qs, ks, vs = (x.view(b, h, s_len, d) for x in (q, k, v))
        q4, k4, v4 = (x.detach().requires_grad_(True) for x in (qs, ks, vs))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        do4 = do.view(b, h, s_len, d)
        for name, kernel, plain, e, backward, lib in (
            ("flash_fwd", fwd, lambda: fa.flash_fwd_plain(q, k, v, causal, scale),
             max(err(o_k, o_p), err(lse_k, lse_p)), False,
             lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)),
            ("flash_bwd", bwd,
             lambda: fa.flash_bwd_plain(q, k, v, do, lse_p, delta, causal, scale),
             max(err(a, c) for a, c in zip(g_k, g_p)), True,
             lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)),
        ):
            rows[name].append(dict(
                shape=shape, dtype=dt, causal=causal, max_abs_err=e,
                ms=time_ms(torch, kernel, flush), call_ms=call_ms(torch, kernel),
                plain_ms=time_ms(torch, plain, flush), library_ms=time_ms(torch, lib, flush),
                **flash_bound(fa, bh, s_len, d, dtype, causal, backward)))
        if (b, h, s_len) == (8, 16, 2048):
            # K2c's two launches apart, each beside its own bound; plain and
            # library times are the whole backward's (one call computes dq,
            # dk and dv)
            whole = rows["flash_bwd"][-1]
            for name, part, kernel, e in (
                ("flash_dkv", "dkv",
                 lambda: fa.flash_backward_dkv(q, k, v, do, lse_p, delta, causal, scale),
                 max(err(g_k[1], g_p[1]), err(g_k[2], g_p[2]))),
                ("flash_dq", "dq",
                 lambda: fa.flash_backward_dq(q, k, v, do, lse_p, delta, causal, scale),
                 err(g_k[0], g_p[0])),
            ):
                rows[name].append(dict(
                    shape=shape, dtype=dt, causal=causal, max_abs_err=e,
                    ms=time_ms(torch, kernel, flush), call_ms=call_ms(torch, kernel),
                    plain_ms=whole["plain_ms"], library_ms=whole["library_ms"],
                    **flash_bound(fa, bh, s_len, d, dtype, causal, part=part)))
        del q, k, v, do, o4, q4, k4, v4
        torch.cuda.empty_cache()
    judge(checks)
    for name, cases in rows.items():
        for c in cases:
            say(f"  {name} {c['shape']} {c['dtype']}: kernel_ms={c['ms']} "
                f"plain_ms={c['plain_ms']} library_ms={c['library_ms']} "
                f"bound_ms={c['bound_ms']} ({c['bound_by']}) {shares(c)} call_ms={c['call_ms']} "
                f"max_abs_err={c['max_abs_err']}")

    # what the kernels do not take raises; nothing falls back to the plain twin
    x64 = torch.zeros(4, 64, device=dev, dtype=torch.float64)
    lab = torch.zeros(4, dtype=torch.int64, device=dev)
    expect_raise(TypeError, lambda: ce.fused_ce_forward(x64, lab), "ce f64")
    expect_raise(ValueError, lambda: ce.fused_ce_forward(x64.float(), lab.cpu()),
                 "ce labels on the CPU")
    qh = torch.zeros(2, 128, 64, device=dev, dtype=torch.float16)
    expect_raise(TypeError, lambda: fa.flash_forward(qh, qh, qh, True, 0.125), "flash f16")
    q32 = torch.zeros(2, 128, 32, device=dev, dtype=torch.bfloat16)
    expect_raise(ValueError, lambda: fa.flash_forward(q32, q32, q32, True, 0.125), "flash D=32")
    qb = torch.zeros(2, 128, 64, device=dev, dtype=torch.bfloat16)
    expect_raise(ValueError, lambda: fa.flash_forward(qb, qb.cpu(), qb, True, 0.125),
                 "flash k on the CPU")
    say("  wrong dtype / wrong device / unsupported head dim raise: ok")
    del flush
    torch.cuda.empty_cache()
    return rows


def phase_step_vs_cpu(torch, modules, what: str, model_kwargs: dict, batch: int, seq: int,
                      seed: int, want: dict):
    """Phases 7 and 10: one f32 training step (TF32 off) of
    ``TransformerLM(**model_kwargs)`` on the card against the same weights
    and batch on the CPU: the loss within rtol 1e-5 and every gradient
    within 1e-4 of its largest magnitude; the card's launches exactly
    ``want``."""
    from pytorch_distributed_training_tpu_torch.engine import lm_loss_local
    from pytorch_distributed_training_tpu_torch.models import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = TransformerLM(**model_kwargs)
    cpu.reset_parameters(torch.Generator().manual_seed(seed))
    gpu = TransformerLM(**model_kwargs)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.cuda()
    gen = torch.Generator().manual_seed(seed + 1)
    vocab = model_kwargs["vocab_size"]
    tokens = torch.randint(0, vocab, (batch, seq), generator=gen)
    labels = torch.randint(0, vocab, (batch, seq), generator=gen)
    for m in modules:
        m.reset_launch_counts()
    losses = {}
    for where, model, tok, lab in (("cpu", cpu, tokens, labels),
                                   ("card", gpu, tokens.cuda(), labels.cuda())):
        loss = lm_loss_local(model(tok), lab, batch * seq)
        loss.backward()
        losses[where] = loss.item()
    counts = all_counts(modules)
    check_launches(what, counts, want)
    say(f"  loss card {losses['card']!r} cpu {losses['cpu']!r}")
    if abs(losses["card"] - losses["cpu"]) > 1e-5 * abs(losses["cpu"]):
        raise AssertionError("loss: card and CPU differ by more than rtol 1e-5")
    # f32 everywhere, TF32 off: the sums run in other orders (cuBLAS, the
    # kernels) than on the CPU; each gradient within 1e-4 of its own largest
    # magnitude
    worst_name, worst = "", 0.0
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        gc, gg = pc.grad, pg.grad.cpu()
        rel = ((gg - gc).abs().max() / gc.abs().max().clamp_min(1e-30)).item()
        if not torch.isfinite(gg).all() or rel > 1e-4:
            raise AssertionError(f"grad {name}: card vs CPU relative error {rel}")
        if rel > worst:
            worst_name, worst = name, rel
    say(f"  {len(list(cpu.parameters()))} gradients match; worst {worst_name}: "
        f"max |card - cpu| / max |cpu| = {worst:.3g}; launches {counts}")
    del cpu, gpu
    torch.cuda.empty_cache()
    return counts, {"loss_card": losses["card"], "loss_cpu": losses["cpu"],
                    "worst_grad_rel": worst}


def phase_long_kernels(torch, fa):
    """Phase 9: the flash kernels where the JAX package streams K/V (bf16
    and f32 at S = 32768: K2b, K2f, K2g) and where it splits its resident
    backward (f32 at S = 2048: K2a, K2d, K2e), against their twins, with
    wrong variants that must be rejected; each launch timed."""
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.tools import flash_checks as fc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = {"long_fwd": [], "long_dq": [], "long_dkv": []}
    checks = []

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    for b, h, s_len, d, dtype in ((2, 8, 32768, 64, torch.bfloat16),
                                  (2, 8, 32768, 64, torch.float32),
                                  (8, 16, 2048, 64, torch.float32)):
        bh, causal, scale = b * h, True, 1.0 / d ** 0.5
        long = s_len >= 32768
        # the twins take seconds a call at S = 32768: fewer repeats there
        reps, warm, calls = (LONG_REPS, 1, 5) if long else (20, 3, 50)
        q, k, v, do = (torch.randn(bh, s_len, d, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        tpu = fa.tpu_kernels(s_len, d, dtype)
        o_k, lse_k = fa.flash_forward(q, k, v, causal, scale)
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        delta = (do.float() * o_p.float()).sum(-1)
        dk_k, dv_k = fa.flash_backward_dkv(q, k, v, do, lse_p, delta, causal, scale)
        dq_k = fa.flash_backward_dq(q, k, v, do, lse_p, delta, causal, scale)
        dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, causal, scale)
        torch.cuda.synchronize()
        shape, dt = [b, h, s_len, d], str(dtype).replace("torch.", "")
        tol, limit = (FLASH_TOL_LONG if long else FLASH_TOL)[dt], FLASH_NORM_LIMIT[dt]
        torch.testing.assert_close(lse_k, lse_p, atol=1e-4, rtol=1e-5)
        label = f"{shape} {dt} ({tpu['forward']}, {tpu['dq']}, {tpu['dkv']})"
        for what, a, c in (("o", o_k, o_p), ("dq", dq_k, dq_p), ("dk", dk_k, dk_p),
                           ("dv", dv_k, dv_p)):
            checks.append((f"flash {what} {label}", readings(a, c, **tol), limit[what], True))
        if dtype == torch.float32:
            checks += tf32_checks(fc, q, k, v, causal, scale, o_p, tol, limit["o"], label)
            checks += dkv_tf32_checks(fc, q, k, v, do, lse_p, delta, causal, scale, (dk_p, dv_p),
                                      tol, limit, label)
            checks += dq_tf32_checks(fc, q, k, v, do, lse_p, delta, causal, scale, dq_p, tol,
                                     limit["dq"], label)
        # wrong variants the limits must reject, each what a kernel with 64
        # rows too few in its loop returns: the diagonal 64-key block left
        # out of the forward (rows past the first 64: those have no other),
        # a middle block of 64 keys left out, the diagonal block left out of
        # both backward loops, and the dK/dV loop stopped 64 query rows short
        mid = s_len // VARIANT_ROWS // 2
        for what, drop in (
                ("diagonal K tile skipped",
                 lambda r, c: (tile_of(r) == tile_of(c)) & (r >= VARIANT_ROWS)),
                (f"K tile {mid} skipped", lambda r, c: (tile_of(c) == mid) & (tile_of(r) > mid))):
            checks.append((f"flash o {label}, {what}", readings(
                attention_dropping(torch, q, k, v, scale, drop), o_p, **tol), limit["o"], False))
        wrong = attention_dropping(torch, q, k, v, scale, lambda r, c: tile_of(r) == tile_of(c),
                                   do, lse_p, delta)
        for what, a, c in zip(("dq", "dk", "dv"), wrong, (dq_p, dk_p, dv_p)):
            checks.append((f"flash {what} {label}, diagonal tile skipped",
                           readings(a, c, **tol), limit[what], False))
        for what, a in dq_variants(torch, q, k, v, do, lse_p, delta, scale):
            checks.append((f"flash dq {label}, {what}", readings(a, dq_p, **tol), limit["dq"],
                           False))
        # one owner a row, no atomics: dq, dk and dv repeat bit for bit
        dq_repeats(torch, fa, dq_k, (q, k, v, do, lse_p, delta, causal, scale), label)
        dkv_repeats(torch, fa, (dk_k, dv_k), (q, k, v, do, lse_p, delta, causal, scale), label)
        do_cut, delta_cut = do.clone(), delta.clone()
        do_cut[:, -VARIANT_ROWS:], delta_cut[:, -VARIANT_ROWS:] = 0, 0
        wrong = fa.flash_backward_dkv(q, k, v, do_cut, lse_p, delta_cut, causal, scale)
        for what, a, c in zip(("dk", "dv"), wrong, (dk_p, dv_p)):
            checks.append((f"flash {what} {label}, last Q tile skipped",
                           readings(a, c, **tol), limit[what], False))
        del wrong, do_cut, delta_cut
        # times: each launch, the twins, and SDPA forward / backward on the
        # same inputs (efficient or flash backend only: the math backend
        # would hold [B, H, S, S] scores)
        from torch.nn.attention import SDPBackend, sdpa_kernel

        q4, k4, v4 = (x.view(b, h, s_len, d).detach().requires_grad_(True) for x in (q, k, v))
        do4 = do.view(b, h, s_len, d)
        lib_fwd = lib_bwd = None
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            try:
                o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
                lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4.detach(), k4.detach(), v4.detach(), is_causal=causal), flush, reps, warm)
                lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                    o4, (q4, k4, v4), do4, retain_graph=True), flush, reps, warm)
                del o4
            except RuntimeError as exc:  # no fused SDPA backend for this shape
                say(f"  SDPA {label}: {exc}")
        plain_bwd = time_ms(torch, lambda: fa.flash_bwd_plain(q, k, v, do, lse_p, delta, causal,
                                                              scale), flush, 2 if long else reps,
                            warm)
        for name, part, kernel, plain_ms, e, lib in (
            ("long_fwd", None, lambda: fa.flash_forward(q, k, v, causal, scale),
             time_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, causal, scale), flush,
                     2 if long else reps, warm),
             max(err(o_k, o_p), err(lse_k, lse_p)), lib_fwd),
            ("long_dq", "dq", lambda: fa.flash_backward_dq(q, k, v, do, lse_p, delta, causal,
                                                           scale),
             plain_bwd, err(dq_k, dq_p), lib_bwd),
            ("long_dkv", "dkv", lambda: fa.flash_backward_dkv(q, k, v, do, lse_p, delta, causal,
                                                              scale),
             plain_bwd, max(err(dk_k, dk_p), err(dv_k, dv_p)), lib_bwd),
        ):
            rows[name].append(dict(
                shape=shape, dtype=dt, causal=causal,
                tpu_kernel=tpu["forward" if part is None else part], max_abs_err=e,
                ms=time_ms(torch, kernel, flush, reps, warm),
                call_ms=call_ms(torch, kernel, calls), plain_ms=plain_ms, library_ms=lib,
                **flash_bound(fa, bh, s_len, d, dtype, causal, part=part)))
        del q, k, v, do, q4, k4, v4, o_k, o_p, dq_k, dk_k, dv_k, dq_p, dk_p, dv_p
        torch.cuda.empty_cache()
    judge(checks)
    for name, cases in rows.items():
        for c in cases:
            say(f"  {name} ({c['tpu_kernel']}) {c['shape']} {c['dtype']}: kernel_ms={c['ms']} "
                f"plain_ms={c['plain_ms']} library_ms={c['library_ms']} "
                f"bound_ms={c['bound_ms']} ({c['bound_by']}) {shares(c)} call_ms={c['call_ms']} "
                f"max_abs_err={c['max_abs_err']}")
    del flush
    torch.cuda.empty_cache()
    return rows


def phase_runner(torch, modules, config: str, name: str, per_step: dict,
                 per_val_batch: dict, steps: int = 6, dtype=None, edit=None, step_flops=None):
    """Phases 8, 11, 12, 18 and 25: the training runner on ``config`` (its
    ``training.dtype`` replaced by ``dtype`` if given, then ``edit(cfg)``'s
    cuts) for ``steps`` steps and one validation of 2 batches, with exact
    launch counts per step and per validation batch (keys missing from the
    dicts count 0).  MFU counts ``step_flops(model, batch, seq)``, by
    default :func:`train_step_flops`."""
    import math

    from functools import partial

    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg, get_train_logger
    from pytorch_distributed_training_tpu_torch.engine import Runner
    from pytorch_distributed_training_tpu_torch.logger import MultiProcessLoggerListener

    cfg = get_cfg(config)
    cfg["training"].update(train_iters=steps, print_interval=1, val_interval=steps)
    if dtype is not None:
        cfg["training"]["dtype"] = dtype
    cfg["dataset"]["n_samples"] = 2 * cfg["training"]["batch_size"]  # 2 val batches
    if edit is not None:
        edit(cfg)
    marks = []

    def on_iter(runner):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), all_counts(modules)))

    # the CLI's logging: records through the listener to stdout and a file
    listener = MultiProcessLoggerListener(
        partial(get_train_logger, os.path.join(_HERE, "run", "chip_smoke"), name), "spawn")
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=listener.queue, global_cfg=cfg, device="cuda",
                    on_iter=on_iter)
    for m in modules:
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        runner()
    finally:
        listener.stop()
    final = all_counts(modules)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in runner.train_log]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses: {losses}")
    if len(runner.val_log) != 1 or not math.isfinite(runner.val_log[0]["loss"]):
        raise AssertionError(f"validation: {runner.val_log}")
    prev = {k: 0 for k in final}
    for i, (_, counts) in enumerate(marks):
        check_launches(f"step {i}", {k: counts[k] - prev[k] for k in final}, per_step)
        prev = counts
    val_batches = len(runner.val_loader)
    got = {k: final[k] - prev[k] for k in final}
    check_launches(f"validation ({val_batches} batches)", got,
                   {k: n * val_batches for k, n in per_val_batch.items()})
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    batch, seq = cfg["training"]["batch_size"], cfg["dataset"]["seq_len"]
    med_ms = statistics.median(step_ms)
    n_params = sum(p.numel() for p in runner.model.parameters())
    flops = (step_flops or train_step_flops)(runner.model, batch, seq)
    say(f"  {n_params / 1e6:.1f} M parameters; losses {losses}; validation {runner.val_log[0]}")
    say(f"  step ms (steps 1-{steps - 1}, host clock, synced): {step_ms}; median {med_ms}")
    say(f"  tokens/s {batch * seq / med_ms * 1e3}; model FLOP a step {flops:.4g}; "
        f"MFU at 989 TFLOP/s {flops / (med_ms / 1e3) / BF16_FLOPS}")
    say(f"  launches: per step {per_step}, validation {got}; peak device memory {peak_gib} GiB")
    return runner, final, dict(step_ms=step_ms, median_step_ms=med_ms,
                               tokens_per_s=batch * seq / med_ms * 1e3,
                               mfu=flops / (med_ms / 1e3) / BF16_FLOPS, model_flop=flops,
                               peak_gib=peak_gib, losses=losses, val=runner.val_log[0])


def train_step_flops(model, batch: int, seq: int) -> float:
    """Model FLOP of one training step: 6 x (matmul parameters) per token,
    plus the attention products over the causal half (2 forward, 4
    backward), each 2 x S x D per (query, key) pair."""
    matmul = sum(p.numel() for n, p in model.named_parameters()
                 if n.endswith(".weight") and p.dim() == 2)
    tokens = batch * seq
    attn = 6 * 2 * model.embed_dim * model.depth * batch * seq * (seq + 1) // 2
    return 6.0 * matmul * tokens + attn


def phase_profile_train(torch, runner, label: str):
    """``--profile``: one training step after a warm one."""
    inp, lab = next(iter(runner.train_loader))
    tokens, labels = runner._to_device(inp, lab)
    runner.train_step(tokens, labels)
    profile_window(torch, label, lambda: runner.train_step(tokens, labels), 20)


def phase_f32_runner(torch, modules):
    """Phase 12: the trainer at its default dtype, f32, on the LM-1024
    config: every flash launch is an f32 one (K2a forward, K2d/K2e split
    backward, as the JAX package dispatches f32 at S = 2048).  Returns the
    runner and its launch counts."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg

    depth = get_cfg(TRAIN_CONFIG)["model"]["depth"]
    runner, counts, f32 = phase_runner(
        torch, modules, TRAIN_CONFIG, "train-lm-1024-f32", steps=3, dtype="float32",
        per_step=dict(add_layernorm=depth, bias_gelu=depth, ce_fwd=1, ce_bwd=1,
                      flash_fwd=depth, flash_bwd=2 * depth, K2a=depth, K2d=depth, K2e=depth),
        per_val_batch=dict(add_layernorm=depth, bias_gelu=depth, ce_fwd=1, flash_fwd=depth,
                           K2a=depth))
    say("f32_runner: " + json.dumps(f32))
    return runner, counts


def phase_f32_runner_and_profile(torch, modules, profile: bool) -> dict:
    """Phase 12, then with ``profile`` one f32 step under the profiler;
    returns the launch counts."""
    runner, counts = phase_f32_runner(torch, modules)
    if profile:
        say("== profile (f32 train step)")
        phase_profile_train(torch, runner, "f32 train step")
    del runner
    torch.cuda.empty_cache()
    return counts


def relative_to_largest(got, want) -> float:
    """max |got - want| / max |want|."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp_min(1e-300)).item()


def norm_relative(got, want) -> float:
    """||got - want|| / ||want||."""
    return ((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-300)).item()


def phase_resnet_step_vs_cpu(torch, modules, batch: int = 4, seed: int = 12) -> dict:
    """Phase 13: one ResNet-50 training step (its forward and backward) at
    full width, f32 with TF32 off, ``sync_bn`` on at world size 1, on the
    card against the same weights and batch on the CPU, in f32 and in
    float64 (statistics and products in float64, the logits and CE in f32).

    - the loss within rtol 1e-5 of the CPU's, the logits and every
      BatchNorm running statistic after the step within 1e-4 of their
      largest magnitude;
    - the gradients against the float64 run: the f32 backward of this
      network at its init amplifies rounding (the CPU's own f32 gradients
      lie ~2.5% from float64 in norm, torch's own BatchNorm likewise), so
      each gradient of the card must lie as close to float64 as the CPU's
      f32 one does: its norm-relative error at most 3x the CPU's (or 1e-4),
      and over all gradients at most 2x; the card-vs-CPU error against the
      largest magnitude is printed beside them;
    - exactly 1 K1a and 1 K1b launch on the card."""
    from pytorch_distributed_training_tpu_torch import optimizers
    from pytorch_distributed_training_tpu_torch.engine import build_train_step
    from pytorch_distributed_training_tpu_torch.models import get_model

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = get_model("ResNet50", num_classes=1000, sync_bn=True)
        cpu.reset_parameters(torch.Generator().manual_seed(seed))
        ref = get_model("ResNet50", num_classes=1000, sync_bn=True, dtype=torch.float64)
        ref.load_state_dict(cpu.state_dict())
        ref.double()
        gpu = get_model("ResNet50", num_classes=1000, sync_bn=True)
        gpu.load_state_dict(cpu.state_dict())
        gpu = gpu.to("cuda", memory_format=torch.channels_last)
        gen = torch.Generator().manual_seed(seed + 1)
        img = torch.randn(batch, 224, 224, 3, generator=gen)
        labels = torch.randint(0, 1000, (batch,), generator=gen)
        out = {}
        for where, model, x, y in (("float64", ref, img.double(), labels),
                                   ("cpu", cpu, img, labels),
                                   ("card", gpu, img.cuda(), labels.cuda())):
            for m in modules:
                m.reset_launch_counts()
            opt = optimizers.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
            step = build_train_step(model, opt, lambda s: 0.1, sync_bn=True)
            t0 = time.perf_counter()
            loss, logits = step.forward_backward(x, y)
            out[where] = (loss.item(), logits.cpu())
            say(f"  {where}: forward and backward in {time.perf_counter() - t0:.2f} s")
        counts = all_counts(modules)
        check_launches("ResNet-50 step on the card", counts, dict(ce_fwd=1, ce_bwd=1))
        (l_cpu, y_cpu), (l_card, y_card) = out["cpu"], out["card"]
        say(f"  loss card {l_card!r} cpu {l_cpu!r} float64 {out['float64'][0]!r}")
        if abs(l_card - l_cpu) > 1e-5 * abs(l_cpu):
            raise AssertionError("loss: card and CPU differ by more than rtol 1e-5")
        numbers = {"logits": relative_to_largest(y_card, y_cpu)}
        if not torch.isfinite(y_card).all() or numbers["logits"] > 1e-4:
            raise AssertionError(f"logits: card vs CPU relative error {numbers['logits']}")
        name, rel = max(((n, relative_to_largest(bg.cpu(), bc)) for (n, bc), bg in
                         zip(cpu.named_buffers(), gpu.buffers())), key=lambda t: t[1])
        if rel > 1e-4:
            raise AssertionError(f"running statistic {name}: card vs CPU relative error {rel}")
        numbers["running"] = (name, rel)
        say(f"  logits {tuple(y_card.shape)}: max |card - cpu| / max |cpu| = "
            f"{numbers['logits']:.3g}; {len(list(cpu.buffers()))} running statistics, worst "
            f"{name} {rel:.3g}; launches {counts}")
        grads = [(n, pc.grad, pg.grad.cpu(), pr.grad) for (n, pc), pg, pr in
                 zip(cpu.named_parameters(), gpu.parameters(), ref.parameters())]
        if not all(torch.isfinite(g).all() for _, _, g, _ in grads):
            raise AssertionError("gradients: non-finite on the card")
        ratios = []
        for n, gc, gg, gr in grads:
            e_card, e_cpu = norm_relative(gg, gr), norm_relative(gc, gr)
            if e_card > max(1e-4, 3 * e_cpu):
                raise AssertionError(f"grad {n}: card {e_card} from float64, CPU f32 {e_cpu}")
            ratios.append((e_card / max(e_cpu, 1e-300), n, e_card, e_cpu))
        flat = [torch.cat([t.double().reshape(-1) for t in ts])
                for ts in zip(*[(gc, gg, gr) for _, gc, gg, gr in grads])]
        g_cpu, g_card = norm_relative(flat[0], flat[2]), norm_relative(flat[1], flat[2])
        if g_card > 2 * g_cpu:
            raise AssertionError(f"gradients: card {g_card} from float64 over all, CPU {g_cpu}")
        worst = max(ratios)
        vs_cpu = max((relative_to_largest(gg, gc), n) for n, gc, gg, _ in grads)
        numbers.update(grad_norm_rel_float64=dict(card=g_card, cpu=g_cpu),
                       worst_ratio=worst, card_vs_cpu_largest=vs_cpu)
        say(f"  {len(grads)} gradients against float64 (norm-relative): all of them card "
            f"{g_card:.4g}, CPU f32 {g_cpu:.4g}; worst card/CPU ratio {worst[0]:.3g} at "
            f"{worst[1]} ({worst[2]:.3g} vs {worst[3]:.3g}); read only: max |card - cpu| / "
            f"max |cpu| worst {vs_cpu[0]:.3g} at {vs_cpu[1]}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    say("resnet_step: " + json.dumps(numbers))
    del cpu, gpu, ref
    torch.cuda.empty_cache()
    return counts


def resnet_forward_flop(torch, name: str, classes: int, image_size: int,
                        space_to_depth: bool = False) -> float:
    """Model FLOP of one image's forward: 2 x the multiply-adds of every
    conv and of ``fc``, from the shapes (a meta-device model, no data; the
    packed stem's zero taps counted, as the card computes them)."""
    from pytorch_distributed_training_tpu_torch.models import get_model

    total = [0]

    def count(module, inputs, output):
        if isinstance(module, torch.nn.Conv2d):
            k = module.kernel_size[0] * module.kernel_size[1] * module.in_channels
            total[0] += 2 * output.numel() * k // module.groups
        else:
            total[0] += 2 * output.numel() * module.weight.shape[1]

    with torch.device("meta"):
        model = get_model(name, num_classes=classes, space_to_depth=space_to_depth)
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d) or m is model.fc:
                m.register_forward_hook(count)
        model(torch.empty(1, 3, image_size, image_size))
    return float(total[0])


def device_step_ms(torch, step, img, labels, reps: int = 8) -> float:
    """Median wall ms of ``step`` on a batch already on the card, each call
    synchronised, after two warm calls."""
    times = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(img, labels)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def loader_ms(loader, batches: int = 6) -> float:
    """Host ms a batch of ``loader`` alone: its stream after one warm batch
    (pool start-up and first decode), ``batches`` batches timed."""
    from pytorch_distributed_training_tpu_torch.data import make_iter_dataloader

    stream = make_iter_dataloader(loader)
    try:
        next(stream)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(stream)
        return (time.perf_counter() - t0) * 1e3 / batches
    finally:
        stream.close()


def phase_resnet_runner(torch, modules, dtype: str, tf32_defaults, profile: bool,
                        steps: int = 8, n_samples=None, training=None, validation=None,
                        layouts=("channels_last", "nchw", "channels_last_cudnn_benchmark"),
                        label=None, after_run=None, config=RESNET_CONFIG, edit=None):
    """Phases 14, 15 and 16: the runner on ``config`` (``config/test-sync.yml``)
    as it is, with ``edit(cfg)``'s cuts, ``train_iters`` (``steps``), the
    dataset size (``n_samples``, default 2 validation batches),
    ``training.dtype`` and the keys of ``training``/``validation`` set in
    memory; TF32 flags at torch's defaults, which the runner does not
    touch.  Per step exactly 1 K1a + 1 K1b, per validation batch 1 K1a.
    ``after_run(runner)``, if given, runs on the trained weights before the
    timings below train them further.  Returns the runner (its loaders
    closed), the launch counts and the numbers printed."""
    import math

    from functools import partial

    import numpy as np

    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg, get_train_logger
    from pytorch_distributed_training_tpu_torch.engine import Runner
    from pytorch_distributed_training_tpu_torch.logger import MultiProcessLoggerListener

    label = label or f"resnet_{dtype}"
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    cfg = get_cfg(config)
    if edit is not None:
        edit(cfg)
    batch = cfg["training"]["batch_size"]
    cfg["training"].update(train_iters=steps, dtype=dtype, **(training or {}))
    cfg["validation"].update(validation or {})
    cfg["dataset"]["n_samples"] = n_samples or 2 * batch
    marks, losses = [], []

    def on_iter(runner):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), all_counts(modules)))
        losses.append(float(runner.last_loss))

    listener = MultiProcessLoggerListener(
        partial(get_train_logger, os.path.join(_HERE, "run", "chip_smoke"), label), "spawn")
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=listener.queue, global_cfg=cfg, device="cuda", on_iter=on_iter)
    for m in modules:
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        runner()
    finally:
        listener.stop()
    final = all_counts(modules)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses: {losses}")
    if len(runner.val_log) != 1 or not math.isfinite(runner.val_log[0]["loss"]):
        raise AssertionError(f"validation: {runner.val_log}")
    prev = {k: 0 for k in final}
    for i, (_, counts) in enumerate(marks):
        check_launches(f"step {i}", {k: counts[k] - prev[k] for k in final},
                       dict(ce_fwd=1, ce_bwd=1))
        prev = counts
    val_batches = len(runner.val_loader)
    check_launches(f"validation ({val_batches} batches)", {k: final[k] - prev[k] for k in final},
                   dict(ce_fwd=val_batches))
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    med_ms = statistics.median(step_ms)
    image_size = cfg["dataset"].get("image_size", 224)
    flop = 3 * resnet_forward_flop(torch, cfg["model"]["name"], cfg["dataset"]["n_classes"],
                                   image_size, cfg["model"].get("space_to_depth", False))
    # bf16 convs on the bf16 tensor cores; f32 convs under cuDNN's TF32 default
    peak = BF16_FLOPS if dtype == "bfloat16" else TF32_FLOPS
    flags = dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                 cudnn=torch.backends.cudnn.allow_tf32)
    loader = runner.train_loader
    say(f"  loader: {loader.worker_mode} mode, {loader.num_workers} worker(s), "
        f"{loader.output_dtype} batches; nproc {os.cpu_count()}")
    say(f"  losses {losses}; validation {runner.val_log[0]}")
    say(f"  allow_tf32 in force (torch's defaults): {flags}; sync_bn in force: "
        f"{runner.sync_bn} (one rank)")
    say(f"  step ms (steps 1-{steps - 1}, host clock, loader-fed, synced): {step_ms}; "
        f"median {med_ms}; images/s per card {batch / med_ms * 1e3}")
    say(f"  model FLOP an image (train: 3 x forward) {flop:.4g}; rate "
        f"{flop * batch / med_ms / 1e9:.2f} TFLOP/s, "
        f"{flop * batch / (med_ms / 1e3) / peak:.4f} of {peak / 1e12:.1f}")
    say(f"  launches a step {{'ce_fwd': 1, 'ce_bwd': 1}}, validation "
        f"{{'ce_fwd': {val_batches}}}; peak device memory {peak_gib} GiB")
    if after_run is not None:
        after_run(runner)

    # the loader alone, then the same step on one batch held on the card
    load_ms = loader_ms(loader)
    inp, lab = next(iter(loader))
    loader.close()
    h2d = dict(float32=inp.size * 4 + lab.nbytes, uint8=inp.size + lab.nbytes)
    img, labels = runner._to_device(inp, lab)
    model, step = runner.model, runner.train_step
    dev_ms = {}
    for layout in layouts:
        if layout == "nchw":
            model.to(memory_format=torch.contiguous_format)
            nchw_img = img.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            dev_ms[layout] = device_step_ms(torch, step, nchw_img, labels)
            model.to(memory_format=torch.channels_last)
            continue
        torch.backends.cudnn.benchmark = layout.endswith("cudnn_benchmark")
        try:
            dev_ms[layout] = device_step_ms(torch, step, img, labels)
        finally:
            torch.backends.cudnn.benchmark = False
    say(f"  loader alone (host): {load_ms} ms a batch of {batch}, "
        f"{batch / load_ms * 1e3} images/s; host-to-device bytes a batch "
        f"{np.dtype(inp.dtype).name} {inp.nbytes + lab.nbytes} (as float32 {h2d['float32']}, "
        f"as uint8 {h2d['uint8']})")
    for layout, ms in dev_ms.items():
        say(f"  device-resident step ({layout}): {ms} ms, {batch / ms * 1e3} images/s, "
            f"{flop * batch / ms / 1e9:.2f} TFLOP/s")
    if profile:
        say(f"== profile (ResNet-50 {dtype} train step, device-resident)")
        profile_window(torch, f"ResNet-50 {dtype} step", lambda: step(img, labels), 20)
    numbers = dict(dtype=dtype, step_ms=step_ms, median_step_ms=med_ms,
                   images_per_s=batch / med_ms * 1e3, loader_ms=load_ms,
                   loader=dict(mode=loader.worker_mode, workers=loader.num_workers,
                               output=loader.output_dtype), nproc=os.cpu_count(),
                   h2d_bytes=inp.nbytes + lab.nbytes, device_step_ms=dev_ms,
                   model_flop_per_image=flop / 3, peak_gib=peak_gib, allow_tf32=flags,
                   losses=losses, val=runner.val_log[0])
    say(f"{label}: " + json.dumps(numbers))
    del model, step, img
    torch.cuda.empty_cache()
    return runner, final, numbers


# The card's host, probed for this phase: Pillow 12.2, g++ 13.3, 8 cores, and
# neither libjpeg's headers (jpeglib.h) nor libjpeg itself, only nvJPEG.  The
# native decoder (native/decode.cpp, linked with -ljpeg) cannot build there.
NATIVE_DECODE_ON_CARD = ("not run: the card's host has no libjpeg (no jpeglib.h, no "
                         "libjpeg.so), so the native decoder does not build there; the "
                         "ImageFolder, native-decode and device_normalize paths are held on "
                         "the CPU only (tests/test_torch_imagefolder.py, test_torch_loader.py, "
                         "test_torch_resnet_data.py)")
PROCESS_VAL_SAMPLES = 300  # 5 validation batches of 64, the last wrap-padded by 20


def phase_resnet_process_exact(torch, modules, tf32_defaults, profile: bool) -> dict:
    """Phase 15: ``config/test-sync.yml`` through the process loader
    (``training.worker_mode: process``, 8 workers) with
    ``validation.exact``, 6 steps over a set of 300 (an epoch of 4
    batches, so the pool runs a second epoch); then the parity validation
    of the same weights.  Holds the launches of phase 14 (also for the
    parity validation) and the exact count n = 300."""
    import logging

    say(f"  native decode, ImageFolder, device_normalize on the card: {NATIVE_DECODE_ON_CARD}")

    def parity(runner):
        """The reference's per-batch meter on the weights just validated."""
        exact = runner.val_log[0]
        if exact.get("n") != PROCESS_VAL_SAMPLES:
            raise AssertionError(f"exact validation counted {exact.get('n')} samples, want "
                                 f"{PROCESS_VAL_SAMPLES}")
        before = all_counts(modules)
        runner.exact_eval = False
        runner.logger.handlers = [logging.StreamHandler(sys.stdout)]  # its listener stopped
        try:
            runner.validate()
        finally:
            runner.val_loader.close()
        val_batches = len(runner.val_loader)
        check_launches(f"parity validation ({val_batches} batches)",
                       {k: v - before[k] for k, v in all_counts(modules).items()},
                       dict(ce_fwd=val_batches))
        padded = -PROCESS_VAL_SAMPLES % runner.host_batch
        say(f"  validation of the same weights: exact {exact} (n = {exact['n']}); parity "
            f"(per-batch meter, the {padded} wrap-padded samples counted again) "
            f"{runner.val_log[1]}")
        say("resnet_process_exact_validation: "
            + json.dumps(dict(exact=exact, parity=runner.val_log[1])))

    runner, counts, _ = phase_resnet_runner(
        torch, modules, "float32", tf32_defaults, profile, steps=6,
        n_samples=PROCESS_VAL_SAMPLES, training=dict(worker_mode="process", print_interval=1,
                                                     val_interval=6),
        validation=dict(exact=True), layouts=("channels_last",), label="resnet_process_exact",
        after_run=parity)
    if runner.train_loader.worker_mode != "process":
        raise AssertionError(f"loader mode {runner.train_loader.worker_mode}, want process")
    del runner
    torch.cuda.empty_cache()
    return counts


def lars_cuts(variant: str):
    """Phase 16's cuts of ``config/ResNet50-lars8k.yml``, made in memory
    (``PERF.md`` section 4): synthetic images (the card's host has no
    libjpeg), batch 8192 -> 256, train_iters and total_iters 6500 -> 8,
    warmup 782 -> 3, print every step, validate at the 8th; variant ``b``
    also sets the space-to-depth stem, bf16 BatchNorm statistics and the
    weight EMA (validation then on the EMA)."""

    def edit(cfg):
        cfg["dataset"]["name"] = "synthetic"
        cfg["training"].update(batch_size=LARS_BATCH, print_interval=1, val_interval=LARS_STEPS)
        cfg["training"]["lr_schedule"].update(total_iters=LARS_STEPS, warmup_iters=LARS_WARMUP)
        if variant == "b":
            cfg["model"].update(space_to_depth=True, bn_stat_dtype="bfloat16")
            cfg["training"]["ema"] = {"decay": 0.999}

    return edit


def phase_s2d_vs_7x7(torch, batch: int = 2, seed: int = 16) -> dict:
    """Phase 16, first check: on one batch at 224^2 in f32 (TF32 off), the
    s2d ResNet-50 forward (train mode) with the folded stem against the 7x7
    model with the unfolded weights, on the card.  The limit is the f32
    error of the same pair on the CPU, as phase 13 sets its own: the card's
    s2d logits within 3x the CPU pair's worst error (each from a float64
    run, and from each other; relative to the largest logit, at least
    1e-6) of the card's 7x7 logits and of float64."""
    from pytorch_distributed_training_tpu_torch.models import get_model
    from pytorch_distributed_training_tpu_torch.models.resnet import fold_stem_weight

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = get_model("ResNet50", num_classes=1000)
        ref.reset_parameters(torch.Generator().manual_seed(seed))
        folded = dict(ref.state_dict())
        folded["conv1.weight"] = fold_stem_weight(folded["conv1.weight"])
        x = torch.randn(batch, 3, 224, 224, generator=torch.Generator().manual_seed(seed + 1))
        out = {}
        for where in ("cpu", "cuda"):
            for stem in ("7x7", "s2d"):
                model = get_model("ResNet50", num_classes=1000, space_to_depth=stem == "s2d")
                model.load_state_dict(ref.state_dict() if stem == "7x7" else folded)
                with torch.no_grad():
                    out[where, stem] = model.to(where).train()(x.to(where)).cpu()
        f64 = get_model("ResNet50", num_classes=1000, dtype=torch.float64)
        f64.load_state_dict(ref.state_dict())
        with torch.no_grad():
            y64 = f64.double().train()(x.double()).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    cpu_err = max([relative_to_largest(out["cpu", s].double(), y64) for s in ("7x7", "s2d")]
                  + [relative_to_largest(out["cpu", "s2d"], out["cpu", "7x7"])])
    limit = max(3 * cpu_err, 1e-6)
    numbers = dict(card_s2d_vs_7x7=relative_to_largest(out["cuda", "s2d"], out["cuda", "7x7"]),
                   card_s2d_vs_float64=relative_to_largest(out["cuda", "s2d"].double(), y64),
                   cpu_f32_vs_float64=cpu_err, limit=limit)
    say(f"  s2d ResNet-50 (folded stem) vs 7x7 (unfolded), f32, train mode, batch {batch}: "
        f"{numbers}")
    if not torch.isfinite(out["cuda", "s2d"]).all() or max(
            numbers["card_s2d_vs_7x7"], numbers["card_s2d_vs_float64"]) > limit:
        raise AssertionError(f"s2d stem on the card: {numbers}")
    return numbers


def phase_lars_step_vs_cpu(torch, seed: int = 18) -> dict:
    """Phase 16, second check: one LARS step (the recipe's lr 10, momentum
    0.9, wd 1e-4, eta 0.001) of ResNet-50's parameters on the card against
    the CPU on the same weights and gradients.  The norms are f32 sums in
    another order on each side (~1e-6 relative apart for a few million
    terms), and the trust ratio carries that into the step: each
    parameter's update (and momentum) within 1e-5 of its own norm, and
    rank <= 1 parameters (plain momentum SGD, no norms) within 1e-6.
    Then the device ms of one LARS update and of one SGD update (momentum
    0.9, wd 1e-4, past its first step) on the same parameters."""
    from pytorch_distributed_training_tpu_torch import optimizers
    from pytorch_distributed_training_tpu_torch.models import get_model

    model = get_model("ResNet50", num_classes=1000)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    params = [p.detach().clone() for p in model.parameters()]
    grads = [torch.randn(p.shape, generator=gen) * 1e-2 for p in params]
    opt = optimizers.LARS(lr=10.0, momentum=0.9, weight_decay=1e-4, eta=0.001)
    out = {}
    for where in ("cpu", "cuda"):
        p = [t.to(where, copy=True) for t in params]  # updated in place
        g = [t.to(where) for t in grads]
        state = opt.update(p, g, opt.init(p), 10.0)
        out[where] = ([t.cpu() for t in p], [t.cpu() for t in state.momentum])
    torch.cuda.synchronize()
    worst = {}
    for i, p0 in enumerate(params):
        limit = 1e-6 if p0.dim() <= 1 else 1e-5
        for what, got, want in (("update", out["cuda"][0][i] - p0, out["cpu"][0][i] - p0),
                                ("momentum", out["cuda"][1][i], out["cpu"][1][i])):
            e = norm_relative(got, want)
            worst[what] = max(worst.get(what, (0.0, 0)), (e, i))
            if not torch.isfinite(got).all() or e > limit:
                raise AssertionError(f"LARS {what} of parameter {i} {tuple(p0.shape)}: "
                                     f"card vs CPU {e} > {limit}")
    # the card's tensors: timed only now, each update changes them in place
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    sgd = optimizers.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    sgd_state = sgd.init(p)._replace(step=1)
    update_ms = dict(lars=time_ms(torch, lambda: opt.update(p, g, state, 1e-3), flush),
                     sgd=time_ms(torch, lambda: sgd.update(p, g, sgd_state, 1e-3), flush))
    say(f"  one LARS step of ResNet-50 ({len(params)} tensors), card vs CPU: worst "
        f"norm-relative update {worst['update']}, momentum {worst['momentum']}")
    say(f"  optimizer update alone on the card (ResNet-50, {sum(t.numel() for t in p)} "
        f"values): LARS {update_ms['lars']} ms, SGD {update_ms['sgd']} ms")
    return dict({k: v[0] for k, v in worst.items()}, update_ms=update_ms)


def phase_lars_forms(torch, reps: int = 6, seed: int = 20) -> dict:
    """Phase 16, last: what the stem and the statistics' dtype each do to
    the step.  The LARS step of ResNet-50 in bf16 at batch 256 on one
    batch held on the card, in four forms (7x7 or space-to-depth stem, f32
    or bf16 BatchNorm statistics), timed in turns (each form's median of
    ``reps`` synchronised steps after two warm ones, the forms in order and
    then in reverse)."""
    from pytorch_distributed_training_tpu_torch import optimizers
    from pytorch_distributed_training_tpu_torch.engine import build_train_step
    from pytorch_distributed_training_tpu_torch.models import get_model

    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.randn(LARS_BATCH, 224, 224, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (LARS_BATCH,), generator=gen, device="cuda")
    forms = {}
    for s2d in (False, True):
        for stats in ("float32", "bfloat16"):
            model = get_model("ResNet50", num_classes=1000, dtype=torch.bfloat16,
                              space_to_depth=s2d,
                              bn_stat_dtype=torch.bfloat16 if stats == "bfloat16" else None)
            model = model.to("cuda", memory_format=torch.channels_last).train()
            opt = optimizers.LARS(lr=0.1, momentum=0.9, weight_decay=1e-4, eta=0.001)
            forms[("s2d" if s2d else "7x7") + f"_{stats}_stats"] = build_train_step(
                model, opt, lambda step: 0.1)
    times = {name: [] for name in forms}
    for name in list(forms) + list(reversed(forms)):
        times[name].append(device_step_ms(torch, forms[name], img, labels, reps=reps))
    ms = {name: statistics.median(t) for name, t in times.items()}
    base = ms["7x7_float32_stats"]
    say(f"  LARS bf16 step, batch {LARS_BATCH}, device-resident, in turns: "
        + "; ".join(f"{k} {v} ms ({v / base:.3f}x)" for k, v in ms.items())
        + f" (turns {times})")
    del forms
    torch.cuda.empty_cache()
    return dict(ms=ms, turns=times)


def phase_lars(torch, modules, tf32_defaults, profile: bool) -> dict:
    """Phase 16: ``config/ResNet50-lars8k.yml`` (:func:`lars_cuts`), runs
    (a) and (b), after the two checks above.  Holds each step's lr against
    ``poly_lr`` computed here and the launches of phase 14; prints the
    step ms loader-fed and device-resident, images/s, peak memory and, for
    (b), the EMA update's ms.  Returns the launch counts by path."""
    from pytorch_distributed_training_tpu_torch.schedulers import poly_lr

    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg

    checks = dict(s2d=phase_s2d_vs_7x7(torch), lars=phase_lars_step_vs_cpu(torch))
    train_cfg = get_cfg(LARS_CONFIG)["training"]
    sched = train_cfg["lr_schedule"]
    want_lr = poly_lr(float(train_cfg["optimizer"]["lr"]), LARS_STEPS, power=sched["power"],
                      end_lr=sched["end_lr"], warmup_iters=LARS_WARMUP,
                      warmup_mode=sched["warmup_mode"], warmup_factor=sched["warmup_factor"])
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    paths = {}
    for variant, path in (("a", "resnet_lars"), ("b", "resnet_lars_s2d_ema")):
        extra = {}

        def after_run(runner, extra=extra):
            lrs = [r["lr"] for r in runner.train_log]
            if lrs != [want_lr(i) for i in range(LARS_STEPS)]:
                raise AssertionError(f"lr by step {lrs}, poly_lr gives "
                                     f"{[want_lr(i) for i in range(LARS_STEPS)]}")
            step = runner.train_step
            if type(runner.optimizer).__name__ != "LARS":
                raise AssertionError(f"optimizer {type(runner.optimizer).__name__}")
            extra["lr"] = lrs
            if variant == "b":
                if step.ema is None or not runner.model.space_to_depth or not all(
                        m.low_stats for m in runner.model.modules() if hasattr(m, "low_stats")):
                    raise AssertionError("variant b: EMA, s2d stem or bf16 statistics missing")
                extra["ema_update_ms"] = time_ms(torch, step.update_ema, flush)
                say(f"  EMA update alone ({len(step.params)} tensors, "
                    f"{sum(p.numel() for p in step.params)} values): "
                    f"{extra['ema_update_ms']} ms")
            say(f"  lr by step (poly, warmup {LARS_WARMUP}): {lrs}")

        runner, counts, _ = phase_resnet_runner(
            torch, modules, "bfloat16", tf32_defaults, profile, steps=LARS_STEPS,
            layouts=("channels_last",), label=path, after_run=after_run, config=LARS_CONFIG,
            edit=lars_cuts(variant))
        paths[path] = by_tpu_kernel(counts)
        say(f"{path}_extra: " + json.dumps(extra))
        del runner
        torch.cuda.empty_cache()
    checks["forms"] = phase_lars_forms(torch)
    say("resnet_lars_checks: " + json.dumps(checks))
    return paths


@contextlib.contextmanager
def deterministic(torch):
    """Phases 17 and 19: ``torch.use_deterministic_algorithms(True)``,
    ``cudnn.benchmark`` off and ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, each
    put back afterwards (the runner sets none of them)."""
    saved = (os.environ.get("CUBLAS_WORKSPACE_CONFIG"), torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        if saved[0] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[0]
        torch.backends.cudnn.benchmark = saved[1]
        torch.use_deterministic_algorithms(saved[2])


def phase_checkpoint(torch, modules) -> dict:
    """Phase 17: checkpoint, resume and preemption on ``config/test-sync.yml``
    (f32, 6 steps over 2-batch epochs) with ``training.checkpoint`` (every
    3 steps, its own directory under ``run/chip_smoke/ckpt``) and the EMA
    (0.999): (a) straight; (b) killed after step 2's save, then a new
    runner resumes at 3 and runs to 6; (c) SIGTERM sent to itself at step
    4, which saves at 4 and returns cleanly, then a relaunch from 5.  Runs
    under ``torch.use_deterministic_algorithms(True)``, ``cudnn.benchmark``
    off and ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set here; (b)'s and (c)'s
    final parameters, BatchNorm buffers, momentum, EMA and the losses of
    steps 3-5 must equal (a)'s bit for bit.  Prints the bytes on disk a
    step, the ms of a save and of a restore, and a sidecar."""
    import shutil
    import signal

    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg
    from pytorch_distributed_training_tpu_torch.engine import Runner

    class Killed(Exception):
        pass

    def run(sub: str, kill_at=None, sigterm_at=None):
        cfg = get_cfg(RESNET_CONFIG)
        cfg["training"].update(train_iters=6, print_interval=1, dtype="float32",
                               ema={"decay": 0.999},
                               checkpoint={"dir": os.path.join(CKPT_DIR, sub), "interval": 3})
        cfg["dataset"]["n_samples"] = 2 * cfg["training"]["batch_size"]
        losses = {}

        def on_iter(runner):
            if runner.iter == kill_at:
                raise Killed
            losses[runner.iter] = float(runner.last_loss)
            if runner.iter == sigterm_at:
                os.kill(os.getpid(), signal.SIGTERM)

        runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                        logger_queue=None, global_cfg=cfg, device="cuda", on_iter=on_iter)
        try:
            runner()
        except Killed:
            pass
        torch.cuda.synchronize()
        return runner, losses

    def state(runner):
        step = runner.train_step
        return dict(model={k: v.cpu() for k, v in runner.model.state_dict().items()},
                    momentum=[t.cpu() for t in step.opt_state.momentum],
                    ema=[t.cpu() for t in step.ema], step=step.opt_state.step)

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    with deterministic(torch):
        a, la = run("a")
        _, lb1 = run("b", kill_at=3)
        b, lb2 = run("b")
        c1, lc1 = run("c", sigterm_at=4)
        c_steps = sorted(os.listdir(os.path.join(CKPT_DIR, "c")))
        c, lc2 = run("c")
    if c1.iter != 4 or c_steps != ["2", "4", "pipeline_2.json", "pipeline_4.json"]:
        raise AssertionError(f"SIGTERM at step 4: stopped at {c1.iter}, saved {c_steps}")
    if sorted(lb2) != [3, 4, 5] or sorted(lc2) != [5]:
        raise AssertionError(f"resumed steps: (b) {sorted(lb2)}, (c) {sorted(lc2)}")
    want = state(a)
    for name, runner, losses in (("b", b, {**lb1, **lb2}), ("c", c, {**lc1, **lc2})):
        got = state(runner)
        bad = [k for k, v in want["model"].items() if not torch.equal(v, got["model"][k])]
        bad += [f"momentum[{i}]" for i, (x, y) in enumerate(zip(want["momentum"],
                                                               got["momentum"]))
                if not torch.equal(x, y)]
        bad += [f"ema[{i}]" for i, (x, y) in enumerate(zip(want["ema"], got["ema"]))
                if not torch.equal(x, y)]
        bad += [f"loss[{i}]" for i in (3, 4, 5) if losses.get(i) != la[i]]
        if got["step"] != want["step"]:
            bad.append("optimizer step")
        if bad:
            raise AssertionError(f"({name}) differs from the straight run in {bad[:10]} "
                                 f"({len(bad)} in all)")
    save, restore = a.checkpointer.last_save, b.checkpointer.last_restore
    side = json.loads(open(os.path.join(CKPT_DIR, "b", "pipeline_2.json")).read())
    numbers = dict(bytes_a_step=save["bytes"], save_ms=save["seconds"] * 1e3,
                   restore_ms=restore["seconds"] * 1e3, sidecar_step_2=side,
                   losses=[la[i] for i in range(6)])
    say(f"  (b) killed after step 2's save, resumed at 3; (c) SIGTERM at 4, saved at 4, "
        f"relaunched at 5: final parameters, BatchNorm buffers, momentum, EMA and the "
        f"losses of steps 3-5 equal the straight run's bit for bit")
    say(f"  a step on disk {save['bytes']} bytes (ResNet-50 parameters, buffers, momentum, "
        f"EMA); save {numbers['save_ms']} ms, restore {numbers['restore_ms']} ms; sidecar "
        f"pipeline_2.json {side}")
    say("resnet_checkpoint: " + json.dumps(numbers))
    return numbers


def phase_resnet(torch, modules, tf32_defaults, profile: bool) -> dict:
    """Phases 13 to 17; returns the launch counts by path."""
    phase("phase 13: ResNet-50 training step at full width, card vs CPU")
    paths = {"resnet_step": by_tpu_kernel(phase_resnet_step_vs_cpu(torch, modules))}
    phase("phase 14: main path (training runner, ResNet-50, config/test-sync.yml)")
    for dtype, path in (("float32", "resnet"), ("bfloat16", "resnet_bf16")):
        runner, counts, _ = phase_resnet_runner(torch, modules, dtype, tf32_defaults, profile)
        paths[path] = by_tpu_kernel(counts)
        del runner
    phase("phase 15: main path (ResNet-50 through the process loader, exact validation)")
    paths["resnet_process_exact"] = by_tpu_kernel(
        phase_resnet_process_exact(torch, modules, tf32_defaults, profile))
    phase("phase 16: main path (training runner, config/ResNet50-lars8k.yml: LARS, poly, "
        "bf16; then s2d, bf16 statistics, EMA)")
    paths.update(phase_lars(torch, modules, tf32_defaults, profile))
    phase("phase 17: checkpoint, resume and preemption (config/test-sync.yml, f32, EMA)")
    phase_checkpoint(torch, modules)
    return paths


def write_corpus(root: str, vocab: int, seq_len: int, windows: dict, seed: int = 18) -> None:
    """``<root>/{split}.bin`` of uint16 token ids drawn from ``seed``,
    ``windows[split]`` non-overlapping ``seq_len + 1`` windows each, and a
    ``meta.json``."""
    import numpy as np

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for split, n in windows.items():
        rng.integers(0, vocab, n * seq_len + 1).astype(np.uint16).tofile(
            os.path.join(root, f"{split}.bin"))
    with open(os.path.join(root, "meta.json"), "w") as fp:
        json.dump({"dtype": "uint16", "vocab_size": vocab}, fp)


def matmul_ops_on_card(torch) -> dict:
    """The aten ops that ``F.linear`` on a [8, 2048, 1024] bf16 stream
    reaches on the card, with a bias and without, and the matmul ops of one
    fused, flash decoder block's forward: the ``dots`` policy must name
    them all (``SAVED_OPS``), and the flash kernels must reach none."""
    import torch.nn.functional as F
    from torch.utils._python_dispatch import TorchDispatchMode

    from pytorch_distributed_training_tpu_torch.models.transformer_lm import (
        SAVED_OPS,
        DecoderBlock,
    )

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    dev, bf16 = "cuda", torch.bfloat16
    x = torch.randn(8, 2048, 1024, device=dev, dtype=bf16)
    w, b = torch.randn(4096, 1024, device=dev, dtype=bf16), torch.randn(4096, device=dev,
                                                                        dtype=bf16)
    block = DecoderBlock(1024, 16, 4.0, bf16, fused_tails=True, flash=True).to(dev)
    out = {}
    with torch.no_grad():
        for name, fn in (("linear, bias", lambda: F.linear(x, w, b)),
                         ("linear, no bias", lambda: F.linear(x, w)),
                         ("decoder block", lambda: block(x))):
            with Seen() as seen:
                fn()
            out[name] = sorted({str(op) for op in seen.ops if "mm" in str(op)})
            unnamed = [op for op in seen.ops if "mm" in str(op) and op not in SAVED_OPS["dots"]]
            if unnamed:
                raise AssertionError(f"{name} reaches {unnamed}, which dots does not save")
    torch.cuda.synchronize()
    return out


class KeepGrads:
    """An optimizer that keeps a step's reduced gradients and applies
    nothing (phase 18's f32 checks)."""

    def init(self, params):
        from pytorch_distributed_training_tpu_torch.optimizers import SGDState

        return SGDState(momentum=[], step=0)

    def update(self, params, grads, state, lr=None):
        self.grads = [g.detach().clone() for g in grads]
        return state


def accum_and_dots_f32(torch, batch: int = 16, seq: int = 2048, seed: int = 18) -> dict:
    """Phase 18's f32 checks at full width, depth 2, TF32 off, card against
    card: the step over ``batch`` sequences as 2 micro-batches against the
    same step whole (loss rtol 1e-6, each gradient within
    ``ACCUM_GRAD_LIMIT`` of its largest magnitude), and the same
    accumulated step under ``remat: dots`` against it without remat (the
    recompute repeats the same launches on the same inputs: equal bits
    expected; the largest difference printed)."""
    from pytorch_distributed_training_tpu_torch.engine import build_lm_train_step
    from pytorch_distributed_training_tpu_torch.models import TransformerLM

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(seed)
    model = TransformerLM(32768, max_len=seq, embed_dim=1024, depth=2, num_heads=16,
                          fused_tails=True, flash=True).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, 32768, (batch, seq + 1), device="cuda", generator=gen)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    results = {}
    try:
        for name, n, policy in (("whole", 1, None), ("accum", 2, None), ("accum_dots", 2, "dots")):
            model.set_remat(policy is not None, policy or "nothing")
            keep = KeepGrads()
            loss = build_lm_train_step(model, keep, lambda s: 0.0, grad_accum=n)(tokens, labels)
            results[name] = (float(loss), keep.grads)
            del keep
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    (lw, gw), (la, ga), (ld, gd) = results["whole"], results["accum"], results["accum_dots"]
    worst = max(relative_to_largest(a, w) for a, w in zip(ga, gw))
    dots_abs = max((d - a).abs().max().item() for d, a in zip(gd, ga))
    dots_rel = max(relative_to_largest(d, a) for d, a in zip(gd, ga))
    numbers = dict(loss_whole=lw, loss_accum=la, loss_accum_dots=ld,
                   accum_vs_whole_worst_grad=worst, accum_vs_whole_loss_rel=abs(la - lw) / abs(lw),
                   dots_vs_none_max_abs=dots_abs, dots_vs_none_worst_grad=dots_rel,
                   dots_bitwise=all(torch.equal(d, a) for d, a in zip(gd, ga)) and ld == la)
    say(f"  f32, depth 2, {batch} x {seq}, TF32 off: 2 micro-batches vs whole: loss "
        f"{la} vs {lw}, worst gradient {worst:.3e} of its largest (limit "
        f"{ACCUM_GRAD_LIMIT}); dots vs no remat: largest |difference| {dots_abs} "
        f"(bitwise: {numbers['dots_bitwise']})")
    if not abs(la - lw) <= 1e-6 * abs(lw) or worst > ACCUM_GRAD_LIMIT:
        raise AssertionError(f"accumulated step vs whole: {numbers}")
    if dots_rel > ACCUM_GRAD_LIMIT or not abs(ld - la) <= 1e-6 * abs(la):
        raise AssertionError(f"dots step vs no remat: {numbers}")
    del model, results, ga, gw, gd
    torch.cuda.empty_cache()
    return numbers


def remat_forms(torch, batch: int = 8, seq: int = 2048, steps: int = 3, seed: int = 19) -> dict:
    """One LM-1024 training step (full width, bf16, fused tails, flash,
    AdamW) at ``batch`` under ``remat`` none, block, dots and dots_saveable
    in turns (each form twice, in the order there and back), ``steps``
    timed steps a turn after a warm one, each synchronised; the median ms,
    the median host ms (until the step returns, before the synchronise:
    the host's own time when the card keeps up) and
    ``max_memory_allocated`` of each form."""
    import math

    from pytorch_distributed_training_tpu_torch.engine import build_lm_train_step
    from pytorch_distributed_training_tpu_torch.models import TransformerLM
    from pytorch_distributed_training_tpu_torch.optimizers import AdamW

    torch.manual_seed(seed)
    model = TransformerLM(32768, max_len=seq, embed_dim=1024, depth=16, num_heads=16,
                          dtype=torch.bfloat16, fused_tails=True, flash=True).cuda()
    step = build_lm_train_step(model, AdamW(lr=3e-4, weight_decay=0.1), lambda s: 3e-4)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, 32768, (batch, seq + 1), device="cuda", generator=gen)
    forms = [("none", False, "nothing"), ("block", True, "nothing"), ("dots", True, "dots"),
             ("dots_saveable", True, "dots_saveable")]
    times = {name: [] for name, _, _ in forms}
    host = {name: [] for name, _, _ in forms}
    peak = {}
    for name, remat, policy in forms + forms[::-1]:
        model.set_remat(remat, policy)
        step(toks[:, :-1], toks[:, 1:])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = step(toks[:, :-1], toks[:, 1:])
            host[name].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            if not math.isfinite(float(loss)):
                raise AssertionError(f"remat {name}: loss {float(loss)}")
        peak[name] = max(peak.get(name, 0.0), torch.cuda.max_memory_allocated() / 2**30)
    out = {name: dict(median_ms=statistics.median(t), ms=t, peak_gib=peak[name],
                      host_ms=statistics.median(host[name]))
           for name, t in times.items()}
    for name, r in out.items():
        say(f"  remat {name}: step {r['median_ms']} ms (median of {len(r['ms'])}, two turns), "
            f"host {r['host_ms']} ms until the step returns, peak {r['peak_gib']} GiB")
    del model, step
    torch.cuda.empty_cache()
    return out


def optimizer_updates(torch, reps: int = 10, seed: int = 20) -> dict:
    """One LAMB update of the LM-1024's 270.8 M f32 parameters against one
    AdamW update, in turns (AdamW, LAMB, LAMB, AdamW), each the mean of
    ``reps`` updates between CUDA events after two warm ones, on seeded
    parameters and gradients of the model's shapes; with each one's byte
    bound (AdamW reads p, g, m, v and writes p, m, v: 7 passes; LAMB also
    writes and reads its denominator and its direction, and reads p and u
    for the norms: 11 passes)."""
    from pytorch_distributed_training_tpu_torch.models import TransformerLM
    from pytorch_distributed_training_tpu_torch.optimizers import LAMB, AdamW

    shapes = [p.shape for p in TransformerLM(32768, max_len=2048, embed_dim=1024, depth=16,
                                              num_heads=16).parameters()]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = [torch.randn(s, device="cuda", generator=gen) * 0.02 for s in shapes]
    grads = [torch.randn(s, device="cuda", generator=gen) * 1e-3 for s in shapes]
    n = sum(p.numel() for p in params)
    opts = {"AdamW": AdamW(lr=3e-4, weight_decay=0.1), "LAMB": LAMB(lr=3e-4, weight_decay=0.1)}
    ms = {k: [] for k in opts}
    for name in ("AdamW", "LAMB", "LAMB", "AdamW"):
        opt = opts[name]
        state = opt.init(params)
        for _ in range(2):
            state = opt.update(params, grads, state)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            state = opt.update(params, grads, state)
        end.record()
        end.synchronize()
        ms[name].append(start.elapsed_time(end) / reps)
        del state
    if not all(bool(torch.isfinite(p).all()) for p in params):
        raise AssertionError("optimizer updates left non-finite parameters")
    passes = {"AdamW": 7, "LAMB": 11}
    out = {name: dict(ms=statistics.mean(t), turns=t, bound_ms=passes[name] * 4 * n
                      / HBM_BYTES_PER_S * 1e3) for name, t in ms.items()}
    out["parameters"] = n
    say(f"  one update of {n / 1e6:.1f} M f32 parameters: AdamW {out['AdamW']['ms']} ms "
        f"(turns {ms['AdamW']}, bytes bound {out['AdamW']['bound_ms']}), LAMB "
        f"{out['LAMB']['ms']} ms (turns {ms['LAMB']}, bytes bound {out['LAMB']['bound_ms']}); "
        f"LAMB / AdamW {out['LAMB']['ms'] / out['AdamW']['ms']}")
    del params, grads
    torch.cuda.empty_cache()
    return out


def guard_cost(torch, batch: int = 8, seq: int = 2048, steps: int = 4, seed: int = 21) -> dict:
    """The anomaly guard's cost: LM-1024 steps (bf16, no remat, AdamW) at
    ``batch`` with the guard armed against without, in turns (without,
    with, with, without), ``steps`` steps back to back a turn after a warm
    one, synchronised at the end only: the guard's per-step host read
    holds the host until the backward is done, where the plain step
    queues the optimizer behind it."""
    import math

    from pytorch_distributed_training_tpu_torch.engine import build_lm_train_step
    from pytorch_distributed_training_tpu_torch.models import TransformerLM
    from pytorch_distributed_training_tpu_torch.optimizers import AdamW

    torch.manual_seed(seed)
    model = TransformerLM(32768, max_len=seq, embed_dim=1024, depth=16, num_heads=16,
                          dtype=torch.bfloat16, fused_tails=True, flash=True).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, 32768, (batch, seq + 1), device="cuda", generator=gen)
    tok, lab = toks[:, :-1], toks[:, 1:]
    plain = build_lm_train_step(model, AdamW(lr=3e-4, weight_decay=0.1), lambda s: 3e-4)
    guarded = build_lm_train_step(model, AdamW(lr=3e-4, weight_decay=0.1), lambda s: 3e-4,
                                  anomaly_factor=10.0)
    calls = {"plain": lambda: plain(tok, lab),
             "guarded": lambda: guarded(tok, lab, 0.0)[0]}
    ms = {k: [] for k in calls}
    for name in ("plain", "guarded", "guarded", "plain"):
        calls[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [calls[name]() for _ in range(steps)]
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / steps)
        if not all(math.isfinite(float(x)) for x in losses):
            raise AssertionError(f"guard cost ({name}): losses {losses}")
    out = {k: dict(ms_per_step=statistics.mean(v), turns=v) for k, v in ms.items()}
    out["guarded_over_plain"] = out["guarded"]["ms_per_step"] / out["plain"]["ms_per_step"]
    say(f"  guard: {out['guarded']['ms_per_step']} ms a step armed (turns {ms['guarded']}) "
        f"against {out['plain']['ms_per_step']} ms (turns {ms['plain']}): "
        f"{out['guarded_over_plain']}x")
    del model, plain, guarded
    torch.cuda.empty_cache()
    return out


def phase_lm_accum(torch, modules) -> dict:
    """Phase 18: ``configs/train-lm-1024-accum.yml`` (LM-1024, batch 64 as 8
    micro-batches of 8 x 2048, a ``tokens`` file, ``remat: dots``, the
    anomaly guard armed) for 3 steps and one validation of 2 batches of 64,
    over a corpus written here (``TOKENS_DIR``; vocab 32768, uint16), the
    config's checkpoint dropped in memory; per step exactly 8 K1a and 8 K1b
    (one a micro-batch), 8 x 2 x 16 K2c launches, and K2a, K3 and K4 each 8
    x 2 x 16 (every block's forward run again by the recompute).  Before
    it: the matmul ops ``F.linear`` reaches on the card, and the f32 checks
    of :func:`accum_and_dots_f32`; after it, the remat forms, LAMB against
    AdamW and the guard's cost.  Returns the launch counts and the numbers."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg

    say(f"  F.linear and a decoder block on the card reach: {matmul_ops_on_card(torch)}")
    checks = accum_and_dots_f32(torch)
    cfg = get_cfg(ACCUM_CONFIG)
    depth, n = cfg["model"]["depth"], cfg["training"]["grad_accumulation"]
    batch, seq = cfg["training"]["batch_size"], cfg["dataset"]["seq_len"]
    write_corpus(TOKENS_DIR, cfg["dataset"]["n_classes"], seq,
                 {"train": 4 * batch, "val": 2 * batch})

    def edit(c):
        c["dataset"]["root"] = TOKENS_DIR
        c["training"].pop("checkpoint", None)

    per_micro = 2 * depth  # each block's forward twice (the recompute), its backward once
    runner, counts, accum = phase_runner(
        torch, modules, ACCUM_CONFIG, "train-lm-1024-accum", steps=3, edit=edit,
        per_step=dict(ce_fwd=n, ce_bwd=n, flash_fwd=n * per_micro, flash_bwd=n * 2 * depth,
                      K2a=n * per_micro, K2c=n * 2 * depth, add_layernorm=n * per_micro,
                      bias_gelu=n * per_micro),
        # validation runs a batch as the step's n micro-batches
        per_val_batch=dict(ce_fwd=n, flash_fwd=n * depth, K2a=n * depth,
                           add_layernorm=n * depth, bias_gelu=n * depth))
    if runner.model.remat_policy != "dots" or runner.train_step.grad_accum != n or not (
            runner.anomaly_enabled and runner._consec_anomalies == 0):
        raise AssertionError("phase 18 did not run the accumulated, dots, guarded path")
    say(f"  {n} micro-batches of {batch // n} x {seq} a step, remat dots, guard armed: "
        f"{len(runner._gnorm_hist)} applied steps, gradient norms {list(runner._gnorm_hist)}")
    del runner
    torch.cuda.empty_cache()
    numbers = dict(f32=checks, runner=accum, remat=remat_forms(torch),
                   optimizers=optimizer_updates(torch), guard=guard_cost(torch))
    say("lm_accum: " + json.dumps(numbers))
    return counts


def phase_faults(torch) -> dict:
    """Phase 19: ResNet-50 under injected faults on ``config/test-sync.yml``
    (f32, the EMA, 2-batch epochs unless stated, deterministic algorithms
    as in phase 17), each run in its own directory under ``FAULTS_DIR``:
    (a) ``nan_batch@1``: step 1 skipped, the state after it bitwise the
    state before it; (b) ``nan_batch@2;3;4`` with ``max_consecutive: 3``
    and a save every 2 steps: one rollback, 6 iterations and 4 applied
    steps, the final state bitwise that of a run of ``nan_batch@2;3``;
    (c) ``ckpt_fail@0:2`` with ``retry``: 2 retries, the final state
    bitwise a clean run's; (d) ``kill_worker@2`` through the process loader
    (8 workers, 4-batch epochs, 10 steps): one respawn, every batch and
    loss bitwise the clean run's; (e) ``stall_step@5:3`` with the watchdog
    (factor 2, ``min_seconds`` 1, warm-up 3): it fires once.  Prints the
    counters of each and the seconds the rollback took."""
    import shutil

    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg
    from pytorch_distributed_training_tpu_torch.engine import Runner, fault

    class Recording(Runner):
        """Keeps each step's batch sum and loss (host reads, one a step)."""

        def train_iter(self, inputs, labels):
            self.batch_sums = getattr(self, "batch_sums", [])
            self.batch_sums.append(float(inputs.double().sum()))
            super().train_iter(inputs, labels)

    def run(sub, iters, spec=None, anomaly=None, ckpt_every=None, retry=None, watchdog=None,
            n_batches=2, **training):
        cfg = get_cfg(RESNET_CONFIG)
        cfg["training"].update(train_iters=iters, print_interval=1, dtype="float32",
                               ema={"decay": 0.999}, **training)
        cfg["dataset"]["n_samples"] = n_batches * cfg["training"]["batch_size"]
        ft = {k: v for k, v in (("anomaly", anomaly), ("watchdog", watchdog),
                                ("fault_spec", spec)) if v is not None}
        if ft:
            cfg["training"]["fault_tolerance"] = ft
        if ckpt_every is not None:
            cfg["training"]["checkpoint"] = {"dir": os.path.join(FAULTS_DIR, sub),
                                             "interval": ckpt_every,
                                             **({"retry": retry} if retry else {})}
        snaps, losses = {}, {}

        def on_iter(runner):
            losses[runner.iter] = float(runner.last_loss)
            if sub == "a" and runner.iter in (0, 1):
                snaps[runner.iter] = state(runner)

        fault.reset_counters()
        runner = Recording(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                           logger_queue=None, global_cfg=cfg, device="cuda", on_iter=on_iter)
        runner()
        torch.cuda.synchronize()
        return runner, fault.counters(), snaps, losses

    def state(runner):
        step = runner.train_step
        return dict(model={k: v.detach().clone() for k, v in runner.model.state_dict().items()},
                    momentum=[t.clone() for t in step.opt_state.momentum],
                    ema=[t.clone() for t in step.ema], step=step.opt_state.step)

    def differs(a, b):
        bad = [k for k, v in a["model"].items() if not torch.equal(v, b["model"][k])]
        bad += [f"momentum[{i}]" for i, (x, y) in enumerate(zip(a["momentum"], b["momentum"]))
                if not torch.equal(x, y)]
        bad += [f"ema[{i}]" for i, (x, y) in enumerate(zip(a["ema"], b["ema"]))
                if not torch.equal(x, y)]
        return bad + (["optimizer step"] if a["step"] != b["step"] else [])

    shutil.rmtree(FAULTS_DIR, ignore_errors=True)
    anomaly = {"enabled": True, "max_consecutive": 3}
    out = {}
    with deterministic(torch):
        a, ca, snaps, _ = run("a", 3, "nan_batch@1", anomaly={"enabled": True})
        bad = differs(snaps[0], snaps[1])
        if bad or ca.get("skipped_steps") != 1 or a.train_step.opt_state.step != 2:
            raise AssertionError(f"(a) NaN step: differs in {bad[:10]}, counters {ca}")
        out["a"] = ca
        say(f"  (a) nan_batch@1: step 1 skipped; parameters, BatchNorm buffers, momentum, EMA "
            f"and optimizer step bitwise unchanged; counters {ca}")

        b, cb, _, _ = run("b", 6, "nan_batch@2;nan_batch@3;nan_batch@4", anomaly=anomaly,
                          ckpt_every=2)
        b0, cb0, _, _ = run("b0", 6, "nan_batch@2;nan_batch@3", anomaly=anomaly)
        bad = differs(state(b), state(b0))
        if (bad or cb.get("rollbacks") != 1 or cb.get("skipped_steps") != 3 or b.iter != 6
                or b.train_step.opt_state.step != 4 or "rollbacks" in cb0):
            raise AssertionError(f"(b) rollback: differs in {bad[:10]}, counters {cb}, "
                                 f"iter {b.iter}, step {b.train_step.opt_state.step}")
        out["b"] = dict(counters=cb, rollback_s=b.rollback_seconds,
                        restore_ms=b.checkpointer.last_restore["seconds"] * 1e3)
        say(f"  (b) burst at 2-4: one rollback to the save of step 3 in "
            f"{b.rollback_seconds[0] * 1e3} ms (restore "
            f"{out['b']['restore_ms']} ms), 6 iterations, 4 applied; the final state bitwise "
            f"the skip-only run's; counters {cb}")

        retry = {"attempts": 3, "backoff": 0.0, "jitter": 0.0}
        c, cc, _, _ = run("c", 4, "ckpt_fail@0:2", ckpt_every=2, retry=retry)
        c0, _, _, _ = run("c0", 4, ckpt_every=2)
        bad = differs(state(c), state(c0))
        if bad or cc.get("ckpt_retries") != 2 or c.checkpointer.retries != 2:
            raise AssertionError(f"(c) ckpt_fail: differs in {bad[:10]}, counters {cc}")
        out["c"] = cc
        say(f"  (c) ckpt_fail@0:2: 2 retries, saves {c.checkpointer.all_steps()}, the final "
            f"state bitwise the clean run's; counters {cc}")

        d0, _, _, ld0 = run("d0", 10, worker_mode="process", n_batches=4)
        d, cd, _, ld = run("d", 10, "kill_worker@2", worker_mode="process", n_batches=4)
        if (cd.get("worker_respawns") != 1 or d.batch_sums != d0.batch_sums or ld != ld0):
            raise AssertionError(f"(d) kill_worker: counters {cd}, batches {d.batch_sums} vs "
                                 f"{d0.batch_sums}, losses {ld} vs {ld0}")
        out["d"] = cd
        say(f"  (d) kill_worker@2 (process loader, 8 workers): one respawn, every batch and "
            f"loss bitwise the clean run's; counters {cd}")

        watchdog = {"factor": 2.0, "min_seconds": 1.0, "poll_seconds": 0.05, "warmup": 3}
        e, ce, _, _ = run("e", 7, "stall_step@5:3.0", watchdog=watchdog)
        if e._watchdog.fires != 1 or ce.get("watchdog_fires") != 1:
            raise AssertionError(f"(e) stall: {e._watchdog.fires} fires, counters {ce}")
        out["e"] = dict(counters=ce, trailing_median_s=e._watchdog.trailing_median())
        say(f"  (e) stall_step@5:3.0 past the warm-up: the watchdog fired once; counters {ce}")
    say("faults: " + json.dumps(out))
    return out


def phase_accum_and_faults(torch, modules) -> dict:
    """Phases 18 and 19; returns the launch counts by path."""
    phase("phase 18: main path (training runner, configs/train-lm-1024-accum.yml: batch 64 "
        "as 8 micro-batches, tokens file, remat dots, guard armed)")
    counts = phase_lm_accum(torch, modules)
    phase("phase 19: fault tolerance (config/test-sync.yml, ResNet-50, f32, injected faults)")
    phase_faults(torch)
    return {"lm_accum": by_tpu_kernel(counts)}


# --------------------------------------------------------------------- #
# phase 20: the serving scheduler


def sched_requests(np, vocab: int, n: int = 32, seed: int = 20):
    """Phase 20's requests: prompt lengths in [1, 512], caps in [1, 32];
    every 4th prompt is a shared 256-token prefix and a tail of 1-256."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 256)
    prompts, caps = [], []
    for i in range(n):
        if i % 4 == 0:
            p = np.concatenate([prefix, rng.integers(0, vocab, int(rng.integers(1, 257)))])
        else:
            p = rng.integers(0, vocab, int(rng.integers(1, 513)))
        prompts.append(p.astype(np.int32))
        caps.append(int(rng.integers(1, 33)))
    return prompts, caps


def serve_trace(submit, prompts, caps, keys, timeout: float = 600.0, adapters=None):
    """Submit every request at once; returns (results, TTFT ms of each,
    wall s).  The first token's time is the host's, in ``on_token``.
    ``adapters``: each request's LoRA adapter (``None``: the base model)."""
    first, sent, futs = {}, {}, []
    t0 = time.perf_counter()
    for i, (p, c, k) in enumerate(zip(prompts, caps, keys)):
        sent[i] = time.perf_counter()
        extra = {} if adapters is None else {"adapter": adapters[i]}
        futs.append(submit(p, max_new_tokens=c, key=k, **extra,
                           on_token=lambda tok, i=i: first.setdefault(i, time.perf_counter())))
    results = [f.result(timeout=timeout) for f in futs]
    wall = time.perf_counter() - t0
    return results, [(first[i] - sent[i]) * 1e3 for i in range(len(futs))], wall


def batcher_trace(engine, prompts, caps, timeout: float = 600.0):
    """The batcher's counterpart of :func:`serve_trace`: its first token
    comes with the whole result, so its TTFT is its latency."""
    done, sent, futs = {}, {}, []
    t0 = time.perf_counter()
    for i, (p, c) in enumerate(zip(prompts, caps)):
        sent[i] = time.perf_counter()
        fut = engine.submit(p, max_new_tokens=c)
        fut.add_done_callback(lambda f, i=i: done.setdefault(i, time.perf_counter()))
        futs.append(fut)
    results = [f.result(timeout=timeout) for f in futs]
    wall = time.perf_counter() - t0
    return results, [(done[i] - sent[i]) * 1e3 for i in range(len(futs))], wall


def sched_on(engine, **kw):
    """A scheduler over ``engine``'s model with the config's pool; ``kw``
    overrides (``temperature``, ``async_depth``, ``start``, ...)."""
    from pytorch_distributed_training_tpu_torch.serving import ContinuousScheduler

    sc = engine.scheduler
    args = dict(slots=sc.slots_n, block_size=sc._block_size, num_blocks=sc._num_blocks,
                prefix_cache=sc._prefix_cache, batch_buckets=engine.batch_buckets,
                seq_buckets=engine.seq_buckets, max_new_tokens=engine.max_new_tokens,
                temperature=0.0, eos_id=None)
    args.update(kw)
    return ContinuousScheduler(engine.model, **args)


def tokens_of(results):
    return [r["tokens"].tolist() for r in results]


def trace_readings(what: str, results, ttft, wall, snap, smi: str) -> dict:
    gen = sum(r["gen_len"] for r in results)
    row = dict(ttft_ms_p50=statistics.median(ttft),
               ttft_ms_p99=sorted(ttft)[min(len(ttft) - 1, int(0.99 * len(ttft)))],
               tokens_per_s=gen / wall, wall_s=wall, generated=gen)
    for key in ("decode_tokens_per_sec", "prefill_tokens_per_sec", "slot_occupancy_mean",
                "block_util_mean", "block_util_max", "prefix_hit_rate", "tick_host_ms_p50",
                "tick_host_ms_mean", "decode_dispatch_gap_ms_p50", "latency_ms_p50",
                "latency_ms_p99", "batches"):
        if key in snap:
            row[key] = snap[key]
    say(f"  reading {what} ({smi}): " + json.dumps(row))
    return row


def drive_ticks(torch, sched, futs, limit: int = 400):
    """Tick a hand-driven scheduler until every future is done; the ms of
    each tick (synchronised), the pool's accounting checked each time."""
    ticks = []
    while any(not f.done() for f in futs):
        t0 = time.perf_counter()
        sched.tick()
        torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t0) * 1e3)
        sched._kv.check_invariants()
        if len(ticks) > limit:
            raise AssertionError("scheduler failed to drain")
    return ticks


def phase_serve_resilience(torch, engine, prompts, caps, keys) -> dict:
    """Phase 20 (d): 8 requests, all admitted at tick 1, under each fault
    against the same requests run clean."""
    from pytorch_distributed_training_tpu_torch.engine import fault
    from pytorch_distributed_training_tpu_torch.serving import PoisonedRequestError
    from pytorch_distributed_training_tpu_torch.telemetry.spans import get_recorder

    restart_ms = []

    def run(spec):
        fault.install(spec)
        try:
            sched = sched_on(engine, start=False)
            rebuild = sched._rebuild_and_requeue

            def timed_rebuild():
                # the restart's span closes on the host before the card has
                # zeroed the new pool: read it here with the device work in
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rebuild()
                torch.cuda.synchronize()
                restart_ms.append((time.perf_counter() - t0) * 1e3)

            sched._rebuild_and_requeue = timed_rebuild
            futs = [sched.submit(p, max_new_tokens=c, key=k)
                    for p, c, k in zip(prompts, caps, keys)]
            ticks = drive_ticks(torch, sched, futs)
            sched.close()
        finally:
            fault.install(None)
        # every request released its blocks: what is left is the prefix
        # cache's alone
        kv = sched._kv
        if any(n != 1 for n in kv._ref.values()) or set(kv._ref) != set(kv._cache.values()):
            raise AssertionError(f"{spec}: blocks held past the run")
        return sched, futs, ticks

    _, ref_futs, clean_ticks = run(None)
    ref = [f.result()["tokens"].tolist() for f in ref_futs]
    out = {}
    # device loss at tick 5: one restart, every stream replayed to the same tokens
    sched, futs, ticks = run("serve_device_lost@5")
    got = [f.result()["tokens"].tolist() for f in futs]
    snap = sched.metrics.snapshot()
    if sched._supervisor.restarts() != 1 or got != ref:
        raise AssertionError(f"serve_device_lost: restarts {sched._supervisor.restarts()}, "
                             f"streams equal {got == ref}")
    if snap.get("replay_parity_mismatch", 0):
        raise AssertionError(f"replay_parity_mismatch {snap['replay_parity_mismatch']}")
    span_ms = [r["ms"] for r in get_recorder().recent() if r["kind"] == "serving_restart"]
    out["device_lost"] = dict(restart_ms=restart_ms[-1], restart_host_span_ms=span_ms[-1],
                              fault_tick_ms=ticks[4], replay_tick_ms=ticks[5],
                              clean_tick_ms=clean_ticks[4:6],
                              replayed_tokens=snap["replayed_tokens"])
    say(f"  (d) serve_device_lost@5: 1 restart, {snap['replayed_tokens']} tokens replayed, "
        f"streams equal; restart {restart_ms[-1]} ms (synchronised; host span "
        f"{span_ms[-1]} ms), fault tick {ticks[4]} ms, "
        f"replay tick {ticks[5]} ms (clean ticks 5-6: {clean_ticks[4:6]} ms)")
    # NaN in the slot of a request still decoding at tick 4; raise in another
    long = [i for i, c in enumerate(caps) if c >= 8]
    for kind, tick, slot in (("serve_nan", 4, long[0]), ("serve_raise", 3, long[-1])):
        sched, futs, _ = run(f"{kind}@{tick}:{slot}")
        failed = [i for i, f in enumerate(futs) if f.exception() is not None]
        if failed != [slot] or not isinstance(futs[slot].exception(), PoisonedRequestError):
            raise AssertionError(f"{kind}: failed {failed}, want [{slot}]")
        rest = [(i, f.result()["tokens"].tolist()) for i, f in enumerate(futs) if i != slot]
        if any(t != ref[i] for i, t in rest) or sched._supervisor.restarts():
            raise AssertionError(f"{kind}: the other streams differ from the clean run")
        out[kind] = dict(slot=slot, probes=sched.metrics.snapshot().get("poison_probes", 0))
        say(f"  (d) {kind}@{tick}:{slot}: only request {slot} failed "
            f"({type(futs[slot].exception()).__name__}), 7 streams equal the clean run, "
            f"{out[kind]['probes']} probes")
    return out


def phase_serve_ckpt(torch, np) -> dict:
    """Phase 20 (e): a port training checkpoint served through
    ``serving.checkpoint``."""
    import shutil

    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg, get_serve_cfg
    from pytorch_distributed_training_tpu_torch.engine import Runner
    from pytorch_distributed_training_tpu_torch.engine.checkpoint import Checkpointer
    from pytorch_distributed_training_tpu_torch.serving import InferenceEngine

    shutil.rmtree(SERVE_CKPT_DIR, ignore_errors=True)
    cfg = get_cfg(TRAIN_CONFIG)
    cfg["model"]["depth"] = 2
    cfg["training"].update(train_iters=2, print_interval=1, val_interval=100,
                           checkpoint={"dir": SERVE_CKPT_DIR, "interval": 1})
    cfg["dataset"]["n_samples"] = 2 * cfg["training"]["batch_size"]
    t0 = time.perf_counter()
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=None, global_cfg=cfg, device="cuda")
    runner()
    train_s = time.perf_counter() - t0
    # the runner keeps an EMA on the image task only (as the JAX package's
    # engine/topology.py:351): the phase writes the EMA of its two steps'
    # weights (decay 0.9) into a third step, as an image run's payload holds it
    ck = Checkpointer(SERVE_CKPT_DIR)
    steps = ck.all_steps()
    load = [torch.load(os.path.join(SERVE_CKPT_DIR, str(s), "state.pt"), map_location="cpu",
                       weights_only=True) for s in steps[-2:]]
    names = [n for n, _ in runner.model.named_parameters()]
    ema = {n: 0.9 * load[0]["model"][n] + 0.1 * load[1]["model"][n] for n in names}
    ck.save(steps[-1] + 1, {"iter": steps[-1] + 1, "model": load[1]["model"],
                            "optimizer": load[1]["optimizer"], "ema": ema})
    scfg = get_serve_cfg(SCHED_CONFIG)
    scfg["model"]["depth"] = 2
    prompts, caps = sched_requests(np, scfg["dataset"]["n_classes"], n=8, seed=21)
    keys = [(1, i) for i in range(8)]
    out = []
    for how in ("checkpoint", "memory"):
        c = json.loads(json.dumps(scfg))
        state = None
        if how == "checkpoint":
            c["serving"]["checkpoint"] = SERVE_CKPT_DIR
        else:
            state = {**load[1]["model"], **ema}
        with InferenceEngine.from_config(c, state_dict=state) as eng:
            out.append(tokens_of(serve_trace(eng.submit, prompts, caps, keys)[0]))
    if out[0] != out[1]:
        raise AssertionError("serving.checkpoint: greedy tokens differ from the in-memory EMA")
    raw = {**load[1]["model"]}
    with InferenceEngine.from_config(json.loads(json.dumps(scfg)), state_dict=raw) as eng:
        raw_tokens = tokens_of(serve_trace(eng.submit, prompts, caps, keys)[0])
    size = os.path.getsize(os.path.join(SERVE_CKPT_DIR, str(steps[-1] + 1), "state.pt"))
    say(f"  (e) trained 2 steps (depth 2) in {train_s:.1f} s, steps {ck.all_steps()}, "
        f"{size} bytes a step; served from serving.checkpoint (EMA, iter {steps[-1] + 1}): "
        f"8 greedy streams equal the in-memory EMA engine's; raw weights' streams differ: "
        f"{out[0] != raw_tokens}")
    shutil.rmtree(SERVE_CKPT_DIR, ignore_errors=True)
    return dict(train_s=train_s, bytes=size)


def phase_serve_sched(torch, np, modules, fe, smi: str, profile: bool):
    """Phase 20; returns the launch counts of (a), and (a)'s trace with its
    readings and streams for phase 21."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_serve_cfg
    from pytorch_distributed_training_tpu_torch.serving import InferenceEngine

    t_phase = time.perf_counter()
    cfg = get_serve_cfg(SCHED_CONFIG)
    serve, depth = cfg["serving"], cfg["model"]["depth"]
    vocab = cfg["dataset"]["n_classes"]
    # (a) the main path
    t0 = time.perf_counter()
    engine = InferenceEngine.from_config(cfg)
    sc = engine.scheduler
    pool_bytes = sum(t.numel() * t.element_size() for t in sc._pool.keys + sc._pool.values)
    say(f"  (a) engine built in {time.perf_counter() - t0:.1f} s on {engine.device}; pool "
        f"{sc._num_blocks} x {sc._block_size} rows, {pool_bytes / 2**20:.1f} MiB")
    warm = engine.warmup()
    say(f"  warmup: {warm['warmup_ms']:.0f} ms over {warm['pairs']:.0f} bucket pairs")
    prompts, caps = sched_requests(np, vocab)
    keys = [(serve["seed"], 20, i) for i in range(len(prompts))]
    for m in modules:
        m.reset_launch_counts()
    calls0 = sc.calls()
    torch.cuda.reset_peak_memory_stats()
    res, ttft, wall = serve_trace(engine.submit, prompts, caps, keys)
    counts = all_counts(modules)
    calls = {k: v - calls0[k] for k, v in sc.calls().items()}
    snap = engine.snapshot()
    for r, c in zip(res, caps):
        t = r["tokens"]
        if r["gen_len"] != c or t.shape != (c,) or t.min() < 0 or t.max() >= vocab:
            raise AssertionError(f"request: gen_len {r['gen_len']} (cap {c}), tokens {t}")
    if not snap["retired"] == snap["admitted"] == len(prompts):
        raise AssertionError(f"retired {snap['retired']}, admitted {snap['admitted']}")
    if not snap.get("prefix_hit_blocks"):
        raise AssertionError("the prefix cache never hit")
    n_calls = sum(calls.values())
    want = {k: depth * n_calls for k in fe.KERNELS}
    check_launches("serving scheduler", counts, want)
    say(f"  (a) 32 requests: retired = admitted = 32, prefix-hit blocks "
        f"{snap['prefix_hit_blocks']}; calls {calls}; launches "
        f"{ {k: counts[k] for k in fe.KERNELS} } = {depth} x {n_calls}; no other kernel; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    readings = {"sync": trace_readings("scheduler sync", res, ttft, wall, snap, smi)}
    sync_tokens = tokens_of(res)

    # (b) greedy identity with the batcher: depth 2, f32, TF32 off
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    small = []
    for path in (CONFIG, SCHED_CONFIG):
        c = get_serve_cfg(path)
        c["model"]["depth"], c["serving"]["dtype"] = 2, "float32"
        small.append(c)
    with InferenceEngine.from_config(small[0]) as eb:
        with InferenceEngine.from_config(small[1], state_dict=eb.model.state_dict()) as es:
            b8 = [tokens_of(batcher_trace(eb, prompts[:8], caps[:8])[0]),
                  tokens_of(serve_trace(es.submit, prompts[:8], caps[:8], keys[:8])[0])]
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if b8[0] != b8[1]:
        raise AssertionError("f32 depth 2: the scheduler's greedy tokens differ from the batcher's")
    with InferenceEngine.from_config(get_serve_cfg(CONFIG),
                                     state_dict=engine.model.state_dict()) as eb:
        eb.warmup()
        bres, blat, bwall = batcher_trace(eb, prompts, caps)
        bsnap = eb.snapshot()
    same = sum(a == b for x, y in zip(tokens_of(bres), sync_tokens) for a, b in zip(x, y))
    share = same / sum(caps)
    say(f"  (b) f32 depth 2, TF32 off: 8 greedy streams through the batcher and the scheduler "
        f"identical; bf16 full depth: {same} of {sum(caps)} tokens identical ({share})")
    readings["batcher"] = trace_readings("batcher (serve-lm-1024.yml, same trace)", bres,
                                         blat, bwall, bsnap, smi)
    readings["bf16_identical_share"] = share

    # (c) async against sync, greedy and sampled
    streams = {}
    for temp in (0.0, 0.8):
        for depth_a in (0, 2):
            if temp == 0.0 and depth_a == 0:
                streams[(temp, 0)] = sync_tokens
                continue
            sched = sched_on(engine, temperature=temp, async_depth=depth_a)
            r, t, w = serve_trace(sched.submit, prompts, caps, keys)
            streams[(temp, depth_a)] = tokens_of(r)
            if temp == 0.0:
                readings["async2"] = trace_readings("scheduler async_depth 2", r, t, w,
                                                    sched.metrics.snapshot(), smi)
            sched.close()
        if streams[(temp, 0)] != streams[(temp, 2)]:
            raise AssertionError(f"async_depth 2 differs from sync at temperature {temp}")
    say("  (c) async_depth 2 against 0 on (a)'s 32 requests: bitwise equal, greedy and sampled")

    # (d) resilience; (e) P7a
    readings["resilience"] = phase_serve_resilience(torch, engine, prompts[:8], caps[:8],
                                                    keys[:8])
    readings["checkpoint"] = phase_serve_ckpt(torch, np)
    if profile:
        say("== profile (phase 20: 16 decode ticks, 8 slots, sync and async_depth 2)")
        for depth_a in (0, 2):
            sched = sched_on(engine, async_depth=depth_a, start=False)
            for p, k in zip(prompts[:8], keys[:8]):
                sched.submit(p, key=k)
            sched.tick()
            sched.tick()
            profile_window(torch, f"decode ticks async_depth {depth_a}",
                           lambda s=sched: [s.tick() for _ in range(16)], 10)
            sched.close()
    engine.close()
    engine = None
    torch.cuda.empty_cache()
    readings["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 20 took {readings['phase_s']:.1f} s")
    say("serving_sched: " + json.dumps(readings))
    return counts, dict(prompts=prompts, caps=caps, keys=keys, tokens=sync_tokens,
                        readings=readings["sync"])


# phase 21: the scheduler's decode modes

# each mode's keys: JAX config/serve-lm.yml's commented example
MODE_KEYS = {
    "quant": {"quant": {"enabled": True}},
    "lora": {"lora": {"enabled": True, "rank": 8,
                      "adapters": [{"name": "tenant-a", "seed": 0},
                                   {"name": "tenant-b", "seed": 1}]}},
    "self_draft": {"speculative": {"enabled": True, "k": 4, "min_acceptance": 0.2}},
    "draft": {"speculative": {"enabled": True, "k": 4, "draft": {"depth": 1}, "draft_seed": 0,
                              "min_acceptance": 0.2}},
}
# the mixed trace of (b): tenant-a, base and tenant-b rows in every decode batch
ADAPTER_CYCLE = ("tenant-a", None, "tenant-b")
# (b): the JAX oracle's scale of the factors (tests/test_serving.py:1035-1045)
# when the random delta flips no token
LORA_SCALE = 30.0


def mode_cfg(mode=None, depth=None, dtype=None) -> dict:
    """``configs/serve-lm-1024-sched.yml`` with ``mode``'s keys, cut to
    ``depth`` and served in ``dtype`` where given."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_serve_cfg

    cfg = get_serve_cfg(SCHED_CONFIG)
    if mode is not None:
        cfg["serving"].update(json.loads(json.dumps(MODE_KEYS[mode])))
    if depth is not None:
        cfg["model"]["depth"] = depth
    if dtype is not None:
        cfg["serving"]["dtype"] = dtype
    return cfg


def mode_gates(torch, plain: dict) -> dict:
    """Phase 21's gates: f32, full width, depth 2, TF32 off, 8 requests of
    phase 20's trace (with (b)'s adapters cycling)."""
    from pytorch_distributed_training_tpu_torch.serving import InferenceEngine

    p8, c8, k8 = plain["prompts"][:8], plain["caps"][:8], plain["keys"][:8]
    mixed = [ADAPTER_CYCLE[i % 3] for i in range(8)]

    def engine(mode=None, **kw):
        return InferenceEngine.from_config(mode_cfg(mode, depth=2, dtype="float32"), **kw)

    def run(e, adapters=None):
        return tokens_of(serve_trace(e.submit, p8, c8, k8, adapters=adapters)[0])

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        with engine() as e:
            base = run(e)
        # (a) the card's int8 streams against the port's own on the CPU
        with engine("quant") as e:
            card = run(e)
        with engine("quant", device="cpu") as e:
            cpu = run(e)
        if card != cpu:
            raise AssertionError("(a) int8: the card's greedy streams differ from the CPU's")
        out["quant_same_as_plain"] = sum(a == b for x, y in zip(card, base) for a, b in zip(x, y))
        say(f"  (a) gate: 8 int8 greedy streams on the card equal the CPU's "
            f"({out['quant_same_as_plain']} of {sum(c8)} tokens equal the plain engine's)")
        # (b) each tenant against a merged-weights engine, base rows against plain
        for scale in (1.0, LORA_SCALE):
            # a fresh engine each time: its prefix cache holds no K/V of
            # other factors
            with engine("lora") as e:
                with torch.no_grad():
                    for name, p in e.model.named_parameters():
                        if "_lora_" in name:
                            p.mul_(scale)
                got = run(e, mixed)
                state = {k: v.detach().clone() for k, v in e.model.state_dict().items()}
                reg = e.lora_registry
            if any(got[i] != base[i] for i in range(8) if mixed[i] is not None):
                break
        for name in ("tenant-a", "tenant-b"):
            with engine(state_dict=reg.merged_params(state, name)) as m:
                ref = run(m)
            if any(got[i] != ref[i] for i in range(8) if mixed[i] == name):
                raise AssertionError(f"(b) {name}: streams differ from the merged-weights engine")
        if any(got[i] != base[i] for i in range(8) if mixed[i] is None):
            raise AssertionError("(b) base rows differ from the plain engine")
        flipped = sum(got[i] != base[i] for i in range(8) if mixed[i] is not None)
        if not flipped:
            raise AssertionError("(b) no tenant stream differs from the base model's")
        out["lora_scale"], out["lora_rows_flipped"] = scale, flipped
        say(f"  (b) gate: tenant rows equal their merged-weights (W + A B) engines, base rows "
            f"the plain engine; factors x{scale}, {flipped} of 5 tenant streams differ from base")
        # (c), (d): greedy streams equal plain greedy
        for mode in ("self_draft", "draft"):
            with engine(mode) as e:
                got = run(e)
                snap = e.snapshot()
            if got != base:
                raise AssertionError(f"({mode}) streams differ from plain greedy")
            rate = snap["spec_acceptance_rate"]
            if mode == "self_draft" and rate != 1.0:
                raise AssertionError(f"(c) self-draft acceptance {rate}, want 1.0")
            out[f"{mode}_acceptance"] = rate
            say(f"  ({'c' if mode == 'self_draft' else 'd'}) gate: {mode} streams equal plain "
                f"greedy; acceptance {rate}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


def mode_reading(torch, modules, fe, smi: str, mode: str, plain: dict,
                 profile: bool = False) -> dict:
    """One mode at bf16, full depth, on phase 20's 32 requests: every
    request its cap, K3/K4 launched exactly depth x each model's paged
    calls, and the readings beside phase 20's plain ones.  ``profile``:
    then 8 decode ticks (4 speculative rounds) of 8 full slots under
    ``torch.profiler``."""
    from pytorch_distributed_training_tpu_torch.serving import InferenceEngine

    prompts, caps, keys = plain["prompts"], plain["caps"], plain["keys"]
    adapters = [ADAPTER_CYCLE[i % 3] for i in range(len(prompts))] if mode == "lora" else None
    t0 = time.perf_counter()
    engine = InferenceEngine.from_config(mode_cfg(mode))
    build_s = time.perf_counter() - t0
    with engine:
        engine.warmup()
        sc = engine.scheduler
        for m in modules:
            m.reset_launch_counts()
        calls0 = sc.calls()
        res, ttft, wall = serve_trace(engine.submit, prompts, caps, keys, adapters=adapters)
        counts = all_counts(modules)
        calls = {k: v - calls0[k] for k, v in sc.calls().items()}
        snap = engine.snapshot()
        for r, c in zip(res, caps):
            if r["gen_len"] != c:
                raise AssertionError(f"{mode}: gen_len {r['gen_len']} (cap {c})")
        paged = ("prefill", "decode_step", "decode_step_fed", "verify")
        depth = engine.model.depth
        draft = sc._spec.draft_model if sc._spec is not None else None
        ddepth = depth if sc._spec is not None and draft is None else getattr(draft, "depth", 0)
        n = depth * sum(calls[k] for k in paged) + ddepth * sum(
            calls.get(f"draft_{k}", 0) for k in paged)
        check_launches(f"serving mode {mode}", counts, {k: n for k in fe.KERNELS})
        row = trace_readings(f"mode {mode}", res, ttft, wall, snap, smi)
        tokens = tokens_of(res)
        row.update(build_s=build_s, calls=calls,
                   launches={k: counts[k] for k in fe.KERNELS},
                   tokens_per_s_vs_plain=row["tokens_per_s"] / plain["readings"]["tokens_per_s"],
                   same_tokens_as_plain=sum(a == b for x, y in zip(tokens, plain["tokens"])
                                            for a, b in zip(x, y)),
                   generated=sum(caps))
        if mode == "quant":
            q = engine.quant_state
            row.update(int8_bytes=sum(v["q"].numel() for v in q.values()),
                       scale_bytes=sum(v["s"].numel() * 4 for v in q.values()),
                       bf16_weight_bytes=sum(p.numel() * p.element_size()
                                             for p in engine.model.parameters()),
                       dequant_launches_per_tick=len(q))
        if mode == "lora":
            row.update(prefix_hit_blocks=snap.get("prefix_hit_blocks", 0),
                       prefix_miss_blocks=snap.get("prefix_miss_blocks", 0),
                       adapter_requests={a: snap.get(f"adapter_{a}_requests", 0)
                                         for a in ("tenant-a", "tenant-b")})
        if sc._spec is not None:
            pool = sc._draft_pool
            row.update(spec_acceptance_rate=snap.get("spec_acceptance_rate"),
                       spec_rounds=snap.get("spec_rounds"),
                       below_floor=bool(snap.get("spec_acceptance_below_floor")),
                       draft_pool_mib=sum(t.numel() * t.element_size()
                                          for t in pool.keys + pool.values) / 2**20)
        if profile:
            hand = sched_on(engine, start=False, quant=engine.quant_state,
                            lora=engine.lora_registry, speculative=sc._spec)
            for i, (p, k) in enumerate(zip(prompts[:8], keys[:8])):
                hand.submit(p, key=k, **({} if adapters is None else {"adapter": adapters[i]}))
            hand.tick()
            hand.tick()
            n = 4 if sc._spec is not None else 8
            profile_window(torch, f"{mode}: {n} ticks of 8 slots",
                           lambda: [hand.tick() for _ in range(n)], 12)
            hand.close()
    say(f"  {mode}: " + json.dumps({k: v for k, v in row.items()
                                    if k in ("build_s", "calls", "launches", "same_tokens_as_plain",
                                             "tokens_per_s_vs_plain", "int8_bytes",
                                             "scale_bytes", "dequant_launches_per_tick",
                                             "prefix_hit_blocks", "prefix_miss_blocks",
                                             "spec_acceptance_rate", "below_floor",
                                             "draft_pool_mib")}))
    return row


def phase_serve_modes(torch, modules, fe, smi: str, plain: dict, profile: bool) -> dict:
    """Phase 21; returns K3/K4's launches by mode."""
    t_phase = time.perf_counter()
    readings = {"gates": mode_gates(torch, plain)}
    for mode in MODE_KEYS:
        readings[mode] = mode_reading(torch, modules, fe, smi, mode, plain, profile)
        torch.cuda.empty_cache()
    readings["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 21 took {readings['phase_s']:.1f} s")
    say("serving_modes: " + json.dumps(readings))
    return {mode: readings[mode]["launches"] for mode in MODE_KEYS}


# --------------------------------------------------------------------- #
# phase 22: ViT-B16 training; phase 23: classification serving

# phase 22 (b)'s cuts of config/ViT-B16.yml: a seeded JPEG tree in place of
# the ImageNet root (2 training and 2 validation batches of the config's
# 256), 8 steps, validation at the 8th
VIT_STEPS, VIT_CLASSES_IN_TREE = 8, 8
VIT_BATCH_TOL_FLOOR = 1e-5  # phase 22 (a): the least limit, norm-relative
SERVE_STREAM = 128  # phase 23 (b): requests a burst
SERVE_CKPT_TOL = 1e-5  # phase 23 (c): engine vs runner, of the largest logit


def vit_reference_f64(torch, sd: dict, x, heads: int):
    """A plain float64 ViT of the port's ``state_dict`` ``sd`` (already
    float64) on ``[N, 3, H, W]`` ``x``: the conv patches, row-major; the
    class token and position table; pre-LN blocks (two-pass LayerNorm, eps
    1e-6), heads-major qkv, softmax attention, exact GELU; the head on the
    class token.  Independent of the port's modules, for phase 22 (a)."""
    import torch.nn.functional as F

    def ln(y, name):
        mu = y.mean(-1, keepdim=True)
        var = ((y - mu) ** 2).mean(-1, keepdim=True)
        return (y - mu) / torch.sqrt(var + 1e-6) * sd[name + ".weight"] + sd[name + ".bias"]

    def dense(y, name):
        return F.linear(y, sd[name + ".weight"], sd[name + ".bias"])

    patch = sd["patch_embed.weight"].shape[-1]
    t = F.conv2d(x, sd["patch_embed.weight"], sd["patch_embed.bias"], stride=patch)
    t = torch.cat([sd["cls_token"].expand(x.shape[0], -1, -1), t.flatten(2).transpose(1, 2)], 1)
    t = t + sd["pos_embedding"]
    depth = len({k.split(".")[0] for k in sd if k.startswith("block")})
    for i in range(depth):
        b = f"block{i}."
        qkv = dense(ln(t, b + "ln1"), b + "attn.qkv")
        qkv = qkv.unflatten(-1, (heads, 3, qkv.shape[-1] // (3 * heads)))
        q, k, v = qkv.unbind(3)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
        out = torch.einsum("bhqk,bkhd->bqhd", att.softmax(-1), v).flatten(2)
        t = t + dense(out, b + "attn.proj")
        t = t + dense(F.gelu(dense(ln(t, b + "ln2"), b + "mlp.fc1")), b + "mlp.fc2")
    return dense(ln(t[:, 0], "ln"), "head")


def phase_vit_step_vs_cpu(torch, modules, batch: int = 2, seed: int = 22) -> dict:
    """Phase 22 (a): ViT-B16 at full width (224^2, 1000 classes), f32 with
    TF32 off, one image-DP step's forward and backward on the card against
    the same weights and batch on the CPU, and both against a plain float64
    twin (:func:`vit_reference_f64`).  As phase 13 sets its limits: the
    card's logits and each gradient must lie as close to float64 as the
    CPU's f32 ones do, within 3x the CPU's error (norm-relative, at least
    ``VIT_BATCH_TOL_FLOOR``), and all gradients together within 2x; the
    loss within rtol 1e-5 of the CPU's; exactly 1 K1a and 1 K1b on the card."""
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch import optimizers
    from pytorch_distributed_training_tpu_torch.engine import build_train_step
    from pytorch_distributed_training_tpu_torch.models import get_model

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = get_model("ViT-B16", num_classes=1000)
        cpu.reset_parameters(torch.Generator().manual_seed(seed))
        gpu = get_model("ViT-B16", num_classes=1000)
        gpu.load_state_dict(cpu.state_dict())
        gpu = gpu.to("cuda", memory_format=torch.channels_last)
        gen = torch.Generator().manual_seed(seed + 1)
        img = torch.randn(batch, 224, 224, 3, generator=gen)
        labels = torch.randint(0, 1000, (batch,), generator=gen)
        out = {}
        for where, model, x, y in (("cpu", cpu, img, labels),
                                   ("card", gpu, img.cuda(), labels.cuda())):
            for m in modules:
                m.reset_launch_counts()
            opt = optimizers.AdamW(lr=1e-3, weight_decay=0.05)
            step = build_train_step(model, opt, lambda s: 1e-3)
            t0 = time.perf_counter()
            loss, logits = step.forward_backward(x, y)
            out[where] = (loss.item(), logits.cpu(),
                          {n: p.grad.cpu() for n, p in model.named_parameters()})
            say(f"  {where}: forward and backward in {time.perf_counter() - t0:.2f} s")
        counts = all_counts(modules)
        check_launches("ViT-B16 step on the card", counts, dict(ce_fwd=1, ce_bwd=1))
        sd = {n: p.detach().double().requires_grad_(True) for n, p in cpu.named_parameters()}
        t0 = time.perf_counter()
        y64 = vit_reference_f64(torch, sd, img.double().permute(0, 3, 1, 2), heads=12)
        l64 = F.cross_entropy(y64, labels)
        l64.backward()
        say(f"  float64 twin: forward and backward in {time.perf_counter() - t0:.2f} s")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    (l_cpu, y_cpu, g_cpu), (l_card, y_card, g_card) = out["cpu"], out["card"]
    say(f"  loss card {l_card!r} cpu {l_cpu!r} float64 {l64.item()!r}")
    if abs(l_card - l_cpu) > 1e-5 * abs(l_cpu):
        raise AssertionError("loss: card and CPU differ by more than rtol 1e-5")
    e_card, e_cpu = norm_relative(y_card, y64.detach()), norm_relative(y_cpu, y64.detach())
    numbers = dict(logits=dict(card=e_card, cpu=e_cpu, card_vs_cpu=norm_relative(y_card, y_cpu)))
    if not torch.isfinite(y_card).all() or e_card > max(3 * e_cpu, VIT_BATCH_TOL_FLOOR):
        raise AssertionError(f"logits from float64: card {e_card}, CPU f32 {e_cpu}")
    ratios = []
    for n, g64 in ((n, t.grad) for n, t in sd.items()):
        ec, eu = norm_relative(g_card[n], g64), norm_relative(g_cpu[n], g64)
        if not torch.isfinite(g_card[n]).all() or ec > max(VIT_BATCH_TOL_FLOOR, 3 * eu):
            raise AssertionError(f"grad {n}: card {ec} from float64, CPU f32 {eu}")
        ratios.append((ec / max(eu, 1e-300), n, ec, eu))
    flat = [torch.cat([g[n].double().reshape(-1) for n in sd]) for g in (g_cpu, g_card)]
    flat64 = torch.cat([t.grad.reshape(-1) for t in sd.values()])
    a_cpu, a_card = norm_relative(flat[0], flat64), norm_relative(flat[1], flat64)
    if a_card > max(2 * a_cpu, VIT_BATCH_TOL_FLOOR):
        raise AssertionError(f"gradients: card {a_card} from float64 over all, CPU {a_cpu}")
    worst = max(ratios)
    numbers.update(grads=dict(card=a_card, cpu=a_cpu), worst_ratio=worst)
    say(f"  logits [{batch}, 1000] from float64 (norm-relative): card {e_card:.4g}, CPU f32 "
        f"{e_cpu:.4g}; {len(sd)} gradients, all of them: card {a_card:.4g}, CPU f32 "
        f"{a_cpu:.4g}; worst card/CPU ratio {worst[0]:.3g} at {worst[1]} ({worst[2]:.3g} vs "
        f"{worst[3]:.3g}); launches {counts}")
    say("vit_step: " + json.dumps(numbers))
    del cpu, gpu, sd
    torch.cuda.empty_cache()
    return counts


def torchvision_vit_b16(torch, seed: int) -> dict:
    """A ``state_dict`` in torchvision's ``vit_b_16`` layout (its names,
    shapes and packed ``[q; k; v]`` ``in_proj``), random from ``seed``:
    Dense weights normal(0, 0.02), biases normal(0, 0.01), LayerNorm
    weights around 1, 1000 classes."""
    gen = torch.Generator().manual_seed(seed)
    e, depth = 768, 12

    def w(*shape, std=0.02, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    sd = {"conv_proj.weight": w(e, 3, 16, 16), "conv_proj.bias": w(e, std=0.01),
          "class_token": w(1, 1, e), "encoder.pos_embedding": w(1, 197, e)}
    for i in range(depth):
        pre = f"encoder.layers.encoder_layer_{i}."
        for ln in ("ln_1", "ln_2"):
            sd[pre + ln + ".weight"] = w(e, std=0.1, mean=1.0)
            sd[pre + ln + ".bias"] = w(e, std=0.01)
        sd[pre + "self_attention.in_proj_weight"] = w(3 * e, e)
        sd[pre + "self_attention.in_proj_bias"] = w(3 * e, std=0.01)
        sd[pre + "self_attention.out_proj.weight"] = w(e, e)
        sd[pre + "self_attention.out_proj.bias"] = w(e, std=0.01)
        sd[pre + "mlp.0.weight"], sd[pre + "mlp.0.bias"] = w(4 * e, e), w(4 * e, std=0.01)
        sd[pre + "mlp.3.weight"], sd[pre + "mlp.3.bias"] = w(e, 4 * e), w(e, std=0.01)
    sd["encoder.ln.weight"], sd["encoder.ln.bias"] = w(e, std=0.1, mean=1.0), w(e, std=0.01)
    sd["heads.head.weight"], sd["heads.head.bias"] = w(1000, e), w(1000, std=0.01)
    return sd


def torchvision_vit_mapped(torch, sd: dict, heads: int = 12) -> dict:
    """``sd`` in the port's names, mapped here and not by the port: the
    in_proj rows ``[which, head, d]`` reordered to ``[head, which, d]``."""
    out = {"patch_embed.weight": sd["conv_proj.weight"], "patch_embed.bias": sd["conv_proj.bias"],
           "cls_token": sd["class_token"], "pos_embedding": sd["encoder.pos_embedding"],
           "ln.weight": sd["encoder.ln.weight"], "ln.bias": sd["encoder.ln.bias"],
           "head.weight": sd["heads.head.weight"], "head.bias": sd["heads.head.bias"]}
    names = {"ln_1": "ln1", "ln_2": "ln2", "self_attention.out_proj": "attn.proj",
             "mlp.0": "mlp.fc1", "mlp.3": "mlp.fc2"}
    for key, t in sd.items():
        if not key.startswith("encoder.layers."):
            continue
        layer, rest = key[len("encoder.layers.encoder_layer_"):].split(".", 1)
        sub, leaf = rest.rsplit(".", 1)
        if sub == "self_attention":  # in_proj_weight / in_proj_bias
            e = t.shape[0] // 3
            t = t.reshape(3, heads, e // heads, -1).transpose(0, 1).reshape(t.shape)
            out[f"block{layer}.attn.qkv.{leaf[len('in_proj_'):]}"] = t
        else:
            out[f"block{layer}.{names[sub]}.{leaf}"] = t
    return out


def vit_forward_flop(model) -> float:
    """Model FLOP of one image's forward: 2 x the multiply-adds of the
    patch conv, of every Dense over every token, of the attention's two
    products, and of the head."""
    e, s = model.embed_dim, model.pos_embedding.shape[1]
    patch = 2 * e * 3 * model.patch_size ** 2 * (s - 1)
    block = 2 * s * 12 * e * e + 2 * 2 * s * s * e  # qkv 3E^2, proj E^2, MLP 8E^2
    return float(patch + model.depth * block + 2 * e * model.num_classes)


# a device-resident step's kernel time by the aten op that launched it
VIT_PROFILE_CLASSES = (
    ("attention einsums (aten::bmm, f32)", ("aten::bmm",)),
    ("Dense GEMMs (aten::addmm/mm: bf16, the head f32)", ("aten::addmm", "aten::mm")),
    ("patch conv (cuDNN)", ("aten::cudnn_convolution", "aten::convolution_backward")),
    ("softmax", ("aten::_softmax", "aten::_softmax_backward_data")),
)


def profile_vit_step(torch, step, img, labels, label: str) -> dict:
    """``--profile``: one device-resident step after a warm one; the device
    time of the kernels each op class of :data:`VIT_PROFILE_CLASSES`
    launched (the rest: elementwise, reductions, copies, the optimizer's
    and EMA's ``_foreach`` passes, K1), then the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e, total=False):
        names = (("device_time_total", "cuda_time_total") if total
                 else ("self_device_time_total", "self_cuda_time_total"))
        return next((getattr(e, n) for n in names if getattr(e, n, None)), 0)

    step(img, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(img, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    by_op = {e.key: device_us(e, total=True) / 1e3 for e in events
             if e.device_type == DeviceType.CPU}
    classes = {name: sum(by_op.get(op, 0.0) for op in ops) for name, ops in VIT_PROFILE_CLASSES}
    classes["the rest"] = busy_ms - sum(classes.values())
    say(f"  profile {label}: wall {wall_ms} ms, device kernel time {busy_ms} ms, busy share "
        f"{busy_ms / wall_ms}, kernel launches {sum(e.count for e in kernels)}")
    for name, ms in classes.items():
        say(f"    {ms:9.3f} ms  {ms / busy_ms:.4f}  {name}")
    for e in sorted(kernels, key=lambda e: -device_us(e))[:15]:
        say(f"    {device_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")
    return dict(wall_ms=wall_ms, device_ms=busy_ms, busy=busy_ms / wall_ms,
                classes_ms=classes)


def phase_vit_runner(torch, modules, tf32_defaults, profile: bool):
    """Phase 22 (b)-(d): the runner on ``config/ViT-B16.yml`` (AdamW, cosine
    with linear warmup, bf16, ``device_normalize``, batch 256 a card, 16
    loader workers) with only these cuts, made in memory: a seeded JPEG
    tree (ImageNet's typical 500 x 375, ``VIT_CLASSES_IN_TREE`` classes)
    under ``run/chip_smoke/vit`` in place of the ImageNet root, loaded by
    PIL in ``worker_mode: thread`` (the card's host has no libjpeg for the
    native decoder); ``VIT_STEPS`` steps, validation at the last on 2
    batches.  (c) ``model.pretrained`` names a torchvision-layout ViT-B16
    ``state_dict`` the phase writes from a seed; before the first step the
    runner's parameters must equal it as this script maps it, bit for bit.
    (d) per step exactly 1 K1a + 1 K1b ([256, 1000] f32: the head is f32),
    per validation batch 1 K1a.  Prints step ms (loader-fed and
    device-resident), images/s, model FLOP and peak memory; with
    ``profile`` the device-resident step's breakdown.  Returns the launch
    counts and the numbers."""
    import math
    import shutil
    from functools import partial

    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg, get_train_logger
    from pytorch_distributed_training_tpu_torch.engine import Runner
    from pytorch_distributed_training_tpu_torch.logger import MultiProcessLoggerListener
    from pytorch_distributed_training_tpu_torch.tools.image_folder import write_image_folder

    import numpy as np

    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    cfg = get_cfg(VIT_CONFIG)
    batch = cfg["training"]["batch_size"]
    shutil.rmtree(VIT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    per_class = 2 * batch // VIT_CLASSES_IN_TREE
    tree = write_image_folder(os.path.join(VIT_DIR, "imagenet"), classes=VIT_CLASSES_IN_TREE,
                              train=per_class, val=per_class, seed=22)
    tv = torchvision_vit_b16(torch, seed=23)
    weights = os.path.join(VIT_DIR, "vit_b_16_torchvision.pt")
    torch.save(tv, weights)
    want = torchvision_vit_mapped(torch, tv)
    say(f"  wrote {2 * per_class * VIT_CLASSES_IN_TREE} JPEGs and a torchvision-layout "
        f"ViT-B16 state_dict ({os.path.getsize(weights)} bytes) in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg["dataset"]["root"] = tree
    cfg["training"].update(train_iters=VIT_STEPS, print_interval=1, val_interval=VIT_STEPS,
                           worker_mode="thread")
    cfg["model"]["pretrained"] = weights
    marks, losses, pre = [], [], {}

    def on_iter(runner):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), all_counts(modules)))
        losses.append(float(runner.last_loss))

    listener = MultiProcessLoggerListener(
        partial(get_train_logger, os.path.join(_HERE, "run", "chip_smoke"), "vit-b16"), "spawn")
    runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                    logger_queue=listener.queue, global_cfg=cfg, device="cuda", on_iter=on_iter)

    def first_step(inputs, labels):
        if not pre:  # (c): the weights the first step starts from
            got = {n: p.detach().cpu() for n, p in runner.model.named_parameters()}
            pre["missing"] = sorted(set(want) ^ set(got))
            pre["differ"] = [n for n in want if n in got and not torch.equal(got[n], want[n])]
        return Runner.train_iter(runner, inputs, labels)

    runner.train_iter = first_step
    for m in modules:
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        runner()
    finally:
        listener.stop()
    final = all_counts(modules)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not pre or pre["missing"] or pre["differ"]:
        raise AssertionError(f"model.pretrained before step 1: {pre or 'no step ran'}")
    say(f"  (c) before step 1 the runner's {len(want)} parameters equal the torchvision "
        f"state_dict mapped here, bit for bit")
    if runner.is_lm or type(runner.model).__name__ != "ViT":
        raise AssertionError(f"config/ViT-B16.yml built {type(runner.model).__name__}")
    if len(losses) != VIT_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses: {losses}")
    if len(runner.val_log) != 1 or not math.isfinite(runner.val_log[0]["loss"]):
        raise AssertionError(f"validation: {runner.val_log}")
    prev = {k: 0 for k in final}
    for i, (_, counts) in enumerate(marks):
        check_launches(f"step {i}", {k: counts[k] - prev[k] for k in final},
                       dict(ce_fwd=1, ce_bwd=1))
        prev = counts
    val_batches = len(runner.val_loader)
    check_launches(f"validation ({val_batches} batches)", {k: final[k] - prev[k] for k in final},
                   dict(ce_fwd=val_batches))
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    # fed by the loader the steps come unevenly (two staged batches, then a
    # wait on the loader): the mean gives the sustained rate
    med_ms, mean_ms = statistics.median(step_ms), statistics.fmean(step_ms)
    flop = 3 * vit_forward_flop(runner.model)
    loader = runner.train_loader
    load_ms = loader_ms(loader)
    inp, lab = next(iter(loader))
    loader.close()
    img, labels = runner._to_device(inp, lab)
    dev_ms = device_step_ms(torch, runner.train_step, img, labels)
    lrs = [r["lr"] for r in runner.train_log]
    say(f"  loader: {loader.worker_mode} mode, {loader.num_workers} worker(s), "
        f"{loader.output_dtype} batches ({np.dtype(inp.dtype).name} {inp.nbytes + lab.nbytes} "
        f"bytes a batch); alone {load_ms} ms a batch of {batch}")
    say(f"  losses {losses}; lr {lrs}; validation {runner.val_log[0]}")
    say(f"  step ms (steps 1-{VIT_STEPS - 1}, host clock, loader-fed, synced): {step_ms}; "
        f"median {med_ms}, mean {mean_ms}; images/s (from the mean) {batch / mean_ms * 1e3}")
    say(f"  device-resident step {dev_ms} ms, {batch / dev_ms * 1e3} images/s; model FLOP an "
        f"image (train: 3 x forward) {flop:.4g}, {flop * batch / dev_ms / 1e9:.2f} TFLOP/s, "
        f"{flop * batch / (dev_ms / 1e3) / BF16_FLOPS:.4f} of 989 (bf16)")
    say(f"  launches a step {{'ce_fwd': 1, 'ce_bwd': 1}} ([{batch}, 1000] f32), validation "
        f"{{'ce_fwd': {val_batches}}}; peak device memory {peak_gib} GiB")
    numbers = dict(step_ms=step_ms, median_step_ms=med_ms, mean_step_ms=mean_ms,
                   images_per_s=batch / mean_ms * 1e3,
                   device_step_ms=dev_ms, device_images_per_s=batch / dev_ms * 1e3,
                   loader_ms=load_ms, model_flop_per_image=flop / 3, peak_gib=peak_gib,
                   losses=losses, lr=lrs, val=runner.val_log[0], pretrained_equal=len(want))
    if profile:
        say("== profile (ViT-B16 bf16 train step, device-resident)")
        numbers["profile"] = profile_vit_step(torch, runner.train_step, img, labels,
                                              "ViT-B16 bf16 step")
    say("vit_runner: " + json.dumps(numbers))
    del runner, img
    torch.cuda.empty_cache()
    return final, numbers


def phase_vit(torch, modules, tf32_defaults, profile: bool) -> dict:
    """Phase 22; returns the launch counts by path."""
    paths = {"vit_step": by_tpu_kernel(phase_vit_step_vs_cpu(torch, modules))}
    counts, _ = phase_vit_runner(torch, modules, tf32_defaults, profile)
    paths["vit"] = by_tpu_kernel(counts)
    return paths


def phase_vit_and_serving(torch, modules, tf32_defaults, smi: str, profile: bool) -> dict:
    """Phases 22 and 23; returns phase 22's launch counts by path (phase 23
    launches no hand-written kernel)."""
    phase("phase 22: ViT-B16, card vs CPU, then config/ViT-B16.yml on the runner "
          "(pretrained)")
    paths = phase_vit(torch, modules, tf32_defaults, profile)
    phase("phase 23: classification serving (config/serve-resnet50.yml: ResNet-50, ViT-B16; "
          "phase 17's checkpoint)")
    phase_serve_classify(torch, modules, smi)
    return paths


def serve_cli(config: str, requests: int, log_dir: str) -> dict:
    """``python -m pytorch_distributed_training_tpu_torch.serving`` run in
    this process: its last line's snapshot."""
    import io

    from pytorch_distributed_training_tpu_torch.serving.__main__ import main as serve_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_main(["--config", config, "--requests", str(requests), "--log-dir", log_dir])
    if rc != 0:
        raise AssertionError(f"serving CLI on {config}: exit {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])["serving"]


def phase_serve_classify(torch, modules, smi: str) -> dict:
    """Phase 23: classification serving on the batcher.  (a) The serving
    CLI on ``config/serve-resnet50.yml`` as it is (ResNet-50, bf16, bucket
    8, uint8 normalised on the card, random weights from ``serving.seed``)
    and on a copy with ``model.name: ViT-B16``, 16 requests each.  (b) Each
    engine from the same config, warmed up, then ``SERVE_STREAM`` seeded
    uint8 requests submitted at once: every result a label in range and
    1000 finite f32 logits, no hand-written kernel launched (classification
    runs no CE or flash); images/s, latency p50/p99, batch fill (mean batch
    over the bucket) and host ms a batch.  (c) ResNet-50 served from phase
    17's checkpoint (``run/chip_smoke/ckpt/a``, with an EMA) at f32, TF32
    off: the engine's logits on 8 seeded images within ``SERVE_CKPT_TOL``
    of the largest of the runner's own eval of the EMA weights (the runner
    resumed from that checkpoint, ``_eval_weights``)."""
    import numpy as np
    import yaml

    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg, get_serve_cfg
    from pytorch_distributed_training_tpu_torch.data.datasets import IMAGENET_MEAN, IMAGENET_STD
    from pytorch_distributed_training_tpu_torch.engine import Runner
    from pytorch_distributed_training_tpu_torch.engine.steps import _eval_logits, input_normalizer
    from pytorch_distributed_training_tpu_torch.serving import InferenceEngine

    t_phase = time.perf_counter()
    log_dir = os.path.join(_HERE, "run", "chip_smoke", "serve-classify")
    vit_cfg = get_serve_cfg(SERVE_RESNET_CONFIG)
    vit_cfg["model"]["name"] = "ViT-B16"
    vit_path = os.path.join(VIT_DIR, "serve-vit-b16.yml")
    os.makedirs(VIT_DIR, exist_ok=True)
    with open(vit_path, "w") as f:
        yaml.safe_dump(vit_cfg, f)
    readings = {}
    for name, path in (("resnet50", SERVE_RESNET_CONFIG), ("vit_b16", vit_path)):
        snap = serve_cli(path, 16, log_dir)
        if snap["requests"] != 16 or snap["items"] != 16:
            raise AssertionError(f"(a) {name} CLI: {snap}")
        say(f"  (a) {name}: the serving CLI answered 16 requests, batch mean "
            f"{snap['batch_size_mean']}, {snap.get('items_per_sec')} images/s (cold)")
        cfg = get_serve_cfg(path)
        rng = np.random.default_rng(23)
        reqs = rng.integers(0, 256, (SERVE_STREAM, 224, 224, 3), dtype=np.uint8)
        for m in modules:
            m.reset_launch_counts()
        with InferenceEngine.from_config(cfg) as engine:
            warm = engine.warmup()
            t0 = time.perf_counter()
            results = [f.result(timeout=600) for f in [engine.submit(r) for r in reqs]]
            wall = time.perf_counter() - t0
            snap = engine.snapshot()
        check_launches(f"(b) {name} serving", all_counts(modules), {})
        bad = [i for i, r in enumerate(results)
               if not 0 <= r["label"] < 1000 or r["logits"].shape != (1000,)
               or r["logits"].dtype != np.float32 or not np.isfinite(r["logits"]).all()]
        if bad or snap["requests"] != SERVE_STREAM:
            raise AssertionError(f"(b) {name}: bad results {bad[:4]}, snapshot {snap}")
        bucket = engine.batch_buckets[-1]
        readings[name] = dict(
            images_per_s=SERVE_STREAM / wall, items_per_sec=snap.get("items_per_sec"),
            latency_ms_p50=snap["latency_ms_p50"], latency_ms_p99=snap["latency_ms_p99"],
            batches=snap["batches"], batch_fill=snap["batch_size_mean"] / bucket,
            batch_host_ms_p50=snap["batch_host_ms_p50"],
            batch_host_ms_p99=snap["batch_host_ms_p99"], warmup_ms=warm["warmup_ms"])
        say(f"  (b) {name}, {SERVE_STREAM} requests at once, bucket {bucket}: "
            + json.dumps(readings[name]) + f"  [{smi}]")
        del engine
        torch.cuda.empty_cache()

    # (c) phase 17's checkpoint, served, against the runner's eval of its EMA
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ckpt = os.path.join(CKPT_DIR, "a")
        train = get_cfg(RESNET_CONFIG)
        train["training"].update(train_iters=6, print_interval=1, dtype="float32",
                                 ema={"decay": 0.999}, checkpoint={"dir": ckpt, "interval": 3})
        train["dataset"]["n_samples"] = 2 * train["training"]["batch_size"]
        runner = Runner(num_nodes=1, rank=0, seed=0, dist_url="", multiprocessing=False,
                        logger_queue=None, global_cfg=train, device="cuda")
        runner()  # resumes at the checkpoint's last step: nothing left to train
        if runner.iter != 6 or runner.train_step.ema is None:
            raise AssertionError(f"(c) runner resumed at {runner.iter}")
        imgs = np.random.default_rng(24).integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)
        norm = input_normalizer((IMAGENET_MEAN, IMAGENET_STD))
        with runner._eval_weights(), torch.no_grad():
            want = _eval_logits(runner.model, norm(torch.from_numpy(imgs).cuda())).float().cpu()
        serve = get_serve_cfg(SERVE_RESNET_CONFIG)
        serve["serving"].update(checkpoint=ckpt, dtype="float32")
        with InferenceEngine.from_config(serve) as engine:
            got = torch.from_numpy(np.stack(
                [f.result(timeout=600)["logits"] for f in [engine.submit(i) for i in imgs]]))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    err = relative_to_largest(got, want)
    labels_equal = bool((got.argmax(-1) == want.argmax(-1)).all())
    readings["ckpt_ema"] = dict(max_err_of_largest=err, labels_equal=labels_equal,
                                limit=SERVE_CKPT_TOL)
    say(f"  (c) ResNet-50 served from {ckpt} (step 5, EMA) at f32, TF32 off, 8 images: max "
        f"|engine - runner eval of the EMA| / max |runner| = {err:.3g} (limit "
        f"{SERVE_CKPT_TOL}); labels equal {labels_equal}")
    if not torch.isfinite(got).all() or err > SERVE_CKPT_TOL:
        raise AssertionError(f"(c) checkpointed ResNet-50: {readings['ckpt_ema']}")
    readings["phase_s"] = time.perf_counter() - t_phase
    say("serve_classify: " + json.dumps(readings))
    del runner
    torch.cuda.empty_cache()
    return readings


# --------------------------------------------------------------------- #
# phase 24: the fleet tier

FLEET_CONFIG = os.path.join(_HERE, "pytorch_distributed_training_tpu_torch", "configs",
                            "serve-lm-1024-fleet.yml")
FLEET_DIR = os.path.join(_HERE, "run", "chip_smoke", "fleet")


def fleet_cfg(depth=None, dtype=None, temperature=None) -> dict:
    """``configs/serve-lm-1024-fleet.yml``, cut in memory; heartbeats under
    ``run/chip_smoke/fleet``."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_serve_cfg

    cfg = get_serve_cfg(FLEET_CONFIG)
    if depth is not None:
        cfg["model"]["depth"] = depth
    if dtype is not None:
        cfg["serving"]["dtype"] = dtype
    if temperature is not None:
        cfg["serving"]["temperature"] = temperature
    cfg["serving"]["fleet"]["heartbeat_dir"] = os.path.join(FLEET_DIR, "hb")
    return cfg


@contextlib.contextmanager
def heartbeat_ages(reps, period: float = 0.02):
    """While the block runs, the largest age in s of each replica's
    heartbeat file, as the router reads it (its mtime against the wall
    clock), sampled every ``period`` s by a side thread: ``{replica_id:
    age}``."""
    import threading

    ages, stop = {}, threading.Event()

    def watch():
        while not stop.wait(period):
            now = time.time()
            for r in reps:
                try:
                    age = now - os.stat(r.heartbeat_path).st_mtime
                except (OSError, TypeError):  # not written yet, or no heartbeat
                    continue
                ages[r.replica_id] = max(ages.get(r.replica_id, 0.0), age)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    try:
        yield ages
    finally:
        stop.set()
        t.join()


def timed_trace(submit, prompts, caps, keys, timeout: float = 600.0):
    """Every request at once; (futures, each request's [(time, token)], the
    send times).  The tokens' times are the host's, in ``on_token``."""
    times = {i: [] for i in range(len(prompts))}
    sent, futs = {}, []
    for i, (p, c, k) in enumerate(zip(prompts, caps, keys)):
        sent[i] = time.perf_counter()
        futs.append(submit(p, max_new_tokens=c, key=k,
                           on_token=lambda tok, i=i: times[i].append((time.perf_counter(), tok))))
    return futs, times, sent


def trace_done(futs, times, sent, t0, timeout: float = 600.0):
    """(results, TTFT ms of each, wall s) of a :func:`timed_trace`; every
    streamed token delivered once, in order, equal to the result."""
    results = [f.result(timeout=timeout) for f in futs]
    wall = time.perf_counter() - t0
    for i, r in enumerate(results):
        if [t for _, t in times[i]] != r["tokens"].tolist():
            raise AssertionError(f"request {i}: on_token stream differs from the result")
    return results, [(times[i][0][0] - sent[i]) * 1e3 for i in range(len(futs))], wall


def tick_totals(reps):
    """Each replica's (ticks, host ms) so far; two readings bracket a run."""
    out = []
    for r in reps:
        h = r.metrics._tick_host_ms.snapshot()
        out.append((h["count"], h.get("sum", 0.0)))
    return out


def tick_ms_between(before, after) -> list:
    """Each replica's mean host ms a tick between two :func:`tick_totals`."""
    return [(s1 - s0) / (n1 - n0) if n1 > n0 else None
            for (n0, s0), (n1, s1) in zip(before, after)]


def replica_counts(reps, name: str) -> int:
    return sum(r.metrics.snapshot().get(name, 0) for r in reps)


def kill_mid_stream(fleet, prompts, caps, keys, victim: int = 0, min_done: int = 2,
                    min_left: int = 4):
    """Drive the trace through ``fleet`` and hard-kill replica ``victim`` once
    one of its requests has streamed ``min_done`` tokens and has
    ``min_left`` to go.
    Returns (results, the failed-over requests, ms from the kill to the
    victim's death and to the first token a survivor streamed for them)."""
    from pytorch_distributed_training_tpu_torch.serving import ReplicaDownError

    router = fleet.router
    sched = fleet.replicas[victim].scheduler
    t0 = time.perf_counter()
    futs, times, sent = timed_trace(fleet.submit, prompts, caps, keys)
    index = {tuple(k): i for i, k in enumerate(keys)}
    deadline = time.monotonic() + 120
    while True:
        with router._lock:
            on_victim = [index[fr.key] for fr in router._outstanding
                         if any(a.replica_idx == victim for a in fr.assignments)]
        if any(min_done <= len(times[i]) <= caps[i] - min_left for i in on_victim):
            break
        if time.monotonic() > deadline:
            raise AssertionError("no request of the victim reached mid-stream")
        time.sleep(0.0005)
    t_kill = time.perf_counter()
    at_kill = {i: len(times[i]) for i in on_victim}
    sched.hard_kill(ReplicaDownError(f"chip_smoke: replica {victim} dies mid-stream"))
    while not sched.health()["closed"]:
        time.sleep(0.0002)
    t_dead = time.perf_counter()
    results, ttft, wall = trace_done(futs, times, sent, t0)
    moved = [i for i in on_victim
             if at_kill[i] < caps[i] and any(t > t_dead for t, _ in times[i])]
    firsts = [min(t for t, _ in times[i] if t > t_dead) for i in moved]
    return (results, moved, (t_dead - t_kill) * 1e3,
            (min(firsts) - t_kill) * 1e3 if firsts else None, ttft, wall)


def fleet_gates(torch, np, prompts, caps) -> dict:
    """Phase 24 (a): f32, depth 2, TF32 off; raises on any failure."""
    from pytorch_distributed_training_tpu_torch.engine import fault
    from pytorch_distributed_training_tpu_torch.serving import (
        DisaggFleet,
        ServingFleet,
        kv_transfer,
    )

    out = {}
    prompts, caps = prompts[:8], [32] * 8  # every request long enough to be killed mid-stream
    keys = [(0, 24, i) for i in range(8)]
    for temp in (0.0, 0.8):
        fleet = ServingFleet.from_config(fleet_cfg(2, "float32", temp))
        ref_eng = fleet.replica_factory(50)  # one scheduler on the fleet's model
        want = tokens_of(serve_trace(ref_eng.submit, prompts, caps, keys)[0])
        got = tokens_of(serve_trace(fleet.submit, prompts, caps, keys)[0])
        if got != want:
            raise AssertionError(f"temperature {temp}: fleet streams differ from one scheduler's")
        reps = fleet.replicas
        fault.reset_counters()
        base = replica_counts(reps, "replayed_tokens")
        res, moved, dead_ms, first_ms, _, _ = kill_mid_stream(fleet, prompts, caps, keys)
        killed = tokens_of(res)
        c = fault.counters()
        mism = replica_counts(reps, "replay_parity_mismatch")
        if killed != want or mism or c.get("serving_fleet_parity_mismatch", 0) or not moved:
            raise AssertionError(
                f"temperature {temp}: kill replica 0: streams equal {killed == want}, "
                f"replay_parity_mismatch {mism}, failed over {moved}")
        out[f"t{temp}"] = dict(failed_over=len(moved), failovers=c.get("serving_fleet_failovers"),
                               replayed=replica_counts(reps, "replayed_tokens") - base,
                               dead_ms=dead_ms, first_new_token_ms=first_ms)
        say(f"  (a) temperature {temp}: 8 fleet streams = one scheduler's; replica 0 killed "
            f"mid-stream: {len(moved)} requests failed over, "
            f"{out[f't{temp}']['replayed']} tokens replayed, streams equal, on_token once a "
            f"token, replay_parity_mismatch 0")
        ref_eng.close()
        if temp:
            fleet.close()
        else:
            greedy = fleet, ref_eng  # its model serves the transfer gate below

    # transfer against recompute on the greedy fleet's model, hand-ticked
    fleet, eng = greedy
    prompt = next(p for p in prompts if p.size > 3 * 16)
    src, dst, ref, mid = (sched_on(eng, start=False) for _ in range(4))

    def serve(s, p):
        fut = s.submit(p, max_new_tokens=32, key=(0, 24, 99))
        drive_ticks(torch, s, [fut])
        return fut.result()["tokens"].tolist()

    def verb(s, fut):
        s.tick()
        return fut.result(timeout=60)

    expected = serve(src, prompt)
    payloads = verb(src, src.export_kv_prefix(prompt, namespace=-1))
    res = verb(dst, dst.import_kv_blocks(payloads))
    if res["accepted"] != len(payloads) or res["rejected"] or not payloads:
        raise AssertionError(f"import: {res} of {len(payloads)} blocks")
    if serve(ref, prompt) != expected:
        raise AssertionError("recompute differs")
    bs = dst._kv.block_size
    n_rows = dst._kv.num_blocks * bs
    rows = {}
    for name, s in (("dst", dst), ("ref", ref)):
        leaves = dict(kv_transfer.pool_row_leaves(s._pool, n_rows))
        rows[name] = [{n: leaves[n][s._kv._cache[p.key] * bs:(s._kv._cache[p.key] + 1) * bs]
                       .cpu().view(torch.uint8) for n in leaves} for p in payloads]
    if not all(torch.equal(a[n], b[n]) for a, b in zip(rows["dst"], rows["ref"]) for n in a):
        raise AssertionError("imported K/V rows differ from the recomputed ones")
    if serve(dst, prompt) != expected or dst._hit_blocks != len(payloads):
        raise AssertionError("decoding over imported blocks differs from a recompute")
    bad = verb(src, src.export_kv_prefix(prompt, namespace=-1))
    kv_transfer.corrupt_payload(bad[1])
    res = verb(mid, mid.import_kv_blocks(bad))
    if (res["accepted"], res["rejected"]) != (1, 1) or serve(mid, prompt) != expected:
        raise AssertionError(f"corrupt payload: {res}")
    out["transfer"] = dict(blocks=len(payloads), bytes_a_block=payloads[0].nbytes)
    say(f"  (a) {len(payloads)} blocks exported and imported: K/V rows bytewise equal to a "
        f"recompute, same 32 tokens; a corrupted block 1: CRC reject, block 0 kept, the "
        f"suffix recomputed, same tokens")
    for s in (src, dst, ref, mid):
        s.close()
    fleet.close()

    # the prefill replica dies mid-transfer: recompute
    fault.install("prefill_replica_down@1:0")
    fault.reset_counters()
    try:
        disagg = DisaggFleet.from_config(fleet_cfg(2, "float32"))
        got = disagg.submit(prompt, max_new_tokens=32, key=(0, 24, 99)).result(timeout=300)
        disagg.close()
    finally:
        fault.install(None)
    c = fault.counters()
    if (got["tokens"].tolist() != expected or not c.get("serving_disagg_transfer_recomputes")
            or c.get("serving_disagg_prefill_replicas_down") != 1):
        raise AssertionError(f"prefill_replica_down: counters {c}")
    say("  (a) prefill replica killed mid-transfer: local recompute, same 32 tokens")
    return out


# phase 24 (b)'s depth in the whole script's run, cut so that the script
# with phase 28 stays inside its time (a run of it took 1,179.4 s on an H100
# 80GB HBM3 at 700 W at the config's 16 blocks); ``--fleet`` runs 16
FLEET_DEFAULT_RUN_DEPTH = 4


def phase_fleet(torch, np, modules, fe, smi: str, depth=None):
    """Phase 24 ((b) at ``depth`` blocks if given); returns the launch
    counts of the fleet's main path."""
    from pytorch_distributed_training_tpu_torch.engine import fault
    from pytorch_distributed_training_tpu_torch.serving import DisaggFleet, ServingFleet
    from pytorch_distributed_training_tpu_torch.serving import kv_transfer as kvt

    t_phase = time.perf_counter()
    cfg = fleet_cfg(depth)
    depth, vocab = cfg["model"]["depth"], cfg["dataset"]["n_classes"]
    prompts, caps = sched_requests(np, vocab)  # phase 20's 32 requests
    keys = [(0, 24, i) for i in range(len(prompts))]

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        readings = {"gates": fleet_gates(torch, np, prompts, caps)}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    say(f"  (a) gates took {time.perf_counter() - t_phase:.1f} s")

    # (b) full width, bf16: the fleet, and one scheduler on its model
    t0 = time.perf_counter()
    fleet = ServingFleet.from_config(cfg)
    reps = fleet.replicas
    weights = sum(p.numel() * p.element_size() for p in reps[0].model.parameters())
    pool = sum(t.numel() * t.element_size()
               for t in reps[0].scheduler._pool.keys + reps[0].scheduler._pool.values)
    if reps[0].model is not reps[1].model:
        raise AssertionError("the replicas do not share one model")
    for r in reps:
        r.warmup()
    say(f"  (b) fleet of {len(reps)} built and warmed in {time.perf_counter() - t0:.1f} s: one "
        f"model ({weights / 2**20:.1f} MiB), {pool / 2**20:.1f} MiB of pool a replica")
    one = fleet.replica_factory(90)  # one scheduler on the same model, not routed
    one.warmup()
    res, ttft, wall = serve_trace(one.submit, prompts, caps, keys)
    readings["one_scheduler"] = trace_readings("one scheduler (same model)", res, ttft, wall,
                                               one.snapshot(), smi)
    one_tokens = tokens_of(res)
    one.close()

    # the main path: 32 requests through the router and 2 replicas
    for m in modules:
        m.reset_launch_counts()
    calls0 = [r.scheduler.calls() for r in reps]
    ticks0 = tick_totals(reps)
    down0 = fault.counters().get("serving_fleet_replicas_down", 0)
    t0 = time.perf_counter()
    with heartbeat_ages(reps) as hb_fleet:
        futs, times, sent = timed_trace(fleet.submit, prompts, caps, keys)
        res, ttft, wall = trace_done(futs, times, sent, t0)
    counts = all_counts(modules)
    n_calls = sum(v - c0[k] for r, c0 in zip(reps, calls0) for k, v in r.scheduler.calls().items())
    for r, c in zip(res, caps):
        t = r["tokens"]
        if r["gen_len"] != c or t.shape != (c,) or t.min() < 0 or t.max() >= vocab:
            raise AssertionError(f"request: gen_len {r['gen_len']} (cap {c}), tokens {t}")
    check_launches("fleet", counts, {k: depth * n_calls for k in fe.KERNELS})
    snap = fleet.snapshot()
    fleet_tokens = tokens_of(res)
    per = {f"r{i}": {k: s.get(k) for k in ("requests", "tick_host_ms_p50", "tick_host_ms_mean",
                                           "prefix_hit_blocks", "slot_occupancy_mean")}
           for i, s in enumerate(snap["replicas"].values())}
    readings["fleet"] = trace_readings("fleet of 2 (router, affinity)", res, ttft, wall,
                                       snap["fleet"], smi)
    readings["fleet"]["replicas"] = per
    readings["fleet"]["tick_host_ms_mean_by_replica"] = tick_ms_between(ticks0, tick_totals(reps))
    readings["fleet"]["affinity_hits"] = fault.counters().get("serving_fleet_affinity_hits", 0)
    readings["fleet"]["heartbeat_age_max_s"] = hb_fleet
    readings["fleet"]["replicas_down"] = (fault.counters().get("serving_fleet_replicas_down", 0)
                                          - down0)
    same = sum(a == b for x, y in zip(fleet_tokens, one_tokens) for a, b in zip(x, y))
    readings["fleet"]["tokens_equal_one_scheduler"] = same / sum(caps)
    say(f"  (b) 32 requests through 2 replicas: launches "
        f"{ {k: counts[k] for k in fe.KERNELS} } = {depth} x {n_calls} paged calls summed over "
        f"the replicas; per replica {json.dumps(per)}; {same} of {sum(caps)} tokens equal the "
        f"one scheduler's (bf16)")

    # scale up by one replica: construction + warmup
    idx = fleet.add_replica()
    new = fleet.replicas[idx]
    readings["scale_up"] = dict(
        scale_up_ready_ms=new.metrics.snapshot()["scale_up_ready_ms"],
        pool_bytes=sum(t.numel() * t.element_size()
                       for t in new.scheduler._pool.keys + new.scheduler._pool.values))
    say(f"  (b) add_replica: replica {idx} ready in {readings['scale_up']['scale_up_ready_ms']:.1f}"
        f" ms, its pool {readings['scale_up']['pool_bytes']} bytes")

    # disaggregation over the same fleet: one prefill replica, on a trace of
    # phase 20's shape that no replica has cached yet
    fault.reset_counters()
    d_prompts, d_caps = sched_requests(np, vocab, seed=24)
    disagg = DisaggFleet(fleet, disagg=cfg["serving"]["disagg"])
    xfer_ms = []  # each transfer's export-to-import ms, from the coordinator's debug line

    class _Transfers(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("kv transfer %d:"):
                xfer_ms.append(float(record.args[-1]))

    handler = _Transfers(logging.DEBUG)
    disagg.logger.addHandler(handler)
    disagg.logger.setLevel(logging.DEBUG)
    prefill = disagg.prefill_replicas[0]
    prefill.warmup()
    for m in modules:
        m.reset_launch_counts()
    all_reps = fleet.replicas + [prefill]
    calls0 = [r.scheduler.calls() for r in all_reps]
    with heartbeat_ages(all_reps) as hb_disagg:
        res, ttft, wall = serve_trace(disagg.submit, d_prompts, d_caps, keys)
    for r, c in zip(res, d_caps):
        if r["gen_len"] != c or r["tokens"].min() < 0 or r["tokens"].max() >= vocab:
            raise AssertionError(f"disaggregated request: gen_len {r['gen_len']} (cap {c})")
    dcounts = all_counts(modules)
    d_calls = sum(v - c0[k] for r, c0 in zip(all_reps, calls0)
                  for k, v in r.scheduler.calls().items())
    check_launches("disaggregated fleet", dcounts, {k: depth * d_calls for k in fe.KERNELS})
    disagg.logger.removeHandler(handler)
    disagg.logger.setLevel(logging.NOTSET)
    dsnap = disagg.snapshot()
    c = fault.counters()
    readings["disagg"] = trace_readings("disaggregated (1 prefill + 3 decode)", res, ttft, wall,
                                        dsnap["fleet"], smi)
    readings["disagg"].update(
        directory=dsnap["disagg"]["directory"], transfers=dsnap["disagg"]["transfers"],
        transfer_recomputes=c.get("serving_disagg_transfer_recomputes", 0),
        deadline_degrades=c.get("serving_disagg_deadline_degrades", 0),
        imported_blocks=sum(s.get("kv_transfer_blocks", 0)
                            for s in dsnap["replicas"].values()),
        transfer_ms=dict(n=len(xfer_ms), p50=statistics.median(xfer_ms) if xfer_ms else None,
                         max=max(xfer_ms, default=None), sum=sum(xfer_ms)),
        heartbeat_age_max_s=hb_disagg, replicas_down=c.get("serving_fleet_replicas_down", 0))
    if not readings["disagg"]["imported_blocks"]:
        raise AssertionError("disaggregated: no block was imported")
    limit = cfg["serving"]["fleet"]["heartbeat_timeout_s"]
    for name in ("fleet", "disagg"):
        if readings[name]["replicas_down"]:
            raise AssertionError(
                f"{name} reading: {readings[name]['replicas_down']} live replica(s) marked down "
                f"(largest heartbeat ages {readings[name]['heartbeat_age_max_s']} s, limit "
                f"{limit} s)")
    # one block's costs, on idle replicas: export (gather, copy to the
    # host, CRC) on the prefill replica, import (copy up, scatter) on a
    # decode replica that holds nothing of it
    src = prefill.scheduler
    long_prompt = max(prompts, key=lambda p: p.size)  # not in the disaggregated trace
    prefill.submit(long_prompt, max_new_tokens=1).result(timeout=300)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refs = kvt.extract_block_refs(src._kv, src._pool, long_prompt, namespace=-1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    payloads = kvt.materialize_payloads(refs)
    t2 = time.perf_counter()
    ok = all(kvt.verify_payload(p) for p in payloads)
    t3 = time.perf_counter()
    fresh = fleet.replica_factory(91)
    fresh.warmup()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    res_imp = fresh.scheduler.import_kv_blocks(payloads).result(timeout=300)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    nb = len(payloads)
    if not ok or res_imp["accepted"] != nb:
        raise AssertionError(f"block costs: verify {ok}, import {res_imp}")
    readings["disagg"]["block"] = dict(
        blocks=nb, bytes_a_block=payloads[0].nbytes, gather_ms_a_block=(t1 - t0) * 1e3 / nb,
        copy_and_crc_ms_a_block=(t2 - t1) * 1e3 / nb, crc_ms_a_block=(t3 - t2) * 1e3 / nb,
        import_ms_a_block=(t5 - t4) * 1e3 / nb,
        import_host_ms=fresh.metrics.snapshot().get("kv_transfer_ms_p50"))
    fresh.close()
    say(f"  (b) disaggregated: launches {depth} x {d_calls} paged calls (prefill replica "
        f"included); " + json.dumps(readings["disagg"]))
    disagg.prefill_replicas.clear()  # closed below with the fleet
    prefill.close()

    # failover at bf16: replica 0 killed mid-trace
    fault.reset_counters()
    live = [fleet.replicas[i] for i in fleet.router.live_indices()]
    base = replica_counts(live, "replayed_tokens")
    res, moved, dead_ms, first_ms, ttft, wall = kill_mid_stream(fleet, prompts, caps, keys,
                                                                min_done=8)
    c = fault.counters()
    killed = tokens_of(res)
    readings["failover"] = dict(
        failed_over=len(moved), failovers=c.get("serving_fleet_failovers", 0),
        kill_to_dead_ms=dead_ms, kill_to_first_new_token_ms=first_ms,
        replayed_tokens=replica_counts(live, "replayed_tokens") - base,
        replay_parity_mismatch=replica_counts(live, "replay_parity_mismatch"),
        fleet_parity_mismatch=c.get("serving_fleet_parity_mismatch", 0),
        streams_equal_unkilled=sum(a == b for a, b in zip(killed, fleet_tokens)),
        tokens_per_s=sum(r["gen_len"] for r in res) / wall)
    if not moved:
        raise AssertionError("failover: no request failed over")
    say("  (b) failover: " + json.dumps(readings["failover"]))
    disagg.close()
    torch.cuda.empty_cache()
    readings["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 24 took {readings['phase_s']:.1f} s")
    say("fleet: " + json.dumps(readings))
    return counts



# --------------------------------------------------------------------- #
# phase 25: the Mixture-of-Experts LM

MOE_CONFIG = os.path.join(_HERE, "pytorch_distributed_training_tpu_torch", "configs",
                          "train-lm-moe.yml")
# phase 25 (a), card against CPU at f32, TF32 off (phase 7's limits): the
# loss and the aux term within rtol 1e-5, the logits and every gradient
# within 1e-4 of their largest magnitude
MOE_LOSS_RTOL = 1e-5
MOE_LIMIT = 1e-4


def moe_objective(torch, model, tokens, labels) -> dict:
    """One forward and backward of the objective the runner trains a MoE LM
    with, :meth:`engine.tp_steps.TPLMTrainStep.micro_loss` over the whole
    batch (mean CE + every MoE block's aux term), with the logits (the
    head's output) and the MoE routers' logits captured."""
    from pytorch_distributed_training_tpu_torch import optimizers
    from pytorch_distributed_training_tpu_torch.engine.tp_steps import build_tp_lm_train_step

    step = build_tp_lm_train_step(model, optimizers.SGD(lr=0.0, momentum=0.0), lambda i: 0.0)
    step.aux = torch.zeros((), device=tokens.device)
    routed, head = [], []
    hooks = [b.moe.router.register_forward_hook(lambda m, a, out: routed.append(out.detach()))
             for b in model.blocks if b.is_moe]
    hooks.append(model.head.register_forward_hook(lambda m, a, out: head.append(out.detach())))
    model.zero_grad(set_to_none=True)
    try:
        loss = step.micro_loss(tokens, labels, labels.numel())
        loss.backward()
    finally:
        for h in hooks:
            h.remove()
    return dict(logits=head[0].cpu(), aux=step.aux.item(), loss=loss.item(),
                routed=[r.cpu() for r in routed],
                grads=[p.grad.detach().cpu() for p in model.parameters()])


def moe_readings(got: dict, want: dict) -> dict:
    return dict(logits=relative_to_largest(got["logits"], want["logits"]),
                loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                aux=abs(got["aux"] - want["aux"]) / abs(want["aux"]),
                grad=max(relative_to_largest(g, w) for g, w in zip(got["grads"], want["grads"])))


def moe_within(r: dict) -> bool:
    return (r["logits"] <= MOE_LIMIT and r["grad"] <= MOE_LIMIT and r["loss"] <= MOE_LOSS_RTOL
            and r["aux"] <= MOE_LOSS_RTOL)


def phase_moe_vs_cpu(torch, modules, batch: int = 2, seq: int = 256, seed: int = 25) -> dict:
    """Phase 25 (a): a MoE LM at full width (d 1024, 16 heads, vocab 32768;
    8 experts, top 2, capacity factor 1.25, aux weight 0.01), depth 2 (block
    0 dense with fused tails, block 1 MoE), f32 with TF32 off, batch 2 x
    256: the card's logits, loss with aux, aux and every gradient of the
    step's objective (:func:`moe_objective`) against the CPU's on the same
    weights and batch, within limits that three wrong
    variants on the card must fail (gates not renormalised over the top 2,
    a capacity counted without k, the aux term left out); the chosen experts
    (top 2, in order) identical, with the smallest top-1/top-2 and
    top-2/top-3 probability gaps printed; exactly 1 K1a, 1 K1b, 2 K2a, 2
    K2d, 2 K2e and 1 each of K3/K4 (the dense block only)."""
    import math

    from pytorch_distributed_training_tpu_torch.models import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(vocab_size=32768, max_len=2048, embed_dim=1024, depth=2, num_heads=16,
              fused_tails=True, flash=True, moe_experts=8, moe_top_k=2,
              moe_capacity_factor=1.25, moe_aux_weight=0.01, moe_every=2)
    cpu = TransformerLM(**kw)
    cpu.reset_parameters(torch.Generator().manual_seed(seed))
    gpu = TransformerLM(**kw)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.cuda()
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, kw["vocab_size"], (batch, seq), generator=gen)
    labels = torch.randint(0, kw["vocab_size"], (batch, seq), generator=gen)
    want = moe_objective(torch, cpu, tokens, labels)
    for m in modules:
        m.reset_launch_counts()
    got = moe_objective(torch, gpu, tokens.cuda(), labels.cuda())
    counts = all_counts(modules)
    check_launches("MoE step vs CPU", counts,
                   dict(add_layernorm=1, bias_gelu=1, ce_fwd=1, ce_bwd=1, flash_fwd=2,
                        flash_bwd=4, K2a=2, K2d=2, K2e=2))
    probs = torch.softmax(want["routed"][0], -1).sort(-1, descending=True).values
    gaps = dict(top1_top2=(probs[..., 0] - probs[..., 1]).min().item(),
                top2_top3=(probs[..., 1] - probs[..., 2]).min().item())
    same_experts = all(torch.equal(torch.topk(g, 2).indices, torch.topk(w, 2).indices)
                       for g, w in zip(got["routed"], want["routed"]))
    sound = moe_readings(got, want)
    say(f"  card vs CPU: {sound}; loss card {got['loss']!r} cpu {want['loss']!r}, aux card "
        f"{got['aux']!r} cpu {want['aux']!r}; chosen experts identical: {same_experts}; "
        f"smallest probability gaps {gaps}; launches {counts}")
    moe = gpu.block1.moe
    cap = moe.capacity(seq)
    route = moe.route

    def raw_gates(x):
        probs_, gate, expert, place, keep = route(x)
        return probs_, probs_.gather(-1, expert), expert, place, keep

    variants = {}
    for name, attr, value in (
            ("gates not renormalised", "route", raw_gates),
            ("capacity without k", "capacity",
             lambda s: max(1, math.ceil(moe.capacity_factor * s / moe.num_experts))),
            ("no aux term", None, None)):
        if attr is not None:
            setattr(moe, attr, value)
        else:
            gpu.moe_aux_weight = 0.0
        try:
            variants[name] = moe_readings(moe_objective(torch, gpu, tokens.cuda(), labels.cuda()),
                                          want)
        finally:
            if attr is not None:
                delattr(moe, attr)
            else:
                gpu.moe_aux_weight = kw["moe_aux_weight"]
        say(f"  wrong variant {name}: {variants[name]} -> "
            f"{'within' if moe_within(variants[name]) else 'outside'}")
    if not same_experts:
        raise AssertionError(f"MoE routing: the card chose other experts than the CPU ({gaps})")
    if not moe_within(sound):
        raise AssertionError(f"MoE step: card vs CPU outside its limits: {sound}")
    inside = [n for n, r in variants.items() if moe_within(r)]
    if inside:
        raise AssertionError(f"MoE step: wrong variants within the limits: {inside}")
    del cpu, gpu
    torch.cuda.empty_cache()
    return dict(card_vs_cpu=sound, loss_card=got["loss"], loss_cpu=want["loss"],
                aux_card=got["aux"], aux_cpu=want["aux"], capacity=cap, gaps=gaps,
                variants=variants, counts=counts)


def moe_step_flops(model, batch: int, seq: int) -> dict:
    """Model FLOP of one training step (3 x forward, the recompute not
    counted), two ways: ``executed``, every product that runs at its shape
    (the dense matmuls, attention's causal half, and in each MoE block the
    dispatch and combine products over ``E x C`` places a group and the
    experts over all of those places, empty ones too); ``active``, 2 x the
    parameters a token meets (its top k experts, not the others) plus the
    same attention."""
    d, tokens = model.embed_dim, batch * seq
    dense = sum(p.numel() for n, p in model.named_parameters()
                if n.endswith(".weight") and p.dim() == 2)
    attn = 2 * 2 * d * model.depth * batch * seq * (seq + 1) // 2
    executed = active = 2 * dense * tokens + attn
    for block in model.blocks:
        if block.is_moe:
            moe = block.moe
            e, _, h = moe.wi.shape
            places = e * moe.capacity(seq)
            executed += batch * (2 * 2 * seq * places * d + 2 * 2 * places * d * h)
            active += 2 * tokens * moe.top_k * 2 * d * h
    return dict(executed=3.0 * executed, active=3.0 * active)


# --profile: the MoE step's device time by class.  Each op's own kernels
# (self device time), so no kernel counts twice; a bmm with the group size
# (S) among its shapes is a dispatch or combine product (or its gradient),
# any other bmm an expert product; an mm/addmm with the vocabulary among
# its shapes is the head's, any other a dense layer's (attention, the dense
# blocks' MLPs, the routers)
MOE_ROUTING_OPS = ("aten::cumsum", "aten::one_hot", "aten::scatter", "aten::scatter_",
                   "aten::topk", "aten::_softmax", "aten::_softmax_backward_data",
                   "aten::gather", "aten::sort", "aten::value_selecting_reduction_backward")


def profile_moe_step(torch, runner, seq: int) -> dict:
    """``--profile``: one MoE training step after a warm one, its device time
    in the classes of phase 25 (c) and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def self_us(e):
        return next((getattr(e, n) for n in ("self_device_time_total", "self_cuda_time_total")
                     if getattr(e, n, None)), 0)

    inp, lab = next(iter(runner.train_loader))
    tokens, labels = runner._to_device(inp, lab)
    runner.train_step(tokens, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        runner.train_step(tokens, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and self_us(e) > 0]
    busy_ms = sum(self_us(e) for e in kernels) / 1e3
    vocab = runner.model.vocab_size
    classes = {"expert bmms": 0.0, "dispatch and combine bmms": 0.0,
               "routing (one-hot, cumsum, scatter, top-k, softmax)": 0.0,
               "attention (flash kernels)": 0.0, "head (vocab GEMMs, CE kernels)": 0.0,
               "dense GEMMs (qkv, proj, fc1, fc2, routers)": 0.0,
               "copies and casts (aten::copy_)": 0.0}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != DeviceType.CPU or not self_us(e):
            continue
        dims = {n for shape in (e.input_shapes or []) for n in (shape or [])}
        ms = self_us(e) / 1e3
        if e.key == "aten::bmm":
            classes["dispatch and combine bmms" if seq in dims else "expert bmms"] += ms
        elif e.key in MOE_ROUTING_OPS:
            classes["routing (one-hot, cumsum, scatter, top-k, softmax)"] += ms
        elif e.key in ("aten::mm", "aten::addmm"):
            classes["head (vocab GEMMs, CE kernels)" if vocab in dims
                    else "dense GEMMs (qkv, proj, fc1, fc2, routers)"] += ms
        elif e.key == "aten::copy_":
            classes["copies and casts (aten::copy_)"] += ms
    for e in kernels:
        if "flash" in e.key:
            classes["attention (flash kernels)"] += self_us(e) / 1e3
        elif e.key.startswith("ce_"):
            classes["head (vocab GEMMs, CE kernels)"] += self_us(e) / 1e3
    classes["the rest"] = busy_ms - sum(classes.values())
    say(f"  profile MoE train step: wall {wall_ms} ms, device kernel time {busy_ms} ms, busy "
        f"share {busy_ms / wall_ms}, kernel launches {sum(e.count for e in kernels)}")
    for name, ms in classes.items():
        say(f"    {ms:9.3f} ms  {ms / busy_ms:.4f}  {name}")
    for e in sorted(kernels, key=lambda e: -self_us(e))[:15]:
        say(f"    {self_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")
    return dict(wall_ms=wall_ms, device_ms=busy_ms, busy=busy_ms / wall_ms, classes_ms=classes)


# phase 25 (b)'s depth in the whole script's run, cut so that the script
# with phase 28 stays inside its time (a run of it took 1,182.9 s on an H100
# 80GB HBM3 at 700 W with 16 blocks here); ``--moe`` runs the config's 16
MOE_DEFAULT_RUN_DEPTH = 4


def phase_moe(torch, modules, profile: bool, depth=None) -> dict:
    """Phase 25: (a) :func:`phase_moe_vs_cpu`; (b) the runner on
    ``configs/train-lm-moe.yml`` (its depth cut to ``depth`` if given;
    full width, 8 experts, bf16, batch 64 as
    8 micro-batches of 8, block remat) for 1 warm-up and 3 timed steps and
    one validation of 2 batches: per step exactly 8 K1a and 8 K1b, 8 x 2 x
    depth K2a and K2c launches (every block's forward run again by the
    recompute), 8 x 2 x the dense blocks each of K3/K4; per validation
    batch (run as the step's 8 micro-batches) 8 K1a, 8 x depth K2a and 8 x
    the dense blocks each of K3/K4; step ms, tokens/s,
    MFU on both FLOP counts of :func:`moe_step_flops`, peak memory, the aux
    term (matmul TF32 off, torch's default, as in (a): the f32 head and
    router run as FP32 GEMMs); (c) with ``profile``,
    :func:`profile_moe_step`.  Returns the runner's launch counts."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg

    t_phase = time.perf_counter()
    gate = phase_moe_vs_cpu(torch, modules)
    cfg, cut = get_cfg(MOE_CONFIG), depth
    if cut is not None:
        cfg["model"]["depth"] = cut
    depth, n = cfg["model"]["depth"], cfg["training"]["grad_accumulation"]
    every = cfg["model"]["moe_every"]
    dense = sum(1 for i in range(depth) if i % every != every - 1)
    batch, seq = cfg["training"]["batch_size"], cfg["dataset"]["seq_len"]
    runner, counts, run = phase_runner(
        torch, modules, MOE_CONFIG, "train-lm-moe", steps=4,
        edit=None if cut is None else (lambda c: c["model"].update(depth=cut)),
        step_flops=lambda model, b, s: moe_step_flops(model, b, s)["executed"],
        per_step=dict(ce_fwd=n, ce_bwd=n, flash_fwd=n * 2 * depth, flash_bwd=n * 2 * depth,
                      K2a=n * 2 * depth, K2c=n * 2 * depth, add_layernorm=n * 2 * dense,
                      bias_gelu=n * 2 * dense),
        per_val_batch=dict(ce_fwd=n, flash_fwd=n * depth, K2a=n * depth,
                           add_layernorm=n * dense, bias_gelu=n * dense))
    if runner.path != "gspmd" or runner.train_step.grad_accum != n or not runner.model.remat:
        raise AssertionError("phase 25 did not run the accumulated MoE step with block remat")
    flops = moe_step_flops(runner.model, batch, seq)
    step_s = run["median_step_ms"] / 1e3
    run.update(aux=float(runner.train_step.aux), dense_blocks=dense, moe_blocks=depth - dense,
               model_flop_executed=flops["executed"], model_flop_active=flops["active"],
               mfu_executed=flops["executed"] / step_s / BF16_FLOPS,
               mfu_active=flops["active"] / step_s / BF16_FLOPS)
    say(f"  {run['moe_blocks']} MoE blocks of {depth}, {n} micro-batches of {batch // n} x "
        f"{seq}: aux objective {run['aux']} of loss {run['losses'][-1]}; model FLOP a step "
        f"executed {flops['executed']:.4g} (MFU {run['mfu_executed']}), active "
        f"{flops['active']:.4g} (MFU {run['mfu_active']}) at 989 TFLOP/s")
    numbers = dict(gate=gate, runner=run)
    if profile:
        say("== profile (MoE train step)")
        numbers["profile"] = profile_moe_step(torch, runner, seq)
    del runner
    torch.cuda.empty_cache()
    numbers["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 25 took {numbers['phase_s']:.1f} s")
    say("moe: " + json.dumps(numbers))
    return counts


# phase 26: the sequence-parallel attention of config/TransformerLM-sp.yml:
# batch 2 a card, seq 32768, 8 heads of 64, a ring of 4 ranks
SP_SHAPE = (2, 32768, 8, 64)
SP_RING = 4
# (b) and (c) against the whole sequence's bf16 flash: the ring combines
# f32-dot blocks in f32, the reference takes bf16 dots over the whole
# sequence, so the two differ by bf16 roundings of p and of each block's
# gradients (summed in bf16 across the ring's blocks, as JAX's AD sums
# them): about two bf16 ulps elementwise, and a norm limit for each tensor
# as a whole (at [1, 2048, 4, 64] on the CPU twins the ring read 2.1e-3 to
# 3.5e-3 of each tensor's norm, and half of the elementwise limit)
SP_TOL = dict(atol=1e-2, rtol=2e-2)
SP_NORM_LIMIT = {"o": 1e-2, "dq": 1e-2, "dk": 1e-2, "dv": 1e-2}


def sp_fold(x):
    """``[B, S, H, ...]`` to the kernels' ``[BH, S, ...]``."""
    b, s_len, h = x.shape[:3]
    return x.transpose(1, 2).reshape(b * h, s_len, *x.shape[3:])


def sp_unfold(x, b: int, h: int):
    return x.reshape(b, h, *x.shape[1:]).transpose(1, 2)


def sp_lse_gate(torch, fa, q, k, v, do, g_lse, causal: bool, label: str) -> tuple:
    """Phase 26 (a) at one mask: ``flash_attention_lse`` with f32 dots on
    bf16 inputs, through autograd with cotangents on o and lse, must launch
    exactly one forward (K2a) and one split backward (K2d + K2e) and equal
    its own kernels' f32 outputs (o, lse; dq, dk, dv before their one
    rounding to bf16) bit for bit; those are held against the f32 twin
    within the f32 flash limits, and two wrong variants must fall outside:
    the backward without the lse cotangent in delta, and the bf16 kernels'
    arithmetic (bf16 dots, the twin of ``out_f32=False``).  Returns
    (checks, the f32 tensors for timing)."""
    b, s_len, h, d = q.shape
    scale = 1.0 / d ** 0.5
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_lse(*leaves, causal=causal)
    torch.autograd.backward((o, lse), (do, g_lse))
    got = {**fa.launch_counts(), **fa.tpu_launch_counts()}
    check_launches(f"flash_attention_lse {label}", got,
                   {"flash_fwd": 1, "flash_bwd": 2, "K2a": 1, "K2d": 1, "K2e": 1})
    qf, kf, vf = (sp_fold(x).float() for x in (q, k, v))
    dof, glf = sp_fold(do), sp_fold(g_lse)
    o32, lse32 = fa.flash_forward(qf, kf, vf, causal, scale)
    delta = (dof * o32).sum(-1) - glf
    grads32 = fa.flash_backward(qf, kf, vf, dof, lse32, delta, causal, scale)
    same = (torch.equal(sp_unfold(o32, b, h), o) and torch.equal(sp_unfold(lse32, b, h), lse)
            and all(torch.equal(sp_unfold(g, b, h).to(x.dtype), x.grad)
                    for g, x in zip(grads32, leaves)))
    if not same:
        raise AssertionError(f"flash_attention_lse {label}: the entry point differs from its "
                             "kernels' outputs")
    o_t, lse_t = fa.flash_fwd_plain(qf, kf, vf, causal, scale)
    delta_t = (dof * o_t).sum(-1) - glf
    twin = fa.flash_bwd_plain(qf, kf, vf, dof, lse_t, delta_t, causal, scale)
    tol, limit = FLASH_TOL_LONG["float32"], FLASH_NORM_LIMIT["float32"]
    checks = [(f"flash_attention_lse lse {label}", readings(lse32, lse_t, atol=1e-5, rtol=1e-5),
               None, True)]
    for what, a, c in zip(("o", "dq", "dk", "dv"), (o32, *grads32), (o_t, *twin)):
        checks.append((f"flash_attention_lse {what} {label}", readings(a, c, **tol),
                       limit[what], True))
    # g_lse left out of delta: dq and dk move, dv (P^T dO) does not
    no_fold = fa.flash_bwd_plain(qf, kf, vf, dof, lse_t, delta_t + glf, causal, scale)
    for what, a, c in zip(("dq", "dk", "dv"), no_fold, twin):
        checks.append((f"flash_attention_lse {what} {label}, g_lse left out of delta",
                       readings(a, c, **tol), limit[what], False if what != "dv" else None))
    # bf16 dots: what the bf16 kernels compute on the same inputs
    qb, kb, vb = (sp_fold(x).contiguous() for x in (q, k, v))
    o_b, lse_b = fa.flash_fwd_plain(qb, kb, vb, causal, scale)
    wrong = fa.flash_bwd_plain(qb, kb, vb, dof.to(q.dtype), lse_b,
                               (dof * o_b.float()).sum(-1) - glf, causal, scale)
    for what, a, c in zip(("o", "dq", "dk", "dv"), (o_b, *wrong), (o_t, *twin)):
        checks.append((f"flash_attention_lse {what} {label}, bf16 dots",
                       readings(a, c, **tol), limit[what], False))
    return checks, (qf, kf, vf, dof, lse_t, delta_t, o_t, twin, o32, lse32, grads32)


def sp_loopback(torch, loops, do):
    """Run the 4 virtual ranks' generators of one attention in one process
    and differentiate: (o, dq, dk, dv) over the whole sequence."""
    from pytorch_distributed_training_tpu_torch.parallel import loopback

    leaves, gens = loops
    o = torch.cat(loopback(gens), 1)
    o.backward(do)
    return [o.detach()] + [torch.cat([x.grad for x in xs], 1) for xs in leaves]


def sp_rank_loops(torch, q, k, v, n: int, kind: str):
    """Each virtual rank's ``[B, S/n, H, D]`` leaves and its generator:
    the ring with ``impl=None`` (flash on the card, as the model picks it)
    or Ulysses with the flash kernels."""
    from pytorch_distributed_training_tpu_torch.parallel.sequence import (
        ring_attention_loop,
        ulysses_attention_loop,
    )

    sl = q.shape[1] // n
    leaves = [[x[:, r * sl:(r + 1) * sl].clone().requires_grad_(True) for r in range(n)]
              for x in (q, k, v)]
    if kind == "ring":
        gens = [ring_attention_loop(leaves[0][r], leaves[1][r], leaves[2][r], n, r, True)
                for r in range(n)]
    else:
        gens = [ulysses_attention_loop(leaves[0][r], leaves[1][r], leaves[2][r], n, True,
                                       impl="flash") for r in range(n)]
    return leaves, gens


def phase_sequence_parallel(torch, modules, smi: str) -> dict:
    """Phase 26: (a) :func:`sp_lse_gate` at the ring's block shape of
    ``config/TransformerLM-sp.yml``, [2, 8192, 8, 64] bf16, causal and not,
    each launch timed beside its bound (f32 at the 3xTF32 rate), the twin
    and SDPA in f32 on the upcast inputs, with the cost of the ``out_f32``
    copies; (b) ring attention at the full shape, S = 32768 as 4 virtual
    ranks of 8192 in one process (``parallel.sequence.loopback``), causal,
    forward and backward, against the whole sequence's bf16
    ``flash_attention`` (o, dq, dk, dv), with exactly 4 causal and 6 full
    f32-dot forwards (K2a) and their 10 split backward pairs (K2d, K2e);
    (c) Ulysses likewise, each virtual rank's bf16 flash over [2, 32768, 2,
    64] (4 K2b, 4 K2f, 4 K2g).  The path's launches are those of (b)'s and
    (c)'s runs alone.  Returns them, and (a)'s rows by kernel."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fa = modules[2]
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    b, s_len, h, d = SP_SHAPE
    n, bf16, scale = SP_RING, torch.bfloat16, 1.0 / SP_SHAPE[3] ** 0.5
    sl = s_len // n
    rows = {"lse_fwd": [], "lse_dq": [], "lse_dkv": []}
    numbers = {"card": smi}

    def err(a, c):
        return (a.float() - c.float()).abs().max().item()

    # (a)
    checks = []
    for causal in (True, False):
        mask = "causal" if causal else "full"
        q, k, v = (torch.randn(b, sl, h, d, generator=gen, device=dev).to(bf16)
                   for _ in range(3))
        do = torch.randn(b, sl, h, d, generator=gen, device=dev)
        g_lse = torch.randn(b, sl, h, generator=gen, device=dev)
        label = f"[{b}, {sl}, {h}, {d}] bf16, f32 dots, {mask}"
        found, kept = sp_lse_gate(torch, fa, q, k, v, do, g_lse, causal, label)
        checks += found
        qf, kf, vf, dof, lse_t, delta_t, o_t, twin, o32, lse32, grads32 = kept
        q4, k4, v4 = (x.view(b, h, sl, d).detach().requires_grad_(True) for x in (qf, kf, vf))
        lib_fwd = lib_bwd = None
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):  # f32: no flash backend
            try:
                o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
                lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4.detach(), k4.detach(), v4.detach(), is_causal=causal), flush)
                lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                    o4, (q4, k4, v4), dof.view(b, h, sl, d), retain_graph=True), flush)
                del o4
            except RuntimeError as exc:  # no fused SDPA backend for this shape
                say(f"  SDPA {label}: {exc}")
        del q4, k4, v4
        plain_bwd = time_ms(torch, lambda: fa.flash_bwd_plain(
            qf, kf, vf, dof, lse_t, delta_t, causal, scale), flush, 5, 1)
        for name, part, kernel, plain_ms, e, lib in (
                ("lse_fwd", None, lambda: fa.flash_forward(qf, kf, vf, causal, scale),
                 time_ms(torch, lambda: fa.flash_fwd_plain(qf, kf, vf, causal, scale), flush,
                         5, 1), max(err(o32, o_t), err(lse32, lse_t)), lib_fwd),
                ("lse_dq", "dq", lambda: fa.flash_backward_dq(qf, kf, vf, dof, lse_t, delta_t,
                                                              causal, scale),
                 plain_bwd, err(grads32[0], twin[0]), lib_bwd),
                ("lse_dkv", "dkv", lambda: fa.flash_backward_dkv(qf, kf, vf, dof, lse_t,
                                                                 delta_t, causal, scale),
                 plain_bwd, max(err(grads32[1], twin[1]), err(grads32[2], twin[2])), lib_bwd)):
            rows[name].append(dict(
                shape=[b, h, sl, d], dtype="bfloat16 in, float32 dots", causal=causal,
                tpu_kernel={"lse_fwd": "K2a", "lse_dq": "K2d", "lse_dkv": "K2e"}[name],
                max_abs_err=e, ms=time_ms(torch, kernel, flush),
                call_ms=call_ms(torch, kernel), plain_ms=plain_ms, library_ms=lib,
                **flash_bound(fa, b * h, sl, d, torch.float32, causal, part=part)))
        # the out_f32 path's own copies: q, k, v upcast once a call, dq, dk,
        # dv rounded to bf16 once; beside them the three kernels and the
        # entry point's forward and backward as autograd runs them
        folded = [sp_fold(x).contiguous() for x in (q, k, v)]
        entry = [x.clone().requires_grad_(True) for x in (q, k, v)]

        def fwd_bwd():
            o, lse = fa.flash_attention_lse(*entry, causal=causal)
            torch.autograd.backward((o, lse), (do, g_lse))

        cost = dict(upcast_ms=time_ms(torch, lambda: [x.float() for x in folded], flush),
                    downcast_ms=time_ms(torch, lambda: [g.to(bf16) for g in grads32], flush),
                    kernels_ms=sum(rows[r][-1]["ms"] for r in rows),
                    entry_fwd_bwd_ms=time_ms(torch, fwd_bwd, flush, 10, 2))
        numbers[f"a_{mask}"] = cost
        say(f"  (a) {label}: " + " ".join(f"{k}={v}" for k, v in cost.items()))
        del q, k, v, do, g_lse, kept, found, entry, folded
        torch.cuda.empty_cache()
    judge(checks)
    for name, cases in rows.items():
        for c in cases:
            say(f"  {name} ({c['tpu_kernel']}) {c['shape']} {c['dtype']} "
                f"{'causal' if c['causal'] else 'full'}: kernel_ms={c['ms']} "
                f"plain_ms={c['plain_ms']} library_ms={c['library_ms']} "
                f"bound_ms={c['bound_ms']} ({c['bound_by']}) {shares(c)} "
                f"call_ms={c['call_ms']} max_abs_err={c['max_abs_err']}")

    # (b) and (c): the whole sequence's bf16 flash is the reference
    q, k, v, do = (torch.randn(b, s_len, h, d, generator=gen, device=dev).to(bf16)
                   for _ in range(4))
    whole = [x.clone().requires_grad_(True) for x in (q, k, v)]

    def whole_run():
        for x in whole:
            x.grad = None
        o = fa.flash_attention(*whole, causal=True)
        o.backward(do)
        return [o.detach()] + [x.grad for x in whole]

    want = whole_run()
    path = {}
    want_counts = {
        "ring": {"flash_fwd": n * (n + 1) // 2, "flash_bwd": n * (n + 1),
                 "K2a": n * (n + 1) // 2, "K2d": n * (n + 1) // 2, "K2e": n * (n + 1) // 2},
        "ulysses": {"flash_fwd": n, "flash_bwd": 2 * n, "K2b": n, "K2f": n, "K2g": n}}
    checks = []
    for kind in ("ring", "ulysses"):
        loops = sp_rank_loops(torch, q, k, v, n, kind)
        for m in modules:
            m.reset_launch_counts()
        got = sp_loopback(torch, loops, do)
        torch.cuda.synchronize()
        counts = all_counts(modules)
        check_launches(f"{kind} attention, {n} virtual ranks", counts, want_counts[kind])
        path = {key: path.get(key, 0) + val for key, val in counts.items()}
        label = f"{kind}, [{b}, {s_len}, {h}, {d}] bf16 as {n} ranks of {sl}, causal"
        for what, a, c in zip(("o", "dq", "dk", "dv"), got, want):
            checks.append((f"{label}: {what} against the whole sequence's flash",
                           readings(a, c, **SP_TOL), SP_NORM_LIMIT[what], True))
        bitwise = all(torch.equal(a, c) for a, c in zip(got, want))
        del got
        # wall time of one forward and backward of the 4 ranks, then of the
        # whole sequence's flash
        times = {}
        for what, fn in ((kind, lambda: sp_loopback(torch, sp_rank_loops(torch, q, k, v, n, kind),
                                                    do)),
                         ("whole", whole_run)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[f"{what}_fwd_bwd_ms"] = (time.perf_counter() - t0) * 1e3
        numbers[kind] = dict(bitwise_equal_whole=bitwise, **times)
        say(f"  ({'b' if kind == 'ring' else 'c'}) {label}: launches {counts_line(counts)}; "
            f"bitwise equal to the whole sequence's flash: {bitwise}; "
            + " ".join(f"{key}={val}" for key, val in times.items()))
        del loops
        torch.cuda.empty_cache()
    judge(checks)
    del q, k, v, do, whole, want, flush
    torch.cuda.empty_cache()
    numbers["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 26 took {numbers['phase_s']:.1f} s; {smi}")
    say("sp: " + json.dumps(numbers))
    return path, rows


# phase 27: Megatron tensor parallelism and expert parallelism at degree 4,
# four gloo ranks as processes on the one card (NCCL takes one rank a card)
TP_CONFIG = os.path.join(_HERE, "pytorch_distributed_training_tpu_torch", "configs",
                         "train-lm-tp.yml")
EP_CONFIG = os.path.join(_HERE, "pytorch_distributed_training_tpu_torch", "configs",
                         "train-lm-moe-ep.yml")
TP_DIR = os.path.join(_HERE, "run", "chip_smoke", "tp")
TP_RANKS = 4
# (a)'s model: full width, depth 2 (block 1 a MoE block of 8 experts in
# the MoE case), f32, a batch of 2 x 256
TP_GATE_KW = dict(vocab_size=32768, max_len=2048, embed_dim=1024, depth=2, num_heads=16,
                  fused_tails=True, flash=True)
TP_GATE_MOE_KW = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
                      moe_aux_weight=0.01, moe_every=2)
TP_GATE_SGD = dict(lr=0.01, momentum=0.9)
TP_GATE_BATCH, TP_GATE_SEQ, TP_GATE_STEPS = 2, 256, 2
# (a)'s limits are tests/test_torch_tensor_parallel.py's, where T ranks held
# against one rank in f32 measured losses equal to 1e-7, parameters after two
# steps 1.1e-7 and gradients 2.2e-6 of their largest magnitude: the losses
# within rtol 1e-6, every gathered gradient within 1e-5 and every gathered
# parameter within 1e-6 of its largest magnitude
TP_LOSS_RTOL, TP_GRAD_LIMIT, TP_PARAM_LIMIT = 1e-6, 1e-5, 1e-6


def tp_probe_gloo(torch) -> str:
    """Phase 1: gloo's ``all_reduce`` of CUDA bf16 tensors over two ranks
    (threads of this process), the dtype the port's copy and reduce take on
    the bf16 stream.  Raises if gloo refuses bf16 or sums wrong."""
    import threading
    from datetime import timedelta

    import torch.distributed as dist

    store, got, errors = dist.HashStore(), {}, []

    def rank(r):
        try:
            pg = dist.ProcessGroupGloo(store, r, 2, timedelta(seconds=60))
            t = torch.full((1024,), float(r + 1), dtype=torch.bfloat16, device="cuda")
            pg.allreduce([t]).wait()
            torch.cuda.synchronize()
            got[r] = t
        except BaseException as err:  # raised below, in the phase's thread
            errors.append(err)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    if errors or len(got) != 2:
        raise AssertionError(f"gloo all_reduce of CUDA bf16 tensors: {errors}")
    for t in got.values():
        if t.dtype != torch.bfloat16 or not bool((t == 3.0).all()):
            raise AssertionError(f"gloo all_reduce of CUDA bf16 tensors summed {t[:4]}")
    return "bfloat16"


def tp_gate_weights(torch, kind: str, seed: int, kw=None) -> dict:
    """(a)'s full weights, on the CPU: flax's init from ``seed``, then
    every bias drawn at 0.02 and every LayerNorm scale at 1 + 0.1 n, so
    that a row-parallel bias counted ``T`` times moves the first forward
    (``kw``: another model's, phase 29's)."""
    from pytorch_distributed_training_tpu_torch.models import TransformerLM

    kw = kw or dict(TP_GATE_KW, **(TP_GATE_MOE_KW if kind == "moe" else {}))
    model = TransformerLM(**kw)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.02, generator=gen)
            elif ".ln" in name and name.endswith("weight"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return {k: v.clone() for k, v in model.state_dict().items()}


def tp_gate_batch(torch, seed: int = 27):
    gen = torch.Generator().manual_seed(seed)
    shape = (TP_GATE_BATCH, TP_GATE_SEQ)
    return (torch.randint(0, TP_GATE_KW["vocab_size"], shape, generator=gen),
            torch.randint(0, TP_GATE_KW["vocab_size"], shape, generator=gen))


def tp_gate_steps(torch, kind: str, full: dict, tokens, labels, tg=None) -> dict:
    """``TP_GATE_STEPS`` SGD steps of the GSPMD-path step on the card from
    ``full`` (this rank's slices of it under ``tg``): the losses, every
    step's gradients before the update and the parameters after, gathered
    over the model group (a collective on every rank), on the CPU."""
    from pytorch_distributed_training_tpu_torch import optimizers
    from pytorch_distributed_training_tpu_torch.engine.tp_steps import build_tp_lm_train_step
    from pytorch_distributed_training_tpu_torch.models import TransformerLM
    from pytorch_distributed_training_tpu_torch.parallel.tensor import gather_param, shard_dim

    kw = dict(TP_GATE_KW, **(TP_GATE_MOE_KW if kind == "moe" else {}))
    model = TransformerLM(**kw, tensor_group=tg)
    model.load_full_state_dict(full)
    model.cuda()
    step = build_tp_lm_train_step(model, optimizers.SGD(**TP_GATE_SGD),
                                  lambda i: TP_GATE_SGD["lr"])
    names = [n for n, _ in model.named_parameters()]
    grads = []
    update = step.optimizer.update

    def record(params, gs, state, lr):
        grads.append({n: gather_param(g, shard_dim(n), tg).cpu() if tg is not None
                      else g.cpu() for n, g in zip(names, gs)})
        return update(params, gs, state, lr)

    step.optimizer.update = record
    losses = [float(step(tokens.cuda(), labels.cuda())) for _ in range(TP_GATE_STEPS)]
    after = {k: v.cpu() for k, v in model.full_state_dict().items()}
    return dict(losses=losses, grads=grads, after=after)


def tp_gate_readings(got: dict, want: dict) -> dict:
    return dict(
        loss=max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])),
        grad=max(relative_to_largest(gs[n], ws[n])
                 for gs, ws in zip(got["grads"], want["grads"]) for n in ws),
        param=max(relative_to_largest(got["after"][n], w) for n, w in want["after"].items()))


def tp_gate_within(r: dict) -> bool:
    return (r["loss"] <= TP_LOSS_RTOL and r["grad"] <= TP_GRAD_LIMIT
            and r["param"] <= TP_PARAM_LIMIT)


def tp_bias_on_every_rank(torch):
    """A wrong row-parallel Dense: the bias added before the reduce, on
    every rank (so ``T`` times)."""
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops import layers

    plain = layers.Dense.forward

    def forward(self, x):
        if self.split != "row":
            return plain(self, x)
        d = self.dtype
        return layers.reduce_from_model(
            F.linear(x.to(d), self.weight.to(d), self.bias.to(d)), self.tensor_group)

    return layers.Dense, "forward", forward


def tp_reduce_all_reducing_backward(torch):
    """A wrong *reduce*: ``torch.distributed.nn.functional.all_reduce``,
    whose backward all-reduces again."""
    from torch.distributed.nn.functional import all_reduce

    from pytorch_distributed_training_tpu_torch.ops import layers

    return layers, "reduce_from_model", lambda x, tg: all_reduce(x, group=tg.group)


TP_VARIANTS = {"row bias on every rank": tp_bias_on_every_rank,
               "reduce with an all-reducing backward": tp_reduce_all_reducing_backward}


def tp_kernel_shapes(modules) -> tuple:
    """Wrap the kernel wrappers (their module attributes and their
    ``KERNELS`` entries) to record the shapes and dtypes they are called
    with; a wrapper counts its launches on its own name, so the wrap holds
    the count while it is in place.  Returns the record and a function that
    puts the originals back, counts included."""
    fe, ce, fa = modules
    seen, undo = {}, []
    for mod, name, key in ((ce, "fused_ce_forward", "K1a"), (ce, "fused_ce_backward", "K1b"),
                           (fa, "flash_forward", "K2a (q folded [B*H, S, D])"),
                           (fa, "flash_backward", "K2c (q folded [B*H, S, D])"),
                           (fe, "fused_add_layernorm", "K3"), (fe, "fused_bias_gelu", "K4")):
        plain = getattr(mod, name)

        def wrapped(first, *args, _plain=plain, _key=key, **kw):
            seen.setdefault(_key, set()).add(f"{list(first.shape)} {first.dtype}".replace(
                "torch.", ""))
            return _plain(first, *args, **kw)

        wrapped.launches = plain.launches
        setattr(mod, name, wrapped)
        entry = next(k for k, fn in mod.KERNELS.items() if fn is plain)
        mod.KERNELS[entry] = wrapped
        undo.append((mod, name, entry, plain, wrapped))

    def restore():
        for mod, name, entry, plain, wrapped in undo:
            plain.launches = wrapped.launches
            setattr(mod, name, plain)
            mod.KERNELS[entry] = plain

    return seen, restore


def tp_exchange_timer(torch) -> dict:
    """Time every all-reduce of the model group's copy and reduce
    (``parallel.tensor._all_reduce``), synchronised before and after so
    that only the exchange is counted (gloo copies through the host)."""
    from pytorch_distributed_training_tpu_torch.parallel import tensor

    plain, clock = tensor._all_reduce, dict(seconds=0.0, calls=0, bytes=0)

    def timed(t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(t, group)
        torch.cuda.synchronize()
        clock["seconds"] += time.perf_counter() - t0
        clock["calls"] += 1
        clock["bytes"] += t.numel() * t.element_size()
        return out

    tensor._all_reduce = timed
    return clock


def tp_runner_readings(torch, modules, config: str, rank: int, port: int,
                       edit=None, steps: int = 4) -> dict:
    """(b) on one rank: the runner on ``config`` (then ``edit(cfg)``'s cuts)
    for ``steps`` steps (1 warm-up, the rest timed) and one validation
    batch, its launches a step and in the
    validation, their shapes, the step ms, the model group's exchange ms a
    step and the peak memory of this process."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg
    from pytorch_distributed_training_tpu_torch.engine import Runner

    cfg = get_cfg(config)
    cfg["training"].update(train_iters=steps, print_interval=1, val_interval=steps)
    cfg["dataset"]["n_samples"] = cfg["training"]["batch_size"]  # 1 validation batch
    if edit is not None:
        edit(cfg)
    clock = tp_exchange_timer(torch)
    shapes, restore = tp_kernel_shapes(modules)
    marks = []

    def on_iter(runner):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), all_counts(modules), clock["seconds"]))

    for m in modules:
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = Runner(num_nodes=TP_RANKS, rank=rank, seed=0, dist_url=f"tcp://127.0.0.1:{port}",
                    multiprocessing=False, logger_queue=None, global_cfg=cfg, device="cuda",
                    dist_backend="gloo", on_iter=on_iter)
    runner()
    wall = time.perf_counter() - t0
    restore()
    final = all_counts(modules)
    prev, per_step = {k: 0 for k in final}, []
    for _, counts, _ in marks:
        per_step.append({k: counts[k] - prev[k] for k in final})
        prev = counts
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    exchange_ms = [(b[2] - a[2]) * 1e3 for a, b in zip(marks, marks[1:])]
    return dict(rank=rank, path=runner.path, n_data=runner.data_size,
                model_idx=runner.layout.model_idx, grad_accum=runner.train_step.grad_accum,
                remat=runner.model.remat, step_ms=step_ms, exchange_ms=exchange_ms,
                exchange_calls=clock["calls"], exchange_bytes=clock["bytes"],
                per_step=per_step, validation={k: final[k] - prev[k] for k in final},
                final=final, shapes={k: sorted(v) for k, v in shapes.items()},
                losses=[r["loss"] for r in runner.train_log], val=runner.val_log,
                aux=float(getattr(runner.train_step, "aux", 0.0) or 0.0),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, wall_s=wall,
                params_m=sum(p.numel() for p in runner.model.parameters()) / 1e6)


def tp_worker(rank: int, task: str, port: int, depth=None) -> None:
    """One of phase 27's ranks, a process of its own on ``cuda:0``: ``gate``
    runs (a)'s cases in turn over one gloo process group, ``tp`` and ``ep``
    run (b) on their config (its depth cut to ``depth`` if given).  Writes
    its results under ``TP_DIR``."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_training_tpu_torch.ops import fused_ce as ce
    from pytorch_distributed_training_tpu_torch.ops import fused_elementwise as fe

    modules = (fe, ce, fa)
    torch.cuda.set_device(0)
    if task != "gate":
        edit = None if depth is None else (lambda c: c["model"].update(depth=depth))
        out = tp_runner_readings(torch, modules, TP_CONFIG if task == "tp" else EP_CONFIG,
                                 rank, port, edit=edit, steps=tp_run_steps(depth))
        with open(os.path.join(TP_DIR, f"{task}.rank{rank}.json"), "w") as f:
            json.dump(out, f)
        return
    from datetime import timedelta

    import torch.distributed as dist

    from pytorch_distributed_training_tpu_torch.parallel import TPLayout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=TP_RANKS, rank=rank, timeout=timedelta(seconds=600))
    try:
        tg = TPLayout(TP_RANKS, rank, TP_RANKS).tensor_group
        tokens, labels = tp_gate_batch(torch)
        results, launches = {}, {}
        cases = [("dense", None), ("moe", None)] + [("dense", v) for v in TP_VARIANTS]
        for kind, variant in cases:
            full = torch.load(os.path.join(TP_DIR, f"full_{kind}.pt"), weights_only=True)
            undo = None
            if variant is not None:
                owner, attr, wrong = TP_VARIANTS[variant](torch)
                undo = (owner, attr, getattr(owner, attr))
                setattr(owner, attr, wrong)
            for m in modules:
                m.reset_launch_counts()
            try:
                results[variant or kind] = tp_gate_steps(torch, kind, full, tokens, labels, tg)
            finally:
                if undo is not None:
                    setattr(*undo)
            launches[variant or kind] = all_counts(modules)
        if rank == 0:
            torch.save(results, os.path.join(TP_DIR, "gate.pt"))
        with open(os.path.join(TP_DIR, f"gate.rank{rank}.json"), "w") as f:
            json.dump(launches, f)
    finally:
        dist.destroy_process_group()


def tp_spawn(torch, task: str, depth=None, worker=None, ports: int = 0) -> float:
    """Run ``worker`` (``tp_worker`` by default) on ``TP_RANKS`` spawned
    processes and wait for all; a rank that fails ends the others and raises
    here.  The worker takes a free port, or a list of ``ports`` free ports
    (one a process group it starts in turn).  Returns the wall s."""
    import socket

    import torch.multiprocessing as mp

    free = []
    for _ in range(max(ports, 1)):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            free.append(s.getsockname()[1])
    t0 = time.perf_counter()
    mp.start_processes(worker or tp_worker, args=(task, free if ports else free[0], depth),
                       nprocs=TP_RANKS, join=True, start_method="spawn")
    return time.perf_counter() - t0


def phase_tp_gate(torch, modules) -> dict:
    """Phase 27 (a): dense at T = 4 and MoE at EP = 4 (2 experts a rank),
    full width, depth 2, f32 with TF32 off, batch 2 x 256: each takes
    ``TP_GATE_STEPS`` SGD steps on four gloo ranks (processes on the card)
    from the same seeded full weights and batch as the one-rank step on the
    card; the loss, every gathered gradient before each update and every
    gathered parameter after held to ``TP_*`` limits, which two wrong dense
    variants must fail (:data:`TP_VARIANTS`); each rank's launches exact
    (every rank runs every kernel on its own slice: K2a/K2d/K2e at [2, 256,
    4, 64] f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(TP_DIR, exist_ok=True)
    tokens, labels = tp_gate_batch(torch)
    want, one_launches = {}, {}
    for i, kind in enumerate(("dense", "moe")):
        full = tp_gate_weights(torch, kind, seed=27 + i)
        torch.save(full, os.path.join(TP_DIR, f"full_{kind}.pt"))
        for m in modules:
            m.reset_launch_counts()
        want[kind] = tp_gate_steps(torch, kind, full, tokens, labels)
        one_launches[kind] = all_counts(modules)
    torch.cuda.empty_cache()
    wall = tp_spawn(torch, "gate")
    got = torch.load(os.path.join(TP_DIR, "gate.pt"), weights_only=True)
    ranks = [json.load(open(os.path.join(TP_DIR, f"gate.rank{r}.json")))
             for r in range(TP_RANKS)]
    steps, depth = TP_GATE_STEPS, TP_GATE_KW["depth"]
    for kind in want:
        dense = depth if kind == "dense" else 1
        # per rank, as the one rank: one K1 pair, a flash forward and split
        # backward a block, K3/K4 in the dense blocks, a step
        per_run = dict(ce_fwd=steps, ce_bwd=steps, flash_fwd=steps * depth,
                       flash_bwd=2 * steps * depth, K2a=steps * depth, K2d=steps * depth,
                       K2e=steps * depth, add_layernorm=steps * dense,
                       bias_gelu=steps * dense)
        check_launches(f"one rank {kind}", one_launches[kind], per_run)
        for r, launches in enumerate(ranks):
            check_launches(f"rank {r} {kind}", launches[kind], per_run)
    sound = {kind: tp_gate_readings(got[kind], want[kind]) for kind in want}
    variants = {v: tp_gate_readings(got[v], want["dense"]) for v in TP_VARIANTS}
    for kind, r in sound.items():
        say(f"  {kind} T = {TP_RANKS} vs one rank: {r} (losses {got[kind]['losses']} vs "
            f"{want[kind]['losses']}) -> {'within' if tp_gate_within(r) else 'OUTSIDE'}")
    for v, r in variants.items():
        say(f"  wrong variant {v}: {r} -> {'within' if tp_gate_within(r) else 'outside'}")
    say(f"  four ranks' wall {wall:.1f} s (spawn, build, 4 runs of {steps} steps)")
    bad = [k for k, r in sound.items() if not tp_gate_within(r)]
    if bad:
        raise AssertionError(f"tensor parallelism on the card outside its limits: {bad}")
    inside = [v for v, r in variants.items() if tp_gate_within(r)]
    if inside:
        raise AssertionError(f"tensor parallelism: wrong variants within the limits: {inside}")
    return dict(sound=sound, variants=variants, launches=ranks[0], wall_s=wall)


def phase_tp_runner(torch, task: str, config: str, smi: str, depth=None) -> dict:
    """Phase 27 (b) on ``config`` (its depth cut to ``depth`` if given):
    four gloo processes on the card through the runner
    (:func:`tp_runner_readings`); each rank's launches exact a
    step (K1a/K1b n, K2a/K2c n x 2 x depth, K3/K4 n x 2 x dense blocks:
    block remat runs each forward twice) and in the validation batch (run
    as n micro-batches); every loss finite and equal on the ranks.  Prints
    the step ms, tokens/s, each process's peak memory, the exchanges'
    share of the step and each rank's launches with their shapes beside the
    card.  Returns the four ranks' launch counts summed."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg

    cfg, cut = get_cfg(config), depth
    if cut is not None:
        cfg["model"]["depth"] = cut
    depth, n = cfg["model"]["depth"], cfg["training"]["grad_accumulation"]
    every = cfg["model"].get("moe_every", 0)
    dense = sum(1 for i in range(depth)
                if not (cfg["model"].get("moe_experts") and i % every == every - 1))
    batch, seq = cfg["training"]["batch_size"], cfg["dataset"]["seq_len"]
    wall = tp_spawn(torch, task, cut)
    ranks = [json.load(open(os.path.join(TP_DIR, f"{task}.rank{r}.json")))
             for r in range(TP_RANKS)]
    per_step = dict(ce_fwd=n, ce_bwd=n, flash_fwd=n * 2 * depth, flash_bwd=n * 2 * depth,
                    K2a=n * 2 * depth, K2c=n * 2 * depth, add_layernorm=n * 2 * dense,
                    bias_gelu=n * 2 * dense)
    per_val = dict(ce_fwd=n, flash_fwd=n * depth, K2a=n * depth, add_layernorm=n * dense,
                   bias_gelu=n * dense)
    for got in ranks:
        if got["path"] != "gspmd" or got["grad_accum"] != n or not got["remat"]:
            raise AssertionError(f"rank {got['rank']} did not run the accumulated GSPMD step "
                                 "with block remat")
        for i, counts in enumerate(got["per_step"]):
            check_launches(f"rank {got['rank']} step {i}", counts, per_step)
        check_launches(f"rank {got['rank']} validation", got["validation"], per_val)
        if got["losses"] != ranks[0]["losses"] or not all(
                math.isfinite(x) for x in got["losses"]) or len(
                    got["losses"]) != tp_run_steps(cut):
            raise AssertionError(f"rank {got['rank']} losses {got['losses']}, rank 0's "
                                 f"{ranks[0]['losses']}")
    step_ms = ranks[0]["step_ms"]
    med = statistics.median(step_ms)
    share = [sum(r["exchange_ms"]) / sum(r["step_ms"]) for r in ranks]
    say(f"  {smi}: {task} {os.path.basename(config)} at depth {depth}, "
        f"{ranks[0]['params_m']:.1f} M parameters a "
        f"rank, {n} micro-batches of {batch // n} x {seq}, data x model = "
        f"{ranks[0]['n_data']} x {TP_RANKS} (gloo processes on one card)")
    say(f"  losses {ranks[0]['losses']}; validation {ranks[0]['val']}; aux {ranks[0]['aux']}")
    say(f"  step ms (steps 1-{len(step_ms)}, host clock, synced): {step_ms}; median {med}; "
        f"tokens/s {batch * seq / med * 1e3} (one data rank)")
    say(f"  gloo exchanges (copy/reduce all-reduces, synced): {ranks[0]['exchange_calls']} calls, "
        f"{ranks[0]['exchange_bytes'] / 2**30:.2f} GiB a rank in the run; ms a step by rank "
        f"{[r['exchange_ms'] for r in ranks]}; share of the step by rank {share}")
    say(f"  peak device memory by process (GiB): {[r['peak_gib'] for r in ranks]}; wall "
        f"{wall:.1f} s")
    for got in ranks:
        say(f"  rank {got['rank']} launches a step {got['per_step'][-1]}, validation "
            f"{got['validation']}; shapes {got['shapes']}")
    total = {k: sum(r["final"][k] for r in ranks) for k in ranks[0]["final"]}
    say(f"{task}: " + json.dumps(dict(depth=depth, step_ms=step_ms, median_step_ms=med,
                                      tokens_per_s=batch * seq / med * 1e3,
                                      exchange_share=share,
                                      peak_gib=[r["peak_gib"] for r in ranks],
                                      losses=ranks[0]["losses"], val=ranks[0]["val"],
                                      wall_s=wall, card=smi)))
    return total


def tp_run_steps(depth) -> int:
    """Phase 27 (b)'s steps: 1 + 3 at the configs' depth, 1 + 1 in the whole
    script's run (its depth cut), so that the script with phase 28 stays
    inside its time (a run of it took 1,179.4 s on an H100 80GB HBM3 at
    700 W with 1 + 3)."""
    return 4 if depth is None else 2


# phase 27 (b)'s depth in the whole script's run: at the configs' 16 blocks
# each config's 4 steps take ~5 min through gloo (~52-58 s a step, 87-91%
# of it exchanges, on an H100 80GB HBM3 at 700 W), which would carry the script past its
# 1200 s limit, so the default run cuts (b) to 2 blocks (the MoE config: 1
# dense, 1 MoE); ``--tp`` runs the full depth
TP_DEFAULT_RUN_DEPTH = 2


def phase_tensor_parallel(torch, modules, smi: str, depth=None) -> dict:
    """Phase 27: (a) :func:`phase_tp_gate`; (b) :func:`phase_tp_runner` on
    ``configs/train-lm-tp.yml`` and ``configs/train-lm-moe-ep.yml`` (at
    ``depth`` blocks if given).  Returns the launch counts of (b) summed
    over the ranks, by path."""
    t_phase = time.perf_counter()
    gate = phase_tp_gate(torch, modules)
    say("tp_gate: " + json.dumps(gate))
    paths = {"tp": by_tpu_kernel(phase_tp_runner(torch, "tp", TP_CONFIG, smi, depth)),
             "ep": by_tpu_kernel(phase_tp_runner(torch, "ep", EP_CONFIG, smi, depth))}
    say(f"  phase 27 took {time.perf_counter() - t_phase:.1f} s")
    return paths


ZERO_CONFIG = os.path.join(_HERE, "pytorch_distributed_training_tpu_torch", "configs",
                           "train-lm-fsdp.yml")
ZERO_DIR = os.path.join(_HERE, "run", "chip_smoke", "zero")
ZERO_RANKS = 4
# (a)'s cases, each on 4 gloo processes: name -> (model, (data, model) ranks,
# ZeRO stage, grad_accumulation); each rank takes a 2 x 256 batch
ZERO_GATE_CASES = {"zero 1": ("dense", (4, 1), 1, 1), "zero 2 accum 2": ("dense", (4, 1), 2, 2),
                   "zero 3": ("dense", (4, 1), 3, 1), "zero 3 moe 2x2": ("moe", (2, 2), 3, 1)}
ZERO_GATE_ROWS = 2  # a rank's rows of the batch
# phase 27's limits; a momentum buffer is a sum of gradients, held to theirs
ZERO_MOMENTUM_LIMIT = TP_GRAD_LIMIT


def zero_probe_gloo(torch) -> str:
    """Phase 1: gloo's reduce-scatter and all-gather of CUDA f32 and bf16
    tensors over two ranks (threads of this process), through the port's
    exchanges (``parallel.tensor._reduce_scatter`` and ``_all_gather``, the
    group's ``_reduce_scatter_base`` and ``_allgather_base``), phase 28's
    ZeRO exchanges.  Raises if gloo refuses one or a result is wrong."""
    import threading
    from datetime import timedelta

    import torch.distributed as dist

    from pytorch_distributed_training_tpu_torch.parallel import tensor

    taken = []
    for dtype in (torch.float32, torch.bfloat16):
        store, got, errors = dist.HashStore(), {}, []

        def rank(r):
            try:
                pg = dist.ProcessGroupGloo(store, r, 2, timedelta(seconds=60))
                inp = torch.arange(8, dtype=dtype, device="cuda") + 10 * r
                part = torch.empty(4, dtype=dtype, device="cuda")
                tensor._reduce_scatter(part, inp, pg)
                whole = torch.empty(6, dtype=dtype, device="cuda")
                tensor._all_gather(whole, torch.full((3,), float(r + 1), dtype=dtype,
                                                     device="cuda"), pg)
                torch.cuda.synchronize()
                got[r] = (part.cpu().tolist(), whole.cpu().tolist())
            except BaseException as err:  # raised below, in the phase's thread
                errors.append(err)

        threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        name = str(dtype).replace("torch.", "")
        if errors or len(got) != 2:
            raise AssertionError(f"gloo reduce-scatter/all-gather of CUDA {name}: {errors}")
        for r, (part, whole) in got.items():
            if (part != [10.0 + 2 * j + 8 * r for j in range(4)]
                    or whole != [1.0, 1.0, 1.0, 2.0, 2.0, 2.0]):
                raise AssertionError(f"gloo reduce-scatter/all-gather of CUDA {name} on rank "
                                     f"{r}: {part}, {whole}")
        taken.append(name)
    return ", ".join(taken)


def zero_gate_weights(torch, kind: str, seed: int) -> dict:
    """(a)'s full weights: :func:`tp_gate_weights`', with the expert banks'
    biases ``moe.bi``/``moe.bo`` drawn at 0.02 as every other bias is (the
    name filter there leaves them at flax's zero init, so their reading of
    max |got - want| / max |want| after two steps would compare the two
    steps' updates, not parameters)."""
    full = tp_gate_weights(torch, kind, seed)
    gen = torch.Generator().manual_seed(seed + 100)
    for name in sorted(full):
        if name.endswith((".moe.bi", ".moe.bo")):
            full[name] = torch.randn(full[name].shape, generator=gen) * 0.02
    return full


def zero_gate_batch(torch, rows: int, seed: int = 28):
    gen = torch.Generator().manual_seed(seed)
    shape = (rows, TP_GATE_SEQ)
    return (torch.randint(0, TP_GATE_KW["vocab_size"], shape, generator=gen),
            torch.randint(0, TP_GATE_KW["vocab_size"], shape, generator=gen))


def zero_gate_steps(torch, kind: str, full: dict, tokens, labels, accum: int,
                    layout=None, zero: int = 0) -> dict:
    """``TP_GATE_STEPS`` SGD steps of the GSPMD-path step on the card from
    ``full``: one rank on the whole batch, or this rank of ``layout`` (a
    :class:`..parallel.TPLayout`) at ZeRO stage ``zero`` on its data rows.
    Returns the losses, every step's gradients as the optimizer takes them,
    gathered (over the data group, then the model group), the full
    parameters after, the momentum as this rank holds it (by name) and the
    step's state bytes, all on the CPU."""
    from pytorch_distributed_training_tpu_torch import optimizers
    from pytorch_distributed_training_tpu_torch.engine.tp_steps import build_tp_lm_train_step
    from pytorch_distributed_training_tpu_torch.models import TransformerLM
    from pytorch_distributed_training_tpu_torch.parallel.tensor import gather_param, shard_dim

    kw = dict(TP_GATE_KW, **(TP_GATE_MOE_KW if kind == "moe" else {}))
    tg = layout.tensor_group if layout is not None else None
    zg = layout.zero_group if layout is not None and zero >= 3 else None
    with torch.device("meta"):  # no weights drawn: ``full`` is loaded next
        model = TransformerLM(**kw, tensor_group=tg, zero_group=zg)
    model.to_empty(device="cuda")
    model.load_full_state_dict(full)
    n_data = layout.n_data if layout is not None else 1
    step = build_tp_lm_train_step(model, optimizers.SGD(**TP_GATE_SGD),
                                  lambda i: TP_GATE_SGD["lr"], world_size=n_data,
                                  group=layout.data_group if layout is not None else None,
                                  grad_accum=accum, zero=zero)
    names = [n for n, _ in model.named_parameters()]
    grads = []
    update = step.optimizer.update

    def record(params, gs, state, lr, **kw):
        whole = step.zero_plan.gather_all(gs) if step.zero_plan is not None else gs
        grads.append({n: (gather_param(g, shard_dim(n), tg) if tg is not None else g).cpu()
                      for n, g in zip(names, whole)})
        return update(params, gs, state, lr, **kw)

    step.optimizer.update = record
    if layout is not None:
        rows = tokens.shape[0] // n_data
        sl = slice(layout.data_idx * rows, (layout.data_idx + 1) * rows)
        tokens, labels = tokens[sl], labels[sl]
    losses = [float(step(tokens.cuda(), labels.cuda())) for _ in range(TP_GATE_STEPS)]
    after = {k: v.cpu() for k, v in model.full_state_dict().items()}
    momentum = {n: t.cpu() for n, t in zip(names, step.opt_state.momentum)}
    return dict(losses=losses, grads=grads, after=after, momentum=momentum,
                bytes=step.state_bytes())


def zero_momentum_reading(torch, got: dict, want: dict, layout, zero: int) -> float:
    """This rank's momentum against its elements of the one-rank momentum
    (the model group's slice, then the rule's data slice), of the largest."""
    from pytorch_distributed_training_tpu_torch.parallel.tensor import (shard_dim, shard_param,
                                                                         zero_shard_dim)

    worst = 0.0
    for name, mine in got.items():
        ref = shard_param(want[name], shard_dim(name), layout.n_model, layout.model_idx)
        if zero >= 1:
            ref = shard_param(ref, zero_shard_dim(name, ref.shape, layout.n_data),
                              layout.n_data, layout.data_idx)
        worst = max(worst, relative_to_largest(mine, ref))
    return worst


def zero_no_reduce(torch):
    """A wrong reduce-scatter: each rank keeps its local gradient's slice."""
    from pytorch_distributed_training_tpu_torch.parallel.tensor import ZeroPlan

    def scatter_sum(self, fulls, idx):
        return [self.slice(t, i).float() for t, i in zip(fulls, idx)]

    return ZeroPlan, "scatter_sum", scatter_sum


def zero_stale_shards(torch):
    """A wrong re-gather after the update: each rank writes its own slice
    alone, the others' stay stale."""
    from pytorch_distributed_training_tpu_torch.parallel.tensor import ZeroPlan

    def gather_into(self, fulls, parts, idx):
        for t, part, i in zip(fulls, parts, idx):
            self._rows(t, i)[self.dg.rank].copy_(part)

    return ZeroPlan, "gather_into", gather_into


def zero_next_rank(torch):
    """Wrong slices: each rank takes the slice one rank over."""
    from pytorch_distributed_training_tpu_torch.parallel.tensor import ZeroPlan, shard_param

    def slice_(self, full, i):
        return shard_param(full, self.dims[i], self.dg.size, (self.dg.rank + 1) % self.dg.size)

    return ZeroPlan, "slice", slice_


# wrong variant -> (the case it runs in, its patch)
ZERO_VARIANTS = {"no reduce (local gradient slice)": ("zero 1", zero_no_reduce),
                 "stale shards (no re-gather)": ("zero 1", zero_stale_shards),
                 "slices one rank over": ("zero 3", zero_next_rank)}


def zero_ref_key(kind: str, accum: int) -> str:
    return f"{kind}_accum{accum}"


def zero_gate_worker(torch, modules, rank: int, port: int) -> None:
    """(a) on one rank: every case of :data:`ZERO_GATE_CASES` and
    :data:`ZERO_VARIANTS` in turn over one gloo process group, each held
    against the one-rank step this process runs on the same weights (the
    parent's ``full_<kind>.pt``) and the whole batch; the full gradients and
    parameters (equal on every rank) are read on rank 0, the losses and the
    momentum slices on every rank.  Writes its readings, launches (and the
    references') and state bytes as JSON."""
    from datetime import timedelta

    import torch.distributed as dist

    from pytorch_distributed_training_tpu_torch.parallel import TPLayout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=ZERO_RANKS, rank=rank, timeout=timedelta(seconds=600))
    try:
        out, refs, fulls = {"references": {}}, {}, {}
        runs = [(c, None) for c in ZERO_GATE_CASES] + [(c, v) for v, (c, _) in
                                                      ZERO_VARIANTS.items()]
        for case, variant in runs:
            kind, (n_data, t), zero, accum = ZERO_GATE_CASES[case]
            if kind not in fulls:
                fulls[kind] = torch.load(os.path.join(ZERO_DIR, f"full_{kind}.pt"),
                                         weights_only=True)
            tokens, labels = zero_gate_batch(torch, ZERO_GATE_ROWS * n_data)
            key = zero_ref_key(kind, accum)
            if key not in refs:  # one reference held at a time
                for m in modules:
                    m.reset_launch_counts()
                refs = {key: zero_gate_steps(torch, kind, fulls[kind], tokens, labels, accum)}
                out["references"][key] = all_counts(modules)
            want = refs[key]
            layout = TPLayout(ZERO_RANKS, rank, t)
            undo = None
            if variant is not None:
                owner, attr, wrong = ZERO_VARIANTS[variant][1](torch)
                undo = (owner, attr, getattr(owner, attr))
                setattr(owner, attr, wrong)
            for m in modules:
                m.reset_launch_counts()
            try:
                got = zero_gate_steps(torch, kind, fulls[kind], tokens, labels, accum, layout,
                                      zero)
            finally:
                if undo is not None:
                    setattr(*undo)
            r = dict(loss=max(abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                                  want["losses"])),
                     momentum=zero_momentum_reading(torch, got["momentum"], want["momentum"],
                                                    layout, zero))
            if rank == 0:
                r.update(tp_gate_readings(got, want))
            out[variant or case] = dict(readings=r, losses=got["losses"],
                                        launches=all_counts(modules), bytes=got["bytes"])
            del got
        with open(os.path.join(ZERO_DIR, f"gate.rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def zero_gate_within(r: dict) -> bool:
    return tp_gate_within(r) and r["momentum"] <= ZERO_MOMENTUM_LIMIT


def zero_rule_bytes(torch, model_kw: dict, n_model: int, n_data: int, stage: int,
                    moments: int) -> dict:
    """A rank's bytes of f32 parameters, gradients and moments at ZeRO
    ``stage`` by the rule (``zero_shard_dim``): a leaf's slice where the
    stage shards that state and the rule splits the leaf, else the leaf."""
    from pytorch_distributed_training_tpu_torch.models import TransformerLM
    from pytorch_distributed_training_tpu_torch.parallel import TensorGroup
    from pytorch_distributed_training_tpu_torch.parallel.tensor import zero_shard_dim

    with torch.device("meta"):
        tg = TensorGroup(None, n_model, 0) if n_model > 1 else None
        model = TransformerLM(**model_kw, tensor_group=tg)
    out = dict(params=0, grads=0, moments=0)
    for name, p in model.named_parameters():
        whole = p.numel() * 4
        part = whole // n_data if zero_shard_dim(name, p.shape, n_data) is not None else whole
        out["params"] += part if stage >= 3 else whole
        out["grads"] += part if stage >= 2 else whole
        out["moments"] += moments * (part if stage >= 1 else whole)
    return out


def phase_zero_gate(torch, modules, ranks: list) -> dict:
    """Phase 28 (a)'s verdicts on the ranks' results (:func:`zero_gate_worker`):
    ZeRO-1, ZeRO-2 (2 micro-batches) and ZeRO-3 at data 4 x model 1 and
    ZeRO-3 at data 2 x model 2 with the MoE block, full width, depth 2, f32
    with TF32 off, a rank's batch 2 x 256: each took ``TP_GATE_STEPS``
    SGD-momentum steps on four gloo processes on the card from the same
    seeded full weights as the one-rank step on the card over the whole
    batch; the losses, every gathered gradient, every gathered parameter
    after and each rank's momentum slice (against its elements of the
    one-rank momentum) held to phase 27's limits (the momentum to the
    gradients'), which three wrong variants must fail
    (:data:`ZERO_VARIANTS`); each rank's launches (and its one-rank
    reference's) exact and its state bytes the rule's."""
    steps, depth = TP_GATE_STEPS, TP_GATE_KW["depth"]
    readings = {}
    for name in ranks[0]:
        if name == "references":
            continue
        case = ZERO_VARIANTS[name][0] if name in ZERO_VARIANTS else name
        kind, (n_data, t), zero, accum = ZERO_GATE_CASES[case]
        dense = depth if kind == "dense" else 1
        # a rank's run, as the one rank's: a K1 pair, an f32 flash forward and
        # split backward a block and K3/K4 in the dense blocks, a micro-batch
        per_run = {k: steps * accum * v for k, v in dict(
            ce_fwd=1, ce_bwd=1, flash_fwd=depth, flash_bwd=2 * depth, K2a=depth, K2d=depth,
            K2e=depth, add_layernorm=dense, bias_gelu=dense).items()}
        if name not in ZERO_VARIANTS:
            kw = dict(TP_GATE_KW, **(TP_GATE_MOE_KW if kind == "moe" else {}))
            rule = zero_rule_bytes(torch, kw, t, n_data, zero, moments=1)
        for r, got in enumerate(ranks):
            check_launches(f"rank {r} one-rank {kind}",
                           got["references"][zero_ref_key(kind, accum)], per_run)
            check_launches(f"rank {r} {name}", got[name]["launches"], per_run)
            if name not in ZERO_VARIANTS and got[name]["bytes"] != rule:
                raise AssertionError(f"rank {r} {name}: state bytes {got[name]['bytes']}, the "
                                     f"rule's {rule}")
        readings[name] = {k: max(got[name]["readings"][k] for got in ranks
                                 if k in got[name]["readings"])
                          for k in ranks[0][name]["readings"]}
    for name, r in readings.items():
        wrong = name in ZERO_VARIANTS
        verdict = "within" if zero_gate_within(r) else ("outside" if wrong else "OUTSIDE")
        say(f"  {'wrong variant ' if wrong else ''}{name} vs one rank: {r} (rank 0 losses "
            f"{ranks[0][name]['losses']}) -> {verdict}")
    for name in ZERO_GATE_CASES:
        say(f"  {name}: state bytes a rank {ranks[0][name]['bytes']} (the rule's)")
    bad = [k for k, r in readings.items() if k not in ZERO_VARIANTS and not zero_gate_within(r)]
    if bad:
        raise AssertionError(f"ZeRO on the card outside its limits: {bad}")
    inside = [k for k in ZERO_VARIANTS if zero_gate_within(readings[k])]
    if inside:
        raise AssertionError(f"ZeRO: wrong variants within the limits: {inside}")
    return dict(readings=readings, launches=ranks[0])


def zero_exchange_timer(torch) -> dict:
    """Time every exchange of the step (ZeRO's reduce-scatters and
    all-gathers, the all-reduces of the whole leaves, the loss and the TP
    copy/reduce), synchronised before and after so that only the exchange
    is counted (gloo copies through the host): calls, bytes and seconds."""
    from pytorch_distributed_training_tpu_torch.engine import sp_steps, tp_steps
    from pytorch_distributed_training_tpu_torch.parallel import tensor

    clock = dict(seconds=0.0, calls=0, bytes=0)

    def timed(plain, nbytes):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = plain(*args)
            torch.cuda.synchronize()
            clock["seconds"] += time.perf_counter() - t0
            clock["calls"] += 1
            clock["bytes"] += nbytes(*args)
            return out
        return run

    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    tensor._reduce_scatter = timed(tensor._reduce_scatter, lambda out, inp, g: size(inp))
    tensor._all_gather = timed(tensor._all_gather, lambda out, inp, g: size(out))
    tensor._all_reduce = timed(tensor._all_reduce, lambda t, g: size(t))
    summed = timed(sp_steps._all_reduce_sum_, lambda ts, g=None: sum(size(t) for t in ts))
    sp_steps._all_reduce_sum_ = tp_steps._all_reduce_sum_ = summed
    return clock


# (b)'s state readings at stages 0-2: one step each of a batch of 4 in one
# micro-batch; the state a rank holds depends on neither
ZERO_BYTES_BATCH = 4


def zero_config(depth=None, **training) -> dict:
    """``configs/train-lm-fsdp.yml`` for (b): no checkpoint, ``depth`` blocks
    if given, ``training`` set, a batch a data rank an epoch and one
    validation batch."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg

    cfg = get_cfg(ZERO_CONFIG)
    cfg["training"].pop("checkpoint")
    if depth is not None:
        cfg["model"]["depth"] = depth
    cfg["training"].update(training)
    cfg["dataset"]["n_samples"] = cfg["training"]["batch_size"] * ZERO_RANKS
    return cfg


def zero_stage_bytes(torch, cfg: dict, rank: int, port: int) -> dict:
    """This rank's state bytes at ZeRO stages 0, 1 and 2 on ``cfg``'s model
    (the runner's steps: ``build_lm_train_step`` at stage 0, the GSPMD
    step above it, over a gloo group of the 4 ranks), each after one step of
    ``ZERO_BYTES_BATCH`` seeded rows, the weights drawn on the card (the
    bytes depend on neither)."""
    from datetime import timedelta

    import torch.distributed as dist

    from pytorch_distributed_training_tpu_torch.engine.sp_steps import build_lm_train_step
    from pytorch_distributed_training_tpu_torch.engine.tp_steps import build_tp_lm_train_step
    from pytorch_distributed_training_tpu_torch.models import TransformerLM
    from pytorch_distributed_training_tpu_torch.optimizers import get_optimizer

    model_kw = {k: v for k, v in cfg["model"].items() if k != "name"}
    opt_cfg = dict(cfg["training"]["optimizer"])
    opt_cls = get_optimizer(opt_cfg)
    opt_cfg.pop("name")
    gen = torch.Generator().manual_seed(28)
    shape = (ZERO_BYTES_BATCH, cfg["dataset"]["seq_len"])
    vocab = cfg["dataset"]["n_classes"]
    tokens = torch.randint(0, vocab, shape, generator=gen).cuda()
    labels = torch.randint(0, vocab, shape, generator=gen).cuda()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=ZERO_RANKS, rank=rank, timeout=timedelta(seconds=600))
    out = {}
    try:
        for stage in (0, 1, 2):
            with torch.device("meta"):
                model = TransformerLM(vocab_size=vocab, dtype=torch.bfloat16, flash=True,
                                      remat=True, **model_kw)
            model.to_empty(device="cuda")
            with torch.no_grad():
                for p in model.parameters():
                    p.normal_(0.0, 0.02)
            lr = lambda i: opt_cfg["lr"]  # noqa: E731
            step = (build_lm_train_step(model, opt_cls(**opt_cfg), lr, world_size=ZERO_RANKS)
                    if stage == 0 else
                    build_tp_lm_train_step(model, opt_cls(**opt_cfg), lr,
                                           world_size=ZERO_RANKS, group=dist.group.WORLD,
                                           zero=stage))
            step(tokens, labels)
            out[stage] = step.state_bytes()
            del step, model
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def zero_runner_readings(torch, modules, rank: int, ports: list, depth=None) -> dict:
    """(b) on one rank: the runner on ``configs/train-lm-fsdp.yml`` (its
    depth cut to ``depth`` if given, no checkpoint) for 4 steps (1 warm-up, 3
    timed) and one validation batch, its launches a step and in the
    validation, the step ms, the exchanges a step and the peak memory of
    this process and its state bytes; then :func:`zero_stage_bytes`."""
    from pytorch_distributed_training_tpu_torch.engine import Runner

    clock = zero_exchange_timer(torch)
    marks = []

    def on_iter(runner):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), all_counts(modules), clock["seconds"],
                      clock["calls"], clock["bytes"]))

    steps = 4
    for m in modules:
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = Runner(num_nodes=ZERO_RANKS, rank=rank, seed=0,
                    dist_url=f"tcp://127.0.0.1:{ports[0]}", multiprocessing=False,
                    logger_queue=None, global_cfg=zero_config(
                        depth, train_iters=steps, print_interval=1, val_interval=steps),
                    device="cuda", dist_backend="gloo", on_iter=on_iter)
    runner()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    final = all_counts(modules)
    prev, per_step = {k: 0 for k in final}, []
    for _, counts, *_ in marks:
        per_step.append({k: counts[k] - prev[k] for k in final})
        prev = counts
    diffs = lambda j: [b[j] - a[j] for a, b in zip(marks, marks[1:])]  # noqa: E731
    out = dict(rank=rank, path=runner.path, zero=runner.train_step.zero,
               n_data=runner.data_size, grad_accum=runner.train_step.grad_accum,
               remat=runner.model.remat, step_ms=[s * 1e3 for s in diffs(0)],
               exchange_ms=[s * 1e3 for s in diffs(2)], exchange_calls=diffs(3),
               exchange_bytes=diffs(4), per_step=per_step,
               validation={k: final[k] - prev[k] for k in final}, final=final,
               losses=[r["loss"] for r in runner.train_log], val=runner.val_log,
               peak_gib=peak, wall_s=wall, bytes={3: runner.train_step.state_bytes()},
               params_m=sum(p.numel() for p in runner.model.parameters()) / 1e6)
    runner = None
    torch.cuda.empty_cache()
    out["bytes"].update(zero_stage_bytes(torch, zero_config(depth), rank, ports[1]))
    return out


def zero_worker(rank: int, task: str, ports: list, depth=None) -> None:
    """One of phase 28's ranks, a process of its own on ``cuda:0``: (a)
    (:func:`zero_gate_worker`), then (b) (:func:`zero_runner_readings`).
    Writes its results under ``ZERO_DIR``."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_training_tpu_torch.ops import fused_ce as ce
    from pytorch_distributed_training_tpu_torch.ops import fused_elementwise as fe

    modules = (fe, ce, fa)
    torch.cuda.set_device(0)
    zero_gate_worker(torch, modules, rank, ports[0])
    torch.cuda.empty_cache()
    out = zero_runner_readings(torch, modules, rank, ports[1:], depth)
    with open(os.path.join(ZERO_DIR, f"runner.rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_zero_runner(torch, smi: str, ranks: list, depth: int, wall: float) -> dict:
    """Phase 28 (b)'s verdicts and readings on the ranks' results
    (:func:`zero_runner_readings`, ``configs/train-lm-fsdp.yml`` at ``depth``
    blocks through the runner): each rank's launches exact a step (K1a/K1b
    n, K2a/K2c n x 2 x depth, K3/K4 n x 2 x depth: block remat runs each
    forward twice) and in the validation batch; every loss finite and equal
    on the ranks; each rank's bytes of parameters, gradients and moments at
    stages 0-3 the rule's.  Prints the step ms, global tokens/s, the
    exchanges' calls, bytes and share of the step and each process's peak
    memory beside the card.  Returns the four ranks' launch counts summed."""
    cfg = zero_config(depth)
    n = cfg["training"]["grad_accumulation"]
    batch, seq = cfg["training"]["batch_size"], cfg["dataset"]["seq_len"]
    per_step = dict(ce_fwd=n, ce_bwd=n, flash_fwd=n * 2 * depth, flash_bwd=n * 2 * depth,
                    K2a=n * 2 * depth, K2c=n * 2 * depth, add_layernorm=n * 2 * depth,
                    bias_gelu=n * 2 * depth)
    per_val = dict(ce_fwd=n, flash_fwd=n * depth, K2a=n * depth, add_layernorm=n * depth,
                   bias_gelu=n * depth)
    model_kw = {k: v for k, v in cfg["model"].items() if k != "name"}
    model_kw["vocab_size"] = cfg["dataset"]["n_classes"]
    rules = {s: zero_rule_bytes(torch, model_kw, 1, ZERO_RANKS, s, moments=2)
             for s in range(4)}
    for got in ranks:
        if (got["path"] != "gspmd" or got["zero"] != 3 or got["grad_accum"] != n
                or not got["remat"] or got["n_data"] != ZERO_RANKS):
            raise AssertionError(f"rank {got['rank']} did not run the accumulated ZeRO-3 "
                                 "GSPMD step with block remat over 4 data ranks")
        for i, counts in enumerate(got["per_step"]):
            check_launches(f"rank {got['rank']} step {i}", counts, per_step)
        check_launches(f"rank {got['rank']} validation", got["validation"], per_val)
        if got["losses"] != ranks[0]["losses"] or not all(
                math.isfinite(x) for x in got["losses"]) or len(got["losses"]) != 4:
            raise AssertionError(f"rank {got['rank']} losses {got['losses']}, rank 0's "
                                 f"{ranks[0]['losses']}")
        for s in range(4):
            if got["bytes"][str(s)] != rules[s]:
                raise AssertionError(f"rank {got['rank']} stage {s}: state bytes "
                                     f"{got['bytes'][str(s)]}, the rule's {rules[s]}")
    step_ms = ranks[0]["step_ms"]
    med = statistics.median(step_ms)
    share = [sum(r["exchange_ms"]) / sum(r["step_ms"]) for r in ranks]
    tokens_per_s = ZERO_RANKS * batch * seq / med * 1e3
    gib = {s: {k: v / 2**30 for k, v in rules[s].items()} for s in range(4)}
    say(f"  {smi}: train-lm-fsdp.yml at depth {depth}, ZeRO-3 over {ZERO_RANKS} data ranks "
        f"(gloo processes on one card), {ranks[0]['params_m']:.2f} M parameters held a rank, "
        f"{n} micro-batches of {batch // n} x {seq} a rank")
    say(f"  losses {ranks[0]['losses']}; validation {ranks[0]['val']}")
    say(f"  step ms (steps 1-3, host clock, synced): {step_ms}; median {med}; global tokens/s "
        f"{tokens_per_s} ({ZERO_RANKS} data ranks)")
    say(f"  gloo exchanges a step (reduce-scatters, all-gathers, all-reduces; synced): calls "
        f"{ranks[0]['exchange_calls']}, GiB {[b / 2**30 for b in ranks[0]['exchange_bytes']]} "
        f"a rank; ms by rank {[r['exchange_ms'] for r in ranks]}; share of the step by rank "
        f"{share}")
    say(f"  peak device memory by process (GiB): {[r['peak_gib'] for r in ranks]}; wall "
        f"{wall:.1f} s")
    say(f"  state a rank at ZeRO stages 0-3 (GiB of params, grads, moments; measured = the "
        f"rule's on every rank): {gib}")
    total = {k: sum(r["final"][k] for r in ranks) for k in ranks[0]["final"]}
    say("zero: " + json.dumps(dict(depth=depth, step_ms=step_ms, median_step_ms=med,
                                   tokens_per_s=tokens_per_s, exchange_share=share,
                                   exchange_calls=ranks[0]["exchange_calls"],
                                   exchange_bytes=ranks[0]["exchange_bytes"],
                                   peak_gib=[r["peak_gib"] for r in ranks],
                                   state_bytes=rules, losses=ranks[0]["losses"],
                                   val=ranks[0]["val"], wall_s=wall, card=smi)))
    return total


# phase 28 (b)'s depth in the whole script's run: 16 blocks through gloo
# would carry the script past its limit, as phase 27's would, so the default
# run cuts (b) to 2 blocks; ``--zero`` runs the full depth
ZERO_DEFAULT_RUN_DEPTH = 2


def phase_zero(torch, modules, smi: str, depth=None) -> dict:
    """Phase 28: the full weights of (a) drawn here, then one spawn of four
    gloo processes on the card runs (a) and (b) (:func:`zero_worker`);
    :func:`phase_zero_gate` and :func:`phase_zero_runner` (on
    ``configs/train-lm-fsdp.yml``, at ``depth`` blocks if given) judge and
    print.  Returns (b)'s launch counts summed over the ranks, by path."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg

    t_phase = time.perf_counter()
    os.makedirs(ZERO_DIR, exist_ok=True)
    for i, kind in enumerate(("dense", "moe")):
        torch.save(zero_gate_weights(torch, kind, seed=28 + i),
                   os.path.join(ZERO_DIR, f"full_{kind}.pt"))
    depth = get_cfg(ZERO_CONFIG)["model"]["depth"] if depth is None else depth
    wall = tp_spawn(torch, "zero", depth=depth, worker=zero_worker, ports=3)
    say(f"  four ranks' wall {wall:.1f} s (spawn, (a)'s {len(ZERO_GATE_CASES)} cases and "
        f"{len(ZERO_VARIANTS)} wrong variants of {TP_GATE_STEPS} steps, (b))")
    read = lambda name: [json.load(open(os.path.join(ZERO_DIR, f"{name}.rank{r}.json")))  # noqa: E731
                         for r in range(ZERO_RANKS)]
    gate = phase_zero_gate(torch, modules, read("gate"))
    say("zero_gate: " + json.dumps(gate["readings"]))
    paths = {"zero": by_tpu_kernel(phase_zero_runner(torch, smi, read("runner"), depth, wall))}
    say(f"  phase 28 took {time.perf_counter() - t_phase:.1f} s")
    return paths


PP_CONFIG = os.path.join(_HERE, "config", "TransformerLM-pp.yml")
PP_DIR = os.path.join(_HERE, "run", "chip_smoke", "pp")
PP_RANKS = 4
# (a)'s model: full width, 4 blocks (one a stage at 4 stages), f32, the
# stage blocks' unfused tails (JAX _stage_applies), flash under its gate;
# a batch of 8 x 256, each data rank's rows of it at 2 x 2
PP_GATE_KW = dict(vocab_size=32768, max_len=2048, embed_dim=1024, depth=4, num_heads=16,
                  flash=True)
PP_GATE_BATCH = 8
# (a)'s cases: name -> ((data, stage) ranks, schedule, microbatches)
PP_GATE_CASES = {"gpipe 1x4": ((1, 4), "gpipe", 4), "1f1b 1x4": ((1, 4), "1f1b", 8),
                 "1f1b 2x2": ((2, 2), "1f1b", 4)}


def pp_probe_worker(rank: int, port: int) -> None:
    """One of phase 1's two processes: CUDA f32 and bf16 tensors hop between
    them through the port's stage exchange (``StageExchange.hop``, one hop
    each way), checked on arrival; writes what arrived under ``PP_DIR``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from pytorch_distributed_training_tpu_torch.parallel import StageExchange

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=timedelta(seconds=60))
    try:
        ex = StageExchange(dist.group.WORLD, [0, 1], dist.get_backend())
        out = {"host_staged": ex.host_staged}
        for dtype in (torch.float32, torch.bfloat16):
            base = torch.arange(1 << 20, device="cuda").float()
            mine = (base + 3 * rank).to(dtype)
            got = torch.empty_like(mine)
            if rank == 0:
                ex.hop(send_next=mine, recv_next=got)
            else:
                ex.hop(send_prev=mine, recv_prev=got)
            torch.cuda.synchronize()
            out[str(dtype).replace("torch.", "")] = bool(torch.equal(
                got, (base + 3 * (1 - rank)).to(dtype)))
        with open(os.path.join(PP_DIR, f"probe.rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def pp_probe_gloo(torch) -> str:
    """Phase 1: gloo's send/recv of CUDA f32 and bf16 tensors between two
    processes through the port's stage exchange (the pipeline's hops, phase
    29).  Gloo's transport hands a tensor's raw pointer to its socket, which
    a CUDA pointer fails (``writev ... Bad address``, torch 2.11), so under
    gloo the exchange stages each tensor through pinned host memory.
    Raises if a value arrives wrong."""
    import socket

    import torch.multiprocessing as mp

    os.makedirs(PP_DIR, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(pp_probe_worker, args=(port,), nprocs=2, join=True,
                       start_method="spawn")
    got = [json.load(open(os.path.join(PP_DIR, f"probe.rank{r}.json"))) for r in range(2)]
    for r, out in enumerate(got):
        if not (out["float32"] and out["bfloat16"]):
            raise AssertionError(f"gloo stage exchange of CUDA tensors on rank {r}: {out}")
    return ("float32, bfloat16 "
            + ("staged through pinned host memory" if got[0]["host_staged"] else "as they are"))


def pp_gate_batch(torch, seed: int = 29):
    gen = torch.Generator().manual_seed(seed)
    shape = (PP_GATE_BATCH, TP_GATE_SEQ)
    return (torch.randint(0, PP_GATE_KW["vocab_size"], shape, generator=gen),
            torch.randint(0, PP_GATE_KW["vocab_size"], shape, generator=gen))


def pp_gate_steps(torch, full: dict, tokens, labels, layout=None, sched=None,
                  micro=None) -> dict:
    """``TP_GATE_STEPS`` SGD steps on the card from ``full``: the one-rank
    step on the whole batch, or this rank's stage of ``layout`` (a
    :class:`..parallel.PPLayout`) under ``sched`` over ``micro``
    microbatches of its data rows.  Returns the losses, every step's
    gradients as the optimizer takes them and the parameters after, gathered
    over the stages (collectives on every rank), on the card: the readings
    are taken there, with no copy of ~1.4 GB a run to the host."""
    from pytorch_distributed_training_tpu_torch import optimizers
    from pytorch_distributed_training_tpu_torch.engine.pp_steps import build_pp_lm_train_step
    from pytorch_distributed_training_tpu_torch.engine.sp_steps import build_lm_train_step
    from pytorch_distributed_training_tpu_torch.models import TransformerLM

    stage = layout.stage if layout is not None else None
    with torch.device("meta"):  # no weights drawn: ``full`` is loaded next
        model = TransformerLM(**PP_GATE_KW, stage_group=stage)
    model.to_empty(device="cuda")
    model.load_full_state_dict(full)
    opt, lr = optimizers.SGD(**TP_GATE_SGD), (lambda i: TP_GATE_SGD["lr"])
    if layout is None:
        step = build_lm_train_step(model, opt, lr)
    else:
        step = build_pp_lm_train_step(model, opt, lr, layout.stage_exchange, micro, sched,
                                      world_size=layout.n_data, group=layout.data_group)
        rows = tokens.shape[0] // layout.n_data
        sl = slice(layout.data_idx * rows, (layout.data_idx + 1) * rows)
        tokens, labels = tokens[sl], labels[sl]
    names = [n for n, _ in model.named_parameters()]
    grads = []
    update = step.optimizer.update

    def record(params, gs, state, lr, **kw):
        grads.append(model.gather_full(dict(zip(names, gs))))
        return update(params, gs, state, lr, **kw)

    step.optimizer.update = record
    losses = [float(step(tokens.cuda(), labels.cuda())) for _ in range(TP_GATE_STEPS)]
    return dict(losses=losses, grads=grads, after=model.full_state_dict())


def pp_drop_dy(torch):
    """A wrong hop: the cotangent received from the next stage dropped."""
    from pytorch_distributed_training_tpu_torch.parallel.pipeline import StageExchange

    plain = StageExchange.hop

    def hop(self, send_next=None, send_prev=None, recv_prev=None, recv_next=None):
        plain(self, send_next, send_prev, recv_prev, recv_next)
        if recv_next is not None:
            recv_next.zero_()

    return StageExchange, "hop", hop


def pp_no_stage_reduce(torch):
    """A wrong reduce: the shared leaves' gradients not summed over the stage
    group (the loss still is)."""
    from pytorch_distributed_training_tpu_torch.engine import pp_steps

    def reduce_grads(self, loss):
        grads = [pp_steps._grad(p) for p in self.params]
        pp_steps._all_reduce_sum_([loss.reshape(1)], self.ex.group)
        if self.world_size > 1:
            pp_steps._all_reduce_sum_(grads + [loss.reshape(1)], self.group)
        return grads

    return pp_steps.PPLMTrainStep, "reduce_grads", reduce_grads


def pp_previous_microbatch(torch):
    """A wrong hop: each stage fed microbatch m - 1's activation in place of
    m's (the first microbatch its own)."""
    from pytorch_distributed_training_tpu_torch.parallel.pipeline import StageExchange

    plain = StageExchange.hop

    def hop(self, send_next=None, send_prev=None, recv_prev=None, recv_next=None):
        plain(self, send_next, send_prev, recv_prev, recv_next)
        if recv_prev is not None:
            last = getattr(self, "_previous", None)
            self._previous = recv_prev.clone()
            if last is not None:
                recv_prev.copy_(last)

    return StageExchange, "hop", hop


def pp_loss_per_microbatch(torch):
    """A wrong objective: each microbatch's loss normalised by its own tokens
    (a mean a microbatch) in place of the step's global token count."""
    from pytorch_distributed_training_tpu_torch.engine import pp_steps

    plain = pp_steps.lm_loss_local
    return pp_steps, "lm_loss_local", (
        lambda logits, labels, global_tokens, ls=0.0: plain(logits, labels, labels.numel(), ls))


# wrong variant -> (the case it runs in, its patch)
PP_VARIANTS = {"received dy dropped": ("1f1b 1x4", pp_drop_dy),
               "shared leaves not reduced over the stages": ("1f1b 1x4", pp_no_stage_reduce),
               "microbatch m - 1's activation fed for m": ("1f1b 1x4", pp_previous_microbatch),
               "loss normalised a microbatch": ("1f1b 1x4", pp_loss_per_microbatch)}


def pp_gate_worker(torch, modules, rank: int, port: int) -> None:
    """(a) on one rank: the one-rank step on the whole batch from the
    parent's ``full.pt`` (this process), then every case of
    :data:`PP_GATE_CASES` and :data:`PP_VARIANTS` in turn over one gloo
    process group, each held against it; writes the readings (every rank
    holds the gathered gradients and parameters) and launches as JSON."""
    from datetime import timedelta

    import torch.distributed as dist

    from pytorch_distributed_training_tpu_torch.parallel import PPLayout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = torch.load(os.path.join(PP_DIR, "full.pt"), weights_only=True)
    tokens, labels = pp_gate_batch(torch)
    for m in modules:
        m.reset_launch_counts()
    want = pp_gate_steps(torch, full, tokens, labels)
    out = {"reference": all_counts(modules)}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=PP_RANKS, rank=rank, timeout=timedelta(seconds=600))
    try:
        layouts = {}
        runs = [(c, None) for c in PP_GATE_CASES] + [(c, v) for v, (c, _) in PP_VARIANTS.items()]
        for case, variant in runs:
            (_, n_stage), sched, micro = PP_GATE_CASES[case]
            if n_stage not in layouts:  # every rank builds the groups in one order
                layouts[n_stage] = PPLayout(PP_RANKS, rank, n_stage)
            undo = None
            if variant is not None:
                owner, attr, wrong = PP_VARIANTS[variant][1](torch)
                undo = (owner, attr, getattr(owner, attr))
                setattr(owner, attr, wrong)
            for m in modules:
                m.reset_launch_counts()
            try:
                got = pp_gate_steps(torch, full, tokens, labels, layouts[n_stage], sched, micro)
            finally:
                if undo is not None:
                    setattr(*undo)
            out[variant or case] = dict(readings=tp_gate_readings(got, want),
                                        losses=got["losses"], launches=all_counts(modules))
            del got
        with open(os.path.join(PP_DIR, f"gate.rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def pp_gate_launches(case: str, stage: int) -> dict:
    """A stage's launches over (a)'s steps under ``case``: an f32 flash
    forward (K2a) a block a microbatch and a second one in each 1F1B B slot's
    recompute, one split backward (K2d dQ, K2e dK/dV) a block a
    microbatch; the last stage a K1a per forward of the head and a K1b a
    microbatch; no K3/K4 (the stage blocks' tails are unfused)."""
    (_, n_stage), sched, micro = PP_GATE_CASES[case]
    blocks, n = PP_GATE_KW["depth"] // n_stage, TP_GATE_STEPS * micro
    fwd = 2 if sched == "1f1b" else 1
    out = dict(flash_fwd=fwd * blocks * n, flash_bwd=2 * blocks * n, K2a=fwd * blocks * n,
               K2d=blocks * n, K2e=blocks * n)
    if stage == n_stage - 1:
        out.update(ce_fwd=fwd * n, ce_bwd=n)
    return out


def phase_pp_gate(torch, ranks: list) -> dict:
    """Phase 29 (a)'s verdicts on the ranks' results (:func:`pp_gate_worker`):
    GPipe and 1F1B at (data 1, stage 4) and 1F1B at (data 2, stage 2), full
    width, 4 blocks, f32 with TF32 off, a batch of 8 x 256: each took
    ``TP_GATE_STEPS`` SGD-momentum steps on four gloo processes on the card
    from the same seeded full weights as the one-rank step on the card over
    the whole batch; the losses, every gathered gradient and every gathered
    parameter after held to phase 27's limits, which four wrong variants
    must fail (:data:`PP_VARIANTS`); each rank's launches (and its one-rank
    reference's) exact."""
    depth = PP_GATE_KW["depth"]
    reference = {k: TP_GATE_STEPS * v for k, v in dict(
        ce_fwd=1, ce_bwd=1, flash_fwd=depth, flash_bwd=2 * depth, K2a=depth, K2d=depth,
        K2e=depth).items()}
    readings = {}
    for name in ranks[0]:
        if name == "reference":
            continue
        case = PP_VARIANTS[name][0] if name in PP_VARIANTS else name
        n_stage = PP_GATE_CASES[case][0][1]
        for r, got in enumerate(ranks):
            check_launches(f"rank {r} one-rank reference", got["reference"], reference)
            check_launches(f"rank {r} {name}", got[name]["launches"],
                           pp_gate_launches(case, r % n_stage))
        readings[name] = {k: max(got[name]["readings"][k] for got in ranks)
                          for k in ranks[0][name]["readings"]}
    for name, r in readings.items():
        wrong = name in PP_VARIANTS
        verdict = "within" if tp_gate_within(r) else ("outside" if wrong else "OUTSIDE")
        say(f"  {'wrong variant ' if wrong else ''}{name} vs one rank: {r} (rank 0 losses "
            f"{ranks[0][name]['losses']}) -> {verdict}")
    bad = [k for k, r in readings.items() if k not in PP_VARIANTS and not tp_gate_within(r)]
    if bad:
        raise AssertionError(f"the pipeline on the card outside its limits: {bad}")
    inside = [k for k in PP_VARIANTS if tp_gate_within(readings[k])]
    if inside:
        raise AssertionError(f"the pipeline: wrong variants within the limits: {inside}")
    return readings


def pp_exchange_timer(torch) -> dict:
    """Time every stage hop (``StageExchange.hop``, its host staging
    included) and every all-reduce of the step (the stage group's of the
    shared leaves and the loss, the data group's), synchronised before and
    after: calls, bytes this rank sent and received, seconds."""
    from pytorch_distributed_training_tpu_torch.engine import pp_steps
    from pytorch_distributed_training_tpu_torch.parallel.pipeline import StageExchange

    clock = {k: dict(seconds=0.0, calls=0, bytes=0) for k in ("hops", "reduces")}
    size = lambda t: 0 if t is None else t.numel() * t.element_size()  # noqa: E731

    def timed(kind, plain, nbytes):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = plain(*args, **kw)
            torch.cuda.synchronize()
            c = clock[kind]
            c["seconds"] += time.perf_counter() - t0
            c["calls"] += 1
            c["bytes"] += nbytes(*args, **kw)
            return out
        return run

    StageExchange.hop = timed("hops", StageExchange.hop, lambda self, *ts, **kw: sum(
        size(t) for t in (*ts, *kw.values())))
    pp_steps._all_reduce_sum_ = timed("reduces", pp_steps._all_reduce_sum_,
                                      lambda ts, g=None: sum(size(t) for t in ts))
    return clock


def pp_config(depth=None, steps: int = 4) -> dict:
    """``config/TransformerLM-pp.yml`` for (b), as it is but ``depth`` blocks
    if given: ``steps`` steps, a log line each, a batch an epoch and one
    validation batch after the last step."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg

    cfg = get_cfg(PP_CONFIG)
    if depth is not None:
        cfg["model"]["depth"] = depth
    cfg["training"].update(train_iters=steps, print_interval=1, val_interval=steps)
    cfg["dataset"]["n_samples"] = cfg["training"]["batch_size"]
    return cfg


def pp_runner_readings(torch, modules, rank: int, port: int, depth, steps: int) -> dict:
    """(b) on one rank: the runner on ``config/TransformerLM-pp.yml`` (its
    depth cut to ``depth`` if given) for ``steps`` steps (1 warm-up, the rest
    timed) and one validation batch: its launches a step and in the
    validation with their shapes, the step ms, the hops and all-reduces a
    step and the peak memory of this process."""
    from pytorch_distributed_training_tpu_torch.engine import Runner

    clock = pp_exchange_timer(torch)
    shapes, restore = tp_kernel_shapes(modules)
    marks = []

    def on_iter(runner):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), all_counts(modules),
                       *(clock[k][f] for k in ("hops", "reduces")
                         for f in ("seconds", "calls", "bytes"))))

    for m in modules:
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = Runner(num_nodes=PP_RANKS, rank=rank, seed=0, dist_url=f"tcp://127.0.0.1:{port}",
                    multiprocessing=False, logger_queue=None, global_cfg=pp_config(depth, steps),
                    device="cuda", dist_backend="gloo", on_iter=on_iter)
    runner()
    wall = time.perf_counter() - t0
    restore()
    final = all_counts(modules)
    prev, per_step = {k: 0 for k in final}, []
    for _, counts, *_ in marks:
        per_step.append({k: counts[k] - prev[k] for k in final})
        prev = counts
    diffs = lambda j: [b[j] - a[j] for a, b in zip(marks, marks[1:])]  # noqa: E731
    lay = runner.layout
    return dict(rank=rank, path=runner.path, stage=lay.stage_idx, n_data=lay.n_data,
                n_stage=lay.n_stage, schedule=runner.pp_schedule, micro=runner.microbatches,
                blocks=list(runner.model.block_ids), remat=runner.model.remat,
                host_staged=lay.stage_exchange.host_staged, step_ms=[s * 1e3 for s in diffs(0)],
                hop_ms=[s * 1e3 for s in diffs(2)], hop_calls=diffs(3), hop_bytes=diffs(4),
                reduce_ms=[s * 1e3 for s in diffs(5)], reduce_calls=diffs(6),
                reduce_bytes=diffs(7), per_step=per_step,
                validation={k: final[k] - prev[k] for k in final}, final=final,
                shapes={k: sorted(v) for k, v in shapes.items()},
                losses=[r["loss"] for r in runner.train_log], val=runner.val_log,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, wall_s=wall,
                params_m=sum(p.numel() for p in runner.model.parameters()) / 1e6)


def pp_worker(rank: int, task: str, ports: list, run) -> None:
    """One of phase 29's ranks, a process of its own on ``cuda:0``: (a)
    (:func:`pp_gate_worker`), then, unless ``run`` is ``None``, (b)
    (:func:`pp_runner_readings` at ``run = (depth, steps)``).  Writes its
    results under ``PP_DIR``."""
    import gc

    import torch

    from pytorch_distributed_training_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_training_tpu_torch.ops import fused_ce as ce
    from pytorch_distributed_training_tpu_torch.ops import fused_elementwise as fe

    modules = (fe, ce, fa)
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    pp_gate_worker(torch, modules, rank, ports[0])
    if run is None:
        return
    gc.collect()  # (a)'s steps hold their optimizers in reference cycles
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out = pp_runner_readings(torch, modules, rank, ports[1], *run)
    out.update(gate_s=t1 - t0, runner_s=time.perf_counter() - t1)
    with open(os.path.join(PP_DIR, f"runner.rank{rank}.json"), "w") as f:
        json.dump(out, f)


def pp_run_launches(depth: int, micro: int, stage: int, n_stage: int) -> tuple:
    """(b)'s launches a step and in the validation batch on ``stage``: under
    1F1B with block remat each of the stage's blocks runs its bf16 flash
    forward three times a microbatch (the F slot, the B slot's recompute and
    remat's replay in its backward) and its backward pair (K2c, dK/dV and
    dQ) once; the last stage runs the head's K1a in each F and B slot and
    K1b in each B slot; no K3/K4.  The validation runs the GPipe ticks
    forward only: one flash forward a block and, on the last stage, one
    K1a a microbatch."""
    blocks = depth // n_stage
    step = dict(flash_fwd=3 * blocks * micro, flash_bwd=2 * blocks * micro,
                K2a=3 * blocks * micro, K2c=2 * blocks * micro)
    val = dict(flash_fwd=blocks * micro, K2a=blocks * micro)
    if stage == n_stage - 1:
        step.update(ce_fwd=2 * micro, ce_bwd=micro)
        val.update(ce_fwd=micro)
    return step, val


def phase_pp_runner(torch, smi: str, ranks: list, depth: int, steps: int, wall: float) -> dict:
    """Phase 29 (b)'s verdicts and readings on the ranks' results
    (:func:`pp_runner_readings`): each rank ran its stage of the pipeline
    path under 1F1B with block remat, its launches exact a step and in the
    validation (:func:`pp_run_launches`), every loss finite and equal on the
    ranks, the validation equal on the ranks.  Prints the step ms, global
    tokens/s, the hops' and all-reduces' calls, bytes, synced ms and share of
    the step, each process's peak memory and each rank's launches with
    their shapes beside the card.  Returns the four ranks' launch counts
    summed."""
    cfg = pp_config(depth, steps)
    micro, batch = cfg["training"]["microbatches"], cfg["training"]["batch_size"]
    seq = cfg["dataset"]["seq_len"]
    for got in ranks:
        per_step, per_val = pp_run_launches(depth, micro, got["stage"], got["n_stage"])
        if (got["path"] != "pipeline" or got["schedule"] != "1f1b" or not got["remat"]
                or got["n_stage"] != PP_RANKS or got["micro"] != micro):
            raise AssertionError(f"rank {got['rank']} did not run 1F1B over {PP_RANKS} stages "
                                 f"with block remat: {got['path']}, {got['schedule']}")
        for i, counts in enumerate(got["per_step"]):
            check_launches(f"rank {got['rank']} step {i}", counts, per_step)
        check_launches(f"rank {got['rank']} validation", got["validation"], per_val)
        if got["losses"] != ranks[0]["losses"] or not all(
                math.isfinite(x) for x in got["losses"]) or len(got["losses"]) != steps:
            raise AssertionError(f"rank {got['rank']} losses {got['losses']}, rank 0's "
                                 f"{ranks[0]['losses']}")
        if got["val"] != ranks[0]["val"] or not math.isfinite(got["val"][0]["loss"]):
            raise AssertionError(f"rank {got['rank']} validation {got['val']}")
    step_ms = ranks[0]["step_ms"]
    med = statistics.median(step_ms)
    n_data = ranks[0]["n_data"]
    tokens_per_s = n_data * batch * seq / med * 1e3
    share = lambda key: [sum(r[key]) / sum(r["step_ms"]) for r in ranks]  # noqa: E731
    say(f"  {smi}: TransformerLM-pp.yml at depth {depth}, {PP_RANKS} stages x {n_data} data "
        f"(gloo processes on one card; hops "
        f"{'staged through pinned host memory' if ranks[0]['host_staged'] else 'on device'}),"
        f" 1F1B over {micro} microbatches of {batch // micro} x {seq}; parameters a rank "
        f"(M) {[round(r['params_m'], 2) for r in ranks]}")
    say(f"  losses {ranks[0]['losses']}; validation {ranks[0]['val']}")
    say(f"  step ms (steps 1-{len(step_ms)}, host clock, synced): {step_ms}; median {med}; "
        f"global tokens/s {tokens_per_s}")
    say(f"  stage hops a step (synced, host staging included): calls by rank "
        f"{[r['hop_calls'] for r in ranks]}, MiB sent + received by rank "
        f"{[[b / 2**20 for b in r['hop_bytes']] for r in ranks]}, ms by rank "
        f"{[r['hop_ms'] for r in ranks]}; share of the step by rank {share('hop_ms')}")
    say(f"  all-reduces a step (the stage group's shared gradients and loss; synced): calls "
        f"{ranks[0]['reduce_calls']}, MiB {[b / 2**20 for b in ranks[0]['reduce_bytes']]}, "
        f"ms by rank {[r['reduce_ms'] for r in ranks]}; share of the step by rank "
        f"{share('reduce_ms')}")
    say(f"  peak device memory by process (GiB): {[r['peak_gib'] for r in ranks]}; wall "
        f"{wall:.1f} s, of it (a) {[round(r['gate_s'], 1) for r in ranks]} s and (b) "
        f"{[round(r['runner_s'], 1) for r in ranks]} s by rank")
    for got in ranks:
        say(f"  rank {got['rank']} (stage {got['stage']}, blocks {got['blocks']}) launches a "
            f"step {counts_line(got['per_step'][-1])}; validation "
            f"{counts_line(got['validation'])}; shapes {got['shapes']}")
    total = {k: sum(r["final"][k] for r in ranks) for k in ranks[0]["final"]}
    say("pp: " + json.dumps(dict(
        depth=depth, step_ms=step_ms, median_step_ms=med, tokens_per_s=tokens_per_s,
        hop_share=share("hop_ms"), reduce_share=share("reduce_ms"),
        hop_calls=[r["hop_calls"] for r in ranks], hop_bytes=[r["hop_bytes"] for r in ranks],
        peak_gib=[r["peak_gib"] for r in ranks], losses=ranks[0]["losses"],
        val=ranks[0]["val"], wall_s=wall, card=smi)))
    return total


def phase_pipeline(torch, smi: str, runner: bool = True) -> dict:
    """Phase 29: (a)'s full weights drawn here, then one spawn of four gloo
    processes on the card runs (a) and, with ``runner``, (b)
    (:func:`pp_worker`); :func:`phase_pp_gate` and :func:`phase_pp_runner`
    (on ``config/TransformerLM-pp.yml`` at its depth, 1 + 3 steps) judge and
    print.  The whole script's run takes (a) alone: with phase 29 at 4
    blocks for 1 + 1 steps it took 1,094.8 s of its 1,200 s on an H100 80GB
    HBM3 at 700 W.  Returns (b)'s launch counts summed over the ranks, by
    path."""
    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg

    t_phase = time.perf_counter()
    os.makedirs(PP_DIR, exist_ok=True)
    torch.save(tp_gate_weights(torch, "dense", seed=29, kw=PP_GATE_KW),
               os.path.join(PP_DIR, "full.pt"))
    depth, steps = get_cfg(PP_CONFIG)["model"]["depth"], 4
    wall = tp_spawn(torch, "pp", depth=(depth, steps) if runner else None, worker=pp_worker,
                    ports=2)
    say(f"  four ranks' wall {wall:.1f} s (spawn, (a)'s {len(PP_GATE_CASES)} cases and "
        f"{len(PP_VARIANTS)} wrong variants of {TP_GATE_STEPS} steps{', (b)' if runner else ''})")
    read = lambda name: [json.load(open(os.path.join(PP_DIR, f"{name}.rank{r}.json")))  # noqa: E731
                         for r in range(PP_RANKS)]
    gate = phase_pp_gate(torch, read("gate"))
    say("pp_gate: " + json.dumps(gate))
    paths = ({"pp": by_tpu_kernel(phase_pp_runner(torch, smi, read("runner"), depth, steps,
                                                  wall))} if runner else {})
    say(f"  phase 29 took {time.perf_counter() - t_phase:.1f} s")
    return paths


def counts_line(counts: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in counts.items() if v)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--f32-runner", action="store_true",
                        help="phases 1, 2 and 12 only (no result line)")
    parser.add_argument("--resnet", action="store_true",
                        help="phases 1, 2 and 13 to 17 only (no result line)")
    parser.add_argument("--accum-faults", action="store_true",
                        help="phases 1, 2, 18 and 19 only (no result line)")
    parser.add_argument("--serve", action="store_true",
                        help="phases 1, 2, 5 and 20 only (no result line)")
    parser.add_argument("--vit", action="store_true",
                        help="phases 1, 2, 17, 22 and 23 only (no result line)")
    parser.add_argument("--fleet", action="store_true",
                        help="phases 1, 2 and 24 only (no result line)")
    parser.add_argument("--moe", action="store_true",
                        help="phases 1, 2 and 25 only (no result line)")
    parser.add_argument("--sp", action="store_true",
                        help="phases 1, 2 and 26 only (no result line)")
    parser.add_argument("--tp", action="store_true",
                        help="phases 1, 2 and 27 only (no result line)")
    parser.add_argument("--zero", action="store_true",
                        help="phases 1, 2 and 28 only (no result line)")
    parser.add_argument("--pp", action="store_true",
                        help="phases 1, 2 and 29 only (no result line)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    from pytorch_distributed_training_tpu_torch import kernels
    from pytorch_distributed_training_tpu_torch.ops import fused_ce as ce
    from pytorch_distributed_training_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_training_tpu_torch.ops import fused_elementwise as fe

    from pytorch_distributed_training_tpu_torch.config_parsing import get_cfg

    modules = (fe, ce, fa)
    # phases 4, 7, 10 and 13 turn TF32 off; phase 14 runs at torch's defaults
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

    t_start = time.perf_counter()
    phase("phase 1: the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    # phase 27's ranks exchange through gloo: its copy and reduce all-reduce
    # the bf16 stream in bf16
    say(f"gloo all_reduce of CUDA tensors, 2 ranks: takes {tp_probe_gloo(torch)} "
        "(the port's copy/reduce dtype on the bf16 stream)")
    # phase 28's ZeRO exchanges: reduce-scatters and all-gathers of f32 and bf16
    say(f"gloo reduce-scatter and all-gather of CUDA tensors, 2 ranks: takes "
        f"{zero_probe_gloo(torch)} (the port's ZeRO exchanges)")
    # phase 29's pipeline hops: send/recv between two processes
    say(f"gloo send/recv of CUDA tensors through the stage exchange, 2 processes: "
        f"{pp_probe_gloo(torch)} (a raw gloo send of a CUDA tensor fails: writev, Bad "
        f"address)")

    phase("phase 2: build")
    built = kernels.build()
    for name, secs in built.items():
        say(f"  built {name} in {secs:.1f} s -> {kernels.library_path(name)}")
        for line in ptxas_report(kernels.build_logs.get(name, "")):
            say(f"    {line}")

    if args.f32_runner:
        phase("phase 12: main path (training runner, full width, float32)")
        phase_f32_runner_and_profile(torch, modules, args.profile)
        say(smi)
        return 0
    if args.resnet:
        phase_resnet(torch, modules, tf32_defaults, args.profile)
        phase(None)
        say(f"total {time.perf_counter() - t_start:.1f} s")
        say(smi)
        return 0
    if args.accum_faults:
        phase_accum_and_faults(torch, modules)
        phase(None)
        say(f"total {time.perf_counter() - t_start:.1f} s")
        say(smi)
        return 0

    if args.vit:
        # phase 23 (c) serves phase 17's checkpoint
        phase("phase 17: checkpoint, resume and preemption (config/test-sync.yml, f32, EMA)")
        phase_checkpoint(torch, modules)
        phase_vit_and_serving(torch, modules, tf32_defaults, smi, args.profile)
        phase(None)
        say(f"total {time.perf_counter() - t_start:.1f} s")
        say(smi)
        return 0

    if args.fleet:
        phase("phase 24: the fleet tier (router, failover, disaggregation), full width")
        phase_fleet(torch, np, modules, fe, smi)
        phase(None)
        say(f"total {time.perf_counter() - t_start:.1f} s")
        say(smi)
        return 0

    if args.moe:
        phase("phase 25: the Mixture-of-Experts LM (expert-parallel degree 1), full width")
        phase_moe(torch, modules, args.profile)
        phase(None)
        say(f"total {time.perf_counter() - t_start:.1f} s")
        say(smi)
        return 0

    if args.sp:
        phase("phase 26: sequence parallelism (flash_attention_lse, ring, Ulysses), full shape")
        phase_sequence_parallel(torch, modules, smi)
        phase(None)
        say(f"total {time.perf_counter() - t_start:.1f} s")
        say(smi)
        return 0

    if args.tp:
        phase("phase 27: tensor and expert parallelism at degree 4, full width")
        phase_tensor_parallel(torch, modules, smi)
        phase(None)
        say(f"total {time.perf_counter() - t_start:.1f} s")
        say(smi)
        return 0

    if args.zero:
        phase("phase 28: ZeRO-1/2/3 at 4 data ranks, full width")
        phase_zero(torch, modules, smi)
        phase(None)
        say(f"total {time.perf_counter() - t_start:.1f} s")
        say(smi)
        return 0

    if args.pp:
        phase("phase 29: pipeline parallelism (GPipe, 1F1B) over 4 stages, full width")
        phase_pipeline(torch, smi)
        phase(None)
        say(f"total {time.perf_counter() - t_start:.1f} s")
        say(smi)
        return 0

    if args.serve:
        phase("phase 5: main path (serving batcher, full width)")
        phase_main_path(torch, fe, np, modules)
        torch.cuda.empty_cache()
        phase("phase 20: main path (serving scheduler, full width)")
        _, plain = phase_serve_sched(torch, np, modules, fe, smi, args.profile)
        phase("phase 21: serving decode modes, full width")
        phase_serve_modes(torch, modules, fe, smi, plain, args.profile)
        phase(None)
        say(f"total {time.perf_counter() - t_start:.1f} s")
        say(smi)
        return 0

    phase("phase 3: kernels against their plain twins")
    cases = phase_kernels(torch, fe)

    phase("phase 4: full-width model, card vs CPU")
    phase_model_vs_cpu(torch, fe)

    phase("phase 5: main path (serving batcher, full width)")
    paths = {}
    serve_counts, engine = phase_main_path(torch, fe, np, modules)
    paths["serving"] = by_tpu_kernel(serve_counts)
    if args.profile:
        say("== profile")
        phase_profile(torch, engine, np)
    engine = None
    torch.cuda.empty_cache()

    phase("phase 6: training kernels against their plain twins")
    cases.update(phase_train_kernels(torch, ce, fa))

    phase("phase 7: full-width training step, card vs CPU")
    # f32 at S = 256: the resident forward (K2a) and the split backward
    # (K2d dQ, K2e dK/dV) of the JAX package, here the f32 kernels
    phase_step_vs_cpu(
        torch, modules, "full-width training step on the card",
        dict(vocab_size=32768, max_len=2048, embed_dim=1024, depth=2, num_heads=16,
             fused_tails=True, flash=True), batch=2, seq=256, seed=4,
        want=dict(add_layernorm=2, bias_gelu=2, ce_fwd=1, ce_bwd=1, flash_fwd=2, flash_bwd=4,
                  K2a=2, K2d=2, K2e=2))

    phase("phase 8: main path (training runner, full width)")
    depth = get_cfg(TRAIN_CONFIG)["model"]["depth"]
    runner, counts, train = phase_runner(
        torch, modules, TRAIN_CONFIG, "train-lm-1024",
        per_step=dict(add_layernorm=depth, bias_gelu=depth, ce_fwd=1, ce_bwd=1, flash_fwd=depth,
                      flash_bwd=2 * depth, K2a=depth, K2c=2 * depth),
        per_val_batch=dict(add_layernorm=depth, bias_gelu=depth, ce_fwd=1, flash_fwd=depth,
                           K2a=depth))
    paths["training"] = by_tpu_kernel(counts)
    say("training: " + json.dumps(train))
    if args.profile:
        say("== profile (training step)")
        phase_profile_train(torch, runner, "train step")
    runner = None
    torch.cuda.empty_cache()

    phase("phase 9: long-context flash kernels against their plain twins")
    cases.update(phase_long_kernels(torch, fa))

    phase("phase 10: long-context widths, f32 training step with remat, card vs CPU")
    # f32 at S = 2048: K2a forward (run twice a block: remat), K2d/K2e backward
    counts, _ = phase_step_vs_cpu(
        torch, modules, "long-context-width f32 step on the card",
        dict(vocab_size=8192, max_len=2048, embed_dim=512, depth=2, num_heads=8, flash=True,
             remat=True), batch=2, seq=2048, seed=8,
        want=dict(ce_fwd=1, ce_bwd=1, flash_fwd=4, flash_bwd=4, K2a=4, K2d=2, K2e=2))
    paths["f32_step"] = by_tpu_kernel(counts)

    phase("phase 11: main path (training runner, long context)")
    depth = get_cfg(LONGCTX_CONFIG)["model"]["depth"]
    # remat runs every block's forward twice a step; S = 32768 is past the
    # JAX package's resident budget, so every flash launch stands for a
    # streamed TPU kernel
    runner, counts, longctx = phase_runner(
        torch, modules, LONGCTX_CONFIG, "train-lm-longctx",
        per_step=dict(ce_fwd=1, ce_bwd=1, flash_fwd=2 * depth, flash_bwd=2 * depth,
                      K2b=2 * depth, K2f=depth, K2g=depth),
        per_val_batch=dict(ce_fwd=1, flash_fwd=depth, K2b=depth))
    paths["longctx"] = by_tpu_kernel(counts)
    say("longctx: " + json.dumps(longctx))
    if args.profile:
        say("== profile (long-context training step)")
        phase_profile_train(torch, runner, "long-context train step")
    runner = None
    torch.cuda.empty_cache()

    phase("phase 12: main path (training runner, full width, float32)")
    paths["f32_runner"] = by_tpu_kernel(phase_f32_runner_and_profile(torch, modules, args.profile))
    paths.update(phase_resnet(torch, modules, tf32_defaults, args.profile))
    paths.update(phase_accum_and_faults(torch, modules))
    phase("phase 20: main path (serving scheduler, full width)")
    counts, plain = phase_serve_sched(torch, np, modules, fe, smi, args.profile)
    paths["serving_sched"] = by_tpu_kernel(counts)
    phase("phase 21: serving decode modes, full width")
    serving_modes = phase_serve_modes(torch, modules, fe, smi, plain, args.profile)
    paths.update(phase_vit_and_serving(torch, modules, tf32_defaults, smi, args.profile))
    phase("phase 24: the fleet tier (router, failover, disaggregation), full width, (b) at "
          f"depth {FLEET_DEFAULT_RUN_DEPTH}")
    paths["fleet"] = by_tpu_kernel(phase_fleet(torch, np, modules, fe, smi,
                                               FLEET_DEFAULT_RUN_DEPTH))
    phase("phase 25: the Mixture-of-Experts LM (expert-parallel degree 1), full width, (b) at "
          f"depth {MOE_DEFAULT_RUN_DEPTH}")
    paths["moe"] = by_tpu_kernel(phase_moe(torch, modules, args.profile, MOE_DEFAULT_RUN_DEPTH))
    phase("phase 26: sequence parallelism (flash_attention_lse, ring, Ulysses), full shape")
    sp_counts, sp_rows = phase_sequence_parallel(torch, modules, smi)
    paths["sp"] = by_tpu_kernel(sp_counts)
    cases.update(sp_rows)
    phase("phase 27: tensor and expert parallelism at degree 4, full width, (b) at depth "
          f"{TP_DEFAULT_RUN_DEPTH}")
    paths.update(phase_tensor_parallel(torch, modules, smi, TP_DEFAULT_RUN_DEPTH))
    phase(f"phase 28: ZeRO-1/2/3 at 4 data ranks, full width, (b) at depth "
          f"{ZERO_DEFAULT_RUN_DEPTH}")
    paths.update(phase_zero(torch, modules, smi, ZERO_DEFAULT_RUN_DEPTH))
    phase("phase 29: pipeline parallelism (GPipe, 1F1B) over 4 stages, full width, (a) only")
    paths.update(phase_pipeline(torch, smi, runner=False))

    keys = ("shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms", "ffma_bound_ms")
    summary = []
    for tpu, (replaces, src, cuda_kernel, (case, idx), path) in TPU_KERNELS.items():
        if paths[path][tpu] == 0:
            raise AssertionError(f"{tpu}: no launch on the {path} path")
        row = dict(name=tpu, kernel=cuda_kernel, route="cuda", source=_CSRC + src,
                   replaces=replaces, launches=paths[path][tpu], path=path,
                   launches_by_path={p: n[tpu] for p, n in paths.items()}, matched=True)
        row.update({k: cases[case][idx].get(k) for k in keys})
        row["also"] = [{k: cases[c][i].get(k) for k in keys} for c, i in ALSO.get(tpu, ())]
        if WRAPPER_OF.get(tpu) in fe.KERNELS:
            # K3/K4's launches on phase 21's run of each decode mode
            row["serving_modes"] = {m: n[WRAPPER_OF[tpu]] for m, n in serving_modes.items()}
        summary.append(row)
    phase(None)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": summary}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
