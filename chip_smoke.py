#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --eager                 (every train step eager)
    python3 chip_smoke.py --plant-fault KERNEL    (any kernel of FAULTS)
    python3 chip_smoke.py --cards 4               (phase 16, on four cards)
    python3 chip_smoke.py --cards 4 --plant-fault ring_dkv_home
    python3 chip_smoke.py --plant-fault serve_left_pad
    python3 chip_smoke.py --plant-fault pbt_own_restore
    python3 chip_smoke.py --plant-fault learner_no_allreduce
    python3 chip_smoke.py --plant-fault sac_stale_critic
    python3 chip_smoke.py --plant-fault vit_padded_keys
    python3 chip_smoke.py --plant-fault dag_stage_skips_block
    python3 chip_smoke.py --plant-fault workflow_reruns_done_step
    python3 chip_smoke.py --plant-fault fake_node_gpu_as_resource

Phases, each printed as it ends; any failed check raises and the script
exits non-zero without its result line:

1. Card: name and power limit from nvidia-smi.
2. Build: every CUDA kernel of ``ray_tpu_torch/ops/cuda/csrc`` with
   nvcc (one process per source, in parallel), with ptxas' register and
   spill counts and its notes (wgmma serialization).
3. Kernels: each square flash-attention kernel at GPT-2 small widths
   (H=12, D=64, bf16, causal), at T=1024 (the training shape, batch 32)
   and at T=2048 (batch 8), held against its plain PyTorch version on
   the same inputs by ``flash_attention.agreement`` (per element and
   overall, limits in ``AGREEMENT_TOL``), and timed with CUDA events
   beside its bound, the plain version and
   ``F.scaled_dot_product_attention`` on the same inputs (a yardstick
   only: the port never calls it). After phase 5, the non-causal
   rectangle of ViT's bidirectional ring (``flash_fwd_nc_rect`` and its
   backward) at ViT-B/16's ``sp 4`` shapes: B·H = 128·12 padded query
   blocks of 50 rows against 50 and 47 valid rows of a padded block, read
   in place, held and timed the same way (SDPA with the padded keys
   masked); with no valid row it launches nothing.
4. Train: GPT-2 124M (``GPT2Config.small()``, random weights from seed
   0) on ``cuda:0`` at batch 32 and seq 1024. First, at step 0 on one
   batch: each layer's attention kernels, on the q, k, v and output
   gradient that layer gives them, are held against the plain versions
   by ``agreement``; the gradients of every layer's attention weights
   (the q, k and v thirds of ``qkv_kernel``, and ``proj_kernel``)
   through the kernels against those through the plain attention
   within GRAD_TOL; and the step-0 loss against the plain-attention,
   full-f32-logit path's within STEP0_LOSS_TOL. Then it trains through
   ``prefetch_to_device``
   and ``make_multi_train_step`` with ``adamw(3e-4, weight_decay=0.1,
   mu_dtype=bf16)`` on that batch, repeated. Checks: the loss is finite
   and falls; each kernel launched 12 times (one per layer) per step.
5. Bands: the band kernels of the causal split (``flash_fwd_rect``,
   ``flash_bwd_dq_rect``, ``flash_bwd_dkv_rect``) at B=32, T=1024, on
   every band of split 2 and split 4, read in place from the [BH, T, D]
   tensors, held against their plain versions by ``agreement`` and
   timed beside their bound, the plain version and SDPA with a
   bottom-right causal mask (``causal_lower_right``). The whole split
   (``RAY_TPU_FLASH_SPLIT``) is held against the unsplit kernels (o bit
   for bit, gradients by ``agreement``) and the plain whole attention,
   and timed beside the unsplit attention.
6. Split training: phase 4's model and batch with
   ``RAY_TPU_FLASH_SPLIT`` 2, then 4 (set for the phase, restored
   after). Checks: the band kernels on layers 0 and 11's own q, k, v and
   output gradient; the step-0 loss within STEP0_LOSS_TOL of phase 4's;
   the loss finite and falling; n_split x 12 launches per step of each
   band kernel and none of the square ones.
7. Remat: phase 4's model under each ``remat_policy``. Checks: the
   step-0 loss and every gradient match the model without remat
   (REMAT_LOSS_TOL, REMAT_GRAD_TOL); per layer per step 2 forward
   launches (1 under "everything") and 1 of each backward kernel; peak
   memory under "nothing" below phase 4's.
8. TinyLlama 1.1B (``LlamaConfig.tinyllama_1b()``, random weights from
   seed 0, 32 heads on 4 kv heads, D=64) at batch 8 and seq 2048, chunked
   CE with chunk 2048, trained and profiled as in phase 4. Checks: the
   kernels on layers 0, 11 and 21's own q, k, v and output gradient (all
   256 folded heads, the shape training gives them); the step-0 loss
   against the
   plain-attention, full-logit path's; the loss finite and falling; each
   square kernel launched 22 times per step.
9. ResNet-50 (``ResNet50Config()``, 1000 classes, random weights from
   seed 0) at batch 128, 224x224, bf16 in ``channels_last`` (cuDNN
   convolutions), ``sgd(0.1, momentum=0.9, nesterov=True)`` with the
   BatchNorm statistics through the step (``has_extra``), on images drawn
   on the card behind the prefetcher. Checks: the step-0 train-mode
   logits at batch 8 against the same weights' float32 forward on the
   CPU (RESNET_LOGIT_TOL); the loss finite and falling; every running
   mean and variance finite and moved, and an eval-mode forward that
   reads them; no flash kernel launched. Prints step ms, images/s, peak
   bytes, the input stall, one profiled dispatch (convolutions, products,
   reductions, the rest) and the share of the bf16 peak from the FLOPs of
   its products and convolutions.
10. ViT-B/16 (``ViTConfig.base()``, random weights from seed 0) at batch
   128, 224x224 (T = 197), ``adamw(3e-3)``. Checks: the square kernels
   with ``causal=False`` on layers 0 and 11's own q, k, v and output
   gradient (all 1536 folded heads) by ``agreement``; the step-0 loss
   against the plain attention within VIT_STEP0_LOSS_TOL; the loss
   finite and falling; 12 launches per step of each square kernel, none
   of the band routes. Prints the kernels' times at that shape beside their bound,
   plain versions and SDPA with no mask, and the run as for ResNet-50.

11. MoE (``MoEConfig()``: GPT-2 small widths, 12 layers, 8 experts in
   every 2nd block, capacity factor 2, 322 M parameters, random weights
   from seed 0) at batch 32 and seq 1024, ``adamw(3e-4,
   weight_decay=0.1, mu_dtype=bf16)`` and chunked CE. Checks: the square
   kernels on MoE layers 1 and 11's own q, k, v and output gradient; the
   step-0 loss against the plain attention within STEP0_LOSS_TOL; the
   aux losses finite; on the first MoE layer's own first 4096 tokens the
   index-form switch FFN against the one-hot einsum form (MOE_FORM_*);
   the loss falling; 12 launches per step of each square kernel, none of
   the bands. Prints step ms, tokens/s, FLOPs a step, the share of the
   bf16 peak, peak bytes, the busy share, and each MoE layer's dropped
   share and per-expert load at step 0 and at the end.

12. Mesh, on a one-rank NCCL group (``parallel.initialize``) and a mesh
   whose axes all have one rank. (a) GPT-2 124M at batch 32 x 1024 on
   ``dp = 1`` through ``init_train_state(mesh=)``, ``shard_batch`` and the
   captured step, the gradient all-reduce inside its graph. Checks: the
   first CAPTURE_STEPS losses against the mesh-less captured step's from
   the same weights (CAPTURE_LOSS_RTOL), ``compile_count`` 1 and buffers
   donated, 12 launches per kernel per step; step ms over
   MESH_TIMED_STEPS steps beside the mesh-less step's and phase 4's.
   (b) The same under FSDP2 (``fsdp = 1``, forced): parameters sharded,
   the step eager by rule (``compile_count`` None), the step-0 loss
   against (a)'s. (c) Ring attention at ``sp = 4`` (RING_SP) at GPT-2's
   (B 32, T 1024, H 12) and TinyLlama's (B 8, T 2048, H 32) attention
   shapes: ``RingAttentionFn``'s own forward and backward on every rank,
   each rank a thread of this process whose rotations pass through
   queues (``ThreadRing``): o, lse, dq, dk and dv of the whole against
   the plain whole causal attention by ``agreement``, 1 + r hops of each
   kernel on rank r; the hops' summed kernel time beside the unsplit
   kernels'. (c') The bidirectional ring of ViT on ``sp``, the same
   function the same way at ViT-B/16's shape (B 128, T 197, H 12) on
   ``sp`` 4 and 8: the sequence padded to blocks of
   ``models.vit.seq_blocks``, the padded rows random, each rank's padded
   queries against every block's valid rows; o, lse, dq, dk, dv of the
   valid rows against the plain whole non-causal attention, one launch
   of each rectangle kernel per rank and block with a valid row; its
   launches on ``sp 4`` are the one-card kernels line's (ViT itself on
   ``sp`` runs in phase 16 (g)). ``--plant-fault vit_padded_keys`` runs
   (c') on ``sp 4`` with every padded row read as a key (exit 1 caught, 2
   missed). (d) Ulysses
   over the ``sp`` group at world 1 equal to ``causal_attention`` bit
   for bit (output and gradients), and
   ``moe_ffn`` over the ``ep`` group within one bf16 unit of the one-hot
   einsum form at ``MoEConfig()``'s width on 4096 tokens. (e)
   ``dryrun_multichip(1)`` with no device named, run at the end of phase
   13 (its (g)): one spawned NCCL rank on ``cuda:0`` takes a GPT-2 tiny
   train step (head dim 64) through the kernels on the JAX dry run's
   ``dp × sp × tp`` factors (all 1), a finite loss.

13. Tensor and pipeline parallelism, the MoE transformer over ``ep`` and
   checkpoints, on phase 12's one-rank NCCL mesh at full width. (a) GPT-2
   124M at batch 32 x 1024 with the tp route forced on the one-rank
   ``tp`` axis (``sharding._place_forced``, as phase 12 forces FSDP2):
   every tp collective (``copy_to``, ``reduce_from``), the vocab-parallel
   lookup and cross-entropy run, captured. Checks: the first
   CAPTURE_STEPS losses against phase 12's mesh-less captured step's
   (CAPTURE_LOSS_RTOL), ``compile_count`` 1, buffers donated, 12 launches
   per kernel per step; step ms beside the mesh-less step's. (b)
   TinyLlama 1.1B at batch 8 x 2048 the same way: the step-0 loss against
   the mesh-less step's, 22 launches per kernel. (c) ``MoETransformer
   (MoEConfig())`` at batch 32 x 1024 on ``dp 1 × ep 1`` through the
   global routing (``ops.moe.top1_route`` over the batch's tokens) and
   the ep route forced:
   the first losses against the mesh-less MoE step's, and each MoE
   layer's dropped share at step 0 equal to the mesh-less routing's. (d)
   The square kernels at the head counts a tp rank runs (TP_KERNEL_SHAPES:
   GPT-2's shape at 6 and 3 heads, TinyLlama's at 8 q heads on 1 kv head,
   its tp 4) by ``agreement``, timed beside their bound, plain versions
   and SDPA. (e) ``spmd_pipeline`` at ``pp = 1``, GPT-2 124M's 12 blocks
   as the stage, PIPE_MICROBATCHES microbatches of 8 x 1024: the loss
   within PIPE_LOSS_RTOL of the plain block stack's, the block gradients
   within PIPE_GRAD_RTOL relative norm of the plain stack on the same
   microbatches and within PIPE_WHOLE_GRAD_RTOL of the whole batch's, 4
   launches per kernel per block. (f) Checkpoint: (a)'s
   state saved after 2 steps (``train.checkpoint.save_train_state``) and
   restored into a fresh state of other weights; the next 2 losses equal
   to the uninterrupted run's bit for bit. (g) Phase 12 (e). (h) ViT-B/16
   and ResNet-50 at batch 128, 224x224, with their tp routes forced on the
   one-rank ``tp`` axis (ViT: ``mlp_proj``'s rows, ``copy_to`` and
   ``reduce_from``; ResNet: every convolution's output channels, the
   channels gathered before each convolution, BatchNorm's slices of its
   scale and bias through ``copy_to`` and its statistics gathered, the
   pooled channels through ``gather_from``), captured: the first
   CAPTURE_STEPS losses
   against the mesh-less captured step's (CAPTURE_LOSS_RTOL; at one rank
   every collective is a copy), ``compile_count`` 1, buffers donated,
   ResNet's running statistics equal; step ms beside the mesh-less step's.

14. The runtime (``ray_tpu_torch.init``, tasks, actors, the object store,
   the GPU as a resource) and ``TorchTrainer`` on it, after the driver
   has freed its memory. (a) A fresh driver's ``init()`` in a new process
   counts the card as ``GPU`` and imports no torch (so holds no CUDA
   context); here, a plain task sees ``CUDA_VISIBLE_DEVICES=""`` and no
   device, a ``num_gpus=1`` task its card and only it
   (``CUDA_VISIBLE_DEVICES="0"``, one device, ``get_gpu_ids() == [0]``).
   (b) GPT-2's ``wte`` (bf16, on the card) through ``put``/``get``,
   through a CPU task and back, and as a CPU task's argument: CPU
   tensors, bit-equal; MB/s, and the time of a CPU task that reads it
   and returns nothing. (c) GPT-2
   124M at batch 32 x 1024: the driver's CAPTURE_STEPS captured steps
   from seed 0 on the LM batch (and MESH_TIMED_STEPS timed), then a
   ``num_gpus=1`` actor, given the same weights as numpy through the
   object store, runs the same steps (``gpt2_steps``, the same code):
   losses within CAPTURE_LOSS_RTOL, ``compile_count`` 1, 12 launches of
   each kernel a step counted inside the actor; a second ``num_gpus=1``
   task waits while the actor holds the card. (d)
   ``TorchTrainer(trainer_loop, scaling_config=ScalingConfig(
   num_workers=1, gpus_per_worker=1)).fit()``: one NCCL rank, the same
   steps, each reported; the reported losses against (c)'s; the trainer's
   checkpoint (``save_train_state``) restored here into other weights
   gives the trainer's next loss bit for bit. (e) The host rates of
   RUNTIME_TASKS no-op tasks and RUNTIME_ACTOR_CALLS calls to one actor
   (printed, not checked); the workers loaded the kernels the driver
   built (no library rebuilt).
15. The Data library (``ray_tpu_torch.data``) feeding GPT-2 124M at batch
   32 x 1024 from seed 0. (a) DATA_STEPS x 32 rows of 1025 token ids
   (numpy seed 0, GPT-2's vocabulary) written with ``data.tfrecord``
   (one int64 feature ``tokens``) into DATA_FILES TFRecord files; the
   native scanner (``native/tfrec.cpp``) must have loaded, and it and the
   Python codec read the same records (CRCs checked; MB/s of each).
   (b) ``read_tfrecords(dir).map_batches(lm_batch)`` alone:
   ``iter_batches(32, drop_last=True)`` gives exactly the numpy batches,
   in order (rows/s and MB/s of the second pass); a ``map_batches`` probe
   shows its block workers without torch, jax or ray_tpu and seeing
   ``CUDA_VISIBLE_DEVICES=""``. (c) The captured step in this process fed
   by ``ds.iterator().iter_device_batches(32)`` against the same step fed
   the numpy batches through ``prefetch_to_device``, from the same
   weights: losses within CAPTURE_LOSS_RTOL (bit-equal expected), the
   batches on the card bit-equal to numpy, ``compile_count`` 1, 12
   launches of each kernel a step; the input stall and the prefetcher's
   produce time, the step ms beside phase 4's. (d)
   ``TorchTrainer(data_trainer_loop, datasets={"train": ds},
   scaling_config=ScalingConfig(num_workers=1, gpus_per_worker=1))
   .fit()``: the rank reads ``get_dataset_shard("train")
   .iter_device_batches(32)`` and reports each step's loss and batch
   checksums (int64 sums of tokens and targets): the checksums equal the
   numpy batches', the losses within CAPTURE_LOSS_RTOL of (c)'s numpy
   feed, ``compile_count`` 1 and 12 launches a kernel a step; fit()'s
   time to the first report and whole, beside phase 14's.

16. Multi-card, only under ``--cards N`` (N >= 4 cards visible, else it
   exits 1 naming the count; the plain run prints that it needs them):
   the build, then ``parallel.multicard.run`` spawns N NCCL ranks, rank r
   on ``cuda:r``, each printing its card's UUID. Every rank runs, on its
   own card, the one-card mesh-less captured step of each model from seed
   0 on the global batch, and holds each mesh route against it within the
   limits of ``parallel.multicard`` (each with its rounding argument): (a)
   GPT-2 124M at 32 x 1024 on ``dp N``, the flat-bucket all-reduce in the
   graph, the first CAPTURE_STEPS losses and gradient norms; (b)
   TinyLlama 1.1B at 8 x 2048 on ``fsdp N``, eager by rule, peak memory
   per rank below the one-card step's; (c) GPT-2 with ring attention and
   TinyLlama with Ulysses on ``sp N``: losses and every layer's step-0
   gradient, and the ring's k, v hop and dk, dv rotation alone; (d) GPT-2
   and TinyLlama on ``dp N/2 x tp 2`` and ``tp N``; (e) the MoE
   transformer on ``dp N/2 x ep 2`` and ``ep N``, the routers' step-0
   gradients; (f) ``spmd_pipeline`` on ``pp N``, GPT-2's blocks in N
   stages, PIPE_MICROBATCHES microbatches: the loss and each stage's block
   gradients against the whole batch's, and the bubble; (g) ViT-B/16 and
   ResNet-50 at 128 x 224² on ``dp N/2 x tp 2``, and ViT-B/16 on ``sp N``
   (the sequence padded to N blocks, the bidirectional ring on the
   non-causal rectangle: one launch of each rectangle kernel a layer for
   each block with a valid row, no other flash kernel; its launches, with
   phase 3's rectangle timed on card 0 first, are the kernels line that
   ``--cards`` prints); (h) GPT-2 saved on ``tp N`` and restored on ``dp N`` and off any mesh, parameters bit-equal;
   (i) ``dryrun_multichip(N)`` with no device named. Every route but FSDP2
   and the pipeline runs captured (``compile_count`` 1, buffers donated).
   Prints each run's step ms and tokens (images) per second per GPU beside
   the one-card step's, the NCCL kernels of one profiled step (the bucket
   all-reduce, tp's all-reduces, the ring's send/receive), peak memory per
   rank and the launch counts per rank, beside every card's name and power
   limit and ``nvidia-smi topo -m``. Then its serve leg: phase 17's
   deployment with N replicas at ``num_gpus=1``, which must sit on N
   distinct cards (UUIDs, ``CUDA_VISIBLE_DEVICES`` 0..N-1);
   SERVE_CARDS_REQUESTS requests at 32 callers, each replica serving some;
   every response bit-equal to its batch recomputed on card 0 and within
   SERVE_ALONE_TOL of its request alone; requests/s. Then its Tune legs:
   (f) phase 18's (a) with N trials at ``GPU: 1``, all at once, on N
   distinct card UUIDs, with (a)'s checks; (g) ``train.torch.TorchTrainer``
   on N NCCL ranks, one card each, with ``prepare_model`` (DDP) and
   ``prepare_data_loader`` (each rank 32 / N of the 32 rows): the eager
   losses and gradient norms of TUNE_TORCH_STEPS steps against the
   one-card eager loop on the whole batch within ``parallel.multicard``'s
   dp limits, 12 launches of each kernel a step on every rank. Phases
   1-15 and 17-19 do not run under ``--cards`` (19's (e) and (h) do); the
   last line keeps its
   form. With ``--plant-fault
   ring_dkv_home`` (``multicard.FAULTS``) it runs (c) with the ring
   backward's dk, dv stopped one rotation short of home and exits 0 only
   if the checks fail it.

17. Serve (``ray_tpu_torch.serve``) on the port's runtime: GPT-2 124M
   (``GPT2Config.small()``, bf16, random weights from seed 0 passed to the
   replicas by object ref) behind ``GPT2Server``, a deployment whose
   ``@serve.batch(max_batch_size=8, batch_wait_timeout_s=0.01)`` method
   runs one forward a batch under ``inference_mode``, right-padded to its
   longest request rounded up to 64; a request gets back its last valid
   position's float32 logits, its top-1 id and its batch's signature.
   Requests: SERVE_REQUESTS token sequences, lengths uniform in 64-1024
   (numpy seed 0). (a) A replica that holds no card cannot start (no CPU
   fallback); then ``serve.run`` of a ``num_gpus=1`` replica, with the
   HTTP proxy, to the first answer; the replica warms every padded length
   at batch 8 and profiles one forward's attention ops. (b) Every response
   bit-equal to its batch recomputed in this process by the same module
   and weights (the signature's requests, padded to its T), and within
   SERVE_ALONE_TOL of its request run alone, batch 1, unpadded. (c) In
   the replica: 12 ``flash_fwd`` launches a batch and no backward one,
   counted from the end of its warm-up, and the flash op, not SDPA, in
   its forward. (d) The requests through the handle at 1, 8 and 32
   callers (requests/s, tokens/s, p50 and p99 ms, mean batch), beside
   them the in-process forward of a full batch (8 x 1024) and of one
   request alone at the requests' mean length (padded to 64), each on
   the host clock as the replica runs it (tokens in, forward, logits
   out) with the card's busy time in it (torch.profiler), and
   SERVE_HTTP_REQUESTS requests over HTTP through the proxy with the
   checks of (b) (no HTTP leg, and a line saying so, where aiohttp does
   not import). (e) Two replicas at ``num_gpus=0.5`` on the one card: each
   serves some of SERVE_HALF_REQUESTS requests at 32 callers, and (b) and
   (c) hold for both. (f) ``util.chaos.ResourceKiller(kind=
   "serve_replica")`` kills one of (e)'s replicas while SERVE_CHAOS_CALLERS
   callers send requests, until the respawned replica has answered
   SERVE_CHAOS_AFTER: no request fails, and (b) and (c) hold for every
   response and for the respawned replica. ``--plant-fault
   serve_left_pad`` runs (a) and (b) with the deployment padding on the
   left, takes (b)'s readings without
   raising and prints ``{"fault": ..., "caught": ...}``: caught when every
   response differs from its batch recomputed and one is off its request
   alone by more than SERVE_FAULT_MARGIN x SERVE_ALONE_TOL. It exits 1
   when caught, 2 when missed or when the run failed before (b).
18. Tune (``ray_tpu_torch.tune``) on the port's runtime: GPT-2 124M
   (``GPT2Config.small()``, random weights from seed 0, handed to every
   trial by ``tune.with_parameters`` as host arrays) trained by
   ``gpt2_trial``: the captured step with ``adamw(lr, weight_decay=0.1,
   mu_dtype=bf16)`` on TUNE_BATCHES fixed batches of 32 x 1025 token ids
   (numpy seed 0), each step's loss (taken before the update) reported
   with the trial's launches since it started, its card and times; a
   checkpoint is the train state (``save_train_state``) and a token that
   the next step's report names. Trial directories live under one
   temporary directory, removed at the end. Each leg's references run in
   this process after its trials have exited. (a) ASHA
   (``max_t=TUNE_STEPS, grace_period=2, reduction_factor=2``) over lr
   TUNE_ONE_CARD_LRS, trials at ``{"CPU": 1, "GPU": 0.5}``, two at once,
   checkpointing at their last step: no trial errors; two trials
   overlapped on the same card UUID; each trial's losses against the same
   steps in this process (CAPTURE_LOSS_RTOL, bit-equal expected); ASHA
   stopped exactly the trials a fresh ASHAScheduler, fed the results in
   the order Tune recorded them, stops; ``compile_count`` 1 and 12
   launches of each kernel a step counted in every trial; the best lr
   printed. (b) PBT (``perturbation_interval=2``, lr mutations
   TUNE_MUTATIONS, ``quantile_fraction=0.5``, seed 0) over lr
   TUNE_PBT_LRS, both trials at ``GPU: 0.5`` and started together,
   checkpointing every 2 steps: an exploit, each from a donor of the upper
   quantile; each restart's first loss bit-equal to the donor's own loss
   from the same checkpoint (the loss precedes the update, so the new lr
   does not reach it), and the donor's checkpoint restored here giving
   that loss and, one step later at the new lr, the trial's weights
   (per-parameter sums within CAPTURE_LOSS_RTOL: the restored AdamW
   moments at work); the launches as in (a). (c) ``Tuner(TorchTrainer(
   gpt2_trainer_loop, ScalingConfig(num_workers=1, gpus_per_worker=1)),
   param_space={"train_loop_config": {"lr": 3e-4}})``, one trial: its
   losses against (a)'s trial at 3e-4, or the same steps in this process
   where ASHA stopped that trial early (bit-equal expected), NCCL, the
   launches; ``Tuner.fit()`` to the trainer's first step beside phase
   14's ``fit()`` to its first report. (d) ``train.torch.TorchTrainer(
   torch_trainer_loop, torch_config=TorchConfig())``: backend NCCL,
   ``get_device()`` the card the scheduler gave; a plain eager loop of
   TUNE_TORCH_STEPS steps through ``prepare_model`` against
   ``disable_capture()`` here (CAPTURE_LOSS_RTOL); ``TorchCheckpoint
   .from_model`` round trips on the card bit-equal. (e) At
   ``dropout=0.1``: ``gpt2_loss`` bit-equal to ``dropout=0``; a
   ``deterministic=False`` forward with a CUDA ``torch.Generator`` keeps
   0.9 of the activations at every site within 4 sigma, each kept value
   x/0.9 exactly; two draws differ; the same seed gives the same output.
   Prints each leg's time and each trial's start to first report.
   ``--plant-fault pbt_own_restore`` runs (b) with every exploited trial
   restoring its own latest checkpoint instead of its donor's, reads (b)'s
   checks without raising and prints ``{"fault": ..., "caught": ...}``:
   caught when an exploit happened and a restart's first report is not
   its donor's. It exits 1 when caught, 2 when missed or when the run
   failed before (b)'s checks.
19. RLlib (``ray_tpu_torch.rllib``) on the port's runtime: PPO's learner
   on ``cuda:0`` in this process (full float32: TF32 off inside the
   learner's calls), its env runners actors on the CPU. CartPole is
   gymnasium's ``CartPole-v1`` where gymnasium imports, else a numpy copy
   of its dynamics registered as ``chip_cartpole`` (printed). (a) PPO on
   CartPole with the JAX test's settings (2 runners, ``train_batch_size
   =1024``, ``lr=3e-3``, minibatch 128 x 6 epochs, RLLIB_ITERS
   iterations): the best ``episode_reward_mean`` past the first by 30;
   the learner's parameters on ``cuda:0``; every runner process sees
   ``CUDA_VISIBLE_DEVICES=""``, keeps its model on the CPU and runs one
   torch thread (read on the actor by ``__ray_call__``); one capture of
   the minibatch update, and Adam's count equal to every update made.
   (b) A learner on the card against the same learner with
   ``device="cpu"`` here, from (a)'s initial weights, on (a)'s first
   episodes: one update on the first minibatch (the gradients within
   LEARNER_GRAD_RTOL, L2; the updates within LEARNER_UPDATE_RTOL of the
   update's size, L2 over the model), then one ``update_from_episodes``
   (the parameters within LEARNER_UPDATE_RTOL of the update, the metrics
   within LEARNER_METRIC_RTOL). (c) PPO on ``chip_frames`` (ChipFrames: [84, 84,
   4] uint8 frames from numpy seed 0, 6 actions, 1000-step episodes) with
   the catalog's CNN at the Nature-DQN filters and ``hidden=(512,)``
   (about 4.0 M parameters), 2 runners, batch FRAMES_BATCH, minibatch
   FRAMES_MINIBATCH x FRAMES_EPOCHS epochs, FRAMES_ITERS iterations: the
   losses finite, one capture, (b)'s one-update comparison on the first
   iteration's batch (the CNN's updates on raw frames amplify float32
   rounding itself, so the card-vs-CPU distance after the iteration's
   first epoch, 4 updates, is printed beside the CPU's
   float32-vs-float64 distance over the same updates, not checked);
   prints sample and learn seconds an iteration, env steps/s, updates/s,
   one runner's sample of SPLIT_STEPS timed inside its actor and through
   the object store, the card's busy share of one profiled learn phase
   and the peak memory. (d) The recurrent learner (GRU RECURRENT_HIDDEN) on
   RECURRENT_EPISODES episodes of the JAX test's memory task: (b)'s
   comparison and the captured shapes. (e) ``LearnerGroup`` of two
   learners at ``GPU: 0.5`` on (c)'s model and a fixed GROUP_ROWS-row batch
   (numpy seed 0), 3 updates: equal ``weights_digests``, one card UUID,
   the first update against an in-process update on the card with the mean
   of the two shards' gradients (LEARNER_UPDATE_RTOL); prints the ring
   all-reduce's time and bytes an update. (f) (a)'s algorithm, still
   running, through ``save_to_path`` and ``PPO.from_checkpoint`` into an
   algorithm without runners: bit-equal, the same greedy action on 16
   observations; ``Tuner(PPO.as_trainable(builder,
   num_iterations=2))`` over lr RLLIB_TUNE_LRS at ``{"CPU": 1, "GPU":
   0.5}``: both trials at ``training_iteration`` 2, each trial's process
   on this card. Prints each leg's time. ``--plant-fault
   learner_no_allreduce`` runs (e) with learners that apply their own
   shard's gradients, reads (e)'s checks without raising and prints
   ``{"fault": ..., "caught": ...}``: exit 1 when the digests or the
   mean-gradient comparison fail it, 2 when missed or when the run failed
   before (e). Under ``--cards N``, after phase 16's Tune legs: (e) again
   (a runtime of one card) and (h) ``LearnerGroup`` of N learners at
   ``GPU: 1``: N distinct card UUIDs, equal digests after 3 updates, the
   first update against the in-process mean-gradient update on card 0;
   the ring all-reduce's time beside (e)'s.
   (g) RLlib's other eight algorithms, in the phase's runtime. First each
   learner (IMPALA, APPO, DQN, SAC, CQL, BC, MARWIL, Dreamer; MLPs 64 x
   64, ``DreamerModelConfig()``, each at its defaults) on the card
   against the same learner on the CPU,
   seed 0 (the same initial weights: the catalog draws them on the CPU),
   on the same batch and the same noise, drawn on the CPU: one update (the
   gradients every optimizer is given within LEARNER_GRAD_RTOL, L2; the
   update within LEARNER_UPDATE_RTOL of its size) and, for the MLP
   learners, a whole iteration's updates from the start again (within
   LEARNER_UPDATE_RTOL; the last metrics within LEARNER_METRIC_RTOL). The
   batches: random-policy episodes of ChipChain (IMPALA, APPO, DQN's
   replay), ChipPoint1D (SAC's replay), ``chip_cartpole`` (Dreamer's
   sequence replay), and offline data from numpy seed 0 (BC, MARWIL,
   CQL). Then each algorithm's ``train()`` with its learner on the card:
   DQN, IMPALA and APPO on ChipChain, SAC on ChipPoint1D (the JAX test's
   ``learning_starts=256``, 16 gradient steps), Dreamer on
   ``chip_cartpole``, one runner each, ALGO_ITERS iterations each, the
   five built at once so that their runners start together; BC, MARWIL
   and CQL on their
   offline data, OFFLINE_ITERS iterations. Checks: the learner on
   ``cuda:0``, updates made, the losses finite, the update captured.
   Prints each algorithm's env steps/s, updates/s, ``compile_count`` and
   time. ``--plant-fault sac_stale_critic`` runs (g)'s SAC comparison
   with a card learner whose actor steps before its critic (the actor
   reading the critic as it was before the critic's update) and prints
   ``{"fault": ..., "caught": ...}``: exit 1 when the comparison fails
   it, 2 when missed or when the run failed before it.
20. Nodes (``cluster_utils.Cluster`` of node daemons, the head in this
   process without a card). (a) One daemon on this card (``gpu_ids``):
   its ``GPU`` row and card id as registered, no libtorch or libcuda in
   its maps. (b) A ``num_gpus=1`` actor placed on it by label runs
   phase 14 (c)'s ``gpt2_steps`` on phase 14 (c)'s weights, through the
   object store: losses bit-equal to phase 14 (c)'s or within
   CAPTURE_LOSS_RTOL, one capture, 12 launches of each square kernel a
   step (the ``kernels`` line's ``"path": "node daemon actor"``
   entries), its ``CUDA_VISIBLE_DEVICES`` the daemon's card, libcuda in
   its maps. (c) The actor's ``wte`` (50304 x 768 float32) pulled from
   the daemon's store, sha256 equal, MB/s printed. (d) ``TorchTrainer``
   (one worker, one GPU, ``max_failures=0``, a checkpoint a report) on
   the daemon's node; SIGTERM to the daemon after the second report (a
   drain) and a replacement daemon on the card: one drain restart, no
   failure spent, the resumed losses bit-equal to phase 14 (d)'s or
   within CAPTURE_LOSS_RTOL; drain-to-resume seconds printed. Then no
   daemon or worker of the phase may outlive its cluster. Under
   ``--cards N``, after phase 19's legs: (e) N daemons, daemon i on card
   i, and ``train.torch``'s DDP ``TorchTrainer`` with N workers
   (``STRICT_SPREAD``, one a node): each rank on its daemon's card (card
   UUIDs), losses within phase 18 (g)'s one-node DDP leg's limits;
   daemon N - 1 SIGKILLed after step 2 and replaced on its card, the
   gang resumed from its checkpoint (``max_failures=1``); no daemon or
   worker left. ``--cards N --plant-fault node_cards_from_head`` takes
   every daemon node's cards from this process's environment (all card
   0): the head refuses the second node, and (e) must fail.
21. DAGs, compiled DAGs and workflows, in one runtime
   (``ray_tpu_torch.dag``, ``experimental.channel``, ``workflow``). (a)
   GPT-2 124M (phase 14 (c)'s weights) as a compiled DAG of two
   ``GPT2Stage`` actors at ``num_gpus=0.5`` on this card, ``with
   InputNode() as x: s1.fwd.bind(s0.fwd.bind(x))``: stage 0 holds the
   embeddings and blocks 0-5, stage 1 blocks 6-11, ``ln_f`` and the head;
   the edge carries the bf16 residual stream (8 x 1024 x 768, 12 MiB,
   inside the 16-MiB channel), stage 1 returns each sequence's summed
   next-token log-probability and the last position's float32 logits
   (``head_reduction``). DAG_EXECUTES batches of 8 x 1024 token ids (numpy
   seed 0), the first alone, the rest with up to DAG_IN_FLIGHT executes
   issued before a ``get``. Checks: channel mode; each output within
   DAG_RTOL of the whole model's forward in this process (same weights,
   tokens and kernels: bit-equal expected); each stage launches
   ``flash_fwd`` once a block an execute and no backward kernel (counted
   in the actors); stage 1 receives a CPU bf16 tensor with the bits stage
   0 sent (sha256, first execute); both stages on this card; a CUDA
   tensor through a channel here arrives a CPU tensor, bit-equal; no
   actor outlives ``teardown()``. Prints executes/s, ms an execute, the
   whole forward in this process, the edge's host copy (write, read) and
   the compile time with the actors' start. (b) A durable workflow
   ``train_span.bind(train_span.bind(None, 2), 2)``, each step a
   ``num_gpus=1`` task that restores the previous step's saved train
   state (or starts from phase 14 (c)'s weights), runs WORKFLOW_SPAN
   captured steps at 32 x 1024 (``gpt2_steps``) and saves the state,
   returning its path and losses; the second step fails on its first run
   (a marker file under the workflow's root), the run ends FAILED, then
   ``workflow.resume``. Checks: step 1 ran once and step 2 twice (files
   the steps write); the 4 losses within CAPTURE_LOSS_RTOL of phase 14
   (c)'s 4 steps in this process; step 2's first loss bit-equal to step
   1's loss after its save; 12 launches of each square kernel a train
   step and ``compile_count`` 1 in each step; no task worker outlives
   the runtime. Prints each step's start to its first loss, the save and
   restore times and the leg's time. ``--plant-fault
   dag_stage_skips_block`` runs (a) with stage 1 starting at block 7,
   ``--plant-fault workflow_reruns_done_step`` runs (b) with a resume that
   reads no stored step; each reads its checks without raising and prints
   ``{"fault": ..., "caught": ...}``: exit 1 caught, 2 missed or failed
   before the checks. Under ``--cards N``, after phase 20 (e): (c) a
   card-less head and N node daemons, daemon i on card i, and GPT-2 124M
   as an N-stage compiled DAG, stage i on daemon i (3 blocks each for N =
   4), every edge a ``CommChannel`` over ``DcnTcpCommunicator``:
   DAG_CARDS_EXECUTES executes against the whole model in this process
   (DAG_RTOL), each stage on its daemon's card UUID, executes/s printed;
   no daemon or worker left.
22. Dashboard, job submission and autoscaler (``ray_tpu_torch.dashboard``,
   ``job_submission``, ``autoscaler``). (a) ``init(include_dashboard=True,
   dashboard_port=0)`` with the card visible; ``POST /api/jobs`` an
   entrypoint ``python <script>`` (the script written under the run's
   temporary directory, this checkout on its ``PYTHONPATH`` through the
   job's ``runtime_env``) that joins the session (``init(address=
   "auto")``), prints its ``CUDA_VISIBLE_DEVICES`` and runs one
   ``num_gpus=1`` task (``job_train``) of WORKFLOW_SPAN captured GPT-2
   124M steps at 32 x 1024 from phase 14 (c)'s weights; ``GET
   /api/jobs/<id>`` until it ends, its line from ``GET
   /api/jobs/<id>/logs``. Checks: SUCCEEDED, return code 0; the losses
   within CAPTURE_LOSS_RTOL of phase 14 (c)'s first steps (bit-equal
   expected); 12 launches of each square kernel a step, ``compile_count``
   1; the entrypoint saw ``CUDA_VISIBLE_DEVICES=""`` (its supervisor holds
   no GPU) and the task ran on this card's UUID; ``/api/cluster`` and
   ``/api/nodes`` report GPU 1, ``/api/agents``, ``/simple`` and the page
   carry the ``gpus`` column with 1; ``/metrics`` the system gauges; a job
   that exits 3 ends FAILED, a sleeping one stopped over REST ends
   STOPPED and leaves no process (its entrypoint's child of the shell
   too); no worker left after ``shutdown()``. Prints submit to
   SUCCEEDED and the entrypoint's start to its first loss. (b) A
   card-less head (``Cluster``), an ``Autoscaler`` over
   ``FakeMultiNodeProvider`` with node type ``h100 = {"CPU": 2, "GPU":
   1}`` (0 to 1 workers, idle timeout AUTOSCALE_IDLE_S) and one pending
   ``num_gpus=1`` task (``autoscaled_forward``): GPT-2 124M's forward of
   phase 17's full batch (8 x 1024). Checks: one node launched, holding
   this card (its daemon started with ``--num-gpus 1`` and
   ``CUDA_VISIBLE_DEVICES`` naming it, the head's card ids, the task on
   this card's UUID); the forward bit-equal to this process's; 12
   ``flash_fwd`` launches and no backward kernel; ``request_resources(
   bundles=[{"GPU": 1}])`` keeps the idle node past twice the timeout,
   ``request_resources(bundles=[])`` lets it go; the node terminated,
   ``non_terminated_nodes()`` empty; no daemon or worker left. Prints
   demand to node registered to result, and the cleared floor to the
   node terminated. ``--plant-fault fake_node_gpu_as_resource`` runs (b)
   with the JAX package's pass-through of ``GPU`` as a bare resource
   (the node's daemon given no card): exit 1 caught, 2 missed. Under
   ``--cards N``, after phase 21 (c): (c) node type ``h100x4 = {"CPU": 4,
   "GPU": N}`` (0 to 1) and a ``STRICT_PACK`` group of N ``{"GPU": 1}``
   bundles: one N-card node launched whole, the N bundles' forwards at
   once on N distinct card UUIDs of it, each bit-equal to this process's,
   12 ``flash_fwd`` each; the node scaled down, nothing left.

Every train phase trains through the captured step (one CUDA graph,
replayed; ``train.step``) and checks that it was captured once
(``compile_count`` 1 after warm-up and after the timed dispatches) and
updated the state in place (``buffers_donated``); its profiled dispatch
cross-checks the launch counters against the flash kernels the profiler
sees in the replay. GPT-2 and ResNet-50 also hold their first
CAPTURE_STEPS losses against the same step under ``disable_capture()``
from the same weights (CAPTURE_LOSS_RTOL).

Then it prints the ``kernels`` JSON line (the ViT run's non-causal
readings as entries with ``"causal": false``; the non-causal rectangle
with phase 12 (c')'s launches on ``sp 4``, its ``"path"`` saying so;
``--cards`` prints its own line of the rectangle with (g)'s launches;
``flash_fwd`` at phase 17's
full batch, 8 x 1024, with the replica's launches, as the entry with
``"path": "serve"``, and with phase 21 (a)'s stages' launches as the
entry with ``"path": "compiled dag stage"``; the square kernels with
phase 20 (b)'s launches, ``"path": "node daemon actor"``, and with phase
21 (b)'s, ``"path": "workflow step"``; the square kernels with phase 22
(a)'s launches, ``"path": "job task"``, and ``flash_fwd`` at phase 17's
full batch with (b)'s, ``"path": "autoscaled node"``), the card line
again, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero when no
GPU is visible, and when the package is not beside it.

``--plant-fault NAME`` shows what the checks read on a wrong kernel: it
builds a copy of kernel NAME's source (under the gitignored build
directory, never in the source tree) carrying the fault of FAULTS, binds
the wrapper to it, and prints what each check reads. Square kernels:
``flash_fwd`` and ``flash_bwd_dq`` mask every score of key tile 3 for
the last query tile (a dropped late key tile), ``flash_bwd_dkv`` masks
the last query tile for every key block but the diagonal one; the run
exits 0 only if the kernel check fails it at both shapes and the
per-layer check on some layer. Band kernels: the diagonal is misaligned
(row0 forced to 0, top left instead of bottom right); the run exits 0
only if the band check fails it on every band with tq < tk and the split
phase's per-layer check on some layer at both splits. Both print
whether the gradient check fails the fault too.

Each kernel line prints the kernel's time over SDPA's from the same run
(``kernel / library``), and each shape the host time of one wrapper
call (checks, tensor-map geometry and encoding, allocation, launch).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import hashlib
import json
import math
import os
import queue
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import types
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ray_tpu_torch.core.accelerator import default_device, node_gpu_ids
from ray_tpu_torch.models import (
    GPT2,
    GPT2Config,
    Llama,
    LlamaConfig,
    MoEBlock,
    MoEConfig,
    MoETransformer,
    ResNet,
    ResNet50Config,
    ViT,
    ViTConfig,
    llama_loss_fn,
    moe_loss_fn,
    resnet_loss_fn,
    vit_loss_fn,
)
from ray_tpu_torch.models.gpt2 import (
    chunked_cross_entropy,
    gpt2_loss_fn,
    matmul_f32,
    vocab_embedding,
)
from ray_tpu_torch.models import vit as vit_model
from ray_tpu_torch.ops.attention import (
    RingAttentionFn,
    causal_attention,
    ulysses_attention,
)
from ray_tpu_torch.ops.cuda import build
from ray_tpu_torch.ops.cuda import flash_attention as fa
from ray_tpu_torch.ops.moe import (
    capacity_for,
    dense_switch_ffn_reference,
    moe_ffn,
    top1_route,
)
from ray_tpu_torch.parallel import initialize, make_mesh, multicard
from ray_tpu_torch.parallel.dryrun import dryrun_multichip
from ray_tpu_torch.parallel.mesh import DATA_AXES
from ray_tpu_torch.parallel.pipeline import spmd_pipeline
from ray_tpu_torch.parallel.sharding import _place_forced
import ray_tpu_torch
from ray_tpu_torch import serve, tune
from ray_tpu_torch.rllib import learner_group
from ray_tpu_torch.rllib.learner_group import LearnerGroup
from ray_tpu_torch.train import (
    adamw,
    buffers_donated,
    compile_count,
    disable_capture,
    init_train_state,
    make_multi_train_step,
    make_train_step,
    prefetch_to_device,
    sgd,
    shard_batch,
)
from ray_tpu_torch.train.checkpoint import (
    restore_train_state,
    save_train_state,
)

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core
# rate and HBM3 bandwidth, at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# lse is float32 in both versions: only summation order differs.
LSE_TOL = 1e-4
# ||g_kernels - g_plain|| / ||g_plain|| of each layer's q, k, v thirds of
# qkv_kernel and of proj_kernel at step 0. Both paths run the same bf16
# model and differ only where the kernels round o, dq, dk, dv to bf16
# differently from the plain version, but 12 bf16 layers at initial
# weights (near-uniform softmax, so ds is a small difference of near
# equal terms) grow that into ~2% on the last layers' q and k gradients
# (H100). This end-to-end check therefore only sees a fault that moves
# the gradients by more than that; the per-layer check holds each layer's
# attention tightly.
GRAD_TOL = 3.5e-2
# |step-0 loss (kernels, chunked CE) - step-0 loss (plain attention,
# full f32 logits)| on ~11 nats: the paths differ in where attention
# rounds to bf16 and in the order of the CE sums. At initial weights the
# loss barely depends on attention; this check holds the CE paths, the
# gradient check above holds attention.
STEP0_LOSS_TOL = 1e-3
# The same for ViT-B/16 (kernels against plain attention, on ~7.4 nats):
# its loss is the mean over 128 images, GPT-2's over 32,768 tokens, so
# the same per-item rounding differences leave ~16x more in the mean
# (9.2e-4 read on an H100). Attention that saw the wrong keys (a causal
# mask, say) would move the CLS token, and the loss, by far more.
VIT_STEP0_LOSS_TOL = 5e-3
# Remat against no remat, same weights and batch on the card: the
# recomputed forward repeats the same kernels and products, so the two
# agree to the last bit unless a library product picks another
# algorithm; a wrong recompute or a stale saved tensor moves them by
# orders of magnitude more.
REMAT_LOSS_TOL = 1e-5
REMAT_GRAD_TOL = 1e-3
# ||logits(bf16 model, card) - logits(float32 model, CPU)|| / ||logits||
# at step 0, train mode, same weights and images: every convolution rounds
# its output to bf16 (2^-9 relative) and BatchNorm renormalises it, so
# the paths drift apart by about a percent (1.2e-2 for ResNet-50 at 64x64
# on the CPU); a window shifted by uneven SAME padding, a wrong layout or
# statistics taken over the wrong axes move the logits by tens of percent.
RESNET_LOGIT_TOL = 5e-2
# The captured step against the same step run eagerly (disable_capture),
# from the same weights on the same batch, over its first CAPTURE_STEPS
# losses: the graph replays the kernels the eager step launches, on the
# same inputs, so only a library product that picks another algorithm
# inside a capture could move a loss, in its last places.
CAPTURE_LOSS_RTOL = 1e-6
CAPTURE_STEPS = 4
# The index-form switch FFN (scatter, gather) against the one-hot einsum
# form on one MoE layer's own tokens: each slot holds one token, so each
# einsum sums one nonzero term and only the rounding of the bf16 products
# may differ: the output within one bf16 unit of each element
# (2^-8 |y|, or 2^-133 where y is 0), the router gradient (float32 sums of
# those products) within 1e-3 relative norm.
MOE_FORM_Y_RTOL = 2.0 ** -8
# spmd_pipeline at pp = 1 against the plain block stack: the loss against
# the whole batch's (the blocks act on each row alone, so only a product
# that picks another algorithm for 8 rows could move it); the block
# gradients against the plain stack on the same microbatches, since each
# microbatch's bf16 weight gradient is rounded before the sum (2.6e-3
# relative against the whole batch's read on an H100), and against the
# whole batch's within PIPE_WHOLE_GRAD_RTOL, so that a fault shared by both
# microbatched runs still shows.
PIPE_LOSS_RTOL = 1e-5
PIPE_GRAD_RTOL = 1e-3
PIPE_WHOLE_GRAD_RTOL = 1e-2
MOE_FORM_GRAD_TOL = 1e-3
# Phase 17: a served request's last-position logits (float32, from the
# bf16 model) against the same request run alone, batch 1, unpadded:
# max |served - alone| <= SERVE_ALONE_TOL * rms(alone). The attention of a
# valid row sees the same keys either way (the causal mask hides the
# padding), but every product runs at another M (B x T rows against 1 x
# len), so cuBLAS may sum in another order and round an element to the
# other bf16 neighbour (2^-8 relative) in any of the 12 layers, which the
# residual stream carries to the LM head. That is the rounding chain the
# kernel checks hold within 2^-3 rms (flash_attention.AGREEMENT_TOL).
# A left-padded batch moves the positions and lets attention see the
# padding: its logits are another function, off by O(rms).
SERVE_ALONE_TOL = 2.0 ** -3
# ``serve_left_pad`` is caught when (b) fails it by this many limits.
SERVE_FAULT_MARGIN = 8

# The host's wait on each side of a profiled dispatch (profile_dispatch).
PROFILE_MARGIN_S = 0.1

# A spin of the card (~50 ms at the H100's clock) queued ahead of each
# timed run, long enough for the host to queue every call of the run.
HOLD_CYCLES = 100_000_000

# False under --eager: every train phase runs its step eagerly
# (disable_capture) and expects no capture.
CAPTURE = True

H, D = 12, 64
SHAPES = ((32, 1024), (8, 2048))   # (batch, seq)
TRAIN_BATCH, TRAIN_SEQ = 32, 1024
SPLITS = (2, 4)
REMAT_POLICIES = ("nothing", "dots", "dots_no_batch", "everything")
SPLIT_CHECK_LAYERS = (0, 11)
LLAMA_BATCH, LLAMA_SEQ = 8, 2048
LLAMA_CHECK_LAYERS = (0, 11, 21)
IMAGE_SIZE = 224
RESNET_BATCH = 128                 # bench.py's ResNet-50 batch per chip
RESNET_CHECK_BATCH = 8             # step-0 logits against the CPU
VIT_BATCH = 128                    # DeiT's 1024 over 8 GPUs
VIT_CHECK_LAYERS = (0, 11)
VIT_SP = (4, 8)                    # phase 12 (c')'s bidirectional rings
MOE_CHECK_LAYERS = (1, 11)         # MoE blocks sit at odd layers
MOE_FORM_TOKENS = 4096             # where the [T, E, C] one-hot fits
K_STEPS = 2                        # optimizer steps per dispatch
TIMED_DISPATCHES = 3
SHORT_TIMED_DISPATCHES = 2         # split, remat and TinyLlama phases
MESH_TIMED_STEPS = 4               # single steps timed in the mesh phase
RING_SP = 4                        # ranks of the ring whose hops run here
RING_SHAPES = ((32, 1024, 12), (8, 2048, 32))  # GPT-2 small, TinyLlama
# (B, T, q heads, kv heads, what): the attention a tp rank runs.
TP_KERNEL_SHAPES = ((32, 1024, 6, 6, "GPT-2 at tp 2 (6 heads)"),
                    (32, 1024, 3, 3, "GPT-2 at tp 4 (3 heads)"),
                    (8, 2048, 8, 1, "TinyLlama at tp 4 (8 q heads on 1 kv "
                     "head)"))
PIPE_MICROBATCHES = 4
RUNTIME_WAIT_S = 2.0               # a second GPU task stays pending so long
NODE_DRAIN_AT = 1                  # phase 20 (d): the drain after report 2
NODE_DRAIN_GRACE_S = 0.2           # (d)'s drain: grace, then its deadline
NODE_DRAIN_DEADLINE_S = 3.0
DAG_EXECUTES = 16                  # phase 21 (a): executes of the DAG
DAG_IN_FLIGHT = 2                  # ... at most this many before a get
DAG_SHARE = 0.5                    # each stage actor's share of the card
DAG_CARDS_EXECUTES = 8             # (c): executes across four daemons
# The stages against the whole model in this process: the same weights,
# tokens and kernels, so bit-equal is expected (phase 20 (b) read the
# same across processes); a block dropped or repeated moves them by
# orders of magnitude more.
DAG_RTOL = 1e-6
WORKFLOW_SPAN = 2                  # (b): train steps of each workflow step
AUTOSCALE_IDLE_S = 2.0             # phase 22 (b), (c): the idle timeout
AUTOSCALE_TTL_S = 1.0              # ... and an idle worker's reaping there
RUNTIME_TASKS = 1000               # no-op tasks of the host rate
RUNTIME_ACTOR_CALLS = 2000         # calls to one actor of the host rate
DATA_STEPS = 12                    # steps (batches) of the Data feed
DATA_FILES = 8                     # TFRecord files the rows are cut into
SERVE_REQUESTS = 256               # requests of each load leg of phase 17
SERVE_CALLERS = (1, 8, 32)         # concurrent callers of the load legs
SERVE_LENGTHS = (64, 1024)         # request lengths, uniform (numpy seed 0)
SERVE_BATCH = 8                    # @serve.batch(max_batch_size=)
SERVE_WAIT_S = 0.01                # @serve.batch(batch_wait_timeout_s=)
PAD_MULTIPLE = 64                  # a batch's T: its longest, rounded up
SERVE_HTTP_REQUESTS = 32           # requests of the HTTP leg
SERVE_HALF_REQUESTS = 64           # requests to the two half-card replicas
SERVE_CARDS_REQUESTS = 128         # requests to the four-card replicas
SERVE_CHAOS_CALLERS = 8            # (f)'s callers while a replica is killed
SERVE_CHAOS_AFTER = 16             # requests the respawned replica answers
TUNE_STEPS = 8                     # steps of each trial (ASHA's max_t)
TUNE_BATCHES = 4                   # fixed batches a trial cycles through
TUNE_LRS = (1e-4, 3e-4, 1e-3, 3e-3)   # (f)'s grid, four cards
TUNE_ONE_CARD_LRS = (1e-4, 3e-4)   # (a)'s grid: one wave of two trials
TUNE_PBT_LRS = (1e-5, 1e-3)        # (b)'s population
TUNE_MUTATIONS = [1e-5, 1e-4, 1e-3]   # PBT's lr choices
TUNE_PBT_INTERVAL = 2              # PBT's perturbation interval, and (b)'s
#                                    checkpoint interval
TUNE_SHARE = 0.5                   # each trial's share of the card
TUNE_TRAINER_LR = 3e-4             # (c)'s trial, one of (a)'s grid
TUNE_TORCH_STEPS = 4               # (d)'s and (g)'s eager steps
DROPOUT_RATE = 0.1                 # (e)
DROPOUT_BATCH = 8                  # (e)'s forward batch (x TRAIN_SEQ)
# Faults of phase 18's trials (user code, not a kernel).
TUNE_FAULTS = {"pbt_own_restore": "a PBT-exploited trial restores its own "
               "latest checkpoint, not its donor's"}
RLLIB_ITERS = 12                   # (a)'s iterations, as the JAX test's
NATURE_FILTERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))   # Nature-DQN's convs
FRAME_SHAPE = (84, 84, 4)          # Atari's stacked frames
FRAME_POOL = 64                    # distinct frames of chip_frames
RLLIB_ACTIONS = 6                  # chip_frames' actions
FRAMES_EPISODE = 1000              # chip_frames' episode length
FRAMES_BATCH = 1024                # (c)'s train_batch_size
FRAMES_MINIBATCH = 256
FRAMES_EPOCHS = 4                  # 16 captured updates an iteration
FRAMES_ITERS = 1
SPLIT_STEPS = 256                  # (c)'s runner sample timed alone
RECURRENT_HIDDEN = 64              # (d)'s GRU width
RECURRENT_EPISODES = 40            # (d)'s episodes, as the JAX test's
GROUP_ROWS = 512                   # (e)'s fixed batch
RLLIB_TUNE_LRS = (3e-4, 3e-3)      # (f)'s grid
RLLIB_TUNE_SHARE = 0.5             # (f)'s trials' share of the card
ALGO_ITERS = 4                     # (g)'s train() iterations, runner-backed
OFFLINE_ITERS = 2                  # (g)'s train() iterations, offline
OFFLINE_ROWS = 4096                # (g)'s offline datasets (numpy seed 0)
# (b): the card's update against the CPU's from the same weights, TF32 off
# in the learner: float32 sums in another order, which Adam turns into a
# full step on entries whose gradient is near zero. Over the whole model
# (L2, relative to the update's own size) that weighs little; TF32's
# rounding of every product's inputs to 10 mantissa bits (~5e-4
# relative) would not. It holds one update, and a whole
# update_from_episodes of (a)'s MLP and (d)'s GRU; the CNN's updates on
# raw frames amplify float32 rounding itself (the CPU's float32 lands as
# far from its float64), so (c) holds one update and prints its first
# epoch beside that float64 distance.
LEARNER_UPDATE_RTOL = 1e-3
LEARNER_METRIC_RTOL = 1e-3
# The first minibatch's gradient, card against CPU (L2 relative): float32
# sums in another order differ by about 1e-6; TF32's 10-bit inputs by
# about 5e-4 in every product.
LEARNER_GRAD_RTOL = 1e-5
# Faults of phase 19's learner group (user code, not a kernel).
RLLIB_FAULTS = {"learner_no_allreduce": "the group's learners apply their "
                "own shard's gradients, skipping the all-reduce",
                "sac_stale_critic": "the card's SAC learner steps its actor "
                "before its critic, so the actor reads the critic as it was "
                "before the critic's update"}
ROOT = os.path.dirname(os.path.abspath(__file__))

SQUARE = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
BAND = ("flash_fwd_rect", "flash_bwd_dq_rect", "flash_bwd_dkv_rect")
NC_RECT = ("flash_fwd_nc_rect", "flash_bwd_dq_nc_rect",
           "flash_bwd_dkv_nc_rect")
WRAPPERS = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv,
            "flash_fwd_rect": fa.flash_fwd_rect,
            "flash_bwd_dq_rect": fa.flash_bwd_dq_rect,
            "flash_bwd_dkv_rect": fa.flash_bwd_dkv_rect,
            "flash_fwd_nc_rect": fa.flash_fwd_nc_rect,
            "flash_bwd_dq_nc_rect": fa.flash_bwd_dq_nc_rect,
            "flash_bwd_dkv_nc_rect": fa.flash_bwd_dkv_nc_rect}
_CSRC = "ray_tpu_torch/ops/cuda/csrc"
SOURCES = {name: f"{_CSRC}/{fa._KERNELS[name].source}.cu"
           for name in SQUARE + BAND + NC_RECT}
# The TPU kernel each replaces on the training path (T=1024 runs the
# single-block Pallas kernels; T=2048, TinyLlama's, the streaming ones,
# :77/:218/:255; the split runs the band kernels).
_PALLAS = "ray_tpu/ops/pallas/flash_attention.py"
REPLACES = {
    "flash_fwd": f"{_PALLAS}:122",
    "flash_bwd_dq": f"{_PALLAS}:296",
    "flash_bwd_dkv": f"{_PALLAS}:296",
    "flash_fwd_rect": f"{_PALLAS}:418",
    "flash_bwd_dq_rect": f"{_PALLAS}:436",
    "flash_bwd_dkv_rect": f"{_PALLAS}:436",
    # The non-causal rectangle is the causal=False branch of the streamed
    # kernels (diag_ok = (not causal) or ...), on a hop of the
    # bidirectional ring; the JAX ViT itself calls
    # jax.nn.dot_product_attention.
    "flash_fwd_nc_rect": f"{_PALLAS}:89",
    "flash_bwd_dq_nc_rect": f"{_PALLAS}:227",
    "flash_bwd_dkv_nc_rect": f"{_PALLAS}:266",
}
# --plant-fault: (text of the source, the same text with the fault). The
# forward and dq drop key tile 3 of the last query tile (every score
# masked); dk/dv drops the last query tile for every key block but the
# diagonal one (every p masked); the band faults misalign the diagonal
# (row0 = 0, top left instead of bottom right). Each keeps the kernel's
# barrier protocol intact (every tile is still loaded and consumed), so a
# fault changes values and never hangs the card.
_FWD_MASK = ("    bool masked = min(a.tk, a.causal ? a.row0 + wrow0 + 1 : a.tk) - k0"
             " < kFwdBK;\n")
_DQ_MASK = ("      bool masked = min(a.tk, a.causal ? a.row0 + wrow0 + 1 : a.tk) - k0"
            " < kBK;\n")
_DKV_QEND = "    int q_end = a.tq;\n"
_ARGS_ROW0 = "  args.row0 = row0;"
# Faults of phase 17's deployment (user code, not a kernel).
NODE_FAULTS = {"node_cards_from_head": "a daemon node's cards are read from "
               "the head process's environment, not the daemon's report"}
SERVE_FAULTS = {"serve_left_pad": "GPT2Server pads each batch on the left"}
# Faults of phase 21's user code (the stages, the resume).
DAG_FAULTS = {"dag_stage_skips_block": "the compiled DAG's second stage "
              "starts one block late (block 7)",
              "workflow_reruns_done_step": "workflow.resume ignores the "
              "stored result of the first step"}
# A fault of phase 22 (b)'s fake provider: the JAX package's pass-through
# of a node type's resources, GPU a bare row of a node given no card.
JOB_FAULTS = {"fake_node_gpu_as_resource": "the fake provider passes a node "
              "type's GPU to Cluster.add_node as a bare resource, so the "
              "node's daemon is given no card"}
# A fault of ViT's bidirectional ring: every row of a padded block taken
# as a valid key (models.vit.seq_blocks planted), so the hops read the
# padding; phase 12 (c') must fail it.
VIT_FAULTS = {"vit_padded_keys": "the bidirectional ring's hops read the "
              "padded rows of the last block as keys"}
FAULTS = {
    "flash_fwd": (_FWD_MASK, _FWD_MASK + "    if (j == 3 && q0 + kFwdBQ >= a.tq)"
                  " masked = true, lim[0] = lim[1] = 0;\n"),
    "flash_bwd_dq": (_DQ_MASK, _DQ_MASK + "      if (j == 3 && q0 + kDqBQ >= a.tq)"
                     " masked = true, lim[0] = lim[1] = 0;\n"),
    "flash_bwd_dkv": (_DKV_QEND, _DKV_QEND
                      + "    if (iq == n_qt - 1 && iq != first) q_end = 0;\n"),
    "flash_fwd_rect": (_ARGS_ROW0, "  args.row0 = 0;"),
    "flash_bwd_dq_rect": (_ARGS_ROW0, "  args.row0 = 0;"),
    "flash_bwd_dkv_rect": (_ARGS_ROW0, "  args.row0 = 0;"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_usage(log: str) -> str:
    """'bf16 D=64: 96 registers, 0 B spilled; ...' from ptxas -v output,
    with ptxas' numbered notes after it (wgmma serialization, setmaxnreg)."""
    out = []
    for fn, body in re.findall(r"Compiling entry function '(\S+)'(.*?)"
                               r"(?=Compiling entry function|\Z)", log, re.S):
        dtype = "fp16" if "__half" in fn else "bf16"
        d = re.search(r"Li(\d+)E", fn).group(1)
        regs = re.search(r"Used (\d+) registers", body).group(1)
        spill = re.search(r"(\d+) bytes spill stores", body).group(1)
        out.append(f"{dtype} D={d}: {regs} registers, {spill} B spilled")
    notes = sorted({re.sub(r"(around line \d+ )|( in the function)?( in "
                             r"function)? '\S+'", "", w).strip()
                    for w in re.findall(r"ptxas \w+\s*: (\(C\d+\) .*)", log)})
    return "; ".join(sorted(out)) + "".join(f"; ptxas {w}" for w in notes)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. The
    calls queue behind a hold of HOLD_CYCLES, so the card runs them back
    to back and the events read device time, not the rate at which the
    host issues calls (which bounds the small bands)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 50) -> float:
    """Mean host time (us) of issuing ``fn`` ``iters`` times back to back:
    the wrapper's checks, tensor-map geometry and encoding, allocation and
    launch. The device runs behind and is waited for after the clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


@contextlib.contextmanager
def flash_split(n: int):
    """``RAY_TPU_FLASH_SPLIT=n`` (unset for 0) inside the block, restored
    after."""
    old = os.environ.get("RAY_TPU_FLASH_SPLIT")
    if n:
        os.environ["RAY_TPU_FLASH_SPLIT"] = str(n)
    else:
        os.environ.pop("RAY_TPU_FLASH_SPLIT", None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("RAY_TPU_FLASH_SPLIT", None)
        else:
            os.environ["RAY_TPU_FLASH_SPLIT"] = old


def work(bh: int, tq: int, tk: int, causal: bool = True
         ) -> dict[str, tuple[float, float]]:
    """{kernel: (tensor-core FLOPs, bytes)} of each kernel on q [BH, tq,
    D] against k, v [BH, tk, D] with the causal diagonal bottom-right
    aligned: each input read once, each output written once, and the
    tq * (tk - tq) + tq (tq + 1) / 2 causal pairs this input needs (all
    tq * tk pairs when not ``causal``). ``flash_bwd`` is the backward as
    one function (what the TPU's fused kernels compute): 5 products, where
    the dq and dkv kernels together do 7."""
    pairs = tq * (tk - tq) + tq * (tq + 1) / 2 if causal else tq * tk
    mm = 2.0 * bh * pairs * D                    # one causal product
    row = bh * D * 2                             # one bf16 row of BH heads
    stats = bh * tq * 4                          # one f32 [BH, tq]
    return {
        "flash_fwd": (2 * mm, row * (2 * tq + 2 * tk) + stats),
        "flash_bwd_dq": (3 * mm, row * (3 * tq + 2 * tk) + 2 * stats),
        "flash_bwd_dkv": (4 * mm, row * (2 * tq + 4 * tk) + 2 * stats),
        "flash_bwd": (5 * mm, row * (3 * tq + 4 * tk) + 2 * stats),
    }


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) for this work and what bounds it: the larger of its
    FLOPs over the bf16 peak and its bytes over the memory rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bounds(bh: int, tq: int, tk: int, causal: bool = True
           ) -> dict[str, tuple[float, str]]:
    return {name: bound(*w) for name, w in work(bh, tq, tk, causal).items()}


def kernel_inputs(b: int, t: int, dev):
    gen = torch.Generator(device=dev).manual_seed(t)
    q, k, v, do = (torch.randn(b * H, t, D, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    return q, k, v, do


def kernel_readings(q, k, v, do, band: bool = False,
                    causal: bool = True) -> dict[str, dict]:
    """Each kernel's outputs held against its plain version's on the same
    inputs: {kernel: {output: fa.agreement(...)}}, lse beside. The square
    kernels on ``[BH, T, D]`` inputs (``causal`` or not), or (``band``)
    the band kernels on q, do ``[BH, tq, D]`` and k, v ``[BH, tk, D]``
    (``causal``; not: the non-causal rectangle, tk <= tq)."""
    fwd, dq_k, dkv_k = ((BAND if causal else NC_RECT) if band
                        else SQUARE)
    route = () if band else (causal,)
    scale = D ** -0.5
    o, lse = WRAPPERS[fwd](q, k, v, scale, *route)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, causal)
    # The backward kernels take the plain lse and delta, so each is held
    # against its own plain version alone.
    delta = (o_ref.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse_ref, delta, scale)
    dq = WRAPPERS[dq_k](*bwd, *route)
    dq_ref = fa.flash_bwd_dq_reference(*bwd, causal)
    dk, dv = WRAPPERS[dkv_k](*bwd, *route)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*bwd, causal)
    torch.cuda.synchronize()
    out = {fwd: {"o": fa.agreement(o, o_ref)},
           dq_k: {"dq": fa.agreement(dq, dq_ref)},
           dkv_k: {"dk": fa.agreement(dk, dk_ref),
                   "dv": fa.agreement(dv, dv_ref)}}
    lse_err = float((lse - lse_ref).abs().max())
    out[fwd]["lse"] = {"max_abs_err": lse_err, "ok": lse_err < LSE_TOL}
    return out


def bands(q, k, v, do, n: int):
    """The n bands of the causal split of folded ``[BH, T, D]`` tensors,
    as views: (tq, tk, (q band, k prefix, v prefix, do band))."""
    s = q.shape[1] // n
    for r in range(n):
        lo, hi = r * s, (r + 1) * s
        yield s, hi, (q[:, lo:hi], k[:, :hi], v[:, :hi], do[:, lo:hi])


def worst(readings: list[dict[str, dict]]) -> dict[str, dict]:
    """The worst reading of each kernel output over several readings."""
    out: dict[str, dict] = {}
    for reading in readings:
        for name, outs in reading.items():
            for o_name, r in outs.items():
                cur = out.setdefault(name, {}).get(o_name)
                key = (not r["ok"], r.get("elem", 0.0), r["max_abs_err"])
                if cur is None or key > (not cur["ok"], cur.get("elem", 0.0),
                                         cur["max_abs_err"]):
                    out[name][o_name] = r
    return out


def describe(readings: dict[str, dict]) -> str:
    return "; ".join(
        f"{o_name} " + ", ".join(f"{key} {val:.4g}" for key, val in r.items()
                                 if key != "ok")
        + ("" if r["ok"] else " FAILS")
        for outs in readings.values() for o_name, r in outs.items())


def check_readings(readings: dict[str, dict], where: str) -> None:
    tol = fa.AGREEMENT_TOL[torch.bfloat16]
    for name, outs in readings.items():
        for o_name, r in outs.items():
            check(r["ok"], f"{name} {o_name} agrees with its plain version "
                  f"{where} (limits {tol}, lse {LSE_TOL}; got {r})")


def kernel_phase(b: int, t: int, dev) -> dict[str, dict]:
    q, k, v, do = kernel_inputs(b, t, dev)
    readings = kernel_readings(q, k, v, do)
    print(f"agreement B={b} T={t}: {describe(readings)}", flush=True)
    check_readings(readings, f"at B={b} T={t}")
    return kernel_times(b, q, k, v, do, readings, f"B={b} T={t} H={H}")


def kernel_times(b: int, q, k, v, do, readings, what: str,
                 causal: bool = True) -> dict[str, dict]:
    """The square kernels on ``[B*heads, T, D]`` inputs timed (CUDA events)
    beside their bounds, their plain versions and SDPA on the same inputs
    (forward, and its whole backward for the backward kernels), causal or
    not."""
    bh, t, _ = q.shape
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    delta = (o.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale, causal)

    # The yardstick: one library call computing the same function.
    q4, k4, v4, do4 = (x.view(b, bh // b, t, D) for x in (q, k, v, do))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal), 20)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), do4, retain_graph=True), 20)

    times = {
        "flash_fwd": (
            cuda_ms(lambda: fa.flash_fwd(q, k, v, scale, causal), 20),
            cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, scale, causal),
                    3, 1),
            lib_fwd),
        "flash_bwd_dq": (
            cuda_ms(lambda: fa.flash_bwd_dq(*bwd), 20),
            cuda_ms(lambda: fa.flash_bwd_dq_reference(*bwd), 3, 1),
            lib_bwd),
        "flash_bwd_dkv": (
            cuda_ms(lambda: fa.flash_bwd_dkv(*bwd), 20),
            cuda_ms(lambda: fa.flash_bwd_dkv_reference(*bwd), 3, 1),
            lib_bwd),
    }
    bnd = bounds(bh, t, t, causal)
    rows = {}
    for name, (ms, p_ms, l_ms) in times.items():
        err = max(r["max_abs_err"] for o_name, r in readings[name].items()
                  if o_name != "lse")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": p_ms,
                      "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
                      "library_ms": l_ms}
        print(f"kernel {name} {what} D={D} bf16 "
              f"{'causal' if causal else 'non-causal'}: "
              f"max abs err {err:.3g}, {ms:.4f} ms, "
              f"bound {bnd[name][0]:.4f} ms ({bnd[name][1]}), "
              f"plain {p_ms:.4f} ms, library {l_ms:.4f} ms, kernel / "
              f"library {ms / l_ms:.3f}x", flush=True)
    hosts = {name: host_us(fn) for name, fn in (
        ("flash_fwd", lambda: fa.flash_fwd(q, k, v, scale, causal)),
        ("flash_bwd_dq", lambda: fa.flash_bwd_dq(*bwd)),
        ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(*bwd)))}
    # The forward's parts: its tensor-map geometry in Python, and the C
    # entry point alone (three encodes and the launch).
    maps = fa._tensor_maps((q, fa._FWD_BOX_ROWS[0]), (k, fa._FWD_BOX_ROWS[1]),
                           (v, fa._FWD_BOX_ROWS[1]))
    c_fn = fa._KERNELS["flash_fwd"]._fn
    c_args = (maps, ctypes.c_void_p(o.data_ptr()),
              ctypes.c_void_p(lse.data_ptr()), bh, t, t, 0, D, scale,
              int(causal), 0,
              ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    geo_us = host_us(lambda: fa._tensor_maps(
        (q, fa._FWD_BOX_ROWS[0]), (k, fa._FWD_BOX_ROWS[1]),
        (v, fa._FWD_BOX_ROWS[1])))
    c_us = host_us(lambda: c_fn(*c_args))
    print(f"host per call {what}: " + ", ".join(
        f"{name} {us:.1f} us" for name, us in hosts.items())
        + f" (flash_fwd encodes 3 tensor maps, flash_bwd_dq and "
        f"flash_bwd_dkv 4; of flash_fwd's, the geometry {geo_us:.1f} us "
        f"and the C entry point, 3 encodes and the launch, {c_us:.1f} us)",
        flush=True)
    pair_ms = times["flash_bwd_dq"][0] + times["flash_bwd_dkv"][0]
    pair_plain = cuda_ms(lambda: fa.flash_bwd_reference(
        q, k, v, o, lse, do, scale, causal), 3, 1)
    print(f"kernel pair flash_bwd_dq+flash_bwd_dkv {what}: {pair_ms:.4f}"
          f" ms, bound of the backward as one function (5 products) "
          f"{bnd['flash_bwd'][0]:.4f} ms ({bnd['flash_bwd'][1]}), "
          f"{pair_ms / bnd['flash_bwd'][0]:.2f}x it; the split's 7 "
          f"products bound it at "
          f"{bnd['flash_bwd_dq'][0] + bnd['flash_bwd_dkv'][0]:.4f} ms; "
          f"plain whole backward {pair_plain:.4f} ms, library {lib_bwd:.4f} "
          f"ms", flush=True)
    return rows


def band_times(b: int, tq: int, tk: int, q, k, v, do, readings) -> dict:
    """One band's kernels timed (CUDA events) beside their bound, their
    plain versions and SDPA with a bottom-right causal mask on the same
    inputs (the library yardstick: forward for the forward kernel, its
    whole backward for the backward kernels)."""
    from torch.nn.attention.bias import causal_lower_right

    scale = D ** -0.5
    o, lse = fa.flash_fwd_rect(q, k, v, scale)
    delta = (o.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale)
    mask = causal_lower_right(tq, tk)
    q4, do4 = (x.reshape(b, H, tq, D).contiguous() for x in (q, do))
    k4, v4 = (x.reshape(b, H, tk, D).contiguous() for x in (k, v))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask), 20)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), do4, retain_graph=True), 20)
    times = {
        "flash_fwd_rect": (
            cuda_ms(lambda: fa.flash_fwd_rect(q, k, v, scale), 20),
            cuda_ms(lambda: fa.flash_fwd_rect_reference(q, k, v, scale),
                    3, 1), lib_fwd),
        "flash_bwd_dq_rect": (
            cuda_ms(lambda: fa.flash_bwd_dq_rect(*bwd), 20),
            cuda_ms(lambda: fa.flash_bwd_dq_reference(*bwd, True), 3, 1),
            lib_bwd),
        "flash_bwd_dkv_rect": (
            cuda_ms(lambda: fa.flash_bwd_dkv_rect(*bwd), 20),
            cuda_ms(lambda: fa.flash_bwd_dkv_reference(*bwd, True), 3, 1),
            lib_bwd),
    }
    w = work(b * H, tq, tk)
    rows = {}
    for name, sq in zip(BAND, SQUARE):
        ms, p_ms, l_ms = times[name]
        err = max(r["max_abs_err"] for o_name, r in readings[name].items()
                  if o_name != "lse")
        flops, nbytes = w[sq]
        bnd_ms, bnd_by = bound(flops, nbytes)
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": p_ms,
                      "library_ms": l_ms, "flops": flops, "bytes": nbytes,
                      "bound_ms": bnd_ms, "bound_by": bnd_by}
        print(f"kernel {name} B={b} tq={tq} tk={tk} H={H} D={D} bf16: max "
              f"abs err {err:.3g}, {ms:.4f} ms, bound {bnd_ms:.4f} ms "
              f"({bnd_by}), plain {p_ms:.4f} ms, library {l_ms:.4f} ms, "
              f"kernel / library {ms / l_ms:.3f}x", flush=True)
    return rows


def split_composition(b: int, t: int, n: int, q, k, v, do,
                      kernel_ms: float) -> None:
    """The whole split on ``[B, T, H, D]`` through autograd against the
    unsplit kernels (o bit for bit, gradients by ``agreement``) and the
    plain whole attention, and its fwd+bwd time beside the unsplit one's
    and beside the sum of its band kernels' times."""
    def unfold(x):
        return x.view(b, H, t, D).transpose(1, 2)

    ins = [unfold(x).detach().requires_grad_() for x in (q, k, v)]
    do4 = unfold(do)
    results = {}
    for m in (n, 0):
        with flash_split(m):
            out = fa.flash_attention(*ins)
            grads = torch.autograd.grad(out, ins, do4)

            def step():
                torch.autograd.grad(fa.flash_attention(*ins), ins, do4)

            results[m] = (fold4(out.detach()), [fold4(g) for g in grads],
                          cuda_ms(step, 10))
    scale = D ** -0.5
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, True)
    plain = (o_ref, *fa.flash_bwd_reference(q, k, v, o_ref, lse_ref, do,
                                            scale, True))
    got, whole = results[n], results[0]
    vs_whole = {name: fa.agreement(x, y) for name, x, y in zip(
        ("dq", "dk", "dv"), got[1], whole[1])}
    vs_plain = {name: fa.agreement(x, y) for name, x, y in zip(
        ("o", "dq", "dk", "dv"), (got[0], *got[1]), plain)}
    o_equal = torch.equal(got[0], whole[0])
    dq_equal = torch.equal(got[1][0], whole[1][0])
    print(f"split {n} B={b} T={t}: o equals the unsplit kernels' bit for "
          f"bit: {o_equal}; dq too: {dq_equal}; vs unsplit "
          f"{describe({'': vs_whole})}; vs plain {describe({'': vs_plain})}",
          flush=True)
    rest = got[2] - kernel_ms
    print(f"split {n} B={b} T={t} fwd+bwd through autograd: {got[2]:.4f} ms "
          f"(band kernels {kernel_ms:.4f} ms, the rest {rest:.4f} ms: folds, "
          f"delta, cat and the sum of band dk/dv into the prefix); unsplit "
          f"{whole[2]:.4f} ms", flush=True)
    check(o_equal, f"split {n}: o equals the unsplit kernels' bit for bit")
    check_readings({"split vs unsplit": vs_whole, "split vs plain": vs_plain},
                   f"for the whole split {n} at B={b} T={t}")


def band_phase(b: int, t: int, dev) -> dict[int, dict[str, dict]]:
    """Every band of split 2 and 4 at (b, t): agreement and times. Returns
    {n: {kernel: the sums over the n bands}} for the kernels line."""
    q, k, v, do = kernel_inputs(b, t, dev)
    sums = {}
    for n in SPLITS:
        per_band = []
        whole_bwd = [0.0, 0.0]      # the 5-product backward, over the bands
        for tq, tk, band in bands(q, k, v, do, n):
            readings = kernel_readings(*band, band=True)
            print(f"agreement split {n} band tq={tq} tk={tk}: "
                  f"{describe(readings)}", flush=True)
            check_readings(readings, f"on band tq={tq} tk={tk}")
            per_band.append(band_times(b, tq, tk, *band, readings))
            for j, x in enumerate(work(b * H, tq, tk)["flash_bwd"]):
                whole_bwd[j] += x
        total = {}
        for name in BAND:
            rows = [r[name] for r in per_band]
            flops = sum(r["flops"] for r in rows)
            nbytes = sum(r["bytes"] for r in rows)
            bnd_ms, bnd_by = bound(flops, nbytes)
            total[name] = {
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": bnd_ms, "bound_by": bnd_by,
                "library_ms": sum(r["library_ms"] for r in rows)}
            print(f"kernel {name} split {n} B={b} T={t}, all {n} bands: "
                  f"{total[name]['ms']:.4f} ms, bound {bnd_ms:.4f} ms "
                  f"({bnd_by}), plain {total[name]['plain_ms']:.4f} ms, "
                  f"library {total[name]['library_ms']:.4f} ms, kernel / "
                  f"library {total[name]['ms'] / total[name]['library_ms']:.3f}"
                  "x", flush=True)
        dq, dkv = total["flash_bwd_dq_rect"], total["flash_bwd_dkv_rect"]
        pair_ms = dq["ms"] + dkv["ms"]
        bwd_ms, bwd_by = bound(*whole_bwd)
        print(f"kernel pair flash_bwd_dq_rect+flash_bwd_dkv_rect split {n} "
              f"B={b} T={t}, all {n} bands: {pair_ms:.4f} ms, bound of the "
              f"band backward as one function (5 products, "
              f"_bwd_rect_kernel) {bwd_ms:.4f} ms ({bwd_by}), "
              f"{pair_ms / bwd_ms:.2f}x it; the dq and dkv kernels' 7 "
              f"products bound it at "
              f"{dq['bound_ms'] + dkv['bound_ms']:.4f} ms", flush=True)
        sums[n] = total
        split_composition(b, t, n, q, k, v, do,
                          sum(total[name]["ms"] for name in BAND))
    return sums


def nc_rect_times(b: int, q, kb, vb, do, tk: int, readings,
                  card: str) -> dict:
    """The non-causal rectangle's kernels on q, do ``[BH, tq, D]`` against
    the first ``tk`` rows of the padded blocks kb, vb ``[BH, tq, D]`` (read
    in place), timed (CUDA events, 20 calls) beside their bound, their
    plain versions and SDPA on the padded blocks with the padded keys
    masked (forward, and its whole backward for the backward kernels)."""
    bh, tq, _ = q.shape
    scale = D ** -0.5
    k, v = kb[:, :tk], vb[:, :tk]
    o, lse = fa.flash_fwd_nc_rect(q, k, v, scale)
    delta = (o.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale)
    mask = torch.zeros(tq, tq, dtype=torch.bool, device=q.device)
    mask[:, :tk] = True
    q4, k4, v4, do4 = (x.view(b, bh // b, tq, D) for x in (q, kb, vb, do))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask), 20)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), do4, retain_graph=True), 20)
    times = {
        "flash_fwd_nc_rect": (
            cuda_ms(lambda: fa.flash_fwd_nc_rect(q, k, v, scale), 20),
            cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, scale, False),
                    3, 1), lib_fwd),
        "flash_bwd_dq_nc_rect": (
            cuda_ms(lambda: fa.flash_bwd_dq_nc_rect(*bwd), 20),
            cuda_ms(lambda: fa.flash_bwd_dq_reference(*bwd, False), 3, 1),
            lib_bwd),
        "flash_bwd_dkv_nc_rect": (
            cuda_ms(lambda: fa.flash_bwd_dkv_nc_rect(*bwd), 20),
            cuda_ms(lambda: fa.flash_bwd_dkv_reference(*bwd, False), 3, 1),
            lib_bwd),
    }
    w = work(bh, tq, tk, causal=False)
    rows = {}
    for name, sq in zip(NC_RECT, SQUARE):
        ms, p_ms, l_ms = times[name]
        err = max(r["max_abs_err"] for o_name, r in readings[name].items()
                  if o_name != "lse")
        bnd_ms, bnd_by = bound(*w[sq])
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": p_ms,
                      "bound_ms": bnd_ms, "bound_by": bnd_by,
                      "library_ms": l_ms}
        print(f"kernel {name} B={b} tq={tq} tk={tk} H={bh // b} D={D} bf16 "
              f"non-causal: max abs err {err:.3g}, {ms:.4f} ms, bound "
              f"{bnd_ms:.4f} ms ({bnd_by}), plain {p_ms:.4f} ms, library "
              f"(SDPA, padded keys masked) {l_ms:.4f} ms, kernel / library "
              f"{ms / l_ms:.3f}x; card {card}", flush=True)
    return rows


def nc_rect_phase(dev, card: str) -> dict[str, dict]:
    """Phase 3's non-causal rectangle at ViT-B/16's shapes on ``sp`` 4
    (VIT_SP[0]): B·H = 128·12 queries of a 50-row block against a source
    block's 50 or 47 valid rows (the last block's), read in place from the
    padded block, held against the plain versions by ``agreement`` and
    timed; a block without a valid row launches nothing. Returns the
    47-row hop's readings for the kernels line."""
    t = ViTConfig.base().num_patches + 1
    block, lengths = vit_model.seq_blocks(t, VIT_SP[0])
    gen = torch.Generator(device=dev).manual_seed(block)
    q, kb, vb, do = (torch.randn(VIT_BATCH * H, block, D, device=dev,
                                 generator=gen).to(torch.bfloat16)
                     for _ in range(4))
    rows = {}
    for tk in sorted(set(lengths), reverse=True):
        readings = kernel_readings(q, kb[:, :tk], vb[:, :tk], do, band=True,
                                   causal=False)
        print(f"agreement non-causal rectangle B={VIT_BATCH} tq={block} "
              f"tk={tk}: {describe(readings)}", flush=True)
        check_readings(readings, f"on the non-causal rectangle tq={block} "
                       f"tk={tk}")
        rows[tk] = nc_rect_times(VIT_BATCH, q, kb, vb, do, tk, readings,
                                 card)
    scale = D ** -0.5
    fa.reset_launch_counts()
    o0, lse0 = fa.flash_fwd_nc_rect(q, kb[:, :0], vb[:, :0], scale)
    dq0 = fa.flash_bwd_dq_nc_rect(q, kb[:, :0], vb[:, :0], do, lse0,
                                  lse0, scale)
    dk0, _ = fa.flash_bwd_dkv_nc_rect(q, kb[:, :0], vb[:, :0], do, lse0,
                                      lse0, scale)
    torch.cuda.synchronize()
    launched = sum(fa.launch_counts().values())
    empty_ok = (launched == 0 and not o0.any() and not dq0.any()
                and bool(torch.isneginf(lse0).all()) and dk0.numel() == 0)
    print(f"non-causal rectangle with tk=0 (a block without a valid row): "
          f"{launched} launches, o = 0, lse = -inf, dq = 0, dk empty: "
          f"{empty_ok}; card {card}", flush=True)
    check(empty_ok, "the non-causal rectangle launches nothing for tk = 0")
    return rows[min(lengths)]


class PlainAttention(torch.autograd.Function):
    """Attention on [BH, T, D] through the plain versions, forward and
    backward, saving only what the kernels' Function saves."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal=True):
        o, lse = fa.flash_fwd_reference(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*fa.flash_bwd_reference(q, k, v, o, lse, do.contiguous(),
                                        ctx.scale, ctx.causal), None, None)


def fold4(x):
    """[B, T, H, D] -> contiguous [B*H, T, D], as the kernels take it."""
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def plain_attention(q, k, v, causal: bool = True):
    """Attention through the plain versions, on [B, T, H, D]."""
    b, t, h, d = q.shape
    o = PlainAttention.apply(fold4(q), fold4(k), fold4(v), d ** -0.5, causal)
    return o.view(b, h, t, d).transpose(1, 2)


def layer_inputs(model, loss, layers) -> dict[int, list]:
    """{layer: [q, k, v, do]} at step 0, folded ``[BH, T, D]``: the
    attention inputs and output gradient ``loss(model)`` gives each of
    ``layers``."""
    seen = {}
    kernel_attn = model.attn_fn
    calls = [0]

    def capture(q, k, v):
        i = calls[0]
        calls[0] += 1
        out = kernel_attn(q, k, v)
        if i in layers:
            seen[i] = [q.detach(), k.detach(), v.detach(), None]
            out.register_hook(lambda g, entry=seen[i]:
                              entry.__setitem__(3, g))
        return out

    model.attn_fn = capture
    try:
        torch.autograd.grad(loss(model), next(model.parameters()))
    finally:
        model.attn_fn = kernel_attn
    return {i: [fold4(x) for x in entry] for i, entry in sorted(seen.items())}


def layer_readings(model, batch, layers=None, n_split: int = 0
                   ) -> list[dict[str, dict]]:
    """Each GPT-2 layer's attention at step 0, on the q, k, v and output
    gradient the model gives it on ``batch``: :func:`kernel_readings` for
    each of ``layers`` (default all), in order; under ``n_split`` the
    band kernels on every band (the worst reading over the bands)."""
    layers = range(len(model.h)) if layers is None else layers
    captured = layer_inputs(
        model, lambda m: gpt2_loss_fn(ce_chunk=2048)(m, batch), set(layers))
    out = []
    for i, xs in captured.items():
        if n_split:
            readings = worst([kernel_readings(*band, band=True)
                              for _, _, band in bands(*xs, n_split)])
        else:
            readings = kernel_readings(*xs)
        out.append(readings)
        route = f" (split {n_split})" if n_split else ""
        print(f"agreement layer {i}{route}: {describe(readings)}", flush=True)
    return out


def attention_grad_readings(model, batch) -> dict[str, tuple[float, int]]:
    """{weight: (largest ||g_kernels - g_plain|| / ||g_plain|| over the
    layers, the layer)} for the q, k, v thirds of ``qkv_kernel`` and for
    ``proj_kernel``, at the model's weights on ``batch``."""
    loss_fn = gpt2_loss_fn(ce_chunk=2048)
    params = [p for blk in model.h
              for p in (blk.attn.qkv_kernel, blk.attn.proj_kernel)]
    kernel_attn = model.attn_fn
    grads = {}
    for name, attn in (("kernels", kernel_attn), ("plain", plain_attention)):
        model.attn_fn = attn
        grads[name] = torch.autograd.grad(loss_fn(model, batch), params)
    model.attn_fn = kernel_attn
    worst_rel = {}
    for i in range(len(model.h)):
        gk_qkv, gk_proj = grads["kernels"][2 * i: 2 * i + 2]
        gp_qkv, gp_proj = grads["plain"][2 * i: 2 * i + 2]
        pairs = {"q": (gk_qkv[:, 0], gp_qkv[:, 0]),
                 "k": (gk_qkv[:, 1], gp_qkv[:, 1]),
                 "v": (gk_qkv[:, 2], gp_qkv[:, 2]),
                 "proj": (gk_proj, gp_proj)}
        for w, (gk, gp) in pairs.items():
            rel = float(torch.linalg.vector_norm(gk - gp)
                        / torch.linalg.vector_norm(gp))
            if rel > worst_rel.get(w, (-1.0, 0))[0]:
                worst_rel[w] = (rel, i)
    print("attention grads vs plain (largest relative norm error over the "
          "layers, layer): " + ", ".join(
              f"{w} {r:.4g} (layer {i})" for w, (r, i) in worst_rel.items())
          + f"; limit {GRAD_TOL}", flush=True)
    return worst_rel


def step0_losses(model, batch, loss_fn=gpt2_loss_fn) -> tuple[float, float]:
    """Step-0 loss through the kernels and the chunked CE, and through
    the plain attention and full float32 logits, same weights and batch."""
    kernel_attn = model.attn_fn
    with torch.no_grad():
        loss_kernel = float(loss_fn()(model, batch))
        model.attn_fn = plain_attention
        loss_plain = float(loss_fn(fused_ce=False)(model, batch))
    model.attn_fn = kernel_attn
    print(f"train step-0 loss: kernels {loss_kernel:.6f}, plain "
          f"{loss_plain:.6f}, |diff| {abs(loss_kernel - loss_plain):.3g} "
          f"(limit {STEP0_LOSS_TOL})", flush=True)
    return loss_kernel, loss_plain


def train_batch(vocab: int, b: int = TRAIN_BATCH, t: int = TRAIN_SEQ):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (b, t)).astype(np.int32)
    return toks, np.roll(toks, -1, 1)


def device_batch(toks, tgts, dev) -> dict:
    """Host token ids on ``dev`` (a copy first of an array the object
    store handed out read-only)."""
    return {k: torch.from_numpy(np.require(v, requirements="W")).to(dev)
            for k, v in (("tokens", toks), ("targets", tgts))}


# Kernel-name markers of each device-time group of ``profile_dispatch``,
# matched in this order on the lower-cased name: cuDNN's convolutions
# (forward, data and weight gradients) before the products, since both
# may carry "gemm" or "xmma"; "reductions" are the row and column sums
# (BatchNorm's and LayerNorm's statistics, the loss); "other" is the
# elementwise work.
KERNEL_GROUPS = (
    ("flash kernels", ("rtt::flash",)),
    ("convolution", ("cudnn", "implicit_gemm", "fprop", "dgrad", "wgrad",
                     "convolution", "conv2d", "winograd", "nchwtonhwc",
                     "nhwctonchw")),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("reductions", ("reduce", "norm")),
)


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, markers in KERNEL_GROUPS:
        if any(m in low for m in markers):
            return group
    return "other"


# The CUDA kernel behind each launch counter (both routes of a kernel run
# the same function).
KERNEL_NAMES = {"flash_fwd": "flash_fwd_kernel",
                "flash_bwd_dq": "flash_bwd_dq_kernel",
                "flash_bwd_dkv": "flash_bwd_dkv_kernel"}


def profile_dispatch(step, state, batch, card: str):
    """Run one dispatch (a replay of the captured step) under
    torch.profiler and print where the device time goes: the busy share of
    the wall time, the kernels with the most device time and every flash
    kernel. Cross-checks the launch counters against the flash kernels the
    profiler saw in the dispatch and fails where they differ. A profiler
    that records no device time prints "not measured" and fails nothing.
    Returns the state and the busy share (None when not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    fa.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # The profiler keeps only the device records that fall inside its
        # window on the host's clock, to which it maps the card's
        # timestamps. With the dispatch at the window's start, the first
        # flash forwards of a dispatch late in this script fell outside
        # now and then (1 or 4 of them). The host waits PROFILE_MARGIN_S
        # on each side of the dispatch.
        opened = time.perf_counter()
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_MARGIN_S)
        window_ms = (time.perf_counter() - opened) * 1e3
    counted = fa.launch_counts()
    rows = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0.0) > 0]
    busy_ms = sum(r[2] for r in rows) / 1e3
    if busy_ms == 0:
        print("profile: no device time recorded (not measured)", flush=True)
        return state, None
    spans = [e.time_range for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    head = min(r.start for r in spans) / 1e3
    tail = window_ms - max(r.end for r in spans) / 1e3
    print(f"profile window: the first device record starts {head:.3f} ms "
          f"after the profiler's start, the last ends {tail:.3f} ms before "
          f"the host left it (the host waits {PROFILE_MARGIN_S * 1e3:.0f} "
          "ms on each side of the dispatch)", flush=True)
    seen = {name: sum(count for key, count, _ in rows if fn in key)
            for name, fn in KERNEL_NAMES.items()}
    want = {name: counted[name] + counted[f"{name}_rect"]
            for name in KERNEL_NAMES}
    print(f"profile: flash kernels the profiler saw in the replayed "
          f"dispatch {seen}; launch counters (both routes) {want}",
          flush=True)
    check(seen == want, "the launch counters match the flash kernels the "
          f"profiler saw in one replayed dispatch ({want} vs {seen})")
    groups = {"flash kernels": 0.0, "convolution": 0.0, "matmul": 0.0,
              "reductions": 0.0, "other": 0.0}
    for key, _, us in rows:
        groups[kernel_group(key)] += us
    print(f"profile: one dispatch of {K_STEPS} steps, wall {wall_ms:.2f} "
          f"ms, device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}); "
          + ", ".join(f"{g} {us / 1e3:.2f} ms ({us / 1e3 / busy_ms:.1%})"
                      for g, us in groups.items())
          + f"; card {card}", flush=True)
    # The 12 kernels with the most device time, then the largest of each
    # group below them and the flash kernels.
    top = sorted(rows, key=lambda r: -r[2])
    shown = {kernel_group(r[0]) for r in top[:12]}
    below = []
    for r in top[12:]:
        group = kernel_group(r[0])
        if group == "flash kernels" or group not in shown:
            below.append(r)
            shown.add(group)
    for key, count, us in top[:12] + below:
        print(f"profile kernel {us / 1e3:9.3f} ms x{count:<5d} {key[:110]}",
              flush=True)
    return state, busy_ms / wall_ms


def lm_opt():
    """The LM phases' optimizer: ``adamw(3e-4, weight_decay=0.1,
    mu_dtype=bf16)`` (``bench.py:371``)."""
    return adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)


def token_stack(toks, tgts) -> dict:
    """One batch repeated K_STEPS times: a host stack for the prefetcher."""
    return {"tokens": np.stack([toks] * K_STEPS),
            "targets": np.stack([tgts] * K_STEPS)}


def train_run(model, loss_fn, opt, stack, items: int, timed: int,
              profile_card: str | None = None, place=None,
              has_extra: bool = False) -> dict:
    """Train ``model`` on the repeated batch ``stack`` (K_STEPS steps a
    dispatch) through ``prefetch_to_device`` (placed by ``place`` when
    given) and ``make_multi_train_step`` with ``opt``, captured as a CUDA
    graph: one warm-up dispatch (the eager warm-up step, the capture and
    a replay), ``timed`` timed dispatches and, with ``profile_card``, one
    profiled dispatch (after the launch counts are read). Checks that the
    step was captured once and stayed so (``compile_count``) and that it
    updated the state in place (``buffers_donated``). ``items`` is what
    one step consumes (tokens or images). With ``has_extra`` the model's
    buffers are the step's ``extra``. Peak memory is over the whole
    run."""
    dev = next(model.parameters()).device
    state = init_train_state(model, opt, extra=(dict(model.named_buffers())
                                                if has_extra else None))
    step = make_multi_train_step(loss_fn, opt, has_extra=has_extra,
                                 grad_norm=False)
    n_dispatch = 1 + timed + (profile_card is not None)
    want_captures = 1 if CAPTURE else None
    busy = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with prefetch_to_device((stack for _ in range(n_dispatch)), dev,
                            place=place) as pf:
        fa.reset_launch_counts()
        state, metrics = step(state, next(pf))     # warm-up dispatch
        loss_warm = float(metrics["loss"])
        captures = compile_count(step)
        stall0 = pf.stall_s
        t0 = time.perf_counter()
        for _ in range(timed):
            state, metrics = step(state, next(pf))
        loss_final = float(metrics["loss"])        # waits for the device
        dt = time.perf_counter() - t0
        stall = pf.stall_s - stall0
        counts = fa.launch_counts()
        check(captures == want_captures
              and compile_count(step) == want_captures,
              f"the step was captured {want_captures} times, at warm-up, "
              f"and not again (compile_count {captures} after warm-up, "
              f"{compile_count(step)} after the timed dispatches)")
        if profile_card is not None:
            state, busy = profile_dispatch(step, state, next(pf),
                                           profile_card)
    n_steps = (1 + timed) * K_STEPS
    check(state.step == n_dispatch * K_STEPS, "every step ran")
    check(compile_count(step) == want_captures,
          f"compile_count stays {want_captures}")
    check(buffers_donated(step, state), "the step updated every parameter "
          "and optimizer-state tensor in place (buffers_donated)")
    check(np.isfinite(loss_final), "loss finite")
    return {"loss_warm": loss_warm, "loss_final": loss_final,
            "n_steps": n_steps, "counts": counts,
            "step_ms": dt / (timed * K_STEPS) * 1e3,
            "tok_s": items * timed * K_STEPS / dt, "busy": busy,
            "compile_count": compile_count(step),
            "peak": torch.cuda.max_memory_allocated(), "stall_ms": stall * 1e3}


def capture_vs_eager(make_model, loss_fn, make_opt, batch, what: str,
                     has_extra: bool = False) -> None:
    """The first CAPTURE_STEPS losses of the captured step against those of
    the same step under ``disable_capture()``, each from a fresh model of
    the same seed on ``batch``, repeated; within CAPTURE_LOSS_RTOL. Not
    under ``--eager``, which runs no capture."""
    if not CAPTURE:
        return
    losses = {}
    for captured in (True, False):
        model = make_model()
        opt = make_opt()
        state = init_train_state(model, opt, extra=(
            dict(model.named_buffers()) if has_extra else None))
        step = make_train_step(loss_fn, opt, has_extra=has_extra,
                               grad_norm=False)
        with contextlib.nullcontext() if captured else disable_capture():
            losses[captured] = [float(step(state, batch)[1]["loss"])
                                for _ in range(CAPTURE_STEPS)]
        check(compile_count(step) == (1 if captured else None),
              f"{what}: compile_count {compile_count(step)}")
        del model, opt, state, step
        torch.cuda.empty_cache()
    got, want = losses[True], losses[False]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"{what} captured vs eager, first {CAPTURE_STEPS} losses: captured "
          f"{got}, eager {want}; largest relative difference {rel:.3g} "
          f"(limit {CAPTURE_LOSS_RTOL}); bit-equal: {got == want}",
          flush=True)
    check(rel <= CAPTURE_LOSS_RTOL,
          f"{what}: the captured step's losses match the eager step's")


def check_counts(run: dict, per_step: dict[str, int], what: str) -> None:
    """Each kernel launched ``per_step[name]`` times per step (0 where not
    named) over the run's counted steps."""
    n = run["n_steps"]
    for name, got in run["counts"].items():
        want = per_step.get(name, 0)
        check(got == want * n, f"{what}: {name} launched {want} times per "
              f"step ({got} for {n} steps)")


def describe_run(what: str, run: dict, loss0: float, card: str,
                 unit: str = "tokens") -> str:
    busy = "not measured" if run["busy"] is None else f"{run['busy']:.1%}"
    return (f"train {what}, {run['n_steps']} steps: loss {loss0:.4f} -> "
            f"{run['loss_warm']:.4f} (step {K_STEPS}) -> "
            f"{run['loss_final']:.4f} (step {run['n_steps']}); step "
            f"{run['step_ms']:.2f} ms, {run['tok_s']:.1f} {unit}/s, peak "
            f"memory {run['peak']} B, input stall {run['stall_ms']:.3f} ms; "
            f"{'captured' if CAPTURE else 'eager'} step: compile_count "
            f"{run['compile_count']}, buffers donated, busy {busy} (one "
            f"profiled dispatch); "
            f"launches {run['counts']}; card {card}")


def train_phase(card: str) -> tuple[dict, float]:
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)                     # on the card by default
    dev = next(model.parameters()).device
    toks, tgts = train_batch(cfg.vocab_size)
    batch0 = device_batch(toks, tgts, dev)
    for i, readings in enumerate(layer_readings(model, batch0)):
        check_readings(readings, f"on layer {i}'s inputs")
    worst_rel = attention_grad_readings(model, batch0)
    for w, (rel, layer) in worst_rel.items():
        check(rel < GRAD_TOL, f"{w} gradient of layer {layer} within "
              f"{GRAD_TOL} of the plain path's (got {rel:.4g})")
    loss_kernel, loss_plain = step0_losses(model, batch0)
    check(np.isfinite(loss_kernel), "step-0 loss finite")
    check(abs(loss_kernel - loss_plain) < STEP0_LOSS_TOL,
          "step-0 loss matches the plain path")
    capture_vs_eager(lambda: GPT2(cfg, seed=0), gpt2_loss_fn(ce_chunk=2048),
                     lm_opt, batch0, "GPT-2 124M")
    del batch0

    run = train_run(model, gpt2_loss_fn(ce_chunk=2048), lm_opt(),
                    token_stack(toks, tgts), toks.size, TIMED_DISPATCHES,
                    profile_card=card)
    print(describe_run(f"GPT-2 124M B={TRAIN_BATCH} T={TRAIN_SEQ} bf16", run,
                       loss_kernel, card), flush=True)
    check(run["loss_final"] < run["loss_warm"] < loss_kernel,
          "loss falls on a repeated batch")
    check_counts(run, {name: cfg.n_layer for name in SQUARE},
                 "GPT-2 unsplit")
    return run, loss_kernel


def split_train_phase(n: int, loss_unsplit: float, card: str) -> dict:
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)
    dev = next(model.parameters()).device
    toks, tgts = train_batch(cfg.vocab_size)
    with flash_split(n):
        batch0 = device_batch(toks, tgts, dev)
        for i, readings in zip(SPLIT_CHECK_LAYERS, layer_readings(
                model, batch0, SPLIT_CHECK_LAYERS, n_split=n)):
            check_readings(readings, f"on layer {i}'s inputs, split {n}")
        with torch.no_grad():
            loss0 = float(gpt2_loss_fn(ce_chunk=2048)(model, batch0))
        print(f"train split {n} step-0 loss {loss0:.6f}, unsplit "
              f"{loss_unsplit:.6f}, |diff| {abs(loss0 - loss_unsplit):.3g} "
              f"(limit {STEP0_LOSS_TOL})", flush=True)
        check(abs(loss0 - loss_unsplit) < STEP0_LOSS_TOL,
              f"split {n} step-0 loss matches the unsplit run's")
        del batch0
        run = train_run(model, gpt2_loss_fn(ce_chunk=2048), lm_opt(),
                        token_stack(toks, tgts), toks.size,
                        SHORT_TIMED_DISPATCHES, profile_card=card)
    print(describe_run(f"GPT-2 124M split {n} B={TRAIN_BATCH} T={TRAIN_SEQ} "
                       "bf16", run, loss0, card), flush=True)
    check(run["loss_final"] < run["loss_warm"] < loss0,
          f"split {n}: loss falls on a repeated batch")
    check_counts(run, {name: n * cfg.n_layer for name in BAND},
                 f"GPT-2 split {n}")
    return run


def remat_phase(base_peak: int, card: str) -> dict[str, dict]:
    """Step-0 loss and gradients of each policy against no remat, then a
    short training run per policy."""
    toks, tgts = train_batch(GPT2Config.small().vocab_size)
    loss_fn = gpt2_loss_fn(ce_chunk=2048)

    def loss_and_grads(cfg):
        model = GPT2(cfg, seed=0)
        batch = device_batch(toks, tgts, next(model.parameters()).device)
        loss = loss_fn(model, batch)
        return float(loss), torch.autograd.grad(loss,
                                                list(model.parameters()))

    loss0, grads0 = loss_and_grads(GPT2Config.small())
    for policy in REMAT_POLICIES:
        loss, grads = loss_and_grads(GPT2Config.small(remat=True,
                                                      remat_policy=policy))
        rel = max(float(torch.linalg.vector_norm(g - g0)
                        / torch.linalg.vector_norm(g0))
                  for g, g0 in zip(grads, grads0))
        equal = sum(torch.equal(g, g0) for g, g0 in zip(grads, grads0))
        del grads
        print(f"remat {policy}: step-0 loss {loss:.6f} vs {loss0:.6f} "
              f"(|diff| {abs(loss - loss0):.3g}, limit {REMAT_LOSS_TOL}); "
              f"gradients: largest relative norm error {rel:.3g} (limit "
              f"{REMAT_GRAD_TOL}), {equal} of {len(grads0)} bit-equal",
              flush=True)
        check(abs(loss - loss0) <= REMAT_LOSS_TOL and rel <= REMAT_GRAD_TOL,
              f"remat {policy}: step-0 loss and gradients match no remat")
    del grads0
    torch.cuda.empty_cache()

    runs = {}
    for policy in REMAT_POLICIES:
        cfg = GPT2Config.small(remat=True, remat_policy=policy)
        run = train_run(GPT2(cfg, seed=0), loss_fn, lm_opt(),
                        token_stack(toks, tgts), toks.size,
                        SHORT_TIMED_DISPATCHES, profile_card=card)
        print(describe_run(f"GPT-2 124M remat {policy} B={TRAIN_BATCH} "
                           f"T={TRAIN_SEQ} bf16", run, loss0, card),
              flush=True)
        fwd = cfg.n_layer * (1 if policy == "everything" else 2)
        check_counts(run, {"flash_fwd": fwd, "flash_bwd_dq": cfg.n_layer,
                           "flash_bwd_dkv": cfg.n_layer}, f"remat {policy}")
        runs[policy] = run
        torch.cuda.empty_cache()
    print("remat peak memory (B): " + ", ".join(
        f"{p} {r['peak']}" for p, r in runs.items())
        + f"; no remat {base_peak}", flush=True)
    check(runs["nothing"]["peak"] < base_peak,
          "remat nothing: peak memory below the run without remat")
    return runs


def llama_phase(card: str) -> dict[str, dict]:
    cfg = LlamaConfig.tinyllama_1b()
    model = Llama(cfg, seed=0)
    dev = next(model.parameters()).device
    n_params = sum(p.numel() for p in model.parameters())
    toks, tgts = train_batch(cfg.vocab_size, LLAMA_BATCH, LLAMA_SEQ)
    batch0 = device_batch(toks, tgts, dev)
    captured = layer_inputs(
        model, lambda m: llama_loss_fn(ce_chunk=2048)(m, batch0),
        set(LLAMA_CHECK_LAYERS))
    readings = {}
    for i, xs in captured.items():
        readings[i] = kernel_readings(*xs)
        print(f"agreement TinyLlama layer {i}: {describe(readings[i])}",
              flush=True)
        check_readings(readings[i], f"on TinyLlama layer {i}'s inputs")
    # The kernels at TinyLlama's own shape, on its last layer's inputs.
    last = LLAMA_CHECK_LAYERS[-1]
    rows = kernel_times(LLAMA_BATCH, *captured[last], readings[last],
                        f"TinyLlama layer {last} B={LLAMA_BATCH} "
                        f"T={LLAMA_SEQ} H={cfg.n_head}")
    del captured
    torch.cuda.empty_cache()
    loss_kernel, loss_plain = step0_losses(model, batch0, llama_loss_fn)
    check(np.isfinite(loss_kernel), "TinyLlama step-0 loss finite")
    check(abs(loss_kernel - loss_plain) < STEP0_LOSS_TOL,
          "TinyLlama step-0 loss matches the plain path")
    del batch0
    torch.cuda.empty_cache()

    run = train_run(model, llama_loss_fn(ce_chunk=2048), lm_opt(),
                    token_stack(toks, tgts), toks.size,
                    SHORT_TIMED_DISPATCHES, profile_card=card)
    mfu = 6 * n_params * run["tok_s"] / PEAK_BF16_FLOPS
    print(describe_run(f"TinyLlama 1.1B ({n_params} params) B={LLAMA_BATCH} "
                       f"T={LLAMA_SEQ} bf16", run, loss_kernel, card)
          + f"; 6*N*tokens/s = {mfu:.4f} of the bf16 peak (attention FLOPs "
          "not counted)", flush=True)
    check(run["loss_final"] < run["loss_warm"] < loss_kernel,
          "TinyLlama: loss falls on a repeated batch")
    check_counts(run, {name: cfg.n_layer for name in SQUARE}, "TinyLlama")
    return rows


def image_place(size: int, classes: int, dev, keys=("image", "label")):
    """``place(seed)`` for ``prefetch_to_device``: one batch drawn on the
    card from ``seed`` (``[B, size, size, 3]`` float32 normal images,
    int32 labels) and repeated K_STEPS times as a ``[K_STEPS, ...]``
    stack. It runs on the prefetcher's side stream, so the next stack is
    drawn while a step runs (the on-device generator of ``bench.py``'s
    ResNet-50 lane, ``bench.py:566-594``)."""
    def place(batch_seed):
        b, seed = batch_seed
        gen = torch.Generator(device=dev).manual_seed(seed)
        image = torch.randn((b, size, size, 3), generator=gen, device=dev)
        label = torch.randint(0, classes, (b,), generator=gen, device=dev,
                              dtype=torch.int32)
        return {keys[0]: image.expand(K_STEPS, *image.shape),
                keys[1]: label.expand(K_STEPS, b)}
    return place


def flops_per_step(model, loss, batch) -> float:
    """FLOPs of one forward and backward of ``loss(model, batch)``, counted
    by ``torch.utils.flop_counter`` from the shapes of each product and
    convolution (the flash kernels are custom ops, which it does not
    count)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = loss(model, batch)
        out = out[0] if isinstance(out, tuple) else out
        torch.autograd.grad(out, [p for p in model.parameters()
                                  if p.requires_grad])
    return float(counter.get_total_flops())


def resnet_phase(card: str) -> dict:
    """ResNet-50 (``ResNet50Config()``, 1000 classes, random weights from
    seed 0) at batch 128, 224x224: step-0 logits against the float32 model
    on the CPU, then training with ``sgd(0.1, momentum=0.9,
    nesterov=True)`` and the BatchNorm statistics through the step
    (``bench.py:537-549``), on images drawn on the card behind the
    prefetcher."""
    cfg = ResNet50Config()
    model = ResNet(cfg, seed=0)
    dev = next(model.parameters()).device
    rng = np.random.default_rng(0)
    image = rng.standard_normal((RESNET_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE,
                                 3)).astype(np.float32)
    # The float32 reference runs on the CPU, so TF32 cannot touch it.
    ref = ResNet(ResNet50Config(dtype=torch.float32), device="cpu", seed=0)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        got, _ = model(torch.from_numpy(image).to(dev), train=True)
        want, _ = ref(torch.from_numpy(image), train=True)
    del ref
    rel = float(torch.linalg.vector_norm(got.cpu() - want)
                / torch.linalg.vector_norm(want))
    print(f"ResNet-50 step-0 logits (train mode, B={RESNET_CHECK_BATCH}): "
          f"bf16 on the card vs float32 on the CPU, relative norm error "
          f"{rel:.4g} (limit {RESNET_LOGIT_TOL}), largest |diff| "
          f"{float((got.cpu() - want).abs().max()):.4g} of largest |logit| "
          f"{float(want.abs().max()):.4g}", flush=True)
    check(bool(torch.isfinite(got).all()) and rel < RESNET_LOGIT_TOL,
          "ResNet-50 step-0 logits match the float32 model on the CPU")

    place = image_place(IMAGE_SIZE, cfg.num_classes, dev)
    batch0 = {k: v[0] for k, v in place((RESNET_BATCH, 0)).items()}
    initial = {k: v.clone() for k, v in model.batch_stats().items()}
    with torch.no_grad():
        loss0 = float(resnet_loss_fn()(model, model.batch_stats(),
                                       batch0)[0])
    flops = flops_per_step(
        model, lambda m, b: resnet_loss_fn()(m, m.batch_stats(), b), batch0)
    capture_vs_eager(lambda: ResNet(cfg, seed=0), resnet_loss_fn(),
                     lambda: sgd(0.1, momentum=0.9, nesterov=True), batch0,
                     "ResNet-50", has_extra=True)
    del batch0
    torch.cuda.empty_cache()

    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True       # fixed shapes: autotune
    try:
        run = train_run(model, resnet_loss_fn(),
                        sgd(0.1, momentum=0.9, nesterov=True),
                        (RESNET_BATCH, 0), RESNET_BATCH,
                        SHORT_TIMED_DISPATCHES, profile_card=card,
                        place=place, has_extra=True)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    share = flops * run["tok_s"] / RESNET_BATCH / PEAK_BF16_FLOPS
    print(describe_run(f"ResNet-50 B={RESNET_BATCH} {IMAGE_SIZE}x"
                       f"{IMAGE_SIZE} bf16 channels_last, SGD-Nesterov",
                       run, loss0, card, unit="images")
          + f"; {flops:.4g} FLOPs a step (convolutions and the classifier, "
          f"forward and backward) = {share:.4f} of the bf16 peak", flush=True)
    check(run["loss_final"] < run["loss_warm"] < loss0,
          "ResNet-50: loss falls on a repeated batch")
    check_counts(run, {}, "ResNet-50 (no flash kernel)")

    stats = model.batch_stats()
    moved = [float((v != initial[k]).float().mean()) for k, v in stats.items()]
    print(f"ResNet-50 running statistics: {len(stats)} buffers, all finite: "
          f"{all(bool(torch.isfinite(v).all()) for v in stats.values())}; "
          f"share of entries moved from their initial value: least "
          f"{min(moved):.4f}, mean {sum(moved) / len(moved):.4f}", flush=True)
    check(all(bool(torch.isfinite(v).all()) for v in stats.values()),
          "ResNet-50 running statistics finite")
    check(all(not torch.equal(v, initial[k]) for k, v in stats.items()),
          "every ResNet-50 running statistic moved from its initial value")
    with torch.no_grad():
        x = torch.from_numpy(image).to(dev)
        eval_trained = model(x)
        eval_initial = model(x, batch_stats=initial)
    diff = float((eval_trained - eval_initial).abs().max())
    print(f"ResNet-50 eval mode (B={RESNET_CHECK_BATCH}): logits finite "
          f"{bool(torch.isfinite(eval_trained).all())}; largest change "
          f"against the initial statistics {diff:.4g}", flush=True)
    check(bool(torch.isfinite(eval_trained).all()) and diff > 0,
          "ResNet-50 eval mode reads the trained running statistics")
    return run


def vit_phase(card: str) -> tuple[dict, dict]:
    """ViT-B/16 (``ViTConfig.base()``, random weights from seed 0) at batch
    128, 224x224 (T = 197), ``adamw(3e-3)``: the kernels with
    ``causal=False`` on layers 0 and 11's own inputs and timed at that
    shape, the step-0 loss against the plain attention, then training."""
    cfg = ViTConfig.base()
    model = ViT(cfg, seed=0)
    dev = next(model.parameters()).device
    t = cfg.num_patches + 1
    place = image_place(cfg.image_size, cfg.num_classes, dev,
                        keys=("images", "labels"))
    batch0 = {k: v[0] for k, v in place((VIT_BATCH, 0)).items()}
    loss = vit_loss_fn()
    captured = layer_inputs(model, lambda m: loss(m, batch0),
                            set(VIT_CHECK_LAYERS))
    readings = {}
    for i, xs in captured.items():
        readings[i] = kernel_readings(*xs, causal=False)
        print(f"agreement ViT-B/16 layer {i} (non-causal, BH="
              f"{xs[0].shape[0]}, T={t}): {describe(readings[i])}",
              flush=True)
        check_readings(readings[i], f"on ViT-B/16 layer {i}'s inputs")
    last = VIT_CHECK_LAYERS[-1]
    rows = kernel_times(VIT_BATCH, *captured[last], readings[last],
                        f"ViT-B/16 layer {last} B={VIT_BATCH} T={t} "
                        f"H={cfg.n_head}", causal=False)
    del captured
    torch.cuda.empty_cache()

    kernel_attn = model.attn_fn
    with torch.no_grad():
        loss_kernel = float(loss(model, batch0))
        model.attn_fn = functools.partial(plain_attention, causal=False)
        loss_plain = float(loss(model, batch0))
    model.attn_fn = kernel_attn
    print(f"ViT-B/16 step-0 loss: kernels {loss_kernel:.6f}, plain "
          f"{loss_plain:.6f}, |diff| {abs(loss_kernel - loss_plain):.3g} "
          f"(limit {VIT_STEP0_LOSS_TOL})", flush=True)
    check(np.isfinite(loss_kernel)
          and abs(loss_kernel - loss_plain) < VIT_STEP0_LOSS_TOL,
          "ViT-B/16 step-0 loss matches the plain-attention path")
    flops = flops_per_step(model, loss, batch0)
    del batch0
    torch.cuda.empty_cache()

    run = train_run(model, loss, adamw(3e-3), (VIT_BATCH, 0), VIT_BATCH,
                    SHORT_TIMED_DISPATCHES, profile_card=card, place=place)
    share = flops * run["tok_s"] / VIT_BATCH / PEAK_BF16_FLOPS
    print(describe_run(f"ViT-B/16 B={VIT_BATCH} {cfg.image_size}x"
                       f"{cfg.image_size} (T={t}) bf16, adamw(3e-3)", run,
                       loss_kernel, card, unit="images")
          + f"; {flops:.4g} FLOPs a step in products and the patch "
          f"convolution (attention not counted) = {share:.4f} of the bf16 "
          "peak", flush=True)
    check(run["loss_final"] < run["loss_warm"] < loss_kernel,
          "ViT-B/16: loss falls on a repeated batch")
    check_counts(run, {name: cfg.n_layer for name in SQUARE}, "ViT-B/16")
    return rows, run


def moe_layer_inputs(model, batch) -> dict[int, torch.Tensor]:
    """{layer: the tokens ``[B·T, D]`` its SwitchFFN takes} of every MoE
    layer, at the model's weights on ``batch``."""
    seen = {}
    hooks = [blk.moe.register_forward_pre_hook(
        lambda m, args, i=i: seen.__setitem__(
            i, args[0].detach().reshape(-1, args[0].shape[-1])))
        for i, blk in enumerate(model.h) if isinstance(blk, MoEBlock)]
    try:
        with torch.no_grad():
            moe_loss_fn()(model, batch)
    finally:
        for hook in hooks:
            hook.remove()
    return dict(sorted(seen.items()))


def moe_routes(model, batch) -> dict:
    """{layer: its Route} of every MoE layer on ``batch`` at the model's
    weights: the routing its ``SwitchFFN`` runs (``top1_route``, over the
    batch's tokens on a mesh)."""
    cfg, mesh = model.config, model.mesh
    ranks = 1 if mesh is None else mesh.axis_size(DATA_AXES)
    routes = {}
    for i, x in moe_layer_inputs(model, batch).items():
        cap = capacity_for(x.shape[0] * ranks, cfg.num_experts,
                           cfg.capacity_factor)
        routes[i] = top1_route(x.float() @ model.h[i].moe.router.float(),
                               cfg.num_experts, cap, mesh,
                               batch["tokens"].shape[0])
    return routes


def moe_routing(model, batch) -> str:
    """Each MoE layer's routing on ``batch``: the share of tokens dropped
    past capacity and each expert's share of the tokens (its load)."""
    cfg = model.config
    parts = []
    for i, route in moe_routes(model, batch).items():
        load = torch.bincount(route.expert, minlength=cfg.num_experts)
        dropped = 1.0 - float(route.kept.float().mean())
        parts.append(f"layer {i} dropped {dropped:.4f}, load " + "/".join(
            f"{v:.3f}" for v in (load.float() / load.sum()).tolist()))
    return "; ".join(parts)


def moe_form_check(model, batch) -> None:
    """The index-form switch FFN (``moe_ffn``) against the one-hot einsum
    form (``dense_switch_ffn_reference``) on the first MOE_FORM_TOKENS
    tokens the first MoE layer takes, with that layer's weights: outputs,
    aux and router gradients."""
    cfg = model.config
    first, x = next(iter(moe_layer_inputs(model, batch).items()))
    x = x[:MOE_FORM_TOKENS]
    ffn = model.h[first].moe
    outs = {}
    for name, fn in (("index", moe_ffn), ("one-hot",
                                          dense_switch_ffn_reference)):
        router = ffn.router.detach().clone().requires_grad_()
        y, aux = fn(x, router, ffn.w_up.detach(), ffn.w_down.detach(),
                    capacity_factor=cfg.capacity_factor, dtype=cfg.dtype)
        grad, = torch.autograd.grad((y.float() ** 2).sum() + aux, router)
        outs[name] = (y.detach().float(), aux.detach(), grad)
    (y, aux, g), (y_ref, aux_ref, g_ref) = outs["index"], outs["one-hot"]
    y_ok = bool(((y - y_ref).abs()
                 <= MOE_FORM_Y_RTOL * y_ref.abs() + 2.0 ** -133).all())
    g_rel = float(torch.linalg.vector_norm(g - g_ref)
                  / torch.linalg.vector_norm(g_ref))
    print(f"MoE layer {first}, first {MOE_FORM_TOKENS} tokens: index form "
          f"vs one-hot einsum form: output bit-equal {torch.equal(y, y_ref)} "
          f"(largest |diff| {float((y - y_ref).abs().max()):.3g}, limit one "
          f"bf16 unit), aux {float(aux):.6f} vs {float(aux_ref):.6f}; router "
          f"gradient bit-equal {torch.equal(g, g_ref)}, relative norm error "
          f"{g_rel:.3g} (limit {MOE_FORM_GRAD_TOL})", flush=True)
    check(y_ok and abs(float(aux) - float(aux_ref)) <= 1e-6 * abs(
        float(aux_ref)) and g_rel <= MOE_FORM_GRAD_TOL,
        "the index-form switch FFN matches the one-hot einsum form")


def moe_phase(card: str) -> dict:
    """The switch-MoE transformer (``MoEConfig()``: GPT-2 small widths, 8
    experts every 2nd block, capacity factor 2, random weights from seed
    0) at batch 32 x 1024, ``adamw(3e-4, weight_decay=0.1,
    mu_dtype=bf16)`` and chunked CE, through the captured step."""
    cfg = MoEConfig()
    model = MoETransformer(cfg, seed=0)
    dev = next(model.parameters()).device
    n_params = sum(p.numel() for p in model.parameters())
    toks, tgts = train_batch(cfg.vocab_size)
    batch0 = device_batch(toks, tgts, dev)
    loss = moe_loss_fn(ce_chunk=2048)
    captured = layer_inputs(model, lambda m: loss(m, batch0),
                            set(MOE_CHECK_LAYERS))
    for i, xs in captured.items():
        readings = kernel_readings(*xs)
        print(f"agreement MoE layer {i}: {describe(readings)}", flush=True)
        check_readings(readings, f"on MoE layer {i}'s inputs")
    del captured
    loss_kernel, loss_plain = step0_losses(model, batch0, moe_loss_fn)
    check(np.isfinite(loss_kernel), "MoE step-0 loss finite")
    check(abs(loss_kernel - loss_plain) < STEP0_LOSS_TOL,
          "MoE step-0 loss matches the plain-attention path")
    with torch.no_grad():
        _, aux = model(batch0["tokens"], return_hidden=True)
    print(f"MoE step-0 aux losses per MoE layer {aux.tolist()}", flush=True)
    check(bool(torch.isfinite(aux).all()) and aux.numel() == cfg.n_layer // 2,
          "MoE aux losses finite, one per MoE layer")
    moe_form_check(model, batch0)
    routing0 = moe_routing(model, batch0)
    flops = flops_per_step(model, loss, batch0)
    torch.cuda.empty_cache()

    run = train_run(model, loss, lm_opt(), token_stack(toks, tgts), toks.size,
                    SHORT_TIMED_DISPATCHES, profile_card=card)
    share = flops * run["tok_s"] / toks.size / PEAK_BF16_FLOPS
    print(describe_run(f"MoE ({n_params} params, {cfg.num_experts} experts "
                       f"every {cfg.moe_every}nd block) B={TRAIN_BATCH} "
                       f"T={TRAIN_SEQ} bf16", run, loss_kernel, card)
          + f"; {flops:.4g} FLOPs a step in products (attention not "
          f"counted) = {share:.4f} of the bf16 peak", flush=True)
    print(f"MoE routing at step 0: {routing0}", flush=True)
    print(f"MoE routing after {run['n_steps'] + K_STEPS} steps: "
          f"{moe_routing(model, batch0)}", flush=True)
    check(run["loss_final"] < run["loss_warm"] < loss_kernel,
          "MoE: loss falls on a repeated batch")
    check_counts(run, {name: cfg.n_layer for name in SQUARE}, "MoE")
    return run


def gpt2_small(mesh):
    return GPT2(GPT2Config.small(), seed=0, mesh=mesh)


def mesh_train(mesh, forced: tuple[str, ...], host_batch, what: str,
               make_model=gpt2_small, loss_fn=None, steps: int = CAPTURE_STEPS,
               timed: int = MESH_TIMED_STEPS, before=None) -> dict:
    """``make_model(mesh)`` (GPT-2 124M from seed 0 by default) with the
    LM optimizer through ``make_train_step``: off a mesh (``mesh`` None),
    or placed on ``mesh`` by ``init_train_state`` (after
    ``sharding._place_forced`` over ``forced``: FSDP2, the tp route or the
    ep route on a one-rank axis) with its batch from ``shard_batch``.
    ``before(model, batch)`` runs first, its result kept. ``steps`` steps
    on the batch give the losses and the launch counts (counts set to 0
    just before, read just after); ``timed`` more are timed."""
    model = make_model(mesh)
    dev = next(model.parameters()).device
    if forced:
        _place_forced(model, mesh, forced)
    opt = lm_opt()
    state = init_train_state(model, opt, mesh=mesh)
    step = make_train_step(loss_fn or gpt2_loss_fn(ce_chunk=2048), opt,
                           grad_norm=False)
    batch = (device_batch(*host_batch, dev) if mesh is None else
             shard_batch({"tokens": host_batch[0], "targets": host_batch[1]},
                         mesh))
    seen = before(model, batch) if before else None
    fa.reset_launch_counts()
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(steps)]
    counts = fa.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, metrics = step(state, batch)
    if timed:
        float(metrics["loss"])
    dt = (time.perf_counter() - t0) / max(timed, 1)
    params = list(model.parameters())
    run = {"losses": losses, "counts": counts, "step_ms": dt * 1e3,
           "tok_s": host_batch[0].size / dt,
           "compile_count": compile_count(step),
           "donated": buffers_donated(step, state),
           "sharded": sum(isinstance(p, DTensor) for p in params),
           "before": seen}
    print(f"mesh {what}: {run['sharded']} of {len(params)} parameters "
          f"sharded by FSDP2; first {steps} losses {losses}; step "
          f"{run['step_ms']:.2f} ms, {run['tok_s']:.1f} tokens/s over "
          f"{timed} single steps; compile_count "
          f"{run['compile_count']} "
          f"({'captured' if run['compile_count'] else 'eager'}), buffers "
          f"donated {run['donated']}; launches {counts}", flush=True)
    del model, opt, state, step, batch
    torch.cuda.empty_cache()
    return run


def _all_valid_blocks(t: int, n: int):
    """``models.vit.seq_blocks`` with the fault VIT_FAULTS plants: every
    row of every block taken as valid."""
    block = -(-t // n)
    return block, (block,) * n


class ThreadRing:
    """Rank ``me`` of the ``n`` ranks of a ring run as threads of this
    process, for ``RingAttentionFn``'s own forward and backward (called
    directly: autograd runs every backward of a card on one thread, where
    a rank waiting for its neighbour would hold up that neighbour).
    :meth:`rotate` hands copies of the tensors to rank ``me + 1``'s box;
    its ``wait`` takes what rank ``me - 1`` sent. Only the rank holding
    ``baton`` runs, and it gives it up only while it waits, so the launch
    counters see one rank at a time."""

    def __init__(self, n: int, me: int, boxes, baton: threading.Lock):
        self.n, self.me, self.boxes, self.baton = n, me, boxes, baton

    def rotate(self, tensors, tag: int = 0):
        self.boxes[(self.me + 1) % self.n][tag].put(
            [t.clone() for t in tensors])
        return types.SimpleNamespace(wait=functools.partial(self._take, tag))

    def _take(self, tag: int):
        self.baton.release()
        try:
            return self.boxes[self.me][tag].get(timeout=120)
        finally:
            self.baton.acquire()


def run_ring(qs, ks, vs, dos, scale: float, lengths) -> list[dict]:
    """``RingAttentionFn``'s forward and backward on every rank of a ring
    of ``len(qs)`` ranks, each a thread over a :class:`ThreadRing`:
    rank r's ``[B, t, H, D]`` blocks in, its o, folded lse, dq, dk and dv
    out. ``lengths`` as ``RingAttentionFn`` takes it (None: causal)."""
    n = len(qs)
    boxes = [[queue.Queue() for _ in range(2)] for _ in range(n)]
    baton = threading.Lock()
    out: list = [None] * n
    errors: list = []

    def rank(r: int) -> None:
        with baton:
            try:
                ctx = types.SimpleNamespace()
                ctx.save_for_backward = lambda *t: setattr(
                    ctx, "saved_tensors", t)
                o = RingAttentionFn.forward(ctx, qs[r], ks[r], vs[r],
                                            ThreadRing(n, r, boxes, baton),
                                            scale, lengths)
                dq, dk, dv = RingAttentionFn.backward(ctx, dos[r])[:3]
                out[r] = {"o": o, "lse": ctx.saved_tensors[4], "dq": dq,
                          "dk": dk, "dv": dv}
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out


def ring_check(b: int, t: int, h: int, sp: int, dev, card: str,
               causal: bool = True, strict: bool = True) -> dict:
    """Ring attention at ``[B, T, H, D]`` on ``sp`` ranks, every rank's
    ``RingAttentionFn`` forward and backward in this process
    (:func:`run_ring`). Causal (``ring_attention``): T in ``sp`` equal
    blocks; each rank runs its hops against the blocks at or before its
    own. Else bidirectional (``_bidir_ring_attention``, ViT on ``sp``):
    the sequence padded to ``sp`` blocks of ``models.vit.seq_blocks``'
    length, the padded rows random (as a model leaves them: anything) and
    their output gradient 0; each rank's padded queries against every
    block's valid rows. o, lse, dq, dk and dv of the valid rows are held
    against the plain whole attention by ``agreement``; the launches of
    all ranks together are one of each square kernel per hop (causal) or
    of each non-causal rectangle kernel per rank and block with a valid
    row, and nothing else. Then the hops' kernels, summed over the ranks,
    are timed beside the unsplit kernels. Returns ``{"ok", "counts"}``:
    whether every check held (``strict``: raise if not) and the launches
    of all ranks."""
    if causal:
        block, lengths = t // sp, None
        valid = [block] * sp
        hops = sp * (sp + 1) // 2
        routes = SQUARE
    else:
        block, lengths = vit_model.seq_blocks(t, sp)
        valid = [max(0, min(block, t - r * block)) for r in range(sp)]
        hops = sp * sum(1 for n in lengths if n)
        routes = NC_RECT
    gen = torch.Generator(device=dev).manual_seed(t + (h if causal else sp))
    q, k, v, do = (torch.randn(b, block * sp, h, D, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    do[:, t:] = 0
    scale = D ** -0.5
    qs, ks, vs, dos = ([x[:, r * block:(r + 1) * block].contiguous()
                        for r in range(sp)] for x in (q, k, v, do))
    fa.reset_launch_counts()
    ranks = run_ring(qs, ks, vs, dos, scale, lengths)
    counts = fa.launch_counts()
    counts_ok = all(c == (hops if n in routes else 0)
                    for n, c in counts.items())
    got = {name: torch.cat([fold4(x[name])[:, :n]
                            for x, n in zip(ranks, valid)], 1)
           for name in ("o", "dq", "dk", "dv")}
    qw, kw, vw, dow = (fold4(x[:, :t]) for x in (q, k, v, do))
    o_ref, lse_ref = fa.flash_fwd_reference(qw, kw, vw, scale, causal)
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(qw, kw, vw, o_ref,
                                                    lse_ref, dow, scale,
                                                    causal)
    want = {"o": o_ref, "dq": dq_ref, "dk": dk_ref, "dv": dv_ref}
    what = "ring" if causal else "bidirectional ring"
    readings = {what: {n: fa.agreement(got[n], want[n]) for n in got}}
    lse_err = float((torch.cat([x["lse"][:, :n] for x, n in
                                zip(ranks, valid)], 1) - lse_ref)
                    .abs().max())
    readings[what]["lse"] = {"max_abs_err": lse_err, "ok": lse_err < LSE_TOL}
    ok = counts_ok and all(r["ok"] for r in readings[what].values())
    shape = (f"sp={sp} B={b} T={t} H={h}" + ("" if causal else
             f" (blocks of {block}, valid rows {valid}, the hops read "
             f"{list(lengths)})"))
    print(f"{what} {shape}, RingAttentionFn on {sp} ranks as threads: "
          f"{describe(readings)}; launches of all ranks {counts}, "
          f"{hops} of each of {list(routes)} and no other: {counts_ok}; "
          f"card {card}", flush=True)
    if strict:
        check(counts_ok, f"{what} sp={sp}: launches of all ranks")
        check_readings(readings, f"for the {what} at {shape}")
    if not ok:
        return {"ok": ok, "counts": counts}
    del o_ref, dq_ref, dk_ref, dv_ref, want
    torch.cuda.empty_cache()

    fq, fk, fv, fdo = ([fold4(x) for x in xs] for xs in (qs, ks, vs, dos))
    lses = [x["lse"] for x in ranks]
    deltas = [(fold4(x["o"]).float() * fdo[r].float()).sum(-1)
              for r, x in enumerate(ranks)]
    pairs = [(r, c) for r in range(sp) for c in range(sp)
             if (c <= r if causal else lengths[c])]

    def ring_hops(name: str, bwd: bool):
        def run():
            for r, c in pairs:
                tk = block if causal else lengths[c]
                rows = (fdo[r], lses[r], deltas[r]) if bwd else ()
                WRAPPERS[name](fq[r], fk[c][:, :tk], fv[c][:, :tk], *rows,
                               scale, *((c == r,) if causal else ()))
        return run

    o_w, lse_w = fa.flash_fwd(qw, kw, vw, scale, causal)
    delta_w = (o_w.float() * dow.float()).sum(-1)
    whole = (lambda: fa.flash_fwd(qw, kw, vw, scale, causal),
             lambda: fa.flash_bwd_dq(qw, kw, vw, dow, lse_w, delta_w, scale,
                                     causal),
             lambda: fa.flash_bwd_dkv(qw, kw, vw, dow, lse_w, delta_w, scale,
                                      causal))
    times = {n: (cuda_ms(ring_hops(n, i > 0), 5), cuda_ms(whole[i], 5))
             for i, n in enumerate(routes)}
    both = [sum(t_[i] for t_ in times.values()) for i in (0, 1)]
    print(f"{what} {shape} kernel time, the {len(pairs)} hops of the {sp} "
          f"ranks summed vs the unsplit {'causal' if causal else 'non-causal'}"
          f" kernels at T={t}: " + "; ".join(
              f"{n} {a:.3f} ms vs {w:.3f} ms" for n, (a, w) in times.items())
          + f"; all {both[0]:.3f} ms vs {both[1]:.3f} ms "
          f"({both[0] / both[1]:.3f}x); card {card}", flush=True)
    return {"ok": ok, "counts": counts}


def exchange_check(mesh, dev) -> None:
    """The exchange ops at world 1: Ulysses (all_to_all over the mesh's
    ``sp`` group, then causal_attention) equal to causal_attention bit for
    bit, forward and gradients, at GPT-2's attention shape; ``moe_ffn``
    over the ``ep`` group equal to the one-hot einsum form within one bf16
    unit, at ``MoEConfig()``'s width on MOE_FORM_TOKENS tokens."""
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (TRAIN_BATCH, TRAIN_SEQ, H, D)
    q, k, v, dy = (torch.randn(shape, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    outs = {}
    for name, fn in (("ulysses", functools.partial(ulysses_attention,
                                                   mesh=mesh)),
                     ("causal", causal_attention)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        y = fn(*leaves)
        y.backward(dy)
        outs[name] = [y.detach()] + [x.grad for x in leaves]
    same = [torch.equal(a, b) for a, b in zip(outs["ulysses"],
                                              outs["causal"])]
    print(f"Ulysses at world 1 vs causal_attention, B={TRAIN_BATCH} "
          f"T={TRAIN_SEQ} H={H}: bit-equal (out, dq, dk, dv) {same}",
          flush=True)
    check(all(same), "Ulysses at world 1 equals causal_attention bit for bit")

    cfg = MoEConfig()
    d, e = cfg.n_embd, cfg.num_experts
    x = torch.randn(MOE_FORM_TOKENS, d, device=dev, generator=gen) \
        .to(cfg.dtype)
    router, w_up, w_down = (
        torch.empty(shape_, device=dev).normal_(0.0, 0.02, generator=gen)
        for shape_ in ((d, e), (e, d, 4 * d), (e, 4 * d, d)))
    y, aux = moe_ffn(x, router, w_up, w_down, group=mesh.group("ep"),
                     capacity_factor=cfg.capacity_factor, dtype=cfg.dtype)
    y_ref, aux_ref = dense_switch_ffn_reference(
        x, router, w_up, w_down, capacity_factor=cfg.capacity_factor,
        dtype=cfg.dtype)
    y, y_ref = y.float(), y_ref.float()
    y_ok = bool(((y - y_ref).abs()
                 <= MOE_FORM_Y_RTOL * y_ref.abs() + 2.0 ** -133).all())
    print(f"moe_ffn over an ep group of 1 vs the one-hot einsum form, "
          f"{MOE_FORM_TOKENS} tokens x {d}, {e} experts: bit-equal "
          f"{torch.equal(y, y_ref)}, largest |diff| "
          f"{float((y - y_ref).abs().max()):.3g} (limit one bf16 unit), aux "
          f"{float(aux):.6f} vs {float(aux_ref):.6f}", flush=True)
    check(y_ok and abs(float(aux) - float(aux_ref))
          <= 1e-6 * abs(float(aux_ref)),
          "moe_ffn at ep = 1 matches the one-hot einsum form")


def mesh_phase(main_run: dict, card: str) -> tuple:
    """The port's mesh on one card: a one-rank NCCL group and a mesh with
    every axis of size 1. (a) GPT-2 124M on ``dp = 1`` through
    ``init_train_state(mesh=)``, ``shard_batch`` and the captured step,
    the gradient all-reduce inside the graph, against the same step off
    the mesh; (b) the same under FSDP2 (``fsdp = 1``); (c) ring attention's
    hops through the kernels at GPT-2's and TinyLlama's attention shapes;
    (c') the bidirectional ring's hops (ViT on ``sp``) at ViT-B/16's; (d)
    Ulysses and ``moe_ffn`` over their groups at world 1; (e) the
    multi-rank dry run, which :func:`tp_phase` runs last. Returns the mesh
    and the mesh-less run, and the launches of (c')'s bidirectional
    rings."""
    dev = initialize()
    mesh = make_mesh({"dp": 1})
    print(f"mesh: {mesh} over a {dist.get_backend()} group of "
          f"{dist.get_world_size()}", flush=True)
    host = train_batch(GPT2Config.small().vocab_size)
    plain = mesh_train(None, (), host, "off (mesh-less captured step)")
    dp = mesh_train(mesh, (), host, "dp=1 (gradient all-reduce in the "
                    "step)")
    rel = max(abs(a - b) / abs(b) for a, b in zip(dp["losses"],
                                                  plain["losses"]))
    overhead = dp["step_ms"] / plain["step_ms"] - 1
    over_phase4 = dp["step_ms"] / main_run["step_ms"] - 1
    print(f"mesh dp=1 vs mesh-less: first {CAPTURE_STEPS} losses bit-equal "
          f"{dp['losses'] == plain['losses']}, largest relative difference "
          f"{rel:.3g} (limit {CAPTURE_LOSS_RTOL}); step {dp['step_ms']:.2f} "
          f"ms vs {plain['step_ms']:.2f} ms ({overhead:+.2%}); phase 4's "
          f"step {main_run['step_ms']:.2f} ms, {main_run['tok_s']:.1f} "
          f"tokens/s (dp=1 {over_phase4:+.2%} over it); card {card}",
          flush=True)
    check(rel <= CAPTURE_LOSS_RTOL, "mesh dp=1: the first losses match the "
          "mesh-less step's")
    want_captures = 1 if CAPTURE else None
    check(dp["compile_count"] == want_captures and dp["donated"],
          f"mesh dp=1: captured {want_captures} time(s), buffers donated")
    n = GPT2Config.small().n_layer
    check_counts({"n_steps": CAPTURE_STEPS, "counts": dp["counts"]},
                 {name: n for name in SQUARE}, "mesh dp=1")

    fsdp = mesh_train(mesh, ("fsdp",), host, "fsdp=1 (FSDP2)")
    rel0 = abs(fsdp["losses"][0] - dp["losses"][0]) / abs(dp["losses"][0])
    print(f"mesh fsdp=1: step-0 loss {fsdp['losses'][0]} vs dp=1 "
          f"{dp['losses'][0]}, relative difference {rel0:.3g} (limit "
          f"{CAPTURE_LOSS_RTOL}); the step was "
          f"{'captured' if fsdp['compile_count'] else 'run eagerly'} "
          "(FSDP2 steps run eagerly by rule)", flush=True)
    check(rel0 <= CAPTURE_LOSS_RTOL, "mesh fsdp=1: step-0 loss matches dp=1")
    check(fsdp["sharded"] > 0 and fsdp["compile_count"] is None,
          "mesh fsdp=1: FSDP2 sharded parameters and compile_count is None "
          "(the FSDP2 step runs eagerly by rule)")
    check_counts({"n_steps": CAPTURE_STEPS, "counts": fsdp["counts"]},
                 {name: n for name in SQUARE}, "mesh fsdp=1")

    for b, t, h in RING_SHAPES:
        ring_check(b, t, h, RING_SP, dev, card)
    t = ViTConfig.base().num_patches + 1
    bidir = {sp: ring_check(VIT_BATCH, t, H, sp, dev, card, causal=False)
             for sp in VIT_SP}
    exchange_check(mesh, dev)
    return mesh, plain, bidir


def check_losses(got: dict, want: dict, what: str) -> float:
    """``got``'s first losses against ``want``'s within CAPTURE_LOSS_RTOL;
    the largest relative difference."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                  want["losses"],
                                                  strict=True))
    print(f"{what}: losses {got['losses']} vs {want['losses']}, bit-equal "
          f"{got['losses'] == want['losses']}, largest relative difference "
          f"{rel:.3g} (limit {CAPTURE_LOSS_RTOL}); step {got['step_ms']:.2f} "
          f"ms vs {want['step_ms']:.2f} ms "
          f"({got['step_ms'] / want['step_ms'] - 1:+.2%})", flush=True)
    check(rel <= CAPTURE_LOSS_RTOL, f"{what}: the losses match")
    return rel


def moe_dropped(model, batch) -> list[float]:
    """Each MoE layer's dropped share at the model's weights on ``batch``
    (``moe_routes``: global routing on a mesh)."""
    return [1.0 - float(route.kept.float().mean())
            for route in moe_routes(model, batch).values()]


def tp_kernel_inputs(b: int, t: int, h: int, kv: int, dev):
    """q, do ``[B*h, T, D]`` and k, v of ``kv`` heads each repeated to h
    (GQA's repeat on a tp rank), folded, bf16."""
    gen = torch.Generator(device=dev).manual_seed(t + h + kv)
    q, do = (torch.randn(b * h, t, D, device=dev, generator=gen)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, kv, t, D, device=dev, generator=gen)
            .to(torch.bfloat16).repeat_interleave(h // kv, dim=1)
            .reshape(b * h, t, D) for _ in range(2))
    return q, k, v, do


def pipeline_check(mesh, host, card: str) -> None:
    """(e) ``spmd_pipeline`` at ``pp = 1``: GPT-2 124M's 12 blocks as the
    stage, PIPE_MICROBATCHES microbatches of the training batch, then
    ``ln_f`` and the chunked CE. The loss against the plain block stack on
    the whole batch; every block gradient against the plain stack run on
    the same microbatches one after another (each microbatch's weight
    gradients are rounded to bf16 before they are summed, on both), and,
    at a looser limit, against the whole batch's."""
    model = gpt2_small(None)
    batch = device_batch(*host, mesh.device)
    dt = model.config.dtype

    def stack(x):
        return functools.reduce(lambda a, blk: blk(a, model.attn_fn),
                                model.h, x)

    pipe = spmd_pipeline(lambda blocks, x: stack(x), PIPE_MICROBATCHES,
                         mesh=mesh)
    variants = {
        "pipeline": lambda x: pipe(model.h, x),
        "plain, microbatched": lambda x: torch.cat(
            [stack(m) for m in x.chunk(PIPE_MICROBATCHES)]),
        "plain, whole batch": stack}
    params = list(model.h.parameters())
    out = {}
    for name, run in variants.items():
        for _ in range(2):                  # the second run is timed
            fa.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = F.embedding(batch["tokens"], model.wte.weight.to(dt)) \
                + model.wpe.weight[:TRAIN_SEQ].to(dt)
            loss = chunked_cross_entropy(model.ln_f(run(x)), model.wte.weight,
                                         batch["targets"])
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            out[name] = (float(loss.detach()), grads,
                         time.perf_counter() - t0,
                         fa.launch_counts())
            del x, loss, grads

    def grad_err(a: str, b: str) -> float:
        return max(float(torch.linalg.vector_norm(x.float() - y.float())
                         / torch.linalg.vector_norm(y.float()))
                   for x, y in zip(out[a][1], out[b][1]))

    lp, _, tp_, cp = out["pipeline"]
    lw, _, tw, _ = out["plain, whole batch"]
    rel = abs(lp - lw) / abs(lw)
    g_micro = grad_err("pipeline", "plain, microbatched")
    g_whole = grad_err("pipeline", "plain, whole batch")
    rows = TRAIN_BATCH // PIPE_MICROBATCHES
    print(f"pipeline pp=1, GPT-2 124M's {len(model.h)} blocks as the stage, "
          f"{PIPE_MICROBATCHES} microbatches of {rows}x{TRAIN_SEQ}: loss "
          f"{lp} vs the plain whole batch's {lw} (relative {rel:.3g}, limit "
          f"{PIPE_LOSS_RTOL}); largest block gradient relative norm error "
          f"{g_micro:.3g} against the plain stack on the same microbatches "
          f"(limit {PIPE_GRAD_RTOL}), {g_whole:.3g} against the whole batch "
          f"(limit {PIPE_WHOLE_GRAD_RTOL}: bf16 weight gradients rounded per "
          f"microbatch); "
          f"forward+backward {tp_ * 1e3:.1f} ms, plain microbatched "
          f"{out['plain, microbatched'][2] * 1e3:.1f} ms, plain whole "
          f"{tw * 1e3:.1f} ms (host clock, eager, second run); launches "
          f"{cp}; card {card}", flush=True)
    check(rel <= PIPE_LOSS_RTOL and g_micro <= PIPE_GRAD_RTOL
          and g_whole <= PIPE_WHOLE_GRAD_RTOL,
          "spmd_pipeline at pp=1 matches the plain block stack")
    check(all(cp[k] == PIPE_MICROBATCHES * len(model.h) for k in SQUARE),
          "the pipeline ran each block's kernels once a microbatch")
    del model, out, params
    torch.cuda.empty_cache()


def checkpoint_check(mesh, host, card: str) -> None:
    """(f) GPT-2 124M on the tp route: its state saved after 2 steps and
    restored into a fresh state of other weights; the next 2 losses
    against the uninterrupted run's, bit for bit."""
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        runs = {}
        for name in ("uninterrupted", "restored"):
            model = GPT2(GPT2Config.small(), seed=int(name == "restored"),
                         mesh=mesh)
            _place_forced(model, mesh, ("tp",))
            opt = lm_opt()
            state = init_train_state(model, opt, mesh=mesh)
            step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                                   grad_norm=False)
            batch = shard_batch({"tokens": host[0], "targets": host[1]},
                                mesh)
            t0 = time.perf_counter()
            if name == "restored":
                restore_train_state(directory, state)
            else:
                for _ in range(2):
                    step(state, batch)
                save_train_state(state, directory)
            torch.cuda.synchronize()
            io_s = time.perf_counter() - t0
            at = state.step
            runs[name] = ([float(step(state, batch)[1]["loss"])
                           for _ in range(2)], at, io_s)
            del model, opt, state, step, batch
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    (want, at_w, save_s), (got, at_g, load_s) = (runs["uninterrupted"],
                                                 runs["restored"])
    print(f"checkpoint, GPT-2 124M on the tp route: losses after restore "
          f"{got} vs uninterrupted {want}, bit-equal {got == want}; step "
          f"{at_g} restored ({at_w} saved); 2 steps + save {save_s:.2f} s, "
          f"restore {load_s:.2f} s (host clock); card {card}", flush=True)
    check(got == want and at_g == at_w == 2,
          "the restored state's next losses equal the uninterrupted run's")


def vision_tp_check(mesh, card: str) -> None:
    """(h) ViT-B/16 and ResNet-50 at batch 128 with the tp route forced on
    the one-rank ``tp`` axis against the mesh-less captured step from the
    same weights on the same images."""
    want_captures = 1 if CAPTURE else None
    for name, make, loss_fn, make_opt, keys, has_extra in (
            ("ViT-B/16", lambda m: ViT(ViTConfig.base(), seed=0, mesh=m),
             vit_loss_fn(), lambda: adamw(3e-3), ("images", "labels"),
             False),
            ("ResNet-50", lambda m: ResNet(ResNet50Config(), seed=0, mesh=m),
             resnet_loss_fn(), lambda: sgd(0.1, momentum=0.9, nesterov=True),
             ("image", "label"), True)):
        host = multicard.image_batch(VIT_BATCH, IMAGE_SIZE, 1000, keys)
        runs = {}
        for what, m in (("mesh-less", None), ("tp=1", mesh)):
            model = make(m)
            if m is not None:
                _place_forced(model, m, ("tp",))
            batch = (shard_batch(host, m) if m is not None else
                     {k: torch.from_numpy(v).to(mesh.device)
                      for k, v in host.items()})
            runs[what] = multicard.run_steps(
                model, loss_fn, make_opt(), batch, m, CAPTURE_STEPS,
                MESH_TIMED_STEPS, has_extra=has_extra)
            del model, batch
            torch.cuda.empty_cache()
        got, want = runs["tp=1"], runs["mesh-less"]
        check_losses(got, want, f"mesh tp=1 (the tp route forced) vs "
                     f"mesh-less {name}")
        check(got["compile_count"] == want_captures and got["donated"],
              f"{name} tp=1: captured {want_captures} time(s), buffers "
              "donated")
        if has_extra:
            same = all(torch.equal(got["stats"][k], want["stats"][k])
                       for k in want["stats"])
            print(f"{name} tp=1: running statistics equal to the mesh-less "
                  f"step's {same}; card {card}", flush=True)
            check(same, f"{name} tp=1: the running statistics match")


def tp_phase(mesh, plain: dict, card: str) -> dict[str, dict]:
    """Phase 13: tensor parallelism, the MoE transformer's global routing
    over ``dp × ep``, the pipeline and checkpoints on the one-rank NCCL
    mesh of phase 12, at full width; then the multi-rank dry run. Returns
    the kernels' readings at the tp-local head counts."""
    dev = mesh.device
    n = GPT2Config.small().n_layer
    host = train_batch(GPT2Config.small().vocab_size)
    want_captures = 1 if CAPTURE else None
    # (a) GPT-2 124M on the tp route.
    tp = mesh_train(mesh, ("tp",), host, "tp=1 (the tp route forced: "
                    "copy_to/reduce_from, vocab-parallel lookup and CE)")
    check_losses(tp, plain, "mesh tp=1 vs mesh-less GPT-2 124M")
    check(tp["compile_count"] == want_captures and tp["donated"],
          f"mesh tp=1: captured {want_captures} time(s), buffers donated")
    check_counts({"n_steps": CAPTURE_STEPS, "counts": tp["counts"]},
                 {name: n for name in SQUARE}, "mesh tp=1")

    # (b) TinyLlama 1.1B on the tp route, step 0.
    llama_host = train_batch(LlamaConfig.tinyllama_1b().vocab_size,
                             LLAMA_BATCH, LLAMA_SEQ)
    runs = {}
    for what, m, forced in (("mesh-less", None, ()),
                            ("tp=1", mesh, ("tp",))):
        runs[what] = mesh_train(
            m, forced, llama_host, f"TinyLlama 1.1B {what}",
            make_model=lambda mm: Llama(LlamaConfig.tinyllama_1b(), seed=0,
                                        mesh=mm),
            loss_fn=llama_loss_fn(ce_chunk=2048), steps=1, timed=1)
    check_losses(runs["tp=1"], runs["mesh-less"],
                 "mesh tp=1 vs mesh-less TinyLlama 1.1B, step 0")
    check_counts({"n_steps": 1, "counts": runs["tp=1"]["counts"]},
                 {name: LlamaConfig.tinyllama_1b().n_layer
                  for name in SQUARE}, "TinyLlama tp=1")

    # (c) The MoE transformer's global routing on dp x ep.
    moe = {}
    for what, m, forced in (("mesh-less", None, ()),
                            ("dp=1 x ep=1", mesh, ("ep",))):
        moe[what] = mesh_train(
            m, forced, host, f"MoE {what}",
            make_model=lambda mm: MoETransformer(MoEConfig(), seed=0,
                                                 mesh=mm),
            loss_fn=moe_loss_fn(ce_chunk=2048), timed=2, before=moe_dropped)
    got, want = moe["dp=1 x ep=1"], moe["mesh-less"]
    check_losses(got, want, "mesh dp=1 x ep=1 (global routing, the ep "
                 "combine) vs mesh-less MoE")
    print(f"MoE dropped share per MoE layer at step 0: global routing "
          f"{got['before']}, mesh-less {want['before']}", flush=True)
    check(got["before"] == want["before"], "MoE: each layer's dropped share "
          "at step 0 equals the mesh-less routing's")
    check_counts({"n_steps": CAPTURE_STEPS, "counts": got["counts"]},
                 {name: n for name in SQUARE}, "MoE dp x ep")

    # (d) The kernels at tp-local head counts.
    rows = {}
    for b, t, h, kv, what in TP_KERNEL_SHAPES:
        q, k, v, do = tp_kernel_inputs(b, t, h, kv, dev)
        readings = kernel_readings(q, k, v, do)
        print(f"agreement {what}: {describe(readings)}", flush=True)
        check_readings(readings, f"at {what}")
        rows[what] = kernel_times(b, q, k, v, do, readings, what)
        del q, k, v, do
    torch.cuda.empty_cache()

    pipeline_check(mesh, host, card)
    checkpoint_check(mesh, host, card)
    vision_tp_check(mesh, card)
    dist.destroy_process_group()

    # (g) = phase 12 (e): the dry run, no device named.
    t0 = time.perf_counter()
    ranks = dryrun_multichip(1)
    print(f"mesh dryrun_multichip(1), no device named: {ranks} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(len(ranks) == 1 and ranks[0]["device"] == "cuda:0"
          and ranks[0]["factors"] == {"dp": 1, "sp": 1, "tp": 1}
          and np.isfinite(ranks[0]["loss"]),
          "dryrun_multichip(1) runs one NCCL rank on the card by default")
    return rows


# -- phase 14: the runtime and the trainer ---------------------------------


def fresh_driver() -> dict:
    """(a) ``ray_tpu_torch.init()`` in a new process: its ``GPU``
    resource, and whether it loaded torch (a process that never imports
    torch holds no CUDA context)."""
    code = ("import json, sys, time\n"
            "t0 = time.perf_counter()\n"
            "import ray_tpu_torch as rt\n"
            "rt.init()\n"
            "out = {'init_s': time.perf_counter() - t0,\n"
            "       'GPU': rt.cluster_resources().get('GPU', 0.0),\n"
            "       'torch': 'torch' in sys.modules}\n"
            "rt.shutdown()\n"
            "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"a fresh driver's init(): {proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def gpu_probe() -> dict:
    """What a task sees of the card (run in a runtime worker)."""
    import ray_tpu_torch
    return {"cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count(),
            "gpu_ids": ray_tpu_torch.get_gpu_ids()}


def echo(x):
    return x


def tensor_bytes(x) -> int:
    return x.numel() * x.element_size()


def noop():
    return None


class Pinger:
    """The actor of the host rate of actor calls."""

    def ping(self):
        return None


def numpy_weights(model) -> dict:
    return {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}


def load_weights(model, weights: dict) -> None:
    """``numpy_weights``' arrays into ``model`` (a copy of each array the
    object store handed out read-only)."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.require(weights[n],
                                                requirements="W")))


def gpt2_steps(model, host, steps: int, timed: int, capture: bool,
               save_to: str | None = None, report=None,
               restore_from: str | None = None) -> dict:
    """GPT-2 on the host batch ``host`` through ``make_train_step`` with
    the LM optimizer, off a mesh: the train state restored from
    ``restore_from`` when given (``restore_s``); ``steps`` steps give the
    losses and the launch counts (counts set to 0 just before, read just
    after), each passed to ``report`` when given; the state is saved to
    ``save_to`` when given (``save_s``) and one more step's loss kept
    (``next_loss``); ``timed`` more steps are timed on the host clock.
    The same code runs in this process, in a runtime actor, in a
    TorchTrainer worker and in a workflow step."""
    dev = next(model.parameters()).device
    opt = lm_opt()
    state = init_train_state(model, opt)
    run = {"losses": []}
    if restore_from is not None:
        t0 = time.perf_counter()
        restore_train_state(restore_from, state)
        run["restore_s"] = time.perf_counter() - t0
    step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                           grad_norm=False)
    batch = device_batch(*host, dev)
    with contextlib.nullcontext() if capture else disable_capture():
        fa.reset_launch_counts()
        for _ in range(steps):
            run["losses"].append(float(step(state, batch)[1]["loss"]))
            if report is not None:
                report({"loss": run["losses"][-1], "t": time.time()})
        run["counts"] = fa.launch_counts()
        if save_to is not None:
            t0 = time.perf_counter()
            save_train_state(state, save_to)
            run["save_s"] = time.perf_counter() - t0
            run["next_loss"] = float(step(state, batch)[1]["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, metrics = step(state, batch)
        if timed:
            float(metrics["loss"])
        run["step_ms"] = (time.perf_counter() - t0) / max(timed, 1) * 1e3
    run["compile_count"] = compile_count(step)
    run["donated"] = buffers_donated(step, state)
    return run


class GPT2Actor:
    """A runtime actor that trains GPT-2 124M on the card it holds."""

    def train(self, weights: dict, host, steps: int, timed: int,
              capture: bool) -> dict:
        t0 = time.perf_counter()
        model = GPT2(GPT2Config.small(), seed=1)    # other weights ...
        load_weights(model, weights)                # ... replaced
        run = gpt2_steps(model, host, steps, timed, capture)
        run["setup_s"] = time.perf_counter() - t0
        run["pid"] = os.getpid()
        return run


def trainer_loop(config: dict) -> None:
    """TorchTrainer's loop: one NCCL rank (``parallel.initialize``),
    GPT-2 124M from the weights in the object store, the steps of
    ``gpt2_steps`` reported one by one, the train state checkpointed."""
    import ray_tpu_torch
    from ray_tpu_torch import train
    t_start = time.time()
    dev = initialize()
    model = GPT2(GPT2Config.small(), seed=1, device=dev)
    load_weights(model, ray_tpu_torch.get(config["weights"]))
    t_weights = time.time()
    # report() copies the checkpoint into the trial directory before it
    # returns; the loop's own copy goes with the block.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as d:
        run = gpt2_steps(model, config["host"], config["steps"],
                         config["timed"], config["capture"],
                         save_to=os.path.join(d, "state"),
                         report=train.report)
        train.report({"loss": run["losses"][-1],
                      "next_loss": run["next_loss"],
                      "step_ms": run["step_ms"], "counts": run["counts"],
                      "compile_count": run["compile_count"],
                      "donated": run["donated"],
                      "backend": dist.get_backend(), "device": str(dev),
                      "t_start": t_start, "t_weights": t_weights,
                      "t": time.time()},
                     checkpoint=train.Checkpoint.from_directory(d))


def runtime_phase(card: str) -> dict:
    """Phase 14: the port's runtime on the card and TorchTrainer on it.
    Returns fit()'s time to the first report and its whole time."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    libs = {name: os.path.getmtime(build.lib_path(name))
            for name in build.sources()}
    n = GPT2Config.small().n_layer
    want_captures = 1 if CAPTURE else None

    # (a) Resources.
    fresh = fresh_driver()
    print(f"runtime (a) a fresh driver's init(): GPU resource "
          f"{fresh['GPU']}, torch imported {fresh['torch']}, "
          f"{fresh['init_s']:.3f} s; card {card}", flush=True)
    check(fresh["GPU"] == torch.cuda.device_count() and not fresh["torch"],
          "init() counts the card as GPU and imports no torch")
    t0 = time.perf_counter()
    rt.init()
    init_s = time.perf_counter() - t0
    res = rt.cluster_resources()
    check(res.get("GPU") == torch.cuda.device_count(),
          f"cluster_resources GPU {res.get('GPU')}")
    probe = rt.remote(gpu_probe)
    # Both first calls at once: their workers start together.
    t0 = time.perf_counter()
    cpu_ref, gpu_ref = probe.remote(), probe.options(num_gpus=1).remote()
    cpu = rt.get(cpu_ref)
    first_cpu_s = time.perf_counter() - t0
    gpu = rt.get(gpu_ref)
    first_gpu_s = time.perf_counter() - t0
    print(f"runtime (a) init {init_s:.3f} s, resources {res}; a plain task "
          f"sees {cpu} (first call {first_cpu_s:.2f} s, the worker's start "
          f"and torch's import included); a num_gpus=1 task sees {gpu} "
          f"({first_gpu_s:.2f} s, issued with the first); card {card}",
          flush=True)
    check(cpu == {"cuda_visible": "", "device_count": 0, "gpu_ids": []},
          "a plain task sees no GPU")
    check(gpu["device_count"] == 1 and gpu["gpu_ids"] == [0]
          and gpu["cuda_visible"] == "0",
          "a num_gpus=1 task sees its card, and only it, as [0]")

    # (c) first: the in-process reference, then its memory freed.
    cfg = GPT2Config.small()
    host = train_batch(cfg.vocab_size)
    model = GPT2(cfg, seed=0)
    weights = numpy_weights(model)
    wte = model.wte.weight.detach().to(torch.bfloat16)
    ref_run = gpt2_steps(model, host, CAPTURE_STEPS, MESH_TIMED_STEPS,
                         CAPTURE)
    del model
    torch.cuda.empty_cache()

    # (b) Objects: a bf16 tensor on the card through put/get.
    nbytes = wte.numel() * wte.element_size()
    t0 = time.perf_counter()
    wte_ref = rt.put(wte)
    t1 = time.perf_counter()
    back = rt.get(wte_ref)
    t2 = time.perf_counter()
    trips = []                  # the first round trip, then steady state
    for _ in range(2):
        t3 = time.perf_counter()
        via_task = rt.get(rt.remote(echo).remote(wte_ref))
        trips.append(time.perf_counter() - t3)
    as_argument = rt.get(rt.remote(echo).remote(wte))   # no put
    into = []                   # the tensor in, nothing back
    for _ in range(2):
        t3 = time.perf_counter()
        check(rt.get(rt.remote(tensor_bytes).remote(wte_ref)) == nbytes,
              "a CPU task reads the whole tensor")
        into.append(time.perf_counter() - t3)
    for got in (back, via_task, as_argument):
        check(isinstance(got, torch.Tensor) and got.device.type == "cpu"
              and got.dtype == torch.bfloat16 and got.shape == wte.shape
              and torch.equal(got.view(torch.int16),
                              wte.cpu().view(torch.int16)),
              "the CUDA bf16 tensor comes back a CPU tensor, bit-equal")
    mb = nbytes / 1e6
    print(f"runtime (b) wte {tuple(wte.shape)} bf16 on the card, {mb:.1f} "
          f"MB: put {mb / (t1 - t0):.1f} MB/s (the copy to the host "
          f"included), get {mb / (t2 - t1):.1f} MB/s, through a CPU task "
          f"and back {mb / trips[0]:.1f} MB/s the first time, "
          f"{mb / trips[1]:.1f} MB/s the second (the return rides the "
          f"exec socket); into a CPU task with nothing back "
          f"{into[0] * 1e3:.1f} ms, then {into[1] * 1e3:.1f} ms (mapped "
          f"from shared memory, one host copy); as a task's argument too; "
          f"bit-equal CPU tensors; "
          f"card {card}", flush=True)
    del wte, back, via_task, as_argument

    # (c) A num_gpus=1 actor trains from the same weights.
    weights_ref = rt.put(weights)
    del weights
    t0 = time.perf_counter()
    actor = rt.remote(num_gpus=1)(GPT2Actor).remote()
    run_ref = actor.train.remote(weights_ref, host, CAPTURE_STEPS,
                                 MESH_TIMED_STEPS, CAPTURE)
    waiting = probe.options(num_gpus=1).remote()
    ready, _ = rt.wait([waiting], timeout=RUNTIME_WAIT_S)
    check(not ready, "a second num_gpus=1 task waits while the actor holds "
          "the card")
    actor_run = rt.get(run_ref)
    actor_s = time.perf_counter() - t0
    rt.kill(actor)
    after = rt.get(waiting, timeout=300)
    check(after["gpu_ids"] == [0], "the waiting task ran once the actor "
          "was gone")
    rel = max(abs(a - b) / abs(b) for a, b in zip(actor_run["losses"],
                                                  ref_run["losses"],
                                                  strict=True))
    print(f"runtime (c) GPT-2 124M B={TRAIN_BATCH} T={TRAIN_SEQ} in a "
          f"num_gpus=1 actor (pid {actor_run['pid']}): losses "
          f"{actor_run['losses']} vs in-process {ref_run['losses']}, "
          f"bit-equal {actor_run['losses'] == ref_run['losses']}, largest "
          f"relative difference {rel:.3g} (limit {CAPTURE_LOSS_RTOL}); step "
          f"{actor_run['step_ms']:.2f} ms vs in-process "
          f"{ref_run['step_ms']:.2f} ms "
          f"({actor_run['step_ms'] / ref_run['step_ms'] - 1:+.2%}) over "
          f"{MESH_TIMED_STEPS} steps; compile_count "
          f"{actor_run['compile_count']}; launches {actor_run['counts']}; "
          f"actor created to result {actor_s:.1f} s (its model built and "
          f"trained in {actor_run['setup_s']:.1f} s); a second num_gpus=1 "
          f"task waited; card {card}", flush=True)
    check(rel <= CAPTURE_LOSS_RTOL, "the actor's losses match the "
          "in-process step's")
    check(actor_run["compile_count"] == want_captures
          and actor_run["donated"], f"the actor's step captured "
          f"{want_captures} time(s), buffers donated")
    check_counts({"n_steps": CAPTURE_STEPS, "counts": actor_run["counts"]},
                 {name: n for name in SQUARE}, "the runtime actor")

    # (d) TorchTrainer.fit() with one NCCL worker on the card.
    storage = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        trainer = TorchTrainer(
            trainer_loop,
            train_loop_config={"weights": weights_ref, "host": host,
                               "steps": CAPTURE_STEPS,
                               "timed": MESH_TIMED_STEPS,
                               "capture": CAPTURE},
            scaling_config=ScalingConfig(num_workers=1, gpus_per_worker=1),
            run_config=RunConfig(name="gpt2", storage_path=storage))
        t_fit = time.time()
        result = trainer.fit()
        fit_s = time.time() - t_fit
        check(result.error is None, f"fit() failed: {result.error}")
        final = result.metrics
        t_first = result.metrics_history[0]["t"]
        first_s = t_first - t_fit
        reported = [m["loss"] for m in result.metrics_history[:-1]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            reported + [final["loss"]],
            actor_run["losses"] + actor_run["losses"][-1:], strict=True))
        # The checkpoint restored into other weights, one step in here.
        model = GPT2(cfg, seed=2)
        opt = lm_opt()
        state = init_train_state(model, opt)
        step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                               grad_norm=False)
        restore_train_state(os.path.join(result.checkpoint_dir, "state"),
                            state)
        batch = device_batch(*host, next(model.parameters()).device)
        with contextlib.nullcontext() if CAPTURE else disable_capture():
            restored = float(step(state, batch)[1]["loss"])
        del model, opt, state, step, batch
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    print(f"runtime (d) TorchTrainer.fit(), 1 worker x 1 GPU "
          f"({final['backend']} on {final['device']}): reported losses "
          f"{reported}, Result loss {final['loss']} vs the actor's last "
          f"{actor_run['losses'][-1]} (relative {rel:.3g}, limit "
          f"{CAPTURE_LOSS_RTOL}); step {final['step_ms']:.2f} ms vs "
          f"in-process {ref_run['step_ms']:.2f} ms "
          f"({final['step_ms'] / ref_run['step_ms'] - 1:+.2%}); "
          f"compile_count {final['compile_count']}; launches "
          f"{final['counts']}; the checkpoint restored into other weights: "
          f"next loss {restored} vs the trainer's {final['next_loss']}, "
          f"bit-equal {restored == final['next_loss']}; fit() to the first "
          f"report {first_s:.1f} s (to the loop's start "
          f"{final['t_start'] - t_fit:.1f} s: the gang's placement, the "
          f"worker's start, its NCCL group; the model and its weights "
          f"{final['t_weights'] - final['t_start']:.1f} s; the first step "
          f"with its capture {t_first - final['t_weights']:.1f} s), whole "
          f"fit() {fit_s:.1f} s; card {card}", flush=True)
    check(rel <= CAPTURE_LOSS_RTOL, "the trainer's losses match the "
          "actor's")
    check(final["backend"] == "nccl" and final["compile_count"] ==
          want_captures and final["donated"],
          "the trainer's rank is NCCL and its step captured once")
    check_counts({"n_steps": CAPTURE_STEPS, "counts": final["counts"]},
                 {name: n for name in SQUARE}, "the TorchTrainer worker")
    check(restored == final["next_loss"], "the trainer's checkpoint "
          "restores bit-equal")

    # (e) Host rates.
    noop_task = rt.remote(noop)
    rt.get([noop_task.remote() for _ in range(100)])
    t0 = time.perf_counter()
    rt.get([noop_task.remote() for _ in range(RUNTIME_TASKS)])
    tasks_s = RUNTIME_TASKS / (time.perf_counter() - t0)
    counter = rt.remote(Pinger).remote()
    rt.get(counter.ping.remote())
    t0 = time.perf_counter()
    rt.get([counter.ping.remote() for _ in range(RUNTIME_ACTOR_CALLS)])
    calls_s = RUNTIME_ACTOR_CALLS / (time.perf_counter() - t0)
    rt.shutdown()
    print(f"runtime (e) host rates: {RUNTIME_TASKS} no-op tasks "
          f"{tasks_s:.1f}/s, {RUNTIME_ACTOR_CALLS} calls to one actor "
          f"{calls_s:.1f}/s; card {card}", flush=True)
    rebuilt = [name for name, t in libs.items()
               if os.path.getmtime(build.lib_path(name)) != t]
    check(not rebuilt, f"the workers loaded the kernels the driver built "
          f"(rebuilt: {rebuilt})")
    return {"first_s": first_s, "fit_s": fit_s,
            "ref_losses": ref_run["losses"],
            "actor_losses": actor_run["losses"], "trainer_losses": reported}


# -- phase 15: the Data feed -------------------------------------------------


def data_rows(vocab: int) -> np.ndarray:
    """DATA_STEPS x TRAIN_BATCH rows of TRAIN_SEQ + 1 token ids, seed 0."""
    return np.random.default_rng(0).integers(
        0, vocab, (DATA_STEPS * TRAIN_BATCH, TRAIN_SEQ + 1))


def data_batches(rows: np.ndarray) -> list[dict]:
    """The LM batches of ``rows``, straight from numpy."""
    toks = rows.astype(np.int32)
    return [{"tokens": toks[i:i + TRAIN_BATCH, :-1],
             "targets": toks[i:i + TRAIN_BATCH, 1:]}
            for i in range(0, len(toks), TRAIN_BATCH)]


def lm_batch(batch: dict) -> dict:
    """The pipeline's map_batches function: a block's token rows (one
    list a row, as read_tfrecords gives a multi-value feature) as the
    LM's int32 tokens and targets."""
    toks = np.stack(batch["tokens"])
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}


def block_probe(batch: dict) -> dict:
    """A map_batches probe: what a block task's worker has loaded and
    which cards it sees."""
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & {"torch", "jax", "ray_tpu"})
    n = len(batch["tokens"])
    return {"loaded": np.asarray([",".join(loaded)] * n),
            "cuda": np.asarray([os.environ.get("CUDA_VISIBLE_DEVICES",
                                               "unset")] * n)}


def batch_sums(batch) -> list[int]:
    """int64 sums of a batch's tokens and targets (numpy or tensors)."""
    return [int(batch[k].to(torch.int64).sum()) if isinstance(
        batch[k], torch.Tensor) else int(batch[k].astype(np.int64).sum())
        for k in ("tokens", "targets")]


def fed_steps(weights: dict, feed, timed_from: int = 1) -> dict:
    """GPT-2 124M from ``weights`` through ``make_train_step`` with the
    LM optimizer, one step a batch of ``feed`` (an iterator of batches on
    the card, with its ``DevicePrefetcher`` as ``feed.prefetcher`` or
    ``feed`` itself): the losses, each batch (a copy on the card), the
    launch counts (counts set to 0 just before, read just after), and the
    host clock and input stall over the steps after ``timed_from``, the
    first of which warms up and captures the step."""
    pf = getattr(feed, "prefetcher", feed)
    model = GPT2(GPT2Config.small(), seed=1)
    load_weights(model, weights)
    opt = lm_opt()
    state = init_train_state(model, opt)
    step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                           grad_norm=False)
    losses, seen = [], []
    fa.reset_launch_counts()
    for i, batch in enumerate(feed):
        if i == timed_from:
            torch.cuda.synchronize()
            t0, stall0 = time.perf_counter(), pf.stall_s
        seen.append({k: v.clone() for k, v in batch.items()})
        losses.append(step(state, batch)[1]["loss"])
    losses = [float(x) for x in losses]     # waits for the device
    wall = time.perf_counter() - t0
    run = {"losses": losses, "seen": seen, "counts": fa.launch_counts(),
           "n_steps": len(losses), "compile_count": compile_count(step),
           "donated": buffers_donated(step, state),
           "step_ms": wall / (len(losses) - timed_from) * 1e3,
           "stall_s": pf.stall_s - stall0, "wall_s": wall,
           "produce_s": pf.produce_s, "batches": pf.batches}
    del model, opt, state, step
    torch.cuda.empty_cache()
    return run


def data_trainer_loop(config: dict) -> None:
    """TorchTrainer's loop on the Data feed: one NCCL rank, GPT-2 124M
    from the weights in the object store, one step a batch of
    ``get_dataset_shard("train").iter_device_batches``, each step's loss
    and batch checksums reported."""
    import ray_tpu_torch
    from ray_tpu_torch import train
    t_start = time.time()
    dev = initialize()
    model = GPT2(GPT2Config.small(), seed=1, device=dev)
    load_weights(model, ray_tpu_torch.get(config["weights"]))
    opt = lm_opt()
    state = init_train_state(model, opt)
    step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                           grad_norm=False)
    feed = train.get_dataset_shard("train").iter_device_batches(TRAIN_BATCH)
    fa.reset_launch_counts()
    for batch in feed:
        sums = batch_sums(batch)
        loss = float(step(state, batch)[1]["loss"])
        train.report({"loss": loss, "sums": sums, "t": time.time()})
    pf = feed.prefetcher
    train.report({"counts": fa.launch_counts(),
                  "compile_count": compile_count(step),
                  "donated": buffers_donated(step, state),
                  "stall_s": pf.stall_s, "produce_s": pf.produce_s,
                  "backend": dist.get_backend(), "device": str(dev),
                  "t_start": t_start, "t": time.time()})


@contextlib.contextmanager
def python_tfrecord_reader():
    """``data.tfrecord.read_records`` through its pure-Python codec."""
    from ray_tpu_torch.native import tfrec
    get_lib = tfrec.get_lib
    tfrec.get_lib = lambda: None
    try:
        yield
    finally:
        tfrec.get_lib = get_lib


def data_phase(card: str, main_run: dict, runtime: dict) -> None:
    """Phase 15: the Data library on the port's runtime feeding GPT-2
    124M, in this process and through TorchTrainer(datasets=)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.data import tfrecord
    from ray_tpu_torch.native import tfrec
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    cfg = GPT2Config.small()
    rows = data_rows(cfg.vocab_size)
    want = data_batches(rows)
    want_sums = [batch_sums(b) for b in want]
    n = cfg.n_layer
    want_captures = 1 if CAPTURE else None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as d:
        # (a) The files, and both TFRecord readers on them.
        t0 = time.perf_counter()
        for f, part in enumerate(np.array_split(rows, DATA_FILES)):
            tfrecord.write_records(
                os.path.join(d, f"part-{f:05d}.tfrecord"),
                [tfrecord.build_example({"tokens": r.tolist()})
                 for r in part])
        write_s = time.perf_counter() - t0
        paths = sorted(os.path.join(d, f) for f in os.listdir(d))
        file_mb = sum(os.path.getsize(p) for p in paths) / 1e6
        check(tfrec.get_lib() is not None, "the native TFRecord scanner "
              "(native/tfrec.cpp) built and loaded")
        t0 = time.perf_counter()
        native = [list(tfrecord.read_records(p, verify=True)) for p in paths]
        native_s = time.perf_counter() - t0
        with python_tfrecord_reader():
            t0 = time.perf_counter()
            python = [list(tfrecord.read_records(p, verify=True))
                      for p in paths]
            python_s = time.perf_counter() - t0
        check(native == python and sum(map(len, native)) == len(rows),
              "the native and Python readers give the same records")
        print(f"data (a) {len(rows)} rows of {TRAIN_SEQ + 1} token ids in "
              f"{DATA_FILES} TFRecord files, {file_mb:.1f} MB, written in "
              f"{write_s:.2f} s; read with CRCs checked: native scanner "
              f"{file_mb / native_s:.1f} MB/s, Python codec "
              f"{file_mb / python_s:.1f} MB/s, the same records; card "
              f"{card}", flush=True)

        # (b) The pipeline alone.
        rt.init()
        try:
            ds = data.read_tfrecords(d).map_batches(lm_batch)
            passes = []
            for _ in range(2):      # the first pass starts the workers
                t0 = time.perf_counter()
                got = list(ds.iterator().iter_batches(TRAIN_BATCH,
                                                      drop_last=True))
                passes.append(time.perf_counter() - t0)
                check(len(got) == DATA_STEPS and all(
                    g[k].dtype == np.int32 and np.array_equal(g[k], w[k])
                    for g, w in zip(got, want) for k in w),
                    "the pipeline's batches are the numpy batches, in order")
            probes = data.read_tfrecords(d).map_batches(block_probe
                                                        ).take_all()
            seen = {(p["loaded"], p["cuda"]) for p in probes}
            out_mb = sum(v.nbytes for b in want for v in b.values()) / 1e6
            print(f"data (b) read_tfrecords -> map_batches(lm) -> "
                  f"iter_batches({TRAIN_BATCH}): the numpy batches "
                  f"bit-equal; {len(rows) / passes[1]:.1f} rows/s, "
                  f"{file_mb / passes[1]:.1f} MB/s of files, "
                  f"{out_mb / passes[1]:.1f} MB/s of batches ({passes[1]:.2f}"
                  f" s; the first pass, workers starting, {passes[0]:.2f} s);"
                  f" block workers loaded {sorted(seen)} (modules, "
                  f"CUDA_VISIBLE_DEVICES); card {card}", flush=True)
            check(seen == {("", "")}, "block tasks run in workers without "
                  "torch, jax or ray_tpu that see no card")

            # (c) In process: the Data feed against the numpy feed.
            model = GPT2(cfg, seed=0)
            weights = numpy_weights(model)
            del model
            torch.cuda.empty_cache()
            dev = default_device()
            numpy_run = fed_steps(weights, prefetch_to_device(iter(want), dev))
            data_run = fed_steps(weights,
                                 ds.iterator().iter_device_batches(
                                     TRAIN_BATCH))
        finally:
            rt.shutdown()
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            data_run["losses"], numpy_run["losses"], strict=True))
        equal = all(torch.equal(g[k].cpu(), torch.from_numpy(w[k]))
                    for g, w in zip(data_run["seen"], want) for k in w)
        stall_share = data_run["stall_s"] / data_run["wall_s"]
        print(f"data (c) GPT-2 124M B={TRAIN_BATCH} T={TRAIN_SEQ}, "
              f"{DATA_STEPS} steps fed by iter_device_batches: losses "
              f"{data_run['losses']} vs fed numpy through prefetch_to_device "
              f"{numpy_run['losses']}, bit-equal "
              f"{data_run['losses'] == numpy_run['losses']}, largest relative "
              f"difference {rel:.3g} (limit {CAPTURE_LOSS_RTOL}); batches on "
              f"the card bit-equal to numpy {equal}; step "
              f"{data_run['step_ms']:.2f} ms vs the numpy feed's "
              f"{numpy_run['step_ms']:.2f} ms and phase 4's static batch "
              f"{main_run['step_ms']:.2f} ms (over steps 2-{DATA_STEPS}); "
              f"input stall {data_run['stall_s'] * 1e3:.2f} ms of "
              f"{data_run['wall_s'] * 1e3:.1f} ({stall_share:.2%}; the numpy "
              f"feed's {numpy_run['stall_s'] * 1e3:.2f} ms), produce_s "
              f"{data_run['produce_s']:.3f} s for {data_run['batches']} "
              f"batches (the numpy feed's {numpy_run['produce_s']:.3f} s); "
              f"compile_count {data_run['compile_count']}; launches "
              f"{data_run['counts']}; card {card}", flush=True)
        check(rel <= CAPTURE_LOSS_RTOL, "the Data feed's losses match the "
              "numpy feed's")
        check(equal, "the Data feed's batches are the numpy batches")
        for run in (data_run, numpy_run):
            check(run["n_steps"] == DATA_STEPS
                  and run["compile_count"] == want_captures
                  and run["donated"], f"{DATA_STEPS} steps, captured "
                  f"{want_captures} time(s), buffers donated")
            check_counts(run, {name: n for name in SQUARE},
                         "the Data feed" if run is data_run else
                         "the numpy feed")

        # (d) TorchTrainer(datasets=) with one NCCL worker on the card.
        storage = tempfile.mkdtemp(prefix="chip_smoke_data_train_")
        rt.init()
        try:
            ds = data.read_tfrecords(d).map_batches(lm_batch)
            trainer = TorchTrainer(
                data_trainer_loop,
                train_loop_config={"weights": rt.put(weights)},
                datasets={"train": ds},
                scaling_config=ScalingConfig(num_workers=1,
                                             gpus_per_worker=1),
                run_config=RunConfig(name="gpt2_data", storage_path=storage))
            t_fit = time.time()
            result = trainer.fit()
            fit_s = time.time() - t_fit
        finally:
            rt.shutdown()
            shutil.rmtree(storage, ignore_errors=True)
    check(result.error is None, f"fit() failed: {result.error}")
    steps, final = result.metrics_history[:-1], result.metrics
    first_s = steps[0]["t"] - t_fit if steps else float("nan")
    losses = [m["loss"] for m in steps]
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        losses, numpy_run["losses"], strict=True))
    print(f"data (d) TorchTrainer(datasets={{'train': ds}}).fit(), 1 worker "
          f"x 1 GPU ({final['backend']} on {final['device']}), each rank "
          f"reading get_dataset_shard('train').iter_device_batches("
          f"{TRAIN_BATCH}): batch checksums equal to numpy's "
          f"{[m['sums'] for m in steps] == want_sums}; losses {losses} vs the "
          f"numpy feed's (relative {rel:.3g}, limit {CAPTURE_LOSS_RTOL}); "
          f"compile_count {final['compile_count']}; launches "
          f"{final['counts']}; input stall {final['stall_s'] * 1e3:.2f} ms, "
          f"produce_s {final['produce_s']:.3f} s; fit() to the first report "
          f"{first_s:.1f} s (to the loop's start "
          f"{final['t_start'] - t_fit:.1f} s), whole fit() {fit_s:.1f} s "
          f"(phase 14's: {runtime['first_s']:.1f} s and "
          f"{runtime['fit_s']:.1f} s); card {card}", flush=True)
    check([m["sums"] for m in steps] == want_sums, "each trainer batch's "
          "checksums are the numpy batch's")
    check(rel <= CAPTURE_LOSS_RTOL, "the trainer's losses match the numpy "
          "feed's")
    check(final["backend"] == "nccl" and final["compile_count"] ==
          want_captures and final["donated"],
          "the trainer's rank is NCCL and its step captured once")
    check_counts({"n_steps": DATA_STEPS, "counts": final["counts"]},
                 {name: n for name in SQUARE}, "the TorchTrainer Data feed")


# -- phase 17: Serve ---------------------------------------------------------


def serve_requests(n: int, vocab: int, seed: int = 0,
                   lengths: tuple[int, int] = SERVE_LENGTHS) -> list[dict]:
    """``n`` requests ``{"id", "tokens"}`` (int32), lengths uniform in
    ``lengths`` (inclusive), from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lengths[0], lengths[1] + 1, n)
    return [{"id": i, "tokens": rng.integers(0, vocab, k).astype(np.int32)}
            for i, k in enumerate(lengths)]


def pad_batch(seqs, left: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """A batch's ``[B, T]`` int32 tokens, padded with 0 to its longest
    request rounded up to PAD_MULTIPLE, and each row's last valid
    position. Right padding leaves a causal forward's valid rows as they
    are; ``left`` (the planted fault ``serve_left_pad``) pads in front."""
    t = -(-max(len(s) for s in seqs) // PAD_MULTIPLE) * PAD_MULTIPLE
    tokens = np.zeros((len(seqs), t), np.int32)
    last = np.empty(len(seqs), np.int64)
    for i, seq in enumerate(seqs):
        if left:
            tokens[i, t - len(seq):], last[i] = seq, t - 1
        else:
            tokens[i, :len(seq)], last[i] = seq, len(seq) - 1
    return tokens, last


def last_logits(model, tokens, last):
    """GPT-2's float32 logits at each row's position ``last`` (``[B,
    vocab]``): the LM head on those rows only."""
    h = model(tokens, return_hidden=True)
    rows = h[torch.arange(len(last), device=h.device), last]
    dt = model.config.dtype
    return matmul_f32(rows.to(dt), model.wte.weight.to(dt).t())


def logits_of(model, tokens: np.ndarray, last: np.ndarray) -> np.ndarray:
    dev = model.wte.weight.device
    with torch.inference_mode():
        return last_logits(model, torch.from_numpy(tokens).to(dev),
                           torch.from_numpy(last).to(dev)).cpu().numpy()


class GPT2Server:
    """The deployment of phase 17 (user code): GPT-2 124M on the card
    the replica holds (``default_device()``, which raises without one),
    its weights from the object store. Each ``@serve.batch`` batch is one
    forward of the right-padded batch under ``inference_mode`` (entered
    in the batch's worker thread, where the forward runs). A request gets
    back its last valid position's float32 logits (numpy), the top-1 id
    and the batch's signature: the request ids in order, the padded T,
    the replica's pid and card and the flash launches of that forward."""

    def __init__(self, weights, left_pad: bool = False):
        import ray_tpu_torch
        t_init = time.time()
        t0 = time.perf_counter()
        self.left_pad = left_pad
        self.model = GPT2(GPT2Config.small(), seed=1)   # other weights ...
        load_weights(self.model, ray_tpu_torch.get(weights))  # ... replaced
        self.dev = self.model.wte.weight.device
        t1 = time.perf_counter()
        # Warm every padded length the batches can have, at a full batch.
        with torch.inference_mode():
            for t in range(PAD_MULTIPLE, SERVE_LENGTHS[1] + 1, PAD_MULTIPLE):
                last_logits(self.model, torch.zeros(
                    SERVE_BATCH, t, dtype=torch.int32, device=self.dev),
                    torch.full((SERVE_BATCH,), t - 1, device=self.dev))
            # The ops of one full batch's forward, as the profiler sees
            # them: the attention is the flash kernel's op, not SDPA.
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                last_logits(self.model, torch.zeros(
                    SERVE_BATCH, SERVE_LENGTHS[1], dtype=torch.int32,
                    device=self.dev), torch.full(
                        (SERVE_BATCH,), SERVE_LENGTHS[1] - 1, device=self.dev))
        torch.cuda.synchronize()
        # (An attribute named "ops" would make cloudpickle ship the
        # unpicklable torch.ops module with this class.)
        self.attention_ops = sorted({e.key for e in prof.key_averages()
                                     if "attention" in e.key
                                     or "flash" in e.key})
        fa.reset_launch_counts()
        self.info = {"pid": os.getpid(),
                     "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                     "device": str(self.dev),
                     "card": str(torch.cuda.get_device_properties(
                         self.dev).uuid),
                     "model_s": t1 - t0, "warm_s": time.perf_counter() - t1,
                     "t_init": t_init, "t_ready": time.time()}

    @serve.batch(max_batch_size=SERVE_BATCH, batch_wait_timeout_s=SERVE_WAIT_S)
    def forward(self, reqs):
        tokens, last = pad_batch([r["tokens"] for r in reqs], self.left_pad)
        before = fa.launch_counts()
        logits = logits_of(self.model, tokens, last)
        after = fa.launch_counts()
        sig = {"ids": [r["id"] for r in reqs], "T": int(tokens.shape[1]),
               "pid": self.info["pid"], "card": self.info["card"],
               "launches": {k: after[k] - before[k] for k in after
                            if after[k] != before[k]}}
        return [{"id": r["id"], "logits": logits[i],
                 "top1": int(logits[i].argmax()), "batch": sig}
                for i, r in enumerate(reqs)]

    def __call__(self, request):
        out = self.forward(request)
        if isinstance(request["tokens"], list):      # over HTTP: JSON
            out = dict(out, logits=out["logits"].tolist())
        return out

    def stats(self) -> dict:
        """The replica's card, start-up times, the attention ops of one
        forward, and the launches since its warm-up ended."""
        return dict(self.info, attention_ops=self.attention_ops,
                    counts=fa.launch_counts())


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def drive(call, reqs: list[dict], callers: int) -> dict:
    """Every request through ``call`` from ``callers`` threads at once
    (each takes the next request when its last is answered): responses in
    request order, per-request latency, requests/s, tokens/s (prompt
    tokens), p50 and p99 latency and the mean batch size."""
    out, lat, errors = [None] * len(reqs), [0.0] * len(reqs), []
    nxt, lock = iter(range(len(reqs))), threading.Lock()

    def caller():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            t = time.perf_counter()
            try:
                out[i] = call(reqs[i])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                return
            lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=caller) for _ in range(callers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    batches = {(o["batch"]["pid"], tuple(o["batch"]["ids"])) for o in out}
    ms = np.asarray(lat) * 1e3
    return {"responses": out, "wall": wall, "rps": len(reqs) / wall,
            "tps": sum(len(r["tokens"]) for r in reqs) / wall,
            "p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99)),
            "mean_batch": len(reqs) / len(batches), "batches": batches}


def forward_times(model, b: int, n: int) -> dict:
    """The in-process forward of ``b`` requests of ``n`` tokens, padded as
    the replica pads them, run as the replica's batch runs it
    (``logits_of``: tokens in, forward, logits out), one call at a time:
    its mean time on the host clock over 20 calls, and the card's busy
    time in it (the device time torch.profiler records over 5 calls, None
    where it records none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tokens, last = pad_batch([np.zeros(n, np.int32)] * b)
    logits_of(model, tokens, last)
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        logits_of(model, tokens, last)
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)     # as in profile_dispatch
        for _ in range(5):
            logits_of(model, tokens, last)
        time.sleep(PROFILE_MARGIN_S)
    busy_us = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return {"T": tokens.shape[1], "wall_ms": float(np.mean(walls)) * 1e3,
            "busy_ms": busy_us / 5e3 if busy_us else None}


def describe_forward(f: dict) -> str:
    if f["busy_ms"] is None:
        return (f"host clock {f['wall_ms']:.3f} ms, device busy not "
                f"measured")
    return (f"host clock {f['wall_ms']:.3f} ms, device busy "
            f"{f['busy_ms']:.3f} ms of it ({f['busy_ms'] / f['wall_ms']:.1%})")


def describe_leg(leg: dict) -> str:
    return (f"{leg['rps']:.2f} requests/s, {leg['tps']:.0f} tokens/s, p50 "
            f"{leg['p50']:.2f} ms, p99 {leg['p99']:.2f} ms, mean batch "
            f"{leg['mean_batch']:.2f} ({len(leg['batches'])} batches) in "
            f"{leg['wall']:.2f} s")


class Reference:
    """The driver's in-process GPT-2 (the replicas' weights, seed 0, on
    cuda:0): each served batch recomputed (cached by its signature) and
    each request run alone, batch 1, unpadded."""

    def __init__(self, model, reqs: list[dict]):
        self.model, self.reqs = model, {r["id"]: r["tokens"] for r in reqs}
        self.batches: dict[tuple, np.ndarray] = {}
        self.alone: dict[int, np.ndarray] = {}

    def batch(self, ids: tuple, t: int) -> np.ndarray:
        if (ids, t) not in self.batches:
            tokens, last = pad_batch([self.reqs[i] for i in ids])
            check(tokens.shape[1] == t, f"batch {ids} padded to {t}")
            self.batches[(ids, t)] = logits_of(self.model, tokens, last)
        return self.batches[(ids, t)]

    def single(self, i: int) -> np.ndarray:
        if i not in self.alone:
            seq = self.reqs[i]
            self.alone[i] = logits_of(self.model, seq[None], np.asarray(
                [len(seq) - 1]))[0]
        return self.alone[i]


def serve_readings(legs: list[list[dict]], ref: Reference) -> dict:
    """(b) and (c) over the responses of one or more runs (``legs``):
    bit-equality with each batch recomputed in process, the worst |served
    - alone| / rms(alone), top-1 against the logits' argmax, and the
    launches of every batch, keyed by (run, replica pid, request ids)."""
    unequal, worst_batch, worst_alone, top1, n = 0, 0.0, 0.0, True, 0
    launches = {}
    vocab = GPT2Config.small().vocab_size
    for k, responses in enumerate(legs):
        for o in responses:
            n += 1
            sig = o["batch"]
            got = np.asarray(o["logits"], dtype=np.float32)
            want = ref.batch(tuple(sig["ids"]), sig["T"])[
                sig["ids"].index(o["id"])]
            if not np.array_equal(got.view(np.int32), want.view(np.int32)):
                unequal += 1
                worst_batch = max(worst_batch,
                                  float(np.abs(got - want).max()))
            alone = ref.single(o["id"])
            rms = float(np.sqrt(np.mean(alone.astype(np.float64) ** 2)))
            worst_alone = max(worst_alone,
                              float(np.abs(got - alone).max()) / rms)
            top1 = (top1 and got.shape == (vocab,)
                    and bool(np.isfinite(got).all())
                    and o["top1"] == int(got.argmax()))
            launches[(k, sig["pid"], tuple(sig["ids"]))] = sig["launches"]
    return {"n": n, "unequal": unequal, "worst_batch": worst_batch,
            "worst_alone": worst_alone, "top1": top1, "launches": launches}


def batches_of(r: dict, pid: int) -> int:
    """Batches that replica ``pid`` served in readings ``r``."""
    return sum(1 for _, p, _ in r["launches"] if p == pid)


def describe_readings(r: dict) -> str:
    n = GPT2Config.small().n_layer
    bad = [v for v in r["launches"].values() if v != {"flash_fwd": n}]
    return (f"{r['n']} responses: {r['n'] - r['unequal']} bit-equal to their "
            f"batch recomputed in process (worst |diff| {r['worst_batch']:.3g})"
            f"; against each request alone (batch 1, unpadded) worst "
            f"|diff| / rms {r['worst_alone']:.4g} (limit {SERVE_ALONE_TOL}); "
            f"top-1 the argmax of finite logits of the vocabulary "
            f"{r['top1']}; {len(r['launches'])} batches, each {n} flash_fwd "
            f"launches and no other: {not bad}")


def check_serve(r: dict, what: str) -> None:
    check(r["unequal"] == 0, f"{what}: every response bit-equal to its batch "
          f"recomputed in process ({r['unequal']} of {r['n']} not; worst "
          f"|diff| {r['worst_batch']:.4g})")
    check(r["worst_alone"] <= SERVE_ALONE_TOL, f"{what}: every response "
          f"within {SERVE_ALONE_TOL} rms of its request alone (worst "
          f"{r['worst_alone']:.4g})")
    check(r["top1"], f"{what}: finite logits of the vocabulary, top-1 their "
          f"argmax")
    n = GPT2Config.small().n_layer
    check(all(v == {"flash_fwd": n} for v in r["launches"].values()),
          f"{what}: {n} flash_fwd launches a batch (one a layer) and no "
          f"backward")


def check_replica(stats: dict, cuda_visible: str, batches: int,
                  what: str) -> None:
    """(c) in the replica: on its card, the flash op in the forward and
    no SDPA, one flash_fwd launch a layer a batch served, no backward
    launch."""
    check(stats["device"] == "cuda:0" and stats["cuda_visible"] ==
          cuda_visible, f"{what}: the replica holds its card "
          f"(CUDA_VISIBLE_DEVICES {stats['cuda_visible']}, {stats['device']})")
    ops = stats["attention_ops"]
    check("ray_tpu_torch::flash_fwd" in ops and not any(
        "scaled_dot_product" in op for op in ops),
        f"{what}: the forward's attention is the flash op, no SDPA ({ops})")
    n = GPT2Config.small().n_layer
    want = {name: n * batches if name == "flash_fwd" else 0
            for name in stats["counts"]}
    check(stats["counts"] == want, f"{what}: launches since the warm-up "
          f"{stats['counts']}, want {want}")


def http_call(port: int):
    import urllib.request

    def call(req: dict) -> dict:
        body = json.dumps({"id": req["id"],
                           "tokens": req["tokens"].tolist()}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/", data=body, headers={
                    "Content-Type": "application/json"}), timeout=120) as r:
            return json.loads(r.read())
    return call


def handle_call(handle):
    return lambda req: handle.remote(req).result(timeout_s=120)


def replica_stats(rt, name: str) -> list[dict]:
    """stats() of every replica of deployment ``name``, straight from the
    controller's replica handles."""
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME
    controller = rt.get_actor(CONTROLLER_NAME)
    _, replicas = rt.get(controller.get_replicas.remote(name), timeout=60)
    return [rt.get(r.handle_request.remote("stats", (), {}), timeout=60)
            for r in replicas]


def serve_phase(card: str, dev, fault: str | None = None) -> dict:
    """Phase 17 (module docstring). With ``fault`` (``serve_left_pad``),
    only (a) and (b) on the first requests, and (b) must fail it."""
    import ray_tpu_torch as rt
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)
    weights = numpy_weights(model)
    reqs = serve_requests(SERVE_REQUESTS, cfg.vocab_size)
    ref = Reference(model, reqs)
    kernel_row = None if fault else kernel_phase(SERVE_BATCH,
                                                 SERVE_LENGTHS[1], dev)
    rt.init()
    try:
        return serve_legs(rt, card, weights, reqs, ref, kernel_row, fault)
    finally:
        serve.shutdown()
        rt.shutdown()


def serve_legs(rt, card, weights, reqs, ref, kernel_row, fault):
    from ray_tpu_torch.serve.replica import Replica
    weights_ref = rt.put(weights)
    # (a') No CPU fallback: a replica that holds no card cannot start. Its
    # worker starts beside (a)'s; the refusal is read after (a).
    nocard = Replica.options(num_cpus=0).remote(GPT2Server, (weights_ref,),
                                                {}, "gpt2#nocard")
    nocard_call = nocard.handle_request.remote("stats", (), {})

    # (a) Start: serve.run to the first answer, HTTP ingress on.
    try:
        import aiohttp  # noqa: F401 — the proxy's server
        port = free_port()
    except ImportError:
        port = None
        print("serve: aiohttp does not import on this machine, so no HTTP "
              "proxy and no HTTP leg (an optional dependency of the JAX "
              "package's Serve too)", flush=True)
    app = serve.deployment(GPT2Server).options(
        name="gpt2", ray_actor_options={"num_gpus": 1}).bind(
            weights_ref, left_pad=fault == "serve_left_pad")
    t0, t_run = time.perf_counter(), time.time()
    handle = serve.run(app, name="gpt2", http_port=port)
    t_returned = time.time()
    first = handle.remote(reqs[0]).result(timeout_s=300)
    start_s = time.perf_counter() - t0
    (stats,) = replica_stats(rt, "gpt2")
    print(f"serve (a) GPT-2 124M behind a num_gpus=1 replica (pid "
          f"{stats['pid']}, CUDA_VISIBLE_DEVICES {stats['cuda_visible']}, "
          f"{stats['device']}): serve.run to the first answer "
          f"{start_s:.2f} s: to the replica's __init__ "
          f"{stats['t_init'] - t_run:.2f} s (the controller, the worker's "
          f"start, its imports and the class's unpickling), __init__ "
          f"{stats['t_ready'] - stats['t_init']:.2f} s (the model and its "
          f"weights {stats['model_s']:.2f} s, the warm-up of "
          f"{SERVE_LENGTHS[1] // PAD_MULTIPLE} padded lengths at batch "
          f"{SERVE_BATCH} and one profiled forward {stats['warm_s']:.2f} s), "
          f"then to serve.run's return {t_returned - stats['t_ready']:.2f} s "
          f"(readiness probe, routing table); "
          f"attention ops of a forward {stats['attention_ops']}; card "
          f"{card}",
          flush=True)
    check(first["id"] == 0, "the first answer is the first request's")
    try:
        rt.get(nocard_call, timeout=300)
        refused = "started"
    except Exception as e:  # noqa: BLE001 — the replica's start failed
        refused = str(e)
    rt.kill(nocard)
    said = [line for line in refused.splitlines() if "CUDA" in line]
    print(f"serve (a) a GPT2Server replica without a card refuses to start: "
          f"{'no CUDA device' in refused} ({(said or [refused])[-1][:200]})",
          flush=True)
    check("no CUDA device" in refused, "a replica without a card refuses "
          "to start (no CPU fallback)")

    if fault:
        leg = drive(handle_call(handle), reqs[:SERVE_HALF_REQUESTS], 8)
        r = serve_readings([leg["responses"]], ref)
        print(f"serve (b) with the fault {fault}: {describe_readings(r)}; "
              f"card {card}", flush=True)
        return r

    # (d) Load through the handle, then (b) and (c) on every response.
    legs = {}
    for callers in SERVE_CALLERS:
        legs[callers] = leg = drive(handle_call(handle), reqs, callers)
        print(f"serve (d) {len(reqs)} requests through the handle at "
              f"{callers} caller(s): {describe_leg(leg)}; card {card}",
              flush=True)
    full = forward_times(ref.model, SERVE_BATCH, SERVE_LENGTHS[1])
    floor_ms = full["wall_ms"]
    mean_len = round(float(np.mean([len(r["tokens"]) for r in reqs])))
    alone = forward_times(ref.model, 1, mean_len)
    print(f"serve (d) the in-process forward, one call at a time as the "
          f"replica runs it (tokens in, forward, logits out): a full batch "
          f"({SERVE_BATCH} x {SERVE_LENGTHS[1]}) {describe_forward(full)}, "
          f"so {SERVE_BATCH / floor_ms * 1e3:.1f} requests/s at most from "
          f"one replica; one request alone at the requests' mean length "
          f"({mean_len} tokens, 1 x {alone['T']} padded) "
          f"{describe_forward(alone)}; card {card}", flush=True)
    responses = [[first]] + [leg["responses"] for leg in legs.values()]
    http = None
    if port is not None:
        http = drive(http_call(port), reqs[:SERVE_HTTP_REQUESTS], 8)
        hr = serve_readings([http["responses"]], ref)
        print(f"serve (d) {SERVE_HTTP_REQUESTS} requests over HTTP through "
              f"the proxy at 8 callers: {describe_leg(http)}; "
              f"{describe_readings(hr)}; card {card}", flush=True)
        check_serve(hr, "over HTTP")
        responses.append(http["responses"])
    r = serve_readings(responses, ref)
    print(f"serve (b), (c) {describe_readings(r)}; card {card}", flush=True)
    check_serve(r, "through the handle")
    (stats,) = replica_stats(rt, "gpt2")
    print(f"serve (c) the replica's launches since its warm-up "
          f"{stats['counts']} for {len(r['launches'])} batches; card {card}",
          flush=True)
    check_replica(stats, "0", len(r["launches"]), "the replica")
    launches = stats["counts"]["flash_fwd"]
    serve.delete("gpt2")

    # (e) Two replicas at num_gpus=0.5 on the one card.
    app = serve.deployment(GPT2Server).options(
        name="gpt2half", num_replicas=2,
        ray_actor_options={"num_gpus": 0.5}).bind(weights_ref)
    t0 = time.perf_counter()
    handle = serve.run(app, name="gpt2half")
    first = handle.remote(reqs[0]).result(timeout_s=300)
    half_start_s = time.perf_counter() - t0
    half = drive(handle_call(handle), reqs[:SERVE_HALF_REQUESTS], 32)
    # The rate beside (d)'s single replica, on the same SERVE_REQUESTS.
    half_rate = drive(handle_call(handle), reqs, 32)
    hr = serve_readings([[first], half["responses"],
                         half_rate["responses"]], ref)
    served = {}
    for o in half["responses"]:
        served[o["batch"]["pid"]] = served.get(o["batch"]["pid"], 0) + 1
    stats = replica_stats(rt, "gpt2half")
    print(f"serve (e) two replicas at num_gpus=0.5 on the one card (started "
          f"in {half_start_s:.2f} s; CUDA_VISIBLE_DEVICES "
          f"{[s['cuda_visible'] for s in stats]}): requests per replica "
          f"{sorted(served.values())} of {SERVE_HALF_REQUESTS} at 32 "
          f"callers; {len(reqs)} requests at 32 callers "
          f"{describe_leg(half_rate)} (one replica, (d): "
          f"{legs[32]['rps']:.2f} requests/s); {describe_readings(hr)}; card "
          f"{card}", flush=True)
    check(len(served) == 2 and min(served.values()) >= 1,
          "both half-card replicas served requests")
    check_serve(hr, "the half-card replicas")
    for st in stats:
        check_replica(st, "0", batches_of(hr, st["pid"]),
                      "a half-card replica")
    chaos = chaos_leg(rt, handle, reqs, ref, card)
    return {"start_s": start_s, "chaos": chaos, "legs": legs, "http": http,
            "floor_ms": floor_ms, "alone": alone, "half": half_rate,
            "kernel": dict(kernel_row["flash_fwd"], launches=launches)}


def chaos_leg(rt, handle, reqs: list[dict], ref, card: str) -> dict:
    """Phase 17 (f): ``util.chaos.ResourceKiller(kind="serve_replica")``
    kills one of (e)'s two half-card replicas while SERVE_CHAOS_CALLERS
    callers send requests through the handle, cycling through ``reqs``,
    until the replica the controller respawns has answered
    SERVE_CHAOS_AFTER of them. Checks: no request failed, one kill, every
    response bit-equal to its batch recomputed in process (the respawned
    replica's too), and the respawned replica on the card with one
    ``flash_fwd`` a layer a batch."""
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME
    from ray_tpu_torch.util.chaos import ResourceKiller
    controller = rt.get_actor(CONTROLLER_NAME)
    before = set(rt.get(controller.replica_pids.remote("gpt2half"),
                        timeout=60).values())
    responses, failures, lock = [], [], threading.Lock()
    stop, state = threading.Event(), {"next": 0, "killed_at": None,
                                      "back_at": None, "new": 0}

    def caller():
        while not stop.is_set():
            with lock:
                i = state["next"] % len(reqs)
                state["next"] += 1
            try:
                o = handle.remote(reqs[i]).result(timeout_s=300)
            except Exception as e:  # noqa: BLE001 — counted, then checked
                with lock:
                    failures.append(f"{type(e).__name__}: {e}"[:300])
                continue
            with lock:
                responses.append(o)
                if o["batch"]["pid"] not in before:
                    state["new"] += 1
                    if state["back_at"] is None:
                        state["back_at"] = time.perf_counter()
                if state["new"] >= SERVE_CHAOS_AFTER:
                    stop.set()

    threads = [threading.Thread(target=caller, daemon=True)
               for _ in range(SERVE_CHAOS_CALLERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while (len(responses) < 2 * SERVE_CHAOS_CALLERS and not failures
           and time.perf_counter() - t0 < 120):
        time.sleep(0.01)
    killer = ResourceKiller(kind="serve_replica", interval_s=0.05,
                            max_kills=1, seed=1234).start()
    t_kill = time.perf_counter()
    while killer.kills < 1 and time.perf_counter() - t_kill < 60:
        time.sleep(0.01)
    killer.stop()
    if killer.kills >= 1:
        state["killed_at"] = time.perf_counter()
        stop.wait(300)
    stop.set()
    for t in threads:
        t.join(timeout=330)
    check(killer.kills >= 1, "(f) the killer killed a replica within 60 s "
          f"of its start ({len(responses)} answered before)")
    wall = time.perf_counter() - t0
    r = serve_readings([responses], ref)
    after = rt.get(controller.replica_pids.remote("gpt2half"), timeout=60)
    new = [pid for pid in after.values() if pid not in before]
    back_s = (None if state["back_at"] is None
              else state["back_at"] - state["killed_at"])
    print(f"serve (f) ResourceKiller(kind='serve_replica', seed=1234) killed "
          f"{killer.decisions} under {SERVE_CHAOS_CALLERS} callers: "
          f"{len(responses)} answered, {len(failures)} failed "
          f"{failures[:2]}; the respawned replica's first answer "
          f"{back_s if back_s is None else round(back_s, 2)} s after the "
          f"kill, {state['new']} answers from it; {wall:.2f} s in all; "
          f"{describe_readings(r)}; card {card}", flush=True)
    check(not failures, "(f) no request failed while a replica was killed")
    check(killer.kills == 1 and len(new) == 1
          and state["new"] >= SERVE_CHAOS_AFTER,
          f"(f) one replica killed and respawned, and the new one answered "
          f"{SERVE_CHAOS_AFTER} requests")
    check_serve(r, "(f) under the kill")
    (st,) = [x for x in replica_stats(rt, "gpt2half") if x["pid"] == new[0]]
    check_replica(st, "0", batches_of(r, new[0]), "(f) the respawned replica")
    return {"answered": len(responses), "failed": len(failures),
            "back_s": back_s, "wall_s": wall}


def serve_cards_phase(n: int, card: str) -> None:
    """Phase 16's serve leg on ``n`` cards (module docstring)."""
    import ray_tpu_torch as rt
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)
    weights = numpy_weights(model)
    reqs = serve_requests(SERVE_CARDS_REQUESTS, cfg.vocab_size)
    ref = Reference(model, reqs)
    rt.init()
    try:
        app = serve.deployment(GPT2Server).options(
            name="gpt2cards", num_replicas=n,
            ray_actor_options={"num_gpus": 1}).bind(rt.put(weights))
        t0 = time.perf_counter()
        handle = serve.run(app, name="gpt2cards")
        first = handle.remote(reqs[0]).result(timeout_s=300)
        start_s = time.perf_counter() - t0
        leg = drive(handle_call(handle), reqs, 32)
        r = serve_readings([[first], leg["responses"]], ref)
        stats = replica_stats(rt, "gpt2cards")
        served = {s["pid"]: batches_of(r, s["pid"]) for s in stats}
        requests = {}
        for o in leg["responses"]:
            requests[o["batch"]["card"]] = requests.get(
                o["batch"]["card"], 0) + 1
        print(f"multicard serve: {n} replicas at num_gpus=1 (started in "
              f"{start_s:.2f} s) on cards {[s['card'] for s in stats]} "
              f"(CUDA_VISIBLE_DEVICES {[s['cuda_visible'] for s in stats]}); "
              f"requests per card {sorted(requests.values())}, batches per "
              f"replica {sorted(served.values())}; {len(reqs)} requests at "
              f"32 callers {describe_leg(leg)}; against card 0's in-process "
              f"recompute: {describe_readings(r)}; card {card}", flush=True)
        check(len({s["card"] for s in stats}) == n
              and sorted(s["cuda_visible"] for s in stats)
              == [str(i) for i in range(n)],
              f"{n} replicas on {n} distinct cards")
        check(len(requests) == n, "every replica served requests")
        check_serve(r, "the replicas on four cards, against card 0")
        for st in stats:
            check_replica(st, st["cuda_visible"], served[st["pid"]],
                          "a replica on its own card")
    finally:
        serve.shutdown()
        rt.shutdown()


# -- phase 18: Tune -------------------------------------------------------------


def tune_batches(vocab: int, n: int = TUNE_BATCHES, b: int = TRAIN_BATCH,
                 t: int = TRAIN_SEQ) -> list:
    """``n`` fixed batches of ``b`` rows of ``t`` + 1 token ids (numpy seed
    0), each as host (tokens, targets)."""
    rows = np.random.default_rng(0).integers(0, vocab, (n, b, t + 1)) \
        .astype(np.int32)
    return [(r[:, :-1].copy(), r[:, 1:].copy()) for r in rows]


def tune_spec(model_cfg, device: str = "cuda", steps: int = TUNE_STEPS,
              **kw) -> dict:
    """What a phase-18 trial runs (its ``with_parameters`` object): the
    model config, its device ("cuda": the card it holds; "cpu" for the CPU
    tests), steps, when to checkpoint (every ``ckpt_every`` steps before
    the last, and at the last with ``ckpt_last``), the population that
    starts together behind ``gate``, the directory of the controller's
    marks that each step waits for (``acks``, set by :func:`tune_pbt`) and
    a planted fault."""
    spec = {"model": model_cfg, "device": device, "steps": steps,
            "ckpt_every": 0, "ckpt_last": False, "population": 0, "gate": "",
            "acks": "", "fault": None, "capture": CAPTURE}
    spec.update(kw)
    return spec


def card_uuid(dev) -> str:
    return (str(torch.cuda.get_device_properties(dev).uuid)
            if dev.type == "cuda" else "cpu")


def wait_for_population(gate: str, n: int, timeout: float = 300.0) -> None:
    """Wait until ``n`` trials have reached this point (a file each in
    ``gate``), so that a population's trials start together."""
    with open(os.path.join(gate, f"{os.getpid()}-{time.time_ns()}"), "w"):
        pass
    deadline = time.monotonic() + timeout
    while len(os.listdir(gate)) < n:
        check(time.monotonic() < deadline, f"{n} trials reach the gate")
        time.sleep(0.01)


def wait_for_ack(acks: str, trial_id: str, iteration: int,
                 timeout: float = 300.0) -> None:
    """Wait until the Tune controller has handled this trial's result
    ``iteration`` (:class:`ResultAcks` marked it)."""
    path = os.path.join(acks, f"{trial_id}-{iteration}")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        check(time.monotonic() < deadline,
              f"the controller handles {trial_id}'s result {iteration}")
        time.sleep(0.005)


def param_digest(model) -> list[float]:
    """Each parameter's float64 sum: a fingerprint of the weights."""
    with torch.no_grad():
        return [float(p.double().sum()) for p in model.parameters()]


def own_latest_checkpoint(trial_dir: str) -> str | None:
    """The newest complete checkpoint of a trial's own directory."""
    names = sorted(d for d in os.listdir(trial_dir)
                   if d.startswith("checkpoint_") and os.path.exists(
                       os.path.join(trial_dir, d, ".complete_rank_0")))
    return os.path.join(trial_dir, names[-1]) if names else None


def spec_device(spec: dict):
    return torch.device("cpu") if spec["device"] == "cpu" \
        else default_device()


def tune_lm_state(weights: dict, spec: dict, lr: float, dev):
    """GPT-2 of ``spec``'s config from ``weights`` on ``dev``, its train
    state under ``adamw(lr, weight_decay=0.1, mu_dtype=bf16)`` and the
    step: what a trial and the in-process references build."""
    model = GPT2(spec["model"], seed=1, device=dev)   # other weights ...
    load_weights(model, weights)                      # ... replaced
    opt = adamw(lr, weight_decay=0.1, mu_dtype=torch.bfloat16)
    state = init_train_state(model, opt)
    step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                           grad_norm=False)
    return model, state, step


def gpt2_tune_steps(config: dict, weights: dict, batches: list, spec: dict,
                    report) -> list[float]:
    """Phase 18's trial: GPT-2 at ``config["lr"]`` from ``weights`` on its
    device, the captured step on the fixed ``batches`` (step i on batch i
    mod their count) up to ``spec["steps"]``, each step's loss (taken
    before the update) passed to ``report`` with the launch counts since
    the trial started, its card and times. A trial that Tune restarted
    (PBT) restores the checkpoint it was given, then reports first the
    loss of that checkpoint's weights. A checkpoint holds the train state
    (``save_train_state``) and a token that the next step's report names
    (``from_token``), so a restart's first loss can be matched with the
    donor's. Returns the losses."""
    from ray_tpu_torch import train
    t_start = time.time()
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    ctx = train.get_context()
    dev = spec_device(spec)
    model, state, step = tune_lm_state(weights, spec, config["lr"], dev)
    trial_id = os.path.basename(os.path.normpath(ctx.trial_dir))
    restored = ctx.restored_checkpoint_dir or ""
    token = ""
    if restored:
        source = restored
        if spec["fault"] == "pbt_own_restore":
            source = own_latest_checkpoint(ctx.trial_dir) or restored
        restore_train_state(os.path.join(source, "state"), state)
        with open(os.path.join(source, "meta.json")) as f:
            token = json.load(f)["token"]
    elif spec["population"]:
        wait_for_population(spec["gate"], spec["population"])
    placed = [device_batch(*b, dev) for b in batches]
    card = card_uuid(dev)
    losses: list[float] = []
    with contextlib.nullcontext() if spec["capture"] else disable_capture():
        fa.reset_launch_counts()
        while state.step < spec["steps"]:
            batch = placed[state.step % len(placed)]
            losses.append(float(step(state, batch)[1]["loss"]))
            m = {"loss": losses[-1], "training_iteration": state.step,
                 "ran": len(losses), "from_token": token,
                 "restored": restored, "card": card, "pid": os.getpid(),
                 "t_start": t_start, "t": time.time(),
                 "counts": fa.launch_counts(),
                 "compile_count": compile_count(step)}
            if restored and len(losses) == 1:
                m["digest"] = param_digest(model)
            token, ckpt = "", None
            every = spec["ckpt_every"]
            if ((every and state.step % every == 0
                 and state.step < spec["steps"])
                    or (spec["ckpt_last"] and state.step == spec["steps"])):
                ckpt = tempfile.mkdtemp(prefix="chip_smoke_trial_")
                save_train_state(state, os.path.join(ckpt, "state"))
                token = os.urandom(8).hex()
                with open(os.path.join(ckpt, "meta.json"), "w") as f:
                    json.dump({"token": token, "step": state.step}, f)
            try:
                report(m, checkpoint=None if ckpt is None
                       else train.Checkpoint.from_directory(ckpt))
            finally:
                if ckpt is not None:
                    shutil.rmtree(ckpt, ignore_errors=True)
            if spec["acks"]:
                wait_for_ack(spec["acks"], trial_id, state.step)
    return losses


def gpt2_trial(config: dict, weights: dict, batches: list, spec: dict):
    """Phase 18's function trainable (bound by ``tune.with_parameters``)."""
    from ray_tpu_torch import train
    gpt2_tune_steps(config, weights, batches, spec, train.report)


def gpt2_trainer_loop(config: dict) -> None:
    """(c)'s TorchTrainer loop: the trial on the rank's card, each step
    reported to the trainer, then every loss in one last report (the
    result a Tuner over a trainer records)."""
    import ray_tpu_torch
    from ray_tpu_torch import train
    seen: list[dict] = []

    def report(metrics, checkpoint=None):
        seen.append(metrics)
        train.report(metrics, checkpoint=checkpoint)

    losses = gpt2_tune_steps(config["train_loop_config"],
                             ray_tpu_torch.get(config["weights"]),
                             config["batches"], config["spec"], report)
    last = seen[-1]
    train.report({"loss": losses[-1], "losses": losses,
                  "t_first": seen[0]["t"], "t_start": last["t_start"],
                  "counts": last["counts"], "ran": last["ran"],
                  "compile_count": last["compile_count"],
                  "card": last["card"], "backend": dist.get_backend()})


def eager_lm_steps(module, model, batches: list, steps: int, lr: float,
                   world: int = 1) -> tuple[list[float], list[float]]:
    """A plain eager loop, as a user of ``train.torch`` writes it: each
    step the forward of ``module`` (``model`` itself, or ``model`` under
    DDP) to the hidden states, the chunked LM loss on ``model``'s tied
    embedding, ``backward()``, the gradient norm and an
    ``adamw(lr, weight_decay=0.1, mu_dtype=bf16)`` update. Returns the
    losses (the mean over the ``world`` ranks) and gradient norms."""
    from ray_tpu_torch.train.optim import global_norm
    opt = adamw(lr, weight_decay=0.1, mu_dtype=torch.bfloat16)
    params = list(model.parameters())
    opt_state = opt.init(params)
    losses, norms = [], []
    for i in range(steps):
        batch = batches[i % len(batches)]
        for p in params:
            p.grad = None
        hidden = module(batch["tokens"], return_hidden=True)
        loss = chunked_cross_entropy(hidden, model.wte.weight,
                                     batch["targets"], chunk_size=2048)
        loss.backward()
        grads = [p.grad for p in params]
        norms.append(float(global_norm(grads)))
        mean = loss.detach().clone()
        if world > 1:
            dist.all_reduce(mean)
            mean /= world
        losses.append(float(mean))
        opt.update(grads, opt_state, params)
    return losses, norms


def torch_trainer_loop(config: dict) -> None:
    """(d)'s and (g)'s ``train.torch.TorchTrainer`` loop: GPT-2 on
    ``get_device()`` through ``prepare_model``, the rows of ``config
    ["rows"]`` through ``prepare_data_loader`` (batches of
    ``config["batch"]`` rows a rank, unshuffled), the eager loop of
    :func:`eager_lm_steps` on the rank's first batch; with ``round_trip``
    a ``TorchCheckpoint.from_model`` round trip on the card. Rank 0
    reports every rank's rows, card and launches."""
    from torch.utils.data import DataLoader, TensorDataset

    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.train import torch as tt

    dev = tt.get_device()
    spec = config["spec"]
    model = GPT2(spec["model"], seed=1, device=dev)
    load_weights(model, ray_tpu_torch.get(config["weights"]))
    module = tt.prepare_model(model)
    rows = config["rows"]
    loader = tt.prepare_data_loader(DataLoader(
        TensorDataset(torch.arange(len(rows)), torch.from_numpy(rows)),
        batch_size=config["batch"], shuffle=False))
    index, block = next(iter(loader))
    block = block.to(dev)
    batch = {"tokens": block[:, :-1].contiguous(),
             "targets": block[:, 1:].contiguous()}
    fa.reset_launch_counts()
    losses, norms = eager_lm_steps(module, model, [batch], config["steps"],
                                   config["lr"], dist.get_world_size())
    mine = {"rows": index.tolist(), "card": card_uuid(dev),
            "device": str(dev), "counts": fa.launch_counts(),
            "gpu_ids": ray_tpu_torch.get_gpu_ids()}
    if config.get("round_trip"):
        with tempfile.TemporaryDirectory() as d:
            ck = tt.TorchCheckpoint.from_model(model, directory=d)
            other = ck.get_model(GPT2(spec["model"], seed=3, device=dev))
        mine["round_trip"] = all(torch.equal(a, b) for a, b in zip(
            model.parameters(), other.parameters()))
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    train.report({"losses": losses, "norms": norms, "ranks": ranks,
                  "backend": dist.get_backend()})


class ResultLog(tune.Callback):
    """The results and completions a Tuner's scheduler saw, in its order
    (for ASHA's replay)."""

    def __init__(self):
        self.events: list[tuple] = []

    def on_trial_result(self, iteration, trials, trial, result):
        self.events.append(("result", trial.trial_id, dict(result)))

    def on_trial_complete(self, iteration, trials, trial):
        self.events.append(("complete", trial.trial_id, None))


class ResultAcks(tune.Callback):
    """Marks each result the Tune controller handles (``on_trial_result``
    runs just before the scheduler decides on it), for trials that wait
    on the mark after each report: none then runs ahead of the
    scheduler's decisions, or ends before them, however busy the
    controller."""

    def __init__(self, directory: str):
        self.directory = directory

    def on_trial_result(self, iteration, trials, trial, result):
        with open(os.path.join(self.directory, f"{trial.trial_id}-"
                               f"{result['training_iteration']}"), "w"):
            pass


class RecordedPBT(tune.PopulationBasedTraining):
    """PBT recording, at each exploit, the trial, the donor's checkpoint,
    the new config and whether the donor was in the upper quantile."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.log: list[dict] = []

    def exploit(self, trial_id):
        _, upper = self._quantiles()
        config, ckpt = super().exploit(trial_id)
        self.log.append({"trial": trial_id, "ckpt": ckpt,
                         "config": dict(config),
                         "upper": any(self._ckpt.get(u) == ckpt
                                      for u in upper)})
        return config, ckpt


def asha_kwargs(steps: int) -> dict:
    return {"metric": "loss", "mode": "min", "max_t": steps,
            "grace_period": 2, "reduction_factor": 2}


def tune_sweep(weights, batches, spec: dict, lrs, resources: dict,
               concurrent: int, storage: str, name: str = "asha") -> dict:
    """(a): ``Tuner`` over ``grid_search(lrs)`` under ASHA, each trial
    holding ``resources``, ``concurrent`` at a time."""
    from ray_tpu_torch.train import RunConfig
    log = ResultLog()
    trainable = tune.with_parameters(gpt2_trial, weights=weights,
                                     batches=batches, spec=spec)
    t0 = time.time()
    grid = tune.Tuner(
        trainable, param_space={"lr": tune.grid_search(list(lrs))},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min",
            scheduler=tune.ASHAScheduler(**asha_kwargs(spec["steps"])),
            resources_per_trial=resources,
            max_concurrent_trials=concurrent, seed=0),
        run_config=RunConfig(name=name, storage_path=storage,
                             callbacks=[log])).fit()
    return {"grid": grid, "events": log.events, "t0": t0,
            "wall_s": time.time() - t0}


def tune_pbt(weights, batches, spec: dict, lrs, resources: dict,
             storage: str, name: str = "pbt") -> dict:
    """(b): PBT over ``lrs``, every trial started together (``spec``'s
    gate), checkpointing every TUNE_PBT_INTERVAL steps, each step waiting
    until the controller has handled the last (:class:`ResultAcks`)."""
    from ray_tpu_torch.train import RunConfig
    sched = RecordedPBT(
        metric="loss", mode="min", perturbation_interval=TUNE_PBT_INTERVAL,
        hyperparam_mutations={"lr": TUNE_MUTATIONS}, quantile_fraction=0.5,
        seed=0)
    acks = tempfile.mkdtemp(prefix="chip_smoke_acks_")
    try:
        trainable = tune.with_parameters(gpt2_trial, weights=weights,
                                         batches=batches,
                                         spec={**spec, "acks": acks})
        t0 = time.time()
        grid = tune.Tuner(
            trainable, param_space={"lr": tune.grid_search(list(lrs))},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", scheduler=sched,
                resources_per_trial=resources,
                max_concurrent_trials=len(lrs), seed=0),
            run_config=RunConfig(name=name, storage_path=storage,
                                 callbacks=[ResultAcks(acks)])).fit()
    finally:
        shutil.rmtree(acks, ignore_errors=True)
    return {"grid": grid, "log": sched.log, "exploits": sched.exploit_count,
            "t0": t0, "wall_s": time.time() - t0}


def reference_losses(weights, batches, spec: dict, lr: float, steps: int,
                     capture: bool | None = None) -> list[float]:
    """The trial's steps at ``lr`` in this process, from the same weights
    on the same batches (captured as the trials, or eager)."""
    dev = spec_device(spec)
    model, state, step = tune_lm_state(weights, spec, lr, dev)
    placed = [device_batch(*b, dev) for b in batches]
    capture = spec["capture"] if capture is None else capture
    with contextlib.nullcontext() if capture else disable_capture():
        out = [float(step(state, placed[i % len(placed)])[1]["loss"])
               for i in range(steps)]
    del model, state, step, placed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def restored_step(weights, batches, spec: dict, ckpt: str, lr: float
                  ) -> tuple[float, list[float]]:
    """A checkpoint restored in this process into other weights, one step
    at ``lr``: its loss and the weights' digest after it."""
    dev = spec_device(spec)
    model, state, step = tune_lm_state(weights, spec, lr, dev)
    restore_train_state(os.path.join(ckpt, "state"), state)
    batch = device_batch(*batches[state.step % len(batches)], dev)
    with contextlib.nullcontext() if spec["capture"] else disable_capture():
        loss = float(step(state, batch)[1]["loss"])
    digest = param_digest(model)
    del model, state, step, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return loss, digest


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def launch_checks(grid, spec: dict, what: str) -> list[tuple]:
    """Every result's launches (12 of each square kernel a step since its
    trial started) and captures, on the card."""
    if spec["device"] == "cpu":
        return []
    per_step = GPT2Config.small().n_layer
    want = 1 if spec["capture"] else None
    bad = [(r.trial_id, m["ran"], m["counts"]) for r in grid
           for m in r.metrics_history
           if any(m["counts"].get(k, 0) != per_step * m["ran"]
                  for k in SQUARE) or m["compile_count"] != want]
    return [(f"{what}: {per_step} launches of each kernel a step counted "
             f"in every trial, compile_count {want}", not bad,
             bad[:3] or "all held")]


def overlaps(spans: dict) -> list[tuple]:
    """Pairs of trials whose [start, last report] spans intersect."""
    ids = sorted(spans)
    return [(a, b) for i, a in enumerate(ids) for b in ids[i + 1:]
            if spans[a][0] < spans[b][1] and spans[b][0] < spans[a][1]]


def trial_spans(grid) -> dict:
    return {r.trial_id: (min(m["t_start"] for m in r.metrics_history),
                         max(m["t"] for m in r.metrics_history))
            for r in grid if r.metrics_history}


def sweep_readings(run: dict, weights, batches, spec: dict, cards: int = 1
                   ) -> tuple[dict, list[tuple]]:
    """(a)'s readings and checks: no errors; on one card two trials
    overlapped on it (``cards`` > 1: every trial on its own card, all at
    once); each trial's losses against the same steps in this process;
    ASHA's stops against a fresh ASHAScheduler fed the recorded results;
    the launches."""
    grid = run["grid"]
    hist = {r.trial_id: r.metrics_history for r in grid}
    lr_of = {r.trial_id: r.config["lr"] for r in grid}
    longest = max((len(h) for h in hist.values()), default=0)
    refs = {lr: reference_losses(weights, batches, spec, lr, longest)
            for lr in sorted(set(lr_of.values()))}
    rel = {tid: _rel([m["loss"] for m in h], refs[lr_of[tid]][:len(h)])
           for tid, h in hist.items() if h}
    equal = {tid: [m["loss"] for m in h] == refs[lr_of[tid]][:len(h)]
             for tid, h in hist.items() if h}
    sched = tune.ASHAScheduler(**asha_kwargs(spec["steps"]))
    replay = set()
    for kind, tid, result in run["events"]:
        if kind == "complete":
            sched.on_trial_complete(tid)
        elif (sched.on_result(tid, result) == "STOP"
              and result["training_iteration"] < spec["steps"]):
            replay.add(tid)
    early = {tid for tid, h in hist.items() if len(h) < spec["steps"]}
    spans = trial_spans(grid)
    card_of = {tid: h[0]["card"] for tid, h in hist.items() if h}
    pairs = [(a, b) for a, b in overlaps(spans) if card_of[a] == card_of[b]]
    best = grid.get_best_result("loss", "min")
    readings = {
        "trials": {tid: {"lr": lr_of[tid], "losses": [m["loss"] for m in h],
                         "card": card_of.get(tid),
                         "first_report_s": (h[0]["t"] - h[0]["t_start"]
                                            if h else None)}
                   for tid, h in hist.items()},
        "rel": rel, "bit_equal": equal, "early": sorted(early),
        "replay": sorted(replay), "same_card_overlaps": pairs,
        "best_lr": best.config["lr"], "wall_s": run["wall_s"],
        "errors": [r.error for r in grid.errors]}
    checks = [("(a) no trial errors", not grid.errors,
               readings["errors"] or "none"),
              ("(a) each trial's losses against the same steps in this "
               f"process (limit {CAPTURE_LOSS_RTOL})",
               all(v <= CAPTURE_LOSS_RTOL for v in rel.values())
               and len(rel) == len(grid), rel),
              ("(a) ASHA stopped exactly the trials a fresh ASHAScheduler "
               "fed the recorded results stops", replay == early,
               {"tune": sorted(early), "replay": sorted(replay)})]
    if cards == 1:
        checks.append(("(a) two trials overlapped on the same card", bool(
            pairs), pairs))
    else:
        ids = sorted(spans)
        common = (max(spans[t][0] for t in ids), min(spans[t][1]
                                                   for t in ids))
        checks.append((f"(f) {cards} trials at once on {cards} distinct "
                       "cards", len(set(card_of.values())) == cards
                       and len(ids) == cards and common[0] < common[1],
                       card_of))
    checks += launch_checks(grid, spec, "(a)")
    return readings, checks


def pbt_readings(run: dict, weights, batches, spec: dict
                 ) -> tuple[dict, list[tuple]]:
    """(b)'s readings and checks: no errors; an exploit happened, each
    from a donor of the upper quantile; for each restart that stepped, its
    first report names the donor checkpoint's token and its loss equals
    the donor's own loss from that checkpoint, bit for bit, and the same
    checkpoint restored in this process gives that loss and, one step
    later at the new lr, the trial's weights (the restored AdamW moments
    at work); two trials overlapped on one card; the launches."""
    grid = run["grid"]
    hist = {r.trial_id: r.metrics_history for r in grid}
    restarts = []
    for e in run["log"]:
        with open(os.path.join(e["ckpt"], "meta.json")) as f:
            meta = json.load(f)
        after = [m for m in hist[e["trial"]] if m["restored"] == e["ckpt"]]
        row = {"trial": e["trial"], "donor": os.path.basename(
            os.path.dirname(e["ckpt"])), "step": meta["step"],
            "lr": e["config"]["lr"], "upper": e["upper"],
            "stepped": bool(after)}
        if after:
            first = after[0]
            donor = [m["loss"] for tid, h in hist.items() if tid != e["trial"]
                     for m in h if m["from_token"] == meta["token"]]
            ref_loss, ref_digest = restored_step(weights, batches, spec,
                                                 e["ckpt"], e["config"]["lr"])
            row.update(
                from_donor=first["from_token"] == meta["token"],
                loss=first["loss"], donor_loss=donor[0] if donor else None,
                ref_loss=ref_loss,
                donor_equal=(not donor) or first["loss"] == donor[0],
                loss_rel=_rel(first["loss"], ref_loss),
                digest_rel=_rel(first["digest"], ref_digest))
        restarts.append(row)
    stepped = [r for r in restarts if r["stepped"]]
    spans = trial_spans(grid)
    card_of = {tid: h[0]["card"] for tid, h in hist.items() if h}
    pairs = [(a, b) for a, b in overlaps(spans) if card_of[a] == card_of[b]]
    readings = {"exploits": run["exploits"], "restarts": restarts,
                "losses": {tid: [(m["training_iteration"], m["loss"])
                                 for m in h] for tid, h in hist.items()},
                "configs": {r.trial_id: r.config for r in grid},
                "same_card_overlaps": pairs, "wall_s": run["wall_s"],
                "errors": [r.error for r in grid.errors]}
    restore_ok = bool(stepped) and all(
        r["from_donor"] and r["donor_equal"]
        and r["loss_rel"] <= CAPTURE_LOSS_RTOL
        and r["digest_rel"] <= CAPTURE_LOSS_RTOL for r in stepped)
    checks = [("(b) no trial errors", not grid.errors,
               readings["errors"] or "none"),
              ("(b) at least one exploit, each from a donor of the upper "
               "quantile", run["exploits"] >= 1
               and all(r["upper"] for r in restarts), run["exploits"]),
              ("(b) each restart's first loss is its donor's, bit for bit, "
               "and the donor's checkpoint restored here gives it and the "
               f"next weights (limit {CAPTURE_LOSS_RTOL})", restore_ok,
               stepped),
              ("(b) the two trials overlapped on the same card",
               bool(pairs), pairs)]
    checks += launch_checks(grid, spec, "(b)")
    return readings, checks


def tune_trainer(weights_ref, batches, spec: dict, storage: str) -> dict:
    """(c): a Tuner over ``TorchTrainer(gpt2_trainer_loop)``, one worker
    (holding a card, or none on the CPU), one trial at
    ``train_loop_config={"lr": TUNE_TRAINER_LR}``."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    trainer = TorchTrainer(
        gpt2_trainer_loop,
        train_loop_config={"weights": weights_ref, "batches": batches,
                           "spec": spec},
        scaling_config=ScalingConfig(
            num_workers=1, gpus_per_worker=0 if spec["device"] == "cpu"
            else 1),
        run_config=RunConfig(storage_path=storage))
    t0 = time.time()
    grid = tune.Tuner(
        trainer, param_space={"train_loop_config": {"lr": TUNE_TRAINER_LR}},
        tune_config=tune.TuneConfig(max_concurrent_trials=1),
        run_config=RunConfig(name="trainer", storage_path=storage)).fit()
    return {"grid": grid, "t0": t0, "wall_s": time.time() - t0}


def trainer_readings(run: dict, ref: list[float], spec: dict
                     ) -> tuple[dict, list[tuple]]:
    """(c)'s readings and checks: the trial's losses against ``ref`` (the
    same steps at TUNE_TRAINER_LR: (a)'s trial, or in this process)."""
    grid = run["grid"]
    r = grid[0]
    m = r.metrics
    losses = m.get("losses", [])
    readings = {"losses": losses, "ref": ref[:len(losses)],
                "bit_equal": losses == ref[:len(losses)],
                "first_report_s": m.get("t_first", run["t0"]) - run["t0"],
                "wall_s": run["wall_s"], "backend": m.get("backend"),
                "error": r.error}
    checks = [("(c) the trainer trial ran", r.error is None
               and len(losses) == spec["steps"], r.error or len(losses)),
              (f"(c) its losses against the same steps (limit "
               f"{CAPTURE_LOSS_RTOL})", bool(losses) and _rel(
                   losses, ref[:len(losses)]) <= CAPTURE_LOSS_RTOL,
               readings["bit_equal"])]
    if spec["device"] != "cpu":
        want = 1 if spec["capture"] else None
        counts = m.get("counts", {})
        checks.append(("(c) 12 launches of each kernel a step in the "
                       "trainer's rank, compile_count once, NCCL",
                       all(counts.get(k) == 12 * m.get("ran", 0)
                           for k in SQUARE)
                       and m.get("compile_count") == want
                       and m.get("backend") == "nccl", counts))
    return readings, checks


def torch_trainer_fit(weights_ref, rows: np.ndarray, spec: dict,
                      workers: int, storage: str, round_trip: bool) -> dict:
    """(d), (g): ``train.torch.TorchTrainer(torch_trainer_loop,
    torch_config=TorchConfig())`` on ``workers`` ranks, one card each (or
    gloo on the CPU), each rank ``len(rows) // workers`` rows."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train import torch as tt
    t0 = time.time()
    result = tt.TorchTrainer(
        torch_trainer_loop,
        train_loop_config={"weights": weights_ref, "rows": rows,
                           "batch": len(rows) // workers, "spec": spec,
                           "steps": TUNE_TORCH_STEPS, "lr": TUNE_TRAINER_LR,
                           "round_trip": round_trip},
        scaling_config=ScalingConfig(
            num_workers=workers,
            gpus_per_worker=0 if spec["device"] == "cpu" else 1),
        run_config=RunConfig(name=f"torch{workers}", storage_path=storage),
        torch_config=tt.TorchConfig()).fit()
    check(result.error is None, f"train.torch.TorchTrainer: {result.error}")
    return {"metrics": result.metrics, "wall_s": time.time() - t0}


def dropout_check(card: str) -> None:
    """(e): GPT-2 124M at ``dropout=DROPOUT_RATE`` on the card (module
    docstring)."""
    from ray_tpu_torch.models import gpt2 as gpt2_module
    cfg = GPT2Config.small()
    host = tune_batches(cfg.vocab_size, n=1)[0]
    plain = GPT2(cfg, seed=0)
    dev = next(plain.parameters()).device
    batch = device_batch(*host, dev)
    loss_fn = gpt2_loss_fn(ce_chunk=2048)
    with torch.no_grad():
        l0 = loss_fn(plain, batch)
        del plain
        model = GPT2(GPT2Config.small(dropout=DROPOUT_RATE), seed=0)
        l1 = loss_fn(model, batch)
    seen = []
    inner = gpt2_module.dropout

    def recording(x, keep, rate):
        out = inner(x, keep, rate)
        seen.append((x, keep, out))
        return out

    tokens = batch["tokens"][:DROPOUT_BATCH]
    gen = torch.Generator(device=dev).manual_seed(0)
    gpt2_module.dropout = recording
    try:
        with torch.no_grad():
            a = model(tokens, deterministic=False, generator=gen,
                      return_hidden=True)
    finally:
        gpt2_module.dropout = inner
    keep_p = 1.0 - DROPOUT_RATE
    shares, scaled = [], True
    for x, keep, out in seen:
        shares.append(float(keep.float().mean()))
        scaled = scaled and torch.equal(out[keep], (x / keep_p)[keep]) \
            and not out[~keep].any()
    sigma = (keep_p * DROPOUT_RATE / seen[0][1].numel()) ** 0.5
    worst = max(abs(s - keep_p) for s in shares) / sigma
    del seen
    with torch.no_grad():
        b = model(tokens, deterministic=False, generator=gen,
                  return_hidden=True)
        c = model(tokens, deterministic=False, return_hidden=True,
                  generator=torch.Generator(device=dev).manual_seed(0))
    print(f"tune (e) dropout {DROPOUT_RATE} on GPT-2 124M: gpt2_loss "
          f"{float(l1)} vs {float(l0)} at dropout 0 (bit-equal "
          f"{bool(torch.equal(l0, l1))}); deterministic=False at "
          f"{DROPOUT_BATCH} x {TRAIN_SEQ}: {len(shares)} sites keep "
          f"{min(shares):.5f}-{max(shares):.5f} (worst {worst:.2f} sigma "
          f"from {keep_p}), kept values x/{keep_p} exactly {scaled}, two "
          f"draws differ {not torch.equal(a, b)}, the same seed gives the "
          f"same output {bool(torch.equal(a, c))}; card {card}", flush=True)
    check(bool(torch.equal(l0, l1)), "(e) the loss at dropout 0.1 is the "
          "loss without dropout, bit for bit")
    check(len(shares) == 1 + 2 * cfg.n_layer and worst <= 4.0 and scaled,
          "(e) every site keeps 0.9 within 4 sigma, at scale 1/0.9")
    check(not torch.equal(a, b) and bool(torch.equal(a, c)),
          "(e) two draws differ; the same seed gives the same output")
    del model, a, b, c, batch
    torch.cuda.empty_cache()


def report_checks(checks: list[tuple], card: str, strict: bool = True,
                  prefix: str = "tune") -> bool:
    """Print each (what, held, reading); raise on the first that failed
    when ``strict``. Returns whether all held."""
    for what, ok, reading in checks:
        print(f"{prefix} check {'held' if ok else 'FAILED'}: {what}: "
              f"{reading}; card {card}", flush=True)
    held = all(ok for _, ok, _ in checks)
    if strict:
        for what, ok, _ in checks:
            check(ok, what)
    return held


def describe_sweep(r: dict) -> str:
    return "; ".join(
        f"lr {t['lr']:g} on {str(t['card'])[:13]}: {len(t['losses'])} steps "
        f"{[round(x, 4) for x in t['losses']]}, first report "
        f"{t['first_report_s']:.1f} s after the trial started"
        for t in sorted(r["trials"].values(), key=lambda t: t["lr"]))


def tune_phase(card: str, runtime: dict | None = None) -> dict:
    """Phase 18: Tune on the card (module docstring). Returns the phase's
    times."""
    import ray_tpu_torch as rt
    cfg = GPT2Config.small()
    weights = numpy_weights(GPT2(cfg, seed=0))
    torch.cuda.empty_cache()
    batches = tune_batches(cfg.vocab_size)
    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    gate = tempfile.mkdtemp(prefix="chip_smoke_gate_")
    free_gb = shutil.disk_usage(storage).free / 1e9
    share = {"CPU": 1, "GPU": TUNE_SHARE}
    times = {}
    try:
        rt.init()
        try:
            sweep = tune_sweep(weights, batches,
                               tune_spec(cfg, ckpt_last=True),
                               TUNE_ONE_CARD_LRS, share, 2, storage)
            pbt = tune_pbt(weights, batches,
                           tune_spec(cfg, ckpt_every=TUNE_PBT_INTERVAL,
                                     population=len(TUNE_PBT_LRS),
                                     gate=gate), TUNE_PBT_LRS, share,
                           storage)
            weights_ref = rt.put(weights)
            trainer = tune_trainer(weights_ref, batches, tune_spec(cfg),
                                   storage)
            rows = np.concatenate([batches[0][0], batches[0][1][:, -1:]],
                                  axis=1)
            torch_run = torch_trainer_fit(weights_ref, rows, tune_spec(cfg),
                                          1, storage, round_trip=True)
        finally:
            rt.shutdown()
        # The references, in this process once every trial has exited.
        spec = tune_spec(cfg)
        ra, checks = sweep_readings(sweep, weights, batches, spec)
        print(f"tune (a) ASHA over lr {list(TUNE_ONE_CARD_LRS)}, "
              f"{len(TUNE_ONE_CARD_LRS)} "
              f"trials at GPU {TUNE_SHARE}, 2 at a time, {TUNE_STEPS} steps "
              f"of B={TRAIN_BATCH} T={TRAIN_SEQ}: {describe_sweep(ra)}; "
              f"stopped early {ra['early']} (replay {ra['replay']}); "
              f"against this process: relative {ra['rel']}, bit-equal "
              f"{ra['bit_equal']}; overlapping on one card "
              f"{ra['same_card_overlaps']}; best lr {ra['best_lr']:g}; "
              f"{ra['wall_s']:.1f} s; disk free {free_gb:.0f} GB; card "
              f"{card}", flush=True)
        rb, more = pbt_readings(pbt, weights, batches, spec)
        checks += more
        print(f"tune (b) PBT over lr {list(TUNE_PBT_LRS)} at GPU "
              f"{TUNE_SHARE}, interval {TUNE_PBT_INTERVAL}: {rb['exploits']} "
              f"exploits, restarts {rb['restarts']}; losses "
              f"{rb['losses']}; final configs {rb['configs']}; "
              f"{rb['wall_s']:.1f} s; card {card}", flush=True)
        # (a)'s trial at the same lr, or, where ASHA stopped it early, the
        # same steps in this process.
        ref = next((t["losses"] for t in ra["trials"].values()
                    if t["lr"] == TUNE_TRAINER_LR), [])
        ref_of = "(a)'s trial"
        if len(ref) < TUNE_STEPS:
            ref = reference_losses(weights, batches, spec, TUNE_TRAINER_LR,
                                   TUNE_STEPS)
            ref_of = "the same steps here"
        rc, more = trainer_readings(trainer, ref, spec)
        checks += more
        phase14 = (f"phase 14's fit() to its first report "
                   f"{runtime['first_s']:.1f} s" if runtime else
                   "phase 14 not run")
        print(f"tune (c) Tuner(TorchTrainer), one worker on the card at lr "
              f"{TUNE_TRAINER_LR:g}: losses {rc['losses']} vs {ref_of} "
              f"{rc['ref']} (bit-equal {rc['bit_equal']}); Tuner.fit() to "
              f"the trainer's first step {rc['first_report_s']:.1f} s "
              f"({phase14}), whole {rc['wall_s']:.1f} s; card {card}",
              flush=True)
        m = torch_run["metrics"]
        rank = m["ranks"][0]
        eager = reference_losses(weights, batches[:1], spec,
                                 TUNE_TRAINER_LR, TUNE_TORCH_STEPS,
                                 capture=False)
        torch.cuda.empty_cache()
        rel = _rel(m["losses"], eager)
        print(f"tune (d) train.torch.TorchTrainer(torch_config="
              f"TorchConfig()): backend {m['backend']}, get_device() "
              f"{rank['device']} ({rank['card'][:13]}, gpu ids "
              f"{rank['gpu_ids']}); eager losses through prepare_model "
              f"{m['losses']} vs disable_capture() here {eager} (relative "
              f"{rel:.3g}, bit-equal {m['losses'] == eager}); launches "
              f"{rank['counts']}; TorchCheckpoint round trip bit-equal "
              f"{rank['round_trip']}; {torch_run['wall_s']:.1f} s; card "
              f"{card}", flush=True)
        checks += [
            ("(d) NCCL, get_device() the card the scheduler gave",
             m["backend"] == "nccl" and rank["device"] == "cuda:0"
             and rank["gpu_ids"] == [0]
             and rank["card"] == card_uuid(torch.device("cuda", 0)),
             rank["device"]),
            (f"(d) the eager losses through prepare_model against "
             f"disable_capture() here (limit {CAPTURE_LOSS_RTOL})",
             rel <= CAPTURE_LOSS_RTOL, rel),
            ("(d) 12 launches of each kernel a step",
             all(rank["counts"].get(k) == 12 * TUNE_TORCH_STEPS
                 for k in SQUARE), rank["counts"]),
            ("(d) TorchCheckpoint.from_model round trips bit-equal",
             rank["round_trip"], rank["round_trip"])]
        report_checks(checks, card)
        times = {"a": ra["wall_s"], "b": rb["wall_s"], "c": rc["wall_s"],
                 "d": torch_run["wall_s"]}
    finally:
        shutil.rmtree(storage, ignore_errors=True)
        shutil.rmtree(gate, ignore_errors=True)
    dropout_check(card)
    return times


def tune_cards_phase(n: int, card: str) -> dict:
    """``--cards n``'s Tune legs: (f) ``n`` trials of (a) at ``GPU: 1``,
    (g) ``train.torch.TorchTrainer`` on ``n`` NCCL ranks (DDP) against the
    one-card eager loop on the whole batch. Returns (g)'s metrics."""
    import ray_tpu_torch as rt
    cfg = GPT2Config.small()
    weights = numpy_weights(GPT2(cfg, seed=0))
    torch.cuda.empty_cache()
    batches = tune_batches(cfg.vocab_size)
    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    spec = tune_spec(cfg)
    try:
        rt.init()
        try:
            sweep = tune_sweep(weights, batches, spec, TUNE_LRS,
                               {"CPU": 1, "GPU": 1}, n, storage)
            rows = np.concatenate([batches[0][0], batches[0][1][:, -1:]],
                                  axis=1)
            ddp = torch_trainer_fit(rt.put(weights), rows, spec, n, storage,
                                    round_trip=False)
        finally:
            rt.shutdown()
        ra, checks = sweep_readings(sweep, weights, batches, spec, cards=n)
        print(f"multicard tune (f) ASHA over lr {list(TUNE_LRS)} at GPU 1, "
              f"{n} at once: {describe_sweep(ra)}; stopped early "
              f"{ra['early']} (replay {ra['replay']}); relative "
              f"{ra['rel']}; {ra['wall_s']:.1f} s; card {card}", flush=True)
        model = GPT2(cfg, seed=1)
        load_weights(model, weights)
        whole = device_batch(*batches[0], next(model.parameters()).device)
        fa.reset_launch_counts()
        losses, norms = eager_lm_steps(model, model, [whole],
                                       TUNE_TORCH_STEPS, TUNE_TRAINER_LR)
        del model, whole
        torch.cuda.empty_cache()
        m = ddp["metrics"]
        loss_rel = [_rel(a, b) for a, b in zip(m["losses"], losses)]
        norm_rel = [_rel(a, b) for a, b in zip(m["norms"], norms)]
        rows_seen = sorted(i for r in m["ranks"] for i in r["rows"])
        print(f"multicard tune (g) train.torch.TorchTrainer on {n} NCCL "
              f"ranks (DDP, {len(rows) // n} rows a rank): losses "
              f"{m['losses']} vs one card's whole batch {losses} (relative "
              f"{loss_rel}); gradient norms {m['norms']} vs {norms} "
              f"(relative {norm_rel}); ranks' rows "
              f"{[r['rows'] for r in m['ranks']]} on cards "
              f"{[r['card'][:13] for r in m['ranks']]}; launches "
              f"{[r['counts'] for r in m['ranks']]}; {ddp['wall_s']:.1f} s; "
              f"card {card}", flush=True)
        checks += [
            (f"(g) {n} ranks on {n} distinct cards, NCCL, each "
             f"{len(rows) // n} of the {len(rows)} rows",
             m["backend"] == "nccl"
             and len({r["card"] for r in m["ranks"]}) == n
             and rows_seen == list(range(len(rows)))
             and all(len(r["rows"]) == len(rows) // n for r in m["ranks"]),
             [r["rows"] for r in m["ranks"]]),
            (f"(g) step-0 loss and gradient norm within "
             f"{multicard.STEP0_LOSS_RTOL} and {multicard.STEP0_GNORM_RTOL}, "
             f"later within {multicard.LOSS_RTOL} and {multicard.GNORM_RTOL}",
             loss_rel[0] <= multicard.STEP0_LOSS_RTOL
             and norm_rel[0] <= multicard.STEP0_GNORM_RTOL
             and all(v <= multicard.LOSS_RTOL for v in loss_rel[1:])
             and all(v <= multicard.GNORM_RTOL for v in norm_rel[1:]),
             (loss_rel, norm_rel)),
            ("(g) 12 launches of each kernel a step on every rank",
             all(r["counts"].get(k) == 12 * TUNE_TORCH_STEPS
                 for r in m["ranks"] for k in SQUARE),
             [r["counts"] for r in m["ranks"]])]
        report_checks(checks, card)
        return m
    finally:
        shutil.rmtree(storage, ignore_errors=True)


def tune_fault_main(name: str, card: str) -> int:
    """``--plant-fault pbt_own_restore``: the build, then phase 18's (b)
    with every exploited trial restoring its own latest checkpoint, (b)'s
    checks read without raising. Exits 1 when (b)'s restore check fails it
    (caught), 2 when it does not, and 2 when the run failed before (b)'s
    checks."""
    import ray_tpu_torch as rt
    print(f"planted fault {name}: {TUNE_FAULTS[name]}", flush=True)
    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    gate = tempfile.mkdtemp(prefix="chip_smoke_gate_")
    try:
        t0 = time.perf_counter()
        build.ensure_built()
        print(f"build: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
        cfg = GPT2Config.small()
        weights = numpy_weights(GPT2(cfg, seed=0))
        torch.cuda.empty_cache()
        batches = tune_batches(cfg.vocab_size)
        spec = tune_spec(cfg, ckpt_every=TUNE_PBT_INTERVAL,
                         population=len(TUNE_PBT_LRS), gate=gate, fault=name)
        rt.init()
        try:
            run = tune_pbt(weights, batches, spec, TUNE_PBT_LRS,
                           {"CPU": 1, "GPU": TUNE_SHARE}, storage)
        finally:
            rt.shutdown()
        readings, checks = pbt_readings(run, weights, batches, spec)
        print(f"tune (b) with {name}: {readings['exploits']} exploits, "
              f"restarts {readings['restarts']}", flush=True)
        report_checks(checks, card, strict=False)
    except Exception:  # noqa: BLE001 — the harness failed, not (b)
        traceback.print_exc()
        print(json.dumps({"fault": name, "caught": False,
                          "failed_before_b": True}), flush=True)
        return 2
    finally:
        shutil.rmtree(storage, ignore_errors=True)
        shutil.rmtree(gate, ignore_errors=True)
    exploited = [ok for what, ok, _ in checks if "exploit" in what]
    missed = [r for r in readings["restarts"] if r["stepped"]
              and not (r["from_donor"] and r["donor_equal"])]
    caught = all(exploited) and bool(missed)
    print(json.dumps({"fault": name, "exploits": readings["exploits"],
                      "restarts_read_wrong": len(missed),
                      "restore_check_fails_it": not all(
                          ok for what, ok, _ in checks
                          if "first loss" in what),
                      "caught": caught}), flush=True)
    return 1 if caught else 2


# -- phase 19: RLlib ------------------------------------------------------------


class ChipCartPole:
    """CartPole-v1's dynamics in numpy (gymnasium's classic_control
    cartpole: Euler steps of 0.02 s, force 10 N, pole half-length 0.5 m,
    terminated past 12 degrees or 2.4 m, truncated at 500 steps, reward 1
    a step; the state starts uniform in +-0.05), registered as
    ``chip_cartpole`` where gymnasium does not import."""

    def __init__(self):
        self.rng = np.random.default_rng()
        self.state = np.zeros(4)
        self.t = 0

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.state = self.rng.uniform(-0.05, 0.05, size=4)
        self.t = 0
        return self.state.astype(np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self.state
        force = 10.0 if int(action) == 1 else -10.0
        cos, sin = np.cos(theta), np.sin(theta)
        total_mass, pole_ml = 1.1, 0.05          # cart 1.0 + pole 0.1; 0.1*0.5
        temp = (force + pole_ml * theta_dot ** 2 * sin) / total_mass
        theta_acc = (9.8 * sin - cos * temp) / (
            0.5 * (4.0 / 3.0 - 0.1 * cos ** 2 / total_mass))
        x_acc = temp - pole_ml * theta_acc * cos / total_mass
        x, x_dot = x + 0.02 * x_dot, x_dot + 0.02 * x_acc
        theta, theta_dot = theta + 0.02 * theta_dot, theta_dot + 0.02 * \
            theta_acc
        self.state = np.array([x, x_dot, theta, theta_dot])
        self.t += 1
        terminated = bool(abs(x) > 2.4 or abs(theta) > 12 * 2 * np.pi / 360)
        return (self.state.astype(np.float32), 1.0, terminated,
                self.t >= 500, {})


class ChipFrames:
    """The image environment of (c): observations [84, 84, 4] uint8,
    Atari's stacked-frame shape, drawn from a pool of FRAME_POOL frames
    made from numpy seed 0; RLLIB_ACTIONS actions; reward 1 when the
    action is the frame's index modulo the action count, else 0 (so the
    advantages are not all zero and the task is learnable); episodes of
    FRAMES_EPISODE steps (truncated)."""

    def __init__(self):
        self.frames = np.random.default_rng(0).integers(
            0, 256, (FRAME_POOL, *FRAME_SHAPE), dtype=np.uint8)
        self.rng = np.random.default_rng()
        self.i = self.t = 0

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.t = 0
        self.i = int(self.rng.integers(FRAME_POOL))
        return self.frames[self.i], {}

    def step(self, action):
        reward = float(int(action) == self.i % RLLIB_ACTIONS)
        self.t += 1
        self.i = int(self.rng.integers(FRAME_POOL))
        return (self.frames[self.i], reward, False,
                self.t >= FRAMES_EPISODE, {})


def chip_frames():
    return ChipFrames()


def chip_cartpole():
    return ChipCartPole()


def cartpole_env() -> str:
    """``CartPole-v1`` where gymnasium imports, else ``chip_cartpole``
    (registered here); printed."""
    try:
        import gymnasium  # noqa: F401
        name = "CartPole-v1"
    except ImportError:
        tune.register_env("chip_cartpole", chip_cartpole)
        name = "chip_cartpole"
    print(f"rllib: CartPole is {name}", flush=True)
    return name


def frames_config() -> dict:
    """(c)'s policy: the catalog's CNN at the Nature-DQN filters."""
    return {"obs_shape": FRAME_SHAPE, "num_actions": RLLIB_ACTIONS,
            "conv_filters": NATURE_FILTERS, "hidden": (512,)}


def runner_view(runner) -> dict:
    """What an env-runner actor sees (run on the instance by
    ``__ray_call__``)."""
    return {"cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cuda": torch.cuda.is_available(),
            "device": str(next(runner.model.parameters()).device),
            "threads": torch.get_num_threads()}


def learner_view(actor) -> dict:
    """A learner actor's device and card UUID (``__ray_call__``)."""
    dev = actor.learner.device
    return {"device": str(dev), "card": card_uuid(dev),
            "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def timed_allreduce(actor, numel: int) -> dict:
    """One ring all-reduce of a float32 vector of ``numel`` elements on
    the learner's device, as ``_allreduce_grads`` runs it after every
    update (``__ray_call__``; every rank at once)."""
    grads = {"g": torch.zeros(numel, device=actor.learner.device)}
    actor._allreduce_grads(grads)               # warm the ring
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    actor._allreduce_grads(grads)
    torch.cuda.synchronize()
    return {"s": time.perf_counter() - t0, "bytes": numel * 4}


def update_rel(got: dict, want: dict, start: dict) -> float:
    """|got - want| / |want - start| over every parameter (L2): how far
    apart two learners' updates from the same ``start`` landed, relative
    to the update's size. Adam turns rounding differences in a near-zero
    gradient entry into a full step on that entry; over the whole model
    such entries weigh little."""
    num = sum(float((got[k].double() - want[k].double()).square().sum())
              for k in want)
    den = sum(float((want[k].double() - start[k].double()).square().sum())
              for k in want)
    return (num / den) ** 0.5 if den else float(num > 0)


def first_update(ln, weights: dict, batch: dict) -> dict:
    """One update of ``ln`` from ``weights`` on the first minibatch its
    ``update_from_episodes`` would take (``default_rng(0)``'s first
    permutation): the gradient (flat, float64 on the CPU) and the
    weights after it."""
    ln.set_weights(weights)
    n = len(batch["obs"])
    mb = max(1, min(ln.hp.minibatch_size, n))
    idx = np.random.default_rng(0).permutation(n)[:mb]
    grads, _ = ln.compute_grads(ln.params, {k: v[idx]
                                            for k, v in batch.items()})
    flat = torch.cat([g.reshape(-1).double().cpu() for g in grads.values()])
    ln.apply_grads(grads)
    return {"grad": flat, "weights": ln.get_weights()}


def learner_pair(policy_config: dict, hp, weights: dict, episodes,
                 recurrent: bool = False, max_seq_len: int = 8,
                 float64: bool = False) -> dict:
    """(b): on the card and on the CPU from the same weights, first one
    update on the first minibatch (the gradients and the updates
    compared), then ``update_from_episodes(episodes)`` (the metrics and
    parameters compared). With ``float64``, also the CPU in float64: how
    far float32 itself lands from exact arithmetic over the same
    updates."""
    from ray_tpu_torch.rllib.learner import (
        RecurrentTorchLearner, TorchLearner,
    )
    cls, kw = ((RecurrentTorchLearner, {"max_seq_len": max_seq_len})
               if recurrent else (TorchLearner, {}))
    runs = (("card", None, policy_config), ("cpu", "cpu", policy_config))
    if float64:
        runs += (("cpu64", "cpu", {**policy_config,
                                   "dtype": torch.float64}),)
    out = {}
    for name, device, cfg in runs:
        ln = cls(cfg, hp, device=device, **kw)
        dtype = next(ln.model.parameters()).dtype
        start = {k: v.to(dtype) for k, v in weights.items()}
        one = first_update(ln, start, ln.compute_advantages(episodes))
        # A fresh learner for the whole update: first_update moved the
        # optimizer state.
        ln = cls(cfg, hp, device=device, **kw)
        ln.set_weights(start)
        t0 = time.perf_counter()
        out[name] = {"metrics": ln.update_from_episodes(episodes),
                     "weights": ln.get_weights(), "one": one,
                     "device": str(next(ln.model.parameters()).device),
                     "captures": ln.compile_count,
                     "s": time.perf_counter() - t0}
        del ln
    torch.cuda.empty_cache()
    card, cpu = out["card"], out["cpu"]
    out["grad_rel"] = float((card["one"]["grad"] - cpu["one"]["grad"]).norm()
                            / cpu["one"]["grad"].norm())
    out["one_rel"] = update_rel(card["one"]["weights"],
                                cpu["one"]["weights"], weights)
    out["rel"] = update_rel(card["weights"], cpu["weights"], weights)
    if float64:
        out["f32_rel"] = update_rel(cpu["weights"], out["cpu64"]["weights"],
                                    weights)
    # The policy term nearly cancels (a mean of O(1) terms): each metric
    # relative to the larger of itself and the total loss.
    scale = abs(cpu["metrics"]["total_loss"])
    out["metric_rel"] = max(abs(card["metrics"][k] - v) / max(abs(v), scale)
                            for k, v in cpu["metrics"].items())
    out["max_abs"] = max(float((card["weights"][k] - cpu["weights"][k])
                               .abs().max()) for k in weights)
    return out


def pair_checks(r: dict, what: str, trajectory: bool = True
                ) -> list[tuple]:
    """The one-update check and, with ``trajectory``, the whole
    ``update_from_episodes``'s."""
    checks = [(f"{what}: the first minibatch's gradient on the card "
               f"against the CPU's within {LEARNER_GRAD_RTOL} (L2), one "
               f"update within {LEARNER_UPDATE_RTOL} of its size",
               r["grad_rel"] <= LEARNER_GRAD_RTOL
               and r["one_rel"] <= LEARNER_UPDATE_RTOL
               and r["card"]["device"] == "cuda:0",
               {"grad_rel": r["grad_rel"], "one_rel": r["one_rel"]})]
    if trajectory:
        checks.append((
            f"{what}: update_from_episodes on the card against the CPU's "
            f"from the same weights within {LEARNER_UPDATE_RTOL} of the "
            f"update (L2), metrics within {LEARNER_METRIC_RTOL}",
            r["rel"] <= LEARNER_UPDATE_RTOL
            and r["metric_rel"] <= LEARNER_METRIC_RTOL,
            {"rel": r["rel"], "metric_rel": r["metric_rel"],
             "max_abs": r["max_abs"]}))
    return checks


def describe_pair(r: dict) -> str:
    f32 = (f" (the CPU's float32 against its float64 over the same "
           f"updates: {r['f32_rel']:.3g})" if "f32_rel" in r else "")
    return (f"first minibatch: gradient relative {r['grad_rel']:.3g}, one "
            f"update relative {r['one_rel']:.3g}; update_from_episodes: "
            f"card vs CPU update relative {r['rel']:.3g}{f32} (max abs "
            f"{r['max_abs']:.3g}), metrics relative {r['metric_rel']:.3g}; "
            f"card {r['card']['s']:.2f} s ({r['card']['captures']} "
            f"captures), CPU {r['cpu']['s']:.2f} s")


class RecordingRunners:
    """Wraps a PPO's runner group and keeps every iteration's episodes."""

    def __init__(self, runners):
        self._runners = runners
        self.batches = []

    def __getattr__(self, name):
        return getattr(self._runners, name)

    def sample(self, steps: int):
        eps = self._runners.sample(steps)
        self.batches.append(eps)
        return eps


def timed_sample(runner, steps: int) -> dict:
    """A runner's ``sample(steps)`` timed inside its actor
    (``__ray_call__``): the episodes stay there."""
    t0 = time.perf_counter()
    eps = runner.sample(steps)
    return {"s": time.perf_counter() - t0,
            "steps": sum(e.length for e in eps),
            "bytes": sum(np.asarray(o).nbytes for e in eps for o in e.obs)}


def learn_profile(learner, episodes) -> dict:
    """One learn phase (``update_from_episodes``) on the host clock, and
    the card's busy time in it (torch.profiler's device time; None where
    it records none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)     # as in profile_dispatch
        t0 = time.perf_counter()
        learner.update_from_episodes(episodes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
    busy_us = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return {"wall_s": wall, "busy_s": busy_us / 1e6 if busy_us else None}


def ppo_cartpole(env: str, card: str) -> tuple[dict, list]:
    """(a) and (b). Returns the algorithm's readings, the algorithm itself
    (running, for (f)'s checkpoint round trip, which stops it) and its
    state, and the checks."""
    from ray_tpu_torch.rllib import PPOConfig
    cfg = (PPOConfig().environment(env, obs_dim=4, num_actions=2)
           .env_runners(2)
           .training(train_batch_size=1024, lr=3e-3, minibatch_size=128,
                     num_epochs=6))
    t0 = time.perf_counter()
    algo = cfg.build()
    start_s = time.perf_counter() - t0
    try:
        views = ray_tpu_torch.get([r.__ray_call__.remote(runner_view)
                        for r in algo.runners.runners])
        algo.runners = RecordingRunners(algo.runners)
        initial = algo.learner.get_weights()
        rewards, results = [], []
        for _ in range(RLLIB_ITERS):
            r = algo.train()
            results.append(r)
            rewards.append(r["episode_reward_mean"])
        finite = [x for x in rewards if np.isfinite(x)]
        first, best = (finite[0], max(finite)) if finite else (None, None)
        device = str(next(algo.learner.model.parameters()).device)
        updates = float(algo.learner.opt_state["count"])
        captures = algo.learner.compile_count
        state = algo.get_state()
        first_eps = algo.runners.batches[0]
        wall = time.perf_counter() - t0
    except BaseException:
        algo.stop()
        raise
    pair = learner_pair(cfg.policy_config, cfg.hparams, initial, first_eps)
    samples = [r["time_sample_s"] for r in results]
    learns = [r["time_learn_s"] for r in results]
    print(f"rllib (a) PPO on {env}, 2 runners, {RLLIB_ITERS} iterations of "
          f"1024 steps, minibatch 128 x 6 epochs: episode_reward_mean "
          f"{[round(x, 1) for x in rewards]} (first {first}, best {best}); "
          f"learner on {device}, {captures} capture(s), {updates:.0f} "
          f"updates; runners {views}; sample s/iteration median "
          f"{np.median(samples):.3f}, learn s/iteration median "
          f"{np.median(learns):.3f}; start {start_s:.1f} s, whole "
          f"{wall:.1f} s; card {card}", flush=True)
    print(f"rllib (b) one update_from_episodes on (a)'s first episodes "
          f"({sum(e.length for e in first_eps)} steps): {describe_pair(pair)}"
          f"; card {card}", flush=True)
    checks = [
        ("(a) learns: best episode_reward_mean > first + 30",
         first is not None and best > first + 30, (first, best)),
        ("(a) the learner's parameters on cuda:0", device == "cuda:0",
         device),
        ("(a) every runner sees CUDA_VISIBLE_DEVICES='' and keeps its "
         "model on the CPU, one torch thread",
         all(v["cuda_visible"] == "" and not v["cuda"]
             and v["device"] == "cpu" and v["threads"] == 1
             for v in views), views),
        ("(a) one capture of the minibatch update, replayed for every "
         "update after it", captures == 1 and updates == sum(
             6 * (r["num_env_steps_sampled"] // 128) for r in results),
         (captures, updates)),
    ] + pair_checks(pair, "(b)")
    return {"state": state, "cfg": cfg, "wall_s": wall, "algo": algo,
            "pair": pair}, checks


def ppo_frames(card: str) -> tuple[dict, list]:
    """(c): PPO on ``chip_frames`` at the realistic width."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.learner import PPOHyperparams
    tune.register_env("chip_frames", chip_frames)
    cfg = PPOConfig(env="chip_frames", policy_config=frames_config(),
                    num_env_runners=2, train_batch_size=FRAMES_BATCH,
                    hparams=PPOHyperparams(minibatch_size=FRAMES_MINIBATCH,
                                           num_epochs=FRAMES_EPOCHS))
    t0 = time.perf_counter()
    algo = cfg.build()
    torch.cuda.reset_peak_memory_stats()
    try:
        algo.runners = RecordingRunners(algo.runners)
        initial = algo.learner.get_weights()
        results = [algo.train() for _ in range(FRAMES_ITERS)]
        captures = algo.learner.compile_count
        alone = ray_tpu_torch.get(algo.runners.runners[0].__ray_call__.remote(
            timed_sample, SPLIT_STEPS))
        t1 = time.perf_counter()
        moved = algo.runners.runners[0].sample.remote(SPLIT_STEPS)
        moved_steps = sum(e.length for e in ray_tpu_torch.get(moved))
        moved_s = time.perf_counter() - t1
        prof = learn_profile(algo.learner, algo.runners.batches[-1])
        peak = torch.cuda.max_memory_allocated()
        first_eps = algo.runners.batches[0]
        wall = time.perf_counter() - t0
    finally:
        algo.stop()
    n_params = sum(v.numel() for v in initial.values())
    # The comparison over the iteration's first epoch (16 updates), with
    # the CPU's float64 beside it: float32 rounding grows with the updates.
    pair = learner_pair(cfg.policy_config, replace(cfg.hparams, num_epochs=1),
                        initial, first_eps, float64=True)
    per_iter = FRAMES_EPOCHS * (FRAMES_BATCH // FRAMES_MINIBATCH)
    readings = [{"sample_s": r["time_sample_s"], "learn_s": r["time_learn_s"],
                 "steps_per_s": r["num_env_steps_sampled"]
                 / r["time_sample_s"],
                 "updates_per_s": per_iter / r["time_learn_s"]}
                for r in results]
    busy = (f"{prof['busy_s'] / prof['wall_s']:.1%}" if prof["busy_s"]
            else "not measured")
    print(f"rllib (c) PPO on chip_frames, CNN {NATURE_FILTERS} + 512, "
          f"{n_params} parameters, 2 runners, batch {FRAMES_BATCH}, "
          f"minibatch {FRAMES_MINIBATCH} x {FRAMES_EPOCHS} epochs: "
          f"iterations {readings}; losses {[r['total_loss'] for r in results]}"
          f"; {captures} capture(s); one learn phase profiled: host "
          f"{prof['wall_s']:.3f} s, card busy {busy}; peak memory "
          f"{peak / 2**30:.2f} GiB; whole {wall:.1f} s; card {card}",
          flush=True)
    print(f"rllib (c) one runner's sample of {alone['steps']} steps: "
          f"{alone['s']:.2f} s inside the actor ({alone['bytes'] / 1e6:.0f} "
          f"MB of float32 observations), {moved_s:.2f} s to the driver "
          f"through the object store ({moved_steps} steps); card {card}",
          flush=True)
    print(f"rllib (c) the card against the CPU on the first iteration's "
          f"batch, its first epoch ({FRAMES_BATCH // FRAMES_MINIBATCH} "
          f"updates): {describe_pair(pair)}; card {card}", flush=True)
    checks = [
        ("(c) the losses finite", all(np.isfinite(r["total_loss"])
                                      for r in results),
         [r["total_loss"] for r in results]),
        ("(c) one capture", captures == 1, captures),
    ] + pair_checks(pair, "(c)", trajectory=False)
    return {"wall_s": wall, "readings": readings, "prof": prof,
            "peak": peak, "pair": pair}, checks


class RecallEnv:
    """The memory task of tests/test_rllib_recurrent.py: the first
    observation is +1 or -1, later ones 0; only the final action counts,
    and it must match the first sign."""

    def __init__(self, horizon: int = 5, seed: int = 3):
        self.h = horizon
        self.rng = np.random.default_rng(seed)

    def reset(self):
        self.sign = 1 if self.rng.random() < 0.5 else -1
        self.t = 0
        return np.array([self.sign], np.float32)

    def step(self, action):
        self.t += 1
        done = self.t >= self.h
        want = 0 if self.sign > 0 else 1
        reward = float(done and int(action) == want)
        return np.zeros(1, np.float32), reward, done


def recall_episodes(model, n: int, seed: int = 0) -> list:
    """``n`` episodes of the GRU ``model`` (on the CPU) in RecallEnv."""
    from ray_tpu_torch.rllib.env_runner import Episode
    env, rng = RecallEnv(), np.random.default_rng(seed)
    out = []
    for _ in range(n):
        obs, ep, done = env.reset(), Episode(), False
        carry = model.initial_state(1)
        ep.state_in = carry[0].numpy().copy()
        while not done:
            with torch.no_grad():
                logits, value, carry = model(torch.from_numpy(obs[None]),
                                             carry)
            probs = torch.softmax(logits[0], -1).numpy()
            a = int(rng.choice(len(probs), p=probs))
            nobs, r, done = env.step(a)
            ep.obs.append(obs)
            ep.actions.append(a)
            ep.rewards.append(r)
            ep.logps.append(float(np.log(probs[a] + 1e-9)))
            ep.values.append(float(value[0]))
            obs = nobs
        ep.terminated = True
        out.append(ep)
    return out


def recurrent_leg(card: str) -> tuple[dict, list]:
    """(d): the recurrent learner, card against CPU, one iteration."""
    from ray_tpu_torch.rllib.catalog import build_recurrent_actor_critic
    from ray_tpu_torch.rllib.learner import PPOHyperparams
    cfg = {"obs_dim": 1, "num_actions": 2, "hidden": (16,),
           "hidden_state": RECURRENT_HIDDEN}
    hp = PPOHyperparams(lr=5e-3, num_epochs=4, minibatch_size=64,
                        entropy_coeff=0.003)
    model = build_recurrent_actor_critic(cfg, device="cpu")
    weights = {k: p.detach().clone() for k, p in model.named_parameters()}
    eps = recall_episodes(model, RECURRENT_EPISODES)
    pair = learner_pair(cfg, hp, weights, eps, recurrent=True)
    print(f"rllib (d) the recurrent learner (GRU {RECURRENT_HIDDEN}) on "
          f"{RECURRENT_EPISODES} episodes of the memory task: "
          f"{describe_pair(pair)}; captured shapes "
          f"{pair['card']['captures']}; card {card}", flush=True)
    return {"pair": pair}, pair_checks(pair, "(d)") + [
        ("(d) the recurrent update captured (one graph per shape)",
         (pair["card"]["captures"] or 0) >= 1, pair["card"]["captures"])]


def group_batch(n: int = GROUP_ROWS, seed: int = 0) -> dict:
    """(e)'s fixed batch: ``n`` rows for (c)'s model, numpy seed 0."""
    rng = np.random.default_rng(seed)
    return {"obs": rng.integers(0, 256, (n, *FRAME_SHAPE)).astype(
                np.float32),
            "actions": rng.integers(0, RLLIB_ACTIONS, n).astype(np.int64),
            "logp_old": np.full(n, -np.log(RLLIB_ACTIONS), np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "returns": rng.standard_normal(n).astype(np.float32)}


def mean_gradient_update(policy_config: dict, batch: dict, n: int) -> dict:
    """The in-process reference of a group's first update: one learner on
    the card (seed 0, the group's initial weights), the gradients of
    each of the ``n`` shards (as ``LearnerGroup.update`` cuts them),
    their mean, one clip-then-Adam update. Returns the initial and the
    updated weights."""
    from ray_tpu_torch.rllib.learner import TorchLearner
    ln = TorchLearner(policy_config, seed=0)
    start = ln.get_weights()
    size = len(batch["obs"])
    per = size // n
    total = None
    for i in range(n):
        hi = size if i == n - 1 else (i + 1) * per
        grads, _ = ln.compute_grads(ln.params, {k: v[i * per:hi]
                                                for k, v in batch.items()})
        grads = {k: g.clone() for k, g in grads.items()}
        total = grads if total is None else {k: total[k] + grads[k]
                                             for k in total}
    ln.apply_grads({k: g / n for k, g in total.items()})
    out = {"start": start, "updated": ln.get_weights()}
    del ln
    torch.cuda.empty_cache()
    return out


class NoAllreduceLearner(learner_group._LearnerActor._cls):
    """``--plant-fault learner_no_allreduce``: a learner that applies its
    own shard's gradients, skipping the all-reduce."""

    def _allreduce_grads(self, grads):
        return grads


class NoAllreduceGroup(LearnerGroup):
    _actor_class = ray_tpu_torch.remote(NoAllreduceLearner)


def group_leg(n: int, card: str, what: str, fault: str | None = None,
              policy: dict | None = None, batch: dict | None = None
              ) -> tuple[dict, list]:
    """(e) (``n`` = 2 on one card) and (h) (``n`` = 4 on four): a
    LearnerGroup of ``n`` learners on (c)'s model and (e)'s batch (or
    ``policy`` and ``batch``), 3 updates, held against the in-process
    mean-gradient update."""
    policy = policy or frames_config()
    batch = batch if batch is not None else group_batch()
    cls = NoAllreduceGroup if fault else LearnerGroup
    share = min(1.0, ray_tpu_torch.cluster_resources()["GPU"] / n)
    t0 = time.perf_counter()
    group = cls(policy, num_learners=n, seed=0)
    try:
        start_s = time.perf_counter() - t0
        views = ray_tpu_torch.get([ln.__ray_call__.remote(learner_view)
                        for ln in group.learners])
        metrics = [group.update(batch)]
        first = group.get_weights()
        metrics += [group.update(batch) for _ in range(2)]
        digests = group.weights_digests()
        numel = sum(v.numel() for v in first.values())
        rings = ray_tpu_torch.get([ln.__ray_call__.remote(timed_allreduce, numel)
                        for ln in group.learners])
    finally:
        group.shutdown()
    ref = mean_gradient_update(policy, batch, n)
    rel = update_rel(first, ref["updated"], ref["start"])
    ring_s = max(r["s"] for r in rings)
    print(f"rllib {what} LearnerGroup of {n} learners at GPU {share}: "
          f"learners {views}; digests equal {len(set(digests)) == 1}; first "
          f"update against the in-process mean-gradient update relative "
          f"{rel:.3g}; ring all-reduce of {rings[0]['bytes'] / 1e6:.1f} MB "
          f"float32 an update {ring_s * 1e3:.1f} ms; start {start_s:.1f} s; "
          f"whole {time.perf_counter() - t0:.1f} s; card {card}", flush=True)
    checks = [
        (f"{what} the replicas' weights_digests are equal",
         len(set(digests)) == 1, digests),
        (f"{what} the first update against the in-process mean-gradient "
         f"update within {LEARNER_UPDATE_RTOL} (L2)",
         rel <= LEARNER_UPDATE_RTOL, rel),
        (f"{what} every learner on a card", all(
            v["device"] == "cuda:0" for v in views), views),
        (f"{what} the learners' cards: " + (
            "one, shared" if n == 2 else f"{n} distinct"),
         len({v["card"] for v in views}) == (1 if n == 2 else n),
         [v["card"][:13] for v in views]),
    ]
    return {"ring_s": ring_s, "bytes": rings[0]["bytes"], "rel": rel,
            "digests": digests}, checks


def trial_probe(gate: str) -> None:
    """Records, in a trial's process, the card it sees (a file in
    ``gate``)."""
    with open(os.path.join(gate, f"{os.getpid()}.json"), "w") as f:
        json.dump({"cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "card": card_uuid(torch.device("cuda", 0))}, f)


def rllib_tune_builder(env: str, gate: str):
    def builder(config: dict):
        from ray_tpu_torch.rllib import PPOConfig
        trial_probe(gate)
        return (PPOConfig().environment(env, obs_dim=4, num_actions=2)
                .env_runners(1)
                .training(train_batch_size=512, lr=config["lr"]))
    return builder


def checkpoint_and_tune(env: str, a: dict, card: str) -> tuple[dict, list]:
    """(f): (a)'s algorithm (still running, its runners too) through
    save_to_path / from_checkpoint (into an algorithm without runners),
    then stopped; then PPO under Tune at half a card a trial."""
    from ray_tpu_torch.rllib import PPO
    from ray_tpu_torch.train import RunConfig
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rllib_")
    gate = tempfile.mkdtemp(prefix="chip_smoke_gate_")
    try:
        t0 = time.perf_counter()
        algo = a["algo"]
        try:
            algo.save_to_path(os.path.join(tmp, "ckpt"))
            # The learner's state is what round trips: the restored
            # algorithm starts no runners.
            restored = PPO.from_checkpoint(os.path.join(tmp, "ckpt"),
                                           a["cfg"].env_runners(0))
            try:
                want = a["state"]["learner"]
                got = restored.get_state()["learner"]
                bit = (all(np.array_equal(want["params"][k],
                                          got["params"][k])
                           for k in want["params"])
                       and all(np.array_equal(x, y) for key in ("mu", "nu")
                               for x, y in zip(want["opt_state"][key],
                                               got["opt_state"][key])))
                obs = np.random.default_rng(0).standard_normal(
                    (16, 4)).astype(np.float32)
                same = ([algo.compute_single_action(o) for o in obs]
                        == [restored.compute_single_action(o) for o in obs])
                iteration = restored.iteration
            finally:
                restored.stop()
        finally:
            algo.stop()
        ckpt_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        grid = tune.Tuner(
            PPO.as_trainable(rllib_tune_builder(env, gate),
                             num_iterations=2),
            param_space={"lr": tune.grid_search(list(RLLIB_TUNE_LRS))},
            tune_config=tune.TuneConfig(
                resources_per_trial={"CPU": 1, "GPU": RLLIB_TUNE_SHARE},
                max_concurrent_trials=len(RLLIB_TUNE_LRS)),
            run_config=RunConfig(name="rllib", storage_path=tmp)).fit()
        tune_s = time.perf_counter() - t1
        iters = sorted(r.metrics.get("training_iteration") for r in grid)
        probes = []
        for name in os.listdir(gate):
            with open(os.path.join(gate, name)) as f:
                probes.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(gate, ignore_errors=True)
    print(f"rllib (f) checkpoint round trip bit-equal {bit}, iteration "
          f"{iteration}, greedy actions on 16 observations equal {same} "
          f"({ckpt_s:.1f} s); Tuner(PPO.as_trainable) over lr "
          f"{list(RLLIB_TUNE_LRS)} at GPU {RLLIB_TUNE_SHARE}: states "
          f"{sorted(r.state for r in grid)}, training_iteration {iters}, "
          f"trials' cards {probes} ({tune_s:.1f} s); card {card}",
          flush=True)
    mine = card_uuid(torch.device("cuda", 0))
    checks = [
        ("(f) save_to_path / from_checkpoint round trips bit for bit",
         bit and iteration == a["state"]["iteration"], (bit, iteration)),
        ("(f) the same greedy action on 16 observations", same, same),
        ("(f) both trials finish at training_iteration 2",
         iters == [2] * len(RLLIB_TUNE_LRS) and not grid.errors, iters),
        ("(f) each trial's learner on its share of this card",
         len(probes) == len(RLLIB_TUNE_LRS)
         and all(p["card"] == mine for p in probes), probes),
    ]
    return {"ckpt_s": ckpt_s, "tune_s": tune_s}, checks



# -- phase 19 (g): RLlib's other eight algorithms ------------------------------


class ChipChain:
    """The chain of tests/test_rllib_algos.py: walk right along N = 8
    one-hot states; +1 at the end, -0.01 a step; truncated after 30
    steps."""

    N = 8

    def __init__(self):
        self.pos = self.t = 0

    def _obs(self):
        o = np.zeros(self.N, np.float32)
        o[self.pos] = 1.0
        return o

    def reset(self, seed=None, options=None):
        self.pos = self.t = 0
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        self.pos = max(0, min(self.N - 1,
                              self.pos + (1 if int(action) == 1 else -1)))
        term = self.pos == self.N - 1
        return (self._obs(), 1.0 if term else -0.01, term,
                self.t >= 30 and not term, {})


class ChipPoint1D:
    """Point1DEnv of tests/test_rllib_algos.py: drive x to 0 with actions
    in [-1, 1] (x += 0.25 a); reward -x²; 16-step episodes."""

    def __init__(self):
        self.x, self.t = 0.0, 0
        self.rng = np.random.default_rng(0)

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.x, self.t = float(self.rng.uniform(-1.0, 1.0)), 0
        return np.array([self.x], np.float32), {}

    def step(self, action):
        a = float(np.clip(np.asarray(action).reshape(-1)[0], -1, 1))
        self.x = float(np.clip(self.x + 0.25 * a, -2.0, 2.0))
        self.t += 1
        return (np.array([self.x], np.float32), -self.x ** 2, False,
                self.t >= 16, {})


def random_episodes(env, steps: int, sample_action, seed: int = 0) -> list:
    """``steps`` steps of ``env`` under ``sample_action(rng)``, as
    episodes with their final observations."""
    from ray_tpu_torch.rllib.env_runner import Episode
    rng = np.random.default_rng(seed)
    obs, _ = env.reset(seed=seed)
    out, ep = [], Episode()
    for _ in range(steps):
        a = sample_action(rng)
        nobs, r, term, trunc, _ = env.step(a)
        ep.obs.append(np.asarray(obs, np.float32))
        ep.actions.append(a)
        ep.rewards.append(float(r))
        ep.logps.append(float(np.log(0.5)))
        ep.values.append(0.0)
        obs = nobs
        if term or trunc:
            ep.terminated, ep.truncated = term, trunc
            ep.final_obs = np.asarray(obs, np.float32)
            out.append(ep)
            ep = Episode()
            obs, _ = env.reset()
    if ep.length:
        ep.final_obs = np.asarray(obs, np.float32)
        out.append(ep)
    return out


def offline_data(kind: str, rows: int = OFFLINE_ROWS, seed: int = 0) -> dict:
    """(g)'s offline datasets from numpy seed 0: a linear expert's (obs,
    action) pairs for BC; half expert, half anti-expert with returns ±1
    for MARWIL (tests/test_rllib_algos.py's tasks); for CQL, logged
    Point1D transitions of a noisy proportional controller."""
    rng = np.random.default_rng(seed)
    if kind == "cql":
        env, cols = ChipPoint1D(), {k: [] for k in (
            "obs", "action", "reward", "next_obs", "done")}
        o, _ = env.reset(seed=seed)
        for t in range(rows):
            a = float(np.clip(-0.8 * o[0] + rng.normal() * 0.7, -1, 1))
            no, r, term, trunc, _ = env.step([a])
            for k, v in (("obs", o), ("action", [a]), ("reward", r),
                         ("next_obs", no), ("done", float(term))):
                cols[k].append(v)
            o = no
            if term or trunc:
                o, _ = env.reset(seed=seed + t + 1)
        return {k: np.asarray(v, np.float32) for k, v in cols.items()}
    obs = rng.standard_normal((rows, 4)).astype(np.float32)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    expert = np.argmax(obs @ w, axis=1).astype(np.int64)
    if kind == "bc":
        return {"obs": obs, "action": expert}
    anti = np.argmin(obs @ w, axis=1).astype(np.int64)
    take = rng.random(rows) < 0.5
    return {"obs": obs, "action": np.where(take, expert, anti),
            "return": np.where(take, 1.0, -1.0).astype(np.float32)}


def record_grads(*opts) -> list:
    """Each optimizer's ``update`` records the gradients it is given
    (float64 on the CPU, flat); returns the list they go into, one entry
    per update made. A captured step's first call is its warm-up (the
    update, recorded) and then its capture, which updates nothing and is
    not recorded."""
    seen = []
    for opt in opts:
        inner = opt.update

        def update(grads, state, params, inner=inner):
            if not (torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
                seen.append(torch.cat([
                    g.detach().reshape(-1).double().cpu()
                    for g in grads if g is not None]))
            return inner(grads, state, params)

        opt.update = update
    return seen


class StaleCriticSAC:
    """``--plant-fault sac_stale_critic``: a SAC learner whose actor step
    runs before the critic's, so the actor reads the critic as it was
    before the critic's update (made a subclass of SACLearner when
    used)."""

    def _body(self, state, batch) -> dict:
        m, opt_state = state.params, state.opt_state
        alpha = torch.exp(m["alpha"].log_alpha.detach())
        y = self._soft_target(m, batch, alpha)
        a_loss, mean_logp = self._actor_step(m, opt_state, batch, alpha)
        c_loss = self._critic_step(m, opt_state, batch, y)
        self._alpha_step(m, opt_state, mean_logp)
        self._polyak(m)
        return {"critic_loss": c_loss, "actor_loss": a_loss,
                "alpha": torch.exp(m["alpha"].log_alpha.detach()),
                "entropy": -mean_logp}


def algo_learners(fault: str | None = None) -> dict:
    """(g): for each learner, ``make(device)`` (seed 0: the same initial
    weights on any device, the catalog draws them on the CPU), the
    optimizers whose gradients are recorded, the modules compared, and
    ``work()``: the batches (and noise, drawn on the CPU) of one update
    and of one iteration, made once for both devices. ``fault``
    (``sac_stale_critic``) swaps the card's SAC learner for the faulty
    one."""
    from ray_tpu_torch.rllib import (
        appo, bc, cql, dqn, dreamer, impala, marwil, sac,
    )
    from ray_tpu_torch.rllib.learner import gumbel
    chain = {"obs_dim": 8, "num_actions": 2, "hidden": (64, 64)}
    cont = {"obs_dim": 1, "action_dim": 1, "hidden": (64, 64)}
    coin = lambda r: int(r.integers(2))              # noqa: E731
    out = {}

    def single(make, work, mlp=True):
        return {"make": make, "opts": lambda ln: (ln.opt,),
                "modules": lambda ln: (ln.model,), "work": work,
                "step": lambda ln, b: ln.update(b), "mlp": mlp}

    def vtrace_work():
        # IMPALA's iteration is one update on its episodes' [B, 64] block.
        eps = random_episodes(ChipChain(), 256, coin)[:8]
        ref = impala.ImpalaLearner(chain, impala.ImpalaHyperparams(), 64,
                                   device="cpu")
        batch = ref.make_batch(eps)
        return [batch], [batch]

    out["impala"] = single(lambda d: impala.ImpalaLearner(
        chain, impala.ImpalaHyperparams(), 64, device=d), vtrace_work)
    out["appo"] = single(lambda d: appo.APPOLearner(
        chain, appo.APPOHyperparams(), 64, device=d), vtrace_work)

    def dqn_work():
        hp = dqn.DQNHyperparams()
        buf = dqn.ReplayBuffer(hp.buffer_size, 8)
        buf.add_episodes(random_episodes(ChipChain(), 2048, coin))
        rng = np.random.default_rng(0)
        batches = [buf.sample(hp.train_batch_size, rng)
                   for _ in range(hp.num_gradient_steps)]
        return batches[:1], batches

    out["dqn"] = single(lambda d: dqn.DQNLearner(
        chain, dqn.DQNHyperparams(), device=d), dqn_work)

    def continuous(make, hp, rows_of, penalty: int = 0):
        def work():
            data, rng = rows_of(), np.random.default_rng(0)
            gen = torch.Generator().manual_seed(1)
            b, n = hp.train_batch_size, len(data["obs"])
            shapes = {"noise_next": (b, 1), "noise": (b, 1)}
            if penalty:
                shapes.update(a_rand=(b, penalty, 1),
                              noise_pi=(b * penalty, 1))
            steps = []
            for _ in range(hp.num_gradient_steps):
                idx = rng.integers(0, n, b)
                noise = {k: (torch.rand(s, generator=gen) * 2 - 1
                             if k == "a_rand" else
                             torch.randn(s, generator=gen))
                         for k, s in shapes.items()}
                steps.append(({k: v[idx] for k, v in data.items()}, noise))
            return steps[:1], steps

        return {"make": make,
                "opts": lambda ln: (ln.critic_opt, ln.actor_opt,
                                    ln.alpha_opt),
                "modules": lambda ln: (ln.actor, ln.critic,
                                       ln.target_critic),
                "work": work, "mlp": True,
                "step": lambda ln, s: ln.update(s[0], noise=s[1])}

    def sac_rows():
        buf = sac.ContinuousReplayBuffer(100_000, 1, 1)
        buf.add_episodes(random_episodes(
            ChipPoint1D(), 2048,
            lambda r: np.array([r.uniform(-1, 1)], np.float32)))
        return {k: getattr(buf, k)[:buf.size] for k in (
            "obs", "actions", "rewards", "next_obs", "dones")}

    def cql_rows():
        d = offline_data("cql")
        return {"obs": d["obs"], "actions": d["action"],
                "rewards": d["reward"], "next_obs": d["next_obs"],
                "dones": d["done"]}

    card_sac = sac.SACLearner
    if fault == "sac_stale_critic":
        card_sac = type("StaleCriticSACLearner",
                        (StaleCriticSAC, sac.SACLearner), {})
    sac_hp, cql_hp = sac.SACHyperparams(), cql.CQLHyperparams()
    out["sac"] = continuous(
        lambda d: (card_sac if d is None else sac.SACLearner)(
            cont, sac_hp, device=d), sac_hp, sac_rows)
    out["cql"] = continuous(
        lambda d: cql.CQLLearner(cont, cql_hp, device=d), cql_hp, cql_rows,
        cql_hp.num_penalty_actions)

    def offline(kind, learner_cls, hp):
        def work():
            data, rng = offline_data(kind), np.random.default_rng(0)
            n = len(data["obs"])
            batches = [{k: v[idx] for k, v in data.items()} for idx in (
                rng.integers(0, n, hp.train_batch_size)
                for _ in range(hp.num_gradient_steps))]
            return batches[:1], batches

        return single(lambda d: learner_cls(
            {"obs_dim": 4, "num_actions": 3, "hidden": (64, 64)}, hp,
            device=d), work)

    out["bc"] = offline("bc", bc.BCLearner, bc.BCHyperparams())
    out["marwil"] = offline("marwil", marwil.MARWILLearner,
                            marwil.MARWILHyperparams())

    def dreamer_work():
        hp, cfg = dreamer.DreamerHyperparams(), dreamer.DreamerModelConfig()
        buf = dreamer.SequenceReplay(hp.buffer_steps, hp.seq_len)
        buf.add_episodes(random_episodes(ChipCartPole(), 2048, coin))
        gen, n = torch.Generator().manual_seed(1), hp.batch_size * hp.seq_len
        noise = {"wm": gumbel((hp.seq_len, hp.batch_size, cfg.n_cat,
                               cfg.n_classes), gen, "cpu"),
                 "ac_a": gumbel((hp.horizon, n, cfg.num_actions), gen,
                                "cpu"),
                 "ac_z": gumbel((hp.horizon, n, cfg.n_cat, cfg.n_classes),
                                gen, "cpu")}
        step = (buf.sample(hp.batch_size, np.random.default_rng(0)), noise)
        return [step], [step]

    out["dreamer"] = {"make": lambda d: dreamer.DreamerLearner(
        dreamer.DreamerModelConfig(), dreamer.DreamerHyperparams(),
        device=d), "opts": lambda ln: (ln.wm_opt, ln.ac_opt),
        "modules": lambda ln: (ln.module,), "work": dreamer_work,
        "step": lambda ln, s: ln.update(s[0], noise=s[1]), "mlp": False}
    return out


def named_weights(modules) -> dict:
    """Every parameter of ``modules``, float64 on the CPU, by module index
    and name."""
    return {f"{i}.{k}": p.detach().to("cpu", torch.float64, copy=True)
            for i, m in enumerate(modules) for k, p in m.named_parameters()}


def algo_pair(spec: dict) -> dict:
    """One learner's (g) comparison: on the card and on the CPU from the
    same weights, first one update (the gradients and the updates
    compared), then (the MLP learners) a whole iteration's updates from
    the start again (the parameters and the last metrics compared)."""
    one, iteration = spec["work"]()
    out = {}
    for name, device in (("card", None), ("cpu", "cpu")):
        ln = spec["make"](device)
        modules = spec["modules"](ln)
        start = named_weights(modules)
        seen = record_grads(*spec["opts"](ln))
        t0 = time.perf_counter()
        spec["step"](ln, one[0])
        if device is None:
            torch.cuda.synchronize()
        res = {"grad": torch.cat(seen), "start": start,
               "one": named_weights(modules),
               "one_s": time.perf_counter() - t0, "device": str(ln.device),
               "captures": ln.compile_count}
        if spec["mlp"]:
            ln = spec["make"](device)
            modules = spec["modules"](ln)
            t0 = time.perf_counter()
            for step in iteration:
                metrics = spec["step"](ln, step)
            if device is None:
                torch.cuda.synchronize()
            res.update(iteration_s=time.perf_counter() - t0,
                       metrics=metrics, updates=len(iteration),
                       captures=ln.compile_count,
                       whole=named_weights(modules))
        out[name] = res
        del ln, modules
    torch.cuda.empty_cache()
    card, cpu = out["card"], out["cpu"]
    out["same_start"] = all(torch.equal(card["start"][k], cpu["start"][k])
                            for k in cpu["start"])
    out["grad_rel"] = float((card["grad"] - cpu["grad"]).norm()
                            / cpu["grad"].norm())
    out["one_rel"] = update_rel(card["one"], cpu["one"], cpu["start"])
    if "whole" in cpu:
        out["rel"] = update_rel(card["whole"], cpu["whole"], cpu["start"])
        scale = max(abs(v) for v in cpu["metrics"].values()) or 1.0
        out["metric_rel"] = max(
            abs(card["metrics"][k] - v) / max(abs(v), scale)
            for k, v in cpu["metrics"].items())
    return out


def algo_pair_checks(name: str, r: dict) -> list[tuple]:
    checks = [(f"(g) {name}: the same initial weights on the card and the "
               f"CPU; the first update's gradient on the card against the "
               f"CPU's within {LEARNER_GRAD_RTOL} (L2), the update within "
               f"{LEARNER_UPDATE_RTOL} of its size",
               r["same_start"] and r["grad_rel"] <= LEARNER_GRAD_RTOL
               and r["one_rel"] <= LEARNER_UPDATE_RTOL
               and r["card"]["device"] == "cuda:0",
               {"grad_rel": r["grad_rel"], "one_rel": r["one_rel"]})]
    if "rel" in r:
        checks.append((
            f"(g) {name}: a whole iteration ({r['card']['updates']} "
            f"updates) on the card against the CPU's within "
            f"{LEARNER_UPDATE_RTOL} of the update (L2), metrics within "
            f"{LEARNER_METRIC_RTOL}",
            r["rel"] <= LEARNER_UPDATE_RTOL
            and r["metric_rel"] <= LEARNER_METRIC_RTOL,
            {"rel": r["rel"], "metric_rel": r["metric_rel"]}))
    return checks


def describe_algo_pair(name: str, r: dict) -> str:
    whole = (f"; a whole iteration of {r['card']['updates']} updates: "
             f"card vs CPU relative {r['rel']:.3g}, metrics "
             f"{r['metric_rel']:.3g}, card {r['card']['iteration_s']:.3f} s, "
             f"CPU {r['cpu']['iteration_s']:.3f} s" if "rel" in r else "")
    return (f"{name}: gradient relative {r['grad_rel']:.3g}, one update "
            f"relative {r['one_rel']:.3g} (card {r['card']['one_s']:.3f} s "
            f"with its capture, CPU {r['cpu']['one_s']:.3f} s){whole}; "
            f"compile_count {r['card']['captures']}")


def algo_configs(env: str) -> dict:
    """(g)'s train() runs: each algorithm at its defaults (MLPs 64 x 64,
    DQN's 50 000-step buffer, DreamerModelConfig()) on its toy task,
    the learner on the card, one runner each (Dreamer's default; the
    others' two cut to one); SAC at the JAX test's learning_starts 256,
    16 gradient steps."""
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch import rllib
    chain = {"obs_dim": 8, "num_actions": 2}
    cfgs = {
        "dqn": rllib.DQNConfig().environment(ChipChain, **chain),
        "impala": rllib.ImpalaConfig().environment(ChipChain, **chain),
        "appo": rllib.APPOConfig().environment(ChipChain, **chain),
        "sac": rllib.SACConfig().environment(ChipPoint1D, obs_dim=1,
                                              action_dim=1)
        .training(learning_starts=256, num_gradient_steps=16),
    }
    cfgs = {k: c.env_runners(1) for k, c in cfgs.items()}
    cfgs["dreamer"] = rllib.DreamerConfig().environment(env, obs_dim=4,
                                                        num_actions=2)
    cql = offline_data("cql")
    cfgs["bc"] = rllib.BCConfig().environment(obs_dim=4, num_actions=3) \
        .offline_data(rdata.from_numpy(offline_data("bc"), parallelism=4))
    cfgs["marwil"] = rllib.MARWILConfig().environment(
        obs_dim=4, num_actions=3).offline_data(rdata.from_numpy(
            offline_data("marwil"), parallelism=4))
    cfgs["cql"] = rllib.CQLConfig().environment(obs_dim=1, action_dim=1) \
        .offline_data(rdata.from_numpy(cql, parallelism=4))
    return cfgs


def updates_of(name: str, cfg, result: dict) -> int:
    """The learner updates a train() iteration made (Dreamer's: a world-
    model and an actor-critic step each)."""
    hp = cfg.hparams
    if name in ("impala", "appo"):
        return 1
    if name == "dreamer":
        return hp.wm_updates_per_iter if "wm_loss" in result else 0
    learned = name in ("bc", "marwil", "cql") or any(
        k in result for k in ("loss", "critic_loss"))
    return hp.num_gradient_steps if learned else 0


def learner_device(learner) -> str:
    params = getattr(learner, "actor_params", None) or learner.params
    return str(next(iter(params.values())).device)


def algo_train(env: str, card: str) -> tuple[dict, list]:
    """(g)'s train() runs: the eight algorithms built at once (the five
    runner-backed ones' runners start together), then each algorithm's
    ALGO_ITERS iterations (OFFLINE_ITERS for the offline three)."""
    from concurrent.futures import ThreadPoolExecutor
    cfgs = algo_configs(env)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cfgs)) as pool:
        built = dict(zip(cfgs, pool.map(lambda c: c.build(),
                                        cfgs.values())))
    start_s = time.perf_counter() - t0
    readings, checks = {}, []
    try:
        for name, algo in built.items():
            offline = name in ("bc", "marwil", "cql")
            t1 = time.perf_counter()
            results = [algo.train() for _ in range(
                OFFLINE_ITERS if offline else ALGO_ITERS)]
            wall = time.perf_counter() - t1
            steps = sum(r.get("num_env_steps_sampled", 0) for r in results)
            sample_s = sum(r.get("time_sample_s", 0.0) for r in results)
            updates = sum(updates_of(name, cfgs[name], r) for r in results)
            learn_s = sum(r["time_learn_s"] for r in results)
            device = learner_device(algo.learner)
            finite = all(np.isfinite(v) for r in results for k, v in
                         r.items() if k.endswith("loss"))
            readings[name] = {
                "iterations": len(results), "env_steps": steps,
                "env_steps_per_s": steps / sample_s if sample_s else None,
                "updates": updates,
                "updates_per_s": updates / learn_s if learn_s else None,
                "compile_count": algo.learner.compile_count,
                "device": device, "wall_s": wall,
                "reward": [round(r.get("episode_reward_mean", np.nan), 3)
                           for r in results]}
            checks.append((f"(g) {name}: {len(results)} train() iterations "
                           f"with the learner on the card, updates made, "
                           f"losses finite, captured",
                           device == "cuda:0" and updates > 0 and finite
                           and (algo.learner.compile_count or 0) >= 1,
                           readings[name]))
    finally:
        for algo in built.values():
            algo.stop()
    for name, r in readings.items():
        rate = (f"{r['env_steps_per_s']:.0f} env steps/s, "
                if r["env_steps_per_s"] else "offline, ")
        print(f"rllib (g) {name} train(): {r['iterations']} iterations, "
              f"{r['env_steps']} env steps, {r['updates']} updates; {rate}"
              f"{r['updates_per_s']:.1f} updates/s; compile_count "
              f"{r['compile_count']}; learner on {r['device']}; "
              f"episode_reward_mean {r['reward']}; {r['wall_s']:.1f} s; "
              f"card {card}", flush=True)
    print(f"rllib (g) the eight algorithms built together (the five "
          f"runner-backed ones' runners started at once) in {start_s:.1f} s; "
          f"card {card}", flush=True)
    return {"start_s": start_s, "readings": readings}, checks


def algos_leg(env: str, card: str, fault: str | None = None
              ) -> tuple[dict, list]:
    """(g): every learner card against CPU, then every algorithm's
    train() on the card (``fault``: the learner comparisons only)."""
    t0 = time.perf_counter()
    specs = algo_learners(fault)
    if fault:
        specs = {"sac": specs["sac"]}
    pairs, checks = {}, []
    for name, spec in specs.items():
        pairs[name] = algo_pair(spec)
        print(f"rllib (g) {describe_algo_pair(name, pairs[name])}; card "
              f"{card}", flush=True)
        checks += algo_pair_checks(name, pairs[name])
    out = {"pairs": pairs, "pairs_s": time.perf_counter() - t0}
    if not fault:
        trained, more = algo_train(env, card)
        checks += more
        out["train"] = trained
    out["wall_s"] = time.perf_counter() - t0
    return out, checks


def rllib_phase(card: str) -> dict:
    """Phase 19: RLlib on the card (module docstring). Returns each leg's
    time."""
    import ray_tpu_torch as rt
    times = {}
    rt.init()
    try:
        env = cartpole_env()
        t = time.perf_counter()
        a, checks = ppo_cartpole(env, card)
        times["a+b"] = time.perf_counter() - t
        # (a)'s algorithm runs on until (f)'s checkpoint round trip.
        report_checks(checks, card, prefix="rllib")
        t = time.perf_counter()
        c, checks = ppo_frames(card)
        times["c"] = time.perf_counter() - t
        report_checks(checks, card, prefix="rllib")
        t = time.perf_counter()
        _, checks = recurrent_leg(card)
        times["d"] = time.perf_counter() - t
        report_checks(checks, card, prefix="rllib")
        t = time.perf_counter()
        e, checks = group_leg(2, card, "(e)")
        times["e"] = time.perf_counter() - t
        report_checks(checks, card, prefix="rllib")
        t = time.perf_counter()
        _, checks = checkpoint_and_tune(env, a, card)
        times["f"] = time.perf_counter() - t
        report_checks(checks, card, prefix="rllib")
        t = time.perf_counter()
        _, checks = algos_leg(env, card)
        times["g"] = time.perf_counter() - t
        report_checks(checks, card, prefix="rllib")
    finally:
        rt.shutdown()
    torch.cuda.empty_cache()
    return times


def rllib_fault_main(name: str, card: str) -> int:
    """``--plant-fault`` of RLLIB_FAULTS: the build, then the leg the fault
    is planted in, its checks read without raising. ``learner_no_allreduce``
    runs phase 19's (e) with learners that skip the all-reduce (caught
    when the digests or the mean-gradient comparison fail it);
    ``sac_stale_critic`` runs (g)'s SAC comparison with the faulty
    learner on the card (caught when the card-against-CPU check fails it).
    Exits 1 when caught, 2 when not, and 2 when the run failed before the
    leg's checks."""
    import ray_tpu_torch as rt
    print(f"planted fault {name}: {RLLIB_FAULTS[name]}", flush=True)
    try:
        t0 = time.perf_counter()
        build.ensure_built()
        print(f"build: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
        if name == "sac_stale_critic":
            readings, checks = algos_leg("", card, fault=name)
            keys, sac = ("(g) sac",), readings["pairs"]["sac"]
            reading = {"grad_rel": sac["grad_rel"], "one_rel": sac["one_rel"],
                       "rel": sac["rel"]}
        else:
            rt.init()
            try:
                readings, checks = group_leg(2, card, "(e)", fault=name)
            finally:
                rt.shutdown()
            keys = ("digests", "mean-gradient")
            reading = {"digests_equal": len(set(readings["digests"])) == 1,
                       "update_rel": readings["rel"]}
        report_checks(checks, card, strict=False, prefix="rllib")
    except Exception:  # noqa: BLE001 — the harness failed, not the leg
        traceback.print_exc()
        print(json.dumps({"fault": name, "caught": False,
                          "failed_before_checks": True}), flush=True)
        return 2
    caught = not all(ok for what, ok, _ in checks
                     if any(k in what for k in keys))
    print(json.dumps({"fault": name, **reading, "caught": caught}),
          flush=True)
    return 1 if caught else 2


def rllib_cards_phase(n: int, card: str) -> None:
    """``--cards n``'s RLlib leg: (e) again (two learners at half of card
    0, for its ring time beside (h)'s), then (h): ``n`` learners at
    ``GPU: 1``."""
    import ray_tpu_torch as rt
    rt.init(num_gpus=1)
    try:
        e, checks = group_leg(2, card, "(e)")
    finally:
        rt.shutdown()
    report_checks(checks, card, prefix="rllib")
    rt.init()
    try:
        h, checks = group_leg(n, card, "(h)")
    finally:
        rt.shutdown()
    report_checks(checks, card, prefix="rllib")
    print(f"multicard rllib: the ring all-reduce of "
          f"{h['bytes'] / 1e6:.1f} MB an update: {n} learners on {n} cards "
          f"{h['ring_s'] * 1e3:.1f} ms, 2 learners on one card "
          f"{e['ring_s'] * 1e3:.1f} ms; card {card}", flush=True)


# -- phase 20: nodes ---------------------------------------------------------


def maps_of(pid: int) -> str:
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


def compute_pids() -> list[int]:
    """Processes holding a CUDA context on a card, as nvidia-smi lists
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


class NodeGPT2Actor:
    """Phase 20 (b), (c): GPT-2 124M in a runtime actor that a node
    daemon hosts, the same steps as phase 14 (c)'s actor."""

    def train(self, weights: dict, host, steps: int, capture: bool) -> dict:
        t0 = time.perf_counter()
        self.model = GPT2(GPT2Config.small(), seed=1)   # other weights ...
        load_weights(self.model, weights)               # ... replaced
        run = gpt2_steps(self.model, host, steps, 0, capture)
        run["setup_s"] = time.perf_counter() - t0
        run.update(pid=os.getpid(),
                   visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                   node=os.environ.get("RAY_TPU_NODE_ID"),
                   gpu_ids=ray_tpu_torch.get_gpu_ids(),
                   device_count=torch.cuda.device_count())
        return run

    def wte(self) -> np.ndarray:
        """The trained tied embedding, float32 (50304 x 768)."""
        return self.model.wte.weight.detach().float().cpu().numpy()

    def wte_sha(self) -> str:
        return hashlib.sha256(self.wte().tobytes()).hexdigest()


def node_trainer_loop(config: dict) -> None:
    """Phase 20 (d)'s loop: GPT-2 124M from the weights in the object
    store, ``config["steps"]`` captured steps, each reported with the
    train state and its position as a checkpoint. A restored run resumes
    after its checkpoint's step; the first run, after the report of
    ``config["drain_at"]``, marks ``config["mark"]`` and waits there for
    its node to be drained."""
    from ray_tpu_torch import train
    t_start = time.time()
    dev = initialize()
    model = GPT2(GPT2Config.small(), seed=1, device=dev)
    load_weights(model, ray_tpu_torch.get(config["weights"]))
    opt = lm_opt()
    state = init_train_state(model, opt)
    step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                           grad_norm=False)
    batch = device_batch(*config["host"], dev)
    start, restored = 0, train.get_checkpoint()
    if restored is not None:
        d = restored.to_directory()
        restore_train_state(os.path.join(d, "state"), state)
        with open(os.path.join(d, "position.json")) as f:
            start = json.load(f)["step"] + 1
    losses = {}
    with contextlib.nullcontext() if config["capture"] else disable_capture():
        fa.reset_launch_counts()
        for i in range(start, config["steps"]):
            loss = float(step(state, batch)[1]["loss"])
            losses[i] = loss
            with tempfile.TemporaryDirectory(prefix="chip_smoke_node_") as d:
                save_train_state(state, os.path.join(d, "state"))
                with open(os.path.join(d, "position.json"), "w") as f:
                    json.dump({"step": i}, f)
                train.report(
                    {"step": i, "loss": loss, "t": time.time(),
                     "resumed": restored is not None,
                     "node": os.environ.get("RAY_TPU_NODE_ID"),
                     "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                     "counts": fa.launch_counts(), "t_start": t_start,
                     "compile_count": compile_count(step)},
                    checkpoint=train.Checkpoint.from_directory(d))
            if i == config["drain_at"] and restored is None:
                # What this run did: fit()'s history keeps the last run's.
                with open(config["mark"] + ".tmp", "w") as f:
                    json.dump({"losses": losses, "t_start": t_start,
                               "node": os.environ.get("RAY_TPU_NODE_ID"),
                               "visible": os.environ.get(
                                   "CUDA_VISIBLE_DEVICES")}, f)
                os.replace(config["mark"] + ".tmp", config["mark"])
                time.sleep(600)    # the drain of this node ends the run


def wait_for(cond, timeout: float, what: str, period: float = 0.05):
    """``cond()``'s first truthy value within ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = cond()
        if out:
            return out
        time.sleep(period)
    raise AssertionError(f"{what} did not happen within {timeout} s")


def node_processes_left(daemons: set, timeout: float = 20.0) -> list[str]:
    """Processes that outlive ``daemons`` (pids of node daemons, or of
    any processes) by ``timeout`` seconds: one of them, or a worker a
    daemon of them spawned (its socket's path names its daemon's pid),
    whether reparented or not."""
    marks = [f"/node-{pid}-" for pid in daemons]

    def left() -> list[str]:
        out = []
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/stat") as f:
                    state = f.read().rsplit(")", 1)[1].split()[0]
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode()
            except (OSError, IndexError):
                continue
            if state != "Z" and (int(pid) in daemons
                                 or any(m in cmd for m in marks)):
                out.append(f"{pid}: {cmd[:160]}")
        return out
    deadline = time.monotonic() + timeout
    while (out := left()) and time.monotonic() < deadline:
        time.sleep(0.1)
    return out


def nodes_phase(card: str, runtime: dict) -> dict:
    """Phase 20 (a)-(d) on one card (see the module docstring). Returns
    the node actor's launches and the legs' seconds."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.api import get_runtime
    from ray_tpu_torch.core.config import env_overrides
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    n = GPT2Config.small().n_layer
    want_captures = 1 if CAPTURE else None
    # This process's card, as a daemon started on it reports it.
    gpu_id = node_gpu_ids(1)[0]
    legs = {}
    cfg = GPT2Config.small()
    host = train_batch(cfg.vocab_size)
    weights = numpy_weights(GPT2(cfg, seed=0))    # phase 14 (c)'s weights
    torch.cuda.empty_cache()
    storage = tempfile.mkdtemp(prefix="chip_smoke_nodes_")
    with env_overrides(drain_grace_period_s=NODE_DRAIN_GRACE_S,
                       drain_deadline_s=NODE_DRAIN_DEADLINE_S):
        c = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0})
        try:
            # (a) The cluster: a head without a card, a daemon on this one.
            t0 = time.perf_counter()
            node = c.add_node(num_cpus=2, num_gpus=1, gpu_ids=[gpu_id],
                              labels={"chip_smoke": "gpu"}, timeout_s=60)
            legs["daemon_s"] = time.perf_counter() - t0
            head = get_runtime()
            rec = head._nodes[node.node_id]
            row = next(r for r in rt.nodes()
                       if r["Labels"].get("chip_smoke") == "gpu")
            maps = maps_of(node.proc.pid)
            print(f"nodes (a) a Cluster with a card-less head and a node "
                  f"daemon (pid {node.proc.pid}) on card {gpu_id}: "
                  f"registered in {legs['daemon_s']:.2f} s; its GPU row "
                  f"{row['Resources'].get('GPU')}, card ids "
                  f"{sorted(rec.cards)}; its maps name libtorch "
                  f"{'libtorch' in maps}, libcuda {'libcuda' in maps}; "
                  f"card {card}", flush=True)
            check(row["NodeID"] == node.node_id
                  and row["Resources"].get("GPU") == 1.0
                  and list(rec.cards) == [gpu_id],
                  "the daemon's node has its GPU row and card as registered")
            check("libtorch" not in maps and "libcuda" not in maps,
                  "the node daemon holds no CUDA context")

            # (b) An actor on the daemon's node, by its label.
            weights_ref = rt.put(weights)
            pin = NodeAffinitySchedulingStrategy(row["NodeID"])
            t0 = time.perf_counter()
            actor = rt.remote(num_gpus=1)(NodeGPT2Actor).options(
                scheduling_strategy=pin).remote()
            run = rt.get(actor.train.remote(weights_ref, host,
                                            CAPTURE_STEPS, CAPTURE))
            legs["actor_s"] = time.perf_counter() - t0
            pids = compute_pids()
            actor_cuda = "libcuda" in maps_of(run["pid"])
            daemon_cuda = "libcuda" in maps_of(node.proc.pid)
            ref_losses = runtime["actor_losses"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(
                run["losses"], ref_losses, strict=True))
            print(f"nodes (b) GPT-2 124M B={TRAIN_BATCH} T={TRAIN_SEQ} in a "
                  f"num_gpus=1 actor on the daemon's node (pid {run['pid']}, "
                  f"CUDA_VISIBLE_DEVICES={run['visible']!r}, get_gpu_ids "
                  f"{run['gpu_ids']}, {run['device_count']} device): losses "
                  f"{run['losses']} vs phase 14 (c)'s {ref_losses}, "
                  f"bit-equal {run['losses'] == ref_losses}, largest "
                  f"relative difference {rel:.3g} (limit "
                  f"{CAPTURE_LOSS_RTOL}); compile_count "
                  f"{run['compile_count']}; launches {run['counts']}; "
                  f"actor created to result {legs['actor_s']:.1f} s (its "
                  f"model built and trained in {run['setup_s']:.1f} s); "
                  f"nvidia-smi's compute pids {pids} (pids of the card's "
                  f"host, not of this machine's namespace; the actor "
                  f"{run['pid']}, the daemon {node.proc.pid}); libcuda "
                  f"mapped in the actor {actor_cuda}, in the daemon "
                  f"{daemon_cuda}; card {card}", flush=True)
            check(run["node"] == node.node_id and run["visible"] == gpu_id
                  and run["gpu_ids"] == [int(gpu_id)]
                  and run["device_count"] == 1,
                  "the node's actor sees the daemon's card and only it")
            # nvidia-smi lists the contexts by pids of another namespace
            # here, so each process's own maps say who holds one.
            check(actor_cuda and not daemon_cuda and len(pids) >= 2,
                  "the actor holds a CUDA context and the daemon none")
            check(rel <= CAPTURE_LOSS_RTOL, "the node actor's losses match "
                  "phase 14 (c)'s")
            check(run["compile_count"] == want_captures and run["donated"],
                  f"the node actor's step captured {want_captures} time(s)")
            check_counts({"n_steps": CAPTURE_STEPS, "counts": run["counts"]},
                         {name: n for name in SQUARE}, "the node actor")

            # (c) The object plane: the trained wte from the daemon's store.
            sha_ref = actor.wte_sha.remote()
            wte_ref = actor.wte.remote()
            rt.wait([wte_ref], timeout=300)
            loc = head._obj_locations.get(wte_ref.id)
            t0 = time.perf_counter()
            wte = rt.get(wte_ref)
            pull_s = time.perf_counter() - t0
            mb = wte.nbytes / 1e6
            same = hashlib.sha256(wte.tobytes()).hexdigest() == rt.get(sha_ref)
            legs["pull_mb_s"] = mb / pull_s
            print(f"nodes (c) the actor's wte {wte.shape} {wte.dtype}, "
                  f"{mb:.1f} MB, homed {loc}: pulled from the daemon's store "
                  f"in {pull_s:.3f} s, {mb / pull_s:.1f} MB/s (PR 14: ~9 MB/s "
                  f"through the one-node store); sha256 equal on both sides "
                  f"{same}; card {card}", flush=True)
            check(isinstance(loc, tuple) and loc[1] == node.node_id,
                  "the actor's return stays in its daemon's store")
            check(same and wte.shape == (cfg.vocab_size, cfg.n_embd),
                  "the pulled wte is bit-equal")
            rt.kill(actor)
            del wte

            # (d) A trainer that survives a drain of its node.
            mark = os.path.join(storage, "drain_now")
            drained: dict = {}

            def drain_then_replace():
                wait_for(lambda: os.path.exists(mark), 600,
                         "the trainer's second report")
                drained["t"] = time.time()
                node.proc.send_signal(signal.SIGTERM)
                # The replacement joins while the drain runs: the
                # draining node takes no new work, so the gang's
                # restart lands on the replacement's card.
                wait_for(lambda: head._nodes[node.node_id].draining, 60,
                         "the drain's start")
                drained["replacement"] = c.add_node(
                    num_cpus=2, num_gpus=1, gpu_ids=[gpu_id],
                    labels={"chip_smoke": "gpu"}, timeout_s=60)

            t = threading.Thread(target=drain_then_replace, daemon=True)
            t.start()
            trainer = TorchTrainer(
                node_trainer_loop,
                train_loop_config={"weights": weights_ref, "host": host,
                                   "steps": CAPTURE_STEPS,
                                   "drain_at": NODE_DRAIN_AT, "mark": mark,
                                   "capture": CAPTURE},
                scaling_config=ScalingConfig(num_workers=1, gpus_per_worker=1),
                run_config=RunConfig(
                    name="drain", storage_path=storage,
                    failure_config=FailureConfig(max_failures=0)))
            t0 = time.time()
            result = trainer.fit()
            legs["fit_s"] = time.time() - t0
            t.join(120)
            wait_for(lambda: not head._nodes[node.node_id].alive, 60,
                     "the drained daemon's exit")
            check(result.error is None, f"fit() through a drain: "
                  f"{result.error}")
            resumed = [m for m in result.metrics_history if m["resumed"]]
            with open(mark) as f:
                first = json.load(f)
            first["steps"] = sorted(int(i) for i in first["losses"])
            want = runtime["trainer_losses"]
            got = {m["step"]: m["loss"] for m in resumed}
            rel = max(abs(got[i] - want[i]) / abs(want[i]) for i in got)
            legs["drain_to_resume_s"] = resumed[0]["t"] - drained["t"]
            new = drained["replacement"].node_id
            print(f"nodes (d) TorchTrainer, 1 worker x 1 GPU on the daemon's "
                  f"node, a checkpoint at each report, max_failures=0: steps "
                  f"{first['steps']} on {first['node']} (CUDA_VISIBLE_DEVICES="
                  f"{first['visible']!r}, losses {first['losses']}), "
                  f"SIGTERM to its daemon (a drain, deadline "
                  f"{NODE_DRAIN_DEADLINE_S} s), a replacement daemon on card "
                  f"{gpu_id}, steps {[m['step'] for m in resumed]} resumed on "
                  f"{resumed[0]['node']} (CUDA_VISIBLE_DEVICES="
                  f"{resumed[0]['visible']!r}); drain restarts "
                  f"{trainer.drain_restarts}, failures spent "
                  f"{trainer.failures}; resumed losses {got} vs phase 14 "
                  f"(d)'s {want}, bit-equal "
                  f"{all(got[i] == want[i] for i in got)}, largest relative "
                  f"difference {rel:.3g} (limit {CAPTURE_LOSS_RTOL}); "
                  f"compile_count {resumed[-1]['compile_count']}, launches "
                  f"{resumed[-1]['counts']}; drain to the first resumed "
                  f"report {legs['drain_to_resume_s']:.1f} s; fit() "
                  f"{legs['fit_s']:.1f} s; card {card}", flush=True)
            check(trainer.drain_restarts == 1 and trainer.failures == 0,
                  "the fit finished through one drain restart, no failure "
                  "spent")
            check(first["steps"] == list(range(NODE_DRAIN_AT + 1))
                  and sorted(got) == list(range(NODE_DRAIN_AT + 1,
                                                CAPTURE_STEPS))
                  and first["node"] == node.node_id
                  and first["visible"] == gpu_id
                  and all(m["node"] == new and m["visible"] == gpu_id
                          for m in resumed),
                  "the run resumed after its checkpoint on the replacement "
                  "node's card")
            check(rel <= CAPTURE_LOSS_RTOL, "the resumed losses match "
                  "phase 14 (d)'s")
            check(resumed[-1]["compile_count"] == want_captures,
                  "the resumed step captured once")
        finally:
            daemons = {nd.proc.pid for nd in c.list_all_nodes
                       if nd.proc is not None}
            c.shutdown()
            shutil.rmtree(storage, ignore_errors=True)
    left = node_processes_left(daemons)
    print(f"nodes: {len(daemons)} daemons shut down, processes left of "
          f"them {left}; card {card}", flush=True)
    check(not left, "no daemon or worker of phase 20 outlives its cluster")
    return {"counts": run["counts"], "legs": legs}


def nodes_ddp_loop(config: dict) -> None:
    """Phase 20 (e)'s ``train.torch.TorchTrainer`` loop: phase 18 (g)'s
    DDP GPT-2 (``prepare_model``, ``prepare_data_loader``, the eager
    steps of :func:`eager_lm_steps`), one step at a time, each reported
    with rank 0's model and optimizer state as the checkpoint. A restored
    run resumes after its checkpoint's step; the first run waits after
    the report of ``config["kill_at"]`` for a node to be killed (rank 0
    marks ``config["mark"]``). The last report carries every rank's card
    UUID, node, visible cards and launches."""
    from torch.utils.data import DataLoader, TensorDataset

    from ray_tpu_torch import train
    from ray_tpu_torch.train import torch as tt
    from ray_tpu_torch.train.optim import global_norm

    dev = tt.get_device()
    spec = config["spec"]
    model = GPT2(spec["model"], seed=1, device=dev)
    load_weights(model, ray_tpu_torch.get(config["weights"]))
    module = tt.prepare_model(model)
    rows = config["rows"]
    loader = tt.prepare_data_loader(DataLoader(
        TensorDataset(torch.arange(len(rows)), torch.from_numpy(rows)),
        batch_size=config["batch"], shuffle=False))
    index, block = next(iter(loader))
    block = block.to(dev)
    tokens, targets = block[:, :-1].contiguous(), block[:, 1:].contiguous()
    opt = adamw(config["lr"], weight_decay=0.1, mu_dtype=torch.bfloat16)
    params = list(model.parameters())
    opt_state = opt.init(params)
    start, restored = 0, train.get_checkpoint()
    if restored is not None:
        saved = torch.load(os.path.join(restored.to_directory(), "state.pt"),
                           map_location=dev)
        with torch.no_grad():
            for p, v in zip(params, saved["params"]):
                p.copy_(v)
        opt_state.count.copy_(saved["count"])
        for mine, v in zip(opt_state.mu + opt_state.nu,
                           saved["mu"] + saved["nu"]):
            mine.copy_(v)
        start = saved["step"] + 1
    world = dist.get_world_size()
    losses = {}
    fa.reset_launch_counts()
    for i in range(start, config["steps"]):
        for p in params:
            p.grad = None
        hidden = module(tokens, return_hidden=True)
        loss = chunked_cross_entropy(hidden, model.wte.weight, targets,
                                     chunk_size=2048)
        loss.backward()
        grads = [p.grad for p in params]
        norm = float(global_norm(grads))
        mean = loss.detach().clone()
        dist.all_reduce(mean)
        mean /= world
        opt.update(grads, opt_state, params)
        losses[i] = float(mean)
        metrics = {"step": i, "loss": float(mean), "norm": norm,
                   "resumed": restored is not None, "t": time.time()}
        if i == config["steps"] - 1:
            mine = {"rows": index.tolist(), "card": card_uuid(dev),
                    "node": os.environ.get("RAY_TPU_NODE_ID"),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "gpu_ids": ray_tpu_torch.get_gpu_ids(),
                    "counts": fa.launch_counts()}
            ranks = [None] * world
            dist.all_gather_object(ranks, mine)
            metrics.update(ranks=ranks, backend=dist.get_backend())
        if dist.get_rank() == 0:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as d:
                torch.save({"step": i, "params": [p.detach() for p in params],
                            "count": opt_state.count, "mu": opt_state.mu,
                            "nu": opt_state.nu}, os.path.join(d, "state.pt"))
                train.report(metrics,
                             checkpoint=train.Checkpoint.from_directory(d))
        else:
            train.report(metrics)
        if i == config["kill_at"] and restored is None:
            dist.barrier()
            if dist.get_rank() == 0:
                # This run's losses: fit()'s history keeps the last run's.
                with open(config["mark"] + ".tmp", "w") as f:
                    json.dump(losses, f)
                os.replace(config["mark"] + ".tmp", config["mark"])
            time.sleep(600)       # a node's death ends this run


def nodes_cards_phase(n: int, card: str, one_node: dict,
                      fault: str | None = None) -> bool:
    """Phase 20 (e): a card-less head and ``n`` node daemons, daemon i on
    card i; ``train.torch``'s DDP ``TorchTrainer`` with ``n`` workers,
    one a node, its losses against phase 18 (g)'s one-node leg
    (``one_node``); after step 2 daemon ``n - 1`` is SIGKILLed and a
    replacement added on its card, and the gang restarts from its
    checkpoint. With ``fault`` (``node_cards_from_head``) every daemon
    node takes its cards from this process's environment, so the head
    refuses the second (RuntimeError from ``add_node``). Returns whether
    every check held, the last that no daemon or worker outlives the
    cluster."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.api import get_runtime
    from ray_tpu_torch.core.runtime import DriverRuntime
    from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.train import torch as tt

    cfg = GPT2Config.small()
    weights = numpy_weights(GPT2(cfg, seed=0))
    torch.cuda.empty_cache()
    batches = tune_batches(cfg.vocab_size)
    rows = np.concatenate([batches[0][0], batches[0][1][:, -1:]], axis=1)
    uuids = [str(torch.cuda.get_device_properties(i).uuid) for i in range(n)]
    storage = tempfile.mkdtemp(prefix="chip_smoke_nodes_ddp_")
    mark = os.path.join(storage, "kill_now")
    saved = DriverRuntime._daemon_cards
    if fault:
        DriverRuntime._daemon_cards = node_cards_from_head
    c = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0})
    checks: list[tuple] = []
    try:
        t0 = time.perf_counter()
        nodes = [c.add_node(num_cpus=2, num_gpus=1, gpu_ids=[i],
                            timeout_s=60) for i in range(n)]
        start_s = time.perf_counter() - t0
        head = get_runtime()
        card_of = {nd.node_id: str(i) for i, nd in enumerate(nodes)}
        print(f"nodes (e) {n} node daemons, daemon i on card i, up in "
              f"{start_s:.2f} s; the head's card ids of them "
              f"{[sorted(head._nodes[nd.node_id].cards) for nd in nodes]}"
              f"{' (fault ' + fault + ')' if fault else ''}; card {card}",
              flush=True)
        killed: dict = {}

        def kill_then_replace():
            wait_for(lambda: os.path.exists(mark), 900, "step 2's report")
            victim = nodes[n - 1]
            killed["t"] = time.time()
            victim.proc.kill()
            wait_for(lambda: not head._nodes[victim.node_id].alive, 120,
                     "the killed daemon declared dead")
            new = c.add_node(num_cpus=2, num_gpus=1, gpu_ids=[n - 1],
                             timeout_s=60)
            card_of[new.node_id] = str(n - 1)
            killed["replacement"] = new.node_id

        t = threading.Thread(target=kill_then_replace, daemon=True)
        t.start()
        spec = tune_spec(cfg)
        t0 = time.time()
        trainer = tt.TorchTrainer(
            nodes_ddp_loop,
            train_loop_config={"weights": rt.put(weights), "rows": rows,
                               "batch": len(rows) // n, "spec": spec,
                               "steps": TUNE_TORCH_STEPS,
                               "lr": TUNE_TRAINER_LR, "kill_at": 1,
                               "mark": mark},
            scaling_config=ScalingConfig(num_workers=n, gpus_per_worker=1,
                                         placement_strategy="STRICT_SPREAD"),
            run_config=RunConfig(name=f"nodes{n}", storage_path=storage,
                                 failure_config=FailureConfig(max_failures=1)),
            torch_config=tt.TorchConfig())
        result = trainer.fit()
        wall_s = time.time() - t0
        t.join(5)
        ok = result.error is None
        checks.append(("(e) fit() finished through a killed node, one "
                       "failure spent", ok and trainer.failures == 1,
                       (result.error or "")[-400:]))
        if ok:
            hist = result.metrics_history
            with open(mark) as f:
                by_step = {int(i): v for i, v in json.load(f).items()}
            by_step.update({m["step"]: m["loss"] for m in hist})
            losses = [by_step[i] for i in range(TUNE_TORCH_STEPS)]
            final = hist[-1]
            ranks = final["ranks"]
            # (The fault run has no one-node leg to hold them against.)
            want = one_node["losses"] if one_node else losses
            loss_rel = [_rel(a, b) for a, b in zip(losses, want)]
            resumed = [m for m in hist if m["resumed"]]
            print(f"nodes (e) train.torch.TorchTrainer on {n} NCCL ranks "
                  f"(DDP), one a node: losses {losses} vs the one-node DDP "
                  f"leg's {want} (relative {loss_rel}); SIGKILL of daemon "
                  f"{n - 1} after step 2, its replacement on card {n - 1}, "
                  f"the gang resumed at step "
                  f"{resumed[0]['step'] if resumed else None} "
                  f"{(resumed[0]['t'] - killed['t']) if resumed else 0:.1f} "
                  f"s after the kill; ranks' nodes "
                  f"{[r['node'] for r in ranks]}, visible "
                  f"{[r['visible'] for r in ranks]}, cards "
                  f"{[r['card'][:13] for r in ranks]}; launches "
                  f"{[r['counts'] for r in ranks]}; drain restarts "
                  f"{trainer.drain_restarts}, failures {trainer.failures}; "
                  f"{wall_s:.1f} s; card {card}", flush=True)
            checks += [
                (f"(e) {n} ranks on {n} distinct nodes and cards, each on "
                 f"its daemon's card",
                 final["backend"] == "nccl"
                 and len({r["node"] for r in ranks}) == n
                 and len({r["card"] for r in ranks}) == n
                 and all(r["visible"] == card_of.get(r["node"])
                         and r["card"] == uuids[int(r["visible"])]
                         for r in ranks),
                 [(r["node"], r["visible"], r["card"][:13]) for r in ranks]),
                (f"(e) losses within the one-node DDP leg's limits "
                 f"({multicard.STEP0_LOSS_RTOL}, then {multicard.LOSS_RTOL})",
                 loss_rel[0] <= multicard.STEP0_LOSS_RTOL
                 and all(v <= multicard.LOSS_RTOL for v in loss_rel[1:]),
                 loss_rel),
                ("(e) the gang resumed from its checkpoint after step 2",
                 bool(resumed) and resumed[0]["step"] == 2
                 and killed.get("replacement") in {r["node"] for r in ranks},
                 [m["step"] for m in resumed])]
    finally:
        daemons = {nd.proc.pid for nd in c.list_all_nodes
                   if nd.proc is not None}
        c.shutdown()
        DriverRuntime._daemon_cards = saved
        shutil.rmtree(storage, ignore_errors=True)
        left = node_processes_left(daemons)
        print(f"nodes (e) {len(daemons)} daemons shut down, processes left "
              f"of them {left}; card {card}", flush=True)
    checks.append(("(e) no daemon or worker outlives the cluster", not left,
                   left))
    return report_checks(checks, card, strict=not fault, prefix="nodes")


# -- phase 21: DAGs, compiled DAGs and workflows ------------------------------


def tensor_sha(t: torch.Tensor) -> str:
    """sha256 of a tensor's bits, wherever it lies."""
    raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def head_reduction(model, h, tokens):
    """What a GPT-2 forward of a batch hands back through a channel:
    each sequence's summed next-token log-probability (float32, ``[B]``)
    and the last position's float32 logits (``[B, vocab]``), from the
    final hidden states ``h`` (after ``ln_f``). The full logits, ``[B, T,
    vocab]`` float32, stay on the card."""
    b, t, e = h.shape
    dt = model.config.dtype
    logits = matmul_f32(h.reshape(b * t, e).to(dt),
                        model.wte.weight.to(dt).t()).view(b, t, -1)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    lp = logp.gather(-1, tokens[:, 1:, None].long())[..., 0].sum(-1)
    return lp, logits[:, -1]


def dag_bounds(n_layer: int, stages: int, fault: str | None = None) -> list:
    """Each stage's blocks ``[lo, hi)``, an even split; under
    ``dag_stage_skips_block`` the second stage starts one block late."""
    step = n_layer // stages
    bounds = [[i * step, (i + 1) * step] for i in range(stages)]
    bounds[-1][1] = n_layer
    if fault == "dag_stage_skips_block":
        bounds[1][0] += 1
    return [tuple(b) for b in bounds]


class GPT2Stage:
    """A stage actor of GPT-2 in a compiled DAG (phase 21): the whole
    model built from ``weights`` (``numpy_weights``' arrays), of which it
    keeps blocks ``[lo, hi)``, with the embeddings on the first stage and
    ``ln_f`` and the tied head on the last. ``fwd`` takes the DAG's input,
    ``{"tokens": [B, T] int32, "probe": bool}``, on the first stage and
    the previous stage's message on the others; a message carries the
    residual stream ``x`` (bf16 on the stage's card, which the channel
    ships as host bits), the tokens, and each stage's record (pid, card,
    launches of this call; with ``probe``, the sha256 of what it sent and
    received). The last stage returns ``head_reduction``'s numpy
    readings."""

    def __init__(self, weights, lo: int, hi: int, config=None,
                 device=None):
        cfg = config or GPT2Config.small()
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        model = GPT2(cfg, seed=1, device=device)   # other weights ...
        load_weights(model, weights)               # ... replaced
        self.first, self.last = lo == 0, hi == cfg.n_layer
        model.h = model.h[lo:hi]
        self.model, self.lo, self.hi = model, lo, hi
        self.dev = model.wte.weight.device
        self.info = {"pid": os.getpid(), "blocks": [lo, hi],
                     "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                     "node": os.environ.get("RAY_TPU_NODE_ID"),
                     "device": str(self.dev),
                     "card": (str(torch.cuda.get_device_properties(
                         self.dev).uuid) if self.dev.type == "cuda"
                         else None)}

    @torch.inference_mode()
    def fwd(self, msg: dict) -> dict:
        m, probe = self.model, msg["probe"]
        fa.reset_launch_counts()
        tokens = torch.from_numpy(np.require(
            msg["tokens"], requirements="W")).to(self.dev)
        rec = dict(self.info)
        if self.first:
            t = tokens.shape[1]
            x = vocab_embedding(tokens, m.wte.weight, m.tp, m.config.dtype) \
                + m.wpe.weight[:t].to(m.config.dtype)
            stages = []
        else:
            got = msg["x"]
            rec["got"] = [type(got).__name__, got.device.type, str(got.dtype)]
            rec["got_sha"] = tensor_sha(got) if probe else None
            x = got.to(self.dev)
            stages = msg["stages"]
        for block in m.h:
            x = block(x, m.attn_fn)
        if not self.last:
            rec["sent_sha"] = tensor_sha(x) if probe else None
            rec["counts"] = fa.launch_counts()
            return {"x": x, "tokens": msg["tokens"], "probe": probe,
                    "stages": stages + [rec]}
        lp, last = head_reduction(m, m.ln_f(x), tokens)
        out = {"lp": lp.cpu().numpy(), "last": last.cpu().numpy()}
        rec["counts"] = fa.launch_counts()
        return dict(out, stages=stages + [rec])


def gpt2_dag(rt, weights, cfg, bounds: list, opts: list, device=None):
    """The compiled DAG of GPT-2's stages (``with InputNode() as x``, each
    stage's ``fwd`` bound to the previous one's), stage i an actor of
    ``GPT2Stage`` with ``opts[i]`` holding blocks ``bounds[i]``;
    ``weights`` is an ObjectRef of ``numpy_weights``' dict."""
    from ray_tpu_torch.dag import InputNode
    stage = rt.remote(GPT2Stage)
    with InputNode() as x:
        node = x
        for (lo, hi), o in zip(bounds, opts, strict=True):
            node = stage.options(**o).bind(weights, lo, hi, cfg, device) \
                .fwd.bind(node)
    return node.experimental_compile()


def gpt2_reduction(model, tokens: np.ndarray) -> dict:
    """The whole model's ``head_reduction`` of one batch in this process,
    as numpy."""
    dev = model.wte.weight.device
    with torch.inference_mode():
        toks = torch.from_numpy(tokens).to(dev)
        lp, last = head_reduction(model, model(toks, return_hidden=True),
                                  toks)
        return {"lp": lp.cpu().numpy(), "last": last.cpu().numpy()}


def reduction_rel(out: dict, ref: dict) -> float:
    """The larger relative distance of the two readings: max |a - b| /
    max |b| over each."""
    return max(float(np.max(np.abs(out[k] - ref[k])) / np.max(np.abs(ref[k])))
               for k in ("lp", "last"))


def run_dag(cdag, batches: np.ndarray, in_flight: int) -> tuple[list, float]:
    """Every batch through ``cdag``, the first alone with ``probe`` (and
    fetched before the rest), the rest with up to ``in_flight`` executes
    issued before their ``get``. Returns the outputs in order and the
    seconds of all but the first."""
    outs = [cdag.execute({"tokens": batches[0], "probe": True})
            .get(timeout=600)]
    pending: list = []
    t0 = time.perf_counter()
    for tokens in batches[1:]:
        if len(pending) == in_flight:
            outs.append(pending.pop(0).get(timeout=600))
        pending.append(cdag.execute({"tokens": tokens, "probe": False}))
    outs += [ref.get(timeout=600) for ref in pending]
    return outs, time.perf_counter() - t0


def dag_leg(rt, card: str, weights_ref, model, cfg=None,
            executes: int = DAG_EXECUTES, fault: str | None = None
            ) -> tuple[dict, list]:
    """Phase 21 (a): GPT-2's two-stage compiled DAG on this card (each
    stage ``num_gpus=DAG_SHARE``), ``executes`` batches of SERVE_BATCH x
    TRAIN_SEQ token ids from numpy seed 0, against ``model`` (the whole
    model, same weights) in this process. Returns the readings and the
    checks."""
    from ray_tpu_torch.experimental.channel import Channel
    cfg = cfg or GPT2Config.small()
    bounds = dag_bounds(cfg.n_layer, 2, fault)
    batches = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (executes, SERVE_BATCH, TRAIN_SEQ)
    ).astype(np.int32)
    refs = [gpt2_reduction(model, b) for b in batches]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        gpt2_reduction(model, b)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / executes * 1e3
    # The edge's host copy: the residual stream through a channel here.
    with torch.inference_mode():
        x = torch.randn(SERVE_BATCH, TRAIN_SEQ, cfg.n_embd,
                        device=model.wte.weight.device).to(cfg.dtype)
    ch = Channel()
    try:
        ch.register_reader()
        copy_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ch.write({"x": x})
            t1 = time.perf_counter()
            back = ch.read(timeout=60)["x"]
            copy_ms.append(((t1 - t0) * 1e3,
                            (time.perf_counter() - t1) * 1e3))
    finally:
        ch.close()
        ch.detach()
    edge_ok = (back.device.type == "cpu" and back.dtype == cfg.dtype
               and tensor_sha(back) == tensor_sha(x))
    del x, back
    t0 = time.perf_counter()
    cdag = gpt2_dag(rt, weights_ref, cfg, bounds,
                    [{"num_gpus": DAG_SHARE}] * 2)
    compile_s = time.perf_counter() - t0
    mode = cdag._mode
    try:
        outs, run_s = run_dag(cdag, batches, DAG_IN_FLIGHT)
    finally:
        t0 = time.perf_counter()
        cdag.teardown()
        teardown_s = time.perf_counter() - t0
    pids = sorted({s["pid"] for o in outs for s in o["stages"]})
    left = node_processes_left(set(pids))
    rel = [reduction_rel(o, r) for o, r in zip(outs, refs, strict=True)]
    per = [[s["counts"] for s in o["stages"]] for o in outs]
    want = [{name: (hi - lo if name == "flash_fwd" else 0)
             for name in fa._KERNELS} for lo, hi in bounds]
    s0, s1 = outs[0]["stages"]
    rate = (executes - 1) / run_s
    readings = {"launches": sum(c[i].get("flash_fwd", 0) for c in per
                                for i in range(2)),
                "rate": rate, "fwd_ms": fwd_ms, "compile_s": compile_s,
                "rel": rel, "mode": mode}
    print(f"dag (a) GPT-2 124M as a two-stage compiled DAG ({mode} mode), "
          f"stages {bounds} at num_gpus={DAG_SHARE} each (pids {pids}, "
          f"CUDA_VISIBLE_DEVICES {[s0['visible'], s1['visible']]}, cards "
          f"{[str(s0['card'])[:13], str(s1['card'])[:13]]}), {executes} "
          f"executes of "
          f"{SERVE_BATCH} x {TRAIN_SEQ} tokens, up to {DAG_IN_FLIGHT} in "
          f"flight: {rate:.2f} executes/s ({1e3 / rate:.2f} ms an execute, "
          f"the first, with the probe, apart) vs the whole forward in this "
          f"process {fwd_ms:.2f} ms; compile (the actors' start included) "
          f"{compile_s:.2f} s, teardown {teardown_s:.2f} s; largest "
          f"relative difference to the in-process forward {max(rel):.3g} "
          f"(bit-equal {max(rel) == 0}, limit {DAG_RTOL}); launches of the "
          f"first execute {per[0]}; the edge received {s1['got']}, sha "
          f"equal {s1['got_sha'] == s0['sent_sha']}; the edge's host copy "
          f"here (12 MiB bf16 from the card): write "
          f"{[round(w, 2) for w, _ in copy_ms]} ms, read "
          f"{[round(r, 2) for _, r in copy_ms]} ms, a CPU tensor bit-equal "
          f"{edge_ok}; processes left {left}; card {card}", flush=True)
    checks = [
        ("(a) compiled in channel mode", mode == "channels", mode),
        (f"(a) each output within {DAG_RTOL} of the whole model in this "
         f"process", max(rel) <= DAG_RTOL, max(rel)),
        ("(a) each stage launches flash_fwd once a block an execute and no "
         "backward kernel", all(p == want for p in per),
         per[0] if all(p == want for p in per) else
         [p for p in per if p != want][:2]),
        ("(a) stage 1 received a CPU bf16 tensor with the bits stage 0 sent",
         s1["got"] == ["Tensor", "cpu", str(cfg.dtype)]
         and s1["got_sha"] == s0["sent_sha"], s1["got"]),
        ("(a) both stages on this card, one CUDA_VISIBLE_DEVICES",
         s0["card"] == s1["card"] and s0["visible"] == s1["visible"]
         and s0["pid"] != s1["pid"], [s0["visible"], s1["visible"]]),
        ("(a) a CUDA tensor through a channel arrives a CPU tensor, "
         "bit-equal", edge_ok, edge_ok),
        ("(a) no actor of the DAG outlives teardown()", not left, left)]
    return readings, checks


def train_span(prev, steps: int, ctx: dict) -> dict:
    """Phase 21 (b)'s workflow step, a ``num_gpus=1`` task: GPT-2 124M
    from ``prev``'s saved train state, or from ``ctx["init"]``'s weights
    when ``prev`` is None, trained ``steps`` captured steps on
    ``ctx["init"]``'s batch (``gpt2_steps``), the state saved under
    ``ctx["root"]``. It logs each run to a file (``span<i>.runs``) and,
    while ``ctx["fail_mark"]`` exists, fails its first run of step
    ``ctx["fail_at"]``. Returns the state's path (never the state: the
    workflow pickles step results into its storage), every step's losses
    so far and each step's record."""
    t_start = time.time()
    index = 1 if prev is None else prev["index"] + 1
    with open(os.path.join(ctx["root"], f"span{index}.runs"), "a") as f:
        f.write("x")
    if index == ctx["fail_at"] and os.path.exists(ctx["fail_mark"]):
        os.unlink(ctx["fail_mark"])
        raise RuntimeError(f"planted failure of step {index}")
    data = np.load(ctx["init"])
    model = GPT2(ctx["config"], seed=1)
    if prev is None:
        load_weights(model, {n: data[n] for n, _ in model.named_parameters()})
    first: dict = {}
    path = os.path.join(ctx["root"], f"state{index}-{os.getpid()}-"
                        f"{time.time_ns()}")
    run = gpt2_steps(model, (data["tokens"], data["targets"]), steps, 0,
                     ctx["capture"], save_to=path,
                     report=lambda m: first.setdefault("t", m["t"]),
                     restore_from=None if prev is None else prev["state"])
    rec = {"index": index, "pid": os.getpid(),
           "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "losses": run["losses"], "next_loss": run["next_loss"],
           "counts": run["counts"], "compile_count": run["compile_count"],
           "first_loss_s": first["t"] - t_start, "save_s": run["save_s"],
           "restore_s": run.get("restore_s")}
    return {"index": index, "state": path,
            "losses": (prev["losses"] if prev else []) + run["losses"],
            "spans": (prev["spans"] if prev else []) + [rec]}


def workflow_leg(rt, card: str, weights: dict, host, ref_losses: list,
                 fault: str | None = None) -> tuple[dict, list]:
    """Phase 21 (b): ``train_span.bind(train_span.bind(None, 2), 2)`` as
    a durable workflow, each step a ``num_gpus=1`` task; the second step
    fails on its first run, the run ends FAILED and ``workflow.resume``
    runs the rest. Under ``workflow_reruns_done_step`` the resume reads
    no stored step. Returns the readings and the checks."""
    from ray_tpu_torch import workflow
    from ray_tpu_torch.workflow.storage import WorkflowStorage
    root = tempfile.mkdtemp(prefix="chip_smoke_workflow_")
    t_leg = time.perf_counter()
    try:
        workflow.init(os.path.join(root, "store"))
        init = os.path.join(root, "init.npz")
        np.savez(init, tokens=host[0], targets=host[1], **weights)
        mark = os.path.join(root, "fail_once")
        open(mark, "w").close()
        ctx = {"root": root, "init": init, "fail_at": 2, "fail_mark": mark,
               "capture": CAPTURE, "config": GPT2Config.small()}
        span = rt.remote(num_gpus=1)(train_span)
        dag = span.bind(span.bind(None, WORKFLOW_SPAN, ctx), WORKFLOW_SPAN,
                        ctx)
        wid = "chip_smoke_gpt2"
        t0 = time.perf_counter()
        try:
            workflow.run(dag, workflow_id=wid, timeout=900)
            first_error = None
        except rt.TaskError as e:        # the planted failure of step 2
            first_error = f"{type(e).__name__}: {e}"
        run_s = time.perf_counter() - t0
        status = workflow.get_status(wid)
        saved = WorkflowStorage.has_step
        if fault == "workflow_reruns_done_step":
            WorkflowStorage.has_step = lambda self, key: False
        try:
            t0 = time.perf_counter()
            out = workflow.resume(wid, timeout=900)
            resume_s = time.perf_counter() - t0
        finally:
            WorkflowStorage.has_step = saved
        runs = []
        for i in (1, 2):
            with open(os.path.join(root, f"span{i}.runs")) as f:
                runs.append(len(f.read()))
        final_status = workflow.get_status(wid)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    leg_s = time.perf_counter() - t_leg
    spans = out["spans"]
    rel = [_rel(a, b) for a, b in zip(out["losses"], ref_losses,
                                      strict=True)]
    want_captures = 1 if CAPTURE else None
    per = GPT2Config.small().n_layer
    bad = [(s["index"], s["counts"]) for s in spans
           if any(s["counts"][k] != per * WORKFLOW_SPAN for k in SQUARE)]
    readings = {"counts": {k: sum(s["counts"][k] for s in spans)
                           for k in SQUARE},
                "pids": sorted({s["pid"] for s in spans}), "leg_s": leg_s}
    print(f"dag (b) a durable workflow of two GPT-2 124M steps, each a "
          f"num_gpus=1 task of {WORKFLOW_SPAN} captured steps at "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: the first run failed at step 2 "
          f"({(first_error or '')[-160:]!r}) after {run_s:.1f} s, status "
          f"{status}; resume "
          f"{resume_s:.1f} s, status {final_status}; runs of each step "
          f"{runs}; losses {out['losses']} vs this process's "
          f"{ref_losses} (relative {max(rel):.3g}, limit "
          f"{CAPTURE_LOSS_RTOL}); step 1's loss after its save "
          f"{spans[0]['next_loss']} vs step 2's first after its restore "
          f"{spans[1]['losses'][0]}; each step's start to its first loss "
          f"{[round(s['first_loss_s'], 2) for s in spans]} s, save "
          f"{[round(s['save_s'], 2) for s in spans]} s, restore "
          f"{spans[1]['restore_s']:.2f} s; compile_count "
          f"{[s['compile_count'] for s in spans]}; launches "
          f"{[s['counts'] for s in spans]}; leg {leg_s:.1f} s; card {card}",
          flush=True)
    checks = [
        ("(b) the first run failed at step 2 and ended FAILED",
         first_error is not None and "planted failure of step 2"
         in first_error and status == "FAILED",
         [(first_error or "")[-120:], status]),
        ("(b) resume finished the workflow: step 1 ran once, step 2 twice",
         final_status == "SUCCESSFUL" and runs == [1, 2], runs),
        (f"(b) the {2 * WORKFLOW_SPAN} losses after resume within "
         f"{CAPTURE_LOSS_RTOL} of the same steps in this process",
         max(rel) <= CAPTURE_LOSS_RTOL, rel),
        ("(b) step 2 restored step 1's saved state bit-equal",
         spans[1]["losses"][0] == spans[0]["next_loss"],
         [spans[0]["next_loss"], spans[1]["losses"][0]]),
        (f"(b) each step launches {per} of each square kernel a train "
         f"step, compile_count {want_captures}",
         not bad and all(s["compile_count"] == want_captures
                         for s in spans), bad or "all held")]
    return readings, checks


def dag_phase(card: str, runtime: dict | None = None,
              fault: str | None = None) -> dict:
    """Phase 21 (see the module docstring): (a) and (b) in one runtime,
    then no process of either leg may outlive it. ``runtime`` (phase
    14's readings) gives (b) the driver's losses; without it they are
    run here. With ``fault`` only the leg it plants into runs, its
    checks read without raising. Returns the readings and whether every
    check held."""
    import ray_tpu_torch as rt
    cfg = GPT2Config.small()
    host = train_batch(cfg.vocab_size)
    model = GPT2(cfg, seed=0)                   # phase 14 (c)'s weights
    weights = numpy_weights(model)
    if runtime is None and fault != "dag_stage_skips_block":
        ref_losses = gpt2_steps(GPT2(cfg, seed=0), host, 2 * WORKFLOW_SPAN,
                                0, CAPTURE)["losses"]
    else:
        ref_losses = (runtime or {}).get("ref_losses")
    torch.cuda.empty_cache()
    out, checks = {}, []
    t0 = time.perf_counter()
    rt.init()
    try:
        if fault != "workflow_reruns_done_step":
            t_a = time.perf_counter()
            out["a"], c = dag_leg(rt, card, rt.put(weights), model,
                                  fault=fault)
            out["a"]["leg_s"] = time.perf_counter() - t_a
            checks += c
        del model
        torch.cuda.empty_cache()
        if fault != "dag_stage_skips_block":
            out["b"], c = workflow_leg(rt, card, weights, host, ref_losses,
                                       fault=fault)
            checks += c
    finally:
        rt.shutdown()
    left = node_processes_left(set(out.get("b", {}).get("pids", [])))
    checks.append(("no task worker of (b) outlives the runtime", not left,
                   left))
    out["s"] = time.perf_counter() - t0
    out["held"] = report_checks(checks, card, strict=fault is None,
                                prefix="dag")
    return out


def dag_fault_main(name: str, card: str) -> int:
    """``--plant-fault dag_stage_skips_block`` or
    ``workflow_reruns_done_step``: the build, then phase 21's leg that the
    fault plants into, its checks read without raising. Exits 1 when a
    check fails it (caught), 2 when none does or the run failed before
    its checks."""
    print(f"planted fault {name}: {DAG_FAULTS[name]}", flush=True)
    try:
        t0 = time.perf_counter()
        build.ensure_built()
        print(f"build: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
        held = dag_phase(card, fault=name)["held"]
    except Exception:  # noqa: BLE001 — the harness failed, not the checks
        traceback.print_exc()
        print(json.dumps({"fault": name, "caught": False,
                          "failed_before_checks": True}), flush=True)
        return 2
    print(json.dumps({"fault": name, "caught": not held}), flush=True)
    return 1 if not held else 2


def dag_cards_phase(n: int, card: str) -> dict:
    """Phase 21 (c), under ``--cards n``: a card-less head and ``n`` node
    daemons, daemon i on card i; GPT-2 124M as an ``n``-stage compiled
    DAG, stage i on daemon i's card, every edge a ``CommChannel`` over
    the host communicator; DAG_CARDS_EXECUTES executes against the whole
    model in this process (card 0). Then no daemon or worker may outlive
    the cluster. Returns the readings."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.dag.comm_channel import CommChannel
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)
    weights = numpy_weights(model)
    bounds = dag_bounds(cfg.n_layer, n)
    batches = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (DAG_CARDS_EXECUTES, SERVE_BATCH, TRAIN_SEQ)
    ).astype(np.int32)
    refs = [gpt2_reduction(model, b) for b in batches]
    del model
    torch.cuda.empty_cache()
    uuids = [str(torch.cuda.get_device_properties(i).uuid) for i in range(n)]
    c = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0})
    checks: list[tuple] = []
    try:
        t0 = time.perf_counter()
        nodes = [c.add_node(num_cpus=2, num_gpus=1, gpu_ids=[i],
                            timeout_s=60) for i in range(n)]
        opts = [{"num_gpus": 1, "scheduling_strategy":
                 NodeAffinitySchedulingStrategy(nd.node_id, soft=False)}
                for nd in nodes]
        cdag = gpt2_dag(rt, rt.put(weights), cfg, bounds, opts)
        compile_s = time.perf_counter() - t0
        kinds = [type(ch).__name__ for ch in cdag._all_channels]
        comm = all(isinstance(ch, CommChannel) for ch in cdag._all_channels)
        try:
            outs, run_s = run_dag(cdag, batches, DAG_IN_FLIGHT)
        finally:
            cdag.teardown()
        rel = [reduction_rel(o, r) for o, r in zip(outs, refs, strict=True)]
        stages = outs[0]["stages"]
        got = [s["got"] for s in stages[1:]]
        bits = [s["got_sha"] == p["sent_sha"]
                for p, s in zip(stages, stages[1:])]
        rate = (DAG_CARDS_EXECUTES - 1) / run_s
        print(f"dag (c) GPT-2 124M as a {n}-stage compiled DAG "
              f"({cdag._mode} mode), stages {bounds}, stage i on daemon i's "
              f"card (visible {[s['visible'] for s in stages]}, cards "
              f"{[str(s['card'])[:13] for s in stages]}); edges {kinds}; "
              f"{DAG_CARDS_EXECUTES} executes, up to {DAG_IN_FLIGHT} in "
              f"flight: {rate:.2f} executes/s ({1e3 / rate:.2f} ms an "
              f"execute); daemons and compile {compile_s:.1f} s; largest "
              f"relative difference to the in-process forward {max(rel):.3g}"
              f" (limit {DAG_RTOL}); each edge received {got}, sha equal "
              f"{bits}; flash_fwd launches of the first execute "
              f"{[s['counts']['flash_fwd'] for s in stages]}; card {card}",
              flush=True)
        checks += [
            ("(c) compiled in channel mode, every edge a CommChannel",
             cdag._mode == "channels" and comm and len(kinds) == n + 1,
             kinds),
            (f"(c) each output within {DAG_RTOL} of the whole model in this "
             f"process", max(rel) <= DAG_RTOL, max(rel)),
            ("(c) each stage received a CPU bf16 tensor with the bits the "
             "one before sent",
             all(g == ["Tensor", "cpu", str(cfg.dtype)] for g in got)
             and all(bits), [got, bits]),
            ("(c) stage i on daemon i's card",
             [s["card"] for s in stages] == uuids
             and [s["visible"] for s in stages] == [str(i) for i in range(n)],
             [s["visible"] for s in stages])]
    finally:
        daemons = {nd.proc.pid for nd in c.list_all_nodes
                   if nd.proc is not None}
        c.shutdown()
        left = node_processes_left(daemons)
    checks.append(("(c) no daemon or worker outlives the cluster", not left,
                   left))
    report_checks(checks, card, prefix="dag")
    return {"rate": rate, "rel": rel}


# -- phase 22: dashboard, job submission and autoscaler ----------------------

# The job's entrypoint (phase 22 (a)), written under the run's temporary
# directory: it joins the session ("auto": the session whose head is its
# ancestor), prints what it sees, and runs one num_gpus=1 task. It loads
# no torch itself: the task imports chip_smoke where it runs.
JOB_ENTRY = """\
import json, os, sys, time
t_entry = time.time()
visible = os.environ.get("CUDA_VISIBLE_DEVICES")
print(f"entrypoint: CUDA_VISIBLE_DEVICES={visible!r}", flush=True)
import ray_tpu_torch as rt


def train(steps, capture):
    import chip_smoke
    return chip_smoke.job_train(steps, capture)


rt.init(address="auto")
task = rt.remote(num_gpus=1)(train)
out = rt.get(task.remote(int(sys.argv[1]), sys.argv[2] == "1"), timeout=900)
out.update(entry_visible=visible, t_entry=t_entry)
print("JOB" + json.dumps(out), flush=True)
"""


def http_json(url: str, body: dict | None = None, timeout: float = 120.0):
    """(status, JSON or text) of a GET, or of a POST of ``body``."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw.decode("utf-8", "replace")


def job_train(steps: int, capture: bool) -> dict:
    """Phase 22 (a)'s task, which the job's entrypoint runs at
    ``num_gpus=1``: GPT-2 124M from phase 14 (c)'s weights (seed 0) on
    its batch, ``steps`` steps of ``gpt2_steps``. Returns the losses, the
    launches, ``compile_count``, the card's UUID and what the task's
    process sees."""
    t_start = time.time()
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)
    first: dict = {}
    run = gpt2_steps(model, train_batch(cfg.vocab_size), steps, 0, capture,
                     report=lambda m: first.setdefault("t", m["t"]))
    return {"losses": run["losses"], "counts": run["counts"],
            "compile_count": run["compile_count"],
            "uuid": card_uuid(next(model.parameters()).device),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "pid": os.getpid(), "t_start": t_start, "t_first": first["t"]}


def runtime_workers() -> set:
    """Pids of this process's children that are runtime workers."""
    out = set()
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == os.getpid() and b"core.worker_entry" in cmd:
            out.add(int(pid))
    return out


def job_status(url: str, sid: str, timeout: float) -> dict:
    """``GET /api/jobs/<sid>`` until the job ends."""
    return wait_for(lambda: (lambda i: i if i["status"] in (
        "SUCCEEDED", "FAILED", "STOPPED") else None)(
        http_json(f"{url}/api/jobs/{sid}")[1]), timeout,
        f"job {sid} ended", period=0.2)


def job_leg(url: str, card: str, ref_losses: list, uuid: str
            ) -> tuple[dict, list]:
    """Phase 22 (a) in a runtime started with the dashboard: the GPT-2
    job over ``POST /api/jobs``, the dashboard's reads, a job that exits 3
    and a sleeping one stopped over REST. Returns readings and checks."""
    n = GPT2Config.small().n_layer
    want_captures = 1 if CAPTURE else None
    root = tempfile.mkdtemp(prefix="chip_smoke_job_")
    here = os.path.dirname(os.path.abspath(__file__))
    env = {"env_vars": {"PYTHONPATH": here}}
    try:
        entry = os.path.join(root, "train_job.py")
        with open(entry, "w") as f:
            f.write(JOB_ENTRY)
        t0 = time.time()
        code, sub = http_json(f"{url}/api/jobs", {
            "entrypoint": f"{sys.executable} {entry} {WORKFLOW_SPAN} "
                          f"{int(CAPTURE)}", "runtime_env": env,
            "metadata": {"phase": "22"}})
        sid = sub["submission_id"]
        info = job_status(url, sid, 900)
        done_s = time.time() - t0
        logs = http_json(f"{url}/api/jobs/{sid}/logs")[1]["logs"]
        line = [x for x in logs.splitlines() if x.startswith("JOB")]
        out = json.loads(line[-1][3:]) if line else None
        cluster = http_json(f"{url}/api/cluster")[1]
        nodes = http_json(f"{url}/api/nodes")[1]
        agents = http_json(f"{url}/api/agents")[1]
        simple = http_json(f"{url}/simple")[1]
        page = http_json(f"{url}/")[1]
        metrics = http_json(f"{url}/metrics")[1]
        t1 = time.time()
        failed = http_json(f"{url}/api/jobs", {
            "entrypoint": f"{sys.executable} -c 'import sys; sys.exit(3)'"}
            )[1]["submission_id"]
        sleeper = http_json(f"{url}/api/jobs", {
            "entrypoint": f"{sys.executable} -c 'import os, time; "
                          f"print(\"PID\", os.getpid(), flush=True); "
                          f"time.sleep(600)'"})[1]["submission_id"]
        failed_info = job_status(url, failed, 300)

        def sleeping_pid():
            lines = [x for x in http_json(f"{url}/api/jobs/{sleeper}/logs")[
                1]["logs"].splitlines() if x.startswith("PID ")]
            return int(lines[0].split()[1]) if lines else None
        pid = wait_for(sleeping_pid, 300, "the sleeping job running", 0.2)
        stop = http_json(f"{url}/api/jobs/{sleeper}/stop", {})
        stopped = job_status(url, sleeper, 120)
        others_s = time.time() - t1
        # Its process, a child of the entrypoint's shell, ends with it.
        sleeper_left = node_processes_left({pid}, timeout=15)
        jobs = http_json(f"{url}/api/jobs")[1]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gauges = sorted(set(re.findall(r"^# TYPE (ray_tpu_\w+) gauge$",
                                   metrics, re.M)))
    head_row = simple.split("<tr><td>head</td>")[-1].split("</tr>")[0]
    readings = {"done_s": done_s, "others_s": others_s, "out": out,
                "counts": (out or {}).get("counts", {})}
    if out is None:
        print(f"jobs (a) the job's logs: {logs[-3000:]}", flush=True)
        out = {"losses": [], "counts": {}, "compile_count": None,
               "uuid": None, "visible": None, "entry_visible": None,
               "pid": None, "t_entry": t0, "t_start": t0, "t_first": t0}
    rel = [_rel(a, b) for a, b in zip(out["losses"], ref_losses)]
    print(f"jobs (a) a job submitted over POST /api/jobs (status {code}), "
          f"its entrypoint a script that joins the session and runs one "
          f"num_gpus=1 task of {WORKFLOW_SPAN} captured GPT-2 124M steps "
          f"at {TRAIN_BATCH} x {TRAIN_SEQ}: {info['status']}, return code "
          f"{info['return_code']}; submit to SUCCEEDED {done_s:.2f} s; the "
          f"entrypoint's start to its first loss "
          f"{out['t_first'] - out['t_entry']:.2f} s (the task's own start to "
          f"it {out['t_first'] - out['t_start']:.2f} s); losses "
          f"{out['losses']} vs phase 14 (c)'s {ref_losses} (relative "
          f"{max(rel) if rel else None}, limit {CAPTURE_LOSS_RTOL}); "
          f"launches {out['counts']}, compile_count {out['compile_count']}; "
          f"the entrypoint's CUDA_VISIBLE_DEVICES {out['entry_visible']!r}, "
          f"the task's {out['visible']!r} on card {out['uuid']}; card "
          f"{card}", flush=True)
    print(f"jobs (a) the dashboard: /api/cluster GPU "
          f"{cluster['resources'].get('GPU')}, /api/nodes GPU "
          f"{[r['resources_total'].get('GPU') for r in nodes]}, "
          f"/api/agents head gpus {agents['head'].get('gpus')}; /simple's "
          f"head row {head_row!r}; {len(gauges)} ray_tpu_* gauges on "
          f"/metrics; a job that exits 3 {failed_info['status']} (return "
          f"code {failed_info['return_code']}), a sleeping job stopped over "
          f"REST {stop} then {stopped['status']} (its process left "
          f"{sleeper_left}), both in {others_s:.2f} s; {len(jobs)} jobs "
          f"listed; card {card}",
          flush=True)
    bad = {k: v for k, v in out["counts"].items()
           if k in SQUARE and v != n * WORKFLOW_SPAN}
    checks = [
        ("(a) the job SUCCEEDED with return code 0",
         info["status"] == "SUCCEEDED" and info["return_code"] == 0,
         [info["status"], info["return_code"]]),
        (f"(a) the job's {WORKFLOW_SPAN} losses within {CAPTURE_LOSS_RTOL} "
         f"of phase 14 (c)'s first steps",
         len(rel) == WORKFLOW_SPAN and max(rel) <= CAPTURE_LOSS_RTOL, rel),
        (f"(a) {n} launches of each square kernel a step, compile_count "
         f"{want_captures}",
         len(out["counts"]) > 0 and not bad
         and all(k in out["counts"] for k in SQUARE)
         and out["compile_count"] == want_captures,
         [out["counts"], out["compile_count"]]),
        ("(a) the entrypoint saw no card (CUDA_VISIBLE_DEVICES=''), the "
         "task ran on this card",
         out["entry_visible"] == "" and out["uuid"] == uuid,
         [out["entry_visible"], out["uuid"], uuid]),
        ("(a) /api/cluster and /api/nodes report GPU 1, the node tables "
         "the gpus column with 1",
         cluster["resources"].get("GPU") == 1.0
         and [r["resources_total"].get("GPU") for r in nodes] == [1.0]
         and agents["head"].get("gpus") == 1 and "<th>gpus</th>" in simple
         and head_row.endswith("<td>1</td>") and '"gpus"]' in page
         and "s.gpus" in page,
         [cluster["resources"].get("GPU"), head_row]),
        ("(a) /metrics carries the system gauges",
         all(g in gauges for g in (
             "ray_tpu_nodes_alive", "ray_tpu_workers_total",
             "ray_tpu_tasks_pending", "ray_tpu_tasks_running",
             "ray_tpu_actors_alive", "ray_tpu_object_store_bytes",
             "ray_tpu_head_queue_depth")), gauges),
        ("(a) a job that exits 3 ends FAILED, a sleeping one stopped over "
         "REST ends STOPPED and leaves no process",
         failed_info["status"] == "FAILED"
         and failed_info["return_code"] == 3
         and stop == (200, {"stopped": True})
         and stopped["status"] == "STOPPED" and not sleeper_left,
         [failed_info["status"], stop, stopped["status"], sleeper_left])]
    return readings, checks


def autoscaled_forward(tokens: np.ndarray, gate: str | None = None,
                       gang: int = 0) -> dict:
    """Phase 22 (b), (c): a ``num_gpus=1`` task on an autoscaled node,
    GPT-2 124M from phase 14 (c)'s weights (seed 0), one forward of
    ``tokens`` (``gpt2_reduction``), the flash launches counted around
    it. With ``gate``, it first waits until ``gang`` tasks are running,
    so that each holds its card at once."""
    import ray_tpu_torch as rt
    if gate is not None:
        open(os.path.join(gate, str(os.getpid())), "w").close()
        wait_for(lambda: len(os.listdir(gate)) >= gang, 300,
                 f"{gang} tasks holding their cards")
    model = GPT2(GPT2Config.small(), seed=0)
    fa.reset_launch_counts()
    red = gpt2_reduction(model, tokens)
    counts = fa.launch_counts()
    return {**red, "counts": counts, "pid": os.getpid(),
            "uuid": card_uuid(next(model.parameters()).device),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "node": rt.get_runtime_context().get_node_id()}


def daemon_pid(cluster, node_id: str) -> int:
    """The pid of the node daemon behind ``node_id`` in ``cluster``."""
    return next(nd.proc.pid for nd in cluster.list_all_nodes
                if nd.node_id == node_id)


def process_env(pid: int, name: str) -> str | None:
    """``name`` in the environment process ``pid`` was started with."""
    with open(f"/proc/{pid}/environ", "rb") as f:
        for item in f.read().split(b"\0"):
            key, _, value = item.partition(b"=")
            if key.decode() == name:
                return value.decode()
    return None


def process_flag(pid: int, flag: str) -> str | None:
    """The value after ``flag`` on process ``pid``'s command line."""
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        args = f.read().decode().split("\0")
    return args[args.index(flag) + 1] if flag in args else None


def fake_provider(fault: str | None):
    """The fake provider's class; under ``fake_node_gpu_as_resource`` the
    JAX package's pass-through of every resource but CPU into
    ``Cluster.add_node(resources=...)``, so the node is given no card."""
    from ray_tpu_torch.autoscaler.fake_provider import FakeMultiNodeProvider
    if fault != "fake_node_gpu_as_resource":
        return FakeMultiNodeProvider

    class GpuAsResource(FakeMultiNodeProvider):
        def create_node(self, node_type, resources):
            res = dict(resources)
            cpus = res.pop("CPU", 1.0)
            node = self._cluster.add_node(num_cpus=cpus, resources=res)
            with self._lock:
                self._nodes[node.node_id] = (node, node_type)
            return node.node_id
    return GpuAsResource


def autoscale_tokens(vocab: int) -> np.ndarray:
    """Phase 17's full batch of token ids, 8 x 1024 (numpy seed 0)."""
    return np.random.default_rng(0).integers(
        0, vocab, (SERVE_BATCH, TRAIN_SEQ)).astype(np.int32)


def autoscale_leg(card: str, fault: str | None = None
                  ) -> tuple[dict, list]:
    """Phase 22 (b): a card-less head, an ``Autoscaler`` over the fake
    provider with node type ``h100 = {"CPU": 2, "GPU": 1}`` (0 to 1),
    one pending ``num_gpus=1`` forward; the ``request_resources`` floor
    holding the idle node, then released. Returns readings and checks."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import (
        Autoscaler,
        AutoscalerConfig,
        NodeTypeConfig,
        sdk,
    )
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.api import get_runtime
    from ray_tpu_torch.core.config import env_overrides
    cfg = GPT2Config.small()
    tokens = autoscale_tokens(cfg.vocab_size)
    model = GPT2(cfg, seed=0)
    ref = gpt2_reduction(model, tokens)
    uuid = card_uuid(next(model.parameters()).device)
    del model
    torch.cuda.empty_cache()
    gpu_id = node_gpu_ids(1)[0]
    t = {}
    daemon = None
    with env_overrides(idle_worker_ttl_s=AUTOSCALE_TTL_S):
        c = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0})
        try:
            head = get_runtime()
            provider = fake_provider(fault)(c)
            asc = Autoscaler(AutoscalerConfig(
                node_types=[NodeTypeConfig("h100", {"CPU": 2, "GPU": 1},
                                           0, 1)],
                idle_timeout_s=AUTOSCALE_IDLE_S, update_interval_s=0.2),
                provider, head)
            asc.start()
            try:
                t0 = time.perf_counter()
                ref_task = rt.remote(num_gpus=1)(autoscaled_forward).remote(
                    tokens)
                node_id = wait_for(provider.non_terminated_nodes, 120,
                                   "a node launched")[0].node_id
                t["node_s"] = time.perf_counter() - t0
                daemon = daemon_pid(c, node_id)
                out = rt.get(ref_task, timeout=600)
                t["result_s"] = time.perf_counter() - t0
                given = [process_flag(daemon, "--num-gpus"),
                         process_env(daemon, "CUDA_VISIBLE_DEVICES")]
                cards = sorted(head._nodes[node_id].cards)
                # The floor: the idle node stays past the idle timeout.
                sdk.request_resources(bundles=[{"GPU": 1}])
                wait_for(lambda: any(
                    r["NodeID"] == node_id and r["alive_workers"] == 0
                    and r["Available"] == r["Resources"]
                    for r in rt.nodes()), 120, "the node idle")
                t_idle = time.perf_counter()
                time.sleep(2 * AUTOSCALE_IDLE_S)
                held = [n.node_id for n in provider.non_terminated_nodes()]
                sdk.request_resources(bundles=[])
                t1 = time.perf_counter()
                wait_for(lambda: not provider.non_terminated_nodes()
                         and asc.terminated_total == 1, 120,
                         "the idle node terminated")
                t["terminate_s"] = time.perf_counter() - t1
                t["idle_s"] = t1 - t_idle
            finally:
                asc.stop()
                sdk.request_resources(bundles=[])
        finally:
            c.shutdown()
    left = node_processes_left({daemon, out["pid"]} - {None})
    rel = reduction_rel(out, ref)
    print(f"autoscale (b) a card-less head and an Autoscaler over the fake "
          f"provider, node type h100 {{CPU: 2, GPU: 1}} (0-1), idle timeout "
          f"{AUTOSCALE_IDLE_S} s: one num_gpus=1 GPT-2 124M forward of "
          f"{SERVE_BATCH} x {TRAIN_SEQ} pending -> node registered "
          f"{t['node_s']:.2f} s -> result {t['result_s']:.2f} s; nodes "
          f"launched {asc.launched_total}, its daemon started with "
          f"--num-gpus {given[0]} and CUDA_VISIBLE_DEVICES {given[1]!r}, "
          f"the head's card ids {cards}; the task's CUDA_VISIBLE_DEVICES "
          f"{out['visible']!r} on card {out['uuid']}; relative difference "
          f"to this process's forward {rel:.3g} (bit-equal "
          f"{rel == 0.0}); launches {out['counts']}; request_resources"
          f"([{{GPU: 1}}]) kept {held} through {2 * AUTOSCALE_IDLE_S:.1f} s "
          f"idle; cleared -> terminated {t['terminate_s']:.2f} s; card "
          f"{card}", flush=True)
    fwd = out["counts"].get("flash_fwd", 0)
    bwd = {k: v for k, v in out["counts"].items() if k != "flash_fwd" and v}
    checks = [
        ("(b) one node launched, holding this card (its daemon given it: "
         "--num-gpus 1 and CUDA_VISIBLE_DEVICES, the head's card ids)",
         asc.launched_total == 1 and given == ["1", gpu_id]
         and cards == [gpu_id] and out["uuid"] == uuid
         and out["node"] == node_id,
         [asc.launched_total, given, cards, out["uuid"] == uuid]),
        ("(b) the forward on the autoscaled node bit-equal to this "
         "process's", rel == 0.0, rel),
        (f"(b) {cfg.n_layer} flash_fwd launches and no backward kernel in "
         f"the task", fwd == cfg.n_layer and not bwd, out["counts"]),
        ("(b) request_resources keeps the idle node past the timeout, "
         "clearing it lets the node go", held == [node_id], held),
        ("(b) the node terminated, non_terminated_nodes() empty, its "
         "daemon gone", not provider.non_terminated_nodes()
         and asc.terminated_total == 1
         and not any(x.startswith(f"{daemon}:") for x in left),
         [asc.terminated_total, left]),
        ("(b) no daemon or worker left", not left, left)]
    return {"counts": out["counts"], **t}, checks


def jobs_phase(card: str, runtime: dict | None = None,
               fault: str | None = None) -> dict:
    """Phase 22 (see the module docstring): (a) in a runtime started with
    the dashboard, then (b) on a cluster of its own. ``runtime`` (phase
    14's readings) gives (a) the driver's losses; without it they are run
    here. With ``fault`` only (b) runs, its checks read without raising.
    Returns the readings and whether every check held."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import get_runtime
    out, checks = {}, []
    t0 = time.perf_counter()
    if fault is None:
        cfg = GPT2Config.small()
        if runtime is None:
            ref_losses = gpt2_steps(GPT2(cfg, seed=0),
                                    train_batch(cfg.vocab_size),
                                    WORKFLOW_SPAN, 0, CAPTURE)["losses"]
        else:
            ref_losses = runtime["ref_losses"][:WORKFLOW_SPAN]
        torch.cuda.empty_cache()
        uuid = card_uuid(default_device())
        t_a = time.perf_counter()
        rt.init(include_dashboard=True, dashboard_port=0)
        try:
            url = get_runtime()._dashboard.url
            out["a"], c = job_leg(url, card, ref_losses, uuid)
            checks += c
            workers = runtime_workers()
        finally:
            rt.shutdown()
        task_pid = (out["a"]["out"] or {}).get("pid")
        left = node_processes_left(workers | ({task_pid} - {None}))
        checks.append(("(a) no worker left after shutdown()", not left,
                       left))
        out["a"]["leg_s"] = time.perf_counter() - t_a
    t_b = time.perf_counter()
    out["b"], c = autoscale_leg(card, fault)
    out["b"]["leg_s"] = time.perf_counter() - t_b
    checks += c
    out["s"] = time.perf_counter() - t0
    out["held"] = report_checks(checks, card, strict=fault is None,
                                prefix="jobs")
    return out


def jobs_fault_main(name: str, card: str) -> int:
    """``--plant-fault fake_node_gpu_as_resource``: the build, then phase
    22 (b) with the fault's provider, its checks read without raising.
    Exits 1 when a check fails it (caught), 2 when none does or the run
    failed before its checks."""
    print(f"planted fault {name}: {JOB_FAULTS[name]}", flush=True)
    try:
        t0 = time.perf_counter()
        build.ensure_built()
        print(f"build: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
        held = jobs_phase(card, fault=name)["held"]
    except Exception:  # noqa: BLE001 — the harness failed, not the checks
        traceback.print_exc()
        print(json.dumps({"fault": name, "caught": False,
                          "failed_before_checks": True}), flush=True)
        return 2
    print(json.dumps({"fault": name, "caught": not held}), flush=True)
    return 1 if not held else 2


def autoscale_cards_phase(n: int, card: str) -> dict:
    """Phase 22 (c), under ``--cards n``: a card-less head, an
    ``Autoscaler`` with node type ``h100x4 = {"CPU": 4, "GPU": n}`` (0 to
    1) and a ``STRICT_PACK`` placement group of ``n`` ``{"GPU": 1}``
    bundles: one ``n``-card node launched whole, a forward in each bundle
    at once on ``n`` distinct cards of it, each bit-equal to this
    process's; then the node scaled down and nothing left."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import (
        Autoscaler,
        AutoscalerConfig,
        NodeTypeConfig,
    )
    from ray_tpu_torch.autoscaler.fake_provider import FakeMultiNodeProvider
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.api import get_runtime
    from ray_tpu_torch.core.config import env_overrides
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )
    cfg = GPT2Config.small()
    tokens = autoscale_tokens(cfg.vocab_size)
    ref = gpt2_reduction(GPT2(cfg, seed=0), tokens)
    torch.cuda.empty_cache()
    uuids = sorted(str(torch.cuda.get_device_properties(i).uuid)
                   for i in range(n))
    gate = tempfile.mkdtemp(prefix="chip_smoke_gang_")
    t = {}
    daemon = None
    outs: list = []
    with env_overrides(idle_worker_ttl_s=AUTOSCALE_TTL_S):
        c = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0})
        try:
            head = get_runtime()
            provider = FakeMultiNodeProvider(c)
            asc = Autoscaler(AutoscalerConfig(
                node_types=[NodeTypeConfig("h100x4", {"CPU": 4, "GPU": n},
                                           0, 1)],
                idle_timeout_s=AUTOSCALE_IDLE_S, update_interval_s=0.2),
                provider, head)
            asc.start()
            try:
                t0 = time.perf_counter()
                pg = rt.placement_group([{"GPU": 1}] * n,
                                        strategy="STRICT_PACK")
                ready = pg.ready(timeout=300)
                t["ready_s"] = time.perf_counter() - t0
                task = rt.remote(num_cpus=0, num_gpus=1)(autoscaled_forward)
                outs = rt.get([task.options(
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        pg, placement_group_bundle_index=i)).remote(
                    tokens, gate, n) for i in range(n)], timeout=900)
                t["result_s"] = time.perf_counter() - t0
                nodes = provider.non_terminated_nodes()
                node_id = nodes[0].node_id
                daemon = daemon_pid(c, node_id)
                cards = sorted(head._nodes[node_id].cards)
                types = [nd.node_type for nd in nodes]
                rt.remove_placement_group(pg)
                t1 = time.perf_counter()
                wait_for(lambda: not provider.non_terminated_nodes()
                         and asc.terminated_total == 1, 180,
                         "the idle node terminated")
                t["terminate_s"] = time.perf_counter() - t1
            finally:
                asc.stop()
        finally:
            c.shutdown()
            shutil.rmtree(gate, ignore_errors=True)
    left = node_processes_left({daemon} | {o["pid"] for o in outs}
                               - {None})
    rel = [reduction_rel(o, ref) for o in outs]
    print(f"autoscale (c) node type h100x4 {{CPU: 4, GPU: {n}}} (0-1), a "
          f"STRICT_PACK group of {n} {{GPU: 1}} bundles: ready "
          f"{t['ready_s']:.2f} s, nodes launched {asc.launched_total} "
          f"({types}), its card ids {cards}; {n} forwards at once, one a "
          f"bundle, on cards {[o['uuid'][:13] for o in outs]} (visible "
          f"{[o['visible'] for o in outs]}), relative differences to this "
          f"process's forward {rel}; results {t['result_s']:.2f} s; the "
          f"group removed -> terminated {t['terminate_s']:.2f} s; card "
          f"{card}", flush=True)
    checks = [
        (f"(c) one {n}-card node launched whole",
         asc.launched_total == 1 and types == ["h100x4"] and ready
         and len(cards) == n, [asc.launched_total, types, cards]),
        (f"(c) the {n} bundles' tasks on {n} distinct cards of that node",
         sorted(o["uuid"] for o in outs) == uuids
         and all(o["node"] == node_id for o in outs),
         [o["uuid"][:13] for o in outs]),
        ("(c) each forward bit-equal to this process's",
         all(r == 0.0 for r in rel), rel),
        (f"(c) {cfg.n_layer} flash_fwd launches a task, no backward",
         all(o["counts"].get("flash_fwd") == cfg.n_layer and not {
             k for k, v in o["counts"].items() if k != "flash_fwd" and v}
             for o in outs), [o["counts"] for o in outs]),
        ("(c) the node scaled down, nothing left",
         asc.terminated_total == 1 and not left, [asc.terminated_total,
                                                   left])]
    report_checks(checks, card, prefix="jobs")
    return t


def node_cards_from_head(self, resources, reported):
    """The planted fault ``node_cards_from_head``: a daemon node's cards
    read from this (the head's) process's environment, not its report."""
    return node_gpu_ids(math.ceil(resources.get("GPU", 0.0)))


def plant_fault(name: str) -> str:
    """Build kernel ``name``'s source with the fault of FAULTS, under the
    build directory, and bind that kernel's wrapper (and only it) to it.
    Returns the temporary directory, for the caller to remove."""
    old, new = FAULTS[name]
    kernel = fa._KERNELS[name]
    with open(build.sources()[kernel.source]) as f:
        src = f.read()
    check(src.count(old) == 1,
          f"the fault's anchor is in {kernel.source}.cu once")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fault-", dir=build.BUILD_DIR)
    cu, lib = (os.path.join(tmp, f"{kernel.source}.cu"),
               os.path.join(tmp, "lib.so"))
    with open(cu, "w") as f:
        f.write(src.replace(old, new))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.SRC_DIR,
                    "-o", lib, cu], check=True, capture_output=True,
                   timeout=600)
    fn = getattr(ctypes.CDLL(lib), kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    kernel._fn = fn
    return tmp


def square_fault_result(name: str, dev) -> dict:
    def fails(readings):
        return not all(r["ok"] for r in readings[name].values())

    kernel_caught = []
    for b, t in SHAPES:
        readings = kernel_readings(*kernel_inputs(b, t, dev))
        print(f"agreement B={b} T={t}: {describe(readings)}", flush=True)
        kernel_caught.append(fails(readings))
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)
    batch0 = device_batch(*train_batch(cfg.vocab_size), dev)
    layer_caught = [fails(r) for r in layer_readings(model, batch0)]
    worst_rel = attention_grad_readings(model, batch0)
    loss_kernel, loss_plain = step0_losses(model, batch0)
    return {"fault": name, "kernel_check_fails_it": all(kernel_caught),
            "layer_check_fails_it_on_layers":
                [i for i, caught in enumerate(layer_caught) if caught],
            "grad_check_fails_it": any(rel >= GRAD_TOL
                                       for rel, _ in worst_rel.values()),
            "loss_check_fails_it":
                abs(loss_kernel - loss_plain) >= STEP0_LOSS_TOL,
            "caught": all(kernel_caught) and any(layer_caught)}


def band_fault_result(name: str, dev) -> dict:
    def fails(readings):
        return not all(r["ok"] for r in readings[name].values())

    q, k, v, do = kernel_inputs(TRAIN_BATCH, TRAIN_SEQ, dev)
    band_caught = {}
    for n in SPLITS:
        for tq, tk, band in bands(q, k, v, do, n):
            readings = kernel_readings(*band, band=True)
            print(f"agreement split {n} band tq={tq} tk={tk}: "
                  f"{describe(readings)}", flush=True)
            band_caught[f"{tq}x{tk}"] = fails(readings)
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)
    batch0 = device_batch(*train_batch(cfg.vocab_size), dev)
    layer_caught, grad_caught = {}, {}
    for n in SPLITS:
        with flash_split(n):
            readings = layer_readings(model, batch0, SPLIT_CHECK_LAYERS,
                                      n_split=n)
            worst_rel = attention_grad_readings(model, batch0)
        layer_caught[n] = [i for i, r in zip(SPLIT_CHECK_LAYERS, readings)
                           if fails(r)]
        grad_caught[n] = any(rel >= GRAD_TOL for rel, _ in worst_rel.values())
    rect = [key for key in band_caught
            if int(key.split("x")[0]) < int(key.split("x")[1])]
    return {"fault": name, "band_check_fails_it_on": band_caught,
            "split_layer_check_fails_it_on_layers": layer_caught,
            "split_grad_check_fails_it": grad_caught,
            "caught": (all(band_caught[key] for key in rect)
                       and all(layer_caught.values()))}


def serve_fault_main(name: str, dev, card: str) -> int:
    """``--plant-fault serve_left_pad``: the build, then phase 17's (a) and
    (b) with the deployment padding its batches on the left, (b) read
    without raising. Exits 1 when (b) catches the fault (every response
    unequal to its batch recomputed, and off its request alone by more
    than SERVE_FAULT_MARGIN limits), 2 when it does not, and 2 when the run
    failed before (b)."""
    print(f"planted fault {name}: {SERVE_FAULTS[name]}", flush=True)
    try:
        t0 = time.perf_counter()
        build.ensure_built()
        print(f"build: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
        r = serve_phase(card, dev, fault=name)
    except Exception:  # noqa: BLE001 — the harness failed, not (b)
        traceback.print_exc()
        print(json.dumps({"fault": name, "caught": False,
                          "failed_before_b": True}), flush=True)
        return 2
    caught = (r["unequal"] == r["n"]
              and r["worst_alone"] > SERVE_FAULT_MARGIN * SERVE_ALONE_TOL)
    print(json.dumps({"fault": name, "responses": r["n"],
                      "unequal_to_their_batch": r["unequal"],
                      "worst_alone_over_rms": r["worst_alone"],
                      "limit": SERVE_ALONE_TOL,
                      "caught_above": SERVE_FAULT_MARGIN * SERVE_ALONE_TOL,
                      "caught": caught}), flush=True)
    return 1 if caught else 2


def vit_fault_main(name: str, dev, card: str) -> int:
    """``--plant-fault vit_padded_keys``: the build, then phase 12 (c')'s
    ring at sp VIT_SP[0] with every padded row read as a key. Prints
    ``{"fault", "caught"}``; exits 1 when the checks fail it, 2 when they
    miss it or the run fails before them."""
    build.ensure_built()
    vit_model.seq_blocks = _all_valid_blocks
    try:
        r = ring_check(VIT_BATCH, ViTConfig.base().num_patches + 1, H,
                       VIT_SP[0], dev, card, causal=False, strict=False)
    except Exception:  # noqa: BLE001 — a failed run is not a catch
        traceback.print_exc()
        print(json.dumps({"fault": name, "caught": False,
                          "error": "the run failed before its checks"}),
              flush=True)
        return 2
    print(json.dumps({"fault": name, "caught": not r["ok"]}), flush=True)
    return 1 if not r["ok"] else 2


def fault_main(name: str, dev) -> int:
    build.ensure_built()
    tmp = plant_fault(name)
    try:
        print(f"planted fault in {name}: "
              f"{FAULTS[name][1].splitlines()[-1].strip()}", flush=True)
        result = (band_fault_result if name in BAND
                  else square_fault_result)(name, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0 if result["caught"] else 1


# -- phase 16: the mesh routes across cards -----------------------------------


def cards_lines() -> tuple[list[str], str]:
    """Every visible card's name and power limit, and ``nvidia-smi topo
    -m`` (the links between them)."""
    names = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    nvlink = subprocess.run(["nvidia-smi", "nvlink", "-s", "-i", "0"],
                            capture_output=True, text=True, timeout=60)
    return names, "\n".join(
        f"$ nvidia-smi {' '.join(r.args[1:])} (exit {r.returncode}):\n"
        f"{(r.stdout + r.stderr).rstrip()}" for r in (topo, nvlink))


def multicard_phase(n: int,
                    fault: str | None = None) -> tuple[bool, list]:
    """Phase 16 on ``n`` cards (see the module docstring). Returns whether
    every check held, and every rank's results; with ``fault``, only (c)
    runs, with the fault planted in every rank."""
    names, topo = cards_lines()
    for i, line in enumerate(names):
        print(f"multicard card {i}: {line}", flush=True)
    print(f"multicard links:\n{topo}", flush=True)
    card = f"{names[0]} x {n}"
    t0 = time.perf_counter()
    results = multicard.run(n, "full", cases=("c",) if fault else
                            multicard.CASES, fault=fault, timeout=900)
    for line in multicard.report(results, n):
        print(f"multicard {line}; card {card}", flush=True)
    readings = multicard.checks(results)
    for what, ok, reading in readings:
        print(f"multicard check {'held' if ok else 'FAILED'}: {what}: "
              f"{reading}", flush=True)
    held = all(ok for _, ok, _ in readings)
    print(f"multicard: {len(results)} ranks, cases "
          f"{[c for c in multicard.CASES if c in results[0]]} in "
          f"{time.perf_counter() - t0:.1f} s; every check held: {held}",
          flush=True)
    if fault:
        return held, results
    t0 = time.perf_counter()
    ranks = dryrun_multichip(n)
    print(f"multicard (i) dryrun_multichip({n}), no device named: {ranks} "
          f"in {time.perf_counter() - t0:.1f} s; card {card}", flush=True)
    held = held and (
        [r["device"] for r in ranks] == [f"cuda:{i}" for i in range(n)]
        and all(np.isfinite(r["loss"]) for r in ranks)
        and len({r["loss"] for r in ranks}) == 1)
    return held, results


def cards_main(n: int, fault: str | None, card: str) -> int:
    """``--cards n``: the build and phase 16, then the card line and the
    result line; with ``fault``, exit 0 only if the checks fail it."""
    have = torch.cuda.device_count()
    if have < n:
        print(f"chip_smoke: --cards {n} needs {n} GPUs, {have} visible",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    build.ensure_built()
    print(f"build: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
    if fault in NODE_FAULTS:
        try:
            held = nodes_cards_phase(n, card, None, fault)
        except RuntimeError as e:
            # The head refuses a node whose cards another node holds.
            print(f"nodes check FAILED: (e) {n} daemons register, each on "
                  f"its own card: {e}; card {card}", flush=True)
            held = False
        print(json.dumps({"fault": fault, "caught": not held}), flush=True)
        return 0 if not held else 1
    if fault:
        held, _ = multicard_phase(n, fault)
        print(json.dumps({"fault": fault, "caught": not held}), flush=True)
        return 0 if not held else 1
    nc_rows = nc_rect_phase(default_device(), card)
    torch.cuda.empty_cache()
    held, results = multicard_phase(n)
    check(held, "phase 16: every multi-card check held")
    # The non-causal rectangle on its own path: rank 0's launches in (g)'s
    # ViT-B/16 steps on sp n (the counts set to 0 just before its steps),
    # its times from phase 3's rectangle on cuda:0.
    vit_sp = f"vit sp {n}"
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "causal": False,
                "path": f"{vit_sp}, rank 0, {multicard.STEPS} steps",
                "launches": results[0]["g"][vit_sp]["counts"].get(name, 0),
                **nc_rows[name]} for name in NC_RECT]
    print(json.dumps({"kernels": kernels}), flush=True)
    t16 = time.perf_counter()
    serve_cards_phase(n, card)
    print(f"multicard serve: {time.perf_counter() - t16:.1f} s", flush=True)
    t18 = time.perf_counter()
    ddp = tune_cards_phase(n, card)
    print(f"multicard tune: {time.perf_counter() - t18:.1f} s", flush=True)
    t19 = time.perf_counter()
    rllib_cards_phase(n, card)
    print(f"multicard rllib: {time.perf_counter() - t19:.1f} s", flush=True)
    t20 = time.perf_counter()
    nodes_cards_phase(n, card, ddp)
    print(f"multicard nodes: phase 20 (e) {time.perf_counter() - t20:.1f} s",
          flush=True)
    t21 = time.perf_counter()
    dag_cards = dag_cards_phase(n, card)
    print(f"multicard dag: phase 21 (c) {time.perf_counter() - t21:.1f} s, "
          f"{dag_cards['rate']:.2f} executes/s", flush=True)
    t22 = time.perf_counter()
    scaled = autoscale_cards_phase(n, card)
    print(f"multicard jobs: phase 22 (c) {time.perf_counter() - t22:.1f} s "
          f"(group ready {scaled['ready_s']:.2f} s, results "
          f"{scaled['result_s']:.2f} s, terminated "
          f"{scaled['terminate_s']:.2f} s); chip_smoke --cards {n}: "
          f"{time.perf_counter() - t0:.1f} s after the build began",
          flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plant-fault",
                        choices=sorted(FAULTS) + sorted(multicard.FAULTS)
                        + list(SERVE_FAULTS) + list(TUNE_FAULTS)
                        + list(RLLIB_FAULTS) + list(VIT_FAULTS)
                        + list(NODE_FAULTS) + list(DAG_FAULTS)
                        + list(JOB_FAULTS))
    parser.add_argument("--eager", action="store_true",
                        help="run every train step eagerly "
                        "(disable_capture), for the captured-vs-eager A/B")
    parser.add_argument("--cards", type=int, default=0,
                        help="run phase 16 (the mesh routes across this "
                        "many cards) instead of phases 1-15")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    card_faults = set(multicard.FAULTS) | set(NODE_FAULTS)
    if args.plant_fault and (args.plant_fault in card_faults) != bool(
            args.cards):
        parser.error("--cards takes no --plant-fault but those of "
                     "parallel.multicard.FAULTS and NODE_FAULTS, which need "
                     "--cards")
    dev = default_device()
    card = card_line()
    print(f"card: {card}", flush=True)
    if args.cards:
        return cards_main(args.cards, args.plant_fault, card)
    if args.plant_fault in SERVE_FAULTS:
        return serve_fault_main(args.plant_fault, dev, card)
    if args.plant_fault in TUNE_FAULTS:
        return tune_fault_main(args.plant_fault, card)
    if args.plant_fault in RLLIB_FAULTS:
        return rllib_fault_main(args.plant_fault, card)
    if args.plant_fault in VIT_FAULTS:
        return vit_fault_main(args.plant_fault, dev, card)
    if args.plant_fault in DAG_FAULTS:
        return dag_fault_main(args.plant_fault, card)
    if args.plant_fault in JOB_FAULTS:
        return jobs_fault_main(args.plant_fault, card)
    if args.plant_fault:
        return fault_main(args.plant_fault, dev)
    if args.eager:
        global CAPTURE
        CAPTURE = False
        with disable_capture():
            return run_all(dev, card)
    return run_all(dev, card)


def run_all(dev, card: str) -> int:
    """Every phase, then the kernels line, the card line and the result
    line."""
    t0 = time.perf_counter()
    build.ensure_built()
    print(f"build: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
    # Seconds of each phase (or group of phases), printed before the
    # kernels line.
    phase_s = {"2": time.perf_counter() - t0}
    tp = time.perf_counter()
    for name in build.sources():
        with open(build.log_path(name)) as f:
            print(f"build {name}: {ptxas_usage(f.read())}", flush=True)

    rows = {}
    for b, t in SHAPES:
        rows[(b, t)] = kernel_phase(b, t, dev)
    band_rows = band_phase(TRAIN_BATCH, TRAIN_SEQ, dev)
    nc_rows = nc_rect_phase(dev, card)
    phase_s["3, 5"], tp = time.perf_counter() - tp, time.perf_counter()

    main_run, loss_unsplit = train_phase(card)
    torch.cuda.empty_cache()
    split_runs = {}
    for n in SPLITS:
        split_runs[n] = split_train_phase(n, loss_unsplit, card)
        torch.cuda.empty_cache()
    remat_phase(main_run["peak"], card)
    phase_s["4, 6, 7"], tp = time.perf_counter() - tp, time.perf_counter()
    llama_phase(card)
    torch.cuda.empty_cache()
    resnet_phase(card)
    torch.cuda.empty_cache()
    vit_rows, vit_run = vit_phase(card)
    torch.cuda.empty_cache()
    moe_phase(card)
    torch.cuda.empty_cache()
    phase_s["8-11"], tp = time.perf_counter() - tp, time.perf_counter()
    mesh, plain, bidir = mesh_phase(main_run, card)
    torch.cuda.empty_cache()
    tp_phase(mesh, plain, card)
    torch.cuda.empty_cache()
    phase_s["12, 13"] = time.perf_counter() - tp
    t14 = time.perf_counter()
    runtime = runtime_phase(card)
    phase_s["14"] = time.perf_counter() - t14
    print(f"runtime: phase 14 {phase_s['14']:.1f} s; card {card}",
          flush=True)
    t15 = time.perf_counter()
    data_phase(card, main_run, runtime)
    phase_s["15"] = time.perf_counter() - t15
    print(f"data: phase 15 {phase_s['15']:.1f} s; card {card}", flush=True)
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    served = serve_phase(card, dev)
    phase_s["17"] = time.perf_counter() - t17
    print(f"serve: phase 17 {phase_s['17']:.1f} s; card {card}", flush=True)
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    legs = tune_phase(card, runtime)
    phase_s["18"] = time.perf_counter() - t18
    print(f"tune: phase 18 {time.perf_counter() - t18:.1f} s ((a) "
          f"{legs['a']:.1f} s, (b) {legs['b']:.1f} s, (c) {legs['c']:.1f} "
          f"s, (d) {legs['d']:.1f} s); card {card}", flush=True)
    t19 = time.perf_counter()
    legs = rllib_phase(card)
    phase_s["19"] = time.perf_counter() - t19
    print(f"rllib: phase 19 {time.perf_counter() - t19:.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in legs.items())
          + f"); card {card}", flush=True)
    t20 = time.perf_counter()
    nodes = nodes_phase(card, runtime)
    print(f"nodes: phase 20 {time.perf_counter() - t20:.1f} s (daemon "
          f"{nodes['legs']['daemon_s']:.2f} s, (b) actor "
          f"{nodes['legs']['actor_s']:.1f} s, (c) pull "
          f"{nodes['legs']['pull_mb_s']:.1f} MB/s, (d) fit "
          f"{nodes['legs']['fit_s']:.1f} s, drain to resume "
          f"{nodes['legs']['drain_to_resume_s']:.1f} s); card {card}",
          flush=True)
    phase_s["20"] = time.perf_counter() - t20
    t21 = time.perf_counter()
    dag = dag_phase(card, runtime)
    phase_s["21"] = time.perf_counter() - t21
    print(f"dag: phase 21 {phase_s['21']:.1f} s ((a) {dag['a']['leg_s']:.1f}"
          f" s: {dag['a']['rate']:.2f} executes/s, compile "
          f"{dag['a']['compile_s']:.1f} s; (b) {dag['b']['leg_s']:.1f} s); "
          f"card {card}", flush=True)
    t22 = time.perf_counter()
    jobs = jobs_phase(card, runtime)
    phase_s["22"] = time.perf_counter() - t22
    print(f"jobs: phase 22 {phase_s['22']:.1f} s ((a) "
          f"{jobs['a']['leg_s']:.1f} s: submit to SUCCEEDED "
          f"{jobs['a']['done_s']:.2f} s; (b) {jobs['b']['leg_s']:.1f} s: "
          f"demand to node {jobs['b']['node_s']:.2f} s, to result "
          f"{jobs['b']['result_s']:.2f} s, cleared floor to terminated "
          f"{jobs['b']['terminate_s']:.2f} s); card {card}", flush=True)
    print("phases (s): " + ", ".join(f"{k} {v:.1f}"
                                     for k, v in phase_s.items()),
          flush=True)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s after the build "
          "began", flush=True)
    print("phase 16 (the mesh routes across cards) needs --cards 4 and four "
          f"cards; {torch.cuda.device_count()} visible here", flush=True)

    main_rows = rows[(TRAIN_BATCH, TRAIN_SEQ)]
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": main_run["counts"][name], **main_rows[name]}
               for name in SQUARE]
    kernels += [{"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name],
                 "launches": split_runs[SPLITS[0]]["counts"][name],
                 **band_rows[SPLITS[0]][name]} for name in BAND]
    # The square kernels' non-causal route at ViT-B/16's shape, with the
    # ViT run's launches (the JAX ViT calls jax.nn.dot_product_attention;
    # the route is the causal=False arithmetic of the kernels replaced).
    kernels += [{"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "causal": False,
                 "launches": vit_run["counts"][name], **vit_rows[name]}
                for name in SQUARE]
    # The non-causal rectangle at ViT-B/16's sp 4 shapes (the last block's
    # 47 valid rows), with the launches of phase 12 (c'): ViT's ring,
    # RingAttentionFn's forward and backward, on 4 ranks run as threads on
    # this one card, one hop of each kernel a rank and a block. ViT itself
    # on sp 4 needs four cards (--cards 4 prints its launches).
    kernels += [{"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "causal": False,
                 "path": f"RingAttentionFn, sp {VIT_SP[0]} as threads",
                 "launches": bidir[VIT_SP[0]]["counts"][name],
                 **nc_rows[name]} for name in NC_RECT]
    # The forward kernel on the serving path: timed at a full batch
    # (SERVE_BATCH x 1024), launched by the replica of phase 17 (d).
    kernels.append({"name": "flash_fwd", "route": "cuda",
                    "source": SOURCES["flash_fwd"],
                    "replaces": REPLACES["flash_fwd"], "path": "serve",
                    **served["kernel"]})
    # The square kernels on the node path: launched by phase 20 (b)'s
    # actor in a worker that a node daemon hosts, timed at GPT-2's shape.
    kernels += [{"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "path": "node daemon actor",
                 "launches": nodes["counts"][name], **main_rows[name]}
                for name in SQUARE]
    # The forward kernel on the compiled DAG's path: launched by phase 21
    # (a)'s two stage actors (one launch a block an execute), timed at
    # their shape, phase 17's full batch.
    kernels.append({"name": "flash_fwd", "route": "cuda",
                    "source": SOURCES["flash_fwd"],
                    "replaces": REPLACES["flash_fwd"],
                    "path": "compiled dag stage",
                    **dict(served["kernel"], launches=dag["a"]["launches"])})
    # The square kernels on the workflow path: launched by phase 21 (b)'s
    # steps, each a num_gpus=1 task, timed at GPT-2's shape.
    kernels += [{"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "path": "workflow step",
                 "launches": dag["b"]["counts"][name], **main_rows[name]}
                for name in SQUARE]
    # The square kernels on the job's path: launched by phase 22 (a)'s
    # num_gpus=1 task of the job submitted over REST, timed at GPT-2's
    # shape; the forward kernel on the autoscaled node's path: launched by
    # (b)'s task there, timed at phase 17's full batch (its shape).
    kernels += [{"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "path": "job task",
                 "launches": jobs["a"]["counts"][name], **main_rows[name]}
                for name in SQUARE]
    kernels.append({"name": "flash_fwd", "route": "cuda",
                    "source": SOURCES["flash_fwd"],
                    "replaces": REPLACES["flash_fwd"],
                    "path": "autoscaled node",
                    **dict(served["kernel"],
                           launches=jobs["b"]["counts"]["flash_fwd"])})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
