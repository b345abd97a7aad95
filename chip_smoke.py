#!/usr/bin/env python3
"""Drive the PyTorch/H100 port once on the card: ``python3 chip_smoke.py``
(``python3 chip_smoke.py 4c 4d`` runs only the phases named, of
``d256``, ``4c``, ``4d``, ``6`` (its train runs, without phase 6's kernel
checks), ``6b``, ``6c``, ``9``, ``10``, ``11``, ``12``, ``13``, ``14``,
``15``, ``16`` and ``17``, after phases 1 and 2).

Run from the root of a checkout, on a machine with one NVIDIA H100, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA.  Imports nothing of JAX
or of the JAX package.  Phases, in order; any failure exits non-zero:

1. Device facts: name, count, and ``nvidia-smi``'s name and power limit.
2. Build the kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source, in parallel) and report the seconds.
3. Each kernel at the serve path's shapes against its plain PyTorch
   version on the same inputs (bf16 tolerance: |err| <= 2e-2 + 3e-2·|ref|),
   its device time (a CUDA graph of many calls, timed with CUDA events),
   its bound from shapes (bytes / 3.35 TB/s or FLOPs / 989 TFLOP/s, the
   larger), the plain version's time, and the time of one PyTorch library
   call computing the same function where there is one (timed only; the
   port never calls it).
   The GEMM runs each qwen2 product at a decode step's M = 8 and a
   prefill chunk's M = 128, printing its plan (regime, tile, split), and
   both sums are timed beside ``torch.matmul``.  Then the GEMM's design
   properties at full width: rows of a 1,024-row product equal the
   product of those rows alone at M = 1, 8, 44, 64, 65, 128, 300 and
   1,024, bitwise, for every (K, N) of qwen2-0.5b and mamba2-780m and two
   ragged ones, in bf16 and fp32; repeated runs give the same bits; A and
   B passed transposed, as the backward passes them, give the bits of
   contiguous copies at every train shape; fp32 operands (unit variance,
   not bf16 values) stay within the reference's fp32 tolerance (rtol
   1e-5, atol 1e-2), which ``torch.matmul`` with TF32 allowed must fail
   at every model K and N of 128 and up (a control).
   Then flash attention's properties at qwen2-0.5b's heads: a
   300-token prompt in one call and chunk by chunk as the paged prefill
   runs it give every row the same output and log-sum-exp, bitwise (with
   and without a window and a softcap); the forward with its
   log-sum-exp and the backward at the train shape give the same bits
   run to run; fp32 q, k, v (the CUDA-core kernel) stay within rtol 2e-5,
   atol 2e-2 of the plain version.
   At head dim 256 (gemma-2b: 8 query heads on one kv head) the flash
   forward (bf16 and fp32) and the backward against their plain versions
   at its dense prefill, a prefill chunk, a window, a softcap, rows with
   no visible key and its train shape; rows bitwise invariant to the
   chunking, forward and backward run to run bitwise; the forward timed
   beside its bound, its plain version and SDPA at the 512-token prefill,
   the backward at the train shape beside ``autograd.grad`` through SDPA.
   Paged decode attention at the serve shape (timed beside SDPA over the
   K/V gathered beforehand, a yardstick only), at head dims 32, 64, 128
   and 256 with 1, 7 and 16 query heads per kv head at lengths 1, KS - 1,
   KS, KS + 1 and the full table (KS the kernel's split), and bitwise:
   each sequence alone == inside the batch, a permuted table of the same
   K/V, run to run.
   The SSD scan is checked at mamba2-780m's prefill shapes (bf16 and fp32
   inputs, S = 512 and a ragged 300, two groups, an initial state, one
   step, one chunk) at the reference SSD test's tolerances, run to run
   bitwise, and bounded by fp32 or bf16 peak FLOP/s by its inputs' type;
   for fp32 inputs the TF32 tensor-core bound is printed beside it.
4. Serve qwen2-0.5b at full width, cut to 8 of its 24 layers
   (``SERVE_LAYERS``; random weights from a seed), through
   ``ContinuousEngine``: 16 requests, prompts of 64-512 tokens, 64 new
   tokens each.  Launch counts are zeroed just before and read just after;
   each kernel must have run, exactly as often as the model's layer loop
   says.  The same requests through the static paged ``Engine`` must give
   identical greedy tokens, and the card's logits must agree with the
   plain versions' on the CPU on a short prompt.  One decode step is also
   split into its host wall time and its device time.
4b. Serve the same model, params and requests through the static
   ``Engine`` on the dense KV cache (the reference's default): launch
   counts (``matmul`` 85 per prefill and per decode step, ``attention``
   12 per prefill, ``paged_decode_attention`` 12 per decode step); the
   dense decode attention (each slot's cache row one page of 1,024)
   bitwise the same K/V in 64-token pages, straight and permuted; the
   dense prefill and decode step against the CPU's at phase 4's
   tolerance; the greedy tokens against the static paged engine's, both
   paths teacher-forced along the paged streams, logits within phase 4's
   tolerance and a token parting only at a low-margin step; serve
   numbers and a decode step split as in phase 4.
4c. Serve gemma3-27b at full width, cut to 7 of its 62 layers (1
   global, window 1,024; 5.7 B parameters drawn on the card from the
   seed, every earlier model freed) through the static ``Engine`` on its
   windowed dense cache (8 slots, ``max_seq`` 2,048): 16 requests with
   prompts of 896-1,600 tokens and 64 new, so that rings wrap in prefill
   and in decode.  Launch counts (``matmul`` 92 per prefill and per
   decode step, ``attention`` 13 per prefill, ``paged_decode_attention``
   13 per decode step); serve numbers and a decode step split into eager
   wall and graph-replayed device time, beside the step's weight bound;
   every kernel call of 8 one-slot prefills (prompts of 4-1,600 tokens,
   past the window) and of two decode steps (a ring of 5 live slots,
   before, at and past the wrap) against its plain version on the same inputs: each distinct
   GEMM shape against ``ref.matmul``, each flash call (head dim 128, GQA
   2, window 1,024 on the local layers) against ``ref.attention``, each
   local layer's ring against ``decode_attention_ring`` and each global
   layer's decode against ``ref.paged_decode_attention``; the first 6
   layers (5 local, 1 global) with the model's own embed, norm
   and unembed against the CPU's plain versions (a 1,040-token prompt
   that wraps in the prefill, then 4 decode steps, phase 4's tolerance);
   prefill-then-decode at the cut's depth against the full windowed forward
   over the same tokens (5%, derived at ``G3_DEPTH_TOL``); the served
   tokens of two requests against that forward by the margin rule.  The
   model is freed before phase 4d.
4d. Serve gemma-2b at full width, cut to 9 of its 18 layers (head dim
   256, MQA) on phase 4's requests: the dense default with its launch
   counts (``matmul`` 64 per prefill and per decode step, ``attention`` 9
   per prefill, ``paged_decode_attention`` 9 per decode step), serve numbers
   and a decode step split, every kernel call of 8 prefills and a decode
   step held against its plain version as in 4c (the flash calls at head
   dim 256), card vs CPU on the dense cache, and the same
   requests through the static paged ``Engine`` and ``ContinuousEngine``
   (equal tokens), the dense engine against them by the margin rule.
5. Serve mamba2-780m at full width, cut to 12 of its 48 layers, through
   the dense-cache static ``Engine`` (8 slots, the same 16-request set),
   with its own launch-count check (``matmul`` 121 per prefill and per
   decode step, ``ssd`` 24 per prefill); hold the GEMM kernel against its plain
   version at each mamba2 product's shape, at M = 8 (a decode step) and
   at a ragged prefill M = 300, and time them beside ``torch.matmul``;
   split a decode step into
   GEMM, the plain ``ssd_step`` and convolutions, other device work and
   host time; hold the card's prefill states and logits against the
   CPU's (with controls that must fail), and prefill-then-decode against
   the full forward.
6. Train qwen2-0.5b at full width (24 layers) through ``Session``.  The
   train kernels first: ``quantize_int8`` bitwise against its plain
   version at each of the int8 wire's 9 bucket lengths, a ragged length,
   exact .5 ties and a zero bucket; the attention backward kernel (and the
   forward with its log-sum-exp) at the train shape and at ragged, window,
   softcap and fully-masked shapes, the forward timed beside its bound
   and SDPA at the train shape; the GEMM's backward products at every
   train shape, on the transposed views the backward passes; each timed
   beside its bound, its plain version and a library call.  Then run 2,
   one rank without a wire (``comms="off"``) on 4 x 512 tokens of
   ``SyntheticLM(structured=True)``, with its launch
   counts; the card's 2-layer loss and gradients against the CPU's; and
   two ranks spawned on the one card over gloo: run 3 (fp32 wire, psum,
   one step, held to run 2) and run 4, the main path (int8 wire, 6 steps,
   ``CommsPlan(schedule="auto")`` resolved by the topology cost model to
   ``tree``, as the reference's at two ranks, the schedule printed; a
   line of two is the backend's all-reduce, the same bits as ``psum``):
   replicas bitwise equal after every step, step 1 held to run 3, the loss
   falling, launches per rank equal to the layer loop's (9
   ``quantize_int8`` per step), a bucket recomputed on the host equal to
   the wire's and a control without one rank's contribution that must
   differ; step, device, host, wire and optimizer times, tokens per
   second, wire bytes and peak memory per rank; then ``tree`` beside
   ``psum`` on the int8 wire, psum then tree:
   ``sync_tree`` alone on the same gradients (bitwise equal) and whole
   steps.
6b. Train gemma-2b at full width and depth on one rank through
   ``Session`` (``comms="off"``, 2 x 512 tokens of
   ``SyntheticLM(structured=True)``): the first batch's gradients under
   ``remat="group:3"`` and ``"full"`` from the same params bitwise equal;
   two steps under ``group:3`` and a third under ``full`` on the first
   batch again, each step's launches the layer loop's for its remat, the
   third loss below the first; then the 2-layer loss and gradients
   against the CPU's, as in phase 6.
6c. The SSD backward kernel first (``check_ssd_backward``): its six
   gradients (dx, ddt, dA, dB, dC, d init_state) against autograd
   through ``ssd_plain`` at mamba2-780m's widths, bf16 and fp32, S = 512
   (the train shape, 2 x 512), a ragged 300 and one chunk of 64, one and
   two groups, with and without an initial state and a final-state
   cotangent, each within its dtype's SSD_TOL of its largest magnitude;
   two more runs bitwise; once through the autograd wrapper (one forward
   and one backward launch); the train shape timed beside its bound, the
   plain version and the forward, and its device µs by pass, which sum to
   within 10% of its timed ms where ``within_10pct_of_ms`` says so (a
   reading, not a gate).  Then mamba2-780m trained on one rank
   at full width and depth (48 layers) through ``Session``
   (``comms="off"``, ``remat="full"``, AdamW at its peak rate from step
   1, 2 x 512 tokens of ``SyntheticLM(structured=True)``): three steps,
   the third on the first batch again with its loss below the first,
   each step's launches the layer loop's (the SSD forward twice a layer,
   its backward once); step ms and the peak; a fourth step profiled for
   the card's idle share; every SSD backward call of one more forward and
   backward held against the plain version at its own shapes; the
   2-layer loss and gradients against the CPU's, as in phase 6.
7. The compressed data-parallel SGD path at full width.  The kernels
   first: ``quantize_compress`` bitwise (q and scale) against its plain
   version, and its error-feedback form ``quantize_compress_ef`` (the
   path's quantizer: bf16 gradients, fp32 error drawn at 1e-2 of their
   scale) bitwise in deq, new error and scale, at each of qwen2-0.5b's 15
   leaf lengths (both timed, the EF form beside the unfused composition
   it replaced), ragged lengths, a bf16 input, an all-zero input, exact
   .5 ties, a negative absmax and n = 1; ``matmul_dequant`` (reached
   through ``ops.matmul_dequant`` only: no model path calls it), bf16
   and fp32 activations, at qwen2-0.5b's eight decode products (M = 8,
   timed as one decode step's 169), at a prefill M = 128, the bench shape
   (8, 1024, 1024) and the ragged shapes: bitwise ``matmul`` on the
   widened weights times the scale (fp32 and bf16 outputs), the same bits
   run to run, rows of an M = 8 call equal to those rows of the M = 128
   call, the reference test's tolerances (fp32 2e-5, bf16 2e-2) as a
   second gate; timed beside ``torch.matmul`` on the weights widened
   beforehand (a yardstick) and ``_weight_int8pack_mm`` where this
   PyTorch registers it for CUDA (the library call).  Then two ranks
   spawned on the card over gloo run
   ``train.compression.build_dp_sgd_step`` over the model's loss for the
   schemes ``none``, ``onebit`` and ``int8``, 2 steps each from the seed
   (lr 0.1, momentum 0.9, 4 x 512 tokens of
   ``SyntheticLM(structured=True)`` a step), each scheme a counted
   window: params and velocity bitwise equal on both ranks after every
   step (the error state is each rank's own); launches per rank equal to
   the layer loop's (``quantize_compress``, counting the EF form, 15 per
   int8 step, 0 for the other schemes); ``none``'s step-1 synced
   gradients the bf16 mean of the local gradients computed alone,
   bitwise; int8's within (s0 + s1) / 4 of their fp32 mean, plus fp32
   rounding; error feedback exact
   (int8: deq + err equals v bitwise or within one fp32 spacing; onebit
   within rtol 1e-5); the first batch's loss lower after ``none``'s
   steps; step, wire and quantizer times, tokens per second, wire bytes
   and peak memory per rank.
8. The CLIs, as a user starts them, in a temporary directory removed at
   the end: ``python -m repro_torch.launch.serve`` on the dense default
   with ``--metrics`` (phase 4's request shape), then
   ``python -m repro_torch.launch.train`` on one rank at
   ``--scale-down 16`` (``CLI_TRAIN_DOWN``: 2 layers, d_model 64; 2 x
   512 tokens, 4 steps, saves at steps 2 and 4, ``--metrics``), then a
   resume of a hard-linked copy of step 2 with nothing left to train,
   whose save must equal the original byte for byte; the JSONL streams
   and snapshots must parse and hold the histograms and spans; prints
   the checkpoint's bytes and save seconds.
9. dMath's distributed linear algebra (``repro_torch.core``) on four
   ranks spawned on the one card over gloo (a ``file://`` rendezvous under
   ``build/chip_smoke/``), mesh (data=2, model=2).  qwen2-0.5b's MLP
   products at 2,048 tokens (up (2048, 896) @ (896, 4864), down (2048,
   4864) @ (4864, 896)), bf16 under ``MIXED`` and fp32 under ``FULL``,
   through the six algorithms and ``gemm_auto`` over 4 x 4 operand
   layouts x {none, rep, row, col, b2d} out layouts: every C gathered and
   held against the plain product of the global operands (bf16: phase
   3's rule; fp32, unit-variance operands: the conformance rule rtol
   2e-5, atol 2e-5 at K = 64, its atol grown by sqrt(K / 64), against the
   float64 product), every rank's local product against its plain
   version on the same block, and the wire bytes of every plan whose
   moves the reference's estimate models equal to its ``est_bytes``.
   gemma3-27b's MLP up-projection at full width ((2048, 5376) @ (5376,
   21504), bf16): each algorithm and ``gemm_auto`` from col x row, held
   once and timed three times (wall ms, the median), the bytes handed to
   collectives beside the estimate, peak memory per rank, and the local
   GEMM's device ms beside ``torch.matmul``'s on rank 0.  Every relayout
   pair of {rep, row, col, b2d} at (4096, 4096), fp32 -> bf16 and back:
   bf16 alone on the wire, bitwise the local cast.
   ``add_row_col_sum_matrix`` at 4096 x 4096 (both modes, the
   deterministic one bitwise run to run) and ``conv2d_halo`` at AlexNet
   conv2's channels (96 -> 256, 5 x 5 and 3 x 3, B = 32, H = W = 28)
   against the unsharded fp32 conv; ``Session.tensor``, ``@``, ``+``,
   ``with_layout``, ``to_global``, the session's table, an op-cache hit.
   Each rank's ``matmul`` launches equal the local products its plans
   call for.  These are gloo-through-host-memory times on one card.
10. Hybrid data x tensor/sequence parallel training: qwen2-0.5b at full
   width (cut to 12 of its 24 layers, ``HYBRID_LAYERS``) on four ranks
   spawned on the one card over gloo,
   ``Session(mesh=...)`` with ``comms="off"`` (the gspmd path with the
   implicit gradient sync and ZeRO-1 AdamW), 4 x 512 tokens,
   ``remat="full"``: 3 steps on (data=2, model=2) (head-TP with the
   sequence-parallel residual) and 3 on (data=1, model=4) (SP with the
   local MLP).  Before the spawn, the one-rank step on the card from the
   same seed and batches is the yardstick, its state after each step
   saved; a rank starts each step from its blocks of the yardstick's
   state before it.  Each step's loss and grad norm within rtol 1e-3 of
   the yardstick's; after each step but the last every rank's param
   blocks within phase 6's step rule of its params' blocks, and every
   rank's mu and nu block within the gradient rule of the matching block
   of its moments (the fp32 rule read beside it).  A witness, not a
   gate: the one-rank steps again with every batch's rows reversed, free
   running, and its distance from the yardstick.  Each rank's
   ``matmul``, flash forward and backward launches equal the layer
   structure's counts, no other kernel runs, every distinct local GEMM
   shape (forward, and dA/dB at the same shapes) and every flash case
   (forward and backward, the SP blocks at their ``q_offset``) is held
   against its plain version; prints per mesh the step wall (step 2),
   the wall of step 3 with its host ms inside the
   collectives (the card synchronized before each), tokens/s,
   each rank's peak memory and bytes received per step by collective,
   equal to the estimate from the layouts.  Then mamba2-780m at full
   width cut to 8 layers on (2, 2) with the sequence-parallel residual
   (the mixer on 24 of the 48 SSD heads a rank: a bf16 gather of the
   residual, bf16 convolutions and scan inputs, the gated norm's fp32
   sum of squares, the bf16 reduce-scatter), 2 steps, held the same way
   against the same cut on one rank on a (1, 1) mesh (the same mixer's
   numerics; the distance from the model without a mesh, whose mixer
   runs fp32, is printed), every distinct SSD forward and backward case
   held against its plain version.  Also alone: ``python3
   chip_smoke.py 10``.
11. The all-reduce schedules, the topology's link fit and the memory
   verdict (also alone: ``python3 chip_smoke.py 11``).  Four ranks
   spawned on the one card over gloo run ``psum``, ``ring``, ``rsag`` and
   ``tree`` over the 4-rank ``model`` line of a (1, 4) mesh and ``hier``
   over (data, model) of (2, 2) with ``intra_axis="model"``, on fp32 and
   bf16 buckets of an odd size (262,147 elements: padding) and of 4 MiB,
   and the int8 wire (``quantize_int8`` on the card) through each: every
   rank's result the same bits, each bitwise the same schedule run on
   CPU tensors in the same ranks (a control with rank 0's bucket one ulp
   up must break that for the ring), each within ``tests/test_comms.py``'s
   tolerances of the fp64 sum; each schedule's bytes received per rank
   (``WIRE``) beside ``allreduce_design``'s, equal where the dataflow is
   the modelled one (psum gathers, and says so); launches 5
   ``quantize_int8`` per rank.  Then every schedule timed at 4 KiB to
   16 MiB by factors of 16 (median of 3 after a warm-up, the slowest
   rank's wall), each run a ``collective_sample`` event through ``obs``,
   one link fitted (``calibrate.fit_link``: alpha, bandwidth, residual;
   the table saved to ``build/chip_smoke/calibration.json``) and, per
   size, the fastest schedule measured beside ``best_schedule`` under the
   fitted and the nominal links (a finding; the gate is a positive
   link).  Then, in this process: ``Session()``'s budget is the h100
   entry, ``plan("gemma3-27b", batch=2, seq=512)`` raises
   ``PlanMemoryError`` with ``torch.cuda.memory_allocated()`` unchanged,
   the model's peak per rank for phase 10's meshes beside the peaks
   phase 10 measured, ``best_hybrid`` for qwen2-0.5b on 4 devices; and
   the train CLI for 2 steps at phase 8's depth with ``--hbm-gib 80
   --calibration`` that table, and its drift report.
12. The whole Session (also alone: ``python3 chip_smoke.py 12``).  (a)
   ``Session.plan("qwen2-0.5b", batch=8, seq=1024, kind="decode")`` and
   ``Session.serve`` at full width and depth on 8 of phase 4's requests
   with 32 new tokens, the static engine on the dense cache and then the
   continuous one: launch counts, greedy tokens bitwise those of the same
   engine built directly on the same params, tok/s and TTFT p50.  (b) A
   second ``serve`` under the same name: the params' storages the same,
   the allocator's requested bytes grown by the new cache's bytes alone
   (within its 512-byte rounding; ``memory_allocated``, which counts a
   reused cached block up to 1 MiB larger than the request, printed
   beside), no copy of a weight's shape in the
   profile, the steps op-cache hits (``describe()`` printed), cold start
   and restart ms, and its tokens the first engine's.  (c) A continuous
   pool over a budget that holds the params and half the pool: refused
   with ``PlanMemoryError`` and ``memory_allocated`` unchanged.  (d)
   ``AutoTuner.pick`` over qwen2-0.5b's forward and backward at 2 x 512
   under remat ``none``, ``full`` and ``group:4``, each candidate's
   workspace its dry-traced peak, the budget between the two largest:
   ``none`` alone disqualified; each candidate's traced and measured
   peak and ms.  (e) ``python -m repro_torch.launch.dryrun --arch
   qwen2-0.5b --shape train_4k`` (16 x 16, 256 fake ranks) passes.  (f)
   One rank's 2 x 512 step: the dry trace's peak over one real step's
   ``max_memory_allocated`` within 0.5-2.0; phase 10's (2, 2) cell traced
   on 4 fake ranks: its bytes per collective equal to
   ``hybrid_wire_estimate`` and 875,241,216 in all.  (g) The backend
   ``init_group`` picks: gloo for four ranks on one card, NCCL for one
   rank (an all-reduce on it).
13. The pipeline (also alone: ``python3 chip_smoke.py 13``): qwen2-0.5b
   at full width (cut to 4 of its 24 layers, ``PIPE_LAYERS``;
   ``remat="full"``), 8 x 512 tokens
   a step in one-row microbatches (M = 2 pp), four gloo ranks spawned on
   the one card, on (data, pipe, model) = (1, 4, 1) and (2, 2, 1), each
   under GPipe and 1F1B, 2 steps each from the seed (step 2 from the
   one-rank yardstick's state after step 1); then mamba2-780m cut to 8
   layers on (1, 4, 1) under 1F1B.  Each rank first runs one layer's
   loss and gradients alone (its first kernel calls, which the pipeline
   would queue stage after stage).  The yardstick is the port's one-rank
   step at the same batch and one-row microbatches.  Gates: every step's
   microbatch losses bitwise the yardstick's (the same rows through the
   same row-invariant kernels; 1F1B's backward-slot recompute the same
   bits as its forward slot); the step loss within 1e-6 relative, the
   grad norm within 2^-9; after step 1 the params within phase 6's step
   rule and the moments within phase 10's rule and, element by element,
   within the reordered sum's bound (``moment_bounds``: the microbatches'
   gradients are the same bits in both runs, summed in fp32 in another
   order); the edge params bitwise the same on every rank; a pipe line's
   ``send_recv`` bytes ``costs.boundary_wire_bytes`` (44,040,192 on
   (1, 4, 1), 7,340,032 a data row on (2, 2, 1)) and every other
   collective's bytes the layouts' estimate (``pipe_wire_estimate``);
   launches per rank the stage's layer structure
   (``expected_pipe_launches``); each kernel's first call of each case
   held against its plain version.  Read, not gated: step walls, the
   share of each step inside ``exchange``, the bubble, the card's idle
   share (the profiled step 2), each rank's step-2 peak beside
   ``stage_footprint``, 1F1B's peak over GPipe's, the headroom (each
   rank's step-2 reserved peak and their sum, the card's free memory
   after each step and after the checks, the parent's reserved memory
   at the spawn).
14. The moe family (also alone: ``python3 chip_smoke.py 14``).  (a) The
   GEMM's batched mode (one launch for an expert bank) at deepseek-moe-
   16b's bank shapes (64 experts; 2048 x 1408 and 1408 x 2048) at
   capacities 8, 15, 60 and 120 (a decode step, a paged chunk, a 512-
   token prefill, a 2 x 512 train step) and dbrx-132b's (16 experts;
   6144 x 10752 and 10752 x 6144) at 8 and 40: against the plain version,
   every expert's slice bitwise the 2-D kernel on that expert, run to run
   bitwise, the backward's dA and dB on the transposed views bitwise the
   2-D kernel per expert; timed beside the bound, the plain version and
   ``torch.bmm``.  (b) deepseek-moe-16b at full width and depth (28
   layers, 16.9 B parameters drawn on the card a layer at a time, every
   earlier model freed) on the first 8 of phase 4's requests to 32 new
   tokens through the static ``Engine`` on the dense cache and
   ``ContinuousEngine``: launch counts (``matmul`` 309 per prefill call and decode step: 4 attention
   products, the router, 3 bank products, 3 shared-expert products a
   layer and the unembed; ``attention`` 28 per prefill call,
   ``paged_decode_attention`` 28 per decode step; 3 batched launches a
   layer), serve numbers, a decode step split beside its weight bound,
   every kernel call of 8 one-slot prefills and a decode step against its
   plain version; the first 6 layers against the CPU's plain versions and
   prefill-then-decode against the full forward by the routing rule
   (the second run dispatches on the first's routes, and where its own
   top-k set differs its k-th/(k+1)-th probability margin must be under
   ``MOE_MARGIN``; every logit compared).  (c) Its 4-layer cut trained on one
   rank through ``Session`` (2 x 512 tokens, ``remat="full"``, AdamW, 3
   steps) after the memory model's verdict: gradients bitwise run to run,
   the loss falling, aux printed, launches the layer loop's; the 2-layer
   loss and gradients against the CPU's, the CPU on the card's routes.
15. The Model's last three families (also alone: ``python3 chip_smoke.py
   15``).  (b) zamba2-1.2b's kernels at its shapes: the SSD forward (bf16
   and fp32) at a 512-token prefill and the 2 x 512 train shape with H =
   64, P = 64, N = 64 and its backward at the train shape (slices of 3
   heads: 21 and one of 1), flash forward and backward at MHA 32 heads of
   64, paged decode on 8 slots; each against its plain version, timed
   beside its bound, its plain version and SDPA where one computes it.
   (a) zamba2-1.2b at full width and depth (38 layers, the shared block
   at 6 sites, a 2-layer tail; 1,170,313,344 parameters) on the first 8
   of phase 4's requests to 32 new tokens through the static ``Engine``
   on the dense cache and through ``Session.serve`` (the Engine's
   tokens): launch counts (``matmul`` 233 per
   prefill and decode step: 5 a mamba layer, 7 a site, the unembed;
   ``ssd`` 38 and ``attention`` 6 per prefill; ``paged_decode_attention``
   6 per decode step), serve numbers, the decode step's eager wall and
   graph-replayed device time beside its bound (weights, states and the
   sites' K/V read once); every kernel call of 8 one-slot prefills and a
   decode step against its plain version (every SSD forward call too);
   prefill-then-decode against the full forward; layers 0-6 (a site and a
   tail layer) against the CPU's plain versions.  (c) It trains on one
   rank from the served weights (2 x 512 tokens, ``remat="full"``, AdamW,
   3 steps): gradients bitwise run to run, launches the layer loop's (the
   nested checkpoints: a group's mamba layers run three times, its shared
   block twice), the loss falling, the step wall, the idle share of a
   profiled step and the peak beside the memory model's footprint; the
   7-layer cut's loss and every gradient against the CPU's.  (d)
   musicgen-medium at full width and depth (48 layers) on the first 8
   of phase 4's requests to 32 new tokens through the static ``Engine``
   on the dense cache, ``ContinuousEngine`` and the static paged
   ``Engine`` (its tokens the continuous engine's), with their launch
   counts.  (e) internvl2-26b at full width cut to 4 layers:
   a forward over 1,024 nonzero vision embeddings ahead of 512 text
   tokens (2 rows), the prefix moving the logits, the first layer's
   residual and last logits against the CPU's; 2 train steps on one rank
   after the memory model's verdict, their launches; the static
   ``Engine`` on phase 4's requests as text.  Each part's seconds.
16. AlexNet, the paper's Table 1 network, and the robustness layer (also
   alone: ``python3 chip_smoke.py 16``).  (a) AlexNet at full width on
   one rank (224², 1,000 classes, fc 4,096, 62,369,152 parameters from
   the seed): at 8 images the loss and every gradient leaf against the
   CPU's plain versions, the FC leaves at tests/test_torch_convnet.py's
   rule (the bf16 rule for all but 0.5% of a leaf, 5e-2 relative rms:
   phase 6's rms; its largest-error rule fails where a ReLU or a pool
   routes a row's gradient elsewhere), each conv's
   output, input gradient and fp32 weight gradient on the same input and
   upstream gradient at an fp32 rule (1e-4 of the largest: TF32 is off;
   the conv leaves end to end printed: the pools' argmax moves where a
   bf16 activation rounds the other way); at
   128 images the ``value_and_grad`` step's median wall after the first,
   images/s, the idle share of a profiled step, the peak, 9 GEMM
   launches a step (3 forward, 6 backward), the conv stack's forward and
   backward ms beside its fp32 CUDA-core bound, the FC head's 9 products
   on the GEMM kernel beside ``torch.matmul``'s (timed only).  (b) The
   same weights and batch on a (2,2) data x model mesh, four gloo ranks
   on the card: the loss and every rank's FC gradient blocks against
   (a)'s by that rule, its conv leaves against half the sum of one rank's
   gradients on each data coordinate's 64 rows (the convs at the mesh's
   batch) and printed against (a)'s; the bytes each rank received equal to
   ``convnet.wire_bytes`` (the layouts' estimate).  (c) qwen2-0.5b at
   full width cut to 4 layers, one rank, 8 steps of 2 x 256 tokens: the
   no-fault oracle; a NaN step and a collective timeout recovered with
   the oracle's losses bitwise (the rollback snapshot refreshed every 2
   steps; the other runs take one an attempt); a torn checkpoint
   (``ckpt_every=2``) restarted by ``ElasticRunner`` from step 4 with
   the oracle's losses;
   a straggler burst escalated to ``StepAbort("watchdog_escalation")``
   with an early checkpoint (its only one), then restarted; ``recovery_s``,
   ``steps_lost``, the snapshot's bytes and ms a step, each checkpoint's
   write ms.  (d) Phase 4's model and requests on the
   ``ContinuousEngine`` under an ``arm_engine`` pool storm (every free
   page for 24 ticks) with two already-expired requests: preemptions
   counted, the two shed with ``DeadlineExceeded``, every admitted
   request's tokens bitwise a storm-free run's.  Each part's seconds.
17. Serving on a mesh (also alone: ``python3 chip_smoke.py 17``).  The
   paged kernel's shard mode on each of 4 shards of qwen2's 8 slots of
   2,048 positions (512 each) against its plain version (partials m, l
   at 1e-3, o at the bf16 rule), the combine of the 4 ranks' partials
   against the plain combine, both bitwise run to run, and the shards'
   combine bitwise the one-rank call over the whole rows; each timed
   beside the one-rank call, its bound and its plain version.  Flash
   attention (bf16 and fp32 forward, backward) and the paged decode at
   head dims 40, 42, 48, 56, 160 and 168 against their plain versions,
   each timed.  Then qwen2-0.5b at full width and depth (24 layers,
   random weights from the seed) on one rank and on (1,4) and (2,2) over
   four gloo ranks on the card, the static ``Engine`` on the dense cache
   and the ``ContinuousEngine`` (page 64, chunk 128), 8 slots of 2,048,
   phase 4's first 8 requests to 32 new tokens: every rank's tokens and
   logits the same; the decode logits within 5% of the largest one-rank
   logit wherever the slot was fed alike; the shard and combine kernels
   launched 24 times a decode step on every rank, the paged one-rank
   call never; each rank's cache 1/4 of 201,326,592 bytes, its pool
   ceil(pages / 4) pages; a decode step's, a 512-token prefill's and a
   128-token chunk's bytes by collective equal to the layouts' estimate;
   tok/s, the decode step's wall and the card's idle share.
18. Print the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, scale_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import gemm as gemm_mod  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.models import Model, ssm  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, Request  # noqa: E402

# the card's peaks and each kernel's bytes and FLOPs: one source
from repro_torch.kernels import roofline  # noqa: E402
from repro_torch.kernels.roofline import (BF16_FLOPS, FP32_FLOPS,  # noqa: E402
                                          HBM_BYTES_PER_S, L2_BYTES,
                                          TF32_FLOPS, bound)
RTOL, ATOL = 3e-2, 2e-2            # bf16: 8 mantissa bits, fp32 sums
# the reference's SSD test (tests/test_kernels.py): the same fp32 math in
# another order; y stored in bf16
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
SSD_Q = ssd_mod.CHUNK              # the SSD kernel's chunk
# Card against CPU at full depth, in fractions of the largest logit.  The
# CPU parity test measures 0.17% at 8 mamba2 layers (one bf16 rounding of
# the residual stream falling the other way,
# tests/test_torch_ssm.py::test_prefill_matches_reference); growing
# linearly with depth that is ~1% at 48, and the card, whose GEMM sums in
# another order in every product, flips more roundings than XLA against
# PyTorch on the CPU: 5%, as for qwen2 (0.32% at 2 layers, 2.29% measured
# at 24).
LOGIT_TOL = 5e-2
# States against states computed from the same inputs, in fractions of the
# state's largest magnitude: the same fp32 math in another order, except
# where a bf16 rounding (of the residual stream, or of a conv state stored
# in bf16) falls the other way and moves a value by 2^-8 of itself.  Holds
# prefill + decode against the forward, and the first layer's prefill
# states on the card against the CPU's (its inputs are the same embedding
# rows in both; every layer runs the same kernels at the same shapes, so
# a wrong scan shows there).  Deeper layers' states, card against CPU, are
# printed, not held to a tolerance: their drift is the residual stream's,
# grown with depth (on an H100, up to 5.5% relative RMS in the SSM state
# of the worst layer, 3.4-3.5% in the conv inputs), and the logit check
# bounds that stream at the last layer.
STATE_TOL = 1e-2

ARCH = "qwen2-0.5b"
MAMBA = "mamba2-780m"
MAMBA_PARAMS = 857_293_056
# mamba2-780m's depth in phase 5: 12 of its 48 layers since phase 17 came
# (24 since phase 14; phase 6c trains it at full depth)
MAMBA_SERVE_LAYERS = 12
PREFILL_M = 300                    # a ragged prompt: 4 GEMM row tiles + 44
SEED = 0
N_REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS = 16, 64, 512, 64
SLOTS, MAX_SEQ, PAGE, CHUNK = 8, 1024, 64, 128
# qwen2-0.5b's depth in phases 4 and 4b: 8 of its 24 layers since phase
# 17 came (12 since phase 14: the whole script stays inside its time
# limit; phases 6-8, 12 and 17 run it at full depth)
SERVE_LAYERS = 8


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(calls, iters: int, warmup: int = 3) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    timed with CUDA events over its replay (the median of 3), so the host's
    launch overhead does not show in a kernel's time.  ``calls`` rotates
    over copies of the inputs large enough together to overflow the 50 MB
    L2, as on the serve path, where each layer's weights and pages arrive
    cold."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            calls[i % len(calls)]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


# each multi-kernel call's kernels in launch order, for pass_us
ATTN_BWD_PASSES = ("attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq",
                   "attn_bwd_sum")
PAGED_PASSES = ("paged_split", "paged_combine")
SSD_PASSES = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")


def pass_us(calls, iters: int, passes, sessions: int = 3) -> dict:
    """A multi-kernel call's device µs by pass: ``iters`` eager calls,
    rotating over ``calls``, recorded by the profiler after a warm-up
    cycle of as many (the profiler's ``schedule``: late in a whole run of
    this script a session's first calls go unrecorded, and a short
    session can record none).  ``passes`` names each kernel of a call, in
    launch order, by a piece of its name; a call is a run of kernels that
    match them in order, and only whole calls count (``calls``), so a
    call of which the profiler dropped a kernel is left out, not read
    short.  A session that records no whole call is made again, up to
    ``sessions`` in all (``sessions``: the one read).  Each pass is
    charged from the end of the pass before it (or its own start, if
    later) to its own end, so a programmatic dependent, which opens while
    the pass before it runs and waits, is not counted twice, and a call's
    passes sum to its span on the device less the host's gaps;
    ``between`` is the mean gap from one call's end to the next one's
    start."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for session in range(1, sessions + 1):
        kern = []

        def ready(prof):
            kern.extend((e.time_range.start, e.time_range.end, e.name)
                        for e in prof.events()
                        if "CUDA" in str(e.device_type)
                        and any(p in e.name for p in passes))
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):           # the warm-up cycle, then the read
                for i in range(iters):
                    calls[i % len(calls)]()
                torch.cuda.synchronize()
                prof.step()
        kern.sort()
        out = {p: 0.0 for p in passes}
        out["between"], prev_end, n, k = 0.0, None, 0, 0
        while k + len(passes) <= len(kern):
            call = kern[k:k + len(passes)]
            if not all(p in c[2] for p, c in zip(passes, call)):
                k += 1
                continue
            if prev_end is not None:
                out["between"] += max(0.0, call[0][0] - prev_end)
            end = call[0][0]
            for p, (t0, t1, _) in zip(passes, call):
                out[p] += t1 - max(t0, end)
                end = max(end, t1)
            prev_end, n, k = end, n + 1, k + len(passes)
        if n:
            out = {k: v / n for k, v in out.items()}
            out["between"] = out["between"] * n / max(n - 1, 1)
            out.update(calls=n, sessions=session)
            return out
    return dict(calls=0, sessions=sessions,
                note="not measured: the profiler recorded no whole call")


def us_text(us: dict) -> str:
    """:func:`pass_us`'s reading as one line."""
    if not us["calls"]:
        return us["note"]
    return (", ".join(f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in us.items()
                      if k not in ("calls", "sessions"))
            + f" (µs, {us['calls']} whole calls, session {us['sessions']})")


def copies(nbytes: float) -> int:
    return max(1, min(64, math.ceil(2 * L2_BYTES / max(nbytes, 1.0))))


def max_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    got, want = got.float(), want.float()
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    require(not bool(bad.any()),
            f"{what}: kernel disagrees with its plain version "
            f"(max abs err {float(err.max()):.3g})")
    return float(err.max())


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Bitwise equality of two floating tensors (-0.0 is not 0.0)."""
    ints = {4: torch.int32, 2: torch.int16}[x.element_size()]
    return x.dtype == y.dtype and torch.equal(x.view(ints), y.view(ints))


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def randn(shape, seed: int, scale: float = 1.0,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    x = torch.randn(shape, generator=gen(seed), device="cuda")
    return (x * scale).to(dtype)


def fp32_close(got: torch.Tensor, want: torch.Tensor):
    """(within the reference kernel test's fp32 tolerance, rtol 1e-5 and
    atol 1e-2 (``tests/test_kernels.py``); the max abs error)."""
    err = (got - want).abs()
    return not bool((err > 1e-2 + 1e-5 * want.abs()).any()), float(err.max())


# ---------------------------------------------------------------------------
# phase 3: the kernels at the serve path's shapes
# ---------------------------------------------------------------------------

def gemm_cases(cfg):
    """(label, K, N, calls per decode step) of every product the model
    runs; a prefill chunk runs the same set at M = CHUNK."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    q, kv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    L = cfg.n_layers
    return [("q", D, q, L), ("k", D, kv, L), ("v", D, kv, L),
            ("o", q, D, L), ("gate", D, F, L), ("in", D, F, L),
            ("out", F, D, L), ("unembed", D, V, 1)]


def plan_label(M, K, N, **kw) -> str:
    pl = gemm_mod.plan(M, K, N, **kw)
    return f"{pl.regime} {pl.tile_m}x{pl.tile_n} split {pl.split}"


def check_gemm(cfg):
    """Each qwen2 product at a decode step's M and a prefill chunk's, with
    its plan (regime, tile, split): against the plain version, timed with
    L2-cold weights beside the bound, the plain version and
    ``torch.matmul``; returns the row with the decode step's sums and the
    prefill chunk's."""
    sums = {M: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    bytes=0.0, flops=0.0) for M in (SLOTS, CHUNK)}
    errs = []
    print("gemm: M K N | plan | kernel ms | bound ms (by) | plain ms | "
          "torch.matmul ms | max abs err")
    for M in (SLOTS, CHUNK):
        for i, (label, K, N, calls) in enumerate(gemm_cases(cfg)):
            nbytes, flops = roofline.matmul_cost(M, K, N)
            n = copies(2 * K * N)
            a = randn((M, K), 100 + i)
            bs = [randn((K, N), 200 + i + 17 * j, 0.05) for j in range(n)]
            err = max_err(gemm_mod.matmul(a, bs[0], torch.float32),
                          ref.matmul(a, bs[0], torch.float32),
                          f"gemm {label} M={M}")
            errs.append(err)
            ms = cuda_ms([lambda b=b: gemm_mod.matmul(a, b, torch.float32)
                          for b in bs], iters=max(20, 4 * n))
            plain = cuda_ms([lambda b=b: ref.matmul(a, b, torch.float32)
                             for b in bs[:2]], iters=5, warmup=1)
            lib = cuda_ms([lambda b=b: torch.matmul(a, b) for b in bs],
                          iters=max(20, 4 * n))
            bms, by = bound(nbytes, flops)
            print(f"gemm {label:7s} {M:4d} {K:5d} {N:6d} | "
                  f"{plan_label(M, K, N)} | {ms:.4f} | {bms:.4f} ({by}) | "
                  f"{plain:.4f} | {lib:.4f} | {err:.3g}")
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("library_ms", lib), ("bound_ms", bms),
                             ("bytes", nbytes), ("flops", flops)):
                sums[M][key] += calls * val
    ncalls = sum(c for *_, c in gemm_cases(cfg))
    rows = {}
    for M, what in ((SLOTS, "one decode step"), (CHUNK, "one prefill chunk")):
        t = sums[M]
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"])
        print(f"gemm: {what} ({ncalls} calls, M={M}): {t['ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
              f"{t['plain_ms']:.4f} ms, torch.matmul {t['library_ms']:.4f} "
              f"ms ({t['ms'] / t['library_ms']:.2f}x)")
        rows[M] = t
    step, chunk = rows[SLOTS], rows[CHUNK]
    return dict(name="gemm", route="cuda",
                source="src/repro_torch/kernels/csrc/gemm.cu",
                replaces="src/repro/kernels/gemm.py:45",
                case=f"one decode step: the {ncalls} products at M={SLOTS}",
                max_abs_err=max(errs), ms=step["ms"],
                plain_ms=step["plain_ms"], bound_ms=step["bound_ms"],
                bound_by=step["bound_by"], library_ms=step["library_ms"],
                prefill_chunk_ms=chunk["ms"],
                prefill_chunk_library_ms=chunk["library_ms"],
                prefill_chunk_bound_ms=chunk["bound_ms"],
                prefill_chunk_plain_ms=chunk["plain_ms"])


def check_gemm_properties(cfg, mcfg):
    """The kernel's design properties at full width, on the card:
    - row invariance, bitwise: for every (K, N) of qwen2-0.5b and
      mamba2-780m and two ragged ones, rows taken from a 1,024-row product
      equal the product of those rows alone at M = 1, 8, 44, 64, 65, 128,
      300 and 1,024 (every regime, tile and split), bf16 and fp32;
    - run to run, bitwise: three more runs of each 1,024-row product;
    - transposed operands, bitwise: A stored (K, M) and B stored (N, K),
      as the backward passes them, equal the product on contiguous
      copies, at every train shape (bf16 and fp32);
    - fp32 operands within the reference's fp32 tolerance (rtol 1e-5,
      atol 1e-2) of the plain version, on unit-variance operands that are
      not bf16 values, as the reference's test draws them; at every model
      K (896 and up) and N of 128 and up (where cuBLAS takes its tensor
      cores), ``torch.matmul`` with TF32 allowed is a control that must
      fail the same check (its 10 mantissa bits err by ~4e-4 sqrt(K) per
      output).
    Returns the counts of products checked."""
    kn = sorted({(K, N) for _, K, N, _ in gemm_cases(cfg)}
                | {(K, N) for _, K, N, _ in mamba_gemm_cases(mcfg)}
                | {(13, 7), (130, 66)})
    checked = dict(row_invariance=0, run_to_run=0, transposed=0, fp32=0,
                   tf32_control=0)
    fp32_err, tf32_err = 0.0, math.inf   # the kernel's worst, TF32's least
    for K, N in kn:
        for dt in (torch.bfloat16, torch.float32):
            a = randn((1024, K), 1700 + K, dtype=dt)
            b = randn((K, N), 1701 + N, dtype=dt)
            full = gemm_mod.matmul(a, b, torch.float32)
            for m in (1, 8, 44, 64, 65, 128, 300, 1024):
                rows = torch.randperm(1024, generator=gen(m),
                                      device="cuda")[:m]
                part = gemm_mod.matmul(a[rows].contiguous(), b,
                                       torch.float32)
                require(torch.equal(part, full[rows]),
                        f"gemm rows depend on M: K={K} N={N} {dt} M={m} "
                        f"({plan_label(m, K, N, f32=dt == torch.float32)})"
                        f", {int((part != full[rows]).sum())} differ")
                checked["row_invariance"] += 1
            for _ in range(3):
                require(torch.equal(gemm_mod.matmul(a, b, torch.float32),
                                    full),
                        f"gemm K={K} N={N} {dt}: two runs differ")
                checked["run_to_run"] += 1
            if dt == torch.float32:
                want = ref.matmul(a, b, torch.float32)
                ok, err = fp32_close(full, want)
                require(ok, f"gemm fp32 K={K} N={N}: beyond rtol 1e-5, "
                        f"atol 1e-2 (max abs err {err:.3g})")
                checked["fp32"] += 1
                fp32_err = max(fp32_err, err)
                if K >= 896 and N >= 128:
                    tf32 = torch.backends.cuda.matmul.allow_tf32
                    torch.backends.cuda.matmul.allow_tf32 = True
                    try:
                        control = torch.matmul(a, b)
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = tf32
                    ok, err = fp32_close(control, want)
                    require(not ok, f"gemm fp32 K={K} N={N}: the check "
                            f"cannot see TF32 (max abs err {err:.3g})")
                    checked["tf32_control"] += 1
                    tf32_err = min(tf32_err, err)
            del full
    M = TRAIN_BATCH // RANKS * TRAIN_SEQ
    for _, K, N, _ in gemm_cases(cfg):
        for dt in (torch.bfloat16, torch.float32):
            a = randn((M, K), 1720 + K, dtype=dt)
            b = randn((K, N), 1721 + N, 0.05, dtype=dt)
            dc = randn((M, N), 1722 + N, dtype=dt)
            for x, y in ((dc, b.t()), (a.t(), dc)):
                got = gemm_mod.matmul(x, y, torch.float32)
                want = gemm_mod.matmul(x.contiguous(), y.contiguous(),
                                       torch.float32)
                require(torch.equal(got, want),
                        f"gemm transposed operands differ from copies: "
                        f"{tuple(x.shape)} @ {tuple(y.shape)} {dt}")
                checked["transposed"] += 1
    print(f"gemm properties: {checked} products checked, all bitwise; "
          f"fp32 within tolerance (max abs err at most {fp32_err:.3g}), "
          f"every TF32 control beyond it (max abs err at least "
          f"{tf32_err:.3g})", flush=True)
    return checked


def sdpa_mask(S, T, q_offset):
    qpos = torch.arange(S, device="cuda")[:, None] + q_offset
    return torch.arange(T, device="cuda")[None, :] <= qpos


def check_flash(cfg):
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    errs, row = [], None
    print("flash: start T | kernel ms | bound ms (by) | plain ms | sdpa ms "
          "| max abs err")
    for start in range(0, PROMPT_MAX, CHUNK):
        T = start + CHUNK             # the chunk's live pages, gathered
        nbytes, flops = roofline.attention_cost(      # causal, visible
            (1, H, CHUNK, hd), (1, Hkv, T, hd),
            roofline.causal_pairs(CHUNK, T, start))
        n = copies(nbytes)
        sets = [(randn((1, H, CHUNK, hd), 300 + j),
                 randn((1, Hkv, T, hd), 400 + j),
                 randn((1, Hkv, T, hd), 500 + j)) for j in range(n)]
        kw = dict(causal=True, q_offset=start)
        q, k, v = sets[0]
        err = max_err(fa_mod.attention(q, k, v, **kw),
                      ref.attention(q, k, v, **kw), f"flash start={start}")
        errs.append(err)
        ms = cuda_ms([lambda s=s: fa_mod.attention(*s, **kw) for s in sets],
                     iters=max(20, 2 * n))
        plain = cuda_ms([lambda s=s: ref.attention(*s, **kw)
                         for s in sets[:2]], iters=5, warmup=1)
        mask = sdpa_mask(CHUNK, T, start)
        lib = cuda_ms([lambda s=s: torch.nn.functional
                       .scaled_dot_product_attention(
                           *s, attn_mask=mask, enable_gqa=True)
                       for s in sets], iters=max(20, 2 * n))
        bms, by = bound(nbytes, flops)
        print(f"flash {start:4d} {T:5d} | {ms:.4f} | {bms:.5f} ({by}) | "
              f"{plain:.4f} | {lib:.4f} | {err:.3g}")
        row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                   bound_by=by, case=f"one prefill chunk: q (1,{H},{CHUNK},"
                   f"{hd}) at q_offset {start} against k/v (1,{Hkv},{T},{hd})")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:87",
                max_abs_err=max(errs), **row)


def chunked_like_paged_prefill(q, k, v, window, softcap):
    """(out, lse) of q (1,H,S,D)'s rows computed chunk by chunk as
    ``models/attention.prefill_chunk_paged`` calls the kernel: CHUNK query
    rows (the last end-padded) at ``q_offset = start`` against the keys
    of the live pages (T a multiple of PAGE; keys past S hold other
    values, as the padding's keys do there)."""
    S, hd = q.shape[2], q.shape[3]
    outs, lses = [], []
    for start in range(0, S, CHUNK):
        n, T = min(CHUNK, S - start), -(-(start + CHUNK) // PAGE) * PAGE
        qc = randn(q.shape[:2] + (CHUNK, hd), 1800 + start)
        kc = randn(k.shape[:2] + (T, hd), 1801 + start)
        vc = randn(v.shape[:2] + (T, hd), 1802 + start)
        qc[:, :, :n] = q[:, :, start:start + n]
        kc[:, :, :min(T, S)] = k[:, :, :T]
        vc[:, :, :min(T, S)] = v[:, :, :T]
        out, lse = fa_mod._forward(qc, kc, vc, True, window, softcap,
                                   hd ** -0.5, start, with_lse=True)
        outs.append(out[:, :, :n])
        lses.append(lse[:, :, :n])
    return torch.cat(outs, 2), torch.cat(lses, 2)


def check_flash_properties(cfg):
    """The attention kernels' design properties at qwen2-0.5b's heads:
    - row invariance, bitwise: a 300-token prompt in one call (S = T =
      300, q_offset 0) and chunk by chunk as the paged prefill runs it
      give every row the same output and log-sum-exp, with no window or
      softcap, a window of 100, a softcap of 30, and both;
    - run to run, bitwise: the forward with its log-sum-exp and the
      backward at the train shape, run twice more on the same inputs;
    - fp32 q, k, v (the CUDA-core kernel) on one prefill chunk within the
      reference kernel test's fp32 tolerance (rtol 2e-5), atol 2e-2,
      timed.
    Returns the counts checked, the fp32 error and time."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    checked = dict(row_invariance=0, run_to_run=0)
    q = randn((1, H, 300, hd), 1810)
    k, v = randn((1, Hkv, 300, hd), 1811), randn((1, Hkv, 300, hd), 1812)
    for window, cap in ((None, None), (100, None), (None, 30.0), (100, 30.0)):
        out, lse = fa_mod._forward(q, k, v, True, window, cap, hd ** -0.5, 0,
                                   with_lse=True)
        c_out, c_lse = chunked_like_paged_prefill(q, k, v, window, cap)
        require(torch.equal(c_out, out) and torch.equal(c_lse, lse),
                f"flash rows depend on the chunking (window {window}, "
                f"softcap {cap}): {int((c_out != out).sum())} outputs and "
                f"{int((c_lse != lse).sum())} log-sum-exps differ")
        checked["row_invariance"] += 1
    B, S = TRAIN_BATCH // RANKS, TRAIN_SEQ
    q, k, v, do = bwd_inputs(1820, B, H, Hkv, S, S, hd)
    args = (True, None, None, hd ** -0.5, 0)
    out, lse = fa_mod._forward(q, k, v, *args, with_lse=True)
    grads = fa_mod.attention_backward(q, k, v, out, do, lse)
    for _ in range(2):
        again = fa_mod._forward(q, k, v, *args, with_lse=True)
        require(torch.equal(again[0], out) and torch.equal(again[1], lse),
                "flash forward: two runs differ")
        require(all(torch.equal(a, b) for a, b in zip(
            fa_mod.attention_backward(q, k, v, out, do, lse), grads)),
            "attention backward: two runs differ")
        checked["run_to_run"] += 2
    start, T = PROMPT_MAX - CHUNK, PROMPT_MAX
    q = randn((1, H, CHUNK, hd), 1830, dtype=torch.float32)
    k = randn((1, Hkv, T, hd), 1831, dtype=torch.float32)
    v = randn((1, Hkv, T, hd), 1832, dtype=torch.float32)
    kw = dict(causal=True, q_offset=start)
    want = ref.attention(q, k, v, **kw)
    err = (fa_mod.attention(q, k, v, **kw) - want).abs()
    require(not bool((err > 2e-2 + 2e-5 * want.abs()).any()),
            f"flash fp32: beyond rtol 2e-5, atol 2e-2 (max abs err "
            f"{float(err.max()):.3g})")
    f32_ms = cuda_ms([lambda: fa_mod.attention(q, k, v, **kw)], iters=20)
    print(f"flash properties: {checked} checks, all bitwise; fp32 one "
          f"chunk within rtol 2e-5, atol 2e-2 (max abs err "
          f"{float(err.max()):.3g}), {f32_ms:.4f} ms", flush=True)
    return dict(checked, fp32_max_abs_err=float(err.max()),
                fp32_chunk_ms=f32_ms)


# gemma-2b's attention: head dim 256, 8 query heads on one kv head (MQA).
# Its prefill on the dense default is one call over the whole prompt
# (S = T, up to the 512-token prompts of phase 4d); the paged engines call
# it per 128-token chunk; its train layer is q (2, 8, 512, 256), causal.
D256_CASES = [
    # (label, B, S, T, q_offset, window, softcap)
    ("prefill", 1, 512, 512, 0, None, None),
    ("chunk", 1, 128, 512, 384, None, None),
    ("window", 1, 300, 300, 0, 100, None),
    ("softcap", 1, 256, 256, 0, None, 30.0),
    # rows 39.. see no key (qpos - 8 >= 31); the others 1 to 8 keys
    ("no visible key", 1, 64, 32, 0, 8, None),
    ("train", 2, 512, 512, 0, None, None),
]


def check_flash_d256(cfg):
    """The flash forward (bf16 on wgmma, fp32 on CUDA cores) and the
    backward at head dim 256 against their plain versions, at gemma-2b's
    prefill and train shapes, with a window, a softcap and rows that see
    no key (zeros, zero gradients); bitwise: a 300-token prompt in one
    call == chunk by chunk as the paged prefill runs it (with and without
    a window and a softcap), and the forward and backward run to run.
    Timed: the forward at the dense prefill's shape beside its bound, its
    plain version and SDPA, the backward at the train shape beside its
    bound, its plain version and ``autograd.grad`` through SDPA (both
    library calls timed only).  Returns the forward's and the backward's
    rows of the kernels line."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    require(hd == 256 and Hkv == 1, f"{cfg.name}: head dim {hd}")
    errs = dict(fwd=[], f32=[], bwd=[])
    fwd_row, bwd_row = {}, {}
    print("flash D=256: case | bf16 fwd err | fp32 fwd err | bwd err")
    for i, (label, B, S, T, off, window, cap) in enumerate(D256_CASES):
        q, k, v, do = bwd_inputs(2000 + 10 * i, B, H, Hkv, S, T, hd)
        kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
        out = fa_mod.attention(q, k, v, **kw)
        errs["fwd"].append(max_err(out, ref.attention(q, k, v, **kw),
                                   f"flash D=256 {label}"))
        q32, k32, v32 = (t.float() for t in (q, k, v))
        want32 = ref.attention(q32, k32, v32, **kw)
        e32 = (fa_mod.attention(q32, k32, v32, **kw) - want32).abs()
        require(not bool((e32 > 2e-2 + 2e-5 * want32.abs()).any()),
                f"flash D=256 fp32 {label}: beyond rtol 2e-5, atol 2e-2 "
                f"(max abs err {float(e32.max()):.3g})")
        errs["f32"].append(float(e32.max()))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(fa_mod.attention(*leaves, **kw), leaves,
                                  do)
        errs["bwd"].append(grads_close(
            got, ref.attention_backward(q, k, v, do, **kw),
            f"attention backward D=256 {label}"))
        if label == "no visible key":
            require(not bool(out[:, :, 39:].any())
                    and not bool(got[0][:, :, 39:].any())
                    and bool(out[:, :, :39].any()),
                    "D=256: rows with no visible key must give zeros and "
                    "zero gradients")
        print(f"flash D=256 {label:14s} | {errs['fwd'][-1]:.3g} | "
              f"{errs['f32'][-1]:.3g} | {errs['bwd'][-1]:.3g}")
        if label not in ("prefill", "train"):
            continue
        n = copies(2 * (3 * q.numel() + 2 * k.numel()))
        sets = [bwd_inputs(2100 + 4 * j, B, H, Hkv, S, T, hd)
                for j in range(n)]
        pairs = S * (S + 1) // 2                          # causal, S == T
        if label == "prefill":
            ms = cuda_ms([lambda s=s: fa_mod.attention(*s[:3], **kw)
                          for s in sets], iters=max(20, 2 * n))
            plain = cuda_ms([lambda s=s: ref.attention(*s[:3], **kw)
                             for s in sets[:2]], iters=5, warmup=1)
            lib = cuda_ms([lambda s=s: torch.nn.functional
                           .scaled_dot_product_attention(
                               *s[:3], is_causal=True, enable_gqa=True)
                           for s in sets], iters=max(20, 2 * n))
            bms, by = bound(*roofline.attention_cost(q.shape, k.shape,
                                                     pairs))
            f32_ms = cuda_ms([lambda: fa_mod.attention(q32, k32, v32, **kw)],
                             iters=10)
            f32_plain = cuda_ms([lambda: ref.attention(q32, k32, v32, **kw)],
                                iters=5, warmup=1)
            f32_lib = cuda_ms([lambda: torch.nn.functional
                               .scaled_dot_product_attention(
                                   q32, k32, v32, is_causal=True,
                                   enable_gqa=True)], iters=10)
            f32_bms, f32_by = bound(*roofline.attention_cost(
                q.shape, k.shape, pairs, itemsize=4), FP32_FLOPS)
            print(f"flash D=256 prefill | {ms:.4f} ms | bound {bms:.5f} "
                  f"({by}) | plain {plain:.4f} | sdpa {lib:.4f}; fp32: "
                  f"kernel {f32_ms:.4f} | bound {f32_bms:.4f} ({f32_by}, "
                  f"CUDA cores) | plain {f32_plain:.4f} | sdpa "
                  f"{f32_lib:.4f}")
            fwd_row = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=by, fp32_ms=f32_ms,
                           fp32_bound_ms=f32_bms, fp32_bound_by=f32_by,
                           fp32_plain_ms=f32_plain, fp32_library_ms=f32_lib,
                           case=f"{cfg.name} dense prefill: q (1,{H},{S},"
                                f"{hd}) against k/v (1,{Hkv},{T},{hd}), "
                                "causal")
        if label == "train":
            outs = [fa_mod._forward(*s[:3], True, None, None, hd ** -0.5, 0,
                                    with_lse=True) for s in sets]
            ms = cuda_ms([lambda s=s, o=o: fa_mod.attention_backward(
                *s[:3], o[0], s[3], o[1]) for s, o in zip(sets, outs)],
                iters=max(10, 2 * n))
            fwd = cuda_ms([lambda s=s: fa_mod._forward(
                *s[:3], True, None, None, hd ** -0.5, 0, with_lse=True)
                for s in sets], iters=max(10, 2 * n))
            plain = event_ms(lambda: ref.attention_backward(q, k, v, do,
                                                            **kw))

            def sdpa():
                ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
                o = torch.nn.functional.scaled_dot_product_attention(
                    *ls, is_causal=True, enable_gqa=True)
                return torch.autograd.grad(o, ls, do)
            lib = event_ms(sdpa, iters=10, warmup=2)
            split = pass_us([lambda s=s, o=o: fa_mod.attention_backward(
                *s[:3], o[0], s[3], o[1]) for s, o in zip(sets, outs)],
                max(10, 2 * n), ATTN_BWD_PASSES)
            bms, by = bound(*roofline.attention_backward_cost(
                q.shape, k.shape, pairs))
            print(f"attention backward D=256 train | {ms:.4f} ms | bound "
                  f"{bms:.4f} ({by}) | plain {plain:.4f} | sdpa backward "
                  f"{lib:.4f} | forward with lse {fwd:.4f}; µs by pass: "
                  + us_text(split))
            bwd_row = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=by,
                           forward_with_lse_ms=fwd, kernels_us=split,
                           case=f"{cfg.name} train layer: q ({B},{H},{S},"
                                f"{hd}), k/v ({B},{Hkv},{T},{hd}), causal")
    checked = dict(row_invariance=0, run_to_run=0)
    q, k, v, _ = bwd_inputs(2200, 1, H, Hkv, 300, 300, hd)
    for window, cap in ((None, None), (100, None), (None, 30.0), (100, 30.0)):
        out, lse = fa_mod._forward(q, k, v, True, window, cap, hd ** -0.5, 0,
                                   with_lse=True)
        c_out, c_lse = chunked_like_paged_prefill(q, k, v, window, cap)
        require(torch.equal(c_out, out) and torch.equal(c_lse, lse),
                f"flash D=256 rows depend on the chunking (window {window},"
                f" softcap {cap})")
        checked["row_invariance"] += 1
    q, k, v, do = bwd_inputs(2210, 2, H, Hkv, 512, 512, hd)
    args = (True, None, None, hd ** -0.5, 0)
    out, lse = fa_mod._forward(q, k, v, *args, with_lse=True)
    grads = fa_mod.attention_backward(q, k, v, out, do, lse)
    for _ in range(2):
        again = fa_mod._forward(q, k, v, *args, with_lse=True)
        require(torch.equal(again[0], out) and torch.equal(again[1], lse),
                "flash D=256 forward: two runs differ")
        require(all(torch.equal(a, b) for a, b in zip(
            fa_mod.attention_backward(q, k, v, out, do, lse), grads)),
            "attention backward D=256: two runs differ")
        checked["run_to_run"] += 2
    print(f"flash D=256 properties: {checked} checks, all bitwise",
          flush=True)
    return (dict(name="flash_attention_d256", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:87",
                 max_abs_err=max(errs["fwd"]),
                 fp32_max_abs_err=max(errs["f32"]),
                 properties_checked=checked, **fwd_row),
            dict(name="attention_backward_d256", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 replaces="src/repro/models/layers.py:52",
                 note="no TPU kernel: the reference trains through "
                      "layers.flash_attention_jnp's autodiff",
                 max_abs_err=max(errs["bwd"]), **bwd_row))


def paged_pool(B, Hq, Hkv, hd, n_row, seed):
    """q, a pool of B * n_row + 1 pages (page 0 unused) and a permuted
    table."""
    P = 1 + B * n_row
    rng = np.random.default_rng(seed)
    table = (rng.permutation(P - 1) + 1).reshape(B, n_row)
    return (randn((B, Hq, hd), seed), randn((P, PAGE, Hkv, hd), seed + 1),
            randn((P, PAGE, Hkv, hd), seed + 2),
            torch.from_numpy(table.astype(np.int32)).cuda())


def check_paged_grid():
    """The kernel at every head dim it takes (32, 64, 128, 256) and 1, 7
    and 16 query heads per kv head, at lengths 1, KS - 1, KS, KS + 1 and
    the full table (KS the kernel's split), against the plain version.
    Returns the cases checked and the largest error."""
    ks, n_row = paged_mod.SPLIT, 6
    lens = [1, ks - 1, ks, ks + 1, n_row * PAGE]
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    worst, cases = 0.0, 0
    for hd in (32, 64, 128, 256):
        for g in (1, 7, 16):
            q, kp, vp, table = paged_pool(len(lens), 2 * g, 2, hd, n_row,
                                          1900 + hd + g)
            args = (q, kp, vp, table, seq_lens)
            worst = max(worst, max_err(
                paged_mod.paged_decode_attention(*args),
                ref.paged_decode_attention(*args),
                f"paged decode hd={hd} g={g} lens={lens}"))
            cases += 1
    return cases, worst


def check_paged_bits(q, pool, table, seq_lens):
    """Bitwise: each sequence alone equals itself inside the batch of 8,
    the same logical K/V under a permuted table give the same bits, and a
    second run gives the same bits."""
    out = paged_mod.paged_decode_attention(q, *pool, table, seq_lens)
    require(torch.equal(paged_mod.paged_decode_attention(
        q, *pool, table, seq_lens), out), "paged decode: two runs differ")
    for b in range(q.shape[0]):
        alone = paged_mod.paged_decode_attention(
            q[b:b + 1], *pool, table[b:b + 1].contiguous(),
            seq_lens[b:b + 1].contiguous())
        require(torch.equal(alone[0], out[b]),
                f"paged decode: sequence {b} alone differs from its bits in "
                "the batch")
    P = pool[0].shape[0]
    perm = torch.from_numpy(np.random.default_rng(SEED + 5).permutation(
        P).astype(np.int64)).cuda()
    inv = torch.argsort(perm)
    moved = paged_mod.paged_decode_attention(
        q, pool[0][inv].contiguous(), pool[1][inv].contiguous(),
        perm[table.long()].int().contiguous(), seq_lens)
    require(torch.equal(moved, out),
            "paged decode: a permuted table of the same K/V differs")
    return dict(run_to_run=1, alone_in_batch=q.shape[0], permuted_pages=1)


def check_paged(cfg):
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    n_row = MAX_SEQ // PAGE
    P = 1 + SLOTS * n_row
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, SLOTS) + NEW_TOKENS // 2
    table = (rng.permutation(P - 1) + 1).reshape(SLOTS, n_row)
    table = torch.from_numpy(table.astype(np.int32)).cuda()
    seq_lens = torch.from_numpy(lens.astype(np.int32)).cuda()
    live = int(lens.sum())
    nbytes, flops = roofline.paged_decode_cost(SLOTS, H, Hkv, hd, live,
                                               table.numel())
    n = copies(2 * 2 * P * PAGE * Hkv * hd)
    q = randn((SLOTS, H, hd), 600)
    pools = [(randn((P, PAGE, Hkv, hd), 700 + j),
              randn((P, PAGE, Hkv, hd), 800 + j)) for j in range(n)]
    args = (table, seq_lens)
    err = max_err(paged_mod.paged_decode_attention(q, *pools[0], *args),
                  ref.paged_decode_attention(q, *pools[0], *args),
                  "paged decode")
    ms = cuda_ms([lambda p=p: paged_mod.paged_decode_attention(q, *p, *args)
                  for p in pools], iters=max(20, 2 * n))
    plain = cuda_ms([lambda p=p: ref.paged_decode_attention(q, *p, *args)
                     for p in pools[:2]], iters=5, warmup=1)
    # yardstick only (not the same function: the gather is left out):
    # SDPA over the K/V already gathered to (B, Hkv, T, hd), length-masked
    T = n_row * PAGE
    mask = (torch.arange(T, device="cuda")[None, :]
            < seq_lens[:, None].long())[:, None, None, :]
    dense = [tuple(x[table.long()].reshape(SLOTS, T, Hkv, hd)
                   .transpose(1, 2).contiguous() for x in p) for p in pools]
    q4 = q[:, :, None, :]
    sdpa = cuda_ms([lambda d=d: torch.nn.functional
                    .scaled_dot_product_attention(q4, *d, attn_mask=mask,
                                                  enable_gqa=True)
                    for d in dense], iters=max(20, 2 * n))
    del dense
    bms, by = bound(nbytes, flops)
    us = pass_us([lambda p=p: paged_mod.paged_decode_attention(q, *p, *args)
                  for p in pools], max(20, 2 * n),
                 PAGED_PASSES)
    grid_cases, grid_err = check_paged_grid()
    bits = check_paged_bits(q, pools[0], table, seq_lens)
    print(f"paged: B={SLOTS} seq_lens={lens.tolist()} | {ms:.4f} ms "
          f"({paged_mod.KERNELS_PER_CALL} kernels) | bound {bms:.5f} ms "
          f"({by}) | plain {plain:.4f} ms | gathered SDPA {sdpa:.4f} ms | "
          f"{err:.3g}; {grid_cases} head-dim x group cases at lengths 1, "
          f"KS-1, KS, KS+1, full (max abs err {grid_err:.3g}); bitwise "
          f"{bits}; profiled µs per call by pass: {us_text(us)}", flush=True)
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:71",
                case=f"one decode step's call: q ({SLOTS},{H},{hd}), pool "
                     f"({P},{PAGE},{Hkv},{hd}), {live} live positions",
                max_abs_err=max(err, grid_err), ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=None,
                kernels_per_call=paged_mod.KERNELS_PER_CALL, device_us=us,
                gathered_sdpa_ms=sdpa, grid_cases=grid_cases,
                bitwise_checked=bits)


def ssd_inputs(seed: int, S: int, G: int, dtype, init: bool, H=48, P=64,
               N=128, B=1):
    """mamba2-780m's prefill shapes (a batch of ``B``), decay drawn as the
    model's inits draw it (A = -U[1, 16], dt log-uniform in [1e-3,
    0.1])."""
    g = gen(seed)
    u = torch.rand((B, S, H), generator=g, device="cuda")
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    A = -(1.0 + 15.0 * torch.rand(H, generator=g, device="cuda"))
    x = torch.randn((B, S, H, P), generator=g, device="cuda").to(dtype)
    Bm = torch.randn((B, S, G, N), generator=g, device="cuda").to(dtype)
    C = torch.randn((B, S, G, N), generator=g, device="cuda").to(dtype)
    init_state = (torch.randn((B, H, P, N), generator=g, device="cuda")
                  if init else None)
    return dict(x=x, dt=dt, A=A, Bm=Bm, C=C, init_state=init_state)


def ssd_cost(inp):
    """Bytes (each input read once, each output written once) and the
    dual form's FLOPs at the kernel's chunk over the valid steps: per
    chunk of q steps, C B^T and scores @ (dt x) on the causal triangle,
    (C exp(a)) h and the state update."""
    x, Bm = inp["x"], inp["Bm"]
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nbytes, flops = roofline.ssd_cost(B, S, H, P, G, N, x.element_size(),
                                      inp["init_state"] is not None, SSD_Q)
    fp32 = x.dtype == torch.float32
    return (nbytes, flops, FP32_FLOPS if fp32 else BF16_FLOPS,
            TF32_FLOPS if fp32 else BF16_FLOPS)


def ssd_close(label, got_pair, want_pair, tol):
    e = []
    for got, want, what in zip(got_pair, want_pair, ("y", "state")):
        got, want = got.float(), want.float()
        require(bool(torch.isfinite(got).all()),
                f"ssd {label}: non-finite {what}")
        err = (got - want).abs()
        require(not bool((err > tol + tol * want.abs()).any()),
                f"ssd {label}: {what} disagrees with the plain version "
                f"(max abs err {float(err.max()):.3g})")
        e.append(float(err.max()))
    return e


def check_ssd():
    cases = [("bf16 S=512", 512, 1, torch.bfloat16, False),
             ("bf16 ragged S=300", 300, 1, torch.bfloat16, False),
             ("bf16 G=2 S=512", 512, 2, torch.bfloat16, False),
             ("fp32 init_state S=300", 300, 1, torch.float32, True),
             ("fp32 S=512", 512, 1, torch.float32, False),
             ("fp32 one step S=1", 1, 1, torch.float32, True),
             ("bf16 one step S=1", 1, 1, torch.bfloat16, False),
             ("fp32 one chunk S=64", 64, 1, torch.float32, False),
             ("bf16 one chunk S=64", 64, 1, torch.bfloat16, True)]
    timed = {"bf16 S=512", "fp32 init_state S=300", "fp32 S=512"}
    print("ssd: case | kernel ms | bound ms (by) | tensor-core bound ms | "
          "plain ms | max abs err y, state (tolerance)")
    errs, row, times = [], None, {}
    for i, (label, S, G, dtype, init) in enumerate(cases):
        inp = ssd_inputs(900 + i, S, G, dtype, init)
        got = ssd_mod.ssd(**inp)
        tol = SSD_TOL[dtype]
        e = ssd_close(label, got, ssd_mod.ssd_plain(**inp, chunk=256), tol)
        errs.append(max(e))
        nbytes, flops, rate, tc_rate = ssd_cost(inp)
        bms, by = bound(nbytes, flops, rate)
        tc = "{:.5f} ({})".format(*bound(nbytes, flops, tc_rate))
        if label in timed:
            n = copies(nbytes)
            sets = [ssd_inputs(950 + j, S, G, dtype, init) for j in range(n)]
            ms = cuda_ms([lambda s=s: ssd_mod.ssd(**s) for s in sets],
                         iters=max(20, 2 * n))
            plain = cuda_ms([lambda s=s: ssd_mod.ssd_plain(**s, chunk=256)
                             for s in sets[:2]], iters=5, warmup=1)
            times[label] = dict(ms=ms, plain_ms=plain, bound_ms=bms)
            print(f"ssd {label:22s} | {ms:.4f} | {bms:.5f} ({by}) | {tc} | "
                  f"{plain:.4f} | {e[0]:.3g}, {e[1]:.3g} ({tol:g})")
            if label == "fp32 S=512":    # what the serve path gives it
                us = pass_us([lambda s=s: ssd_mod.ssd(**s) for s in sets],
                             max(20, 2 * n), SSD_PASSES)
                print(f"ssd {label}: profiled µs per call by pass: "
                      f"{us_text(us)}")
                row = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                           device_us=us,
                           tensor_core_bound_ms=bound(nbytes, flops,
                                                      tc_rate)[0],
                           fp32_max_abs_err=max(e),
                           case=f"one prefill call at S={S}: x (1,{S},48,64)"
                                f" fp32, B/C (1,{S},1,128) fp32")
        else:
            print(f"ssd {label:22s} | - | {bms:.5f} ({by}) | {tc} | - | "
                  f"{e[0]:.3g}, {e[1]:.3g} ({tol:g})")
    # run to run, bitwise, in both types
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        inp = ssd_inputs(990 + i, 300, 1, dtype, True)
        y, st = ssd_mod.ssd(**inp)
        for _ in range(2):
            y2, st2 = ssd_mod.ssd(**inp)
            require(torch.equal(y2, y) and torch.equal(st2, st),
                    f"ssd {dtype}: two runs differ")
    print("ssd: two more runs of each type give the same bits", flush=True)
    return dict(name="ssd", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:81",
                max_abs_err=max(errs), library_ms=None,
                kernels_per_call=ssd_mod.KERNELS_PER_CALL,
                cases_checked=len(cases), run_to_run_bitwise=2,
                timed_cases=times, **row)


# The SSD backward against autograd through ``ssd_plain`` on the same
# inputs: each gradient within its dtype's SSD_TOL (the forward's, the
# reference SSD test's: 2e-4 fp32, 5e-2 bf16) of the largest magnitude of
# that gradient (the same math in another order; bf16 dx, dB and dC
# stored in bf16, the bf16 path's products in one TF32 rounding).
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "d_init")
SSD_BWD_PASSES = ("ssd_bwd_state", "ssd_bwd_chunk", "ssd_bwd_sum")


def ssd_bwd_close(label, got, want, tol):
    """The gradients ``got`` against ``want``, each held within ``tol`` of
    its largest magnitude: (max abs error, that error over the largest
    magnitude) of each."""
    errs = {}
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        if w is None:
            require(g is None, f"ssd backward {label}: an unexpected {name}")
            continue
        g, w = g.float(), w.float()
        require(bool(torch.isfinite(g).all()),
                f"ssd backward {label}: non-finite {name}")
        e = float((g - w).abs().max())
        lim = tol * float(w.abs().max())
        require(e <= lim, f"ssd backward {label}: {name} disagrees with the "
                          f"plain version (max abs err {e:.3g}, tolerance "
                          f"{lim:.3g})")
        errs[name] = (e, e / max(float(w.abs().max()), 1e-30))
    return errs


def ssd_bwd_call(inp, dy, d_state):
    """The forward kernels' call, then the backward kernels' on its
    scratch: the six gradients."""
    _, _, scratch = ssd_mod._forward(inp["x"], inp["dt"], inp["A"],
                                     inp["Bm"], inp["C"], inp["init_state"])
    return ssd_mod.ssd_backward(inp["x"], inp["dt"], inp["A"], inp["Bm"],
                                inp["C"], dy, d_state, scratch,
                                init_state=inp["init_state"])


def check_ssd_backward():
    """The SSD backward kernel (every input's gradient) against autograd
    through ``ssd_plain`` at mamba2-780m's widths: bf16 and fp32; S = 512
    (the train shape, 2 x 512), a ragged 300 and one chunk of 64; one and
    two groups; with and without an initial state; with and without a
    final-state cotangent.  Through the autograd wrapper once, with its
    launch counts.  Two more runs give the same bits.  The train shape is
    timed beside its bound (bf16: tensor-core peak; fp32: the fp32 peak,
    the TF32 one printed beside), the plain version and the forward."""
    cases = [("bf16 train 2x512", 2, 512, 1, torch.bfloat16, False, False),
             ("fp32 train 2x512", 2, 512, 1, torch.float32, False, False),
             ("bf16 ragged S=300 init", 1, 300, 1, torch.bfloat16, True,
              True),
             ("fp32 ragged S=300 init", 1, 300, 1, torch.float32, True, True),
             ("bf16 G=2 S=512", 1, 512, 2, torch.bfloat16, False, True),
             ("fp32 G=2 S=300", 1, 300, 2, torch.float32, True, False),
             ("bf16 one chunk S=64 init", 1, 64, 1, torch.bfloat16, True,
              False),
             ("fp32 one chunk S=64", 2, 64, 1, torch.float32, False, True)]
    timed = {"bf16 train 2x512", "fp32 train 2x512"}
    print("ssd backward: case | kernel ms | bound ms (by) | tensor-core "
          "bound ms | plain ms | forward ms | max err / largest, by "
          "gradient (tolerance)")
    errs, rels, times, row = [], [], {}, None
    for i, (label, B, S, G, dtype, init, dst) in enumerate(cases):
        inp = ssd_inputs(1100 + i, S, G, dtype, init, B=B)
        g = gen(1150 + i)
        dy = torch.randn(inp["x"].shape, generator=g, device="cuda"
                         ).to(dtype)
        d_state = (torch.randn((B, 48, 64, 128), generator=g, device="cuda")
                   if dst else None)
        got = ssd_bwd_call(inp, dy, d_state)
        want = ssd_mod.ssd_backward_plain(**inp, dy=dy, d_state=d_state)
        tol = SSD_TOL[dtype]
        e = ssd_bwd_close(label, got, want, tol)
        errs.append(max(a for a, _ in e.values()))
        rels.append(max(r for _, r in e.values()))
        for _ in range(2):
            again = ssd_bwd_call(inp, dy, d_state)
            require(all((a is None and b is None) or same_bits(a, b)
                        for a, b in zip(again, got)),
                    f"ssd backward {label}: two runs differ")
        nbytes, flops = roofline.ssd_backward_cost(
            B, S, 48, 64, G, 128, inp["x"].element_size(), init, dst)
        fp32 = dtype == torch.float32
        bms, by = bound(nbytes, flops, FP32_FLOPS if fp32 else BF16_FLOPS)
        tcb = bound(nbytes, flops, TF32_FLOPS if fp32 else BF16_FLOPS)[0]
        es = ", ".join(f"{k} {r:.2g}" for k, (_, r) in e.items())
        if label not in timed:
            print(f"ssd backward {label:24s} | - | {bms:.5f} ({by}) | "
                  f"{tcb:.5f} | - | - | {es} ({tol:g})")
            continue
        n = copies(nbytes + 4 * inp["x"].numel() / 64 * 128)
        sets = []
        for j in range(n):
            s_in = ssd_inputs(1200 + j, S, G, dtype, init, B=B)
            s_dy = torch.randn(s_in["x"].shape, generator=gen(1300 + j),
                               device="cuda").to(dtype)
            s_sc = ssd_mod._forward(s_in["x"], s_in["dt"], s_in["A"],
                                    s_in["Bm"], s_in["C"], None)[2]
            sets.append((s_in, s_dy, s_sc))
        ms = cuda_ms([lambda s=s: ssd_mod.ssd_backward(
            s[0]["x"], s[0]["dt"], s[0]["A"], s[0]["Bm"], s[0]["C"], s[1],
            None, s[2]) for s in sets], iters=max(10, 2 * n))
        fwd = cuda_ms([lambda s=s: ssd_mod.ssd(**s[0]) for s in sets],
                      iters=max(10, 2 * n))
        plain = event_ms(lambda: ssd_mod.ssd_backward_plain(
            **inp, dy=dy, d_state=d_state), iters=3)
        us = pass_us([lambda s=s: ssd_mod.ssd_backward(
            s[0]["x"], s[0]["dt"], s[0]["A"], s[0]["Bm"], s[0]["C"], s[1],
            None, s[2]) for s in sets], max(10, 2 * n), SSD_BWD_PASSES)
        summed = sum(us.get(k, 0.0) for k in SSD_BWD_PASSES)
        us["within_10pct_of_ms"] = bool(us["calls"]) and bool(
            abs(summed / 1e3 - ms) <= 0.1 * ms)
        times[label] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                            bound_by=by, tensor_core_bound_ms=tcb,
                            forward_ms=fwd, device_us=us)
        print(f"ssd backward {label:24s} | {ms:.4f} | {bms:.5f} ({by}) | "
              f"{tcb:.5f} | {plain:.4f} | {fwd:.4f} | {es} ({tol:g})")
        print(f"ssd backward {label}: profiled µs per call by pass (the "
              f"timed calls, eager: the passes sum to {summed:.1f} µs "
              f"against {1e3 * ms:.1f} timed) {us_text(us)}")
        if label == "bf16 train 2x512":
            row = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                       device_us=us, tensor_core_bound_ms=tcb,
                       case="one layer's backward at mamba2-780m's train "
                            "shape: x, dy (2,512,48,64) bf16, B/C "
                            "(2,512,1,128) bf16, no final-state cotangent")
    # through the autograd wrapper: one forward, one backward launch
    inp = ssd_inputs(1400, 300, 1, torch.float32, True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in inp.items()}
    before = (ssd_mod.launches, ssd_mod.bwd_launches)
    y, st = ssd_mod.ssd(**leaves)
    dy = torch.randn(y.shape, generator=gen(1401), device="cuda")
    got = torch.autograd.grad([y], list(leaves.values()), [dy])
    require((ssd_mod.launches, ssd_mod.bwd_launches)
            == (before[0] + 1, before[1] + 1),
            "ssd under autograd: not one forward and one backward launch")
    want = ssd_mod.ssd_backward_plain(**inp, dy=dy)
    order = ("x", "dt", "A", "Bm", "C", "init_state")
    ssd_bwd_close("autograd", [got[list(leaves).index(k)] for k in order],
                  want, SSD_TOL[torch.float32])
    print("ssd backward: two more runs of every case give the same bits; "
          "autograd through the wrapper launches the kernels once each",
          flush=True)
    return dict(name="ssd_backward", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                replaces="src/repro/models/ssm.py:29",
                note="no TPU kernel: the reference trains through "
                     "ssd_chunked's autodiff",
                max_abs_err=max(errs), max_err_over_largest=max(rels),
                library_ms=None,
                kernels_per_call=ssd_mod.KERNELS_PER_BWD_CALL,
                cases_checked=len(cases),
                run_to_run_bitwise=2, timed_cases=times, **row)


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------

def requests(cfg, new_tokens=NEW_TOKENS, prompts=(PROMPT_MIN, PROMPT_MAX)):
    """``N_REQUESTS`` requests, prompt lengths drawn from the seed in the
    closed range ``prompts``, each to ``new_tokens`` new tokens."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(prompts[0], prompts[1] + 1, N_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=new_tokens)
            for i, n in enumerate(lens)]


def launch_counts(**counts) -> dict:
    """A launch report (``ops.dispatch_report``'s keys) with every op at 0
    but ``counts``."""
    return {**dict.fromkeys(ops.dispatch_report(), 0), **counts}


def dense_serve_launches(cfg, steps: int, prefills: int):
    """Launches of the static engine on the dense cache: 7 products a
    layer and the unembed per prefill and per decode step, one flash call
    a layer per prefill, one paged-decode call a layer per decode step."""
    L = cfg.n_layers
    return launch_counts(matmul=(7 * L + 1) * (steps + prefills),
                         attention=L * prefills,
                         paged_decode_attention=L * steps)


def continuous_serve_launches(cfg, steps: int, fin):
    """Launches of the continuous engine over the finished requests
    ``fin``: 7 products a layer and the unembed per decode step and per
    ``CHUNK``-token prefill chunk, one flash call a layer per chunk, one
    paged-decode call a layer per decode step; and the chunks."""
    chunks = sum(-(-len(r.prompt) // CHUNK) for r in fin)
    L = cfg.n_layers
    return launch_counts(matmul=(7 * L + 1) * (steps + chunks),
                         attention=L * chunks,
                         paged_decode_attention=L * steps), chunks


def serve(engine_cls, model, params, reqs, max_seq=MAX_SEQ, **kw):
    """Drive a new engine to completion; returns (finished, seconds,
    decode steps)."""
    return drive(engine_cls(model, params, batch_slots=SLOTS,
                            max_seq=max_seq, page_size=PAGE,
                            prefill_chunk=CHUNK, **kw), reqs)


def drive(eng, reqs):
    """Drive ``eng`` over ``reqs`` to completion; returns (finished,
    seconds, decode steps)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.queue or any(r is not None for r in eng.active):
        steps += eng.step() > 0
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # the pool holds every slot's full row, so nothing is preempted and
    # each prompt is prefilled exactly once
    require(len(eng.finished) == len(reqs) and not eng.refused
            and not any(r.n_preempted for r in eng.finished),
            f"{type(eng).__name__}: {len(eng.finished)} of {len(reqs)} "
            "requests finished without preemption")
    return eng.finished, dt, steps


def serve_stats(arch, n_params, fin, dt, launches, peak, resident):
    tokens = sum(len(r.out) for r in fin)
    ttft = [r.first_token_t - r.submit_t for r in fin]
    per_tok = [(r.finish_t - r.first_token_t) / (len(r.out) - 1)
               for r in fin]
    return dict(
        arch=arch, params=n_params, requests=len(fin), tokens=tokens,
        seconds=dt, tok_per_s=tokens / dt,
        ttft_p50_ms=1e3 * statistics.median(ttft),
        decode_ms_per_token_p50=1e3 * statistics.median(per_tok),
        resident_before_gib=resident / 2**30, peak_mem_gib=peak / 2**30,
        launches=launches)


def agree(got, want, what, tol=LOGIT_TOL):
    """Logits (steps, V) of the card against a reference: max |diff|
    within ``tol`` of the largest logit, and greedy tokens equal
    wherever the reference's top-1/top-2 margin exceeds twice that."""
    require(bool(torch.isfinite(got).all()), f"{what}: logits not finite")
    atol = tol * float(want.abs().max())
    diff = float((got - want).abs().max())
    rel_rms = float((got - want).norm() / want.norm())
    top2 = torch.topk(want, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * atol
    same_sure = bool((got.argmax(-1)[sure] == want.argmax(-1)[sure]).all())
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"{what}: max abs diff {diff:.4g} = "
          f"{diff / float(want.abs().max()):.2%} of the largest logit "
          f"(tolerance {tol:.0%}), relative rms {rel_rms:.3%}; greedy "
          f"tokens equal on {same}/{len(want)} steps, required on the "
          f"{int(sure.sum())} with a margin over {2 * atol:.3g}: {same_sure}")
    require(diff <= atol and same_sure, f"{what}: logits disagree")
    return dict(max_abs_diff_frac=diff / float(want.abs().max()),
                rel_rms=rel_rms, greedy_equal=same, steps=len(want))


def check_against_cpu(cfg, model, params, dense=False):
    """A short prompt through prefill and 4 decode steps on the card and
    through the plain versions on the CPU, teacher-forced with the CPU's
    greedy tokens, held to :func:`agree`: on the paged cache (one prefill
    chunk), or with ``dense`` on the dense KV cache (the one-slot prefill
    and the dense decode step)."""
    cpu = Model(cfg, device="cpu")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    prompt = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, 64)).astype(np.int64)
    runs = []
    for m, p in ((model, params), (cpu, cpu_params)):
        toks = torch.from_numpy(prompt).to(m.device)
        if dense:
            cache = m.init_cache(1, 128)
            logits, cache = m.prefill(p, toks, cache=cache, slot=0)
        else:
            cache = m.init_paged_cache(1, 128, PAGE)
            logits, cache = m.prefill_chunk_paged(p, cache, toks,
                                                  cache["table"][0], 0)
        out = [logits[0, -1].float().cpu()]
        runs.append((m, p, cache, out))
    for s in range(4):
        tok = int(torch.argmax(runs[1][3][-1]))
        for m, p, cache, out in runs:
            step = m.decode_step if dense else m.decode_step_paged
            logits, _ = step(p, cache, torch.tensor([[tok]], device=m.device),
                             torch.tensor([64 + s], device=m.device))
            out.append(logits[0, 0].float().cpu())
    agree(torch.stack(runs[0][3]), torch.stack(runs[1][3]),
          f"card vs cpu logits ({cfg.name}, full width, "
          f"{'dense' if dense else 'paged'}"
          " cache, 64-token prompt + 4 steps)")


def wall_and_device(step):
    """(eager wall ms, ended by a synchronize, median of 10; device ms of
    the same step replayed from a CUDA graph)."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls), cuda_ms([step], iters=5, warmup=1)


def step_breakdown(cfg, model, params, dense=False, max_seq=MAX_SEQ,
                   positions=(PROMPT_MIN, PROMPT_MAX + NEW_TOKENS)):
    """One full decode step (8 slots, each at a serve-like position drawn
    from ``positions``): host wall time of the eager step, ended by a
    synchronize, against the device time of the same step replayed from
    a CUDA graph.  Their gap is what the host adds per step.  On the
    paged cache, or with ``dense`` on the dense KV cache (the table and
    ``seq_lens`` made outside the step, as the engine passes them)."""
    rng = np.random.default_rng(SEED + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SLOTS, 1))).cuda()
    pos = torch.from_numpy(rng.integers(*positions, SLOTS)).cuda()
    if dense:
        cache = model.init_cache(SLOTS, max_seq)
        table = torch.arange(SLOTS, dtype=torch.int32,
                             device="cuda")[:, None]
        lens = (pos + 1).to(torch.int32)

        def step():
            return model.decode_step(params, cache, tokens, pos,
                                     block_table=table, seq_lens=lens)[0]
    else:
        cache = model.init_paged_cache(SLOTS, MAX_SEQ, PAGE)

        def step():
            return model.decode_step_paged(params, cache, tokens, pos)[0]

    wall, device = wall_and_device(step)
    fams = breakdown_per_call(step, calls=10,
                              busy=("paged_decode_attention",))
    print(f"decode step ({cfg.name}, 8 slots, full width, "
          f"{'dense' if dense else 'paged'} cache): eager wall {wall:.3f} "
          f"ms, device (graph replay) {device:.3f} ms, device idle share of "
          f"the eager step {1 - device / wall:.1%}; profiled eager step, "
          "device ms by kernel family: " + ", ".join(
              f"{k} {v:.4f}" for k, v in fams.items() if v > 0))
    return dict(decode_step_wall_ms=wall, decode_step_device_ms=device,
                decode_step_profiled_ms=fams)


# ---------------------------------------------------------------------------
# phase 4b: qwen2-0.5b on the dense KV cache (the static engine's default)
# ---------------------------------------------------------------------------

# Dense against paged: the dense prefill takes the forward's wide fp32 MLP
# product, the paged prefill chunks glu_mlp's bf16 product (as in the
# reference), so every layer's activations differ by bf16 roundings, and
# with random full-width weights that difference grows with depth as the
# card's against the CPU's does: the prefill logits differ by 0.65% of the
# largest at 2 layers and 2.30% at 24 on the CPU's plain versions
# (scripts/dense_paged_depth.py).  So the full-depth tolerance LOGIT_TOL
# holds here too, with tests/test_torch_serve.py's rule for the tokens: a
# token may first differ only at a step whose paged top-1/top-2 margin is
# under twice the tolerance, the history before it being the same.


def check_dense_decode_bits(cfg):
    """The dense decode's attention call (each slot's cache row one page
    of ``MAX_SEQ`` positions, table ``arange(B)[:, None]``) against the
    same K/V laid out in 64-token pages, straight and permuted: the same
    bits; and against its plain version."""
    B, T, Hkv, hd = SLOTS, MAX_SEQ, cfg.n_kv_heads, cfg.d_head
    k = randn((B, T, Hkv, hd), SEED + 40)
    v = randn((B, T, Hkv, hd), SEED + 41)
    q = randn((B, cfg.n_heads, hd), SEED + 42)
    lens = np.random.default_rng(SEED + 43).integers(1, T + 1, B)
    lens[:3] = (1, T, PAGE + 1)
    lens = torch.from_numpy(lens).to("cuda", torch.int32)
    table = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    dense = ops.paged_decode_attention(q, k, v, table, lens)
    n_row = T // PAGE
    kp, vp = k.view(B * n_row, PAGE, Hkv, hd), v.view(B * n_row, PAGE, Hkv,
                                                          hd)
    ptable = torch.arange(B * n_row, dtype=torch.int32,
                          device="cuda").view(B, n_row)
    perm = torch.randperm(B * n_row, generator=gen(SEED + 44),
                          device="cuda")
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(B * n_row, device="cuda")
    paged = ops.paged_decode_attention(q, kp, vp, ptable, lens)
    permuted = ops.paged_decode_attention(
        q, kp[perm].contiguous(), vp[perm].contiguous(),
        inv[ptable.long()].to(torch.int32), lens)
    same = same_bits(dense, paged) and same_bits(dense, permuted)
    err = max_err(dense, ref.paged_decode_attention(q, k, v, table, lens),
                  "dense decode attention")
    print(f"dense decode attention ({B} slots, one page of {T} a slot, "
          f"lengths {lens.tolist()}): bitwise the 64-token pages and a "
          f"permuted paging: {same}; max abs err vs plain {err:.3g}")
    require(same, "dense decode attention differs from the paged call on "
            "the same K/V")
    return err


def teacher_forced(model, params, reqs, streams, dense: bool):
    """Logits (fp32, on the CPU) of each request at steps 0..63, fed the
    tokens ``streams[i]`` of the paged engine: each prompt prefilled into
    its own slot (on the dense cache in one pass, or on the paged cache in
    128-token chunks), then decode steps, all requests batched."""
    B = len(reqs)
    out = [[] for _ in reqs]
    if dense:
        cache = model.init_cache(B, MAX_SEQ)
        step = model.decode_step
    else:
        cache = model.init_paged_cache(B, MAX_SEQ, PAGE)
        step = model.decode_step_paged
    for b, r in enumerate(reqs):
        P = len(r.prompt)
        if dense:
            logits, cache = model.prefill(
                params, torch.from_numpy(r.prompt[None].astype(np.int64))
                .cuda(), cache=cache, slot=b)
            out[b].append(logits[0, -1].float().cpu())
            continue
        for start in range(0, P, CHUNK):
            chunk = np.zeros((1, CHUNK), np.int64)
            n = min(CHUNK, P - start)
            chunk[0, :n] = r.prompt[start:start + n]
            logits, cache = model.prefill_chunk_paged(
                params, cache, torch.from_numpy(chunk).cuda(),
                cache["table"][b], start)
        out[b].append(logits[0, n - 1].float().cpu())
    for s in range(1, NEW_TOKENS):
        tok = torch.tensor([[streams[b][s - 1]] for b in range(B)],
                           device="cuda")
        pos = torch.tensor([len(r.prompt) + s - 1 for r in reqs],
                           device="cuda")
        logits, cache = step(params, cache, tok, pos)
        for b in range(B):
            out[b].append(logits[b, 0].float().cpu())
    return torch.stack([torch.stack(o) for o in out])


def dense_against_paged(cfg, model, params, dense_fin, paged_fin):
    """Greedy tokens of the dense engine against the static paged
    engine's, by the rule of tests/test_torch_serve.py: both paths teacher
    forced along the paged streams give logits within ``LOGIT_TOL`` of
    the largest, and a request's tokens may first differ only at a
    step whose paged top-1/top-2 margin is under twice that (the history
    before it being the same).  Prints where each request first
    diverges."""
    dense = {r.rid: r.out for r in dense_fin}
    reqs = sorted(paged_fin, key=lambda r: r.rid)
    streams = [r.out for r in reqs]
    diverge = {}
    for r in reqs:
        d = next((i for i, (a, b) in enumerate(zip(dense[r.rid], r.out))
                  if a != b), None)
        if d is not None:
            diverge[r.rid] = d
    print(f"dense vs static paged greedy tokens: {len(reqs) - len(diverge)}"
          f" of {len(reqs)} requests equal throughout; first divergence "
          f"by request: {diverge}")
    pl = teacher_forced(model, params, reqs, streams, dense=False)
    dl = teacher_forced(model, params, reqs, streams, dense=True)
    require(bool(torch.isfinite(dl).all()), "dense logits not finite")
    largest = float(pl.abs().max())
    atol = LOGIT_TOL * largest
    diff = float((dl - pl).abs().max())
    rel_rms = float((dl - pl).norm() / pl.norm())
    top2 = torch.topk(pl, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]                 # (requests, steps)
    low = margin <= 2 * atol
    detail = {}
    for b, r in enumerate(reqs):
        if r.rid in diverge:
            d = diverge[r.rid]
            detail[r.rid] = dict(diverges_at=d,
                                 margin_at_divergence=float(margin[b, d]),
                                 low=bool(low[b, d]))
    ok = diff <= atol and all(v["low"] for v in detail.values())
    print(f"dense vs paged teacher-forced logits ({len(reqs)} requests x "
          f"{NEW_TOKENS} steps): max abs diff {diff:.4g} = "
          f"{diff / largest:.3%} of the largest (tolerance "
          f"{LOGIT_TOL:.0%}), relative rms {rel_rms:.3%}; steps with "
          f"a paged margin under {2 * atol:.3g}: {int(low.sum())} of "
          f"{low.numel()}; at each divergence: {json.dumps(detail)}")
    require(ok, "the dense engine's logits or tokens leave the paged "
            "engine's beyond the margin rule")
    return dict(equal=len(reqs) - len(diverge), max_abs_diff_frac=diff /
                largest, rel_rms=rel_rms, low_margin_steps=int(low.sum()),
                steps=low.numel(), diverged=detail)


def serve_dense(cfg, model, params, paged_fin):
    """Phase 4b: the same model, params and 16 requests through the static
    engine on the dense KV cache, its launch counts, the dense decode
    attention's bits, card against CPU, and tokens against the static
    paged engine's."""
    serve(Engine, model, params, requests(cfg, 2)[:2])           # warm-up
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fin, dt, steps = serve(Engine, model, params, requests(cfg))
    launches = ops.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    n = len(fin)
    expect = dense_serve_launches(cfg, steps, n)
    print(f"dense launches: {launches} (expected {expect}: {steps} decode "
          f"steps, {n} one-call prefills)")
    require(all(launches[k] > 0 for k in
                ("matmul", "attention", "paged_decode_attention")),
            "a kernel of the dense serve path was never launched")
    require(launches == expect,
            "dense launch counts do not match the layer loop")
    stats = serve_stats(ARCH, sum(p.numel() for p in params.values()), fin,
                        dt, launches, peak, resident)
    stats.update(decode_steps=steps, prefills=n,
                 **step_breakdown(cfg, model, params, dense=True))
    print("serve dense " + json.dumps(stats), flush=True)
    stats["decode_attention_max_abs_err"] = check_dense_decode_bits(cfg)
    check_against_cpu(cfg, model, params, dense=True)
    stats["against_paged"] = dense_against_paged(cfg, model, params, fin,
                                                 paged_fin)
    return stats, launches


# ---------------------------------------------------------------------------
# phase 4c: gemma3-27b at full width and depth on its windowed dense cache
# ---------------------------------------------------------------------------

GEMMA3 = "gemma3-27b"
# gemma3-27b's depth in phase 4c: 7 of its 62 layers (one 5:1 group and a
# local tail) since phase 17 came (13 since phase 14): the whole script
# stays inside its time limit
G3_LAYERS = 7
G3_MAX_SEQ, G3_PROMPTS = 2048, (896, 1600)
# card against CPU: the first local:global group (layers 0-5, the global
# one last), a prompt that wraps the 1,024-slot rings in the prefill, then
# 4 decode steps
G3_CPU_LAYERS, G3_CPU_PROMPT, G3_DECODE = 6, 1040, 4
# Prefill-then-decode against the full windowed forward over the same
# tokens, both on the card at 62 layers: the forward's MLP multiplies
# act(g) * h in fp32 and rounds once, the decode step rounds both to bf16
# first (as in the reference), so each decoded token's activations part by
# bf16 roundings in every layer.  On the CPU's plain versions at gemma3's
# widths (scripts/ring_decode_depth.py, vocabulary cut to 32,768) the
# logits part by 0.663% of the largest at 2 layers, 0.979% at 6, 1.362%
# at 12 and 1.701% at 24, growing as about the square root of depth:
# ~2.7-3.1% at 62.  Held at 5% (phase 4's LOGIT_TOL), with the margin rule
# for the tokens.  This drift bounds the decode path's numerics only: on
# an H100 at 62 layers and the full vocabulary it reads 3.28%, and 2.86%
# with a planted fault (every ring call's seq_lens one short), so a
# one-slot ring fault hides in it; :func:`check_layer_calls` and the CPU
# parity tests (window 16) are what catch one.
G3_DEPTH_TOL = 5e-2


@contextlib.contextmanager
def held_calls(ring_window=None):
    """Within the block, the model's kernel calls are each held against
    the plain version on the same inputs at the bf16 tolerance
    (:func:`max_err`): ``ops.matmul`` once for each distinct operand
    shape, strides and dtypes; every ``ops.attention`` call; every
    ``ops.paged_decode_attention`` call, a local layer's ring (pages of
    ``ring_window`` slots) against ``decode_attention_ring`` at the
    positions the caller sets as ``held.pos``, any other against
    ``ref.paged_decode_attention``.  Yields ``held``, whose ``errs`` maps
    ``matmul``, ``attention``, ``paged`` and ``ring`` to the errors."""
    from repro_torch.models import layers as layers_mod
    kernels = (ops.matmul, ops.attention, ops.paged_decode_attention)
    held = types.SimpleNamespace(pos=None, errs=dict(
        matmul=[], attention=[], paged=[], ring=[]))
    seen = set()

    def matmul(a, b, out_dtype=None):
        out = kernels[0](a, b, out_dtype)
        key = (a.shape, a.stride(), b.shape, b.stride(), a.dtype, b.dtype,
               out_dtype)
        if key not in seen:
            seen.add(key)
            held.errs["matmul"].append(max_err(
                out, ref.matmul(a, b, out_dtype),
                f"gemm {tuple(a.shape)} @ {tuple(b.shape)}"))
        return out

    def attention(q, k, v, **kw):
        out = kernels[1](q, k, v, **kw)
        held.errs["attention"].append(max_err(
            out, ref.attention(q, k, v, **kw),
            f"flash q {tuple(q.shape)} k {tuple(k.shape)} {kw}"))
        return out

    def paged(q, k_pages, v_pages, table, seq_lens, **kw):
        out = kernels[2](q, k_pages, v_pages, table, seq_lens, **kw)
        if k_pages.shape[1] == ring_window:
            want = layers_mod.decode_attention_ring(
                q[:, :, None], k_pages, v_pages, held.pos, **kw)[:, :, 0]
            held.errs["ring"].append(max_err(
                out, want, f"ring decode attention at positions "
                           f"{held.pos.tolist()}"))
        else:
            held.errs["paged"].append(max_err(
                out, ref.paged_decode_attention(q, k_pages, v_pages, table,
                                                seq_lens, **kw),
                f"decode attention, seq_lens {seq_lens.tolist()}"))
        return out

    ops.matmul, ops.attention, ops.paged_decode_attention = (
        matmul, attention, paged)
    try:
        yield held
    finally:
        ops.matmul, ops.attention, ops.paged_decode_attention = kernels


def check_layer_calls(cfg, model, params, lens, steps, max_seq):
    """Every kernel call of 8 one-slot prefills (prompts of ``lens``
    tokens) into a dense cache of 8 slots and of ``steps`` decode steps
    on it, held by :func:`held_calls` at full shapes.  For gemma3 the
    prompts run past the window (the flash kernel's window masks them)
    and the decode steps come on a ring of 5 live slots (where a slot
    left unread moves the output far more than among 1,024), before the
    wrap (up to 1,023, ring full), at it (1,024, the first overwrite)
    and past it; each local layer's ring call is held against
    ``decode_attention_ring``.  Returns the largest error of each
    kernel's calls."""
    W = cfg.window
    cache = model.init_cache(SLOTS, max_seq)
    rng = np.random.default_rng(SEED + 8)
    with held_calls(ring_window=W) as held:
        for b, n in enumerate(lens):
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                 (1, n))).cuda()
            model.prefill(params, toks, cache=cache, slot=b)
        for step in range(steps):
            held.pos = torch.tensor(lens, device="cuda") + step
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                (SLOTS, 1))).cuda()
            model.decode_step(params, cache, tok, held.pos)
    errs = held.errs
    # attention layers: every layer, or the hybrid's sites
    L = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
         else cfg.n_layers)
    n_ring = sum(not cfg.is_global_layer(i) for i in range(L)) if W else 0
    require(len(errs["attention"]) == SLOTS * L
            and len(errs["ring"]) == steps * n_ring
            and len(errs["paged"]) == steps * (L - n_ring),
            f"{cfg.name} held calls: {[(k, len(v)) for k, v in errs.items()]}")
    out = {k: max(v) for k, v in errs.items() if v}
    print(f"{cfg.name} kernel calls at full shapes, each within the bf16 "
          f"tolerance of its plain version (prompts {lens}, {steps} decode "
          f"steps): {len(errs['matmul'])} distinct GEMM shapes, "
          f"{len(errs['attention'])} flash calls, {len(errs['ring'])} ring "
          f"and {len(errs['paged'])} other decode attention calls; max abs "
          f"err {json.dumps(out)}", flush=True)
    return out


def g3_against_cpu(cfg, params):
    """The model's first local:global group (layers 0-5) with its own
    embed, final norm and unembed, on the card and through the plain
    versions on the CPU: a 1,040-token prompt (the rings wrap in the
    prefill) into a one-slot cache, then 4 decode steps teacher-forced
    with the CPU's greedy tokens, held to :func:`agree`."""
    import dataclasses
    small = dataclasses.replace(cfg, n_layers=G3_CPU_LAYERS)
    sub = {k: (v[:G3_CPU_LAYERS] if k.startswith("layers.") else v)
           for k, v in params.items()}
    cpu_params = {k: v.cpu() for k, v in sub.items()}
    prompt = np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, (1, G3_CPU_PROMPT))
    T = G3_CPU_PROMPT + G3_DECODE
    runs = []
    for m, p in ((Model(small, device="cuda"), sub),
                 (Model(small, device="cpu"), cpu_params)):
        cache = m.init_cache(1, T)
        logits, _ = m.prefill(p, torch.from_numpy(prompt).to(m.device),
                              cache=cache, slot=0)
        runs.append((m, p, cache, [logits[0, -1].float().cpu()]))
    for s in range(G3_DECODE):
        tok = int(torch.argmax(runs[1][3][-1]))
        for m, p, cache, out in runs:
            logits, _ = m.decode_step(
                p, cache, torch.tensor([[tok]], device=m.device),
                torch.tensor([G3_CPU_PROMPT + s], device=m.device))
            out.append(logits[0, 0].float().cpu())
    return agree(torch.stack(runs[0][3]), torch.stack(runs[1][3]),
                 f"card vs cpu logits ({cfg.name}, full width, layers 0-5, "
                 f"{G3_CPU_PROMPT}-token prompt + {G3_DECODE} steps)")


def g3_forward_logits(model, params, tokens, first):
    """fp32 logits of the full windowed forward over ``tokens`` (1, S) at
    positions ``first``.. (the last position's head only is skipped)."""
    with torch.no_grad():
        x, _ = model._dense_stack(params, tokens)
        return model._head(params, x[:, first:])[0].float()


def g3_depth_check(cfg, model, params):
    """Prefill-then-decode at full depth against the full windowed
    forward over the same tokens, teacher-forced, on the card: a
    1,040-token prompt, then 4 decode steps, logits held to
    ``G3_DEPTH_TOL`` of the largest (the derivation at the constant)."""
    toks = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, (1, G3_CPU_PROMPT + G3_DECODE))).cuda()
    cache = model.init_cache(1, toks.shape[1])
    model.prefill(params, toks[:, :G3_CPU_PROMPT], cache=cache, slot=0)
    steps = []
    for p in range(G3_CPU_PROMPT, toks.shape[1]):
        logits, _ = model.decode_step(params, cache, toks[:, p:p + 1],
                                      torch.tensor([p], device="cuda"))
        steps.append(logits[0, 0].float())
    full = g3_forward_logits(model, params, toks, G3_CPU_PROMPT)
    return agree(torch.stack(steps).cpu(), full.cpu(),
                 f"prefill-then-decode vs the full forward ({cfg.name}, "
                 f"{cfg.n_layers} layers, {G3_CPU_PROMPT}-token prompt + {G3_DECODE} steps)",
                 tol=G3_DEPTH_TOL)


def g3_tokens_by_margin(cfg, model, params, fin):
    """The engine's greedy tokens against the full forward over each
    request's prompt and stream (teacher-forced), for the request with
    the shortest prompt (its rings wrap in the decode) and the longest:
    a token may first differ only at a step whose forward top-1/top-2
    margin is under twice ``G3_DEPTH_TOL`` of the largest logit."""
    picked = sorted(fin, key=lambda r: len(r.prompt))
    out = {}
    for r in (picked[0], picked[-1]):
        P = len(r.prompt)
        seq = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
        logits = g3_forward_logits(model, params, torch.from_numpy(
            seq[None].astype(np.int64)).cuda(), P - 1).cpu()
        atol = G3_DEPTH_TOL * float(logits.abs().max())
        top2 = torch.topk(logits, 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        want = logits.argmax(-1).tolist()
        first = next((s for s, (a, b) in enumerate(zip(r.out, want))
                      if a != b), None)
        low = first is None or float(margin[first]) <= 2 * atol
        out[r.rid] = dict(prompt=P, first_divergence=first,
                          margin_there=None if first is None
                          else float(margin[first]), low_margin=low)
        require(low, f"{cfg.name} request {r.rid}: the engine's token {first}"
                     " leaves the forward's argmax at a margin over twice "
                     "the tolerance")
    print(f"served tokens vs the full forward ({cfg.name}, margin rule at "
          f"{2 * G3_DEPTH_TOL:.0%} of the largest logit): {json.dumps(out)}",
          flush=True)
    return out


def serve_gemma3():
    """Phase 4c: gemma3-27b at full width, cut to ``G3_LAYERS`` (7, one of
    them global)
    from seed 0, served by the static ``Engine`` on its windowed dense
    cache (8 slots, ``max_seq`` 2,048): launch counts, serve numbers, a
    decode step split, every local layer's ring attention against its
    plain version, the card against the CPU, prefill-then-decode against
    the full forward, and the served tokens by the margin rule.  Frees
    the model before it returns."""
    cfg = dataclasses.replace(get_config(GEMMA3), n_layers=G3_LAYERS)
    model = Model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in params.values())
    # the config's count leaves out the qk-norm scales: 2 x 128 a layer
    require(n_params == cfg.param_count() + cfg.n_layers * 2 * cfg.d_head,
            f"{GEMMA3}: {n_params} parameters")
    print(f"{GEMMA3}: {n_params} parameters drawn on the card in "
          f"{init_s:.1f} s, peak {init_peak / 2**30:.2f} GiB", flush=True)
    # prompts of 896-1,600 tokens: the longer ones wrap the 1,024-slot
    # rings in the prefill, some of the shorter ones in the decode
    serve(Engine, model, params, requests(cfg, 2, G3_PROMPTS)[:2],
          max_seq=G3_MAX_SEQ)                                   # warm-up
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fin, dt, steps = serve(Engine, model, params,
                           requests(cfg, prompts=G3_PROMPTS),
                           max_seq=G3_MAX_SEQ)
    launches = ops.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    n = len(fin)
    expect = dense_serve_launches(cfg, steps, n)
    print(f"{GEMMA3} launches: {launches} (expected {expect}: {steps} "
          f"decode steps, {n} one-call prefills)")
    require(all(launches[k] > 0 for k in
                ("matmul", "attention", "paged_decode_attention")),
            f"a kernel of the {GEMMA3} serve path was never launched")
    require(launches == expect,
            f"{GEMMA3} launch counts do not match the layer loop")
    W = cfg.window
    stats = serve_stats(GEMMA3, n_params, fin, dt, launches, peak, resident)
    stats.update(
        decode_steps=steps, prefills=n, init_s=init_s,
        init_peak_gib=init_peak / 2**30,
        prompts_wrapping_in_prefill=sum(len(r.prompt) > W for r in fin),
        prompts_wrapping_in_decode=sum(
            len(r.prompt) <= W < len(r.prompt) + len(r.out) - 1
            for r in fin),
        decode_step_bound_ms=bound(2 * n_params, 0)[0],
        **step_breakdown(cfg, model, params, dense=True,
                         max_seq=G3_MAX_SEQ,
                         positions=(G3_PROMPTS[0],
                                    G3_PROMPTS[1] + NEW_TOKENS)))
    print(f"serve {GEMMA3} " + json.dumps(stats), flush=True)
    stats["kernel_calls_max_abs_err"] = check_layer_calls(
        cfg, model, params, [4, 900, 1022, 1023, 1024, 1030, 1400, 1600],
        steps=2, max_seq=G3_MAX_SEQ)
    stats["prefill_decode_vs_forward"] = g3_depth_check(cfg, model, params)
    stats["tokens_by_margin"] = g3_tokens_by_margin(cfg, model, params, fin)
    stats["card_vs_cpu"] = g3_against_cpu(cfg, params)
    del model, params
    torch.cuda.empty_cache()
    return stats, launches


# ---------------------------------------------------------------------------
# phase 4d: gemma-2b at full width and depth (head dim 256, MQA)
# ---------------------------------------------------------------------------

GEMMA2B = "gemma-2b"
GEMMA2B_PARAMS = 3_030_460_416
# gemma-2b's depth in phase 4d: 9 of its 18 layers, since phase 14 came
# (phase 6b trains it at full depth)
G2B_SERVE_LAYERS = 9


def serve_gemma2b():
    """Phase 4d: gemma-2b (18 layers, head dim 256, one kv head) from seed
    0, phase 4's requests on the dense default (launch counts, serve
    numbers, a decode step split), the card against the CPU on the dense
    cache, and the same requests through the static paged ``Engine`` and
    ``ContinuousEngine``: those two token for token, the dense engine's
    against them by the margin rule.  Frees the model before it
    returns."""
    cfg = dataclasses.replace(get_config(GEMMA2B),
                              n_layers=G2B_SERVE_LAYERS)
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    n_params = sum(p.numel() for p in params.values())
    require(n_params == cfg.param_count() and cfg.d_head == 256,
            f"{GEMMA2B}: {n_params} parameters, head dim {cfg.d_head}")
    serve(Engine, model, params, requests(cfg, 2)[:2])          # warm-up
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fin, dt, steps = serve(Engine, model, params, requests(cfg))
    launches = ops.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    n = len(fin)
    expect = dense_serve_launches(cfg, steps, n)
    print(f"{GEMMA2B} launches: {launches} (expected {expect}: {steps} "
          f"decode steps, {n} one-call prefills)")
    require(launches == expect and launches["attention"] > 0
            and launches["paged_decode_attention"] > 0,
            f"{GEMMA2B} launch counts do not match the layer loop")
    stats = serve_stats(GEMMA2B, n_params, fin, dt, launches, peak, resident)
    stats.update(decode_steps=steps, prefills=n,
                 **step_breakdown(cfg, model, params, dense=True))
    print(f"serve {GEMMA2B} " + json.dumps(stats), flush=True)
    stats["kernel_calls_max_abs_err"] = check_layer_calls(
        cfg, model, params, [len(r.prompt) for r in requests(cfg)[:SLOTS]],
        steps=1, max_seq=MAX_SEQ)
    check_against_cpu(cfg, model, params, dense=True)
    static, _, _ = serve(Engine, model, params, requests(cfg), paged=True)
    cont, _, _ = serve(ContinuousEngine, model, params, requests(cfg))
    same = {r.rid: r.out for r in static} == {r.rid: r.out for r in cont}
    print(f"{GEMMA2B} static paged == continuous greedy tokens: {same}")
    require(same, f"{GEMMA2B}: static paged and continuous engines disagree")
    stats["against_paged"] = dense_against_paged(cfg, model, params, fin,
                                                 static)
    del model, params
    torch.cuda.empty_cache()
    return stats, launches


# ---------------------------------------------------------------------------
# phase 5: mamba2-780m through the dense-cache static engine
# ---------------------------------------------------------------------------

def mamba_gemm_cases(cfg):
    """(label, K, N, calls per decode step) of the mamba2 products; a
    prefill runs the same set at M = the prompt's length."""
    D, di, V, L = cfg.d_model, cfg.d_inner, cfg.padded_vocab, cfg.n_layers
    GN2 = 2 * cfg.ssm_groups * cfg.ssm_state
    return [("wx", D, di, L), ("wz", D, di, L), ("wbc", D, GN2, L),
            ("wdt", D, cfg.n_ssm_heads, L), ("w_out", di, D, L),
            ("unembed", D, V, 1)]


def check_mamba_gemm(cfg):
    """The GEMM kernel against its plain version at each mamba2 product's
    shape (``wdt``'s N = 48 is the one N of either model below a tile,
    ``w_out`` the one K = 3072), at M = 8 (a decode step) and at a ragged
    prefill M = PREFILL_M, each timed with L2-cold weights beside
    ``torch.matmul``.  Returns the sums over the 241 calls of a decode
    step and of a PREFILL_M-token prefill."""
    out = dict(gemm_ms=0.0, gemm_library_ms=0.0, gemm_bound_ms=0.0,
               prefill_gemm_ms=0.0, prefill_gemm_library_ms=0.0,
               prefill_gemm_bound_ms=0.0, gemm_max_abs_err=0.0)
    for M, key in ((SLOTS, "gemm"), (PREFILL_M, "prefill_gemm")):
        for i, (label, K, N, calls) in enumerate(mamba_gemm_cases(cfg)):
            n = copies(2 * K * N)
            a = randn((M, K), 1000 + i)
            bs = [randn((K, N), 1100 + i + 17 * j, 0.05) for j in range(n)]
            err = max_err(gemm_mod.matmul(a, bs[0], torch.float32),
                          ref.matmul(a, bs[0], torch.float32),
                          f"mamba2 gemm {label} M={M}")
            ms = cuda_ms([lambda b=b: gemm_mod.matmul(a, b, torch.float32)
                          for b in bs], iters=max(20, 4 * n))
            lib = cuda_ms([lambda b=b: torch.matmul(a, b) for b in bs],
                          iters=max(20, 4 * n))
            bms, _ = bound(*roofline.matmul_cost(M, K, N))
            print(f"mamba2 gemm {label:7s} M={M} K={K} N={N} "
                  f"({plan_label(M, K, N)}): {ms:.4f} ms x {calls} (bound "
                  f"{bms:.4f} ms, torch.matmul {lib:.4f} ms), max abs err "
                  f"{err:.3g}")
            out[f"{key}_ms"] += calls * ms
            out[f"{key}_library_ms"] += calls * lib
            out[f"{key}_bound_ms"] += calls * bms
            out["gemm_max_abs_err"] = max(out["gemm_max_abs_err"], err)
    return out


def mamba_step_breakdown(cfg, model, params):
    """One decode step of 8 slots: eager wall time (ended by a
    synchronize), device time (the same step replayed from a CUDA graph),
    the GEMM kernel's share (:func:`check_mamba_gemm`), and the share of
    the plain ``ssd_step`` with the two rolling convolutions (48 layers'
    worth replayed from a graph on the cache's own state rows)."""
    cache = model.init_cache(SLOTS, MAX_SEQ)
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SLOTS, 1))).cuda()
    pos = torch.from_numpy(rng.integers(
        PROMPT_MIN, PROMPT_MAX + NEW_TOKENS, SLOTS)).cuda()

    wall, device = wall_and_device(
        lambda: model.decode_step(params, cache, tokens, pos)[0])
    gemm = check_mamba_gemm(cfg)

    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di, GN2 = cfg.d_inner, 2 * cfg.ssm_groups * cfg.ssm_state
    g = gen(1200)
    xz = torch.randn((SLOTS, 1, di), generator=g, device="cuda")
    bc = torch.randn((SLOTS, 1, GN2), generator=g, device="cuda")
    dt = torch.rand((SLOTS, H), generator=g, device="cuda") * 0.1
    A = -(1.0 + 15.0 * torch.rand(H, generator=g, device="cuda"))
    lp = [model._layer(params, i)["ssm"] for i in range(cfg.n_layers)]

    def mixer_plain():
        for i, p in enumerate(lp):
            x1, _ = ssm._causal_conv(xz, p["conv_x"].float(),
                                     cache["conv"][i])
            b1, _ = ssm._causal_conv(bc, p["conv_bc"].float(),
                                     cache["bc_conv"][i])
            b1 = torch.nn.functional.silu(b1)
            ops.ssd_step(torch.nn.functional.silu(x1).reshape(SLOTS, H, P),
                         dt, A, b1[:, 0, :GN2 // 2].reshape(SLOTS, 1, N),
                         b1[:, 0, GN2 // 2:].reshape(SLOTS, 1, N),
                         cache["ssm"][i])

    mixer = cuda_ms([mixer_plain], iters=3, warmup=1)
    out = dict(decode_step_wall_ms=wall, decode_step_device_ms=device,
               **gemm, ssd_step_and_conv_ms=mixer,
               other_device_ms=device - gemm["gemm_ms"] - mixer,
               host_ms=wall - device)
    print("mamba2 decode step (8 slots, full width): " + ", ".join(
        f"{k} {v:.4g}" for k, v in out.items())
        + f"; device idle share of the eager step {1 - device / wall:.1%}")
    return out


def state_drift(got, want):
    """Per cache key: (max |diff| of layer 0 over its largest magnitude,
    each layer's relative RMS)."""
    out = {}
    for k in ("conv", "ssm", "bc_conv"):
        g, w = got[k].float().cpu(), want[k].float().cpu()
        d = g - w
        out[k] = (float(d[0].abs().max() / w[0].abs().max()),
                  [float(d[i].norm() / w[i].norm())
                   for i in range(w.shape[0])])
    return out


def states_agree(drift, keys=("conv", "ssm", "bc_conv")) -> bool:
    return all(drift[k][0] <= STATE_TOL for k in keys)


def check_mamba_against_cpu(cfg, model, params):
    """A 64-token prompt through prefill and 4 decode steps on the card
    and through the plain versions on the CPU, on the engine's path (the
    prefill's states written into a row of a dense cache).  The first
    layer's prefill states are held to :func:`states_agree` (every
    layer's relative RMS is printed); two controls on the card must fail
    it on the SSM state, so the check can see the scan: the
    state zeroed, and the state of the prompt with its last token changed.
    The logits, teacher-forced with the CPU's greedy tokens, are held to
    :func:`agree`."""
    cpu = Model(cfg, device="cpu")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    prompt = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, 64)).astype(np.int64))
    runs = []
    for m, p in ((model, params), (cpu, cpu_params)):
        logits, cache = m.prefill(p, prompt.to(m.device),
                                  cache=m.init_cache(1, 128), slot=0)
        runs.append((m, p, cache, [logits[0, -1].float().cpu()]))
    card, want = runs[0][2], runs[1][2]
    zeroed = dict(card, ssm=torch.zeros_like(card["ssm"]))
    other = prompt.clone()
    other[0, -1] = (other[0, -1] + 1) % cfg.vocab_size
    _, changed = model.prefill(params, other.cuda(),
                               cache=model.init_cache(1, 128), slot=0)
    out = {}
    for what, got in (("card", card), ("control: zeroed ssm state", zeroed),
                      ("control: last prompt token changed", changed)):
        drift = state_drift(got, want)
        out[what] = drift
        print(f"mamba2 prefill states, {what} vs cpu: layer 0 max abs diff "
              f"of the largest magnitude (tolerance {STATE_TOL:g}) "
              + ", ".join(f"{k} {l0:.3g}" for k, (l0, _) in drift.items())
              + "; worst layer's relative rms " + ", ".join(
                  f"{k} {max(r):.3g} (layer {r.index(max(r))})"
                  for k, (_, r) in drift.items()))
        print("  ssm relative rms by layer: "
              + " ".join(f"{r:.3g}" for r in drift["ssm"][1]))
        if what == "card":
            require(states_agree(drift), "mamba2 prefill states on the card "
                    "disagree with the CPU's")
        else:
            require(not states_agree(drift, ("ssm",)),
                    f"mamba2 state check cannot see a wrong scan ({what} "
                    "passes it)")
    for s in range(4):
        tok = int(torch.argmax(runs[1][3][-1]))
        for m, p, cache, logits_out in runs:
            logits, _ = m.decode_step(
                p, cache, torch.tensor([[tok]], device=m.device),
                torch.tensor([64 + s], device=m.device))
            logits_out.append(logits[0, 0].float().cpu())
    out["logits"] = agree(torch.stack(runs[0][3]), torch.stack(runs[1][3]),
                          "card vs cpu logits (mamba2, full width, 64-token "
                          "prompt + 4 steps)")
    return out


def prefill_then_decode(cfg, model, params, S=300, seed=SEED + 4):
    """Prefill S-1 random tokens (drawn from ``seed``; the SSD kernel's
    final state, ragged against its chunk), decode position S-1 with the
    plain ``ssd_step`` recurrence, and run the full forward on the S
    tokens, on the card.  Returns (the step's logits, the forward's last
    logits, per state the step's max |diff| from the forward's over the
    latter's largest magnitude, the same for a control's SSM state that
    decoded from a zeroed state, and the control's logits)."""
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, S))).cuda()
    full, _, states = model.forward(params, toks, with_cache=True)
    want = full[:, -1].float().cpu()
    _, cache = model.prefill(params, toks[:, :-1])
    control = {k: v.clone() for k, v in cache.items()}
    control["ssm"].zero_()
    pos = torch.tensor([S - 1], device="cuda")
    got, _ = model.decode_step(params, cache, toks[:, -1:], pos)
    drift = {k: float((cache[k].float() - ref_state.float()).abs().max()
                      / ref_state.float().abs().max())
             for k, ref_state in zip(("conv", "ssm", "bc_conv"), states)}
    lost, _ = model.decode_step(params, control, toks[:, -1:], pos)
    control_drift = float((control["ssm"].float() - states[1].float())
                          .abs().max() / states[1].float().abs().max())
    return (got[:, 0].float().cpu(), want, drift, control_drift,
            lost[:, 0].float().cpu())


def check_prefill_then_decode(cfg, model, params, S=300):
    """:func:`prefill_then_decode` held to the forward: the logits of the
    last position (:func:`agree`), and each state after the step within
    STATE_TOL of its largest magnitude.  With random weights the SSM state
    moves the logits little (the D skip dominates), so the states are
    compared directly; the control's SSM state must fail the
    comparison."""
    got, want, drift, control_drift, lost = prefill_then_decode(
        cfg, model, params, S)
    out = agree(got, want,
                f"mamba2 prefill {S - 1} + decode vs forward {S} (card)")
    for k, d in drift.items():
        out[f"{k}_diff_frac"] = d
        print(f"  {k} state after the step vs the forward's: max abs diff "
              f"{d:.3g} of its largest magnitude (tolerance {STATE_TOL:g})")
        require(d <= STATE_TOL, f"mamba2 {k} state after prefill + decode "
                "disagrees with the forward's")
    out["zeroed_state_diff_frac"] = float(
        (lost - want).abs().max() / want.abs().max())
    print(f"  control: decoding from a zeroed SSM state moves the logits by "
          f"{out['zeroed_state_diff_frac']:.2%} of the largest and the ssm "
          f"state by {control_drift:.3g} of its largest magnitude")
    require(control_drift > STATE_TOL,
            "the state comparison cannot see a lost state")
    return out


def prefill_breakdown(model, params, reqs):
    """Device ms of one prefill by kernel family, the mean over the serve
    phase's prompts (64-512 tokens), each prefilled alone as the engine
    does (profiled eager)."""
    toks = [torch.from_numpy(r.prompt.astype(np.int64)[None]).cuda()
            for r in reqs]

    def prefills():
        for t in toks:
            model.prefill(params, t)

    fams = {k: v / len(toks) for k, v in
            breakdown_per_call(prefills, calls=1, busy=("ssd",)).items()}
    print(f"mamba2 prefill ({len(toks)} prompts, "
          f"{sum(t.shape[1] for t in toks) / len(toks):.1f} tokens on "
          "average), device ms per prefill by kernel family: " + ", ".join(
              f"{k} {v:.4f}" for k, v in fams.items() if v > 0), flush=True)
    return fams


def serve_mamba():
    """mamba2-780m at full width through ``Engine(paged=False)``; returns
    (the serve stats, the launch counts)."""
    cfg = dataclasses.replace(get_config(MAMBA), n_layers=MAMBA_SERVE_LAYERS)
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    n_params = sum(p.numel() for p in params.values())
    require(n_params == cfg.param_count(),
            f"mamba2: {n_params} parameters in {cfg.n_layers} layers")
    serve(Engine, model, params, requests(cfg, 2)[:2])          # warm-up
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fin, dt, steps = serve(Engine, model, params, requests(cfg))
    launches = ops.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    prefills = len(fin)
    expect = launch_counts(matmul=(5 * L + 1) * (prefills + steps),
                           ssd=L * prefills)
    print(f"mamba2 launches: {launches} (expected {expect}: {steps} decode "
          f"steps, {prefills} prefills)")
    require(launches["matmul"] > 0 and launches["ssd"] > 0,
            "a kernel of the mamba2 serve path was never launched")
    require(launches == expect,
            "mamba2 launch counts do not match the layer loop")
    stats = serve_stats(MAMBA, n_params, fin, dt, launches, peak, resident)
    stats.update(decode_steps=steps, prefills=prefills,
                 **mamba_step_breakdown(cfg, model, params))
    stats["prefill_profiled_ms"] = prefill_breakdown(model, params,
                                                     requests(cfg))
    print("serve " + json.dumps(stats), flush=True)
    stats["card_vs_cpu"] = check_mamba_against_cpu(cfg, model, params)
    stats["prefill_decode_vs_forward"] = check_prefill_then_decode(
        cfg, model, params)
    return stats, launches


# ---------------------------------------------------------------------------
# phase 6: train qwen2-0.5b at full width, two ranks on the card
# ---------------------------------------------------------------------------

# The int8 wire's nine gradient buckets at qwen2-0.5b (the reference's
# plan at 32 MiB; tests/test_torch_comms.py pins it).
BUCKETS = (136_134_656, 2_781_056, 19_267_584, 19_267_584, 2_795_520,
           104_595_456, 104_595_456, 104_595_456, 136_134_656)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, RANKS = 4, 512, 6, 2
# AdamW moves every weight by about lr from the first step on: a peak of
# 1e-4 keeps six steps from overshooting (the loss falls on the batches
# seen and on the first one seen again) while most bf16 weights of
# magnitude <= 0.05 still change at step 1.
TRAIN_PEAK, TRAIN_WARMUP = 1e-4, 2
# run 4's steps on the int8 wire: 4 of the schedule's 6 (6 until phase 14
# came: the whole script stays inside its time limit)
WIRE_STEPS = 4
PROFILED = WIRE_STEPS - 2           # the int8 step traced by the profiler
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
# bf16 gradients, card against plain: the kernels' products round their
# operands (O, dO, the cotangent) to bf16 where the plain versions keep
# fp32, and sums run in another order (tests/test_torch_kernels.py).
GRAD_RTOL, GRAD_ATOL_FRAC = 3e-2, 2e-2
# Card against CPU, 2 layers: every GEMM's sum order differs and the
# kernels round at other places, which moves the logits by ~0.3% of the
# largest at 2 layers (phase 4's check); the CPU port agrees with the
# reference's gradients to 0.5% relative rms at 2 layers
# (tests/test_torch_train.py).  Ten times that per leaf: 5% relative rms
# and 5% of the leaf's largest value; loss rtol 1e-3, grad norm 2e-2.
CPU_GRAD_TOL, CPU_LOSS_RTOL, CPU_NORM_RTOL = 5e-2, 1e-3, 2e-2


def train_adamw():
    from repro_torch.train import optimizer as opt
    return opt.AdamWConfig(lr=opt.warmup_cosine(TRAIN_PEAK, TRAIN_WARMUP,
                                                 TRAIN_STEPS))


def train_batches(cfg):
    from repro_torch.data import SyntheticLM
    data = iter(SyntheticLM(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                            seed=SEED, structured=True))
    return [next(data) for _ in range(TRAIN_STEPS)]


def expected_train_launches(cfg, steps: int, int8: bool,
                            remat: str = "full"):
    """Per rank.  Each layer runs 7 products and one attention forward;
    ``remat="full"`` runs every layer's forward again in the backward;
    ``"group:G"`` (G dividing L) each layer's once more and, for each
    group, its first G - 1 layers' once besides (the group's recompute
    stops at the last tensor it saves, the input of its last layer,
    torch.utils.checkpoint's early stop); each product's backward runs
    two products (dA, dB), each attention one backward kernel; the head's
    unembed is not checkpointed; the int8 wire quantizes each of its
    buckets once."""
    L = cfg.n_layers
    fwd = 7 * L + 1
    redo = L
    if remat.startswith("group:"):
        G = int(remat.split(":")[1])
        redo = L + (L // G) * (G - 1) if L % G == 0 else 0
    return launch_counts(matmul=steps * (fwd + 7 * redo + 2 * fwd),
                         attention=steps * (L + redo),
                         attention_backward=steps * L,
                         quantize_int8=steps * (len(BUCKETS) if int8 else 0))


def event_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Device ms per eager call (CUDA events around ``iters`` calls): for
    the plain and library versions that run autograd, which a CUDA graph
    does not capture."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_quantize():
    """``quantize_int8`` against its plain version, bitwise, at each of
    the wire's bucket lengths (timed), a ragged length, exact .5 ties and
    a zero bucket."""
    from repro_torch.kernels import fused as fused_mod
    step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    print("quantize_int8: n | kernel ms | bound ms (by) | plain ms | "
          "bitwise equal")
    g = gen(1300)
    cases = [(f"bucket {i}", n) for i, n in enumerate(BUCKETS)]
    cases += [("ragged", 4096 * 37 + 3), ("ties", 100_003), ("zero", 4097)]
    timed = {}
    for label, n in cases:
        x = torch.randn(n, generator=g, device="cuda") * 1e-3
        if label == "zero":
            x.zero_()
        scale = ref.int8_scale(x.abs().max())
        if label == "ties":
            scale = torch.full((), 2.0 ** -10, device="cuda")
            k = torch.randint(-127, 127, (n,), generator=g,
                              device="cuda").float() + 0.5
            x = torch.where(torch.arange(n, device="cuda") % 2 == 0,
                            k * scale, x)
        got = fused_mod.quantize_int8(x, scale)
        same = torch.equal(got, ref.quantize_int8(x, scale))
        require(same, f"quantize_int8 {label} (n={n}) is not bitwise its "
                "plain version")
        if label == "zero":
            require(not bool(got.any()), "a zero bucket quantizes to zero")
        bms, by = bound(*roofline.quantize_int8_cost(n), FP32_FLOPS)
        if label.startswith("bucket"):
            if n not in timed:
                timed[n] = (
                    cuda_ms([lambda: fused_mod.quantize_int8(x, scale)],
                            iters=20),
                    event_ms(lambda: ref.quantize_int8(x, scale), iters=3))
            ms, plain = timed[n]
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bms)):
                step[key] += val
            print(f"quantize_int8 {label} {n} | {ms:.4f} | {bms:.4f} ({by})"
                  f" | {plain:.4f} | {same}")
        else:
            print(f"quantize_int8 {label} {n} | - | {bms:.4f} ({by}) | - | "
                  f"{same}")
    print(f"quantize_int8: one step's 9 buckets per rank: {step['ms']:.4f} "
          f"ms, bound {step['bound_ms']:.4f} ms (bytes), plain "
          f"{step['plain_ms']:.4f} ms")
    return dict(name="quantize_int8", route="cuda",
                source="src/repro_torch/kernels/csrc/quantize.cu",
                replaces="src/repro/kernels/fused.py:117",
                case="one train step's 9 gradient buckets of one rank "
                     f"({sum(BUCKETS)} fp32 elements)",
                max_abs_err=0.0, bound_by="bytes", library_ms=None, **step)


def leaf_lengths(cfg):
    """(name, elements) of qwen2-0.5b's 15 parameter leaves, in the
    params' order: the compressed step quantizes each once per int8
    step."""
    specs = Model(cfg, device="cpu").param_specs()
    return [(name, math.prod(spec.shape)) for name, spec in specs.items()]


def compress_input(label, n, g):
    """An input of ``quantize_compress``: fp32 gradient-like values, or
    bf16 ones; ``zero`` all zeros (scale fl32(1e-12), q 0); ``ties`` the
    largest magnitude 127 * 2^-10 (scale exactly 2^-10) and every other
    element an exact .5 multiple of the scale; ``negative`` the largest
    magnitude on a negative element."""
    x = torch.randn(n, generator=g, device="cuda") * 1e-3
    if label == "zero":
        x.zero_()
    if label == "ties":
        k = torch.randint(-127, 127, (n,), generator=g,
                          device="cuda").float() + 0.5
        x = torch.where(torch.arange(n, device="cuda") % 2 == 0,
                        k * 2.0 ** -10, x * 0.1)
        x[n // 2] = 127 * 2.0 ** -10
        require(float(ref.int8_scale(x.abs().max())) == 2.0 ** -10,
                "the ties case's scale is not 2^-10")
    if label == "negative":
        x[n // 3] = -2 * x.abs().max()
    return x.to(torch.bfloat16) if label == "bf16" else x


def ef_error(label, x, g):
    """(g, err) of the error-feedback form for a ``compress_input`` x:
    err drawn at 1e-2 of the gradients' scale (N(0, 1e-5)), g = x; for
    ``zero`` both zero; for ``ties`` err a whole multiple of 2^-10 at the
    even elements and g = x - err there (exact in fp32), so v = g + err is
    x again, its ties included."""
    n = x.numel()
    err = torch.randn(n, generator=g, device="cuda") * 1e-5
    if label == "zero":
        err.zero_()
    if label == "ties":
        j = torch.randint(-3, 4, (n,), generator=g, device="cuda").float()
        even = torch.arange(n, device="cuda") % 2 == 0
        err = torch.where(even, j * 2.0 ** -10, err)
        err[n // 2] = 0.0
        x = torch.where(even, x - err, x)
    return x, err


def check_quantize_compress(cfg):
    """``quantize_compress`` and its error-feedback form against their
    plain versions, bitwise (q and the scale; deq, new_err and the scale),
    at each of qwen2-0.5b's 15 leaf lengths, ragged lengths, a bf16 input,
    an all-zero input, exact .5 ties, a negative absmax and n = 1.  Timed
    over the 15 leaves (one int8 step of the compressed SGD path on one
    rank): ``quantize_compress`` on fp32 x, bound 5 bytes an element (x
    read once, int8 written), two-pass floor 9 (x read twice); the EF form
    on bf16 g (the path's gradients) and fp32 err, bound 14 bytes an
    element (g and err read once, deq and new_err written), two-pass floor
    20 (read twice), beside its plain version and, timed once as a
    yardstick, the unfused composition it replaced (the earlier
    ``compression.quantize_int8``: v = g.float() + err, the kernel on v,
    deq = q * scale, the residual in float64)."""
    from repro_torch.kernels import fused as fused_mod
    step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, two_pass_bound_ms=0.0)
    ef = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, two_pass_bound_ms=0.0,
              unfused_ms=0.0)
    print("quantize_compress: leaf n | kernel ms | bound ms (by) | two-pass "
          "ms | plain ms | bitwise equal || EF (g dtype): kernel ms | bound "
          "ms | two-pass ms | plain ms | unfused ms | bitwise equal")
    g = gen(1700)
    leaves = dict(leaf_lengths(cfg))
    cases = list(leaves.items())
    cases += [("ragged", 4096 * 37 + 3), ("bf16", 1_000_003),
              ("zero", 4097), ("ties", 100_003), ("negative", 999_999),
              ("one", 1)]
    timed = {}

    def unfused(gb, err):
        v = gb.float() + err
        q, scale = fused_mod.quantize_compress(v)
        return (q.float() * scale,
                (v.double() - q.double() * scale.double()).float())

    for label, n in cases:
        x = compress_input(label, n, g)
        q, s = fused_mod.quantize_compress(x)
        qw, sw = ref.quantize_compress(x)
        same = torch.equal(q, qw) and torch.equal(s, sw)
        require(same, f"quantize_compress {label} (n={n}) is not bitwise "
                "its plain version")
        if label == "zero":
            require(not bool(q.any()) and float(s) == float(
                np.float32(1e-12)), "a zero input gives q 0, scale 1e-12")
        # the EF form: bf16 g at the leaves (the path's gradients)
        gx, err = ef_error(label, x, g)
        if label in leaves:
            gx = gx.to(torch.bfloat16)
        g0, e0 = gx.clone(), err.clone()
        deq, ne, es = fused_mod.quantize_compress_ef(gx, err)
        dw, nw, esw = ref.quantize_compress_ef(gx, err)
        ef_same = (same_bits(deq, dw) and same_bits(ne, nw)
                   and same_bits(es, esw))
        require(ef_same, f"quantize_compress_ef {label} (n={n}, "
                f"{gx.dtype}) is not bitwise its plain version")
        require(torch.equal(gx, g0) and torch.equal(err, e0),
                f"quantize_compress_ef {label} changed its inputs")
        if label == "ties":
            require(float(es) == 2.0 ** -10, "the EF ties case's scale is "
                    "not 2^-10")
        elt, gelt = x.element_size(), gx.element_size()
        bms, by = bound(*roofline.quantize_compress_cost(n, elt), FP32_FLOPS)
        two_pass = (2 * elt + 1.0) * n / HBM_BYTES_PER_S * 1e3
        ebms, eby = bound(*roofline.quantize_compress_ef_cost(n, gelt),
                          FP32_FLOPS)
        etwo = (2 * gelt + 16.0) * n / HBM_BYTES_PER_S * 1e3
        if label in leaves:
            if n not in timed:
                timed[n] = (
                    cuda_ms([lambda: fused_mod.quantize_compress(x)],
                            iters=20),
                    event_ms(lambda: ref.quantize_compress(x), iters=3),
                    cuda_ms([lambda: fused_mod.quantize_compress_ef(
                        gx, err)], iters=20),
                    event_ms(lambda: ref.quantize_compress_ef(gx, err),
                             iters=3),
                    event_ms(lambda: unfused(gx, err), iters=1))
            ms, plain, ems, eplain, eun = timed[n]
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bms),
                             ("two_pass_bound_ms", two_pass)):
                step[key] += val
            for key, val in (("ms", ems), ("plain_ms", eplain),
                             ("bound_ms", ebms),
                             ("two_pass_bound_ms", etwo),
                             ("unfused_ms", eun)):
                ef[key] += val
            print(f"quantize_compress {label} {n} | {ms:.4f} | {bms:.4f} "
                  f"({by}) | {two_pass:.4f} | {plain:.4f} | {same} || "
                  f"{gx.dtype}: {ems:.4f} | {ebms:.4f} ({eby}) | "
                  f"{etwo:.4f} | {eplain:.4f} | {eun:.4f} | {ef_same}")
        else:
            print(f"quantize_compress {label} {n} | - | {bms:.4f} ({by}) | "
                  f"- | - | {same} || {gx.dtype}: - | {ebms:.4f} ({eby}) | "
                  f"- | - | - | {ef_same}")
        del q, qw, deq, ne, dw, nw
    n_all = sum(leaves.values())
    print(f"quantize_compress: one int8 step's 15 leaves per rank "
          f"({n_all} fp32 elements): {step['ms']:.4f} ms, bound "
          f"{step['bound_ms']:.4f} ms (bytes, 5 B an element), two-pass "
          f"floor {step['two_pass_bound_ms']:.4f} ms (9 B), plain "
          f"{step['plain_ms']:.4f} ms")
    print(f"quantize_compress_ef: one int8 step's 15 leaves per rank "
          f"({n_all} elements, bf16 g, fp32 err): {ef['ms']:.4f} ms, bound "
          f"{ef['bound_ms']:.4f} ms (bytes, 14 B an element: g and err read "
          f"once, deq and new_err written), two-pass floor "
          f"{ef['two_pass_bound_ms']:.4f} ms (20 B: read twice), plain "
          f"{ef['plain_ms']:.4f} ms, the unfused composition it replaced "
          f"{ef['unfused_ms']:.4f} ms")
    return dict(name="quantize_compress", route="cuda",
                source="src/repro_torch/kernels/csrc/quantize.cu",
                replaces="src/repro/kernels/fused.py:77",
                case="one int8 step of the compressed SGD path on one rank "
                     "through the error-feedback form: qwen2-0.5b's 15 "
                     f"leaves ({n_all} elements, bf16 g, fp32 err)",
                max_abs_err=0.0, bound_by="bytes", library_ms=None,
                ms=ef["ms"], plain_ms=ef["plain_ms"],
                bound_ms=ef["bound_ms"],
                two_pass_bound_ms=ef["two_pass_bound_ms"],
                unfused_ms=ef["unfused_ms"],
                compress_alone=dict(step, case="the same 15 leaves as fp32 "
                                    "x, quantize_compress (q, scale)"))


# the reference's matmul_dequant tolerances (tests/test_fused_kernels.py)
DEQUANT_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}


def int8pack_mm():
    """``torch.ops.aten._weight_int8pack_mm`` (A (M, K), B (N, K) int8,
    scales (N,)) when this PyTorch registers it for CUDA, else None (the
    reason printed).  Timed only, as the library call beside
    ``matmul_dequant``; the port never calls it."""
    try:
        has = torch._C._dispatch_has_kernel_for_dispatch_key(
            "aten::_weight_int8pack_mm", "CUDA")
    except RuntimeError as e:
        print(f"_weight_int8pack_mm: no such op ({e})")
        return None
    print(f"_weight_int8pack_mm registered for CUDA: {has} (torch "
          f"{torch.__version__})")
    return torch.ops.aten._weight_int8pack_mm if has else None


def dequant_widened(a, bq, bs, out):
    """What ``matmul_dequant`` is pinned to, bitwise: the GEMM kernel on
    the weights widened to ``a``'s type, in fp32, times the scale, cast
    once."""
    return (gemm_mod.matmul(a, bq.to(a.dtype), torch.float32)
            * bs[None, :]).to(out)


def check_matmul_dequant(cfg):
    """``matmul_dequant`` at qwen2-0.5b's eight decode products (M = 8)
    and at a prefill M = 128, at the bench shape (8, 1024, 1024) and the
    reference test's ragged shapes, for bf16 and fp32 activations:
    bitwise ``matmul`` on the widened weights times the scale (fp32 and
    bf16 outputs), the same bits on a second run, rows of an M = 8 call
    equal to those rows inside an M = 128 call, and the reference's
    tolerances against the plain version (fp32 2e-5, bf16 2e-2) as a
    second gate.  Timed beside its bound, its plain version, the
    ``matmul`` kernel and ``torch.matmul`` on the already-widened weights
    (yardsticks) and
    ``_weight_int8pack_mm`` (bf16, decode products; the library call where
    this PyTorch has it for CUDA, on B transposed once outside the
    timing).  Weights: normal * 0.05, quantized per column."""
    shapes = [(M, label, K, N, calls) for M in (SLOTS, CHUNK)
              for label, K, N, calls in gemm_cases(cfg)]
    shapes += [(8, "bench", 1024, 1024, 0), (5, "ragged", 300, 77, 0),
               (130, "ragged", 257, 129, 0)]
    lib_op = int8pack_mm()
    rows = {dt: dict(ms=0.0, plain_ms=0.0, widened_ms=0.0, gemm_ms=0.0,
                     bound_ms=0.0, bytes=0.0, flops=0.0, library_ms=0.0)
            for dt in DEQUANT_TOL}
    errs = {dt: 0.0 for dt in DEQUANT_TOL}
    pins = 0
    print("matmul_dequant: dtype label M K N | kernel ms | bound ms (by) | "
          "plain ms | matmul kernel (widened B) ms | torch.matmul (widened "
          "B) ms | _weight_int8pack_mm ms | max abs err | bitwise widened "
          "matmul, runs, rows")
    for i, (M, label, K, N, calls) in enumerate(shapes):
        n = copies(K * N)
        ws = [torch.randn((K, N), generator=gen(1800 + 7 * i + j),
                          device="cuda") * 0.05 for j in range(n)]
        qs = [ops.quantize_int8_per_channel(w) for w in ws]
        del ws
        for dt, (rtol, atol) in DEQUANT_TOL.items():
            a = torch.randn((M, K), generator=gen(1900 + i),
                            device="cuda").to(dt)
            bq, bs = qs[0]
            for out in (torch.float32, torch.bfloat16):
                got = gemm_mod.matmul_dequant(a, bq, bs, out)
                require(same_bits(got, dequant_widened(a, bq, bs, out)),
                        f"matmul_dequant {dt} -> {out} {label} ({M},{K},{N})"
                        " is not bitwise matmul on the widened weights times "
                        "the scale")
                require(same_bits(got, gemm_mod.matmul_dequant(
                    a, bq, bs, out)), f"matmul_dequant {dt} {label} "
                    f"({M},{K},{N}): two runs differ")
                pins += 2
            if M == CHUNK and label != "ragged":
                # rows of an M = 8 call inside this M = 128 call
                got = gemm_mod.matmul_dequant(a, bq, bs, torch.float32)
                require(same_bits(got[:SLOTS], gemm_mod.matmul_dequant(
                    a[:SLOTS].contiguous(), bq, bs, torch.float32)),
                    f"matmul_dequant {dt} {label} ({K},{N}): rows of an "
                    f"M = {SLOTS} call differ from those rows at M = {M}")
                pins += 1
            got = gemm_mod.matmul_dequant(a, bq, bs, torch.float32)
            want = ref.matmul_dequant(a, bq, bs, torch.float32)
            require(bool(torch.isfinite(got).all()),
                    f"matmul_dequant {label}: non-finite output")
            e = (got - want).abs()
            require(not bool((e > atol + rtol * want.abs()).any()),
                    f"matmul_dequant {dt} {label} ({M},{K},{N}) disagrees "
                    f"with its plain version (max abs err "
                    f"{float(e.max()):.3g}, tolerance {atol} + {rtol} |ref|)")
            errs[dt] = max(errs[dt], float(e.max()))
            if label == "ragged":
                print(f"matmul_dequant {dt} {label} {M} {K} {N} | - | - | - "
                      f"| - | - | - | {float(e.max()):.3g} | True")
                continue
            wide = [q.to(dt) for q, _ in qs[:2]]
            ms = cuda_ms([lambda q=q, s=s: gemm_mod.matmul_dequant(
                a, q, s, torch.float32) for q, s in qs], iters=max(20, 4 * n))
            plain = cuda_ms([lambda q=q, s=s: ref.matmul_dequant(
                a, q, s, torch.float32) for q, s in qs[:2]], iters=5,
                warmup=1)
            widened = cuda_ms([lambda b=b: torch.matmul(a, b) for b in wide],
                              iters=max(20, 4 * n))
            gemm_wide = cuda_ms([lambda b=b: gemm_mod.matmul(
                a, b, torch.float32) for b in wide], iters=max(20, 4 * n))
            lib = None
            if lib_op is not None and dt == torch.bfloat16:
                packed = [(q.t().contiguous(), s.to(dt)) for q, s in qs]
                lib = cuda_ms([lambda q=q, s=s: lib_op(a, q, s)
                               for q, s in packed], iters=max(20, 4 * n))
                del packed
            nbytes, flops = roofline.matmul_dequant_cost(M, K, N,
                                                         a.element_size())
            bms, by = bound(nbytes, flops, BF16_FLOPS if dt == torch.bfloat16
                            else FP32_FLOPS)
            lib_s = "-" if lib is None else f"{lib:.4f}"
            print(f"matmul_dequant {dt} {label:7s} {M:4d} {K:5d} {N:6d} | "
                  f"{ms:.4f} | {bms:.4f} ({by}) | {plain:.4f} | "
                  f"{gemm_wide:.4f} | {widened:.4f} | {lib_s} | "
                  f"{float(e.max()):.3g} | True")
            if M == SLOTS and calls:
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("widened_ms", widened),
                                 ("gemm_ms", gemm_wide), ("bound_ms", bms),
                                 ("bytes", nbytes), ("flops", flops),
                                 ("library_ms", lib or 0.0)):
                    rows[dt][key] += calls * val
    out = {}
    for dt, r in rows.items():
        bms, by = bound(r["bytes"], r["flops"], BF16_FLOPS
                        if dt == torch.bfloat16 else FP32_FLOPS)
        out[dt] = dict(r, bound_ms=bms, bound_by=by)
        lib_s = (f"{r['library_ms']:.4f} ms" if lib_op is not None
                 and dt == torch.bfloat16 else "none")
        print(f"matmul_dequant {dt}: one qwen2-0.5b decode step's 169 "
              f"products at M={SLOTS}: {r['ms']:.4f} ms, bound {bms:.4f} ms "
              f"({by}), plain {r['plain_ms']:.4f} ms, the matmul kernel on "
              f"widened weights {r['gemm_ms']:.4f} ms, torch.matmul on them "
              f"{r['widened_ms']:.4f} ms, _weight_int8pack_mm {lib_s}")
    print(f"matmul_dequant: {pins} bitwise pins held (widened matmul, runs, "
          "rows)")
    bf, f32 = out[torch.bfloat16], out[torch.float32]
    return dict(name="matmul_dequant", route="cuda",
                source="src/repro_torch/kernels/csrc/gemm.cu",
                replaces="src/repro/kernels/gemm.py:115",
                case=f"one qwen2-0.5b decode step's 169 products at M={SLOTS}"
                     ", bf16 activations, int8 weights (no model path calls "
                     "it: entry point ops.matmul_dequant only)",
                max_abs_err=errs[torch.bfloat16], ms=bf["ms"],
                plain_ms=bf["plain_ms"], bound_ms=bf["bound_ms"],
                bound_by=bf["bound_by"],
                library_ms=bf["library_ms"] if lib_op is not None else None,
                library=("torch.ops.aten._weight_int8pack_mm on B transposed "
                         "beforehand, scales in bf16 (timed only)"
                         if lib_op is not None else "none: "
                         "_weight_int8pack_mm is not registered for CUDA"),
                widened_matmul_ms=bf["widened_ms"],
                gemm_widened_ms=bf["gemm_ms"],
                bitwise_pins=pins,
                fp32_activations=dict(
                    ms=f32["ms"], plain_ms=f32["plain_ms"],
                    bound_ms=f32["bound_ms"], bound_by=f32["bound_by"],
                    widened_matmul_ms=f32["widened_ms"],
                    gemm_widened_ms=f32["gemm_ms"],
                    max_abs_err=errs[torch.float32]))


def bwd_inputs(seed, B, hq, hkv, S, T, D=64):
    return (randn((B, hq, S, D), seed), randn((B, hkv, T, D), seed + 1),
            randn((B, hkv, T, D), seed + 2), randn((B, hq, S, D), seed + 3))


def grads_close(got, want, what):
    err = 0.0
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        g, w = g.float(), w.float()
        require(bool(torch.isfinite(g).all()), f"{what} {name}: not finite")
        atol = GRAD_ATOL_FRAC * float(w.abs().max()) + 1e-6
        e = (g - w).abs()
        require(not bool((e > atol + GRAD_RTOL * w.abs()).any()),
                f"{what} {name}: kernel disagrees with its plain version "
                f"(max abs err {float(e.max()):.3g}, tolerance {atol:.3g} + "
                f"{GRAD_RTOL} |ref|)")
        err = max(err, float(e.max()))
    return err


def profile_calls(fn, calls: int):
    """The profiler's record of ``calls`` eager calls of ``fn`` (after one
    call it does not see)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return prof


def check_attention_backward(cfg):
    """The backward kernel against autograd through the plain attention
    at the train shape and at small ragged, window and softcap shapes,
    zero gradients on rows with no visible key; timed at the train shape
    beside one ``torch.autograd.grad`` through SDPA (timed only), with
    the forward that keeps its log-sum-exp beside its bound and SDPA's
    forward (``is_causal=True, enable_gqa=True``; timed only)."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    B = TRAIN_BATCH // RANKS
    cases = [("train", B, H, Hkv, TRAIN_SEQ, TRAIN_SEQ, 0, None, None),
             ("ragged", 1, 4, 2, 37, 100, 63, None, None),
             ("window", 2, 6, 3, 96, 96, 0, 24, None),
             ("softcap", 1, 4, 1, 64, 64, 0, None, 5.0),
             ("no visible key", 1, 2, 1, 16, 40, 20, 1, None)]
    errs, row = [], None
    print("attention backward: case | kernel ms | bound ms (by) | plain ms"
          " | sdpa backward ms | max abs err")
    for i, (label, b, hq, hkv, S, T, off, window, cap) in enumerate(cases):
        q, k, v, do = bwd_inputs(1400 + 10 * i, b, hq, hkv, S, T, hd)
        kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(fa_mod.attention(*leaves, **kw), leaves,
                                  do)
        want = ref.attention_backward(q, k, v, do, **kw)
        err = grads_close(got, want, f"attention backward {label}")
        errs.append(err)
        if window == 1:
            require(not bool(got[0][:, :, 20:].any()),
                    "rows with no visible key must get zero gradients")
        if label != "train":
            print(f"attention backward {label:15s} | - | - | - | - | "
                  f"{err:.3g}")
            continue
        n = copies(2 * (3 * q.numel() + 2 * k.numel()))
        sets = [bwd_inputs(1500 + 4 * j, b, hq, hkv, S, T, hd)
                for j in range(n)]
        outs = [fa_mod._forward(*s[:3], True, None, None, hd ** -0.5, 0,
                                with_lse=True) for s in sets]
        ms = cuda_ms([lambda s=s, o=o: fa_mod.attention_backward(
            *s[:3], o[0], s[3], o[1]) for s, o in zip(sets, outs)],
            iters=max(10, 2 * n))
        fwd = cuda_ms([lambda s=s: fa_mod._forward(
            *s[:3], True, None, None, hd ** -0.5, 0, with_lse=True)
            for s in sets], iters=max(10, 2 * n))
        fwd_lib = cuda_ms([lambda s=s: torch.nn.functional
                           .scaled_dot_product_attention(
                               *s[:3], is_causal=True, enable_gqa=True)
                           for s in sets], iters=max(10, 2 * n))
        plain = event_ms(lambda: ref.attention_backward(q, k, v, do, **kw))

        def sdpa():
            ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = torch.nn.functional.scaled_dot_product_attention(
                *ls, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(o, ls, do)
        lib = event_ms(sdpa, iters=10, warmup=2)
        split = pass_us([lambda s=s, o=o: fa_mod.attention_backward(
            *s[:3], o[0], s[3], o[1]) for s, o in zip(sets, outs)],
            max(10, 2 * n), ATTN_BWD_PASSES)
        print("attention backward, device µs per call by pass: "
              + us_text(split))
        pairs = S * (S + 1) // 2
        # recompute QK^T and dP (2 products), dV, dK, dQ (3): 5 products
        bms, by = bound(*roofline.attention_backward_cost(q.shape, k.shape,
                                                          pairs))
        # the forward with its log-sum-exp: q, k, v read, out and lse
        # written; QK^T and PV over the causal pairs
        fbms, fby = bound(*roofline.attention_cost(q.shape, k.shape, pairs,
                                                   lse=True))
        print(f"attention backward {label:15s} | {ms:.4f} | {bms:.4f} ({by})"
              f" | {plain:.4f} | {lib:.4f} | {err:.3g}; the forward with "
              f"its log-sum-exp {fwd:.4f} ms, bound {fbms:.5f} ({fby}), "
              f"sdpa forward {fwd_lib:.4f} ms")
        row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                   bound_by=by, forward_with_lse_ms=fwd,
                   forward_bound_ms=fbms, forward_bound_by=fby,
                   forward_library_ms=fwd_lib, kernels_us=split,
                   case=f"one layer's backward on one rank: q ({b},{hq},{S},"
                        f"{hd}), k/v ({b},{hkv},{T},{hd}), causal")
    return dict(name="attention_backward", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/layers.py:52",
                note="no TPU kernel: the reference trains through "
                     "layers.flash_attention_jnp's autodiff",
                max_abs_err=max(errs), **row)


def check_gemm_backward(cfg):
    """dA = dC Bᵀ and dB = Aᵀ dC on the GEMM kernel against the plain
    products at every train shape (M = one rank's 1,024 tokens), timed
    with the forward product; the backward products are timed as the
    backward calls them, on transposed views of A and B (the kernel reads
    either layout; no copy is made), with their plans; returns the
    kernel's ms per train step per rank (the forward, its recompute under
    remat, the backward)."""
    M = TRAIN_BATCH // RANKS * TRAIN_SEQ
    L = cfg.n_layers
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               fwd_ms=0.0, bwd_ms=0.0)
    errs = []
    print("gemm train products: label M K N | fwd ms | dA ms | dB ms | "
          "bound ms | plain ms | torch.matmul ms | max abs err")
    for i, (label, K, N, _) in enumerate(gemm_cases(cfg)):
        calls = 1 if label == "unembed" else L
        a, b = randn((M, K), 1600 + i), randn((K, N), 1620 + i, 0.05)
        dc = randn((M, N), 1640 + i)
        leaves = [a.clone().requires_grad_(True),
                  b.clone().requires_grad_(True)]
        got = torch.autograd.grad(
            gemm_mod.matmul(*leaves, torch.float32), leaves, dc.float())
        # the backward passes Bᵀ and Aᵀ as transposed views: no copies
        bt, at = b.t(), a.t()
        want = (ref.matmul(dc, bt, torch.bfloat16),
                ref.matmul(at, dc, torch.bfloat16))
        err = 0.0
        for g_, w_, nm in zip(got, want, ("dA", "dB")):
            e = (g_.float() - w_.float()).abs()
            tol = GRAD_ATOL_FRAC * float(w_.float().abs().max())
            require(not bool((e > tol + GRAD_RTOL * w_.float().abs()).any()),
                    f"gemm backward {label} {nm} disagrees with its plain "
                    f"version (max abs err {float(e.max()):.3g})")
            err = max(err, float(e.max()))
        errs.append(err)
        prods = ((a, b, torch.float32), (dc, bt, torch.bfloat16),
                 (at, dc, torch.bfloat16))
        ms = [cuda_ms([lambda x=x, y=y, o=o: gemm_mod.matmul(x, y, o)],
                      iters=10) for x, y, o in prods]
        plain = [event_ms(lambda x=x, y=y, o=o: ref.matmul(x, y, o),
                          iters=3) for x, y, o in prods]
        lib = [cuda_ms([lambda x=x, y=y: torch.matmul(x, y)], iters=10)
               for x, y, _ in prods]
        bms = [bound(*roofline.matmul_cost(
                   x.shape[0], x.shape[1], y.shape[1], 2, 2,
                   4 if o == torch.float32 else 2))[0] for x, y, o in prods]
        print(f"gemm train {label:7s} {M} {K} {N} | {ms[0]:.4f} | "
              f"{ms[1]:.4f} | {ms[2]:.4f} | {sum(bms):.4f} | "
              f"{sum(plain):.4f} | {sum(lib):.4f} | {err:.3g} | plans: "
              f"{plan_label(M, K, N)}; dA {plan_label(M, N, K)}; dB "
              f"{plan_label(K, M, N, a_transposed=True)}")
        # per step: the forward, its recompute under remat (not the
        # head's), and the two backward products
        n = (calls * (1 if label == "unembed" else 2), calls, calls)
        tot["fwd_ms"] += n[0] * ms[0]
        tot["bwd_ms"] += calls * (ms[1] + ms[2])
        for key, vals in (("ms", ms), ("plain_ms", plain),
                          ("library_ms", lib), ("bound_ms", bms)):
            tot[key] += sum(c * v for c, v in zip(n, vals))
    print("gemm: one train step per rank: " + ", ".join(
        f"{k} {v:.3f}" for k, v in tot.items()))
    return dict(max_abs_err=max(errs), **{f"train_step_{k}": v
                                          for k, v in tot.items()})


def params_digest(params) -> torch.Tensor:
    """A position-weighted int64 sum of every leaf's bits, per leaf, on
    the CPU: equal on two ranks iff (but for a 2^-64 chance) the leaves
    are bitwise equal."""
    out = []
    for name in sorted(params):
        bits = params[name].detach().reshape(-1).view(torch.int16)
        h = torch.zeros((), dtype=torch.int64, device=bits.device)
        for s in range(0, bits.numel(), 1 << 24):
            chunk = bits[s:s + (1 << 24)].to(torch.int64)
            idx = torch.arange(s, s + chunk.numel(), device=bits.device)
            h += (chunk * (idx * 2654435761 % 2147483629 + 1)).sum()
        out.append(h)
    return torch.stack(out).cpu()


def same_on_every_rank(digest: torch.Tensor) -> bool:
    import torch.distributed as dist
    hi, lo = digest.clone(), digest.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return torch.equal(hi, lo)


# elements a check reads of a leaf at once (its fp32 temporaries would
# otherwise hold several copies of the largest leaves: four ranks share
# the card in phases 10 and 13)
CHECK_CHUNK = 1 << 22


@torch.no_grad()
def step_agreement(got, want, p0, lr, what, quantized=False,
                   rms_bound=0.1):
    """The step tolerance of tests/test_torch_train.py, on the card: at
    step 1 AdamW moves every weight by about lr whatever its gradient's
    size, so every weight lies within 2 lr (+20%, + one bf16 ulp) of the
    other run's; an element moved the other way by more than half an lr
    is rare (under 0.5% of the model), and the updates differ by under
    ``rms_bound`` (10%) of their rms.  On the int8 wire a weight whose
    synced gradient rounds to zero moves by its decay only, within lr of
    the fp32 result: the same bound holds, the moves under half an lr are
    not counted, and the rms rule does not apply.  Each leaf is read
    ``CHECK_CHUNK`` elements at a time."""
    worst = against = still = total = 0.0
    dd = uu = 0.0
    for name in got:
        flat = [x[name].reshape(-1) for x in (got, want, p0)]
        for i in range(0, flat[0].numel(), CHECK_CHUNK):
            g, w, p = (x[i:i + CHECK_CHUNK].float() for x in flat)
            d = (g - w).abs()
            worst = max(worst, float((d - w.abs() * 2.0 ** -7).max()))
            ug, uw = g - p, w - p
            big = (ug.abs() > lr / 2) & (uw.abs() > lr / 2)
            against += float(((torch.sign(ug) != torch.sign(uw))
                              & big).sum())
            still += float((ug.abs() <= lr / 2).sum())
            total += g.numel()
            dd += float(((ug - uw) ** 2).sum())
            uu += float((uw ** 2).sum())
    rel = math.sqrt(dd / uu)
    out = dict(max_excess_over_ulp=worst, bound=2.4 * lr,
               moved_against_frac=against / total, update_rel_rms=rel,
               moved_under_half_lr_frac=still / total)
    print(f"{what}: " + ", ".join(f"{k} {v:.4g}" for k, v in out.items()))
    require(worst <= 2.4 * lr, f"{what}: a weight is more than 2 lr apart")
    require(against / total < 5e-3, f"{what}: too many weights moved the "
            "other way")
    if not quantized:
        require(rel < rms_bound,
                f"{what}: the updates differ by {rel:.1%} rms")
    return out


def device_breakdown(prof, busy=()):
    """Device ms of the profiled step by kernel family (this rank's;
    ``memcpy`` is the copies, gloo's staging through host memory
    included, ``other`` every other kernel: the eager PyTorch ops).  For
    each family named in ``busy``, also ``<family>_busy``: the ms during
    which one of its kernels ran, the union of their intervals, so that a
    programmatic dependent's span, which opens while the kernel before it
    still runs, is not counted twice."""
    fams = {"gemm": ("gemm_wgmma_kernel", "gemm_f32_kernel",
                     "reduce_groups_kernel"),
            "attention": ("flash_attention_wgmma_kernel",
                          "flash_attention_f32_kernel"),
            "attention_backward": ("attn_bwd",),
            "paged_decode_attention": ("paged_split", "paged_combine"),
            "ssd": ("ssd_chunk", "ssd_state_pass"),
            "ssd_backward": ("ssd_bwd",),
            "quantize_int8": ("quantize",),
            "memcpy": ("emcpy",)}
    out = {k: 0.0 for k in fams}
    out["other"] = 0.0
    total = 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):        # kernels, not host ops
            continue
        t = e.self_device_time_total / 1e3
        if t <= 0:
            continue
        total += t
        for k, pats in fams.items():
            if any(pat in e.key for pat in pats):
                out[k] += t
                break
        else:
            out["other"] += t
    out["device_total"] = total
    for k in busy:
        iv = device_intervals(prof, fams[k])
        out[k + "_busy"] = (union_ns(iv, min(s for s, _ in iv),
                                     max(e for _, e in iv)) / 1e6
                            if iv else 0.0)
    return out


def breakdown_per_call(fn, calls: int, busy=()):
    """:func:`device_breakdown` of ``calls`` eager calls of ``fn``, in
    device ms per call."""
    prof = profile_calls(fn, calls)
    return {k: v / calls for k, v in device_breakdown(prof, busy).items()}


def device_intervals(prof, pats=()):
    """``[start, end]`` ns of every device activity (kernels and copies)
    the profiler saw, or of the kernels whose names hold one of ``pats``,
    on the host's epoch clock, to which it aligns the card's timestamps:
    comparable with ``time.time_ns()`` and across the ranks of one
    host."""
    return [[e.start_ns(), e.start_ns() + e.duration_ns()]
            for e in prof.profiler.kineto_results.events()
            if "CUDA" in str(e.device_type()) and e.duration_ns() > 0
            and (not pats or any(p in e.name() for p in pats))]


def union_ns(intervals, lo, hi) -> int:
    """ns of ``[lo, hi]`` covered by at least one interval."""
    busy, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy


def train_rank(rank, init, batches, run2_path, result_path):
    """One rank of the two-rank train phase (runs 3 and 4, the wire
    control and the timings); writes its results as JSON to
    ``result_path`` with the rank's number in place of ``{}`` (a file, not
    a pipe: the parent reads them after the join, and the profiled step's
    device intervals would fill a pipe's buffer and block the rank)."""
    import torch.distributed as dist
    from repro_torch.api import Session
    from repro_torch.comms import bucketer, compressed
    from repro_torch.comms.plan import CommsPlan, sync_tree
    from repro_torch.core.distributed import close_group, init_group
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(init, rank=rank, world_size=RANKS)
    sess = Session(device="cuda")
    out = dict(rank=rank)
    lr1 = TRAIN_PEAK / TRAIN_WARMUP

    # run 3: the fp32 wire, one step from the seed
    plan3 = sess.plan(ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      comms=CommsPlan(schedule="psum"), adamw=train_adamw(),
                      microbatches=1)
    sess.init_state(plan3, seed=SEED, name="fp32")
    m3 = sess.step(plan3, batches[0], name="fp32")
    p3 = sess.evict("fp32")["params"]
    out["run3"] = {k: float(v) for k, v in m3.items()}
    require(same_on_every_rank(params_digest(p3)),
            "fp32 wire: replicas differ after the step")
    p0 = plan3.model.init(SEED)
    if rank == 0:
        run2 = torch.load(run2_path)
        p2 = {k: v.cuda() for k, v in run2["params"].items()}
        out["run3_vs_run2"] = step_agreement(
            p3, p2, p0, lr1, "two ranks, fp32 wire vs one rank, step 1")
        for k in ("loss", "grad_norm"):
            rtol = 1e-3 if k == "loss" else 1e-2
            require(abs(out["run3"][k] - run2["metrics"][k])
                    <= rtol * abs(run2["metrics"][k]),
                    f"fp32 wire vs one rank: {k} {out['run3'][k]} vs "
                    f"{run2['metrics'][k]}")
        del p2, run2
    torch.cuda.empty_cache()

    # run 4: the int8 wire, the main path, WIRE_STEPS steps; its schedule
    # resolved by the topology cost model (the reference's tree at 2)
    plan4 = sess.plan(ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      comms=CommsPlan(schedule="auto", wire_dtype="int8"),
                      adamw=train_adamw(), microbatches=1)
    sess.init_state(plan4, seed=SEED, name="int8")
    out["schedule"] = plan4.comms.resolve(sess.mesh, 4 * sum(
        p.numel() for p in sess.get("int8")["params"].values()))
    require(out["schedule"] == "tree",
            f"the int8 wire resolved to {out['schedule']}, not tree")
    dist.barrier()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, stats = [], [], []
    for s in range(WIRE_STEPS):
        torch.cuda.synchronize()
        prof = None
        if s == PROFILED:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        dist.barrier()
        t0, t0_ns = time.perf_counter(), time.time_ns()
        m = sess.step(plan4, batches[s], name="int8")
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        if prof is not None:
            t1_ns = time.time_ns()
            prof.__exit__(None, None, None)
            out["profile"] = device_breakdown(prof)
            out["profiled_window_ns"] = [t0_ns, t1_ns]
            out["device_intervals_ns"] = device_intervals(prof)
        m = {k: float(v) for k, v in m.items()}
        losses.append(m["loss"])
        stats.append(m)
        params = sess.state["int8"]["params"]
        require(same_on_every_rank(params_digest(params)),
                f"int8 wire: replicas differ after step {s + 1}")
        if s == 0:
            out["run4_vs_run3"] = step_agreement(
                params, p3, p0, lr1,
                "two ranks, int8 wire vs fp32 wire, step 1", quantized=True)
            require(abs(m["loss"] - out["run3"]["loss"])
                    <= 1e-6 * abs(out["run3"]["loss"]),
                    "int8 and fp32 runs start from different losses")
            del p3, p0
    out["launches"] = ops.dispatch_report()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out.update(step_wall_ms=walls, losses=losses, stats=stats)

    # the first batch again, after the steps: the group's mean loss
    state = sess.state["int8"]
    local = {k: torch.from_numpy(np.asarray(v)).cuda().long()
             .chunk(RANKS)[rank] for k, v in batches[0].items()}
    with torch.no_grad():
        again = plan4.model.loss_fn(state["params"], local)[0].reshape(1)
    dist.all_reduce(again)
    out["first_batch_again"] = float(again) / RANKS

    # the step's parts alone, and the control: one bucket recomputed on
    # the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, _ = step_mod.local_grads(plan4.model, state["params"], local)
    torch.cuda.synchronize()
    out["forward_backward_ms"] = 1e3 * (time.perf_counter() - t0)
    dist.barrier()
    t0 = time.perf_counter()
    sync_tree(grads, plan4.comms, sess.mesh, ("data",))
    torch.cuda.synchronize()
    out["wire_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    opt.apply(plan4.adamw, state["opt"], grads, state["params"])
    torch.cuda.synchronize()
    out["adamw_ms"] = 1e3 * (time.perf_counter() - t0)
    bplan = bucketer.plan_buckets(grads)
    require(bplan.bucket_sizes == BUCKETS,
            f"bucket plan {bplan.bucket_sizes}")
    out["wire_int32_bytes"] = 4 * sum(bplan.bucket_sizes)
    out["wire_int8_format_bytes"] = sum(bplan.bucket_sizes)   # 1 B each
    buckets, absmaxes = bucketer.flatten_buckets_fused(bplan, grads, "int8")
    i = 1                                   # the smallest bucket
    wire = compressed.wire_all_reduce(
        buckets[i].clone(), sess.mesh, ("data",), out["schedule"], "int8",
        absmax=absmaxes[i])
    mine, my_amax = buckets[i].cpu(), absmaxes[i].cpu().reshape(1)
    host = [torch.empty_like(mine) for _ in range(RANKS)]
    dist.all_gather(host, mine)
    amax = [torch.empty_like(my_amax) for _ in range(RANKS)]
    dist.all_gather(amax, my_amax)
    if rank == 0:
        scale = ref.int8_scale(torch.cat(amax).max())
        qs = [ref.quantize_int8(b, scale).to(torch.int32) for b in host]
        full = (sum(qs).float() * scale)
        partial = qs[0].float() * scale
        ok = torch.equal(full, wire.cpu())
        control = torch.equal(partial, wire.cpu())
        print(f"wire control, bucket {i} ({BUCKETS[i]} elements): host "
              f"recompute with both ranks == the wire: {ok}; with rank 1's "
              f"int8 contribution left out: {control} (must be False)")
        require(ok, "the int8 wire's bucket differs from its host recompute")
        require(not control, "the control matches: the check cannot see a "
                "missing rank")
        out["control"] = dict(bucket=i, both_ranks_equal=ok,
                              one_rank_equal=control)
    del wire, buckets, absmaxes
    out["tree_vs_psum"] = tree_against_psum(sess, plan4, grads, batches)
    Path(result_path.format(rank)).write_text(json.dumps(out))
    dist.barrier()
    close_group()


def tree_against_psum(sess, plan4, grads, batches):
    """Run 4's schedule (``tree``) beside ``psum`` on the same int8 wire in
    this run, psum then tree: ``sync_tree`` alone on the same gradients
    (the two must give the same bits: two addends commute and the int8
    wire sums int32), then whole steps on run 4's state.  Returns the ms
    of each by schedule."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.comms.plan import sync_tree
    order = ("psum", "tree")
    comms = {s: dataclasses.replace(plan4.comms, schedule=s)
             for s in ("psum", "tree")}
    sync_ms = {s: [] for s in comms}
    digests = {}
    for s in order:
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        synced = sync_tree(grads, comms[s], sess.mesh, ("data",))
        torch.cuda.synchronize()
        sync_ms[s].append(1e3 * (time.perf_counter() - t0))
        digests[s] = params_digest(synced)
        del synced
    require(torch.equal(digests["psum"], digests["tree"]),
            "at two ranks tree and psum synced different bits")
    plans = {"tree": plan4,
             "psum": sess.plan(ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                               comms=comms["psum"], adamw=plan4.adamw,
                               microbatches=1)}
    step_ms = {s: [] for s in plans}
    for k, s in enumerate(order):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        sess.step(plans[s], batches[k], name="int8")
        torch.cuda.synchronize()
        step_ms[s].append(1e3 * (time.perf_counter() - t0))
    return dict(order=order, sync_tree_ms=sync_ms, step_ms=step_ms,
                same_bits=True)


def run_one_rank(cfg, batches):
    """Run 2: one step on one rank, no wire (path gspmd), the whole batch;
    saves the params after the step for the two-rank runs."""
    from repro_torch.api import Session
    sess = Session(device="cuda")
    plan = sess.plan(ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ, comms="off",
                     adamw=train_adamw(), microbatches=1)
    require(plan.path == "gspmd", f"comms='off' took path {plan.path}")
    sess.init_state(plan, seed=SEED)
    n_params = sum(p.numel() for p in sess.state["train_state"]
                   ["params"].values())
    require(n_params == 630_167_424 and cfg.n_layers == 24,
            f"qwen2-0.5b: {n_params} parameters")
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = {k: float(v) for k, v in sess.step(plan, batches[0]).items()}
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    launches = ops.dispatch_report()
    expect = expected_train_launches(cfg, 1, int8=False)
    print(f"run 2 (one rank, no wire, {TRAIN_BATCH}x{TRAIN_SEQ} tokens): "
          f"{m}, {wall:.1f} ms (first step); launches {launches} "
          f"(expected {expect})")
    require(launches == expect, "one-rank train launches do not match the "
            "layer loop")
    require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
            "one-rank step: non-finite metrics")
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    path = TRAIN_DIR / "run2.pt"
    torch.save({"params": {k: v.detach().cpu() for k, v in
                           sess.state["train_state"]["params"].items()},
                "metrics": m}, path)
    return path, dict(metrics=m, first_step_wall_ms=wall)


def check_train_against_cpu(cfg):
    """2 layers at full width, one sequence of 128 tokens: loss, grad
    norm and a few leaves' gradients on the card against the plain
    versions on the CPU, from the same weights."""
    import dataclasses
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod
    small = dataclasses.replace(cfg, n_layers=2)
    toks = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (1, 129))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    card = Model(small, device="cuda")
    params = card.init(SEED)
    runs = []
    for m, dev in ((card, "cuda"), (Model(small, device="cpu"), "cpu")):
        p = {k: v.detach().to(dev).requires_grad_(True)
             for k, v in params.items()}
        g, met = step_mod.local_grads(
            m, p, {k: v.to(dev) for k, v in batch.items()})
        runs.append((g, float(met["loss"]), float(opt.global_norm(g))))
    (gc, lc, nc), (gp, lp, np_) = runs
    out = dict(loss_card=lc, loss_cpu=lp, grad_norm_card=nc,
               grad_norm_cpu=np_)
    require(abs(lc - lp) <= CPU_LOSS_RTOL * abs(lp),
            f"train card vs cpu: loss {lc} vs {lp}")
    require(abs(nc - np_) <= CPU_NORM_RTOL * abs(np_),
            f"train card vs cpu: grad norm {nc} vs {np_}")
    for name in ("embed", "unembed", "layers.attn.wq", "layers.attn.wk",
                 "layers.attn.bv", "layers.mlp.out", "layers.ln1",
                 "final_norm", "layers.ssm.wx", "layers.ssm.wbc",
                 "layers.ssm.A", "layers.ssm.dt_bias", "layers.ssm.conv_x",
                 "layers.ssm.w_out"):
        if name not in gc:          # each family's leaves; gemma-2b: no bias
            continue
        c, w = gc[name].float().cpu(), gp[name].float()
        rel = float((c - w).norm() / w.norm())
        mx = float((c - w).abs().max() / w.abs().max())
        out[name] = dict(rel_rms=rel, max_abs_frac=mx)
        require(rel <= CPU_GRAD_TOL and mx <= CPU_GRAD_TOL,
                f"train card vs cpu: {name} gradient relative rms {rel:.3g},"
                f" max {mx:.3g} of the largest (tolerance {CPU_GRAD_TOL})")
    print(f"train card vs cpu ({cfg.name}, 2 layers, full width, 128 "
          "tokens): " + json.dumps(out))
    return out


def steady_wall(rank_result) -> float:
    """Median wall ms of the steps after the first, the profiled one
    left out."""
    return statistics.median(
        w for i, w in enumerate(rank_result["step_wall_ms"])
        if i not in (0, PROFILED))


def profiled_idle(ranks):
    """Busy and idle time of the card over the profiled step.

    ``card``: the union of both ranks' device intervals (kernels and
    copies; the ranks' kernels overlap on the one card) over one window,
    from the first rank's start to the last rank's end of that step.  Per
    rank: the step's wall time, the union of its own device intervals, and
    the rest (host time: its work was not on the card).  The profiler's
    host tracing slows the step a little, so its wall time runs above the
    unprofiled steps' median.  If a rank's device intervals do not fall
    inside its own step on the host clock, the clocks are not aligned and
    the card's share is not measured (None)."""
    per_rank, aligned = [], True
    for r in ranks:
        lo, hi = r["profiled_window_ns"]
        iv = r["device_intervals_ns"]
        require(iv, f"rank {r['rank']}: the profiler saw no device work")
        slack = 1_000_000
        aligned &= (min(s for s, _ in iv) >= lo - slack
                    and max(e for _, e in iv) <= hi + slack)
        busy = union_ns(iv, min(s for s, _ in iv), max(e for _, e in iv))
        per_rank.append(dict(wall_ms=(hi - lo) / 1e6, device_ms=busy / 1e6,
                             host_ms=(hi - lo - busy) / 1e6))
    card = dict(clocks_aligned=aligned, wall_ms=None, device_busy_ms=None,
                device_idle_share=None)
    if aligned:
        lo = min(r["profiled_window_ns"][0] for r in ranks)
        hi = max(r["profiled_window_ns"][1] for r in ranks)
        busy = union_ns([iv for r in ranks
                         for iv in r["device_intervals_ns"]], lo, hi)
        card.update(wall_ms=(hi - lo) / 1e6, device_busy_ms=busy / 1e6,
                    device_idle_share=1 - busy / (hi - lo))
    print("profiled step: card " + json.dumps(card) + "; per rank "
          + json.dumps(per_rank))
    return dict(card=card, ranks=per_rank)


def train_phase(cfg):
    """Run 2 here, runs 3 and 4 in two spawned ranks sharing the card
    over gloo; the card-vs-CPU check; returns the summary and the launch
    counts of the main path (run 4, summed over the ranks)."""
    import torch.multiprocessing as mp
    batches = train_batches(cfg)
    run2_path, run2 = run_one_rank(cfg, batches)
    torch.cuda.empty_cache()
    cpu_check = check_train_against_cpu(cfg)
    torch.cuda.empty_cache()
    init = f"file://{TRAIN_DIR / 'rendezvous'}"
    (TRAIN_DIR / "rendezvous").unlink(missing_ok=True)
    results = [TRAIN_DIR / f"rank{r}.json" for r in range(RANKS)]
    for f in results:
        f.unlink(missing_ok=True)
    try:
        mp.spawn(train_rank, args=(init, batches, str(run2_path),
                                   str(TRAIN_DIR / "rank{}.json")),
                 nprocs=RANKS, join=True)
    finally:
        run2_path.unlink(missing_ok=True)
    ranks = [json.loads(f.read_text()) for f in results]
    for f in results:
        f.unlink()
    expect = expected_train_launches(cfg, WIRE_STEPS, int8=True)
    for r in ranks:
        print(f"rank {r['rank']} launches over {WIRE_STEPS} int8-wire "
              f"steps: {r['launches']} (expected {expect})")
        require(r["launches"]["quantize_int8"] > 0
                and r["launches"]["attention_backward"] > 0,
                "a kernel of the train path was never launched")
        require(r["launches"] == expect,
                "train launches do not match the layer loop")
    losses = ranks[0]["losses"]
    require(all(r["losses"] == losses for r in ranks),
            "ranks report different losses")
    again = ranks[0]["first_batch_again"]
    print(f"int8-wire losses over {WIRE_STEPS} steps: {losses}; the first "
          f"batch after them: {again}")
    print(f"int8 wire: schedule {ranks[0]['schedule']} (CommsPlan 'auto' "
          f"through the topology); sync_tree alone "
          f"{[r['wire_ms'] for r in ranks]} ms, step wall median "
          f"{[steady_wall(r) for r in ranks]} ms per rank", flush=True)
    for r in ranks:
        tp = r["tree_vs_psum"]
        print(f"rank {r['rank']}, tree beside psum in this run (order "
              f"{'/'.join(tp['order'])}; the same bits: {tp['same_bits']}):"
              f" sync_tree alone tree {tp['sync_tree_ms']['tree']} ms, psum "
              f"{tp['sync_tree_ms']['psum']} ms; steps tree "
              f"{tp['step_ms']['tree']} ms, psum {tp['step_ms']['psum']} ms",
              flush=True)
    require(all(map(math.isfinite, losses)) and losses[-1] < losses[0]
            and again < losses[0], "the loss did not fall")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    wall = steady_wall(ranks[0])
    idle = profiled_idle(ranks)
    summary = dict(
        arch=ARCH, params=630_167_424, ranks=RANKS,
        global_batch_tokens=tokens, steps=WIRE_STEPS, losses=losses,
        first_batch_loss_after=again,
        run2=run2, run3=ranks[0]["run3"],
        run3_vs_run2=ranks[0]["run3_vs_run2"],
        run4_vs_run3=ranks[0]["run4_vs_run3"], control=ranks[0]["control"],
        schedule=ranks[0]["schedule"],
        card_vs_cpu=cpu_check, step_wall_ms_median=wall,
        tokens_per_s=tokens / (wall / 1e3), profiled_step=idle["card"],
        per_rank=[dict(
            rank=r["rank"], step_wall_ms=r["step_wall_ms"],
            step_wall_ms_median=steady_wall(r),
            profiled_step=idle["ranks"][i],
            forward_backward_ms=r["forward_backward_ms"],
            wire_ms=r["wire_ms"], adamw_ms=r["adamw_ms"],
            tree_vs_psum=r["tree_vs_psum"],
            peak_gib=r["peak_gib"], profile=r["profile"])
            for i, r in enumerate(ranks)],
        wire_int32_bytes_per_rank=ranks[0]["wire_int32_bytes"],
        wire_int8_format_bytes_per_rank=ranks[0]["wire_int8_format_bytes"])
    print("train " + json.dumps(summary), flush=True)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    return summary, launches


# ---------------------------------------------------------------------------
# phase 6b: gemma-2b trained on one rank at full width and depth
# ---------------------------------------------------------------------------

G2B_TRAIN_BATCH = 2                  # 2 x 512 tokens a step


def train_gemma2b():
    """Phase 6b: gemma-2b (18 layers, head dim 256) through ``Session``
    on one rank (``comms="off"``), 2 x 512 tokens of
    ``SyntheticLM(structured=True)`` a step, AdamW at its peak rate from
    step 1: the gradients of the first batch under ``remat="group:3"``
    and ``"full"`` from the same params, bitwise equal; two steps under
    ``"group:3"`` and a third under ``"full"`` on the first batch again,
    each step's launches exactly the layer loop's for its remat, the
    third loss below the first; step times and peak memory; then the
    card's 2-layer loss and gradients against the CPU's.  Returns the
    summary and the launch counts of the three steps."""
    from repro_torch.api import Session
    from repro_torch.data import SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod
    cfg = get_config(GEMMA2B)
    data = iter(SyntheticLM(cfg.vocab_size, G2B_TRAIN_BATCH, TRAIN_SEQ,
                            seed=SEED, structured=True))
    batches = [next(data), next(data)]
    sess = Session(device="cuda")
    adamw = opt.AdamWConfig(lr=opt.warmup_cosine(TRAIN_PEAK, 0, 3))
    plans = {remat: sess.plan(GEMMA2B, batch=G2B_TRAIN_BATCH, seq=TRAIN_SEQ,
                              comms="off", microbatches=1, adamw=adamw,
                              model_kwargs={"remat": remat})
             for remat in ("group:3", "full")}
    require(all(p.model.remat == r for r, p in plans.items()),
            "Session.plan did not pass remat to the model")
    torch.cuda.reset_peak_memory_stats()
    sess.init_state(plans["group:3"], seed=SEED)
    params = sess.state["train_state"]["params"]
    n_params = sum(p.numel() for p in params.values())
    require(n_params == GEMMA2B_PARAMS, f"{GEMMA2B}: {n_params} parameters")
    first = {k: torch.from_numpy(v).cuda().long()
             for k, v in batches[0].items()}
    grads = [step_mod.local_grads(plans[r].model, params, first)
             for r in ("group:3", "full")]
    same = all(same_bits(grads[0][0][k], grads[1][0][k]) for k in params) \
        and same_bits(grads[0][1]["loss"], grads[1][1]["loss"])
    print(f"{GEMMA2B} gradients under remat group:3 and full, same params "
          f"and batch: bitwise equal {same}", flush=True)
    require(same, f"{GEMMA2B}: gradients differ between remat modes")
    del grads
    torch.cuda.empty_cache()
    ops.reset_launches()
    losses, walls, total = [], [], {}
    for remat, batch in (("group:3", batches[0]), ("group:3", batches[1]),
                         ("full", batches[0])):
        before = ops.dispatch_report()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in sess.step(plans[remat], batch).items()}
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        got = {k: v - before[k] for k, v in ops.dispatch_report().items()}
        expect = expected_train_launches(cfg, 1, int8=False, remat=remat)
        require(got == expect, f"{GEMMA2B} {remat} step launches {got}, "
                               f"expected {expect}")
        require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                f"{GEMMA2B}: non-finite metrics {m}")
        losses.append(m["loss"])
        total = {k: total.get(k, 0) + v for k, v in got.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"{GEMMA2B} steps (group:3, group:3, full on the first batch "
          f"again): losses {losses}, wall ms {walls}, peak "
          f"{peak / 2**30:.2f} GiB; launches {total}", flush=True)
    require(losses[2] < losses[0], f"{GEMMA2B}: the loss did not fall")
    del sess, params, plans
    torch.cuda.empty_cache()
    cpu_check = check_train_against_cpu(cfg)
    torch.cuda.empty_cache()
    tokens = G2B_TRAIN_BATCH * TRAIN_SEQ
    summary = dict(arch=GEMMA2B, params=n_params, tokens_per_step=tokens,
                   losses=losses, step_wall_ms=walls,
                   tokens_per_s_steps_2_3=[tokens / (w / 1e3)
                                           for w in walls[1:]],
                   peak_gib=peak / 2**30, remat_grads_bitwise=same,
                   card_vs_cpu=cpu_check)
    print("train " + json.dumps(summary), flush=True)
    return summary, total


# ---------------------------------------------------------------------------
# phase 6c: mamba2-780m trained on one rank at full width and depth
# ---------------------------------------------------------------------------

MAMBA_TRAIN_BATCH = 2                # 2 x 512 tokens a step
MAMBA_TRAIN_PATH = f"{MAMBA} train (1 rank, 3 steps)"


def expected_mamba_train_launches(cfg, steps: int):
    """Per rank under ``remat="full"``: each layer's 5 products (wx, wz,
    wbc, wdt, w_out) and one SSD forward, all run again by the backward's
    recompute (its early stop comes inside the layer's last product,
    after the launch), and the head's unembed once; two products for
    each product's backward, one SSD backward call a layer."""
    L = cfg.n_layers
    fwd = 5 * L + 1
    return launch_counts(matmul=steps * (fwd + 5 * L + 2 * fwd),
                         ssd=steps * 2 * L, ssd_backward=steps * L)


def held_ssd_backward_call(real, label, x, dt, A, Bm, C, dy, d_state,
                           scratch, *, init_state=None):
    """``real``'s gradients of one SSD backward call and their largest
    error over each gradient's largest magnitude against the plain
    version on the same inputs and cotangents (held within SSD_TOL by
    :func:`ssd_bwd_close`)."""
    got = real(x, dt, A, Bm, C, dy, d_state, scratch, init_state=init_state)
    want = ssd_mod.ssd_backward_plain(
        x, dt, A, Bm, C, torch.zeros_like(x) if dy is None else dy, d_state,
        init_state=init_state)
    e = ssd_bwd_close(f"{label}, x {tuple(x.shape)} {x.dtype}", got, want,
                      SSD_TOL[x.dtype])
    return got, max(r for _, r in e.values())


@contextlib.contextmanager
def held_ssd_backward():
    """Within the block every SSD backward call is held against the plain
    version on its own inputs and cotangents (:func:`ssd_bwd_close`, each
    gradient within SSD_TOL of its largest magnitude); yields ``held``,
    whose ``errs`` lists each call's largest relative error and
    ``shapes`` the distinct (x shape, dtype).  The plain version launches
    nothing."""
    real = ssd_mod.ssd_backward
    held = types.SimpleNamespace(errs=[], shapes=set())

    def call(x, *args, **kw):
        got, err = held_ssd_backward_call(real, f"call {len(held.errs)}",
                                          x, *args, **kw)
        held.errs.append(err)
        held.shapes.add((tuple(x.shape), str(x.dtype)))
        return got

    ssd_mod.ssd_backward = call
    try:
        yield held
    finally:
        ssd_mod.ssd_backward = real


def profiled_step(step):
    """One call of ``step`` under the profiler: (the profile, the host
    window's start and end ns on the clock the device intervals use)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        lo = time.time_ns()
        step()
        torch.cuda.synchronize()
        hi = time.time_ns()
    return prof, lo, hi


def train_mamba2():
    """Phase 6c: mamba2-780m (48 layers, 857,293,056 parameters) through
    ``Session`` on one rank (``comms="off"``, ``remat="full"``, AdamW at
    its peak rate from step 1), 2 x 512 tokens of
    ``SyntheticLM(structured=True)`` a step: three steps, the third on
    the first batch again and its loss below the first; each step's
    launches exactly the layer loop's (the SSD forward twice a layer,
    its backward once); step ms and the peak; a fourth step profiled for
    the card's idle share and the SSD kernels' busy ms; every SSD
    backward call of one more forward and backward held against the plain
    version at its own shapes; the card's 2-layer loss and gradients
    against the CPU's.  Returns the summary and the three steps'
    launches."""
    from repro_torch.api import Session
    from repro_torch.data import SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod
    cfg = get_config(MAMBA)
    data = iter(SyntheticLM(cfg.vocab_size, MAMBA_TRAIN_BATCH, TRAIN_SEQ,
                            seed=SEED, structured=True))
    batches = [next(data), next(data)]
    sess = Session(device="cuda")
    plan = sess.plan(MAMBA, batch=MAMBA_TRAIN_BATCH, seq=TRAIN_SEQ,
                     comms="off", microbatches=1,
                     adamw=opt.AdamWConfig(
                         lr=opt.warmup_cosine(TRAIN_PEAK, 0, 3)))
    require(plan.path == "gspmd" and plan.model.mesh is None
            and plan.model.remat == "full",
            f"{MAMBA}: plan {plan.path}, remat {plan.model.remat}")
    torch.cuda.reset_peak_memory_stats()
    sess.init_state(plan, seed=SEED)
    params = sess.state["train_state"]["params"]
    n_params = sum(p.numel() for p in params.values())
    require(n_params == MAMBA_PARAMS and cfg.n_layers == 48,
            f"{MAMBA}: {n_params} parameters in {cfg.n_layers} layers")
    ops.reset_launches()
    losses, walls, total = [], [], {}
    expect = expected_mamba_train_launches(cfg, 1)
    for batch in (batches[0], batches[1], batches[0]):
        before = ops.dispatch_report()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in sess.step(plan, batch).items()}
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        got = {k: v - before[k] for k, v in ops.dispatch_report().items()}
        require(got == expect, f"{MAMBA} step launches {got}, expected "
                               f"{expect}")
        require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                f"{MAMBA}: non-finite metrics {m}")
        losses.append(m["loss"])
        total = {k: total.get(k, 0) + v for k, v in got.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"{MAMBA} steps (the third on the first batch again): losses "
          f"{losses}, wall ms {walls}, peak {peak / 2**30:.2f} GiB; "
          f"launches {total}", flush=True)
    require(losses[2] < losses[0], f"{MAMBA}: the loss did not fall")
    prof, lo, hi = profiled_step(lambda: sess.step(plan, batches[1]))
    busy = union_ns(device_intervals(prof), lo, hi)
    parts = device_breakdown(prof, busy=("gemm", "ssd", "ssd_backward"))
    idle = 1 - busy / (hi - lo)
    print(f"{MAMBA} profiled step: wall {(hi - lo) / 1e6:.1f} ms, device "
          f"busy {busy / 1e6:.1f} ms, idle share {idle:.3f}; device ms by "
          f"kernel family {json.dumps(parts)}", flush=True)
    first = {k: torch.from_numpy(v).cuda().long()
             for k, v in batches[0].items()}
    with held_ssd_backward() as held:
        step_mod.local_grads(plan.model, params, first)
    require(len(held.errs) == cfg.n_layers,
            f"{MAMBA}: {len(held.errs)} SSD backward calls held, expected "
            f"{cfg.n_layers}")
    print(f"{MAMBA}: every SSD backward call of a step ({len(held.errs)}, "
          f"shapes {sorted(held.shapes)}) within SSD_TOL of its plain "
          f"version; largest error / largest gradient {max(held.errs):.3g}",
          flush=True)
    del sess, params, plan, prof
    torch.cuda.empty_cache()
    cpu_check = check_train_against_cpu(cfg)
    torch.cuda.empty_cache()
    tokens = MAMBA_TRAIN_BATCH * TRAIN_SEQ
    summary = dict(arch=MAMBA, params=n_params, tokens_per_step=tokens,
                   losses=losses, step_wall_ms=walls,
                   tokens_per_s_steps_2_3=[tokens / (w / 1e3)
                                           for w in walls[1:]],
                   peak_gib=peak / 2**30, profiled_wall_ms=(hi - lo) / 1e6,
                   device_busy_ms=busy / 1e6, device_idle_share=idle,
                   device_ms=parts, ssd_backward_calls_held=len(held.errs),
                   ssd_backward_max_rel_err=max(held.errs),
                   card_vs_cpu=cpu_check)
    print("train " + json.dumps(summary), flush=True)
    return summary, total


# ---------------------------------------------------------------------------
# phase 7: compressed data-parallel SGD, qwen2-0.5b at full width
# ---------------------------------------------------------------------------

# 2 steps a scheme (3 until phase 14 came: the whole script stays inside
# its time limit)
DP_SCHEMES, DP_STEPS = ("none", "onebit", "int8"), 2
# Plain SGD with momentum 0.9 moves a weight by lr times its gradient:
# most of qwen2-0.5b's bf16 weights (|w| ~ 0.02, one ulp ~ 1e-4) keep
# their value unless lr * |g| reaches half an ulp, so the rate is far
# above AdamW's 1e-4.
DP_LR, DP_MOMENTUM = 0.1, 0.9
DP_PATH = (f"{ARCH} compressed DP SGD ({RANKS} ranks, int8, {DP_STEPS} "
           "steps)")


def expected_dp_launches(cfg, scheme: str):
    """Per rank over the ``DP_STEPS`` steps: the train layer loop (remat
    ``full``, as the model's default), and one ``quantize_compress`` per
    parameter leaf per int8 step."""
    expect = expected_train_launches(cfg, DP_STEPS, int8=False)
    leaves = len(leaf_lengths(cfg))
    expect["quantize_compress"] = DP_STEPS * leaves if scheme == "int8" else 0
    return expect


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units of fp32 spacing at |b|."""
    spacing = torch.nextafter(b.abs(), torch.full_like(b, math.inf)) - b.abs()
    return (a - b).abs() / spacing


def dp_step1_check(scheme, synced, local, group_sum):
    """Checks of step 1 (the seed's params, the first batch), with no
    kernel of the port launched: ``none`` gives the bf16 mean of the
    local gradients computed before the steps, bitwise (so the step's
    local gradients are those); ``int8`` lies within (s0 + s1) / 4 of the
    fp32 mean of the two local gradients, plus fp32 rounding (each rank's
    dequantized value lies within half its scale s_r of its gradient)."""
    from repro_torch.comms import schedules
    out = {}
    if scheme == "none":
        same = all(torch.equal(
            synced[k], schedules.group_reduce(g.clone()) / torch.full(
                (), RANKS, dtype=g.dtype, device=g.device))
            for k, g in local.items())
        require(same, "none, step 1: the synced gradients are not the mean "
                "of the local gradients computed alone")
        out["bf16_mean_bitwise"] = same
    if scheme == "int8":
        worst = 0.0
        for k, g in local.items():
            v = g.float()
            exact = schedules.group_reduce(v.clone()) / torch.full(
                (), RANKS, device=v.device)
            s_sum = group_sum(ref.int8_scale(v.abs().max()))
            d = (synced[k] - exact).abs()
            slack = 2.0 ** -23 * (64 * s_sum + synced[k].abs() + exact.abs())
            require(not bool((d > s_sum / 4 + slack).any()),
                    f"int8, step 1, {k}: the synced gradient is more than "
                    "(s0 + s1) / 4 from the exact mean")
            worst = max(worst, float(d.max()) / (float(s_sum) / 4))
        out["max_err_over_quarter_scale_sum"] = worst
    return out


def dp_ef_check(scheme, local, err_digest):
    """Error feedback at step 1, after the counted window: the quantizer
    on the local gradients (zero error state) gives the step's new error
    state, bitwise, and ``deq + err`` gives back ``v``: int8 bitwise or
    within one rounding (one fp32 spacing of v), onebit within the
    reference's rtol 1e-5 (``tests/test_properties.py``)."""
    from repro_torch.train import compression as comp
    quant = getattr(comp, f"quantize_{scheme}")
    exact = total = 0
    worst = 0.0
    for k, g in local.items():
        v = g.float()
        deq, e = quant(g, torch.zeros_like(v))
        back = deq + e
        total += v.numel()
        if scheme == "int8":
            exact += int((back == v).sum())
            worst = max(worst, float(ulps_apart(back, v).max()))
        else:
            worst = max(worst, float(((back - v).abs() / (
                1e-6 + 1e-5 * v.abs())).max()))
        del deq, back
        err_digest_k = params_digest({k: e})
        require(torch.equal(err_digest_k, err_digest[k]),
                f"{scheme}: the step's error state for {k} is not the "
                "quantizer's")
    if scheme == "int8":
        require(worst <= 1.0, f"int8: deq + err is {worst} fp32 spacings "
                "from v")
        return dict(bitwise_share=exact / total, max_spacings=worst)
    require(worst <= 1.0, "onebit: deq + err is beyond rtol 1e-5 of v")
    return dict(max_over_tolerance=worst)


def dp_timings(scheme, loss_fn, params, local0, local):
    """The step's parts alone, after the counted window: forward and
    backward on the rank's rows, ``compressed_psum`` (quantize and wire),
    and the quantizer alone (wire = the difference)."""
    import torch.distributed as dist
    from repro_torch.train import compression as comp
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.autograd.grad(loss_fn(params, local0), list(params.values()))
    torch.cuda.synchronize()
    out["forward_backward_ms"] = 1e3 * (time.perf_counter() - t0)
    zeros = comp.init_error_state(local)
    grads = {k: g.clone() for k, g in local.items()}
    dist.barrier()
    t0 = time.perf_counter()
    comp.compressed_psum(grads, zeros, None, scheme)
    torch.cuda.synchronize()
    out["compressed_psum_ms"] = 1e3 * (time.perf_counter() - t0)
    out["quantizer_ms"] = 0.0
    if scheme != "none":
        quant = getattr(comp, f"quantize_{scheme}")
        t0 = time.perf_counter()
        for k, g in local.items():
            quant(g, zeros[k])
        torch.cuda.synchronize()
        out["quantizer_ms"] = 1e3 * (time.perf_counter() - t0)
    out["wire_ms"] = out["compressed_psum_ms"] - out["quantizer_ms"]
    return out


def dp_rank(rank, init, batches, result_path):
    """One rank of phase 7: ``build_dp_sgd_step`` over the model's loss,
    ``DP_STEPS`` steps per scheme from the seed's params, each scheme's
    steps a counted window; writes its results as JSON to ``result_path``
    with the rank's number in place of ``{}``."""
    import torch.distributed as dist
    from repro_torch.core.distributed import close_group, init_group
    from repro_torch.train import compression as comp

    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(init, rank=rank, world_size=RANKS)
    cfg = get_config(ARCH)
    model = Model(cfg, device="cuda")

    def loss_fn(p, b):
        return model.loss_fn(p, b)[0]

    def group_sum(x: torch.Tensor) -> torch.Tensor:
        x = x.detach().float().reshape(1).clone()
        dist.all_reduce(x)
        return x.reshape(())

    def fresh():
        return {k: v.requires_grad_(True)
                for k, v in model.init(SEED).items()}

    gb = [{k: torch.from_numpy(np.asarray(v)).cuda().long()
           for k, v in b.items()} for b in batches[:DP_STEPS]]
    local0 = {k: v.chunk(RANKS)[rank] for k, v in gb[0].items()}
    # step 1's local gradients, computed alone: every scheme's step 1
    # computes the same ones (the seed's params, this rank's rows of the
    # first batch; no kernel uses atomics, so bitwise)
    params = fresh()
    with torch.no_grad():
        first_before = float(group_sum(loss_fn(params, local0))) / RANKS
    local = dict(zip(params, torch.autograd.grad(
        loss_fn(params, local0), list(params.values()))))
    del params
    out = dict(rank=rank, first_batch_before=first_before, schemes={})
    for scheme in DP_SCHEMES:
        params = fresh()
        vel = {k: torch.zeros_like(p) for k, p in params.items()}
        err = comp.init_error_state(params)
        step = comp.build_dp_sgd_step(loss_fn, scheme=scheme, lr=DP_LR,
                                      momentum=DP_MOMENTUM)
        res = dict(step_wall_ms=[], losses=[])
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        for s in range(DP_STEPS):
            dist.barrier()
            t0 = time.perf_counter()
            r = step(params, vel, err, gb[s])
            torch.cuda.synchronize()
            res["step_wall_ms"].append(1e3 * (time.perf_counter() - t0))
            res["losses"].append(float(group_sum(r["loss"])) / RANKS)
            require(same_on_every_rank(params_digest(params))
                    and same_on_every_rank(params_digest(vel)),
                    f"{scheme}: replicas differ after step {s + 1}")
            if s == 0:
                res["step1"] = dp_step1_check(scheme, r["grads"], local,
                                              group_sum)
                err1 = {k: params_digest({k: e}) for k, e in err.items()}
            del r
        res["launches"] = ops.dispatch_report()
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["vel_dtypes"] = sorted({str(v.dtype) for v in vel.values()})
        if scheme == "none":
            with torch.no_grad():
                res["first_batch_after"] = float(group_sum(
                    loss_fn(params, local0))) / RANKS
        else:
            res["err_same_on_every_rank"] = same_on_every_rank(
                params_digest(err))
            res["error_feedback"] = dp_ef_check(scheme, local, err1)
        res.update(dp_timings(scheme, loss_fn, params, local0, local))
        res["wire_bytes"] = comp.wire_bytes(params, scheme)
        out["schemes"][scheme] = res
        del params, vel, err, step
        torch.cuda.empty_cache()
    Path(result_path.format(rank)).write_text(json.dumps(out))
    dist.barrier()
    close_group()


def dp_phase(cfg):
    """Phase 7: two ranks spawned on the one card over gloo run the three
    schemes; returns the summary and the int8 run's launch counts summed
    over the ranks (the path's main window)."""
    import torch.multiprocessing as mp
    batches = train_batches(cfg)
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    init = f"file://{TRAIN_DIR / 'rendezvous_dp'}"
    (TRAIN_DIR / "rendezvous_dp").unlink(missing_ok=True)
    results = [TRAIN_DIR / f"dp_rank{r}.json" for r in range(RANKS)]
    for f in results:
        f.unlink(missing_ok=True)
    mp.spawn(dp_rank, args=(init, batches, str(TRAIN_DIR / "dp_rank{}.json")),
             nprocs=RANKS, join=True)
    ranks = [json.loads(f.read_text()) for f in results]
    for f in results:
        f.unlink()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    summary = dict(arch=ARCH, params=630_167_424, ranks=RANKS,
                   global_batch_tokens=tokens, steps=DP_STEPS, lr=DP_LR,
                   momentum=DP_MOMENTUM,
                   first_batch_before=ranks[0]["first_batch_before"],
                   schemes={})
    for scheme in DP_SCHEMES:
        rs = [r["schemes"][scheme] for r in ranks]
        expect = expected_dp_launches(cfg, scheme)
        for r, res in zip(ranks, rs):
            print(f"rank {r['rank']} {scheme}: launches {res['launches']} "
                  f"(expected {expect})")
            require(res["launches"] == expect, f"{scheme}: launches do not "
                    "match the layer loop")
        require(all(res["losses"] == rs[0]["losses"] for res in rs),
                f"{scheme}: ranks report different losses")
        require(all(map(math.isfinite, rs[0]["losses"])),
                f"{scheme}: non-finite loss")
        wall = statistics.median(rs[0]["step_wall_ms"])
        row = dict(losses=rs[0]["losses"], step_wall_ms_median=wall,
                   tokens_per_s=tokens / (wall / 1e3),
                   wire_bytes_per_rank=rs[0]["wire_bytes"],
                   vel_dtypes=rs[0]["vel_dtypes"],
                   per_rank=[{k: res[k] for k in (
                       "step_wall_ms", "peak_gib", "forward_backward_ms",
                       "compressed_psum_ms", "quantizer_ms", "wire_ms")}
                       for res in rs],
                   step1=rs[0]["step1"])
        for key in ("first_batch_after", "error_feedback",
                    "err_same_on_every_rank"):
            if key in rs[0]:
                row[key] = [res[key] for res in rs] if key != \
                    "first_batch_after" else rs[0][key]
        summary["schemes"][scheme] = row
    none = summary["schemes"]["none"]
    print(f"compressed DP SGD, none: first batch {summary['first_batch_before']}"
          f" before the steps, {none['first_batch_after']} after")
    require(none["first_batch_after"] < summary["first_batch_before"],
            "none: the first batch's loss did not fall")
    int8 = [r["schemes"]["int8"]["launches"] for r in ranks]
    require(all(x["quantize_compress"] > 0 and x["matmul"] > 0
                and x["attention_backward"] > 0 for x in int8),
            "a kernel of the compressed DP path was never launched")
    print("dp_sgd " + json.dumps(summary), flush=True)
    return summary, {k: sum(x[k] for x in int8) for k in int8[0]}


# ---------------------------------------------------------------------------
# phase 8: the CLIs, as a user starts them
# ---------------------------------------------------------------------------

def cli(args, timeout: int):
    """``python -m <args>`` from the checkout's root with its ``src`` on
    the path; fails the phase on a non-zero exit.  Returns (stdout,
    seconds)."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *args], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    tail = "\n".join(r.stdout.strip().splitlines()[-8:])
    print(f"$ python -m {' '.join(args)}  ({dt:.1f} s, exit "
          f"{r.returncode})\n{tail}", flush=True)
    require(r.returncode == 0, f"{args[0]} failed:\n{r.stderr[-3000:]}")
    return r.stdout, dt


def read_jsonl(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# phase 8's train CLI: qwen2-0.5b cut by scale_config(..., 16) (2 layers,
# d_model 64, 2 heads of 32: the cuts by 2, 4 and 8 give head counts or
# widths the kernels refuse) since phase 15 came (at full width its three
# 8.8 GB saves took most of the phase; the whole script stays inside its
# time limit; phase 11 still runs the train CLI at full width)
CLI_TRAIN_DOWN = 16


def cli_phase(cfg):
    """Serve the phase-4 request shape through ``repro_torch.launch.serve``
    (the dense default) with ``--metrics``; train qwen2-0.5b cut by
    ``CLI_TRAIN_DOWN`` through ``repro_torch.launch.train`` (one rank, 2 x
    512 tokens, 4 steps, saves at step 2 and the final one) with
    ``--metrics``; resume a
    copy of the step-2 checkpoint with nothing left to train, so the
    state the session restored is saved again, and hold those files to
    the originals byte for byte (params, both moments, master, step).
    Everything lives in a temporary directory, removed at the end."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        out, serve_s = cli(
            ["repro_torch.launch.serve", "--arch", ARCH, "--scale-down", "1",
             "--requests", str(N_REQUESTS), "--batch-slots", str(SLOTS),
             "--max-seq", str(MAX_SEQ), "--prompt-len",
             f"{PROMPT_MIN}:{PROMPT_MAX}", "--new-tokens", str(NEW_TOKENS),
             "--metrics", str(tmp / "serve.jsonl")], timeout=400)
        snap = json.loads((tmp / "BENCH_serve_metrics.json").read_text())
        hist = snap["metrics"]["histograms"]
        kinds = {e["kind"] for e in read_jsonl(tmp / "serve.jsonl")}
        require(snap["meta"]["serve"]["paged"] is False
                and snap["meta"]["tokens"] == N_REQUESTS * (NEW_TOKENS - 1)
                and hist["serve.prefill_s"]["count"] == N_REQUESTS
                and hist["serve.decode_s"]["count"] > 0
                and hist["span.build_engine.s"]["count"] == 1
                and hist["span.serve.s"]["count"] == 1
                and kinds == {"span", "metrics"},
                "the serve CLI's snapshot or stream is not what it ran")
        serve_out = dict(
            seconds=serve_s, tok_per_s=snap["meta"]["tok_per_s"],
            prefill_p50_ms=1e3 * hist["serve.prefill_s"]["p50"],
            decode_p50_ms=1e3 * hist["serve.decode_s"]["p50"],
            decode_p99_ms=1e3 * hist["serve.decode_s"]["p99"])

        ck, ck2 = tmp / "ck", tmp / "ck2"
        train = ["repro_torch.launch.train", "--arch", ARCH,
                 "--scale-down", str(CLI_TRAIN_DOWN), "--batch", "2",
                 "--seq", "512", "--comms", "off"]
        out, train_s = cli(train + ["--steps", "4", "--ckpt-every", "2",
                                    "--ckpt-dir", str(ck), "--metrics",
                                    str(tmp / "train.jsonl")], timeout=400)
        save = re.search(r"checkpoint: step 4, (\d+) bytes in ([\d.]+) s",
                         out)
        snap = json.loads((tmp / "BENCH_step_metrics.json").read_text())
        hist = snap["metrics"]["histograms"]
        kinds = {e["kind"] for e in read_jsonl(tmp / "train.jsonl")}
        mgr_steps = sorted(int(d.name.split("_")[1])
                           for d in ck.glob("step_*"))
        require(save is not None and mgr_steps == [2, 4]
                and (ck / "LATEST").read_text() == "4"
                and hist["span.step.s"]["count"] == 3
                and all(hist[f"span.{k}.s"]["count"] == 1
                        for k in ("plan", "build_step", "step_warmup"))
                and snap["meta"]["kernel_launches"]
                == expected_train_launches(scale_config(cfg, CLI_TRAIN_DOWN),
                                           4, int8=False)
                and kinds == {"span", "plan_resolved", "metrics"},
                "the train CLI's checkpoints, snapshot or stream are not "
                "what it ran")
        ckpt_bytes, save_s = int(save.group(1)), float(save.group(2))
        shutil.rmtree(ck / "step_4")                 # room for the resume
        (ck2 / "step_2").mkdir(parents=True)
        for f in (ck / "step_2").iterdir():           # a copy, as links
            os.link(f, ck2 / "step_2" / f.name)
        (ck2 / "LATEST").write_text("2")
        out, resume_s = cli(train + ["--steps", "2", "--resume",
                                     "--ckpt-dir", str(ck2)], timeout=400)
        names = sorted(f.name for f in (ck / "step_2").iterdir())
        match, mismatch, errors = filecmp.cmpfiles(
            ck / "step_2", ck2 / "step_2", names, shallow=False)
        print(f"resume from step 2: {len(match)} of {len(names)} files "
              "saved again from the restored session equal the originals "
              f"byte for byte; differ: {mismatch + errors}")
        require("resumed from step 2" in out and len(match) == len(names)
                == 4 * 15 + 2, "the resumed state is not the saved one")
        train_out = dict(seconds=train_s, resume_seconds=resume_s,
                         step_p50_ms=1e3 * hist["span.step.s"]["p50"],
                         checkpoint_bytes=ckpt_bytes,
                         checkpoint_save_s=save_s,
                         checkpoint_files=len(names))
        print(f"checkpoint: {ckpt_bytes} bytes ({ckpt_bytes / 2**30:.2f} "
              f"GiB) saved in {save_s:.3f} s "
              f"({ckpt_bytes / save_s / 2**30:.2f} GiB/s)")
        result = dict(serve=serve_out, train=train_out)
        print("cli " + json.dumps(result), flush=True)
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: dMath's distributed linear algebra, four gloo ranks on the card
# ---------------------------------------------------------------------------

LINALG_RANKS, LINALG_MESH = 4, (2, 2)          # (data, model)
LINALG_PATH = "dmath linalg (4 ranks, gloo)"
QWEN_MLP = ((2048, 896, 4864), (2048, 4864, 896))   # up, down at 2,048 tokens
GEMMA_UP = (2048, 5376, 21504)                 # gemma3-27b's MLP up at 2,048
RELAYOUT_SHAPE = (4096, 4096)
ARCS_SHAPE = (4096, 4096)                      # AlexNet's FC width
# AlexNet conv2's channels and kernel, and a 3 x 3; the height cut from 27
# to 28 so that the model axis's 2 ranks divide it
CONV_X, CONV_KERNELS = (32, 28, 28, 96), ((5, 5, 96, 256), (3, 3, 96, 256))
LINALG_ALGS = ("local", "row_par", "col_par", "inner_psum", "inner_rs",
               "summa2d")
LINALG_IN = {"local": ("rep", "rep"), "row_par": ("row", "rep"),
             "col_par": ("rep", "col"), "inner_psum": ("col", "row"),
             "inner_rs": ("col", "row"), "summa2d": ("b2d", "b2d")}


def fp32_rule(got: torch.Tensor, want64: torch.Tensor, k: int):
    """The fp32 rule of ``tests/test_gemm_conformance.py`` (rtol 2e-5,
    atol 2e-5 at K = 64), its atol grown as the outputs' spread with K,
    sqrt(K / 64), against the float64 product: (holds, max abs err, the
    elements past the unscaled rule, which no fp32 order keeps at these
    K)."""
    err = (got.double() - want64).abs()
    tol = 2e-5 * want64.abs()
    ok = not bool((err > tol + 2e-5 * (k / 64) ** 0.5).any())
    return ok, float(err.max()), int((err > tol + 2e-5).sum())


def linalg_algorithm(name, a, b, mesh, policy):
    """One of the six GEMM algorithms on this rank's blocks."""
    from repro_torch.core import gemm as G
    from repro_torch.core import precision as P
    if name == "local":
        return P.matmul(a, b, policy)
    return {"row_par": G.gemm_row_parallel, "col_par": G.gemm_col_parallel,
            "inner_psum": G.gemm_inner_psum, "inner_rs": G.gemm_inner_rs,
            "summa2d": G.gemm_summa2d}[name](a, b, mesh, policy=policy)


def linalg_layouts():
    from repro_torch.core.layout import Layout
    return {"rep": Layout.replicated(2), "row": Layout.row_sharded(2),
            "col": Layout.col_sharded(2),
            "b2d": Layout.blocked_2d(("data", "model"))}


def move_kind(src, dst) -> str:
    """How ``relayout_explicit`` moves ``src`` to ``dst``: what the byte
    estimate models (``none``, ``slice``, ``gather``, ``all_to_all``) or
    ``gather_slice``, which it does not (it costs it as an all-to-all)."""
    if src == dst:
        return "none"
    if dst.is_replicated():
        return "gather"
    if src.is_replicated():
        return "slice"
    s, d = src.sharded_dims(), dst.sharded_dims()
    if (len(s) == 1 and len(d) == 1 and s != d
            and src.dims[s[0]] == dst.dims[d[0]]
            and isinstance(src.dims[s[0]], str)):
        return "all_to_all"
    return "gather_slice"


def plan_is_modeled(plan, la, lb, lout, c_dtype, dtype) -> bool:
    """True where the plan's every move is one the estimate models at the
    dtype it counts: no reduction (the reference reduces in fp32 and
    models a reduce-scatter at 1/n of its bytes), no gather-then-slice,
    and a C move only when C has the operands' dtype."""
    from repro_torch.core import gemm as G
    if plan.algorithm in ("inner_psum", "inner_rs"):
        return False
    moves = [move_kind(la, plan.a_relayout or la),
             move_kind(lb, plan.b_relayout or lb)]
    cur = G.native_layout(plan.algorithm)
    if lout is not None and cur != lout:
        if c_dtype != dtype:
            return False
        moves.append(move_kind(cur, lout))
    return "gather_slice" not in moves


class HeldProducts:
    """Wraps ``ops.matmul`` in a rank: every local product the linalg
    layer runs is held against its plain version on the same block (bf16
    operands: ``ref.matmul`` at phase 3's bf16 rule; fp32: the float64
    product at :func:`fp32_rule`), except while ``timed`` (the timed
    repeats of a product held once).  The plain products launch nothing."""

    def __init__(self):
        self.kernel, self.errs = ops.matmul, {}
        self.count = self.held = 0
        self.timed = False

    def __call__(self, a, b, out_dtype=None):
        c = self.kernel(a, b, out_dtype)
        self.count += 1
        if self.timed:
            return c
        self.held += 1
        if a.dtype == torch.float32:
            ok, err, _ = fp32_rule(c, a.double() @ b.double(), a.shape[1])
            require(ok, f"local product {tuple(a.shape)} @ {tuple(b.shape)} "
                    f"fp32: outside the fp32 rule (max err {err:.3g})")
        else:
            err = max_err(c, ref.matmul(a, b, out_dtype),
                          f"local product {tuple(a.shape)} @ "
                          f"{tuple(b.shape)}")
        key = "fp32" if a.dtype == torch.float32 else "bf16"
        self.errs[key] = max(self.errs.get(key, 0.0), err)
        return c


def linalg_sweep(mesh, L, out):
    """qwen2-0.5b's MLP products at 2,048 tokens, bf16 under MIXED and
    fp32 under FULL, through the six algorithms and ``gemm_auto`` over 4 x
    4 operand layouts x 5 out layouts; every C gathered and held against
    the plain product of the global operands; the wire bytes of every
    plan whose moves the estimate models equal to its ``est_bytes``.
    Returns the local products run."""
    from repro_torch.core import gemm as G
    from repro_torch.core import precision as P
    from repro_torch.core.distributed import WIRE
    from repro_torch.core.redistribute import relayout_explicit
    products, res = 0, {}
    rep = L["rep"]
    for (m, k, n), (pname, dtype) in itertools.product(
            QWEN_MLP, (("MIXED", torch.bfloat16), ("FULL", torch.float32))):
        policy = getattr(P, pname)
        a = randn((m, k), SEED + 90, dtype=dtype)
        b = randn((k, n), SEED + 91, dtype=dtype)
        if dtype == torch.float32:
            want = a.double() @ b.double()
        else:
            want = ref.matmul(a, b, torch.float32)
        worst, unscaled, modeled = 0.0, 0, 0

        def hold(c, lay, what):
            nonlocal worst, unscaled
            full = relayout_explicit(c, lay, rep, mesh)
            require(full.shape == (m, n) and full.dtype == torch.float32,
                    f"{what}: C {tuple(full.shape)} {full.dtype}")
            if dtype == torch.float32:
                ok, err, past = fp32_rule(full, want, k)
                require(ok, f"{what}: outside the fp32 rule ({err:.3g})")
                unscaled += past
            else:
                err = max_err(full, want, what)
            worst = max(worst, err)

        for alg in LINALG_ALGS:
            la, lb = (L[x] for x in LINALG_IN[alg])
            c = linalg_algorithm(alg, la.block(a, mesh), lb.block(b, mesh),
                                 mesh, policy)
            products += 1
            hold(c, G.native_layout(alg), f"{alg} {pname} {(m, k, n)}")
        for la, lb, lo in itertools.product(L, L, (None, *L)):
            lout = None if lo is None else L[lo]
            ab, bb = L[la].block(a, mesh), L[lb].block(b, mesh)
            WIRE.reset()
            c, plan = G.gemm_auto(ab, bb, L[la], L[lb], mesh,
                                  out_layout=lout, policy=policy)
            moved = WIRE.total()
            products += 1
            if plan_is_modeled(plan, L[la], L[lb], lout, c.dtype, dtype):
                modeled += 1
                require(moved == plan.est_bytes,
                        f"gemm_auto {la} x {lb} -> {lo} {pname}: "
                        f"{moved} bytes on the wire, the plan estimates "
                        f"{plan.est_bytes} ({plan.describe()})")
            hold(c, lout or plan.out_layout,
                 f"gemm_auto {la} x {lb} -> {lo} {pname} {(m, k, n)}")
        res[f"{pname} {m}x{k}x{n}"] = dict(
            max_abs_err=worst, plans_bytes_equal_estimate=modeled,
            **({"elements_past_unscaled_fp32_rule": unscaled}
               if dtype == torch.float32 else {}))
        del a, b, want
    out["sweep"] = res
    return products


def linalg_full_width(mesh, L, out, held):
    """gemma3-27b's MLP up-projection at 2,048 tokens, bf16: each
    algorithm from its own layouts, then ``gemm_auto`` from col x row,
    once held (this rank's C block against the plain product's, its
    local product against ``ref.matmul``, the bytes it handed to
    collectives beside the plan's estimate), then three times timed (wall
    ms per call, the median of 3, each ended by a synchronize).  Returns
    the local products run."""
    import torch.distributed as dist
    from repro_torch.core import gemm as G
    from repro_torch.core import precision as P
    from repro_torch.core.distributed import WIRE
    m, k, n = GEMMA_UP
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a = randn((m, k), SEED + 92)
    b = randn((k, n), SEED + 93, scale=0.02)
    want = ref.matmul(a, b, torch.float32)
    rows, products = {}, 0
    runs = [(alg, LINALG_IN[alg]) for alg in LINALG_ALGS] \
        + [("gemm_auto", ("col", "row"))]
    for name, (la, lb) in runs:
        ab, bb = L[la].block(a, mesh), L[lb].block(b, mesh)
        walls = []
        for i in range(4):
            held.timed = i > 0
            dist.barrier()
            WIRE.reset()
            t0 = time.perf_counter()
            if name == "gemm_auto":
                c, plan = G.gemm_auto(ab, bb, L[la], L[lb], mesh)
            else:
                c = linalg_algorithm(name, ab, bb, mesh, P.MIXED)
            torch.cuda.synchronize()
            products += 1
            if i == 0:
                moved = dict(WIRE.bytes)
                first = c
            else:
                walls.append(1e3 * (time.perf_counter() - t0))
                require(same_bits(c, first), f"{name}: a repeat changed "
                        "bits")
        held.timed = False
        if name != "gemm_auto":
            plan = next(p for p in G.gemm_candidates(
                (m, k), (k, n), a.dtype, L[la], L[lb], mesh,
                G.native_layout(name)) if p.algorithm == name)
        lay = G.native_layout(plan.algorithm)
        err = max_err(c, lay.block(want, mesh), f"{name} at {GEMMA_UP}")
        total = sum(moved.values())
        modeled = plan.algorithm not in ("inner_psum", "inner_rs")
        if modeled:
            require(total == plan.est_bytes,
                    f"{name}: {total} bytes on the wire, the plan estimates "
                    f"{plan.est_bytes}")
        rows[name] = dict(plan=plan.algorithm, wall_ms=walls,
                          wall_ms_median=statistics.median(walls),
                          bytes_by_collective=moved, bytes=total,
                          est_bytes=plan.est_bytes,
                          bytes_equal_estimate=modeled,
                          max_abs_err=err)
        del ab, bb, c, first
    out["full_width"] = dict(shape=list(GEMMA_UP), runs=rows,
                             peak_gib=torch.cuda.max_memory_allocated()
                             / 2**30)
    del a, b, want
    torch.cuda.empty_cache()
    return products


def linalg_relayouts(mesh, L, out):
    """Every pair of {rep, row, col, b2d} at (4096, 4096), fp32 -> bf16
    and bf16 -> fp32: only bf16 on the wire, the bytes of every modeled
    move equal to the estimate at bf16, and the block bitwise the local
    cast of the whole input."""
    from repro_torch.core.distributed import WIRE
    from repro_torch.core.redistribute import (collective_bytes_estimate,
                                               relayout_explicit)
    x32 = randn(RELAYOUT_SHAPE, SEED + 94, dtype=torch.float32)
    x16 = randn(RELAYOUT_SHAPE, SEED + 95)
    res = dict(pairs=0, bytes=0)
    for (src, dst), (x, to) in itertools.product(
            itertools.product(L, L), ((x32, torch.bfloat16),
                                      (x16, torch.float32))):
        WIRE.reset()
        y = relayout_explicit(L[src].block(x, mesh), L[src], L[dst], mesh,
                              dtype=to)
        kind = move_kind(L[src], L[dst])
        wire = WIRE.dtypes
        require(wire == (set() if kind in ("none", "slice")
                         else {torch.bfloat16}),
                f"relayout {src} -> {dst} to {to}: {wire} on the wire")
        if kind != "gather_slice":
            est = collective_bytes_estimate(RELAYOUT_SHAPE, torch.bfloat16,
                                            L[src], L[dst], mesh)
            require(WIRE.total() == est,
                    f"relayout {src} -> {dst}: {WIRE.total()} bytes, "
                    f"estimate {est}")
        require(same_bits(y, L[dst].block(x.to(to), mesh)),
                f"relayout {src} -> {dst} to {to}: not the local cast")
        res["pairs"] += 1
        res["bytes"] += WIRE.total()
    out["relayouts"] = res


def linalg_primitives(mesh, L, out):
    """``add_row_col_sum_matrix`` at 4096 x 4096 in both modes against the
    float64 sums (``tests/test_primitives.py``'s tolerances), the
    deterministic mode bitwise run to run; ``conv2d_halo`` at AlexNet
    conv2's channels (unit-variance outputs) against the unsharded fp32
    conv on one rank and the float64 conv (its 2e-4: TF32 would not keep
    it)."""
    import torch.nn.functional as F
    from repro_torch.core.layout import Layout
    from repro_torch.core.primitives import (add_row_col_sum_matrix,
                                             conv2d_halo, local_conv)
    res = {}
    mm = randn(ARCS_SHAPE, SEED + 96, dtype=torch.float32)
    m64 = mm.double()
    want = L["row"].block(m64 + 0.5 * m64.sum(1, keepdim=True)
                          + 0.25 * m64.sum(0, keepdim=True), mesh)
    blk = L["row"].block(mm, mesh)
    for det, tol in ((True, 1e-5), (False, 5e-2)):
        got = add_row_col_sum_matrix(blk, 0.5, 0.25, mesh=mesh,
                                     deterministic=det)
        err = (got.double() - want).abs()
        require(not bool((err > tol * 10 + tol * want.abs()).any()),
                f"add_row_col_sum_matrix (deterministic={det}): max err "
                f"{float(err.max()):.3g}")
        if det:
            again = add_row_col_sum_matrix(blk, 0.5, 0.25, mesh=mesh,
                                           deterministic=True)
            require(same_bits(got, again), "add_row_col_sum_matrix: the "
                    "deterministic mode changed bits run to run")
        res[f"arcs_{'deterministic' if det else 'fast'}_max_abs_err"] = \
            float(err.max())
    x = randn(CONV_X, SEED + 97, dtype=torch.float32)
    xl = Layout(("data", "model", None, None))
    for kh, kw, cin, cout in CONV_KERNELS:
        w = randn((kh, kw, cin, cout), SEED + 98, dtype=torch.float32,
                  scale=(kh * kw * cin) ** -0.5)
        got = conv2d_halo(xl.block(x, mesh), w, mesh=mesh)
        full = local_conv(F.pad(x, (0, 0, 0, 0, kh // 2, kh // 2)), w)
        exact = F.conv2d(x.double().permute(0, 3, 1, 2),
                         w.double().permute(3, 2, 0, 1),
                         padding=(kh // 2, kw // 2)).permute(0, 2, 3, 1)
        for what, ref_conv in (("unsharded fp32", full), ("float64", exact)):
            want = xl.block(ref_conv, mesh)
            err = (got.double() - want).abs()
            require(not bool((err > 2e-4 + 2e-4 * want.abs()).any()),
                    f"conv2d_halo {kh}x{kw} against the {what} conv: max "
                    f"err {float(err.max()):.3g}")
            res[f"conv_{kh}x{kw}_vs_{what.split()[-1]}_max_abs_err"] = \
                float(err.max())
    out["primitives"] = res


def linalg_dtensor(mesh, L, out):
    """``Session.tensor``, ``@``, ``+``, ``with_layout``, ``to_global``, the
    session's table, and a second ``gemm_auto`` of the same shapes an
    op-cache hit.  Returns the local products run."""
    import torch.distributed as dist
    from repro_torch.api import Session
    from repro_torch.core import REGISTRY
    from repro_torch.core.opcache import GLOBAL_CACHE
    m, k, n = QWEN_MLP[0]
    a = randn((m, k), SEED + 99)
    b = randn((k, n), SEED + 100)
    sess = Session(group=dist.group.WORLD, mesh=mesh)
    before = len(REGISTRY)
    X = sess.tensor(a, L["row"], name="X")
    W = sess.tensor(b, L["col"], name="W")
    Y = X @ W
    misses = GLOBAL_CACHE.stats()["gemm_auto"].misses
    hits = GLOBAL_CACHE.stats()["gemm_auto"].hits
    Y2 = X @ W
    st = GLOBAL_CACHE.stats()["gemm_auto"]
    require(st.hits == hits + 1 and st.misses == misses,
            "a second gemm_auto of the same shapes was not an op-cache hit")
    Z = (Y + Y2).with_layout(L["b2d"], dtype=torch.bfloat16)
    full = Z.to_global()
    err = max_err(full, (2 * ref.matmul(a, b, torch.float32)).to(
        torch.bfloat16), "DistTensor (X @ W + X @ W)")
    names = sorted(sess.tensors.layouts())
    need = {"X", "W", "(X@W)", f"{Z.name}", f"{Z.name}@L[-, -]"}
    require(need <= set(names) and len(REGISTRY) == before,
            f"DistTensor names {names}: the session's table must hold "
            "them and the global one none")
    out["dtensor"] = dict(names=names, max_abs_err=err,
                          plan=repr(Y.layout), z=repr(Z))
    return 2


def linalg_rank(rank, init, result_path):
    """One rank of phase 9; writes its results as JSON to ``result_path``
    with the rank's number in place of ``{}``."""
    import torch.distributed as dist
    from repro_torch.core.distributed import Mesh, close_group, init_group
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_group(init, rank=rank, world_size=LINALG_RANKS)
    mesh = Mesh(LINALG_MESH, ("data", "model"), dist.group.WORLD)
    L = linalg_layouts()
    held = HeldProducts()
    ops.matmul = held
    out = dict(rank=rank, coords=mesh.coords, seconds={})
    dist.barrier()
    ops.reset_launches()
    expected = 0
    for name, part in (("sweep", linalg_sweep),
                       ("full_width", lambda *a: linalg_full_width(*a, held)),
                       ("relayouts", linalg_relayouts),
                       ("primitives", linalg_primitives),
                       ("dtensor", linalg_dtensor)):
        t0 = time.perf_counter()
        expected += part(mesh, L, out) or 0
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
    out["launches"] = ops.dispatch_report()
    out["expected_matmul"] = expected
    out["products"], out["held_products"] = held.count, held.held
    out["held_max_abs_err"] = held.errs
    ops.matmul = held.kernel
    # the local GEMMs' device time on rank 0, the others at a barrier
    m, k, n = GEMMA_UP
    shapes = {"local": (m, k, n), "row_par": (m // 2, k, n),
              "col_par": (m, k, n // 2), "inner": (m, k // 2, n),
              "summa2d": (m // 2, k, n // 2)}
    times = {}
    dist.barrier()
    if rank == 0:
        for name, (mm, kk, nn) in shapes.items():
            x = randn((mm, kk), SEED + 101)
            y = randn((kk, nn), SEED + 102)
            times[name] = dict(
                shape=[mm, kk, nn],
                ms=cuda_ms([lambda: ops.matmul(x, y, torch.float32)], 10),
                torch_matmul_ms=cuda_ms([lambda: torch.matmul(x, y)], 10))
            del x, y
    dist.barrier()
    out["local_gemm_ms"] = times
    Path(result_path.format(rank)).write_text(json.dumps(out))
    dist.barrier()
    close_group()


def linalg_phase():
    """Phase 9: four ranks spawned on the one card over gloo, mesh (data=2,
    model=2); returns the summary and the ranks' launch counts summed."""
    import torch.multiprocessing as mp
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    init = f"file://{TRAIN_DIR / 'rendezvous_linalg'}"
    (TRAIN_DIR / "rendezvous_linalg").unlink(missing_ok=True)
    results = [TRAIN_DIR / f"linalg_rank{r}.json"
               for r in range(LINALG_RANKS)]
    for f in results:
        f.unlink(missing_ok=True)
    mp.spawn(linalg_rank,
             args=(init, str(TRAIN_DIR / "linalg_rank{}.json")),
             nprocs=LINALG_RANKS, join=True)
    ranks = [json.loads(f.read_text()) for f in results]
    for f in results:
        f.unlink()
    for r in ranks:
        print(f"rank {r['rank']} {r['coords']}: launches {r['launches']} "
              f"(matmul expected {r['expected_matmul']}, held "
              f"{r['held_products']} of {r['products']}); seconds "
              f"{r['seconds']}")
        require(r["launches"]["matmul"] == r["expected_matmul"]
                == r["products"],
                "linalg: matmul launches do not match the plans' local "
                "products")
        require(all(v == 0 for op, v in r["launches"].items()
                    if op != "matmul"), "linalg: a kernel other than the "
                "GEMM was launched")
    r0 = ranks[0]
    summary = dict(mesh=dict(zip(("data", "model"), LINALG_MESH)),
                   ranks=LINALG_RANKS, backend="gloo (host memory), one card",
                   sweep=r0["sweep"], full_width=r0["full_width"],
                   full_width_wall_ms_median_by_rank=[
                       {k: v["wall_ms_median"] for k, v in
                        r["full_width"]["runs"].items()} for r in ranks],
                   full_width_bytes_by_rank=[
                       {k: v["bytes"] for k, v in
                        r["full_width"]["runs"].items()} for r in ranks],
                   peak_gib_by_rank=[r["full_width"]["peak_gib"]
                                     for r in ranks],
                   local_gemm_ms=r0["local_gemm_ms"],
                   relayouts=r0["relayouts"], primitives=r0["primitives"],
                   dtensor=r0["dtensor"],
                   held_max_abs_err=r0["held_max_abs_err"],
                   seconds=r0["seconds"],
                   matmul_launches_by_rank=[r["launches"]["matmul"]
                                            for r in ranks])
    print("dmath " + json.dumps(summary), flush=True)
    return summary, {k: sum(r["launches"][k] for r in ranks)
                     for k in r0["launches"]}


# ---------------------------------------------------------------------------
# phase 10: hybrid data x tensor/sequence parallel training, four ranks
# ---------------------------------------------------------------------------

HYBRID_RANKS = 4
# (mesh (data, model), the plan's attention mode, steps).  Every step
# starts from the one-rank yardstick's state before it (a rank restarts
# from its blocks of the yardstick's state after each step), so each
# step's loss and grad norm differ from the yardstick's by that step's
# sums (their order, and the shares' bf16 roundings on the wire) alone,
# and are held at rtol 1e-3.  Step 1 runs the plain checks, step 2 gives
# the step wall, step 3 is timed with the collectives clocked
# (``CollectiveClock`` synchronizes the card before each).  Three steps,
# not four: the whole script stays inside its time limit.
HYBRID = (((2, 2), "head_tp", 3), ((1, 4), "sp", 3))
# qwen2-0.5b's depth in phase 10: 12 of its 24 layers since phase 14 came
# (the whole script stays inside its time limit; at 8 layers the mesh's
# reordered sums moved one rank's nu of the embedding past the moment
# gate, ROADMAP queue 3)
HYBRID_LAYERS = 12
# mamba2-780m at full width, cut to 8 of its 48 layers, on (2, 2) with the
# sequence-parallel residual (the reference's forward_shardmap): (mesh,
# layers, steps), held against the same cut's one-rank steps
HYBRID_MAMBA = ((2, 2), 8, 2)
HYBRID_PATH = (f"{ARCH} (2,2), (1,4) ({HYBRID_LAYERS} layers) and {MAMBA} "
               "(2,2, 8 layers) hybrid train (4 ranks, gloo)")
HYBRID_DEVICE = "cuda"
HYBRID_CLOCKED = 2                     # the step (from 0) whose wire is timed


def hybrid_yard(t: int, name: str = "") -> Path:
    """The yardstick's state after step ``t`` (from 1); ``name`` tells
    mamba2's from qwen2's."""
    return TRAIN_DIR / f"hybrid_yardstick{name}{t}.pt"


def hybrid_qwen2():
    """qwen2-0.5b at full width, cut to ``HYBRID_LAYERS``: phase 10's cells
    and phase 11's memory verdict for them."""
    import dataclasses
    return dataclasses.replace(get_config(ARCH), n_layers=HYBRID_LAYERS)


def hybrid_cells():
    """Phase 10's cells: (tag, config, mesh, the plan's attention mode,
    steps, the yardstick's name)."""
    import dataclasses
    shape, layers, steps = HYBRID_MAMBA
    mcfg = dataclasses.replace(get_config(MAMBA), n_layers=layers)
    return ([(f"{s[0]}x{s[1]}", hybrid_qwen2(), s, mode, n, "")
             for s, mode, n in HYBRID]
            + [(f"{MAMBA} {shape[0]}x{shape[1]}", mcfg, shape, "none", steps,
                "_mamba2")])


def hybrid_session(shape, cfg):
    """A Session on ``shape`` over the default group, and its train plan
    (the gspmd path on the mesh)."""
    import torch.distributed as dist
    from repro_torch.api import Session
    from repro_torch.core.distributed import Mesh
    mesh = Mesh(shape, ("data", "model"), dist.group.WORLD)
    sess = Session(device=HYBRID_DEVICE, group=dist.group.WORLD, mesh=mesh)
    plan = sess.plan(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, comms="off",
                     adamw=train_adamw(), microbatches=1)
    return sess, plan, mesh


class HeldKernels:
    """Wraps ``ops.matmul``, ``ops.attention``, ``ops.ssd`` and the SSD
    backward in a rank: the first call of each distinct case (shapes,
    dtypes, the flash arguments) is held against its plain version on the
    same inputs (phase 3's rule; the SSD's SSD_TOL, of each output's
    largest magnitude for the backward); the GEMM and flash cases are kept
    for the backward checks.  The plain versions launch nothing."""

    def __init__(self):
        self.mm, self.att = ops.matmul, ops.attention
        self.ssd, self.ssd_bwd = ops.ssd, ssd_mod.ssd_backward
        self.mm_cases, self.att_cases = {}, {}
        self.ssd_cases, self.ssd_bwd_cases = {}, {}
        self.calls = {"matmul": 0, "attention": 0, "ssd": 0}

    def install(self):
        ops.matmul, ops.attention = self.matmul, self.attention
        ops.ssd, ssd_mod.ssd_backward = self.ssd_forward, self.ssd_backward

    def uninstall(self):
        ops.matmul, ops.attention = self.mm, self.att
        ops.ssd, ssd_mod.ssd_backward = self.ssd, self.ssd_bwd

    def ssd_forward(self, x, dt, A, Bm, C, **kw):
        self.calls["ssd"] += 1
        y, state = self.ssd(x, dt, A, Bm, C, **kw)
        key = (tuple(x.shape), tuple(Bm.shape), str(x.dtype))
        if key not in self.ssd_cases:
            with torch.no_grad():
                want = ssd_mod.ssd_plain(
                    *(t.detach() for t in (x, dt, A, Bm, C)),
                    init_state=kw.get("init_state"))
            self.ssd_cases[key] = max(ssd_close(
                f"hybrid {key}", (y.detach(), state.detach()), want,
                SSD_TOL[x.dtype]))
        return y, state

    def ssd_backward(self, x, dt, A, Bm, C, *args, **kw):
        key = (tuple(x.shape), tuple(Bm.shape), str(x.dtype))
        if key in self.ssd_bwd_cases:
            return self.ssd_bwd(x, dt, A, Bm, C, *args, **kw)
        got, self.ssd_bwd_cases[key] = held_ssd_backward_call(
            self.ssd_bwd, "hybrid", x, dt, A, Bm, C, *args, **kw)
        return got

    def matmul(self, a, b, out_dtype=None):
        # counted before the call: under remat the recompute stops inside
        # a layer's last product, after its launch (torch.utils.checkpoint)
        self.calls["matmul"] += 1
        c = self.mm(a, b, out_dtype)
        key = (tuple(a.shape), tuple(b.shape), str(a.dtype),
               str(out_dtype or a.dtype))
        if key not in self.mm_cases:
            with torch.no_grad():
                self.mm_cases[key] = max_err(
                    c.detach(), ref.matmul(a.detach(), b.detach(), out_dtype),
                    f"hybrid local product {key}")
        return c

    def attention(self, q, k, v, **kw):
        self.calls["attention"] += 1
        out = self.att(q, k, v, **kw)
        key = (tuple(q.shape), tuple(k.shape),
               tuple(sorted((n, x) for n, x in kw.items())))
        if key not in self.att_cases:
            with torch.no_grad():
                want = ref.attention(q.detach(), k.detach(), v.detach(), **kw)
            self.att_cases[key] = max_err(out.detach(), want,
                                          f"hybrid flash {key}")
        return out

    def backward_checks(self):
        """dA and dB of every distinct forward product (the cotangent in
        fp32 for an fp32 result), and the flash backward of every distinct
        case, on random inputs of the case's shapes, against the plain
        backward: (GEMM max abs err, flash max abs err)."""
        mm_err = att_err = 0.0
        for i, (sa, sb, _, od) in enumerate(self.mm_cases):
            a, b = randn(sa, 2100 + i), randn(sb, 2200 + i, 0.05)
            out = getattr(torch, od.split(".")[1])
            dc = randn((sa[0], sb[1]), 2300 + i, dtype=out)
            leaves = [a.clone().requires_grad_(True),
                      b.clone().requires_grad_(True)]
            got = torch.autograd.grad(self.mm(*leaves, out), leaves, dc)
            g = dc.to(torch.bfloat16)      # the kernel's backward operand
            want = (ref.matmul(g, b.t(), torch.bfloat16),
                    ref.matmul(a.t(), g, torch.bfloat16))
            mm_err = max(mm_err, grads_close(
                got, want, f"hybrid product backward {sa} @ {sb}"))
        for i, (sq, sk, kw) in enumerate(self.att_cases):
            B, hq, S, D = sq
            q, k, v, d_out = bwd_inputs(2400 + 4 * i, B, hq, sk[1], S, sk[2],
                                        D)
            kw = dict(kw)
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            got = torch.autograd.grad(self.att(*leaves, **kw), leaves, d_out)
            want = ref.attention_backward(q, k, v, d_out, **kw)
            att_err = max(att_err, grads_close(
                got, want, f"hybrid flash backward {sq} x {sk} {kw}"))
        return mm_err, att_err


class CollectiveClock:
    """Host seconds inside the counted collectives of
    ``repro_torch.core.distributed`` (the outermost call only; the card is
    synchronized first, so a collective's time does not include the
    kernels queued before it): the wire's share of a step."""

    NAMES = ("all_gather", "all_to_all", "psum", "psum_scatter", "pmax")

    def __init__(self):
        from repro_torch.core import distributed as D
        self.D, self.saved, self.seconds, self.depth = D, {}, 0.0, 0

    def _timed(self, fn):
        def call(*a, **k):
            if self.depth:
                return fn(*a, **k)
            if HYBRID_DEVICE == "cuda":
                torch.cuda.synchronize()
            self.depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds += time.perf_counter() - t0
                self.depth -= 1
        return call

    def __enter__(self):
        for n in self.NAMES:
            self.saved[n] = getattr(self.D, n)
            setattr(self.D, n, self._timed(self.saved[n]))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.D, n, fn)


def hybrid_wire_estimate(model, mesh, batch: int, seq: int):
    """Bytes one rank receives in one step, by collective, from the
    layouts (``WIRE``'s accounting: an all-gather of a block receives the
    other ranks' blocks; a reduce-scatter, an all-to-all of the pieces,
    (n - 1)/n of the tensor; a floating sum over n > 2 ranks gathers the
    line's tensors, over 2 one tensor).  Per layer the forward, its
    recompute under ``remat="full"`` (which stops after the last product
    whose inputs the backward keeps: the MLP's and the mamba2 mixer's
    reduce-scatters are not run again) and the backward (each
    collective's transpose); the embedding's
    all-to-all and the head's gather, each with its transpose; the loss's
    max and sums over the model axis; the gradient sync onto the ZeRO
    blocks and the parameters' gather back, in each leaf's type (bf16;
    mamba2's A, dt bias and D skip fp32); the grad norm's sum."""
    import collections
    from repro_torch.core.replication import zero_layout
    cfg, plan = model.cfg, model.plan
    tp, nd = mesh.shape["model"], mesh.shape["data"]
    b = batch // nd if model.rows_split(batch) else batch
    act = b * seq * cfg.d_model * 2                   # bf16, whole sequence
    est = collections.Counter()

    def ag(block, n):
        est["all_gather"] += (n - 1) * block

    def rs(full, n):
        est["all_to_all"] += (n - 1) * full // n

    def ps(nbytes, n):
        est["all_reduce"] += ((n - 1) * nbytes if n > 2
                              else nbytes if n == 2 else 0)

    L = cfg.n_layers
    if tp > 1:
        if cfg.family == "ssm":
            # the mixer (SP): gather the sequence, reduce-scatter back
            # (the recompute stops inside the last product, before it);
            # the gated norm's fp32 sum of squares in the forward, the
            # recompute and its copy's transpose
            for _ in range(L):
                for _ in range(3):              # fwd, remat, the bwd's
                    ag(act // tp, tp)
                for _ in range(2):              # fwd, the gather's bwd
                    rs(act, tp)
                for _ in range(3):
                    ps(b * seq * 4, tp)
        elif plan.attn_mode == "head_tp":
            # attention and MLP: gather the sequence, reduce-scatter back;
            # the recompute runs all but the MLP's reduce-scatter
            for _ in range(L):
                for _ in range(3 * 2):          # fwd, remat, bwd x 2 gathers
                    ag(act // tp, tp)
                for _ in range(3 * 2 - 1):      # the same reduce-scatters
                    rs(act, tp)
        else:
            kv = b * (seq // tp) * cfg.n_kv_heads * cfg.d_head * 2
            for _ in range(L):
                for _ in range(2 * 2):          # K and V: fwd and remat
                    ag(kv, tp)
                for _ in range(2):              # their transposes
                    rs(kv * tp, tp)
        rs(act // tp, tp)                       # embed all-to-all + back
        rs(act // tp, tp)
        ag(act // tp, tp)                       # the head's gather
        rs(act, tp)                             # and its transpose
        ag(b * seq * 4, tp)                     # the loss's max
        ps(b * seq * 4, tp)                     # sum of exps
        ps(b * seq * 4, tp)                     # gold logit
    if model.rows_split(batch):
        ps(4, nd)                               # the token count
        ps(4, nd)                               # the loss
    specs = model.param_specs()
    for name, spec in specs.items():
        storage = spec.layout
        zero = zero_layout(storage, spec.shape, mesh)
        size = spec.dtype.itemsize          # bf16, the mixer's fp32 leaves
        block = math.prod(storage.local_shape(spec.shape, mesh)) * size
        for a in model.grad_split_axes(name, batch):
            n = mesh.shape[a]
            if n == 1 or a in storage.mesh_axes_used():
                continue
            if a in zero.mesh_axes_used():
                rs(block, n)
                block //= n
            else:
                ps(block, n)
        zblock = math.prod(zero.local_shape(spec.shape, mesh)) * size
        for a in reversed([a for a in zero.mesh_axes_used()
                           if a not in storage.mesh_axes_used()]):
            ag(zblock, mesh.shape[a])
            zblock *= mesh.shape[a]
    for a in ("data", "model"):                 # the grad norm's sum
        ps(4 * len(specs), mesh.shape[a])
    return dict(est)


def yard_state(opt_state) -> dict:
    """A yardstick's AdamW state as saved for the ranks: the step, the
    fp32 master and moments on the CPU, and each moment leaf's largest
    magnitude (the gradient rule's atol scale, so that a rank need not
    scan the whole leaf)."""
    return {"step": int(opt_state["step"]),
            **{slot: {k: v.cpu() for k, v in opt_state[slot].items()}
               for slot in ("master", "mu", "nu")},
            "absmax": {slot: {k: float(v.abs().max())
                              for k, v in opt_state[slot].items()}
                       for slot in ("mu", "nu")}}


def hybrid_one_rank(cfg, batches, steps, keep=False, name="",
                    on_mesh=False):
    """``steps`` one-rank steps on the card (path gspmd, no mesh) from the
    seed: their metrics; with ``keep``, the state after each step but the
    last goes to :func:`hybrid_yard` under ``name`` (the fp32 master, from
    which the step wrote the params, and the moments).  ``on_mesh`` puts
    the one-rank model on a (1, 1) mesh (no process group: every axis has
    one rank), where it runs the mesh's code path: for mamba2 the
    sequence-parallel mixer's bf16 convolutions and scan inputs, the
    reference's one-device default (``forward_shardmap``), where the model
    without a mesh runs ``ssm.forward``'s fp32 ones."""
    import dataclasses
    from repro_torch.api import Session
    from repro_torch.core.distributed import Mesh
    from repro_torch.core.planner import plan_for
    sess = Session(device=HYBRID_DEVICE)
    plan = sess.plan(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, comms="off",
                     adamw=train_adamw(), microbatches=1)
    require(plan.path == "gspmd" and plan.model.mesh is None,
            "the yardstick is the one-rank path")
    if on_mesh:
        one = Mesh((1, 1), ("data", "model"))
        plan = dataclasses.replace(plan, model=Model(
            plan.cfg, device=HYBRID_DEVICE, mesh=one,
            plan=plan_for(plan.cfg, one)))
    sess.init_state(plan, seed=SEED)
    metrics = []
    for t in range(steps):
        m = sess.step(plan, batches[t])
        metrics.append({k: float(v) for k, v in m.items()})
        if keep and t + 1 < steps:
            opt_state = sess.state["train_state"]["opt"]
            TRAIN_DIR.mkdir(parents=True, exist_ok=True)
            torch.save(yard_state(opt_state), hybrid_yard(t + 1, name))
    del sess, plan
    torch.cuda.empty_cache()
    return metrics


def hybrid_yardstick(cfg, batches):
    """The one-rank yardstick from the seed and batches the ranks use: its
    metrics for every step, its state after each step but the last saved
    for the ranks.  Then a witness: the same steps with every batch's rows
    reversed (the same loss and gradients, summed in another order); its
    relative distance from the yardstick at each step is what the sums'
    order alone moves on one rank, free running (not a gate).  mamba2's
    cut gets a yardstick of its own, and a witness: the same steps without
    a mesh, whose mixer keeps fp32 where the yardstick's rounds to bf16.
    The witness's first update differs from the yardstick's by an rms
    (the step rule's third reading) that is what placing the bf16
    roundings moves there; the mesh places them otherwise again (each
    rank's shares of a gradient rounded before their sum), so the cell's
    mesh is held at twice that, and never tighter than the rule's 10%
    (the first AdamW update is a sign, and the gradients of mamba2's
    small leaves cross zero within their bf16 noise).  Returns the
    yardsticks' metrics by cell, qwen2's drift and the rms bounds."""
    steps = max(n for _, _, n in HYBRID)
    metrics = hybrid_one_rank(cfg, batches, steps, keep=True)
    flipped = [{k: np.ascontiguousarray(np.asarray(v)[::-1])
                for k, v in b.items()} for b in batches]
    witness = hybrid_one_rank(cfg, flipped, steps)
    drift = [{k: abs(w[k] / y[k] - 1) for k in ("loss", "grad_norm")}
             for w, y in zip(witness, metrics)]
    print(f"hybrid yardstick (one rank): {metrics}", flush=True)
    print(f"hybrid one-rank witness, rows reversed, free running: relative "
          f"distance {drift}", flush=True)
    yards = {tag: metrics for tag, *_ in hybrid_cells()[:len(HYBRID)]}
    tag, mcfg, _, _, msteps, name = hybrid_cells()[-1]
    mbatches = train_batches(mcfg)
    yards[tag] = hybrid_one_rank(mcfg, mbatches, msteps, keep=True,
                                 name=name, on_mesh=True)
    fp32 = hybrid_one_rank(mcfg, mbatches, msteps, keep=True,
                           name=name + "_fp32")
    witness_rms = hybrid_update_rms(mcfg, name, yards[tag][0]["lr"])
    gap = [{k: abs(w[k] / y[k] - 1) for k in ("loss", "grad_norm")}
           for w, y in zip(fp32, yards[tag])]
    print(f"hybrid yardstick, {tag} ({mcfg.n_layers} layers, one rank on "
          f"a (1, 1) mesh, the SP mixer): {yards[tag]}; without a mesh "
          f"(ssm.forward's fp32 mixer), relative distance {gap}, step-1 "
          f"update rms {witness_rms:.4g}", flush=True)
    return yards, drift, {tag: max(0.1, 2 * witness_rms)}


def hybrid_update_rms(cfg, name, lr):
    """The step rule between the yardstick's params after step 1 and the
    fp32-mixer witness's, from the seed's params: the update rms."""
    p0 = Model(cfg, device=HYBRID_DEVICE).init(SEED)

    def params(t):
        master = torch.load(t, mmap=True)["master"]
        return {k: v.to(HYBRID_DEVICE, p0[k].dtype) for k, v in
                master.items()}
    return step_agreement(params(hybrid_yard(1, name + "_fp32")),
                          params(hybrid_yard(1, name)), p0, lr,
                          f"hybrid {cfg.name} one-rank witness, fp32 mixer, "
                          "step 1", rms_bound=math.inf)["update_rel_rms"]


# unit roundoffs: bf16 and fp32
BF16_U, FP32_U = 2.0 ** -9, 2.0 ** -24


def gamma(n: int, u: float) -> float:
    """The standard bound's gamma_n = n u / (1 - n u): n roundings of
    unit roundoff u move a sum by at most gamma_n times the sum of its
    terms' magnitudes."""
    return n * u / (1 - n * u) if n > 0 else 0.0


@dataclasses.dataclass
class Terms:
    """The terms a leaf's gradient on this rank's ZeRO block sums, as a
    moment gate needs them: ``T`` the sum of their magnitudes (this
    block's, in the gradient's units), ``k`` their count, ``u_sum`` the
    unit roundoff they are summed in, ``m`` further bf16 roundings on a
    term's way whose place differs between the two runs, ``u_leaf`` the
    gradient's own storage rounding."""

    T: torch.Tensor
    k: int
    u_sum: float
    m: int
    u_leaf: float


def moment_bounds(terms: Terms, mu_r, mu_y, nu_r, nu_y, mu0, norms,
                  adamw):
    """Per-element bounds on ``|mu_r - mu_y|`` and ``|nu_r - nu_y|``
    after one AdamW step from the same state (``mu0`` the first moment
    before it), derived from a reordered sum.

    Both runs' gradient element is g = t_1 + ... + t_k over the same k
    terms (on a mesh the ranks' shares: a rank's heads and rows; on the
    pipeline the microbatches' gradients), summed in another order.  Two
    orders of a sum evaluated with n roundings of unit roundoff u differ
    by at most 2 gamma_n sum|t_j| (Higham, *Accuracy and Stability of
    Numerical Algorithms*, eq. 4.4, once for each order), so

        |g_r - g_y| <= 2 (gamma_{k-1}(u_sum) + gamma_m(2^-9)) T
                       + u_leaf (|g_r| + |g_y|),

    T = sum|t_j| (the k - 1 additions; m bf16 roundings that sit in
    other places along a term's way on a mesh, which perturb it by at
    most gamma_m of its magnitude; each side's rounding of the result to
    the gradient's type).  AdamW scales the gradient by c = min(1,
    clip / ||g||) and sets mu = b1 mu0 + (1 - b1) c g, nu = b2 nu0 +
    (1 - b2) (c g)^2, in fp32.  With gh = c g (recovered from the
    yardstick's mu) and the two clip scales' relative difference rho
    (from the two grad norms),

        |gh_r - gh_y| <= d := c |g_r - g_y| + |gh_y| rho,
        |mu_r - mu_y| <= (1 - b1) d + 4 u32 (|mu_r| + |mu_y|),
        |nu_r - nu_y| <= (1 - b2) (2 |gh_y| d + d^2)
                         + 4 u32 (|nu_r| + |nu_y|),

    the last terms the moments' own fp32 roundings (u32 = 2^-24, a few
    operations each).  ``norms``: (this run's grad norm, the yardstick's);
    ``adamw``: the step's config."""
    gn_r, gn_y = norms
    clip = adamw.grad_clip or math.inf
    c_r, c_y = min(1.0, clip / gn_r), min(1.0, clip / gn_y)
    rho = abs(c_r / c_y - 1.0)
    b1, b2 = adamw.b1, adamw.b2
    gh_y = (mu_y - b1 * mu0) / (1.0 - b1)
    g_abs = (gh_y.abs() + ((mu_r - b1 * mu0) / (1.0 - b1)).abs()) / c_y
    dg = (2 * (gamma(terms.k - 1, terms.u_sum) + gamma(terms.m, BF16_U))
          * terms.T + terms.u_leaf * g_abs)
    d = c_y * dg + gh_y.abs() * rho
    bmu = (1.0 - b1) * d + 4 * FP32_U * (mu_r.abs() + mu_y.abs())
    bnu = ((1.0 - b2) * (2 * gh_y.abs() * d + d * d)
           + 4 * FP32_U * (nu_r.abs() + nu_y.abs()))
    return bmu, bnu


def derived_ratio(terms: Terms, mu_r, mu_y, nu_r, nu_y, mu0, norms, adamw,
                  slot: str) -> float:
    """The largest ratio of ``slot``'s error to :func:`moment_bounds`'
    bound over a leaf's block, ``CHECK_CHUNK`` elements at a time."""
    flat = [x.reshape(-1) for x in (terms.T, mu_r, mu_y, nu_r, nu_y, mu0)]
    worst = 0.0
    for i in range(0, flat[0].numel(), CHECK_CHUNK):
        T, a, b, c, d, m0 = (x[i:i + CHECK_CHUNK] for x in flat)
        bmu, bnu = moment_bounds(dataclasses.replace(terms, T=T), a, b, c,
                                 d, m0, norms, adamw)
        e, bound = ((a - b).abs(), bmu) if slot == "mu" else ((c - d).abs(),
                                                              bnu)
        worst = max(worst, float((e / bound).nan_to_num(0.0, 0.0).max()))
    return worst


def hybrid_after_step(sess, plan, mesh, yard, p_start, lr, what,
                      rms_bound=0.1, terms=None, before=None, norms=None):
    """After a step from the yardstick's state (``p_start`` this rank's
    params then): this rank's param blocks within phase 6's step rule of
    the yardstick's blocks after the step, and its mu and nu blocks within
    the gradient rule of the yardstick moments' matching blocks.  The fp32
    rule (rtol 2e-5, atol 2e-5: ``fp32_rule`` at K = 64) is read beside
    it, not held: the moments come from bf16 gradients summed in another
    order, so only the rule's absolute atol can hold them, and whether it
    does depends on the gradients' scale.

    Given each leaf's :class:`Terms` (``before``: this rank's mu blocks
    before the step; ``norms``: this run's grad norm and the
    yardstick's), every element is also held to :func:`moment_bounds`,
    the reordered sum's bound (the pipeline, whose terms are the same
    bits in both runs; a mesh's are not, so phase 10 passes none: ROADMAP
    queue 3).  Returns the
    readings and this rank's blocks of the yardstick's state, read once,
    in host memory (for :func:`hybrid_restart`; on the card every rank's
    state and checks share one device)."""
    zero = sess.zero_layouts(plan)
    st = sess.state["train_state"]
    dev = HYBRID_DEVICE
    blocks = {slot: {k: zero.zero[k].block(yard[slot][k], mesh)
                     for k in st["opt"][slot]}
              for slot in ("master", "mu", "nu")}
    want = {k: zero.from_zero(k, blocks["master"][k].to(dev, p.dtype))
            for k, p in st["params"].items()}
    rule = step_agreement({k: v.detach() for k, v in st["params"].items()},
                          want, p_start, lr, what, rms_bound=rms_bound)
    errs, fp32, ratios = {}, {}, {}
    for slot in ("mu", "nu"):
        err, ratio, past, past_rel, total = 0.0, 0.0, 0, 0, 0
        for k, got in st["opt"][slot].items():
            w = blocks[slot][k].to(dev)
            e = (got - w).abs()
            atol = GRAD_ATOL_FRAC * yard["absmax"][slot][k]
            require(not bool((e > atol + GRAD_RTOL * w.abs()).any()),
                    f"{what}: {slot} {k} off the yardstick's block (max abs "
                    f"err {float(e.max()):.3g})")
            if terms is not None:
                r = derived_ratio(
                    terms[k], st["opt"]["mu"][k], blocks["mu"][k].to(dev),
                    st["opt"]["nu"][k], blocks["nu"][k].to(dev), before[k],
                    norms, plan.adamw or train_adamw(), slot)
                require(r <= 1.0,
                        f"{what}: {slot} {k} off the yardstick's block by "
                        f"more than the reordered sum's bound (max abs err "
                        f"{float(e.max()):.3g}, error over bound {r:.3g})")
                ratio = max(ratio, r)
            err = max(err, float(e.max()))
            past += int((e > 2e-5 * w.abs() + 2e-5).sum())
            past_rel += int((e > 2e-5 * w.abs()).sum())
            total += e.numel()
        errs[slot] = err
        ratios[slot] = ratio if terms is not None else None
        fp32[slot] = dict(holds=past == 0, past_frac=past / total,
                          past_rtol_alone_frac=past_rel / total)
    derived = ("" if terms is None else "; largest error over the "
               f"reordered sum's bound (held) {ratios}")
    print(f"{what}: moments max abs err {errs}{derived}; fp32 rule (read, "
          f"not held) {fp32}", flush=True)
    return dict(step_rule=rule, moments_max_abs_err=errs,
                moments_error_over_derived_bound=ratios,
                moments_fp32_rule=fp32), blocks


def hybrid_restart(sess, plan, yard, blocks):
    """Sets this rank's state to its blocks of the yardstick's state
    ``yard`` (``blocks``: those blocks of its master and moments, from
    :func:`hybrid_after_step`): master, moments and step, and the params
    cast from the master and gathered as the step writes them."""
    zero = sess.zero_layouts(plan)
    st = sess.state["train_state"]
    with torch.no_grad():
        for slot in ("master", "mu", "nu"):
            for k, x in st["opt"][slot].items():
                x.copy_(blocks[slot][k])
        for k, p in st["params"].items():
            p.copy_(zero.from_zero(k, blocks["master"][k].to(p.device,
                                                              p.dtype)))
        st["opt"]["step"].fill_(yard["step"])


def hybrid_rank(rank, init, result_path, yard_metrics, rms_bounds):
    """One rank of phase 10; writes its results as JSON to
    ``result_path`` with its number in place of ``{}``."""
    import torch.distributed as dist
    from repro_torch.core.distributed import WIRE, close_group, init_group
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(init, rank=rank, world_size=HYBRID_RANKS,
               device=HYBRID_DEVICE)
    out = dict(rank=rank, meshes={})
    for tag, cfg, shape, mode, steps, name in hybrid_cells():
        batches = train_batches(cfg)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        ssm_family = cfg.family == "ssm"
        clocked = HYBRID_CLOCKED if steps > HYBRID_CLOCKED else None
        what = f"hybrid {tag} rank {rank}"
        sess, plan, mesh = hybrid_session(shape, cfg)
        require(plan.path == "gspmd" and plan.model.mesh is mesh
                and plan.parallel.attn_mode == mode
                and plan.parallel.seq_parallel_residual
                and plan.parallel.ffn_replicated == (mode == "sp"),
                f"{what}: plan {plan.path} {plan.parallel}")
        sess.init_state(plan, seed=SEED)
        held = HeldKernels()
        walls, metrics, after = [], [], []
        clocked_ms = None
        if HYBRID_DEVICE == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        ops.reset_launches()
        held.install()
        for t in range(steps):
            st = sess.state["train_state"]
            p_start = {k: v.detach().clone() for k, v in st["params"].items()}
            WIRE.reset()
            dist.barrier()
            with (CollectiveClock() if t == clocked
                  else contextlib.nullcontext()) as clock:
                t0 = time.perf_counter()
                m = sess.step(plan, batches[t])
                if HYBRID_DEVICE == "cuda":
                    torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            if clock is not None:
                clocked_ms = 1e3 * clock.seconds
            wire = dict(WIRE.bytes)
            metrics.append({k: float(v) for k, v in m.items()})
            if t + 1 < steps:
                held.uninstall()
                yard = torch.load(hybrid_yard(t + 1, name), mmap=True)
                reading, blocks = hybrid_after_step(
                    sess, plan, mesh, yard, p_start, metrics[t]["lr"],
                    f"{what} after step {t + 1}",
                    rms_bound=rms_bounds.get(tag, 0.1))
                after.append(reading)
                hybrid_restart(sess, plan, yard, blocks)
                del yard, blocks
                if HYBRID_DEVICE == "cuda":
                    torch.cuda.empty_cache()
                held.install()
            del p_start
        held.uninstall()
        launches = ops.dispatch_report()
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if HYBRID_DEVICE == "cuda" else 0.0)
        mm_bwd, att_bwd = held.backward_checks()
        dev = [{k: abs(got[k] / want[k] - 1) for k in ("loss", "grad_norm")}
               for got, want in zip(metrics, yard_metrics[tag])]
        print(f"{what}: relative distance from the one-rank step {dev}",
              flush=True)
        for t, (got, want) in enumerate(zip(metrics, yard_metrics[tag])):
            for k in ("loss", "grad_norm", "lr"):
                # each step from the yardstick's state before it: only
                # the step's sums differ (their order, the wire's bf16)
                require(math.isclose(got[k], want[k], rel_tol=1e-3),
                        f"{what} step {t + 1}: {k} {got[k]} against the "
                        f"one-rank {want[k]}")
        if ssm_family:     # the CPU's backward is autograd's, no call
            require(held.ssd_cases and (held.ssd_bwd_cases
                                        or HYBRID_DEVICE != "cuda"),
                    f"{what}: no SSD call was held")
        # the unclocked steps after the first
        free = [w for t, w in enumerate(walls) if t and t != clocked]
        out["meshes"][tag] = dict(
            mode=mode, layers=cfg.n_layers, steps=steps, metrics=metrics,
            walls_ms=walls,
            clocked_step=None if clocked is None else clocked + 1,
            clocked_wall_ms=None if clocked is None else walls[clocked],
            collective_ms=clocked_ms,
            wall_ms_median=statistics.median(free),
            tokens_per_s=tokens / (statistics.median(free) / 1e3),
            peak_gib=peak, wire_bytes=wire,
            wire_estimate=hybrid_wire_estimate(plan.model, mesh, TRAIN_BATCH,
                                               TRAIN_SEQ),
            launches=launches, forward_calls=held.calls,
            distance_from_one_rank=dev,
            expected=(expected_mamba_train_launches(cfg, steps)
                      if ssm_family
                      else expected_train_launches(cfg, steps, int8=False)),
            gemm_cases=len(held.mm_cases), flash_cases=len(held.att_cases),
            ssd_cases=len(held.ssd_cases),
            ssd_backward_cases=len(held.ssd_bwd_cases),
            gemm_max_abs_err=max(held.mm_cases.values()),
            flash_max_abs_err=max(held.att_cases.values(), default=0.0),
            ssd_max_abs_err=max(held.ssd_cases.values(), default=0.0),
            ssd_backward_max_rel_err=max(held.ssd_bwd_cases.values(),
                                         default=0.0),
            gemm_backward_max_abs_err=mm_bwd,
            flash_backward_max_abs_err=att_bwd, after_step=after)
        del sess, plan
        if HYBRID_DEVICE == "cuda":
            torch.cuda.empty_cache()
    Path(result_path.format(rank)).write_text(json.dumps(out))
    dist.barrier()
    close_group()


def hybrid_phase():
    """Phase 10: the one-rank yardsticks (and qwen2's witness), then four
    ranks spawned on the one card over gloo, each cell in turn (qwen2's
    meshes, then mamba2's cut on (2, 2)); returns the summary and the
    ranks' launch counts summed over the cells."""
    import torch.multiprocessing as mp
    cfg = hybrid_qwen2()
    init = f"file://{TRAIN_DIR / 'rendezvous_hybrid'}"
    (TRAIN_DIR / "rendezvous_hybrid").unlink(missing_ok=True)
    results = [TRAIN_DIR / f"hybrid_rank{r}.json"
               for r in range(HYBRID_RANKS)]
    for f in results:
        f.unlink(missing_ok=True)
    yards = [hybrid_yard(t, name) for *_, steps, name in hybrid_cells()
             for t in range(1, steps)]
    yards += [hybrid_yard(1, name + "_fp32")
              for *_, name in hybrid_cells() if name]
    try:
        yard_metrics, witness, rms_bounds = hybrid_yardstick(
            cfg, train_batches(cfg))
        mp.spawn(hybrid_rank,
                 args=(init, str(TRAIN_DIR / "hybrid_rank{}.json"),
                       yard_metrics, rms_bounds),
                 nprocs=HYBRID_RANKS, join=True)
    finally:
        for f in yards:
            f.unlink(missing_ok=True)
    ranks = [json.loads(f.read_text()) for f in results]
    for f in results:
        f.unlink()
    total = {}
    qwen_tag = f"{HYBRID[0][0][0]}x{HYBRID[0][0][1]}"
    summary = dict(arch=ARCH, ranks=HYBRID_RANKS,
                   backend="gloo (host memory), one card",
                   tokens_per_step=TRAIN_BATCH * TRAIN_SEQ,
                   yardstick=yard_metrics[qwen_tag],
                   one_rank_rows_reversed_distance=witness, meshes={})
    for tag, mcfg, shape, mode, steps, _ in hybrid_cells():
        rows = [r["meshes"][tag] for r in ranks]
        for r, row in zip(ranks, rows):
            got, want = row["launches"], row["expected"]
            print(f"hybrid {tag} rank {r['rank']}: launches {got} (expected "
                  f"{want}); held {row['gemm_cases']} GEMM, "
                  f"{row['flash_cases']} flash, {row['ssd_cases']} SSD and "
                  f"{row['ssd_backward_cases']} SSD backward cases; peak "
                  f"{row['peak_gib']:.3f} GiB; wire per step "
                  f"{row['wire_bytes']} (estimate {row['wire_estimate']})",
                  flush=True)
            require(got == want, f"hybrid {tag} rank {r['rank']}: launches "
                    "do not match the layer structure")
            require(row["wire_bytes"] == row["wire_estimate"],
                    f"hybrid {tag} rank {r['rank']}: wire bytes per step "
                    "differ from the layouts' estimate")
            for op, n in got.items():
                total[op] = total.get(op, 0) + n
        cell = dict(
            mode=mode, layers=mcfg.n_layers, steps=steps,
            metrics_rank0=rows[0]["metrics"],
            step_wall_ms_median_by_rank=[r["wall_ms_median"] for r in rows],
            step_walls_ms_rank0=rows[0]["walls_ms"],
            clocked_step=rows[0]["clocked_step"],
            clocked_wall_ms_by_rank=[r["clocked_wall_ms"] for r in rows],
            collective_ms_by_rank=[r["collective_ms"] for r in rows],
            tokens_per_s_by_rank=[r["tokens_per_s"] for r in rows],
            peak_gib_by_rank=[r["peak_gib"] for r in rows],
            wire_bytes_per_step_by_rank=[r["wire_bytes"] for r in rows],
            wire_estimate_by_rank=[r["wire_estimate"] for r in rows],
            after_step_by_rank=[r["after_step"] for r in rows],
            distance_from_one_rank_by_rank=[r["distance_from_one_rank"]
                                            for r in rows],
            max_abs_err={k: max(r[k] for r in rows) for k in (
                "gemm_max_abs_err", "flash_max_abs_err",
                "gemm_backward_max_abs_err", "flash_backward_max_abs_err",
                "ssd_max_abs_err", "ssd_backward_max_rel_err")})
        if mcfg.family == "ssm":
            summary["mamba2"] = dict(cell, yardstick=yard_metrics[tag],
                                     update_rms_bound=rms_bounds[tag])
        else:
            summary["meshes"][tag] = cell
    print("hybrid " + json.dumps(summary), flush=True)
    return summary, total


# ---------------------------------------------------------------------------
# phase 11: the all-reduce schedules, the link fit, the memory verdict and
# the train CLI with a calibration table
# ---------------------------------------------------------------------------

SCHED_RANKS = 4
SCHED_PATH = "comms schedules (4 ranks, gloo, int8 wire)"
SCHED_ODD = 262_147                   # elements: padded at 4 and at 2
SCHED_BYTES = 4 << 20                 # a 4 MiB bucket
SCHED_FLAT = ("psum", "ring", "rsag", "tree")
FIT_SIZES = tuple(4096 * 16 ** k for k in range(4))    # 4 KiB .. 16 MiB
CALIBRATION = TRAIN_DIR / "calibration.json"
SCHED_DEVICE = "cuda"                 # "cpu" for a rehearsal off the card
#: phase 10's peaks per rank at ``HYBRID_LAYERS`` as PERF.md records them
#: (H100 80GB HBM3, 700 W; the checks read leaves in chunks), printed when
#: phase 10 did not run in this invocation
HYBRID_PEAK_RECORDED = {"2x2": 3.600, "1x4": 3.713}


def sched_cases():
    """(name, schedule, wire, dtype, elements): fp32 and bf16 buckets of
    an odd size and of 4 MiB, and the int8 wire (fp32 in) at 4 MiB,
    through each flat schedule on the 4-rank line and ``hier`` on
    (2, 2)."""
    out = []
    for sched in SCHED_FLAT + ("hier",):
        for dtype in (torch.float32, torch.bfloat16):
            for n in (SCHED_ODD, SCHED_BYTES // dtype.itemsize):
                out.append((f"{sched}-{str(dtype)[6:]}-{n}", sched, None,
                            dtype, n))
        out.append((f"{sched}-int8wire", sched, "int8", torch.float32,
                    SCHED_BYTES // 4))
    return out


def sched_input(case, rank: int, device) -> torch.Tensor:
    """Rank ``rank``'s bucket of ``case``, from a seed (ranks of unlike
    scale); any rank can make any rank's."""
    name, _, _, dtype, n = case
    seed = SEED + 1000 * rank + sum(map(ord, name))
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g) * 10.0 ** ((rank - 1.5) / 2)
    return x.to(dtype).to(device)


def sched_meshes():
    """The 4-rank ``model`` line of (1, 4) and (data, model) of (2, 2)
    over the default group: (mesh, reduce axes, intra axis) by kind."""
    import torch.distributed as dist
    from repro_torch.core.distributed import Mesh
    world = dist.group.WORLD
    return {"flat": (Mesh((1, 4), ("data", "model"), world), ("model",),
                     "model"),
            "hier": (Mesh((2, 2), ("data", "model"), world),
                     ("data", "model"), "model")}


def sched_run(case, x, meshes):
    from repro_torch.comms import compressed, schedules
    _, sched, wire, _, _ = case
    mesh, axes, intra = meshes["hier" if sched == "hier" else "flat"]
    if wire is None:
        return schedules.all_reduce(x, mesh, axes, sched, intra)
    return compressed.wire_all_reduce(x, mesh, axes, sched, wire, intra)


def sched_design(sched: str, nbytes: int):
    """(steps, wire bytes) the cost model gives one all-reduce of
    ``nbytes`` per rank: ``allreduce_design`` for a flat schedule on 4
    ranks, its two flat phases for ``hier`` on (2, 2)."""
    from repro_torch.comms import topology
    if sched != "hier":
        return topology.allreduce_design(nbytes, sched, SCHED_RANKS)
    ni = nn = 2
    return (2 * (ni - 1) + 2 * (nn - 1),
            2 * nbytes * (ni - 1) / ni + 2 * (nbytes / ni) * (nn - 1) / nn)


def sched_sync() -> None:
    if SCHED_DEVICE == "cuda":
        torch.cuda.synchronize()


def int_bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({1: torch.int8, 2: torch.int16,
                                4: torch.int32}[t.element_size()])


def sched_rank(rank, init, result_path, fit):
    """One rank of phase 11: every case on the card and on CPU tensors in
    the same group, the failing control, the wire bytes, and (``fit``)
    the timed sizes; writes its results as JSON to ``result_path`` with
    its number in place of ``{}``."""
    import hashlib
    import torch.distributed as dist
    from repro_torch.core import distributed as dist_mod
    from repro_torch.core.distributed import close_group, init_group
    init_group(init, rank=rank, world_size=SCHED_RANKS,
               device=SCHED_DEVICE)
    meshes = sched_meshes()
    out = dict(rank=rank, digest={}, same_as_cpu={}, wire={}, err={})
    dist.barrier()
    ops.reset_launches()
    for case in sched_cases():
        name, sched, wire, dtype, n = case
        x = sched_input(case, rank, SCHED_DEVICE)
        dist_mod.WIRE.reset()
        y = sched_run(case, x, meshes)
        sched_sync()
        out["wire"][name] = dist_mod.WIRE.total()
        y_cpu = sched_run(case, x.cpu(), meshes)
        require(y.dtype == dtype and y.shape == x.shape,
                f"{name}: {y.dtype} {tuple(y.shape)}")
        out["same_as_cpu"][name] = torch.equal(int_bits(y.cpu()),
                                               int_bits(y_cpu))
        out["digest"][name] = hashlib.sha256(
            int_bits(y.cpu()).numpy().tobytes()).hexdigest()
        xs = [sched_input(case, r, "cpu").double()
              for r in range(SCHED_RANKS)]
        want = sum(xs)
        big = float(want.abs().max())
        if wire == "int8":
            scale = max(float(v.abs().max()) for v in xs) / 127
            rtol, atol = 0.0, SCHED_RANKS * scale / 2 + 1e-6 * big
        elif dtype == torch.bfloat16:
            rtol, atol = 2e-2, 0.16 * big / 8
        else:
            rtol, atol = 1e-5, 8e-5 * big / 8
        if sched == "hier":
            atol *= 2
        excess = float(((y.cpu().double() - want).abs()
                        - (atol + rtol * want.abs())).max())
        out["err"][name] = dict(max_abs=float((y.cpu().double() - want)
                                             .abs().max()),
                                within=excess <= 0)
        if name == f"ring-float32-{SCHED_BYTES // 4}":
            # the control: rank 0's bucket moved by one ulp
            moved = (torch.nextafter(x, torch.full_like(x, math.inf))
                     if rank == 0 else x)
            y2 = sched_run(case, moved, meshes)
            out["control_differs"] = not torch.equal(
                int_bits(y2.cpu()), int_bits(y_cpu))
    sched_sync()
    out["launches"] = ops.dispatch_report()
    if fit:
        out["samples"] = sched_timings(meshes)
    Path(result_path.format(rank)).write_text(json.dumps(out))
    dist.barrier()
    close_group()


def sched_timings(meshes):
    """Each schedule at each of ``FIT_SIZES`` (fp32): one warm-up, then 3
    runs, each the slowest rank's wall from a barrier to its own
    synchronize; the median."""
    import torch.distributed as dist
    rows = []
    for nbytes in FIT_SIZES:
        g = torch.Generator(device=SCHED_DEVICE).manual_seed(SEED + nbytes)
        x = torch.randn(nbytes // 4, generator=g, device=SCHED_DEVICE)
        for sched in SCHED_FLAT + ("hier",):
            case = ("fit", sched, None, torch.float32, x.numel())
            sched_run(case, x, meshes)
            walls = []
            for _ in range(3):
                sched_sync()
                dist.barrier()
                t0 = time.perf_counter()
                sched_run(case, x, meshes)
                sched_sync()
                walls.append(time.perf_counter() - t0)
            t = torch.tensor(walls, dtype=torch.float64)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            steps, wire = sched_design(sched, nbytes)
            rows.append(dict(schedule=sched, nbytes=nbytes, steps=steps,
                             wire_bytes=wire,
                             seconds=statistics.median(t.tolist())))
    return rows


def sched_link_fit(samples):
    """Record every timed run as a ``collective_sample`` event through
    ``obs``, fit one link with ``calibrate.fit_link`` over them, save the
    table (``calibrate.fit``) to ``CALIBRATION``, and print, per size,
    the fastest schedule measured beside ``best_schedule`` under the
    fitted link and under the nominal links.  A finding, not a gate: the
    gate is a positive link."""
    import warnings
    from repro_torch import obs as obs_mod
    from repro_torch.comms import topology
    from repro_torch.core import calibrate
    from repro_torch.core.distributed import Mesh
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    stream = TRAIN_DIR / "collective_samples.jsonl"
    obs = obs_mod.Obs(jsonl=str(stream), name="chip_smoke/11")
    for row in samples:
        obs.event("collective_sample", **row)
    obs.close()
    events = [e for e in read_jsonl(stream)
              if e["kind"] == "collective_sample"]
    stream.unlink()
    link, meta = calibrate.fit_link(events)
    require(link is not None and link.latency_s > 0
            and link.bandwidth_Bps > 0, f"link fit: {meta}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", calibrate.CalibrationWarning)
        table = calibrate.fit(events, {"meta": {}, "metrics": {}},
                              sources=["chip_smoke.py phase 11"])
    table.save(str(CALIBRATION))
    fitted = dict(alpha_us=link.latency_s * 1e6,
                  bandwidth_GBps=link.bandwidth_Bps / 1e9,
                  residual_rms_rel=meta["residual_rms_rel"],
                  samples=meta["n_samples"])
    print(f"link fit over {meta['n_samples']} collective samples: alpha "
          f"{fitted['alpha_us']:.1f} us, bandwidth "
          f"{fitted['bandwidth_GBps']:.3f} GB/s, relative residual "
          f"{fitted['residual_rms_rel']:.3f} (the nominals: PCIE_GEN3 2 us "
          "12 GB/s, FDR_IB 5 us 6.8 GB/s)", flush=True)
    line = Mesh((1, 4), ("data", "model"))
    nominal = topology.topology_from_mesh(line)
    fit_topo = topology.topology_from_mesh(line, intra=link, inter=link)
    by_size = []
    for nbytes in FIT_SIZES:
        ms = {r["schedule"]: 1e3 * r["seconds"] for r in samples
              if r["nbytes"] == nbytes}
        flat = {k: v for k, v in ms.items() if k != "hier"}
        row = dict(nbytes=nbytes, ms=ms,
                   fastest_measured=min(flat, key=flat.get),
                   best_fitted=fit_topo.best_schedule(nbytes),
                   best_nominal=nominal.best_schedule(nbytes))
        by_size.append(row)
        print(f"  {nbytes:>9} B: " + ", ".join(
            f"{k} {v:.2f}" for k, v in ms.items())
            + f" ms; fastest flat {row['fastest_measured']}, best_schedule "
            f"fitted {row['best_fitted']}, nominal {row['best_nominal']}")
    return dict(link=fitted, by_size=by_size)


def memory_verdict(hybrid=None):
    """Phase 11(d), in this process alone: the session's budget is the
    card's entry; gemma3-27b's one-rank train cell is refused before a
    byte is allocated; the model's peak per rank for phase 10's meshes
    beside the peaks phase 10 measured; ``best_hybrid`` for qwen2-0.5b
    on 4 devices."""
    from repro_torch.api import PlanMemoryError, Session
    from repro_torch.core import memory as mem_mod
    from repro_torch.core.distributed import Mesh
    from repro_torch.core.planner import best_hybrid
    sess = Session()
    require(sess.budget == mem_mod.HBM_BUDGETS["h100"],
            f"the session's budget is {sess.budget.describe()}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    refusal = None
    try:
        sess.plan(GEMMA3, batch=2, seq=512)
    except PlanMemoryError as e:
        refusal = e
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    require(refusal is not None, "gemma3-27b's one-rank cell was planned")
    require(after == before, f"the refused plan allocated {after - before} "
            "bytes on the card")
    peak = mem_mod.peak_stage_footprint(refusal.footprints).total / 2**30
    print(f"memory verdict: gemma3-27b, one rank, 2 x 512 tokens: refused "
          f"({peak:.1f} GiB per device vs {sess.budget.describe()}); "
          f"allocated before/after {before}/{after} bytes", flush=True)
    cfg = hybrid_qwen2()
    meshes = {}
    for shape, _, _ in HYBRID:
        tag = f"{shape[0]}x{shape[1]}"
        fps = mem_mod.footprints_for_mesh(
            cfg, Mesh(shape, ("data", "model")), global_batch=TRAIN_BATCH,
            seq_len=TRAIN_SEQ)
        pred = mem_mod.peak_stage_footprint(fps).total / 2**30
        if hybrid is not None:
            meas, src = max(hybrid["meshes"][tag]["peak_gib_by_rank"]), \
                "phase 10, this run"
        else:
            meas, src = HYBRID_PEAK_RECORDED[tag], "phase 10, PERF.md"
        meshes[tag] = dict(predicted_gib=pred, measured_gib=meas,
                           measured_over_predicted=meas / pred, source=src)
        print(f"  qwen2-0.5b ({HYBRID_LAYERS} layers) hybrid {tag}, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: the model's peak {pred:.3f} GiB per rank, measured "
              f"{meas:.3f} ({src}), ratio {meas / pred:.3f}")
    best = best_hybrid(get_config(ARCH), 4, global_batch=TRAIN_BATCH,
                       seq_len=TRAIN_SEQ,
                       hbm_budget=sess.budget)
    print(f"  best_hybrid(qwen2-0.5b, 4 devices, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}) = (dp, tp, pp) {best}", flush=True)
    return dict(refused_peak_gib=peak, allocated_delta=after - before,
                hybrid=meshes, best_hybrid=list(best))


def calibrated_cli():
    """Phase 11(e): the train CLI at phase 8's depth for 2 steps with
    ``--hbm-gib 80 --calibration`` the table fitted in (c), and its drift
    report."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cal_"))
    try:
        out, dt = cli(["repro_torch.launch.train", "--arch", ARCH,
                       "--scale-down", "1", "--batch", "2", "--seq", "512",
                       "--comms", "off", "--steps", "2", "--hbm-gib", "80",
                       "--calibration", str(CALIBRATION), "--metrics",
                       str(tmp / "train.jsonl")], timeout=300)
        lines = out.splitlines()
        at = next(i for i, ln in enumerate(lines)
                  if ln.startswith("drift report"))
        print("\n".join(lines[at:at + 5]))
        snap = json.loads((tmp / "BENCH_step_metrics.json").read_text())
        rows = {r["name"]: r for r in snap["meta"]["drift"]["rows"]}
        require("calibration: CalibrationTable(" in out
                and "override 80.0 GiB" in out
                and snap["meta"]["calibration"] == str(CALIBRATION)
                and set(rows) == {"peak_bytes", "step_time_s"},
                "the calibrated train CLI's lines or snapshot are not what "
                "it ran")
        return dict(seconds=dt, drift=rows)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sched_phase(hybrid=None, fit=True):
    """Phase 11: four ranks spawned on the one card over gloo run (a) every
    schedule on the card and on CPU tensors, (b) count the wire, (c) time
    the fit sizes; then, here, the link fit, (d) the memory verdict and
    (e) the calibrated train CLI.  Returns the summary and the ranks'
    launch counts summed."""
    import torch.multiprocessing as mp
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    init = f"file://{TRAIN_DIR / 'rendezvous_sched'}"
    (TRAIN_DIR / "rendezvous_sched").unlink(missing_ok=True)
    results = [TRAIN_DIR / f"sched_rank{r}.json" for r in range(SCHED_RANKS)]
    for f in results:
        f.unlink(missing_ok=True)
    mp.spawn(sched_rank, args=(init, str(TRAIN_DIR / "sched_rank{}.json"),
                               fit), nprocs=SCHED_RANKS, join=True)
    ranks = [json.loads(f.read_text()) for f in results]
    for f in results:
        f.unlink()
    r0 = ranks[0]
    cases = sched_cases()
    for name, sched, wire, _, _ in cases:
        require(all(r["digest"][name] == r0["digest"][name] for r in ranks),
                f"{name}: the ranks' results differ")
        require(all(r["same_as_cpu"][name] for r in ranks),
                f"{name}: the card's result is not the CPU tensors' bits")
        require(all(r["err"][name]["within"] for r in ranks),
                f"{name}: past the reference test's tolerance of the fp64 "
                f"sum ({r0['err'][name]})")
    require(all(r["control_differs"] for r in ranks),
            "the control (rank 0's input one ulp up) matches: the check "
            "cannot see a changed input")
    print(f"schedules: {len(cases)} cases, every rank the same bits, each "
          "bitwise its CPU-tensor run, within the reference test's "
          "tolerance of the fp64 sum; the ring's control with rank 0's "
          "bucket one ulp up differs: True", flush=True)
    wire = {}
    for sched in SCHED_FLAT + ("hier",):
        name = f"{sched}-float32-{SCHED_BYTES // 4}"
        got = r0["wire"][name]
        want = sched_design(sched, SCHED_BYTES)[1]
        wire[sched] = dict(received=got, modelled=want)
        why = ("" if got == want else "; psum adds in rank order by "
               "gathering the line's tensors, (n - 1) of them, not the "
               "modelled 2 (n - 1) / n")
        print(f"  wire per rank, {sched}, {SCHED_BYTES} B fp32: {got} bytes "
              f"received, modelled {want:.0f}{why}")
        require(got == want or sched == "psum",
                f"{sched}: wire bytes {got} differ from the model's {want}")
    int8_cases = 5 if SCHED_DEVICE == "cuda" else 0
    expect = {op: (int8_cases if op == "quantize_int8" else 0)
              for op in r0["launches"]}
    for r in ranks:
        require(r["launches"] == expect, f"schedules rank {r['rank']}: "
                f"launches {r['launches']} (expected {expect})")
    summary = dict(ranks=SCHED_RANKS, backend="gloo (host memory), one card",
                   cases=len(cases), wire=wire,
                   max_abs_err={k: v["max_abs"] for k, v in
                                r0["err"].items()},
                   launches_by_rank=[r["launches"] for r in ranks])
    if fit:
        summary["link"] = sched_link_fit(r0["samples"])
    summary["memory"] = memory_verdict(hybrid)
    if fit:
        summary["calibrated_cli"] = calibrated_cli()
    print("schedules " + json.dumps(summary), flush=True)
    return summary, {k: sum(r["launches"][k] for r in ranks)
                     for k in r0["launches"]}


# ---------------------------------------------------------------------------
# phase 12: the whole Session: serve on persistent state through the op
# cache, restart, the budget's refusal, autotune, the dry traces, the
# backend
# ---------------------------------------------------------------------------

SESSION_REQUESTS, SESSION_NEW = 8, 32
SESSION_PATH = f"{ARCH} Session.serve (dense, restart, continuous)"
TUNE_PATH = f"{ARCH} autotune (fwd + bwd, 2 x 512, 3 remat candidates)"
TUNE_BATCH, TUNE_SEQ = 2, 512
TUNE_REMAT = ("none", "full", "group:4")
#: phase 10's wire per rank per step at (2, 2) on four H100s, the
#: layouts' estimate
HYBRID_WIRE_2X2 = 875_241_216


def timed_serve(sess, plan, **kw):
    """``sess.serve`` and its wall ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = sess.serve(plan, batch_slots=SLOTS, max_seq=MAX_SEQ, seed=SEED,
                     **kw)
    torch.cuda.synchronize()
    return eng, 1e3 * (time.perf_counter() - t0)


def tokens_of(fin):
    return {r.rid: list(map(int, r.out)) for r in fin}


def weight_copies(prof, params) -> list:
    """Copy operators in a profile whose input has a weight's shape."""
    shapes = {tuple(v.shape) for v in params.values()}
    return [e.name for e in prof.events()
            if e.name in ("aten::copy_", "aten::_to_copy", "aten::to")
            and any(tuple(s) in shapes for s in (e.input_shapes or ())
                    if s)]


def session_serve(cfg):
    """Phase 12 (a)-(c): ``Session.plan(kind="decode")`` and
    ``Session.serve``, dense then continuous, each against the same
    engine built directly on the same params (bitwise tokens); a restart
    under the same name (the same storages, the new cache's bytes alone,
    no weight copy, the steps from the op cache); an over-budget pool
    refused before anything is allocated."""
    from repro_torch.api import PlanMemoryError, Session
    from repro_torch.core import memory as mem_mod
    from repro_torch.serve.blocks import kv_bytes_per_block

    def fresh(n=SESSION_REQUESTS):          # new Request objects each run
        return requests(cfg, new_tokens=SESSION_NEW)[:n]

    sess = Session()
    plan = sess.plan(ARCH, batch=SLOTS, seq=MAX_SEQ, kind="decode")
    require(plan.path == "decode" and plan.model.mesh is None,
            f"the decode plan: path {plan.path}")
    out = dict(plan=plan.describe())
    launches = {}

    # (a) dense, cold: the params are drawn here; a direct engine on two
    # requests warms the kernels first when this phase runs alone
    eng, cold_ms = timed_serve(sess, plan, name="qwen2")
    params = sess.get("qwen2/params")
    drive(Engine(plan.model, params, SLOTS, MAX_SEQ, seed=SEED), fresh(2))
    ops.reset_launches()
    fin, dt, steps = drive(eng, fresh())
    launches["dense"] = ops.dispatch_report()
    want = dense_serve_launches(cfg, steps, len(fin))
    require(launches["dense"] == want, f"Session.serve dense launches "
            f"{launches['dense']} (expected {want})")
    direct, _, _ = drive(Engine(plan.model, params, SLOTS, MAX_SEQ,
                                seed=SEED), fresh())
    same = tokens_of(fin) == tokens_of(direct)
    require(same, "Session.serve's dense tokens differ from the engine "
            "built directly on the same params")
    out["dense"] = serve_stats(ARCH, sum(p.numel() for p in params.values()),
                               fin, dt, launches["dense"], 0, 0)
    print(f"session dense: {out['dense']['tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{out['dense']['ttft_p50_ms']:.1f} ms; tokens bitwise the direct "
          f"engine's: {same}", flush=True)

    # (b) restart under the same name
    ptrs = {k: v.data_ptr() for k, v in params.items()}
    requested = lambda: torch.cuda.memory_stats()[  # noqa: E731
        "requested_bytes.all.current"]
    torch.cuda.synchronize()
    before, before_req = torch.cuda.memory_allocated(), requested()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA],
            record_shapes=True) as prof:
        eng2, restart_ms = timed_serve(sess, plan, name="qwen2")
    # the bytes the restart asked for; the allocator may hand a request a
    # cached block up to 1 MiB larger than it (a large block's remainder
    # of 1 MiB or less is not split off), which memory_allocated counts
    grown = requested() - before_req
    grown_blocks = torch.cuda.memory_allocated() - before
    cache_bytes = mem_mod.tree_bytes(eng2.cache)
    htod = [e for e in prof.events() if "Memcpy HtoD" in e.name]
    copies_ = weight_copies(prof, params)
    same_ptrs = {k: v.data_ptr() for k, v in eng2.params.items()} == ptrs
    stats = sess.opcache.stats()
    hits = {op: stats[op].hits for op in ("serve_decode", "serve_prefill")}
    print(f"session restart: cold start {cold_ms:.1f} ms, restart "
          f"{restart_ms:.1f} ms; params' storages the same: {same_ptrs}; "
          f"the requested bytes grew {grown} (memory_allocated "
          f"{grown_blocks}) for a {cache_bytes}-byte cache; {len(htod)} "
          f"host-to-device copies, {len(copies_)} of a "
          f"weight's shape; op-cache hits {hits}", flush=True)
    print(sess.describe(), flush=True)
    require(same_ptrs, "the restarted engine's params are other tensors")
    require(0 <= grown - cache_bytes <= 512 * (len(eng2.cache) + 2),
            f"the restart allocated {grown} bytes for a {cache_bytes}-byte "
            "cache")
    require(not copies_, f"the restart copied a weight: {copies_}")
    require(all(h >= 1 for h in hits.values()),
            f"the restart's steps are not op-cache hits: {hits}")
    ops.reset_launches()
    fin2, _, steps2 = drive(eng2, fresh())
    launches["restart"] = ops.dispatch_report()
    want = dense_serve_launches(cfg, steps2, len(fin2))
    require(launches["restart"] == want, f"Session.serve restart launches "
            f"{launches['restart']} (expected {want})")
    require(tokens_of(fin2) == tokens_of(fin), "the restarted engine's "
            "tokens differ")
    del eng, eng2
    out.update(cold_start_ms=cold_ms, restart_ms=restart_ms,
               restart_allocated=grown, restart_blocks=grown_blocks,
               cache_bytes=cache_bytes,
               htod_copies=len(htod), op_cache_hits=hits)

    # (a) continuous, on the same params
    ckw = dict(name="qwen2", scheduler="continuous", page_size=PAGE,
               prefill_chunk=CHUNK)
    eng3, _ = timed_serve(sess, plan, **ckw)
    ops.reset_launches()
    fin3, dt3, steps3 = drive(eng3, fresh())
    launches["continuous"] = ops.dispatch_report()
    want, _ = continuous_serve_launches(cfg, steps3, fin3)
    require(launches["continuous"] == want, f"Session.serve continuous "
            f"launches {launches['continuous']} (expected {want})")
    direct3, _, _ = drive(ContinuousEngine(
        plan.model, params, SLOTS, MAX_SEQ, seed=SEED, page_size=PAGE,
        prefill_chunk=CHUNK), fresh())
    same3 = tokens_of(fin3) == tokens_of(direct3)
    require(same3, "Session.serve's continuous tokens differ from the "
            "engine built directly on the same params")
    out["continuous"] = serve_stats(ARCH, 0, fin3, dt3,
                                    launches["continuous"], 0, 0)
    print(f"session continuous: {out['continuous']['tok_per_s']:.1f} tok/s, "
          f"TTFT p50 {out['continuous']['ttft_p50_ms']:.1f} ms; tokens "
          f"bitwise the direct engine's: {same3}", flush=True)
    out["registry"] = {k: [e.kind, e.nbytes] for k in sess.state.keys()
                       for e in [sess.state.entry(k)]}
    del eng3

    # (c) a pool over the budget: the params and half the pool fit
    n_pages = 1 + SLOTS * (MAX_SEQ // PAGE)
    pool = n_pages * kv_bytes_per_block(cfg, PAGE)
    pbytes = mem_mod.tree_bytes(params)
    hbm_gib = (pbytes + pool / 2) / mem_mod.DEFAULT_HEADROOM / mem_mod.GIB
    tight = Session(hbm_gib=hbm_gib)
    tight.put("qwen2/params", params, kind="params")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    refusal = None
    try:
        tight.serve(tight.plan(ARCH, batch=SLOTS, seq=MAX_SEQ,
                               kind="decode"),
                    batch_slots=SLOTS, max_seq=MAX_SEQ, name="qwen2",
                    scheduler="continuous", page_size=PAGE,
                    prefill_chunk=CHUNK, num_pages=n_pages)
    except PlanMemoryError as e:
        refusal = str(e)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    print(f"session budget: a {pool}-byte pool beside {pbytes} bytes of "
          f"params under {tight.budget.describe()}: refused "
          f"{refusal is not None}; allocated before/after {before}/{after}",
          flush=True)
    require(refusal is not None, "the over-budget pool was allocated")
    require(after == before, f"the refused pool allocated {after - before} "
            "bytes")
    out["refused_pool"] = dict(pool_bytes=pool, params_bytes=pbytes,
                               hbm_gib=hbm_gib, allocated_delta=after - before)
    total = {k: sum(v[k] for v in launches.values())
             for k in launches["dense"]}
    return out, total


def fwd_bwd(model, params, batch):
    """The loss's forward and the gradients of every param."""
    loss, _ = model.loss_fn(params, batch)
    return torch.autograd.grad(loss, list(params.values()))


def dry_peak(model, fn) -> int:
    """The dry trace's peak of ``fn(model, params, batch)`` on fake
    tensors of the model's params and a 2 x 512 batch."""
    from repro_torch.core import dry
    with dry.fake_mode():
        params = {k: v.requires_grad_(True) for k, v in
                  model.init(SEED).items()}
        batch = {k: torch.zeros((TUNE_BATCH, TUNE_SEQ), dtype=torch.long,
                                device="cuda") for k in ("tokens", "labels")}
        with dry.traced(params) as trace:
            fn(model, params, batch)
    return trace.peak_bytes


def session_autotune(cfg):
    """Phase 12 (d): ``AutoTuner.pick`` over the forward and backward at
    2 x 512 under remat none, full and group:4, each candidate's
    workspace its dry-traced peak, the budget between the largest two
    peaks; each candidate's peak measured (the params counted, as the
    trace counts them) and its µs a call (3 calls) printed beside."""
    from repro_torch.core import memory as mem_mod
    from repro_torch.core.autotune import AutoTuner, Candidate
    params = {k: v.requires_grad_(True) for k, v in
              Model(cfg, device="cuda").init(SEED).items()}
    batch = {k: torch.from_numpy(v[:TUNE_BATCH, :TUNE_SEQ]).long().cuda()
             for k, v in train_batches(cfg)[0].items()}
    models = {r: Model(cfg, device="cuda", remat=r) for r in TUNE_REMAT}
    rows = {}
    ops.reset_launches()
    for remat, model in models.items():
        traced = dry_peak(model, fwd_bwd)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd(model, params, batch)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base \
            + mem_mod.tree_bytes(params)
        rows[remat] = dict(traced_peak=traced, measured_peak=measured)
    peaks = sorted(r["traced_peak"] for r in rows.values())
    require(rows["none"]["traced_peak"] == peaks[-1] > peaks[-2],
            f"remat none is not the largest traced peak: {rows}")
    budget = (peaks[-1] + peaks[-2]) // 2
    tuner = AutoTuner(budget_bytes=budget, warmup=1, iters=3)
    choice = tuner.pick(
        ("fwd_bwd", ARCH, TUNE_BATCH, TUNE_SEQ),
        [Candidate(r, lambda m=m: fwd_bwd(m, params, batch),
                   workspace_bytes=rows[r]["traced_peak"])
         for r, m in models.items()])
    launches = ops.dispatch_report()
    for remat, model in models.items():
        rows[remat]["us"] = 1e6 * event_ms(
            lambda m=model: fwd_bwd(m, params, batch), iters=3) / 1e3
        r = rows[remat]
        print(f"autotune {remat:8s}: traced peak {r['traced_peak']} B, "
              f"measured {r['measured_peak']} B (ratio "
              f"{r['traced_peak'] / r['measured_peak']:.3f}), "
              f"{r['us']:.0f} us a call", flush=True)
    print(f"autotune: budget {budget} B; choice {choice.name} "
          f"({choice.us_per_call:.0f} us a call in the tuner), "
          f"disqualified {list(choice.disqualified)}", flush=True)
    require(choice.disqualified == ("none",) and choice.name != "none",
            f"the budget did not disqualify remat none alone: {choice}")
    return dict(budget=budget, choice=choice.name,
                us_per_call=choice.us_per_call,
                disqualified=list(choice.disqualified), candidates=rows), \
        launches


def session_dry(cfg):
    """Phase 12 (e)-(g): the dry-run CLI in a subprocess on 16 x 16; one
    rank's 2 x 512 step dry-traced against its measured peak; phase 10's
    (2, 2) cell dry-traced on 4 fake ranks, its wire against the
    layouts' estimate; the backend ``init_group`` picks."""
    import torch.distributed as dist
    from repro_torch.api import Session
    from repro_torch.core.distributed import (close_group, init_group,
                                              select_backend)
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    out = {}
    # (e)
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    text, secs = cli(["repro_torch.launch.dryrun", "--arch", ARCH, "--shape",
                      "train_4k", "--out", str(TRAIN_DIR / "dryrun")],
                     timeout=300)
    shutil.rmtree(TRAIN_DIR / "dryrun", ignore_errors=True)
    require(text.strip().splitlines()[-1] == "ALL DRY-RUN CELLS PASSED",
            "the dry run did not pass")
    out["dryrun_cli"] = dict(seconds=secs, line=next(
        ln for ln in text.splitlines() if ln.startswith("OK ")))
    # (f) one rank: traced against measured
    sess = Session()
    plan = sess.plan(ARCH, batch=TUNE_BATCH, seq=TUNE_SEQ, comms="off",
                     adamw=train_adamw())
    trace, _ = sess.dryrun(plan)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sess.init_state(plan, seed=SEED)
    batch = {k: v[:TUNE_BATCH, :TUNE_SEQ]
             for k, v in train_batches(cfg)[0].items()}
    sess.step(plan, batch)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    ratio = trace.peak_bytes / measured
    print(f"dry trace, one rank, {TUNE_BATCH} x {TUNE_SEQ}: traced peak "
          f"{trace.peak_bytes} B, one step's max_memory_allocated {measured} "
          f"B, ratio {ratio:.3f} (traced {trace.trace_s:.2f} s, kernels "
          f"{trace.kernel_calls})", flush=True)
    require(0.5 <= ratio <= 2.0, f"traced/measured peak {ratio:.3f} is "
            "outside 0.5-2.0")
    sess.evict("train_state")
    del sess
    out["one_rank"] = dict(traced_peak=trace.peak_bytes, measured=measured,
                           ratio=ratio, trace_s=trace.trace_s)
    # (f) phase 10's (2, 2) cell on 4 fake ranks
    with fake_world(HYBRID_RANKS):
        mesh = make_mesh((2, 2), ("data", "model"))
        sess = Session(mesh=mesh)
        plan = sess.plan(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, comms="off",
                         adamw=train_adamw(), microbatches=1)
        trace, meta = sess.dryrun(plan)
        est = hybrid_wire_estimate(plan.model, mesh, TRAIN_BATCH, TRAIN_SEQ)
    print(f"dry trace, phase 10's (2, 2) cell ({meta['plan']['attn_mode']}, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}): peak {trace.peak_bytes} B a rank, "
          f"wire {trace.wire_bytes} B a rank a step {trace.collectives} "
          f"(estimate {sum(est.values())}, phase 10 measured "
          f"{HYBRID_WIRE_2X2})", flush=True)
    require(trace.collectives == est
            and trace.wire_bytes == HYBRID_WIRE_2X2,
            "the traced wire differs from the layouts' estimate")
    out["hybrid_2x2"] = dict(traced_peak=trace.peak_bytes,
                             wire_bytes=trace.wire_bytes,
                             collectives=trace.collectives)
    # (g) the backend: four ranks on the one card, and one rank alone
    cards = torch.cuda.device_count()
    four = select_backend("cuda", cards, HYBRID_RANKS, 0)
    (TRAIN_DIR / "rendezvous_nccl").unlink(missing_ok=True)
    init_group(f"file://{TRAIN_DIR / 'rendezvous_nccl'}", rank=0,
               world_size=1)
    one = dist.get_backend()
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    close_group()
    (TRAIN_DIR / "rendezvous_nccl").unlink(missing_ok=True)
    print(f"init_group's backend on {cards} card(s): {four} for "
          f"{HYBRID_RANKS} ranks (phases 6, 7, 9-11), {one} for one rank "
          f"(an all-reduce on it: {x.tolist()})", flush=True)
    require(four == "gloo" and one == "nccl" and x.tolist() == [1.0] * 4,
            f"init_group chose {four} and {one}")
    out["backend"] = {f"{HYBRID_RANKS} ranks": four, "1 rank": one}
    return out


def session_phase():
    """Phase 12: (a)-(c) serve through the Session, (d) autotune, (e)-(g)
    the dry traces and the backend.  Returns the summary and the
    launches by path."""
    cfg = get_config(ARCH)
    summary, serve_launches = session_serve(cfg)
    torch.cuda.empty_cache()
    summary["autotune"], tune_launches = session_autotune(cfg)
    torch.cuda.empty_cache()
    summary.update(session_dry(cfg))
    torch.cuda.empty_cache()
    print("session " + json.dumps(summary), flush=True)
    return summary, {SESSION_PATH: serve_launches, TUNE_PATH: tune_launches}



# ---------------------------------------------------------------------------
# phase 13: the pipeline, GPipe and 1F1B, four ranks
# ---------------------------------------------------------------------------

PIPE_RANKS = 4
PIPE_BATCH = 8                         # 8 x 512 tokens, one-row microbatches
PIPE_STEPS = 2
# (data, pipe) meshes of qwen2-0.5b at full width, each under both
# schedules; M = 2 pp microbatches, one row each.  Depth cut to 4 of its
# 24 layers (1 a stage on (1, 4), 2 on (2, 2)) since phase 17 came (8
# since phase 14): the whole script stays inside its time limit
PIPE_MESHES = ((1, 4), (2, 2))
PIPE_LAYERS = 4
PIPE_SCHEDULES = ("gpipe", "1f1b")
# mamba2-780m at full width cut to 8 of its 48 layers: (mesh, layers,
# schedule)
PIPE_MAMBA = ((1, 4), 8, "1f1b")
PIPE_PATH = (f"{ARCH} (1,4), (2,2) ({PIPE_LAYERS} layers) and {MAMBA} "
             "(1,4, 8 layers) pipeline train (4 ranks, gloo)")
PIPE_DEVICE = "cuda"
PIPE_STEP_LOSS_RTOL = 1e-6
PIPE_NORM_RTOL = 2.0 ** -9


def pipe_cells():
    """Phase 13's cells: (tag, config, (data, pipe), schedule, yardstick
    name)."""
    import dataclasses
    shape, layers_, sched = PIPE_MAMBA
    mcfg = dataclasses.replace(get_config(MAMBA), n_layers=layers_)
    qcfg = dataclasses.replace(get_config(ARCH), n_layers=PIPE_LAYERS)
    return ([(f"{d}x{p} {s}", qcfg, (d, p), s, "")
             for d, p in PIPE_MESHES for s in PIPE_SCHEDULES]
            + [(f"{MAMBA} {shape[0]}x{shape[1]} {sched}", mcfg, shape, sched,
                "_mamba2")])


def pipe_yard(name: str) -> Path:
    """The one-rank yardstick's state after step 1."""
    return TRAIN_DIR / f"pipe_yardstick{name}1.pt"


def pipe_batches(cfg):
    from repro_torch.data import SyntheticLM
    data = iter(SyntheticLM(cfg.vocab_size, PIPE_BATCH, TRAIN_SEQ,
                            seed=SEED, structured=True))
    return [next(data) for _ in range(PIPE_STEPS)]


class LossTape:
    """Records the hex bits of every ``layers.lm_loss`` value while
    installed, with whether autograd was recording (1F1B's forward slot
    runs without it, its backward slot's recompute with it)."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers, self.real, self.seen = layers, layers.lm_loss, []

    def __enter__(self):
        def rec(logits, labels, **kw):
            loss, den = self.real(logits, labels, **kw)
            self.seen.append((float(loss.detach()).hex(),
                              torch.is_grad_enabled()))
            return loss, den
        self.layers.lm_loss = rec
        return self

    def __exit__(self, *exc):
        self.layers.lm_loss = self.real

    def forward_losses(self, schedule: str):
        """The microbatches' losses in order: 1F1B's forward slot's (its
        recomputes must be the same bits), GPipe's one each."""
        if schedule != "1f1b":
            return [v for v, _ in self.seen]
        fwd = [v for v, grad in self.seen if not grad]
        require(fwd == [v for v, grad in self.seen if grad],
                "1F1B: a backward slot's recomputed loss is not the "
                "forward slot's bits")
        return fwd


def pipe_yardstick(cfg, name, batches):
    """The one-rank step (path gspmd, no mesh) on the phase's batches in
    one-row microbatches: per step its metrics and microbatch losses; its
    state after step 1 saved for the ranks."""
    from repro_torch.api import Session
    sess = Session(device=PIPE_DEVICE)
    plan = sess.plan(cfg, batch=PIPE_BATCH, seq=TRAIN_SEQ, comms="off",
                     adamw=train_adamw(), microbatches=PIPE_BATCH)
    require(plan.path == "gspmd" and plan.model.mesh is None
            and plan.num_microbatches == PIPE_BATCH,
            "the pipeline's yardstick is the one-rank path")
    sess.init_state(plan, seed=SEED)
    out = []
    for t in range(PIPE_STEPS):
        with LossTape() as tape:
            m = sess.step(plan, batches[t])
        out.append(dict({k: float(v) for k, v in m.items()},
                        microbatch_losses=tape.forward_losses("gpipe")))
        if t == 0:
            opt_state = sess.state["train_state"]["opt"]
            TRAIN_DIR.mkdir(parents=True, exist_ok=True)
            torch.save(yard_state(opt_state), pipe_yard(name))
    del sess, plan
    torch.cuda.empty_cache()
    print(f"pipeline yardstick {cfg.name} ({cfg.n_layers} layers, one "
          f"rank, {PIPE_BATCH} one-row microbatches): "
          + json.dumps([{k: v for k, v in m.items()
                         if k != "microbatch_losses"} for m in out]),
          flush=True)
    return out


def expected_pipe_launches(cfg, n_local: int, last: bool, M: int,
                           schedule: str, steps: int):
    """Per rank: each of the M microbatches runs the stage's layers
    forward (GPipe once with autograd; 1F1B once without it in the
    forward slot and once with it in the backward slot), their recompute
    in the backward (remat="full", each layer checkpointed) and their
    backward; the last stage adds the head's unembed to each forward and
    two products to each backward.  Dense layers run 7 products and one
    attention, ssm layers 5 products and one SSD forward."""
    per = 5 if cfg.family == "ssm" else 7
    fwd = per * n_local + int(last)
    runs = 2 if schedule == "1f1b" else 1
    mm = M * (runs * fwd + per * n_local + 2 * fwd)
    mix = M * (runs + 1) * n_local
    dense = cfg.family != "ssm"
    return launch_counts(matmul=steps * mm,
                         attention=steps * mix if dense else 0,
                         attention_backward=(steps * M * n_local if dense
                                             else 0),
                         ssd=0 if dense else steps * mix,
                         ssd_backward=0 if dense else steps * M * n_local)


def pipe_wire_estimate(plan, mesh):
    """Bytes this rank receives in one step besides the stage boundary's
    ``send_recv``, by collective, from the layouts (``WIRE``'s
    accounting, as :func:`hybrid_wire_estimate`'s): each edge leaf's
    fp32 gradient broadcast over ``pipe`` from the stage that uses it;
    the loss sums over ``pipe`` (3 fp32); over the data axis the
    gradients' reduce-scatter onto their ZeRO blocks (fp32; a sum where
    the ZeRO layout leaves the axis), the metrics' mean and the
    parameters' gather back (bf16, mamba2's fp32 leaves fp32); the grad
    norm's sum over every axis."""
    import collections
    from repro_torch.pipeline import pipeline_param_specs
    from repro_torch.pipeline.schedule import _edge_stage
    from repro_torch.core.replication import zero_layout
    spec = plan.pipeline
    pp, nd = mesh.shape["pipe"], mesh.shape["data"]
    s = mesh.coords["pipe"]
    est = collections.Counter()

    def ps(nbytes, n):
        est["all_reduce"] += ((n - 1) * nbytes if n > 2
                              else nbytes if n == 2 else 0)

    specs = pipeline_param_specs(plan.model, spec)
    for name, sp in specs.items():
        storage = sp.layout
        zero = zero_layout(storage, sp.shape, mesh)
        block = math.prod(storage.local_shape(sp.shape, mesh)) * 4
        if not name.startswith("layers.") and pp > 1 \
                and _edge_stage(name, pp) != s:
            est["broadcast"] += block
        if nd > 1:
            if "data" in zero.mesh_axes_used():
                est["all_to_all"] += (nd - 1) * block // nd
                zblock = (math.prod(zero.local_shape(sp.shape, mesh))
                          * sp.dtype.itemsize)
                est["all_gather"] += (nd - 1) * zblock
            else:
                ps(block, nd)
    ps(12, pp)                                  # the loss sums over pipe
    ps(12, nd)                                  # the metrics' mean
    for a in ("data", "pipe"):                  # the grad norm's sum
        ps(4 * len(specs), mesh.shape[a])
    return {k: v for k, v in est.items() if v}


def card_free_bytes() -> int:
    """The card's free bytes now, over every process on it (four ranks
    and the parent share the one card): a reading of the headroom."""
    return torch.cuda.mem_get_info()[0]


class ExchangeClock:
    """Host seconds inside ``distributed.exchange`` (the stage
    boundary's sends and receives, waiting for the other stage
    included)."""

    def __init__(self):
        from repro_torch.core import distributed as D
        self.D, self.real, self.seconds = D, D.exchange, 0.0

    def __enter__(self):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return self.real(*a, **k)
            finally:
                self.seconds += time.perf_counter() - t0
        self.D.exchange = timed
        return self

    def __exit__(self, *exc):
        self.D.exchange = self.real


class MicrobatchSums:
    """While installed, each microbatch's gradients of the stage's
    parameters (``torch.autograd.grad`` of the pipeline's leaves) add
    their magnitudes to an fp32 sum; :meth:`terms` combines these as the
    step combines the gradients (an edge leaf's from the stage that uses
    it, over ``pipe``; the batch axes' sum onto the ZeRO blocks, and its
    mean), ``WIRE``'s counts left as they were: each element's sum of
    its terms' magnitudes, the M microbatches of every data row."""

    def __init__(self, params):
        self.params, self.sums = params, {}
        self.names = list(params)
        self.ids = [id(p) for p in params.values()]

    def __enter__(self):
        self.real = torch.autograd.grad

        def grad(outputs, inputs, *a, **k):
            out = self.real(outputs, inputs, *a, **k)
            ins = list(inputs) if isinstance(inputs, (list, tuple)) \
                else [inputs]
            if [id(x) for x in ins[:len(self.ids)]] == self.ids:
                for name, g in zip(self.names, out):
                    if g is not None:
                        mag = g.detach().abs().float()
                        self.sums[name] = (self.sums[name] + mag
                                           if name in self.sums else mag)
            return out
        torch.autograd.grad = grad
        return self

    def __exit__(self, *exc):
        torch.autograd.grad = self.real

    def terms(self, plan, mesh, zero):
        from repro_torch.core import distributed as D
        from repro_torch.core import precision
        from repro_torch.pipeline.schedule import _edge_stage
        from repro_torch.train import step as step_mod
        spec = plan.pipeline
        axes = step_mod.batch_axes_of(mesh)
        n_rows = math.prod(mesh.shape[a] for a in axes)
        saved = (D.WIRE.bytes, D.WIRE.calls, D.WIRE.dtypes)
        D.WIRE.reset()
        out = {}
        try:
            for name, p in self.params.items():
                T = self.sums.get(name)
                if T is None:
                    T = torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                if not name.startswith("layers."):
                    T = D.broadcast(T, mesh, spec.axis,
                                    _edge_stage(name, spec.n_stages))
                T = step_mod.sync_to_zero(T, zero.storage[name],
                                          zero.zero[name], axes, mesh)
                if n_rows > 1:
                    T = precision.div_count(T, n_rows)
                out[name] = Terms(T, spec.num_microbatches * n_rows, FP32_U,
                                  0, FP32_U)
        finally:
            D.WIRE.bytes, D.WIRE.calls, D.WIRE.dtypes = saved
        return out


def pipe_warmup(cfg):
    """A rank's first calls of the kernels and their plain versions, run
    alone before the timed cells (one layer's loss and gradients on one
    row, each product and attention call held against its plain version,
    the results discarded): the pipeline would otherwise queue every
    stage's first-call costs one after the other."""
    model = Model(dataclasses.replace(cfg, n_layers=1), device=PIPE_DEVICE)
    params = model.init(SEED)
    for p in params.values():
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(np.asarray(v)[:1], device=PIPE_DEVICE)
             for k, v in pipe_batches(cfg)[0].items()}
    held = HeldKernels()
    held.install()
    try:
        loss, _ = model.loss_fn(params, batch)
        torch.autograd.grad(loss, list(params.values()))
    finally:
        held.uninstall()
    torch.cuda.synchronize()
    del model, params, held


def pipe_rank(rank, init, result_path, yards):
    """One rank of phase 13; writes its results as JSON to
    ``result_path`` with its number in place of ``{}``."""
    import torch.distributed as dist
    from repro_torch.api import Session
    from repro_torch.core.distributed import WIRE, close_group, init_group
    from repro_torch.pipeline import costs
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(init, rank=rank, world_size=PIPE_RANKS, device=PIPE_DEVICE)
    out = dict(rank=rank, cells={})
    t0 = time.perf_counter()
    pipe_warmup(get_config(ARCH))
    out["warmup_s"] = time.perf_counter() - t0
    for tag, cfg, (dp, pp), sched, name in pipe_cells():
        t_cell = time.perf_counter()
        what = f"pipeline {tag} rank {rank}"
        batches = pipe_batches(cfg)
        sess = Session(device=PIPE_DEVICE, group=dist.group.WORLD, pp=pp)
        mesh = sess.mesh
        plan = sess.plan(cfg, batch=PIPE_BATCH, seq=TRAIN_SEQ, comms="off",
                         adamw=train_adamw(), microbatches=2 * pp,
                         pp_schedule=sched)
        spec = plan.pipeline
        require(plan.path == "pipeline" and spec.schedule == sched
                and spec.num_microbatches == PIPE_BATCH // dp == 2 * pp
                and dict(mesh.shape) == {"data": dp, "pipe": pp,
                                         "model": 1},
                f"{what}: plan {plan.path} {spec} {dict(mesh.shape)}")
        sess.init_state(plan, seed=SEED)
        setup_s = time.perf_counter() - t_cell
        check_s = 0.0
        s = mesh.coords["pipe"]
        held = HeldKernels()
        metrics, walls, waits, wires, losses, after = [], [], [], [], [], []
        prof_rank = peak = reserved = None
        free = []        # the card's free bytes after each step and check
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launches()
        for t in range(PIPE_STEPS):
            st = sess.state["train_state"]
            if t == 0:         # for the checks after step 1
                p_start = {k: v.detach().clone()
                           for k, v in st["params"].items()}
                before = {k: v.clone() for k, v in st["opt"]["mu"].items()}
            WIRE.reset()
            held.install()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            profiled = t == PIPE_STEPS - 1
            prof = (torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    if profiled else contextlib.nullcontext())
            sums = (MicrobatchSums(st["params"]) if t == 0
                    else contextlib.nullcontext())
            with LossTape() as tape, ExchangeClock() as clock, prof, sums:
                t0 = time.perf_counter()
                lo = time.time_ns()
                m = sess.step(plan, batches[t])
                torch.cuda.synchronize()
                hi = time.time_ns()
                walls.append(1e3 * (time.perf_counter() - t0))
            held.uninstall()
            if t == 1:      # step 2 holds no copy kept for the checks
                peak = torch.cuda.max_memory_allocated()
                reserved = torch.cuda.max_memory_reserved()
            free.append(card_free_bytes())
            if profiled:
                prof_rank = dict(rank=rank, profiled_window_ns=[lo, hi],
                                 device_intervals_ns=device_intervals(prof))
            waits.append(1e3 * clock.seconds)
            wires.append(dict(WIRE.bytes))
            metrics.append({k: float(v) for k, v in m.items()})
            losses.append(tape.forward_losses(sched)
                          if s == pp - 1 else [])
            if t == 0:
                t_check = time.perf_counter()
                yard = torch.load(pipe_yard(name), mmap=True)
                reading, blocks = hybrid_after_step(
                    sess, plan, mesh, yard, p_start, metrics[t]["lr"],
                    f"{what} after step 1",
                    terms=sums.terms(plan, mesh, sess.zero_layouts(plan)),
                    before=before, norms=(metrics[t]["grad_norm"],
                                          yards[name][t]["grad_norm"]))
                after.append(reading)
                # step 2 starts from the yardstick's state after step 1
                hybrid_restart(sess, plan, yard, blocks)
                free.append(card_free_bytes())
                del yard, sums, p_start, before, blocks
                torch.cuda.empty_cache()
                check_s = time.perf_counter() - t_check
        launches = ops.dispatch_report()
        st = sess.state["train_state"]["params"]
        edge_same = same_on_every_rank(params_digest(
            {k: st[k] for k in ("embed", "unembed", "final_norm")}))
        mm_bwd, att_bwd = held.backward_checks()
        rows = PIPE_BATCH // dp // spec.num_microbatches
        act = costs.boundary_act_bytes(rows, TRAIN_SEQ, cfg.d_model)
        out["cells"][tag] = dict(
            coords=mesh.coords, layers=cfg.n_layers, schedule=sched,
            microbatches=spec.num_microbatches, metrics=metrics,
            microbatch_losses=losses, walls_ms=walls, exchange_ms=waits,
            wire_bytes=wires, wire_estimate=pipe_wire_estimate(plan, mesh),
            boundary_wire_bytes=costs.boundary_wire_bytes(
                act, pp, spec.num_microbatches),
            bubble=spec.bubble_fraction(), peak_bytes=peak,
            reserved_peak_bytes=reserved, card_free_bytes=free,
            stage_footprint_bytes=plan.footprints[s].total,
            launches=launches, edge_params_same_on_every_rank=edge_same,
            expected=expected_pipe_launches(
                cfg, cfg.n_layers // pp, s == pp - 1, spec.num_microbatches,
                sched, PIPE_STEPS),
            profiled=prof_rank, after_step=after,
            gemm_cases=len(held.mm_cases), flash_cases=len(held.att_cases),
            ssd_cases=len(held.ssd_cases),
            ssd_backward_cases=len(held.ssd_bwd_cases),
            gemm_max_abs_err=max(held.mm_cases.values()),
            flash_max_abs_err=max(held.att_cases.values(), default=0.0),
            ssd_max_abs_err=max(held.ssd_cases.values(), default=0.0),
            ssd_backward_max_rel_err=max(held.ssd_bwd_cases.values(),
                                         default=0.0),
            gemm_backward_max_abs_err=mm_bwd,
            flash_backward_max_abs_err=att_bwd,
            cell_s=time.perf_counter() - t_cell, setup_s=setup_s,
            check_s=check_s)
        del sess, plan, st
        torch.cuda.empty_cache()
    Path(result_path.format(rank)).write_text(json.dumps(out))
    dist.barrier()
    close_group()


def pipe_check_cell(tag, cfg, shape, sched, ranks, yard):
    """Phase 13's gates on one cell (the ranks' results, the yardstick's
    steps) and its readings."""
    dp, pp = shape
    rows = sorted((r["cells"][tag] | {"rank": r["rank"]} for r in ranks),
                  key=lambda r: r["rank"])
    for t in range(PIPE_STEPS):
        # step 1 from the seed, step 2 from the yardstick's state after
        # step 1: the same rows through the same row-invariant kernels
        last = sorted((r for r in rows if r["coords"]["pipe"] == pp - 1),
                      key=lambda r: r["coords"]["data"])
        got = [v for r in last for v in r["microbatch_losses"][t]]
        require(got == yard[t]["microbatch_losses"],
                f"pipeline {tag} step {t + 1}: the microbatch losses are not "
                "the yardstick's bits")
        for r in rows:
            m, w = r["metrics"][t], yard[t]
            require(math.isclose(m["loss"], w["loss"],
                                 rel_tol=PIPE_STEP_LOSS_RTOL),
                    f"pipeline {tag} rank {r['rank']} step {t + 1}: loss "
                    f"{m['loss']} against the yardstick's {w['loss']}")
            require(math.isclose(m["grad_norm"], w["grad_norm"],
                                 rel_tol=PIPE_NORM_RTOL),
                    f"pipeline {tag} rank {r['rank']} step {t + 1}: grad "
                    f"norm {m['grad_norm']} against {w['grad_norm']}")
            require(m["lr"] == w["lr"], f"pipeline {tag}: lr")
    for r in rows:
        require(r["edge_params_same_on_every_rank"],
                f"pipeline {tag}: the edge params differ across ranks")
        require(r["launches"] == r["expected"],
                f"pipeline {tag} rank {r['rank']}: launches {r['launches']} "
                f"against the stage's layer structure {r['expected']}")
        for t, wire in enumerate(r["wire_bytes"]):
            rest = {k: v for k, v in wire.items() if k != "send_recv"}
            require(rest == r["wire_estimate"],
                    f"pipeline {tag} rank {r['rank']} step {t + 1}: wire "
                    f"{rest} against the layouts' estimate "
                    f"{r['wire_estimate']}")
    for d in range(dp):
        line = [r for r in rows if r["coords"]["data"] == d]
        for t in range(PIPE_STEPS):
            got = sum(r["wire_bytes"][t].get("send_recv", 0) for r in line)
            require(got == line[0]["boundary_wire_bytes"],
                    f"pipeline {tag} data row {d} step {t + 1}: send_recv "
                    f"{got} bytes against boundary_wire_bytes "
                    f"{line[0]['boundary_wire_bytes']}")
    ssm_family = cfg.family == "ssm"
    # (the CPU's SSD backward is autograd's: no call to hold)
    require(all(r["gemm_cases"] and (
        (r["ssd_cases"] and (r["ssd_backward_cases"] or PIPE_DEVICE != "cuda"))
        if ssm_family else r["flash_cases"]) for r in rows),
            f"pipeline {tag}: a rank held no kernel call")
    idle = profiled_idle([r["profiled"] for r in rows])
    cell = dict(
        mesh=f"{dp}x{pp}", schedule=sched, layers=cfg.n_layers,
        microbatches=rows[0]["microbatches"], bubble=rows[0]["bubble"],
        send_recv_bytes_per_line=rows[0]["boundary_wire_bytes"],
        wire_bytes_by_rank=[r["wire_bytes"][0] for r in rows],
        step_walls_ms_by_rank=[r["walls_ms"] for r in rows],
        exchange_ms_by_rank=[r["exchange_ms"] for r in rows],
        exchange_share_by_rank=[[e / w for e, w in
                                 zip(r["exchange_ms"], r["walls_ms"])]
                                for r in rows],
        peak_gib_by_rank=[r["peak_bytes"] / 2**30 for r in rows],
        reserved_peak_gib_by_rank=[r["reserved_peak_bytes"] / 2**30
                                   for r in rows],
        reserved_peak_gib_summed=sum(r["reserved_peak_bytes"]
                                     for r in rows) / 2**30,
        card_free_gib_by_rank=[[b / 2**30 for b in r["card_free_bytes"]]
                               for r in rows],
        card_free_gib_least=min(min(r["card_free_bytes"])
                                for r in rows) / 2**30,
        stage_footprint_gib_by_rank=[r["stage_footprint_bytes"] / 2**30
                                     for r in rows],
        cell_s_by_rank=[r["cell_s"] for r in rows],
        setup_s_by_rank=[r["setup_s"] for r in rows],
        check_s_by_rank=[r["check_s"] for r in rows],
        card_idle=idle["card"], metrics_rank0=rows[0]["metrics"],
        after_step_by_rank=[r["after_step"] for r in rows],
        max_abs_err={k: max(r[k] for r in rows) for k in (
            "gemm_max_abs_err", "flash_max_abs_err",
            "gemm_backward_max_abs_err", "flash_backward_max_abs_err",
            "ssd_max_abs_err", "ssd_backward_max_rel_err")})
    print(f"pipeline {tag}: " + json.dumps(cell), flush=True)
    return cell, rows


def pipe_phase():
    """Phase 13: the one-rank yardsticks, then four ranks spawned on the
    one card over gloo, each cell in turn; returns the summary and the
    ranks' launch counts summed over the cells."""
    import torch.multiprocessing as mp
    init = f"file://{TRAIN_DIR / 'rendezvous_pipe'}"
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    (TRAIN_DIR / "rendezvous_pipe").unlink(missing_ok=True)
    results = [TRAIN_DIR / f"pipe_rank{r}.json" for r in range(PIPE_RANKS)]
    for f in results:
        f.unlink(missing_ok=True)
    yards, files = {}, []
    t0 = time.perf_counter()
    try:
        for tag, cfg, _, _, name in pipe_cells():
            if name not in yards:
                files.append(pipe_yard(name))
                yards[name] = pipe_yardstick(cfg, name, pipe_batches(cfg))
        print(f"pipeline yardsticks: {time.perf_counter() - t0:.1f} s; the "
              f"parent holds {torch.cuda.memory_reserved() / 2**30:.3f} GiB "
              f"reserved, the card {card_free_bytes() / 2**30:.3f} GiB "
              "free at the spawn", flush=True)
        mp.spawn(pipe_rank, args=(init, str(TRAIN_DIR / "pipe_rank{}.json"),
                                  yards),
                 nprocs=PIPE_RANKS, join=True)
    finally:
        for f in files:
            f.unlink(missing_ok=True)
    ranks = [json.loads(f.read_text()) for f in results]
    for f in results:
        f.unlink()
    total, summary = {}, dict(arch=ARCH, ranks=PIPE_RANKS,
                              backend="gloo (host memory), one card",
                              tokens_per_step=PIPE_BATCH * TRAIN_SEQ,
                              cells={})
    for tag, cfg, shape, sched, name in pipe_cells():
        cell, rows = pipe_check_cell(tag, cfg, shape, sched, ranks,
                                     yards[name])
        summary["cells"][tag] = cell
        for r in rows:
            for op, n in r["launches"].items():
                total[op] = total.get(op, 0) + n
    summary["warmup_s_by_rank"] = [r["warmup_s"] for r in ranks]
    for d, p in PIPE_MESHES:
        g, o = (summary["cells"][f"{d}x{p} {s}"] for s in PIPE_SCHEDULES)
        ratio = [b / a if a else None for a, b in zip(
            g["peak_gib_by_rank"], o["peak_gib_by_rank"])]
        print(f"pipeline {d}x{p}: 1F1B's peak over GPipe's by rank {ratio}",
              flush=True)
    print("pipeline " + json.dumps({k: v for k, v in summary.items()
                                    if k != "cells"}), flush=True)
    return summary, total


# ---------------------------------------------------------------------------
# phase 14: the moe family (deepseek-moe-16b; dbrx-132b's bank shapes)
# ---------------------------------------------------------------------------

MOE = "deepseek-moe-16b"
DBRX = "dbrx-132b"
# the specs' leaves summed: the config's param_count() (it counts the
# router and the norms too)
MOE_PARAMS = 16_879_568_896
# Expert-bank products (E, cap, K) @ (E, K, N): deepseek's 64 experts at
# the capacities its paths give (a decode step of 8 slots, a 128-token
# paged chunk, a 512-token prefill, a 2 x 512 train step), dbrx's 16 at a
# decode step and a 128-token chunk (its 6144 -> 10752 -> 6144 banks)
MOE_BANKS = ((MOE, 64, ((2048, 1408), (1408, 2048)), (8, 15, 60, 120)),
             (DBRX, 16, ((6144, 10752), (10752, 6144)), (8, 40)))
# A (token, layer) top-k set may differ between two runs of the same
# layers (card against CPU, prefill-then-decode against the forward) only
# where the reference run's margin between the k-th and (k+1)-th
# probability is under this.  The card's and the CPU's router inputs part
# by bf16 roundings of the residual (phase 4: ~0.3% of the largest logit
# at 2 layers, growing with depth); the fp32 router product over D = 2,048
# with weights of std 0.02 turns a relative drift r of the residual into
# router logits that move by ~0.02 * sqrt(2048) * r ~ 1e-2 at r = 1%, and
# a top-6 probability near 1/30 by ~3e-4.  Held at 2e-3, six times that.
MOE_MARGIN = 2e-3
MOE_CPU_LAYERS, MOE_CPU_PROMPT, MOE_DECODE = 6, 96, 4
# prefill-then-decode against the forward, 16 prompt tokens then 4 steps:
# capacity is per call (the forward's from all 20 tokens, the prefill's
# from 16, a decode step's from 1), and random weights route most tokens
# of a deep model alike, so the forward drops where the decode steps do
# not, by design (the reference's too).  The check runs the same weights
# at capacity factor E / k, where every copy has a slot, to hold the
# steps' numerics alone.
MOE_DEPTH_PROMPT = 16
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH = 4, 2
MOE_DEVICE = "cuda"                   # "cpu" for a rehearsal off the card


def moe_products_per_layer(cfg) -> int:
    """GEMM launches a moe layer makes per forward: q, k, v, o, the
    router, the three bank products (one batched launch each) and the
    shared experts' three."""
    return 4 + 1 + 3 + (3 if cfg.n_shared_experts else 0)


def moe_serve_launches(cfg, steps: int, calls: int, attention: int):
    """Launches of an engine over ``steps`` decode steps and ``calls``
    prefill calls (one-slot prefills, or paged chunks), ``attention``
    flash calls a layer each: the layer loop's products and the unembed
    per call and per step, one paged-decode call a layer per step."""
    L = cfg.n_layers
    return launch_counts(
        matmul=(moe_products_per_layer(cfg) * L + 1) * (steps + calls),
        attention=L * attention, paged_decode_attention=L * steps)


def expected_moe_train_launches(cfg, steps: int):
    """Per step on one rank under ``remat="full"``: every layer's
    products and flash call in the forward and again in the recompute,
    two backward products (dA, dB) for each forward product, the unembed
    not checkpointed, one attention backward a layer."""
    L = cfg.n_layers
    fwd = moe_products_per_layer(cfg) * L + 1
    return launch_counts(matmul=steps * (fwd + (fwd - 1) + 2 * fwd),
                         attention=steps * 2 * L,
                         attention_backward=steps * L)


def check_expert_gemm():
    """Phase 14 (a): the GEMM's batched mode at the expert-bank shapes:
    each against its plain version (the 2-D plain version per expert),
    bitwise the 2-D kernel expert by expert, the same bits run to run;
    the backward's dA = dC·Bᵀ and dB = Aᵀ·dC on the transposed views,
    bitwise the 2-D kernel per expert; each timed beside its bound, the
    plain version and ``torch.bmm``.  Returns the row, headed by
    deepseek's decode shape."""
    shapes, errs = [], []
    print("gemm batched: arch E cap K N | plan | kernel ms | bound ms (by) |"
          " plain ms | torch.bmm ms | max abs err")
    for arch, E, kns, caps in MOE_BANKS:
        for K, N in kns:
            n = copies(2 * E * K * N)
            bs = [randn((E, K, N), 300 + K + j, 0.02) for j in range(n)]
            for M in caps:
                a = randn((E, M, K), 400 + M)
                out = gemm_mod.matmul(a, bs[0], torch.float32)
                what = f"gemm batched {arch} ({E}, {M}, {K}) @ ({K}, {N})"
                err = max_err(out, ref.matmul(a, bs[0], torch.float32), what)
                each = all(same_bits(out[e], gemm_mod.matmul(
                    a[e], bs[0][e], torch.float32)) for e in range(E))
                again = same_bits(out, gemm_mod.matmul(a, bs[0],
                                                       torch.float32))
                dc = randn((E, M, N), 500 + M)
                da = gemm_mod.matmul(dc, bs[0].mT, torch.bfloat16)
                db = gemm_mod.matmul(a.mT, dc, torch.bfloat16)
                bwd_err = max(
                    max_err(da, ref.matmul(dc, bs[0].mT, torch.bfloat16),
                            what + " dA"),
                    max_err(db, ref.matmul(a.mT, dc, torch.bfloat16),
                            what + " dB"))
                bwd_each = all(
                    same_bits(da[e], gemm_mod.matmul(dc[e], bs[0][e].t(),
                                                     torch.bfloat16))
                    and same_bits(db[e], gemm_mod.matmul(a[e].t(), dc[e],
                                                         torch.bfloat16))
                    for e in range(E))
                require(each and again and bwd_each,
                        f"{what}: per expert bitwise {each}, run to run "
                        f"{again}, backward per expert bitwise {bwd_each}")
                del da, db, dc
                ms = cuda_ms([lambda b=b: gemm_mod.matmul(a, b, torch.float32)
                              for b in bs], iters=max(10, 2 * n))
                plain = cuda_ms([lambda: ref.matmul(a, bs[0],
                                                    torch.float32)],
                                iters=2, warmup=1)
                lib = cuda_ms([lambda b=b: torch.bmm(a, b) for b in bs],
                              iters=max(10, 2 * n))
                bms, by = bound(*roofline.matmul_cost(M, K, N, batch=E))
                errs += [err, bwd_err]
                shapes.append(dict(arch=arch, experts=E, cap=M, K=K, N=N,
                                   ms=ms, bound_ms=bms, bound_by=by,
                                   plain_ms=plain, library_ms=lib,
                                   max_abs_err=max(err, bwd_err)))
                print(f"gemm batched {arch} {E} {M:4d} {K:6d} {N:6d} | "
                      f"{plan_label(M, K, N)} | {ms:.4f} | {bms:.4f} ({by}) "
                      f"| {plain:.4f} | {lib:.4f} | {max(err, bwd_err):.3g}",
                      flush=True)
                del a
            del bs
            torch.cuda.empty_cache()
    head = shapes[0]
    print("gemm batched: every expert's slice bitwise the 2-D kernel, run to "
          "run bitwise, forward and backward (transposed views)", flush=True)
    return dict(name="gemm_batched", route="cuda",
                source="src/repro_torch/kernels/csrc/gemm.cu",
                replaces="src/repro/kernels/gemm.py:45",
                case=(f"{MOE}'s gate bank at a decode step: (64, 8, 2048) @ "
                      "(64, 2048, 1408), one launch"),
                max_abs_err=max(errs), ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                shapes=shapes)


def moe_route_diff(got, want, what):
    """Routes of a run forced onto another's (``moe.force_routes``;
    ``want`` the forcing run's ``moe.record_routes`` list, ``got`` the
    forced run's, in call order): where the forced run's own top-k set
    differs from the one it was given, its own margin between the k-th and
    (k+1)-th probability must be under ``MOE_MARGIN`` (the two runs' inputs
    part by roundings alone, so only a near tie can flip); the experts it
    dispatched to and kept are the forcing run's.  Returns a summary."""
    require(len(got) == len(want), f"{what}: {len(got)} routed calls "
                                   f"against {len(want)}")
    flips, margins = 0, []
    for g, w in zip(got, want):
        require(torch.equal(g["kept"].sort(-1).values,
                            w["kept"].sort(-1).values),
                f"{what}: the forced run kept other experts")
        bad = ~(g["idx"].sort(-1).values == w["idx"].sort(-1).values
                ).all(-1)
        flips += int(bad.sum())
        margins += g["margin"][bad].tolist()
        wide = g["margin"][bad & (g["margin"] >= MOE_MARGIN)]
        require(not len(wide), f"{what}: top-k sets differ at margins "
                               f"{wide.tolist()} >= {MOE_MARGIN}")
    out = dict(calls=len(want), decisions=sum(len(w["idx"]) for w in want),
               sets_differing=flips, their_margins=margins,
               least_margin=min(float(g["margin"].min()) for g in got))
    print(f"{what}: routes: {out}", flush=True)
    return out


def moe_against_cpu(cfg, params):
    """The first 6 layers at full width with the model's own embed, norm
    and unembed, on the card and through the plain versions on the CPU:
    a 96-token prompt into a one-slot dense cache, then 4 decode steps
    teacher-forced with the card's greedy tokens.  The CPU runs on the
    card's routes (``moe.force_routes``): its own top-k sets may differ
    only at near ties (:func:`moe_route_diff`), and every logit is held to
    :func:`agree`."""
    from repro_torch.models import moe as moe_mod
    small = dataclasses.replace(cfg, n_layers=MOE_CPU_LAYERS)
    sub = {k: (v[:MOE_CPU_LAYERS] if k.startswith("layers.") else v)
           for k, v in params.items()}
    cpu_params = {k: v.cpu() for k, v in sub.items()}
    prompt = np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, (1, MOE_CPU_PROMPT))
    P, T = MOE_CPU_PROMPT, MOE_CPU_PROMPT + MOE_DECODE
    toks = torch.from_numpy(prompt)

    def run(m, p, tokens):
        cache = m.init_cache(1, T)
        logits, _ = m.prefill(p, tokens[:, :P].to(m.device),
                              last_only=False, cache=cache, slot=0)
        out = [logits[0].float().cpu()]
        for s in range(MOE_DECODE):
            if tokens.shape[1] == P + s:      # the card's run: greedy
                tokens = torch.cat(
                    [tokens, out[-1][-1:].argmax(-1, keepdim=True)], 1)
            logits, _ = m.decode_step(
                p, cache, tokens[:, P + s:P + s + 1].to(m.device),
                torch.tensor([P + s], device=m.device))
            out.append(logits[0].float().cpu())
        return torch.cat(out), tokens

    with torch.no_grad():
        with moe_mod.record_routes() as card_routes:
            card, toks = run(Model(small, device=MOE_DEVICE), sub, toks)
        with moe_mod.record_routes() as cpu_routes, moe_mod.force_routes(
                [r["idx"] for r in card_routes]):
            cpu, _ = run(Model(small, device="cpu"), cpu_params, toks)
    summary = moe_route_diff(cpu_routes, card_routes,
                             f"card vs cpu ({cfg.name}, layers 0-5)")
    summary["logits"] = agree(
        card, cpu, f"card vs cpu logits ({cfg.name}, full width, layers "
                   f"0-5, {P}-token prompt + {MOE_DECODE} steps, the CPU "
                   "on the card's routes)")
    return summary


def moe_depth_check(cfg, params):
    """Prefill-then-decode at full depth against the full forward over the
    same tokens, teacher-forced, on the card: a 16-token prompt and 4
    decode steps, at capacity factor E / k (every copy kept: see
    ``MOE_DEPTH_PROMPT``), the prefill and the steps on the forward's
    routes (:func:`moe_route_diff`), their logits held to phase 4's
    tolerance."""
    from repro_torch.models import moe as moe_mod
    cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = Model(cfg, device=MOE_DEVICE)
    P, L = MOE_DEPTH_PROMPT, cfg.n_layers
    toks = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, (1, P + MOE_DECODE))).to(MOE_DEVICE)
    cache = model.init_cache(1, toks.shape[1])
    steps = []
    with torch.no_grad():
        with moe_mod.record_routes() as full_routes:
            x, _ = model._dense_stack(params, toks)
        full = model._head(params, x[:, P:])[0].float()
        forced = [r["idx"][:P] for r in full_routes] + [
            r["idx"][P + s:P + s + 1] for s in range(MOE_DECODE)
            for r in full_routes]
        want = [{k: v[:P] for k, v in r.items()} for r in full_routes] + [
            {k: v[P + s:P + s + 1] for k, v in r.items()}
            for s in range(MOE_DECODE) for r in full_routes]
        with moe_mod.record_routes() as got, moe_mod.force_routes(forced):
            model.prefill(params, toks[:, :P], cache=cache, slot=0)
            for p in range(P, toks.shape[1]):
                logits, _ = model.decode_step(
                    params, cache, toks[:, p:p + 1],
                    torch.tensor([p], device=MOE_DEVICE))
                steps.append(logits[0, 0].float())
    summary = moe_route_diff(
        got, want, f"prefill-then-decode vs the forward ({cfg.name}, {L} "
                   "layers)")
    summary["logits"] = agree(
        torch.stack(steps).cpu(), full.cpu(),
        f"prefill-then-decode vs the full forward ({cfg.name}, {L} layers, "
        f"{P}-token prompt + {MOE_DECODE} steps)")
    return summary


def serve_moe():
    """Phase 14 (b): deepseek-moe-16b at full width and depth (28 layers,
    64 routed experts top-6 and 2 shared, 16.9 B parameters drawn on the
    card a layer at a time from the seed, every earlier model freed), the
    first 8 of phase 4's requests to 32 new tokens (``SHORT_REQUESTS``)
    through the static ``Engine`` on the dense cache (8 slots,
    ``max_seq`` 1,024) and through ``ContinuousEngine``: launch
    counts (``matmul`` 309 per prefill call and decode step, ``attention``
    28 per prefill call, ``paged_decode_attention`` 28 per decode step),
    serve numbers, a decode step split beside its weight bound, every
    kernel call of 8 one-slot prefills and a decode step against its
    plain version, the first 6 layers against the CPU and
    prefill-then-decode against the full forward (both by the routing
    rule).  Frees the model before it returns."""
    cfg = get_config(MOE)
    model = Model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in params.values())
    require(n_params == MOE_PARAMS and cfg.n_layers == 28,
            f"{MOE}: {n_params} parameters")
    print(f"{MOE}: {n_params} parameters drawn on the card in {init_s:.1f} "
          f"s, peak {init_peak / 2**30:.2f} GiB", flush=True)
    reqs = requests(cfg)
    serve(Engine, model, params, requests(cfg, 2)[:2])          # warm-up
    out, launches = {}, {}
    for tag, cls in (("dense", Engine), ("continuous", ContinuousEngine)):
        ops.reset_launches()
        batched0 = gemm_mod.batched_launches
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        fin, dt, steps = serve(cls, model, params, requests(
            cfg, SHORT_NEW_TOKENS)[:SHORT_REQUESTS])
        got = ops.dispatch_report()
        batched = gemm_mod.batched_launches - batched0
        peak = torch.cuda.max_memory_allocated()
        if tag == "dense":
            calls = attn = len(fin)
        else:
            calls = attn = sum(-(-len(r.prompt) // CHUNK) for r in fin)
        expect = moe_serve_launches(cfg, steps, calls, attn)
        print(f"{MOE} {tag} launches: {got} (expected {expect}: {steps} "
              f"decode steps, {calls} prefill calls); batched bank "
              f"launches {batched} (3 a layer a call: "
              f"{3 * cfg.n_layers * (steps + calls)})", flush=True)
        require(got == expect and got["attention"] > 0
                and got["paged_decode_attention"] > 0,
                f"{MOE} {tag} launch counts do not match the layer loop")
        require(batched == 3 * cfg.n_layers * (steps + calls),
                f"{MOE} {tag}: {batched} batched bank launches")
        stats = serve_stats(MOE, n_params, fin, dt, got, peak, resident)
        stats.update(decode_steps=steps, prefill_calls=calls,
                     batched_launches=batched)
        out[tag], launches[tag] = stats, dict(got, matmul_batched=batched)
    stats = out["dense"]
    stats["continuous"] = out["continuous"]
    embed = cfg.padded_vocab * cfg.d_model
    banks = cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff_expert
    stats.update(
        init_s=init_s, init_peak_gib=init_peak / 2**30,
        decode_step_bound_ms=bound(2 * (n_params - embed), 0)[0],
        decode_step_bank_bound_ms=bound(2 * banks, 0)[0],
        **step_breakdown(cfg, model, params, dense=True))
    print(f"serve {MOE} " + json.dumps(stats), flush=True)
    stats["kernel_calls_max_abs_err"] = check_layer_calls(
        cfg, model, params, [len(r.prompt) for r in reqs[:SLOTS]],
        steps=1, max_seq=MAX_SEQ)
    stats["prefill_decode_vs_forward"] = moe_depth_check(cfg, params)
    stats["card_vs_cpu"] = moe_against_cpu(cfg, params)
    del model, params
    torch.cuda.empty_cache()
    return stats, launches


def moe_train_against_cpu(cfg, params_src):
    """2 layers at full width, one sequence of 128 tokens: loss, aux, grad
    norm and every leaf's gradient on the card against the plain versions
    on the CPU from the same weights (phase 6's tolerances), the CPU on
    the card's routes (``moe.force_routes``; :func:`moe_route_diff`)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod
    small = dataclasses.replace(cfg, n_layers=2)
    toks = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (1, 129))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    params = {k: (v[:2] if k.startswith("layers.") else v).detach()
              for k, v in params_src.items()}
    runs, routes = [], []
    for m, dev in ((Model(small, device=MOE_DEVICE, remat="none"),
                    MOE_DEVICE),
                   (Model(small, device="cpu", remat="none"), "cpu")):
        p = {k: v.to(dev).clone().requires_grad_(True)
             for k, v in params.items()}
        forced = (moe_mod.force_routes([r["idx"] for r in routes[0]])
                  if routes else contextlib.nullcontext())
        with moe_mod.record_routes() as r, forced:
            g, met = step_mod.local_grads(
                m, p, {k: v.to(dev) for k, v in batch.items()})
        routes.append(r)
        runs.append(({k: v.float().cpu() for k, v in g.items()},
                     float(met["loss"]), float(opt.global_norm(g)),
                     float(met["aux"])))
        del p, g
    summary = moe_route_diff(routes[1], routes[0],
                             f"train card vs cpu ({cfg.name}, 2 layers)")
    (gc, lc, nc, ac), (gp, lp, np_, ap) = runs
    out = dict(loss_card=lc, loss_cpu=lp, grad_norm_card=nc,
               grad_norm_cpu=np_, aux_card=ac, aux_cpu=ap, routes=summary)
    require(abs(lc - lp) <= CPU_LOSS_RTOL * abs(lp),
            f"moe train card vs cpu: loss {lc} vs {lp}")
    require(abs(ac - ap) <= CPU_LOSS_RTOL * abs(ap),
            f"moe train card vs cpu: aux {ac} vs {ap}")
    require(abs(nc - np_) <= CPU_NORM_RTOL * abs(np_),
            f"moe train card vs cpu: grad norm {nc} vs {np_}")
    for name in gc:
        c, w = gc[name], gp[name]
        rel = float((c - w).norm() / w.norm())
        mx = float((c - w).abs().max() / w.abs().max())
        out[name] = dict(rel_rms=rel, max_abs_frac=mx)
        require(rel <= CPU_GRAD_TOL and mx <= CPU_GRAD_TOL,
                f"moe train card vs cpu: {name} gradient relative rms "
                f"{rel:.3g}, max {mx:.3g} of the largest (tolerance "
                f"{CPU_GRAD_TOL})")
    print(f"train card vs cpu ({cfg.name}, 2 layers, full width, 128 "
          "tokens): " + json.dumps(out), flush=True)
    return out


def train_moe():
    """Phase 14 (c): deepseek-moe-16b at full width cut to 4 layers (2.77 B
    parameters), trained on one rank through ``Session`` (``comms="off"``,
    ``remat="full"``, AdamW at its peak rate from step 1, 2 x 512 tokens
    of ``SyntheticLM(structured=True)``), after the memory model's verdict
    on the cut: the first batch's gradients twice from the same params,
    bitwise equal; three steps, the third on the first batch again with
    its loss below the first, each step's launches the layer loop's and
    its aux printed; then the 2-layer loss and gradients against the
    CPU's.  Returns the summary and the three steps' launch counts."""
    from repro_torch.api import Session
    from repro_torch.core import memory as mem_mod
    from repro_torch.data import SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod
    cfg = dataclasses.replace(get_config(MOE), n_layers=MOE_TRAIN_LAYERS)
    sess = Session(device="cuda")
    fp = mem_mod.estimate_stage_footprints(
        cfg, local_batch=MOE_TRAIN_BATCH, seq_len=TRAIN_SEQ)[0]
    print(f"{MOE} train cut ({cfg.n_layers} layers, {cfg.param_count()} "
          f"parameters): the memory model's footprint "
          f"{fp.total / 2**30:.2f} GiB against {sess.budget.usable / 2**30:.2f}"
          f" usable: fits {fp.fits(sess.budget)}", flush=True)
    require(fp.fits(sess.budget), f"{MOE}'s train cut does not fit")
    data = iter(SyntheticLM(cfg.vocab_size, MOE_TRAIN_BATCH, TRAIN_SEQ,
                            seed=SEED, structured=True))
    batches = [next(data), next(data)]
    adamw = opt.AdamWConfig(lr=opt.warmup_cosine(TRAIN_PEAK, 0, 3))
    plan = sess.plan(cfg, batch=MOE_TRAIN_BATCH, seq=TRAIN_SEQ, comms="off",
                     microbatches=1, adamw=adamw,
                     model_kwargs={"remat": "full"})
    torch.cuda.reset_peak_memory_stats()
    sess.init_state(plan, seed=SEED)
    params = sess.state["train_state"]["params"]
    n_params = sum(p.numel() for p in params.values())
    require(n_params == cfg.param_count(), f"{MOE} cut: {n_params}")
    first = {k: torch.from_numpy(v).cuda().long()
             for k, v in batches[0].items()}
    grads = [step_mod.local_grads(plan.model, params, first)
             for _ in range(2)]
    same = all(same_bits(grads[0][0][k], grads[1][0][k]) for k in params) \
        and same_bits(grads[0][1]["loss"], grads[1][1]["loss"])
    print(f"{MOE} gradients twice from the same params and batch: bitwise "
          f"equal {same}", flush=True)
    require(same, f"{MOE}: gradients differ run to run")
    del grads
    torch.cuda.empty_cache()
    ops.reset_launches()
    batched0 = gemm_mod.batched_launches
    losses, auxes, walls, total = [], [], [], {}
    for batch in (batches[0], batches[1], batches[0]):
        before = ops.dispatch_report()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in sess.step(plan, batch).items()}
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        got = {k: v - before[k] for k, v in ops.dispatch_report().items()}
        expect = expected_moe_train_launches(cfg, 1)
        require(got == expect, f"{MOE} step launches {got}, expected "
                               f"{expect}")
        require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                f"{MOE}: non-finite metrics {m}")
        losses.append(m["loss"])
        auxes.append(m["aux"])
        total = {k: total.get(k, 0) + v for k, v in got.items()}
    total["matmul_batched"] = gemm_mod.batched_launches - batched0
    require(total["matmul_batched"] == 3 * 12 * cfg.n_layers,
            f"{MOE}: {total['matmul_batched']} batched launches in 3 steps")
    peak = torch.cuda.max_memory_allocated()
    print(f"{MOE} steps (first batch, second, first again): losses "
          f"{losses}, aux {auxes}, wall ms {walls}, peak "
          f"{peak / 2**30:.2f} GiB; launches {total}", flush=True)
    require(losses[2] < losses[0], f"{MOE}: the loss did not fall")
    cpu_check = moe_train_against_cpu(cfg, params)
    del sess, params, plan
    torch.cuda.empty_cache()
    tokens = MOE_TRAIN_BATCH * TRAIN_SEQ
    summary = dict(arch=MOE, layers=cfg.n_layers, params=n_params,
                   model_footprint_gib=fp.total / 2**30,
                   tokens_per_step=tokens, losses=losses, aux=auxes,
                   step_wall_ms=walls,
                   tokens_per_s_steps_2_3=[tokens / (w / 1e3)
                                           for w in walls[1:]],
                   peak_gib=peak / 2**30, grads_bitwise_run_to_run=same,
                   card_vs_cpu=cpu_check)
    print("train " + json.dumps(summary), flush=True)
    return summary, total


def moe_phase():
    """Phase 14: the batched GEMM at the bank shapes, deepseek-moe-16b
    served at full width and depth, and its 4-layer cut trained on one
    rank.  Returns (the batched mode's row, the serve summary, the train
    summary, each path's launches)."""
    row = check_expert_gemm()
    torch.cuda.empty_cache()
    served, serve_launches = serve_moe()
    trained, train_launches = train_moe()
    paths = {f"{MOE} dense cache": serve_launches["dense"],
             f"{MOE} continuous": serve_launches["continuous"],
             f"{MOE} train ({MOE_TRAIN_LAYERS} layers, 1 rank, 3 steps)":
                 train_launches}
    return row, served, trained, paths


# ---------------------------------------------------------------------------
# phase 15: the Model's last three families (hybrid, audio, vlm)
# ---------------------------------------------------------------------------

ZAMBA, MUSICGEN, INTERNVL = "zamba2-1.2b", "musicgen-medium", "internvl2-26b"
ZAMBA_PARAMS = 1_170_313_344
# zamba2 card against CPU at full width: the first site's group (6 mamba
# layers and the shared block) and a 1-layer tail, from the full model's
# weights
ZAMBA_CPU_LAYERS = 7
ZAMBA_TRAIN_BATCH = 2                 # 2 x 512 tokens a step
ZAMBA_TRAIN_PATH = f"{ZAMBA} train (1 rank, 3 steps)"
# internvl2-26b at full width cut to 4 of its 48 layers: 1,024 vision
# embeddings ahead of 512 text tokens a row, 2 rows
INTERNVL_LAYERS, INTERNVL_BATCH, INTERNVL_TEXT = 4, 2, 512
# its card against CPU on the first layer (the CPU's fp32 products at
# 6,144 x 16,384 over 3,072 positions take seconds a layer)
INTERNVL_CPU_LAYERS = 1
INTERNVL_TRAIN_PATH = f"{INTERNVL} train ({INTERNVL_LAYERS} layers, 1 rank)"
# musicgen's three engines, zamba2's Engine and Session.serve, and
# deepseek-moe-16b's two engines (phase 14), on the first 8
# of phase 4's requests to 32 new tokens (one wave of 8 slots): the whole
# script stays inside its time limit
SHORT_REQUESTS, SHORT_NEW_TOKENS = SLOTS, 32


def hybrid_products(cfg) -> int:
    """GEMM launches of the hybrid's forward (a prefill call or a decode
    step): 5 a mamba layer (wx, wz, wbc, wdt, w_out), 7 a site (q, k, v,
    o, gate, in, out) and the unembed."""
    return 5 * cfg.n_layers + 7 * (cfg.n_layers // cfg.attn_every) + 1


def hybrid_serve_launches(cfg, steps: int, prefills: int):
    """The static engine on the dense cache: the products per prefill and
    per decode step, one SSD forward a layer and one flash call a site per
    prefill, one paged-decode call a site per decode step (the mixer's
    decode step is the plain ``ssd_step``)."""
    sites = cfg.n_layers // cfg.attn_every
    return launch_counts(matmul=hybrid_products(cfg) * (steps + prefills),
                         attention=sites * prefills,
                         paged_decode_attention=sites * steps,
                         ssd=cfg.n_layers * prefills)


def expected_hybrid_train_launches(cfg, steps: int):
    """Per step on one rank under ``remat="full"``: the forward; the
    backward's recompute of each site's group (its mamba layers, each
    recomputed again by its own checkpoint, and the shared block) and of
    each tail layer; two backward products for each forward product, one
    SSD backward a layer and one attention backward a site."""
    L, every = cfg.n_layers, cfg.attn_every
    sites = L // every
    tail = L - sites * every
    fwd = hybrid_products(cfg)
    recompute = 10 * sites * every + 7 * sites + 5 * tail
    return launch_counts(matmul=steps * (fwd + recompute + 2 * fwd),
                         attention=steps * 2 * sites,
                         attention_backward=steps * sites,
                         ssd=steps * (L + 2 * sites * every + tail),
                         ssd_backward=steps * L)


def check_zamba_kernels(cfg):
    """Phase 15 (b): the kernels at zamba2's shapes against their plain
    versions.  The SSD forward (bf16 and fp32) at a 512-token prefill and
    the train shape (2 x 512), H = 64, P = 64, N = 64, G = 1, and its
    backward (the backward's slices of 3 heads: 21 and one of 1) at the
    train shape; flash forward at the prefill (MHA, 32 heads of 64) and
    its backward at the train shape, beside SDPA; paged decode at 8 slots
    on 32 kv heads.  Each timed beside its bound and its plain version.
    Returns {kernel row name: its zamba2 entry}."""
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    require((H, P, N, cfg.ssm_groups) == (64, 64, 64, 1)
            and ssd_mod._bwd_slices(H, 1) == 22,
            f"{ZAMBA}'s SSD shapes: H {H}, P {P}, N {N}")
    out = {}
    for label, B, dtype in (("prefill bf16", 1, torch.bfloat16),
                            ("prefill fp32", 1, torch.float32),
                            ("train bf16", 2, torch.bfloat16),
                            ("train fp32", 2, torch.float32)):
        inp = ssd_inputs(1600 + B, 512, 1, dtype, False, H=H, P=P, N=N, B=B)
        got = ssd_mod.ssd(**inp)
        want = ssd_mod.ssd_plain(**inp)
        err = max(ssd_close(f"{ZAMBA} {label}", got, want, SSD_TOL[dtype]))
        nbytes, flops, peak, _ = ssd_cost(inp)
        bms, by = bound(nbytes, flops, peak)
        n = copies(nbytes)
        sets = [ssd_inputs(1650 + j, 512, 1, dtype, False, H=H, P=P, N=N,
                           B=B) for j in range(n)]
        ms = cuda_ms([lambda s=s: ssd_mod.ssd(**s) for s in sets],
                     iters=max(10, 2 * n))
        plain = cuda_ms([lambda: ssd_mod.ssd_plain(**inp)], iters=3,
                        warmup=1)
        entry = dict(ms=ms, bound_ms=bms, bound_by=by, plain_ms=plain,
                     max_abs_err=err, case=f"x ({B},512,{H},{P}), B/C "
                     f"({B},512,1,{N}) {str(dtype)[6:]}")
        if B == 2:
            g = gen(1700)
            dy = torch.randn(inp["x"].shape, generator=g,
                             device="cuda").to(dtype)
            bgot = ssd_bwd_call(inp, dy, None)
            bwant = ssd_mod.ssd_backward_plain(**inp, dy=dy)
            e = ssd_bwd_close(f"{ZAMBA} {label}", bgot, bwant,
                              SSD_TOL[dtype])
            again = ssd_bwd_call(inp, dy, None)
            require(all((a is None and b is None) or same_bits(a, b)
                        for a, b in zip(again, bgot)),
                    f"{ZAMBA} ssd backward {label}: two runs differ")
            scr = [ssd_mod._forward(t["x"], t["dt"], t["A"], t["Bm"],
                                    t["C"], None)[2] for t in sets]
            bnb, bfl = roofline.ssd_backward_cost(
                B, 512, H, P, 1, N, inp["x"].element_size(), False, False)
            bbms, bby = bound(bnb, bfl, FP32_FLOPS
                              if dtype == torch.float32 else BF16_FLOPS)
            entry["backward"] = dict(
                ms=cuda_ms([lambda t=t, c=c: ssd_mod.ssd_backward(
                    t["x"], t["dt"], t["A"], t["Bm"], t["C"], dy, None, c)
                    for t, c in zip(sets, scr)], iters=max(10, 2 * n)),
                plain_ms=event_ms(lambda: ssd_mod.ssd_backward_plain(
                    **inp, dy=dy), iters=3),
                bound_ms=bbms, bound_by=bby,
                max_err_over_largest=max(r for _, r in e.values()))
        print(f"{ZAMBA} ssd {label}: " + json.dumps(entry), flush=True)
        out[f"ssd {label}"] = entry
        del inp, sets
    # flash: the shared block at a 512-token prefill and the train shape
    hq = cfg.n_heads
    hd = cfg.d_head
    q, k, v, do = bwd_inputs(1800, 1, hq, hq, 512, 512, hd)
    err = max_err(fa_mod.attention(q, k, v, causal=True),
                  ref.attention(q, k, v, causal=True),
                  f"{ZAMBA} flash prefill")
    pairs = 512 * 513 // 2
    bms, by = bound(*roofline.attention_cost(q.shape, k.shape, pairs))
    n = copies(4 * q.numel() * 2)
    fsets = [bwd_inputs(1830 + 4 * j, 1, hq, hq, 512, 512, hd)[:3]
             for j in range(n)]
    flash = dict(
        ms=cuda_ms([lambda s=s: fa_mod.attention(*s, causal=True)
                    for s in fsets], iters=max(10, 2 * n)),
        plain_ms=cuda_ms([lambda: ref.attention(q, k, v, causal=True)],
                         iters=3, warmup=1),
        library_ms=cuda_ms([lambda s=s: torch.nn.functional
                            .scaled_dot_product_attention(*s, is_causal=True)
                            for s in fsets], iters=max(10, 2 * n)),
        bound_ms=bms, bound_by=by, max_abs_err=err,
        case=f"q/k/v (1,{hq},512,{hd}), causal")
    q, k, v, do = bwd_inputs(1810, ZAMBA_TRAIN_BATCH, hq, hq, TRAIN_SEQ,
                             TRAIN_SEQ, hd)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fa_mod.attention(*leaves, causal=True),
                              leaves, do)
    berr = grads_close(got, ref.attention_backward(q, k, v, do, causal=True),
                       f"{ZAMBA} attention backward")
    bbms, bby = bound(*roofline.attention_backward_cost(q.shape, k.shape,
                                                        pairs))

    def sdpa():
        ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(torch.nn.functional
                                   .scaled_dot_product_attention(
                                       *ls, is_causal=True), ls, do)
    n = copies(2 * 6 * q.numel())
    bsets = [bwd_inputs(1850 + 4 * j, ZAMBA_TRAIN_BATCH, hq, hq, TRAIN_SEQ,
                        TRAIN_SEQ, hd) for j in range(n)]
    bouts = [fa_mod._forward(*s[:3], True, None, None, hd ** -0.5, 0,
                             with_lse=True) for s in bsets]
    backward = dict(
        ms=cuda_ms([lambda s=s, o=o: fa_mod.attention_backward(
            *s[:3], o[0], s[3], o[1]) for s, o in zip(bsets, bouts)],
            iters=max(10, 2 * n)),
        plain_ms=event_ms(lambda: ref.attention_backward(q, k, v, do,
                                                         causal=True)),
        library_ms=event_ms(sdpa, iters=10, warmup=2), bound_ms=bbms,
        bound_by=bby, max_abs_err=berr,
        case=f"q/k/v ({ZAMBA_TRAIN_BATCH},{hq},{TRAIN_SEQ},{hd}), causal")
    print(f"{ZAMBA} flash prefill {json.dumps(flash)}; backward "
          f"{json.dumps(backward)}", flush=True)
    out["flash"], out["attention_backward"] = flash, backward
    del fsets, bsets, bouts
    # paged decode: 8 slots, one page of MAX_SEQ a slot (the dense cache)
    rng = np.random.default_rng(SEED + 60)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + NEW_TOKENS, SLOTS)
    n = copies(2 * 2 * SLOTS * MAX_SEQ * hq * hd)
    pools = [(randn((SLOTS, MAX_SEQ, hq, hd), 1860 + 2 * j),
              randn((SLOTS, MAX_SEQ, hq, hd), 1861 + 2 * j))
             for j in range(n)]
    kc, vc = pools[0]
    qd = randn((SLOTS, hq, hd), 1822)
    table = torch.arange(SLOTS, dtype=torch.int32, device="cuda")[:, None]
    sl = torch.from_numpy(lens.astype(np.int32)).cuda()
    err = max_err(ops.paged_decode_attention(qd, kc, vc, table, sl),
                  ref.paged_decode_attention(qd, kc, vc, table, sl),
                  f"{ZAMBA} paged decode")
    bms, by = bound(*roofline.paged_decode_cost(SLOTS, hq, hq, hd,
                                                int(lens.sum()), SLOTS))
    paged = dict(
        ms=cuda_ms([lambda p=p: ops.paged_decode_attention(qd, *p, table,
                                                           sl)
                    for p in pools], iters=max(10, 2 * n)),
        plain_ms=cuda_ms([lambda: ref.paged_decode_attention(
            qd, kc, vc, table, sl)], iters=3, warmup=1),
        bound_ms=bms, bound_by=by, max_abs_err=err,
        case=f"q ({SLOTS},{hq},{hd}) on the dense cache's rows, "
             f"{int(lens.sum())} live positions")
    print(f"{ZAMBA} paged decode {json.dumps(paged)}", flush=True)
    out["paged"] = paged
    del kc, vc, pools
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def held_ssd_calls():
    """Within the block every ``ops.ssd`` call is held against
    ``ssd_plain`` on its inputs (SSD_TOL); yields the list of errors."""
    real = ops.ssd
    errs = []

    def call(x, dt, A, Bm, C, **kw):
        y, state = real(x, dt, A, Bm, C, **kw)
        kw.pop("chunk", None)
        want = ssd_mod.ssd_plain(x, dt, A, Bm, C, **kw)
        errs.append(max(ssd_close(f"call {len(errs)} x {tuple(x.shape)}",
                                  (y, state), want, SSD_TOL[x.dtype])))
        return y, state

    ops.ssd = call
    try:
        yield errs
    finally:
        ops.ssd = real


def zamba_against_cpu(cfg, params):
    """The first ``ZAMBA_CPU_LAYERS`` layers (a site after layer 6, then a
    tail layer) at full width with the model's own embed, shared block,
    norm and unembed, on the card and through the plain versions on the
    CPU: a 96-token prompt into a one-slot dense cache, then 4 decode steps
    teacher-forced with the CPU's greedy tokens, held to :func:`agree`;
    the first layer's prefill states held within STATE_TOL of their
    largest magnitude (the site's K/V, 6 layers deeper, printed: the
    residual's drift, as phase 5 prints mamba2's deeper states)."""
    small = dataclasses.replace(cfg, n_layers=ZAMBA_CPU_LAYERS)
    sub = {k: (v[:ZAMBA_CPU_LAYERS] if k.startswith("layers.") else v)
           for k, v in params.items()}
    runs = []
    prompt = np.random.default_rng(SEED + 61).integers(
        0, cfg.vocab_size, (1, 96))
    for m, p in ((Model(small, device="cuda"), sub),
                 (Model(small, device="cpu"),
                  {k: v.cpu() for k, v in sub.items()})):
        cache = m.init_cache(1, 128)
        with torch.no_grad():
            logits, _ = m.prefill(p, torch.from_numpy(prompt).to(m.device),
                                  cache=cache, slot=0)
        runs.append((m, p, cache, [logits[0, -1].float().cpu()]))
    drift = {k: float((runs[0][2][k][0].float().cpu()
                       - runs[1][2][k][0].float()).abs().max()
                      / runs[1][2][k][0].float().abs().max())
             for k in ("conv", "ssm", "bc_conv", "k", "v")}
    held = ("conv", "ssm", "bc_conv")
    for s in range(4):
        tok = int(torch.argmax(runs[1][3][-1]))
        for m, p, cache, out in runs:
            with torch.no_grad():
                lg, _ = m.decode_step(p, cache,
                                      torch.tensor([[tok]], device=m.device),
                                      torch.tensor([96 + s], device=m.device))
            out.append(lg[0, 0].float().cpu())
    res = agree(torch.stack(runs[0][3]), torch.stack(runs[1][3]),
                f"card vs cpu logits ({ZAMBA}, full width, layers 0-6: a "
                "site and a tail layer, dense cache, 96-token prompt + 4 "
                "steps)")
    print(f"  prefill states card vs cpu, max abs diff over the largest: "
          f"{json.dumps(drift)} (layer 0's {held} within {STATE_TOL:g}; the "
          "site's k and v printed)", flush=True)
    require(all(drift[k] <= STATE_TOL for k in held),
            f"{ZAMBA} card vs cpu: a first-layer prefill state disagrees")
    res["layer0_state_diff_frac"] = drift
    return res


def zamba_depth_check(cfg, model, params):
    """Prefill-then-decode at full depth against the full forward over the
    same tokens on the card: a 300-token prompt (ragged against the SSD
    chunk), then 4 decode steps teacher-forced, held to :func:`agree`."""
    toks = torch.from_numpy(np.random.default_rng(SEED + 62).integers(
        0, cfg.vocab_size, (1, 304))).cuda()
    with torch.no_grad():
        full, _, _ = model.forward(params, toks)
        cache = model.init_cache(1, 512)
        model.prefill(params, toks[:, :300], cache=cache, slot=0)
        steps = [model.decode_step(params, cache, toks[:, p:p + 1],
                                   torch.tensor([p], device="cuda"))[0]
                 [0, 0].float().cpu() for p in range(300, 304)]
    return agree(torch.stack(steps), full[0, 300:304].float().cpu(),
                 f"prefill-then-decode vs the full forward ({ZAMBA}, "
                 f"{cfg.n_layers} layers, 300-token prompt + 4 steps)")


def zamba_step_bound(cfg, params, lens):
    """The decode step's least time at 8 slots: every weight but the
    embedding table read once (the table's 8 rows), each layer's fp32
    SSM state and bf16 convolution states read and written, each site's
    K/V read over the live positions; over the card's HBM rate."""
    n_params = sum(p.numel() for p in params.values())
    embed = cfg.padded_vocab * cfg.d_model
    weights = 2 * (n_params - embed + SLOTS * cfg.d_model)
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    W, di = cfg.conv_width, cfg.d_inner
    gn2 = 2 * cfg.ssm_groups * N
    states = 2 * cfg.n_layers * SLOTS * (4 * H * P * N
                                         + 2 * (W - 1) * (di + gn2))
    sites = cfg.n_layers // cfg.attn_every
    kv = sites * 2 * 2 * cfg.n_kv_heads * cfg.d_head * int(np.sum(lens))
    total = weights + states + kv
    return dict(decode_step_bound_ms=bound(total, 0)[0],
                decode_step_bytes=dict(weights=weights, states=states,
                                       kv=kv))


def serve_zamba():
    """Phase 15 (a): zamba2-1.2b at full width and depth (38 layers, the
    shared block at 6 sites, a 2-layer tail; 1,170,313,344 parameters
    drawn on the card from the seed) on the first 8 of phase 4's requests
    to 32 new tokens through the static ``Engine`` on the dense cache, and
    through ``Session.serve`` (the Engine's tokens): launch counts,
    serve numbers, the decode step split
    beside its bound, every kernel call of 8 one-slot prefills and a
    decode step against its plain version (the SSD forward's too),
    prefill-then-decode against the forward, the first 7 layers against
    the CPU.  Returns (stats, launches by path, the params; the model is
    freed)."""
    from repro_torch.api import Session
    cfg = get_config(ZAMBA)
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    n_params = sum(p.numel() for p in params.values())
    sites = cfg.n_layers // cfg.attn_every
    require(n_params == ZAMBA_PARAMS and (cfg.n_layers, sites) == (38, 6),
            f"{ZAMBA}: {n_params} parameters, {cfg.n_layers} layers")
    serve(Engine, model, params, requests(cfg, 2)[:2])          # warm-up
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fin, dt, steps = serve(Engine, model, params, requests(
        cfg, SHORT_NEW_TOKENS)[:SHORT_REQUESTS])
    launches = ops.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    expect = hybrid_serve_launches(cfg, steps, len(fin))
    print(f"{ZAMBA} launches: {launches} (expected {expect}: {steps} decode "
          f"steps, {len(fin)} prefills; per call {hybrid_products(cfg)} "
          f"products, {cfg.n_layers} SSD, {sites} flash or paged)",
          flush=True)
    require(all(launches[k] > 0 for k in ("matmul", "attention",
                                          "paged_decode_attention", "ssd")),
            f"a kernel of the {ZAMBA} serve path was never launched")
    require(launches == expect,
            f"{ZAMBA} launch counts do not match the layer loop")
    stats = serve_stats(ZAMBA, n_params, fin, dt, launches, peak, resident)
    stats.update(decode_steps=steps, prefills=len(fin))
    # Session.serve on the same params, the first wave's requests to fewer
    # tokens: the Engine's first tokens (a slot's decode reads its own
    # row alone, and the GEMM's rows are invariant to the others')
    sess = Session(device="cuda")
    sess.put("serve/params", params, kind="params")
    plan = sess.plan(cfg, batch=SLOTS, seq=MAX_SEQ, kind="decode")
    ops.reset_launches()
    eng = sess.serve(plan, batch_slots=SLOTS, max_seq=MAX_SEQ)
    sfin, sdt, ssteps = drive(eng, requests(
        cfg, SHORT_NEW_TOKENS)[:SHORT_REQUESTS])
    session_launches = ops.dispatch_report()
    first = {r.rid: r.out[:SHORT_NEW_TOKENS] for r in fin
             if r.rid < SHORT_REQUESTS}
    same = {r.rid: r.out for r in sfin} == first
    print(f"{ZAMBA} Session.serve: {sum(len(r.out) for r in sfin) / sdt:.1f}"
          f" tok/s, tokens equal to the Engine's {same}", flush=True)
    require(same and session_launches == hybrid_serve_launches(
        cfg, ssteps, len(sfin)), f"{ZAMBA} Session.serve differs")
    stats["session_serve_tok_per_s"] = sum(len(r.out) for r in sfin) / sdt
    del eng, sess
    # step_breakdown's draws: the tokens, then the positions
    rng = np.random.default_rng(SEED + 2)
    rng.integers(0, cfg.vocab_size, (SLOTS, 1))
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + NEW_TOKENS, SLOTS) + 1
    stats.update(**step_breakdown(cfg, model, params, dense=True),
                 **zamba_step_bound(cfg, params, lens))
    print(f"serve {ZAMBA} " + json.dumps(stats), flush=True)
    reqs = requests(cfg)
    with held_ssd_calls() as ssd_errs:
        stats["kernel_calls_max_abs_err"] = check_layer_calls(
            cfg, model, params, [len(r.prompt) for r in reqs[:SLOTS]],
            steps=1, max_seq=MAX_SEQ)
    require(len(ssd_errs) == SLOTS * cfg.n_layers,
            f"{ZAMBA}: {len(ssd_errs)} SSD calls held")
    stats["kernel_calls_max_abs_err"]["ssd"] = max(ssd_errs)
    stats["prefill_decode_vs_forward"] = zamba_depth_check(cfg, model,
                                                           params)
    stats["card_vs_cpu"] = zamba_against_cpu(cfg, params)
    del model
    torch.cuda.empty_cache()
    return stats, {f"{ZAMBA} dense cache": launches,
                   f"{ZAMBA} Session.serve": session_launches}, params


def zamba_train_against_cpu(cfg, params_src):
    """``ZAMBA_CPU_LAYERS`` layers (a site and a tail layer) at full width,
    one sequence of 128 tokens: loss, grad norm and every leaf's gradient
    (``shared.*`` among them, each the sum of its site's cotangents) on
    the card against the plain versions on the CPU, phase 6's
    tolerances."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod
    small = dataclasses.replace(cfg, n_layers=ZAMBA_CPU_LAYERS)
    toks = np.random.default_rng(SEED + 63).integers(
        0, cfg.vocab_size, (1, 129))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    params = {k: (v[:ZAMBA_CPU_LAYERS] if k.startswith("layers.")
                  else v).detach() for k, v in params_src.items()}
    runs = []
    for dev in ("cuda", "cpu"):
        m = Model(small, device=dev, remat="none")
        p = {k: v.to(dev).clone().requires_grad_(True)
             for k, v in params.items()}
        g, met = step_mod.local_grads(
            m, p, {k: v.to(dev) for k, v in batch.items()})
        runs.append(({k: v.float().cpu() for k, v in g.items()},
                     float(met["loss"]), float(opt.global_norm(g))))
        del p, g
    (gc, lc, nc), (gp, lp, np_) = runs
    out = dict(loss_card=lc, loss_cpu=lp, grad_norm_card=nc,
               grad_norm_cpu=np_)
    require(abs(lc - lp) <= CPU_LOSS_RTOL * abs(lp)
            and abs(nc - np_) <= CPU_NORM_RTOL * abs(np_),
            f"{ZAMBA} train card vs cpu: loss {lc} / {lp}, norm {nc} / "
            f"{np_}")
    for name in gc:
        c, w = gc[name], gp[name]
        rel = float((c - w).norm() / w.norm())
        mx = float((c - w).abs().max() / w.abs().max())
        out[name] = dict(rel_rms=rel, max_abs_frac=mx)
        require(rel <= CPU_GRAD_TOL and mx <= CPU_GRAD_TOL,
                f"{ZAMBA} train card vs cpu: {name} gradient relative rms "
                f"{rel:.3g}, max {mx:.3g} of the largest (tolerance "
                f"{CPU_GRAD_TOL})")
    print(f"train card vs cpu ({ZAMBA}, {ZAMBA_CPU_LAYERS} layers, full "
          "width, 128 tokens): " + json.dumps(out), flush=True)
    return out


def train_zamba(params_src):
    """Phase 15 (c): zamba2-1.2b at full width and depth trained on one
    rank through ``Session`` (``comms="off"``, ``remat="full"``, AdamW at
    its peak rate from step 1, 2 x 512 tokens of
    ``SyntheticLM(structured=True)``) from the served model's weights:
    the memory model's footprint; the first batch's gradients twice,
    bitwise equal; three steps (the third on the first batch again, its
    loss below the first), each step's launches the layer loop's; a
    fourth step profiled for the card's idle share; the 7-layer cut's
    loss and gradients against the CPU's.  Returns the summary and the
    three steps' launches."""
    from repro_torch.api import Session
    from repro_torch.core import memory as mem_mod
    from repro_torch.data import SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod
    cfg = get_config(ZAMBA)
    sess = Session(device="cuda")
    fp = mem_mod.estimate_stage_footprints(
        cfg, local_batch=ZAMBA_TRAIN_BATCH, seq_len=TRAIN_SEQ)[0]
    data = iter(SyntheticLM(cfg.vocab_size, ZAMBA_TRAIN_BATCH, TRAIN_SEQ,
                            seed=SEED, structured=True))
    batches = [next(data), next(data)]
    plan = sess.plan(ZAMBA, batch=ZAMBA_TRAIN_BATCH, seq=TRAIN_SEQ,
                     comms="off", microbatches=1,
                     adamw=opt.AdamWConfig(
                         lr=opt.warmup_cosine(TRAIN_PEAK, 0, 3)))
    require(plan.path == "gspmd" and plan.model.remat == "full",
            f"{ZAMBA}: plan {plan.path}, remat {plan.model.remat}")
    torch.cuda.reset_peak_memory_stats()
    sess.init_state(plan, params={k: v.detach()
                                  for k, v in params_src.items()})
    params = sess.state["train_state"]["params"]
    first = {k: torch.from_numpy(v).cuda().long()
             for k, v in batches[0].items()}
    grads = [step_mod.local_grads(plan.model, params, first)
             for _ in range(2)]
    same = all(same_bits(grads[0][0][k], grads[1][0][k]) for k in params)
    print(f"{ZAMBA} gradients twice from the same params and batch: bitwise "
          f"equal {same} (shared.* the sums over {cfg.n_layers // 6} sites)",
          flush=True)
    require(same, f"{ZAMBA}: gradients differ run to run")
    del grads
    ops.reset_launches()
    losses, walls, total = [], [], {}
    expect = expected_hybrid_train_launches(cfg, 1)
    for batch in (batches[0], batches[1], batches[0]):
        before = ops.dispatch_report()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in sess.step(plan, batch).items()}
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        got = {k: v - before[k] for k, v in ops.dispatch_report().items()}
        require(got == expect, f"{ZAMBA} step launches {got}, expected "
                               f"{expect}")
        require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                f"{ZAMBA}: non-finite metrics {m}")
        losses.append(m["loss"])
        total = {k: total.get(k, 0) + v for k, v in got.items()}
    peak = torch.cuda.max_memory_allocated()
    require(losses[2] < losses[0], f"{ZAMBA}: the loss did not fall")
    prof, lo, hi = profiled_step(lambda: sess.step(plan, batches[1]))
    busy = union_ns(device_intervals(prof), lo, hi)
    parts = device_breakdown(prof, busy=("gemm", "ssd", "ssd_backward"))
    idle = 1 - busy / (hi - lo)
    print(f"{ZAMBA} steps (the third on the first batch again): losses "
          f"{losses}, wall ms {walls}, peak {peak / 2**30:.2f} GiB against "
          f"the memory model's {fp.total / 2**30:.2f}; launches {total}; "
          f"profiled step wall {(hi - lo) / 1e6:.1f} ms, device busy "
          f"{busy / 1e6:.1f} ms, idle share {idle:.3f}, by family "
          f"{json.dumps(parts)}", flush=True)
    trained = {k: v.detach() for k, v in params.items()}
    del sess, plan, prof, params
    torch.cuda.empty_cache()
    cpu_check = zamba_train_against_cpu(cfg, trained)
    del trained
    torch.cuda.empty_cache()
    tokens = ZAMBA_TRAIN_BATCH * TRAIN_SEQ
    summary = dict(arch=ZAMBA, tokens_per_step=tokens, losses=losses,
                   step_wall_ms=walls, peak_gib=peak / 2**30,
                   model_footprint_gib=fp.total / 2**30,
                   tokens_per_s_steps_2_3=[tokens / (w / 1e3)
                                           for w in walls[1:]],
                   profiled_wall_ms=(hi - lo) / 1e6,
                   device_busy_ms=busy / 1e6, device_idle_share=idle,
                   device_ms=parts, grads_bitwise_run_to_run=same,
                   card_vs_cpu=cpu_check)
    print("train " + json.dumps(summary), flush=True)
    return summary, total


def serve_musicgen():
    """Phase 15 (d): musicgen-medium at full width and depth (48 layers,
    MHA 24 heads of 64, vocab 2,048) on the first 8 of phase 4's requests
    to 32 new tokens through the static ``Engine`` on the dense cache, the
    static paged ``Engine`` and ``ContinuousEngine``: launch counts (the
    dense family's), the paged and continuous tokens equal, serve
    numbers.  Returns (stats, launches by path)."""
    cfg = get_config(MUSICGEN)
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    n_params = sum(p.numel() for p in params.values())
    require(cfg.n_layers == 48 and cfg.n_kv_heads == cfg.n_heads == 24,
            f"{MUSICGEN}: {cfg.n_layers} layers")
    serve(Engine, model, params, requests(cfg, 2)[:2])          # warm-up
    out, launches = {}, {}
    for tag, cls, kw in (("dense", Engine, {}),
                         ("continuous", ContinuousEngine, {}),
                         ("paged", Engine, dict(paged=True))):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        fin, dt, steps = serve(cls, model, params, requests(
            cfg, SHORT_NEW_TOKENS)[:SHORT_REQUESTS], **kw)
        got = ops.dispatch_report()
        peak = torch.cuda.max_memory_allocated()
        if tag == "dense":
            expect = dense_serve_launches(cfg, steps, len(fin))
        else:
            expect, _ = continuous_serve_launches(cfg, steps, fin)
        require(got == expect and got["attention"] > 0
                and got["paged_decode_attention"] > 0,
                f"{MUSICGEN} {tag} launches {got}, expected {expect}")
        out[tag] = serve_stats(MUSICGEN, n_params, fin, dt, got, peak,
                               resident)
        out[tag]["tokens_by_rid"] = {r.rid: r.out for r in fin}
        out[tag]["decode_steps"] = steps
        launches[tag] = got
    same = out["paged"]["tokens_by_rid"] == out["continuous"][
        "tokens_by_rid"]
    print(f"{MUSICGEN}: static paged == continuous greedy tokens: {same}",
          flush=True)
    require(same, f"{MUSICGEN}: static paged and continuous disagree")
    stats = {k: {kk: vv for kk, vv in v.items() if kk != "tokens_by_rid"}
             for k, v in out.items()}
    print(f"serve {MUSICGEN} " + json.dumps(stats), flush=True)
    del model, params
    torch.cuda.empty_cache()
    return stats, {f"{MUSICGEN} dense cache": launches["dense"],
                   f"{MUSICGEN} continuous": launches["continuous"],
                   f"{MUSICGEN} static paged": launches["paged"]}


def internvl_batch(cfg, seed):
    """2 rows of ``INTERNVL_TEXT`` text tokens behind 1,024 vision
    embeddings (standard normal, nonzero), the prefix's labels -1."""
    from repro_torch.data import SyntheticLM
    nv = cfg.n_vision_tokens
    item = next(iter(SyntheticLM(cfg.vocab_size, INTERNVL_BATCH,
                                 nv + INTERNVL_TEXT, seed=seed,
                                 structured=True)))
    item["tokens"] = item["tokens"][:, :-nv]
    item["labels"][:, :nv] = -1
    item["vision_embeds"] = torch.randn(
        (INTERNVL_BATCH, nv, cfg.d_model), generator=gen(seed + 7),
        device="cuda").to(torch.bfloat16)
    return item


def internvl_phase():
    """Phase 15 (e): internvl2-26b at full width cut to 4 layers (48 query
    and 8 kv heads of 128, d_ff 16,384, the 92,672-column unembed): the
    vision-prefixed forward (1,024 nonzero embeddings ahead of 512 text
    tokens, 2 rows), its first layer's residual and last logits card
    against CPU, the prefix used (the logits without it differ); 2 train
    steps on one rank through ``Session`` (``remat="full"``: the dry
    run's ``group:8`` remats nothing at 4 layers, as the reference does
    when G does not divide L) after the memory model's verdict, their
    launches the layer loop's; the static ``Engine`` on phase 4's
    requests as text.  Returns (summary, launches by path)."""
    from repro_torch.api import Session
    from repro_torch.core import memory as mem_mod
    from repro_torch.train import optimizer as opt
    cfg = dataclasses.replace(get_config(INTERNVL),
                              n_layers=INTERNVL_LAYERS)
    sess = Session(device="cuda")
    fp = mem_mod.estimate_stage_footprints(
        cfg, local_batch=INTERNVL_BATCH,
        seq_len=cfg.n_vision_tokens + INTERNVL_TEXT)[0]
    print(f"{INTERNVL} cut ({cfg.n_layers} layers, {cfg.param_count()} "
          f"parameters): the memory model's footprint {fp.total / 2**30:.2f}"
          f" GiB against {sess.budget.usable / 2**30:.2f} usable: fits "
          f"{fp.fits(sess.budget)}", flush=True)
    require(fp.fits(sess.budget), f"{INTERNVL}'s cut does not fit")
    plan = sess.plan(cfg, batch=INTERNVL_BATCH,
                     seq=cfg.n_vision_tokens + INTERNVL_TEXT, comms="off",
                     microbatches=1, adamw=opt.AdamWConfig(
                         lr=opt.warmup_cosine(TRAIN_PEAK, 0, 2)),
                     model_kwargs={"remat": "full"})
    sess.init_state(plan, seed=SEED)
    model = plan.model
    params = sess.state["train_state"]["params"]
    batch = internvl_batch(cfg, SEED)
    toks = torch.from_numpy(batch["tokens"]).cuda().long()
    ve = batch["vision_embeds"]
    with torch.no_grad():
        logits = model.forward(params, toks, ve)[0]
        bare = model.forward(params, toks)[0]
    S = cfg.n_vision_tokens + INTERNVL_TEXT
    require(tuple(logits.shape) == (INTERNVL_BATCH, S, cfg.padded_vocab)
            and bool(torch.isfinite(logits).all()),
            f"{INTERNVL}: logits {tuple(logits.shape)}")
    moved = float((logits[:, cfg.n_vision_tokens:] - bare).abs().max()
                  / bare.abs().max())
    require(moved > LOGIT_TOL, f"{INTERNVL}: the prefix moved the logits "
                               f"by {moved:.3g} of the largest")
    del logits, bare
    # the first layer card vs cpu: its residual over every position and
    # the last position's logits
    small = dataclasses.replace(cfg, n_layers=INTERNVL_CPU_LAYERS)
    sub = {k: (v[:INTERNVL_CPU_LAYERS] if k.startswith("layers.") else v)
           .detach() for k, v in params.items()}
    res = []
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        m = Model(small, device=dev)
        p = {k: v.to(dev) for k, v in sub.items()}
        with torch.no_grad():
            x, _ = m._dense_stack(p, toks.to(dev), None, ve.to(dev))
            res.append((x.float().cpu(), m._head(p, x[:, -1:])[:, 0]
                        .float().cpu()))
        del p
    cpu_s = time.perf_counter() - t0
    (xc, lc), (xp, lp) = res
    x_rel = float((xc - xp).norm() / xp.norm())
    x_max = float((xc - xp).abs().max() / xp.abs().max())
    print(f"{INTERNVL} first layer's residual over the prefix and the text, "
          f"card vs cpu: relative rms {x_rel:.3g}, max abs diff {x_max:.3g} "
          f"of the largest ({cpu_s:.1f} s)", flush=True)
    require(x_max <= STATE_TOL, f"{INTERNVL}: the residual disagrees")
    cpu = agree(lc, lp, f"card vs cpu last logits ({INTERNVL}, full width, "
                        "first layer, 1,024 vision + 512 text, 2 rows)")
    del res, xc, xp, sub
    # train: 2 steps
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    L = cfg.n_layers
    fwd = 7 * L + 1
    expect = launch_counts(matmul=fwd + (fwd - 1) + 2 * fwd, attention=2 * L,
                           attention_backward=L)
    losses, walls, total = [], [], {}
    for seed in (SEED, SEED + 1):
        b = internvl_batch(cfg, seed)
        before = ops.dispatch_report()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in sess.step(plan, b).items()}
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        got = {k: v - before[k] for k, v in ops.dispatch_report().items()}
        require(got == expect, f"{INTERNVL} step launches {got}, expected "
                               f"{expect}")
        require(math.isfinite(m["loss"]), f"{INTERNVL}: metrics {m}")
        losses.append(m["loss"])
        total = {k: total.get(k, 0) + v for k, v in got.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"{INTERNVL} steps: losses {losses}, wall ms {walls}, peak "
          f"{peak / 2**30:.2f} GiB against the model's "
          f"{fp.total / 2**30:.2f}; launches {total}", flush=True)
    # serve as text
    serve_params = {k: v.detach() for k, v in params.items()}
    del sess, plan
    torch.cuda.empty_cache()
    ops.reset_launches()
    fin, dt, steps = serve(Engine, model, serve_params, requests(cfg))
    slaunch = ops.dispatch_report()
    require(slaunch == dense_serve_launches(cfg, steps, len(fin)),
            f"{INTERNVL} serve launches {slaunch}")
    sstats = serve_stats(INTERNVL, sum(p.numel() for p in
                                       serve_params.values()),
                         fin, dt, slaunch, torch.cuda.max_memory_allocated(),
                         0)
    print(f"serve {INTERNVL} ({L} layers, as text) " + json.dumps(sstats),
          flush=True)
    del model, serve_params
    torch.cuda.empty_cache()
    tokens = INTERNVL_BATCH * S
    summary = dict(arch=INTERNVL, layers=L, prefix_moves_logits=moved,
                   card_vs_cpu=dict(residual_rel_rms=x_rel,
                                    residual_max_frac=x_max, **cpu),
                   cpu_seconds=cpu_s, losses=losses, step_wall_ms=walls,
                   tokens_per_step=tokens, peak_gib=peak / 2**30,
                   model_footprint_gib=fp.total / 2**30, serve=sstats)
    print("internvl " + json.dumps(summary), flush=True)
    return summary, {INTERNVL_TRAIN_PATH: total,
                     f"{INTERNVL} ({L} layers) dense cache": slaunch}


def families_phase():
    """Phase 15: zamba2-1.2b's kernels at its shapes, zamba2 served and
    trained at full width and depth, musicgen-medium served at full width
    and depth, internvl2-26b's vision-prefixed 4-layer cut.  Returns (the
    kernel entries at zamba2's shapes, a summary, launches by path)."""
    t = {}
    t0 = time.perf_counter()
    kernels = check_zamba_kernels(get_config(ZAMBA))
    t["b_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    served, paths, params = serve_zamba()
    t["a_serve_zamba"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the served weights train: no second draw of 1.17 B parameters
    trained, train_launches = train_zamba(params)
    del params
    torch.cuda.empty_cache()
    paths[ZAMBA_TRAIN_PATH] = train_launches
    t["c_train_zamba"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    music, mpaths = serve_musicgen()
    paths.update(mpaths)
    t["d_serve_musicgen"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vlm, vpaths = internvl_phase()
    paths.update(vpaths)
    t["e_internvl"] = time.perf_counter() - t0
    print(f"phase 15 seconds by part: {json.dumps(t)}", flush=True)
    return kernels, dict(zamba_serve=served, zamba_train=trained,
                         musicgen=music, internvl=vlm, seconds=t), paths


# ---------------------------------------------------------------------------
# phase 16: AlexNet (the paper's Table 1 network) and the robustness layer
# ---------------------------------------------------------------------------

ALEX_PARAMS, ALEX_CONV_PARAMS = 62_369_152, 3_747_200
ALEX_CHECK_BATCH, ALEX_BATCH, ALEX_STEPS = 8, 128, 6
ALEX_MESH, ALEX_RANKS = (2, 2), 4
ALEX_PATH = "alexnet (1 rank, 128 images)"
ALEX_MESH_PATH = "alexnet ((2,2) mesh, 4 ranks, 128 images)"
# tests/test_torch_convnet.py's gradient rule: the bf16 rule (2e-2 of
# each value plus 2e-2 of the leaf's largest) for all but 0.5% of each
# leaf's elements, and CPU_GRAD_TOL relative rms.  fp32 sums in another
# order round some bf16 activations the other way, and a ReLU input or a
# max-pool window's top two within that ulp pass or send a whole row's
# gradient elsewhere: phase 6's rule on the largest error does not hold
# here (on an H100, fc2_w's largest error card against CPU was 13.4% of
# the largest, on 0.02% of its elements, at 1.7% relative rms)
ALEX_RULE, ALEX_OUTSIDE = 2e-2, 5e-3
# each conv, card against CPU on the same input and the same upstream
# gradient: its fp32 output, input gradient and weight gradient, as a
# fraction of the largest of each: fp32 sums of up to 8 x 56 x 56
# products in another order; a TF32 product (10 mantissa bits) would
# miss it.  End to end the conv leaves part by more than either rule
# (on an H100 conv0_w parted by 5.7% rms card against CPU, and by 4.5%
# at (2,2) against one rank, whose convs run at another batch): where
# about 2% of
# the bf16 activations round the other way, the 3 x 3 max-pools' argmax
# moves wherever a window's top two sit within an ulp and sends that
# window's gradient to another position.  They are printed; at (2,2)
# they are held by the rule against the one-rank gradients of each
# rank's own rows (the same convs at the same batch), summed over data
CONV_FP32_TOL = 1e-4
# the reference's own spread, its (2,2) against its (1,1) at scale_down 8
# on the CPU (4 fake devices, tests/test_torch_convnet.py's inputs): the
# loss equal, every gradient within 0.28% of its leaf's largest
REF_MESH_SPREAD = 2.8e-3
# the drills: qwen2-0.5b at full width cut to 4 layers, one rank.  Its
# 4.65 GB train state takes seconds to write to a checkpoint (1.4-2.9 s
# on an H100's host) and its first two pinned snapshots ~2 s each, so
# the NaN drill refreshes the snapshot every DRILL_SNAPSHOT_EVERY steps,
# the drills that never roll back take one an attempt
# (snapshot_every=0), and only the torn drill checkpoints every
# DRILL_EVERY steps (the straggler drill's one checkpoint is its
# escalation's)
DRILL_LAYERS, DRILL_STEPS, DRILL_EVERY = 4, 8, 2
DRILL_SNAPSHOT_EVERY = 2
DRILL_BATCH, DRILL_SEQ = 2, 256
DRILL_PATH = (f"{ARCH} drills ({DRILL_LAYERS} layers, 1 rank, "
              f"{DRILL_STEPS} steps a run)")
# the serve drill: phase 4's model and requests; every free page stolen at
# tick 30 for 24 ticks (two preemptions in a CPU run of the same lengths)
STORM = dict(seam="serve.pool_storm", step=30, magnitude=128, duration=24)
STORM_PATH = f"{ARCH} serve drill (pool storm, {SERVE_LAYERS} layers)"
ROBUST_DIR = TRAIN_DIR / "robust"


def alex_plan():
    from repro_torch.core.planner import ParallelPlan
    return ParallelPlan(batch_axes=("data",), tp_axis="model",
                        attn_mode="none", fsdp=False,
                        seq_parallel_residual=False)


def alex_batch(n: int, seed: int):
    """``n`` NHWC 224² images (bf16, from the seed) and their labels."""
    return (randn((n, 224, 224, 3), seed),
            torch.randint(0, 1000, (n,), generator=gen(seed + 1),
                          device="cuda"))


def conv_flops(batch: int, img: int = 224) -> float:
    """FLOPs of the conv stack's products for a forward and backward on
    ``batch`` images: 2 per multiply-add, forward, weight gradient and
    (but for the first, whose input is the images) input gradient."""
    from repro_torch.models import convnet
    h, c_in, flops = img, 3, 0.0
    for i, (c_out, k, s, pool) in enumerate(convnet.CONV_STAGES):
        h = -(-h // s)
        macs = batch * h * h * c_out * k * k * c_in
        flops += 2 * macs * (3 if i else 2)
        if pool:
            h = (h - convnet.POOL) // convnet.POOL_STRIDE + 1
        c_in = c_out
    return flops


def fc_products(batch: int, params):
    """The FC head's 9 products a step, (M, K, N) with their operands'
    roles: 3 forward, then each one's dA = dC Bᵀ and dB = Aᵀ dC."""
    dims = [tuple(params[f"fc{i}_w"].shape) for i in (1, 2, 3)]
    fwd = [(batch, k, n) for k, n in dims]
    bwd = [p for (m, k, n) in fwd for p in ((m, n, k), (k, m, n))]
    return fwd + bwd


def leaf_stats(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """Relative rms, the largest error over the largest value, and the
    share of elements outside :data:`ALEX_RULE`."""
    got, want = got.float(), want.float()
    require(bool(torch.isfinite(got).all()), f"{what}: not finite")
    d = (got - want).abs()
    big = float(want.abs().max())
    return dict(rel_rms=float((got - want).norm() / want.norm()),
                max_abs_frac=float(d.max()) / big,
                outside_frac=float((d > ALEX_RULE * (want.abs() + big))
                                   .float().mean()))


def convnet_rule(got: torch.Tensor, want: torch.Tensor, what: str,
                 failed: list) -> dict:
    """:data:`ALEX_RULE` for all but :data:`ALEX_OUTSIDE` of the elements
    and ``CPU_GRAD_TOL`` relative rms; a miss is appended to ``failed``."""
    out = leaf_stats(got, want, what)
    if out["outside_frac"] > ALEX_OUTSIDE or out["rel_rms"] > CPU_GRAD_TOL:
        failed.append(f"{what}: {out} (rule {ALEX_RULE}, outside <= "
                      f"{ALEX_OUTSIDE}, rms <= {CPU_GRAD_TOL})")
    return out


def conv_stages_against_cpu(params, images, failed: list) -> dict:
    """Each conv on the card against the CPU on the same NCHW input (the
    card's previous stage, moved) and the same upstream gradient (seeded,
    fp32): its output, input gradient and fp32 weight gradient, each as a
    fraction of the largest, held to :data:`CONV_FP32_TOL`."""
    from repro_torch.models import convnet
    x = images.permute(0, 3, 1, 2)
    out = {}
    for i, (_, _, _, pool) in enumerate(convnet.CONV_STAGES):
        name = f"conv{i}_w"
        res = []
        for dev in ("cuda", "cpu"):
            w = params[name].float().to(dev).requires_grad_(True)
            xin = x.float().to(dev).requires_grad_(True)
            y = convnet.conv_stage({name: w}, i, xin)
            g = randn(y.shape, SEED + 80 + i, dtype=torch.float32).to(dev)
            dx, dw = torch.autograd.grad(y, (xin, w), g)
            res.append([t.detach().cpu() for t in (y, dx, dw)])
        errs = {k: float((c - p).abs().max() / p.abs().max())
                for k, c, p in zip(("output", "input_grad", "weight_grad"),
                                   *res)}
        out[f"conv{i}"] = errs
        if max(errs.values()) > CONV_FP32_TOL:
            failed.append(f"conv{i}: card against CPU {errs} of the largest "
                          f"(tolerance {CONV_FP32_TOL})")
        with torch.no_grad():
            y = convnet.conv_stage(params, i, x)
            b = params[f"conv{i}_b"].float()
            x = torch.relu(y + b[:, None, None]).to(torch.bfloat16)
            if pool:
                x = torch.nn.functional.max_pool2d(x, 3, 2)
    return out


def alexnet_one_rank(failed: list):
    """Phase 16 (a): AlexNet at full width on one rank; saves the batch's
    gradients for (b).  Returns (summary, launches of one step); the
    checks that miss are appended to ``failed``."""
    from repro_torch.kernels.roofline import FP32_FLOPS, matmul_cost
    from repro_torch.models import convnet
    plan = alex_plan()
    params = convnet.init(SEED, plan, None, device="cuda")
    n = sum(v.numel() for v in params.values())
    n_conv = sum(v.numel() for k, v in params.items() if k.startswith("conv"))
    require((n, n_conv) == (ALEX_PARAMS, ALEX_CONV_PARAMS),
            f"alexnet: {n} parameters, {n_conv} in the conv stack")
    out = dict(params=n, conv_params=n_conv)
    # card against the CPU's plain versions at 8 images
    t0 = time.perf_counter()
    imgs, labels = alex_batch(ALEX_CHECK_BATCH, SEED + 60)
    out["conv_fp32_err_by_stage"] = conv_stages_against_cpu(params, imgs,
                                                             failed)
    lc, gc = convnet.value_and_grad(params, imgs, labels, plan)
    lp, gp = convnet.value_and_grad({k: v.cpu() for k, v in params.items()},
                                    imgs.cpu(), labels.cpu(), plan)
    lc, lp = float(lc), float(lp)
    if abs(lc - lp) > CPU_LOSS_RTOL * abs(lp):
        failed.append(f"alexnet card vs cpu: loss {lc} vs {lp}")
    out["against_cpu"] = dict(
        batch=ALEX_CHECK_BATCH, loss_card=lc, loss_cpu=lp,
        fc_leaves={k: convnet_rule(gc[k].cpu(), gp[k], f"alexnet {k}",
                                   failed)
                   for k in gc if k.startswith("fc")},
        conv_leaves_printed={k: leaf_stats(gc[k].cpu(), gp[k], k)
                             for k in gc if k.startswith("conv")},
        seconds=time.perf_counter() - t0)
    del gc, gp
    # the step at 128 images
    imgs, labels = alex_batch(ALEX_BATCH, SEED + 61)

    def step():
        return convnet.value_and_grad(params, imgs, labels, plan)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(ALEX_STEPS):
        if i == ALEX_STEPS - 1:
            ops.reset_launches()
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    launches = ops.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    if launches["matmul"] != 9 or any(
            v for k, v in launches.items() if k != "matmul"):
        failed.append(f"alexnet: launches {launches}, expected 9 GEMM "
                      "products a step (3 forward, 6 backward)")
    wall = statistics.median(walls[1:])
    prof, lo, hi = profiled_step(step)
    busy = union_ns(device_intervals(prof), lo, hi)
    fams = device_breakdown(prof, busy=("gemm",))
    # the conv stack's forward and backward alone (bias, ReLU and pools
    # with it), device ms by CUDA events
    conv_leaves = {k: v.detach().requires_grad_(k.startswith("conv"))
                   for k, v in params.items()}
    names = [k for k in conv_leaves if k.startswith("conv")]

    def conv_fwd_bwd():
        feats = convnet._features(conv_leaves, imgs)
        return torch.autograd.grad(feats.float().sum(),
                                   [conv_leaves[k] for k in names])

    conv_fwd_bwd()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        conv_fwd_bwd()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    flops = conv_flops(ALEX_BATCH)
    # the FC head's 9 products: the GEMM in the step, and torch.matmul's
    # time for the same products (timed only)
    prods = fc_products(ALEX_BATCH, params)
    ab = [(randn((m, k), SEED + 70 + i), randn((k, nn), SEED + 90 + i))
          for i, (m, k, nn) in enumerate(prods)]
    kernel_ms = sum(cuda_ms([lambda a=a, b=b: ops.matmul(a, b, torch.float32)
                             ], 5) for a, b in ab)
    torch_ms = sum(cuda_ms([lambda a=a, b=b: torch.matmul(a, b)], 5)
                   for a, b in ab)
    fc_bytes, fc_flops = (sum(c) for c in zip(*(matmul_cost(*p)
                                                 for p in prods)))
    ops.reset_launches()
    out.update(
        loss=float(loss), step_wall_ms_median=wall, step_wall_ms=walls,
        images_per_s=ALEX_BATCH / wall * 1e3,
        device_busy_ms=busy / 1e6, device_idle_share=1 - busy / (hi - lo),
        device_ms_by_family=fams, peak_gib=peak / 2**30, launches=launches,
        conv_stack_fwd_bwd_ms=statistics.median(times),
        conv_stack_gflop=flops / 1e9,
        conv_stack_fp32_bound_ms=flops / FP32_FLOPS * 1e3,
        fc_products=[list(p) for p in prods],
        fc_gemm_kernel_ms=kernel_ms, fc_torch_matmul_ms=torch_ms,
        fc_bound_ms=roofline.bound(fc_bytes, fc_flops)[0])
    ROBUST_DIR.mkdir(parents=True, exist_ok=True)
    torch.save({"loss": loss.cpu(),
                "grads": {k: v.cpu() for k, v in grads.items()}},
               ROBUST_DIR / "alexnet_one_rank.pt")
    print("alexnet one rank " + json.dumps(out), flush=True)
    del params, grads, conv_leaves, ab
    torch.cuda.empty_cache()
    return out, launches


def alexnet_rank(rank, init, result_path):
    """One rank of phase 16 (b): AlexNet on the (2,2) mesh at 128 images,
    against (a)'s one-rank gradients; writes JSON to ``result_path``."""
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.core.distributed import Mesh, close_group, init_group
    from repro_torch.core.layout import batch_block
    from repro_torch.models import convnet
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_group(init, rank=rank, world_size=ALEX_RANKS)
    mesh = Mesh(ALEX_MESH, ("data", "model"), dist.group.WORLD)
    plan = alex_plan()
    params = convnet.init(SEED, plan, mesh, device="cuda")
    imgs, labels = alex_batch(ALEX_BATCH, SEED + 61)
    walls = []
    for i in range(3):
        if i == 2:
            ops.reset_launches()
            D.WIRE.reset()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = convnet.value_and_grad(params, imgs, labels, plan,
                                             mesh=mesh)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    launches = ops.dispatch_report()
    wire = dict(D.WIRE.bytes)
    one = torch.load(ROBUST_DIR / "alexnet_one_rank.pt")
    lays = convnet.param_layouts(plan)
    leaves, spread = {}, 0.0
    for k, g in grads.items():
        want = lays[k].block(one["grads"][k], mesh)
        leaves[k] = leaf_stats(g.cpu(), want, f"alexnet (2,2) rank {rank} {k}")
        spread = max(spread, leaves[k]["max_abs_frac"])
    # one rank's step on this rank's own rows (whole weights, no mesh):
    # its conv leaves' gradients, for the sum over data
    rows = [batch_block(t, mesh, plan.batch_axes) for t in (imgs, labels)]
    _, g_rows = convnet.value_and_grad(
        convnet.init(SEED, plan, None, device="cuda"), *rows, plan)
    torch.save({k: (grads[k].cpu(), g_rows[k].cpu()) for k in grads
                if k.startswith("conv")},
               ROBUST_DIR / f"alexnet_conv_rank{rank}.pt")
    out = dict(rank=rank, coords=mesh.coords, loss=float(loss),
               loss_one_rank=float(one["loss"]), step_wall_ms=walls,
               launches=launches, wire_bytes=wire,
               wire_estimate=convnet.wire_bytes(params, ALEX_BATCH, plan,
                                                mesh),
               leaves=leaves, max_abs_frac=spread)
    Path(result_path.format(rank)).write_text(json.dumps(out))
    dist.barrier()
    close_group()


def alexnet_mesh(failed: list):
    """Phase 16 (b): four gloo ranks on the card, (data=2, model=2); the
    checks that miss are appended to ``failed``."""
    import torch.multiprocessing as mp
    init = f"file://{ROBUST_DIR / 'rendezvous_alexnet'}"
    (ROBUST_DIR / "rendezvous_alexnet").unlink(missing_ok=True)
    results = [ROBUST_DIR / f"alexnet_rank{r}.json"
               for r in range(ALEX_RANKS)]
    for f in results:
        f.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mp.spawn(alexnet_rank,
             args=(init, str(ROBUST_DIR / "alexnet_rank{}.json")),
             nprocs=ALEX_RANKS, join=True)
    ranks = [json.loads(f.read_text()) for f in results]
    convs = [torch.load(ROBUST_DIR / f"alexnet_conv_rank{r}.pt")
             for r in range(ALEX_RANKS)]
    for f in results + [ROBUST_DIR / "alexnet_one_rank.pt"] + [
            ROBUST_DIR / f"alexnet_conv_rank{r}.pt"
            for r in range(ALEX_RANKS)]:
        f.unlink()
    # each rank's conv leaves against half the sum of the one-rank
    # gradients of the two data coordinates' rows (each a mean over 64)
    by_data = {r["coords"]["data"]: convs[i] for i, r in enumerate(ranks)}
    summed = []
    for i, r in enumerate(ranks):
        st = {}
        for k, (mesh_g, _) in convs[i].items():
            want = 0.5 * (by_data[0][k][1].float() + by_data[1][k][1].float())
            st[k] = convnet_rule(mesh_g, want, f"alexnet (2,2) rank "
                                 f"{r['rank']} {k} against its rows'", failed)
        summed.append(max(v["rel_rms"] for v in st.values()))
    for r in ranks:
        what = f"alexnet (2,2) rank {r['rank']}"
        if abs(r["loss"] - r["loss_one_rank"]) \
                > CPU_LOSS_RTOL * abs(r["loss_one_rank"]):
            failed.append(f"{what}: loss {r['loss']} against one rank's "
                          f"{r['loss_one_rank']}")
        if r["wire_bytes"] != r["wire_estimate"]:
            failed.append(f"{what}: bytes {r['wire_bytes']} against the "
                          f"layouts' {r['wire_estimate']}")
        if r["launches"]["matmul"] != 9:
            failed.append(f"{what}: launches {r['launches']}")
        for k, st in r["leaves"].items():
            if k.startswith("fc") and (st["outside_frac"] > ALEX_OUTSIDE
                                       or st["rel_rms"] > CPU_GRAD_TOL):
                failed.append(f"{what} {k}: {st} (rule {ALEX_RULE}, outside "
                              f"<= {ALEX_OUTSIDE}, rms <= {CPU_GRAD_TOL})")
    if len({r["loss"] for r in ranks}) != 1:
        failed.append("alexnet (2,2): the ranks' losses differ")
    out = dict(mesh=dict(zip(("data", "model"), ALEX_MESH)),
               backend="gloo (host memory), one card",
               loss=ranks[0]["loss"], loss_one_rank=ranks[0]["loss_one_rank"],
               step_wall_ms_by_rank=[r["step_wall_ms"] for r in ranks],
               wire_bytes_by_rank=[r["wire_bytes"] for r in ranks],
               wire_estimate_by_rank=[r["wire_estimate"] for r in ranks],
               max_abs_frac_by_rank=[r["max_abs_frac"] for r in ranks],
               conv_against_rows_worst_rel_rms_by_rank=summed,
               reference_own_spread=REF_MESH_SPREAD,
               worst_leaf_by_rank=[max(r["leaves"].items(),
                                       key=lambda kv: kv[1]["rel_rms"])
                                   for r in ranks],
               seconds=time.perf_counter() - t0)
    print("alexnet (2,2) " + json.dumps(out), flush=True)
    return out, {k: sum(r["launches"][k] for r in ranks)
                 for k in ranks[0]["launches"]}


class TimedCheckpoints(CheckpointManager):
    """A ``CheckpointManager`` that records each snapshot's write (the
    disk part, on the writer thread or blocking) in ms by step."""

    def __init__(self, directory):
        super().__init__(str(directory))
        self.write_ms = {}

    def _write(self, step, manifest, host):
        t0 = time.perf_counter()
        super()._write(step, manifest, host)
        self.write_ms[step] = 1e3 * (time.perf_counter() - t0)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def drills():
    """Phase 16 (c): the train drills on qwen2-0.5b at full width, cut to
    ``DRILL_LAYERS`` layers, one rank: a no-fault oracle; a NaN step and
    a collective timeout recovered bitwise; a torn checkpoint restarted by
    ``ElasticRunner``; a straggler burst escalated and restarted.
    Returns (summary, launches over the runs)."""
    from repro_torch import faults as F
    from repro_torch import obs as obs_mod
    from repro_torch.api import Session
    from repro_torch.data import SyntheticLM
    from repro_torch.train import (ElasticRunner, ResilienceConfig,
                                   ResilientStepLoop, StepTimeWatchdog)
    from repro_torch.train import optimizer as opt
    cfg = dataclasses.replace(get_config(ARCH), n_layers=DRILL_LAYERS)
    adamw = opt.AdamWConfig(lr=opt.warmup_cosine(TRAIN_PEAK, TRAIN_WARMUP,
                                                 DRILL_STEPS))
    snap_ms = []

    class Timed(Session):
        def snapshot_state(self, name="train_state"):
            t0 = time.perf_counter()
            out = super().snapshot_state(name)
            snap_ms.append(1e3 * (time.perf_counter() - t0))
            return out

    def factory(obs):
        def make(attempt):
            sess = Timed(device="cuda", obs=obs)
            return sess, sess.plan(cfg, batch=DRILL_BATCH, seq=DRILL_SEQ,
                                   comms="off", adamw=adamw)
        return make

    def data():
        return SyntheticLM(cfg.vocab_size, DRILL_BATCH, DRILL_SEQ,
                           seed=SEED, structured=True)

    rcfg = dict(backoff_base_s=0.05)
    counters = ("resil.retries", "resil.nonfinite", "resil.rollbacks",
                "resil.anomalies", "resil.aborts", "resil.skipped_steps",
                "resil.torn_checkpoints")
    out = {}
    ops.reset_launches()
    # the oracle, and the NaN step + the timeout on one loop
    runs = {}
    for name, specs, every in (("oracle", [], 0), ("nonfinite_timeout", [
            F.FaultSpec("train.nonfinite", step=2),
            F.FaultSpec("comms.timeout", step=3)], DRILL_SNAPSHOT_EVERY)):
        obs = obs_mod.Obs(name=f"drill/{name}")
        sess, plan = factory(obs)(0)
        sess.init_state(plan, seed=SEED)
        faults = F.FaultPlan(specs) if specs else None
        t0 = time.perf_counter()
        res = ResilientStepLoop(
            sess, plan, faults=faults,
            config=ResilienceConfig(**rcfg, snapshot_every=every)).run(
            iter(data()), start_step=0, steps=DRILL_STEPS)
        runs[name] = res
        out[name] = dict(losses=res["losses"], skipped=res["skipped"],
                         counters={k: obs.counter(k).value
                                   for k in counters},
                         seconds=time.perf_counter() - t0)
        if name == "oracle":
            out["snapshot_bytes"] = tree_bytes(sess.get("train_state"))
        del sess, plan
    oracle = runs["oracle"]["losses"]
    got = out["nonfinite_timeout"]
    require(got["losses"] == oracle and got["skipped"] == [],
            f"drill: the NaN and timeout run's losses {got['losses']} are "
            f"not the oracle's {oracle}")
    require(got["counters"]["resil.rollbacks"] == 1
            and got["counters"]["resil.retries"] == 1,
            f"drill: counters {got['counters']}")
    # the torn checkpoint, and the straggler burst, through ElasticRunner
    for name, specs, every, kw in (
            ("torn_checkpoint", [F.FaultSpec("checkpoint.torn", step=6)],
             DRILL_EVERY, {}),
            ("straggler_escalation", [
                F.FaultSpec("train.straggler", step=5, magnitude=0.5),
                F.FaultSpec("train.straggler", step=6, magnitude=1.5)],
             0, dict(anomaly_window=8, anomaly_limit=2))):
        obs = obs_mod.Obs(name=f"drill/{name}")
        d = ROBUST_DIR / name
        shutil.rmtree(d, ignore_errors=True)
        mgr = TimedCheckpoints(d)
        faults = F.FaultPlan(specs)
        t0 = time.perf_counter()
        res = ElasticRunner(
            factory(obs), data, ckpt=mgr, steps=DRILL_STEPS,
            ckpt_every=every,
            config=ResilienceConfig(**rcfg, **kw, snapshot_every=0),
            faults=faults,
            seed=SEED,
            watchdog_factory=lambda: StepTimeWatchdog(warmup_steps=3)
        ).run()
        mgr.wait()
        out[name] = dict(
            losses=res["losses"], skipped=res["skipped"],
            restarts=res["restarts"], attempts=res["attempts"],
            counters={k: obs.counter(k).value for k in counters},
            checkpoint_write_ms=mgr.write_ms, valid=mgr.valid_steps(),
            seconds=time.perf_counter() - t0)
        shutil.rmtree(d, ignore_errors=True)
        require(res["losses"] == oracle and res["attempts"] == 2,
                f"drill {name}: losses {res['losses']} against the "
                f"oracle's {oracle}, attempts {res['attempts']}")
    rec = out["torn_checkpoint"]["restarts"][0]
    require((rec["reason"], rec["abort_step"], rec["restored_step"])
            == ("checkpoint.torn", 6, 4), f"drill torn: {rec}")
    rec = out["straggler_escalation"]["restarts"][0]
    require(rec["reason"] == "watchdog_escalation"
            and rec["checkpoint_step"] == rec["abort_step"] + 1
            == rec["restored_step"],
            f"drill straggler: {rec} (an escalation with an early "
            "checkpoint, restored)")
    launches = ops.dispatch_report()
    out.update(snapshot_ms=snap_ms,
               snapshot_ms_median=statistics.median(snap_ms),
               recovery_s={k: out[k]["restarts"][0]["recovery_s"]
                           for k in ("torn_checkpoint",
                                     "straggler_escalation")},
               steps_lost={k: out[k]["restarts"][0]["steps_lost"]
                           for k in ("torn_checkpoint",
                                     "straggler_escalation")},
               launches=launches)
    print("drills " + json.dumps(out), flush=True)
    torch.cuda.empty_cache()
    return out, launches


def storm_drive(eng, reqs):
    """Drive ``eng`` to completion (preemptions allowed); the ticks."""
    for r in reqs:
        eng.submit(r)
    ticks = 0
    while eng.queue or any(r is not None for r in eng.active):
        eng.step()
        ticks += 1
    torch.cuda.synchronize()
    return ticks


def serve_drill():
    """Phase 16 (d): phase 4's model and requests on the
    ``ContinuousEngine`` under an ``arm_engine`` pool storm, with two
    already-expired requests; against a storm-free run of the same
    requests.  Returns (summary, launches of the storm run)."""
    from repro_torch import faults as F
    from repro_torch.serve import DeadlineExceeded
    scfg = dataclasses.replace(get_config(ARCH), n_layers=SERVE_LAYERS)
    model = Model(scfg, device="cuda")
    params = model.init(SEED)
    kw = dict(batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
              prefill_chunk=CHUNK)
    clean = requests(scfg)
    t0 = time.perf_counter()
    clean_ticks = storm_drive(ContinuousEngine(model, params, **kw), clean)
    clean_s = time.perf_counter() - t0
    reqs = requests(scfg) + [
        Request(rid=100 + i, prompt=np.zeros(64, np.int32),
                max_new_tokens=8, deadline_s=1e-9) for i in range(2)]
    eng = ContinuousEngine(model, params, **kw)
    plan = F.FaultPlan([F.FaultSpec(**STORM)])
    F.arm_engine(plan, eng)
    ops.reset_launches()
    t0 = time.perf_counter()
    ticks = storm_drive(eng, reqs)
    storm_s = time.perf_counter() - t0
    launches = ops.dispatch_report()
    preempted = {r.rid: r.n_preempted for r in reqs if r.n_preempted}
    want = {r.rid: r.out for r in clean}
    got = {r.rid: r.out for r in eng.finished}
    out = dict(storm=STORM, injected=plan.injected(), ticks=ticks,
               clean_ticks=clean_ticks, preemptions=sum(preempted.values()),
               preempted=preempted, shed=sorted(r.rid for r in eng.shed),
               refused=[r.rid for r in eng.refused],
               seconds=storm_s, clean_seconds=clean_s, launches=launches)
    print("serve drill " + json.dumps(out), flush=True)
    require(plan.injected() == 1 and sum(preempted.values()) >= 1,
            "serve drill: the storm preempted nothing")
    require(out["shed"] == [100, 101] and all(
        isinstance(r.refusal, DeadlineExceeded) for r in eng.shed),
        "serve drill: the expired requests were not shed")
    require(not eng.refused and got == want,
            "serve drill: an admitted request's tokens differ from the "
            "storm-free run's")
    require(launches["matmul"] > 0 and launches["attention"] > 0
            and launches["paged_decode_attention"] > 0,
            f"serve drill: launches {launches}")
    del model, params, eng
    torch.cuda.empty_cache()
    return out, launches


def robust_phase():
    """Phase 16: (a)-(d); returns (summary, launches by path)."""
    t = {}
    failed = []          # (a)'s and (b)'s misses, raised after (d)
    t0 = time.perf_counter()
    one, one_launches = alexnet_one_rank(failed)
    t["a_alexnet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh, mesh_launches = alexnet_mesh(failed)
    t["b_alexnet_mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    drill, drill_launches = drills()
    t["c_drills"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    storm, storm_launches = serve_drill()
    t["d_serve_drill"] = time.perf_counter() - t0
    print(f"phase 16 seconds by part: {json.dumps(t)}", flush=True)
    require(not failed, "phase 16: " + "; ".join(failed))
    return (dict(alexnet=one, alexnet_mesh=mesh, drills=drill,
                 serve_drill=storm, seconds=t),
            {ALEX_PATH: one_launches, ALEX_MESH_PATH: mesh_launches,
             DRILL_PATH: drill_launches, STORM_PATH: storm_launches})


# ---------------------------------------------------------------------------
# phase 17: serving on a mesh (the dense family), four ranks on the card
# ---------------------------------------------------------------------------

MESH_SERVE_DIR = TRAIN_DIR / "mesh_serve"
MESH_SHAPES = ((1, 4), (2, 2))
MESH_RANKS = 4
MESH_SLOTS, MESH_MAX_SEQ, MESH_NEW = 8, 2048, 32
MESH_REQUESTS = 8                   # the first 8 of phase 4's requests
MESH_ENGINES = ("dense", "continuous")
MESH_LOGIT_TOL = 0.05               # of the largest one-rank logit
MESH_LOGIT_STEPS = 8                # decode steps whose logits are held
MESH_PROMPT = 512                   # the one-slot prefill whose wire counts
# qwen2's K/V: 24 layers x 2 (k, v) x 2 kv heads x 64 x 2 bytes = 12,288
# B a token; 8 slots of 2,048 positions, 201 MB
MESH_KV_BYTES = 12_288 * MESH_SLOTS * MESH_MAX_SEQ
ODD_HEAD_DIMS = (40, 42, 48, 56, 160, 168)
MESH_DEVICE = "cuda"                # a CPU rehearsal sets "cpu"


def mesh_engine(kind, model, params):
    """Phase 17's engines: the static one on the dense cache, the
    continuous one on pages of ``PAGE`` with ``CHUNK``-token chunks."""
    if kind == "dense":
        return Engine(model, params, batch_slots=MESH_SLOTS,
                      max_seq=MESH_MAX_SEQ)
    return ContinuousEngine(model, params, batch_slots=MESH_SLOTS,
                            max_seq=MESH_MAX_SEQ, page_size=PAGE,
                            prefill_chunk=CHUNK)


def mesh_warm(kind, model, params, cfg):
    """One short request through a new engine of ``kind`` (its first
    calls: the allocator's and the group's first buffers)."""
    warm = mesh_engine(kind, model, params)
    warm.submit(Request(rid=0, prompt=requests(cfg, 2)[0].prompt[:PAGE],
                        max_new_tokens=2))
    warm.run()


def recorded(eng):
    """Wrap ``eng``'s decode step: each step's wall (synchronized), the
    (tokens, positions) it was fed, and the first ``MESH_LOGIT_STEPS``
    steps' logits on the host."""
    inner, rec = eng._decode, dict(walls=[], fed=[], logits=[])

    def step(params, cache, tokens, pos, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = inner(params, cache, tokens, pos, **kw)
        torch.cuda.synchronize()
        rec["walls"].append(time.perf_counter() - t0)
        rec["fed"].append((tokens[:, 0].tolist(), pos.tolist()))
        if len(rec["logits"]) < MESH_LOGIT_STEPS:
            rec["logits"].append(logits[:, 0].float().cpu())
        return logits, cache

    eng._decode = step
    return rec


def mesh_serve_run(kind, model, params, cfg):
    """One engine over phase 17's requests: (tokens by rid, seconds, the
    decode record, the cache's bytes on this rank)."""
    eng = mesh_engine(kind, model, params)
    rec = recorded(eng)
    nbytes = sum(t.numel() * t.element_size() for t in eng.cache.values()
                 if t.dtype == torch.bfloat16)
    for r in requests(cfg, MESH_NEW)[:MESH_REQUESTS]:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {str(r.rid): [int(t) for t in r.out] for r in fin}, dt, rec, \
        nbytes, eng


def mesh_wire_estimate(cfg, plan, mesh, B, what: str, S: int = 1,
                       T: int = None):
    """Bytes this rank receives, by collective, for one serving call on
    the mesh, from the layouts: ``what`` is ``decode`` (the dense cache of
    B slots of T), ``paged`` (a pool's decode step), ``prefill`` (a
    one-slot prefill of S tokens) or ``chunk`` (a paged chunk of S tokens
    at the start of a row of pages 1, 2, ..., whose ``ceil(S / PAGE)``
    live pages lie on consecutive ranks).  Each all-gather
    receives (n - 1) blocks; a floating psum over n > 2 ranks gathers the
    others' tensors, over 2 it is gloo's all-reduce, 2 (n - 1) / n of
    one."""
    T = MESH_MAX_SEQ if T is None else T
    shape = mesh.shape
    tp = shape[plan.tp_axis]
    hd, H, Hkv, D, V = (cfg.d_head, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_model, cfg.padded_vocab)
    L = cfg.n_layers
    rows = (what == "decode" and B % shape["data"] == 0
            and B >= shape["data"])
    b = B // shape["data"] if rows else B
    n_seq = tp * (1 if rows else shape["data"])
    head_tp = plan.attn_mode == "head_tp"
    gather = 0
    reduce = 0

    def psum(nbytes):
        return (tp - 1) * nbytes if tp > 2 else 2 * (tp - 1) * nbytes // tp

    tokens = b * S
    gather += (tp - 1) * tokens * (D // tp) * 2             # the embedding
    gather += (tp - 1) * (b if what != "chunk" and what != "prefill"
                          else (1 if what == "prefill" else S)) \
        * (V // tp) * 4                                       # the logits
    if rows:
        gather += (shape["data"] - 1) * b * V * 4
    per_layer = 0
    if head_tp:
        heads = (H + 2 * Hkv) if what in ("decode", "paged") else 2 * Hkv
        per_layer += (tp - 1) * tokens * (heads // tp) * hd * 2
        reduce += L * psum(tokens * D * 4)                    # wo's shares
    if not plan.ffn_replicated:
        reduce += L * psum(tokens * D * 4)                    # the MLP's
    if what == "decode":
        splits = -(-(T // n_seq) // paged_mod.SPLIT)
        per_layer += (n_seq - 1) * b * H * splits * (hd + 2) * 4
    elif what == "paged":
        splits = paged_mod.splits_of(-(-T // PAGE), PAGE)
        per_layer += (n_seq - 1) * b * H * splits * (hd + 2) * 4
    elif what == "chunk":
        # each rank sends its held pages of the row, padded to the most
        # any rank holds: ceil(n_live / n) of pages 1 .. n_live
        held = -(-(-(-S // PAGE)) // n_seq)
        per_layer += (n_seq - 1) * 2 * held * PAGE * Hkv * hd * 2
    gather += L * per_layer
    out = {"all_gather": gather}
    if reduce:
        out["all_reduce"] = reduce
    return out


def mesh_serve_rank(rank, init, result_dir):
    """One rank of phase 17: qwen2-0.5b at full width and depth on each
    mesh, both engines over phase 17's requests, then one decode step,
    one prefill and one chunk by themselves for their bytes by
    collective, one decode step profiled; results to ``result_dir``."""
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.core.distributed import Mesh, close_group, init_group
    init_group(init, rank=rank, world_size=MESH_RANKS,
               device=MESH_DEVICE)
    cfg = get_config(ARCH)
    out, logits = {}, {}
    for shape in MESH_SHAPES:
        tag = "x".join(map(str, shape))
        mesh = Mesh(shape, ("data", "model"), dist.group.WORLD)
        model = Model(cfg, device=MESH_DEVICE, mesh=mesh)
        params = model.init(SEED)
        for kind in MESH_ENGINES:
            mesh_warm(kind, model, params, cfg)
        for kind in MESH_ENGINES:
            dist.barrier()
            ops.reset_launches()
            D.WIRE.reset()
            toks, dt, rec, nbytes, eng = mesh_serve_run(kind, model, params,
                                                        cfg)
            launches = ops.dispatch_report()
            run_wire = dict(D.WIRE.bytes)
            B = MESH_SLOTS
            tok = torch.zeros((B, 1), dtype=torch.long,
                              device=MESH_DEVICE)
            pos = torch.full((B,), 1000, dtype=torch.long,
                             device=MESH_DEVICE)
            paged = kind == "continuous"
            decode = (model.decode_step_paged if paged
                      else model.decode_step)
            D.WIRE.reset()
            decode(params, eng.cache, tok, pos)
            step_wire = dict(D.WIRE.bytes)
            prompt = torch.zeros((1, MESH_PROMPT if not paged else CHUNK),
                                 dtype=torch.long, device=MESH_DEVICE)
            D.WIRE.reset()
            if paged:
                row = torch.arange(1, MESH_MAX_SEQ // PAGE + 1,
                                   dtype=torch.int32, device=MESH_DEVICE)
                model.prefill_chunk_paged(params, eng.cache, prompt, row, 0)
            else:
                model.prefill(params, prompt, cache=eng.cache, slot=0)
            prefill_wire = dict(D.WIRE.bytes)
            dist.barrier()
            prof, lo, hi = profiled_step(
                lambda: decode(params, eng.cache, tok, pos))
            est = dict(
                decode=mesh_wire_estimate(cfg, model.plan, mesh, B,
                                          "paged" if paged else "decode"),
                prefill=mesh_wire_estimate(
                    cfg, model.plan, mesh, 1, "chunk" if paged else
                    "prefill", S=CHUNK if paged else MESH_PROMPT))
            logits[f"{tag}/{kind}"] = torch.stack(rec["logits"])
            out[f"{tag}/{kind}"] = dict(
                tokens=toks, seconds=dt, steps=len(rec["walls"]),
                step_walls_ms=[1e3 * w for w in rec["walls"]],
                fed=rec["fed"][:MESH_LOGIT_STEPS], cache_bytes=nbytes,
                pool_pages=(eng.blocks.num_pages if paged else None),
                launches=launches, run_wire=run_wire,
                decode_wire=step_wire, prefill_wire=prefill_wire,
                wire_estimate=est, rank=rank, coords=mesh.coords,
                profiled_window_ns=[lo, hi],
                device_intervals_ns=device_intervals(prof),
                logits_hash=float(logits[f"{tag}/{kind}"].double().sum()))
            del eng
        del model, params
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save(logits, Path(result_dir) / "logits_mesh.pt")
    Path(result_dir, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    close_group()


def live_split_count(key_live: torch.Tensor) -> int:
    """The (sequence, split) pairs of ``key_live`` (B, T) bool, one rank's
    live keys, that hold a live key: the splits whose o the shard kernel
    writes and the combine reads."""
    B, T = key_live.shape
    splits = -(-T // paged_mod.SPLIT)
    pad = torch.nn.functional.pad(key_live,
                                  (0, splits * paged_mod.SPLIT - T))
    return int(pad.reshape(B, splits, paged_mod.SPLIT).any(-1).sum())


def page_sharded_pools(cfg, lens):
    """The continuous engine's pool in phase 17's mesh layout: 8 slots of
    ``MESH_MAX_SEQ`` positions on pages of ``PAGE``, each row's live pages
    (up to ``lens``) drawn from the global pool in a shuffled order, as an
    allocator hands them out, its tail on the NULL page.  Rank r holds
    the pages ``attention.page_shard`` gives it, so about three of four
    entries of its table are -1.  Returns the global table, K and V pools,
    and per rank (its table, its K and V pools, its live keys (B, T))."""
    from repro_torch.models import attention as attn_mod
    Hkv, hd = cfg.n_kv_heads, cfg.d_head
    B, n, nb = MESH_SLOTS, MESH_RANKS, MESH_MAX_SEQ // PAGE
    used = [-(-int(x) // PAGE) for x in lens.tolist()]
    ids = np.random.default_rng(SEED + 171).permutation(sum(used)) + 1
    table = np.zeros((B, nb), dtype=np.int32)
    for b, u in enumerate(used):
        table[b, :u] = ids[sum(used[:b]):sum(used[:b]) + u]
    table = torch.from_numpy(table).cuda()
    P = sum(used) + 1
    kg, vg = randn((P, PAGE, Hkv, hd), 1710), randn((P, PAGE, Hkv, hd), 1711)
    keys = torch.arange(nb * PAGE, device="cuda")[None] < lens[:, None]
    ranks = []
    for r in range(n):
        held, local = attn_mod.page_shard(table, n, r)
        mine = torch.arange(r + 1, P, n, device="cuda")
        pools = []
        for whole in (kg, vg):
            pool = torch.zeros((attn_mod.local_pages(P, n),) + whole.shape[1:],
                               dtype=whole.dtype, device="cuda")
            pool[(mine - 1) // n + 1] = whole[mine]
            pools.append(pool)
        ranks.append((torch.where(held, local, -1).to(torch.int32), *pools,
                      keys & held.repeat_interleave(PAGE, 1)))
    return table, kg, vg, ranks


def check_shards(q, shards, what):
    """The shard-mode kernel on each rank's ``shards`` entry (K pool, V
    pool, table, lengths) against its plain version: o at the bf16 rule
    where l > 0 (o where l = 0 is left unwritten and read by no one), m
    and l at fp32 rounding of bf16 products, the same bits run to run;
    the combine of the ranks' partials against the plain combine, the
    same bits run to run.  Returns (the partials (n, ...), splits, their
    max abs err, the combine's output, its max abs err)."""
    B, H, hd = q.shape
    splits = paged_mod.splits_of(shards[0][2].shape[1], shards[0][0].shape[1])
    per = B * H * splits

    def partials():
        return torch.stack([paged_mod.paged_decode_partials(q, kp, vp, tb, ls)
                            for kp, vp, tb, ls in shards])

    def live(parts):
        return ref.live_partials(parts, B, H, hd, splits)

    parts = partials()
    err = 0.0
    for r, (kp, vp, tb, ls) in enumerate(shards):
        got = live(parts[r])
        want = ref.paged_decode_partials(q, kp, vp, tb, ls)
        err = max(err, max_err(got[:per * hd], want[:per * hd],
                               f"{what}: shard {r}'s partial outputs"))
        m, l = got[per * hd:per * (hd + 1)], got[per * (hd + 1):]
        mw, lw = want[per * hd:per * (hd + 1)], want[per * (hd + 1):]
        on = lw > 0
        require(torch.equal(l > 0, on) and bool(torch.isinf(m[~on]).all())
                and bool(torch.allclose(m[on], mw[on], rtol=1e-3,
                                        atol=1e-3))
                and bool(torch.allclose(l[on], lw[on], rtol=1e-3)),
                f"{what}: shard {r}'s m and l disagree with the plain "
                "version's")
    require(same_bits(live(partials()), live(parts)),
            f"{what}: shard mode: two runs differ")
    comb = paged_mod.paged_decode_combine(parts, B, H, hd, splits)
    err_comb = max_err(comb, ref.paged_decode_combine(parts, B, H, hd,
                                                      splits),
                       f"{what}: combine")
    require(same_bits(paged_mod.paged_decode_combine(parts, B, H, hd,
                                                     splits), comb),
            f"{what}: combine: two runs differ")
    return parts, splits, err, comb, err_comb


def check_mesh_decode_kernels(cfg):
    """The shard-mode kernel and the combine at phase 17's shapes, qwen2's
    decode (8 slots, 14 heads on 2 kv heads of 64) on 4 ranks, in both
    layouts the engines run: the static engine's dense cache cut into
    (1,4)'s shards (512 positions of 2,048 each, lengths from phase 4's
    prompts), whose combine is bitwise the one-rank call over the whole
    rows, and the continuous engine's pool sharded by page
    (:func:`page_sharded_pools`), whose combine is held to the one-rank
    plain decode.  Each rank and the combine against their plain
    versions (:func:`check_shards`); device ms beside the one-rank
    call's, the bounds from this run's live keys and splits, plain ms."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    B, T, n = MESH_SLOTS, MESH_MAX_SEQ, MESH_RANKS
    t = T // n
    rng = np.random.default_rng(SEED + 17)
    lens = torch.from_numpy(rng.integers(
        PROMPT_MIN, PROMPT_MAX * 3, B).astype(np.int32)).cuda()
    q = randn((B, H, hd), 1700)
    k, v = randn((B, T, Hkv, hd), 1701), randn((B, T, Hkv, hd), 1702)
    table = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    shards = [(k[:, r * t:(r + 1) * t].contiguous(),
               v[:, r * t:(r + 1) * t].contiguous(), table,
               (lens.long() - r * t).clamp(0, t).to(torch.int32))
              for r in range(n)]
    parts, splits, err_part, comb, err_comb = check_shards(
        q, shards, "dense shards")
    one = paged_mod.paged_decode_attention(q, k, v, table, lens)
    require(torch.equal(comb, one), "the dense shards' combine is not the "
            "one-rank call's bits")
    dense_live = [live_split_count(torch.arange(t, device="cuda")[None]
                                   < ls[:, None]) for *_, ls in shards]

    # the continuous engine's pool sharded by page: edges of a page and of
    # the row among the lengths
    plens = torch.tensor([1, PAGE, PAGE + 1] + sorted(rng.integers(
        PAGE + 2, T, 4).tolist()) + [T], dtype=torch.int32, device="cuda")
    ptable, kg, vg, pranks = page_sharded_pools(cfg, plens)
    pshards = [(kp, vp, tb, plens) for tb, kp, vp, _ in pranks]
    pparts, psplits, perr_part, pcomb, perr_comb = check_shards(
        q, pshards, "page shards")
    perr_one = max_err(pcomb, ref.paged_decode_attention(q, kg, vg, ptable,
                                                         plens),
                       "the page shards' combine against the one-rank "
                       "plain decode")
    paged_live = [live_split_count(keys) for *_, keys in pranks]

    kp1, vp1, tb1, _ = pshards[1]
    ks, vs, _, ls = shards[1]
    shard_ms = cuda_ms([lambda: paged_mod.paged_decode_partials(
        q, ks, vs, table, ls)], iters=40)
    shard_plain = cuda_ms([lambda: ref.paged_decode_partials(
        q, ks, vs, table, ls)], iters=5, warmup=1)
    pshard_ms = cuda_ms([lambda: paged_mod.paged_decode_partials(
        q, kp1, vp1, tb1, plens)], iters=40)
    pshard_plain = cuda_ms([lambda: ref.paged_decode_partials(
        q, kp1, vp1, tb1, plens)], iters=5, warmup=1)
    comb_ms = cuda_ms([lambda: paged_mod.paged_decode_combine(
        parts, B, H, hd, splits)], iters=40)
    comb_plain = cuda_ms([lambda: ref.paged_decode_combine(
        parts, B, H, hd, splits)], iters=3, warmup=1)
    pcomb_ms = cuda_ms([lambda: paged_mod.paged_decode_combine(
        pparts, B, H, hd, psplits)], iters=40)
    pcomb_plain = cuda_ms([lambda: ref.paged_decode_combine(
        pparts, B, H, hd, psplits)], iters=3, warmup=1)
    one_ms = cuda_ms([lambda: paged_mod.paged_decode_attention(
        q, k, v, table, lens)], iters=40)
    pone_ms = cuda_ms([lambda: paged_mod.paged_decode_attention(
        q, kg, vg, ptable, plens)], iters=40)
    live = int(ls.sum())
    plive = int(pranks[1][3].sum())
    s_bound, s_by = bound(*roofline.paged_partials_cost(
        B, H, Hkv, hd, live, B, splits, dense_live[1]))
    c_bound, c_by = bound(*roofline.paged_combine_cost(
        n, B, H, hd, splits, sum(dense_live)))
    o_bound, _ = bound(*roofline.paged_decode_cost(
        B, H, Hkv, hd, int(lens.sum()), B))
    ps_bound, ps_by = bound(*roofline.paged_partials_cost(
        B, H, Hkv, hd, plive, ptable.numel(), psplits, paged_live[1]))
    pc_bound, pc_by = bound(*roofline.paged_combine_cost(
        n, B, H, hd, psplits, sum(paged_live)))
    po_bound, _ = bound(*roofline.paged_decode_cost(
        B, H, Hkv, hd, int(plens.sum()), ptable.numel()))
    print(f"mesh decode kernels, dense shards: shard (rank 1's, {live} live "
          f"of {int(lens.sum())}, {dense_live[1]} live splits of "
          f"{B * splits}) {shard_ms:.4f} ms, bound {s_bound:.5f} ({s_by}), "
          f"plain {shard_plain:.4f}; combine of {n} ranks ({sum(dense_live)}"
          f" live of {n * B * splits} splits) {comb_ms:.4f} ms, bound "
          f"{c_bound:.5f} ({c_by}), plain {comb_plain:.4f}; the one-rank "
          f"call over the whole rows {one_ms:.4f} ms (bound {o_bound:.5f}); "
          "shards' combine bitwise the one-rank call", flush=True)
    print(f"mesh decode kernels, page shards: shard (rank 1's, {plive} live "
          f"of {int(plens.sum())}, {paged_live[1]} live splits of "
          f"{B * psplits}) {pshard_ms:.4f} ms, bound {ps_bound:.5f} "
          f"({ps_by}), plain {pshard_plain:.4f}; combine of {n} ranks "
          f"({sum(paged_live)} live of {n * B * psplits} splits) "
          f"{pcomb_ms:.4f} ms, bound {pc_bound:.5f} ({pc_by}), plain "
          f"{pcomb_plain:.4f}; the one-rank call {pone_ms:.4f} ms (bound "
          f"{po_bound:.5f}); combine against the one-rank plain decode: "
          f"max abs err {perr_one:.3g}", flush=True)
    common = dict(route="cuda",
                  source="src/repro_torch/kernels/csrc/paged_attention.cu",
                  replaces="src/repro/kernels/paged_attention.py:71",
                  library_ms=None, one_rank_call_ms=one_ms,
                  one_rank_bound_ms=o_bound)
    return [dict(name="paged_decode_partials",
                 max_abs_err=max(err_part, perr_part),
                 ms=shard_ms, plain_ms=shard_plain, bound_ms=s_bound,
                 bound_by=s_by,
                 case=f"rank 1 of 4 dense shards: q ({B},{H},{hd}) against "
                      f"({B},{t},{Hkv},{hd}), {live} live positions",
                 page_sharded=dict(
                     ms=pshard_ms, plain_ms=pshard_plain, bound_ms=ps_bound,
                     bound_by=ps_by, max_abs_err=perr_part,
                     one_rank_call_ms=pone_ms, one_rank_bound_ms=po_bound,
                     case=f"rank 1 of 4 page shards of a ({B},{T // PAGE}) "
                          f"table of pages of {PAGE}, {plive} live "
                          "positions"),
                 **common),
            dict(name="paged_decode_combine",
                 max_abs_err=max(err_comb, perr_comb),
                 ms=comb_ms, plain_ms=comb_plain, bound_ms=c_bound,
                 bound_by=c_by,
                 case=f"{n} ranks x {splits} splits of ({B},{H},{hd})",
                 page_sharded=dict(
                     ms=pcomb_ms, plain_ms=pcomb_plain, bound_ms=pc_bound,
                     bound_by=pc_by, max_abs_err=perr_comb,
                     max_abs_err_one_rank=perr_one,
                     case=f"{n} ranks x {psplits} splits of "
                          f"({B},{H},{hd})"),
                 **common)]


def check_head_dims():
    """Flash attention (forward bf16 and fp32, backward) and the paged
    decode at head dims 40, 42, 48, 56, 160 and 168 (on the tile of the
    next width, columns past D masked; 42 loads element by element)
    against their plain versions; each timed.  Returns per-D errors and
    ms."""
    out = {}
    for d in ODD_HEAD_DIMS:
        q, k, v = (randn((1, 14, 128, d), 1800), randn((1, 2, 512, d), 1801),
                   randn((1, 2, 512, d), 1802))
        kw = dict(causal=True, q_offset=384)
        e_fwd = max_err(ops.attention(q, k, v, **kw),
                        ref.attention(q, k, v, **kw), f"flash D={d}")
        qf, kf, vf = (x.float() for x in (q, k, v))
        got = ops.attention(qf, kf, vf, **kw)
        e_f32 = float((got - ref.attention(qf, kf, vf, **kw)).abs().max())
        require(e_f32 <= 2e-2, f"flash fp32 D={d}: max abs err {e_f32:.3g}")
        qt, kt, vt = (randn((2, 14, 512, d), 1803), randn((2, 2, 512, d),
                                                          1804),
                      randn((2, 2, 512, d), 1805))
        dout = randn((2, 14, 512, d), 1806)
        leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
        got = torch.autograd.grad(ops.attention(*leaves, causal=True),
                                  leaves, dout)
        want = ref.attention_backward(qt, kt, vt, dout, causal=True)
        o_t, lse_t = fa_mod._forward(qt, kt, vt, True, None, None,
                                     d ** -0.5, 0, with_lse=True)
        e_bwd = 0.0
        for g, w in zip(got, want):
            g, w = g.float(), w.float()
            tol = 3e-2 * w.abs() + 2e-2 * float(w.abs().max()) + 1e-6
            require(bool(((g - w).abs() <= tol).all()),
                    f"flash backward D={d}: disagrees with its plain version")
            e_bwd = max(e_bwd, float((g - w).abs().max()))
        P, nb = 8 * 16 + 1, 16
        pq = randn((8, 14, d), 1807)
        pool = (randn((P, PAGE, 2, d), 1808), randn((P, PAGE, 2, d), 1809))
        table = (torch.arange(8 * nb, dtype=torch.int32, device="cuda")
                 + 1).reshape(8, nb)
        lens = torch.tensor([1, 127, 128, 129, 500, 700, 900, nb * PAGE],
                            dtype=torch.int32, device="cuda")
        e_paged = max_err(paged_mod.paged_decode_attention(pq, *pool, table,
                                                           lens),
                          ref.paged_decode_attention(pq, *pool, table, lens),
                          f"paged D={d}")
        ms = dict(
            flash_prefill=cuda_ms([lambda: ops.attention(q, k, v, **kw)],
                                  iters=40),
            flash_fp32=cuda_ms([lambda: ops.attention(qf, kf, vf, **kw)],
                               iters=10),
            flash_backward=cuda_ms([lambda: fa_mod.attention_backward(
                qt, kt, vt, o_t, dout, lse_t, causal=True)], iters=20),
            paged=cuda_ms([lambda: paged_mod.paged_decode_attention(
                pq, *pool, table, lens)], iters=40))
        out[d] = dict(max_abs_err=dict(flash=e_fwd, flash_fp32=e_f32,
                                       flash_backward=e_bwd, paged=e_paged),
                      ms=ms)
    print("head dims " + json.dumps(out), flush=True)
    return out


def mesh_one_rank(cfg):
    """Phase 17's yardstick: the one-rank engines on the same weights and
    requests, their tokens, decode records and tok/s."""
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    for kind in MESH_ENGINES:
        mesh_warm(kind, model, params, cfg)
    out = {}
    for kind in MESH_ENGINES:
        toks, dt, rec, nbytes, _ = mesh_serve_run(kind, model, params, cfg)
        out[kind] = dict(tokens=toks, seconds=dt, rec=rec, cache_bytes=nbytes)
    del model, params
    torch.cuda.empty_cache()
    return out


def mesh_logits_check(one, mesh_logits, mesh_fed, what):
    """The mesh engine's decode logits against the one-rank engine's,
    per slot over the steps whose fed tokens and positions agree so far
    (greedy streams may part at a near-tie): (largest |diff| over the
    largest one-rank logit, compared (slot, step) pairs).  A slot parked
    at position 0 (idle, or mid-prefill on the continuous engine) decodes
    garbage on the NULL page, which the mesh's ranks do not hold: it is
    left out."""
    one_logits, one_fed = one["rec"]["logits"], one["rec"]["fed"]
    n_steps = min(len(one_logits), len(mesh_logits))
    worst, scale, pairs = 0.0, 0.0, 0
    for b in range(MESH_SLOTS):
        for s in range(n_steps):
            same = all(one_fed[j][0][b] == mesh_fed[j][0][b]
                       and one_fed[j][1][b] == mesh_fed[j][1][b]
                       for j in range(s + 1))
            if not same:
                break
            if one_fed[s][1][b] == 0:
                continue
            worst = max(worst, float((mesh_logits[s][b]
                                      - one_logits[s][b]).abs().max()))
            scale = max(scale, float(one_logits[s][b].abs().max()))
            pairs += 1
    require(pairs > 0, f"{what}: no decode step fed alike to compare")
    frac = worst / max(scale, 1e-30)
    require(frac <= MESH_LOGIT_TOL,
            f"{what}: logits part by {frac:.4f} of the largest one-rank "
            f"logit (limit {MESH_LOGIT_TOL})")
    return frac, pairs


def mesh_serve_phase():
    """Phase 17: qwen2-0.5b (24 layers, full width) served on (1,4) and
    (2,2) by four gloo ranks on the card, both engines; the shard-mode
    kernel and the combine at their shapes; the attention kernels at the
    non-power-of-two head dims.  Returns (the two kernel rows, the head
    dims' readings, the summary, the launches by path)."""
    import torch.multiprocessing as mp
    cfg = get_config(ARCH)
    require(cfg.n_layers == 24, f"{ARCH}: {cfg.n_layers} layers")
    t = {}
    t0 = time.perf_counter()
    rows = check_mesh_decode_kernels(cfg)
    heads = check_head_dims()
    t["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = mesh_one_rank(cfg)
    t["one_rank"] = time.perf_counter() - t0
    MESH_SERVE_DIR.mkdir(parents=True, exist_ok=True)
    init = f"file://{MESH_SERVE_DIR / 'rendezvous'}"
    (MESH_SERVE_DIR / "rendezvous").unlink(missing_ok=True)
    results = [MESH_SERVE_DIR / f"rank{r}.json" for r in range(MESH_RANKS)]
    for f in results:
        f.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mp.spawn(mesh_serve_rank, args=(init, str(MESH_SERVE_DIR)),
             nprocs=MESH_RANKS, join=True)
    t["ranks"] = time.perf_counter() - t0
    ranks = [json.loads(f.read_text()) for f in results]
    logits = torch.load(MESH_SERVE_DIR / "logits_mesh.pt")
    shutil.rmtree(MESH_SERVE_DIR)
    summary, paths = {}, {}
    L = cfg.n_layers
    for key in ranks[0]:
        tag, kind = key.split("/")
        runs = [r[key] for r in ranks]
        what = f"{ARCH} on ({tag.replace('x', ',')}) {kind}"
        require(all(r["tokens"] == runs[0]["tokens"] for r in runs),
                f"{what}: the ranks' tokens differ")
        require(all(r["logits_hash"] == runs[0]["logits_hash"]
                    for r in runs), f"{what}: the ranks' logits differ")
        ref_toks = one[kind]["tokens"]
        frac, pairs = mesh_logits_check(one[kind], logits[key],
                                        runs[0]["fed"], what)
        same_tokens = sum(runs[0]["tokens"][k] == v
                          for k, v in ref_toks.items())
        for r in runs:
            for part in ("decode", "prefill"):
                got = r[f"{part}_wire"]
                require(got == r["wire_estimate"][part],
                        f"{what} rank {r['rank']}: {part} bytes {got} "
                        f"against the layouts' {r['wire_estimate'][part]}")
        steps = runs[0]["steps"]
        n_tok = sum(len(v) for v in runs[0]["tokens"].values())
        launches = {k: sum(r["launches"][k] for r in runs)
                    for k in runs[0]["launches"]}
        require(launches["paged_decode_partials"] == MESH_RANKS * L * steps
                and launches["paged_decode_combine"]
                == MESH_RANKS * L * steps
                and launches["paged_decode_attention"] == 0
                and launches["matmul"] > 0 and launches["attention"] > 0,
                f"{what}: launches {launches} ({steps} decode steps)")
        if kind == "dense":
            require(all(r["cache_bytes"] * MESH_RANKS == MESH_KV_BYTES
                        for r in runs),
                    f"{what}: cache bytes {[r['cache_bytes'] for r in runs]}"
                    f" against {MESH_KV_BYTES} over {MESH_RANKS}")
        else:
            pages = runs[0]["pool_pages"]
            page_bytes = 2 * L * PAGE * cfg.n_kv_heads * cfg.d_head * 2
            require(all(r["cache_bytes"] == -(-pages // MESH_RANKS)
                        * page_bytes for r in runs),
                    f"{what}: pool bytes {[r['cache_bytes'] for r in runs]}")
        walls = sorted(w for r in runs for w in r["step_walls_ms"][1:])
        idle = profiled_idle(runs)
        summary[key] = dict(
            tok_per_s=n_tok / runs[0]["seconds"],
            one_rank_tok_per_s=sum(len(v) for v in ref_toks.values())
            / one[kind]["seconds"],
            decode_steps=steps, decode_step_wall_ms_median=walls[
                len(walls) // 2], decode_step_wall_ms_range=[walls[0],
                                                             walls[-1]],
            device_idle_share=idle["card"]["device_idle_share"],
            idle=idle, logits_max_frac=frac, logits_pairs=pairs,
            requests_same_tokens_as_one_rank=same_tokens,
            cache_bytes_per_rank=runs[0]["cache_bytes"],
            one_rank_cache_bytes=one[kind]["cache_bytes"],
            decode_wire=runs[0]["decode_wire"],
            prefill_wire=runs[0]["prefill_wire"],
            run_wire=runs[0]["run_wire"], launches=launches)
        paths[f"{what} (mesh, {MESH_RANKS} ranks)"] = launches
        print(f"mesh serve {what}: " + json.dumps(
            {k: v for k, v in summary[key].items() if k != "idle"}),
            flush=True)
    print(f"phase 17 seconds by part: {json.dumps(t)}", flush=True)
    return rows, heads, summary, paths


# phases that also run alone, ``python3 chip_smoke.py 4c 4d``: after the
# device facts and the build, each with the same checks and lines, then
# its seconds; no kernels line and no ok line
ALONE = {"d256": lambda: print(json.dumps(
             check_flash_d256(get_config(GEMMA2B)))),
         "4c": serve_gemma3, "4d": serve_gemma2b, "6b": train_gemma2b,
         "6": lambda: train_phase(get_config(ARCH)),
         "6c": lambda: (check_ssd_backward(), train_mamba2()),
         "9": linalg_phase, "10": hybrid_phase, "11": sched_phase,
         "12": session_phase, "13": pipe_phase, "14": moe_phase,
         "15": families_phase, "16": robust_phase, "17": mesh_serve_phase}


def main() -> int:
    only = sys.argv[1:]
    if any(p not in ALONE for p in only):
        print(f"chip_smoke: phases to run alone: {list(ALONE)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device facts
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"device: {name} (count {count}); nvidia-smi: {smi}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for phase in only:
        t0 = time.perf_counter()
        ALONE[phase]()
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    if only:
        return 0

    # 3. kernels against their plain versions, times and bounds
    t3 = time.perf_counter()
    cfg = get_config(ARCH)
    rows = [check_gemm(cfg), check_flash(cfg), check_paged(cfg), check_ssd()]
    rows[0]["properties_checked"] = check_gemm_properties(
        cfg, get_config(MAMBA))
    rows[1]["properties_checked"] = check_flash_properties(cfg)
    rows += check_flash_d256(get_config(GEMMA2B))
    print(f"phase 3: {time.perf_counter() - t3:.1f} s", flush=True)

    # 4. qwen2-0.5b at full width, cut to SERVE_LAYERS (4 and 4b)
    t4 = time.perf_counter()
    scfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS)
    model = Model(scfg, device="cuda")
    params = model.init(SEED)
    n_params = sum(p.numel() for p in params.values())
    serve(ContinuousEngine, model, params, requests(scfg, 2)[:2])  # warm-up
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fin, dt, steps = serve(ContinuousEngine, model, params, requests(scfg))
    launches = ops.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    expect, chunks = continuous_serve_launches(scfg, steps, fin)
    print(f"launches: {launches} (expected {expect}: {steps} decode steps, "
          f"{chunks} prefill chunks)")
    require(all(launches[k] > 0 for k in
                ("matmul", "attention", "paged_decode_attention")),
            "a kernel of the serve path was never launched")
    require(launches == expect, "launch counts do not match the layer loop")
    serve_stats_q = serve_stats(ARCH, n_params, fin, dt, launches, peak,
                                resident)
    serve_stats_q.update(decode_steps=steps, prefill_chunks=chunks,
                         **step_breakdown(scfg, model, params))
    rows[2]["decode_step_ms"] = serve_stats_q["decode_step_profiled_ms"][
        "paged_decode_attention_busy"]
    print("serve " + json.dumps(serve_stats_q), flush=True)

    static, _, _ = serve(Engine, model, params, requests(scfg), paged=True)
    cont = {r.rid: r.out for r in fin}
    same = cont == {r.rid: r.out for r in static}
    print(f"static paged == continuous greedy tokens: {same}")
    require(same, "static paged and continuous engines disagree")
    check_against_cpu(scfg, model, params)
    print(f"phase 4: {time.perf_counter() - t4:.1f} s", flush=True)

    # 4b. qwen2-0.5b on the dense KV cache, the static engine's default
    t4b = time.perf_counter()
    _, dense_launches = serve_dense(scfg, model, params, static)
    print(f"phase 4b: {time.perf_counter() - t4b:.1f} s", flush=True)
    del model, params
    torch.cuda.empty_cache()

    # 4c. gemma3-27b at full width and depth on its windowed dense cache
    t4c = time.perf_counter()
    g3_stats, g3_launches = serve_gemma3()
    print(f"phase 4c: {time.perf_counter() - t4c:.1f} s", flush=True)

    # 4d. gemma-2b at full width and depth (head dim 256)
    t4d = time.perf_counter()
    g2b_stats, g2b_launches = serve_gemma2b()
    print(f"phase 4d: {time.perf_counter() - t4d:.1f} s", flush=True)

    # 5. mamba2-780m at full width
    t5 = time.perf_counter()
    mamba_stats, mamba_launches = serve_mamba()
    rows[3]["prefill_ms"] = mamba_stats["prefill_profiled_ms"]["ssd_busy"]
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"],
                                 mamba_stats["gemm_max_abs_err"])
    print(f"phase 5: {time.perf_counter() - t5:.1f} s", flush=True)

    # 6. train qwen2-0.5b at full width, two ranks on the card
    t6 = time.perf_counter()
    rows += [check_quantize(), check_attention_backward(cfg)]
    gemm_train = check_gemm_backward(cfg)
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"],
                                 gemm_train.pop("max_abs_err"))
    rows[0].update(gemm_train)
    for key in ("with_lse_ms", "bound_ms", "bound_by", "library_ms"):
        rows[1]["train_forward_" + key] = rows[-1].pop("forward_" + key)
    _, train_launches = train_phase(cfg)
    torch.cuda.empty_cache()
    print(f"phase 6: {time.perf_counter() - t6:.1f} s", flush=True)

    # 6b. gemma-2b trained on one rank at full width and depth
    t6b = time.perf_counter()
    _, g2b_train_launches = train_gemma2b()
    print(f"phase 6b: {time.perf_counter() - t6b:.1f} s", flush=True)

    # 6c. mamba2-780m trained on one rank at full width and depth
    t6c = time.perf_counter()
    rows.append(check_ssd_backward())
    _, mamba_train_launches = train_mamba2()
    print(f"phase 6c: {time.perf_counter() - t6c:.1f} s", flush=True)

    # 7. compressed data-parallel SGD at full width, two ranks on the card
    t7 = time.perf_counter()
    rows += [check_quantize_compress(cfg), check_matmul_dequant(cfg)]
    torch.cuda.empty_cache()
    _, dp_launches = dp_phase(cfg)
    torch.cuda.empty_cache()
    print(f"phase 7: {time.perf_counter() - t7:.1f} s", flush=True)

    # 8. the serve and train CLIs, checkpoint and resume
    t8 = time.perf_counter()
    cli_phase(cfg)
    print(f"phase 8: {time.perf_counter() - t8:.1f} s", flush=True)

    # 9. dMath's distributed linear algebra, four ranks on the card
    t9 = time.perf_counter()
    _, linalg_launches = linalg_phase()
    print(f"phase 9: {time.perf_counter() - t9:.1f} s", flush=True)

    # 10. hybrid data x tensor/sequence parallel training, four ranks
    t10 = time.perf_counter()
    hybrid, hybrid_launches = hybrid_phase()
    print(f"phase 10: {time.perf_counter() - t10:.1f} s", flush=True)

    # 11. the all-reduce schedules, the link fit and the memory verdict
    t11 = time.perf_counter()
    _, sched_launches = sched_phase(hybrid)
    print(f"phase 11: {time.perf_counter() - t11:.1f} s", flush=True)

    # 12. the whole Session: serve, restart, refusal, autotune, dry runs
    t12 = time.perf_counter()
    _, session_launches = session_phase()
    print(f"phase 12: {time.perf_counter() - t12:.1f} s", flush=True)

    # 13. the pipeline: GPipe and 1F1B on (1, 4) and (2, 2), four ranks
    t13 = time.perf_counter()
    pipe, pipe_launches = pipe_phase()
    print(f"phase 13: {time.perf_counter() - t13:.1f} s", flush=True)

    # 14. the moe family: the batched GEMM, deepseek-moe-16b served and
    # trained
    t14 = time.perf_counter()
    moe_row, moe_served, _, moe_paths = moe_phase()
    rows.append(moe_row)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)

    # 15. the Model's last three families: zamba2, musicgen, internvl2
    t15 = time.perf_counter()
    zk, families, family_paths = families_phase()
    print(f"phase 15: {time.perf_counter() - t15:.1f} s", flush=True)

    # 16. AlexNet at full width and the robustness layer
    t16 = time.perf_counter()
    _, robust_paths = robust_phase()
    print(f"phase 16: {time.perf_counter() - t16:.1f} s", flush=True)

    # 17. serving on a mesh: qwen2-0.5b at full width and depth on (1, 4)
    # and (2, 2), four ranks; the attention kernels at the other head dims
    t17 = time.perf_counter()
    mesh_rows, head_dims, _, mesh_paths = mesh_serve_phase()
    rows += mesh_rows
    rows[1]["head_dims"] = {d: dict(ms=v["ms"]["flash_prefill"],
                                    fp32_ms=v["ms"]["flash_fp32"])
                            for d, v in head_dims.items()}
    rows[2]["head_dims"] = {d: v["ms"]["paged"]
                            for d, v in head_dims.items()}
    print(f"phase 17: {time.perf_counter() - t17:.1f} s", flush=True)

    # results
    ssd_bwd = next(r for r in rows if r["name"] == "ssd_backward")
    attn_bwd = next(r for r in rows if r["name"] == "attention_backward")
    rows[3]["zamba2"] = {k: {kk: vv for kk, vv in v.items()
                             if kk != "backward"}
                         for k, v in zk.items() if k.startswith("ssd")}
    ssd_bwd["zamba2"] = {k: v["backward"] for k, v in zk.items()
                         if "backward" in v}
    rows[1]["zamba2"], attn_bwd["zamba2"] = zk["flash"], zk[
        "attention_backward"]
    rows[2]["zamba2"] = zk["paged"]
    ze = families["zamba_serve"]["kernel_calls_max_abs_err"]
    for row, err in ((rows[0], ze["matmul"]), (rows[1], ze["attention"]),
                     (rows[2], ze["paged"]), (rows[3], ze["ssd"]),
                     (rows[1], zk["flash"]["max_abs_err"]),
                     (attn_bwd, zk["attention_backward"]["max_abs_err"]),
                     (rows[2], zk["paged"]["max_abs_err"])):
        row["max_abs_err"] = max(row["max_abs_err"], err)
    for k, v in zk.items():
        if k.startswith("ssd"):
            rows[3]["max_abs_err"] = max(rows[3]["max_abs_err"],
                                         v["max_abs_err"])
            if "backward" in v:
                ssd_bwd["max_err_over_largest"] = max(
                    ssd_bwd["max_err_over_largest"],
                    v["backward"]["max_err_over_largest"])

    # results; 4c's and 4d's kernel calls held at their own shapes
    g3e = g3_stats["kernel_calls_max_abs_err"]
    g2e = g2b_stats["kernel_calls_max_abs_err"]
    moe_e = moe_served["kernel_calls_max_abs_err"]
    for row, err in ((rows[0], g3e["matmul"]), (rows[0], g2e["matmul"]),
                     (rows[1], g3e["attention"]),
                     (rows[4], g2e["attention"]),
                     (rows[2], max(g3e["paged"], g3e["ring"])),
                     (rows[2], g2e["paged"]), (rows[0], moe_e["matmul"]),
                     (rows[1], moe_e["attention"]),
                     (rows[2], moe_e["paged"]),
                     (moe_row, moe_e["matmul"])):
        row["max_abs_err"] = max(row["max_abs_err"], err)
    for mesh_row in hybrid["meshes"].values():
        errs = mesh_row["max_abs_err"]
        rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"],
                                     errs["gemm_max_abs_err"],
                                     errs["gemm_backward_max_abs_err"])
        rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"],
                                     errs["flash_max_abs_err"])
        bwd = next(r for r in rows if r["name"] == "attention_backward")
        bwd["max_abs_err"] = max(bwd["max_abs_err"],
                                 errs["flash_backward_max_abs_err"])
    for cell in pipe["cells"].values():
        errs = cell["max_abs_err"]
        rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"],
                                     errs["gemm_max_abs_err"],
                                     errs["gemm_backward_max_abs_err"])
        rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"],
                                     errs["flash_max_abs_err"])
        bwd = next(r for r in rows if r["name"] == "attention_backward")
        bwd["max_abs_err"] = max(bwd["max_abs_err"],
                                 errs["flash_backward_max_abs_err"])
        rows[3]["max_abs_err"] = max(rows[3]["max_abs_err"],
                                     errs["ssd_max_abs_err"])
        ssd_bwd = next(r for r in rows if r["name"] == "ssd_backward")
        ssd_bwd["max_err_over_largest"] = max(
            ssd_bwd["max_err_over_largest"], errs["ssd_backward_max_rel_err"])
    errs = hybrid["mamba2"]["max_abs_err"]
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"],
                                 errs["gemm_max_abs_err"],
                                 errs["gemm_backward_max_abs_err"])
    rows[3]["max_abs_err"] = max(rows[3]["max_abs_err"],
                                 errs["ssd_max_abs_err"])
    ssd_bwd = next(r for r in rows if r["name"] == "ssd_backward")
    ssd_bwd["max_err_over_largest"] = max(ssd_bwd["max_err_over_largest"],
                                          errs["ssd_backward_max_rel_err"])
    for d, v in head_dims.items():
        e = v["max_abs_err"]
        rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], e["flash"],
                                     e["flash_fp32"])
        rows[2]["max_abs_err"] = max(rows[2]["max_abs_err"], e["paged"])
        attn_bwd["max_abs_err"] = max(attn_bwd["max_abs_err"],
                                      e["flash_backward"])
        attn_bwd.setdefault("head_dims", {})[d] = v["ms"]["flash_backward"]
    names = {"gemm": "matmul", "flash_attention": "attention",
             "flash_attention_d256": "attention",
             "paged_decode_attention": "paged_decode_attention",
             "ssd": "ssd", "ssd_backward": "ssd_backward",
             "quantize_int8": "quantize_int8",
             "attention_backward": "attention_backward",
             "attention_backward_d256": "attention_backward",
             "quantize_compress": "quantize_compress",
             "matmul_dequant": "matmul_dequant",
             "gemm_batched": "matmul_batched",
             "paged_decode_partials": "paged_decode_partials",
             "paged_decode_combine": "paged_decode_combine"}
    train_path = (f"{ARCH} train ({RANKS} ranks, int8 wire, {WIRE_STEPS} "
                  "steps)")
    paths = {ARCH: launches, f"{ARCH} dense cache": dense_launches,
             f"{GEMMA3} dense cache": g3_launches, MAMBA: mamba_launches,
             train_path: train_launches,
             MAMBA_TRAIN_PATH: mamba_train_launches, DP_PATH: dp_launches,
             LINALG_PATH: linalg_launches, HYBRID_PATH: hybrid_launches,
             SCHED_PATH: sched_launches, PIPE_PATH: pipe_launches,
             **session_launches, **moe_paths, **family_paths,
             **robust_paths, **mesh_paths}
    # gemma-2b's attention is the head-dim-256 rows' alone
    d256 = {f"{GEMMA2B} dense cache": g2b_launches,
            f"{GEMMA2B} train (1 rank, 3 steps)": g2b_train_launches}
    for row in rows:
        op = names[row["name"]]
        use = (d256 if row["name"].endswith("_d256") else moe_paths
               if op == "matmul_batched" else paths
               if op.startswith("attention") else {**paths, **d256})
        row["launches_by_path"] = {k: v.get(op, 0)
                                   for k, v in use.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
