"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device  — torch/CUDA versions, the card's name and power limit;
2. build   — nvcc builds every kernel from the sources in this checkout
             (``ops/csrc/*.cu``), one nvcc per source, all started together,
             and prints ptxas's registers and spills of the tensor-core
             flash kernels (16-bit and f32) and the paged kernels;
3. kernels — each kernel against its plain PyTorch version on the card, on
             seeded inputs, with the stated tolerances: the paged decode
             kernel (split-key flash-decoding) at the split count it picks
             and at forced counts 1, 2, 4 and one table entry per split,
             a draft_k = 4 verify (l_q = 5) at the serving shape on bf16
             and on int8 pools among its cases;
             the flash-attention kernels of every route — f32 cases on the
             SIMT kernels (forward, dQ, dK/dV), their bf16 twins on the
             tensor-core kernels (``tc``), float16 cases on both routes
             (dO scaled by the fp16 loss scale 2^15 among them, once with
             V scaled so that dS passes float16's range), the f32
             forward, dQ and dK/dV on the 3xTF32 tensor-core kernels
             (``tc32``: the slice, ragged L = 1000, a key mask, cross
             lengths 96 x 160 and, causal, 96 x 160 and 160 x 96, head
             dims 16 and 128, a row with no valid key, and BERT's shape
             in phase 5c's mask check; out and lse at the f32 tolerance,
             the gradients at the f32 gradient tolerance, bitwise equal
             when run again, and their largest difference from the SIMT
             kernels' printed) — and the block primitives (a two-block
             split, and causal diagonal blocks with Lq != Lk);
4. serve   — the GPT server at the full width of the repo's serve bench
             (vocab 16384, hidden 512, 8 layers, 8 heads, ffn 2048, max_len
             144, bf16, 8 slots), random weights from a seed, answering
             ``bench.py --serve``'s default trace (32 requests, a shared
             16-token prefix, prefill chunk 16, a 128-block prefix pool of
             8-token blocks) through ``SlotKVCache`` and
             ``ContinuousBatcher.run`` in three windows: M, the monolithic
             table (no paged launch); P, the paged table with the
             zero-copy pool (one kernel launch per layer per decode
             iteration, copy-on-write); Q, window P with int8 pools (every
             launch on the kernel's int8 route).  Then three windows of
             the decode paths beside them: S-self, window M with a draft
             that is the served model (draft_k 4; the accept rate; its
             streams must be bitwise M's: the verify runs its GEMMs and
             attention reads one query column at a time, at a decode
             step's shapes); S-small, window P with a 1-layer draft of its
             own seed (draft_k 4, multi_step 4: the draft's proposals are
             fused rounds; accepted + rejected == proposed, every paged
             launch at l_q = 1; its streams must be bitwise P's); K,
             window P at multi_step 8, every round in the timed window a
             CUDA graph replay, whose streams must equal P's bitwise
             (dispatches, host gap and tokens/s against P).  A seeded
             0.8-temperature check holds three rounds of 4 (eager,
             captured, replayed) to 12 single steps.  Then first-decode-step
             logits of the paged fused read against the gather read and
             against the monolithic table, of a warm prefix pool against a
             cold one, the cursor mode (``generate``) against the
             monolithic prefill and ``generate``'s greedy streams against
             the table's; chunked prefill at chunks 16 and 8, warm pool
             against cold and cursor against the table, bitwise; a
             seeded 0.8-temperature window run twice, and
             where a decode step's device time goes (``torch.profiler``):
             paged, a replayed round of 8 (window K's table), paged on
             int8 pools, monolithic;
4b. cnn    — the reference's own training path through ``cli.main``, as a
             user runs it: ``-m c -cs sync -n 1 -b 32 --model cnn --dataset
             mnist`` (BASELINE config 1 at full width: synthetic MNIST,
             8192/2048 rows, 256 steps at steps_per_call 8, prefetch 2)
             over a 1-rank NCCL process group, to test accuracy >= 0.97
             with one NCCL all-reduce per step and the chunks replayed as
             CUDA graphs (1 capture, 31 replays); the same window under
             ``--precision bf16-f32master``; steps-to-97% of the same
             config (``steps_to_accuracy``); ``-m d -ds keras`` with the
             MLP at steps_per_call 1 and 8, whose heartbeat loss lines
             must be identical; later, with the other profiles, where a
             CNN step's device time goes.  The card has one GPU, so
             scaling n=1→8 is not measured here;
4c. local  — BASELINE configs 3 and 4 through ``cli.main`` on a 1-rank
             NCCL group: ``-m c -cs async -n 1 -b 32 --model resnet20
             --dataset cifar10`` (ResNet-20 at its published widths on
             synthetic CIFAR-10, 8192/2048 rows, 256 steps, sync_every 10,
             steps_per_call 8, prefetch 2) to at least the CPU
             rehearsal's test accuracy less 0.05, with exactly steps + 2
             NCCL all-reduces (one per step, ``eval_params``, the eval
             totals); ``-m d -ds custom -d 1`` and ``-ds graph`` with the
             MLP on Fashion-MNIST (gossip; on one rank the mix is the
             full-mean all-reduce), whose heartbeats must be identical;
             ResNet-20's logits and one step's gradients on the card
             against the CPU; later, with the other profiles, where a
             ResNet-20 async step's device time goes;
5. train   — the GPT of ``bench.py --lm`` (vocab 16384, hidden 512, 8
             layers, 8 heads, ffn 2048, sequence 1024, bf16, dropout 0,
             flash attention), random weights from a seed, trained for two
             epochs of 64 seeded rows at batch 8 (16 steps) by
             ``Trainer(model, engine=SyncEngine(model)).fit`` at one step
             per call (each heartbeat timestamps its step) and evaluated
             by ``Trainer.evaluate``; the launch counts show every
             attention forward and backward went through the kernels of
             the ``tc`` route, and one step is held against a
             dense-attention twin; then where a train step's device time
             goes;
5b. precision — the same GPT under ``bf16-f32master`` through
             ``Trainer.fit`` at 8 steps per call (epoch 1 eager, epoch 2 a
             captured and replayed graph; params == cast(master) after),
             evaluated; then 4 steps under ``fp16-f32master``, every
             flash launch on the float16 ``tc`` kernels;
5c. bert   — BASELINE config 5 through ``cli.main``: ``-m c -cs sync -n 1
             -b 32 --model bert_tiny --dataset glue_synth --attention
             flash`` (BERT-tiny at its published widths: 2 layers, hidden
             128, 2 heads of 64, FFN 512; synthetic GLUE, 4096/1024 rows
             of 128 tokens; 128 steps at steps_per_call 8) over a 1-rank
             NCCL group, at f32 (every forward, dQ and dK/dV on
             ``tc32``) and under ``--precision
             bf16-f32master`` (every launch on ``tc``): test accuracy at
             least the CPU rehearsal's less
             0.05; flash launches of layers × (steps + eval batches)
             forwards and layers × steps dQ and dK/dV; one all-reduce per
             step (two under the master policy) and the evaluation's; 1
             capture and 15 replays.  With the kernel checks before it:
             BERT flash against dense with the same weights on a padded
             32 × 128 batch with an all-padding row, at f32 and bf16, and
             the flash kernels at BERT's shape under that batch's key mask
             against their plain versions on every route (the
             all-padding row the mean of V over its 128 keys);
5d. repeat — one seed gives one run: configs 1 (the CNN window), 3 and 5
             (f32) through ``cli.main`` twice each, their per-step losses,
             final parameters (one flat f32 buffer) and test accuracy and
             loss bitwise equal; then configs 1 and 3 (the ones with
             convolutions) once with cuDNN at torch's defaults, for the
             examples/s that its deterministic algorithms cost (a failure
             is raised after the timings);
5e. train-f32 — the GPT of phase 5 at ``dtype float32`` (the JAX
             package's default), 4 steps through ``Trainer.fit`` at one
             step per call: every flash forward, dQ and dK/dV on ``tc32``
             at the slice's shape (8 of each a step); one step against a
             dense-attention twin at the f32 tolerance; where an f32 step's
             device time goes (the flash forward's share among it);
5f. cli-lm — the GPT at ``bench.py --lm``'s widths (hidden 512, 8 layers,
             8 heads, ffn 2048, max_len 512) on ``lm_synth`` (vocabulary
             128, L = 128; 512 steps at -b 8, seed 0, flash attention),
             trained, greedy-sampled and served through ``cli.main`` as a
             user runs it, each window with every launch count set to 0
             just before it.  L1, f32 (the CLI's default), with the
             optimizer recipe (cosine schedule, 32 warmup steps, weight
             decay 0.1, clip 1.0), ``--sample 32`` and the README's serve
             command on the paged table (32 requests, 8 slots, 32 new
             tokens, prefill chunk 16, a 128-block pool of 8-token blocks,
             a 16-token shared prefix): every flash launch on ``tc32``, as
             many as predicted from the code before the run (8 layers ×
             (512 steps + 11 eval batches) forwards, 8 × 512 dQ and
             dK/dV), 8 paged launches per decode iteration, all on f32
             pools; test loss <= 3.85; the samples bitwise ``generate``'s
             on the trained module and the served streams bitwise a direct
             ``SlotKVCache(paged)`` + ``ContinuousBatcher`` window; the
             serve section with ``serve_goodput_under_slo`` and ``slo``;
             the recipe's ``ScheduledAdamW`` in the engine.  L2, under
             ``bf16-f32master`` with a linear schedule, rope and
             ``--kv-heads 2``, served at ``--serve-multi-step 8``:
             every flash launch on ``tc``, every paged launch on bf16
             pools with 2 kv heads (8 × 8 per round), RoundGraph replays,
             and the streams bitwise a direct ``multi_step=8`` window;
             then its training flags without the serve window on the
             first 192 rows of ``lm_synth`` (24 steps: an eager chunk, a
             captured one, a replay) at steps_per_call 8 and 1: per-step
             losses, the flat f32 master and test loss bitwise equal;
5g. sp    — sequence parallelism on the card, where one GPU makes a (1, 1)
             (data, seq) NCCL mesh: the ``bench.py --lm`` GPT (hidden 512,
             8 layers, 8 heads, ffn 2048, vocab 16384, B = 8, L = 1024)
             under ``SeqParallelEngine`` for 4 eager steps each,
             ``ring_flash`` at f32 and under ``bf16-f32master`` and
             ``ulysses_flash`` at f32, against ``SyncEngine`` with the
             flash attention from the same weights, batches and Adam: the
             f32 ring's first loss within 1e-6 relative (its bitwise
             equality printed) and the rest within 1e-4, ``ulysses_flash``
             bitwise the flash GPT, the bf16 ring within the bf16 train
             tolerance; the ring's block kernels launched 8 forwards (tc32
             at f32, tc under bf16), 8 dQ and 8 dK/dV (tc32 in both: the
             block backward casts to f32) a step, no SIMT launch.  Then the
             virtual-rank ring: the ring's own per-block functions for n
             ranks in one process against the whole sequence's block
             kernels, causal at n = 4 (B=2, L=4096: blocks of 1024, H=8,
             D=64, f32 and bf16; 10 forward, dQ and dK/dV launches) and
             under BERT's key mask at n = 2 (B=32, L=128, H=2, f32).  With
             the timings: the block kernels at the SP GPT's block shape
             (rows ``flash_fwd_block.*``/``flash_bwd_block.*``), the bf16
             block backward's price of its f32 casts against the tc dQ and
             dK/dV, the eager steps, and the virtual cases' device ms
             beside the whole sequence's;
5h. moe   — the ``bench.py --moe`` GPT (``bench_moe``): the ``bench.py
             --lm`` GPT (B = 8, L = 1024, vocab 16384, hidden 512, 8
             layers, 8 heads, ffn 2048, bf16, flash, dropout 0) with every
             FFN swapped for 8 routed experts (top-1, capacity factor
             1.25: 8 groups of 1024 tokens, 160 slots, printed and gated),
             and its dense twin, under ``SyncEngine`` on a 1-rank NCCL
             mesh through bench_moe's protocol on the graph path: chunks
             of 3 and 13 steps replayed as CUDA graphs, the step time
             (t13 - t3) / 10, 3 repeats, median and spread; it prints
             ``dense_tokens_per_sec_per_chip``,
             ``moe_tokens_per_sec_per_chip``, their spreads and
             ``moe_vs_dense`` beside the card's name and power limit.
             Gates: losses finite and falling over the first 16 steps; the
             replayed chunk's losses bitwise a twin's eager chunk from the
             seed; overflow in [0, 1]; 8 flash forwards, dQ and dK/dV a
             step, all on ``tc``; block 0's MoE layer on its full-width
             input (8192 × 512, bf16) on the card against the CPU:
             dispatch and overflow equal (a router tie is the one
             difference allowed, printed), outputs within
             ``MOE_LAYER_TOL``.  Printed: each step's device time split
             into attention, expert GEMMs, dispatch/combine GEMMs, the
             router's GEMM and the rest, beside the dense step's.  Then
             ``ExpertParallelEngine`` on a (1, 1) NCCL mesh: the
             MoEClassifier (8 experts, synthetic data), top-1 and top-2,
             32 steps: the task loss falls, ``total_loss - loss`` is the
             weighted router terms within 1e-6, overflow in [0, 1], and
             the first task loss is ``SyncEngine``'s within 1e-5;
5i. ckpt  — checkpoint, resume and failure on the cli-lm GPT (phase 5f's
             widths: hidden 512, 8 layers, 8 heads, ffn 2048, B = 8, L =
             128, ``lm_synth``, 512 steps an epoch, constant LR, flash on
             ``tc32`` at f32 and ``tc`` under ``bf16-f32master``), in a
             temporary directory removed after: C0, ``harness.run`` for 2
             epochs at steps_per_call 8 with no checkpoint, the reference
             trajectory; C1, ``failure.run_with_recovery`` with
             ``--checkpoint-dir``, ``--checkpoint-every 128`` and the
             async writer, whose first run trains one epoch and crashes,
             the restart going through ``elastic_restore``: final
             parameters and test loss bitwise C0's, one restart, no
             replayed step, the resumed fit starting at 512, the flash
             launches those of 512 + 512 steps and both runs' evals; C2,
             ``Trainer.fit`` under ``bf16-f32master`` with a
             ``should_stop`` firing at step 300, drained at boundary 304
             with its final checkpoint, then a fresh engine and Trainer
             restoring it and finishing the epoch: the bf16 parameters and
             the f32 master bitwise an uninterrupted fit; C3, the step-256
             checkpoint of a synchronous-writer run tensor by tensor the
             async run's, and that f32 checkpoint restored into
             ``bf16-f32master`` training 8 steps with finite losses; C4,
             a fit under a 30 s watchdog (beats, no stall) and a 0.2 s
             watchdog around a one-second device wait (one stall episode,
             re-armed after).  Printed beside the card's name and power
             limit: the checkpoint's bytes (parameters, optimizer,
             master), the synchronous save's wall time, checkpoint_wait_s
             against checkpoint_overlapped_s for both writers, and the
             step time with and without checkpoints;
5j. codec — gradient codecs and bucketed overlap on the cli-lm GPT
             (phase 5i's widths and data, ``cli.main`` on a one-rank NCCL
             group, 1 epoch of 512 steps, chunks of 8 replayed as graphs):
             G-base, ``CLI_LM_ARGV`` as it is; G0, + ``--grad-bucket-mb
             4`` (codec none): losses and final parameters bitwise
             G-base's; G1, + ``--grad-compression bf16``; G2, + ``int8``;
             G3, + ``int8 --grad-bucket-mb 4 --grad-accum 2`` (each
             microbatch's buckets reduced as its backward produces them;
             ``collective_overlap`` a dict with finite ``exposed_s`` and
             ``hidden_s``: at n = 1 this shows the probe runs, not an
             overlap); G4, + ``--precision bf16-f32master --grad-compression
             int8 --grad-bucket-mb 4`` (the ``tc`` route).  Gates: every
             test loss ≤ ``CLI_LM_TEST_LOSS``; 8 flash forwards, dQ and
             dK/dV a microbatch, all ``tc32`` in G-base–G3 and ``tc`` in
             G4 (the probe's steps left out); ``grad_allreduce_bytes`` the
             figure computed from the parameters' shapes (f32: 4 B a
             parameter, bf16 2, int8 1 plus 4 a leaf or a bucket); the
             NCCL all-reduces, all-to-alls and all-gathers per step those
             of the plan.  G2's engine for 24 steps in chunks of 8 (the
             first eager, the second captured, then a replay) against 24
             single eager steps: heartbeats, parameters and the codec
             generator's state bitwise (the generator is registered with
             the graph).  ``AsyncLocalEngine`` (sync every 8) and
             ``GossipEngine`` (degree 1: at n = 1 the all-reduce branch)
             under int8 for two chunks each: finite losses, the plan's
             collectives.  Printed beside the card's name and power limit:
             each run's wire bytes, step p50 and test loss, the probe's
             splits, a replayed int8 chunk's device time split into the
             codec's own kernels (timed alone on the same gradients), NCCL
             kernels and the rest, and the phase's wall time;
5k. mp    — FSDP and tensor parallelism on one NCCL rank.  F1, window
             L1's argv (the cli-lm GPT, f32, flash, the optimizer recipe
             with ``--clip-norm``, ``--sample``, paged ``--serve``) with
             ``-m d -ds fsdp``: at n = 1 every shard is the whole leaf, so
             its test loss, samples and served streams are held bitwise
             to L1's from this run; 8 flash forwards, dQ and dK/dV a step
             on ``tc32`` (rows 1c–3c), one all-gather and one
             reduce-scatter a step for every leaf on NCCL, one all-reduce
             a step (the metrics) and the evaluation's; its
             ``state_bytes_per_device`` printed.  F2, F1 under
             ``--precision bf16-f32master``: finite, the test loss within
             ``MP_BF16_LOSS_ATOL`` of F1's, every flash launch on ``tc``
             (rows 1d–3d), the f32 master's bytes per device printed.  T,
             ``TensorParallelEngine`` on a (1, 1) (data, model) mesh over
             the ``bench.py --lm`` GPT (L = 1024, bf16, flash) with
             ``partition_model=True`` for 4 eager steps: losses bitwise
             ``SyncEngine``'s flash GPT from the same weights, batches and
             Adam; 8 ``tc`` forwards, dQ and dK/dV a step (rows 1–3);
             2 × 8 + 1 model-axis all-reduces a step forward and as many
             backward, one logit all-gather, one data-axis all-reduce.
             Printed on ``[mp]`` lines: each window's step p50 and busy
             share beside G-base's and the Train window's;
5l. pp    — pipeline parallelism on one NCCL rank: ``PipelineEngine`` on
             a (1, 1) (data, pipe) mesh over ``gpt_pipeline_stages`` at
             ``bench.py --lm``'s widths (8 flash layers in the one stage,
             bf16 compute over f32 parameters), M = 4 microbatches of
             2 × 1024 of ``_lm_data``, Adam, 4 eager steps from one init
             in each window: PG (GPipe), P1 (1F1B), PR (GPipe with
             remat); each first-step loss within ``PP_LOSS_RTOL`` of the
             sequential forward's cross-entropy over the whole batch, P1's
             and PR's losses and parameters bitwise PG's; flash launches a
             step on ``tc`` 32/32/32 (PG) and 64/32/32 (P1, PR: the
             recompute); the pipe shifts a step (copies at a pipe of one,
             no point-to-point op) and two NCCL all-reduces a step as
             planned (``PP_SHIFTS``).  Pgen: ``generate`` from PG's state
             (32-token prompts of the data, 32 new tokens) against the
             naive rollout (a first difference must be a tie, within
             ``PP_TIE``).  Printed on ``[pp]`` lines: each window's step
             p50, busy share, ``max_memory_allocated`` (reset per window)
             and flash launches; rows 1p-3p (the flash kernels at the
             microbatch's shape, B=2, L=1024, H=8, D=64, causal, bf16,
             ``tc``) join the kernels line;
5m. composite — the composites without the pipeline on one NCCL rank,
             every axis of size 1.  X1 (tp×sp): the ``bench.py --lm``
             GPT at f32 with ``partition_model=True`` and ``ring_flash``
             under ``CompositeEngine`` on a (1, 1, 1) (data, model, seq)
             mesh, 4 eager steps from phase 5g's init and batches: losses
             bitwise phase 5g's f32 ``ring_flash`` window and parameters
             bitwise its ``SeqParallelEngine`` twin run here; 8 ``tc32``
             forwards, dQ and dK/dV a step (the ring's block kernels, rows
             of phase 5g).  X2 (ep×sp): phase 5h's ``bench.py --moe`` GPT
             with ``ring_flash`` and ``partition_experts=True`` on a (1,
             1, 1) (data, expert, seq) mesh, 4 eager steps: finite, the
             first loss within ``COMP_MOE_RTOL`` of the same MoE GPT's
             with ``flash`` under ``SyncEngine``; 8 ``tc`` forwards and 8
             ``tc32`` dQ and dK/dV a step.  X3 (ep×tp): phase 5h's
             ``ExpertParallelEngine`` MoEClassifier (top-2, z-loss on)
             with ``partition_model=True`` on a (1, 1, 1) (data, expert,
             model) mesh, ``COMP_EP_STEPS`` steps, losses and parameters
             bitwise its (1, 1) twin.  Printed on ``[comp]`` lines beside
             the card's name and power limit: flash launches a step by
             route, NCCL calls a step, the step p50, the busy share and
             the peak memory above the window's entry;
5n. ppc   — the pipeline's dense composites on one NCCL rank, every axis
             of size 1, from phase 5l's init and batches (its GPT stages:
             8 layers, bf16 compute over f32 parameters, M = 4
             microbatches of 2 × 1024, Adam, 4 eager steps a window).
             C1: pp×tp GPipe, the Megatron stages on a (1, 1, 1) (data,
             pipe, model) mesh, losses and parameters bitwise PG's; C2:
             the same under 1F1B, bitwise P1's; C3: pp×sp GPipe,
             ``ring_flash`` stages on a (1, 1, 1) (data, pipe, seq) mesh,
             its first loss within ``PPC_SP_RTOL`` of PG's; C3R: C3 with
             remat, bitwise C3; C4: pp×tp×sp on (1, 1, 1, 1) (data, pipe,
             seq, model), bitwise C3; Cgen: ``generate`` from C1's final
             state, bitwise Pgen's tokens.  Flash launches a step by
             route, the Megatron pair's NCCL calls, gradient all-reduces
             and pipe shifts a step held to ``_ppc_plan``.  Printed on
             ``[ppc]`` lines beside the card's name and power limit: each
             window's step p50 and peak memory above its entry, C1's and
             C4's busy share; rows 1p-3p gain C1's and C2's launches
             (``launches_ppc``), and the ring's block kernels at the
             microbatch's shape (forward ``tc``, backward ``tc32``) join
             the kernels line;
5o. ppe   — the pipeline's MoE composites on one NCCL rank, every axis of
             size 1, from phase 5l's init with phase 5h's MoE FFN added
             (``MOE_GPT``: 8 experts, top-1, capacity factor 1.25, drawn
             on the card from seed 0) and 5l's batches; aux 0.01 and z
             1e-3, 4 eager steps a window.  E0: the MoE stages on a (1, 1)
             (data, pipe) mesh, GPipe, ``flash``, its first loss within
             ``PP_LOSS_RTOL`` of the sequential forward's mean
             cross-entropy over the microbatches (each routed alone, as a
             stage routes its call); E1: pp×ep on (1, 1, 1) (data, pipe,
             expert), bitwise E0 (losses, overflow, parameters); E1R: E1
             with remat, bitwise E1 (the router terms counted once); E2:
             pp×ep×tp on (1, 1, 1, 1) with the 2-D expert layout,
             bitwise E1; E3: pp×ep×sp with ``ring_flash``, its first loss
             within ``PPC_SP_RTOL`` of E1's; E4: pp×ep×tp×sp on (1, 1, 1,
             1, 1), bitwise E3; 1F1B with MoE stages refused in JAX's
             words.  Flash launches a step by route, the expert and
             Megatron NCCL calls, gradient all-reduces and pipe shifts a
             step held to ``_ppe_plan``.  Printed on ``[ppe]`` lines
             beside the card's name and power limit: each window's step
             p50, peak memory above its entry and overflow, E0's and E4's
             busy share;
             rows 1p-3p and 1rp-3rp gain ``launches_ppe``;
5p. tpd   — TP decode on one NCCL rank.  TPL: window L1's flags with
             ``-tp 1`` through ``cli.main`` (a 'model' axis needs -tp > 1
             and a serve mesh more than one rank, as in JAX's harness, so
             this is L1 and reaches no TP table): test loss, samples and
             serve streams bitwise L1's, the serve table without a mesh,
             paged launches layers x decode iterations.  TPM, TPP,
             TPQ: the serve GPT with ``partition_model=True`` bound to a
             (1, 1) (data, model) NCCL mesh through ``SlotKVCache(mesh=
             ...)``, monolithic, paged and paged int8, on the bench trace:
             streams bitwise phase 5's M, P and Q, NCCL calls (2 x layers
             + 1 model-axis all-reduces and one logit all-gather) a
             forward, paged launches layers x decode iterations, rounds
             eager; TPG: ``generate(mesh=...)`` bitwise the unbound
             model's.  Printed on ``[tpd]`` lines beside the card's name
             and power limit: each window's ITL p50 beside its twin's and
             the TP decode step's wall and busy share beside phase 5's;
             the paged kernel at the per-rank K/V heads of tp 2, 4 and 8
             (4, 2, 1; bf16 and int8 pools) joins the kernels line, its
             launches those of TPP and TPQ at that K/V head count
             (``paged_attention.launches_by_kv_heads``; 0 on one card);
5q. lease — the elastic lease and the telemetry on the cli-lm GPT (phase
             5i's C0 config, ``_ckpt_config``: f32, flash on ``tc32``, 2
             epochs of 512 steps at steps_per_call 8, one NCCL rank),
             through ``harness.run``.  Q1: ``--checkpoint-dir`` with
             ``--max-steps-per-lease 300``, drained at boundary 304 with
             ``preempted == "max_steps_per_lease:300"`` and its final
             checkpoint there, then an ``--elastic-restore`` run of the
             directory finishing the fit: the final state and test loss
             bitwise C0's (phase 5i hands over its state).  Q2: the same
             without the budget, a timer thread sending SIGTERM to this
             process once chunk 20 is dispatched: drained with
             ``preempted == "signal:SIGTERM"``, its resume bitwise C0,
             and SIGTERM's disposition back after every window (a guard
             handler of the smoke's own stands behind the lease in Q2, so
             a stray notice fails a gate instead of ending the run).  Q3:
             window L1's argv with ``--metrics-path``, ``--trace`` and
             ``--timeline`` through ``cli.main``: test loss, samples,
             serve streams and launch counts bitwise L1's, one metrics
             record a step, every trace line whole, the span table, the
             tracer's, logger's and timeline's overhead as shares of the
             fit, step p50 beside L1's, the serve section's timeline keys,
             the ``stragglers`` and ``lease`` sections, paged launches 8 x
             decode iterations on f32 pools.  Q4: a 24-step fit under
             ``--profile-dir``: its Chrome trace holds the Trainer's span
             names and the ``tc32`` kernels' names.  Rows 1c-3c and 4f
             gain ``launches_lease``;
5r. health — the health layer, the roofline, the program ledger and the
             analyzer on the cli-lm GPT (f32, flash on ``tc32``, one NCCL
             rank).  R1: window L1's argv with ``--health on --roofline``
             (and ``--metrics-path``) through ``cli.main``: test loss,
             samples, serve streams and launch counts bitwise L1's, one
             metrics record a step with the six health keys finite, the
             ``health`` section with 0 anomalies, ``train_mfu``,
             ``serve_prefill_mfu`` and ``serve_decode_mbu`` each in
             (0, 1.05] against the H100's peaks
             (``observability/roofline.py``), the report's ``xla``
             manifest with the chunk graph's capture seconds, memory and
             FLOPs beside ``torch.cuda.max_memory_allocated()``, the
             port's ``analyze roofline`` and ``analyze health`` exiting 0
             on the run's files, step p50 beside L1's.  R1r: the serve
             GPT's paged table under a ledger records its captured round.
             R2: 24 steps on ``_lm_head_rows`` with health on, replayed
             chunks of 8 against single eager steps: the loss and the six
             health streams bitwise.  R3: ``HealthConfig(inject_nan_at=
             20)``, a step of the first replayed chunk: ``'halt'`` raises
             ``AnomalyDetected`` at step 20 with its record logged,
             ``'warn'`` is fatal under the nan-guard default, ``'warn'``
             with ``nan_guard=False`` completes with the first anomaly at
             20.  Rows 1c-3c and 4f gain ``launches_health``;
6. timings — the main paths' kernels at their shapes beside their bounds,
             the plain versions and a library call: each one's device time
             per launch from ``torch.profiler`` (``ms``; a session that
             sees no device time is run again, and then CUDA events around
             launches queued behind a device-side spin measure it, as they
             do where a session counts fewer kernels per call than were
             launched) and the
             event-window time per call with the host's cost
             (``call_ms``); the paged kernel also at a 4096-token context,
             with a sweep of split counts at both shapes, and on int8 pools at
             the decode shape, and at the verify width (l_q = 5, bf16
             and int8 pools: row 4v).  Last, so that
             no profiler session precedes the serve and train windows; then
             the spin-queued event time beside the profiler's for the
             paged decode kernel and the tc forward; the float16 ``tc``
             kernels' rows; then the step profiles: the GPT step under
             ``bf16-f32master`` beside the f32-param one (copy kernels by
             kind and by copied shape), and replayed-graph chunks of the
             CNN, the GPT and config 5 at f32 and bf16-f32master (wall,
             device busy, busy share).  Among the kernel rows: the flash
             kernels at BERT's shape (B=32, L=128, H=2, D=64, key mask) on
             each route, and the SIMT kernels at f32 at the slice's shape,
             bound by the f32 (non-tensor) peak, and the tc32 forward, dQ
             and dK/dV at both shapes, bound by three TF32 products per f32
             product at the TF32 peak, with the SIMT kernels' times beside
             them,
             beside SDPA (under a boolean key mask at BERT's shape; its
             backward kernels named); last, a draft_k = 4 verify's device
             time by column beside one forward over its 40 rows and a
             decode step, on the paged layout; and phase 5f's kernels at its
             shapes (the flash kernels at B=8, L=128, H=8, D=64, causal,
             on tc32 and tc; the paged kernel on f32 pools and on bf16
             pools with 2 kv heads, 64-entry tables), each held against
             its plain version first;
7. remat   — the train window's GPT with remat off and on: eager steps
             with equal losses, forward launches 16 per step against 8
             (dQ and dK/dV 8), each step's peak memory and device time;
             two 8-step ``bf16-f32master`` chunks under remat, the second
             captured and replayed as a CUDA graph, against eager chunks;
             BERT-tiny (dropout 0.1) under remat, a replayed chunk against
             the one without remat.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import re
import signal
import subprocess
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.observability.roofline import (
    device_peaks)

F32_TOL = dict(rtol=1e-5, atol=2e-5)   # as tests/test_serving_paged_kernel.py
# bf16 output: kernel and plain version both accumulate in f32 and round
# once to bf16, so they may differ by one bf16 rounding (relative 2^-8)
BF16_TOL = dict(rtol=8e-3, atol=8e-3)
# first decode step's logits, fused read vs gather read, bf16 model: the
# two attention reads round differently to bf16 and the difference passes
# through 8 layers; logits have unit scale at this init
LOGIT_ATOL = 0.1
# f32 flash gradients: the bounds of tests/test_flash_attention.py (tile
# and online-softmax reassociation against one dense pass); bf16 gradients
# are held to BF16_TOL: the kernels sum in f32 and round once to bf16
FLASH_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# the tensor-core route (bf16, head dim a multiple of 16 up to 128) rounds
# each P (and dS) to bf16 before its product and each output to bf16
# again: a rounding of a term moves an output by at most 2^-9 (bf16's unit
# roundoff) of that term, so outputs are held element-wise to
# 2^-8 (|want| + sum of |terms|) + 1e-5 (a bound on |want| alone fails
# where large terms cancel), and to a relative Frobenius error under 1e-2.
# lse stays f32 on both routes (F32_TOL).
TC_RTOL, TC_ATOL, TC_FROBENIUS = 2.0 ** -8, 1e-5, 1e-2
# float16 dQ and dK also allow CANCEL of ``_cancel_sums``: dS = P (dP - Δ)
# scale cancels to near 0 where dP ≈ Δ (a causal row's first key), and the
# f32 sums of dP and Δ, in other orders on each side, leave a few f32
# roundings (2^-24) of the cancelled magnitudes, large beside the small
# results when dO carries an fp16 loss scale
CANCEL = 2.0 ** -20
# float16 outputs are compared where the plain version's f32 result rounds
# to a finite float16 (below 65520); there the kernel's must be finite too,
# save within its bound of 65520, where the two roundings may fall on
# either side of it.  dO scaled by the fp16 loss scale 2^15 is drawn as
# N(0, 1) x 2^15 saturated at 65504 (the draws past 2 would be inf, which
# makes the plain version non-finite on nearly every row).
F16_MAX, F16_OVERFLOW, LOSS_SCALE = 65504.0, 65520.0, 2.0 ** 15
# one train step of the bf16 flash model against its dense-attention twin
# (same weights, same batch): the dense path rounds scores, softmax and
# P·V to bf16 where the kernels keep f32, in each of 8 layers.  Loss: 0.2%
# of its ~9.7; each parameter's gradient: 10% relative (Frobenius norm).
# The attention key biases are not compared: their gradient is zero in
# exact arithmetic (a per-row score shift leaves the softmax unchanged),
# so both sides hold rounding noise.
TRAIN_LOSS_RTOL = 2e-3
TRAIN_GRAD_RTOL = 1e-1
# the same step of the f32 GPT: the dense twin runs f32 scores, softmax and
# P·V (TF32 off) where the tc32 kernels keep about 21 bits of each product
# and sum in another order, so each attention output moves by a few f32
# roundings (~1e-6 relative), and through 8 layers' forward and backward a
# few times that.  Loss: 1e-5 relative; each parameter's gradient: 1e-3
# relative (Frobenius norm), a hundredth of the bf16 bounds' 1e-1.
TRAIN_F32_LOSS_RTOL = 1e-5
TRAIN_F32_GRAD_RTOL = 1e-3
# the H100 SXM's data-sheet peaks, as the port's roofline holds them
_H100 = device_peaks("NVIDIA H100 80GB HBM3")
HBM_BYTES_PER_S = _H100.hbm_bytes_per_s
PEAK_FLOPS = {torch.float32: _H100.flops_per_s["f32"],
              torch.bfloat16: _H100.flops_per_s["bf16"],
              torch.float16: _H100.flops_per_s["bf16"]}
# the tc32 kernels run each f32 product as three TF32 products at the
# dense TF32 peak (data sheet, SXM): ~165 TFLOP/s of f32 products
TF32_FLOPS = 494.7e12
TC32_FLOPS = TF32_FLOPS / 3
LM = dict(vocab=16384, hidden=512, layers=8, heads=8, ffn=2048,
          seq=1024, batch=8)


def _device_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time_windows(fn, iters: int, warmup: int, windows: int = 3):
    """(median ms of ``windows`` timed windows, their spread: (max - min)
    / median)."""
    times = sorted(_time_ms(fn, iters, warmup) for _ in range(windows))
    mid = times[len(times) // 2]
    return mid, (times[-1] - times[0]) / mid


def _time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
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


# device times that torch.profiler did not see (or of which it dropped
# kernel records) and queued CUDA events measured instead (``_device_ms``)
EVENT_TIMED: list[str] = []
# what earlier phases measured that phase 5k holds its windows to or
# prints them beside: L1's outputs, step p50s and busy shares
SEEN: dict = {}
_SLEEP_CYCLES_PER_MS: list[float] = []


def _profiled(run, steps: int):
    """``_device_rows`` of a ``torch.profiler`` session around ``run()``
    (``steps`` calls of the work measured).  A session whose trace holds
    no device kernel is run once more before the result stands: CUPTI
    has, in one run on the card, handed a session no kernel at all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = _device_rows(prof, steps)
        if rows:
            return rows
    return rows


def _queued_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` from CUDA events around ``iters`` calls
    queued behind a device-side spin (``torch.cuda._sleep``) that outlasts
    their enqueueing: the card then runs them back to back, so the window
    holds their kernels and the gaps between kernels but not the host's
    launch cost (unless ``fn`` itself waits for the card)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not _SLEEP_CYCLES_PER_MS:
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(1e7 / start.elapsed_time(end))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int(2 * enqueue_ms * _SLEEP_CYCLES_PER_MS[0]) + 1)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 50, warmup: int = 5, *, label: str,
               whole: bool = False) -> float:
    """Device time per call of ``fn``: the self device time of every
    kernel ``iters`` calls launch, from ``torch.profiler``, over ``iters``
    (the host's cost between launches is not in it).  Two sessions are
    taken and the one that recorded more kernel launches stands: CUPTI
    has, in one run on the card, handed a session half of a kernel's
    launches (device time half the call's wall time).  ``whole``: ``fn``
    launches the same kernels every call and never waits for the card, so
    a count of kernels per call that is not a whole number (0.96: fewer
    than were launched) shows dropped records, and that reading is
    refused.  Then, and where the profiler sees no device time,
    ``_queued_ms`` measures it, ``label`` goes into ``EVENT_TIMED``, and
    which reading stands is printed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    sessions = [_profiled(run, iters) for _ in range(2)]
    counts = [sum(r[1] for r in rows) for rows in sessions]
    if counts[0] != counts[1]:
        print(f"[timing] {label}: the two profiler sessions recorded "
              f"{counts[0]:.2f} and {counts[1]:.2f} kernels per call; the "
              f"larger stands")
    best = max(sessions, key=lambda rows: sum(r[1] for r in rows))
    us, per_call = sum(r[0] for r in best), max(counts)
    dropped = whole and abs(per_call - round(per_call)) > 1e-6
    if us and not dropped:
        return us / 1e3
    EVENT_TIMED.append(label)
    ms = _queued_ms(fn, iters)
    why = ("saw no device time" if not us else
           f"recorded {counts[0]:.2f} and {counts[1]:.2f} kernels per call "
           f"(records dropped)")
    print(f"[timing] {label}: the profiler {why}; the queued CUDA events' "
          f"reading stands: {ms:.5f} ms per call"
          + (f" (profiler {us / 1e3:.5f})" if us else ""))
    return ms


def timing_cross_check() -> None:
    """``_device_ms``'s fallback beside the profiler on the same calls:
    the paged kernel at the decode shape and the tc flash forward at the
    train window's shape.  The fallback's window also holds the gaps
    between kernels, so it reads at or above the profiler's sum."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    q, kp, vp, bt, pos, _, _ = _paged_case(
        7, q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16)
    fq, fk, fv, _, _ = _flash_case(7, b=8, lq=1024, h=8, d=64,
                                   dtype=torch.bfloat16)
    calls = {"paged decode": lambda: pa.paged_attention(q, kp, vp, bt, pos),
             "flash fwd tc": lambda: fa._fwd_cuda(fq, fk, fv, None,
                                                  64 ** -0.5, True)}
    for name, fn in calls.items():
        prof = _device_ms(fn, label=f"{name} (cross-check)")
        queued = _queued_ms(fn, 50)
        print(f"[timing] {name}: profiler {prof:.5f} ms, queued CUDA "
              f"events {queued:.5f} ms per call (ratio "
              f"{queued / prof:.3f})")


def _paged_case(seed, *, s=8, l_q=1, h=8, kvh=8, d=64, blk=8, mb=18,
                q_dtype=torch.float32, kv_dtype=torch.float32,
                pos=None, alias=False, dev="cuda"):
    """Seeded pools + a permuted block table on ``dev`` (numpy draws)."""
    rng = np.random.default_rng(seed)
    n = s * mb + 1
    q = torch.from_numpy(rng.standard_normal((s, l_q, h, d)).astype(
        np.float32)).to(dev, q_dtype)
    ks = vs = None
    if kv_dtype == torch.int8:
        kp = torch.from_numpy(rng.integers(-127, 128, (n, blk, kvh, d))
                              .astype(np.int8)).to(dev)
        vp = torch.from_numpy(rng.integers(-127, 128, (n, blk, kvh, d))
                              .astype(np.int8)).to(dev)
        ks = torch.from_numpy((rng.uniform(0.5, 1.5, (n, blk, kvh)) / 127.0)
                              .astype(np.float32)).to(dev)
        vs = torch.from_numpy((rng.uniform(0.5, 1.5, (n, blk, kvh)) / 127.0)
                              .astype(np.float32)).to(dev)
    else:
        kp = torch.from_numpy(rng.standard_normal((n, blk, kvh, d)).astype(
            np.float32)).to(dev, kv_dtype)
        vp = torch.from_numpy(rng.standard_normal((n, blk, kvh, d)).astype(
            np.float32)).to(dev, kv_dtype)
    bt = rng.permutation(n)[:s * mb].reshape(s, mb).astype(np.int32)
    if alias:
        bt[1::2] = bt[0::2]
    if pos is None:
        pos = rng.integers(16, mb * blk - l_q + 1, s)
    pos = np.asarray(pos, np.int32)
    if alias:
        pos[1::2] = pos[0::2]
        q[1::2] = q[0::2]
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.from_numpy(pos).to(dev), ks, vs)


def _bound_ms(q, kp, pos, ks) -> tuple[float, str]:
    """Least time for the work this run's data needs (tables that alias
    no block): the keys each slot sees (``pos + l_q`` K and V rows, and
    their scales) and the table entries that map them read once,
    q/positions read once, out written once — against the HBM rate; the
    QK and PV products of every unmasked (row, key) pair against the peak
    rate for the input type.  The larger of the two bounds it."""
    s, l_q, h, d = q.shape
    _, blk, kvh, _ = kp.shape
    keys = pos.cpu().numpy().astype(np.int64) + l_q    # per slot
    kv_row = kvh * d * kp.element_size() + (kvh * 4 if ks is not None
                                            else 0)
    nbytes = (2 * int(keys.sum()) * kv_row
              + 2 * q.numel() * q.element_size()
              + int((-(-keys // blk)).sum()) * 4 + pos.numel() * 4)
    # query row l of a slot sees keys 0..pos+l
    pairs = float((l_q * (keys - l_q) + l_q * (l_q + 1) // 2).sum())
    flops = 4.0 * h * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS.get(q.dtype, PEAK_FLOPS[torch.float32]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _paged_timed(tag, q, kp, vp, bt, pos, splits_list, ks=None,
                 vs=None) -> dict:
    """Device ms per call of the kernel at each split count (None = the
    count ``_splits`` picks), the plain version and the library yardstick,
    the event-window ms per call of each, and the bound.  ``ks``/``vs``:
    the scales of int8 pools; ``tag`` names the shape in ``EVENT_TIMED``."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    s, l_q, h, d = q.shape
    mb, blk = bt.shape[1], kp.shape[1]
    sc = dict(k_scale=ks, v_scale=vs)
    sweep = {sp: _device_ms(
        lambda sp=sp: pa._paged_cuda(q, kp, vp, bt, pos, splits=sp, **sc),
        label=f"paged {tag} splits={sp}") for sp in splits_list}
    kernel = lambda: pa.paged_attention(  # noqa: E731
        q, kp, vp, bt, pos, **sc)
    plain = lambda: pa.paged_attention_reference(  # noqa: E731
        q, kp, vp, bt, pos, **sc)
    # library yardstick: one scaled_dot_product_attention call over the
    # table gathered (and dequantized, and widened to the query heads
    # under GQA) beforehand, not in the timed call
    kvh = kp.shape[2]
    keys = kp[bt.long()].reshape(s, mb * blk, kvh, d)
    vals = vp[bt.long()].reshape(s, mb * blk, kvh, d)
    if ks is not None:
        keys = (keys.float() * ks[bt.long()].reshape(s, mb * blk, kvh, 1)
                ).to(q.dtype)
        vals = (vals.float() * vs[bt.long()].reshape(s, mb * blk, kvh, 1)
                ).to(q.dtype)
    keys = keys.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    vals = vals.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    # query row l of a slot sees keys t <= pos + l
    rows = pos.long()[:, None] + torch.arange(l_q, device="cuda")[None, :]
    mask = (torch.arange(mb * blk, device="cuda")[None, None, None, :]
            <= rows[:, None, :, None])
    qt = q.transpose(1, 2)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731,E501
        qt, keys, vals, attn_mask=mask)
    bound_ms, bound_by = _bound_ms(q, kp, pos, ks)
    return {"splits": pa._splits(s, kp.shape[2], mb, blk),
            "ms": _device_ms(kernel, label=f"paged {tag}"),
            "call_ms": _time_ms(kernel),
            "plain_ms": _device_ms(plain, iters=10,
                                   label=f"paged {tag} plain"),
            "plain_call_ms": _time_ms(plain, iters=20, warmup=3),
            "library_ms": _device_ms(library, label=f"paged {tag} SDPA"),
            "library_call_ms": _time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "sweep": {str(sp): t for sp, t in sweep.items()}}


def paged_check_phase() -> dict:
    """The paged kernel against its plain version on ten seeded cases at
    every split count; returns each case's max abs error."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    cases = {
        "decode_bench_bf16": (dict(q_dtype=torch.bfloat16,
                                   kv_dtype=torch.bfloat16), BF16_TOL),
        "gqa_f32": (dict(h=8, kvh=2), F32_TOL),
        "verify_lq5_gqa_f32": (dict(h=8, kvh=2, l_q=5), F32_TOL),
        "int8_scales": (dict(h=8, kvh=2, kv_dtype=torch.int8), F32_TOL),
        # window Q's decode shape: bf16 queries over int8 pools
        "decode_int8_bf16": (dict(q_dtype=torch.bfloat16,
                                  kv_dtype=torch.int8), BF16_TOL),
        "mha_f32": (dict(), F32_TOL),
        "aliased_tables_bf16": (dict(q_dtype=torch.bfloat16,
                                     kv_dtype=torch.bfloat16, alias=True),
                                BF16_TOL),
        "block_edges_f32": (dict(pos=[0, 7, 8, 15, 16, 63, 64, 143]),
                            F32_TOL),
        "head_dim_256_f32": (dict(d=256, h=4, kvh=4, mb=4), F32_TOL),
        # 80 folded rows x head_dim 128: 95 KB of dynamic shared memory
        "large_group_smem_f32": (dict(h=32, kvh=2, l_q=5, d=128), F32_TOL),
        # a draft_k = 4 verify at the serving shape, on the pools the
        # served tables hold (windows S-small and, at int8, Q's storage)
        "verify_lq5_bf16": (dict(q_dtype=torch.bfloat16,
                                 kv_dtype=torch.bfloat16, l_q=5), BF16_TOL),
        "verify_lq5_int8": (dict(q_dtype=torch.bfloat16,
                                 kv_dtype=torch.int8, l_q=5), BF16_TOL),
    }
    errs = {}
    for i, (name, (kw, tol)) in enumerate(cases.items()):
        q, kp, vp, bt, pos, ks, vs = _paged_case(100 + i, **kw)
        ref = pa.paged_attention_reference(q, kp, vp, bt, pos,
                                           k_scale=ks, v_scale=vs)
        mb = bt.shape[1]
        # the wrapper's own split count, then forced counts up to one
        # table entry per split
        for sp in (None, 1, 2, 4, mb):
            out = pa._paged_cuda(q, kp, vp, bt, pos, k_scale=ks, v_scale=vs,
                                 splits=sp)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ref.float(), **tol,
                                       msg=f"{name} splits={sp}")
            if kw.get("alias"):
                assert torch.equal(out[0::2], out[1::2]), "aliased rows differ"
            err = float((out.float() - ref.float()).abs().max())
            errs[name] = max(errs.get(name, 0.0), err)
        print(f"[kernel] {name}: max_abs_err={errs[name]:.3e} at splits "
              f"default/1/2/4/{mb} ok")
    return errs


def paged_timing_phase(errs) -> dict:
    """The paged kernel timed at the serve decode shape and at a long
    context, with a sweep of split counts; returns the kernel's row."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    sweep = (1, 2, 4, 8, 16, 32, 64)
    # the serving path's decode shape
    q, kp, vp, bt, pos, _, _ = _paged_case(
        7, q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16)
    dec = _paged_timed("decode", q, kp, vp, bt, pos, sweep)
    # a long context: 4096-token tables, positions in [3584, 4095]
    long_pos = np.random.default_rng(8).integers(3584, 4096, 8)
    q, kp, vp, bt, pos, _, _ = _paged_case(
        8, blk=16, mb=256, q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16,
        pos=long_pos)
    out = pa.paged_attention(q, kp, vp, bt, pos)
    ref = pa.paged_attention_reference(q, kp, vp, bt, pos)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    lng = _paged_timed("4096-token", q, kp, vp, bt, pos, sweep)
    del q, kp, vp, bt, pos, out, ref
    # window Q's decode shape: int8 pools with f32 scales
    q, kp, vp, bt, pos, ks, vs = _paged_case(
        9, q_dtype=torch.bfloat16, kv_dtype=torch.int8)
    i8 = _paged_timed("int8", q, kp, vp, bt, pos, (1, 2, 4, 8), ks, vs)
    del q, kp, vp, bt, pos, ks, vs
    # row 4v: a draft_k = 4 verify (l_q = 5) at the serving shape, on bf16
    # and on int8 pools
    q, kp, vp, bt, pos, _, _ = _paged_case(
        10, l_q=5, q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16)
    ver = _paged_timed("verify l_q=5", q, kp, vp, bt, pos, (1, 2, 4, 8))
    q, kp, vp, bt, pos, ks, vs = _paged_case(
        11, l_q=5, q_dtype=torch.bfloat16, kv_dtype=torch.int8)
    ver8 = _paged_timed("verify l_q=5 int8", q, kp, vp, bt, pos,
                        (1, 2, 4, 8), ks, vs)
    del q, kp, vp, bt, pos, ks, vs
    for label, t in (("decode S=8 H=KVH=8 D=64 blk=8 MB=18 bf16", dec),
                     ("decode S=8 H=KVH=8 D=64 blk=8 MB=18 bf16 q, int8 "
                      "pools + f32 scales", i8),
                     ("verify l_q=5 S=8 H=KVH=8 D=64 blk=8 MB=18 bf16", ver),
                     ("verify l_q=5 S=8 H=KVH=8 D=64 blk=8 MB=18 bf16 q, "
                      "int8 pools + f32 scales", ver8),
                     ("long context S=8 H=KVH=8 D=64 blk=16 MB=256 pos "
                      "3584-4095 bf16", lng)):
        print(f"[kernel] {label}: device ms per call: kernel={t['ms']:.5f} "
              f"(splits={t['splits']}) plain={t['plain_ms']:.5f} "
              f"library={t['library_ms']:.5f}; call ms: "
              f"kernel={t['call_ms']:.5f} plain={t['plain_call_ms']:.5f} "
              f"library={t['library_call_ms']:.5f}; bound_ms="
              f"{t['bound_ms']:.6f} ({t['bound_by']}), kernel/bound="
              f"{t['ms'] / t['bound_ms']:.2f}")
        print(f"[kernel] {label}: split sweep (device ms per call): "
              + " ".join(f"{sp}:{ms:.5f}" for sp, ms in t["sweep"].items()))
    return {"name": "paged_attention", "route": "cuda",
            "source": "distributed_tensorflow_tpu_torch/ops/csrc/"
                      "paged_attention.cu",
            "replaces": "distributed_tensorflow_tpu/ops/paged_attention.py:257",
            "max_abs_err": errs["decode_bench_bf16"],
            **{k: dec[k] for k in ("ms", "call_ms", "plain_ms",
                                   "plain_call_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_call_ms",
                                   "splits")},
            "split_sweep": dec["sweep"],
            "long_context": {k: lng[k] for k in (
                "ms", "call_ms", "splits", "bound_ms", "bound_by",
                "plain_ms", "library_ms", "sweep")},
            "int8": {"max_abs_err": errs["decode_int8_bf16"],
                     **{k: i8[k] for k in (
                         "ms", "call_ms", "splits", "bound_ms", "bound_by",
                         "plain_ms", "library_ms", "sweep")}},
            "verify_lq5": {
                "max_abs_err": errs["verify_lq5_bf16"],
                **{k: ver[k] for k in (
                    "ms", "call_ms", "splits", "bound_ms", "bound_by",
                    "plain_ms", "library_ms", "sweep")},
                "int8": {"max_abs_err": errs["verify_lq5_int8"],
                         **{k: ver8[k] for k in (
                             "ms", "call_ms", "splits", "bound_ms",
                             "bound_by", "plain_ms", "library_ms",
                             "sweep")}}}}


def _flash_case(seed, *, b, lq, h, d, dtype=torch.float32, lk=None,
                masked=False, dead_row=False, do_scale=1.0, v_scale=1.0):
    """Seeded q, k, v (times ``v_scale``), dO (times ``do_scale``,
    saturated at ±65504) and key mask on the card (numpy draws)."""
    rng = np.random.default_rng(seed)
    lk = lk or lq

    def draw(*shape, scale=1.0):
        a = np.clip(rng.standard_normal(shape) * scale, -F16_MAX, F16_MAX)
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)

    q, k, v, do = draw(b, lq, h, d), draw(b, lk, h, d), \
        draw(b, lk, h, d, scale=v_scale), draw(b, lq, h, d, scale=do_scale)
    mask = None
    if masked or dead_row:
        m = (rng.uniform(size=(b, lk)) > 0.3 if masked
             else np.ones((b, lk), bool))
        m[:, 0] = True
        if dead_row:
            m[-1] = False            # the last batch row has no valid key
        mask = torch.from_numpy(m.astype(np.float32)).cuda()
    return q, k, v, do, mask


def _flash_bound_ms(kind, q, k, causal, mask=None,
                    peak=None) -> tuple[float, str]:
    """Least time for one kernel's work on these inputs: each input read
    once and each output written once at the HBM rate, against the products
    of the unmasked (causal) pairs at the peak rate for the input type —
    QKᵀ and PV (fwd: 4·D per pair), QKᵀ, dO·Vᵀ and dS·K (dq: 6·D), QKᵀ,
    dO·Vᵀ, Pᵀ·dO and dSᵀ·Q (dkv: 8·D).  The larger of the two bounds it.
    A (B, Lk) f32 key ``mask`` (non-causal) is one more input, and only its
    valid keys' pairs count.  ``peak``: the FLOP/s of the products (default
    the type's peak; ``TC32_FLOPS`` for the 3xTF32 kernels)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    tensor = q.numel() * q.element_size()       # q, k, v, dO alike (Lq=Lk)
    row = b * h * lq * 4                        # lse or delta, f32
    tensors, rows, per_pair = {"fwd": (4, 1, 4), "dq": (5, 2, 6),
                               "dkv": (6, 2, 8)}[kind]
    nbytes = tensors * tensor + rows * row
    qpos = np.arange(lq)
    pairs = b * h * float((np.minimum(qpos + 1, lk) if causal
                           else np.full(lq, lk)).sum())
    if mask is not None:
        assert not causal
        nbytes += mask.numel() * mask.element_size()
        pairs = h * lq * float((mask > 0).sum())
    flops = float(per_pair * d) * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[q.dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _f16_kept(name, got, want, bound):
    """The elements of a float16 output to compare (F16_OVERFLOW): where
    the plain f32 ``want`` rounds to a finite float16, less the ones where
    ``got`` overflowed within ``bound`` of 65520 (any other overflow
    fails)."""
    ok = torch.isfinite(want.half())
    lost = ok & ~torch.isfinite(got)
    assert bool((want.abs() + bound)[lost].ge(F16_OVERFLOW).all()), (
        name, "non-finite where the plain version is finite in float16")
    return ok & ~lost


def _close_tc(name, got, want, terms, cancel=None):
    """The tensor-core tolerance (TC_*; dQ and dK also ``CANCEL`` of
    ``_cancel_sums``); returns (max abs err, relative Frobenius err)."""
    f16 = got.dtype == torch.float16
    got, want = got.float(), want.float()
    bound = TC_RTOL * (want.abs() + terms) + TC_ATOL
    if cancel is not None:
        bound = bound + CANCEL * cancel
    if f16:
        keep = _f16_kept(name, got, want, bound)
        got, want, bound = got[keep], want[keep], bound[keep]
    err = (got - want).abs()
    worst = float((err / bound).max())
    frob = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert worst <= 1.0 and frob < TC_FROBENIUS, (name, worst, frob)
    return float(err.max()), frob


def _check_flash(name, case, causal, route, v_scale=1.0) -> dict:
    """Forward, dQ and dK/dV kernels against the plain versions; the
    backward gets the plain forward's lse and Δ = rowsum(dO·O).  The
    launch counters show the kernels of ``route`` ran (``tc32``: the
    forward, dQ and dK/dV, which must also repeat bitwise; their largest
    difference from the SIMT kernels' is printed)."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do, mask = case
    scale = q.shape[-1] ** -0.5
    # a case runs on its inputs' route, or on simt where it is forced there
    assert route == "simt" or fa._route(q.dtype, q.shape[-1],
                                        "dq") == route, (name, route)
    before, before32 = _flash_counts(), _tc32_counts()
    out, lse = fa._fwd_cuda(q, k, v, mask, scale, causal, route=route)
    ref_out, ref_lse = fa._fwd_reference(q, k, v, mask, scale, causal)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    bwd = (q, k, v, mask, do, ref_lse.contiguous(), delta, scale, causal)
    grads = (fa._dq_cuda(*bwd, route=route),
             *fa._dkv_cuda(*bwd, route=route))
    torch.cuda.synchronize()
    tc, tc32 = int(route == "tc"), int(route == "tc32")
    assert _flash_counts() == {
        "fwd": before["fwd"] + 1, "dq": before["dq"] + 1,
        "dkv": before["dkv"] + 1, "fwd_tc": before["fwd_tc"] + tc,
        "dq_tc": before["dq_tc"] + tc,
        "dkv_tc": before["dkv_tc"] + tc}, (name, route)
    assert _tc32_counts() == {n: c + tc32 for n, c in before32.items()}, (
        name, route)
    refs = fa._bwd_reference(q, k, v, mask, do, ref_lse, delta, scale,
                             causal)
    if v_scale > 1.0:
        # the case holds what it is for: a dS that float16 cannot hold
        p = torch.exp(fa._scores(q, k, mask, scale, causal)
                      - ref_lse[..., None])
        dp = torch.einsum("blhd,bmhd->bhlm", do.float(), v.float())
        ds_max = float((p * (dp - delta[..., None]) * scale).abs().max())
        del p, dp
        assert ds_max > F16_OVERFLOW, (name, ds_max)
        print(f"[flash] {name}: the plain version's largest |dS| is "
              f"{ds_max:.0f}")
    torch.testing.assert_close(lse, ref_lse, **F32_TOL)
    errs = {"lse": float((lse - ref_lse).abs().max())}
    f32 = q.dtype == torch.float32
    if route == "tc":
        terms = fa._term_sums(q, k, v, mask, do, ref_lse, delta, scale,
                              causal)
        # the cancellation term only for float16 (bf16 keeps its bound)
        cancel = (fa._cancel_sums(q, k, v, mask, do, ref_lse, delta, scale,
                                  causal) if q.dtype == torch.float16
                  else (None, None))
        for n, got, want, t, c in (
                ("out", out, ref_out, terms[0], None),
                ("dq", grads[0], refs[0], terms[3], cancel[1]),
                ("dk", grads[1], refs[1], terms[1], cancel[0]),
                ("dv", grads[2], refs[2], terms[2], None)):
            errs[n], errs[f"{n}_frobenius"] = _close_tc(f"{name} {n}", got,
                                                        want, t, c)
    else:
        for n, g, w in zip(("out", "dq", "dk", "dv"), (out, *grads),
                           (ref_out, *refs)):
            g, w = g.float(), w.float()
            tol = ((F32_TOL if n == "out" else FLASH_GRAD_TOL) if f32
                   else BF16_TOL)
            if q.dtype == torch.float16:
                keep = _f16_kept(f"{name} {n}", g, w,
                                 tol["rtol"] * w.abs() + tol["atol"])
                g, w = g[keep], w[keep]
            torch.testing.assert_close(g, w, msg=f"{name} {n}", **tol)
            errs[n] = float((g - w).abs().max())
    if route == "tc32":
        again = (*fa._fwd_cuda(q, k, v, mask, scale, causal, route=route),
                 fa._dq_cuda(*bwd, route=route),
                 *fa._dkv_cuda(*bwd, route=route))
        simt = (*fa._fwd_cuda(q, k, v, mask, scale, causal, route="simt"),
                fa._dq_cuda(*bwd, route="simt"),
                *fa._dkv_cuda(*bwd, route="simt"))
        torch.cuda.synchronize()
        for n, g, a, w in zip(("out", "lse", "dq", "dk", "dv"),
                              (out, lse, *grads), again, simt):
            assert torch.equal(g, a), (name, n, "not bitwise repeatable")
            errs[f"{n}_vs_simt"] = float((g - w).abs().max())
    print(f"[flash] {name} ({route}): " + " ".join(
        f"{n}_{'rel' if n.endswith('frobenius') else 'max_abs_err'}={e:.3e}"
        for n, e in errs.items()) + " ok")
    return errs


def _check_flash_blocks() -> None:
    """``flash_fwd_block``/``flash_bwd_block`` over a two-block split of
    the keys, given the full rows' lse and Δ: each block against the plain
    versions, and the blocks merged against the whole."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do, _ = _flash_case(30, b=2, lq=512, h=4, d=64)
    scale = 64 ** -0.5
    full_out, lse = fa._fwd_reference(q, k, v, None, scale, False)
    delta = (do * full_out).sum(-1).transpose(1, 2).contiguous()
    full = fa._bwd_reference(q, k, v, None, do, lse, delta, scale, False)
    ones = torch.ones(2, 256, device="cuda")
    merged, dq, dks, dvs = 0.0, 0.0, [], []
    for half in (slice(0, 256), slice(256, 512)):
        kb, vb = k[:, half].contiguous(), v[:, half].contiguous()
        out_b, lse_b = fa.flash_fwd_block(q, kb, vb, ones, scale=scale)
        want_out, want_lse = fa._fwd_reference(q, kb, vb, ones, scale, False)
        torch.testing.assert_close(out_b, want_out, **F32_TOL)
        torch.testing.assert_close(lse_b, want_lse, **F32_TOL)
        grads = fa.flash_bwd_block(q, kb, vb, ones, do, lse, delta,
                                   scale=scale)
        want = fa._bwd_reference(q, kb, vb, ones, do, lse, delta, scale,
                                 False)
        for g, w in zip(grads, want):
            torch.testing.assert_close(g, w, **FLASH_GRAD_TOL)
        merged = merged + torch.exp(lse_b - lse).transpose(1, 2)[
            ..., None] * out_b
        dq = dq + grads[0]
        dks.append(grads[1])
        dvs.append(grads[2])
    torch.testing.assert_close(merged, full_out, **F32_TOL)
    for g, w in zip((dq, torch.cat(dks, 1), torch.cat(dvs, 1)), full):
        torch.testing.assert_close(g, w, **FLASH_GRAD_TOL)
    # causal diagonal blocks with Lq != Lk (the mask by absolute position)
    worst = 0.0
    for lq in (200, 448):
        qb, dob = q[:, :lq].contiguous(), do[:, :lq].contiguous()
        kb, vb = k[:, :320].contiguous(), v[:, :320].contiguous()
        mask = torch.ones(2, 320, device="cuda")
        out_b, lse_b = fa.flash_fwd_block(qb, kb, vb, mask, scale=scale,
                                          causal=True)
        want_out, want_lse = fa._fwd_reference(qb, kb, vb, mask, scale, True)
        torch.testing.assert_close(out_b, want_out, **F32_TOL)
        torch.testing.assert_close(lse_b, want_lse, **F32_TOL)
        delta_b = (dob * want_out).sum(-1).transpose(1, 2).contiguous()
        grads = fa.flash_bwd_block(qb, kb, vb, mask, dob, want_lse, delta_b,
                                   scale=scale, causal=True)
        want = fa._bwd_reference(qb, kb, vb, mask, dob, want_lse, delta_b,
                                 scale, True)
        for g, w in zip(grads, want):
            torch.testing.assert_close(g, w, **FLASH_GRAD_TOL)
        worst = max(worst, float((out_b - want_out).abs().max()))
    print(f"[flash] block primitives, two-block split: merged out "
          f"max_abs_err={float((merged - full_out).abs().max()):.3e}, "
          f"dq {float((dq - full[0]).abs().max()):.3e}; causal diagonal "
          f"blocks 200x320 and 448x320: out max_abs_err={worst:.3e} ok")


def _sdpa_backend(dtype=torch.bfloat16):
    """The first SDPA backend that takes the slice's causal shape in
    ``dtype``, in the order flash, cuDNN, memory-efficient."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q = torch.zeros(1, 1, 128, 64, device="cuda", dtype=dtype)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            # a backend that refuses the inputs warns why, then raises
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                torch.nn.functional.scaled_dot_product_attention(
                    q, q, q, is_causal=True)
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes the slice's shape")


def flash_check_phase() -> dict:
    """The flash kernels of both routes against their plain versions on
    seeded cases; returns each case's errors."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    cases = {"slice_bf16_causal": (dict(b=8, lq=1024, h=8, d=64,
                                         dtype=bf16), True, "tc")}
    for name, kw, causal in (
            ("ragged_l1000", dict(b=2, lq=1000, h=4, d=64), True),
            ("key_mask", dict(b=2, lq=512, h=4, d=64, masked=True), False),
            ("cross_96x160", dict(b=2, lq=96, lk=160, h=4, d=64), False),
            ("head_dim_128", dict(b=1, lq=384, h=2, d=128), True),
            ("head_dim_256", dict(b=1, lq=384, h=2, d=256), True),
            ("no_valid_key_row", dict(b=2, lq=256, h=2, d=64,
                                      dead_row=True), False)):
        cases[f"{name}_f32"] = (kw, causal, "simt")
        # the bf16 twin: the tc route where it takes the head dim
        cases[f"{name}_bf16"] = (dict(kw, dtype=bf16), causal,
                                 fa._route(bf16, kw["d"]))
    # float16 (the fp16-f32master GPT): both routes at the slice's shape,
    # also with dO scaled by the fp16 loss scale 2^15, and with V scaled
    # so that dS passes float16's range; and the tc route's edge cases
    f16 = torch.float16
    slice16 = dict(b=8, lq=1024, h=8, d=64, dtype=f16)
    for route in ("tc", "simt"):
        cases[f"slice_f16_causal_{route}"] = (slice16, True, route)
        cases[f"scaled_do_f16_{route}"] = (dict(slice16, do_scale=LOSS_SCALE),
                                           True, route)
        cases[f"scaled_do_large_ds_f16_{route}"] = (
            dict(slice16, do_scale=LOSS_SCALE, v_scale=4.0), True, route)
    for name, kw, causal in (
            ("ragged_l1000", dict(b=2, lq=1000, h=4, d=64), True),
            ("key_mask", dict(b=2, lq=512, h=4, d=64, masked=True), False),
            ("head_dim_128", dict(b=1, lq=384, h=2, d=128), True),
            ("no_valid_key_row", dict(b=2, lq=256, h=2, d=64,
                                      dead_row=True), False)):
        cases[f"{name}_f16"] = (dict(kw, dtype=f16), causal, "tc")
    # the f32 kernels on the 3xTF32 tensor-core route (tc32: forward, dQ
    # and dK/dV), on seeds of their own: the slice, and the SIMT cases at
    # head dims it takes, cross lengths also causal, and head dim 16
    tc32 = {"slice_f32_causal_tc32": (dict(b=8, lq=1024, h=8, d=64), True,
                                      "tc32")}
    for name, kw, causal in (
            ("ragged_l1000", dict(b=2, lq=1000, h=4, d=64), True),
            ("key_mask", dict(b=2, lq=512, h=4, d=64, masked=True), False),
            ("cross_96x160", dict(b=2, lq=96, lk=160, h=4, d=64), False),
            ("head_dim_128", dict(b=1, lq=384, h=2, d=128), True),
            ("no_valid_key_row", dict(b=2, lq=256, h=2, d=64,
                                      dead_row=True), False),
            ("cross_96x160_causal", dict(b=2, lq=96, lk=160, h=4, d=64),
             True),
            ("cross_160x96_causal", dict(b=2, lq=160, lk=96, h=4, d=64),
             True),
            ("head_dim_16", dict(b=2, lq=200, h=2, d=16, masked=True),
             True)):
        tc32[f"{name}_tc32"] = (kw, causal, "tc32")
    seeds = {name: 20 + i for i, name in enumerate(cases)}
    seeds.update({name: 60 + i for i, name in enumerate(tc32)})
    cases.update(tc32)
    errs = {}
    for name, (kw, causal, route) in cases.items():
        case = _flash_case(seeds[name], **kw)
        errs[name] = _check_flash(name, case, causal, route,
                                  kw.get("v_scale", 1.0))
        if kw.get("dead_row"):
            q, k, v, _, mask = case
            out = fa.flash_attention(q, k, v, kv_mask=mask)
            mean_v = v[-1].float().mean(0, keepdim=True).expand_as(out[-1])
            if route == "tc":
                _close_tc(f"{name} mean of V", out[-1], mean_v,
                          v[-1].float().abs().mean(0, keepdim=True))
            else:
                torch.testing.assert_close(out[-1], mean_v, **F32_TOL)
    _check_flash_blocks()
    return errs


def flash_timing_phase(errs) -> list[dict]:
    """The flash kernels timed at the training slice's shape; returns
    their rows."""
    from torch.nn.attention import sdpa_kernel

    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    # the training slice's shape, timed: device ms per launch from the
    # profiler; beside it the event-window ms per call (median of three
    # windows of back-to-back calls, host cost included)
    q, k, v, do, _ = _flash_case(7, b=8, lq=1024, h=8, d=64, dtype=bf16)
    scale = 64 ** -0.5
    out, lse = fa._fwd_cuda(q, k, v, None, scale, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, None, do, lse, delta, scale, True)
    timed = {
        "fwd": lambda: fa._fwd_cuda(q, k, v, None, scale, True),
        "dq": lambda: fa._dq_cuda(*args),
        "dkv": lambda: fa._dkv_cuda(*args),
        # the SIMT kernels on the same bf16 inputs: the design the tc
        # route replaced on this path
        "fwd_simt": lambda: fa._fwd_cuda(q, k, v, None, scale, True,
                                         route="simt"),
        "dq_simt": lambda: fa._dq_cuda(*args, route="simt"),
        "dkv_simt": lambda: fa._dkv_cuda(*args, route="simt")}
    dev = {n: _device_ms(fn, label=f"flash {n}", whole=True)
           for n, fn in timed.items()}
    call = {n: _time_windows(fn, iters=50, warmup=5) for n, fn in timed.items()}
    plain_fwd = lambda: fa._fwd_reference(q, k, v, None, scale, True)  # noqa: E731,E501
    # the plain backward computes dq, dk and dv in one function: its time
    # stands in both backward rows
    plain_bwd = lambda: fa._bwd_reference(*args)  # noqa: E731
    plain = {"fwd": (_device_ms(plain_fwd, iters=10, warmup=2,
                                label="flash fwd plain", whole=True),
                     _time_windows(plain_fwd, iters=10, warmup=2)[0]),
             "bwd": (_device_ms(plain_bwd, iters=10, warmup=2,
                                label="flash bwd plain", whole=True),
                     _time_windows(plain_bwd, iters=10, warmup=2)[0])}
    # library yardstick, used nowhere in the port: one SDPA call under a
    # named backend, and the autograd backward of that call (dq, dk, dv)
    backend = _sdpa_backend()
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dot = do.transpose(1, 2)
    lib_fwd_fn = lambda: sdpa(qt, kt, vt, is_causal=True)  # noqa: E731
    with sdpa_kernel(backend):
        lib_fwd = (_device_ms(lib_fwd_fn, label="flash fwd SDPA",
                              whole=True),
                   *_time_windows(lib_fwd_fn, iters=50, warmup=5))
        o = sdpa(qt, kt, vt, is_causal=True)
    lib_bwd_fn = lambda: torch.autograd.grad(  # noqa: E731
        o, (qt, kt, vt), dot, retain_graph=True)
    lib_bwd = (_device_ms(lib_bwd_fn, label="flash bwd SDPA", whole=True),
               *_time_windows(lib_bwd_fn, iters=50, warmup=5))
    print(f"[flash] library yardstick: SDPA backend {backend.name}: "
          f"fwd device {lib_fwd[0]:.5f} ms, call {lib_fwd[1]:.5f} ms "
          f"(spread {lib_fwd[2]:.3f}); bwd device {lib_bwd[0]:.5f} ms, call "
          f"{lib_bwd[1]:.5f} ms (spread {lib_bwd[2]:.3f})")
    for n in timed:
        print(f"[flash] slice B=8 L=1024 H=8 D=64 bf16 causal: {n} device "
              f"{dev[n]:.5f} ms, call {call[n][0]:.5f} ms (spread "
              f"{call[n][1]:.3f} over 3 windows)")
    print(f"[flash] plain device ms: fwd {plain['fwd'][0]:.5f}, bwd "
          f"{plain['bwd'][0]:.5f}")
    print(f"[flash] dq+dkv {dev['dq'] + dev['dkv']:.5f} ms against the "
          f"SDPA backward {lib_bwd[0]:.5f} ms (device)")
    src = "distributed_tensorflow_tpu_torch/ops/csrc/"
    replaces = {"fwd": 170, "dq": 281, "dkv": 299}
    slice_errs = errs["slice_bf16_causal"]
    rows = []
    for kind in ("fwd", "dq", "dkv"):
        variant = fa._route(bf16, 64)
        bound_ms, bound_by = _flash_bound_ms(kind, q, k, True)
        err = {"fwd": slice_errs["out"], "dq": slice_errs["dq"],
               "dkv": max(slice_errs["dk"], slice_errs["dv"])}[kind]
        lib = lib_fwd if kind == "fwd" else lib_bwd
        pl = plain["fwd" if kind == "fwd" else "bwd"]
        rows.append({
            "name": f"flash_attention.{kind}", "route": "cuda",
            "variant": variant,
            "source": src + ("flash_attention_sm90.cu" if variant == "tc"
                             else "flash_attention.cu"),
            "replaces": "distributed_tensorflow_tpu/ops/flash_attention.py:"
                        f"{replaces[kind]}",
            "max_abs_err": err, "ms": dev[kind],
            "call_ms": call[kind][0], "call_spread": call[kind][1],
            "plain_ms": pl[0], "plain_call_ms": pl[1],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / dev[kind],
            "library_ms": lib[0], "library_call_ms": lib[1],
            "library_spread": lib[2], "library_backend": backend.name,
            "simt_ms": dev[f"{kind}_simt"],
            "simt_call_ms": call[f"{kind}_simt"][0]})
    return rows


def flash_f16_timing_phase(errs) -> list[dict]:
    """The float16 tensor-core kernels (the fp16-f32master GPT's) timed at
    the training slice's shape beside their bounds, the plain versions and
    float16 SDPA; returns their rows (launches filled in by ``main``)."""
    f16 = torch.float16
    q, k, v, do, _ = _flash_case(7, b=8, lq=1024, h=8, d=64, dtype=f16)
    return _flash_rows("f16", "tc", q, k, v, do, None, True,
                       errs["slice_f16_causal_tc"], _sdpa_backend(f16),
                       "float16")


SERVE = dict(vocab=16384, hidden=512, layers=8, heads=8, ffn=2048,
             slots=8, block=8, chunk=16, pool=128)


def _serve_model(seed: int = 0, **overrides):
    """The serve GPT with random weights from ``seed``; ``overrides`` of
    its size make a draft (``parse_draft_config``)."""
    from distributed_tensorflow_tpu_torch.models import create_model

    size = {k: SERVE[k] for k in ("hidden", "layers", "heads", "ffn")}
    size.update(overrides)
    model = create_model("gpt", num_classes=SERVE["vocab"],
                         max_len=16 + 64 + 64, dropout_rate=0.0,
                         dtype="bfloat16", **size)
    return model.reset_parameters(torch.Generator().manual_seed(seed))


def _bench_trace():
    """``bench.py --serve``'s default trace, drawn in its order from
    ``default_rng(0)``: 32 requests, prompts of the 16-token shared prefix
    plus 16-32 tokens (every 4th plus 64), 32-64 new tokens.  Returns the
    shared prefix and the requests."""
    from distributed_tensorflow_tpu_torch.serving import Request

    rng = np.random.default_rng(0)
    n, rate, prompt_len, max_new, shared_len = 32, 4.0, 32, 64, 16
    rng.exponential(1.0 / rate, n)          # the arrivals (see below)
    p_lens = rng.integers(prompt_len // 2, prompt_len + 1, n)
    p_lens[::4] = 2 * prompt_len
    n_news = rng.integers(max_new // 2, max_new + 1, n)
    shared = rng.integers(0, SERVE["vocab"], shared_len).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, SERVE["vocab"], pl).astype(np.int32)]) for pl in p_lens]
    # every request arrives at 0: the smoke is no benchmark, and the
    # Poisson arrivals at 4 per second would add about 8 s of wall time to
    # each window
    return shared, [Request(rid=i, prompt=prompts[i],
                            max_new_tokens=int(n_news[i]))
                    for i in range(n)]


def _reset_paged_counts() -> None:
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    pa.paged_attention.launches = 0
    pa.paged_attention.int8_launches = 0
    pa.paged_attention.verify_launches = 0
    pa.paged_attention.launches_by_kv_heads.clear()


def _paged_counts() -> tuple[int, int, int]:
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    return (pa.paged_attention.launches, pa.paged_attention.int8_launches,
            pa.paged_attention.verify_launches)


def _serve_window(name, kv, requests, gpu, before_main=None, **batcher_kw):
    """A warm-up window of the first two requests (allocator, library
    handles, a graph's eager round and capture; they stay in the prefix
    pool), then the whole trace with the paged counts set to 0 just before
    (and ``before_main`` called); returns the summary and the counts (all
    launches, int8-route launches, ``l_q > 1`` launches).  The summary
    gains ``dispatches`` (forwards of both tables) and ``host_gap_s``
    (wall time less the target table's forward time) in every window."""
    from distributed_tensorflow_tpu_torch.serving import ContinuousBatcher

    batcher = ContinuousBatcher(kv, prefill_chunk=SERVE["chunk"],
                                **batcher_kw)
    batcher.run(requests[:2])
    torch.cuda.synchronize()
    _reset_paged_counts()
    if before_main is not None:
        before_main()
    disp0 = batcher._dispatches()
    summary = batcher.run(requests)
    torch.cuda.synchronize()
    counts = _paged_counts()
    summary["dispatches"] = batcher._dispatches() - disp0
    summary["host_gap_s"] = max(summary["elapsed_s"] - sum(
        summary["device_phase_s"].values()), 0.0)
    assert summary["completed"] == len(requests), (name, summary["completed"])
    for r in summary["results"]:
        req = requests[r.rid]
        assert len(r.tokens) == req.max_new_tokens, (name, r.rid)
        assert all(0 <= t < SERVE["vocab"] for t in r.tokens), name
    pool = summary["prefix_cache"]
    assert pool["hits"] > 0, (name, pool)
    lp_sum = sum(len(r.prompt) for r in requests)
    assert summary["prefill_tokens"] == lp_sum - pool["tokens_reused"], (
        name, summary["prefill_tokens"], lp_sum, pool)
    paged = summary["paged"] or {}
    print(f"[serve] window {name} ({gpu}; {kv.kv_layout}, {kv.kv_dtype}): "
          f"completed={summary['completed']} "
          f"decode_iterations={summary['decode_iterations']} "
          f"prefill_chunks={summary['prefill_chunks']} "
          f"prefill_tokens={summary['prefill_tokens']} "
          f"paged_launches={counts[0]} int8_launches={counts[1]} "
          f"serve_tokens_per_sec={summary['serve_tokens_per_sec']:.3f} "
          f"ttft_p50_s={summary['serve_ttft_p50_s']:.5f} "
          f"ttft_p95_s={summary['serve_ttft_p95_s']:.5f} "
          f"itl_p50_s={summary['serve_itl_p50_s']:.6f} "
          f"itl_p95_s={summary['serve_itl_p95_s']:.6f} "
          f"serve_prefix_cache_hit_rate="
          f"{summary['serve_prefix_cache_hit_rate']:.4f} "
          f"serve_prefix_zero_copy_hit_rate="
          f"{summary['serve_prefix_zero_copy_hit_rate']} "
          f"cow_copies={paged.get('cow_copies')} "
          f"kv_bytes_per_slot={summary['serve_kv_bytes_per_slot']} "
          f"elapsed_s={summary['elapsed_s']:.4f} "
          f"dispatches={summary['dispatches']} "
          f"host_gap_s={summary['host_gap_s']:.4f}")
    print(f"[serve] window {name}: prefix_cache={json.dumps(pool)} "
          f"device_phase_s={json.dumps(summary['device_phase_s'])}")
    return summary, counts


def serve_phase(gpu: str) -> tuple[int, int]:
    """Windows M, P and Q on ``bench.py --serve``'s trace, the
    cross-checks, ``generate`` and temperature checks, and the decode
    profiles; returns the paged kernel's launches in windows P and Q
    (all, and on the int8 route)."""
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    layers, slots, block = SERVE["layers"], SERVE["slots"], SERVE["block"]
    model = _serve_model()
    shared, requests = _bench_trace()
    pool = dict(prefix_cache_blocks=SERVE["pool"], prefix_block=block)

    # M: the default table of bench.py --serve: monolithic, prefix pool
    mono = SlotKVCache(model, None, slots, **pool)
    m, (launches, _, _) = _serve_window("M", mono, requests, gpu)
    assert launches == 0, launches
    assert m["paged"] is None and m["serve_kv_blocks_in_use"] is None

    # P: the same trace on the paged table, the same pool (zero copy)
    kv = SlotKVCache(model, None, slots, kv_layout="paged",
                     paged_block=block, **pool)
    p, (p_launches, p_int8, _) = _serve_window("P", kv, requests, gpu)
    iters = p["decode_iterations"]
    assert p_launches == layers * iters and p_int8 == 0, (p_launches, iters)
    assert p["paged"]["zero_copy_blocks"] == p["prefix_cache"]["hits"]
    # the warm-up left requests 0 and 1 pooled, block-aligned at 80 and 40
    # tokens: each admission here reuses all but the last token and writes
    # that one into a shared block
    assert p["paged"]["cow_copies"] >= 1, p["paged"]
    assert kv.blocks_in_use == p["prefix_cache"]["cached_blocks"], (
        kv.blocks_in_use, p["prefix_cache"])
    kv.reset_prefix_cache()
    assert kv.blocks_in_use == 0, kv.blocks_in_use

    # Q: window P at int8 storage; every launch on the kernel's int8 route
    kv8 = SlotKVCache(model, None, slots, kv_layout="paged",
                      paged_block=block, kv_dtype="int8", **pool)
    q, (q_launches, q_int8, _) = _serve_window("Q", kv8, requests, gpu)
    assert q_launches == q_int8 == layers * q["decode_iterations"], (
        q_launches, q_int8, q["decode_iterations"])
    ratio = q["serve_kv_bytes_per_slot"] / p["serve_kv_bytes_per_slot"]
    assert ratio < 0.6, ratio
    agree = total = 0
    for a, b in zip(p["results"], q["results"]):
        agree += sum(x == y for x, y in zip(a.tokens, b.tokens))
        total += len(a.tokens)
    print(f"[serve] window Q vs P: kv_bytes_per_slot ratio {ratio:.4f} "
          f"(bound 0.6); greedy tokens equal at {agree}/{total} positions")

    for name, summary in (("M", m), ("P", p), ("Q", q)):
        SEEN[f"serve {name}"] = {"streams": _streams(summary),
                                 "itl_p50_s": summary["serve_itl_p50_s"]}
    verify_launches, kvk = spec_multi_windows(gpu, model, requests, m, p)
    _sampled_rounds_check(model, requests)

    _fused_vs_gather(model, kv, requests)
    _profile_decode(kv, "paged")
    for req in requests[:slots]:
        kvk.insert(req.prompt)
    _profile_rounds(kvk, "paged, multi_step 8")
    for req in requests[:slots]:
        kv8.insert(req.prompt)
    _profile_decode(kv8, "paged int8")
    xcheck = _cross_checks(model, requests)
    _prefill_parity(model, requests)
    _profile_decode(xcheck, "monolithic")
    _generate_check(model, shared)
    _temperature_check(model, requests)
    return p_launches + q_launches, q_int8, verify_launches


def _streams(summary) -> list[list[int]]:
    return [r.tokens for r in summary["results"]]


def _spec_ledger(name, summary) -> dict:
    """The speculative ledger's gate (accepted + rejected == proposed, in
    the run and per request) and its line."""
    spec = summary["speculative"]
    assert spec["proposed_tokens"] > 0, (name, spec)
    assert (spec["accepted_tokens"] + spec["rejected_tokens"]
            == spec["proposed_tokens"]), (name, spec)
    assert spec["accepted_tokens"] == sum(
        r.accepted_tokens for r in summary["results"]), name
    print(f"[serve] window {name}: serve_accept_rate="
          f"{summary['serve_accept_rate']:.4f} speculative="
          f"{json.dumps(spec)}")
    return spec


def _top2(model, prompt, stream, j):
    """The target's logits for generated token ``j`` of ``stream`` by
    single decode steps of a fresh monolithic table (whole-prompt prefill,
    then ``stream[:j]`` fed back): (top-2 gap, the logits)."""
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    table = SlotKVCache(model, None, SERVE["slots"])
    slot, _ = table.insert(prompt)
    table.tokens[slot] = stream[0]
    for i in range(1, j):
        table.advance()
        table.tokens[slot] = stream[i]
    logits = table.decode_logits()[slot].float()
    top = logits.topk(2).values
    return float(top[0] - top[1]), logits


def _first_difference(name, model, requests, base, summary,
                      base_name="M") -> bool:
    """Whether ``summary``'s greedy streams are bitwise ``base``'s; where
    they are not, where they first leave them: the request, the position,
    both tokens, and the target's top-2 gap there (``_top2``)."""
    diffs = [(next(j for j, (a, b) in enumerate(zip(x.tokens, y.tokens))
                   if a != b), x.rid)
             for x, y in zip(base["results"], summary["results"])
             if x.tokens != y.tokens]
    total = sum(len(r.tokens) for r in base["results"])
    agree = sum(a == b for x, y in zip(base["results"], summary["results"])
                for a, b in zip(x.tokens, y.tokens))
    if not diffs:
        print(f"[serve] window {name} vs {base_name}: every stream bitwise "
              f"equal ({total}/{total} tokens)")
        return True
    j, rid = min(diffs)
    want = base["results"][rid].tokens
    got = summary["results"][rid].tokens
    gap, logits = _top2(model, requests[rid].prompt, want, j)
    print(f"[serve] window {name} vs {base_name}: {len(diffs)}/"
          f"{len(requests)} streams differ, {agree}/{total} tokens equal; "
          f"first at request {rid} token {j}: {base_name} {want[j]}, {name} "
          f"{got[j]}; the target's top-2 logit gap there {gap:.5f}, "
          f"logit({base_name}) - logit({name}) "
          f"{float(logits[want[j]] - logits[got[j]]):.5f} (single decode "
          f"steps of a fresh table)")
    return False


def spec_multi_windows(gpu, model, requests, m, p):
    """Windows S-self (monolithic, draft 'self', draft_k 4), S-small
    (paged, a 1-layer draft of its own seed, draft_k 4, multi_step 4: the
    draft's proposals are fused rounds) and K (paged, multi_step 8, rounds
    replayed as CUDA graphs) on the same trace and pool as M and P;
    returns the ``l_q > 1`` paged launches of S-small and K's table."""
    from collections import Counter

    from distributed_tensorflow_tpu_torch.serving import SlotKVCache
    from distributed_tensorflow_tpu_torch.serving.decode_graph import (
        RoundGraph)
    from distributed_tensorflow_tpu_torch.utils.harness import (
        parse_draft_config)

    layers, slots, block = SERVE["layers"], SERVE["slots"], SERVE["block"]
    pool = dict(prefix_cache_blocks=SERVE["pool"], prefix_block=block)

    # S-self: the draft is the served model (accept rate 1 in exact
    # arithmetic); its table is the draft's own, without a pool
    assert parse_draft_config("self") is None
    s_self, (launches, _, _) = _serve_window(
        "S-self", SlotKVCache(model, None, slots, **pool), requests, gpu,
        draft_kv=SlotKVCache(model, None, slots), draft_k=4)
    assert launches == 0, launches
    _spec_ledger("S-self", s_self)
    # the verify's columns are bitwise decode steps (by_column), so the
    # speculative streams are bitwise the plain ones
    assert _first_difference("S-self", model, requests, m, s_self), (
        "window S-self's streams differ from M's")

    # S-small: a 1-layer draft of the served widths, weights from seed 1
    draft = _serve_model(seed=1, **parse_draft_config("layers=1"))
    kv = SlotKVCache(model, None, slots, kv_layout="paged",
                     paged_block=block, **pool)
    widths = Counter()
    verify = kv.verify_block

    def counted(block_):
        widths[block_.shape[1]] += 1
        return verify(block_)

    kv.verify_block = counted
    small, (launches, _, verify_launches) = _serve_window(
        "S-small", kv, requests, gpu, before_main=widths.clear,
        draft_kv=SlotKVCache(draft, None, slots), draft_k=4, multi_step=4)
    spec = _spec_ledger("S-small", small)
    assert spec["rejected_tokens"] > 0, spec
    # a verify of width w reads the pool one query column at a time: w
    # launches per layer at l_q = 1, none at l_q > 1
    assert verify_launches == 0, verify_launches
    assert widths[5] > 0, widths
    single = small["decode_iterations"] - sum(widths.values())
    columns = sum(w * n for w, n in widths.items())
    assert launches == layers * (columns + single), (launches, single)
    print(f"[serve] window S-small: verify rounds by width "
          f"{dict(sorted(widths.items()))}; paged launches {launches}: "
          f"{layers * columns} in verify columns, {layers * single} in "
          f"single steps, all at l_q = 1")
    assert _first_difference("S-small", model, requests, p, small,
                             base_name="P"), (
        "window S-small's streams differ from P's")

    # K: fused rounds of 8 steps, pipelined one ahead, each a graph replay
    kvk = SlotKVCache(model, None, slots, kv_layout="paged",
                      paged_block=block, **pool)
    graphs0 = RoundGraph.captures
    mark = {}

    def before_k():
        mark["captures"], mark["replays"] = (RoundGraph.captures,
                                             RoundGraph.replays)

    k, (launches, _, _) = _serve_window("K", kvk, requests, gpu,
                                        before_main=before_k, multi_step=8)
    rounds = k["serve_dispatches"] - k["prefill_chunks"]
    replays = RoundGraph.replays - mark["replays"]
    assert RoundGraph.captures - graphs0 == 1, RoundGraph.captures - graphs0
    assert RoundGraph.captures == mark["captures"]
    assert replays == rounds > 0, (replays, rounds)
    assert launches == layers * 8 * rounds, (launches, rounds)
    assert _streams(k) == _streams(p), "window K's streams differ from P's"
    print(f"[serve] window K vs P ({gpu}): streams bitwise equal; "
          f"dispatches {k['dispatches']} vs {p['dispatches']}, host_gap_s "
          f"{k['host_gap_s']:.4f} vs {p['host_gap_s']:.4f}, "
          f"serve_host_gap_s {k['serve_host_gap_s']:.4f}, tokens/s "
          f"{k['serve_tokens_per_sec']:.3f} vs "
          f"{p['serve_tokens_per_sec']:.3f}, decode_iterations "
          f"{k['decode_iterations']} vs {p['decode_iterations']}; rounds "
          f"{rounds}, every one a graph replay (1 capture in the warm-up)")
    return verify_launches, kvk


def _sampled_rounds_check(model, requests) -> None:
    """Temperature 0.8 at a seed on two paged tables holding the trace's
    first 8 prompts: three rounds of 4 (eager, captured, replayed) draw
    the tokens of 12 single steps."""
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache
    from distributed_tensorflow_tpu_torch.serving.decode_graph import (
        RoundGraph)

    def table():
        kv = SlotKVCache(model, None, SERVE["slots"], kv_layout="paged",
                         paged_block=SERVE["block"], greedy=False,
                         temperature=0.8,
                         generator=torch.Generator("cuda").manual_seed(0))
        for req in requests[:SERVE["slots"]]:
            kv.insert(req.prompt)
        return kv

    single, fused = table(), table()
    want = np.stack([single.advance() for _ in range(12)])
    replays = RoundGraph.replays
    got = np.concatenate([fused.advance_multi(4)[0] for _ in range(3)])
    assert RoundGraph.replays - replays == 2
    assert np.array_equal(got, want), "sampled rounds differ from k = 1"
    print(f"[serve] temperature 0.8, seed 0, paged: 3 rounds of 4 (eager, "
          f"captured, replayed) equal 12 single steps ({got.size} tokens)")


def _verify_cost(model, requests) -> None:
    """Device ms of a draft_k = 4 verify (width 5) on the paged table (the
    kernel's layout; the monolithic one's read is the dense attention, its
    GEMMs the same), the trace's first 8 prompts in the table: by query
    column (the served verify, bitwise decode steps) beside one forward
    over all 40 rows (the verify before: other GEMM and paged-kernel
    shapes than a decode step), and one decode step; and how many of the
    one-forward verify's logits equal the column verify's bitwise."""
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    slots = SERVE["slots"]
    width = 5
    rng = np.random.default_rng(5)
    for layout in ("paged",):
        kv = SlotKVCache(model, None, slots, kv_layout=layout,
                         **({"paged_block": SERVE["block"]}
                            if layout == "paged" else {}))
        for req in requests[:slots]:
            kv.insert(req.prompt)
        block = rng.integers(0, SERVE["vocab"], (slots, width)).astype(
            np.int32)
        block[:, 0] = kv.tokens

        def one_forward():
            d_len = kv._dev_cached("lengths", kv.lengths)
            pos = d_len[:, None] + torch.arange(
                width, dtype=torch.int32, device=kv.device)[None, :]
            return kv._step_forward(kv._upload(block.astype(np.int64)), pos,
                                    kv._decode_bt(kv.active))

        fns = {"by column": lambda: kv.verify_logits(block),
               "one forward": one_forward,
               "decode step": kv.decode_logits}
        # 5 calls a profiler session: a call is ~400-1000 kernels, and
        # the sessions' processing, not the calls, set this check's wall
        dev = {n: _device_ms(fn, iters=5, warmup=3,
                             label=f"verify {layout} {n}")
               for n, fn in fns.items()}
        wall = {n: _time_windows(fn, iters=20, warmup=3)[0]
                for n, fn in fns.items()}
        cols, whole = kv.verify_logits(block), one_forward()
        same = int((cols == whole).all(-1).sum())
        print(f"[serve] verify cost, {layout}, draft_k 4 (width 5, 8 "
              f"slots): device ms by column {dev['by column']:.4f} (call "
              f"{wall['by column']:.4f}), one forward "
              f"{dev['one forward']:.4f} (call {wall['one forward']:.4f}), "
              f"a decode step {dev['decode step']:.4f} (call "
              f"{wall['decode step']:.4f}); one forward's logit rows "
              f"bitwise the columns' at {same}/{slots * width}")


def _prefill_parity(model, requests) -> None:
    """Chunked prefill at the smoke's chunk and at a second size, on the
    monolithic table, held bitwise: the first decode step's logits after a
    warm admission (the prefix pool restores its blocks, the rest is
    prefilled in chunks) against the cold one, and the cursor mode's
    logits at the last prompt position (8 equal-length prompts, one
    forward per chunk for all 8) against the table's chunked prefill of
    each prompt."""
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    slots, block = SERVE["slots"], SERVE["block"]
    prompts = [r.prompt for r in requests[:slots]]
    shared = requests[0].prompt[:16]
    rng = np.random.default_rng(3)
    equal = np.stack([np.concatenate([shared, rng.integers(
        0, SERVE["vocab"], 21).astype(np.int32)]) for _ in range(slots)])
    lp = equal.shape[1]
    for chunk in (SERVE["chunk"], 8):
        pooled = SlotKVCache(model, None, slots,
                             prefix_cache_blocks=SERVE["pool"],
                             prefix_block=block)

        def admit(table, ps):
            for p in ps:
                slot, _ = table.begin_insert(p)
                while table.prefill_chunk(slot, chunk) is None:
                    pass

        admit(pooled, prompts)
        cold = pooled.decode_logits().clone()
        hits = pooled.prefix_cache_stats()["hits"]
        for s in range(slots):
            pooled.evict(s)
        admit(pooled, prompts)
        assert pooled.prefix_cache_stats()["hits"] > hits
        warm = pooled.decode_logits()

        cache = model.init_cache(slots)
        ids = torch.from_numpy(equal).to(cache[0]["cached_key"].device)
        with torch.no_grad():
            for c0 in range(0, lp, chunk):
                cursor, cache = model(ids[:, c0:c0 + chunk], cache=cache)
        table = SlotKVCache(model, None, slots)
        last = []
        for p in equal:
            slot, _ = table.begin_insert(p)
            filled = 0
            while filled < lp:
                n = min(chunk, lp - filled)
                logits = table._prefill_forward(
                    slot, p[None, filled:filled + n],
                    np.arange(filled, filled + n, dtype=np.int32)[None])
                filled += n
            last.append(logits[0, -1])
            table.abort_insert(slot)
        torch.cuda.synchronize()
        for what, got, want in (("warm vs cold pool", warm, cold),
                                ("cursor vs monolithic prefill",
                                 cursor[:, -1], torch.stack(last))):
            same = int((got == want).all(-1).sum())
            err = float((got - want).abs().max())
            print(f"[serve] chunked prefill at chunk {chunk}: {what}: "
                  f"{same}/{slots} logit rows bitwise equal, max abs "
                  f"difference {err:.4e}")
            assert same == slots, (chunk, what, same, err)


def _fused_vs_gather(model, kv, requests) -> None:
    """First decode step's logits: the paged fused table vs a gather twin
    holding the same prompts (prefill writes identical pools on both)."""
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    slots = SERVE["slots"]
    twin = SlotKVCache(model, None, slots, kv_layout="paged",
                       paged_block=SERVE["block"], paged_fused=False)
    for table in (kv, twin):
        for req in requests[:slots]:
            table.insert(req.prompt)
    fused = kv.decode_logits()
    gather = twin.decode_logits()
    torch.cuda.synchronize()
    assert fused.shape == (slots, SERVE["vocab"])
    assert bool(fused.isfinite().all())
    _close_logits("paged fused vs gather", fused, gather)


def _close_logits(label, got, want) -> float:
    err = float((got - want).abs().max())
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"[serve] {label} logits: max_abs_err={err:.4e} (bound "
          f"{LOGIT_ATOL}), bitwise equal {bool(torch.equal(got, want))}, "
          f"greedy agreement {agree}/{got.shape[0]}, logit scale "
          f"{float(want.abs().max()):.3f}")
    assert err <= LOGIT_ATOL, (label, err)
    return err


def _cross_checks(model, requests):
    """The trace's first 8 prompts: first-decode-step logits of the
    monolithic table (dense read) against the paged fused table, and of a
    warm prefix pool (the prompts admitted and evicted once) against the
    cold admission.  Returns the monolithic table, 8 slots active."""
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    slots, block = SERVE["slots"], SERVE["block"]
    prompts = [r.prompt for r in requests[:slots]]
    mono = SlotKVCache(model, None, slots)
    paged = SlotKVCache(model, None, slots, kv_layout="paged",
                        paged_block=block)
    for table in (mono, paged):
        for p in prompts:
            table.insert(p)
    _close_logits("monolithic (dense) vs paged fused", mono.decode_logits(),
                  paged.decode_logits())
    pooled = SlotKVCache(model, None, slots, prefix_cache_blocks=SERVE["pool"],
                         prefix_block=block)
    for p in prompts:
        pooled.insert(p)
    cold = pooled.decode_logits().clone()
    before = pooled.prefix_cache_stats()["hits"]
    for s in range(slots):
        pooled.evict(s)
    for p in prompts:
        pooled.insert(p)
    warm_hits = pooled.prefix_cache_stats()["hits"] - before
    assert warm_hits > 0, warm_hits
    print(f"[serve] warm pool re-admission: {warm_hits} block hits")
    _close_logits("monolithic warm pool vs cold", pooled.decode_logits(),
                  cold)
    return mono


def _generate_check(model, shared) -> None:
    """Eight prompts of the shared prefix plus 16 tokens: the cursor mode's
    logits at the first generated position against the monolithic table's
    prefill logits, and ``generate(greedy=True)``'s 64 tokens against the
    table's stream (agreement printed)."""
    from distributed_tensorflow_tpu_torch.models.gpt import generate
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    slots = SERVE["slots"]
    rng = np.random.default_rng(1)
    prompts = np.stack([np.concatenate([shared, rng.integers(
        0, SERVE["vocab"], 16).astype(np.int32)]) for _ in range(slots)])
    lp = prompts.shape[1]
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(prompts).cuda().long(),
                          cache=model.init_cache(slots))
    table = SlotKVCache(model, None, slots)
    prefill = []
    for p in prompts:
        slot, _ = table.begin_insert(p)
        prefill.append(table._prefill_forward(
            slot, p[None], np.arange(lp, dtype=np.int32)[None])[0, -1])
    _close_logits("cursor (generate) vs monolithic prefill", logits[:, -1],
                  torch.stack(prefill))
    t0 = time.perf_counter()
    gen = generate(model, None, prompts, 64, greedy=True).cpu().numpy()
    gen_s = time.perf_counter() - t0
    table = SlotKVCache(model, None, slots)
    stream = [[table.insert(p)[1]] for p in prompts]
    for _ in range(63):
        toks = table.advance()
        for s in range(slots):
            stream[s].append(int(toks[s]))
    stream = np.asarray(stream)
    assert gen.shape == stream.shape == (slots, 64)
    assert ((gen >= 0) & (gen < SERVE["vocab"])).all()
    print(f"[serve] generate(greedy=True) vs the monolithic table over 64 "
          f"new tokens: {int((gen == stream).sum())}/{gen.size} equal, "
          f"{int((gen == stream).all(1).sum())}/{slots} whole streams "
          f"equal; generate took {gen_s:.3f} s")


def _temperature_check(model, requests) -> None:
    """A 0.8-temperature window of 8 requests twice from the same seed:
    identical streams, every id in range."""
    from distributed_tensorflow_tpu_torch.serving import (
        ContinuousBatcher, SlotKVCache)

    def run():
        kv = SlotKVCache(model, None, SERVE["slots"], greedy=False,
                         temperature=0.8,
                         generator=torch.Generator("cuda").manual_seed(0))
        res = ContinuousBatcher(kv, prefill_chunk=SERVE["chunk"]).run(
            requests[:8])
        return [r.tokens for r in res["results"]]

    a, b = run(), run()
    assert a == b, "same seed, different streams"
    assert all(0 <= t < SERVE["vocab"] for toks in a for t in toks)
    greedy = [r.tokens for r in ContinuousBatcher(
        SlotKVCache(model, None, SERVE["slots"]),
        prefill_chunk=SERVE["chunk"]).run(requests[:8])["results"]]
    same = sum(x == y for s, g in zip(a, greedy) for x, y in zip(s, g))
    print(f"[serve] temperature 0.8 window, 8 requests, twice from seed "
          f"0: streams identical; {same}/{sum(map(len, a))} tokens equal "
          f"the greedy window's")


CNN_ARGV = ["-m", "c", "-cs", "sync", "-n", "1", "-b", "32", "--model",
            "cnn", "--dataset", "mnist", "--log-every", "0"]
SUMMARY_KEYS = {"engine", "model", "dataset", "synthetic_data", "n_devices",
                "data_parallel", "global_batch", "epochs", "steps",
                "steps_per_call", "prefetch_depth", "elapsed_s",
                "examples_per_sec", "examples_per_sec_per_device",
                "test_accuracy", "test_loss"}


def _cli(argv, dataset_fn=None):
    """``cli.main(argv)`` with its stdout captured: (summary, heartbeat
    lines)."""
    from distributed_tensorflow_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = cli.main(argv, dataset_fn=dataset_fn)
    lines = out.getvalue().splitlines()
    assert json.loads(lines[-1]) == summary
    return summary, [line for line in lines[:-1] if line.startswith("step ")]


def _recorded_cli(argv, *, cudnn_default: bool = False,
                  steps_per_call: int = 8, dataset_fn=None) -> dict:
    """``_cli(argv)`` that also keeps the run's per-step losses (every
    chunk's, in step order), its final parameters and buffers as one
    flat f32 buffer, its trainer and the summary of its serve window
    (``serve_summary``, with the per-request results that the serve
    section drops; None without one).  ``cudnn_default``: the run with
    cuDNN at torch's defaults (deterministic off; TF32 still off), as
    ``harness.run`` ran before it held cuDNN deterministic."""
    from distributed_tensorflow_tpu_torch import cli, serving
    from distributed_tensorflow_tpu_torch.utils import harness

    kept = {"losses": [], "serve": None}

    class Served(serving.ContinuousBatcher):
        def run(self, *args, **kw):
            kept["serve"] = summary = super().run(*args, **kw)
            kept["serve_kv"] = self.kv
            return summary

    class Recorder(harness.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            kept["trainer"] = self
            chunk, single = self.engine.many_step, self.engine.step
            inside = []

            def many_step(*a, **k):
                inside.append(True)
                try:
                    state, metrics = chunk(*a, **k)
                finally:
                    inside.pop()
                kept["losses"].append(metrics["loss"].detach().reshape(-1)
                                      .clone())
                return state, metrics

            def step(*a, **k):
                # a step of its own (steps_per_call 1), not one of a chunk
                state, metrics = single(*a, **k)
                if not inside:
                    kept["losses"].append(metrics["loss"].detach()
                                          .reshape(-1).clone())
                return state, metrics

            self.engine.many_step, self.engine.step = many_step, step

    def default_cudnn_run(config):
        m, c = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = m.allow_tf32, c.allow_tf32, c.deterministic, c.benchmark
        m.allow_tf32 = c.allow_tf32 = c.deterministic = c.benchmark = False
        try:
            return harness.run.__wrapped__(config)
        finally:
            m.allow_tf32, c.allow_tf32, c.deterministic, c.benchmark = saved

    trainer, batcher = harness.Trainer, serving.ContinuousBatcher
    harness.Trainer, serving.ContinuousBatcher = Recorder, Served
    if cudnn_default:
        cli.run = default_cudnn_run
    try:
        summary, _ = _cli(argv, dataset_fn=dataset_fn)
    finally:
        harness.Trainer, cli.run = trainer, harness.run
        serving.ContinuousBatcher = batcher
    state = kept["trainer"].state
    assert summary["steps_per_call"] == steps_per_call, summary
    params = torch.cat([t.detach().float().reshape(-1)
                        for t in state.model.state_dict().values()])
    losses = torch.cat(kept["losses"])
    assert losses.numel() == summary["steps"], (losses.shape, summary)
    return {"summary": summary, "losses": losses, "params": params,
            "trainer": kept["trainer"], "serve_summary": kept["serve"],
            "serve_kv": kept.get("serve_kv")}


def repeat_phase(gpu: str) -> list[str]:
    """One seed gives one run: configs 1 (the CNN window), 3 and 5 at f32
    through ``cli.main`` twice each, whose per-step losses, final
    parameters (one flat f32 buffer of the state dict) and test accuracy
    and loss must be bitwise equal; then, where the config has
    convolutions, once with cuDNN at torch's defaults, for the examples/s
    the deterministic algorithms cost.  Returns the failures (raised by
    ``main`` after the timings)."""
    failures = []
    for name, argv, convs in (
            ("config 1 (CNN, sync)", CNN_ARGV, True),
            ("config 3 (ResNet-20, async)", C3_ARGV, True),
            ("config 5 (BERT-tiny, f32, flash)", BERT_ARGV, False)):
        a, b = _recorded_cli(argv), _recorded_cli(argv)
        # cuDNN's defaults move only convolutions: BERT has none
        free = _recorded_cli(argv, cudnn_default=True) if convs else a
        sa, sb, sf = a["summary"], b["summary"], free["summary"]
        checks = {
            "losses": torch.equal(a["losses"], b["losses"]),
            "params": torch.equal(a["params"], b["params"]),
            "test_accuracy": sa["test_accuracy"] == sb["test_accuracy"],
            "test_loss": sa["test_loss"] == sb["test_loss"]}
        diff = (a["losses"] != b["losses"]).nonzero()
        first = int(diff[0]) if len(diff) else None
        default_same = (torch.equal(a["losses"], free["losses"])
                        and torch.equal(a["params"], free["params"]))
        print(f"[repeat] {gpu}: {name}, {sa['steps']} steps, seed 0, "
              f"twice: bitwise equal {json.dumps(checks)} (first differing "
              f"step {first}); test_accuracy {sa['test_accuracy']:.6f} / "
              f"{sb['test_accuracy']:.6f}; examples_per_sec "
              f"{sa['examples_per_sec']:.1f} / {sb['examples_per_sec']:.1f}"
              + (f" deterministic, {sf['examples_per_sec']:.1f} with cuDNN "
                 f"at its defaults (test_accuracy "
                 f"{sf['test_accuracy']:.6f}, losses and params bitwise the "
                 f"deterministic run's: {default_same})" if convs else
                 " (no convolution: cuDNN's defaults not run)"))
        if not all(checks.values()):
            failures.append(f"{name}: {checks}")
    return failures


def cnn_phase(gpu: str) -> dict:
    """The MNIST CNN through the CLI on an NCCL group of one rank,
    steps-to-97%, and the MLP's drain at k=1 against k=8."""
    from distributed_tensorflow_tpu_torch.engines.sync import _ChunkGraph
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll
    from distributed_tensorflow_tpu_torch.utils.harness import (
        ExperimentConfig, steps_to_accuracy)

    coll.all_reduce_.launches = coll.all_reduce_.nccl_launches = 0
    graphs = _ChunkGraph.captures, _ChunkGraph.replays
    summary, _ = _cli(CNN_ARGV)
    nccl = coll.all_reduce_.nccl_launches
    # 32 chunks of 8: the first eager, the second captured, every chunk
    # after the first replayed
    graphs = (_ChunkGraph.captures - graphs[0],
              _ChunkGraph.replays - graphs[1])
    assert graphs == (1, summary["steps"] // 8 - 1), graphs
    missing = SUMMARY_KEYS - set(summary)
    assert not missing, missing
    steps = summary["steps"]
    assert summary["synthetic_data"] is True, summary
    assert (steps, summary["global_batch"], summary["steps_per_call"],
            summary["prefetch_depth"]) == (256, 32, 8, 2), summary
    # the fit's nan guard read the last step's loss; the eval's loss too
    assert np.isfinite(summary["test_loss"]), summary
    assert summary["test_accuracy"] >= 0.97, summary
    # one gradient all-reduce per step, one for the final evaluate
    assert nccl == coll.all_reduce_.launches == steps + 1, (nccl, steps)
    rr = summary["run_report"]
    print(f"[cnn] {gpu}: -m c -cs sync -n 1 -b 32 --model cnn --dataset "
          f"mnist: steps={steps} examples_per_sec="
          f"{summary['examples_per_sec']:.1f} step_ms_p50="
          f"{rr['step_time_p50_s'] * 1e3:.4f} step_ms_p95="
          f"{rr['step_time_p95_s'] * 1e3:.4f} first_chunk_s="
          f"{rr['compile_s']:.4f} elapsed_s={summary['elapsed_s']:.4f} "
          f"test_accuracy={summary['test_accuracy']:.6f} test_loss="
          f"{summary['test_loss']:.6f} nccl_allreduce_launches={nccl} "
          f"({nccl / steps:.4f} per step) graph captures/replays="
          f"{graphs[0]}/{graphs[1]}")

    # the same window under bf16-f32master: bf16 parameters, f32 master;
    # the 16-bit gradients and the f32 metrics take one all-reduce each
    coll.all_reduce_.launches = coll.all_reduce_.nccl_launches = 0
    bf16, _ = _cli(CNN_ARGV + ["--precision", "bf16-f32master"])
    nccl16 = coll.all_reduce_.nccl_launches
    rr16 = bf16["run_report"]
    assert bf16["precision"] == rr16["precision"] == "bf16-f32master"
    assert bf16["steps"] == steps and bf16["test_accuracy"] >= 0.97, bf16
    assert nccl16 == 2 * steps + 1, (nccl16, steps)
    assert 2 * rr16["param_bytes_per_device"] == rr[
        "param_bytes_per_device"], (rr16, rr)
    print(f"[cnn] {gpu}: ... --precision bf16-f32master: steps={steps} "
          f"examples_per_sec={bf16['examples_per_sec']:.1f} step_ms_p50="
          f"{rr16['step_time_p50_s'] * 1e3:.4f} step_ms_p95="
          f"{rr16['step_time_p95_s'] * 1e3:.4f} test_accuracy="
          f"{bf16['test_accuracy']:.6f} test_loss={bf16['test_loss']:.6f} "
          f"param_bytes={rr16['param_bytes_per_device']} (f32 "
          f"{rr['param_bytes_per_device']}) opt_state_bytes="
          f"{rr16['opt_state_bytes_per_device']} (f32 "
          f"{rr['opt_state_bytes_per_device']}) nccl_allreduce_launches="
          f"{nccl16}")

    cfg = ExperimentConfig(engine="sync", model="cnn", dataset="mnist",
                           n_devices=1, batch_size=32)
    reach = steps_to_accuracy(cfg, 0.97)
    assert reach["reached"], reach
    print(f"[cnn] {gpu}: steps_to_97pct={reach['steps']} "
          f"step_resolution={reach['step_resolution']} accuracy="
          f"{reach['accuracy']:.6f} elapsed_s={reach['elapsed_s']:.4f} "
          f"synthetic={reach['synthetic']}")

    # k=1, 8, 8, 1: the pairs' spread says how far one reading of a
    # host-bound wall metric can be trusted
    beats = []
    for k in (1, 8, 8, 1):
        mlp, lines = _cli(["-m", "d", "-ds", "keras", "-n", "1", "-b", "32",
                           "--model", "mlp", "--dataset", "mnist",
                           "--log-every", "16", "--steps-per-call", str(k)])
        assert mlp["engine"] == "allreduce" and mlp["steps_per_call"] == k
        beats.append(lines)
        print(f"[cnn] {gpu}: -m d -ds keras --model mlp --steps-per-call "
              f"{k}: examples_per_sec={mlp['examples_per_sec']:.1f} "
              f"step_ms_p50="
              f"{mlp['run_report']['step_time_p50_s'] * 1e3:.4f} "
              f"test_accuracy={mlp['test_accuracy']:.6f}")
    losses = [float(line.split()[3]) for line in beats[0]]
    assert all(b == beats[0] for b in beats) and len(losses) == 16, beats
    assert all(np.isfinite(losses)), losses
    print(f"[cnn] MLP heartbeats identical in all four runs ({len(losses)} "
          f"lines): losses {' '.join(f'{v:.4f}' for v in losses)}")
    return summary


# BASELINE config 3: ResNet-20 on CIFAR-10 under the async engine.  The
# CPU rehearsal of the same command (``--device cpu``) reaches test
# accuracy 0.96631 (loss 0.13729) after 256 steps.  Rounding alone moves
# it by a point (the same run with the pads outside the convolutions
# read 0.97119), and the card's convolutions sum in other orders, so the
# gate allows 0.05.
C3_ARGV = ["-m", "c", "-cs", "async", "-n", "1", "-b", "32", "--model",
           "resnet20", "--dataset", "cifar10", "--log-every", "0"]
C3_CPU_ACCURACY, C3_ACCURACY_MARGIN = 0.96630859375, 0.05
# BASELINE config 4: the MLP under gossip, ``-ds custom`` and ``-ds graph``
C4_ARGV = ["-m", "d", "-ds", "{}", "-d", "1", "-n", "1", "-b", "32",
           "--model", "mlp", "--dataset", "fashion_mnist", "--log-every",
           "16"]
# ResNet-20 on the card against the CPU (f32, TF32 off, the same
# parameters and batch, the card's ReLUs on the CPU's masks): f32 sums in
# other orders, cuDNN's algorithms among them
RESNET_LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
RESNET_GRAD_FROBENIUS = 1e-4


def _resnet_card_vs_cpu(gpu: str) -> None:
    """ResNet-20's logits and one step's gradients on the card against
    the CPU.  A ReLU input within the devices' rounding difference of 0
    may take the other side of its kink on each, moving the gradients
    upstream by ~1e-3: the card applies the CPU forward's ReLU masks,
    checked against its own signs wherever an input is farther than 1e-5
    from 0."""
    from distributed_tensorflow_tpu_torch.data import load_dataset
    from distributed_tensorflow_tpu_torch.engines.base import cross_entropy
    from distributed_tensorflow_tpu_torch.models import create_model

    ds = load_dataset("cifar10")
    x, y = torch.from_numpy(ds.x[:32]), torch.from_numpy(ds.y[:32])
    ref = create_model("resnet20", device="cpu")
    with torch.no_grad():
        ref(x[:1])
    ref.reset_parameters(torch.Generator().manual_seed(0))
    state_dict = ref.state_dict()
    relu = torch.relu

    def run(device, masks=None):
        model = create_model("resnet20", device=device)
        with torch.no_grad():
            model(x[:1].to(device))
        model.load_state_dict(state_dict)
        seen, given = [], iter(masks or [])

        def masked(v):
            own = v.detach() > 0
            seen.append(own.cpu())
            if masks is None:
                return v * own
            mask = next(given).to(v.device)
            far = v.detach().abs() > 1e-5
            assert torch.equal(own[far], mask[far]), "ReLU signs differ"
            return v * mask

        torch.relu = masked
        try:
            logits = model(x.to(device))
        finally:
            torch.relu = relu
        cross_entropy(logits, y.to(device)).mean().backward()
        return (logits.detach().cpu(),
                {n: p.grad.cpu() for n, p in model.named_parameters()}, seen)

    want_logits, want, masks = run("cpu")
    got_logits, got, _ = run("cuda", masks)
    assert len(masks) == 19, len(masks)
    torch.testing.assert_close(got_logits, want_logits, **RESNET_LOGITS_TOL)
    errs = {n: float((got[n] - w).norm() / w.norm()) for n, w in want.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] < RESNET_GRAD_FROBENIUS, (worst, errs[worst])
    print(f"[local] {gpu}: ResNet-20 card vs CPU (B=32, f32, TF32 off): "
          f"logits max_abs_err="
          f"{(got_logits - want_logits).abs().max().item():.3e}; gradients "
          f"max relative Frobenius err={errs[worst]:.3e} ({worst}), "
          f"{len(errs)} tensors")


def local_phase(gpu: str) -> None:
    """BASELINE configs 3 and 4 through the CLI on an NCCL group of one
    rank: ResNet-20 under the async engine (one all-reduce per step, one
    for ``eval_params``, one for the eval totals); the MLP under gossip
    from ``-ds custom`` and ``-ds graph`` (on one rank the mix is the
    degenerate all-reduce, packed with the metrics), whose heartbeats
    must be identical; then ResNet-20 on the card against the CPU."""
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll

    coll.all_reduce_.launches = coll.all_reduce_.nccl_launches = 0
    coll.neighbor_mean.launches = 0
    summary, _ = _cli(C3_ARGV)
    nccl = coll.all_reduce_.nccl_launches
    missing = SUMMARY_KEYS - set(summary)
    assert not missing, missing
    steps = summary["steps"]
    assert summary["engine"] == "async" and summary["synthetic_data"], summary
    assert (steps, summary["global_batch"], summary["steps_per_call"],
            summary["prefetch_depth"]) == (256, 32, 8, 2), summary
    assert np.isfinite(summary["test_loss"]), summary
    assert summary["test_accuracy"] >= (C3_CPU_ACCURACY
                                        - C3_ACCURACY_MARGIN), summary
    # one per step (a parameter mean every 10th, the metrics otherwise),
    # eval_params, the eval totals
    assert nccl == coll.all_reduce_.launches == steps + 2, (nccl, steps)
    assert coll.neighbor_mean.launches == 0
    rr = summary["run_report"]
    print(f"[local] {gpu}: config 3: -m c -cs async -n 1 -b 32 --model "
          f"resnet20 --dataset cifar10 (sync_every 10): steps={steps} "
          f"examples_per_sec={summary['examples_per_sec']:.1f} "
          f"step_ms_p50={rr['step_time_p50_s'] * 1e3:.4f} step_ms_p95="
          f"{rr['step_time_p95_s'] * 1e3:.4f} first_chunk_s="
          f"{rr['compile_s']:.4f} elapsed_s={summary['elapsed_s']:.4f} "
          f"test_accuracy={summary['test_accuracy']:.6f} (CPU rehearsal "
          f"{C3_CPU_ACCURACY:.6f}) test_loss={summary['test_loss']:.6f} "
          f"nccl_allreduce_launches={nccl} (steps + 2)")

    beats = []
    for strategy in ("custom", "graph"):
        coll.all_reduce_.launches = coll.all_reduce_.nccl_launches = 0
        mlp, lines = _cli([a.format(strategy) for a in C4_ARGV])
        nccl = coll.all_reduce_.nccl_launches
        assert mlp["engine"] == "gossip", mlp
        assert nccl == coll.all_reduce_.launches == mlp["steps"] + 2, (
            nccl, mlp["steps"])
        assert coll.neighbor_mean.launches == 0
        beats.append(lines)
        print(f"[local] {gpu}: config 4: -m d -ds {strategy} -d 1 -n 1 -b "
              f"32 --model mlp --dataset fashion_mnist: steps="
              f"{mlp['steps']} examples_per_sec="
              f"{mlp['examples_per_sec']:.1f} step_ms_p50="
              f"{mlp['run_report']['step_time_p50_s'] * 1e3:.4f} "
              f"test_accuracy={mlp['test_accuracy']:.6f} "
              f"nccl_allreduce_launches={nccl} (steps + 2)")
    losses = [float(line.split()[3]) for line in beats[0]]
    assert beats[0] == beats[1] and len(losses) == 16, beats
    assert all(np.isfinite(losses)), losses
    print(f"[local] gossip heartbeats identical for custom and graph "
          f"({len(losses)} lines): losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}")
    _resnet_card_vs_cpu(gpu)


def _profile_step(label: str, engine: str, model: str, dataset: str,
                  steps: int = 16) -> None:
    """Where a train step's time goes (batch 32, 1-rank NCCL mesh):
    ``steps`` steps of ``engine`` on ``model`` on the host clock, then
    the same under ``torch.profiler``: the device's busy share, kernels per
    step and the top kernels."""
    from distributed_tensorflow_tpu_torch.data import load_dataset
    from distributed_tensorflow_tpu_torch.engines import create_engine
    from distributed_tensorflow_tpu_torch.models import create_model
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh

    ds = load_dataset(dataset)
    mesh = create_mesh(1)
    try:
        eng = create_engine(engine, create_model(model), mesh=mesh)
        state = eng.init_state(torch.Generator().manual_seed(0), ds.x[:1])
        xs, ys = eng.shard_batch(ds.x[:32], ds.y[:32])
        for _ in range(4):
            eng.step(state, xs, ys)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step(state, xs, ys)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / steps
        rows = _profiled(lambda: [eng.step(state, xs, ys)
                                  for _ in range(steps)], steps)
    finally:
        mesh.close()
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        print(f"[profile] no device time in the {label} trace: not measured")
        return
    nccl_us = sum(r[0] for r in rows if "nccl" in r[2].lower())
    print(f"[profile] {label} (B=32, f32, 1-rank NCCL): wall_ms="
          f"{wall_us / 1e3:.4f} device_busy_ms={busy_us / 1e3:.4f} "
          f"busy_share={busy_us / wall_us:.4f} "
          f"kernels_per_step={sum(r[1] for r in rows):.1f} "
          f"nccl_ms={nccl_us / 1e3:.4f}")
    for dev_us, count, key in rows[:10]:
        print(f"[profile]   {dev_us:9.2f} us/step x{count:<6.1f} {key[:80]}")


def _lm_data(rows: int):
    """bench.py --lm's tokens: default_rng(0) ids over 1025 positions,
    split into inputs and next-token labels."""
    tok = np.random.default_rng(0).integers(0, LM["vocab"],
                                            (rows, LM["seq"] + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _lm_model(attention_impl: str, dtype: str = "bfloat16",
              remat: bool = False, **kw):
    from distributed_tensorflow_tpu_torch.models import create_model

    return create_model("gpt", num_classes=LM["vocab"], hidden=LM["hidden"],
                        layers=LM["layers"], heads=LM["heads"],
                        ffn=LM["ffn"], max_len=LM["seq"], dropout_rate=0.0,
                        dtype=dtype, attention_impl=attention_impl,
                        remat=remat, **kw)


_FLASH_COUNTS = ("fwd", "dq", "dkv", "fwd_tc", "dq_tc", "dkv_tc")
_F16_COUNTS = ("fwd_f16", "dq_f16", "dkv_f16")
_TC32_COUNTS = ("fwd_tc32", "dq_tc32", "dkv_tc32")


def _flash_counts() -> dict:
    """Launches of each flash kernel (all routes), and of the tc route."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    return {n: getattr(fa.flash_attention, f"{n}_launches")
            for n in _FLASH_COUNTS}


def _reset_flash_counts() -> None:
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    for n in _FLASH_COUNTS + _F16_COUNTS + _TC32_COUNTS:
        setattr(fa.flash_attention, f"{n}_launches", 0)


def _tc32_counts() -> dict:
    """Launches of the tc32 (f32 tensor-core) kernels."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    return {n: getattr(fa.flash_attention, f"{n}_launches")
            for n in _TC32_COUNTS}


def _f16_counts() -> dict:
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    return {n: getattr(fa.flash_attention, f"{n}_launches")
            for n in _F16_COUNTS}


def precision_phase(gpu: str):
    """The GPT of ``bench.py --lm`` under ``bf16-f32master`` (16 steps at
    the Trainer's default 8 steps per call: the second epoch's chunk is a
    replayed CUDA graph), then under ``fp16-f32master`` for 4 steps.
    Returns the flash launches of the bf16 fit, of the fp16 fit (f16
    counters), and the bf16 trainer (profiled after the timings)."""
    from distributed_tensorflow_tpu_torch.data import Dataset
    from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer
    from distributed_tensorflow_tpu_torch.engines.sync import _ChunkGraph

    layers, batch = LM["layers"], LM["batch"]
    x, y = _lm_data(64 + 16)
    train_ds = Dataset(x=x[:64], y=y[:64], num_classes=LM["vocab"],
                       name="lm_bench")
    eval_ds = Dataset(x=x[64:], y=y[64:], num_classes=LM["vocab"],
                      name="lm_bench")
    model = _lm_model("flash")
    trainer = Trainer(model, engine=SyncEngine(
        model, precision="bf16-f32master"), seed=0)
    beats = []
    graphs = _ChunkGraph.captures, _ChunkGraph.replays
    _reset_flash_counts()
    result = trainer.fit(train_ds, epochs=2, batch_size=batch, log_every=1,
                         log_fn=beats.append)
    torch.cuda.synchronize()
    fit = _flash_counts()
    graphs = (_ChunkGraph.captures - graphs[0],
              _ChunkGraph.replays - graphs[1])
    losses = [float(line.split()[3]) for line in beats]
    assert result["steps"] == 16 and len(losses) == 16, result
    assert result["steps_per_call"] == 8 and graphs == (1, 1), graphs
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    n = layers * 16
    assert fit == {k: n for k in _FLASH_COUNTS}, fit
    opt = trainer.state.optimizer
    # the stored bf16 parameters are the downcast f32 master, bitwise
    assert torch.equal(opt.flat, opt.master.to(torch.bfloat16))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    ev = trainer.evaluate(eval_ds, batch_size=batch)
    assert np.isfinite(ev["loss"]) and ev["count"] == 16 * LM["seq"], ev
    st = result["step_time"]
    print(f"[precision] {gpu}: GPT bench --lm under bf16-f32master, "
          f"steps_per_call 8 (graph captures/replays {graphs[0]}/"
          f"{graphs[1]}): loss first={losses[0]:.4f} last={losses[-1]:.4f} "
          f"tokens_per_sec={result['examples_per_sec'] * LM['seq']:.1f} "
          f"step_ms_p50={st['steady_p50_s'] * 1e3:.3f} "
          f"first_chunk_s={st['compile_s']:.3f} "
          f"eval_loss={ev['loss']:.5f} param_bytes="
          f"{result['param_bytes_per_device']} opt_state_bytes="
          f"{result['opt_state_bytes_per_device']} "
          f"flash_launches_fit={json.dumps(fit)}")
    print(f"[precision] losses {' '.join(f'{v:.4f}' for v in losses)}")

    # fp16-f32master: 4 steps, every flash launch on the float16 tc route
    model16 = _lm_model("flash", "float16")
    trainer16 = Trainer(model16, engine=SyncEngine(
        model16, precision="fp16-f32master"), seed=0)
    beats16 = []
    _reset_flash_counts()
    r16 = trainer16.fit(train_ds, epochs=1, batch_size=batch, log_every=1,
                        max_steps=4, log_fn=beats16.append)
    torch.cuda.synchronize()
    fit16 = {**_flash_counts(), **_f16_counts()}
    n = layers * 4
    assert r16["steps"] == 4 and fit16 == {
        k: n for k in _FLASH_COUNTS + _F16_COUNTS}, fit16
    losses16 = [float(line.split()[3]) for line in beats16]
    ls = r16["loss_scale"]
    assert all(np.isfinite(losses16)), losses16
    assert ls["skipped_steps"] < 4, ls
    print(f"[precision] {gpu}: GPT under fp16-f32master: steps=4 losses "
          f"{' '.join(f'{v:.4f}' for v in losses16)} loss_scale="
          f"{json.dumps(ls)} flash_launches_fit={json.dumps(fit16)}")
    del trainer16, model16
    return fit, fit16, trainer, (x[:batch], y[:batch])


def _profile_chunk(label: str, engine, state, xs, ys, chunks: int = 4,
                   top: int = 6):
    """Where a replayed chunk's time goes: ``chunks`` replays of the
    engine's CUDA graph for ``len(xs)`` steps on the host clock, then under
    ``torch.profiler``: per step, the wall, the kernels' device time, the
    busy share and the kernels; beside it the CUDA-event time of a chunk
    (kernels and the gaps between them)."""
    k = len(xs)
    for _ in range(2):     # eager on a key's first chunk, then the capture
        engine.many_step(state, xs, ys)
    assert engine._graphs, "no graph captured"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        engine.many_step(state, xs, ys)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / (chunks * k)
    event_ms = _time_ms(lambda: engine.many_step(state, xs, ys),
                        iters=chunks, warmup=1) / k
    rows = _profiled(lambda: [engine.many_step(state, xs, ys)
                              for _ in range(chunks)], chunks * k)
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        print(f"[profile] {label}: no device time in the trace (not "
              f"measured); event_ms_per_step={event_ms:.4f} "
              f"wall_ms_per_step={wall_us / 1e3:.4f}")
        return
    SEEN[label] = {"wall_ms": wall_us / 1e3, "busy_share": busy_us / wall_us}
    print(f"[profile] {label}, replayed CUDA graph of {k} steps: "
          f"wall_ms_per_step={wall_us / 1e3:.4f} event_ms_per_step="
          f"{event_ms:.4f} device_busy_ms={busy_us / 1e3:.4f} "
          f"busy_share={busy_us / wall_us:.4f} "
          f"kernels_per_step={sum(r[1] for r in rows):.1f}")
    for dev_us, count, key in rows[:top]:
        print(f"[profile]   {dev_us:9.2f} us/step x{count:<6.1f} {key[:80]}")


def _profile_cnn_chunk() -> None:
    """The CNN window's step (B=32, f32, 1-rank NCCL) as a replayed chunk
    of 8."""
    from distributed_tensorflow_tpu_torch.data import load_dataset
    from distributed_tensorflow_tpu_torch.engines import create_engine
    from distributed_tensorflow_tpu_torch.models import create_model
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh

    ds = load_dataset("mnist")
    mesh = create_mesh(1)
    try:
        eng = create_engine("sync", create_model("cnn"), mesh=mesh)
        state = eng.init_state(torch.Generator().manual_seed(0), ds.x[:1])
        xs, ys = zip(*(eng.shard_batch(ds.x[32 * i:32 * i + 32],
                                       ds.y[32 * i:32 * i + 32])
                       for i in range(8)))
        _profile_chunk("CNN train step (B=32, f32, 1-rank NCCL)", eng, state,
                       list(xs), list(ys))
    finally:
        mesh.close()


def train_phase(gpu: str):
    """Full-width GPT LM training through SyncEngine and Trainer; returns
    the flash launches of the fit, of the evaluate call, and the steps."""
    from distributed_tensorflow_tpu_torch.data import Dataset
    from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer

    layers, batch = LM["layers"], LM["batch"]
    x, y = _lm_data(64 + 16)
    train_ds = Dataset(x=x[:64], y=y[:64], num_classes=LM["vocab"],
                       name="lm_bench")
    eval_ds = Dataset(x=x[64:], y=y[64:], num_classes=LM["vocab"],
                      name="lm_bench")
    model = _lm_model("flash")
    trainer = Trainer(model, engine=SyncEngine(model), seed=0)
    # one step per call: the heartbeat reads each step's loss as it is
    # dispatched (a host sync per step), so its timestamps mark when each
    # step finished on the device (a chunk of 8 would log its steps
    # together after one read)
    beats = []
    _reset_flash_counts()
    result = trainer.fit(train_ds, epochs=2, batch_size=batch, log_every=1,
                         steps_per_call=1,
                         log_fn=lambda line: beats.append(
                             (time.perf_counter(), line)))
    torch.cuda.synchronize()
    fit = _flash_counts()
    steps = result["steps"]
    losses = [float(line.split()[3]) for _, line in beats]
    assert steps == 16 and len(losses) == 16, (steps, len(losses))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    # every forward, dQ and dK/dV of the bf16 model on the tc route
    n = layers * steps
    assert fit == {"fwd": n, "dq": n, "dkv": n, "fwd_tc": n, "dq_tc": n,
                   "dkv_tc": n}, fit
    _reset_flash_counts()
    ev = trainer.evaluate(eval_ds, batch_size=batch)
    torch.cuda.synchronize()
    evaluate = _flash_counts()
    eval_batches = -(-len(eval_ds) // batch)
    n = layers * eval_batches
    assert evaluate == {"fwd": n, "dq": 0, "dkv": 0, "fwd_tc": n,
                        "dq_tc": 0, "dkv_tc": 0}, evaluate
    assert np.isfinite(ev["loss"]) and ev["count"] == 16 * LM["seq"], ev
    stamps = [t for t, _ in beats]
    gaps = np.diff(stamps)                  # steps 2..16, first excluded
    tokens = batch * LM["seq"]
    SEEN["train"] = {"step_ms_p50": float(np.median(gaps)) * 1e3}
    print(f"[train] {gpu}: steps={steps} loss first={losses[0]:.4f} "
          f"last={losses[-1]:.4f} "
          f"steady_tokens_per_sec={tokens * len(gaps) / gaps.sum():.1f} "
          f"step_ms_p50={np.median(gaps) * 1e3:.3f} "
          f"eval_loss={ev['loss']:.5f} eval_accuracy={ev['accuracy']:.6f} "
          f"elapsed_s={result['elapsed']:.3f} "
          f"flash_launches_fit={json.dumps(fit)} "
          f"flash_launches_eval={json.dumps(evaluate)}")
    print(f"[train] losses {' '.join(f'{v:.4f}' for v in losses)}")
    _flash_vs_dense_step(x[:batch], y[:batch])
    _profile_train(trainer.engine, trainer.state, x[:batch], y[:batch])
    return fit, evaluate, steps


def f32_train_phase(gpu: str):
    """The GPT of ``bench.py --lm`` at ``dtype float32`` (the JAX package's
    default for the GPT) for 4 steps through ``Trainer.fit`` at one step
    per call: every flash forward, dQ and dK/dV on the 3xTF32 ``tc32``
    kernels at the training slice's shape (8 of each a step); one step held
    against a dense-attention twin at the f32 tolerance; then where an f32
    step's device time goes.  Returns the fit's flash launches (tc32
    counters included) and the steps."""
    from distributed_tensorflow_tpu_torch.data import Dataset
    from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer

    layers, batch = LM["layers"], LM["batch"]
    x, y = _lm_data(4 * batch)
    train_ds = Dataset(x=x, y=y, num_classes=LM["vocab"], name="lm_bench")
    model = _lm_model("flash", dtype="float32")
    trainer = Trainer(model, engine=SyncEngine(model), seed=0)
    beats = []
    _reset_flash_counts()
    result = trainer.fit(train_ds, epochs=1, batch_size=batch, log_every=1,
                         steps_per_call=1,
                         log_fn=lambda line: beats.append(
                             (time.perf_counter(), line)))
    torch.cuda.synchronize()
    fit = {**_flash_counts(), **_tc32_counts()}
    steps = result["steps"]
    losses = [float(line.split()[3]) for _, line in beats]
    assert steps == 4 and len(losses) == 4, (steps, len(losses))
    assert all(np.isfinite(losses)), losses
    assert all(p.dtype == torch.float32 for p in model.parameters())
    n = layers * steps
    assert fit == {"fwd": n, "dq": n, "dkv": n, "fwd_tc": 0, "dq_tc": 0,
                   "dkv_tc": 0, "fwd_tc32": n, "dq_tc32": n,
                   "dkv_tc32": n}, fit
    gaps = np.diff([t for t, _ in beats])
    print(f"[train-f32] {gpu}: GPT bench --lm at float32: steps={steps} "
          f"losses {' '.join(f'{v:.4f}' for v in losses)} "
          f"step_ms_p50={np.median(gaps) * 1e3:.3f} "
          f"steady_tokens_per_sec="
          f"{batch * LM['seq'] * len(gaps) / gaps.sum():.1f} "
          f"flash_launches_fit={json.dumps(fit)}")
    _flash_vs_dense_step(x[:batch], y[:batch], "float32")
    _profile_train(trainer.engine, trainer.state, x[:batch], y[:batch],
                   label="f32 params", compute="f32")
    return fit, steps


def _flash_vs_dense_step(x, y, dtype: str = "bfloat16") -> None:
    """One SyncEngine step of the flash model and of a dense-attention twin
    from the same fresh weights on the same batch: loss and every
    parameter's gradient (left in ``.grad`` by the step), to TRAIN_* (bf16)
    or TRAIN_F32_* (f32)."""
    from distributed_tensorflow_tpu_torch.engines import SyncEngine

    loss_rtol, grad_rtol = ((TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL)
                            if dtype == "bfloat16"
                            else (TRAIN_F32_LOSS_RTOL, TRAIN_F32_GRAD_RTOL))
    losses, grads = {}, {}
    for impl in ("flash", "dense"):
        eng = SyncEngine(_lm_model(impl, dtype))
        state = eng.init_state(torch.Generator().manual_seed(0))
        state, m = eng.step(state, *eng.shard_batch(x, y))
        losses[impl] = float(m["loss"])
        grads[impl] = {n: p.grad for n, p in state.model.named_parameters()}
    worst, worst_name = 0.0, None
    for name, g in grads["dense"].items():
        if name.endswith("attn.key.bias"):
            continue
        rel = float((grads["flash"][name].float() - g.float()).norm()
                    / g.float().norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    rel_loss = abs(losses["flash"] - losses["dense"]) / abs(losses["dense"])
    print(f"[train] one {dtype} step flash vs dense twin: loss "
          f"{losses['flash']:.6f} vs {losses['dense']:.6f} (rel "
          f"{rel_loss:.2e}, bound {loss_rtol}); worst gradient rel err "
          f"{worst:.3e} at {worst_name} (bound {grad_rtol})")
    assert rel_loss <= loss_rtol, rel_loss
    assert worst <= grad_rtol, (worst, worst_name)


def _device_rows(prof, steps):
    """(device us per step, launches per step, name) of each device kernel,
    largest first.  User annotations with device time (the optimizer's
    ``Optimizer.step#...`` range) are left out: they span kernels that are
    counted on their own."""
    from torch.autograd import DeviceType

    return sorted(((e.self_device_time_total / steps, e.count / steps, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.self_device_time_total > 0), reverse=True)


def _copy_ops(engine, state, xs, ys, steps: int, top: int = 6):
    """The ``aten::copy_`` calls of ``steps`` SyncEngine steps grouped by
    input shapes, largest device time first: (device us per step, calls
    per step, shapes) — what the copy kernels copy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(steps):
            engine.step(state, xs, ys)
        torch.cuda.synchronize()
    ops = sorted(((e.device_time_total / steps, e.count / steps,
                   str(e.input_shapes)[:90])
                  for e in prof.key_averages(group_by_input_shape=True)
                  if e.key == "aten::copy_" and e.device_time_total > 0),
                 reverse=True)
    return ops[:top]


def _profile_train(engine, state, x, y, steps: int = 4,
                   label: str = "f32 params", compute: str = "bf16") -> None:
    """Where a train step's time goes: ``steps`` SyncEngine steps timed on
    the host clock, then the same under ``torch.profiler``: the device's
    busy share of an unprofiled step, the flash kernels' share of device
    time, the copy kernels (dtype casts among them: the per-call weight
    casts of f32 parameters), kernels per step, and the top kernels."""
    xs, ys = engine.shard_batch(x, y)
    engine.step(state, xs, ys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step(state, xs, ys)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / steps
    rows = _profiled(lambda: [engine.step(state, xs, ys)
                              for _ in range(steps)], steps)
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        print("[profile] no device time in the trace: not measured")
        return
    # flash_{kind}_kernel (SIMT), flash_{kind}_tc_kernel (16-bit tensor
    # cores) or flash_{kind}_tc32_kernel (f32 tensor cores)
    flash_us = {kind: sum(r[0] for r in rows
                          if re.search(rf"flash_{kind}(_tc32|_tc)?_kernel",
                                       r[2]))
                for kind in ("fwd", "dq", "dkv")}
    names = sorted({m.group(0) for r in rows
                    if (m := re.search(
                        r"flash_(fwd|dq|dkv)(_tc32|_tc)?_kernel", r[2]))})
    total_flash = sum(flash_us.values())
    copies = [r for r in rows if "copy" in r[2].lower()]
    print(f"[profile] train step (B=8, L=1024, {compute} compute, {label}): "
          f"copy_kernels_per_step={sum(r[1] for r in copies):.1f} "
          f"copy_ms={sum(r[0] for r in copies) / 1e3:.4f}")
    # by kernel: the vectorized bfloat16_copy_kernel is the f32→bf16 cast
    # (the per-call weight casts of f32 parameters among them); the
    # unrolled direct_copy_kernel the casts to f32 (activations into
    # LayerNorm and the logits, gradients)
    for dev_us, count, key in copies:
        print(f"[profile]   copy {dev_us:9.2f} us/step x{count:<6.1f} "
              f"{key[:100]}")
    for dev_us, count, shapes in _copy_ops(engine, state, xs, ys, steps):
        print(f"[profile]   aten::copy_ {dev_us:9.2f} us/step "
              f"x{count:<6.1f} {shapes}")
    SEEN[f"train step {compute} {label}"] = {"wall_ms": wall_us / 1e3,
                                   "busy_share": busy_us / wall_us}
    print(f"[profile] train step (B=8, L=1024, {compute}, {label}): wall_ms="
          f"{wall_us / 1e3:.4f} device_busy_ms={busy_us / 1e3:.4f} "
          f"busy_share={busy_us / wall_us:.4f} "
          f"flash_ms={total_flash / 1e3:.4f} "
          f"flash_share_of_device={total_flash / busy_us:.4f} "
          f"flash_fwd_share_of_device={flash_us['fwd'] / busy_us:.4f} "
          + " ".join(f"flash_{k}_ms={v / 1e3:.4f}"
                     for k, v in flash_us.items())
          + f" kernels_per_step={sum(r[1] for r in rows):.1f} "
          f"flash_kernels={','.join(names)}")
    for dev_us, count, key in rows[:8]:
        print(f"[profile]   {dev_us:9.2f} us/step x{count:<6.1f} {key[:80]}")


def _profile_decode(kv, label: str, steps: int = 16) -> None:
    """Where a decode step's time goes: ``steps`` decode iterations of the
    full table timed on the host clock, then the same again under
    ``torch.profiler`` for the device kernels' own time — the device's
    busy share of an unprofiled step, and the top kernels.  The wall and
    busy share are kept in ``SEEN`` under ``decode <label>``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        kv.advance()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / steps
    rows = _profiled(lambda: [kv.advance() for _ in range(steps)], steps)
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        print("[profile] no device time in the trace: not measured")
        return
    # the split kernel and, with more than one split, the combine kernel
    paged_us = sum(r[0] for r in rows
                   if re.search(r"paged_(attention|combine)_kernel", r[2]))
    SEEN[f"decode {label}"] = {"wall_ms": wall_us / 1e3,
                               "busy_share": busy_us / wall_us}
    print(f"[profile] {label} decode step (8 active slots): wall_ms="
          f"{wall_us / 1e3:.4f} device_busy_ms={busy_us / 1e3:.4f} "
          f"busy_share={busy_us / wall_us:.4f} "
          f"paged_attention_ms={paged_us / 1e3:.4f} "
          f"paged_attention_share_of_device={paged_us / busy_us:.4f} "
          f"kernels_per_step={sum(r[1] for r in rows):.1f}")
    for dev_us, count, key in rows[:8]:
        print(f"[profile]   {dev_us:9.2f} us/step x{count:<6.1f} {key[:80]}")


def _profile_rounds(kv, label: str, k: int = 8, rounds: int = 2) -> None:
    """Where a fused round's time goes: ``rounds`` rounds of ``k`` steps
    (graph replays, each waited for) timed on the host clock, then the
    same under ``torch.profiler``: per decode step, the wall time, the
    device's busy time and share, kernels, and the top kernels."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        kv.advance_multi(k)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / (rounds * k)
    rows = _profiled(lambda: [kv.advance_multi(k) for _ in range(rounds)],
                     rounds * k)
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        print("[profile] no device time in the trace: not measured")
        return
    paged_us = sum(r[0] for r in rows
                   if re.search(r"paged_(attention|combine)_kernel", r[2]))
    print(f"[profile] {label} round of {k} (8 active slots), per step: "
          f"wall_ms={wall_us / 1e3:.4f} device_busy_ms={busy_us / 1e3:.4f} "
          f"busy_share={busy_us / wall_us:.4f} "
          f"paged_attention_ms={paged_us / 1e3:.4f} "
          f"kernels_per_step={sum(r[1] for r in rows):.1f}")
    for dev_us, count, key in rows[:8]:
        print(f"[profile]   {dev_us:9.2f} us/step x{count:<6.1f} {key[:80]}")


# ------------------------------------------------- BERT-tiny and remat

BERT_ARGV = ["-m", "c", "-cs", "sync", "-n", "1", "-b", "32", "--model",
             "bert_tiny", "--dataset", "glue_synth", "--attention", "flash",
             "--log-every", "0"]
# config 5 (glue_synth: 4096 train rows, 1024 test rows, L = 128, vocab
# 1024) at batch 32: 128 steps; the harness evaluates in batches of 100
BERT = dict(layers=2, steps=4096 // 32, eval_batches=-(-1024 // 100),
            batch=32, seq=128, heads=2, head_dim=64, vocab=1024)
# test accuracy of the same command on the CPU (``--device cpu``), f32 and
# under bf16-f32master alike: 1.0.  The card sums in other orders and draws
# other dropout masks; the gate allows 0.05 below it, as config 3's does
BERT_MIN_ACCURACY = 1.0 - 0.05
# BERT flash against dense with the same weights, no dropout: at f32 the
# kernels' online softmax sums in another order than one dense pass
# (FLASH_GRAD_TOL's reassociation), through two layers, LayerNorms and the
# pooler; at bf16 the dense path rounds scores, probabilities and P·V to
# bf16 where the kernels keep f32: a few bf16 roundings (2^-8) of logits of
# order 1
BERT_LOGITS_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
                   "bfloat16": dict(rtol=0.0, atol=5e-2)}


def _bert_ids(seed: int, rows: int = 32):
    """A seeded rows × 128 batch of token ids whose rows have padded tails
    of random length, the last row all padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, BERT["vocab"], (rows, BERT["seq"]))
    for r in range(rows - 1):
        ids[r, rng.integers(1, BERT["seq"] + 1):] = 0
    ids[-1] = 0
    return ids


def bert_phase(gpu: str) -> dict:
    """BASELINE config 5 through ``cli.main`` on a 1-rank NCCL group: at
    f32 (every forward, dQ and dK/dV on tc32) and under ``bf16-f32master``
    (every launch on ``tc``).  Returns each
    policy's flash launches (fit and evaluation)."""
    from distributed_tensorflow_tpu_torch.engines.sync import _ChunkGraph
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll

    layers, steps = BERT["layers"], BERT["steps"]
    fwd = layers * (steps + BERT["eval_batches"])
    bwd = layers * steps
    out = {}
    for policy in ("f32", "bf16-f32master"):
        _reset_flash_counts()
        coll.all_reduce_.launches = coll.all_reduce_.nccl_launches = 0
        graphs = _ChunkGraph.captures, _ChunkGraph.replays
        summary, _ = _cli(BERT_ARGV + ["--precision", policy])
        torch.cuda.synchronize()
        counts = _flash_counts()
        tc32 = _tc32_counts()
        nccl = coll.all_reduce_.nccl_launches
        graphs = (_ChunkGraph.captures - graphs[0],
                  _ChunkGraph.replays - graphs[1])
        tc = int(policy != "f32")
        assert SUMMARY_KEYS <= set(summary), summary
        assert (summary["model"], summary["steps"], summary["precision"],
                summary["steps_per_call"]) == ("bert_tiny", steps, policy,
                                               8), summary
        # fit: one forward, dQ and dK/dV per layer per step; evaluation:
        # one forward per layer per batch; all on the policy's route
        assert counts == {"fwd": fwd, "dq": bwd, "dkv": bwd,
                          "fwd_tc": fwd * tc, "dq_tc": bwd * tc,
                          "dkv_tc": bwd * tc}, (policy, counts)
        # at f32 every launch on the 3xTF32 tensor-core kernels
        assert tc32 == {"fwd_tc32": fwd * (1 - tc),
                        "dq_tc32": bwd * (1 - tc),
                        "dkv_tc32": bwd * (1 - tc)}, (policy, tc32)
        # one all-reduce per step (two under a 16-bit policy: the 16-bit
        # gradients, then the f32 metrics) and one of the eval totals
        assert nccl == (1 + tc) * steps + 1, (policy, nccl)
        assert graphs == (1, steps // 8 - 1), (policy, graphs)
        acc = summary["test_accuracy"]
        assert acc >= BERT_MIN_ACCURACY, (policy, acc)
        rr = summary["run_report"]
        print(f"[bert] {gpu}: config 5 (BERT-tiny, glue_synth, B=32, "
              f"L=128) {policy}: test_accuracy={acc:.6f} "
              f"test_loss={summary['test_loss']:.6f} steps={steps} "
              f"examples_per_sec={summary['examples_per_sec']:.1f} "
              f"step_ms_p50={rr['step_time_p50_s'] * 1e3:.4f} "
              f"first_chunk_s={rr['compile_s']:.3f} "
              f"graphs={graphs[0]}/{graphs[1]} nccl_all_reduces={nccl} "
              f"flash_launches={json.dumps({**counts, **tc32})}")
        out[policy] = {**counts, **tc32}
    return out


def bert_mask_check() -> dict:
    """BERT ``flash`` against BERT ``dense`` with the same weights on a
    padded batch (a row all padding among them), at f32 and bf16; the
    flash kernels at BERT's shape under that batch's key mask against
    their plain versions on each route, the all-padding row the mean of V
    over its 128 keys.  Returns the kernel checks' errors."""
    from distributed_tensorflow_tpu_torch.models import create_model
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    ids = torch.from_numpy(_bert_ids(40)).cuda()
    for dtype, tol in BERT_LOGITS_TOL.items():
        logits = {}
        for impl in ("dense", "flash"):
            model = create_model("bert_tiny", num_classes=2,
                                 vocab_size=BERT["vocab"],
                                 attention_impl=impl, dtype=dtype)
            model.reset_parameters(torch.Generator().manual_seed(0))
            with torch.no_grad():
                logits[impl] = model(ids)
        err = float((logits["flash"] - logits["dense"]).abs().max())
        torch.testing.assert_close(logits["flash"], logits["dense"], **tol)
        print(f"[bert] flash vs dense logits, {dtype}, padded 32 x 128 "
              f"batch with an all-padding row: max_abs_err={err:.3e} "
              f"(tolerance {tol}) ok")
    mask = (ids > 0).float()
    shape = dict(b=BERT["batch"], lq=BERT["seq"], h=BERT["heads"],
                 d=BERT["head_dim"])
    errs = {}
    for dtype, route in ((torch.float32, "simt"), (torch.bfloat16, "tc"),
                         (torch.float32, "tc32")):
        q, k, v, do, _ = _flash_case(41, dtype=dtype, **shape)
        name = f"bert_padded_{route}"
        errs[route] = _check_flash(name, (q, k, v, do, mask), False, route)
        out = fa.flash_attention(q, k, v, kv_mask=mask)
        mean_v = v[-1].float().mean(0, keepdim=True).expand_as(out[-1])
        if route == "tc":
            _close_tc(f"{name} mean of V", out[-1], mean_v,
                      v[-1].float().abs().mean(0, keepdim=True))
        else:
            torch.testing.assert_close(out[-1], mean_v, **F32_TOL)
        print(f"[bert] {name}: the all-padding row is the mean of V over "
              f"its {BERT['seq']} keys ok")
    return errs


def _sdpa_masked_backend(dtype):
    """The first SDPA backend that takes BERT's shape in ``dtype`` under a
    boolean (B, 1, 1, L) key mask, in the order flash, cuDNN,
    memory-efficient, math."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q = torch.zeros(2, BERT["heads"], BERT["seq"], BERT["head_dim"],
                    device="cuda", dtype=dtype, requires_grad=True)
    mask = torch.ones(2, 1, 1, BERT["seq"], device="cuda", dtype=torch.bool)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            # a backend that refuses the inputs warns why, then raises
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                torch.nn.functional.scaled_dot_product_attention(
                    q, q, q, attn_mask=mask).sum().backward()
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes BERT's masked shape")


def _kernel_names(fn, calls: int = 10) -> list[str]:
    """The device kernels ``fn`` launches, largest device time first
    (``torch.profiler`` over ``calls`` calls), or ``["not recorded"]``
    where the profiler saw none."""
    def run():
        for _ in range(calls):
            fn()

    run()
    torch.cuda.synchronize()
    return [name for _, _, name in _profiled(run, calls)] or ["not recorded"]


def _flash_rows(tag, variant, q, k, v, do, mask, causal, errs,
                sdpa_backend, dtype_name):
    """Kernel rows of the flash forward, dQ and dK/dV on ``variant`` at
    these inputs (``tc32``: with the SIMT kernels' device ms beside them
    and the 67 TFLOP/s f32 bound beside the 3xTF32 one): device ms (each
    call launches one kernel), the event-window ms per call (host cost
    included),
    bound, the plain versions and one SDPA call (with the boolean key mask
    where there is one) under ``sdpa_backend``, whose backward kernels are
    named."""
    from torch.nn.attention import sdpa_kernel

    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    scale = q.shape[-1] ** -0.5
    out, lse = fa._fwd_cuda(q, k, v, mask, scale, causal, route=variant)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, mask, do, lse, delta, scale, causal)
    timed = {"fwd": lambda: fa._fwd_cuda(q, k, v, mask, scale, causal,
                                         route=variant),
             "dq": lambda: fa._dq_cuda(*args, route=variant),
             "dkv": lambda: fa._dkv_cuda(*args, route=variant)}
    if variant == "tc32":
        # the SIMT kernels the tc32 route replaced on this path
        timed.update({
            "fwd_simt": lambda: fa._fwd_cuda(q, k, v, mask, scale, causal,
                                             route="simt"),
            "dq_simt": lambda: fa._dq_cuda(*args, route="simt"),
            "dkv_simt": lambda: fa._dkv_cuda(*args, route="simt")})
    dev = {n: _device_ms(fn, label=f"flash {n} {tag}", whole=True)
           for n, fn in timed.items()}
    call = {n: _time_windows(fn, iters=50, warmup=5)[0]
            for n, fn in timed.items()}
    plain_fwd = lambda: fa._fwd_reference(q, k, v, mask, scale, causal)  # noqa: E731,E501
    plain_bwd = lambda: fa._bwd_reference(*args)  # noqa: E731
    plain = {"bwd": _device_ms(plain_bwd, iters=10, warmup=2,
                               label=f"flash bwd {tag} plain", whole=True),
             "fwd": _device_ms(plain_fwd, iters=10, warmup=2,
                               label=f"flash fwd {tag} plain", whole=True)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    attn_mask = None if mask is None else (mask > 0)[:, None, None, :]
    lib_fwd_fn = lambda: sdpa(qt, kt, vt, attn_mask=attn_mask,  # noqa: E731
                              is_causal=causal)
    with sdpa_kernel(sdpa_backend):
        lib_fwd = _device_ms(lib_fwd_fn, label=f"flash fwd {tag} SDPA",
                             whole=True)
        o = lib_fwd_fn()
    lib_bwd_fn = lambda: torch.autograd.grad(  # noqa: E731
        o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)
    lib_bwd = _device_ms(lib_bwd_fn, label=f"flash bwd {tag} SDPA",
                         whole=True)
    lib_kernels = _kernel_names(lib_bwd_fn)
    print(f"[flash] {tag}: SDPA {sdpa_backend.name} backward kernels, "
          f"largest first: {lib_kernels}")
    src = "distributed_tensorflow_tpu_torch/ops/csrc/" + {
        "tc": "flash_attention_sm90.cu", "tc32": "flash_attention_f32_sm90.cu",
        "simt": "flash_attention.cu"}[variant]
    replaces = {"fwd": 170, "dq": 281, "dkv": 299}
    b, lq, h, d = q.shape
    rows = []
    for kind in ("fwd", "dq", "dkv"):
        bound_ms, bound_by = _flash_bound_ms(
            kind, q, k, causal, mask,
            peak=TC32_FLOPS if variant == "tc32" else None)
        row = {
            "name": f"flash_attention.{kind}_{tag}", "route": "cuda",
            "variant": variant, "source": src,
            "replaces": "distributed_tensorflow_tpu/ops/flash_attention.py:"
                        f"{replaces[kind]}",
            "shape": f"B={b} L={lq} H={h} D={d} {dtype_name} "
                     + ("causal" if causal else "key mask"),
            "max_abs_err": {"fwd": errs["out"], "dq": errs["dq"],
                            "dkv": max(errs["dk"], errs["dv"])}[kind],
            "ms": dev[kind], "call_ms": call[kind],
            "plain_ms": plain["fwd" if kind == "fwd" else "bwd"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / dev[kind],
            "library_ms": lib_fwd if kind == "fwd" else lib_bwd,
            "library_backend": sdpa_backend.name,
            "library_kernel": None if kind == "fwd" else lib_kernels[0]}
        if variant == "tc32":
            row["bound_f32_cuda_cores_ms"] = _flash_bound_ms(
                kind, q, k, causal, mask)[0]
            row["simt_ms"] = dev[f"{kind}_simt"]
            row["simt_call_ms"] = call[f"{kind}_simt"]
            row["max_abs_err_vs_simt"] = {
                "fwd": errs["out_vs_simt"], "dq": errs["dq_vs_simt"],
                "dkv": max(errs["dk_vs_simt"], errs["dv_vs_simt"])}[kind]
        rows.append(row)
        print(f"[flash] {tag} ({variant}) B={b} L={lq} H={h} D={d} "
              f"{dtype_name} {'causal' if causal else 'key mask'}: {kind} "
              f"device {dev[kind]:.5f} ms, call {call[kind]:.5f} ms; plain "
              f"{row['plain_ms']:.5f}; SDPA {sdpa_backend.name} "
              f"{row['library_ms']:.5f}; bound {bound_ms:.6f} "
              f"({bound_by}), share {row['bound_share']:.3f}" + (
                  f"; SIMT {row['simt_ms']:.5f}; f32 CUDA-core bound "
                  f"{row['bound_f32_cuda_cores_ms']:.6f}"
                  if variant == "tc32" else ""))
    if variant == "tc32":
        print(f"[flash] {tag}: fwd tc32 {dev['fwd']:.5f} ms (SIMT "
              f"{dev['fwd_simt']:.5f}) against the SDPA f32 forward "
              f"{lib_fwd:.5f} ms (device)")
        print(f"[flash] {tag}: dq+dkv tc32 {dev['dq'] + dev['dkv']:.5f} ms "
              f"(SIMT {dev['dq_simt'] + dev['dkv_simt']:.5f}) against the "
              f"SDPA f32 backward {lib_bwd:.5f} ms (device)")
    return rows


def bert_timing_phase(bert_errs) -> list[dict]:
    """The flash kernels at BERT's shape (B=32, L=128, H=2, D=64,
    non-causal, config 5's all-valid key mask) on each route, and the f32
    kernels at the training slice's shape (B=8, L=1024, H=8, D=64,
    causal): the SIMT forward, dQ and dK/dV bound by the f32 (non-tensor)
    peak, and the tc32 forward, dQ and dK/dV by the 3xTF32 rate, beside
    the plain
    versions and SDPA; returns their rows (launches filled in by
    ``main``)."""
    print(f"[flash] f32 rows are bound by the H100's f32 (non-tensor) "
          f"peak of {PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s (data "
          f"sheet, SXM, 700 W), tc32 rows by three TF32 products per f32 "
          f"product at {TF32_FLOPS / 1e12:.1f} TFLOP/s "
          f"({TC32_FLOPS / 1e12:.1f}); bf16 by "
          f"{PEAK_FLOPS[torch.bfloat16] / 1e12:.0f} TFLOP/s; bytes by "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    rows = []
    shape = dict(b=BERT["batch"], lq=BERT["seq"], h=BERT["heads"],
                 d=BERT["head_dim"])
    mask = torch.ones(BERT["batch"], BERT["seq"], device="cuda")
    for dtype, variant, name in ((torch.float32, "simt", "float32"),
                                 (torch.bfloat16, "tc", "bfloat16"),
                                 (torch.float32, "tc32", "float32")):
        q, k, v, do, _ = _flash_case(42, dtype=dtype, **shape)
        rows += _flash_rows(f"bert_{variant}", variant, q, k, v, do, mask,
                            False, bert_errs[variant],
                            _sdpa_masked_backend(dtype), name)
    case = _flash_case(43, b=8, lq=1024, h=8, d=64)
    errs = _check_flash("slice_f32_causal", case, True, "simt")
    rows += _flash_rows("slice_f32", "simt", *case[:4], None, True, errs,
                        _sdpa_backend(torch.float32), "float32")
    errs = _check_flash("slice_f32_causal_tc32", case, True, "tc32")
    rows += _flash_rows("slice_tc32", "tc32", *case[:4], None, True, errs,
                        _sdpa_backend(torch.float32), "float32")
    return rows


def remat_phase(gpu: str) -> None:
    """The train window's GPT (bf16, flash, B=8, L=1024) with remat off
    and on: eager steps (the same losses; the forward launches double,
    the backward's do not), each step's peak memory and device time; an
    8-step ``bf16-f32master`` chunk replayed as a CUDA graph under remat
    against its eager chunk; BERT-tiny under remat, a replayed chunk
    against the chunk without remat."""
    from distributed_tensorflow_tpu_torch.engines import Engine, SyncEngine
    from distributed_tensorflow_tpu_torch.engines.sync import _ChunkGraph

    layers, batch = LM["layers"], LM["batch"]
    x, y = _lm_data(batch * 8)
    stats = {}
    for remat in (False, True):
        eng = SyncEngine(_lm_model("flash", remat=remat))
        state = eng.init_state(torch.Generator().manual_seed(0))
        batches = [eng.shard_batch(x[batch * i:batch * (i + 1)],
                                   y[batch * i:batch * (i + 1)])
                   for i in range(4)]
        eng.step(state, *batches[0])         # the optimizer's state, warm
        torch.cuda.synchronize()
        _reset_flash_counts()
        losses, peaks = [], []
        for xs, ys in batches[1:]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            state, m = eng.step(state, xs, ys)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            peaks.append((torch.cuda.max_memory_allocated(),
                          torch.cuda.max_memory_allocated() - before))
        counts = _flash_counts()
        n = layers * len(losses)
        # the recompute runs each layer's forward again in the backward
        assert counts == {"fwd": 2 * n if remat else n, "dq": n, "dkv": n,
                          "fwd_tc": 2 * n if remat else n, "dq_tc": n,
                          "dkv_tc": n}, (remat, counts)
        ms = _device_ms(lambda: eng.step(state, *batches[1]), iters=4,
                        warmup=1, label=f"GPT step remat={remat}")
        stats[remat] = losses
        print(f"[remat] {gpu}: GPT (B=8, L=1024, bf16, flash, 8 layers) "
              f"remat={remat}: losses {' '.join(f'{v:.6f}' for v in losses)}"
              f" peak_allocated_bytes={max(p[0] for p in peaks)} "
              f"step_peak_above_entry_bytes={max(p[1] for p in peaks)} "
              f"step_device_ms={ms:.4f} fwd_tc_per_step="
              f"{counts['fwd_tc'] / len(losses):.1f} dq_tc_per_step="
              f"{counts['dq_tc'] / len(losses):.1f} dkv_tc_per_step="
              f"{counts['dkv_tc'] / len(losses):.1f}")
        del eng, state, batches
        torch.cuda.empty_cache()
    # the same kernels on the same values: the losses agree bit for bit
    assert stats[False] == stats[True], stats

    def chunks(model, precision, xs_all, ys_all, graph, k=8):
        eng = SyncEngine(model, precision=precision)
        state = eng.init_state(torch.Generator().manual_seed(0))
        drain = eng.many_step if graph else functools.partial(
            Engine.many_step, eng)
        losses = []
        for c in range(2):
            xs, ys = zip(*(eng.shard_batch(xs_all[i], ys_all[i])
                           for i in range(c * k, (c + 1) * k)))
            state, m = drain(state, list(xs), list(ys))
            losses.append(m["loss"].cpu())
        return torch.cat(losses)

    lm_x = [x[batch * (i % 8):batch * (i % 8 + 1)] for i in range(16)]
    lm_y = [y[batch * (i % 8):batch * (i % 8 + 1)] for i in range(16)]
    graphs = _ChunkGraph.captures
    runs = {g: chunks(_lm_model("flash", remat=True), "bf16-f32master",
                      lm_x, lm_y, g) for g in (False, True)}
    assert _ChunkGraph.captures - graphs == 1
    assert torch.equal(runs[False], runs[True]), runs
    print(f"[remat] GPT bf16-f32master under remat, 8-step chunks: eager "
          f"then captured and replayed, losses equal to the eager chunks' "
          f"bit for bit: {' '.join(f'{v:.5f}' for v in runs[True].tolist())}")

    from distributed_tensorflow_tpu_torch.data import load_dataset
    from distributed_tensorflow_tpu_torch.models import create_model

    ds = load_dataset("glue_synth")
    bx = [ds.x[32 * i:32 * (i + 1)] for i in range(16)]
    by = [ds.y[32 * i:32 * (i + 1)] for i in range(16)]
    graphs = _ChunkGraph.captures
    bert = {remat: chunks(create_model(
        "bert_tiny", num_classes=2, attention_impl="flash", remat=remat),
        "f32", bx, by, True) for remat in (False, True)}
    assert _ChunkGraph.captures - graphs == 2
    assert torch.equal(bert[False], bert[True]), bert
    print(f"[remat] BERT-tiny f32 (dropout 0.1) under remat, a replayed "
          f"8-step chunk: losses equal to the chunk without remat bit for "
          f"bit: {' '.join(f'{v:.5f}' for v in bert[True].tolist())}")


def _profile_bert_chunk(policy: str) -> None:
    """Config 5's step (B=32, L=128, 1-rank NCCL) as a replayed chunk of
    8, under ``policy``."""
    from distributed_tensorflow_tpu_torch.data import load_dataset
    from distributed_tensorflow_tpu_torch.engines import create_engine
    from distributed_tensorflow_tpu_torch.models import create_model
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh

    ds = load_dataset("glue_synth")
    dtype = "float32" if policy == "f32" else "bfloat16"
    mesh = create_mesh(1)
    try:
        eng = create_engine("sync", create_model(
            "bert_tiny", num_classes=2, attention_impl="flash", dtype=dtype),
            mesh=mesh, precision=policy)
        state = eng.init_state(torch.Generator().manual_seed(0))
        xs, ys = zip(*(eng.shard_batch(ds.x[32 * i:32 * i + 32],
                                       ds.y[32 * i:32 * i + 32])
                       for i in range(8)))
        _profile_chunk(f"BERT-tiny train step (B=32, L=128, {policy}, "
                       f"1-rank NCCL)", eng, state, list(xs), list(ys))
    finally:
        mesh.close()


_MANGLED = {"f": "float", "13__nv_bfloat16": "bf16", "6__half": "half",
            "a": "int8",
            "Lb0E": "false", "Lb1E": "true"}


# phase cli-lm: the GPT at bench.py --lm's widths on lm_synth (vocabulary
# 128, L = 128, 4096 train and 1024 test rows), trained, sampled and
# served through cli.main
CLI_LM = dict(layers=8, heads=8, head_dim=64, batch=8, seq=128, vocab=128,
              slots=8, block=8, max_len=512)
CLI_LM_ARGV = ["-m", "c", "-cs", "sync", "-n", "1", "-b", "8", "-e", "1",
               "--model", "gpt", "--dataset", "lm_synth", "--attention",
               "flash", "--model-arg", "hidden=512", "--model-arg",
               "layers=8", "--model-arg", "heads=8", "--model-arg",
               "ffn=2048", "--seed", "0", "--log-every", "0"]
# L1, the CLI's default precision (f32): the README's serve command on the
# paged table, with the optimizer recipe and --sample
CLI_L1_ARGV = CLI_LM_ARGV + [
    "--lr-schedule", "cosine", "--warmup-steps", "32", "--weight-decay",
    "0.1", "--clip-norm", "1.0", "--sample", "32", "--serve", "32",
    "--serve-slots", "8", "--serve-max-new", "32", "--serve-prefill-chunk",
    "16", "--serve-prefix-cache", "128", "--serve-prefix-block", "8",
    "--serve-shared-prefix", "16", "--serve-kv-layout", "paged"]
# L2: bf16-f32master, rope, GQA (kv_heads 2) and multi-step rounds
CLI_L2_ARGV = CLI_LM_ARGV + [
    "--precision", "bf16-f32master", "--lr-schedule", "linear",
    "--warmup-steps", "32", "--weight-decay", "0.1", "--clip-norm", "1.0",
    "--positional", "rope", "--kv-heads", "2", "--serve", "32",
    "--serve-slots", "8", "--serve-max-new", "32", "--serve-prefix-block",
    "8", "--serve-kv-layout", "paged", "--serve-multi-step", "8"]
# L2's training flags without its serve window, for the replayed-against-
# eager twin on the first LM_HEAD_ROWS rows (warmup inside those steps)
CLI_L2_TWIN_ARGV = CLI_LM_ARGV + [
    "--precision", "bf16-f32master", "--lr-schedule", "linear",
    "--warmup-steps", "8", "--weight-decay", "0.1", "--clip-norm", "1.0",
    "--positional", "rope", "--kv-heads", "2"]
CLI_LM_TEST_LOSS = 3.85    # one nat under chance, ln 128 = 4.852
LM_HEAD_ROWS = 192         # a short fit: 24 steps at -b 8, chunks of 8


def _lm_head_rows(batch_size, type="train"):  # noqa: A002 — harness API
    """The first ``LM_HEAD_ROWS`` training rows of ``lm_synth`` (100 test
    rows): a ``dataset_fn`` for the short fits."""
    from distributed_tensorflow_tpu_torch.data import loaders

    ds = loaders.load_dataset("lm_synth", split=type)
    rows = LM_HEAD_ROWS if type == "train" else 100
    return loaders.Dataset(x=ds.x[:rows], y=ds.y[:rows],
                           num_classes=ds.num_classes, name=ds.name,
                           synthetic=ds.synthetic)


@contextlib.contextmanager
def _paged_pools(seen: set):
    """Record (pool dtype, kv heads, query heads) of every paged-kernel
    launch made from Python (eager steps and graph captures; a replay
    repeats its capture's) while the block runs: the wrapper's launch
    function is wrapped, its counters stay where they are."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    launch = pa._paged_cuda

    def recording(q, kp, *args, **kw):
        seen.add((kp.dtype, kp.shape[2], q.shape[2]))
        return launch(q, kp, *args, **kw)

    pa._paged_cuda = recording
    try:
        yield
    finally:
        pa._paged_cuda = launch


def _cli_lm_requests(shared: int):
    """The serve window's requests as ``harness._serve_from_state`` builds
    them for this phase's flags: test rows' first 8 tokens behind a
    ``shared``-token prefix from ``default_rng(seed 0)``, 32 new tokens,
    every arrival at 0."""
    from distributed_tensorflow_tpu_torch.data import loaders
    from distributed_tensorflow_tpu_torch.serving import Request

    rows = loaders.load_dataset("lm_synth", split="test").x
    head = np.random.default_rng(0).integers(
        0, CLI_LM["vocab"], shared).astype(np.int32)
    return [Request(i, np.concatenate([head, rows[i % len(rows), :8]]), 32,
                    0.0) for i in range(32)]


def _cli_lm_window(name, argv, gpu, steps_per_call, pool_kind):
    """One run of ``cli.main(argv)`` with every launch count set to 0 just
    before it and read just after; returns the record, the flash and paged
    counts, the pools the paged kernel read, and the RoundGraph replays."""
    from distributed_tensorflow_tpu_torch.serving.decode_graph import (
        RoundGraph)

    pools: set = set()
    _reset_flash_counts()
    _reset_paged_counts()
    replays = RoundGraph.replays
    with _paged_pools(pools):
        rec = _recorded_cli(argv, steps_per_call=steps_per_call)
    torch.cuda.synchronize()
    counts = {**_flash_counts(), **_tc32_counts()}
    paged, int8, verify = _paged_counts()
    replays = RoundGraph.replays - replays
    sm, sv = rec["summary"], rec["summary"]["serve"]
    rr = sm["run_report"]
    print(f"[cli-lm] window {name} ({gpu}): steps={sm['steps']} "
          f"steps_per_call={sm['steps_per_call']} precision="
          f"{sm['precision']} test_loss={sm['test_loss']:.6f} "
          f"test_perplexity={sm['test_perplexity']:.4f} "
          f"examples_per_sec={sm['examples_per_sec']:.1f} "
          f"step_ms_p50={rr['step_time_p50_s'] * 1e3:.4f} serve: "
          f"completed={sv['completed']} decode_iterations="
          f"{sv['decode_iterations']} tokens_per_sec="
          f"{sv['serve_tokens_per_sec']:.2f} ttft_p50_s="
          f"{sv['serve_ttft_p50_s']:.5f} itl_p50_s="
          f"{sv['serve_itl_p50_s']:.6f} goodput_under_slo="
          f"{sv['serve_goodput_under_slo']} kv_layout={sv['serve_kv_layout']}"
          f" kv_dtype={sv['serve_kv_dtype']}; flash launches "
          f"{json.dumps(counts)}; paged launches {paged} (int8 {int8}, "
          f"l_q > 1 {verify}) on pools {sorted(map(str, pools))}; "
          f"RoundGraph replays {replays}")
    assert pools == {pool_kind}, (name, pools)
    assert int8 == verify == 0, (name, int8, verify)
    assert "serve_goodput_under_slo" in sv and sv["slo"]["requests"] == 32
    assert sv["completed"] == 32 and sm["serve_exit_policy"] == 0, sv
    return rec, counts, paged, replays


def cli_lm_phase(gpu: str) -> dict:
    """Phase cli-lm (module docstring): windows L1 and L2 through
    ``cli.main``; returns each window's launches of the kernels it ran
    (the kernel rows at its shapes take them)."""
    from distributed_tensorflow_tpu_torch.data import loaders
    from distributed_tensorflow_tpu_torch.models.gpt import generate
    from distributed_tensorflow_tpu_torch.parallel.precision import (
        strip_master)
    from distributed_tensorflow_tpu_torch.serving import (
        ContinuousBatcher, SlotKVCache)
    from distributed_tensorflow_tpu_torch.utils.optim import ScheduledAdamW

    layers = CLI_LM["layers"]
    train = loaders.load_dataset("lm_synth", split="train")
    test = loaders.load_dataset("lm_synth", split="test")
    steps = len(train) // CLI_LM["batch"]
    evals = -(-len(test) // 100)                 # eval batch 100, padded
    want_fwd, want_bwd = layers * (steps + evals), layers * steps
    print(f"[cli-lm] predicted flash launches per window: forward "
          f"{layers} layers x ({steps} steps + {evals} eval batches) = "
          f"{want_fwd}, dQ and dK/dV {layers} x {steps} = {want_bwd}; "
          f"paged launches {layers} x decode iterations (L1: one forward "
          f"a decode iteration, prefill reads by gather) and {layers} x 8 "
          f"x rounds (L2: rounds = dispatches - prefills)")

    # L1: f32, every flash launch on tc32, f32 pools
    rec, counts, paged, _ = _cli_lm_window(
        "L1 (f32)", CLI_L1_ARGV, gpu, 8,
        (torch.float32, CLI_LM["heads"], CLI_LM["heads"]))
    sm, sv = rec["summary"], rec["summary"]["serve"]
    assert counts == {"fwd": want_fwd, "dq": want_bwd, "dkv": want_bwd,
                      "fwd_tc": 0, "dq_tc": 0, "dkv_tc": 0,
                      "fwd_tc32": want_fwd, "dq_tc32": want_bwd,
                      "dkv_tc32": want_bwd}, counts
    assert paged == layers * sv["decode_iterations"], (
        paged, sv["decode_iterations"])
    assert sm["steps"] == steps and sm["test_loss"] <= CLI_LM_TEST_LOSS, sm
    trainer = rec["trainer"]
    model = trainer.state.model
    assert isinstance(strip_master(trainer.state.optimizer),
                      ScheduledAdamW), type(trainer.state.optimizer)
    prompts = test.x[:1, :8]
    direct = generate(model, None, prompts, 32, greedy=True).cpu().tolist()
    assert sm["sample_prompts"] == prompts.tolist()
    assert sm["samples"] == direct, (sm["samples"], direct)
    kv = SlotKVCache(model, None, CLI_LM["slots"], kv_layout="paged",
                     prefix_cache_blocks=128, prefix_block=CLI_LM["block"])
    base = ContinuousBatcher(kv, prefill_chunk=16).run(
        _cli_lm_requests(16))
    assert _streams(rec["serve_summary"]) == _streams(base), (
        "window L1's serve streams differ from the direct window's")
    SEEN["L1"] = {"test_loss": sm["test_loss"], "samples": sm["samples"],
                  "streams": _streams(rec["serve_summary"]),
                  "counts": counts, "paged": paged,
                  "step_ms_p50": sm["run_report"]["step_time_p50_s"] * 1e3}
    print(f"[cli-lm] window L1: test_loss {sm['test_loss']:.6f} <= "
          f"{CLI_LM_TEST_LOSS}; samples bitwise generate(greedy) on the "
          f"trained module; serve streams bitwise a direct SlotKVCache("
          f"paged) + ContinuousBatcher window; optimizer "
          f"{type(strip_master(trainer.state.optimizer)).__name__}; flash "
          f"and paged launches as predicted")
    l1 = {"fwd_tc32": counts["fwd_tc32"], "dq_tc32": counts["dq_tc32"],
          "dkv_tc32": counts["dkv_tc32"], "paged_f32": paged}
    del rec, model, kv, base

    # L2: bf16-f32master, replayed chunks against eager ones
    graph, counts, paged, replays = _cli_lm_window(
        "L2 (bf16-f32master, steps_per_call 8)", CLI_L2_ARGV
        + ["--steps-per-call", "8"], gpu, 8,
        (torch.bfloat16, 2, CLI_LM["heads"]))
    sv = graph["summary"]["serve"]
    assert counts == {"fwd": want_fwd, "dq": want_bwd, "dkv": want_bwd,
                      "fwd_tc": want_fwd, "dq_tc": want_bwd,
                      "dkv_tc": want_bwd, "fwd_tc32": 0, "dq_tc32": 0,
                      "dkv_tc32": 0}, counts
    rounds = sv["serve_dispatches"] - sv["prefills"]
    assert replays > 0 and paged == layers * 8 * rounds, (
        replays, paged, rounds)
    # replayed chunks against eager steps: L2's training flags without
    # its serve window, on the first rows of lm_synth (an eager chunk, a
    # captured one, a replay) at steps_per_call 8 and 1
    twin = {k: _recorded_cli(CLI_L2_TWIN_ARGV + ["--steps-per-call",
                                                 str(k)],
                             steps_per_call=k, dataset_fn=_lm_head_rows)
            for k in (8, 1)}
    masters = [r["trainer"].state.optimizer.master for r in twin.values()]
    checks = {
        "losses": torch.equal(twin[8]["losses"], twin[1]["losses"]),
        "master": torch.equal(*masters),
        "test_loss": (twin[8]["summary"]["test_loss"]
                      == twin[1]["summary"]["test_loss"])}
    assert all(checks.values()), checks
    assert twin[1]["summary"]["steps"] == LM_HEAD_ROWS // CLI_LM["batch"]
    model = graph["trainer"].state.model
    assert isinstance(strip_master(graph["trainer"].state.optimizer),
                      ScheduledAdamW)
    kv = SlotKVCache(model, None, CLI_LM["slots"], kv_layout="paged",
                     prefix_block=CLI_LM["block"])
    base = ContinuousBatcher(kv, multi_step=8).run(_cli_lm_requests(0))
    assert _streams(graph["serve_summary"]) == _streams(base), (
        "window L2's serve streams differ from the direct multi_step "
        "window's")
    print(f"[cli-lm] window L2 ({gpu}): test_loss "
          f"{graph['summary']['test_loss']:.6f}; serve rounds {rounds}, "
          f"RoundGraph replays {replays}; streams bitwise a direct "
          f"multi_step=8 window; its training flags on "
          f"{twin[1]['summary']['steps']} steps at steps_per_call 8 "
          f"(replayed chunks) against 1 (eager): bitwise "
          f"{json.dumps(checks)}, examples_per_sec "
          f"{twin[8]['summary']['examples_per_sec']:.1f} / "
          f"{twin[1]['summary']['examples_per_sec']:.1f}")
    l2 = {"fwd_tc": counts["fwd_tc"], "dq_tc": counts["dq_tc"],
          "dkv_tc": counts["dkv_tc"], "paged_bf16_gqa": paged}
    # where a replayed step of each window goes (after every window: a
    # profiler session before one would be in its host times); the
    # profiled chunks train the states on
    batch = CLI_LM["batch"]
    for label, tr in (("cli-lm L1 step (B=8, L=128, f32)", trainer),
                      ("cli-lm L2 step (B=8, L=128, bf16-f32master)",
                       graph["trainer"])):
        xs, ys = zip(*(tr.engine.shard_batch(
            train.x[batch * i:batch * (i + 1)],
            train.y[batch * i:batch * (i + 1)]) for i in range(8)))
        _profile_chunk(label, tr.engine, tr.state, list(xs), list(ys),
                       chunks=2)
    del trainer, graph, twin, model, kv, base, masters
    torch.cuda.empty_cache()
    return {"L1": l1, "L2": l2}


def cli_lm_timing_phase(launches: dict) -> list[dict]:
    """The kernels of phase cli-lm at its shapes, held against their plain
    versions and timed beside their bounds, the plain versions and SDPA:
    the flash forward, dQ and dK/dV at B=8, L=128, H=8, D=64, causal on
    ``tc32`` (f32, window L1) and ``tc`` (bf16, window L2), and the paged
    kernel over f32 pools (H = KVH = 8, window L1) and bf16 GQA pools
    (H=8, KVH=2, window L2), 8 slots, 8-token blocks, 64-entry tables
    (max_len 512), at the windows' contexts; returns their rows with the
    windows' launches."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    b, lq, h, d = (CLI_LM["batch"], CLI_LM["seq"], CLI_LM["heads"],
                   CLI_LM["head_dim"])
    rows = []
    for dtype, variant, name, seed in ((torch.float32, "tc32", "float32", 46),
                                       (torch.bfloat16, "tc", "bfloat16",
                                        47)):
        case = _flash_case(seed, b=b, lq=lq, h=h, d=d, dtype=dtype)
        errs = _check_flash(f"cli_lm_{variant}", case, True, variant)
        got = _flash_rows(f"cli_lm_{variant}", variant, *case[:4], None,
                          True, errs, _sdpa_backend(dtype), name)
        window = launches["L1" if variant == "tc32" else "L2"]
        for row in got:
            kind = row["name"].rsplit(".", 1)[1].split("_")[0]
            row["launches"] = window[f"{kind}_{variant}"]
        rows += got
    mb = CLI_LM["max_len"] // CLI_LM["block"]
    for tag, kvh, dtype, tol, lo, window, key in (
            ("f32", h, torch.float32, F32_TOL, 24, "L1", "paged_f32"),
            ("bf16_gqa", 2, torch.bfloat16, BF16_TOL, 8, "L2",
             "paged_bf16_gqa")):
        # the windows' contexts: a 16-token prefix (L1) and 8 prompt
        # tokens, then up to 32 new ones
        pos = np.random.default_rng(12).integers(lo, lo + 32, b)
        q, kp, vp, bt, pos, _, _ = _paged_case(
            48, s=b, h=h, kvh=kvh, d=d, blk=CLI_LM["block"], mb=mb,
            q_dtype=dtype, kv_dtype=dtype, pos=pos)
        ref = pa.paged_attention_reference(q, kp, vp, bt, pos)
        err = 0.0
        for sp in (None, 1, 2, 4, mb):
            out = pa._paged_cuda(q, kp, vp, bt, pos, splits=sp)
            torch.testing.assert_close(out.float(), ref.float(), **tol,
                                       msg=f"cli_lm paged {tag} splits={sp}")
            err = max(err, float((out.float() - ref.float()).abs().max()))
        t = _paged_timed(f"cli_lm {tag}", q, kp, vp, bt, pos, (1, 2, 4, 8))
        row = {"name": f"paged_attention_cli_lm_{tag}", "route": "cuda",
               "source": "distributed_tensorflow_tpu_torch/ops/csrc/"
                         "paged_attention.cu",
               "replaces": "distributed_tensorflow_tpu/ops/"
                           "paged_attention.py:257",
               "shape": f"S={b} H={h} KVH={kvh} D={d} "
                        f"blk={CLI_LM['block']} MB={mb} {tag} pools, pos "
                        f"{lo}-{lo + 31}",
               "launches": launches[window][key], "max_abs_err": err,
               **{k: t[k] for k in ("ms", "call_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "splits")},
               "bound_share": t["bound_ms"] / t["ms"],
               "split_sweep": t["sweep"]}
        rows.append(row)
        print(f"[kernel] cli-lm paged {row['shape']}: max_abs_err "
              f"{err:.3e}; device ms kernel={t['ms']:.5f} (splits "
              f"{t['splits']}) plain={t['plain_ms']:.5f} SDPA="
              f"{t['library_ms']:.5f}; bound {t['bound_ms']:.6f} "
              f"({t['bound_by']}); launches in window {window} "
              f"{row['launches']}")
    return rows


# --------------------------------------------------------------------------
# phase 5g: sequence parallelism on the card (sp = 1) and the virtual ring
# --------------------------------------------------------------------------

SP_STEPS = 4
# f32 ring_flash against the flash GPT at sp = 1: the forward is the same
# kernel, merged with weight exactly 1 (logaddexp(-1e30, lse) == lse), and
# a key mask of ones leaves every score as it is; the backward runs the
# same tc32 dQ and dK/dV from the same lse and delta.  So every loss is
# held bitwise (on the H100 all 4 were).  Under bf16-f32master the forward
# is the same tc kernel (first loss bitwise), but the ring's backward runs
# the f32 tc32 kernels where the flash GPT runs the bf16 tc ones: each
# later loss is held within SP_BF16_DROP_SHARE of the flash GPT's drop
# from its first loss (about 0.04 a step; the H100 read under 1%), a
# bound that a wrong attention backward would not meet where 2e-3 of the
# whole loss (over half a step's drop) could
SP_BF16_DROP_SHARE = 0.05
# the virtual-rank ring's shapes: (a) causal, blocks of 1024 (the slice's
# block), (b) BERT's key-masked shape
SP_VIRTUAL = (dict(n=4, causal=True, b=2, l=4096, h=8),
              dict(n=2, causal=False, b=32, l=128, h=2))


def _sp_window(impl: str, dtype: str, policy: str, mesh, x, y) -> dict:
    """SP_STEPS eager steps of the ``bench.py --lm`` GPT from the seed-0
    weights: ``SyncEngine`` for ``flash``, else ``SeqParallelEngine`` on
    the (1, 1) mesh; both with the same (non-capturable) Adam.  Every
    launch count is set to 0 just before the steps and read just after."""
    from distributed_tensorflow_tpu_torch.engines import (
        SeqParallelEngine, SyncEngine)

    model = _lm_model(impl, dtype)
    cls = SyncEngine if impl == "flash" else SeqParallelEngine
    eng = cls(model, mesh=mesh, precision=policy,
              optimizer=lambda p: torch.optim.Adam(p, lr=1e-3))
    state = eng.init_state(torch.Generator().manual_seed(0))
    batch = LM["batch"]
    batches = [eng.shard_batch(x[i * batch:(i + 1) * batch],
                               y[i * batch:(i + 1) * batch])
               for i in range(SP_STEPS)]
    torch.cuda.synchronize()
    _reset_flash_counts()
    losses, step_ms = [], []
    for xb, yb in batches:
        t0 = time.perf_counter()
        state, m = eng.step(state, xb, yb)
        losses.append(float(m["loss"]))        # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {**_flash_counts(), **_tc32_counts()}
    assert all(np.isfinite(losses)), (impl, policy, losses)
    del state, eng, model
    return {"losses": losses, "step_ms": step_ms, "counts": counts}


def _sp_counts_ok(label, counts, fwd_route) -> None:
    """Per step: 8 forwards (on ``fwd_route``), 8 dQ and 8 dK/dV on tc32,
    and no SIMT launch."""
    n = LM["layers"] * SP_STEPS
    want = {"fwd": n, "dq": n, "dkv": n, "fwd_tc": 0, "dq_tc": 0,
            "dkv_tc": 0, "fwd_tc32": 0, "dq_tc32": n, "dkv_tc32": n}
    want[f"fwd_{fwd_route}"] = n
    assert counts == want, (label, counts, want)


def _sp_virtual_check(case: dict, dtype) -> dict:
    """One virtual-rank case on the card against the whole sequence:
    f32 out and lse within F32_TOL of ``flash_fwd_block`` over the whole
    sequence, gradients within FLASH_GRAD_TOL of ``flash_bwd_block`` over
    it; bf16 out within the tc bound of the plain version (``_close_tc``),
    lse within F32_TOL, and the gradients within FLASH_GRAD_TOL of the
    whole sequence's f32 backward from the ring's lse and Δ (the blocks'
    dQ and dK/dV are f32 tc32 kernels).  Launches gated: one forward, dQ
    and dK/dV per pairing that is not entirely future."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel import ring_attention as ra

    n, causal = case["n"], case["causal"]
    q, k, v, do, mask = _flash_case(70 + n, b=case["b"], lq=case["l"],
                                    h=case["h"], d=64, dtype=dtype,
                                    masked=not causal)
    if mask is None:
        mask = torch.ones(case["b"], case["l"], device="cuda")
    scale = 64 ** -0.5
    before = _flash_counts()
    got = ra.virtual_ring(q, k, v, mask, do, n, causal=causal, scale=scale)
    torch.cuda.synchronize()
    launched = {c: _flash_counts()[c] - before[c] for c in ("fwd", "dq",
                                                           "dkv")}
    pairs = n * (n + 1) // 2 if causal else n * n
    assert launched == {"fwd": pairs, "dq": pairs, "dkv": pairs}, launched
    out, lse, dq, dk, dv = got
    w_out, w_lse = fa.flash_fwd_block(q, k, v, mask, scale=scale,
                                      causal=causal)
    if dtype == torch.float32:
        delta = (do * w_out).sum(-1).transpose(1, 2).contiguous()
        want = fa.flash_bwd_block(q, k, v, mask, do, w_lse, delta,
                                  scale=scale, causal=causal)
        torch.testing.assert_close(out, w_out, **F32_TOL)
        out_err = float((out - w_out).abs().max())
    else:
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        want = fa.flash_bwd_block(q, k, v, mask, do, lse,
                                  delta.contiguous(), scale=scale,
                                  causal=causal)
        plain, _ = fa._fwd_reference(q, k, v, mask, scale, causal)
        terms = fa._term_sums(q, k, v, mask, do, lse, delta.contiguous(),
                              scale, causal)[0]
        out_err, _ = _close_tc("virtual ring bf16 out", out, plain.float(),
                               terms)
    torch.testing.assert_close(lse, w_lse, **F32_TOL)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, **FLASH_GRAD_TOL)
    grad_err = max(float((g - w).abs().max())
                   for g, w in zip((dq, dk, dv), want))
    return {"n": n, "causal": causal, "dtype": str(dtype).split(".")[-1],
            "shape": f"B={case['b']} L={case['l']} H={case['h']} D=64",
            "launches": launched, "out_max_abs_err": out_err,
            "grad_max_abs_err": grad_err,
            "inputs": (q, k, v, mask, do, scale)}


def sp_phase(gpu: str) -> dict:
    """Phase 5g: the ``bench.py --lm`` GPT under ``SeqParallelEngine`` on
    a (1, 1) NCCL mesh, 4 steps each: ``ring_flash`` at f32 and under
    ``bf16-f32master`` and ``ulysses_flash`` at f32, each against
    ``SyncEngine`` with the flash attention from the same weights and
    batches; then the virtual-rank ring.  Returns the windows and the
    virtual cases."""
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    x, y = _lm_data(SP_STEPS * LM["batch"])
    mesh = meshlib.create_mesh(1, shape=(1, 1), axis_names=("data", "seq"))
    try:
        runs = {}
        for label, impl, dtype, policy in (
                ("flash_f32", "flash", "float32", "f32"),
                ("ring_flash_f32", "ring_flash", "float32", "f32"),
                ("ulysses_flash_f32", "ulysses_flash", "float32", "f32"),
                ("flash_bf16", "flash", "bfloat16", "bf16-f32master"),
                ("ring_flash_bf16", "ring_flash", "bfloat16",
                 "bf16-f32master")):
            runs[label] = _sp_window(impl, dtype, policy, mesh, x, y)
    finally:
        mesh.close()
    base, ring = runs["flash_f32"]["losses"], runs["ring_flash_f32"]["losses"]
    assert ring == base, ("f32 ring_flash not bitwise the flash GPT", ring,
                          base)
    assert runs["ulysses_flash_f32"]["losses"] == base, (
        runs["ulysses_flash_f32"]["losses"], base)
    base16 = runs["flash_bf16"]["losses"]
    ring16 = runs["ring_flash_bf16"]["losses"]
    assert ring16[0] == base16[0], ("bf16 ring_flash first loss", ring16,
                                    base16)
    drop_share = max(abs(r - b) / abs(b - base16[0])
                     for r, b in zip(ring16[1:], base16[1:]))
    assert drop_share <= SP_BF16_DROP_SHARE, (drop_share, ring16, base16)
    _sp_counts_ok("ring_flash f32", runs["ring_flash_f32"]["counts"], "tc32")
    _sp_counts_ok("ring_flash bf16", runs["ring_flash_bf16"]["counts"], "tc")
    _sp_counts_ok("ulysses_flash f32", runs["ulysses_flash_f32"]["counts"],
                  "tc32")
    for label, run in runs.items():
        steady = float(np.median(run["step_ms"][1:]))
        print(f"[sp] {gpu}: {label}: losses "
              f"{' '.join(repr(v) for v in run['losses'])} eager step ms "
              f"{' '.join(f'{t:.3f}' for t in run['step_ms'])} (median of "
              f"steps 2-4 {steady:.3f}) flash_launches="
              f"{json.dumps(run['counts'])}")
    print(f"[sp] f32 ring_flash and ulysses_flash losses bitwise the "
          f"flash GPT's over {SP_STEPS} steps; bf16 ring_flash first loss "
          f"bitwise, later ones within {drop_share:.3e} of the bf16 flash "
          f"GPT's drop (bound {SP_BF16_DROP_SHARE}); launches as counted "
          f"in all three SP windows")
    cases = []
    for case, dtype in ((SP_VIRTUAL[0], torch.float32),
                        (SP_VIRTUAL[0], torch.bfloat16),
                        (SP_VIRTUAL[1], torch.float32)):
        res = _sp_virtual_check(case, dtype)
        cases.append(res)
        print(f"[sp] virtual ring n={res['n']} {res['shape']} "
              f"{res['dtype']} {'causal' if res['causal'] else 'key mask'}:"
              f" launches {json.dumps(res['launches'])}, out max_abs_err "
              f"{res['out_max_abs_err']:.3e}, grads max_abs_err "
              f"{res['grad_max_abs_err']:.3e} ok")
    return {"runs": runs, "cases": cases}


def sp_timing_phase(sp: dict) -> list[dict]:
    """The ring's block kernels at the SP GPT's block shape (B=8, L=1024,
    H=8, D=64, the diagonal pairing, key mask of ones) beside their
    bounds, plain versions and SDPA: the f32 forward (tc32), the bf16
    forward (tc), and the f32 dQ and dK/dV (tc32) that ``flash_bwd_block``
    runs under both; then the bf16 backward's price of the f32 casts (the
    block backward on bf16 inputs against the tc dQ and dK/dV), and each
    virtual-rank case's device ms beside the whole sequence's kernels.
    Each kernel's row is held to its plain version on the same inputs
    before it is timed (f32 out and lse within F32_TOL, bf16 out within
    the tc bound, dQ and dK/dV within FLASH_GRAD_TOL).  Launches: the sp
    windows' counts."""
    from torch.nn.attention import sdpa_kernel

    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel import ring_attention as ra

    runs = sp["runs"]
    f32c, bf16c = runs["ring_flash_f32"]["counts"], \
        runs["ring_flash_bf16"]["counts"]
    b, lq, h, d = LM["batch"], LM["seq"], LM["heads"], 64
    scale = d ** -0.5
    mask = torch.ones(b, lq, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    cases = {torch.float32: _flash_case(80, b=b, lq=lq, h=h, d=d),
             torch.bfloat16: _flash_case(80, b=b, lq=lq, h=h, d=d,
                                         dtype=torch.bfloat16)}
    lib = {}
    for dtype, (q, k, v, do, _) in cases.items():
        backend = _sdpa_backend(dtype)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        with sdpa_kernel(backend):
            lib_fwd = lambda: sdpa(qt, kt, vt, is_causal=True)  # noqa: E731
            fwd_ms = _device_ms(lib_fwd, label=f"sp SDPA fwd {dtype}",
                                whole=True)
            o = lib_fwd()
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)
        lib[dtype] = (fwd_ms, _device_ms(lib_bwd, label=f"sp SDPA bwd "
                                         f"{dtype}", whole=True),
                      backend.name)
    src = "distributed_tensorflow_tpu_torch/ops/csrc/"
    # the f32 backward's inputs: what flash_bwd_block hands its kernels
    q, k, v, do, _ = cases[torch.float32]
    out, lse = fa._fwd_reference(q, k, v, mask, scale, True)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    plain_bwd = fa._bwd_reference(q, k, v, mask, do, lse, delta, scale, True)
    plain_bwd_ms = _device_ms(
        lambda: fa._bwd_reference(q, k, v, mask, do, lse, delta, scale,
                                  True), iters=5, warmup=1,
        label="sp plain bwd", whole=True)
    for name, kind, dtype, route, launches in (
            ("flash_fwd_block.ring_tc32", "fwd", torch.float32, "tc32",
             f32c["fwd_tc32"]),
            ("flash_fwd_block.ring_tc", "fwd", torch.bfloat16, "tc",
             bf16c["fwd_tc"]),
            ("flash_bwd_block.dq_ring_tc32", "dq", torch.float32, "tc32",
             f32c["dq_tc32"] + bf16c["dq_tc32"]),
            ("flash_bwd_block.dkv_ring_tc32", "dkv", torch.float32, "tc32",
             f32c["dkv_tc32"] + bf16c["dkv_tc32"])):
        qc, kc, vc, doc, _ = cases[dtype]
        if kind == "fwd":
            fn = lambda qc=qc, kc=kc, vc=vc: fa.flash_fwd_block(  # noqa: E731
                qc, kc, vc, mask, scale=scale, causal=True)
            got, got_lse = fn()
            want, want_lse = fa._fwd_reference(qc, kc, vc, mask, scale, True)
            plain_ms = _device_ms(
                lambda qc=qc, kc=kc, vc=vc: fa._fwd_reference(
                    qc, kc, vc, mask, scale, True), iters=5, warmup=1,
                label=f"sp plain fwd {dtype}", whole=True)
            # gated before it is timed: f32 within F32_TOL, bf16 within the
            # tc bound of the plain version; lse f32 on both routes
            torch.testing.assert_close(got_lse, want_lse, msg=name,
                                       **F32_TOL)
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, msg=name, **F32_TOL)
                err = float((got - want).abs().max())
            else:
                delta_c = (doc.float() * want.float()).sum(-1).transpose(1, 2)
                terms = fa._term_sums(qc, kc, vc, mask, doc, want_lse,
                                      delta_c.contiguous(), scale, True)[0]
                err, _ = _close_tc(name, got, want, terms)
            lib_ms = lib[dtype][0]
        else:
            cuda_fn = fa._dq_cuda if kind == "dq" else fa._dkv_cuda
            fn = lambda cuda_fn=cuda_fn: cuda_fn(  # noqa: E731
                q, k, v, mask, do, lse, delta, scale, True)
            got = fn()
            got = (got,) if kind == "dq" else got
            want = plain_bwd[:1] if kind == "dq" else plain_bwd[1:]
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, msg=name, **FLASH_GRAD_TOL)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            plain_ms, lib_ms = plain_bwd_ms, lib[dtype][1]
        ms = _device_ms(fn, label=f"sp {name}", whole=True)
        bound_ms, bound_by = _flash_bound_ms(
            kind, qc, kc, True, None,
            peak=TC32_FLOPS if route == "tc32" else None)
        rows.append({
            "name": name, "route": "cuda", "variant": route,
            "source": src + ("flash_attention_f32_sm90.cu" if route == "tc32"
                             else "flash_attention_sm90.cu"),
            "replaces": "distributed_tensorflow_tpu/ops/flash_attention.py:"
                        + {"fwd": "170", "dq": "281", "dkv": "299"}[kind],
            "shape": f"B={b} L={lq} H={h} D={d} "
                     f"{str(dtype).split('.')[-1]} ring diagonal block",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "library_ms": lib_ms,
            "library_backend": lib[dtype][2]})
        print(f"[sp] {name} ({route}) at the SP GPT's block: device "
              f"{ms:.5f} ms, plain {plain_ms:.5f}, SDPA {lib[dtype][2]} "
              f"{lib_ms:.5f}, bound {bound_ms:.6f} ({bound_by}), share "
              f"{bound_ms / ms:.3f}, launches {launches}, max_abs_err "
              f"{err:.3e}")
    # the price of the f32 casts under bf16: the block backward (casts +
    # tc32 dQ and dK/dV) against the tc dQ and dK/dV on the same inputs
    q16, k16, v16, do16, _ = cases[torch.bfloat16]
    out16, lse16 = fa._fwd_cuda(q16, k16, v16, mask, scale, True)
    delta16 = (do16.float() * out16.float()).sum(-1).transpose(1, 2)
    delta16 = delta16.contiguous()
    block_ms = _device_ms(lambda: fa.flash_bwd_block(
        q16, k16, v16, mask, do16, lse16, delta16, scale=scale,
        causal=True), label="sp bf16 block bwd (f32 casts + tc32)")
    tc_ms = _device_ms(lambda: (
        fa._dq_cuda(q16, k16, v16, mask, do16, lse16, delta16, scale, True,
                    route="tc"),
        fa._dkv_cuda(q16, k16, v16, mask, do16, lse16, delta16, scale,
                     True, route="tc")), label="sp bf16 tc dq+dkv")
    print(f"[sp] bf16 ring backward per layer at B={b} L={lq} H={h} D={d}: "
          f"flash_bwd_block (f32 casts + tc32 dQ and dK/dV) {block_ms:.5f} "
          f"ms device against the tc dQ + dK/dV {tc_ms:.5f} ms: the casts' "
          f"route costs {block_ms - tc_ms:.5f} ms a layer, "
          f"{LM['layers'] * (block_ms - tc_ms):.4f} ms a step of "
          f"{LM['layers']} layers")
    eager = {label: float(np.median(run["step_ms"][1:]))
             for label, run in runs.items()}
    print(f"[sp] eager step ms (median of steps 2-4): ring_flash f32 "
          f"{eager['ring_flash_f32']:.3f} vs flash f32 "
          f"{eager['flash_f32']:.3f}; ring_flash bf16-f32master "
          f"{eager['ring_flash_bf16']:.3f} vs flash "
          f"{eager['flash_bf16']:.3f}; ulysses_flash f32 "
          f"{eager['ulysses_flash_f32']:.3f}")
    for res in sp["cases"]:
        q, k, v, mask_v, do, scale_v = res["inputs"]
        n, causal = res["n"], res["causal"]

        def whole(q=q, k=k, v=v, m=mask_v, do=do, s=scale_v, c=causal):
            out, lse = fa.flash_fwd_block(q, k, v, m, scale=s, causal=c)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
            return fa.flash_bwd_block(q, k, v, m, do, lse,
                                      delta.contiguous(), scale=s, causal=c)

        virtual_ms = _device_ms(
            lambda q=q, k=k, v=v, m=mask_v, do=do, s=scale_v, c=causal,
            n=n: ra.virtual_ring(q, k, v, m, do, n, causal=c, scale=s),
            iters=10, warmup=2, label=f"sp virtual ring n={n}")
        whole_ms = _device_ms(whole, iters=10, warmup=2,
                              label=f"sp whole sequence n={n}")
        res["virtual_ms"], res["whole_ms"] = virtual_ms, whole_ms
        print(f"[sp] virtual ring n={n} {res['shape']} {res['dtype']} "
              f"{'causal' if causal else 'key mask'}: forward + backward "
              f"{virtual_ms:.5f} ms device (all pairings, merges and casts) "
              f"against the whole sequence's block kernels "
              f"{whole_ms:.5f} ms")
    return rows


# ------------------------------------------------------------ phase moe
# bench.py --moe (bench_moe, bench.py:1101-1160): the bench --lm GPT with
# every FFN swapped for 8 routed experts (top-1, capacity factor 1.25),
# against the dense twin at the same widths and seed: both bf16 compute
# over f32 parameters, flash attention, dropout 0, SyncEngine on a 1-rank
# NCCL mesh.  8192 tokens a step route in _moe_group_size(8192) = 8 groups
# of 1024 with int(1.25·1024/8 + 0.999999) = 160 slots per expert.
MOE_GPT = dict(experts=8, top_k=1, capacity_factor=1.25, groups=8,
               group=1024, capacity=160)
# bench_moe's protocol on the graph path: replayed chunks of 3 and 13
# steps, the step time (t13 - t3) / 10, repeated
MOE_CHUNKS, MOE_REPEATS = (3, 13), 3
# the MoE layer on the card against the CPU at bf16: each of its four
# einsums rounds its output to bf16 (relative 2^-8) on both sides, with
# f32 sums in other orders, so an output may differ by a few roundings of
# the terms before it: element-wise within MOE_LAYER_TOL, and a relative
# Frobenius error under TC_FROBENIUS.  The router runs in f32 on both
# sides from the same bf16 input: a token whose two largest router
# probabilities lie within MOE_TIE_GAP is a tie, the one difference of
# dispatch allowed (its group is then left out of the comparison)
MOE_LAYER_TOL = dict(rtol=2e-2, atol=2e-2)
MOE_TIE_GAP = 1e-5
# ExpertParallelEngine on the (1, 1) mesh: MoEClassifier at the JAX CLI
# test's setting (8 experts, synthetic 28×28 data), MOE_EP_STEPS steps of
# batch 32 each with top-1 and top-2; the f32 engine's first task loss
# within MOE_EP_RTOL of SyncEngine's on the same model and batch (one
# rank's routing is the global routing, its all-to-all a copy; the router
# sums run in another order)
MOE_EP_STEPS, MOE_EP_RTOL = 32, 1e-5


def _moe_gpt(moe: bool):
    """The bench --moe GPT (``moe``) or its dense twin."""
    from distributed_tensorflow_tpu_torch.models import create_model

    extra = (dict(moe_experts=MOE_GPT["experts"], moe_top_k=MOE_GPT["top_k"],
                  moe_capacity_factor=MOE_GPT["capacity_factor"])
             if moe else {})
    return create_model("gpt", num_classes=LM["vocab"], hidden=LM["hidden"],
                        layers=LM["layers"], heads=LM["heads"],
                        ffn=LM["ffn"], max_len=LM["seq"], dropout_rate=0.0,
                        dtype="bfloat16", attention_impl="flash", **extra)


def _moe_window(moe: bool, mesh, x, y) -> dict:
    """bench_moe's protocol for one model on the graph path: the chunks of
    3 and 13 steps each run eagerly once, then are captured and replayed;
    then MOE_REPEATS repeats of (t3, t13) on the host clock around a
    replay each (synchronized).  Returns the losses of the first chunks in
    step order, the rates, the flash launches of the whole window, the
    engine and its state."""
    from distributed_tensorflow_tpu_torch.engines import SyncEngine
    from distributed_tensorflow_tpu_torch.engines.sync import _ChunkGraph

    model = _moe_gpt(moe)
    eng = SyncEngine(model, mesh=mesh)
    state = eng.init_state(torch.Generator().manual_seed(0))
    xs, ys = eng.shard_batch(x, y)
    torch.cuda.synchronize()
    _reset_flash_counts()
    captures = _ChunkGraph.captures
    steps, losses = 0, []
    for k in MOE_CHUNKS:
        for _ in range(2):           # eager, then captured and replayed
            state, m = eng.many_step(state, [xs] * k, [ys] * k)
            losses += m["loss"].tolist()
            steps += k
    assert _ChunkGraph.captures - captures == len(MOE_CHUNKS)
    rates = []
    tokens = LM["batch"] * LM["seq"]
    for _ in range(MOE_REPEATS):
        t = {}
        for k in MOE_CHUNKS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = eng.many_step(state, [xs] * k, [ys] * k)
            torch.cuda.synchronize()
            t[k] = time.perf_counter() - t0
            steps += k
        short, long = MOE_CHUNKS
        rates.append(tokens * (long - short) / (t[long] - t[short]))
    counts = {**_flash_counts(), **_tc32_counts()}
    return {"losses": losses, "rates": rates, "counts": counts,
            "steps": steps, "engine": eng, "state": state, "model": model,
            "last_loss": float(m["loss"][-1])}


def _median_spread(vals):
    """(median, spread) as bench.py's ``_median_spread`` for fewer than 5
    values: (max - min) / median."""
    med = float(np.median(vals))
    return med, (max(vals) - min(vals)) / med if med else 0.0


def _moe_layer_card_vs_cpu(model, x) -> dict:
    """Block 0's MoE layer on its input from the trained model's forward
    (8192 tokens of width 512, bf16): on the card and, with the same
    parameters, on the CPU; dispatch (the keep mask and slots) and
    overflow equal, save for a router tie, and the outputs within
    MOE_LAYER_TOL."""
    from distributed_tensorflow_tpu_torch.models.moe import (
        _moe_group_size, moe_ffn)

    layer = model.blocks[0].moe
    seen = []
    handle = layer.register_forward_pre_hook(
        lambda mod, args, kw: seen.append(args[0].detach().clone()),
        with_kwargs=True)
    try:
        with torch.no_grad():
            model(torch.as_tensor(x, device="cuda").long())
    finally:
        handle.remove()
    tokens = seen[0]                             # (8192, 512) bf16
    gs = _moe_group_size(tokens.shape[0])
    assert (gs, layer.capacity(gs)) == (MOE_GPT["group"],
                                        MOE_GPT["capacity"]), gs
    g = tokens.shape[0] // gs
    out = {}
    cpu_layer = type(layer)(layer.d, layer.num_experts, layer.hidden,
                            layer.capacity_factor, layer.router_top_k,
                            dtype=layer.dtype, device="cpu")
    cpu_layer.load_state_dict({k: v.cpu() for k, v in
                               layer.state_dict().items()})
    for dev, lay in (("cuda", layer), ("cpu", cpu_layer)):
        t0 = time.perf_counter()
        xt = tokens.to(dev)
        with torch.no_grad():
            dispatch, _ = lay.route(xt.reshape(g, gs, -1))
            y = moe_ffn(lay, xt.reshape(1, *xt.shape))[0]
        out[dev] = (dispatch.cpu(), float(lay.overflow), y.float().cpu(),
                    time.perf_counter() - t0)
    (d1, o1, y1, t1), (d0, o0, y0, t0) = out["cuda"], out["cpu"]
    with torch.no_grad():
        probs = torch.softmax(tokens.cpu().float() @ cpu_layer.gate, -1)
    top = probs.sort(dim=-1).values
    tie = ((top[:, -1] - top[:, -2]) < MOE_TIE_GAP).reshape(g, gs).any(1)
    keep = ~tie
    if tie.any():
        print(f"[moe] router tie(s) within {MOE_TIE_GAP} in group(s) "
              f"{tie.nonzero().flatten().tolist()}: left out of the "
              f"card-vs-CPU comparison")
    else:
        assert o1 == o0, (o1, o0)
    assert torch.equal(d1[keep], d0[keep])
    y1g, y0g = y1.reshape(g, gs, -1)[keep], y0.reshape(g, gs, -1)[keep]
    torch.testing.assert_close(y1g, y0g, **MOE_LAYER_TOL)
    frob = float((y1g - y0g).norm() / y0g.norm())
    assert frob < TC_FROBENIUS, frob
    err = float((y1g - y0g).abs().max())
    print(f"[moe] block 0's MoE layer at full width (8192 x 512 bf16, "
          f"{g} groups of {gs}, capacity {layer.capacity(gs)}): card vs "
          f"CPU dispatch equal in {int(keep.sum())}/{g} groups, overflow "
          f"card {o1!r} CPU {o0!r}, outputs max_abs_err {err:.3e} (tol "
          f"{MOE_LAYER_TOL}), rel Frobenius {frob:.3e}; "
          f"card {t1:.3f}s CPU {t0:.3f}s")
    return {"overflow": o1, "max_abs_err": err, "frobenius": frob,
            "ties": int(tie.sum())}


def _moe_step_split(engine, state, x, y, label: str) -> dict:
    """Where one step's device time goes (``torch.profiler``, input shapes
    recorded): the flash kernels by name; the MoE einsums' GEMMs
    (``aten::bmm``, forward and backward) by their shapes — a matrix side
    of the expert hidden width (2048) is an expert GEMM, of E·C = 1280 or
    C = 160 a dispatch/combine einsum, the rest the router's logits — and
    all other kernels (the router's softmax, argmax, one-hots and cumsums,
    LayerNorms, the head, Adam) as the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = 4
    xs, ys = engine.shard_batch(x, y)
    engine.step(state, xs, ys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step(state, xs, ys)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(steps):
            engine.step(state, xs, ys)
        torch.cuda.synchronize()
    kernels = [(e.self_device_time_total / steps / 1e3, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation
               and e.self_device_time_total > 0]
    busy = sum(ms for ms, _ in kernels)
    if not busy:
        print(f"[moe] {label}: no device time in the trace: not measured")
        return {}
    flash = sum(ms for ms, key in kernels
                if re.search(r"flash_(fwd|dq|dkv)(_tc32|_tc)?_kernel", key))
    split = {"expert_gemm": 0.0, "dispatch_combine": 0.0, "router_gemm": 0.0}
    ec = MOE_GPT["experts"] * MOE_GPT["capacity"]
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key != "aten::bmm" or not e.device_time_total:
            continue
        dims = {d for shape in e.input_shapes for d in shape[1:]}
        kind = ("expert_gemm" if LM["ffn"] in dims else
                "dispatch_combine" if dims & {ec, MOE_GPT["capacity"]}
                else "router_gemm")
        split[kind] += e.device_time_total / steps / 1e3
    rest = busy - flash - sum(split.values())
    res = {"wall_ms": wall_ms, "device_busy_ms": busy, "attention_ms": flash,
           **{f"{k}_ms": v for k, v in split.items()}, "rest_ms": rest}
    print(f"[moe] {label} step profile (B=8, L=1024, bf16, eager): "
          + " ".join(f"{k}={v:.4f}" for k, v in res.items())
          + f" busy_share={busy / wall_ms:.4f}")
    for ms, key in sorted(kernels, reverse=True)[:12]:
        print(f"[moe]   {ms * 1e3:9.2f} us/step {key[:100]}")
    return res


def _moe_ep_window(mesh, k: int, x, y) -> dict:
    """MoEClassifier (8 experts, top-``k``) for MOE_EP_STEPS steps under
    ExpertParallelEngine on the (1, 1) mesh with the default router
    weights and the z-loss on, beside SyncEngine's first step at f32."""
    from distributed_tensorflow_tpu_torch.engines import (
        ExpertParallelEngine, SyncEngine)
    from distributed_tensorflow_tpu_torch.engines.expert_parallel import (
        router_losses)
    from distributed_tensorflow_tpu_torch.models import create_model

    first = {}
    for cls in (SyncEngine, ExpertParallelEngine):
        model = create_model("moe", router_top_k=k)
        kw = dict(router_z_weight=1e-3) if cls is ExpertParallelEngine else {}
        eng = cls(model, mesh=mesh, **kw)
        state = eng.init_state(torch.Generator().manual_seed(0), x[:1])
        xs, ys = eng.shard_batch(x[:32], y[:32])
        state, m = eng.step(state, xs, ys)
        first[cls.__name__] = float(m["loss"])
    losses, gaps, overflow = [float(m["loss"])], [], [float(m["overflow"])]
    for i in range(1, MOE_EP_STEPS):
        xs, ys = eng.shard_batch(x[32 * i:32 * i + 32],
                                 y[32 * i:32 * i + 32])
        state, m = eng.step(state, xs, ys)
        aux, z, _ = router_losses(model)
        gaps.append(abs(float(m["total_loss"]) - float(m["loss"])
                        - (eng.aux_weight * float(aux.detach())
                           + eng.router_z_weight * float(z.detach()))))
        losses.append(float(m["loss"]))
        overflow.append(float(m["overflow"]))
    rel = (abs(first["ExpertParallelEngine"] - first["SyncEngine"])
           / abs(first["SyncEngine"]))
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses
    assert max(gaps) <= 1e-6, max(gaps)
    assert all(0.0 <= o <= 1.0 for o in overflow), overflow
    assert rel <= MOE_EP_RTOL, first
    print(f"[moe] ExpertParallelEngine (1, 1) NCCL mesh, MoEClassifier "
          f"top-{k}, {MOE_EP_STEPS} steps of 32: task loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}, overflow "
          f"{min(overflow):.4f}..{max(overflow):.4f}, max |total - task - "
          f"weighted router terms| {max(gaps):.2e}, first task loss vs "
          f"SyncEngine rel {rel:.2e} (bound {MOE_EP_RTOL})")
    return {"losses": losses, "first": first}


def moe_phase(gpu: str) -> dict:
    """Phase moe: the ``bench.py --moe`` GPT and its dense twin through
    bench_moe's protocol on replayed chunks (the main path: every count
    set to 0 before the MoE window and read after it), the gates, block
    0's MoE layer on the card against the CPU, the step profile, then
    ExpertParallelEngine on a (1, 1) NCCL mesh."""
    from distributed_tensorflow_tpu_torch.data import load_dataset
    from distributed_tensorflow_tpu_torch.engines import Engine, SyncEngine
    from distributed_tensorflow_tpu_torch.engines.expert_parallel import (
        router_losses)
    from distributed_tensorflow_tpu_torch.models.moe import _moe_group_size
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    tokens = LM["batch"] * LM["seq"]
    gs = _moe_group_size(tokens)
    groups = tokens // gs
    capacity = int(MOE_GPT["capacity_factor"] * gs / MOE_GPT["experts"]
                   + 0.999999)
    print(f"[moe] routing shape: {tokens} tokens, {groups} groups of {gs}, "
          f"capacity {capacity}")
    assert (groups, gs, capacity) == (MOE_GPT["groups"], MOE_GPT["group"],
                                      MOE_GPT["capacity"])
    x, y = _lm_data(LM["batch"])
    torch.cuda.empty_cache()
    mesh = meshlib.create_mesh(1)
    try:
        dense = _moe_window(False, mesh, x, y)
        dense_state = (dense.pop("engine"), dense.pop("state"),
                       dense.pop("model"))
        moe = _moe_window(True, mesh, x, y)
        # the replayed chunk against eager chunks from the same state: a
        # twin from the seed runs the first two chunks eagerly
        twin = SyncEngine(_moe_gpt(True), mesh=mesh)
        tstate = twin.init_state(torch.Generator().manual_seed(0))
        txs, tys = twin.shard_batch(x, y)
        eager = []
        for _ in range(2):
            tstate, m = Engine.many_step(twin, tstate, [txs] * 3, [tys] * 3)
            eager += m["loss"].tolist()
        del twin, tstate
        _, _, overflow = router_losses(moe["model"])
        overflow = float(overflow)
        layer = _moe_layer_card_vs_cpu(moe["model"], x)
        split = _moe_step_split(moe["engine"], moe["state"], x, y, "MoE")
        dense_split = _moe_step_split(*dense_state[:2], x, y, "dense")
        del dense_state
        moe.pop("engine"), moe.pop("state"), moe.pop("model")
        torch.cuda.empty_cache()
        ep = {}
        ds = load_dataset("synthetic")
        ep_mesh = meshlib.create_mesh(1, shape=(1, 1),
                                      axis_names=("data", "expert"))
        try:
            for k in (1, 2):
                ep[k] = _moe_ep_window(ep_mesh, k, ds.x, ds.y)
        finally:
            ep_mesh.close()
    finally:
        mesh.close()
    losses = moe["losses"]
    assert all(np.isfinite(losses[:16])), losses
    assert losses[15] < losses[0], losses[:16]
    assert moe["losses"][:6] == eager, (moe["losses"][:6], eager)
    assert 0.0 <= overflow <= 1.0, overflow
    # 8 forwards, 8 dQ and 8 dK/dV a step, every one on tc
    for run in (moe, dense):
        n = LM["layers"] * run["steps"]
        want = {"fwd": n, "dq": n, "dkv": n, "fwd_tc": n, "dq_tc": n,
                "dkv_tc": n, "fwd_tc32": 0, "dq_tc32": 0, "dkv_tc32": 0}
        assert run["counts"] == want, (run["counts"], want)
    rows = {}
    for kind, run in (("dense", dense), ("moe", moe)):
        med, spread = _median_spread(run["rates"])
        rows[kind] = (med, spread)
    result = {
        "metric": "gpt_moe_sync_tokens_per_sec_per_chip",
        "dense_tokens_per_sec_per_chip": rows["dense"][0],
        "dense_spread": rows["dense"][1],
        "moe_tokens_per_sec_per_chip": rows["moe"][0],
        "moe_spread": rows["moe"][1],
        "moe_vs_dense": rows["moe"][0] / rows["dense"][0],
        "dense_step_ms": tokens / rows["dense"][0] * 1e3,
        "moe_step_ms": tokens / rows["moe"][0] * 1e3,
        "moe_rates": moe["rates"], "dense_rates": dense["rates"],
    }
    print(f"[moe] {gpu}: bench --moe on replayed chunks of "
          f"{MOE_CHUNKS[0]} and {MOE_CHUNKS[1]} steps, {MOE_REPEATS} "
          f"repeats: {json.dumps(result)}")
    print(f"[moe] losses (first {len(losses)} steps, chunks "
          f"{MOE_CHUNKS[0]},{MOE_CHUNKS[0]},{MOE_CHUNKS[1]},"
          f"{MOE_CHUNKS[1]}): {' '.join(f'{v:.4f}' for v in losses)}; "
          f"replayed chunk bitwise the eager chunk; overflow "
          f"{overflow!r}; flash launches {json.dumps(moe['counts'])} over "
          f"{moe['steps']} steps (8 + 8 + 8 a step, all tc)")
    return {"counts": moe["counts"], "steps": moe["steps"],
            "result": result, "layer": layer, "split": split,
            "dense_split": dense_split, "ep": ep}


# --------------------------------------------------------------------------
# phase 5i: checkpoint, resume and failure on the cli-lm GPT
# --------------------------------------------------------------------------

CKPT_STOP_AT = 300       # C2's should_stop fires at the first boundary >=
CKPT_EVERY = 128


def _ckpt_config(**kw):
    """The ``CLI_LM_ARGV`` run as an ``ExperimentConfig``: the cli-lm GPT
    on ``lm_synth`` at B = 8, flash attention, the stock Adam at a
    constant learning rate (so the trajectory does not depend on the
    epoch count), 2 epochs at steps_per_call 8."""
    from distributed_tensorflow_tpu_torch.utils.harness import (
        ExperimentConfig)

    base = dict(engine="sync", model="gpt", dataset="lm_synth",
                n_devices=1, batch_size=CLI_LM["batch"], epochs=2, seed=0,
                log_every=0, attention_impl="flash", steps_per_call=8,
                model_args=dict(hidden=512, layers=CLI_LM["layers"],
                                heads=CLI_LM["heads"], ffn=2048))
    base.update(kw)
    return ExperimentConfig(**base)


def _kept_run(config, on_chunk=None):
    """``harness.run(config)`` and the Trainer it trained;
    ``on_chunk(n)`` is called after the run's n-th chunk is dispatched."""
    from distributed_tensorflow_tpu_torch.utils import harness

    kept = {}

    class Keeper(harness.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            kept["trainer"] = self
            if on_chunk is not None:
                chunk, n = self.engine.many_step, [0]

                def many_step(*a, **k):
                    out = chunk(*a, **k)
                    n[0] += 1
                    on_chunk(n[0])
                    return out

                self.engine.many_step = many_step

    saved = harness.Trainer
    harness.Trainer = Keeper
    try:
        summary = harness.run(config)
    finally:
        harness.Trainer = saved
    return summary, kept["trainer"]


def _same_state(a, b) -> bool:
    """Every tensor of two states' checkpoints bitwise equal (and the
    steps)."""
    da, db = (s.engine.checkpoint_state(s) for s in (a, b))
    return da.keys() == db.keys() and all(
        torch.equal(v, db[k]) if isinstance(v, torch.Tensor) else v == db[k]
        for k, v in da.items())


def _ckpt_bytes(path) -> dict:
    """Bytes of a checkpoint file's parameters, optimizer and master."""
    d = torch.load(path, weights_only=True)
    out = {"params": 0, "optimizer": 0, "master": 0, "other": 0}
    for k, v in d.items():
        kind = {"model": "params", "opt": "optimizer", "master": "master"
                }.get(k.split("/")[0], "other")
        out[kind] += v.numel() * v.element_size()
    out["file"] = path.stat().st_size
    return out


def _ckpt_launches(label, counts, steps, evals, route) -> None:
    """Flash launches of a C window: 8 a step (+ 8 forwards an eval
    batch), every one on ``route``."""
    layers = CLI_LM["layers"]
    fwd, bwd = layers * (steps + evals), layers * steps
    other = "tc" if route == "tc32" else "tc32"
    want = {"fwd": fwd, "dq": bwd, "dkv": bwd, f"fwd_{route}": fwd,
            f"dq_{route}": bwd, f"dkv_{route}": bwd, f"fwd_{other}": 0,
            f"dq_{other}": 0, f"dkv_{other}": 0}
    assert counts == want, (label, counts, want)


def _c2_window(gpu, tmp):
    """C2: bf16-f32master, a should_stop drain at 304, a fresh engine's
    elastic restore, against an uninterrupted fit."""
    from distributed_tensorflow_tpu_torch.elastic import elastic_restore
    from distributed_tensorflow_tpu_torch.engines import Trainer
    from distributed_tensorflow_tpu_torch.utils import harness
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        AsyncCheckpointManager)

    cfg = _ckpt_config(precision="bf16-f32master")

    def fit(**kw):
        ex = harness._setup(harness._resolve_precision(cfg))
        tr = Trainer(None, engine=ex.engine, seed=0)
        if "restore" in kw:
            template = ex.engine.init_state(
                torch.Generator().manual_seed(0), ex.train_ds.x[:1])
            tr.state, extra = elastic_restore(kw.pop("restore"), ex.engine,
                                              template)
            kw["data_state"] = extra["data_state"]
        with harness._repeatable_math():
            r = tr.fit(ex.train_ds, epochs=1, batch_size=ex.global_batch,
                       log_every=0, steps_per_call=8, **kw)
        torch.cuda.synchronize()
        ex.mesh.close()
        return tr, r

    _reset_flash_counts()
    whole, rw = fit()
    mgr = AsyncCheckpointManager(f"{tmp}/c2")
    stopped, rs = fit(checkpoint_manager=mgr, should_stop=lambda s: (
        "preempt" if s >= CKPT_STOP_AT else None))
    resumed, rr = fit(restore=mgr)
    counts = {**_flash_counts(), **_tc32_counts()}
    mgr.close()
    steps = rw["steps"]
    assert rs["preempted"] == "preempt" and rs["steps"] == 304, rs
    assert mgr.steps() == [304] and rs["data_state"]["batch_index"] == 304
    assert rr["start_step"] == 304 and rr["steps"] == steps - 304, rr
    assert rr["resume_replay_steps"] == 0, rr
    _ckpt_launches("C2", counts, 2 * steps, 0, "tc")
    checks = {
        "bf16 params": all(torch.equal(p, q) for p, q in zip(
            whole.state.model.parameters(), resumed.state.model.parameters())),
        "f32 master": torch.equal(whole.state.optimizer.master,
                                  resumed.state.optimizer.master),
        "whole state": _same_state(whole.state, resumed.state)}
    assert all(checks.values()), checks
    nbytes = _ckpt_bytes(mgr.directory / "step_304" / "state.pt")
    print(f"[ckpt] C2 ({gpu}): bf16-f32master fit, should_stop at "
          f"{CKPT_STOP_AT} drained at boundary {rs['steps']} with the "
          f"final checkpoint (data state batch "
          f"{rs['data_state']['batch_index']}); a fresh engine restored "
          f"it and trained {rr['steps']} steps: bitwise the uninterrupted "
          f"fit {json.dumps(checks)}; flash launches {json.dumps(counts)} "
          f"(all tc); checkpoint bytes {json.dumps(nbytes)}")
    del whole, stopped, resumed
    return counts, nbytes


def ckpt_phase(gpu: str) -> dict:
    """Phase 5i (module docstring): C0–C4 on the cli-lm GPT; returns the
    C windows' flash launches by route."""
    import dataclasses
    import shutil
    import tempfile

    from distributed_tensorflow_tpu_torch.data import loaders
    from distributed_tensorflow_tpu_torch.engines import Trainer
    from distributed_tensorflow_tpu_torch.parallel import precision as tpl
    from distributed_tensorflow_tpu_torch.utils import failure, harness
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    train = loaders.load_dataset("lm_synth", split="train")
    test = loaders.load_dataset("lm_synth", split="test")
    epoch = len(train) // CLI_LM["batch"]
    evals = -(-len(test) // 100)
    print(f"[ckpt] predicted flash launches: C0 {CLI_LM['layers']} x "
          f"({2 * epoch} steps + {evals} eval batches) forwards, "
          f"{CLI_LM['layers']} x {2 * epoch} dQ and dK/dV, all tc32; C1 "
          f"{CLI_LM['layers']} x ({2 * epoch} + {2 * evals}) forwards (two "
          f"runs' evals), the same backward; C2 {CLI_LM['layers']} x "
          f"{2 * epoch} (uninterrupted {epoch} + 304 + {epoch - 304}) of "
          f"each, all tc")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # C0: the reference trajectory, no checkpoint
        _reset_flash_counts()
        c0, t0 = _kept_run(_ckpt_config())
        torch.cuda.synchronize()
        c0_counts = {**_flash_counts(), **_tc32_counts()}
        _ckpt_launches("C0", c0_counts, 2 * epoch, evals, "tc32")
        print(f"[ckpt] C0 ({gpu}): {c0['steps']} steps, test_loss "
              f"{c0['test_loss']!r}, step_ms_p50 "
              f"{c0['run_report']['step_time_p50_s'] * 1e3:.4f} (no "
              f"checkpoint); flash launches {json.dumps(c0_counts)}")

        # C1: crash after the first epoch, recovered from its checkpoint
        crashed = {}

        def crash_once(config):
            if not crashed:
                crashed["summary"], _ = _kept_run(
                    dataclasses.replace(config, epochs=1))
                # C3 compares this run's step-256 checkpoint (retention
                # keeps three steps, so it goes at the end of the epoch)
                shutil.copytree(f"{tmp}/c1/step_256", f"{tmp}/c1_256")
                raise RuntimeError("injected crash after epoch 1")
            crashed["resumed"], crashed["trainer"] = _kept_run(config)
            return crashed["resumed"]

        _reset_flash_counts()
        c1 = failure.run_with_recovery(
            _ckpt_config(checkpoint_dir=f"{tmp}/c1",
                         checkpoint_every=CKPT_EVERY),
            max_restarts=1, run_fn=crash_once)
        torch.cuda.synchronize()
        c1_counts = {**_flash_counts(), **_tc32_counts()}
        t1 = crashed["trainer"]
        fit1 = t1.history[-1]
        rep = c1["run_report"]
        checks = {
            "params": all(torch.equal(a, b) for a, b in zip(
                t0.state.model.state_dict().values(),
                t1.state.model.state_dict().values())),
            "whole state": _same_state(t0.state, t1.state),
            "test_loss": c1["test_loss"] == c0["test_loss"]}
        assert all(checks.values()), checks
        assert c1["restarts"] == 1 and rep["resume_replay_steps"] == 0, rep
        assert fit1["start_step"] == epoch and c1["steps"] == epoch, fit1
        assert rep["restored_step"] == epoch, rep
        _ckpt_launches("C1", c1_counts, 2 * epoch, 2 * evals, "tc32")
        first = crashed["summary"]["run_report"]
        print(f"[ckpt] C1 ({gpu}): run_with_recovery, 1 restart through "
              f"elastic_restore from step {rep['restored_step']} "
              f"(preemption_lost_s {rep['preemption_lost_s']:.3f}, "
              f"resume_replay_steps {rep['resume_replay_steps']}, "
              f"start_step {fit1['start_step']}): bitwise C0 "
              f"{json.dumps(checks)}; test_loss {c1['test_loss']!r}; flash "
              f"launches {json.dumps(c1_counts)}")
        c1_bytes = _ckpt_bytes(Path(tmp) / "c1" / f"step_{2 * epoch}"
                               / "state.pt")
        print(f"[ckpt] checkpoint bytes, f32 ({gpu}): "
              f"{json.dumps(c1_bytes)}")

        # C3: the synchronous writer's step-256 checkpoint, tensor by
        # tensor the async run's; an f32 checkpoint into bf16-f32master
        c3, _ = _kept_run(_ckpt_config(
            epochs=1, checkpoint_dir=f"{tmp}/c3",
            checkpoint_every=CKPT_EVERY, async_checkpoint=False,
            watchdog_timeout=30.0))
        a = torch.load(f"{tmp}/c1_256/state.pt", weights_only=True)
        b = torch.load(f"{tmp}/c3/step_256/state.pt", weights_only=True)
        assert a.keys() == b.keys() and all(
            torch.equal(v, b[k]) for k, v in a.items()), "C3 sync != async"
        ex = harness._setup(harness._resolve_precision(
            _ckpt_config(precision="bf16-f32master")))
        template = ex.engine.init_state(torch.Generator().manual_seed(0),
                                        ex.train_ds.x[:1])
        adopted = tpl.restore_into_policy(CheckpointManager(f"{tmp}/c3"),
                                          template, ex.engine.precision)
        tr = Trainer(None, engine=ex.engine, seed=0)
        tr.state = adopted
        lines = []
        with harness._repeatable_math():
            r = tr.fit(ex.train_ds, epochs=1, batch_size=ex.global_batch,
                       log_every=1, log_fn=lines.append, steps_per_call=8,
                       max_steps=8)
        ex.mesh.close()
        assert r["steps"] == 8 and r["start_step"] == epoch, r
        losses = [float(line.split()[3]) for line in lines]
        assert len(losses) == 8 and all(np.isfinite(losses)), lines
        print(f"[ckpt] C3 ({gpu}): the sync writer's step-256 checkpoint "
              f"equals the async writer's in all {len(a)} tensors; the f32 "
              f"checkpoint of step {epoch} adopted into bf16-f32master "
              f"trained 8 steps, losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}")
        del tr, adopted, template, ex

        # the save's wall time and the two writers' accounting
        sync = CheckpointManager(f"{tmp}/timed", max_to_keep=1)
        walls = []
        for i in range(3):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            sync.save(t0.state, step=i)
            walls.append(time.perf_counter() - ts)
        c3r = c3["run_report"]
        print(f"[ckpt] ({gpu}) the synchronous save of the f32 state "
              f"({c1_bytes['file']} bytes): "
              f"{' '.join(f'{w:.4f}' for w in walls)} s; "
              f"at --checkpoint-every {CKPT_EVERY} over {epoch} steps: "
              f"async checkpoint_wait_s {first['checkpoint_wait_s']:.4f} "
              f"against checkpoint_overlapped_s "
              f"{first['checkpoint_overlapped_s']:.4f}, sync "
              f"{c3r['checkpoint_wait_s']:.4f} against "
              f"{c3r['checkpoint_overlapped_s']:.4f}; step_ms_p50 without "
              f"checkpoints {c0['run_report']['step_time_p50_s'] * 1e3:.4f}"
              f", async {first['step_time_p50_s'] * 1e3:.4f}, sync "
              f"{c3r['step_time_p50_s'] * 1e3:.4f}; step_ms_mean "
              f"{c0['run_report']['step_time_mean_s'] * 1e3:.4f} / "
              f"{first['step_time_mean_s'] * 1e3:.4f} / "
              f"{c3r['step_time_mean_s'] * 1e3:.4f}")

        # C4: the watchdog
        wd = c3r["watchdog"]
        assert wd["beats"] > 0 and wd["stall_episodes"] == 0, wd
        with failure.Watchdog(timeout=0.2, poll_interval=0.02) as dog:
            dog.beat()
            ts = time.perf_counter()
            torch.cuda._sleep(2_000_000_000)   # ~1 s of device spin
            torch.cuda.synchronize()
            waited = time.perf_counter() - ts
            stalled, episodes = dog.stalled, dog.stall_episodes
            dog.beat()
            time.sleep(0.1)
            rearmed = not dog.stalled
        assert waited > 0.4 and stalled and episodes == 1 and rearmed, (
            waited, stalled, episodes, rearmed)
        print(f"[ckpt] C4 ({gpu}): a fit under a 30 s watchdog: "
              f"{wd['beats']} beats, {wd['stall_episodes']} stalls "
              f"(timeout {wd['timeout_s']} s after rescale); a 0.2 s "
              f"watchdog around a {waited:.3f} s device wait: "
              f"{episodes} stall episode, re-armed after the next beat")
        # phase 5q's uninterrupted twin: C0's final state
        c0_state = {k: v.clone() if isinstance(v, torch.Tensor) else v
                    for k, v in t0.state.engine.checkpoint_state(
                        t0.state).items()}
        del t0, t1, crashed
        c2_counts, c2_bytes = _c2_window(gpu, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"tc32": {k: c0_counts[f"{k}_tc32"] + c1_counts[f"{k}_tc32"]
                     for k in ("fwd", "dq", "dkv")},
            "tc": {k: c2_counts[f"{k}_tc"] for k in ("fwd", "dq", "dkv")},
            "bytes_f32": c1_bytes, "bytes_bf16_f32master": c2_bytes,
            "c0": {"state": c0_state, "test_loss": c0["test_loss"],
                   "steps": c0["steps"]}}


# --------------------------------------------------------------------------
# phase 5j: gradient codecs and bucketed overlap on the cli-lm GPT
# --------------------------------------------------------------------------

CODEC_BUCKET_MB = 4
CODEC_RUNS = {
    "G-base": [],
    "G0": ["--grad-bucket-mb", str(CODEC_BUCKET_MB)],
    "G1": ["--grad-compression", "bf16"],
    "G2": ["--grad-compression", "int8"],
    "G3": ["--grad-compression", "int8", "--grad-bucket-mb",
           str(CODEC_BUCKET_MB), "--grad-accum", "2"],
    "G4": ["--precision", "bf16-f32master", "--grad-compression", "int8",
           "--grad-bucket-mb", str(CODEC_BUCKET_MB)],
}


def _codec_counters():
    """(holder, attribute) of the NCCL collective counters the codec path
    moves: the all-reduces, the int8 all-to-alls and all-gathers."""
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll
    from distributed_tensorflow_tpu_torch.parallel import compression

    return {"all_reduce": (coll.all_reduce_, "nccl_launches"),
            "all_to_all": (compression.all_to_all_, "nccl_launches"),
            "all_gather": (compression.all_gather_, "nccl_launches")}


def _codec_counts() -> dict:
    return {k: getattr(fn, a) for k, (fn, a) in _codec_counters().items()}


def _all_counts() -> dict:
    return {**_flash_counts(), **_tc32_counts(), **_codec_counts()}


def _reset_all_counts() -> None:
    _reset_flash_counts()
    for fn, a in _codec_counters().values():
        setattr(fn, a, 0)


@contextlib.contextmanager
def _probe_counts(kept: dict):
    """Record what the harness's one-time overlap probe launched (its
    throwaway steps and collectives), so the run's counts can leave it
    out; ``kept["probe"]`` is the probe's result."""
    from distributed_tensorflow_tpu_torch.parallel import overlap

    probe = overlap.probe_engine_overlap

    def recorded(*args, **kw):
        before = _all_counts()
        try:
            kept["probe"] = probe(*args, **kw)
        finally:
            torch.cuda.synchronize()
            after = _all_counts()
            kept["delta"] = {k: after[k] - before[k] for k in after}
        return kept["probe"]

    overlap.probe_engine_overlap = recorded
    try:
        yield
    finally:
        overlap.probe_engine_overlap = probe


def _codec_plan(extra: list, numels: list, itemsize: int, steps: int,
                evals: int) -> tuple[int, dict]:
    """From the parameters' element counts and storage width alone: the
    wire bytes of one exchange under the run's flags, and the NCCL
    collectives of its ``steps`` and ``evals`` (one f32 all-reduce a step
    for the metrics, packed behind f32 gradients at codec none unbucketed;
    one an evaluation for its totals)."""
    flag = dict(zip(extra[::2], extra[1::2]))
    name = flag.get("--grad-compression", "none")
    bucket = float(flag.get("--grad-bucket-mb", 0))
    k = int(flag.get("--grad-accum", 1))
    total = sum(numels)
    nb = -(-total * itemsize // int(bucket * (1 << 20))) if bucket else None
    if name == "int8":
        wire = total + 4 * (nb if bucket else len(numels))
        per = {"all_reduce": 1, "all_to_all": k * nb if bucket else 1}
        per["all_gather"] = 3 * per["all_to_all"]
    else:
        width = 2 if name == "bf16" else itemsize
        wire = total * width
        per = {"all_reduce": (k * nb + 1 if bucket
                              else 1 if name == "none" else 2),
               "all_to_all": 0, "all_gather": 0}
    counts = {c: n * steps for c, n in per.items()}
    counts["all_reduce"] += evals
    return wire, counts


def _codec_launches(label, counts, steps, k, evals, route) -> None:
    """8 flash forwards, dQ and dK/dV a microbatch (+ 8 forwards an eval
    batch), every one on ``route``."""
    layers = CLI_LM["layers"]
    fwd, bwd = layers * (steps * k + evals), layers * steps * k
    other = "tc" if route == "tc32" else "tc32"
    want = {"fwd": fwd, "dq": bwd, "dkv": bwd, f"fwd_{route}": fwd,
            f"dq_{route}": bwd, f"dkv_{route}": bwd, f"fwd_{other}": 0,
            f"dq_{other}": 0, f"dkv_{other}": 0}
    got = {key: counts[key] for key in want}
    assert got == want, (label, got, want)


def _codec_twin(gpu) -> dict:
    """G2's engine: 24 steps in chunks of 8 against 24 single eager
    steps, bitwise; then where a replayed chunk's device time goes, and
    the codec's own kernels timed alone on the same gradients."""
    from distributed_tensorflow_tpu_torch.engines import Trainer
    from distributed_tensorflow_tpu_torch.engines.sync import _ChunkGraph
    from distributed_tensorflow_tpu_torch.utils import harness

    cfg = _ckpt_config(epochs=1, grad_compression="int8")
    runs, split = {}, {}
    for k in (8, 1):
        ex = harness._setup(harness._resolve_precision(cfg))
        tr = Trainer(None, engine=ex.engine, seed=0)
        lines = []
        replays = _ChunkGraph.replays
        with harness._repeatable_math():
            tr.fit(ex.train_ds, epochs=1, batch_size=ex.global_batch,
                   log_every=1, log_fn=lines.append, steps_per_call=k,
                   max_steps=24)
        torch.cuda.synchronize()
        runs[k] = (lines, [p.detach().clone()
                           for p in tr.state.model.parameters()],
                   tr.state.codec_generator.get_state(),
                   _ChunkGraph.replays - replays)
        if k == 8:
            split = _codec_split(ex, tr.state)
        ex.mesh.close()
        del tr, ex
    (l8, p8, g8, replays), (l1, p1, g1, _) = runs[8], runs[1]
    checks = {"heartbeats": l8 == l1 and len(l8) == 24,
              "params": all(torch.equal(a, b) for a, b in zip(p8, p1)),
              "codec generator": torch.equal(g8, g1),
              "replays": replays == 2}
    assert all(checks.values()), (checks, l8[-1:], l1[-1:])
    print(f"[codec] G2 twin ({gpu}): 24 steps in chunks of 8 (eager, "
          f"captured, replayed) against 24 eager steps: bitwise "
          f"{json.dumps(checks)}")
    return split


def _codec_split(ex, state) -> dict:
    """A replayed int8 chunk of 8 steps under ``torch.profiler``: device
    ms a step, the NCCL kernels' share; and the codec's own kernels (its
    encode, decode and layout work, NCCL left out) timed alone on the
    gradients' shapes with the run's generator: their device ms and
    launches a step."""
    eng = ex.engine
    bx, by, _ = next(iter(ex.train_ds.batches(ex.global_batch,
                                              shuffle=False)))
    xs, ys = eng.shard_batch(bx, by)
    step_rows = _profiled(lambda: [eng.many_step(state, [xs] * 8, [ys] * 8)
                                   for _ in range(2)], 16)
    grads = [torch.randn_like(p) for p in state.model.parameters()]
    gen = state.codec_generator
    codec_rows = _profiled(lambda: [eng.grad_codec.all_reduce_sum(
        grads, eng.mesh, generator=gen) for _ in range(4)], 4)

    def nccl(rows):
        return sum(r[0] for r in rows if "nccl" in r[2].lower())

    step_us = sum(r[0] for r in step_rows)
    out = {"step_ms": step_us / 1e3, "nccl_ms": nccl(step_rows) / 1e3,
           "codec_ms": (sum(r[0] for r in codec_rows)
                        - nccl(codec_rows)) / 1e3,
           "codec_kernels": sum(r[1] for r in codec_rows
                                if "nccl" not in r[2].lower()),
           "codec_top": [(round(r[0], 2), round(r[1], 1), r[2][:60])
                         for r in codec_rows[:6]]}
    out["rest_ms"] = out["step_ms"] - out["nccl_ms"] - out["codec_ms"]
    out["codec_share"] = (out["codec_ms"] / out["step_ms"]
                          if step_us else None)
    return out


def _codec_local(gpu, engine: str, **kw) -> None:
    """``engine`` (async or gossip) on the cli-lm GPT under int8, two
    chunks of 8 eager steps: finite losses, the plan's collectives."""
    from distributed_tensorflow_tpu_torch.engines import Trainer
    from distributed_tensorflow_tpu_torch.utils import harness

    ex = harness._setup(harness._resolve_precision(_ckpt_config(
        engine=engine, epochs=1, grad_compression="int8", **kw)))
    try:
        tr = Trainer(None, engine=ex.engine, seed=0)
        lines = []
        _reset_all_counts()
        with harness._repeatable_math():
            r = tr.fit(ex.train_ds, epochs=1, batch_size=ex.global_batch,
                       log_every=1, log_fn=lines.append, steps_per_call=8,
                       max_steps=16)
        torch.cuda.synchronize()
        counts = _codec_counts()
    finally:
        ex.mesh.close()
    losses = [float(line.split()[3]) for line in lines]
    mixes = 16 // kw["sync_every"] if engine == "async" else 16
    want = {"all_reduce": 16, "all_to_all": mixes, "all_gather": 3 * mixes}
    assert len(losses) == 16 and all(np.isfinite(losses)), lines
    assert counts == want, (engine, counts, want)
    assert r["grad_compression"] == "int8", r
    print(f"[codec] {engine} ({gpu}): int8, 16 steps in 2 chunks: losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}, NCCL collectives "
          f"{json.dumps(counts)} (the plan's), wire bytes "
          f"{r['grad_allreduce_bytes']} of {r['grad_allreduce_bytes_raw']}")


def codec_phase(gpu: str) -> dict:
    """Phase 5j (module docstring): G-base–G4 through ``cli.main``, the G2
    twin and split, async and gossip; returns the G runs' flash launches
    by route."""
    from distributed_tensorflow_tpu_torch.data import loaders

    t0 = time.perf_counter()
    train = loaders.load_dataset("lm_synth", split="train")
    test = loaders.load_dataset("lm_synth", split="test")
    steps = len(train) // CLI_LM["batch"]
    evals = -(-len(test) // 100)
    launches = {"tc32": {"fwd": 0, "dq": 0, "dkv": 0},
                "tc": {"fwd": 0, "dq": 0, "dkv": 0}}
    recs = {}
    for name, extra in CODEC_RUNS.items():
        kept: dict = {}
        _reset_all_counts()
        with _probe_counts(kept):
            rec = _recorded_cli(CLI_LM_ARGV + extra)
        torch.cuda.synchronize()
        counts = {k: v - kept.get("delta", {}).get(k, 0)
                  for k, v in _all_counts().items()}
        sm, rr = rec["summary"], rec["summary"]["run_report"]
        params = list(rec["trainer"].state.model.parameters())
        itemsize = params[0].element_size()
        wire, want = _codec_plan(extra, [p.numel() for p in params],
                                 itemsize, sm["steps"], 1)
        k = int(dict(zip(extra[::2], extra[1::2])).get("--grad-accum", 1))
        route = "tc" if "--precision" in extra else "tc32"
        _codec_launches(name, counts, sm["steps"], k, evals, route)
        for kind in ("fwd", "dq", "dkv"):
            launches[route][kind] += counts[f"{kind}_{route}"]
        got = {c: counts[c] for c in want}
        assert sm["steps"] == steps, sm
        assert rr["grad_allreduce_bytes"] == wire, (name, rr, wire)
        assert got == want, (name, got, want)
        assert sm["test_loss"] <= CLI_LM_TEST_LOSS, (name, sm["test_loss"])
        split = rr["collective_overlap"]
        if "--grad-bucket-mb" in extra:
            assert isinstance(split, dict) and all(
                np.isfinite(split[key]) for key in ("exposed_s", "hidden_s")
            ), (name, split)
        recs[name] = rec
        SEEN.setdefault("codec", {})[name] = rr["step_time_p50_s"] * 1e3
        print(f"[codec] {name} ({gpu}): {' '.join(extra) or 'base'}: "
              f"test_loss={sm['test_loss']!r} step_ms_p50="
              f"{rr['step_time_p50_s'] * 1e3:.4f} wire_bytes="
              f"{rr['grad_allreduce_bytes']} raw="
              f"{rr['grad_allreduce_bytes_raw']} (planned {wire}); NCCL "
              f"collectives {json.dumps(got)} over {sm['steps']} steps + "
              f"1 eval; flash launches on {route} "
              f"{counts[f'fwd_{route}']}/{counts[f'dq_{route}']}/"
              f"{counts[f'dkv_{route}']}"
              + (f"; probe split {json.dumps(split)} (probe's own launches "
                 f"{json.dumps(kept.get('delta'))})" if split else ""))
    base, g0 = recs["G-base"], recs["G0"]
    same = {"losses": torch.equal(base["losses"], g0["losses"]),
            "params": torch.equal(base["params"], g0["params"])}
    assert all(same.values()), same
    print(f"[codec] G0 bitwise G-base ({gpu}): {json.dumps(same)}; test "
          f"loss G1 {recs['G1']['summary']['test_loss']!r}, G2 "
          f"{recs['G2']['summary']['test_loss']!r} against G-base "
          f"{base['summary']['test_loss']!r}")
    del recs, base, g0
    split = _codec_twin(gpu)
    print(f"[codec] a replayed int8 chunk ({gpu}), device ms a step: "
          f"{split['step_ms']:.4f} = NCCL {split['nccl_ms']:.4f} + codec "
          f"{split['codec_ms']:.4f} ({split['codec_kernels']:.1f} kernels "
          f"a step, timed alone; share {split['codec_share']:.4f}) + rest "
          f"{split['rest_ms']:.4f}; codec's largest kernels "
          f"{json.dumps(split['codec_top'])}")
    _codec_local(gpu, "async", sync_every=8)
    _codec_local(gpu, "gossip")
    torch.cuda.empty_cache()
    print(f"[codec] phase 5j wall {time.perf_counter() - t0:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 5k: FSDP and tensor parallelism on one NCCL rank
# --------------------------------------------------------------------------

MP_STEPS = 4
# F2 (bf16 parameters and compute under an f32 master) against F1 (f32):
# the test loss after the same 512 steps; phase 5j's bf16 run G1 stays
# within this of G-base
MP_BF16_LOSS_ATOL = 0.02
MP_FSDP_ARGV = ["-m", "d", "-ds", "fsdp"]


def _mp_counters():
    """(holder, attribute) of the NCCL collectives the two engines launch:
    FSDP's all-gathers and reduce-scatters, TP's model-axis all-reduces
    (forward: row-parallel outputs and the vocab-parallel embedding;
    backward: column-parallel inputs and the head's input) and logit
    all-gathers, and every all-reduce."""
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll

    return {"gather": (coll.gather_shards, "nccl_launches"),
            "scatter": (coll.gather_shards, "nccl_scatter_launches"),
            "reduce_from_model": (coll.reduce_from_model, "nccl_launches"),
            "copy_to_model": (coll.copy_to_model, "nccl_launches"),
            "gather_from_model": (coll.gather_from_model, "nccl_launches"),
            "all_reduce": (coll.all_reduce_, "nccl_launches")}


def _mp_counts() -> dict:
    return {k: getattr(fn, a) for k, (fn, a) in _mp_counters().items()}


def _reset_mp_counts() -> None:
    for fn, a in _mp_counters().values():
        setattr(fn, a, 0)


# a window whose busy reading the smoke skips (printed "not measured")
_NOT_READ = {"wall_ms": None, "busy_share": None, "kernels": None}


def _eager_busy(engine, state, xs, ys, steps: int = 2) -> dict:
    """``steps`` eager steps on the host clock, then under
    ``torch.profiler``: wall ms a step and the device's busy share (two
    steps a reading by default: the smoke's wall is near its limit, and
    the profiler's processing of longer sessions is the cost)."""
    engine.step(state, xs, ys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step(state, xs, ys)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / steps
    rows = _profiled(lambda: [engine.step(state, xs, ys)
                              for _ in range(steps)], steps)
    busy_us = sum(r[0] for r in rows)
    return {"wall_ms": wall_us / 1e3,
            "busy_share": busy_us / wall_us if busy_us else None,
            "kernels": sum(r[1] for r in rows)}


def _fresh_busy(engine: str, precision: str = "f32") -> dict:
    """``_eager_busy`` of the cli-lm GPT under ``engine`` (window L1's
    recipe) from a fresh state on a one-rank NCCL group, on its first
    batch."""
    from distributed_tensorflow_tpu_torch.utils import harness

    ex = harness._setup(harness._resolve_precision(_ckpt_config(
        engine=engine, precision=precision, lr_schedule="cosine",
        warmup_steps=32, weight_decay=0.1, clip_norm=1.0)))
    try:
        state = ex.engine.init_state(torch.Generator().manual_seed(0),
                                     ex.train_ds.x[:1])
        bx, by, _ = next(iter(ex.train_ds.batches(ex.global_batch,
                                                  shuffle=False)))
        with harness._repeatable_math():
            return _eager_busy(ex.engine, state,
                               *ex.engine.shard_batch(bx, by))
    finally:
        ex.mesh.close()


def _fmt(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def _fsdp_window(name, extra, gpu, pool_kind, route, steps, evals):
    """``cli.main`` with window L1's flags under ``-m d -ds fsdp`` (and
    ``extra``), every count set to 0 just before it: the flash launches
    of L1 (8 layers a step on ``route`` and a forward an eval batch), one
    all-gather and one reduce-scatter a step of every leaf's slice (at
    n = 1 each slice is the whole leaf), one all-reduce a step (the loss
    and accuracy) and the evaluation's, and no model-axis collective."""
    from distributed_tensorflow_tpu_torch.engines import FSDPEngine

    layers = CLI_LM["layers"]
    _reset_mp_counts()
    rec, counts, paged, _ = _cli_lm_window(
        name, CLI_L1_ARGV + MP_FSDP_ARGV + extra, gpu, 8, pool_kind)
    mp = _mp_counts()
    eng, state = rec["trainer"].engine, rec["trainer"].state
    assert isinstance(eng, FSDPEngine), type(eng)
    fwd, bwd = layers * (steps + evals), layers * steps
    other = "tc" if route == "tc32" else "tc32"
    assert counts == {"fwd": fwd, "dq": bwd, "dkv": bwd,
                      f"fwd_{route}": fwd, f"dq_{route}": bwd,
                      f"dkv_{route}": bwd, f"fwd_{other}": 0,
                      f"dq_{other}": 0, f"dkv_{other}": 0}, (name, counts)
    leaves = len(list(state.model.parameters()))
    assert len(eng.param_specs) == leaves, (leaves, eng.param_specs)
    want = {"gather": steps, "scatter": steps,
            "reduce_from_model": 0, "copy_to_model": 0,
            "gather_from_model": 0, "all_reduce": steps + 1}
    assert mp == want, (name, mp, want)
    return rec, counts, paged, mp, leaves


def mp_phase(gpu: str) -> dict:
    """Phase 5k (module docstring): F1 and F2 through ``cli.main``, T on a
    (1, 1) (data, model) mesh; returns the windows' kernel launches."""
    from distributed_tensorflow_tpu_torch.data import loaders
    from distributed_tensorflow_tpu_torch.engines import (
        SyncEngine, TensorParallelEngine)
    from distributed_tensorflow_tpu_torch.models import create_model
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    t0 = time.perf_counter()
    layers = CLI_LM["layers"]
    train = loaders.load_dataset("lm_synth", split="train")
    test = loaders.load_dataset("lm_synth", split="test")
    steps = len(train) // CLI_LM["batch"]
    evals = -(-len(test) // 100)

    # F1: FSDP at f32, bitwise window L1
    rec, counts, paged, mp, leaves = _fsdp_window(
        "F1 (fsdp, f32)", [], gpu, (torch.float32, CLI_LM["heads"],
                                    CLI_LM["heads"]), "tc32", steps, evals)
    sm, l1 = rec["summary"], SEEN["L1"]
    same = {"test_loss": sm["test_loss"] == l1["test_loss"],
            "samples": sm["samples"] == l1["samples"],
            "streams": _streams(rec["serve_summary"]) == l1["streams"]}
    assert all(same.values()), (same, sm["test_loss"], l1["test_loss"])
    assert paged == layers * sm["serve"]["decode_iterations"], paged
    eng, state = rec["trainer"].engine, rec["trainer"].state
    per, whole = eng.state_bytes_per_device(state)
    f1 = {"fwd_tc32": counts["fwd_tc32"], "dq_tc32": counts["dq_tc32"],
          "dkv_tc32": counts["dkv_tc32"], "paged_f32": paged}
    f1_p50 = sm["run_report"]["step_time_p50_s"] * 1e3
    f1_loss = sm["test_loss"]
    print(f"[mp] F1 ({gpu}): FSDP at n = 1 bitwise window L1 "
          f"{json.dumps(same)}; test_loss {f1_loss!r}; {leaves} leaves, "
          f"NCCL collectives {json.dumps(mp)} over {steps} steps + 1 eval "
          f"(planned: one all-gather of the {leaves} slices and one "
          f"reduce-scatter a step); flash launches on tc32 "
          f"{counts['fwd_tc32']}/"
          f"{counts['dq_tc32']}/{counts['dkv_tc32']}; paged {paged}; "
          f"state_bytes_per_device {per} of {whole} replicated")
    del rec, eng, state

    # F2: FSDP under bf16-f32master
    rec, counts, paged2, mp, _ = _fsdp_window(
        "F2 (fsdp, bf16-f32master)", ["--precision", "bf16-f32master"], gpu,
        (torch.bfloat16, CLI_LM["heads"], CLI_LM["heads"]), "tc", steps,
        evals)
    sm = rec["summary"]
    assert np.isfinite(sm["test_loss"]), sm["test_loss"]
    assert abs(sm["test_loss"] - f1_loss) <= MP_BF16_LOSS_ATOL, (
        sm["test_loss"], f1_loss)
    eng, state = rec["trainer"].engine, rec["trainer"].state
    per2, whole2 = eng.state_bytes_per_device(state)
    master = state.optimizer.master
    f2 = {"fwd_tc": counts["fwd_tc"], "dq_tc": counts["dq_tc"],
          "dkv_tc": counts["dkv_tc"], "paged_bf16": paged2}
    f2_p50 = sm["run_report"]["step_time_p50_s"] * 1e3
    print(f"[mp] F2 ({gpu}): test_loss {sm['test_loss']!r} within "
          f"{MP_BF16_LOSS_ATOL} of F1's ({abs(sm['test_loss'] - f1_loss):.6f}"
          f"); NCCL collectives {json.dumps(mp)}; flash launches on tc "
          f"{counts['fwd_tc']}/{counts['dq_tc']}/{counts['dkv_tc']}; paged "
          f"{paged2} (bf16 pools); f32 master bytes per device "
          f"{master.numel() * master.element_size()}; state_bytes_per_device"
          f" {per2} of {whole2} replicated")
    del rec, eng, state, master

    # T: TP on a (1, 1) mesh at the Train window's shape
    x, y = _lm_data(MP_STEPS * LM["batch"])
    mesh = meshlib.create_mesh(1, shape=(1, 1), axis_names=("data", "model"))
    runs = {}
    try:
        for label in ("sync", "tp"):
            model = create_model(
                "gpt", num_classes=LM["vocab"], hidden=LM["hidden"],
                layers=LM["layers"], heads=LM["heads"], ffn=LM["ffn"],
                max_len=LM["seq"], dropout_rate=0.0, dtype="bfloat16",
                attention_impl="flash", partition_model=label == "tp")
            cls = SyncEngine if label == "sync" else TensorParallelEngine
            # one (non-capturable) Adam for both
            eng = cls(model, mesh=mesh,
                      optimizer=lambda p: torch.optim.Adam(p, lr=1e-3))
            state = eng.init_state(torch.Generator().manual_seed(0))
            b = LM["batch"]
            batches = [eng.shard_batch(x[i * b:(i + 1) * b],
                                       y[i * b:(i + 1) * b])
                       for i in range(MP_STEPS)]
            torch.cuda.synchronize()
            _reset_flash_counts()
            _reset_mp_counts()
            losses, step_ms = [], []
            for xb, yb in batches:
                ts = time.perf_counter()
                state, m = eng.step(state, xb, yb)
                losses.append(float(m["loss"]))     # waits for the step
                step_ms.append((time.perf_counter() - ts) * 1e3)
            runs[label] = {"losses": losses, "step_ms": step_ms,
                           "counts": {**_flash_counts(), **_tc32_counts()},
                           "mp": _mp_counts(),
                           "busy": _eager_busy(eng, state, *batches[0])}
            del eng, state, model
            torch.cuda.empty_cache()
    finally:
        mesh.close()
    tp, sync = runs["tp"], runs["sync"]
    f1_busy, f2_busy = _fresh_busy("fsdp"), _fresh_busy("fsdp",
                                                       "bf16-f32master")
    sync_busy = _fresh_busy("sync")
    assert tp["losses"] == sync["losses"], (tp["losses"], sync["losses"])
    n = layers * MP_STEPS
    assert tp["counts"] == {"fwd": n, "dq": n, "dkv": n, "fwd_tc": n,
                            "dq_tc": n, "dkv_tc": n, "fwd_tc32": 0,
                            "dq_tc32": 0, "dkv_tc32": 0}, tp["counts"]
    pair = MP_STEPS * (2 * layers + 1)
    want = {"gather": 0, "scatter": 0, "reduce_from_model": pair,
            "copy_to_model": pair, "gather_from_model": MP_STEPS,
            "all_reduce": 2 * pair + MP_STEPS}
    assert tp["mp"] == want, (tp["mp"], want)
    print(f"[mp] T ({gpu}): TensorParallelEngine on a (1, 1) NCCL mesh, "
          f"partitioned flash GPT (B=8, L=1024, bf16): losses "
          f"{' '.join(repr(v) for v in tp['losses'])} bitwise SyncEngine's; "
          f"flash launches {json.dumps(tp['counts'])}; NCCL collectives "
          f"{json.dumps(tp['mp'])} ({2 * layers + 1} model-axis all-reduces "
          f"a step forward and as many backward, one logit all-gather and "
          f"one data-axis all-reduce)")
    codec = SEEN.get("codec", {})
    train = SEEN.get("train", {})
    l1_busy = SEEN.get("cli-lm L1 step (B=8, L=128, f32)", {})
    train_busy = SEEN.get("train step bf16 f32 params", {})
    for name, p50, busy in (
            ("F1", f1_p50, f1_busy), ("F2", f2_p50, f2_busy),
            ("T", float(np.median(tp["step_ms"][1:])), tp["busy"]),
            ("T's sync twin", float(np.median(sync["step_ms"][1:])),
             sync["busy"]),
            ("the cli-lm GPT under SyncEngine, eager", None, sync_busy)):
        print(f"[mp] {name} ({gpu}): step_ms_p50={_fmt(p50)} eager "
              f"wall_ms={busy['wall_ms']:.4f} busy_share="
              f"{_fmt(busy['busy_share'])} kernels_per_step="
              f"{busy['kernels']:.1f}; beside G-base step_ms_p50="
              f"{_fmt(codec.get('G-base'))} (a replayed L1 step: wall_ms="
              f"{_fmt(l1_busy.get('wall_ms'))} busy_share="
              f"{_fmt(l1_busy.get('busy_share'))}) and the Train window's "
              f"step_ms_p50={_fmt(train.get('step_ms_p50'))} (eager: "
              f"busy_share={_fmt(train_busy.get('busy_share'))})")
    torch.cuda.empty_cache()
    print(f"[mp] phase 5k wall {time.perf_counter() - t0:.1f} s")
    return {"F1": f1, "F2": f2, "T": tp["counts"]}


# --------------------------------------------------------------------------
# phase 5l: pipeline parallelism on one NCCL rank
# --------------------------------------------------------------------------

PP_STEPS = 4
PP_MICRO = 4
# the first step's loss against the cross-entropy of the sequential
# forward over the whole batch on the same weights: the same kernels at
# other row counts (B = 8 against 4 microbatches of 2), so cuBLAS may sum
# a bf16 GEMM's products in another order and round an activation one
# bf16 step (2^-8) the other way; over 8192 tokens' mean that moves the
# loss by far less than this share of it
PP_LOSS_RTOL = 1e-3
# Pgen against the naive rollout: the rollout runs each prefix at its own
# length, so its GEMMs see other row counts and its bf16 logits may round
# otherwise; a first difference is a tie where the naive logits' top two
# lie within two bf16 roundings of the larger (2 * 2^-8 of its size)
PP_TIE = 2 * 2 ** -8
PP_PROMPT = 32
PP_NEW = 32
# the (1, 1) mesh's planned collectives a step: the shifts of a pipe of
# one (copies, no point-to-point op): GPipe 2 (T - 1) with T = M + S - 1
# ticks, 1F1B 2 (T - 1) with T = 2 (M + S - 1); two all-reduces (the
# block gradients over 'data', embed, head and metrics over every rank)
PP_SHIFTS = {"gpipe": 2 * (PP_MICRO - 1), "1f1b": 2 * (2 * PP_MICRO - 1)}


def _pp_counters():
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll

    return {"next_clones": (coll.shift_to_next, "clones"),
            "prev_clones": (coll.shift_to_prev, "clones"),
            "next_p2p": (coll.shift_to_next, "launches"),
            "prev_p2p": (coll.shift_to_prev, "launches"),
            "all_reduce": (coll.all_reduce_, "launches"),
            "all_reduce_nccl": (coll.all_reduce_, "nccl_launches")}


def _pp_counts() -> dict:
    return {k: getattr(fn, a) for k, (fn, a) in _pp_counters().items()}


def _reset_pp_counts() -> None:
    for fn, a in _pp_counters().values():
        setattr(fn, a, 0)


def _pp_engine(mesh, schedule: str, remat: bool = False):
    from distributed_tensorflow_tpu_torch.engines import PipelineEngine
    from distributed_tensorflow_tpu_torch.models.gpt import (
        gpt_pipeline_stages)

    stages = gpt_pipeline_stages(
        vocab_size=LM["vocab"], hidden=LM["hidden"], heads=LM["heads"],
        ffn=LM["ffn"], max_len=LM["seq"], layers_per_stage=LM["layers"],
        attention_impl="flash", dtype=torch.bfloat16)
    return PipelineEngine(microbatches=PP_MICRO, mesh=mesh, stages=stages,
                          schedule=schedule, remat=remat,
                          optimizer=lambda p: torch.optim.Adam(p, lr=1e-3))


def _pp_window(name, mesh, schedule, remat, init, batches) -> dict:
    """PP_STEPS eager steps of ``PipelineEngine`` from ``init``, every
    count set to 0 just before them and read just after; the first step's
    loss against the sequential forward's cross-entropy on ``init``; the
    window's peak memory (reset before it)."""
    from distributed_tensorflow_tpu_torch.engines.base import cross_entropy

    eng = _pp_engine(mesh, schedule, remat)
    state = eng.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(init)
    (x0, y0) = batches[0]
    with torch.no_grad():
        seq = float(cross_entropy(eng._sequential_logits(
            eng.eval_params(state), x0), y0).mean())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _reset_flash_counts()
    _reset_pp_counts()
    losses, step_ms = [], []
    for xb, yb in batches:
        t0 = time.perf_counter()
        state, m = eng.step(state, xb, yb)
        losses.append(float(m["loss"]))        # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {**_flash_counts(), **_tc32_counts()}
    collectives = _pp_counts()
    peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(losses)), (name, losses)
    err = abs(losses[0] - seq)
    assert err <= PP_LOSS_RTOL * seq, (name, losses[0], seq)
    params = {k: v.detach().clone()
              for k, v in state.model.state_dict().items()}
    return {"eng": eng, "state": state, "losses": losses, "seq_loss": seq,
            "loss_err": err, "step_ms": step_ms, "counts": counts,
            "collectives": collectives, "peak": peak, "base_mem": base_mem,
            "params": params}


def _pp_generate(gpu, eng, state, x) -> dict:
    """Pgen: ``generate`` from PG's final state (32-token prompts of the
    data, 32 new tokens) against the naive rollout, a loop of
    ``_sequential_logits`` on the growing prefix with argmax."""
    prompts = np.asarray(x[:, :PP_PROMPT], np.int32)
    torch.cuda.synchronize()
    _reset_flash_counts()
    t0 = time.perf_counter()
    got = eng.generate(state, prompts, PP_NEW)
    gen_ms = (time.perf_counter() - t0) * 1e3
    counts = {**_flash_counts(), **_tc32_counts()}
    model = eng.eval_params(state)
    toks = torch.as_tensor(prompts, device="cuda").long()
    with torch.no_grad():
        for _ in range(PP_NEW):
            nxt = eng._sequential_logits(model, toks)[:, -1].argmax(-1)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    want = toks.cpu().numpy()
    assert got.shape == want.shape == (len(prompts), PP_PROMPT + PP_NEW)
    assert np.array_equal(got[:, :PP_PROMPT], prompts)
    diff = np.argwhere(got != want)
    first = None
    if len(diff):
        # the earliest position over the rows: the tokens before it agree
        row, pos = min(diff.tolist(), key=lambda rc: (rc[1], rc[0]))
        with torch.no_grad():
            logits = eng._sequential_logits(
                model, torch.as_tensor(want[row:row + 1, :pos],
                                       device="cuda").long())[0, -1]
        top = logits.topk(2).values
        gap = float(top[0] - top[1])
        first = {"row": row, "position": pos, "naive": int(want[row, pos]),
                 "generate": int(got[row, pos]), "top2_gap": gap,
                 "tie_bound": PP_TIE * abs(float(top[0]))}
        print(f"[pp] Pgen ({gpu}): generate leaves the naive rollout at row "
              f"{row} position {pos}: naive {first['naive']}, generate "
              f"{first['generate']}; the naive logits' top-2 gap there "
              f"{gap:.6f} (tie bound {first['tie_bound']:.6f})")
        assert gap <= first["tie_bound"], first
    n = LM["layers"] * PP_NEW
    assert counts["fwd_tc"] == counts["fwd"] == n, counts
    assert counts["dq"] == counts["dkv"] == 0, counts
    print(f"[pp] Pgen ({gpu}): {len(prompts)} prompts of {PP_PROMPT} "
          f"tokens + {PP_NEW} new: "
          + ("bitwise the naive rollout" if first is None else
             "equal to the naive rollout up to a tie")
          + f" ({int((got == want).sum())}/{want.size} tokens equal); "
          f"{gen_ms:.1f} ms; flash forwards on tc {counts['fwd_tc']} "
          f"({LM['layers']} layers x {PP_NEW} fixed-length forwards)")
    return {"counts": counts, "first_difference": first, "ms": gen_ms,
            "tokens": got, "prompts": prompts}


def pp_phase(gpu: str) -> tuple[dict, dict]:
    """Phase 5l (module docstring): ``PipelineEngine`` on a (1, 1) (data,
    pipe) NCCL mesh over the GPT stages at ``bench.py --lm``'s widths:
    windows PG, P1, PR from one init on the same batches, then Pgen.
    Returns each window's flash launches, and what phase 5n starts from
    and is held to: the init, the batches, PG's and P1's losses and final
    parameters, Pgen's prompts and tokens."""
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    t0 = time.perf_counter()
    x, y = _lm_data(PP_STEPS * LM["batch"])
    mesh = meshlib.create_mesh(1, shape=(1, 1), axis_names=("data", "pipe"))
    runs = {}
    try:
        eng = _pp_engine(mesh, "gpipe")
        init = {k: v.detach().clone() for k, v in eng.init_state(
            torch.Generator().manual_seed(0)).model.state_dict().items()}
        b = LM["batch"]
        batches = [eng.shard_batch(x[i * b:(i + 1) * b],
                                   y[i * b:(i + 1) * b])
                   for i in range(PP_STEPS)]
        del eng
        for name, schedule, remat in (("PG", "gpipe", False),
                                      ("P1", "1f1b", False),
                                      ("PR", "gpipe", True)):
            run = runs[name] = _pp_window(name, mesh, schedule, remat, init,
                                          batches)
            eng, state = run.pop("eng"), run.pop("state")
            if name == "PG":
                # from PG's final state, before the busy share's steps
                gen = _pp_generate(gpu, eng, state, x[:LM["batch"]])
            run["busy"] = _eager_busy(eng, state, *batches[0])
            del eng, state
            torch.cuda.empty_cache()
    finally:
        mesh.close()
    n = LM["layers"] * PP_MICRO * PP_STEPS
    plan = {"PG": (n, n), "P1": (2 * n, n), "PR": (2 * n, n)}
    for name, (fwd, bwd) in plan.items():
        want = {"fwd": fwd, "dq": bwd, "dkv": bwd, "fwd_tc": fwd,
                "dq_tc": bwd, "dkv_tc": bwd, "fwd_tc32": 0, "dq_tc32": 0,
                "dkv_tc32": 0}
        assert runs[name]["counts"] == want, (name, runs[name]["counts"])
        shifts = PP_SHIFTS["1f1b" if name == "P1" else "gpipe"] // 2
        want = {"next_clones": shifts * PP_STEPS,
                "prev_clones": shifts * PP_STEPS, "next_p2p": 0,
                "prev_p2p": 0, "all_reduce": 2 * PP_STEPS,
                "all_reduce_nccl": 2 * PP_STEPS}
        assert runs[name]["collectives"] == want, (
            name, runs[name]["collectives"], want)
    same = {name: all(torch.equal(runs["PG"]["params"][k], v)
                      for k, v in runs[name]["params"].items())
            for name in ("P1", "PR")}
    assert same == {"P1": True, "PR": True}, same
    for name in ("P1", "PR"):
        assert runs[name]["losses"] == runs["PG"]["losses"], (
            name, runs[name]["losses"], runs["PG"]["losses"])
    for name, run in runs.items():
        p50 = float(np.median(run["step_ms"][1:]))
        SEEN[f"pp {name}"] = p50
        print(f"[pp] {name} ({gpu}): losses "
              f"{' '.join(repr(v) for v in run['losses'])}; first-step "
              f"loss - sequential forward's {run['loss_err']:.3e} (bound "
              f"{PP_LOSS_RTOL * run['seq_loss']:.3e}); step ms "
              f"{' '.join(f'{t:.3f}' for t in run['step_ms'])} "
              f"(p50 of steps 2-4 {p50:.3f}); eager wall_ms="
              f"{run['busy']['wall_ms']:.4f} busy_share="
              f"{_fmt(run['busy']['busy_share'])}; max_memory_allocated "
              f"{run['peak'] / 2**20:.1f} MiB ({run['base_mem'] / 2**20:.1f}"
              f" MiB before the steps); flash launches "
              f"{json.dumps(run['counts'])}; collectives "
              f"{json.dumps(run['collectives'])}")
    print(f"[pp] P1 and PR parameters after {PP_STEPS} steps bitwise PG's "
          f"{json.dumps(same)}; peak memory above each window's entry "
          + ", ".join(f"{k} {(r['peak'] - r['base_mem']) / 2**20:.1f} MiB"
                      for k, r in runs.items()) + "; order "
          + " < ".join(sorted(runs, key=lambda k: runs[k]["peak"]
                              - runs[k]["base_mem"])))
    torch.cuda.empty_cache()
    print(f"[pp] phase 5l wall {time.perf_counter() - t0:.1f} s")
    ref = {"init": init, "batches": [(x[i * b:(i + 1) * b],
                                      y[i * b:(i + 1) * b])
                                     for i in range(PP_STEPS)],
           "prompts": gen["prompts"], "tokens": gen["tokens"],
           **{name: {"losses": runs[name]["losses"],
                     "params": runs[name]["params"]}
              for name in ("PG", "P1")}}
    return ({**{name: run["counts"] for name, run in runs.items()},
             "Pgen": gen["counts"]}, ref)


# --------------------------------------------------------------------------
# phase 5m: the composites without the pipeline on one NCCL rank
# --------------------------------------------------------------------------

COMP_STEPS = 4
# X2's first loss against the flash MoE GPT's under SyncEngine: the same
# tc forward kernel (a ring of one block merges with weight exactly 1),
# the same routing, but the composite's experts run as one batched GEMM
# over every group's buffers where the plain layer batches them by
# group, so cuBLAS may sum a bf16 product's terms in another order and
# round an activation one bf16 step the other way; over 8192 tokens'
# mean that moves the loss by far less than this share of it
COMP_MOE_RTOL = 1e-5
COMP_EP_STEPS = 8


def _comp_counters():
    """(holder, attribute) of every NCCL collective a composite step can
    launch."""
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll

    return {"all_reduce": (coll.all_reduce_, "nccl_launches"),
            "copy_to_model": (coll.copy_to_model, "nccl_launches"),
            "reduce_from_model": (coll.reduce_from_model, "nccl_launches"),
            "gather_from_model": (coll.gather_from_model, "nccl_launches")}


def _comp_window(eng, state, batches) -> dict:
    """``eng``'s eager steps over ``batches``, every count set to 0 just
    before them and read just after; the step times, the peak memory
    above the window's entry, the final parameters."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _reset_flash_counts()
    for fn, a in _comp_counters().values():
        setattr(fn, a, 0)
    losses, step_ms = [], []
    for xb, yb in batches:
        t0 = time.perf_counter()
        state, m = eng.step(state, xb, yb)
        losses.append(float(m["loss"]))        # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {**_flash_counts(), **_tc32_counts()}
    nccl = {k: getattr(fn, a) for k, (fn, a) in _comp_counters().items()}
    peak = torch.cuda.max_memory_allocated() - base_mem
    assert all(np.isfinite(losses)), losses
    return {"losses": losses, "step_ms": step_ms, "counts": counts,
            "nccl": nccl, "peak": peak,
            "params": {k: v.detach().clone()
                       for k, v in state.model.state_dict().items()}}


def _lm_engine(cls, model, mesh, **kw):
    """``cls`` over ``model`` with phase 5g's Adam, its seed-0 state."""
    eng = cls(model, mesh=mesh, **kw,
              optimizer=lambda p: torch.optim.Adam(p, lr=1e-3))
    return eng, eng.init_state(torch.Generator().manual_seed(0))


def composite_phase(gpu: str, sp: dict) -> dict:
    """Phase 5m (module docstring): X1, X2 and X3 on (1, 1, 1) NCCL
    meshes.  Returns X1's and X2's flash launches."""
    from distributed_tensorflow_tpu_torch.engines import (
        CompositeEngine, ExpertParallelEngine, SeqParallelEngine, SyncEngine)
    from distributed_tensorflow_tpu_torch.models import create_model
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    t0 = time.perf_counter()
    x, y = _lm_data(COMP_STEPS * LM["batch"])
    b = LM["batch"]
    runs = {}
    # X1: tp×sp against phase 5g's f32 ring_flash window and its twin
    mesh = meshlib.create_mesh(1, shape=(1, 1), axis_names=("data", "seq"))
    try:
        eng, state = _lm_engine(SeqParallelEngine,
                                _lm_model("ring_flash", "float32"), mesh)
        batches = [eng.shard_batch(x[i * b:(i + 1) * b],
                                   y[i * b:(i + 1) * b])
                   for i in range(COMP_STEPS)]
        twin = _comp_window(eng, state, batches)
        del eng, state
    finally:
        mesh.close()
    mesh = meshlib.create_mesh(1, shape=(1, 1, 1),
                               axis_names=("data", "model", "seq"))
    try:
        model = _lm_model("ring_flash", "float32", partition_model=True)
        eng, state = _lm_engine(CompositeEngine, model, mesh)
        runs["X1"] = _comp_window(eng, state, batches)
        runs["X1"]["busy"] = _eager_busy(eng, state, *batches[0])
        del eng, state, model, batches
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    x1 = runs["X1"]
    assert x1["losses"] == sp["runs"]["ring_flash_f32"]["losses"], (
        "X1 not bitwise phase 5g", x1["losses"],
        sp["runs"]["ring_flash_f32"]["losses"])
    same = [k for k, v in x1["params"].items()
            if not torch.equal(v, twin["params"][k])]
    assert not same, ("X1 parameters not bitwise the SP twin", same[:4])
    # X2: ep×sp, its first loss against the flash MoE GPT under SyncEngine
    moe_kw = dict(num_classes=LM["vocab"], hidden=LM["hidden"],
                  layers=LM["layers"], heads=LM["heads"], ffn=LM["ffn"],
                  max_len=LM["seq"], dropout_rate=0.0, dtype="bfloat16",
                  moe_experts=MOE_GPT["experts"], moe_top_k=MOE_GPT["top_k"],
                  moe_capacity_factor=MOE_GPT["capacity_factor"])
    mesh = meshlib.create_mesh(1)
    try:
        eng, state = _lm_engine(SyncEngine, create_model(
            "gpt", attention_impl="flash", **moe_kw), mesh)
        _, m = eng.step(state, *eng.shard_batch(x[:b], y[:b]))
        sync_first = float(m["loss"])
        del eng, state
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    mesh = meshlib.create_mesh(1, shape=(1, 1, 1),
                               axis_names=("data", "expert", "seq"))
    try:
        eng, state = _lm_engine(CompositeEngine, create_model(
            "gpt", attention_impl="ring_flash", partition_experts=True,
            **moe_kw), mesh)
        batches = [eng.shard_batch(x[i * b:(i + 1) * b],
                                   y[i * b:(i + 1) * b])
                   for i in range(COMP_STEPS)]
        runs["X2"] = _comp_window(eng, state, batches)
        runs["X2"]["busy"] = _eager_busy(eng, state, *batches[0])
        del eng, state, batches
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    x2_rel = abs(runs["X2"]["losses"][0] - sync_first) / abs(sync_first)
    assert x2_rel <= COMP_MOE_RTOL, (runs["X2"]["losses"][0], sync_first)
    n = LM["layers"] * COMP_STEPS
    for name, fwd_route in (("X1", "tc32"), ("X2", "tc")):
        want = {"fwd": n, "dq": n, "dkv": n, "fwd_tc": 0, "dq_tc": 0,
                "dkv_tc": 0, "fwd_tc32": 0, "dq_tc32": n, "dkv_tc32": n}
        want[f"fwd_{fwd_route}"] = n
        assert runs[name]["counts"] == want, (name, runs[name]["counts"])
    # X3: ep×tp, the 2-D expert layout against its (1, 1) twin
    from distributed_tensorflow_tpu_torch.data import load_dataset

    ds = load_dataset("synthetic")
    ep = {}
    for name, shape, axes, kw in (
            ("twin", (1, 1), ("data", "expert"), {}),
            ("X3", (1, 1, 1), ("data", "expert", "model"),
             dict(partition_experts=True, partition_model=True))):
        mesh = meshlib.create_mesh(1, shape=shape, axis_names=axes)
        try:
            eng = ExpertParallelEngine(create_model("moe", router_top_k=2,
                                                    **kw),
                                       mesh=mesh, router_z_weight=1e-3)
            state = eng.init_state(torch.Generator().manual_seed(0),
                                   ds.x[:1])
            batches = [eng.shard_batch(ds.x[32 * i:32 * i + 32],
                                       ds.y[32 * i:32 * i + 32])
                       for i in range(COMP_EP_STEPS)]
            ep[name] = _comp_window(eng, state, batches)
            del eng, state
        finally:
            mesh.close()
    assert ep["X3"]["losses"] == ep["twin"]["losses"], (
        ep["X3"]["losses"], ep["twin"]["losses"])
    same = [k for k, v in ep["X3"]["params"].items()
            if not torch.equal(v, ep["twin"]["params"][k])]
    assert not same, ("X3 not bitwise its (1, 1) twin", same[:4])
    runs["X3"] = ep["X3"]
    for name, run in runs.items():
        steps = len(run["step_ms"])
        p50 = float(np.median(run["step_ms"][1:]))
        SEEN[f"composite {name}"] = p50
        busy = run.get("busy", {})
        per_step = {k: v / steps for k, v in run["counts"].items() if v}
        nccl = {k: v / steps for k, v in run["nccl"].items()}
        print(f"[comp] {name} ({gpu}): losses "
              f"{' '.join(repr(v) for v in run['losses'])}; step ms "
              f"{' '.join(f'{t:.3f}' for t in run['step_ms'])} (p50 of "
              f"steps 2-{steps} {p50:.3f}); eager wall_ms="
              f"{_fmt(busy.get('wall_ms'))} busy_share="
              f"{_fmt(busy.get('busy_share'))}; peak memory above the "
              f"window's entry {run['peak'] / 2**20:.1f} MiB; flash "
              f"launches a step {json.dumps(per_step)}; NCCL calls a step "
              f"{json.dumps(nccl)}")
    print(f"[comp] X1 losses and parameters bitwise phase 5g's f32 "
          f"ring_flash window and its SeqParallelEngine twin; X2 first loss "
          f"{runs['X2']['losses'][0]!r} vs SyncEngine flash MoE GPT "
          f"{sync_first!r} (rel {x2_rel:.3e}, bound {COMP_MOE_RTOL}); X3 "
          f"losses and parameters bitwise its (1, 1) twin over "
          f"{COMP_EP_STEPS} steps")
    print(f"[comp] phase 5m wall {time.perf_counter() - t0:.1f} s")
    return {name: runs[name]["counts"] for name in ("X1", "X2")}


# --------------------------------------------------------------------------
# phase 5n: the pipeline's dense composites on one NCCL rank
# --------------------------------------------------------------------------

# C3's first loss against PG's: the same tc forward kernel (a ring of one
# block merges with weight exactly 1) on the same weights and batch; the
# forward is all a first loss sees, so it may differ only where a kernel
# of the ring path sums in another order
PPC_SP_RTOL = 1e-5
# the windows: name, mesh axes, stage options, schedule, remat
PPC_WINDOWS = (
    ("C1", ("data", "pipe", "model"), dict(partition_model=True,
                                           attention_impl="flash"),
     "gpipe", False),
    ("C2", ("data", "pipe", "model"), dict(partition_model=True,
                                           attention_impl="flash"),
     "1f1b", False),
    ("C3", ("data", "pipe", "seq"), dict(attention_impl="ring_flash",
                                         seq_axis="seq"), "gpipe", False),
    ("C3R", ("data", "pipe", "seq"), dict(attention_impl="ring_flash",
                                          seq_axis="seq"), "gpipe", True),
    ("C4", ("data", "pipe", "seq", "model"),
     dict(partition_model=True, attention_impl="ring_flash",
          seq_axis="seq"), "gpipe", False),
)


def _ppc_plan(name: str, axes, schedule: str, remat: bool) -> dict:
    """A window's planned launches a step, written before the run.  Flash
    (L layers, M microbatches): GPipe L·M forwards, dQ and dK/dV; remat
    and 1F1B run each block forward twice.  ``flash`` runs every kernel
    on ``tc``; ``ring_flash`` its block forward on ``tc`` (bf16) and its
    block backward on ``tc32`` (``flash_bwd_block`` casts to f32).  NCCL
    on a 'model' axis of one rank (a group of one still launches): per
    microbatch 2L + 1 forward all-reduces (``reduce_from_model``: each
    block's attention output and FFN output, the embed's lookup) — twice
    the block's under remat, the block's and the embed's twice under
    1F1B (its backward tick runs them again) — 2L + 1 backward all-reduces
    (``copy_to_model``: each block's attention and FFN input, the head's
    input) and one logit all-gather; no gradient all-reduce (every data,
    pipe and seq axis has one rank).  The pipe shifts are copies: T − 1
    each way, T = M + S − 1 ticks (GPipe) or 2 (M + S − 1) (1F1B)."""
    n, m = LM["layers"], PP_MICRO
    twice = remat or schedule == "1f1b"
    fwd = n * m * (2 if twice else 1)
    ring = "seq" in axes
    flash = {"fwd_tc": fwd, "dq_tc": 0 if ring else n * m,
             "dkv_tc": 0 if ring else n * m, "fwd_tc32": 0,
             "dq_tc32": n * m if ring else 0,
             "dkv_tc32": n * m if ring else 0}
    tp = "model" in axes
    reduce = m * ((4 * n + 2) if schedule == "1f1b" else
                  (4 * n + 1) if remat else (2 * n + 1)) if tp else 0
    copy = m * (2 * n + 1) if tp else 0
    shifts = PP_SHIFTS[schedule] // 2
    return {"flash": flash, "nccl": {
        "reduce_from_model": reduce, "copy_to_model": copy,
        "gather_from_model": m if tp else 0, "gradient_all_reduce": 0,
        "next_clones": shifts, "prev_clones": shifts, "next_p2p": 0,
        "prev_p2p": 0}}


def _ppc_counts() -> dict:
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll

    c = {"reduce_from_model": coll.reduce_from_model.nccl_launches,
         "copy_to_model": coll.copy_to_model.nccl_launches,
         "gather_from_model": coll.gather_from_model.nccl_launches,
         "next_clones": coll.shift_to_next.clones,
         "prev_clones": coll.shift_to_prev.clones,
         "next_p2p": coll.shift_to_next.launches,
         "prev_p2p": coll.shift_to_prev.launches}
    # every all-reduce but the Megatron pair's is a gradient reduce
    c["gradient_all_reduce"] = (coll.all_reduce_.nccl_launches
                                - c["reduce_from_model"]
                                - c["copy_to_model"])
    return c


def _reset_ppc_counts() -> None:
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll

    _reset_flash_counts()
    for fn in (coll.reduce_from_model, coll.copy_to_model,
               coll.gather_from_model, coll.all_reduce_):
        fn.nccl_launches = 0
    for fn in (coll.shift_to_next, coll.shift_to_prev):
        fn.clones = fn.launches = 0


def _ppc_window(name, axes, kw, schedule, remat, init, batches) -> dict:
    """PP_STEPS eager steps of ``PipelineEngine`` over phase 5l's GPT
    stages with ``kw`` on a mesh of ``axes``, each of one rank, from
    phase 5l's ``init`` and batches; every count set to 0 just before the
    steps and read just after, held to ``_ppc_plan``.  Returns the
    losses, step times, counts, peak memory above the window's entry and
    the final parameters, with the engine, its state and its mesh (the
    caller closes it)."""
    from distributed_tensorflow_tpu_torch.engines import PipelineEngine
    from distributed_tensorflow_tpu_torch.models.gpt import (
        gpt_pipeline_stages)
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    mesh = meshlib.create_mesh(1, shape=(1,) * len(axes), axis_names=axes)
    try:
        eng = PipelineEngine(
            microbatches=PP_MICRO, mesh=mesh, schedule=schedule, remat=remat,
            optimizer=lambda p: torch.optim.Adam(p, lr=1e-3),
            stages=gpt_pipeline_stages(
                vocab_size=LM["vocab"], hidden=LM["hidden"],
                heads=LM["heads"], ffn=LM["ffn"], max_len=LM["seq"],
                layers_per_stage=LM["layers"], dtype=torch.bfloat16,
                device=mesh.device, **kw))
        state = eng.init_state(torch.Generator().manual_seed(0))
        state.model.load_state_dict(init)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        _reset_ppc_counts()
        losses, step_ms = [], []
        for xb, yb in batches:
            t0 = time.perf_counter()
            state, m = eng.step(state, *eng.shard_batch(xb, yb))
            losses.append(float(m["loss"]))        # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
        flash = {k: v for k, v in {**_flash_counts(), **_tc32_counts()}.items()
                 if "_" in k}
        nccl = _ppc_counts()
        peak = torch.cuda.max_memory_allocated() - base_mem
        assert all(np.isfinite(losses)), (name, losses)
        plan = _ppc_plan(name, axes, schedule, remat)
        want = {k: v * PP_STEPS for k, v in plan["flash"].items()}
        assert flash == want, (name, "flash", flash, want)
        want = {k: v * PP_STEPS for k, v in plan["nccl"].items()}
        assert nccl == want, (name, "nccl", nccl, want)
        params = {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()}
    except BaseException:
        mesh.close()
        raise
    return {"losses": losses, "step_ms": step_ms, "flash": flash,
            "nccl": nccl, "peak": peak, "params": params, "eng": eng,
            "state": state, "mesh": mesh}


def ppc_phase(gpu: str, pp_ref: dict) -> dict:
    """Phase 5n (module docstring): windows C1, C2, C3, C3R and C4 from
    phase 5l's init and batches, and Cgen from C1's final state.  Returns
    each window's flash launches."""
    t0 = time.perf_counter()
    runs = {}
    gen = None
    for name, axes, kw, schedule, remat in PPC_WINDOWS:
        run = runs[name] = _ppc_window(name, axes, kw, schedule, remat,
                                       pp_ref["init"], pp_ref["batches"])
        eng, state, mesh = run.pop("eng"), run.pop("state"), run.pop("mesh")
        try:
            if name == "C1":
                t1 = time.perf_counter()
                tokens = eng.generate(state, pp_ref["prompts"], PP_NEW)
                gen = {"ms": (time.perf_counter() - t1) * 1e3,
                       "tokens": tokens}
            # busy readings for the first and the widest window only:
            # the smoke's wall is near its budget, and the profiler's
            # processing of a session is its cost
            run["busy"] = (_eager_busy(eng, state, *eng.shard_batch(
                *pp_ref["batches"][0])) if name in ("C1", "C4")
                else _NOT_READ)
        finally:
            del eng, state
            mesh.close()
            torch.cuda.empty_cache()
    pg, p1 = pp_ref["PG"], pp_ref["P1"]

    def same(run, ref) -> bool:
        return run["losses"] == ref["losses"] and all(
            torch.equal(run["params"][k], v) for k, v in ref["params"].items())

    gates = {"C1 = PG": same(runs["C1"], pg), "C2 = P1": same(runs["C2"], p1),
             "C3R = C3": same(runs["C3R"], runs["C3"]),
             "C4 = C3": same(runs["C4"], runs["C3"]),
             "Cgen = Pgen": bool(np.array_equal(gen["tokens"],
                                                pp_ref["tokens"]))}
    rel = abs(runs["C3"]["losses"][0] - pg["losses"][0]) / pg["losses"][0]
    gates["C3 first loss"] = rel <= PPC_SP_RTOL
    for label, run in runs.items():
        p50 = float(np.median(run["step_ms"][1:]))
        SEEN[f"ppc {label}"] = p50
        per_step = {k: v / PP_STEPS for k, v in run["flash"].items() if v}
        nccl = {k: v / PP_STEPS for k, v in run["nccl"].items() if v}
        print(f"[ppc] {label} ({gpu}): losses "
              f"{' '.join(repr(v) for v in run['losses'])}; step ms "
              f"{' '.join(f'{t:.3f}' for t in run['step_ms'])} (p50 of "
              f"steps 2-{PP_STEPS} {p50:.3f}); eager wall_ms="
              f"{_fmt(run['busy']['wall_ms'])} busy_share="
              f"{_fmt(run['busy']['busy_share'])}; peak memory above the "
              f"window's entry {run['peak'] / 2**20:.1f} MiB; flash "
              f"launches a step {json.dumps(per_step)}; NCCL calls and "
              f"pipe shifts a step {json.dumps(nccl)}")
    print(f"[ppc] Cgen ({gpu}): generate from C1's state, "
          f"{len(gen['tokens'])} prompts of {PP_PROMPT} tokens + {PP_NEW} "
          f"new, {gen['ms']:.1f} ms; C3's first loss "
          f"{runs['C3']['losses'][0]!r} vs PG's {pg['losses'][0]!r} (rel "
          f"{rel:.3e}, bound {PPC_SP_RTOL}); gates {json.dumps(gates)}")
    assert all(gates.values()), gates
    print(f"[ppc] phase 5n wall {time.perf_counter() - t0:.1f} s")
    return {name: run["flash"] for name, run in runs.items()}


# --------------------------------------------------------------------------
# phase 5o: the pipeline's MoE composites on one NCCL rank
# --------------------------------------------------------------------------

# the router terms of phase 5o's objective (bench --moe's aux weight, the
# z-loss on)
PPE_AUX, PPE_Z = 0.01, 1e-3
# the windows: name, mesh axes, stage options, remat
PPE_WINDOWS = (
    ("E0", ("data", "pipe"), dict(attention_impl="flash"), False),
    ("E1", ("data", "pipe", "expert"), dict(attention_impl="flash"), False),
    ("E1R", ("data", "pipe", "expert"), dict(attention_impl="flash"), True),
    ("E2", ("data", "pipe", "expert", "model"),
     dict(attention_impl="flash", partition_model=True), False),
    ("E3", ("data", "pipe", "expert", "seq"),
     dict(attention_impl="ring_flash", seq_axis="seq"), False),
    ("E4", ("data", "pipe", "expert", "model", "seq"),
     dict(attention_impl="ring_flash", seq_axis="seq",
          partition_model=True), False),
)


def _ppe_plan(axes, remat: bool) -> dict:
    """A window's planned launches a step, written before the run.  Flash
    (L layers, M microbatches) as ``_ppc_plan`` (GPipe; remat runs each
    block forward twice).  NCCL on an 'expert' axis of one rank (the
    layers' ``replicated`` route): per MoE layer call one forward
    ``reduce_from_model`` (the combine) and, in its backward, two
    ``copy_to_model`` all-reduces (the router's probabilities and the
    tokens); on a 'model' axis per layer call the attention's pair and
    the 2-D expert layout's pair (each one forward reduce and one
    backward copy), and per microbatch the embed's lookup (a reduce), the
    head's input (a copy) and one logit all-gather.  The forward reduces
    of a block count twice under remat.  Gradient all-reduces: two on the
    (data, pipe) mesh (PR 19's), none on a composite mesh of one-rank
    axes.  The pipe shifts are copies: M − 1 each way."""
    n, m = LM["layers"], PP_MICRO
    fwd = n * m * (2 if remat else 1)
    ring = "seq" in axes
    flash = {"fwd_tc": fwd, "dq_tc": 0 if ring else n * m,
             "dkv_tc": 0 if ring else n * m, "fwd_tc32": 0,
             "dq_tc32": n * m if ring else 0,
             "dkv_tc32": n * m if ring else 0}
    ep, tp = "expert" in axes, "model" in axes
    reduce = fwd * ((1 if ep else 0) + (2 if tp else 0)) + (m if tp else 0)
    copy = n * m * ((2 if ep else 0) + (2 if tp else 0)) + (m if tp else 0)
    shifts = PP_SHIFTS["gpipe"] // 2
    return {"flash": flash, "nccl": {
        "reduce_from_model": reduce, "copy_to_model": copy,
        "gather_from_model": m if tp else 0,
        "gradient_all_reduce": 2 if axes == ("data", "pipe") else 0,
        "next_clones": shifts, "prev_clones": shifts, "next_p2p": 0,
        "prev_p2p": 0}}


def _ppe_engine(mesh, kw, remat: bool = False, schedule: str = "gpipe"):
    """``PipelineEngine`` over phase 5l's GPT stages with phase 5h's MoE
    FFN (``MOE_GPT``) on ``mesh``, the router terms on."""
    from distributed_tensorflow_tpu_torch.engines import PipelineEngine
    from distributed_tensorflow_tpu_torch.models.gpt import (
        gpt_pipeline_stages)

    return PipelineEngine(
        microbatches=PP_MICRO, mesh=mesh, schedule=schedule, remat=remat,
        aux_weight=PPE_AUX, router_z_weight=PPE_Z,
        optimizer=lambda p: torch.optim.Adam(p, lr=1e-3),
        stages=gpt_pipeline_stages(
            vocab_size=LM["vocab"], hidden=LM["hidden"], heads=LM["heads"],
            ffn=LM["ffn"], max_len=LM["seq"], layers_per_stage=LM["layers"],
            dtype=torch.bfloat16, device=mesh.device,
            moe_experts=MOE_GPT["experts"], moe_top_k=MOE_GPT["top_k"],
            moe_capacity_factor=MOE_GPT["capacity_factor"],
            partition_experts=True, **kw))


def _ppe_window(name, axes, kw, remat, init, batches) -> dict:
    """PP_STEPS eager steps of the MoE pipeline on a mesh of ``axes``,
    each of one rank, from ``init`` on phase 5l's batches; every count set
    to 0 just before the steps and read just after, held to
    ``_ppe_plan``.  E0's first loss is held to the sequential forward's
    mean cross-entropy over the microbatches, each routed alone (the
    routing population of a stage's call).  Returns the losses,
    overflows, step times, counts, peak memory above the window's entry
    and the final parameters, with the engine, its state and its mesh
    (the caller closes it)."""
    from distributed_tensorflow_tpu_torch.engines.base import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    mesh = meshlib.create_mesh(1, shape=(1,) * len(axes), axis_names=axes)
    try:
        eng = _ppe_engine(mesh, kw, remat)
        # ``init`` replaces the seeded draw, which every window would
        # throw away: the host draws the experts at ~1.3 s a layer
        eng.model.reset_parameters = lambda generator=None: eng.model
        state = eng.init_state(torch.Generator().manual_seed(0))
        state.model.load_state_dict(init)
        seq = None
        if name == "E0":
            model = eng.eval_params(state)
            with torch.no_grad():
                seq = float(np.mean([float(cross_entropy(
                    eng._sequential_logits(model, xm), ym).mean())
                    for xm, ym in zip(*(t.chunk(PP_MICRO) for t in
                                        eng.shard_batch(*batches[0])))]))
            del model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        _reset_ppc_counts()
        losses, overflow, step_ms = [], [], []
        for xb, yb in batches:
            t0 = time.perf_counter()
            state, m = eng.step(state, *eng.shard_batch(xb, yb))
            losses.append(float(m["loss"]))        # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            overflow.append(float(m["overflow"]))
        flash = {k: v for k, v in {**_flash_counts(), **_tc32_counts()}.items()
                 if "_" in k}
        nccl = _ppc_counts()
        peak = torch.cuda.max_memory_allocated() - base_mem
        assert all(np.isfinite(losses)), (name, losses)
        assert all(0.0 <= v < 1.0 for v in overflow), (name, overflow)
        plan = _ppe_plan(axes, remat)
        want = {k: v * PP_STEPS for k, v in plan["flash"].items()}
        assert flash == want, (name, "flash", flash, want)
        want = {k: v * PP_STEPS for k, v in plan["nccl"].items()}
        assert nccl == want, (name, "nccl", nccl, want)
        if seq is not None:
            assert abs(losses[0] - seq) <= PP_LOSS_RTOL * seq, (
                name, losses[0], seq)
        params = {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()}
    except BaseException:
        mesh.close()
        raise
    return {"losses": losses, "overflow": overflow, "seq_loss": seq,
            "step_ms": step_ms, "flash": flash, "nccl": nccl, "peak": peak,
            "params": params, "eng": eng, "state": state, "mesh": mesh}


def ppe_phase(gpu: str, pp_ref: dict) -> dict:
    """Phase 5o (module docstring): windows E0, E1, E1R, E2, E3 and E4
    from phase 5l's init with the MoE FFN added and its batches, then
    1F1B's refusal.  Returns each window's flash launches."""
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    t0 = time.perf_counter()
    # phase 5l's leaves but its FFN's, and the MoE FFN drawn on the card
    # from seed 0 at flax's lecun-normal variance (every window loads it;
    # each layer's whole draw on the host would take ~1.3 s)
    gen = torch.Generator(device="cuda").manual_seed(0)
    d, e, h = LM["hidden"], MOE_GPT["experts"], LM["ffn"]
    init = {k: v for k, v in pp_ref["init"].items()
            if ".fc1." not in k and ".fc2." not in k}
    for i in range(LM["layers"]):
        for leaf, shape in (("gate", (d, e)), ("w1", (e, d, h)),
                            ("w2", (e, h, d))):
            init[f"block.layers.{i}.moe.{leaf}"] = torch.randn(
                shape, generator=gen, device="cuda") * math.prod(
                shape[:-1]) ** -0.5
    mesh = meshlib.create_mesh(1, shape=(1, 1), axis_names=("data", "pipe"))
    try:
        try:
            _ppe_engine(mesh, dict(attention_impl="flash"),
                        schedule="1f1b")
            refusal = None
        except ValueError as e:
            refusal = str(e)
    finally:
        mesh.close()
        torch.cuda.empty_cache()
    runs = {}
    for name, axes, kw, remat in PPE_WINDOWS:
        run = runs[name] = _ppe_window(name, axes, kw, remat, init,
                                       pp_ref["batches"])
        eng, state, mesh = run.pop("eng"), run.pop("state"), run.pop("mesh")
        try:
            # one step a reading, for the first and the widest window
            # only: the profiler's processing of a MoE step's many
            # routing kernels, more than the steps, sets the phase's wall
            run["busy"] = (_eager_busy(eng, state, *eng.shard_batch(
                *pp_ref["batches"][0]), steps=1) if name in ("E0", "E4")
                else _NOT_READ)
        finally:
            del eng, state
            mesh.close()
            torch.cuda.empty_cache()

    def same(run, ref) -> bool:
        return (run["losses"] == ref["losses"]
                and run["overflow"] == ref["overflow"]
                and all(torch.equal(run["params"][k], v)
                        for k, v in ref["params"].items()))

    gates = {"E1 = E0": same(runs["E1"], runs["E0"]),
             "E1R = E1": same(runs["E1R"], runs["E1"]),
             "E2 = E1": same(runs["E2"], runs["E1"]),
             "E4 = E3": same(runs["E4"], runs["E3"])}
    e1 = runs["E1"]["losses"][0]
    rel = abs(runs["E3"]["losses"][0] - e1) / e1
    gates["E3 first loss"] = rel <= PPC_SP_RTOL
    gates["1F1B refused"] = refusal is not None and refusal.startswith(
        "schedule='1f1b' does not compose with MoE stage blocks")
    for label, run in runs.items():
        p50 = float(np.median(run["step_ms"][1:]))
        SEEN[f"ppe {label}"] = p50
        per_step = {k: v / PP_STEPS for k, v in run["flash"].items() if v}
        nccl = {k: v / PP_STEPS for k, v in run["nccl"].items() if v}
        print(f"[ppe] {label} ({gpu}): losses "
              f"{' '.join(repr(v) for v in run['losses'])}; overflow "
              f"{' '.join(repr(v) for v in run['overflow'])}; step ms "
              f"{' '.join(f'{t:.3f}' for t in run['step_ms'])} (p50 of "
              f"steps 2-{PP_STEPS} {p50:.3f}); eager wall_ms="
              f"{_fmt(run['busy']['wall_ms'])} busy_share="
              f"{_fmt(run['busy']['busy_share'])}; peak memory above the "
              f"window's entry {run['peak'] / 2**20:.1f} MiB; flash "
              f"launches a step {json.dumps(per_step)}; NCCL calls and "
              f"pipe shifts a step {json.dumps(nccl)}")
    e0 = runs["E0"]
    print(f"[ppe] E0's first loss {e0['losses'][0]!r} vs the sequential "
          f"per-microbatch forward's {e0['seq_loss']!r} (bound "
          f"{PP_LOSS_RTOL * e0['seq_loss']:.3e}); E3's first loss "
          f"{runs['E3']['losses'][0]!r} vs E1's {e1!r} (rel {rel:.3e}, "
          f"bound {PPC_SP_RTOL}); 1F1B: {refusal}; gates "
          f"{json.dumps(gates)}")
    assert all(gates.values()), gates
    print(f"[ppe] phase 5o wall {time.perf_counter() - t0:.1f} s")
    return {name: run["flash"] for name, run in runs.items()}


# --------------------------------------------------------------------------
# phase 5p: TP decode on one NCCL rank
# --------------------------------------------------------------------------

# TPL's flags: window L1's with -tp 1, which the harness runs as L1 (a
# 'model' axis needs -tp > 1, and a serve mesh more than one rank, as in
# JAX's harness)
CLI_TPL_ARGV = CLI_L1_ARGV + ["-tp", "1"]
# the serve GPT's K/V heads a rank at tp 2, 4 and 8 (8 heads, MHA)
TPD_KV_HEADS = (4, 2, 1)


def _tpd_window(name, kv, requests, gpu, ref, layers) -> dict:
    """A serve window over a TP table (``_serve_window``), its streams
    bitwise phase 5's window ``ref``, its NCCL calls those of one forward
    a dispatch (2 x layers + 1 model-axis all-reduces: the row-parallel
    ``out`` and ``fc2`` and the vocab-parallel embedding; one logit
    all-gather) and, paged, one kernel launch a layer a decode step."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    summary, (launches, int8, _) = _serve_window(
        name, kv, requests, gpu, before_main=_reset_mp_counts)
    by_kvh = dict(pa.paged_attention.launches_by_kv_heads)
    mp = _mp_counts()
    same = _streams(summary) == SEEN[f"serve {ref}"]["streams"]
    assert same, f"window {name}'s streams differ from window {ref}'s"
    n = summary["dispatches"]
    want = {"gather": 0, "scatter": 0, "reduce_from_model": (2 * layers + 1)
            * n, "copy_to_model": 0, "gather_from_model": n,
            "all_reduce": (2 * layers + 1) * n}
    assert mp == want, (name, mp, want)
    iters = summary["decode_iterations"]
    if kv.kv_layout == "paged":
        assert launches == layers * iters, (name, launches, iters)
        assert int8 == (launches if kv.kv_dtype == "int8" else 0), int8
        # tp 1: every launch at the model's whole K/V head count
        assert by_kvh == {kv.model.kv_heads: launches}, (name, by_kvh)
    else:
        assert launches == 0 and not by_kvh, (launches, by_kvh)
    assert kv.eager_rounds and kv.model.tp_mesh is not None
    print(f"[tpd] window {name} ({gpu}): streams bitwise window {ref}'s; "
          f"itl_p50_s={summary['serve_itl_p50_s']:.6f} (window {ref}: "
          f"{SEEN[f'serve {ref}']['itl_p50_s']:.6f}); NCCL collectives "
          f"{json.dumps(mp)} over {n} forwards; paged launches {launches} "
          f"(int8 {int8}) over {iters} decode iterations, by K/V heads "
          f"{json.dumps(by_kvh)}")
    return {"launches": launches, "int8": int8, "by_kv_heads": by_kvh,
            "itl_p50_s": summary["serve_itl_p50_s"]}


def tpd_phase(gpu: str) -> dict:
    """Phase 5p (module docstring): TPL through ``cli.main``; TPM, TPP and
    TPQ, the serve GPT bound to a (1, 1) (data, model) NCCL mesh on
    ``SlotKVCache(mesh=...)``; TPG; returns the paged launches."""
    from distributed_tensorflow_tpu_torch.models.gpt import generate
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    t0 = time.perf_counter()
    layers, slots, block = SERVE["layers"], SERVE["slots"], SERVE["block"]

    # TPL: window L1 with -tp 1, bitwise L1
    rec, _, tpl_paged, _ = _cli_lm_window(
        "TPL (-tp 1, f32)", CLI_TPL_ARGV, gpu, 8,
        (torch.float32, CLI_LM["heads"], CLI_LM["heads"]))
    sm, l1 = rec["summary"], SEEN["L1"]
    same = {"test_loss": sm["test_loss"] == l1["test_loss"],
            "samples": sm["samples"] == l1["samples"],
            "streams": _streams(rec["serve_summary"]) == l1["streams"]}
    assert all(same.values()), (same, sm["test_loss"], l1["test_loss"])
    assert tpl_paged == CLI_LM["layers"] * sm["serve"]["decode_iterations"]
    assert rec["serve_kv"].mesh is None, "TPL's table took a mesh"
    print(f"[tpd] TPL ({gpu}): cli.main with -tp 1 bitwise window L1 "
          f"{json.dumps(same)}; the serve table without a mesh (one "
          f"rank); paged launches {tpl_paged}")
    del rec

    model = _serve_model()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    shared, requests = _bench_trace()
    pool = dict(prefix_cache_blocks=SERVE["pool"], prefix_block=block)
    mesh = meshlib.create_mesh(1, shape=(1, 1), axis_names=("data", "model"))
    out = {"TPL": tpl_paged}
    try:
        for name, ref, kw in (
                ("TPM", "M", {}),
                ("TPP", "P", dict(kv_layout="paged", paged_block=block)),
                ("TPQ", "Q", dict(kv_layout="paged", paged_block=block,
                                  kv_dtype="int8"))):
            kv = SlotKVCache(_serve_model(partition_model=True), sd, slots,
                             mesh=mesh, **pool, **kw)
            out[name] = _tpd_window(name, kv, requests, gpu, ref, layers)
            label = {"TPM": "TP monolithic", "TPP": "TP paged"}.get(name)
            if label:
                for req in requests[:slots]:
                    kv.insert(req.prompt)
                _profile_decode(kv, label)
            del kv
        # TPG: generate over the mesh, bitwise the unbound model's
        prompts = np.stack([r.prompt[:24] for r in requests[:slots]])
        want = generate(model, None, prompts, 32, greedy=True)
        _reset_mp_counts()
        got = generate(_serve_model(partition_model=True), sd, prompts, 32,
                       greedy=True, mesh=mesh)
        mp = _mp_counts()
        assert torch.equal(got, want), "TPG differs from generate"
        # one prefill forward and 32 steps
        assert mp["gather_from_model"] == 33, mp
        print(f"[tpd] TPG ({gpu}): generate(mesh=(1, 1)) of 8 prompts x 32 "
              f"tokens bitwise the unbound model's; NCCL collectives "
              f"{json.dumps(mp)}")
    finally:
        mesh.close()
    for label, ref in (("TP paged", "paged"),
                       ("TP monolithic", "monolithic")):
        tp, base = SEEN.get(f"decode {label}"), SEEN.get(f"decode {ref}")
        if tp and base:
            print(f"[tpd] {label} decode step ({gpu}): wall_ms="
                  f"{tp['wall_ms']:.4f} busy_share={tp['busy_share']:.4f} "
                  f"against window {ref}'s wall_ms={base['wall_ms']:.4f} "
                  f"busy_share={base['busy_share']:.4f}")
    del model, sd
    torch.cuda.empty_cache()
    print(f"[tpd] phase 5p wall {time.perf_counter() - t0:.1f} s")
    return {"paged": out["TPP"]["launches"] + out["TPQ"]["launches"],
            "int8": out["TPQ"]["int8"], "TPL": tpl_paged,
            "by_kv_heads": {"bf16": out["TPP"]["by_kv_heads"],
                            "int8": out["TPQ"]["by_kv_heads"]}}


# --------------------------------------------------------------------------
# phase 5q: the lease drain and the telemetry on the cli-lm GPT
# --------------------------------------------------------------------------

LEASE_BUDGET = 300        # Q1's --max-steps-per-lease: not a multiple of
                          # 8, so the drain lands on boundary 304
LEASE_SIGNAL_CHUNK = 20   # Q2's timer thread sends SIGTERM once the fit
                          # has dispatched this many chunks (160 steps)


def _same_as(state, want: dict) -> bool:
    """A state's checkpoint tensors and fields bitwise ``want``'s."""
    got = state.engine.checkpoint_state(state)
    return got.keys() == want.keys() and all(
        torch.equal(v, got[k]) if isinstance(v, torch.Tensor) else v == got[k]
        for k, v in want.items())


def _sigterm_back(label: str, want) -> None:
    """The window left SIGTERM's disposition as it found it."""
    now = signal.getsignal(signal.SIGTERM)
    assert now is want, (label, now, want)


def _lease_resume(label, tmp, c0, gpu, stopped: int):
    """An ``elastic_restore`` run of the drained directory finishes the
    fit; its final state and test loss are bitwise C0's."""
    r, tr = _kept_run(_ckpt_config(checkpoint_dir=f"{tmp}", elastic_restore=True))
    rep = r["run_report"]
    assert rep["restored_step"] == stopped and rep["resume_replay_steps"] == 0
    assert r["steps"] == c0["steps"] - stopped and r["preempted"] is None, r
    checks = {"state": _same_as(tr.state, c0["state"]),
              "test_loss": r["test_loss"] == c0["test_loss"]}
    assert all(checks.values()), (label, checks)
    print(f"[lease] {label} resume ({gpu}): --elastic-restore from step "
          f"{stopped}, {r['steps']} steps, resume_replay_steps 0, "
          f"preemption_lost_s {rep['preemption_lost_s']:.3f}: bitwise C0 "
          f"{json.dumps(checks)}")


def lease_phase(gpu: str, c0: dict) -> dict:
    """Phase 5q (module docstring): Q1–Q4; returns the windows' flash
    launches on tc32 and Q3's paged launches on f32 pools."""
    import shutil
    import tempfile

    from distributed_tensorflow_tpu_torch import observability as obs
    from distributed_tensorflow_tpu_torch.data import loaders
    from distributed_tensorflow_tpu_torch.utils import metrics as um
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    train = loaders.load_dataset("lm_synth", split="train")
    test = loaders.load_dataset("lm_synth", split="test")
    epoch = len(train) // CLI_LM["batch"]
    evals = -(-len(test) // 100)
    stop_q1 = -(-LEASE_BUDGET // 8) * 8
    layers = CLI_LM["layers"]
    print(f"[lease] predicted: Q1 drains at boundary {stop_q1} (budget "
          f"{LEASE_BUDGET}, chunks of 8), Q2 at a boundary at or past "
          f"{8 * LEASE_SIGNAL_CHUNK}; each drain + resume pair launches "
          f"{layers} x ({2 * epoch} + {2 * evals}) flash forwards and "
          f"{layers} x {2 * epoch} dQ and dK/dV, all tc32; Q3 L1's "
          f"counts; Q4 {layers} x {LM_HEAD_ROWS // CLI_LM['batch']} "
          f"+ {layers} (eval) forwards")
    total = {"fwd": 0, "dq": 0, "dkv": 0}

    def add(counts):
        for k in total:
            total[k] += counts[f"{k}_tc32"]

    before = signal.getsignal(signal.SIGTERM)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lease_")
    try:
        # Q1: the step budget, then the resume
        t_q = time.perf_counter()
        _reset_flash_counts()
        q1, _ = _kept_run(_ckpt_config(checkpoint_dir=f"{tmp}/q1",
                                       max_steps_per_lease=LEASE_BUDGET))
        _sigterm_back("Q1", before)
        assert q1["preempted"] == f"max_steps_per_lease:{LEASE_BUDGET}", q1
        assert q1["steps"] == stop_q1, q1["steps"]
        assert CheckpointManager(f"{tmp}/q1").latest_step() == stop_q1
        lease = q1["run_report"]["lease"]
        assert lease == {"max_steps_per_lease": LEASE_BUDGET,
                         "signal_handler_installed": True,
                         "preempt_signal": None, "triggered": None}, lease
        print(f"[lease] Q1 ({gpu}): --max-steps-per-lease {LEASE_BUDGET} "
              f"drained at boundary {q1['steps']} (preempted "
              f"{q1['preempted']!r}), final checkpoint step_{stop_q1}; "
              f"lease {json.dumps(lease)}; stragglers "
              f"{json.dumps(q1['run_report']['stragglers'])}")
        _lease_resume("Q1", f"{tmp}/q1", c0, gpu, stop_q1)
        _sigterm_back("Q1 resume", before)
        counts = {**_flash_counts(), **_tc32_counts()}
        _ckpt_launches("Q1", counts, 2 * epoch, 2 * evals, "tc32")
        add(counts)
        print(f"[lease] Q1 + resume: {time.perf_counter() - t_q:.1f} s; "
              f"flash launches {json.dumps(counts)}")

        # Q2: SIGTERM from a timer thread during the fit.  A guard handler
        # of the smoke's own stands behind the lease, so a signal that
        # landed outside it would fail the gates instead of ending the run
        t_q = time.perf_counter()
        caught: list = []
        dispatched = threading.Event()
        guard = lambda signum, frame: caught.append(signum)  # noqa: E731
        signal.signal(signal.SIGTERM, guard)
        try:
            def notice():
                if dispatched.wait(600):
                    os.kill(os.getpid(), signal.SIGTERM)

            timer = threading.Thread(target=notice, daemon=True)
            timer.start()
            _reset_flash_counts()
            q2, _ = _kept_run(
                _ckpt_config(checkpoint_dir=f"{tmp}/q2"),
                on_chunk=lambda n: (dispatched.set()
                                    if n == LEASE_SIGNAL_CHUNK else None))
            timer.join(60)
            _sigterm_back("Q2", guard)
        finally:
            signal.signal(signal.SIGTERM, before)
        _sigterm_back("Q2, the guard removed", before)
        stop_q2 = q2["steps"]
        assert not caught, caught
        assert q2["preempted"] == "signal:SIGTERM", q2["preempted"]
        assert q2["run_report"]["lease"]["preempt_signal"] == "SIGTERM"
        assert 8 * LEASE_SIGNAL_CHUNK <= stop_q2 < 2 * epoch, stop_q2
        assert stop_q2 % 8 == 0
        assert CheckpointManager(f"{tmp}/q2").latest_step() == stop_q2
        print(f"[lease] Q2 ({gpu}): SIGTERM from a timer thread after "
              f"chunk {LEASE_SIGNAL_CHUNK} was dispatched; drained at "
              f"boundary {stop_q2} (preempted {q2['preempted']!r}) with "
              f"its final checkpoint; SIGTERM's disposition back "
              f"(the smoke's guard, then the default)")
        _lease_resume("Q2", f"{tmp}/q2", c0, gpu, stop_q2)
        _sigterm_back("Q2 resume", before)
        counts = {**_flash_counts(), **_tc32_counts()}
        _ckpt_launches("Q2", counts, 2 * epoch, 2 * evals, "tc32")
        add(counts)
        print(f"[lease] Q2 + resume: {time.perf_counter() - t_q:.1f} s")

        # Q3: window L1 with the metrics, the trace and the timeline on
        t_q = time.perf_counter()
        made = {}

        class KeptTracer(obs.Tracer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made["tracer"] = self

        class KeptLogger(um.MetricsLogger):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made["logger"] = self

        paths = {"metrics": Path(tmp) / "q3_metrics.jsonl",
                 "trace": Path(tmp) / "q3_trace.jsonl"}
        saved = obs.Tracer, um.MetricsLogger
        obs.Tracer, um.MetricsLogger = KeptTracer, KeptLogger
        try:
            rec, counts, paged, _ = _cli_lm_window(
                "Q3 (L1 + --metrics-path --trace --timeline)",
                CLI_L1_ARGV + ["--metrics-path", str(paths["metrics"]),
                               "--trace", str(paths["trace"]),
                               "--timeline"], gpu, 8,
                (torch.float32, CLI_LM["heads"], CLI_LM["heads"]))
        finally:
            obs.Tracer, um.MetricsLogger = saved
        _sigterm_back("Q3", before)
        sm, sv, l1 = rec["summary"], rec["summary"]["serve"], SEEN["L1"]
        rr = sm["run_report"]
        checks = {"test_loss": sm["test_loss"] == l1["test_loss"],
                  "samples": sm["samples"] == l1["samples"],
                  "streams": _streams(rec["serve_summary"]) == l1["streams"],
                  "flash launches": counts == l1["counts"],
                  "paged launches": paged == l1["paged"]}
        assert all(checks.values()), checks
        assert paged == layers * sv["decode_iterations"]
        records = [json.loads(line) for line in
                   paths["metrics"].read_text().splitlines()]
        assert [r["step"] for r in records] == list(range(1, epoch + 1))
        assert {"schema_version", "step", "time", "loss",
                "accuracy"} <= set(records[0]), records[0]
        lines = paths["trace"].read_text().splitlines()
        trace = [json.loads(line) for line in lines]   # every line whole
        tracer, logger = made["tracer"], made["logger"]
        assert len(trace) == tracer.stats()["written"] and \
            tracer.stats()["dropped"] == 0
        span_names = {r["name"] for r in trace if r["event"] == "span"}
        assert {"compile", "chunk_dispatch", "materialize", "eval", "serve",
                "request", "prefill_chunk", "decode"} <= span_names, \
            span_names
        assert sum(r["event"] == "event" and r["name"] == "timeline_series"
                   for r in trace) > 0
        tl_keys = ("queue_depth_auc", "kv_blocks_in_use_p95",
                   "timeline_overhead_s")
        assert all(k in sv for k in tl_keys), sorted(sv)
        assert rr["stragglers"]["observed"] > 0 and rr["lease"] is None
        assert rr["metrics_sink"] == {"records": epoch, "dropped": 0,
                                      "written": epoch}, rr["metrics_sink"]
        elapsed = rr["elapsed_s"]
        shares = {"tracer": tracer.overhead_s / elapsed,
                  "metrics_logger": logger.overhead_s / elapsed,
                  "timeline": rr["timeline"]["overhead_s"] / elapsed,
                  "report_total": rr["telemetry_overhead_frac"]}
        print(f"[lease] Q3 ({gpu}): bitwise L1 {json.dumps(checks)}; "
              f"{len(records)} metrics records (one a step), "
              f"{len(trace)} trace lines, all whole; spans "
              + "; ".join(f"{name} {v['count']} x, {v['total_s']:.4f} s"
                          for name, v in rr["spans"].items())
              + f"; telemetry overhead shares of the fit's "
              f"{elapsed:.3f} s: "
              + ", ".join(f"{k} {v:.6f}" for k, v in shares.items())
              + f"; step_ms_p50 {rr['step_time_p50_s'] * 1e3:.4f} "
              f"(L1 {l1['step_ms_p50']:.4f}); serve "
              + ", ".join(f"{k} {sv[k]!r}" for k in tl_keys)
              + f"; stragglers {json.dumps(rr['stragglers'])}; lease "
              f"{rr['lease']!r} (no --checkpoint-dir); paged launches "
              f"{paged} = {layers} x {sv['decode_iterations']} decode "
              f"iterations on f32 pools; {time.perf_counter() - t_q:.1f} s")
        add(counts)
        q3_paged = paged
        del rec

        # Q4: a short fit under --profile-dir
        t_q = time.perf_counter()
        prof = Path(tmp) / "q4_profile"
        _reset_flash_counts()
        q4, _ = _kept_run(_ckpt_config(
            epochs=1, dataset_fn=_lm_head_rows,
            profile_dir=str(prof)))
        _sigterm_back("Q4", before)
        counts = {**_flash_counts(), **_tc32_counts()}
        add(counts)
        files = sorted(prof.glob("*.pt.trace.json"))
        assert len(files) == 1, files
        events = json.loads(files[0].read_text())["traceEvents"]
        names = [e.get("name", "") for e in events]
        spans = {n for n in ("compile", "chunk_dispatch", "materialize")
                 if n in names}
        kernels = {k: sum(k in n for n in names) for k in (
            "flash_fwd_tc32_kernel", "flash_dq_tc32_kernel",
            "flash_dkv_tc32_kernel")}
        assert spans == {"compile", "chunk_dispatch", "materialize"}, spans
        assert all(kernels.values()), kernels
        print(f"[lease] Q4 ({gpu}): a {q4['steps']}-step fit under "
              f"--profile-dir ({files[0].stat().st_size} bytes, "
              f"{len(events)} events): the Trainer's spans {sorted(spans)}; "
              f"tc32 kernel events {json.dumps(kernels)} against launches "
              f"{json.dumps({k: counts[k + '_tc32'] for k in total})} "
              f"(the first chunk eager, the second captured, the third "
              f"replayed); {time.perf_counter() - t_q:.1f} s")
    finally:
        signal.signal(signal.SIGTERM, before)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"tc32": total, "paged_f32": q3_paged}


# --------------------------------------------------------------------------
# phase 5r: health, the roofline, the ledger and the analyzer on the cli-lm
# GPT
# --------------------------------------------------------------------------

HEALTH_INJECT_AT = 20     # R3's poisoned step: inside the third chunk of 8,
                          # the first replayed one


def _health_records(path) -> list[dict]:
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _health_fit(gpu, label: str, cfg, **fit_kw):
    """The cli-lm GPT (``_ckpt_config``'s engine) on ``_lm_head_rows``
    with health ``cfg`` through ``Trainer.fit`` at steps_per_call 8; its
    result (or the error it raised), every step's metrics record and the
    flash launches."""
    from distributed_tensorflow_tpu_torch.engines import Trainer
    from distributed_tensorflow_tpu_torch.utils import harness

    class Records:
        def __init__(self):
            self.records = []

        def should_log(self, step):
            return True

        def log(self, step, **metrics):
            self.records.append((step, metrics))

        def flush(self):
            pass

    ex = harness._setup(_ckpt_config(epochs=1, dataset_fn=_lm_head_rows))
    rec = Records()
    _reset_flash_counts()
    try:
        ex.engine.enable_health(cfg)
        try:
            out = Trainer(None, engine=ex.engine, seed=0).fit(
                ex.train_ds, batch_size=CLI_LM["batch"], log_every=0,
                steps_per_call=8, metrics_logger=rec,
                log_fn=lambda _: None, **fit_kw)
        except Exception as e:   # the policy's raise is this window's result
            out = e
    finally:
        ex.mesh.close()
    torch.cuda.synchronize()
    counts = {**_flash_counts(), **_tc32_counts()}
    print(f"[health] {label} ({gpu}): "
          + (f"raised {type(out).__name__}: {out}"
             if isinstance(out, Exception) else
             f"{out['steps']} steps, health {json.dumps(out['health'])}")
          + f"; {len(rec.records)} records; flash launches "
          f"{json.dumps(counts)}")
    return out, rec.records, counts


def health_phase(gpu: str) -> dict:
    """Phase 5r (module docstring): R1, R1r, R2, R3; returns the windows'
    flash launches on tc32 and R1's paged launches on f32 pools."""
    import shutil
    import tempfile

    from distributed_tensorflow_tpu_torch.observability import (
        HealthConfig, ProgramLedger, analyze)
    from distributed_tensorflow_tpu_torch.observability import health as hl
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache
    from distributed_tensorflow_tpu_torch.utils.failure import (
        AnomalyDetected)

    layers = CLI_LM["layers"]
    total = {"fwd": 0, "dq": 0, "dkv": 0}

    def add(counts):
        for k in total:
            total[k] += counts[f"{k}_tc32"]

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_health_"))
    try:
        # R1: window L1 with --health on --roofline
        t_r = time.perf_counter()
        rec, counts, paged, _ = _cli_lm_window(
            "R1 (L1 + --health on --roofline)",
            CLI_L1_ARGV + ["--health", "on", "--roofline",
                           "--metrics-path", str(tmp / "r1_metrics.jsonl")],
            gpu, 8, (torch.float32, CLI_LM["heads"], CLI_LM["heads"]))
        add(counts)
        sm, sv, l1 = rec["summary"], rec["summary"]["serve"], SEEN["L1"]
        rr = sm["run_report"]
        checks = {"test_loss": sm["test_loss"] == l1["test_loss"],
                  "samples": sm["samples"] == l1["samples"],
                  "streams": _streams(rec["serve_summary"]) == l1["streams"],
                  "flash launches": counts == l1["counts"],
                  "paged launches": paged == l1["paged"]}
        assert all(checks.values()), checks
        records = _health_records(tmp / "r1_metrics.jsonl")
        assert [r["step"] for r in records] == list(
            range(1, sm["steps"] + 1))
        for r in records:
            assert all(k in r and math.isfinite(r[k])
                       for k in hl.HEALTH_KEYS), r
        health = rr["health"]
        assert health["anomalies"] == 0 and health["on_anomaly"] == "warn", \
            health
        shares = {"train_mfu": rr["train_mfu"],
                  "serve_prefill_mfu": sv["serve_prefill_mfu"],
                  "serve_decode_mbu": sv["serve_decode_mbu"]}
        assert all(isinstance(v, float) and 0 < v <= 1.05
                   for v in shares.values()), shares
        xla = rr["xla"]["programs"]
        chunk = xla["train_chunk_k8"]
        assert chunk["compile_s"] > 0 and chunk["peak_bytes_est"] > 0, chunk
        assert chunk["flops"] and chunk["flops"] > 0, chunk
        report = tmp / "r1_summary.json"
        report.write_text(json.dumps(sm))
        outs = {}
        for cmd in (["roofline", str(report)],
                    ["health", str(tmp / "r1_metrics.jsonl")]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code = analyze.main(cmd)
            assert code == 0, (cmd, code, buf.getvalue())
            outs[cmd[0]] = buf.getvalue()
        offline = json.loads(outs["health"])
        assert offline["steps"] == sm["steps"] and \
            offline["first_anomaly_step"] is None, offline
        rf = rr["roofline"]
        print(f"[health] R1 ({gpu}): bitwise L1 {json.dumps(checks)}; "
              f"{len(records)} metrics records, each with the six health "
              f"keys finite; health {json.dumps(health)}; "
              + ", ".join(f"{k} {v!r}" for k, v in shares.items())
              + f" (peaks {json.dumps(rf['device'])}; train model FLOPs a "
              f"step {rf['train']['model_flops_per_step']!r}, achieved "
              f"{rf['train']['achieved_flops_per_sec']!r}; serve "
              f"{json.dumps(rf['serve'])}); xla manifest "
              + "; ".join(f"{n} compiles {p['compiles']} compile_s "
                          f"{p['compile_s']:.4f} peak_bytes_est "
                          f"{p['peak_bytes_est']} flops {p['flops']!r}"
                          for n, p in xla.items())
              + f"; peak_hbm_bytes_est {rr['peak_hbm_bytes_est']}, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated()}; "
              f"step_ms_p50 {rr['step_time_p50_s'] * 1e3:.4f} (L1 "
              f"{l1['step_ms_p50']:.4f}); analyze roofline exit 0:\n"
              + outs["roofline"].rstrip()
              + f"\n[health] R1: analyze health exit 0: first anomaly "
              f"{offline['first_anomaly_step']!r}, maxima "
              f"{json.dumps(offline.get('maxima'))}; "
              f"{time.perf_counter() - t_r:.1f} s")
        r1_paged = paged
        r1_trainer = rec["trainer"]
        del rec

        # R1r: a paged serve table's fused decode rounds in the ledger
        ledger = ProgramLedger()
        kv = SlotKVCache(_serve_model(), None, 8, kv_layout="paged",
                         paged_block=8, prefix_block=8, ledger=ledger)
        for i in range(8):
            kv.insert(np.arange(8, dtype=np.int32) + i)
        for _ in range(3):       # eager, captured, replayed
            kv.advance_multi(8)
        torch.cuda.synchronize()
        rounds = ledger.programs()["kv_paged_decode_multi_k8"]
        assert rounds["compiles"] == 1 and rounds["compile_s"] > 0 and \
            rounds["peak_bytes_est"] > 0, rounds
        print(f"[health] R1r ({gpu}): the serve GPT's paged table, rounds "
              f"of 8 (eager, captured, replayed) under a ledger: "
              + "; ".join(f"{n} {json.dumps(p)}"
                          for n, p in ledger.programs().items()))
        del kv

        # R2: 24 steps, chunks of 8 replayed against single eager steps
        t_r = time.perf_counter()
        streams = {}
        for k in (8, 1):
            path = tmp / f"r2_k{k}.jsonl"
            _reset_flash_counts()
            r2, _ = _kept_run(_ckpt_config(
                epochs=1, dataset_fn=_lm_head_rows, health="on",
                steps_per_call=k, metrics_path=str(path)))
            add({**_flash_counts(), **_tc32_counts()})
            streams[k] = [{key: r[key] for key in ("step", "loss",
                                                   *hl.HEALTH_KEYS)}
                          for r in _health_records(path)]
            assert r2["steps_per_call"] == k and len(streams[k]) == 24
        assert streams[8] == streams[1], next(
            (a, b) for a, b in zip(streams[8], streams[1]) if a != b)
        print(f"[health] R2 ({gpu}): 24 steps, the six health streams and "
              f"the loss of replayed chunks of 8 bitwise 24 eager steps; "
              f"step 24 {json.dumps(streams[8][-1])}; "
              f"{time.perf_counter() - t_r:.1f} s")

        # R3: the injection at a step of a replayed chunk
        t_r = time.perf_counter()
        cfg = HealthConfig(inject_nan_at=HEALTH_INJECT_AT)
        out, recs, counts = _health_fit(gpu, "R3 halt", cfg,
                                        on_anomaly="halt")
        add(counts)
        assert isinstance(out, AnomalyDetected), out
        assert f"at step {HEALTH_INJECT_AT}" in str(out), out
        assert recs[-1][0] == HEALTH_INJECT_AT, recs[-1]
        assert recs[-1][1]["nonfinite_count"] > 0, recs[-1]
        out, _, counts = _health_fit(gpu, "R3 warn", cfg)
        add(counts)
        assert isinstance(out, AnomalyDetected), out
        assert f"diverged at step {HEALTH_INJECT_AT}" in str(out), out
        out, recs, counts = _health_fit(gpu, "R3 warn, nan_guard=False",
                                        cfg, nan_guard=False)
        add(counts)
        assert not isinstance(out, Exception), out
        assert out["steps"] == 24 and out["health"]["anomalies"] >= 1
        assert out["health"]["first_anomaly_step"] == HEALTH_INJECT_AT
        print(f"[health] R3 ({gpu}): inject_nan_at {HEALTH_INJECT_AT} "
              f"inside a replayed chunk: 'halt' raised at it with its "
              f"record logged; 'warn' fatal under the nan-guard default; "
              f"'warn' with nan_guard=False completed, first anomaly "
              f"{out['health']['first_anomaly_step']}; "
              f"{time.perf_counter() - t_r:.1f} s")
        # where R1's replayed step goes, beside L1's (phase 5f): the
        # capture's kernels among the step's (after every window: a
        # profiler session before one would be in its host times).  The
        # fit's batch shapes, so its captured graph replays (the run's
        # process group is gone: an eager chunk could not reduce)
        from distributed_tensorflow_tpu_torch.data import loaders

        train, batch = loaders.load_dataset("lm_synth",
                                            split="train"), CLI_LM["batch"]
        eng = r1_trainer.engine
        xs, ys = zip(*(eng.shard_batch(
            train.x[batch * i:batch * (i + 1)],
            train.y[batch * i:batch * (i + 1)]) for i in range(8)))
        _profile_chunk("cli-lm R1 step (B=8, L=128, f32, --health on)",
                       eng, r1_trainer.state, list(xs), list(ys),
                       chunks=2, top=16)
        del r1_trainer, eng
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[health] phase 5r launches: tc32 {json.dumps(total)}, paged on "
          f"f32 pools {r1_paged} ({layers} x R1's decode iterations)")
    return {"tc32": total, "paged_f32": r1_paged}


def tpd_timing_phase(tpd: dict) -> list[dict]:
    """The paged kernel at the serve GPT's per-rank K/V heads (8 heads
    over tp 2, 4 and 8: 4, 2 and 1 a rank, MHA), bf16 queries over bf16
    and int8 pools, 8 slots, 8-token blocks, 18-entry tables: held against
    its plain version at every split count, then timed beside its bound,
    the plain version and SDPA.  Launches: windows TPP's (bf16) and TPQ's
    (int8) at that K/V head count, as the wrapper counted them; one card
    runs tp 1 only, at 8 K/V heads, so these read 0 here."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    rows = []
    for i, (kvh, kv_dtype) in enumerate(
            (k, dt) for k in TPD_KV_HEADS
            for dt in (torch.bfloat16, torch.int8)):
        tag = f"kvh{kvh}_{'int8' if kv_dtype == torch.int8 else 'bf16'}"
        q, kp, vp, bt, pos, ks, vs = _paged_case(
            60 + i, h=kvh, kvh=kvh, q_dtype=torch.bfloat16,
            kv_dtype=kv_dtype)
        ref = pa.paged_attention_reference(q, kp, vp, bt, pos, k_scale=ks,
                                           v_scale=vs)
        err = 0.0
        for sp in (None, 1, 2, 4, bt.shape[1]):
            got = pa._paged_cuda(q, kp, vp, bt, pos, k_scale=ks, v_scale=vs,
                                 splits=sp)
            torch.testing.assert_close(got.float(), ref.float(), **BF16_TOL,
                                       msg=f"tp paged {tag} splits={sp}")
            err = max(err, float((got.float() - ref.float()).abs().max()))
        t = _paged_timed(f"tp {tag}", q, kp, vp, bt, pos, (), ks, vs)
        row = {"name": f"paged_attention_tp_{tag}", "route": "cuda",
               "source": "distributed_tensorflow_tpu_torch/ops/csrc/"
                         "paged_attention.cu",
               "replaces": "distributed_tensorflow_tpu/ops/"
                           "paged_attention.py:257",
               "shape": f"S=8 H=KVH={kvh} D=64 blk=8 MB=18 bf16 q, "
                        f"{tag.split('_')[1]} pools",
               "launches": tpd["by_kv_heads"][tag.split("_")[1]].get(
                   kvh, 0),
               "max_abs_err": err,
               **{k: t[k] for k in ("ms", "call_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "splits")},
               "bound_share": t["bound_ms"] / t["ms"]}
        rows.append(row)
        print(f"[kernel] tp paged {row['shape']}: max_abs_err {err:.3e}; "
              f"device ms kernel={t['ms']:.5f} (splits {t['splits']}) "
              f"plain={t['plain_ms']:.5f} SDPA={t['library_ms']:.5f}; "
              f"bound {t['bound_ms']:.6f} ({t['bound_by']})")
        del q, kp, vp, bt, pos, ks, vs
    return rows


def ppc_timing_phase(ppc: dict, ppe: dict) -> list[dict]:
    """The ring's block kernels at phase 5n's microbatch shape (B=2,
    L=1024, H=8, D=64, the diagonal pairing, a key mask of ones): the
    bf16 forward on ``tc`` and the f32 dQ and dK/dV on ``tc32`` that
    ``flash_bwd_block`` runs, each held against its plain version on the
    same inputs (bf16 out within the tc bound, lse within F32_TOL, dQ and
    dK/dV within FLASH_GRAD_TOL) before it is timed beside its bound, the
    plain version and SDPA.  Launches: C3's, C3R's and C4's, and phase
    5o's E3's and E4's (``launches_ppe``)."""
    from torch.nn.attention import sdpa_kernel

    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    b, lq, h = LM["batch"] // PP_MICRO, LM["seq"], LM["heads"]
    d = LM["hidden"] // h
    scale = d ** -0.5
    mask = torch.ones(b, lq, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    src = "distributed_tensorflow_tpu_torch/ops/csrc/"
    rows = []
    for name, kind, dtype, route in (
            ("flash_fwd_block.ring_tc_pp", "fwd", torch.bfloat16, "tc"),
            ("flash_bwd_block.dq_ring_tc32_pp", "dq", torch.float32, "tc32"),
            ("flash_bwd_block.dkv_ring_tc32_pp", "dkv", torch.float32,
             "tc32")):
        q, k, v, do, _ = _flash_case(81, b=b, lq=lq, h=h, d=d, dtype=dtype)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        backend = _sdpa_backend(dtype)
        with sdpa_kernel(backend):
            lib_fwd = lambda: sdpa(qt, kt, vt, is_causal=True)  # noqa: E731
            o = lib_fwd()
            if kind == "fwd":
                lib_ms = _device_ms(lib_fwd, label=f"ppc SDPA fwd {dtype}",
                                    whole=True)
        if kind == "fwd":
            fn = lambda: fa.flash_fwd_block(  # noqa: E731
                q, k, v, mask, scale=scale, causal=True)
            got, got_lse = fn()
            want, want_lse = fa._fwd_reference(q, k, v, mask, scale, True)
            torch.testing.assert_close(got_lse, want_lse, msg=name,
                                       **F32_TOL)
            delta = (do.float() * want.float()).sum(-1).transpose(1, 2)
            terms = fa._term_sums(q, k, v, mask, do, want_lse,
                                  delta.contiguous(), scale, True)[0]
            err, _ = _close_tc(name, got, want, terms)
            plain_ms = _device_ms(
                lambda: fa._fwd_reference(q, k, v, mask, scale, True),
                iters=5, warmup=1, label="ppc plain fwd", whole=True)
        else:
            lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
                o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)
            lib_ms = _device_ms(lib_bwd, label=f"ppc SDPA bwd {dtype}",
                                whole=True)
            out, lse = fa._fwd_reference(q, k, v, mask, scale, True)
            delta = (do * out).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, mask, do, lse, delta, scale, True)
            cuda_fn = fa._dq_cuda if kind == "dq" else fa._dkv_cuda
            fn = lambda: cuda_fn(*args)  # noqa: E731
            got = fn()
            got = (got,) if kind == "dq" else got
            plain = fa._bwd_reference(*args)
            want = plain[:1] if kind == "dq" else plain[1:]
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, msg=name, **FLASH_GRAD_TOL)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            plain_ms = _device_ms(lambda: fa._bwd_reference(*args), iters=5,
                                  warmup=1, label="ppc plain bwd",
                                  whole=True)
        ms = _device_ms(fn, label=f"ppc {name}", whole=True)
        bound_ms, bound_by = _flash_bound_ms(
            kind, q, k, True, None,
            peak=TC32_FLOPS if route == "tc32" else None)
        launches = sum(ppc[w][f"{kind}_{route}"] for w in ("C3", "C3R",
                                                           "C4"))
        launches_ppe = sum(ppe[w][f"{kind}_{route}"] for w in ("E3", "E4"))
        assert launches > 0 and launches_ppe > 0, name
        rows.append({
            "name": name, "route": "cuda", "variant": route,
            "source": src + ("flash_attention_f32_sm90.cu" if route == "tc32"
                             else "flash_attention_sm90.cu"),
            "replaces": "distributed_tensorflow_tpu/ops/flash_attention.py:"
                        + {"fwd": "170", "dq": "281", "dkv": "299"}[kind],
            "shape": f"B={b} L={lq} H={h} D={d} "
                     f"{str(dtype).split('.')[-1]} ring diagonal block",
            "launches": launches, "launches_ppe": launches_ppe,
            "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "library_ms": lib_ms,
            "library_backend": backend.name})
        print(f"[ppc] {name} ({route}) at the microbatch's block: device "
              f"{ms:.5f} ms, plain {plain_ms:.5f}, SDPA {backend.name} "
              f"{lib_ms:.5f}, bound {bound_ms:.6f} ({bound_by}), share "
              f"{bound_ms / ms:.3f}, launches {launches} (5o: "
              f"{launches_ppe}), max_abs_err {err:.3e}")
    return rows


def pp_timing_phase(pp: dict, ppc: dict, ppe: dict) -> list[dict]:
    """Rows 1p-3p: the flash forward, dQ and dK/dV at phase 5l's
    microbatch shape (B=2, L=1024, H=8, D=64, causal, bf16, ``tc``),
    held against their plain versions and timed beside their bounds, the
    plain versions and SDPA; each row's launches are PG's, P1's and PR's
    (every training launch of the phase is at this shape), phase 5n's
    C1's and C2's (``launches_ppc``) and phase 5o's E0's, E1's, E1R's and
    E2's (``launches_ppe``)."""
    h = LM["heads"]
    b = LM["batch"] // PP_MICRO
    case = _flash_case(49, b=b, lq=LM["seq"], h=h, d=LM["hidden"] // h,
                       dtype=torch.bfloat16)
    errs = _check_flash("pp_tc", case, True, "tc")
    rows = _flash_rows("pp", "tc", *case[:4], None, True, errs,
                       _sdpa_backend(torch.bfloat16), "bfloat16")
    for row in rows:
        kind = row["name"].rsplit(".", 1)[1].split("_")[0]
        row["launches"] = sum(pp[w][f"{kind}_tc"] for w in ("PG", "P1",
                                                            "PR"))
        row["launches_ppc"] = sum(ppc[w][f"{kind}_tc"] for w in ("C1",
                                                                 "C2"))
        row["launches_ppe"] = sum(ppe[w][f"{kind}_tc"] for w in (
            "E0", "E1", "E1R", "E2"))
        assert row["launches_ppc"] > 0 and row["launches_ppe"] > 0, \
            row["name"]
    return rows


def _ptxas_lines(log: str):
    """One line per kernel of a ptxas -v report: registers and spills."""
    for block in log.split("Compiling entry function")[1:]:
        name = re.search(r"\d+((?:flash|paged)_\w+?_kernel)I(.*?)EE?v",
                         block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if name and regs and spill:
            args = re.findall(
                r"Li(\d+)E|(Lb[01]E)|(13__nv_bfloat16|6__half|S1_|f|a)",
                name.group(2))
            shown = [a[0] or _MANGLED.get(a[1] or a[2], "") for a in args]
            # S1_ repeats the first type argument
            shown = [x or shown[0] for x in shown]
            yield (f"{name.group(1)}<{', '.join(shown)}>: {regs.group(1)} "
                   f"registers, {spill.group(1)} bytes spill stores, "
                   f"{spill.group(2)} bytes spill loads")


def build_phase() -> None:
    """One nvcc per kernel source, all started together."""
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    jobs = {"paged_attention": pa.build,
            "flash_attention": functools.partial(fa.build, "simt"),
            "flash_attention_sm90": functools.partial(fa.build, "tc"),
            "flash_attention_f32_sm90": functools.partial(fa.build, "tc32")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        for fut in [pool.submit(fn) for fn in jobs.values()]:
            fut.result()
    for name in jobs:
        print(f"[build] {name}.cu built in "
              f"{_build.build_seconds[name]:.2f}s")
    print(f"[build] phase {time.perf_counter() - t0:.2f}s")
    for lib in ("flash_attention_sm90", "flash_attention_f32_sm90",
                "paged_attention"):
        for line in _ptxas_lines(_build.build_logs[lib]):
            print(f"[build] ptxas {line}")
    for d in (64, 128):
        print(f"[build] tc dynamic shared memory at head_dim {d}: "
              f"{fa.smem_bytes(d, 'tc')}; tc32 at 64 and 32 rows: "
              f"{fa.smem_bytes(d, 'tc32', 64)}, "
              f"{fa.smem_bytes(d, 'tc32', 32)}")


_PHASE_MARK = [0.0, 0.0]     # (start of the run, end of the last phase)


def _phase_done(name: str) -> None:
    """Print the seconds of the phase that just ended and of the run so
    far (every phase's seconds, for the smoke's time budget)."""
    now = time.perf_counter()
    print(f"[phase] {name}: {now - _PHASE_MARK[1]:.1f} s (run "
          f"{now - _PHASE_MARK[0]:.1f} s)")
    _PHASE_MARK[1] = now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 parity on the card
    torch.backends.cudnn.allow_tf32 = False
    _PHASE_MARK[:] = [time.perf_counter()] * 2

    gpu = _device_line()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    build_phase()
    _phase_done('build')
    paged_errs = paged_check_phase()
    flash_errs = flash_check_phase()
    bert_errs = bert_mask_check()
    _phase_done('kernels')
    # before any profiler session: its host times are the measurement
    cnn_phase(gpu)
    _phase_done('cnn')
    local_phase(gpu)
    _phase_done('local')
    launches, int8_launches, verify_launches = serve_phase(gpu)
    _phase_done('5 serve')
    fit, evaluate, steps = train_phase(gpu)
    _phase_done('train')
    fit_master, fit16, ptrainer, (px, py) = precision_phase(gpu)
    _phase_done('precision')
    bert_launches = bert_phase(gpu)
    _phase_done('bert')
    repeat_failures = repeat_phase(gpu)
    _phase_done('repeat')
    fit32, steps32 = f32_train_phase(gpu)
    _phase_done('train-f32')
    cli_lm_launches = cli_lm_phase(gpu)
    _phase_done('5f cli-lm')
    sp = sp_phase(gpu)
    _phase_done('5g sp')
    moe = moe_phase(gpu)
    _phase_done('5h moe')
    ckpt = ckpt_phase(gpu)
    _phase_done('5i ckpt')
    codec = codec_phase(gpu)
    _phase_done('5j codec')
    mp = mp_phase(gpu)
    _phase_done('5k mp')
    pp, pp_ref = pp_phase(gpu)
    _phase_done('5l pp')
    comp = composite_phase(gpu, sp)
    _phase_done('5m composite')
    ppc = ppc_phase(gpu, pp_ref)
    _phase_done('5n ppc')
    ppe = ppe_phase(gpu, pp_ref)
    _phase_done('5o ppe')
    del pp_ref
    tpd = tpd_phase(gpu)
    _phase_done('5p tpd')
    lease = lease_phase(gpu, ckpt.pop("c0"))
    _phase_done('5q lease')
    health = health_phase(gpu)
    _phase_done('5r health')
    # the timings last: each profiler session before the serve and train
    # windows would be in their host times
    paged_row = paged_timing_phase(paged_errs)
    _phase_done('6 paged timings')
    # windows P and Q; the int8 sub-entry counts Q's int8-route launches
    paged_row["launches"] = launches
    paged_row["int8"]["launches"] = int8_launches
    # window S-small's verify rounds (l_q > 1)
    paged_row["verify_lq5"]["launches"] = verify_launches
    # phase 5p's windows TPP and TPQ (the TP tables at tp 1: 8 kv heads)
    paged_row["launches_tpd"] = tpd["paged"]
    paged_row["int8"]["launches_tpd"] = tpd["int8"]
    flash_rows = flash_timing_phase(flash_errs)
    _phase_done('6 flash timings')
    for row in flash_rows:
        kind = row["name"].rsplit(".", 1)[1]
        # the launches of this row's kernel: the tc count for a tc row
        counter = f"{kind}_tc" if row["variant"] == "tc" else kind
        row["launches"] = fit[counter] + evaluate[counter]
        row["launches_bf16_f32master"] = fit_master[counter]
        # the bench --moe window's launches (all on tc)
        row["launches_moe"] = moe["counts"][counter]
        # phase 5k's window T (all on tc)
        row["launches_mp"] = mp["T"][counter]
        # phase 5l's windows PG, P1, PR and Pgen (all on tc; the training
        # windows' at the microbatch's shape, rows 1p-3p)
        row["launches_pp"] = sum(w[counter] for w in pp.values())
        print(f"[flash] {row['name']} ({row['variant']}) at the slice's "
              f"shape, device ms: kernel={row['ms']:.5f} "
              f"plain={row['plain_ms']:.5f} "
              f"library={row['library_ms']:.5f} "
              f"({row['library_backend']}) simt={row['simt_ms']:.5f}; "
              f"call ms: kernel={row['call_ms']:.5f}; "
              f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
              f"bound_share={row['bound_share']:.4f} "
              f"launches_per_train_step={fit[counter] / steps:.1f}")
    f16_rows = flash_f16_timing_phase(flash_errs)
    for row in f16_rows:
        # the fp16-f32master window's launches of this float16 kernel
        row["launches"] = fit16[row["name"].rsplit(".", 1)[1]]
    bert_rows = bert_timing_phase(bert_errs)
    cli_lm_rows = cli_lm_timing_phase(cli_lm_launches)
    _phase_done('6 bert, cli-lm timings')
    for row in cli_lm_rows:
        if row["name"].startswith("flash"):
            # phase 5i's C windows run these kernels at this shape
            kind = row["name"].rsplit(".", 1)[1].split("_")[0]
            variant = "tc32" if "tc32" in row["name"] else "tc"
            row["launches_ckpt"] = ckpt[variant][kind]
            # phase 5j's G runs
            row["launches_codec"] = codec[variant][kind]
            # phase 5k's FSDP windows: F1 on tc32, F2 on tc
            row["launches_mp"] = mp["F1" if variant == "tc32" else "F2"][
                f"{kind}_{variant}"]
            if variant == "tc32":
                # phase 5q's windows Q1-Q4 (all tc32)
                row["launches_lease"] = lease["tc32"][kind]
                # phase 5r's windows R1-R3 (all tc32)
                row["launches_health"] = health["tc32"][kind]
        elif row["name"] == "paged_attention_cli_lm_f32":
            row["launches_mp"] = mp["F1"]["paged_f32"]
            # phase 5p's window TPL
            row["launches_tpd"] = tpd["TPL"]
            # phase 5q's window Q3
            row["launches_lease"] = lease["paged_f32"]
            # phase 5r's window R1
            row["launches_health"] = health["paged_f32"]
    sp_rows = sp_timing_phase(sp)
    _phase_done('6 sp timings')
    for row in sp_rows:
        # phase 5m's windows X1 (f32: tc32) and X2 (bf16: tc forward, tc32
        # backward) run the ring's block kernels at this shape
        counter = {"flash_fwd_block.ring_tc32": "fwd_tc32",
                   "flash_fwd_block.ring_tc": "fwd_tc",
                   "flash_bwd_block.dq_ring_tc32": "dq_tc32",
                   "flash_bwd_block.dkv_ring_tc32": "dkv_tc32"}[row["name"]]
        row["launches_composite"] = sum(c[counter] for c in comp.values())
        assert row["launches_composite"] > 0, row["name"]
    pp_rows = pp_timing_phase(pp, ppc, ppe)
    ppc_rows = ppc_timing_phase(ppc, ppe)
    tpd_rows = tpd_timing_phase(tpd)
    _phase_done('6 pp, ppc, tpd timings')
    f32 = bert_launches["f32"]
    simt = {k: f32[k] - f32[f"{k}_tc"] - f32.get(f"{k}_tc32", 0)
            for k in ("fwd", "dq", "dkv")}
    for row in bert_rows:
        kind = row["name"].rsplit(".", 1)[1].split("_")[0]
        if row["variant"] == "tc":
            # config 5 under bf16-f32master: every launch at this shape
            row["launches"] = bert_launches["bf16-f32master"][f"{kind}_tc"]
        elif row["variant"] == "tc32":
            # config 5 at f32 (BERT's shape) and the f32 GPT window (the
            # slice's shape): every f32 launch is on tc32
            bert, gpt = f32[f"{kind}_tc32"], fit32[f"{kind}_tc32"]
            row["launches"] = bert + gpt
            row["launches_at_this_shape"] = (
                bert if "_bert_" in row["name"] else gpt)
            row["launches_per_f32_gpt_step"] = gpt / steps32
        else:
            # the SIMT kernels: config 5's f32 launches left on them (none:
            # the f32 GPT window's are all tc32, as it asserts)
            row["launches"] = simt[kind]
            row["launches_at_this_shape"] = (
                simt[kind] if "_bert_" in row["name"] else 0)
    timing_cross_check()
    _phase_done('6 cross-check')
    _profile_step("CNN train step", "sync", "cnn", "mnist")
    _profile_cnn_chunk()
    _profile_train(ptrainer.engine, ptrainer.state, px, py,
                   label="bf16-f32master")
    pxs, pys = ptrainer.engine.shard_batch(px, py)
    _profile_chunk("GPT train step (B=8, L=1024, bf16-f32master)",
                   ptrainer.engine, ptrainer.state, [pxs] * 8, [pys] * 8,
                   chunks=2)
    _profile_step("ResNet-20 async train step", "async", "resnet20",
                  "cifar10")
    for policy in ("f32", "bf16-f32master"):
        _profile_bert_chunk(policy)
    remat_phase(gpu)
    _phase_done('6 step profiles, 7 remat')
    _verify_cost(_serve_model(), _bench_trace()[1])
    _phase_done('6 verify cost')
    assert not repeat_failures, repeat_failures
    print(f"[timing] device times from queued CUDA events, where the "
          f"profiler saw no device time or dropped a kernel's records: "
          f"{len(EVENT_TIMED)} "
          f"({', '.join(EVENT_TIMED) or 'none'})")
    print(gpu)
    print(json.dumps({"kernels": [paged_row, *flash_rows, *f16_rows,
                                  *bert_rows, *cli_lm_rows, *sp_rows,
                                  *pp_rows, *ppc_rows, *tpd_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
