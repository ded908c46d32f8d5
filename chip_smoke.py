"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line). First
every ``NEZHA_NO_*`` variable is deleted from the environment (the names
printed), so no phase runs a composed path in place of a kernel; only
serve_wire (e) sets one, for one engine at a time.

1. device: requires ``torch.cuda.is_available()``; prints the card's name
   and ``nvidia-smi``'s name and power limit;
2. build: compiles every CUDA kernel from ``nezha_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and prints the build time;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes in bf16 (GPT-2 124M: H=12, D=64, pool blocks
   of 16, 64 blocks per row), with its time on the device (``device_time``:
   L2 flushed and the device held in a spin before each call, so no host
   gap is timed; three repeats; the profiler's per-kernel time beside
   it; the rig's zero point, an empty launch timed the same way, printed
   once and beside every row with the row's ms less it), the plain
   version's time, the bound (bytes the call must move
   over 3.35 TB/s vs its flops over 989 TFLOP/s, from this run's lengths
   and starts) and, as a yardstick only, ``scaled_dot_product_attention``
   on the same K/V gathered dense, pinned to a backend that it names;
   each output element must lie within ``fold_error_bound`` of the plain
   one; any host-late timed call fails the phase. The float paged decode
   kernel (B7), split over the KV length, on all four (q, pool) dtype
   pairs (lengths 0-1024 and on the first splits' boundaries), the
   length-0 row exact zero and two runs bitwise equal; timed on the
   serving rows at H=12 and at H=3 (a shard of the 4-way mesh), with its
   split size and the grid its library recorded at the launch;
   The three flash-attention training kernels are held the same way in
   bf16 at GPT-2's training shape (B=8, H=12, S=1024, D=64, causal), at
   BERT-base's (B=16, H=12, S=512, D=64, non-causal; also with the
   right-padded lengths BERT_PAD_LENGTHS) and
   on a non-causal case, a ``kv_lengths`` case with a zero-length row,
   an odd S=100, D=128 at S=1024 with lengths [0, 700], D=40 at S=200,
   and S=130 at B*H=6 (lse and delta rows at odd multiples of 4 bytes):
   the forward's output within ``fold_error_bound`` and its lse within
   LSE_ATOL, dq/dk/dv within ``flash_bwd_error_bound``, the delta
   pre-pass (which dq and dK/dV both read) within 2 D 2^-24 of each row's
   sum |dO * O| of its plain version, padded keys' dk/dv exactly zero,
   and two backward runs bitwise equal. B2 is timed alone on the
   pre-pass's delta, B3 with the pre-pass, and the whole backward beside
   SDPA's, at GPT-2's shape and at BERT's (each flash row's ``bert``).
   Yardstick: SDPA's forward (causal or not, as the case), and its
   backward alone
   (``torch.autograd.grad`` of a forward run outside the timer). Each
   flash row carries the SASS counts (``cuobjdump``) of ``HGMMA`` and
   ``UTMALDG`` in its kernels' instantiations; every instantiation of the
   Hopper bodies of B1-B3 must have both, and their first bodies must not
   be built for bf16.
   The dense flash-decode kernel, split over the KV length, on all four
   (q, cache) dtype pairs at L=1024, D=64 (lengths 0-1024 and on the
   first splits' boundaries) within ``fold_error_bound``, the length-0
   row exact zero and two runs bitwise equal; timed at generate's shape
   (B=8, H=12, bf16) with every row at length 768, with its split size
   and the grid its library recorded at the launch; yardstick SDPA with
   a ``[B, 1, 1, L]`` length mask. The LayerNorm
   forward and backward kernels at D=768, bf16, on 8, 37, 4096 and 8192
   rows within ``layer_norm_error_bound``, both bitwise repeatable; the
   forward timed at the rows each path gives it (8: a generate decode
   step; 4096: generate's prefill; 8192: a train step), each beside
   ``F.layer_norm`` on the same rows and its own bound; the backward (dx,
   and dscale and dbias, summed by its second kernel) at 8192 rows beside
   ``F.layer_norm``'s backward alone.
   The int8 paged decode kernel (B8), split over the KV length, at the
   serving shapes over int8 pools quantized with
   ``ops.quant.quantize_kv_block`` from random bf16 values (bf16 and f32
   queries; lengths 0-1024) within ``fold_error_bound``, the length-0 row
   exact zero and two runs bitwise equal, with its split size and the
   grid its library recorded at the launch; yardstick SDPA over the K/V
   dequantized and gathered dense (the dequant outside the timed
   region). The int8 prefill kernel with its fused block
   write (B10) at chunk width 256 from starts 0, 300 and 768 and width 37:
   the output within ``fold_error_bound``, every data block and scale
   after the call bitwise equal to the plain version's, untouched blocks
   unchanged, the error sample within 1e-6 relative, two runs bitwise
   equal; yardstick SDPA over the dequantized prefix and the chunk with
   the offset causal mask (it leaves out the write). The q-offset prefill
   kernel (B11) at the ring hop's shape on a 4-shard mesh (one row, H=3,
   and again H=12; a 256-row chunk from starts 0, 300 and 768; each of
   its four 64-query slices at ``q_offsets = starts + 64k``): within
   ``fold_error_bound`` of its plain version, each slice bitwise equal to
   B9's rows of the full chunk, and ``q_offsets = starts`` over the whole
   chunk bitwise equal to B9; yardstick SDPA over the prefix gathered
   dense and the chunk with the offset causal mask;
4. train: GPT-2 124M at full width, bf16, B=8, S=1024,
   ``fused_loss_chunk=-1``, AdamW (weight decay 0.1), batches from
   ``synthetic_token_batches`` (seed 0): (a) one step's loss, gradients
   and updated weights with flash attention against the same step with
   composed attention, from the same weights and batch (TRAIN_*
   tolerances); (b) the loss on one fixed batch at a constant lr falls
   by at least LOSS_DROP over 10 steps; (c) 10 steps through
   ``Trainer.fit`` after 2 warm-up steps: ms per step, tokens/s and MFU
   (the analytic step flops of ``bench.py``, over 989 TFLOP/s); (d) each
   flash kernel launched exactly 12 times per step in that run; (e) one
   step with ``ln_impl="pallas"`` against the same step with the xla
   LayerNorm, from the same weights and batch (TRAIN_* tolerances); (f)
   10 timed steps with ``ln_impl="pallas"``, each LayerNorm kernel (the
   forward, the backward and its sums) launched exactly 25 times per step
   (2 per block + ``ln_f``); (g) that trainer, logging every 5 steps,
   windows of RUN_DIR_STEPS steps bare and inside a telemetry run (the
   train CLI's ``--run-dir``), in the order bare, run, run, bare twice:
   ms a step of each window and the difference of the medians;
4a. train_bert: BERT-base at full width (``bert_base_zero1``: bf16, the
   fused MLM head, vocab 30522, 12 x 768, 12 heads, seeded random
   weights), B=16, S=512, ``synthetic_mlm_batches``: (a) one step's MLM
   loss, gradients and updated weights with flash attention (non-causal)
   against the same step with composed attention, from the same weights
   and batch, under BERT_LOSS_ATOL and BERT_GRAD_RTOL (AdamW at lr 1e-4,
   weight decay 0.01); (b) the same on the batch right-padded to
   BERT_PAD_LENGTHS (``kv_lengths``; labels -100 past each length; the
   composed path builds its prefix mask from the lengths); (c) the loss
   on one fixed batch at a constant lr falls by at least BERT_LOSS_DROP
   over 10 steps; (d) 10 steps through ``Trainer.fit`` after 2 warm-up
   steps with the config's optimizer: ms per step, tokens/s, MFU
   (``bench.py``'s ``(6 N + 6 L H S) B S`` over 989 TFLOP/s), peak
   memory, then 3 profiled steps for the device-busy share; each flash
   kernel and the delta pre-pass exactly 12 times a step; (e) the
   config's eval split (8 batches of seed 1) through ``train.evaluate``
   with ``mlm_token_stats``: a finite perplexity;
4b. train_image: ResNet-50 at full width (``resnet50_imagenet``: s2d
   stem, bf16, 1000 classes, seeded random weights) on
   ``synthetic_image_batches`` at 224 px: (a) one step at batch
   IMG_CHECK_B in bf16 against the same step in fp32 with TF32 off
   (cuDNN and matmul), from the same weights (the zero-initialized head
   and last BatchNorm scales replaced by seeded random values of std
   BN3_SCALE_STD, so the trunk has gradients): the loss within
   IMAGE_LOSS_RTOL, the whole gradient within IMAGE_GRAD_RTOL of its
   norm, each tensor's cosine with its fp32 gradient at least
   IMAGE_GRAD_COS, each BatchNorm's batch statistics (recovered from its
   buffers) within IMAGE_MEAN_TOL and IMAGE_VAR_RTOL; (b) the loss on
   one fixed batch at a constant lr (momentum 0.1, beta 0.9, weight decay
   1e-4: ``bench.py``'s RN50 optimizer) falls by IMG_LOSS_DROP over 10
   steps; (c) 10 steps through ``Trainer.fit`` after 2 warm-up steps at
   the config's shape and optimizer (batch 128, the config's momentum
   schedule): ms per step (host clock, ended by a sync), images/s and
   MFU (``bench.py``'s 3 x 8.2 GFLOP an image over 989 TFLOP/s), then 3
   steps under ``torch.profiler`` for the device-busy share; no kernel
   of the port launches on this path; (d) ``wrn101_large_batch``
   (Wide-ResNet-101-2, s2d stem, bf16, the config's momentum schedule)
   the same way at WRN_B images, 5 timed steps: ms per step, images/s,
   MFU at 3 x 45.6 GFLOP an image (``bench.py``), peak memory, a finite
   loss and no kernel of the port launched; (e) ``mlp_mnist`` for
   MLP_STEPS steps and its top-1 accuracy on the synthetic test split
   (``train.evaluate``), at least MLP_MIN_ACCURACY. Prints its wall
   seconds;
4c. train_cli: the train CLI on the card, ``--config bert_base_zero1
   --steps 20 --eval-batches 2 --eval`` (a finite loss and eval
   perplexity over 2 batches) and ``--config wrn101_large_batch
   --batch-size 64 --steps 5`` (a finite loss), each returning 0. This
   phase's runs and data_ckpt's (b), (d) and (e) call the CLI's ``main``
   in this process;
4f. train_flags (after 4c): the train CLI's single-card flags at full
   width: (a) ResNet-50 (batch IMG_B, 224 px, the config's model and
   momentum) fed four batches bare and through ``runtime.Prefetcher``
   (pinned memory, a side stream, depth PF_DEPTH): the prefetched batches
   bitwise equal to ``batch_to_device``'s, PF_CHECK_STEPS steps' losses
   from one snapshot bitwise equal (cuDNN deterministic for the check),
   then ``ab_rates``'s ABBA windows (images/s, ms a step, busy ms) and a
   PF_TRACE_STEPS-step profile of each stream: the prefetched copies must
   run on a stream that runs no kernel; (b) ``wrn101_large_batch
   --batch-size 64 --grad-accum 8`` through the CLI for two flushes: a
   forward pre-hook reads the parameters at each step's start, and they
   must not move on the seven hold steps and must move on each flush;
   (c) GPT-2 124M through the CLI with ``--optimizer lamb --lr 6e-4
   --grad-accum 2 --metrics-file --log-memory --log-every 2
   --profile-dir --profile-steps 2:2`` for FLAG_STEPS steps: every JSONL
   line holds ``hbm_bytes_in_use`` and ``hbm_peak_bytes``, the trace of
   steps 3-4 exists and names B1-B3, which launch 12 times a step; one
   short run each of ``--optimizer adafactor`` and ``lars`` on the tiny
   ResNet (a finite loss); (d) two ZeRO-1 steps of GPT-2 124M at world 1
   (the coordinator, NCCL) saved per shard, the same weights as a dense
   npz: the generate CLI (``--ln-impl pallas``) and the serve CLI from
   each give the same greedy tokens (B1, B6, B4; B7, B9 launched from
   the per-shard save). Prints its wall seconds;
4i. train_tp (after 4f, before 4e): tensor-parallel training
   (``parallel/gspmd.py``) at ``dp=1,tp=2`` on the one card (its two
   shards run one after another, so its times say nothing about two
   cards): (a) GPT-2 124M (bf16, B=8, S=1024, the fused head): the
   first step's loss within TRAIN_LOSS_ATOL and every gradient,
   gathered from its shards, within TRAIN_GRAD_RTOL of the
   single-device step's from the same weights and batch; B1, B2, B3 and
   the delta pre-pass 2 x 12 each for its forward and backward; (b)
   TP_STEPS steps through ``Trainer.fit`` after one warm-up (AdamW,
   weight decay 0.1): ms a step, 2 x 12 launches of each a step; (c) its
   per-shard save (JAX's shards and keys) restored onto one device
   (``restore_variables_any``) bitwise equal to the gathered state; (d)
   BERT-base (B=16, S=512) the same first-step check at BERT_*
   tolerances, 2 x 12 launches; (e) the train CLI in-process with
   ``--parallel gspmd --mesh dp=1,tp=2 --shard-device cuda:0`` for
   TP_CLI_STEPS steps and ``--ckpt-dir`` (2 x 12 launches a step), then
   the generate CLI from its ``step_<N>.sharded`` on one device: its
   greedy tokens those of ``models.generate`` on the save restored in
   this process;
4j. train_pp_moe (after 4i, before 4k): pipeline parallelism, the MoE
   GPT-2 and remat at GPT-2 124M's width (bf16, B=8, S=1024, AdamW, the
   fused head; every mesh one card repeated): (a) ``parallel/
   pipeline.py`` at ``dp=1,pp=2``, PP_M microbatches: the first step's
   loss within PP_LOSS_ATOL and its gradients within TRAIN_GRAD_RTOL of
   one device's, B1-B3 and the pre-pass 12 x PP_M a step exactly (no
   bubble launch), ms a step; (b) the same step with remat: B1 twice
   that, the gradients (a)'s, the step's HBM peak below (a)'s; one
   device with remat: B1 24; (c) the MoE GPT-2 (MOE_E experts, top-2)
   against its ``attn_impl="xla"`` twin (the train check), its aux loss
   and dropped tokens per MoE layer, B1-B3 12 a step, ms a step and the
   peak; (d) its experts over ``ep=2`` against one device; (e)
   ResNet-50 (batch IMG_B) with remat against without: the gradients
   within the image check's limits, the BatchNorm buffers bitwise, the
   peak below; (f) the train CLI in process: ``--parallel pp`` with a
   save, the save restored into a fresh step bitwise, a resume (launches
   exact), and ``--moe-experts`` under gspmd with an ep axis;
4k. train_sp (after 4j, before 4e): sequence-parallel training and the
   chunked LM loss at GPT-2 124M's width (bf16, AdamW, the fused head;
   every mesh one card repeated): B1 non-causal and B2/B3 on a two-block
   ring's global lse and output at S_loc 512 and 4096 against their
   plain versions; at B=8, S=1024: (a) the ring with the flash hops at
   ``dp=1,sp=2`` against one device's flash step (the loss within
   TRAIN_LOSS_ATOL, the gradients within SP_GRAD_RTOL), B1, the
   pre-pass, B2 and B3 36 each a step exactly, ms a step and the step's
   HBM peak; (b) the composed ring (no launch) against (a); (c) Ulysses
   with the flash kernels against one device, 24 each; (d)
   ``fused_loss_chunk=128`` on one device against the ``-1`` path, the
   step's peak below it; (e) the train CLI in process at ``--seq-len
   8192 --batch-size 1 --remat``, sp=2, 3 steps with a save (tokens/s,
   ms a step, the run's peak, B1 72 and the rest 36 a step), one step
   resumed at sp=4 (B1 240, the rest 120) whose restored state equals
   the save bitwise, and the generate CLI from its save;
4l. train_graph (after 4k, before 4e): the graph-IR engine and the scan
   trunk: (a) GPT-2 124M's graph program under the bf16 policy
   (``--graph-bf16``, B=8, S=1024): its first step's loss and gradients
   against the module engine's from the same weights (GRAPH_LOSS_ATOL,
   GRAPH_GRAD_RTOL), the weights after it within 2 * lr; then 3 steps
   through ``Trainer.fit`` on the host clock (ended by a sync) with B1,
   the pre-pass, B2 and B3 12 each a step exactly, the busy share and the
   executor's 1 miss and 2 hits; (b) the IR's composed attention: no
   launch, the loss and gradients within the train check's limits of
   (a)'s; (c) the fp32 program: 12 each; (d) BERT-base's graph step
   (B=16, S=512; 12 each, non-causal) and ResNet-50's fp32 graph step at
   the config's batch (no launch; the loss falls on a repeated batch);
   (e) the MLP's programs single, dp and ZeRO-1 on ``[cuda:0] * 2``,
   their losses within 1e-5 of one another; (f) ``--scan-layers``
   through the train CLI in process, 3 steps with a save (36 each),
   its losses against the unrolled run's (bitwise where two unrolled
   runs repeat bitwise, else within their spread), the save restored
   into the unrolled model leaf for leaf, the generate and serve CLIs
   from it against the unrolled model's save of the same weights
   (tokens and launches equal, generate's B1, B6 and B4 counted
   exactly), and one step of a BERT-base scan model (12 each);
4e. train_dist (after 4k, before 4d): multi-process training at full
   width: (a) in-process, the coordinator's world of one and NCCL
   through ``init_torch_distributed``: GPT-2 124M (B=8, S=1024) and
   ResNet-50 (batch IMG_B) by dp, BERT-base (B=16, S=512) by ZeRO-1,
   against the single-device step from the same init and batches, the
   two taking turns in ABBA rounds of DIST_STEPS-step windows: every
   weight and buffer within DIST_WEIGHT_ATOL (0: bitwise), B1-B3 12
   launches a step on both sides, ms a step and tokens/s or images/s of
   each and the paired overhead, then 2 profiled steps each for the
   device's busy ms and the NCCL kernels' launches and device ms a step,
   and the optimizer state's bytes; (b) ``grad_reduce="int8"`` for GPT-2 dp and
   BERT ZeRO-1 on a fixed batch at a constant lr: the loss finite and
   falling over DIST_INT8_STEPS, the wire's ms a call (CUDA events) for
   int8 and fp32 on the step's gradients, and its payload bytes against
   fp32's, and GPT-2's steps inside a telemetry run count one
   ``all_reduce_int8`` a step at ``wire_payload_bytes`` and one
   ``all_reduce`` of the exact leaves at fp32; (c) the CLI,
   ``bert_base_zero1 --coordinator 127.0.0.1:0
   --serve-coordinator --world-size 1 --mesh dp=1 --ckpt-dir``:
   DIST_CLI_STEPS steps with a per-shard save every DIST_CLI_EVERY, then
   DIST_CLI_MORE resumed from the last (``resumed from step N
   (sharded)``), with each save's and restore's seconds and bytes; (d)
   two ranks on the one card in spawned processes: NCCL tried once (its
   answer printed), then gloo over the card's tensors for GPT-2 124M dp,
   DIST_TWO_STEPS steps on 4 rows a rank: the ranks' weights bitwise
   equal, and equal to one process averaging the same two halves; the
   first step's mean gradient within DIST_TWO_GRAD_RTOL of the 8 rows'
   and the losses within TRAIN_LOSS_ATOL of one process over the 8 rows
   (the weights' distance from it is printed, beside twice the most
   AdamW can move a weight); each rank runs inside a telemetry run
   (``rank0/``, ``rank1/``, the train CLI's ``--run-dir`` layout) that
   passes ``nezha-telemetry --check`` and counts one ``all_reduce`` a
   step of the gradients' bytes. Only NCCL's and gloo's own refusals of two
   ranks on one device pass, printed; a crash, a hang or any other error
   fails. Prints its wall seconds;
4g. rejoin (after 4e): ``--on-failure rejoin`` at full width, two
   processes of the train CLI on the one card (``gpt2_124m --parallel
   single --batch-size REJOIN_B``, one ``--ckpt-dir``, checks and logs
   every REJOIN_EVERY steps), each a ``chip_smoke.py --train-rank``
   process that writes its kernel counts: rank 1 is SIGKILLed after its
   first metrics line; rank 0 must save a rescue checkpoint and print
   ``waiting for rejoin``; a replacement started with ``--rank-hint 1``
   resumes from that checkpoint and trains REJOIN_MORE steps; rank 0
   prints ``world healed; resumed from step N`` (N the rescue's step),
   its logged steps rise strictly to REJOIN_STEPS, B1-B3 launch on it,
   and both exit 0. Prints the seconds from the kill to the detection,
   the rescue save's seconds and bytes, the heal wait and the reload's
   seconds. Then a second world with no replacement: rank 0 exits
   nonzero with ``no replacement rejoined within REJOIN_GIVE_UP_S s``,
   its rescue checkpoint on disk;
4h. interop (after 4g): GPT-2 124M at full width: (1) a random
   ``GPT2LMHeadModel(GPT2Config())`` built in process and written with
   ``save_pretrained``; (2) the generate CLI with ``--hf-dir`` and
   ``--ln-impl pallas`` (B1, B6, B4 launched): the load's seconds; the
   prompt's last logits of the loaded model within HF_LOGIT_ATOL of
   transformers' own forward (fp32 on the card, a yardstick), and each
   greedy token equal to transformers' argmax wherever its top-2 margin
   exceeds SERVE_LOGIT_ATOL (the CLI decodes on a bf16 cache); (3) two
   ZeRO-1 steps at world 1 saved per shard and as a dense npz; the
   export CLI in both formats from the npz: ``load_state_dict(strict=
   True)`` takes each, both hold the same bits, and the loaded model's
   logits lie within HF_LOGIT_ATOL of the port's fp32 forward of the
   checkpoint; each export's seconds; (4) the reshard CLI (a process of
   its own) onto RESHARD_MESH shards of the card from the npz and from
   the per-shard save, ``--out --verify`` exact, with its seconds and
   peak host resident memory; (5) the serve CLI with ``--mesh
   RESHARD_MESH --ckpt-dir`` (B7, B9 launched) against the single-device
   serve of the npz, token by token up to the first divergence, which
   must fall where the no-cache reference's top-2 margin is within
   SERVE_LOGIT_ATOL; (6) JPEGs and PNGs written with PIL, packed by the
   pack_images CLI, and the tiny ResNet trained 4 steps from the
   records and evaluated over every val record. Prints its wall seconds;
4d. data_ckpt: the user's path from text on disk to served text, in a
   temporary directory, through the CLIs at full width: (a) pack the
   port and ``docs/`` with ``pack_text --learn-bpe DC_BPE_MERGES`` into
   ``train.tokens.u16`` and ``tools/`` and the README with that
   tokenizer into ``val.tokens.u16``, and the same sources with
   ``--learn-wordpiece DC_WP_VOCAB`` for BERT; (b) ``gpt2_124m
   --data-dir --ckpt-dir --ckpt-every 10 --ckpt-keep 2 --eval
   --eval-batches 4`` for DC_STEPS steps, then DC_MORE more, which must
   print ``resumed from step DC_STEPS``, end at their sum with a finite
   eval perplexity and leave exactly two ``step_*.npz``; each save's and
   restore's seconds and bytes. The first run also takes ``--ln-impl
   pallas --log-every DC_LOG_EVERY --run-dir``, its kernels counted: the
   port's
   ``nezha-telemetry --check`` passes on the run dir, the report's
   step-rate windows are the CLI's logged windows and its tokens/s per
   chip mean theirs, ``train.first_step`` and ``checkpoint.save`` are
   spans, ``train.steps`` is DC_STEPS, and B1-B3 launch 12 and B4/B5 25
   a step (B1 and B4 a forward's worth more an eval batch); (c)
   in-process, the config's GPT-2 at batch 8: tokens/s and the busy
   share from disk against the synthetic stream, then the exact round
   trip (a fixed batch's loss, save, restore into a fresh module and
   optimizer: every leaf, the loss and one more step's weights bitwise;
   the two streams feed one trainer in turn, timed in the order disk,
   synthetic, synthetic, disk); (d) ``bert_base_zero1`` from the
   WordPiece corpus (``[MASK]`` resolved from the sidecar), 10 steps with
   a checkpoint, then 5 resumed with ``--eval``; (e) ``resnet50_imagenet``
   from ``train.nzr``/``val.nzr`` written by ``ImageRecordWriter`` (seeded
   256 px images), ``--crop 224``, batch 128, 10 steps with a checkpoint,
   then 5 resumed with ``--eval`` (momentum's conv velocity and the
   BatchNorm state round-trip), and in-process images/s from the records
   against synthetic; (f) the generate CLI (``--ckpt-dir --tokenizer
   --prompt "def main(" --ln-impl pallas``): valid ids and text, B1, B4
   and B6 launched (the counts and the profiler); (g) the serve CLI from
   the same checkpoint answers four text prompts (B7 and B9 launched),
   its greedy tokens equal ``models.generate``'s up to the first
   position where the no-cache reference's top-2 margin is within
   SERVE_LOGIT_ATOL. Prints its wall seconds;
5. serve: GPT-2 124M at full width, seeded random weights, bf16, eight
   greedy requests through ``Scheduler`` (prompts of 5-900 tokens, some
   prefilled in chunks, two sharing a 128-token prefix); requires every
   request to finish, both paged kernels launched on the path, a clean
   ``leak_check()``, and agreement with the port's no-cache causal
   forward with composed attention (``attn_impl="xla"``, independent of
   every kernel) on the card (see SERVE_LOGIT_ATOL); then the same eight
   requests on a second engine with ``kv_dtype="int8"``: every request
   finishes, the int8 kernels (B8, B10) launch and the float ones (B7,
   B9) do not, a clean ``leak_check()``, a prefix hit, and the same
   cross-check under INT8_SERVE_LOGIT_ATOL; it prints the largest
   per-chunk dequant error and both pools' bytes per block;
5c. serve_wire (after the serve phase's speculative, dense and
   scheduling modes, before 5b): GPT-2 124M at full width, blocks of 16,
   ``max_len`` 1024. (a) The int8 host KV tier: two slots, the default
   129-block pool, ``kv_host_blocks=WIRE_HOST_BLOCKS``; WIRE_CONVS seeded
   conversations of WIRE_TURNS turns (a turn: the previous prompt, its
   WIRE_NEW greedy tokens and WIRE_ADD new ones), each turn of all of
   them submitted round robin, so that the others evict a
   conversation's blocks between its turns; then the same traffic
   without the tier. Demotions and promotions above 0 with the tier, 0
   without, no failed promote, fewer B10 launches with the tier, a
   clean ``leak_check()`` and ``cross_check`` of every request in both
   runs; prints the tier's counts and bytes, each revisit's TTFT, and
   the demote and promote device spans by CUDA events. (b) Migration in
   one process, bf16 then int8: a ``prefill_only`` request parked on
   engine A, exported, encoded, decoded (through JSON), installed on B
   and ACKed; B serves it with exactly one prefill chunk (the tail, B9
   or B10 a layer) and B7 or B8 a layer a step; int8 blocks arrive
   bitwise; wire bytes against the pool's block bytes, each step's ms;
   both pools leak-free and the tokens cross-checked. (c) Two
   ``run_http`` servers on 127.0.0.1 in threads: a ``prefill_only`` POST
   parks on A, a ``pull_from`` POST on B migrates and decodes it (A's
   ``/healthz`` then shows no park), HTTP_STRAGGLERS long requests on B
   and its drain event with HTTP_DRAIN_S: ``/healthz`` 503 "draining", a
   new POST 503, the stragglers answered "deadline", the server thread
   ended; every answer cross-checked, both pools leak-free. (d)
   ``prefill_impl="xla"`` on bf16 and int8 pools with the serve phase's
   eight prompts: no B9 or B10, B7 or B8 a layer a decode step, every
   token cross-checked. (e) The same prompts with
   ``NEZHA_NO_PREFILL_KERNEL=1``: no B9, B7 a layer a decode step, the
   tokens of (d)'s bf16 run; then with ``NEZHA_NO_DECODE_KERNEL=1``: no
   B7, B9 as on the kernel path, the tokens the kernel path's up to a
   divergence the margin rule allows;
5d. serve_fleet (after serve_wire): the serve CLI's fleet, GPT-2 124M at
   full width, blocks of 16, ``max_len`` 1024, 256-wide chunks, eight
   slots a replica. (a) ``--replicas 2 --replica-backend thread
   --affinity-routing on`` in a thread of this process: the serve
   phase's eight prompts, then four sharing a FLEET_PREFIX-token prefix
   (the first alone, the rest after a digest interval); B9 launches 12 x
   the prefill chunks both engines report and B7 12 x their decode
   steps, nothing else launched; then one request on each replica at
   once under torch.profiler, whose device events (CUPTI sees both
   worker threads) equal the wrappers' counts and 12 x the engines'
   chunks and steps (a profile short of them, the profiler's drops of
   ROADMAP C3, is retaken with a fresh pair up to PROFILE_ATTEMPTS
   times) (profiling the whole traffic slowed the GIL-shared
   loops ~5x); an affinity
   win and a prefix hit on the holder; ``/stats`` counts the tokens
   answered, ``/metrics`` exposes them; no retry, failover or restart;
   both pools leak-free; every answer cross-checked. (b) ``python -m
   nezha_tpu_torch.cli.serve --random-init --replicas 2 --http 0`` as a
   subprocess, no ``--device``: the replicas hold ``/dev/nvidia*`` open,
   the front end holds none; SIGKILL of replica 0 with four requests in
   flight: before it, ``nezha-top`` polls the front end twice (exit 0,
   ``replicas live 2`` and a ``tokens/s`` row in each frame); each
   request answered (tokens or a typed ``replica_lost``), one
   restart, the restarted replica serves, the card's used memory within
   FLEET_MEM_RTOL of its level before the kill; SIGTERM drains and the
   process exits 0. (c) ``--prefill-replicas 1 --decode-replicas 1
   --kv-dtype int8``, threads: each request prefills and parks on P
   (B10), is pulled, installed and decoded on D (a tail chunk of B10, B8
   12 a decode step), one ``router.migrate`` span each, no fallback, P
   leak-free with no park; every token cross-checked at
   INT8_SERVE_LOGIT_ATOL. Prints the start-up and restart seconds and
   ``router.route_s``;
5b. serve_seq: the same weights on ``ShardedEngine(mesh_devices=4,
   devices=[cuda:0] * 4)`` (one card, its four shards run one after
   another) with ``prefill_mode="sequence"``, ``seq_prefill_variant=
   "ring"`` and ``long_prefill_buckets=(512, 1024)``: the serve phase's
   eight requests plus a 960-token one; every request finishes, B11
   launches 4 x 4 x 12 times per prefill chunk and B9/B10 never, B7 4 x
   12 times per decode step, a prefix hit, a clean ``leak_check()`` of
   every shard, the cross-check under SERVE_LOGIT_ATOL; then a ulysses
   engine on the same mesh (B9 per shard): identical tokens and, from a
   cold prefill of each prompt at its own bucket widths (the prefix cache
   emptied first; 512 and 1024 among them), bitwise-equal last-prompt
   logits; then a ulysses engine
   on int8 pools (B10, B8): the cross-check under INT8_SERVE_LOGIT_ATOL.
   Prints ``memory_report()``, the 960-token prompt's TTFT and the wall
   time;
5e. serve_mesh (after 5b): every serve path JAX runs under ``--mesh``,
   on ``ShardedEngine(mesh_devices=2, devices=[cuda:0] * 2)``, the serve
   phase's eight prompts, 32 greedy tokens each: (a) speculative with
   the identity self-draft (``draft_k=4``) on bf16 then int8 pools: the
   draft on the target's shards and its pool head-sharded, B9/B10 2 x
   12 a chunk (the target's and the draft's), B7/B8 2 x 12 a draft
   decode, nothing else (the verify is composed), at least
   SPEC_MIN_TOKENS_PER_VERIFY tokens a verify, the tokens against the
   one-device speculative engine's (serve_modes) up to a divergence the
   margin rule allows, the cross-check; (b) ``decode_impl`` and
   ``prefill_impl`` "xla", then ``NEZHA_NO_NESTED_KERNELS`` set for its
   engine alone: no kernel launched, the same tokens both ways,
   ``prefill_kernel_active`` off, the cross-check; (c) serve_wire (a)'s
   conversations on int8 mesh pools with the host tier and without:
   demotions and promotions, every host entry full-head, fewer B10
   launches with the tier, no leak on any shard; (d) WIRE_PROMPT tokens
   parked on an int8 mesh and installed into a one-device engine, then
   the reverse: the mesh's wire its shards' head groups concatenated,
   bitwise, and the one-device layout and bytes; the installed blocks
   the source's, bitwise; the migrated request a prefix hit with its
   tail chunk B10 (2 x) 12 and B8 every decode step; tokens
   cross-checked at INT8_SERVE_LOGIT_ATOL. Prints the wall;
6. generate: GPT-2 124M at full width, bf16, ``ln_impl="pallas"``, eight
   random 512-token prompts, 256 new tokens greedy through
   ``models.generate``: time to first token, decode ms per step and
   tokens/s; exact launch counts (flash forward 12 for the prefill, the
   flash-decode kernel 255 x 12, the LayerNorm forward 256 x 25); the
   prompt's last logits and every greedy token against the no-cache
   forward of a copy with ``attn_impl="xla"`` and ``ln_impl="xla"``
   (SERVE_LOGIT_ATOL, tokens where the reference's top-2 margin exceeds
   it); then one sampled call (temperature 0.8, top-k 40, top-p 0.95)
   whose every token lies in its step's top 40.

Each phase prints its wall seconds (``{"phase_wall_s": ...}``), and the
run its total (``{"smoke_wall_s": ...}``). The
line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12         # fp32 outside the tensor cores
# Kernel vs plain version, both on the card in bf16: they fold in
# different orders, so each rounds p to bf16 against other running maxima
# and rounds its own output; fold_error_bound (ops/cuda/common.py) bounds
# that per element by 2^-7 * (sum p|v| / l + |out|) + 1e-5, computed from
# the plain version run on |v|.
# Served logits vs the no-cache forward: both run GPT-2 in bf16 through
# 12 layers, but the reference rounds attention scores to bf16 and the
# kernels keep them fp32, so activations differ by bf16 rounding at every
# layer; logits of this random init have std ~0.5, and 0.125 (32 bf16
# ulps at 1.0) bounds that drift.
SERVE_LOGIT_ATOL = 0.125
# Served logits from an int8 pool vs the same no-cache forward: on top of
# the bf16 drift above, every cached K/V element carries a dequant error
# of at most amax/254 of its (block, head) — about one bf16 rounding
# (2^-9 relative) of the block's largest element — so the drift is of the
# same order as bf16's.
INT8_SERVE_LOGIT_ATOL = 0.125
# The flash forward's lse against its plain version: both fp32, summing
# up to 1024 exponentials in other orders (64-key tiles against 512-key
# blocks) and scores whose fp32 dots differ in order; |lse| stays below
# ~10 here, and 1e-4 is ~100 fp32 ulps of that.
LSE_ATOL = 1e-4
# Train step, flash against composed attention, both bf16 on the card.
# The composed path rounds the attention scores to bf16 before the
# softmax, the kernels keep them fp32, so every layer's activations
# differ by bf16 rounding (2^-8 relative) and so do the gradients that
# flow back through them:
# - loss: a mean over 8192 positions of ~10.8 nats; 0.02 is ~2^-9 of it;
# - gradients: per tensor, ||g_flash - g_xla|| <= 0.03 ||g_xla|| (a few
#   bf16 roundings compounded over 12 layers): twice the largest spread
#   tools/grad_spread.py measured on the H100 over six seeds (0.0149, an
#   LN scale or the position embedding; the median tensor ~0.010);
# - weights after one AdamW step: the first update is lr * g / (|g| +
#   eps), ~lr * sign(g), so where |g| is near eps a rounding flips it;
#   |w_flash - w_xla| <= 2 * lr + 1e-6 bounds that.
TRAIN_LOSS_ATOL = 0.02
TRAIN_GRAD_RTOL = 0.03
# The fixed-batch loss after 10 AdamW steps at lr 6e-4 must sit at least
# this far below the first step's.
LOSS_DROP = 0.5
TRAIN_B, TRAIN_S, TRAIN_LR = 8, 1024, 6e-4
RUN_DIR_STEPS = 10        # steps a side of the run dir's cost (train (g))
# BERT-base (bert_base_zero1 at full width: bf16, the fused MLM head),
# flash attention (non-causal) against composed, both bf16 on the card,
# one AdamW step (the config's lr 1e-4 and weight decay 0.01) from the
# same weights, on a full-length batch and on a right-padded one
# (BERT_PAD_LENGTHS, labels -100 past each length). The mechanism is
# GPT-2's above (the composed path rounds the scores to bf16), over 12
# post-LN layers. tools/grad_spread.py --config bert_base_zero1 read,
# over six seeds and both batches on the H100 (PERF.md):
# - loss: at most 5.7e-4 of ~10.47 nats; the limit is 2.5 times that;
# - gradients: at most 0.0173 of a tensor's norm (the median tensor
#   0.013-0.015: every tensor carries the rounding); the limit is 2
#   times that, since at 2.5 times (0.043) the tool's scores_fp8
#   control (the composed scores rounded to float8 e4m3, 0.0424) would
#   pass. Its lengths_plus_one control (one padded key attended, 0.0193)
#   stays under it: an off-by-one length is the kernels phase's to
#   catch (padded keys' dk/dv exactly zero, outputs within bound).
BERT_LOSS_ATOL = 0.0014
BERT_GRAD_RTOL = 0.035
BERT_B, BERT_S, BERT_LR, BERT_WD = 16, 512, 1e-4, 0.01
# One length a row: full, tile boundaries (64, 128, 256) and one past
# them, a row of one key, and a zero-length row (clamped to 1).
BERT_PAD_LENGTHS = [512, 300, 1, 0, 511, 257, 256, 128, 64, 65, 500, 200,
                    100, 450, 350, 2]
# The fixed-batch MLM loss after 10 AdamW steps at lr 1e-4 must sit at
# least this far below the first step's (it fell 2.30 on the H100,
# PERF.md).
BERT_LOSS_DROP = 1.0
# Wide-ResNet-101-2 (wrn101_large_batch), timed at bench.py's batch of
# 64 (the config's 512 does not fit one 80 GB card; 256 does).
WRN_B = 64
WRN_FLOPS_PER_IMAGE = 3 * 45.6e9   # bench.py:334, fwd + bwd at 224 px
# The LayerNorm-kernel step against the xla-LayerNorm step is held to the
# same TRAIN_* tolerances: both paths compute the statistics in fp32 from
# the same bf16 input and round the output (and dx) to bf16 once, so they
# differ by fp32 summation order and rsqrt's last bits, which the bf16
# rounding of every activation turns into occasional one-ulp (2^-8) flips
# that compound through 12 layers and their backward — the mechanism,
# and at most the size, of the flash-vs-composed difference above.
# ResNet-50 bf16 step against fp32 (TF32 off), same weights, batch 32 at
# 224 px. BatchNorm's backward subtracts the parts of the incoming
# gradient that the batch mean and variance explain, and bf16's rounding
# of what is left is large against it. Each limit is about 2.5 times the
# largest reading of tools/image_check_spread.py over seeds 0-3 on an
# H100 (PERF.md, PR 12), and that tool's two bf16 BatchNorm controls
# (statistics reduced in bf16; buffers kept in bf16) break the variance
# limit by 7.7-11 times:
# - loss: 3e-4 of it (read at most 1.04e-4);
# - the whole gradient (every tensor, concatenated): 0.13 of its norm
#   (read 0.0522-0.0534);
# - each tensor's cosine with its fp32 gradient: at least 0.8 (the worst,
#   stem_bn.bias, read 0.8665-0.9119; a wrong sign, layout or padding
#   reads near 0);
# - the batch statistics that each BatchNorm's buffers took in, (after -
#   0.9 before) / 0.1: the mean within 0.025 of the batch's standard
#   deviation (RMS over channels; read at most 0.0095), the variance
#   within 0.006 of its norm (read at most 0.0023).
IMAGE_LOSS_RTOL = 3e-4
IMAGE_GRAD_RTOL = 0.13
IMAGE_GRAD_COS = 0.8
IMAGE_MEAN_TOL = 0.025
IMAGE_VAR_RTOL = 0.006
BN3_SCALE_STD = 0.05   # the check's last-BatchNorm scales (config: 0)
IMG_B, IMG_SIZE, IMG_CHECK_B = 128, 224, 32
IMG_FLOPS_PER_IMAGE = 3 * 8.2e9   # bench.py:251, fwd + bwd at 224 px
IMG_LOSS_DROP = 0.5
# The synthetic MNIST's classes are templates plus noise: the same config
# on the CPU reads 1.0 after 300 steps.
MLP_STEPS, MLP_MIN_ACCURACY = 300, 0.99
GEN_B, GEN_PROMPT, GEN_NEW = 8, 512, 256
DEC_L = 1024                      # the dense decode check's cache length
LN_D = 768
SEQ_MESH = 4                      # serve_seq's shards, all on one card
# serve_modes: new tokens a request, proposals a verify window, the
# shallow self-draft's depth, verify/decode forwards timed a row, the
# identity draft's least tokens a verify (32 tokens are 7 windows of at
# most 5 when every proposal is taken: 4.57; it drafts with B7 and
# verifies by the composed path, so near-ties round apart, and random
# weights give flat logits: the floor only catches a draft that stopped
# agreeing with its target), and
# JAX's grant order of a full three-lane backlog under the default 4:2:1
# weights.
MODES_NEW = 32
SPEC_K, SPEC_DRAFT_LAYERS = 4, 4
VERIFY_CALLS, VERIFY_DEVICE_CALLS = 20, 10
SPEC_MIN_TOKENS_PER_VERIFY = 2.0
WFQ_ORDER = ["interactive", "batch", "background", "interactive",
             "interactive", "batch", "interactive"]

H, D, BS, M = 12, 64, 16, 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


_PHASE = {}   # the running phase's name and start (host clock)


def phase(name=None) -> None:
    """Start phase ``name`` (None: only end the running one), printing
    the wall seconds of the phase it ends."""
    if _PHASE:
        print(json.dumps({"phase_wall_s": {
            _PHASE["name"]: time.perf_counter() - _PHASE["t0"]}}),
            flush=True)
    if name is not None:
        print(f"== {name}", flush=True)
        _PHASE.update(name=name, t0=time.perf_counter())


# The device timer. A kernel's time is taken on the device, not across
# its wrapper's host work: before each timed call the L2 cache is flushed
# (the serving path meets each layer's K/V cold) and the device is held in
# a spin (torch.cuda._sleep) long enough that the host enqueues the start
# event, the call and the end event while it still spins. A call whose
# start event had already completed when the host finished enqueueing was
# late: the gap before its launch is in its time. Every timed row counts
# such calls (host_late). A row with a late call is timed again from the
# start with twice the spin, up to TIMING_ATTEMPTS times (the late counts
# of the attempts set aside are kept in host_late_retried), and the
# kernels phase fails if its last attempt still had one. Each row is
# TIMED_REPEATS repeats of `iters` calls: ms is the mean of the repeats'
# means, ms_spread their min / median / max. A call over OUTLIER_FACTOR
# times its repeat's median call (a stall of the device, not the kernel's
# work) is left out of the mean and counted (outliers). Beside it,
# PROFILED_CALLS
# calls under torch.profiler give each launched kernel's device time
# (profiler_kernels) and their sum per call (profiler_us); a row whose
# event time and profiler time differ by more than DISAGREE_REL of the
# profiler time and more than DISAGREE_US is flagged (profiler_disagrees).
# The rig's zero point (empty_row): an empty launch, torch.cuda._sleep(0),
# timed the same way, EMPTY_ITERS calls a repeat; every row carries it
# (empty_ms) and its ms less it (ms_less_empty) beside its ms, which
# stays what the events read.
TIMED_REPEATS = 3
SLEEP_FLOOR_MS = 2.0      # the least device spin before a timed call
SLEEP_OVER_ENQUEUE = 8    # and at least this many times the host's enqueue
OUTLIER_FACTOR = 4.0
TIMING_ATTEMPTS = 3
PROFILED_CALLS = 5
PROFILE_ATTEMPTS = 3      # a profile that lost events is taken again
PROFILE_SETTLE_S = 0.01   # host pause before a profiling cycle closes
DISAGREE_REL, DISAGREE_US = 0.15, 5.0
EMPTY_ITERS = 200
FLUSH_BYTES = 64 << 20    # over the H100's 50 MB L2
# SDPA's backends in PyTorch's own order of preference; a yardstick runs
# pinned to the first that takes its inputs (library_backend).
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
TIMED_ROWS = []           # (label, ms, profiler_us, disagrees), in order


def repeat_mean(times):
    """The mean of one repeat's call times (ms) without its outliers ->
    (mean, outliers): a call over OUTLIER_FACTOR times the repeat's median
    call is an outlier."""
    v = sorted(times)
    median = spread(v)[1]
    kept = [t for t in v if t <= OUTLIER_FACTOR * median]
    return sum(kept) / len(kept), len(v) - len(kept)


def spread(values):
    """[min, median, max] of the repeats' means."""
    v = sorted(values)
    n = len(v)
    median = v[n // 2] if n % 2 else (v[n // 2 - 1] + v[n // 2]) / 2
    return [v[0], median, v[-1]]


def host_late_count(started) -> int:
    """Calls whose start event had completed by the time the host had
    enqueued the call and its end event."""
    return sum(1 for done in started if done)


def kernel_name(raw: str) -> str:
    """A profiler kernel name without return type, namespaces, template
    arguments or parameters: ``void ns::(anonymous namespace)::k<T>(T*)``
    -> ``k``."""
    name = raw.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    for stop in ("<", "("):
        if stop in name:
            name = name[:name.index(stop)]
    return name.split("::")[-1].strip()


def fold_profiler_events(events, calls: int, exclude=()):
    """Device events ``(raw name, us)`` of ``calls`` profiled calls ->
    ``{kernel: {"launches_per_call", "us_per_launch"}}``, leaving out the
    kernels named in ``exclude`` (the L2 flush's own)."""
    totals = {}
    for raw, us in events:
        name = kernel_name(raw)
        if name in exclude:
            continue
        n, t = totals.get(name, (0, 0.0))
        totals[name] = (n + 1, t + us)
    return {name: {"launches_per_call": n / calls, "us_per_launch": t / n}
            for name, (n, t) in totals.items()}


def profiler_us(kernels) -> float:
    """Device microseconds per call summed over the call's kernels."""
    return sum(k["launches_per_call"] * k["us_per_launch"]
               for k in kernels.values())


def profiler_disagrees(event_ms: float, prof_us: float) -> bool:
    """The event time and the profiler time differ by more than
    DISAGREE_REL of the profiler time and by more than DISAGREE_US."""
    diff = abs(event_ms * 1e3 - prof_us)
    return diff > DISAGREE_REL * prof_us and diff > DISAGREE_US


def timing_fields(means, started, delay_ms, kernels, prefix="",
                  outliers=0, retried=(), empty_ms=None):
    """One timed row's fields from its repeats' means (ms), the start
    events' completion flags, the spin before each call, the profiled
    kernels, the calls left out as outliers, the late counts of attempts
    set aside and the rig's zero point (``empty_row``'s ms, None where
    it was not taken); ``prefix`` names a yardstick's fields
    (``library_``)."""
    ms = sum(means) / len(means)
    prof = profiler_us(kernels)
    return {f"{prefix}ms": ms, f"{prefix}empty_ms": empty_ms,
            f"{prefix}ms_less_empty": (None if empty_ms is None
                                       else ms - empty_ms),
            f"{prefix}ms_spread": spread(means),
            f"{prefix}outliers": outliers,
            f"{prefix}host_late": host_late_count(started),
            f"{prefix}host_late_retried": list(retried),
            f"{prefix}delay_ms": delay_ms, f"{prefix}profiler_us": prof,
            f"{prefix}profiler_kernels": kernels,
            f"{prefix}event_over_profiler": ms * 1e3 / prof if prof else None,
            f"{prefix}profiler_disagrees": profiler_disagrees(ms, prof)}


_FLUSH = []


def flush_l2() -> None:
    """Evict the L2 cache: a device-to-device copy of FLUSH_BYTES (a
    memcpy, not a kernel, so it never shares a name with a timed call's
    kernels)."""
    if not _FLUSH:
        _FLUSH.extend(torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                  device="cuda") for _ in range(2))
    _FLUSH[0].copy_(_FLUSH[1])


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms() -> float:
    """The device spin's clock cycles per millisecond, measured."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    cycles = 10_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


@functools.lru_cache(maxsize=None)
def flush_kernel_names():
    """The device events the L2 flush itself shows under the profiler."""
    return frozenset(profiled_kernels(flush_l2, with_flush=False))


def profiled_kernels(fn, calls: int = PROFILED_CALLS,
                     with_flush: bool = True):
    """``calls`` calls of fn (each after an L2 flush) under torch.profiler
    -> fold_profiler_events of their device events. The profiler runs one
    warm-up cycle of the same calls before the recorded one (CUPTI drops
    events while it starts up), and each cycle closes PROFILE_SETTLE_S
    after the device is idle; a profile that still caught a fraction of a
    launch per call, or no device event, is taken again, up to
    PROFILE_ATTEMPTS times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    exclude = flush_kernel_names() if with_flush else ()
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    if with_flush:
                        flush_l2()
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_SETTLE_S)
                prof.step()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        kernels = fold_profiler_events(events, calls, exclude)
        if whole_launches(kernels):
            break
    return kernels


def whole_launches(kernels) -> bool:
    """Every kernel was caught a whole number of times a call (a call
    launches each of its kernels whole times), and at least one was."""
    return bool(kernels) and all(
        float(k["launches_per_call"]).is_integer() for k in kernels.values())


def timed_attempts(label: str, fn, iters: int, warmup: int = 3):
    """fn's timed repeats, retried with twice the spin while a call was
    host-late (see the timer's notes above) -> (means, started,
    outliers, delay_ms, retried); fails when the last attempt had a
    host-late call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    delay_ms = max(SLEEP_FLOOR_MS, SLEEP_OVER_ENQUEUE * enqueue_ms)
    retried = []
    for attempt in range(TIMING_ATTEMPTS):
        means, started, outliers = timed_repeats(fn, iters, delay_ms)
        late = host_late_count(started)
        if not late or attempt == TIMING_ATTEMPTS - 1:
            break
        retried.append(late)
        delay_ms *= 2
    if late:
        fail(f"{label}: {late} of {len(started)} timed calls were host-late "
             f"(the device finished a {delay_ms:.2f} ms spin before the "
             f"host had enqueued the call), after {retried} in earlier "
             f"attempts")
    return means, started, outliers, delay_ms, retried


def empty_call() -> None:
    """A launch that does no work: the timer's zero point."""
    torch.cuda._sleep(0)


@functools.lru_cache(maxsize=None)
def empty_row():
    """``empty_call`` on the rig every row is timed on -> its
    timing_fields (``ms`` is the zero point ``empty_ms`` of every other
    row), taken once a run."""
    means, started, outliers, delay_ms, retried = timed_attempts(
        "empty launch", empty_call, EMPTY_ITERS)
    return timing_fields(means, started, delay_ms,
                         profiled_kernels(empty_call), outliers=outliers,
                         retried=retried)


def device_time(label: str, fn, iters: int, warmup: int = 3,
                prefix: str = ""):
    """Time fn on the device (see the timer's notes above) -> its
    timing_fields, with the rig's zero point; fails when the last attempt
    had a host-late call."""
    zero = empty_row()["ms"]
    means, started, outliers, delay_ms, retried = timed_attempts(
        label, fn, iters, warmup)
    row = timing_fields(means, started, delay_ms, profiled_kernels(fn),
                        prefix, outliers, retried, zero)
    TIMED_ROWS.append((f"{label} {prefix}".strip(), row[f"{prefix}ms"],
                       row[f"{prefix}profiler_us"],
                       row[f"{prefix}profiler_disagrees"]))
    return row


def timed_repeats(fn, iters: int, delay_ms: float):
    """TIMED_REPEATS repeats of ``iters`` calls, each after an L2 flush
    and a ``delay_ms`` device spin -> (the repeats' means without their
    outliers, each call's start-event completion flag, outliers)."""
    cycles = int(delay_ms * sleep_cycles_per_ms())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    means, started, outliers = [], [], 0
    gc.disable()
    try:
        for _ in range(TIMED_REPEATS):
            times = []
            for _ in range(iters):
                flush_l2()
                torch.cuda._sleep(cycles)
                start.record()
                fn()
                end.record()
                started.append(start.query())
                end.synchronize()
                times.append(start.elapsed_time(end))
            mean, dropped = repeat_mean(times)
            means.append(mean)
            outliers += dropped
    finally:
        gc.enable()
    return means, started, outliers


def library_time(label: str, fn, iters: int, backend: str):
    """A yardstick's device_time fields, prefixed ``library_``, with the
    backend it ran on."""
    return {**device_time(label, fn, iters, prefix="library_"),
            "library_backend": backend}


def plain_time_ms(fn, iters: int) -> float:
    """Mean ms of the plain PyTorch version from CUDA events around each
    call, the L2 flushed first. Its many small launches are host-bound,
    so this is host and device together; it is the plain version's cost,
    not a yardstick of the kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        flush_l2()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


TIMING_KEYS = ("ms", "empty_ms", "ms_less_empty", "ms_spread", "outliers",
               "host_late", "host_late_retried", "delay_ms", "profiler_us",
               "profiler_kernels", "event_over_profiler",
               "profiler_disagrees")


def reported(case):
    """The kernels line's timing fields of one timed case: the kernel's,
    its yardstick's, the plain version's time and the bound."""
    keys = (TIMING_KEYS + tuple(f"library_{k}" for k in TIMING_KEYS)
            + ("library_backend", "plain_ms", "bound_ms", "bound_by"))
    return {k: case[k] for k in keys}


def additive_mask(allowed, dtype):
    """A boolean attention mask as SDPA's kernels take it with no work of
    their own: 0 where allowed, -inf elsewhere, in the queries' dtype, a
    view whose rows start 16 elements apart. Made once, outside the timer,
    so a yardstick times the attention, not the mask's conversion."""
    n = allowed.shape[-1]
    buf = torch.full((*allowed.shape[:-1], -(-n // 16) * 16), float("-inf"),
                     dtype=dtype, device=allowed.device)
    mask = buf[..., :n]
    mask.masked_fill_(allowed, 0.0)
    return mask


def sdpa_yardstick(q, k, v, **kw):
    """``F.scaled_dot_product_attention(q, k, v, **kw)`` pinned to the
    first of SDPA_BACKENDS that takes these inputs -> (call, backend). A
    boolean ``attn_mask`` is passed in its additive form."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if kw.get("attn_mask") is not None and kw["attn_mask"].dtype == torch.bool:
        kw["attn_mask"] = additive_mask(kw["attn_mask"], q.dtype)

    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with sdpa_kernel(backend):
                    F.scaled_dot_product_attention(q, k, v, **kw)
            torch.cuda.synchronize()
        except RuntimeError:
            continue

        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v, **kw)
        return call, name
    fail(f"no SDPA backend takes q {tuple(q.shape)} {q.dtype}")


def bound(nbytes: float, flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def shuffled_tables(g, rows: int, n_blocks: int):
    perm = torch.randperm(n_blocks - 1, generator=g) + 1
    return perm[:rows * M].reshape(rows, M).to(torch.int32)


def within(name: str, got, want, bound):
    """-> (max |got - want|, its largest ratio to the elementwise bound);
    fails when any element exceeds the bound."""
    err = (got.float() - want.float()).abs()
    ratio = (err / bound).max().item()
    if not ratio <= 1.0:
        fail(f"{name}: |kernel - plain| exceeds its bound (max ratio "
             f"{ratio}, max error {err.max().item()})")
    return err.max().item(), ratio


def fold_bound(want, want_abs_v, p_dtype=torch.bfloat16):
    """``fold_error_bound`` of an attention output whose p is rounded to
    ``p_dtype`` before P.V."""
    from nezha_tpu_torch.ops.cuda.common import fold_error_bound

    return fold_error_bound(want, want_abs_v, p_dtype == torch.bfloat16)


def within_bound(name: str, got, want, want_abs_v):
    """``within`` against ``fold_error_bound`` of an attention output."""
    return within(name, got, want, fold_bound(want, want_abs_v))


def worst_element(got, want, bound) -> dict:
    """The element with the largest ``|got - want| / bound``: both values,
    the error, the bound and, for a bf16 output, the error in units in the
    last place of ``want``."""
    err = (got.float() - want.float()).abs()
    i = int((err / bound).flatten().argmax())
    w, e = want.float().flatten()[i].item(), err.flatten()[i].item()
    row = {"want": w, "got": got.float().flatten()[i].item(), "err": e,
           "bound": bound.flatten()[i].item()}
    if want.dtype == torch.bfloat16 and w != 0.0:
        row["out_ulps"] = e / 2.0 ** (math.frexp(w)[1] - 8)
    return row


def check_paged_decode_case(tag: str, args, p_dtype) -> dict:
    """B7 on one case held against its plain version within
    ``fold_error_bound``, its length-0 rows exact zero and two runs
    bitwise equal -> max_abs_err, err_over_tolerance and the worst
    element."""
    from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                          paged_decode_attention_plain)

    q, kp, vp, lengths, tab = args
    got = paged_decode_attention(*args)
    torch.cuda.synchronize()
    want = paged_decode_attention_plain(*args)
    abs_v = paged_decode_attention_plain(q, kp, vp.abs(), lengths, tab)
    bnd = fold_bound(want, abs_v, p_dtype)
    err, ratio = within(tag, got, want, bnd)
    if not torch.all(got[lengths == 0] == 0):
        fail(f"{tag}: a length-0 row is not exact zero")
    if not torch.equal(paged_decode_attention(*args), got):
        fail(f"{tag}: two runs differ")
    return {"max_abs_err": err, "err_over_tolerance": ratio,
            "worst": worst_element(got, want, bnd)}


def time_paged_decode(q, kp, vp, lengths, tab, label: str):
    """B7 on one bf16 case, checked first (``check_paged_decode_case``),
    with the device timer, beside SDPA over the rows' K/V gathered dense
    and masked by length, the plain version and the bound -> the row's
    fields."""
    from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                          paged_decode_attention_plain)

    b, h = q.shape[:2]
    args = (q, kp, vp, lengths, tab)
    checked = check_paged_decode_case(label, args, kp.dtype)
    timing = device_time(label, lambda: paged_decode_attention(*args), 100)
    timing["grid"] = launched_grid("paged_decode")
    if not math.prod(timing["grid"]):
        fail(f"{label}: no launch grid recorded ({timing['grid']})")
    timing["plain_ms"] = plain_time_ms(
        lambda: paged_decode_attention_plain(*args), 5)
    kd = kp[tab.long()].transpose(1, 2).reshape(b, h, M * BS, D)
    vd = vp[tab.long()].transpose(1, 2).reshape(b, h, M * BS, D)
    mask = (torch.arange(M * BS, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    sdpa, backend = sdpa_yardstick(q, kd, vd, attn_mask=mask)
    timing.update(library_time(label, sdpa, 100, backend))
    lens = lengths.tolist()
    total = sum(lens)
    nbytes = (2 * b * h * D * 2                     # q in, out
              + 2 * total * h * D * 2               # K and V read once
              + sum(math.ceil(x / BS) for x in lens) * 4 + b * 4)
    timing["bound_ms"], timing["bound_by"] = bound(nbytes, 4 * total * h * D)
    timing["timed_case"] = checked
    return timing


def check_decode(g):
    """B7, split over the KV length, at the serving shape's H=12 (the
    engine) and H=3 (a shard of the 4-way mesh): for each, all four (q,
    pool) dtype pairs over lengths 0-1024 and on the first splits'
    boundaries within ``fold_error_bound``, the length-0 row exact zero
    and two runs bitwise equal; then the serving rows of the same tensors
    in bf16, checked the same way and timed, with its split size and the
    grid its library recorded at the launch."""
    from nezha_tpu_torch.ops.cuda.decode_attention import split_size

    split = split_size("paged_decode")
    timed_lengths = [0, 1, 15, 16, 17, 300, 777, M * BS]
    lengths_list = timed_lengths + [split - 1, split, split + 1,
                                    2 * split + 1]
    b = len(lengths_list)
    n = 1 + b * M
    nb = len(timed_lengths)
    bf, f32 = torch.bfloat16, torch.float32
    tab = shuffled_tables(g, b, n).cuda()
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    worst = {"err_over_tolerance": -1.0}
    by_dtypes, timed = {}, {}
    h3 = H // SEQ_MESH
    for h in (h3, H):
        q32 = torch.randn(b, h, 1, D, generator=g).cuda()
        k32 = torch.randn(n, h, BS, D, generator=g).cuda()
        v32 = torch.randn(n, h, BS, D, generator=g).cuda()
        for q_dtype, pool_dtype in ((bf, bf), (f32, bf), (bf, f32),
                                    (f32, f32)):
            pair = f"H={h} q {q_dtype} pool {pool_dtype}"
            case = check_paged_decode_case(
                f"paged_decode {pair}",
                (q32.to(q_dtype), k32.to(pool_dtype), v32.to(pool_dtype),
                 lengths, tab), pool_dtype)
            by_dtypes[pair] = case["err_over_tolerance"]
            if case["err_over_tolerance"] > worst["err_over_tolerance"]:
                worst = {"pair": pair, **case}
        # Timed on the serving rows of the same tensors, in bf16.
        timed[h] = time_paged_decode(
            q32[:nb].to(bf), k32.to(bf), v32.to(bf), lengths[:nb], tab[:nb],
            "paged_decode" if h == H else f"paged_decode H={h}")
    timing = timed[H]
    return {"name": "paged_decode", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/paged_decode.cu",
            "replaces": "nezha_tpu/ops/pallas/decode_attention.py:89",
            "max_abs_err": max(c["max_abs_err"] for c in (worst, *(
                t["timed_case"] for t in timed.values()))),
            "err_over_tolerance": max([*by_dtypes.values(), *(
                t["timed_case"]["err_over_tolerance"]
                for t in timed.values())]),
            "err_over_tolerance_by_dtypes": by_dtypes,
            "err_worst": {k: worst[k] for k in ("pair", "worst")},
            **timing, "split": split, "blocks": math.prod(timing["grid"]),
            "by_heads": {str(h3): timed[h3]},
            "shape": f"B={nb} H={H} D={D} bs={BS} M={M} bf16 q and pool, "
                     f"lengths={timed_lengths} (splits of {split} keys, "
                     f"grid {timing['grid']}); timed also at H={h3} "
                     f"(by_heads); checked B={b} lengths={lengths_list} at "
                     f"H={h3} and H={H}, all four (q, pool) dtype pairs, "
                     f"and each timed case"}


def check_prefill(g):
    from nezha_tpu_torch.ops.cuda import (paged_prefill_attention,
                                          paged_prefill_attention_plain)

    bf = torch.bfloat16
    n = 1 + M
    kp = torch.randn(n, H, BS, D, generator=g).to("cuda", bf)
    vp = torch.randn(n, H, BS, D, generator=g).to("cuda", bf)
    tab = shuffled_tables(g, 1, n).cuda()
    worst = worst_ratio = 0.0
    cases = []
    for s in (32, 256):
        q, kc, vc = (torch.randn(1, H, s, D, generator=g).to("cuda", bf)
                     for _ in range(3))
        for start in (0, 37, 256, 768):
            starts = torch.tensor([start], dtype=torch.int32, device="cuda")
            args = (q, kc, vc, kp, vp, tab, starts)
            got = paged_prefill_attention(*args)
            torch.cuda.synchronize()
            want = paged_prefill_attention_plain(*args)
            abs_v = paged_prefill_attention_plain(q, kc, vc.abs(), kp,
                                                  vp.abs(), tab, starts)
            err, ratio = within_bound(f"paged_prefill S={s} start={start}",
                                      got, want, abs_v)
            worst = max(worst, err)
            worst_ratio = max(worst_ratio, ratio)
            tag = f"paged_prefill S={s} start={start}"
            timing = device_time(tag, lambda: paged_prefill_attention(*args),
                                 50)
            plain_ms = plain_time_ms(
                lambda: paged_prefill_attention_plain(*args), 3)
            # Yardstick: SDPA over [prefix gathered dense ; chunk].
            pk = kp[tab[0].long()].transpose(0, 1).reshape(1, H, M * BS, D)
            pv = vp[tab[0].long()].transpose(0, 1).reshape(1, H, M * BS, D)
            kd = torch.cat([pk[:, :, :start], kc], dim=2)
            vd = torch.cat([pv[:, :, :start], vc], dim=2)
            mask = (torch.arange(start + s, device="cuda")[None, :]
                    <= start + torch.arange(s, device="cuda")[:, None])
            sdpa, backend = sdpa_yardstick(q, kd, vd, attn_mask=mask)
            timing.update(library_time(tag, sdpa, 50, backend))
            nbytes = (4 * s * H * D * 2                 # q, k, v in; out
                      + 2 * start * H * D * 2           # prefix K and V
                      + math.ceil(start / BS) * 4 + 4)
            flops = 4 * H * D * (s * start + s * (s + 1) // 2)
            bound_ms, bound_by = bound(nbytes, flops)
            cases.append({"S": s, "start": start, "max_abs_err": err,
                          "err_over_tolerance": ratio, **timing,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by})
    print(json.dumps({"paged_prefill_cases": cases}), flush=True)
    # The kernels line reports the widest chunk at the deepest start.
    rep = cases[-1]
    return {"name": "paged_prefill", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/paged_prefill.cu",
            "replaces": "nezha_tpu/ops/pallas/prefill_attention.py:137",
            **reported(rep),
            "max_abs_err": worst, "err_over_tolerance": worst_ratio,
            "shape": f"B=1 H={H} D={D} bs={BS} M={M} S={rep['S']} "
                     f"start={rep['start']}"}


def int8_pools(g, n: int):
    """int8 K/V pools [n, H, BS, D] and their [n, H] scales on the card,
    quantized from random bf16 values with the port's quantize_kv_block."""
    from nezha_tpu_torch.ops.quant import quantize_kv_block

    out = []
    for _ in range(2):
        x = torch.randn(n, H, BS, D, generator=g).to("cuda", torch.bfloat16)
        out += list(quantize_kv_block(x))
    return out            # kq, ks, vq, vs


def check_quant_decode(g):
    """B8 at the serving shapes, bf16 and f32 queries over int8 pools: the
    length-0 row exact zero, two runs bitwise equal; the split size and
    the grid its library recorded at the launch."""
    from nezha_tpu_torch.ops.cuda import (paged_quant_decode_attention,
                                          paged_quant_decode_attention_plain)
    from nezha_tpu_torch.ops.cuda.decode_attention import split_size
    from nezha_tpu_torch.ops.quant import dequantize_kv_block

    split = split_size("paged_quant_decode")
    lengths_list = [0, 1, 15, 16, 17, 300, 777, M * BS]
    b = len(lengths_list)
    n = 1 + b * M
    kq, ks, vq, vs = int8_pools(g, n)
    q32 = torch.randn(b, H, 1, D, generator=g).cuda()
    tab = shuffled_tables(g, b, n).cuda()
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    worst = worst_ratio = 0.0
    for q in (q32.to(torch.bfloat16), q32):
        args = (q, kq, vq, ks, vs, lengths, tab)
        got = paged_quant_decode_attention(*args)
        torch.cuda.synchronize()
        want = paged_quant_decode_attention_plain(*args)
        abs_v = paged_quant_decode_attention_plain(q, kq, vq.abs(), ks, vs,
                                                   lengths, tab)
        err, ratio = within(f"paged_quant_decode q {q.dtype}", got, want,
                            fold_bound(want, abs_v, q.dtype))
        if not torch.all(got[0] == 0):
            fail("paged_quant_decode: the length-0 row is not exact zero")
        if not torch.equal(paged_quant_decode_attention(*args), got):
            fail(f"paged_quant_decode q {q.dtype}: two runs differ")
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    q = q32.to(torch.bfloat16)
    args = (q, kq, vq, ks, vs, lengths, tab)
    timing = device_time("paged_quant_decode",
                         lambda: paged_quant_decode_attention(*args), 100)
    grid = launched_grid("paged_quant_decode")
    if not math.prod(grid):
        fail(f"paged_quant_decode: no launch grid recorded ({grid})")
    plain_ms = plain_time_ms(
        lambda: paged_quant_decode_attention_plain(*args), 5)
    # Yardstick: SDPA over the rows' K/V dequantized (untimed) and
    # gathered dense, masked by length.
    kd, vd = (dequantize_kv_block(p[tab.long()], s[tab.long()], q.dtype)
              .transpose(1, 2).reshape(b, H, M * BS, D)
              for p, s in ((kq, ks), (vq, vs)))
    mask = (torch.arange(M * BS, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    sdpa, backend = sdpa_yardstick(q, kd, vd, attn_mask=mask)
    timing.update(library_time("paged_quant_decode", sdpa, 100, backend))
    total = sum(lengths_list)
    blocks = sum(math.ceil(x / BS) for x in lengths_list)
    nbytes = (2 * b * H * D * 2                     # q in, out (bf16)
              + 2 * total * H * D                   # int8 K and V read once
              + 2 * blocks * H * 4                  # their scales
              + blocks * 4 + b * 4)                 # table entries, lengths
    bound_ms, bound_by = bound(nbytes, 4 * total * H * D)
    return {"name": "paged_quant_decode", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/paged_quant_decode.cu",
            "replaces": "nezha_tpu/ops/pallas/decode_attention.py:101",
            "max_abs_err": worst, "err_over_tolerance": worst_ratio,
            **timing, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "split": split, "grid": grid,
            "blocks": math.prod(grid),
            "shape": f"B={b} H={H} D={D} bs={BS} M={M} int8 pools, bf16 q "
                     f"(also checked f32 q; splits of {split} keys, grid "
                     f"{grid}); lengths={lengths_list}"}


def check_quant_prefill(g):
    """B10: chunk width 256 from starts 0, 300 and 768, and width 37;
    the output within fold_error_bound, the write bitwise against the
    plain version's, two runs bitwise equal."""
    from nezha_tpu_torch.ops.cuda import (paged_quant_prefill_attention,
                                          paged_quant_prefill_attention_plain)
    from nezha_tpu_torch.ops.quant import dequantize_kv_block

    bf = torch.bfloat16
    n = 1 + M
    pools = int8_pools(g, n)
    tab = shuffled_tables(g, 1, n).cuda()
    worst = worst_ratio = 0.0
    cases = []
    for s, start in ((256, 0), (256, 300), (37, 100), (256, 768)):
        q, kc, vc = (torch.randn(1, H, s, D, generator=g).to("cuda", bf)
                     for _ in range(3))
        starts = torch.tensor([start], dtype=torch.int32, device="cuda")

        def run(fn, v_chunk=vc, v_abs=False):
            kq, ks, vq, vs = (t.clone() for t in pools)
            out, qerr = fn(q, kc, v_chunk, kq, vq.abs() if v_abs else vq,
                           ks, vs, tab, starts)
            return out, qerr, (kq, ks, vq, vs)

        tag = f"paged_quant_prefill S={s} start={start}"
        got, qerr, got_pools = run(paged_quant_prefill_attention)
        torch.cuda.synchronize()
        want, want_err, want_pools = run(paged_quant_prefill_attention_plain)
        abs_v = run(paged_quant_prefill_attention_plain, vc.abs(), True)[0]
        err, ratio = within_bound(tag, got, want, abs_v)
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        for name, a, w in zip(("k", "k_scale", "v", "v_scale"), got_pools,
                              want_pools):
            if not torch.equal(a[1:], w[1:]):
                fail(f"{tag}: {name} after the write differs from the "
                     f"plain version's")
        touched = set(tab[0, start // BS:(start + s - 1) // BS + 1].tolist())
        untouched = [i for i in range(1, n) if i not in touched]
        for name, a, orig in zip(("k", "k_scale", "v", "v_scale"),
                                 got_pools, pools):
            if not torch.equal(a[untouched], orig[untouched]):
                fail(f"{tag}: an untouched {name} block changed")
        qerr_rel = abs(qerr.item() - want_err.item()) / want_err.item()
        if not qerr_rel <= 1e-6:
            fail(f"{tag}: qerr {qerr.item()} vs plain {want_err.item()}")
        again = run(paged_quant_prefill_attention)
        if not (torch.equal(again[0], got) and torch.equal(again[1], qerr)
                and all(torch.equal(a, b)
                        for a, b in zip(again[2], got_pools))):
            fail(f"{tag}: two runs differ")
        kq, ks, vq, vs = (t.clone() for t in pools)
        args = (q, kc, vc, kq, vq, ks, vs, tab, starts)
        timing = device_time(tag,
                             lambda: paged_quant_prefill_attention(*args), 50)
        plain_ms = plain_time_ms(
            lambda: paged_quant_prefill_attention_plain(*args), 3)
        # Yardstick: SDPA over [prefix dequantized (untimed) ; chunk],
        # offset-causal; it computes no block write.
        pk, pv = (dequantize_kv_block(p[tab[0].long()], sc[tab[0].long()],
                                      bf).transpose(0, 1)
                  .reshape(1, H, M * BS, D)
                  for p, sc in ((pools[0], pools[1]), (pools[2], pools[3])))
        kd = torch.cat([pk[:, :, :start], kc], dim=2)
        vd = torch.cat([pv[:, :, :start], vc], dim=2)
        mask = (torch.arange(start + s, device="cuda")[None, :]
                <= start + torch.arange(s, device="cuda")[:, None])
        sdpa, backend = sdpa_yardstick(q, kd, vd, attn_mask=mask)
        timing.update(library_time(tag, sdpa, 50, backend))
        n_touched = len(touched)
        nbytes = (4 * s * H * D * 2                 # q, k, v in; out (bf16)
                  + 2 * start * H * D               # int8 prefix K and V
                  + 2 * math.ceil(start / BS) * H * 4   # their scales
                  + 2 * 2 * n_touched * H * BS * D  # touched blocks r + w
                  + 2 * 2 * n_touched * H * 4       # their scales r + w
                  + math.ceil((start + s) / BS) * 4 + 4 + 4)
        flops = 4 * H * D * (s * start + s * (s + 1) // 2)
        bound_ms, bound_by = bound(nbytes, flops)
        cases.append({"S": s, "start": start, "max_abs_err": err,
                      "err_over_tolerance": ratio, "qerr": qerr.item(),
                      "qerr_rel_err": qerr_rel, **timing,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by})
    print(json.dumps({"paged_quant_prefill_cases": cases}), flush=True)
    rep = cases[-1]
    return {"name": "paged_quant_prefill", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/quant_prefill.cu",
            "replaces": "nezha_tpu/ops/pallas/prefill_attention.py:225",
            **reported(rep),
            "max_abs_err": worst, "err_over_tolerance": worst_ratio,
            "library_covers": "the attention only, not the block write",
            "shape": f"B=1 H={H} D={D} bs={BS} M={M} int8 pools, bf16 q, "
                     f"S={rep['S']} start={rep['start']}; checked S=256 at "
                     f"0, 300, 768 and S=37 at 100"}


def check_prefill_qoff(g):
    """B11 at the ring hop's shapes: every 64-query slice of a 256-row
    chunk, H=3 (12 heads over 4 shards) and H=12, from starts 0, 300 and
    768; within fold_error_bound of the plain version and bitwise equal to
    B9's rows of the full chunk."""
    from nezha_tpu_torch.ops.cuda import (paged_prefill_attention,
                                          paged_prefill_qoff_attention,
                                          paged_prefill_qoff_attention_plain)

    bf = torch.bfloat16
    n = 1 + M
    s_kc = 256
    s_q = s_kc // SEQ_MESH
    worst = worst_ratio = 0.0
    cases = []
    for h in (H // SEQ_MESH, H):
        kp = torch.randn(n, h, BS, D, generator=g).to("cuda", bf)
        vp = torch.randn(n, h, BS, D, generator=g).to("cuda", bf)
        tab = shuffled_tables(g, 1, n).cuda()
        for start in (0, 300, 768):
            q, kc, vc = (torch.randn(1, h, s_kc, D, generator=g)
                         .to("cuda", bf) for _ in range(3))
            starts = torch.tensor([start], dtype=torch.int32, device="cuda")
            full = paged_prefill_attention(q, kc, vc, kp, vp, tab, starts)
            tag = f"paged_prefill_qoff H={h} start={start}"
            if not torch.equal(paged_prefill_attention(
                    q, kc, vc, kp, vp, tab, starts, q_offsets=starts), full):
                fail(f"{tag}: q_offsets = starts differs from B9")
            for k in range(SEQ_MESH):
                rows = slice(k * s_q, (k + 1) * s_q)
                qs = q[:, :, rows].contiguous()
                qoff = starts + k * s_q
                args = (qs, kc, vc, kp, vp, tab, starts, qoff)
                got = paged_prefill_qoff_attention(*args)
                torch.cuda.synchronize()
                if not torch.equal(got, full[:, :, rows]):
                    fail(f"{tag} slice {k}: not bitwise equal to B9's rows")
                want = paged_prefill_qoff_attention_plain(*args)
                abs_v = paged_prefill_qoff_attention_plain(
                    qs, kc, vc.abs(), kp, vp.abs(), tab, starts, qoff)
                err, ratio = within_bound(f"{tag} slice {k}", got, want,
                                          abs_v)
                worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
                if h != H // SEQ_MESH or start != 768:
                    continue
                # Timed: the ring hop's own shape, every slice.
                timing = device_time(
                    f"{tag} slice {k}",
                    lambda: paged_prefill_qoff_attention(*args), 50)
                plain_ms = plain_time_ms(
                    lambda: paged_prefill_qoff_attention_plain(*args), 3)
                # Yardstick: SDPA over [prefix gathered dense ; chunk],
                # the causal diagonal at the slice's offset.
                pk = kp[tab[0].long()].transpose(0, 1).reshape(1, h, M * BS,
                                                              D)
                pv = vp[tab[0].long()].transpose(0, 1).reshape(1, h, M * BS,
                                                              D)
                kd = torch.cat([pk[:, :, :start], kc], dim=2)
                vd = torch.cat([pv[:, :, :start], vc], dim=2)
                mask = (torch.arange(start + s_kc, device="cuda")[None, :]
                        <= start + k * s_q
                        + torch.arange(s_q, device="cuda")[:, None])
                sdpa, backend = sdpa_yardstick(qs, kd, vd, attn_mask=mask)
                timing.update(library_time(f"{tag} slice {k}", sdpa, 50,
                                           backend))
                keys = (k + 1) * s_q          # chunk rows the slice reaches
                nbytes = (2 * s_q * h * D * 2           # q in, out
                          + 2 * keys * h * D * 2        # chunk K and V
                          + 2 * start * h * D * 2       # prefix K and V
                          + math.ceil(start / BS) * 4 + 4 + 4)
                flops = 4 * h * D * (s_q * start + s_q * k * s_q
                                     + s_q * (s_q + 1) // 2)
                bound_ms, bound_by = bound(nbytes, flops)
                cases.append({"H": h, "start": start, "slice": k,
                              "S_q": s_q, "S_kc": s_kc, **timing,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by})
    print(json.dumps({"paged_prefill_qoff_cases": cases}), flush=True)
    rep = cases[-1]             # the last slice: the deepest diagonal
    return {"name": "paged_prefill_qoff", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/paged_prefill.cu",
            "replaces": "nezha_tpu/ops/pallas/prefill_attention.py:167",
            **reported(rep),
            "max_abs_err": worst, "err_over_tolerance": worst_ratio,
            "shape": f"B=1 H={rep['H']} D={D} bs={BS} M={M} S_q={s_q} "
                     f"S_kc={s_kc} start=768, slice {rep['slice']} "
                     f"(q_offset {768 + rep['slice'] * s_q}); checked H=3 "
                     f"and 12, starts 0, 300, 768, slices 0-3"}


def attended_pairs(s: int, causal: bool, lengths) -> int:
    """(query, key) pairs the masks leave, summed over rows."""
    pairs = 0
    for n in lengths:
        n = max(1, min(int(n), s))
        pairs += sum(min(i + 1, n) for i in range(s)) if causal else s * n
    return pairs


def flash_case(g, b, s, causal, lengths=None, timed=False, d=D, h=H):
    """Check the three flash kernels (and the dK/dV kernel's delta
    pre-pass) against their plain versions on one bf16 case; -> per-kernel
    errors, and times and bounds when timed."""
    from nezha_tpu_torch.ops.cuda.flash_attention import (
        _delta_launch, _dkv_launch, _dq_launch, _lengths, flash_block_bwd,
        flash_block_bwd_plain, flash_block_fwd, flash_block_fwd_plain,
        flash_bwd_delta_plain, flash_bwd_error_bound)

    bf = torch.bfloat16
    tag = (f"flash B={b} H={h} S={s} D={d} causal={causal}"
           + ("" if lengths is None else f" lengths={lengths}"))
    q, k, v, do = (torch.randn(b, h, s, d, generator=g).to("cuda", bf)
                   for _ in range(4))
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    out, lse = flash_block_fwd(q, k, v, causal, kv_lengths=lens)
    torch.cuda.synchronize()
    want, want_lse = flash_block_fwd_plain(q, k, v, causal, kv_lengths=lens)
    abs_v = flash_block_fwd_plain(q, k, v.abs(), causal,
                                  kv_lengths=lens)[0]
    res = {"flash_fwd": within_bound(f"{tag} out", out, want, abs_v)}
    lse_err = (lse - want_lse).abs().max().item()
    if not lse_err <= LSE_ATOL:
        fail(f"{tag}: lse differs by {lse_err} > {LSE_ATOL}")
    # The backward from the plain forward's out and lse, so both sides
    # differentiate the same values.
    bwd_args = (q, k, v, want, want_lse, do, causal)
    grads = flash_block_bwd(*bwd_args, kv_lengths=lens)
    torch.cuda.synchronize()
    plain = flash_block_bwd_plain(*bwd_args, kv_lengths=lens)
    bounds = flash_bwd_error_bound(*bwd_args, kv_lengths=lens)
    for name, got, w, bd in zip(("dq", "dk", "dv"), grads, plain, bounds):
        key = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
        err, ratio = within(f"{tag} {name}", got, w, bd)
        prev = res.get(key, (0.0, 0.0))
        res[key] = (max(prev[0], err), max(prev[1], ratio))
    if lengths is not None:
        for i, n in enumerate(lengths):
            n = max(1, n)
            if torch.any(grads[1][i, :, n:] != 0) or torch.any(
                    grads[2][i, :, n:] != 0):
                fail(f"{tag}: keys past length {n} of row {i} got a "
                     f"non-zero dk/dv")
    again = flash_block_bwd(*bwd_args, kv_lengths=lens)
    if not all(torch.equal(x, y) for x, y in zip(grads, again)):
        fail(f"{tag}: two backward runs differ")
    # The pre-pass's delta against its plain version on the card: each
    # sums D fp32 products in its own order, off the exact sum by at most
    # D 2^-24 of the row's sum |dO * O|, so the two by twice that.
    delta = _delta_launch(want, do)
    torch.cuda.synchronize()
    row = (do.float() * want.float()).abs().sum(-1)
    delta_ratio = ((delta - flash_bwd_delta_plain(want, do)).abs()
                   / (2 * d * 2.0 ** -24 * row + 1e-30)).max().item()
    if not delta_ratio <= 1.0:
        fail(f"{tag}: delta off its plain version by {delta_ratio} of "
             f"its bound")
    res["lse_err"] = lse_err
    res["delta_err_over_tolerance"] = delta_ratio
    if not timed:
        return res
    lens_c = _lengths(lens, q, s)
    scale = 1.0 / d ** 0.5
    at = "" if (b, s, causal) == (TRAIN_B, TRAIN_S, True) else \
        f" B={b} S={s} causal={causal}"     # the timer's row labels
    # B2 alone on the pre-pass's delta; B3 with the pre-pass, which its
    # row carries; then the whole backward (pre-pass, dq, dK/dV).
    timing = {
        "flash_fwd": device_time(
            "flash_fwd" + at,
            lambda: flash_block_fwd(q, k, v, causal, kv_lengths=lens), 20),
        "flash_bwd_dq": device_time(
            "flash_bwd_dq" + at, lambda: _dq_launch(
                q, k, v, want_lse, do, delta, lens_c, causal, scale), 20),
        "flash_bwd_dkv": device_time(
            "flash_bwd_dkv" + at, lambda: _dkv_launch(
                q, k, v, want_lse, do, _delta_launch(want, do), lens_c,
                causal, scale), 20)}
    whole = device_time("flash_bwd" + at,
                        lambda: flash_block_bwd(*bwd_args, kv_lengths=lens),
                        20)
    plain_fwd_ms = plain_time_ms(
        lambda: flash_block_fwd_plain(q, k, v, causal, kv_lengths=lens), 3)
    plain_bwd_ms = plain_time_ms(
        lambda: flash_block_bwd_plain(*bwd_args, kv_lengths=lens), 3)
    # Yardsticks: SDPA's forward (causal as the case, no lengths), and its
    # backward alone: the forward runs once outside the timer on the same
    # pinned backend, then only torch.autograd.grad is timed.
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa, backend = sdpa_yardstick(qg, kg, vg, is_causal=causal)
    library = {"flash_fwd": library_time("flash_fwd" + at, sdpa, 20,
                                         backend)}
    out_g = sdpa()
    sdpa_bwd = library_time(
        "flash_bwd" + at, lambda: torch.autograd.grad(
            out_g, (qg, kg, vg), do, retain_graph=True), 20,
        f"{backend} backward")
    library["flash_bwd_dq"] = library["flash_bwd_dkv"] = sdpa_bwd
    pairs = attended_pairs(s, causal, lengths or [s] * b) * h
    x = b * h * s * d * 2                     # one [B, H, S, D] bf16 tensor
    lse_bytes = b * h * s * 4                 # and one fp32 [B, H, S] row
    # dq reads q, k, v, dO, lse and delta and writes dq; dK/dV's row
    # carries the pre-pass, so it reads o too.
    bounds = {"flash_fwd": bound(4 * x + lse_bytes, 4 * pairs * d),
              "flash_bwd_dq": bound(5 * x + 2 * lse_bytes, 6 * pairs * d),
              "flash_bwd_dkv": bound(7 * x + lse_bytes, 8 * pairs * d)}
    plain_ms = {"flash_fwd": plain_fwd_ms, "flash_bwd_dq": plain_bwd_ms,
                "flash_bwd_dkv": plain_bwd_ms}
    res["timing"] = {n: {**timing[n], **library[n], "plain_ms": plain_ms[n],
                         "bound_ms": bounds[n][0], "bound_by": bounds[n][1]}
                     for n in timing}
    res["whole_backward"] = {
        "ms": whole["ms"], "ms_spread": whole["ms_spread"],
        "profiler_kernels": whole["profiler_kernels"],
        "sdpa_backward_ms": sdpa_bwd["library_ms"],
        "sdpa_backend": sdpa_bwd["library_backend"]}
    return res


FLASH_SOURCES = {
    "flash_fwd": ("nezha_tpu_torch/csrc/flash_fwd.cu",
                  "nezha_tpu/ops/pallas/flash_attention.py:91"),
    "flash_bwd_dq": ("nezha_tpu_torch/csrc/flash_bwd.cu",
                     "nezha_tpu/ops/pallas/flash_attention.py:228"),
    "flash_bwd_dkv": ("nezha_tpu_torch/csrc/flash_bwd.cu",
                      "nezha_tpu/ops/pallas/flash_attention.py:265"),
}


# Each flash row's kernels in the built libraries (SASS labels), and the
# Hopper bodies: every instantiation of these must issue wgmma (HGMMA)
# and TMA loads (UTMALDG).
FLASH_SASS = {"flash_fwd": ("flash_fwd_",),
              "flash_bwd_dq": ("flash_bwd_dq_",),
              "flash_bwd_dkv": ("flash_bwd_delta_", "flash_bwd_dkv_")}
HOPPER_BODIES = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel")
# The first bodies of B1-B3, built for fp32 only: bf16 runs the Hopper
# ones.
FIRST_BODIES = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel")


def sass_label(mangled: str) -> str:
    """A mangled flash kernel instantiation, readable: its dtype and
    integer template arguments, ``flash_bwd_dq_kernel<bf16, 8>``,
    ``flash_fwd_wgmma_kernel<64, 2, 128, 2>``."""
    import re

    m = re.search(r"(flash_[a-z_]+_kernel)I(.*?E)E*v", mangled)
    if not m:
        return mangled
    args = m.group(2)
    words = (["bf16"] if args.startswith("13__nv_bfloat16")
             else ["f32"] if args.startswith("f") else [])
    words += re.findall(r"Li(\d+)E", args)
    return f"{m.group(1)}<{', '.join(words)}>"


def flash_sass():
    """``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) counts of every kernel
    instantiation in the built flash libraries, from ``cuobjdump -sass``.
    Fails unless every instantiation of the three Hopper bodies (one or
    more each) issues both, or if a first body of B1-B3 was built for
    bf16."""
    import re
    from pathlib import Path

    from nezha_tpu_torch.ops.cuda import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    counts = {}
    for lib in ("flash_fwd", "flash_bwd"):
        sass = subprocess.run([str(tool), "-sass",
                               str(build.library_path(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        current = None
        for line in sass.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                current = sass_label(m.group(1))
                counts[current] = {"HGMMA": 0, "UTMALDG": 0}
            elif current:
                for op in counts[current]:
                    if re.search(rf"\b{op}\b", line):
                        counts[current][op] += 1
    for body in HOPPER_BODIES:
        inst = {k: c for k, c in counts.items() if k.startswith(body + "<")}
        if not inst or not all(c["HGMMA"] and c["UTMALDG"]
                               for c in inst.values()):
            fail(f"{body}: SASS instantiations {inst} lack HGMMA or UTMALDG")
    for body in FIRST_BODIES:
        if any(k.startswith(body + "<bf16") for k in counts):
            fail(f"{body} was built for bf16: {sorted(counts)}")
    return counts


def check_flash(g):
    """The flash kernels on nine cases; the kernels line reports the
    training shape's times, BERT's non-causal shape's times (``bert``),
    the worst error over all cases and each row's SASS counts."""
    main = flash_case(g, TRAIN_B, TRAIN_S, True, timed=True)
    bert = flash_case(g, BERT_B, BERT_S, False, timed=True)
    cases = [main, bert,
             flash_case(g, BERT_B, BERT_S, False, lengths=BERT_PAD_LENGTHS),
             flash_case(g, 4, TRAIN_S, False),
             flash_case(g, 4, TRAIN_S, True, lengths=[0, 1, 517, TRAIN_S]),
             flash_case(g, TRAIN_B, 100, True),
             flash_case(g, 2, TRAIN_S, True, lengths=[0, 700], d=128),
             flash_case(g, 2, 200, True, d=40),
             flash_case(g, 3, 130, True, lengths=[0, 77, 500], h=2)]
    print(json.dumps({"flash_cases": [
        {k: v for k, v in c.items() if k not in ("timing", "whole_backward")}
        for c in cases]}), flush=True)
    whole = main["whole_backward"]
    bert_shape = f"B={BERT_B} H={H} S={BERT_S} D={D} non-causal"
    print(json.dumps({"flash_backward": {
        "shape": f"B={TRAIN_B} H={H} S={TRAIN_S} D={D} causal", **whole}}),
        flush=True)
    print(json.dumps({"flash_backward": {
        "shape": bert_shape, **bert["whole_backward"]}}), flush=True)
    sass = flash_sass()
    out = []
    for name, (source, replaces) in FLASH_SOURCES.items():
        t = main["timing"][name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "max_abs_err": max(c[name][0] for c in cases),
                    "err_over_tolerance": max(c[name][1] for c in cases),
                    **t,
                    "shape": f"B={TRAIN_B} H={H} S={TRAIN_S} D={D} causal",
                    "bert": {**bert["timing"][name], "shape": bert_shape,
                             "whole_backward_ms":
                                 bert["whole_backward"]["ms"]},
                    "sass": {k: c for k, c in sass.items()
                             if k.startswith(FLASH_SASS[name])}})
        if name != "flash_fwd":
            out[-1]["plain_covers"] = "dq, dk and dv together"
            out[-1]["library_covers"] = "dq, dk and dv together"
            out[-1]["whole_backward_ms"] = whole["ms"]
    return out


def launched_grid(kernel: str):
    """The grid (x, y, z) of a split decode kernel's last launch, as its
    library recorded it at the launch (``nezha_<kernel>_last_grid``)."""
    import ctypes
    from nezha_tpu_torch.ops.cuda import build

    xyz = (ctypes.c_int * 3)()
    build.bind(kernel, f"nezha_{kernel}_last_grid", (ctypes.c_void_p,))(xyz)
    return list(xyz)


def check_flash_decode(g):
    """The dense flash-decode kernel at generate's shape: all four (q,
    cache) dtype pairs, lengths from 0 to L and on the first splits'
    boundaries; the length-0 row exact zero, two runs bitwise equal."""
    from nezha_tpu_torch.ops.cuda import (flash_decode_attention,
                                          flash_decode_attention_plain)
    from nezha_tpu_torch.ops.cuda.decode_attention import split_size

    split = split_size("flash_decode")
    lengths_list = [0, 1, 17, 300, 511, 768, 1000, DEC_L,
                    split - 1, split, split + 1, 2 * split + 1]
    b = len(lengths_list)
    bf, f32 = torch.bfloat16, torch.float32
    q32 = torch.randn(b, H, 1, D, generator=g).cuda()
    k32 = torch.randn(b, H, DEC_L, D, generator=g).cuda()
    v32 = torch.randn(b, H, DEC_L, D, generator=g).cuda()
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    worst = worst_ratio = 0.0
    for q_dtype, cache_dtype in ((bf, bf), (f32, bf), (bf, f32), (f32, f32)):
        q, k, v = q32.to(q_dtype), k32.to(cache_dtype), v32.to(cache_dtype)
        tag = f"flash_decode q {q_dtype} cache {cache_dtype}"
        got = flash_decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        want = flash_decode_attention_plain(q, k, v, lengths)
        abs_v = flash_decode_attention_plain(q, k, v.abs(), lengths)
        err, ratio = within(tag, got, want,
                            fold_bound(want, abs_v, cache_dtype))
        if not torch.all(got[0] == 0):
            fail(f"{tag}: the length-0 row is not exact zero")
        if not torch.equal(flash_decode_attention(q, k, v, lengths), got):
            fail(f"{tag}: two runs differ")
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    # Timed at generate's batch, every row at length 768.
    q, k, v = (x[:8].to(bf) for x in (q32, k32, v32))
    timed = torch.full((8,), 768, dtype=torch.int32, device="cuda")
    args = (q, k, v, timed)
    timing = device_time("flash_decode",
                         lambda: flash_decode_attention(*args), 100)
    grid = launched_grid("flash_decode")
    if not math.prod(grid):
        fail(f"flash_decode: no launch grid recorded ({grid})")
    plain_ms = plain_time_ms(lambda: flash_decode_attention_plain(*args), 5)
    mask = (torch.arange(DEC_L, device="cuda")[None, :]
            < timed[:, None])[:, None, None, :]
    sdpa, backend = sdpa_yardstick(q, k, v, attn_mask=mask)
    timing.update(library_time("flash_decode", sdpa, 100, backend))
    total = 768 * 8
    nbytes = (2 * 8 * H * D * 2                     # q in, out
              + 2 * total * H * D * 2               # K and V read once
              + 8 * 4)
    bound_ms, bound_by = bound(nbytes, 4 * total * H * D)
    return {"name": "flash_decode", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/flash_decode.cu",
            "replaces": "nezha_tpu/ops/pallas/decode_attention.py:63",
            "max_abs_err": worst, "err_over_tolerance": worst_ratio,
            **timing, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "split": split, "grid": grid,
            "blocks": math.prod(grid),
            "shape": f"B=8 H={H} L={DEC_L} D={D} bf16, timed at length "
                     f"768 (splits of {split} keys, grid {grid}); checked "
                     f"B={b} lengths={lengths_list}, all four (q, cache) "
                     f"dtype pairs"}


# The rows B4's forward gets, by path: generate's decode steps (one token
# of GEN_B rows; GEN_NEW - 1 steps of 25 LayerNorms), its prefill (GEN_B x
# GEN_PROMPT rows, 25 launches a call) and a train step with
# ln_impl="pallas" (TRAIN_B x TRAIN_S rows, 25 a step, where B5 runs too).
LN_TIMED_ROWS = {"generate decode": GEN_B,
                 "generate prefill": GEN_B * GEN_PROMPT,
                 "train": TRAIN_B * TRAIN_S}


def layer_norm_case(g, rows: int, d: int):
    """x [rows, d] bf16 (rows with their own offsets), dy, fp32 scale and
    bias, on the card."""
    bf = torch.bfloat16
    x = (torch.randn(rows, d, generator=g) * 2
         + torch.randn(rows, 1, generator=g)).to("cuda", bf)
    dy = torch.randn(rows, d, generator=g).to("cuda", bf)
    scale = (1 + 0.3 * torch.randn(d, generator=g)).cuda()
    bias = (0.2 * torch.randn(d, generator=g)).cuda()
    return x, dy, scale, bias


def time_layer_norm_fwd(x, scale, bias, eps, fwd=None):
    """B4's forward (or ``fwd``, another build's) on x with the device
    timer, beside ``F.layer_norm`` on the same rows, the plain version and
    the bound -> the row's fields. ``F.layer_norm`` on the card takes scale
    and bias in x's dtype."""
    import torch.nn.functional as F
    from nezha_tpu_torch.ops.cuda.layer_norm import (layer_norm_fwd,
                                                     layer_norm_fwd_plain)

    fwd = fwd or layer_norm_fwd
    rows, d = x.shape
    label = f"layer_norm_fwd rows={rows}"
    sg, bg = scale.to(x.dtype), bias.to(x.dtype)
    elems = rows * d
    # x in, y out (bf16), scale and bias in; ~8 fp32 ops each
    bound_ms, bound_by = bound(2 * elems * x.element_size() + 2 * d * 4,
                               8 * elems, FP32_FLOPS_PER_S)
    return {"rows": rows,
            **device_time(label, lambda: fwd(x, scale, bias, eps), 50),
            **library_time(label,
                           lambda: F.layer_norm(x, (d,), sg, bg, eps), 50,
                           "F.layer_norm"),
            "plain_ms": plain_time_ms(
                lambda: layer_norm_fwd_plain(x, scale, bias, eps), 5),
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_layer_norm_bwd(x, dy, scale, bias, eps, bwd=None):
    """B5 (or ``bwd``, another build's backward returning dx, dscale and
    dbias) on x and dy with the device timer, beside ``F.layer_norm``'s
    backward alone (its forward runs once outside the timer, then only
    ``torch.autograd.grad``), the plain version and the bound -> the
    row's fields."""
    import torch.nn.functional as F
    from nezha_tpu_torch.ops.cuda.layer_norm import (layer_norm_bwd,
                                                     layer_norm_bwd_plain)

    bwd = bwd or layer_norm_bwd
    rows, d = x.shape
    xg, sg, bg = (t.detach().to(x.dtype).requires_grad_()
                  for t in (x, scale, bias))
    y_g = F.layer_norm(xg, (d,), sg, bg, eps)
    elems = rows * d
    # x, dy in, dx out (bf16), scale in, dscale and dbias out; ~19 fp32
    # ops each
    bound_ms, bound_by = bound(3 * elems * x.element_size() + 3 * d * 4,
                               19 * elems, FP32_FLOPS_PER_S)
    return {**device_time("layer_norm_bwd",
                          lambda: bwd(x, scale, dy, eps), 50),
            **library_time(
                "layer_norm_bwd",
                lambda: torch.autograd.grad(y_g, (xg, sg, bg), dy,
                                            retain_graph=True), 50,
                "F.layer_norm backward"),
            "plain_ms": plain_time_ms(
                lambda: layer_norm_bwd_plain(x, scale, dy, eps), 5),
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_layer_norm(g):
    """The LayerNorm kernels at D=768, bf16 x, on the rows of
    LN_TIMED_ROWS and 37 rows, each within ``layer_norm_error_bound`` (the
    backward's dx, dscale and dbias, which its second kernel sums) and
    both bitwise repeatable; the forward timed at each of LN_TIMED_ROWS's
    shapes, the backward at the train step's; -> the kernels line's two
    entries. The forward's entry carries generate's
    decode shape (almost all of its launches on its home path) and each
    timed shape under ``by_rows``."""
    from nezha_tpu_torch.ops.cuda.layer_norm import (
        launched_fwd_plan, layer_norm_bwd, layer_norm_bwd_plain,
        layer_norm_error_bound, layer_norm_fwd, layer_norm_fwd_plain)

    d, eps = LN_D, 1e-5
    worst = {"layer_norm_fwd": (0.0, 0.0), "layer_norm_bwd": (0.0, 0.0)}
    by_rows, bwd_timing = {}, {}
    for rows in sorted(set(LN_TIMED_ROWS.values()) | {37}):
        x, dy, scale, bias = layer_norm_case(g, rows, d)
        y = layer_norm_fwd(x, scale, bias, eps)
        torch.cuda.synchronize()
        res = [within(f"layer_norm_fwd rows={rows}", y,
                      layer_norm_fwd_plain(x, scale, bias, eps),
                      layer_norm_error_bound(x, scale, bias, eps))]
        if not torch.equal(layer_norm_fwd(x, scale, bias, eps), y):
            fail(f"layer_norm_fwd rows={rows}: two runs differ")
        grads = layer_norm_bwd(x, scale, dy, eps)
        torch.cuda.synchronize()
        plain = layer_norm_bwd_plain(x, scale, dy, eps)
        bounds = layer_norm_error_bound(x, scale, bias, eps, dy=dy)
        bwd = []
        for name, got, want, bd in zip(("dx", "dscale", "dbias"), grads,
                                       plain, bounds):
            bwd.append(within(f"layer_norm_bwd rows={rows} {name}", got,
                              want, bd))
        res.append((max(e for e, _ in bwd), max(r for _, r in bwd)))
        again = layer_norm_bwd(x, scale, dy, eps)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            fail(f"layer_norm_bwd rows={rows}: two runs differ")
        for name, (err, ratio) in zip(worst, res):
            worst[name] = (max(worst[name][0], err),
                           max(worst[name][1], ratio))
        if rows not in LN_TIMED_ROWS.values():
            continue
        timing = time_layer_norm_fwd(x, scale, bias, eps)
        by_rows[str(rows)] = {
            "path": [p for p, r in LN_TIMED_ROWS.items() if r == rows],
            "plan": dataclasses.asdict(launched_fwd_plan()), **timing}
        if rows != LN_TIMED_ROWS["train"]:
            continue
        bwd_timing = time_layer_norm_bwd(x, dy, scale, bias, eps)
    decode = dict(by_rows[str(LN_TIMED_ROWS["generate decode"])])
    decode.pop("rows")
    decode.pop("path")
    fwd = {"name": "layer_norm_fwd", "route": "cuda",
           "source": "nezha_tpu_torch/csrc/layer_norm.cu",
           "replaces": "nezha_tpu/ops/pallas/layer_norm.py:24",
           "max_abs_err": worst["layer_norm_fwd"][0],
           "err_over_tolerance": worst["layer_norm_fwd"][1], **decode,
           "by_rows": by_rows,
           "shape": f"rows={LN_TIMED_ROWS['generate decode']} D={d} bf16 x, "
                    f"fp32 scale/bias (generate's decode step); timed also "
                    f"at rows {LN_TIMED_ROWS['generate prefill']} and "
                    f"{LN_TIMED_ROWS['train']} (by_rows); checked rows "
                    f"{sorted(set(LN_TIMED_ROWS.values()) | {37})}"}
    bwd = {"name": "layer_norm_bwd", "route": "cuda",
           "source": "nezha_tpu_torch/csrc/layer_norm.cu",
           "replaces": "nezha_tpu/ops/pallas/layer_norm.py:33",
           "max_abs_err": worst["layer_norm_bwd"][0],
           "err_over_tolerance": worst["layer_norm_bwd"][1], **bwd_timing,
           "library_covers": "dx, dscale and dbias",
           "shape": f"rows={LN_TIMED_ROWS['train']} D={d} bf16 x, fp32 "
                    f"scale/bias; checked rows "
                    f"{sorted(set(LN_TIMED_ROWS.values()) | {37})}"}
    return [fwd, bwd]


def compare_steps(what: str, model, ref, batch, loss_fn=None,
                  lr: float = TRAIN_LR, weight_decay: float = 0.1,
                  loss_atol: float = TRAIN_LOSS_ATOL,
                  grad_rtol: float = TRAIN_GRAD_RTOL) -> dict:
    """One AdamW step (constant ``lr``) of ``model`` against the same
    step of ``ref`` from the same weights and batch: the loss
    (``loss_fn``, GPT-2's ``lm_loss`` when None) within ``loss_atol``,
    each gradient within ``grad_rtol`` of its norm, the weights after the
    step within 2 * lr. Both models are updated."""
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.train import make_train_step

    steps = [make_train_step(m, adamw(lr, weight_decay=weight_decay),
                             loss_fn or lm_loss) for m in (model, ref)]
    loss, grads = steps[0].loss_and_grads(batch)
    loss_r, grads_r = steps[1].loss_and_grads(batch)
    loss_err = abs(loss.item() - loss_r.item())
    if not math.isfinite(loss.item()) or loss_err > loss_atol:
        fail(f"train {what}: loss {loss.item()} vs reference "
             f"{loss_r.item()} (tolerance {loss_atol})")
    worst_grad, worst_name = 0.0, None
    for name, g in grads.items():
        gr = grads_r[name]
        rel = ((g - gr).norm() / gr.norm().clamp_min(1e-30)).item()
        if rel >= worst_grad:
            worst_grad, worst_name = rel, name
        if not rel <= grad_rtol:
            fail(f"train {what}: gradient of {name} differs by {rel} of its "
                 f"norm (tolerance {grad_rtol})")
    del grads, grads_r
    for st in steps:
        st(batch)
    worst_w = max((pa - pb).abs().max().item() for pa, pb in zip(
        steps[0].params.values(), steps[1].params.values()))
    if not worst_w <= 2 * lr + 1e-6:
        fail(f"train {what}: weights after one step differ by {worst_w} > "
             f"2 * lr")
    return {"loss": loss.item(), "loss_reference": loss_r.item(),
            "loss_err": loss_err, "loss_atol": loss_atol,
            "max_grad_rel_err": worst_grad, "worst_param": worst_name,
            "grad_rtol": grad_rtol, "max_weight_err_after_step": worst_w}


def timed_fit(model, batches, n_steps: int, counters, per_step, card: str,
              loss_fn=None, optimizer=None, b: int = TRAIN_B,
              s: int = TRAIN_S):
    """2 warm-up steps, then ``n_steps`` through ``Trainer.fit`` on the
    host clock (ended by a device sync), every count in ``counters`` set
    to 0 just before; each kernel in ``per_step`` must launch exactly
    that many times per step, the LayerNorm forward on the step's rows.
    ``loss_fn`` and ``optimizer`` default to GPT-2's ``lm_loss`` and
    AdamW (lr TRAIN_LR, weight decay 0.1); the batches are ``b`` rows of
    ``s`` tokens. MFU counts ``bench.py``'s step flops, ``(6 N + 6 L H
    S) B S``. -> (stats, launches, the trainer)."""
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.ops.cuda.layer_norm import FWD_LAUNCHES_BY_ROWS
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.train import Trainer

    trainer = Trainer(model, optimizer or adamw(TRAIN_LR, weight_decay=0.1),
                      loss_fn or lm_loss, log_every=0)
    trainer.fit(batches, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        for name in c:
            c[name] = 0
    FWD_LAUNCHES_BY_ROWS.clear()
    t0 = time.perf_counter()
    last = trainer.fit(batches, n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: n for c in counters for name, n in c.items()}
    for name, want in per_step.items():
        if launches[name] != want * n_steps:
            fail(f"train: {name} launched {launches[name]} times in "
                 f"{n_steps} steps, not {want} per step")
    ln_rows = dict(FWD_LAUNCHES_BY_ROWS)
    if ln_rows != ({b * s: launches["layer_norm_fwd"]}
                   if launches.get("layer_norm_fwd") else {}):
        fail(f"train: LayerNorm forward launches by rows {ln_rows}")
    if not math.isfinite(last["loss"]):
        fail(f"train: loss {last['loss']}")
    n_params = sum(p.numel() for p in model.parameters())
    cfg = model.cfg
    step_flops = (6 * n_params + 6 * cfg.num_layers * cfg.hidden_size * s) \
        * b * s
    return {"B": b, "S": s, "ln_impl": cfg.ln_impl, "steps": n_steps,
            "ms_per_step": wall / n_steps * 1e3,
            "tokens_per_s": b * s * n_steps / wall,
            "mfu": step_flops * n_steps / wall / BF16_FLOPS_PER_S,
            "step_tflop": step_flops / 1e12, "params": n_params,
            "last_loss": last["loss"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches, "layer_norm_fwd_by_rows": ln_rows,
            "card": card}, launches, trainer


def run_dir_cost(trainer, batches, card: str) -> dict:
    """(g) What a telemetry run (the train CLI's ``--run-dir``) costs a
    step: ``trainer`` logging every 5 steps, windows of RUN_DIR_STEPS
    steps on the host clock (ended by a sync) bare and inside
    ``obs.start_run``, in the order bare, run, run, bare twice; the
    difference of the sides' medians (a single window swings by tens of
    ms, ROADMAP C2)."""
    import statistics
    import tempfile

    from nezha_tpu_torch import obs

    trainer.log_every = 5
    ms = {"bare": [], "run": []}
    with tempfile.TemporaryDirectory(prefix="nezha_run_cost_") as tmp:
        for i, side in enumerate(("bare", "run", "run", "bare") * 2):
            if side == "run":
                obs.start_run(f"{tmp}/{i}")
            t0 = time.perf_counter()
            trainer.fit(batches, RUN_DIR_STEPS)
            torch.cuda.synchronize()
            ms[side].append((time.perf_counter() - t0) / RUN_DIR_STEPS
                            * 1e3)
            if side == "run":
                obs.end_run()
    return {"steps": RUN_DIR_STEPS, "bare_ms_per_step": ms["bare"],
            "run_ms_per_step": ms["run"],
            "extra_ms_per_step": statistics.median(ms["run"])
            - statistics.median(ms["bare"]), "card": card}


def train(card: str):
    """-> ({"train": flash launches of the default run, "train_ln": flash
    and LayerNorm launches of the ln_impl="pallas" run}, {"train_ln": its
    LayerNorm forward launches by row count})."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.data import synthetic_token_batches
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.ops.cuda.layer_norm import LAUNCHES as LN_LAUNCHES
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.train import make_train_step

    b, s = TRAIN_B, TRAIN_S
    layers = 12
    batches = synthetic_token_batches(b, seq_len=s, seed=0)
    batch = next(batches)

    def fresh(**kw):
        return gpt2_for_preset("full", seed=0, device="cuda",
                               fused_loss_chunk=-1, **kw)

    # (a) one step, flash against composed attention, same weights.
    model = fresh()
    ref = fresh(attn_impl="xla")
    ref.load_state_dict(model.state_dict())
    print(json.dumps({"train_vs_composed": compare_steps(
        "flash vs composed attention", model, ref, batch)}), flush=True)
    del ref
    # (e) one step, the LayerNorm kernels against the xla LayerNorm.
    ln_model, ref = fresh(ln_impl="pallas"), fresh()
    ref.load_state_dict(ln_model.state_dict())
    print(json.dumps({"train_ln_vs_xla_ln": compare_steps(
        "ln_impl pallas vs xla", ln_model, ref, batch)}), flush=True)
    del ln_model, ref
    torch.cuda.empty_cache()

    # (b) the loss on one fixed batch falls at a constant lr.
    model = fresh()
    step = make_train_step(model, adamw(TRAIN_LR, weight_decay=0.1),
                           lm_loss)
    losses = [step(batch)["loss"].item() for _ in range(10)]
    if not (all(map(math.isfinite, losses))
            and losses[-1] <= losses[0] - LOSS_DROP):
        fail(f"train: fixed-batch loss did not fall by {LOSS_DROP}: "
             f"{losses}")
    print(json.dumps({"fixed_batch_losses": losses}), flush=True)
    del step

    # (c) + (d): the main path, Trainer.fit over the synthetic stream.
    stats, launches, _ = timed_fit(model, batches, 10, [LAUNCHES],
                                   {n: layers for n in LAUNCHES}, card)
    print(json.dumps({"train": stats}), flush=True)
    del model
    torch.cuda.empty_cache()
    # (f) the same run with the LayerNorm kernels.
    ln_stats, ln_launches, trainer = timed_fit(
        fresh(ln_impl="pallas"), batches, 10, [LAUNCHES, LN_LAUNCHES],
        {**{n: layers for n in LAUNCHES},
         **{n: 2 * layers + 1 for n in LN_LAUNCHES}}, card)
    print(json.dumps({"train_ln_pallas": ln_stats,
                      "default_ms_per_step": stats["ms_per_step"],
                      "ln_pallas_over_default": ln_stats["ms_per_step"]
                      / stats["ms_per_step"]}), flush=True)
    print(json.dumps({"train_run_dir_cost": run_dir_cost(trainer, batches,
                                                         card)}),
          flush=True)
    del trainer
    torch.cuda.empty_cache()
    return ({"train": launches, "train_ln": ln_launches},
            {"train_ln": ln_stats["layer_norm_fwd_by_rows"]})


def bert_models(**kw):
    """BERT-base as ``bert_base_zero1`` builds it (bf16, the fused MLM
    head, seed 0) with ``kw`` overriding its config, on the card."""
    from nezha_tpu_torch.models.bert import bert_base

    gen = torch.Generator(device="cuda").manual_seed(0)
    return bert_base(fused_loss_chunk=-1, generator=gen, **kw)


def right_padded(batch: dict, lengths) -> dict:
    """``batch`` with ``kv_lengths`` and its labels -100 past each row's
    length."""
    import numpy as np

    lens = np.asarray(lengths, np.int32)
    past = np.arange(batch["labels"].shape[1])[None, :] >= lens[:, None]
    return {**batch, "labels": np.where(past, -100, batch["labels"]),
            "kv_lengths": lens}


def train_bert(card: str):
    """Phase 4a (see the module docstring). -> (flash launches of the
    timed run, its summary)."""
    from nezha_tpu_torch.cli.train import build_config
    from nezha_tpu_torch.models.bert import mlm_loss
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.train import evaluate, make_train_step

    check = dict(loss_fn=mlm_loss, lr=BERT_LR, weight_decay=BERT_WD,
                 loss_atol=BERT_LOSS_ATOL, grad_rtol=BERT_GRAD_RTOL)
    cfg = build_config("bert_base_zero1", steps=12, seed=0, device="cuda")
    layers = cfg.model.cfg.num_layers
    batches = cfg.batches(BERT_B)
    batch = next(batches)
    # (a) and (b): one step, flash against composed, same weights; the
    # full-length batch, then the right-padded one.
    for tag, b in (("full", batch),
                   ("right_padded", right_padded(batch, BERT_PAD_LENGTHS))):
        model, ref = bert_models(), bert_models(attn_impl="xla")
        ref.load_state_dict(model.state_dict())
        before = LAUNCHES["flash_fwd"]
        res = compare_steps(f"bert {tag} flash vs composed", model, ref, b,
                            **check)
        if LAUNCHES["flash_fwd"] - before != 2 * layers:
            fail(f"train_bert: the {tag} check ran "
                 f"{LAUNCHES['flash_fwd'] - before} flash forwards, not "
                 f"{2 * layers}")
        print(json.dumps({f"bert_vs_composed_{tag}": res}), flush=True)
        del model, ref
        gc.collect()
        torch.cuda.empty_cache()

    # (c) the loss on one fixed batch falls at a constant lr.
    model = bert_models()
    step = make_train_step(model, adamw(BERT_LR, weight_decay=BERT_WD),
                           mlm_loss)
    losses = [step(batch)["loss"].item() for _ in range(10)]
    if not (all(map(math.isfinite, losses))
            and losses[-1] <= losses[0] - BERT_LOSS_DROP):
        fail(f"train_bert: fixed-batch loss did not fall by "
             f"{BERT_LOSS_DROP}: {losses}")
    print(json.dumps({"bert_fixed_batch_losses": losses}), flush=True)
    del step, model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the main path: Trainer.fit with the config's model, optimizer
    # and batches; (e) its eval split on the trained weights.
    stats, launches, trainer = timed_fit(
        cfg.model, batches, 10, [LAUNCHES], {n: layers for n in LAUNCHES},
        card, loss_fn=cfg.loss_fn, optimizer=cfg.optimizer, b=BERT_B,
        s=BERT_S)
    stats.update(config="bert_base_zero1", policy="bf16",
                 **profiled_busy_share(trainer, batches, 3))
    print(json.dumps({"train_bert": stats}), flush=True)
    result = evaluate(cfg.model, cfg.eval_batches(BERT_B), cfg.eval_stat)
    if not (math.isfinite(result["perplexity"]) and result["count"] > 0):
        fail(f"train_bert: eval {result}")
    print(json.dumps({"bert_eval": result}), flush=True)
    del trainer, cfg
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"tokens_per_s": stats["tokens_per_s"],
                      "ms_per_step": stats["ms_per_step"],
                      "mfu": stats["mfu"],
                      "device_busy_share": stats["device_busy_share"],
                      "peak_mem_gb": stats["peak_mem_gb"],
                      "eval_perplexity": result["perplexity"]}


def image_check_models(seed: int = 0):
    """The config's bf16 ResNet-50 (weights from ``seed``) and an fp32
    copy with the same weights and buffers; the zero-initialized head and
    last BatchNorm scales replaced by values drawn from ``seed + 1`` (a
    LeCun-scaled head, scales of std BN3_SCALE_STD: near the config's
    identity blocks, where a deeper net's bf16 gradients stay near its
    fp32 ones) so that gradients reach the trunk."""
    from nezha_tpu_torch.cli.train import build_config
    from nezha_tpu_torch.models import resnet50
    from nezha_tpu_torch.tensor.policy import f32_policy

    model = build_config("resnet50_imagenet", seed=seed,
                         device="cuda").model
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bn3.scale"):
                p.copy_(BN3_SCALE_STD * torch.randn(
                    p.shape, generator=g, device="cuda"))
            elif name == "head.w":
                p.copy_(torch.randn(p.shape, generator=g, device="cuda")
                        / math.sqrt(p.shape[0]))
    ref = resnet50(stem="s2d", policy=f32_policy(), device="cuda")
    ref.load_state_dict(model.state_dict())
    return model, ref


def batch_statistics(model, before: dict) -> dict:
    """``{BatchNorm name: (mean, var, eps)}`` of the batch that one
    training forward saw, recovered from each module's buffers before
    (``before``) and after it: ``(after - m * before) / (1 - m)``."""
    from nezha_tpu_torch.nn.layers import BatchNorm

    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            m = mod.momentum
            out[name] = tuple(
                (getattr(mod, b) - m * before[f"{name}.{b}"]) / (1 - m)
                for b in ("mean", "var")) + (mod.eps,)
    return out


def image_step_errors(batch, seed: int = 0) -> dict:
    """One training forward and backward of the bf16 model against the
    fp32 one with TF32 off, from the same weights (``seed``) and batch:
    -> the losses, the gradients' distances and the batch statistics'."""
    from nezha_tpu_torch.cli.train import image_ce
    from nezha_tpu_torch.optim import sgd
    from nezha_tpu_torch.train import make_train_step

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model, ref = image_check_models(seed)
        before = {k: v.clone() for k, v in ref.named_buffers()}
        (loss, grads), (loss_r, grads_r) = (
            make_train_step(m, sgd(0.0), image_ce).loss_and_grads(batch)
            for m in (model, ref))
        stats, stats_r = (batch_statistics(m, before) for m in (model, ref))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    diff_sq = norm_sq = 0.0
    worst_cos, worst_rel = (1.0, ""), (0.0, "")
    for name, gr in grads_r.items():
        g = grads[name].float()
        diff_sq += (g - gr).square().sum().item()
        norm_sq += gr.square().sum().item()
        rel = ((g - gr).norm() / gr.norm().clamp_min(1e-30)).item()
        cos = torch.nn.functional.cosine_similarity(
            g.flatten(), gr.flatten(), dim=0).item()
        worst_rel = max(worst_rel, (rel, name))
        worst_cos = min(worst_cos, (cos, name))
    worst_mean, worst_var = (0.0, ""), (0.0, "")
    for name, (mean_r, var_r, eps) in stats_r.items():
        mean, var, _ = stats[name]
        # The mean's error in units of the batch's standard deviation
        # (RMS over the channels), the variance's relative to its norm.
        mean_err = ((mean - mean_r) / (var_r + eps).sqrt()).square().mean(
        ).sqrt().item()
        var_err = ((var - var_r).norm() / var_r.norm()).item()
        worst_mean = max(worst_mean, (mean_err, name))
        worst_var = max(worst_var, (var_err, name))
    return {"B": len(batch["label"]), "seed": seed,
            "loss_bf16": loss.item(), "loss_fp32": loss_r.item(),
            "loss_rel_err": abs(loss.item() - loss_r.item())
            / abs(loss_r.item()),
            "grad_rel_err_whole": math.sqrt(diff_sq / norm_sq),
            "grad_rel_err_worst_tensor": list(worst_rel),
            "grad_cos_worst_tensor": list(worst_cos),
            "batch_mean_err_worst": list(worst_mean),
            "batch_var_rel_err_worst": list(worst_var),
            "tensors": len(grads)}


def image_check_failures(errs: dict) -> list:
    """The limits of (a) that ``errs`` (:func:`image_step_errors`)
    breaks, as messages; a NaN breaks every limit it meets."""
    out = []
    if not errs["loss_rel_err"] <= IMAGE_LOSS_RTOL:
        out.append(f"bf16 loss {errs['loss_bf16']} vs fp32 "
                   f"{errs['loss_fp32']} (tolerance {IMAGE_LOSS_RTOL} of "
                   f"it)")
    if not errs["grad_rel_err_whole"] <= IMAGE_GRAD_RTOL:
        out.append(f"the whole bf16 gradient differs by "
                   f"{errs['grad_rel_err_whole']} of its norm (tolerance "
                   f"{IMAGE_GRAD_RTOL})")
    cos, name = errs["grad_cos_worst_tensor"]
    if not cos >= IMAGE_GRAD_COS:
        out.append(f"gradient of {name} has cosine {cos} with its fp32 "
                   f"gradient (at least {IMAGE_GRAD_COS})")
    err, name = errs["batch_mean_err_worst"]
    if not err <= IMAGE_MEAN_TOL:
        out.append(f"batch mean of {name} off by {err} of its standard "
                   f"deviation (tolerance {IMAGE_MEAN_TOL})")
    err, name = errs["batch_var_rel_err_worst"]
    if not err <= IMAGE_VAR_RTOL:
        out.append(f"batch variance of {name} off by {err} of its norm "
                   f"(tolerance {IMAGE_VAR_RTOL})")
    return out


def compare_image_steps(batch) -> dict:
    """(a): :func:`image_step_errors` held to the IMAGE_* limits."""
    errs = image_step_errors(batch)
    broken = image_check_failures(errs)
    if broken:
        fail("train_image: " + "; ".join(broken))
    return errs


def profiled_busy_share(trainer, batches, steps: int) -> dict:
    """``steps`` more steps under torch.profiler: the device's busy
    milliseconds a step (its kernels' and copies' time) over the wall."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.fit(batches, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = copy_us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        busy_us += us
        if "memcpy htod" in e.key.lower():
            copy_us += us
    return {"profiled_steps": steps,
            "profiled_ms_per_step": wall / steps * 1e3,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_busy_share": busy_us / 1e6 / wall,
            "htod_copy_ms_per_step": copy_us / 1e3 / steps}


def timed_image_fit(name: str, batch: int, n_steps: int,
                    flops_per_image: float, card: str,
                    busy_steps: int = 0) -> dict:
    """Config ``name`` (its model, optimizer and batches) through
    ``Trainer.fit`` at ``batch`` images of IMG_SIZE px: 2 warm-up steps,
    then ``n_steps`` on the host clock ended by a sync, with the port's
    kernel counts set to 0 just before (none may launch); then
    ``busy_steps`` under the profiler. -> its stats."""
    from nezha_tpu_torch.cli.train import build_config
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.ops.cuda.layer_norm import LAUNCHES as LN_LAUNCHES
    from nezha_tpu_torch.train import Trainer

    warmup = 2
    cfg = build_config(name, steps=warmup + n_steps + busy_steps, seed=0,
                       device="cuda")
    trainer = Trainer(cfg.model, cfg.optimizer, cfg.loss_fn, log_every=0,
                      examples_per_step=batch)
    batches = cfg.batches(batch)
    trainer.fit(batches, warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counts in (LAUNCHES, LN_LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    last = trainer.fit(batches, n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: n for counts in (LAUNCHES, LN_LAUNCHES)
                for k, n in counts.items() if n}
    if launched:
        fail(f"train_image: the port's kernels launched on the {name} "
             f"path: {launched}")
    if not math.isfinite(last["loss"]):
        fail(f"train_image: {name} loss {last['loss']}")
    step_flops = flops_per_image * (IMG_SIZE / 224) ** 2 * batch
    stats = {"config": name, "B": batch, "image_size": IMG_SIZE,
             "stem": "s2d", "policy": "bf16", "steps": n_steps,
             "ms_per_step": wall / n_steps * 1e3,
             "images_per_s": batch * n_steps / wall,
             "mfu": step_flops * n_steps / wall / BF16_FLOPS_PER_S,
             "step_tflop": step_flops / 1e12,
             "params": sum(p.numel() for p in cfg.model.parameters()),
             "last_loss": last["loss"],
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
             "card": card}
    if busy_steps:
        stats.update(profiled_busy_share(trainer, batches, busy_steps))
    del trainer, cfg, batches
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def train_image(card: str) -> dict:
    """Phase 4b (see the module docstring). -> its summary."""
    from nezha_tpu_torch.cli.train import build_config
    from nezha_tpu_torch.data import mnist_batches, synthetic_image_batches
    from nezha_tpu_torch.optim import momentum
    from nezha_tpu_torch.train import Trainer, evaluate, make_train_step

    t_phase = time.perf_counter()
    # (a) bf16 against fp32, one step.
    check = next(synthetic_image_batches(IMG_CHECK_B, IMG_SIZE, seed=0))
    print(json.dumps({"train_image_bf16_vs_fp32": compare_image_steps(
        check)}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the loss on one fixed batch falls at a constant lr.
    cfg = build_config("resnet50_imagenet", seed=0, device="cuda")
    step = make_train_step(cfg.model, momentum(0.1, beta=0.9,
                                               weight_decay=1e-4),
                           cfg.loss_fn)
    losses = [step(check)["loss"].item() for _ in range(10)]
    if not (all(map(math.isfinite, losses))
            and losses[-1] <= losses[0] - IMG_LOSS_DROP):
        fail(f"train_image: fixed-batch loss did not fall by "
             f"{IMG_LOSS_DROP}: {losses}")
    print(json.dumps({"image_fixed_batch_losses": losses}), flush=True)
    del step, cfg
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the main path: Trainer.fit at the config's shape and optimizer.
    stats = timed_image_fit("resnet50_imagenet", IMG_B, 10,
                            IMG_FLOPS_PER_IMAGE, card, busy_steps=3)
    print(json.dumps({"train_image": stats}), flush=True)
    # (d) wrn101_large_batch the same way, at bench.py's batch.
    wrn = timed_image_fit("wrn101_large_batch", WRN_B, 5,
                          WRN_FLOPS_PER_IMAGE, card)
    print(json.dumps({"train_image_wrn101": wrn}), flush=True)

    # (e) mlp_mnist on the synthetic set (no MNIST files in the checkout).
    os.environ["NEZHA_DATA_DIR"] = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "no_mnist")
    cfg = build_config("mlp_mnist", seed=0, device="cuda")
    trainer = Trainer(cfg.model, cfg.optimizer, cfg.loss_fn, log_every=0)
    t0 = time.perf_counter()
    last = trainer.fit(cfg.batches(cfg.default_batch), MLP_STEPS)
    torch.cuda.synchronize()
    mlp_wall = time.perf_counter() - t0
    result = evaluate(cfg.model, mnist_batches(256, split="test", epochs=1))
    if not result["accuracy"] >= MLP_MIN_ACCURACY:
        fail(f"train_image: mlp_mnist test accuracy {result['accuracy']} "
             f"after {MLP_STEPS} steps (at least {MLP_MIN_ACCURACY})")
    mlp = {"steps": MLP_STEPS, "B": cfg.default_batch,
           "last_loss": last["loss"], "test": result,
           "ms_per_step": mlp_wall / MLP_STEPS * 1e3, "card": card}
    print(json.dumps({"mlp_mnist": mlp}), flush=True)
    summary = {"wall_s": time.perf_counter() - t_phase,
               "images_per_s": stats["images_per_s"],
               "ms_per_step": stats["ms_per_step"], "mfu": stats["mfu"],
               "device_busy_share": stats["device_busy_share"],
               "wrn101_images_per_s": wrn["images_per_s"],
               "wrn101_ms_per_step": wrn["ms_per_step"],
               "wrn101_mfu": wrn["mfu"],
               "wrn101_peak_mem_gb": wrn["peak_mem_gb"],
               "mlp_accuracy": result["accuracy"]}
    print(json.dumps({"train_image_summary": summary}), flush=True)
    return summary


DC_STEPS, DC_MORE = 20, 10        # GPT-2: steps, then resumed steps
DC_LOG_EVERY = 5                  # the first GPT-2 run's log windows
DC_BPE_MERGES, DC_WP_VOCAB = 1000, 3000
DC_AB_STEPS, DC_BUSY_STEPS = 5, 3
DC_IMG_RECORDS, DC_VAL_RECORDS, DC_IMG_PX = 256, 64, 256
DC_GEN_NEW = 32
DC_PROMPTS = ["def main(", "class Trainer:", "import torch\n",
              "The checkpoint"]


def module_run(module: str, *argv, timeout: int = 600,
               counts: str = None):
    """``python -m nezha_tpu_torch.cli.<module>`` from the checkout's
    root: -> (stdout lines, stderr lines, wall seconds); fails unless it
    exits 0. With ``counts`` (the train CLI only) the run is a
    ``chip_smoke.py --train-rank COUNTS`` process, which writes its
    kernel counts there."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = ([sys.executable, "-m", f"nezha_tpu_torch.cli.{module}"]
           if counts is None else
           [sys.executable, os.path.abspath(__file__), "--train-rank",
            counts, "--"])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd + list(argv),
                          capture_output=True, text=True, timeout=timeout,
                          cwd=root, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{module} CLI {' '.join(argv)}: rc {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    return proc.stdout.splitlines(), proc.stderr.splitlines(), wall


def json_lines(lines, key: str) -> list:
    """The ``key`` field of every JSON line that has it."""
    out = []
    for line in lines:
        if line.startswith("{"):
            obj = json.loads(line)
            if key in obj:
                out.append(obj[key])
    return out


def train_in_process(*argv):
    """``cli.train.main(argv)`` in this process, its stdout and stderr
    captured, every kernel count set to 0 just before: -> (stdout lines,
    stderr lines, wall seconds, ended by a sync); fails unless it returns
    0. Its model and loaders are freed after it."""
    import io

    from nezha_tpu_torch.cli import train as train_cli

    out, err = io.StringIO(), io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = train_cli.main(list(argv))
        torch.cuda.synchronize()
    except SystemExit as e:
        fail(f"train CLI in-process {' '.join(argv)}: {e}: "
             f"{err.getvalue()[-3000:]}")
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"train CLI in-process {' '.join(argv)}: rc {rc}")
    gc.collect()
    torch.cuda.empty_cache()
    return out.getvalue().splitlines(), err.getvalue().splitlines(), wall


def cli_run(*argv, counts: str = None, in_process: bool = False) -> dict:
    """The train CLI on the card with ``argv``: -> its argv, wall
    seconds, final metrics, last eval, saves, restores, metric lines and
    stderr, and its kernel launches when run ``in_process`` (its ``main``
    in this process: no interpreter or card context to start) or given
    ``counts`` (a file path: the run is then a ``chip_smoke.py
    --train-rank`` process, else a ``python -m`` one). Fails unless it
    exits 0 with a finite loss."""
    launches = None
    if in_process:
        out, err, wall = train_in_process(*argv)
        launches = read_counts()
    else:
        out, err, wall = module_run("train", *argv, counts=counts)
    final = json.loads(out[-1])["final"]
    if not math.isfinite(final.get("loss", math.nan)):
        fail(f"train CLI {' '.join(argv)}: final {final}")
    evals = json_lines(err, "eval")
    run = {"argv": list(argv), "wall_s": wall, "final": final,
           "eval": evals[-1] if evals else None,
           "saves": json_lines(err, "save"),
           "restores": json_lines(err, "restore"),
           "logs": [json.loads(line) for line in err
                    if line.startswith('{"loss"')], "stderr": err}
    if counts is not None:
        with open(counts) as f:
            launches = json.load(f)
    if launches is not None:
        run["launches"] = launches
    return run


def train_cli() -> dict:
    """Phase 4c (see the module docstring). -> the two runs."""
    bert = cli_run("--config", "bert_base_zero1", "--steps", "20",
                   "--eval-batches", "2", "--eval", in_process=True)
    if not (bert["eval"] and bert["eval"]["batches"] == 2
            and math.isfinite(bert["final"].get("eval_perplexity",
                                                math.nan))):
        fail(f"train CLI bert_base_zero1: eval {bert}")
    wrn = cli_run("--config", "wrn101_large_batch", "--batch-size",
                  str(WRN_B), "--steps", "5", in_process=True)
    out = {name: {k: run[k] for k in ("argv", "wall_s", "final", "eval")}
           for name, run in (("bert_base_zero1", bert),
                             ("wrn101_large_batch", wrn))}
    print(json.dumps({"train_cli": out}), flush=True)
    return out


PF_DEPTH = 2                     # --prefetch's default
PF_CHECK_STEPS = 3               # steps of the bitwise loss check
PF_TRACE_STEPS = 2               # steps under the profiler for the streams
ACCUM_B, ACCUM_N = WRN_B, 8      # wrn101_large_batch 64 x 8 = 512
FLAG_STEPS = 6                   # the GPT-2 run with every new flag
SH_NEW = 32                      # greedy tokens from the per-shard save
SH_PROMPTS = [[464, 2068, 7586, 21831], [15496, 995], [40, 716, 257],
              [2, 4, 6, 8, 10, 12, 14, 16]]


def copy_streams(prof, tmp: str) -> dict:
    """From a profile's Chrome trace: the streams of the host-to-device
    copies and of the kernels, and whether every copy ran on a stream
    that ran no kernel (the prefetcher's side stream)."""
    path = f"{tmp}/streams.json"
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    copies, kernels = set(), set()
    n_copies = 0
    for e in events:
        stream = e.get("args", {}).get("stream")
        if stream is None:
            continue
        if "Memcpy HtoD" in e.get("name", ""):
            copies.add(stream)
            n_copies += 1
        elif e.get("cat") == "kernel":
            kernels.add(stream)
    return {"htod_copies": n_copies, "copy_streams": sorted(copies),
            "kernel_streams": sorted(kernels),
            "copies_on_side_stream": bool(copies)
            and not copies & kernels}


def prefetch_ab(card: str) -> dict:
    """(a) ResNet-50 (the config's model and momentum) at batch IMG_B,
    224 px, fed the same four batches bare (the step's pageable copy) and
    through ``Prefetcher`` (pinned memory, a side stream): the first
    batches bitwise equal to ``batch_to_device``'s; from one snapshot,
    PF_CHECK_STEPS steps' losses bitwise equal (cuDNN deterministic);
    then ABBA windows (``ab_rates``) and a short profile of each stream
    for the streams its copies ran on."""
    import itertools
    import tempfile

    from nezha_tpu_torch.cli.train import build_config
    from nezha_tpu_torch.runtime import Prefetcher
    from nezha_tpu_torch.train import Trainer, batch_to_device

    cfg = build_config("resnet50_imagenet", steps=100, seed=0, device="cuda")
    pool = list(itertools.islice(cfg.batches(IMG_B), 4))
    trainer = Trainer(cfg.model, cfg.optimizer, cfg.loss_fn, log_every=0)
    dev = torch.device("cuda", torch.cuda.current_device())
    check = Prefetcher(iter(pool), depth=PF_DEPTH, device=dev)
    for i, b in enumerate(check):
        want = batch_to_device(pool[i], dev)
        if b.keys() != want.keys() or not all(
                b[k].dtype == want[k].dtype and torch.equal(b[k], want[k])
                for k in want):
            fail(f"train_flags prefetch: batch {i} differs from "
                 f"batch_to_device's")
    check.close()

    snapshot = {k: v.clone() for k, v in cfg.model.state_dict().items()}
    opt0 = trainer.step_fn.opt_state

    def losses(stream) -> list:
        cfg.model.load_state_dict(snapshot)
        trainer.step_fn.opt_state = opt0
        return [trainer.step_fn(next(stream))["loss"].item()
                for _ in range(PF_CHECK_STEPS)]

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        bare = losses(iter(pool))
        pf = Prefetcher(iter(pool), depth=PF_DEPTH, device=dev)
        pre = losses(pf)
        pf.close()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    if bare != pre:
        fail(f"train_flags prefetch: losses bare {bare} vs prefetched "
             f"{pre}")
    cfg.model.load_state_dict(snapshot)
    trainer.step_fn.opt_state = opt0

    pf = Prefetcher(itertools.cycle(pool), depth=PF_DEPTH, device=dev)
    streams = {"bare": itertools.cycle(pool), "prefetch": pf}
    rates = ab_rates(trainer, streams, IMG_B, "images_per_s")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    seen = {}
    with tempfile.TemporaryDirectory(prefix="nezha_prefetch_") as tmp:
        for name, stream in streams.items():
            with torch.profiler.profile(activities=acts) as prof:
                trainer.fit(stream, PF_TRACE_STEPS)
                torch.cuda.synchronize()
            seen[name] = copy_streams(prof, tmp)
    pf.close()
    if not seen["prefetch"]["copies_on_side_stream"]:
        fail(f"train_flags prefetch: the prefetched copies did not run on "
             f"a side stream: {seen['prefetch']}")
    out = {"B": IMG_B, "image_size": IMG_SIZE, "depth": PF_DEPTH,
           "losses_bitwise_equal": bare, "rates": rates,
           "prefetch_over_bare": rates["prefetch"]["images_per_s"]
           / rates["bare"]["images_per_s"],
           "streams": seen, "stalls": pf.stalls,
           "stall_seconds": pf.stall_seconds, "card": card}
    del trainer, cfg, pool, streams, pf, snapshot, opt0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def grad_accum_wrn(card: str, tmp: str) -> dict:
    """(b) ``wrn101_large_batch --batch-size 64 --grad-accum 8`` through
    the CLI (in-process) for two flushes: a forward pre-hook on the
    model reads its parameters at each step's start, so step i's update
    shows between reads i and i + 1; the parameters must not move on the
    seven hold steps and must move on each flush."""
    from nezha_tpu_torch.cli import train as train_cli
    from nezha_tpu_torch.models.resnet import ResNet
    from nezha_tpu_torch.obs import read_metrics

    seen = {"prev": None, "moved": [], "model": None}

    def read(model) -> None:
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])
        if seen["prev"] is not None:
            seen["moved"].append(not torch.equal(flat, seen["prev"]))
        seen["prev"], seen["model"] = flat, model

    def hook(module, args):
        if isinstance(module, ResNet):
            read(module)

    metrics = f"{tmp}/wrn_accum.jsonl"
    steps = 2 * ACCUM_N
    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    t0 = time.perf_counter()
    try:
        _, out = cli_stdout(train_cli.main, [
            "--config", "wrn101_large_batch", "--batch-size", str(ACCUM_B),
            "--grad-accum", str(ACCUM_N), "--steps", str(steps),
            "--log-every", str(ACCUM_N), "--metrics-file", metrics])
    finally:
        handle.remove()
    wall = time.perf_counter() - t0
    read(seen["model"])
    want = ([False] * (ACCUM_N - 1) + [True]) * 2
    if seen["moved"] != want:
        fail(f"train_flags grad-accum: parameters moved at steps "
             f"{seen['moved']}, expected {want}")
    final = json.loads(out[-1])["final"]
    if not math.isfinite(final.get("loss", math.nan)):
        fail(f"train_flags grad-accum: final {final}")
    lines = [r for r in read_metrics(metrics) if "loss" in r]
    res = {"B": ACCUM_B, "grad_accum": ACCUM_N, "effective_batch":
           ACCUM_B * ACCUM_N, "steps": steps, "moved": seen["moved"],
           "windows": [{k: r[k] for k in ("step", "loss", "steps_per_sec",
                                          "examples_per_sec")}
                       for r in lines],
           "wall_s": wall, "card": card}
    seen.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return res


def gpt2_flags(card: str, tmp: str):
    """(c) GPT-2 124M through the CLI (in-process) with every new flag:
    ``--optimizer lamb --lr 6e-4 --grad-accum 2 --metrics-file
    --log-memory --log-every 2 --profile-dir --profile-steps 2:2``: the
    JSONL carries the card's memory, the trace exists and names the flash
    kernels; the port's kernel counts of the run. Then one short run each
    of ``--optimizer adafactor`` and ``lars`` on the tiny ResNet (conv
    kernels, Adafactor's HWIO factoring). -> (the counts, a summary)."""
    from nezha_tpu_torch.cli import train as train_cli
    from nezha_tpu_torch.obs import read_metrics

    metrics, prof_dir = f"{tmp}/gpt2_flags.jsonl", f"{tmp}/gpt2_trace"
    zero_counts()
    t0 = time.perf_counter()
    _, out = cli_stdout(train_cli.main, [
        "--config", "gpt2_124m", "--steps", str(FLAG_STEPS), "--optimizer",
        "lamb", "--lr", "6e-4", "--grad-accum", "2", "--metrics-file",
        metrics, "--log-memory", "--log-every", "2", "--profile-dir",
        prof_dir, "--profile-steps", "2:2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    final = json.loads(out[-1])["final"]
    lines = [r for r in read_metrics(metrics) if "loss" in r]
    if [r["step"] for r in lines] != list(range(2, FLAG_STEPS + 1, 2)) or \
            not all(isinstance(r.get(k), int) and r[k] > 0 for r in lines
                    for k in ("hbm_bytes_in_use", "hbm_peak_bytes")):
        fail(f"train_flags gpt2: metrics lines {lines}")
    traces = os.listdir(prof_dir)
    if traces != [f"trace_steps3-4_pid{os.getpid()}.json"]:
        fail(f"train_flags gpt2: traces {traces}")
    with open(f"{prof_dir}/{traces[0]}") as f:
        text = f.read()
    named = {k: text.count(k) for k in ("flash_fwd_", "flash_bwd_dq_",
                                        "flash_bwd_dkv_")}
    if not all(named.values()):
        fail(f"train_flags gpt2: the trace names {named}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] != 12 * FLAG_STEPS:
            fail(f"train_flags gpt2: {name} launched {launches[name]} "
                 f"times in {FLAG_STEPS} steps")
    small = {}
    for opt, lr in (("adafactor", "0.01"), ("lars", "1.0")):
        _, o = cli_stdout(train_cli.main, [
            "--config", "resnet50_imagenet", "--model-preset", "tiny",
            "--batch-size", "32", "--steps", "4", "--optimizer", opt,
            "--lr", lr, "--log-every", "0"])
        small[opt] = json.loads(o[-1])["final"]
        if not math.isfinite(small[opt].get("loss", math.nan)):
            fail(f"train_flags {opt}: final {small[opt]}")
    res = {"final": final, "wall_s": wall, "windows": lines,
           "trace": {"file": traces[0], "bytes": len(text),
                     "kernel_name_counts": named},
           "tiny_resnet": small, "card": card}
    del text
    gc.collect()
    torch.cuda.empty_cache()
    return launches, res


def gpt2_saves(dirs: dict, what: str) -> list:
    """GPT-2 124M (the config's AdamW), two ZeRO-1 steps at world 1 (the
    coordinator and NCCL) saved per shard into ``dirs["sharded"]``
    (``step_2.sharded``), and the same weights as a dense npz into
    ``dirs["dense"]``; -> the per-shard save's records."""
    import torch.distributed as tdist

    from nezha_tpu_torch import dist as nzdist
    from nezha_tpu_torch.cli.train import build_config
    from nezha_tpu_torch.models.convert import train_state_to_jax
    from nezha_tpu_torch.parallel.zero1 import Zero1TrainStep
    from nezha_tpu_torch.train import Trainer
    from nezha_tpu_torch.train import checkpoint as ckpt

    coord = nzdist.Coordinator(world_size=1)
    group = nzdist.join("127.0.0.1", coord.port)
    try:
        nzdist.init_torch_distributed(group, "nccl")
        cfg = build_config("gpt2_124m", steps=100, seed=0, device="cuda")
        step = Zero1TrainStep(cfg.model, cfg.optimizer, cfg.loss_fn)
        trainer = Trainer(cfg.model, cfg.optimizer, cfg.loss_fn,
                          checkpoint_dir=dirs["sharded"], log_every=0,
                          step_fn=step)
        trainer.fit(cfg.batches(TRAIN_B), 2)
        trainer.save()
        trainer.wait_saves()
        ckpt.save_checkpoint(dirs["dense"], train_state_to_jax(
            cfg.model, rng=trainer.rng), trainer.global_step)
        saves = trainer.saves
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        group.leave()
        coord.stop()
    if os.listdir(dirs["sharded"]) != ["step_00000002.sharded"]:
        fail(f"{what}: {os.listdir(dirs['sharded'])}")
    del trainer, step, cfg
    gc.collect()
    torch.cuda.empty_cache()
    return saves


def sharded_generate_serve(card: str, tmp: str):
    """(d) GPT-2 124M: two ZeRO-1 steps at world 1 (the coordinator and
    NCCL) saved per shard (``step_2.sharded``, the config's AdamW), and
    the same weights as a dense npz; the generate CLI (``--ln-impl
    pallas``) and the serve CLI from each: the greedy tokens equal. ->
    (the per-shard runs' counts, a summary)."""
    import io

    from nezha_tpu_torch.cli import generate as gen_cli
    from nezha_tpu_torch.cli import serve as serve_cli

    dirs = {"sharded": f"{tmp}/gpt2_sharded", "dense": f"{tmp}/gpt2_dense"}
    saves = gpt2_saves(dirs, "train_flags sharded")
    tokens, launches = {}, {}
    reqs = "".join(json.dumps({"id": f"p{i}", "prompt_tokens": p,
                               "max_new_tokens": SH_NEW}) + "\n"
                   for i, p in enumerate(SH_PROMPTS))
    for name, d in dirs.items():
        argv = ["--ckpt-dir", d, "--prompt-tokens",
                ",".join(map(str, SH_PROMPTS[0])), "--max-new-tokens",
                str(SH_NEW), "--temperature", "0", "--ln-impl", "pallas",
                "--eos-id", "-1"]
        zero_counts()
        got, _ = cli_stdout(gen_cli.run, gen_cli.build_parser().parse_args(
            argv))
        torch.cuda.synchronize()
        launches[f"{name}_generate"] = read_counts()
        args = serve_cli.build_parser().parse_args([
            "--ckpt-dir", d, "--max-len", "128", "--max-prefill-len", "32",
            "--eos-id", "-1"])
        sched = serve_cli.build_scheduler(args)
        out = io.StringIO()
        zero_counts()
        serve_cli.run_stdio(sched, args, stdin=io.StringIO(reqs),
                            stdout=out)
        torch.cuda.synchronize()
        launches[f"{name}_serve"] = read_counts()
        res = {r["id"]: r for r in map(json.loads,
                                       out.getvalue().splitlines())}
        if len(res) != len(SH_PROMPTS) or any(
                r["event"] != "done" for r in res.values()):
            fail(f"train_flags sharded serve from {name}: {res}")
        tokens[name] = {"generate": got["tokens"],
                        "serve": {k: r["tokens"] for k, r in res.items()}}
        del sched
        gc.collect()
    if tokens["sharded"] != tokens["dense"]:
        fail(f"train_flags sharded: tokens {tokens}")
    for name in ("flash_fwd", "flash_decode", "layer_norm_fwd"):
        if launches["sharded_generate"][name] <= 0:
            fail(f"train_flags sharded generate: {name} not launched")
    for name in ("paged_decode", "paged_prefill"):
        if launches["sharded_serve"][name] <= 0:
            fail(f"train_flags sharded serve: {name} not launched")
    torch.cuda.empty_cache()
    return launches, {"save": saves[-1], "tokens_equal": True,
                      "generate_tokens": tokens["sharded"]["generate"],
                      "card": card}


def train_flags(card: str) -> dict:
    """Phase 4f (see the module docstring). -> the kernel counts of its
    GPT-2 flag run and its per-shard generate and serve runs."""
    import tempfile

    t0 = time.perf_counter()
    out = {"prefetch": prefetch_ab(card)}
    print(json.dumps({"train_flags_prefetch": out["prefetch"]}), flush=True)
    with tempfile.TemporaryDirectory(prefix="nezha_train_flags_") as tmp:
        out["grad_accum"] = grad_accum_wrn(card, tmp)
        print(json.dumps({"train_flags_grad_accum": out["grad_accum"]}),
              flush=True)
        flag_launches, out["gpt2"] = gpt2_flags(card, tmp)
        print(json.dumps({"train_flags_gpt2": out["gpt2"]}), flush=True)
        sh_launches, out["sharded"] = sharded_generate_serve(card, tmp)
        print(json.dumps({"train_flags_sharded": out["sharded"]}),
              flush=True)
    print(json.dumps({"train_flags_wall_s": time.perf_counter() - t0}),
          flush=True)
    return {"train_cli_flags": flag_launches,
            "sharded_generate": sh_launches["sharded_generate"],
            "sharded_serve": sh_launches["sharded_serve"]}


def pack_corpora(tmp: str) -> dict:
    """The GPT-2 corpus (a learned BPE over the port and docs/, held-out
    tools/ and the README), and the BERT corpus (a learned WordPiece over
    the same sources), each through the pack CLI's ``main`` in this
    process."""
    from nezha_tpu_torch.cli import pack_text as pack_cli

    root = os.path.dirname(os.path.abspath(__file__))
    train_src = [os.path.join(root, "nezha_tpu_torch"),
                 os.path.join(root, "docs")]
    val_src = [os.path.join(root, "tools"), os.path.join(root, "README.md")]
    packs = {}
    for name, learn, n in (("gpt", "--learn-bpe", DC_BPE_MERGES),
                           ("bert", "--learn-wordpiece", DC_WP_VOCAB)):
        tok, data = f"{tmp}/tok_{name}", f"{tmp}/data_{name}"
        t0 = time.perf_counter()
        _, out = cli_stdout(pack_cli.main, [
            *train_src, learn, str(n), "--save-tokenizer", tok, "--out",
            f"{data}/train.tokens.u16"])
        wall = time.perf_counter() - t0
        train = json.loads(out[-1])
        _, out = cli_stdout(pack_cli.main, [
            *val_src, "--tokenizer", tok, "--out",
            f"{data}/val.tokens.u16"])
        packs[name] = {"tokenizer": tok, "data": data, "train": train,
                       "val": json.loads(out[-1]), "wall_s": wall}
    print(json.dumps({"data_ckpt_pack": packs}), flush=True)
    return packs


def check_two_left(ckpt_dir: str, want) -> None:
    left = sorted(p for p in os.listdir(ckpt_dir) if p.endswith(".npz"))
    if left != [f"step_{s:08d}.npz" for s in want]:
        fail(f"data_ckpt: {ckpt_dir} holds {left}, expected steps {want}")


def check_train_run_dir(run_dir: str, run: dict, steps: int) -> dict:
    """(b)'s ``--run-dir``: the port's ``nezha-telemetry --check``
    passes; the report's step-rate windows are the CLI's logged windows,
    and its tokens/s per chip mean is theirs; ``train.first_step`` and
    ``checkpoint.save`` are among the spans; ``train.steps`` is the steps
    run; B1-B3 launched 12 a step and B4/B5 25 a step, B1 and B4 a
    forward's worth more each eval batch. -> what it read."""
    from nezha_tpu_torch.cli import telemetry as telemetry_cli
    from nezha_tpu_torch.obs import read_metrics, report

    rc, _ = cli_stdout(telemetry_cli.main, [run_dir, "--check"])
    if rc != 0:
        fail(f"data_ckpt run dir: nezha-telemetry --check exited {rc}")
    text = report.render_report(run_dir)
    m = re.search(r"step rate \(steps/sec over (\d+) windows\)", text)
    logs = run["logs"]
    if not m or int(m.group(1)) != len(logs):
        fail(f"data_ckpt run dir: the report's windows "
             f"{m and m.group(1)}, the CLI logged {len(logs)}")
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    mean = summary["histograms"]["metric.tokens_per_sec_per_chip"]["mean"]
    want = sum(r["tokens_per_sec_per_chip"] for r in logs) / len(logs)
    if not math.isclose(mean, want, rel_tol=1e-12):
        fail(f"data_ckpt run dir: tokens/s per chip mean {mean}, the "
             f"CLI's lines {want}")
    spans = [r["name"] for r in read_metrics(
        os.path.join(run_dir, "spans.jsonl"))]
    if "train.first_step" not in spans or "checkpoint.save" not in spans:
        fail(f"data_ckpt run dir: spans {sorted(set(spans))}")
    if summary["counters"]["train.steps"] != steps:
        fail(f"data_ckpt run dir: train.steps "
             f"{summary['counters']['train.steps']}, ran {steps}")
    evals = run["eval"]["batches"]
    want = {"flash_fwd": 12 * (steps + evals), "flash_bwd_dq": 12 * steps,
            "flash_bwd_delta": 12 * steps, "flash_bwd_dkv": 12 * steps,
            "layer_norm_fwd": 25 * (steps + evals),
            "layer_norm_bwd": 25 * steps,
            "layer_norm_bwd_sums": 25 * steps}
    got = {k: run["launches"][k] for k in want}
    if got != want:
        fail(f"data_ckpt run dir: launches {got}, expected {want}")
    return {"windows": len(logs), "tokens_per_sec_per_chip_mean": mean,
            "train_steps": steps, "spans": sorted(set(spans)),
            "first_step_s": next(
                r["dur_s"] for r in read_metrics(os.path.join(
                    run_dir, "spans.jsonl"))
                if r["name"] == "train.first_step"),
            "launches": got, "wall_s": run["wall_s"]}


def resumed(run: dict, step: int) -> None:
    if f"resumed from step {step}" not in run["stderr"]:
        fail(f"data_ckpt: no 'resumed from step {step}' line: "
             f"{run['stderr'][-5:]}")


def ab_rates(trainer, streams: dict, per_step: int, unit: str) -> dict:
    """One trainer fed by two streams in turn: 2 warm-up steps from each,
    then DC_AB_STEPS timed steps in the order A, B, B, A (host clock,
    ended by a sync; ``per_step`` tokens or images a step), then
    DC_BUSY_STEPS profiled steps of each. -> {stream: rate, ms per step
    (each window), busy share}."""
    names = list(streams)
    for name in names:
        trainer.fit(streams[name], 2)
    windows = {name: [] for name in names}
    for name in names + names[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(streams[name], DC_AB_STEPS)
        torch.cuda.synchronize()
        windows[name].append((time.perf_counter() - t0) / DC_AB_STEPS)
    return {name: {unit: per_step * len(w) / sum(w),
                   "ms_per_step_windows": [t * 1e3 for t in w],
                   **profiled_busy_share(trainer, streams[name],
                                         DC_BUSY_STEPS)}
            for name, w in windows.items()}


def gpt2_ab_and_round_trip(packs: dict, tmp: str, card: str) -> dict:
    """In-process, full-width GPT-2 (the config's model and AdamW) at
    batch 8: tokens/s and the device's busy share from disk against the
    synthetic stream (``ab_rates``), then the exact round trip: the loss of a fixed
    batch, save, restore into a fresh module and optimizer (every leaf
    bitwise, the loss bitwise), one more step from both (weights
    bitwise)."""
    from nezha_tpu_torch.cli import train as train_cli
    from nezha_tpu_torch.models.convert import train_state_template
    from nezha_tpu_torch.train import Trainer
    from nezha_tpu_torch.train import checkpoint as ckpt

    args = train_cli.parse_args(["--config", "gpt2_124m", "--data-dir",
                                 packs["gpt"]["data"]])
    cfg = train_cli.build_config("gpt2_124m", steps=100)
    trainer = Trainer(cfg.model, cfg.optimizer, cfg.loss_fn, log_every=0)
    disk, close = train_cli.data_source(args, cfg, TRAIN_B)
    rates = ab_rates(trainer, {"disk": disk,
                               "synthetic": cfg.batches(TRAIN_B)},
                     TRAIN_B * TRAIN_S, "tokens_per_s")
    close()

    # The round trip, on the A/B trainer's state.
    fixed = next(cfg.batches(TRAIN_B))
    step_batch = next(cfg.batches(TRAIN_B))

    def fixed_loss(model):
        batch = {"tokens": torch.as_tensor(fixed["tokens"]).long().cuda()}
        model.train()
        with torch.no_grad():
            return cfg.loss_fn(model(batch), batch).float()

    before = fixed_loss(trainer.model)
    d = f"{tmp}/round_trip"
    trainer.checkpoint_dir = d
    path = trainer.save()
    saved = ckpt.verify_checkpoint(d, trainer.global_step)
    fresh_cfg = train_cli.build_config("gpt2_124m", steps=100, seed=1)
    fresh = Trainer(fresh_cfg.model, cfg.optimizer, cfg.loss_fn,
                    checkpoint_dir=d, log_every=0)
    fresh.initialize()
    restore = fresh.last_restore
    mine = fresh.state_dict()
    if mine.keys() != saved.keys() or set(saved) != set(
            train_state_template(fresh.model, fresh.step_fn.opt_state)):
        fail("data_ckpt round trip: leaf sets differ")
    unequal = [k for k in saved if not (
        mine[k].dtype == saved[k].dtype
        and np.array_equal(mine[k], saved[k]))]
    if unequal:
        fail(f"data_ckpt round trip: {len(unequal)} restored leaves differ "
             f"from the saved ones: {unequal[:5]}")
    after = fixed_loss(fresh.model)
    if not torch.equal(before, after):
        fail(f"data_ckpt round trip: fixed-batch loss {before.item()!r} "
             f"before the save, {after.item()!r} after the restore")
    trainer.fit(iter([step_batch]), 1)
    fresh.fit(iter([step_batch]), 1)
    a, b = trainer.model.state_dict(), fresh.model.state_dict()
    worst = max((a[k].float() - b[k].float()).abs().max().item()
                for k in a)
    if worst != 0.0:
        fail(f"data_ckpt round trip: one more step from both states: "
             f"weights differ by up to {worst}")
    out = {"rates": rates,
           "disk_over_synthetic": rates["disk"]["tokens_per_s"]
           / rates["synthetic"]["tokens_per_s"],
           "round_trip": {"leaves": len(saved), "bytes":
                          os.path.getsize(path),
                          "save_s": trainer.saves[-1]["seconds"],
                          "restore_s": restore["seconds"],
                          "fixed_loss": before.item(),
                          "step_after_restore_max_weight_diff": worst},
           "card": card}
    del trainer, fresh, cfg, fresh_cfg, saved, mine, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return out


def image_records(tmp: str) -> str:
    """train.nzr and val.nzr from seeded 256 px images, written by the
    port's ImageRecordWriter."""
    from nezha_tpu_torch.data.native import ImageRecordWriter

    d = f"{tmp}/data_img"
    os.makedirs(d, exist_ok=True)
    r = np.random.RandomState(0)
    for name, n in (("train.nzr", DC_IMG_RECORDS),
                    ("val.nzr", DC_VAL_RECORDS)):
        with ImageRecordWriter(f"{d}/{name}", DC_IMG_PX, DC_IMG_PX) as w:
            for i in range(n):
                w.append(r.randint(0, 256, (DC_IMG_PX, DC_IMG_PX, 3),
                                   dtype=np.uint8), i % 1000)
    return d


def image_ab(data: str, card: str) -> dict:
    """In-process ResNet-50 (the config's model and momentum) at batch
    IMG_B, 224 px: images/s from the records against the synthetic
    stream, each with its busy share (``ab_rates``)."""
    from nezha_tpu_torch.cli import train as train_cli
    from nezha_tpu_torch.train import Trainer

    args = train_cli.parse_args(["--config", "resnet50_imagenet",
                                 "--data-dir", data])
    cfg = train_cli.build_config("resnet50_imagenet", steps=100)
    trainer = Trainer(cfg.model, cfg.optimizer, cfg.loss_fn, log_every=0)
    disk, close = train_cli.data_source(args, cfg, IMG_B)
    rates = ab_rates(trainer, {"disk": disk,
                               "synthetic": cfg.batches(IMG_B)},
                     IMG_B, "images_per_s")
    close()
    del trainer, cfg
    gc.collect()
    torch.cuda.empty_cache()
    return {"rates": rates, "disk_over_synthetic":
            rates["disk"]["images_per_s"]
            / rates["synthetic"]["images_per_s"], "card": card}


def zero_counts() -> None:
    from nezha_tpu_torch.ops.cuda import (flash_decode_attention,
                                          paged_decode_attention,
                                          paged_prefill_attention)
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.ops.cuda.layer_norm import LAUNCHES as LN_LAUNCHES
    for c in (LAUNCHES, LN_LAUNCHES):
        for k in c:
            c[k] = 0
    for fn in (flash_decode_attention, paged_decode_attention,
               paged_prefill_attention):
        fn.launches = 0
    zero_serve_launches()


def read_counts() -> dict:
    from nezha_tpu_torch.ops.cuda import (flash_decode_attention,
                                          paged_decode_attention,
                                          paged_prefill_attention,
                                          paged_quant_decode_attention,
                                          paged_quant_prefill_attention)
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.ops.cuda.layer_norm import LAUNCHES as LN_LAUNCHES
    return {**LAUNCHES, **LN_LAUNCHES,
            "flash_decode": flash_decode_attention.launches,
            "paged_decode": paged_decode_attention.launches,
            "paged_prefill": paged_prefill_attention.launches,
            "paged_quant_decode": paged_quant_decode_attention.launches,
            "paged_quant_prefill": paged_quant_prefill_attention.launches}


def cli_stdout(fn, *args, **kw):
    """Call a CLI entry point in-process; -> (its return, its stdout
    lines)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args, **kw)
    return ret, buf.getvalue().splitlines()


def agree_to_divergence(what: str, reference, prompt, want, got,
                        atol: float = SERVE_LOGIT_ATOL):
    """``got``'s greedy tokens against ``want``'s after ``prompt``, up to
    the first difference, which must fall where ``reference``'s top-2
    margin (its no-cache forward over the prompt and ``want``) is within
    ``atol``. -> (tokens compared, tokens whose margin exceeds atol)."""
    seq = torch.tensor([list(prompt) + list(want[:-1])], device="cuda")
    ref = reference(seq)[0, len(prompt) - 1:].float()
    top2 = ref.topk(2, dim=-1).values
    compared = checked = 0
    for j, (a, b) in enumerate(zip(want, got)):
        margin = float(top2[j, 0] - top2[j, 1])
        compared += 1
        if a != b:
            if margin > atol:
                fail(f"{what}: token {j}: {b}, want {a}, margin {margin}")
            break
        checked += margin > atol
    return compared, checked


def generate_and_serve(packs: dict, ckpt_dir: str, card: str):
    """The generate CLI (``--ln-impl pallas``) and the serve CLI from the
    GPT-2 checkpoint with its tokenizer, in-process so that the launch
    counts and the profiler see them; serve's greedy tokens against
    ``models.generate``'s on the restored weights wherever the no-cache
    reference's top-2 margin exceeds SERVE_LOGIT_ATOL. -> (the two runs'
    launches, a summary)."""
    import io
    from nezha_tpu_torch.cli import generate as gen_cli
    from nezha_tpu_torch.cli import serve as serve_cli
    from nezha_tpu_torch.cli.common import load_gpt2_for_inference
    from nezha_tpu_torch.data.tokenizer import encode_plain, load_tokenizer
    from nezha_tpu_torch.models import generate

    tok_dir = packs["gpt"]["tokenizer"]
    tok = load_tokenizer(tok_dir)
    argv = ["--ckpt-dir", ckpt_dir, "--tokenizer", tok_dir, "--prompt",
            DC_PROMPTS[0], "--max-new-tokens", str(DC_GEN_NEW),
            "--temperature", "0", "--ln-impl", "pallas", "--eos-id", "-1"]
    gen_cli.run(gen_cli.build_parser().parse_args(argv))     # warm-up
    torch.cuda.synchronize()
    zero_counts()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got, _ = cli_stdout(gen_cli.run,
                            gen_cli.build_parser().parse_args(argv))
        torch.cuda.synchronize()
    gen_launches = read_counts()
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[kernel_name(e.key)] = by_kernel.get(
                kernel_name(e.key), 0) + e.count
    profiled = {k: n for k, n in by_kernel.items()
                if k.startswith(("flash_fwd", "flash_decode", "ln_fwd"))}
    for name in ("flash_fwd", "layer_norm_fwd", "flash_decode"):
        if gen_launches[name] <= 0:
            fail(f"data_ckpt generate: {name} not launched "
                 f"({gen_launches})")
    for prefix in ("flash_fwd", "flash_decode", "ln_fwd"):
        if not any(k.startswith(prefix) for k in profiled):
            fail(f"data_ckpt generate: the profiler saw no {prefix} "
                 f"kernel: {sorted(by_kernel)[:20]}")
    if (len(got["tokens"]) != DC_GEN_NEW or not isinstance(got["text"], str)
            or max(got["tokens"]) >= tok.vocab_size or got.get(
                "unknown_tokens")):
        fail(f"data_ckpt generate: {got}")

    args = serve_cli.build_parser().parse_args([
        "--ckpt-dir", ckpt_dir, "--tokenizer", tok_dir, "--max-len", "128",
        "--max-prefill-len", "32", "--eos-id", "-1"])
    sched = serve_cli.build_scheduler(args)
    reqs = [{"id": f"p{i}", "prompt": p, "max_new_tokens": DC_GEN_NEW}
            for i, p in enumerate(DC_PROMPTS)]
    out = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    serve_cli.run_stdio(sched, args, stdin=io.StringIO(
        "".join(json.dumps(r) + "\n" for r in reqs)), stdout=out,
        tokenizer=serve_cli.load_tokenizer_arg(args))
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_launches = read_counts()
    for name in ("paged_decode", "paged_prefill"):
        if serve_launches[name] <= 0:
            fail(f"data_ckpt serve: {name} not launched "
                 f"({serve_launches})")
    res = {r["id"]: r for r in map(json.loads, out.getvalue().splitlines())}
    if len(res) != len(reqs) or any(
            r["event"] != "done" or r["finish_reason"] != "length"
            or not isinstance(r["text"], str) for r in res.values()):
        fail(f"data_ckpt serve: {res}")
    del sched
    gc.collect()

    # Serve against generate, token by token up to the first divergence,
    # which must fall where the reference's top-2 margin is within
    # SERVE_LOGIT_ATOL.
    model = load_gpt2_for_inference(gen_cli.build_parser().parse_args(
        argv)).eval()
    reference = xla_reference(model)
    checked = compared = 0
    with torch.no_grad():
        for i, p in enumerate(DC_PROMPTS):
            ids = torch.tensor([encode_plain(tok, p)], device="cuda")
            g = generate(model, ids, DC_GEN_NEW)[0, ids.shape[1]:].tolist()
            n, k = agree_to_divergence(
                f"data_ckpt serve against generate, prompt {i}", reference,
                ids[0].tolist(), g, res[f"p{i}"]["tokens"])
            compared += n
            checked += k
    summary = {"generate": {"prompt": DC_PROMPTS[0], "tokens":
                            got["tokens"], "text": got["text"],
                            "profiled_launches": profiled},
               "serve": {"requests": len(res), "wall_s": serve_wall,
                         "texts": [res[f"p{i}"]["text"]
                                   for i in range(len(DC_PROMPTS))]},
               "serve_vs_generate": {"tokens_compared": compared,
                                     "tokens_checked": checked},
               "card": card}
    del model, reference
    gc.collect()
    torch.cuda.empty_cache()
    return {"generate": gen_launches, "serve": serve_launches}, summary


def data_ckpt(card: str):
    """Phase 4d (see the module docstring). -> (the launches of its
    generate and serve runs, its summary)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="nezha_data_ckpt_") as tmp:
        packs = pack_corpora(tmp)
        g = packs["gpt"]
        ck = f"{tmp}/ckpt_gpt2"
        common = ["--config", "gpt2_124m", "--data-dir", g["data"],
                  "--ckpt-dir", ck, "--ckpt-every", "10", "--ckpt-keep",
                  "2", "--eval", "--eval-batches", "4"]
        run_dir = f"{tmp}/run_gpt2"
        first = cli_run(*common, "--steps", str(DC_STEPS), "--ln-impl",
                        "pallas", "--log-every", str(DC_LOG_EVERY),
                        "--run-dir", run_dir, in_process=True)
        telemetry = check_train_run_dir(run_dir, first, DC_STEPS)
        print(json.dumps({"data_ckpt_run_dir": telemetry}), flush=True)
        second = cli_run(*common, "--steps", str(DC_MORE),
                         in_process=True)
        resumed(second, DC_STEPS)
        if second["final"]["step"] != DC_STEPS + DC_MORE or not \
                math.isfinite(second["final"].get("eval_perplexity",
                                                  math.nan)):
            fail(f"data_ckpt gpt2 resumed: final {second['final']}")
        check_two_left(ck, [DC_STEPS, DC_STEPS + DC_MORE])
        disk_cli_rate = first["logs"][-1].get("tokens_per_sec")
        gpt2 = {"first": {k: first[k] for k in ("wall_s", "final",
                                                "saves")},
                "second": {k: second[k] for k in ("wall_s", "final",
                                                  "saves", "restores")},
                "cli_disk_tokens_per_s": disk_cli_rate}
        print(json.dumps({"data_ckpt_gpt2": gpt2}), flush=True)

        inproc = gpt2_ab_and_round_trip(packs, tmp, card)
        print(json.dumps({"data_ckpt_gpt2_inprocess": inproc}), flush=True)

        b = packs["bert"]
        bck = f"{tmp}/ckpt_bert"
        bcommon = ["--config", "bert_base_zero1", "--data-dir", b["data"],
                   "--ckpt-dir", bck, "--ckpt-every", "10"]
        bfirst = cli_run(*bcommon, "--steps", "10", in_process=True)
        if not any("mlm: [MASK] id" in line for line in bfirst["stderr"]):
            fail("data_ckpt bert: [MASK] did not resolve from the sidecar")
        bsecond = cli_run(*bcommon, "--steps", "5", "--eval",
                          "--eval-batches", "2", in_process=True)
        resumed(bsecond, 10)
        bert = {"first": {k: bfirst[k] for k in ("wall_s", "final",
                                                 "saves")},
                "second": {k: bsecond[k] for k in ("wall_s", "final",
                                                   "saves", "restores")}}
        print(json.dumps({"data_ckpt_bert": bert}), flush=True)

        img = image_records(tmp)
        ick = f"{tmp}/ckpt_rn50"
        icommon = ["--config", "resnet50_imagenet", "--data-dir", img,
                   "--crop", "224", "--batch-size", str(IMG_B),
                   "--ckpt-dir", ick, "--ckpt-every", "10"]
        ifirst = cli_run(*icommon, "--steps", "10", in_process=True)
        isecond = cli_run(*icommon, "--steps", "5", "--eval",
                          in_process=True)
        resumed(isecond, 10)
        if not math.isfinite(isecond["final"].get("eval_accuracy",
                                                  math.nan)):
            fail(f"data_ckpt resnet50: final {isecond['final']}")
        rn50 = {"first": {k: ifirst[k] for k in ("wall_s", "final",
                                                 "saves")},
                "second": {k: isecond[k] for k in ("wall_s", "final",
                                                   "saves", "restores")},
                "in_process": image_ab(img, card)}
        print(json.dumps({"data_ckpt_resnet50": rn50}), flush=True)

        launches, gen_serve = generate_and_serve(packs, ck, card)
        launches["train"] = first["launches"]
        print(json.dumps({"data_ckpt_generate_serve": gen_serve}),
              flush=True)
    summary = {
        "gpt2_save_s": [s["seconds"] for s in first["saves"]
                        + second["saves"]],
        "gpt2_save_bytes": first["saves"][-1]["bytes"],
        "gpt2_restore_s": second["restores"][0]["seconds"],
        "gpt2_disk_tokens_per_s": inproc["rates"]["disk"]["tokens_per_s"],
        "gpt2_synthetic_tokens_per_s":
            inproc["rates"]["synthetic"]["tokens_per_s"],
        "gpt2_disk_busy": inproc["rates"]["disk"]["device_busy_share"],
        "gpt2_synthetic_busy":
            inproc["rates"]["synthetic"]["device_busy_share"],
        "rn50_disk_images_per_s":
            rn50["in_process"]["rates"]["disk"]["images_per_s"],
        "rn50_synthetic_images_per_s":
            rn50["in_process"]["rates"]["synthetic"]["images_per_s"],
        "round_trip_exact": True, "card": card}
    print(json.dumps({"data_ckpt_summary": summary}), flush=True)
    return launches, summary


def serve_prompts(vocab: int):
    """The serve phase's eight prompts: 5-900 tokens, two sharing a
    128-token prefix (seeded)."""
    g = torch.Generator().manual_seed(1)

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=g).tolist()

    prefix = toks(128)
    return [toks(5), toks(37), toks(200), toks(300), toks(600), toks(900),
            prefix + toks(20), prefix + toks(45)]


def serve(card: str, kv_dtype: str = "bf16"):
    """Eight greedy requests through Scheduler/Engine on a paged pool of
    ``kv_dtype``; -> the kernel launches of that run."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.serve import (Engine, FinishReason, Request,
                                       Scheduler, ServeConfig)

    model = gpt2_for_preset("full", seed=0, device="cuda")
    model.eval()
    cfg = ServeConfig(max_batch_size=8, max_len=1024, max_prefill_len=256,
                      kv_block_size=16, kv_dtype=kv_dtype)
    engine = Engine(model, cfg)
    sched = Scheduler(engine)
    reqs = [Request(prompt=p, max_new_tokens=32, request_id=f"r{i}")
            for i, p in enumerate(serve_prompts(model.cfg.vocab_size))]
    zero_serve_launches()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle(max_iters=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = engine.kernel_launches()
    if sched.has_work():
        fail("scheduler did not drain")
    int8 = kv_dtype == "int8"
    path = {"paged_quant_decode", "paged_quant_prefill"} if int8 else {
        "paged_decode", "paged_prefill"}
    for name, n in launches.items():
        if name in path and n <= 0:
            fail(f"kernel {name} was not launched on the {kv_dtype} "
                 f"serving path")
        if name not in path and n != 0:
            fail(f"kernel {name} launched {n} times on the {kv_dtype} "
                 f"serving path")
    for r in reqs:
        res = sched.results[r.request_id]
        if res.finish_reason not in (FinishReason.LENGTH, FinishReason.EOS):
            fail(f"{kv_dtype} {r.request_id} finished {res.finish_reason}: "
                 f"{res.error}")
        dec = res.latency_s - res.ttft_s
        print(json.dumps({"request": r.request_id, "kv_dtype": kv_dtype,
                          "prompt_len": len(r.prompt),
                          "new_tokens": len(res.tokens),
                          "ttft_s": res.ttft_s,
                          "decode_tok_s": (len(res.tokens) - 1) / dec
                          if dec > 0 else None,
                          "card": card}), flush=True)
    engine.pool.leak_check()
    if engine.pool.prefix_hits < 1:
        fail("the shared 128-token prefix did not hit the prefix cache")
    # Each decode launch serves every active row at once, so per request
    # is the run's count over the requests served.
    stats = {"kv_dtype": kv_dtype, "serve_wall_s": wall,
             "launches": launches,
             "launches_per_request": {
                 k: n / len(reqs) for k, n in launches.items()},
             "prefix_hits": engine.pool.prefix_hits,
             "cow_copies": engine.pool.cow_copies,
             "step_calls": engine.step_calls,
             "bytes_per_block": engine.pool.bytes_per_block, "card": card}
    if int8:
        stats["max_quant_error"] = max(engine.quant_errors)
        stats["quant_error_samples"] = len(engine.quant_errors)
    print(json.dumps(stats), flush=True)
    cross_check(model, sched, reqs,
                INT8_SERVE_LOGIT_ATOL if int8 else SERVE_LOGIT_ATOL)
    return launches


def zero_serve_launches() -> None:
    """Zero every count ``Engine.kernel_launches`` reads."""
    from nezha_tpu_torch.ops.cuda import (flash_decode_attention,
                                          paged_decode_attention,
                                          paged_prefill_attention,
                                          paged_prefill_qoff_attention,
                                          paged_quant_decode_attention,
                                          paged_quant_prefill_attention)
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES

    for wrapper in (paged_decode_attention, paged_prefill_attention,
                    paged_prefill_qoff_attention,
                    paged_quant_decode_attention,
                    paged_quant_prefill_attention, flash_decode_attention):
        wrapper.launches = 0
    LAUNCHES["flash_fwd"] = 0


def serve_seq(card: str):
    """Sequence-sharded serving on a 4-shard mesh of one card: a ring
    engine (B11), a ulysses engine (B9) and a ulysses engine on int8
    pools (B10); -> the launches of each run."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.serve import (FinishReason, Request, Scheduler,
                                       ServeConfig, ShardedEngine)

    model = gpt2_for_preset("full", seed=0, device="cuda")
    model.eval()
    layers, m = model.cfg.num_layers, SEQ_MESH
    g = torch.Generator().manual_seed(3)
    prompts = serve_prompts(model.cfg.vocab_size) + [
        torch.randint(0, model.cfg.vocab_size, (960,), generator=g).tolist()]
    label = f"one card, {m} shards run serially"
    runs, served, engines = {}, {}, {}
    for variant, kv_dtype in (("ring", "bf16"), ("ulysses", "bf16"),
                              ("ulysses", "int8")):
        tag = f"serve_seq {variant} {kv_dtype}"
        cfg = ServeConfig(max_batch_size=8, max_len=1024,
                          max_prefill_len=256,
                          long_prefill_buckets=(512, 1024),
                          kv_block_size=16, prefill_mode="sequence",
                          seq_prefill_variant=variant, kv_dtype=kv_dtype)
        engine = ShardedEngine(model, cfg, mesh_devices=m,
                               devices=[torch.device("cuda", 0)] * m)
        if engine._seq_variant != variant:
            fail(f"{tag}: the engine runs {engine._seq_variant}")
        sched = Scheduler(engine)
        reqs = [Request(prompt=p, max_new_tokens=32, request_id=f"r{i}")
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        zero_serve_launches()
        t0 = time.perf_counter()
        for r in reqs:
            sched.submit(r)
        sched.run_until_idle(max_iters=10_000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = engine.kernel_launches()
        if sched.has_work():
            fail(f"{tag}: the scheduler did not drain")
        for r in reqs:
            res = sched.results[r.request_id]
            if res.finish_reason not in (FinishReason.LENGTH,
                                         FinishReason.EOS):
                fail(f"{tag} {r.request_id} finished {res.finish_reason}: "
                     f"{res.error}")
        per_layer = m * layers
        chunks, steps = engine.prefill_chunks, engine.step_calls
        int8 = kv_dtype == "int8"
        want = {"flash_decode": 0, "flash_fwd": 0,
                "paged_decode": 0 if int8 else per_layer * steps,
                "paged_quant_decode": per_layer * steps if int8 else 0,
                "paged_prefill": (per_layer * chunks
                                  if variant == "ulysses" and not int8
                                  else 0),
                "paged_quant_prefill": per_layer * chunks if int8 else 0,
                "paged_prefill_qoff": (m * per_layer * chunks
                                       if variant == "ring" else 0)}
        if launches != want:
            fail(f"{tag}: launches {launches}, expected {want} for "
                 f"{chunks} chunks and {steps} decode steps")
        engine.pool.leak_check()
        if engine.pool.prefix_hits < 1:
            fail(f"{tag}: the shared 128-token prefix did not hit")
        doc = sched.results[reqs[-1].request_id]
        print(json.dumps({"serve_seq": {
            "variant": variant, "kv_dtype": kv_dtype, "mesh": label,
            "wall_s": wall, "ttft_960_s": doc.ttft_s,
            "prefill_chunks": chunks, "decode_steps": steps,
            "launches": launches, "prefix_hits": engine.pool.prefix_hits,
            "memory_report": engine.memory_report(),
            "max_quant_error": max(engine.quant_errors) if int8 else None,
            "card": card}}), flush=True)
        cross_check(model, sched, reqs,
                    INT8_SERVE_LOGIT_ATOL if int8 else SERVE_LOGIT_ATOL)
        runs[f"{variant}_{kv_dtype}"] = launches
        served[variant, kv_dtype] = {r.request_id: sched.results[
            r.request_id].tokens for r in reqs}
        engines[variant, kv_dtype] = engine
    if served["ring", "bf16"] != served["ulysses", "bf16"]:
        fail("serve_seq: ring and ulysses served different tokens")
    # Each prompt's last logits from a cold prefill, ring against
    # ulysses: the same bits. The prefix cache is emptied before every
    # prompt, so each prefills whole at its own bucket widths (up to the
    # 1024-wide long bucket), not as a short tail over cached blocks.
    widths = {}
    for i, p in enumerate(prompts):
        logits = []
        for key in (("ring", "bf16"), ("ulysses", "bf16")):
            engine = engines[key]
            engine.pool.clear_prefix_cache()
            plan = engine._plan_chunks(len(p))
            before = engine.prefill_chunks
            slot = engine.pool.alloc()
            try:
                engine.prefill(slot, p, max_new_tokens=1)
                logits.append(engine.last_logits[slot].clone())
            finally:
                engine.pool.free(slot)
            if engine.prefill_chunks - before != len(plan):
                fail(f"serve_seq r{i}: {engine.prefill_chunks - before} "
                     f"chunks dispatched, the cold plan has {len(plan)}")
            widths[f"r{i}"] = [w for _, _, w in plan]
        if not torch.equal(logits[0], logits[1]):
            fail(f"serve_seq r{i}: ring and ulysses last logits differ by "
                 f"{(logits[0] - logits[1]).abs().max().item()}")
    long_widths = {w for ws in widths.values() for w in ws} & {512, 1024}
    if long_widths != {512, 1024}:
        fail(f"serve_seq: the cold prefills used long buckets "
             f"{sorted(long_widths)}, expected 512 and 1024")
    for engine in engines.values():
        engine.pool.leak_check()
    print(json.dumps({"serve_seq_ring_vs_ulysses": {
        "tokens_identical": True, "last_logits_bitwise_equal": len(prompts),
        "requests": len(prompts), "cold_prefill_widths": widths}}),
        flush=True)
    return runs


# ----------------------------------------------------------- serve_mesh
MESH_M = 2    # serve_mesh's and train_tp's shards, both on the one card
MESH_NOTE = "one card repeated: says nothing about two cards"


def serve_mesh(card: str) -> dict:
    """Phase 5e: every serve path JAX runs under ``--mesh`` on a
    MESH_M-shard ShardedEngine of the one card, GPT-2 124M at full width,
    serve's eight prompts (32 greedy tokens each). (a) speculative with
    the identity self-draft (draft_k=SPEC_K), bf16 then int8: tokens
    against the one-device speculative engine's (serve_modes) by the
    margin rule, tokens a verify, B9/B10 MESH_M x 12 a chunk and B7/B8
    MESH_M x 12 a draft decode, the draft sharing the target's shards,
    both pools head-sharded and leak-free; (b) ``decode_impl`` and
    ``prefill_impl`` "xla", then ``NEZHA_NO_NESTED_KERNELS``: no kernel
    launched, the same tokens, cross-checked; (c) serve_wire (a)'s
    conversations on an int8 mesh with the host tier and without:
    demotions and promotions, full-head entries, fewer B10 launches with
    the tier; (d) WIRE_PROMPT tokens parked on an int8 mesh and
    installed on one device, then the reverse: the payload the
    one-device layout and bytes, the installed blocks the shards'
    concatenation bitwise, a prefix hit, tokens cross-checked. -> the
    launches of each run."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.serve import SpeculativeConfig
    from nezha_tpu_torch.serve.sharded.pool import ShardedPagedSlotPool

    t0 = time.perf_counter()
    model = gpt2_for_preset("full", seed=0, device="cuda")
    model.eval()
    layers, m = model.cfg.num_layers, MESH_M
    prompts = serve_prompts(model.cfg.vocab_size)
    reference = xla_reference(model)
    out, paths = {}, {}
    for kv_dtype in ("bf16", "int8"):
        tag = f"serve_mesh spec {kv_dtype}"
        int8 = kv_dtype == "int8"
        cfg = modes_config(kv_dtype=kv_dtype, speculative=SpeculativeConfig(
            draft_k=SPEC_K))
        engine, launches, stats = modes_run(model, cfg, tag, card,
                                            tokens=True, mesh=m)
        if not (isinstance(engine.draft_pool, ShardedPagedSlotPool)
                and engine.draft_model.shards is engine.model.shards):
            fail(f"{tag}: the draft is not on the target's shards")
        windows = stats["step_calls"] * cfg.decode_horizon
        draft_chunks = sum(len(engine._plan_chunks(len(p)))
                           for p in prompts)
        want = {("paged_quant_decode" if int8 else "paged_decode"):
                m * windows * (SPEC_K + 1) * layers,
                ("paged_quant_prefill" if int8 else "paged_prefill"):
                m * layers * (stats["prefill_chunks"] + draft_chunks)}
        expect_launches(tag, launches, want)
        if stats["tokens_per_verify"] < SPEC_MIN_TOKENS_PER_VERIFY:
            fail(f"{tag}: {stats['tokens_per_verify']} tokens a verify")
        got, one = stats.pop("greedy"), SPEC_GREEDY[kv_dtype]
        with torch.no_grad():
            agreed = [agree_to_divergence(
                f"{tag} r{i}", reference, p, one[f"r{i}"], got[f"r{i}"],
                INT8_SERVE_LOGIT_ATOL if int8 else SERVE_LOGIT_ATOL)
                for i, p in enumerate(prompts)]
        stats.update(tokens_agreed=[n for n, _ in agreed],
                     identical_to_one_device=got == one, mesh=m,
                     note=MESH_NOTE, want_launches=want)
        print(json.dumps({"serve_mesh": {tag: stats}}), flush=True)
        out[tag] = stats
        paths[f"serve_mesh_spec_{kv_dtype}"] = launches
    composed = {}
    for tag, kw, var in (
            ("xla", dict(decode_impl="xla", prefill_impl="xla"), None),
            ("NEZHA_NO_NESTED_KERNELS", {}, "NEZHA_NO_NESTED_KERNELS")):
        with (env_switch(var) if var else contextlib.nullcontext()):
            engine, launches, stats = modes_run(
                model, modes_config(**kw), f"serve_mesh {tag}", card,
                tokens=True, mesh=m)
            if engine.prefill_kernel_active:
                fail(f"serve_mesh {tag}: the engine prefills by kernel")
        expect_launches(f"serve_mesh {tag}", launches, {})
        composed[tag] = stats.pop("greedy")
        print(json.dumps({"serve_mesh": {tag: stats}}), flush=True)
        out[tag] = stats
        paths[f"serve_mesh_{tag}"] = launches
    if composed["xla"] != composed["NEZHA_NO_NESTED_KERNELS"]:
        fail("serve_mesh: NEZHA_NO_NESTED_KERNELS served other tokens than "
             "the xla impls")
    tier = {}
    for host_blocks in (WIRE_HOST_BLOCKS, 0):
        tier[host_blocks], paths[f"serve_mesh_tier_{host_blocks}"] = \
            host_tier_run(model, host_blocks, card, mesh=m)
        print(json.dumps({"serve_mesh": {f"tier_{host_blocks}":
                                         tier[host_blocks]}}), flush=True)
    with_tier, without = tier[WIRE_HOST_BLOCKS], tier[0]
    if not (with_tier["demotions"] > 0 and with_tier["promotions"] > 0):
        fail(f"serve_mesh tier: {with_tier['demotions']} demotions, "
             f"{with_tier['promotions']} promotions")
    b10 = [t["launches"]["paged_quant_prefill"] for t in (with_tier,
                                                          without)]
    if not b10[0] < b10[1]:
        fail(f"serve_mesh tier: B10 {b10[0]} with the tier, {b10[1]} "
             f"without")
    out["tier"] = tier
    for src, dst in ((m, 0), (0, m)):
        tag = f"migrate_{src}_to_{dst}"
        out[tag], paths[f"serve_mesh_{tag}"] = migrate_once(
            model, "int8", card, src_mesh=src, dst_mesh=dst)
        print(json.dumps({"serve_mesh": {tag: out[tag]}}), flush=True)
    if out[f"migrate_{m}_to_0"]["wire_payload_bytes"] != \
            out[f"migrate_0_to_{m}"]["wire_payload_bytes"]:
        fail("serve_mesh: a mesh export's bytes differ from one device's")
    print(json.dumps({"serve_mesh_wall_s": time.perf_counter() - t0}),
          flush=True)
    return paths


def modes_config(**kw):
    """serve_modes' engine shape: the serve phase's (8 slots, 1024
    positions, 256-wide chunks, blocks of 16)."""
    from nezha_tpu_torch.serve import ServeConfig
    return ServeConfig(**{**dict(max_batch_size=8, max_len=1024,
                                 max_prefill_len=256, kv_block_size=16),
                          **kw})


def modes_run(model, cfg, tag: str, card: str, tokens: bool = False,
              mesh: int = 0):
    """The serve phase's eight greedy requests (32 new tokens each)
    through Scheduler on an Engine of ``cfg`` (with ``mesh``, a
    ShardedEngine of that many shards on the one card): every request
    finishes, both pools' books balance, and cross_check holds each
    token. -> (engine, launches, stats); with ``tokens``, stats["greedy"]
    holds each request's tokens."""
    from nezha_tpu_torch.serve import FinishReason, Request, Scheduler

    engine = serve_engine(model, cfg, mesh)
    sched = Scheduler(engine)
    reqs = [Request(prompt=p, max_new_tokens=MODES_NEW, request_id=f"r{i}")
            for i, p in enumerate(serve_prompts(model.cfg.vocab_size))]
    torch.cuda.synchronize()
    zero_serve_launches()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle(max_iters=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = engine.kernel_launches()
    if sched.has_work():
        fail(f"{tag}: the scheduler did not drain")
    for r in reqs:
        res = sched.results[r.request_id]
        if res.finish_reason not in (FinishReason.LENGTH, FinishReason.EOS):
            fail(f"{tag} {r.request_id} finished {res.finish_reason}: "
                 f"{res.error}")
    engine.pool.leak_check()                # and the draft pool's
    stats = {"serve_wall_s": wall, "step_calls": engine.step_calls,
             "prefill_chunks": engine.prefill_chunks,
             "tokens": sum(len(sched.results[r.request_id].tokens)
                           for r in reqs),
             "ttft_s": [sched.results[r.request_id].ttft_s for r in reqs],
             "launches": launches, "card": card}
    if tokens:
        stats["greedy"] = {r.request_id: sched.results[r.request_id].tokens
                           for r in reqs}
    if engine.spec is not None:
        v = engine.spec_verifies
        stats.update(verifies=v, draft_tokens=engine.spec_draft_tokens,
                     accepted=engine.spec_accepted,
                     tokens_per_verify=(engine.spec_accepted + v) / v,
                     accept_rate=(engine.spec_accepted
                                  / engine.spec_draft_tokens))
    cross_check(model, sched, reqs,
                INT8_SERVE_LOGIT_ATOL if cfg.kv_dtype == "int8"
                else SERVE_LOGIT_ATOL)
    return engine, launches, stats     # stats' counts from before it


def serve_engine(model, cfg, mesh: int = 0):
    """An Engine of ``cfg``, or with ``mesh`` a ShardedEngine of that
    many shards, every one on the one card."""
    from nezha_tpu_torch.serve import Engine, ShardedEngine

    if not mesh:
        return Engine(model, cfg)
    return ShardedEngine(model, cfg, mesh_devices=mesh,
                         devices=[torch.device("cuda", 0)] * mesh)


def expect_launches(tag: str, launches: dict, want: dict) -> None:
    """The run launched exactly ``want`` (kernels not named: none)."""
    full = {k: want.get(k, 0) for k in launches}
    if launches != full:
        fail(f"{tag}: launches {launches}, expected {full}")


@torch.no_grad()
def time_verify(engine, card: str) -> dict:
    """The verify forward (draft_k + 1 tokens a row) against the target's
    single-token decode forward (B7) and one draft decode forward, over
    the eight prompts prefilled into their slots: ms a call by CUDA
    events around back-to-back calls (host included). A forward launches
    more kernels than the device's launch queue holds, so the kernel
    rows' spin-ahead timer cannot take it whole; it takes one layer's
    attention instead: the verify's composed path against B7 on the
    same rows and pool, device ms with no host gap inside."""
    from nezha_tpu_torch.models.gpt2 import _gathered_attention
    from nezha_tpu_torch.ops.cuda import paged_decode_attention

    cfg, k = engine.cfg, engine.spec.draft_k
    prompts = serve_prompts(engine.vocab)
    slots = []
    for p in prompts:
        slots.append(engine.pool.alloc())
        engine.prefill(slots[-1], p, max_new_tokens=MODES_NEW)
    active = np.zeros((cfg.max_batch_size,), bool)
    active[slots] = True
    engine._bind_decode_windows(active, k + 1,
                                (engine.pool, engine.draft_pool))
    act = torch.as_tensor(active, device="cuda")
    rows = engine._cache_rows(engine.pool)
    drows = engine._cache_rows(engine.draft_pool)
    pos = engine.positions
    b, mc = cfg.max_batch_size, engine.model.cfg
    win = torch.randint(0, engine.vocab, (b, k + 1), device="cuda")
    calls = {
        "verify": lambda: engine.model(win, cache=rows, pos=pos, active=act),
        "target_decode": lambda: engine.model(win[:, :1], cache=rows,
                                              pos=pos, active=act),
        "draft_decode": lambda: engine.draft_model(win[:, :1], cache=drows,
                                                   pos=pos, active=act)}
    out = {"rows": len(slots), "window": k + 1,
           "context": [len(p) for p in prompts], "card": card}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(VERIFY_CALLS):
            fn()
        end.record()
        end.synchronize()
        out[f"{name}_forward_ms"] = start.elapsed_time(end) / VERIFY_CALLS
    layer = rows[0]
    q = torch.randn(b, mc.num_heads, k + 1, mc.hidden_size // mc.num_heads,
                    device="cuda", dtype=torch.bfloat16)
    lengths = (pos + 1).int()
    attn = {
        "verify_attention": lambda: _gathered_attention(
            q, layer["k"], layer["v"], layer["tables"], pos, None),
        "b7_attention": lambda: paged_decode_attention(
            q[:, :, :1].contiguous(), layer["k"], layer["v"], lengths,
            layer["tables"])}
    for name, fn in attn.items():
        means, _, outliers, delay_ms, _ = timed_attempts(
            f"{name} (one layer)", fn, VERIFY_DEVICE_CALLS)
        out[f"{name}_device_ms"] = sum(means) / len(means)
        out[f"{name}_device_ms_spread"] = spread(means)
    for s in slots:
        engine.pool.free(s)
    engine.pool.leak_check()
    return out


SPEC_GREEDY = {}   # the identity self-draft's tokens by kv dtype


def spec_modes(model, card: str) -> dict:
    """(a) speculative on paged bf16 pools, the identity self-draft and a
    4-layer one; (b) the identity draft on int8 pools. Launch counts are
    exact: a window runs draft_k + 1 draft decodes (B7/B8, one launch a
    draft layer) and a composed verify; prefill runs B9/B10 a layer a
    chunk, the draft's chunks a cold plan of every prompt."""
    from nezha_tpu_torch.serve import SpeculativeConfig

    layers = model.cfg.num_layers
    prompts = serve_prompts(model.cfg.vocab_size)
    out, paths = {}, {}
    for tag, kv_dtype, draft_layers in (
            ("spec_identity", "bf16", None),
            ("spec_4layer", "bf16", SPEC_DRAFT_LAYERS),
            ("spec_int8", "int8", None)):
        cfg = modes_config(kv_dtype=kv_dtype, speculative=SpeculativeConfig(
            draft_k=SPEC_K, draft_layers=draft_layers))
        engine, launches, stats = modes_run(model, cfg, tag, card,
                                            tokens=draft_layers is None)
        if draft_layers is None:     # serve_mesh (a)'s one-device runs
            SPEC_GREEDY[kv_dtype] = stats.pop("greedy")
        # The counts of the run: cross_check has prefilled since.
        dl = engine.draft_model.cfg.num_layers
        windows = stats["step_calls"] * cfg.decode_horizon
        draft_chunks = sum(len(engine._plan_chunks(len(p)))
                           for p in prompts)
        decode = windows * (SPEC_K + 1) * dl
        prefill = layers * stats["prefill_chunks"] + dl * draft_chunks
        int8 = kv_dtype == "int8"
        expect_launches(tag, launches, {
            ("paged_quant_decode" if int8 else "paged_decode"): decode,
            ("paged_quant_prefill" if int8 else "paged_prefill"): prefill})
        if stats["tokens_per_verify"] <= 1.0:
            fail(f"{tag}: {stats['tokens_per_verify']} tokens a verify")
        if (draft_layers is None and stats["tokens_per_verify"]
                < SPEC_MIN_TOKENS_PER_VERIFY):
            fail(f"{tag}: the identity draft's {stats['tokens_per_verify']}"
                 f" tokens a verify < {SPEC_MIN_TOKENS_PER_VERIFY}")
        stats.update(kv_dtype=kv_dtype, draft_layers=dl, draft_k=SPEC_K,
                     windows=windows, draft_prefill_chunks=draft_chunks,
                     want_decode_launches=decode,
                     want_prefill_launches=prefill)
        if tag == "spec_4layer":
            stats["verify_timing"] = time_verify(engine, card)
        print(json.dumps({"serve_modes": {tag: stats}}), flush=True)
        out[tag], paths[f"serve_{tag}"] = stats, launches
    return out, paths


def dense_mode(model, card: str):
    """(c) the dense layout: B6 a layer a decode step, no paged kernel,
    and no B1 (a dense prefill attends by the composed path)."""
    cfg = modes_config(kv_layout="dense")
    _, launches, stats = modes_run(model, cfg, "dense", card)
    steps = stats["step_calls"] * cfg.decode_horizon
    expect_launches("dense", launches,
                    {"flash_decode": model.cfg.num_layers * steps})
    print(json.dumps({"serve_modes": {"dense": stats}}), flush=True)
    return stats, launches


def sched_modes(model, card: str):
    """(d) scheduling held on the card: the 4:2:1 grant order of a full
    three-lane backlog, a tenant over its cap while another admits, and
    a background decode preempted by an interactive arrival on two slots,
    resumed by a prefix hit and a B9 tail, its stream the uninterrupted
    one up to a margin within SERVE_LOGIT_ATOL."""
    from nezha_tpu_torch.serve import (Engine, FinishReason, Request,
                                       Scheduler, TenantOverLimit)

    prompts = serve_prompts(model.cfg.vocab_size)
    engine = Engine(model, modes_config(max_batch_size=2, tenant_queue_cap=2,
                                        preemption=True))
    sched = Scheduler(engine)
    for rid, pri in (("g0", "background"), ("b0", "batch"), ("b1", "batch"),
                     ("i0", "interactive"), ("i1", "interactive"),
                     ("i2", "interactive"), ("i3", "interactive")):
        sched.submit(Request(prompt=prompts[0], max_new_tokens=4,
                             priority=pri, request_id=rid,
                             tenant_id=f"t{rid}"))
    with sched._lock:
        order = [sched._pop_next().req.priority for _ in range(7)]
    if order != WFQ_ORDER:
        fail(f"sched: grants {order}, expected {WFQ_ORDER}")
    sched = Scheduler(engine)
    for i in range(2):
        sched.submit(Request(prompt=prompts[0], max_new_tokens=4,
                             tenant_id="acme", request_id=f"a{i}"))
    try:
        sched.submit(Request(prompt=prompts[0], max_new_tokens=4,
                             tenant_id="acme", request_id="a2"))
        fail("sched: a tenant past its cap was admitted")
    except TenantOverLimit:
        pass
    sched.submit(Request(prompt=prompts[1], max_new_tokens=4,
                         tenant_id="xcorp", request_id="x0"))
    sched.run_until_idle(max_iters=1000)
    if sorted(sched.results) != ["a0", "a1", "x0"]:
        fail(f"sched: served {sorted(sched.results)}")
    engine.pool.leak_check()

    bg = prompts[2]
    sched = Scheduler(engine)
    sched.submit(Request(prompt=bg, max_new_tokens=MODES_NEW,
                         priority="background", request_id="ref"))
    sched.run_until_idle(max_iters=1000)
    want = sched.results["ref"].tokens
    engine.pool.clear_prefix_cache()
    sched = Scheduler(engine)
    hits = engine.pool.prefix_hits
    zero_serve_launches()
    reqs = [Request(prompt=bg, max_new_tokens=MODES_NEW,
                    priority="background", request_id="bg")]
    sched.submit(reqs[0])
    sched.step()
    reqs += [Request(prompt=p, max_new_tokens=8, request_id=f"i{i}")
             for i, p in enumerate(prompts[:2])]
    for r in reqs[1:]:
        sched.submit(r)
    sched.step()
    if sched.preempted_count != 1:
        fail(f"sched: {sched.preempted_count} preempted, expected 1")
    before = dict(engine.kernel_launches())
    sched.run_until_idle(max_iters=1000)
    torch.cuda.synchronize()
    launches = engine.kernel_launches()
    if (sched.resumes, sched.preempted_count) != (1, 0):
        fail(f"sched: resumes {sched.resumes}, still preempted "
             f"{sched.preempted_count}")
    resume_hits = engine.pool.prefix_hits - hits
    if resume_hits < 1:
        fail("sched: the resume did not hit its own blocks")
    for name in ("paged_prefill", "paged_decode"):
        if launches[name] - before[name] <= 0:
            fail(f"sched: the resume launched no {name}")
    for r in reqs:
        if sched.results[r.request_id].finish_reason != FinishReason.LENGTH:
            fail(f"sched: {r.request_id} finished "
                 f"{sched.results[r.request_id].finish_reason}")
    reference = xla_reference(model)
    got = sched.results["bg"].tokens
    with torch.no_grad():
        compared, checked = agree_to_divergence("sched resume", reference,
                                                bg, want, got)
    cross_check(model, sched, reqs, SERVE_LOGIT_ATOL)
    engine.pool.leak_check()
    stats = {"grant_order": order, "tenant_over_limit": True,
             "preemptions": sched.preemptions, "resumes": sched.resumes,
             "resume_prefix_hits": resume_hits,
             "bg_tokens_equal": got == want, "compared": compared,
             "margin_checked": checked, "launches": launches, "card": card}
    print(json.dumps({"serve_modes": {"sched": stats}}), flush=True)
    return stats, launches


def serve_modes(card: str) -> dict:
    """Phase 5a: speculative decoding (paged bf16 with the identity and a
    4-layer self-draft; int8), the dense layout and the scheduler's lanes,
    tenant caps and preemption, GPT-2 124M at full width. -> the launches
    of each path."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset

    t0 = time.perf_counter()
    model = gpt2_for_preset("full", seed=0, device="cuda")
    model.eval()
    _, paths = spec_modes(model, card)
    _, paths["serve_dense"] = dense_mode(model, card)
    _, paths["serve_sched"] = sched_modes(model, card)
    print(json.dumps({"serve_modes_wall_s": time.perf_counter() - t0}),
          flush=True)
    return paths


# ----------------------------------------------------------- serve_wire
# serve_wire (a): conversations, turns, their first prompts' lengths, the
# new tokens a turn and the words a user adds; the host tier's budget.
WIRE_CONVS, WIRE_TURNS = 6, 3
WIRE_FIRST = (384, 640)
WIRE_NEW, WIRE_ADD = 16, 48
WIRE_HOST_BLOCKS = 512
# (b) the migrated prompt; (c) the HTTP prompt, the stragglers' tokens,
# their count and the drain budget: long enough for two requests to see
# the draining server from outside while the decode thread holds the
# interpreter most of the time (at 0.5 s the server was seen to shut down
# before the second), and far shorter than the stragglers' decode (~30
# ms a token for four streams).
WIRE_PROMPT = 600
HTTP_PROMPT, HTTP_NEW, HTTP_STRAGGLERS = 96, 400, 4
HTTP_DRAIN_S = 2.0


def wire_config(**kw):
    """serve_wire's engine shape: two slots, 1024 positions, 256-wide
    chunks, blocks of 16, the default (dense-equivalent, 129-block)
    pool."""
    from nezha_tpu_torch.serve import ServeConfig
    return ServeConfig(**{**dict(max_batch_size=2, max_len=1024,
                                 max_prefill_len=256, kv_block_size=16),
                          **kw})


class EventTimer:
    """Wraps a pool method (the host tier's ``_demote``, ``_promote``)
    with CUDA events on the current stream: the device span of the work
    each call queues (the stream's idle gaps inside it included)."""

    def __init__(self, obj, name: str):
        self.pairs = []
        inner = getattr(obj, name)

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*a, **kw)
            end.record()
            self.pairs.append((start, end))
            return out

        setattr(obj, name, timed)

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.pairs]


def host_tier_run(model, host_blocks: int, card: str, mesh: int = 0):
    """(a) WIRE_CONVS seeded conversations of WIRE_TURNS turns, each turn
    of all of them submitted round robin and drained before the next: a
    turn is the previous prompt, its WIRE_NEW greedy tokens and WIRE_ADD
    new ones, so between a conversation's turns the others evict its
    blocks; with ``mesh``, on a ShardedEngine of that many shards, whose
    host entries must hold every head. -> (stats, launches)."""
    from nezha_tpu_torch.serve import FinishReason, Request, Scheduler

    engine = serve_engine(model, wire_config(kv_dtype="int8",
                                             kv_host_blocks=host_blocks),
                          mesh)
    pool = engine.pool
    demote, promote = EventTimer(pool, "_demote"), EventTimer(pool,
                                                              "_promote")
    sched = Scheduler(engine)
    g = torch.Generator().manual_seed(3)
    vocab = model.cfg.vocab_size

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=g).tolist()

    prompts = [toks(int(torch.randint(WIRE_FIRST[0], WIRE_FIRST[1] + 1,
                                      (1,), generator=g)))
               for _ in range(WIRE_CONVS)]
    reqs, ttft = [], {}
    torch.cuda.synchronize()
    zero_serve_launches()
    t0 = time.perf_counter()
    for turn in range(WIRE_TURNS):
        wave = [Request(prompt=p, max_new_tokens=WIRE_NEW,
                        request_id=f"c{c}t{turn}")
                for c, p in enumerate(prompts)]
        for r in wave:
            sched.submit(r)
        sched.run_until_idle(max_iters=10_000)
        for c, r in enumerate(wave):
            res = sched.results[r.request_id]
            if res.finish_reason != FinishReason.LENGTH:
                fail(f"serve_wire tier {host_blocks}: {r.request_id} "
                     f"finished {res.finish_reason}: {res.error}")
            if turn:
                ttft[r.request_id] = res.ttft_s
            prompts[c] = list(r.prompt) + res.tokens + toks(WIRE_ADD)
        reqs += wave
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = engine.kernel_launches()
    pool.leak_check()
    for key, entry in pool._host_tier.items():
        entry.wait()
        if tuple(entry[0]["k"].shape[1:]) != pool.block_shape:
            fail(f"serve_wire tier {host_blocks}: a host entry holds "
                 f"{tuple(entry[0]['k'].shape)}, not every head "
                 f"{pool.block_shape}")
    demote_ms, promote_ms = demote.ms(), promote.ms()
    stats = {"kv_host_blocks": host_blocks, "mesh": mesh, "wall_s": wall,
             "demotions": pool.demotions, "promotions": pool.promotions,
             "promote_failures": pool.promote_failures,
             "host_blocks_used": pool.host_blocks_used,
             "host_bytes_resident": pool.host_bytes_resident,
             "prefix_hits": pool.prefix_hits,
             "fleet_hits": dict(pool.fleet_hits),
             "prefill_chunks": engine.prefill_chunks,
             "revisit_ttft_s": ttft,
             "demote_ms": {"calls": len(demote_ms),
                           "mean": float(np.mean(demote_ms))
                           if demote_ms else None,
                           "max": max(demote_ms, default=None)},
             "promote_ms": {"calls": len(promote_ms),
                            "blocks": pool.promotions,
                            "total": float(np.sum(promote_ms))
                            if promote_ms else None,
                            "max": max(promote_ms, default=None)},
             "launches": launches, "card": card}
    cross_check(model, sched, reqs, INT8_SERVE_LOGIT_ATOL)
    return stats, launches


def migrate_once(model, kv_dtype: str, card: str, src_mesh: int = 0,
                 dst_mesh: int = 0):
    """(b) One prompt parked on engine A, exported, encoded, decoded,
    installed on engine B and ACKed; B then serves it: its prefill runs
    the tail chunk only (B9 or B10 a layer, a shard), its decode B7 or
    B8; it hits the installed prefix. Both pools leak-free. ``src_mesh``
    and ``dst_mesh`` make A or B a ShardedEngine of that many shards on
    the one card: A's wire is then its shards' head groups concatenated,
    bitwise, in the one-device layout and bytes. -> (stats, B's
    launches)."""
    from nezha_tpu_torch.serve import (FinishReason, Request, Scheduler,
                                       migrate)
    from nezha_tpu_torch.serve.slots import _gather_blocks_quantized

    cfg = wire_config(kv_dtype=kv_dtype)
    a = Scheduler(serve_engine(model, cfg, src_mesh))
    b = Scheduler(serve_engine(model, cfg, dst_mesh))
    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, model.cfg.vocab_size, (WIRE_PROMPT,),
                           generator=g).tolist()
    a.submit(Request(prompt=prompt, max_new_tokens=MODES_NEW,
                     request_id="m", prefill_only=True))
    a.run_until_idle(max_iters=1000)
    if (a.results["m"].finish_reason, a.parked_count) != (
            FinishReason.PREFILLED, 1):
        fail(f"serve_wire {kv_dtype}: the park answered "
             f"{a.results['m'].finish_reason}, {a.parked_count} parked")
    pool_a, bs = a.engine.pool, cfg.kv_block_size
    slot = a._parked["m"][0]
    nfull = len(prompt) // bs

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (layers, nbytes), export_ms = clock(
        lambda: pool_a.export_block_payload(slot, nfull))
    wire, encode_ms = clock(lambda: migrate.encode_wire(
        prompt[:nfull * bs], layers, bs))
    if wire != a.export_parked("m"):
        fail(f"serve_wire {kv_dtype}: export_parked's wire differs from "
             f"the pool's export")
    if kv_dtype == "int8" and nbytes != nfull * pool_a.bytes_per_block:
        fail(f"serve_wire int8: {nbytes} payload bytes for {nfull} blocks "
             f"of {pool_a.bytes_per_block}")
    if src_mesh:
        # Gather-on-export: the shards' head groups in shard order.
        idx = torch.as_tensor(pool_a.tables_host[slot, :nfull]
                              .astype(np.int64), device="cuda")
        parts = [_gather_blocks_quantized(pool_a.shard_caches(r), idx)
                 for r in range(src_mesh)]
        for li, layer in enumerate(layers):
            for key, arr in layer.items():
                cat = torch.cat([p[li][key] for p in parts], dim=1)
                if not np.array_equal(arr, cat.cpu().numpy()):
                    fail(f"serve_wire mesh export: layer {li} {key} is not "
                         f"the shards' concatenation")
    text = json.dumps(wire)
    (tokens, got, wire_bytes), decode_ms = clock(
        lambda: migrate.decode_wire(json.loads(text)))
    installed, install_ms = clock(
        lambda: b.install_migrated(tokens, got, wire_bytes))
    if installed != nfull or not a.ack_parked("m") or a.parked_count:
        fail(f"serve_wire {kv_dtype}: installed {installed} of {nfull} "
             f"blocks, or the ACK did not release the park")
    pool_b = b.engine.pool
    if kv_dtype == "int8":
        # int8 pools ship their blocks verbatim: B holds A's bytes.
        blocks = pool_b.trie.match(prompt)
        mine = pool_b._gather_wire(blocks)
        for li, (x, y) in enumerate(zip(layers, mine)):
            for key in x:
                if not np.array_equal(x[key], y[key]):
                    fail(f"serve_wire int8: layer {li} {key} changed in "
                         f"the migration")
    torch.cuda.synchronize()
    zero_serve_launches()
    hits = pool_b.prefix_hits
    req = Request(prompt=prompt, max_new_tokens=MODES_NEW, request_id="m")
    b.submit(req)
    b.run_until_idle(max_iters=1000)
    torch.cuda.synchronize()
    launches = b.engine.kernel_launches()
    if pool_b.prefix_hits != hits + 1:
        fail(f"serve_wire {kv_dtype}: the migrated request did not hit "
             f"the installed prefix")
    res = b.results["m"]
    if res.finish_reason != FinishReason.LENGTH:
        fail(f"serve_wire {kv_dtype}: the migrated request finished "
             f"{res.finish_reason}: {res.error}")
    layers_n = model.cfg.num_layers * max(dst_mesh, 1)
    int8 = kv_dtype == "int8"
    expect_launches(f"serve_wire {kv_dtype} migration", launches, {
        ("paged_quant_prefill" if int8 else "paged_prefill"): layers_n,
        ("paged_quant_decode" if int8 else "paged_decode"):
            layers_n * b.engine.step_calls})
    pool_a.leak_check()
    pool_b.leak_check()
    stats = {"kv_dtype": kv_dtype, "src_mesh": src_mesh,
             "dst_mesh": dst_mesh, "prompt_len": len(prompt),
             "blocks": nfull, "wire_payload_bytes": nbytes,
             "wire_json_bytes": len(text),
             "pool_block_bytes": nfull * pool_a.bytes_per_block,
             "export_ms": export_ms, "encode_ms": encode_ms,
             "decode_ms": decode_ms, "install_ms": install_ms,
             "ttft_s": res.ttft_s, "migrations": b.migrations,
             "migration_bytes": b.migration_bytes,
             "launches": launches, "card": card}
    cross_check(model, b, [req], INT8_SERVE_LOGIT_ATOL if int8
                else SERVE_LOGIT_ATOL)
    return stats, launches


def http_call(port: int, method: str, path: str, obj=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        body = None if obj is None else json.dumps(obj).encode()
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def http_drain(model, card: str):
    """(c) Two ``run_http`` servers on 127.0.0.1 in threads of this
    process: a ``prefill_only`` POST parks on A, a ``pull_from`` POST on
    B migrates and decodes it (A's /healthz then shows no park); then
    HTTP_STRAGGLERS long requests on B and its drain event with
    HTTP_DRAIN_S: /healthz 503 "draining", a new POST 503, the
    stragglers answered "deadline", the server thread ended. Every answer
    against the reference; both pools leak-free. -> (stats, B's
    launches)."""
    from nezha_tpu_torch.cli import serve as serve_cli

    args = serve_cli.build_parser().parse_args(
        ["--random-init", "--drain-timeout", str(HTTP_DRAIN_S),
         "--max-new-tokens", str(HTTP_NEW)])
    servers = {}
    try:
        return http_checks(model, card, args, servers)
    finally:
        # A failed check must not leave a server whose threads keep the
        # process alive.
        for _, _, drain, _ in servers.values():
            drain.set()
        for _, _, _, th in servers.values():
            th.join(60)


def http_checks(model, card: str, args, servers: dict):
    """http_drain's servers (registered in ``servers`` as they start) and
    checks."""
    import threading
    import types

    from nezha_tpu_torch.cli import serve as serve_cli
    from nezha_tpu_torch.serve import Engine, RequestResult, Scheduler

    for name in ("a", "b"):
        sched = Scheduler(Engine(model, wire_config(max_batch_size=4)))
        ready, drain = threading.Event(), threading.Event()
        box = {}

        def cb(srv, box=box, ready=ready):
            box["port"] = srv.server_address[1]
            ready.set()

        th = threading.Thread(target=serve_cli.run_http,
                              args=(sched, args, 0),
                              kwargs=dict(ready_cb=cb, drain=drain),
                              daemon=True)
        th.start()
        servers[name] = (sched, None, drain, th)
        if not ready.wait(60):
            fail(f"serve_wire http: server {name} did not start")
        servers[name] = (sched, box["port"], drain, th)
    sa, pa, drain_a, th_a = servers["a"]
    sb, pb, drain_b, th_b = servers["b"]
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, model.cfg.vocab_size, (HTTP_PROMPT,),
                           generator=g).tolist()
    code, park = http_call(pa, "POST", "/generate", {
        "id": "h", "prompt_tokens": prompt, "max_new_tokens": MODES_NEW,
        "prefill_only": True})
    if code != 200 or park["finish_reason"] != "prefilled":
        fail(f"serve_wire http: the park answered {code} {park}")
    torch.cuda.synchronize()
    zero_serve_launches()
    code, moved = http_call(pb, "POST", "/generate", {
        "id": "h", "prompt_tokens": prompt, "max_new_tokens": MODES_NEW,
        "pull_from": {"port": pa, "request_id": "h"}})
    if code != 200 or moved.get("migration", {}).get("installed", 0) < 1 \
            or not moved["migration"]["acked"]:
        fail(f"serve_wire http: the pull answered {code} {moved}")
    code, health_a = http_call(pa, "GET", "/healthz")
    if code != 200 or health_a["parked"] != 0:
        fail(f"serve_wire http: A's /healthz after the ACK: {code} "
             f"{health_a}")
    answers, threads = {}, []
    for i in range(HTTP_STRAGGLERS):
        def post(i=i):
            answers[i] = http_call(pb, "POST", "/generate", {
                "id": f"s{i}", "prompt_tokens": prompt[i:],
                "max_new_tokens": HTTP_NEW})
        threads.append(threading.Thread(target=post, daemon=True))
        threads[-1].start()
    t_end = time.monotonic() + 60
    while sb.engine.pool.num_active < HTTP_STRAGGLERS:
        if time.monotonic() > t_end:
            fail("serve_wire http: the stragglers were never admitted")
        time.sleep(0.005)
    t_drain = time.perf_counter()
    drain_b.set()
    code, health_b = http_call(pb, "GET", "/healthz")
    late = http_call(pb, "POST", "/generate", {"prompt_tokens": prompt})
    for th in threads:
        th.join(120)
    th_b.join(60)
    drain_wall = time.perf_counter() - t_drain
    torch.cuda.synchronize()
    launches = sb.engine.kernel_launches()
    drain_a.set()
    th_a.join(60)
    if (code, health_b["status"]) != (503, "draining") or late[0] != 503:
        fail(f"serve_wire http: during the drain /healthz answered {code} "
             f"{health_b}, a new POST {late}")
    if th_a.is_alive() or th_b.is_alive():
        fail("serve_wire http: a server thread outlived its drain")
    reasons = {i: a[1].get("finish_reason") for i, a in answers.items()}
    if len(answers) != HTTP_STRAGGLERS or any(
            a[0] != 200 for a in answers.values()) or set(
            reasons.values()) != {"deadline"}:
        fail(f"serve_wire http: stragglers answered {reasons}")
    for name in ("paged_prefill", "paged_decode"):
        if launches[name] <= 0:
            fail(f"serve_wire http: {name} not launched ({launches})")
    results = {"h": moved, **{f"s{i}": a[1] for i, a in answers.items()}}
    reqs = [types.SimpleNamespace(request_id="h", prompt=prompt)] + [
        types.SimpleNamespace(request_id=f"s{i}", prompt=prompt[i:])
        for i in range(HTTP_STRAGGLERS) if answers[i][1]["tokens"]]
    view = types.SimpleNamespace(engine=sb.engine, results={
        r.request_id: RequestResult(r.request_id,
                                    results[r.request_id]["tokens"],
                                    results[r.request_id]["finish_reason"],
                                    None, 0.0) for r in reqs})
    cross_check(model, view, reqs, SERVE_LOGIT_ATOL)
    sa.engine.pool.leak_check()
    stats = {"migration": moved["migration"], "healthz_a": health_a,
             "healthz_b_draining": health_b,
             "straggler_tokens": {i: len(a[1]["tokens"])
                                  for i, a in answers.items()},
             "drain_wall_s": drain_wall, "launches": launches,
             "card": card}
    return stats, launches


def prefill_xla(model, card: str):
    """(d) ``prefill_impl="xla"``: the serve phase's eight prompts on
    bf16 and int8 pools; no B9 or B10, B7 or B8 every decode step. ->
    the launches of each."""
    out, paths = {}, {}
    for kv_dtype in ("bf16", "int8"):
        cfg = modes_config(kv_dtype=kv_dtype, prefill_impl="xla")
        engine, launches, stats = modes_run(model, cfg,
                                            f"prefill_xla {kv_dtype}", card,
                                            tokens=True)
        dec = ("paged_quant_decode" if kv_dtype == "int8"
               else "paged_decode")
        expect_launches(f"prefill_xla {kv_dtype}", launches, {
            dec: model.cfg.num_layers * stats["step_calls"]})
        out[kv_dtype] = stats
        paths[f"serve_prefill_xla_{kv_dtype}"] = launches
    return out, paths


@contextlib.contextmanager
def env_switch(name: str):
    """``name=1`` in this process's environment for the block, removed
    after it."""
    os.environ[name] = "1"
    try:
        yield
    finally:
        del os.environ[name]


def kernel_switches(model, card: str, xla_tokens: dict):
    """(e) The serve phase's eight prompts (32 greedy tokens each) with
    ``NEZHA_NO_PREFILL_KERNEL``: no B9, B7 12 a decode step, the tokens
    of (d)'s ``prefill_impl="xla"`` run; then with
    ``NEZHA_NO_DECODE_KERNEL``: no B7, B9 12 a prefill chunk, the tokens
    the kernel path's up to a divergence the margin rule allows. Each
    variable is set for its engine alone. -> (stats, the launches of
    each)."""

    layers = model.cfg.num_layers
    stats, paths = {}, {}
    with env_switch("NEZHA_NO_PREFILL_KERNEL"):
        engine, launches, st = modes_run(model, modes_config(),
                                         "NEZHA_NO_PREFILL_KERNEL", card,
                                         tokens=True)
        if engine.prefill_kernel_active:
            fail("NEZHA_NO_PREFILL_KERNEL: the engine still prefills "
                 "through B9")
    expect_launches("NEZHA_NO_PREFILL_KERNEL", launches, {
        "paged_decode": layers * st["step_calls"]})
    if st.pop("greedy") != xla_tokens:
        fail("NEZHA_NO_PREFILL_KERNEL: the tokens differ from "
             "prefill_impl='xla''s")
    stats["no_prefill_kernel"], paths["serve_no_prefill_kernel"] = (
        st, launches)
    _, kernel_launches, kernel = modes_run(model, modes_config(),
                                           "the kernel path", card,
                                           tokens=True)
    with env_switch("NEZHA_NO_DECODE_KERNEL"):
        _, launches, st = modes_run(model, modes_config(),
                                    "NEZHA_NO_DECODE_KERNEL", card,
                                    tokens=True)
    expect_launches("NEZHA_NO_DECODE_KERNEL", launches, {
        "paged_prefill": layers * st["prefill_chunks"]})
    if launches["paged_prefill"] != kernel_launches["paged_prefill"]:
        fail(f"NEZHA_NO_DECODE_KERNEL: B9 {launches['paged_prefill']}, "
             f"the kernel path's {kernel_launches['paged_prefill']}")
    reference = xla_reference(model)
    prompts = serve_prompts(model.cfg.vocab_size)
    got, want = st.pop("greedy"), kernel.pop("greedy")
    agreed = [agree_to_divergence(f"NEZHA_NO_DECODE_KERNEL r{i}",
                                  reference, p, want[f"r{i}"], got[f"r{i}"])
              for i, p in enumerate(prompts)]
    st["tokens_agreed"] = [n for n, _ in agreed]
    stats["no_decode_kernel"], paths["serve_no_decode_kernel"] = (
        st, launches)
    del reference
    return stats, paths


def serve_wire(card: str) -> dict:
    """Phase 5c: the host KV tier, migration in one process, the HTTP
    front end with a drain, and ``--prefill-impl xla``, GPT-2 124M at
    full width. -> the launches of each path."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset

    t0 = time.perf_counter()
    model = gpt2_for_preset("full", seed=0, device="cuda")
    model.eval()
    paths = {}
    tier, paths["serve_wire_tier"] = host_tier_run(model, WIRE_HOST_BLOCKS,
                                                   card)
    cold, paths["serve_wire_no_tier"] = host_tier_run(model, 0, card)
    print(json.dumps({"serve_wire": {"tier": tier, "no_tier": cold}}),
          flush=True)
    if not (tier["demotions"] > 0 and tier["promotions"] > 0):
        fail(f"serve_wire: the tier demoted {tier['demotions']}, promoted "
             f"{tier['promotions']}")
    if cold["demotions"] or cold["promotions"] or tier["promote_failures"]:
        fail(f"serve_wire: without the tier {cold['demotions']} "
             f"demotions, {cold['promotions']} promotions; "
             f"{tier['promote_failures']} failed promotes")
    b10 = "paged_quant_prefill"
    if tier["launches"][b10] >= cold["launches"][b10]:
        fail(f"serve_wire: {b10} launched {tier['launches'][b10]} times "
             f"with the tier, {cold['launches'][b10]} without")
    for kv_dtype in ("bf16", "int8"):
        stats, paths[f"serve_wire_migrate_{kv_dtype}"] = migrate_once(
            model, kv_dtype, card)
        print(json.dumps({"serve_wire": {f"migrate_{kv_dtype}": stats}}),
              flush=True)
    stats, paths["serve_wire_http"] = http_drain(model, card)
    print(json.dumps({"serve_wire": {"http": stats}}), flush=True)
    stats, xla_paths = prefill_xla(model, card)
    paths.update(xla_paths)
    xla_tokens = stats["bf16"].pop("greedy")
    stats["int8"].pop("greedy")
    print(json.dumps({"serve_wire": {"prefill_xla": stats}}), flush=True)
    stats, switch_paths = kernel_switches(model, card, xla_tokens)
    paths.update(switch_paths)
    print(json.dumps({"serve_wire": {"kernel_switches": stats}}),
          flush=True)
    print(json.dumps({"serve_wire_wall_s": time.perf_counter() - t0}),
          flush=True)
    return paths


# ---------------------------------------------------------- serve_fleet
# The fleet's engine shape and probe cadence (every replica: GPT-2 124M at
# full width, blocks of 16, 1024 positions, 256-wide prefill chunks, eight
# slots and the default pool of 1 + 8 x 64 blocks, ~0.3 GB bf16 a
# replica, so two replicas and the smoke's own engines fit one card).
FLEET_NEW = 32
FLEET_ARGV = ["--random-init", "--max-len", "1024", "--max-prefill-len",
              "256", "--kv-block-size", "16", "--max-batch-size", "8",
              "--max-new-tokens", "96", "--http", "0",
              "--probe-interval", "0.1", "--digest-interval", "0.5",
              "--restart-backoff", "0.25", "--drain-timeout", "30"]
FLEET_PREFIX = 256          # the shared prefix of the affinity prompts
FLEET_TAILS = (20, 33, 47, 61)
FLEET_KILL_NEW = 96         # long enough to be in flight at the kill
FLEET_MEM_RTOL = 0.05       # the card's used memory after the restart
FLEET_START_S = 300         # the longest a fleet may take to go live


def fleet_prompts(vocab: int):
    """The serve phase's eight prompts and four that share a
    FLEET_PREFIX-token prefix (seeded)."""
    g = torch.Generator().manual_seed(7)
    prefix = torch.randint(0, vocab, (FLEET_PREFIX,), generator=g).tolist()
    shared = [prefix + torch.randint(0, vocab, (n,), generator=g).tolist()
              for n in FLEET_TAILS]
    return serve_prompts(vocab), shared


def fleet_cli(argv, run_dir: str):
    """A fleet front end of the serve CLI in a thread of this process ->
    (its server, its drain event, the thread, start-up seconds until
    every replica is live)."""
    import threading

    from nezha_tpu_torch.cli import serve as serve_cli

    args = serve_cli.build_parser().parse_args(
        FLEET_ARGV + argv + ["--run-dir", run_dir])
    box, ready, drain = {}, threading.Event(), threading.Event()

    def cb(srv):
        box["server"] = srv
        ready.set()

    t0 = time.perf_counter()
    th = threading.Thread(target=lambda: box.setdefault(
        "rc", serve_cli.run(args, ready_cb=cb, drain_event=drain)),
        daemon=True)
    th.start()
    if not ready.wait(FLEET_START_S):
        fail(f"serve_fleet {argv}: the front end did not start")
    srv = box["server"]
    want = len(srv.supervisor.replicas())
    fleet_wait_live(srv.server_address[1], want, f"serve_fleet {argv}")
    return srv, drain, th, box, time.perf_counter() - t0


def fleet_wait_live(port: int, want: int, what: str) -> dict:
    t_end = time.monotonic() + FLEET_START_S
    while True:
        try:
            code, health = http_call(port, "GET", "/healthz")
        except OSError:
            code, health = None, {}
        if code == 200 and health.get("replicas_live") == want and all(
                r["state"] == "live" and r["healthy"]
                for r in health["replicas"]):
            return health
        if time.monotonic() > t_end:
            fail(f"{what}: {want} replicas never went live ({health})")
        time.sleep(0.05)


def fleet_post_all(port: int, bodies) -> list:
    """POST every body to the front end at once -> (status, answer) in
    order."""
    import threading

    out = [None] * len(bodies)

    def post(i):
        try:
            out[i] = http_call(port, "POST", "/generate", bodies[i])
        except Exception as e:
            out[i] = (None, {"error": f"{type(e).__name__}: {e}"})

    threads = [threading.Thread(target=post, args=(i,), daemon=True)
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    return out


def fleet_engines(srv):
    """The thread fleet's schedulers, by rid."""
    return [r.handle.worker._sched for r in srv.supervisor.replicas()]


def fleet_engine_counts(scheds) -> list:
    return [(s.engine.prefill_chunks, s.engine.step_calls) for s in scheds]


class DeviceKernels:
    """The device kernels launched inside the block, by name, from
    torch.profiler (CUPTI sees every thread's launches): one warm-up
    cycle first, as profiled_kernels takes, since CUPTI drops events
    while it starts up."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, schedule
        # Device activity only: recording every thread's host ops slows
        # a fleet's decode loops by an order of magnitude.
        self.prof = profile(activities=[ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=1,
                                              repeat=1))
        self.prof.__enter__()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        self.prof.step()
        return self

    def __exit__(self, *exc):
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        self.prof.step()
        self.prof.__exit__(None, None, None)
        self.counts = {}
        for e in self.prof.events():
            if e.device_type == DeviceType.CUDA:
                name = kernel_name(e.name)
                self.counts[name] = self.counts.get(name, 0) + 1
        return False


def fleet_stats(port: int) -> dict:
    code, stats = http_call(port, "GET", "/stats")
    if code != 200:
        fail(f"serve_fleet: /stats answered {code}")
    return stats


def fleet_router_counts(stats: dict) -> dict:
    c = stats["router"]["counters"]
    return {k: c.get(f"router.{k}_total", 0)
            for k in ("retries", "failovers", "replica_restarts",
                      "migrate_fallbacks", "affinity_wins")}


def fleet_route_s(stats: dict) -> dict:
    h = stats["router"]["histograms"].get("router.route_s", {})
    return {"count": h.get("count"), "p50": h.get("p50"),
            "p99": h.get("p99")}


def fleet_view(model, kv_dtype: str, answers: dict, prompts: dict):
    """A single engine on the fleet's weights and the answers as
    cross_check reads them."""
    import types

    from nezha_tpu_torch.serve import Engine, RequestResult, ServeConfig

    engine = Engine(model, ServeConfig(max_batch_size=8, max_len=1024,
                                       max_prefill_len=256,
                                       kv_block_size=16, kv_dtype=kv_dtype))
    reqs = [types.SimpleNamespace(request_id=rid, prompt=prompts[rid])
            for rid in answers if answers[rid]["tokens"]]
    view = types.SimpleNamespace(engine=engine, results={
        rid: RequestResult(rid, a["tokens"], a["finish_reason"], None, 0.0)
        for rid, a in answers.items()})
    return view, reqs


def fleet_thread(model, card: str, tmp: str):
    """(a) ``--replicas 2 --replica-backend thread`` with affinity on."""
    import threading

    from nezha_tpu_torch.obs import parse_prometheus
    from nezha_tpu_torch.obs.timeseries import metric_value

    run_dir = os.path.join(tmp, "thread")
    srv, drain, th, box, start_s = fleet_cli(
        ["--replicas", "2", "--replica-backend", "thread",
         "--affinity-routing", "on"], run_dir)
    port = srv.server_address[1]
    scheds = fleet_engines(srv)
    vocab = model.cfg.vocab_size
    plain, shared = fleet_prompts(vocab)
    prompts = {f"f{i}": p for i, p in enumerate(plain)}
    prompts.update({f"s{i}": p for i, p in enumerate(shared)})
    torch.cuda.synchronize()
    before = fleet_engine_counts(scheds)
    zero_serve_launches()
    t0 = time.perf_counter()
    first = fleet_post_all(port, [
        {"id": rid, "prompt_tokens": prompts[rid],
         "max_new_tokens": FLEET_NEW}
        for rid in prompts if rid.startswith("f")])
    s0 = fleet_post_all(port, [{"id": "s0", "prompt_tokens": shared[0],
                                "max_new_tokens": FLEET_NEW}])
    # One digest interval and two probes: the holder advertises it.
    time.sleep(0.5 + 0.2)
    holder, hits_before = [], []
    for i, s in enumerate(scheds):
        with s._lock:
            if (len(s.engine.pool.trie.match(shared[0]))
                    >= FLEET_PREFIX // 16):
                holder.append(i)
            hits_before.append(s.engine.pool.prefix_hits)
    rest = fleet_post_all(port, [
        {"id": f"s{i}", "prompt_tokens": shared[i],
         "max_new_tokens": FLEET_NEW} for i in range(1, len(shared))])
    traffic_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = scheds[0].engine.kernel_launches()
    after = fleet_engine_counts(scheds)
    chunks = sum(a[0] - b[0] for a, b in zip(after, before))
    steps = sum(a[1] - b[1] for a, b in zip(after, before))
    layers = model.cfg.num_layers
    expect_launches("serve_fleet thread", launches, {
        "paged_prefill": layers * chunks, "paged_decode": layers * steps})
    # The profiler over both worker threads: one request on each replica
    # at once (CUPTI's tracing slows the GIL-shared loops several times,
    # so it covers this window, not the whole traffic).
    # The profiler drops kernel events now and then (ROADMAP C3): a
    # profile that saw fewer launches than the wrappers counted is taken
    # again with a fresh pair, up to PROFILE_ATTEMPTS times; one that saw
    # more, or the last attempt short, fails.
    ports = [r.port for r in srv.supervisor.replicas()]
    pairs, retakes = [], []
    for attempt in range(PROFILE_ATTEMPTS):
        pair = [None, None]

        def direct(i):
            rid = f"p{i}" if not attempt else f"p{i}r{attempt}"
            prompts[rid] = plain[2 + i]
            pair[i] = http_call(ports[i], "POST", "/generate", {
                "id": rid, "prompt_tokens": plain[2 + i],
                "max_new_tokens": FLEET_NEW})

        zero_serve_launches()
        with DeviceKernels() as dk:
            both = [threading.Thread(target=direct, args=(i,))
                    for i in (0, 1)]
            for t in both:
                t.start()
            for t in both:
                t.join(300)
        pairs += pair
        prof_launches = scheds[0].engine.kernel_launches()
        after2 = fleet_engine_counts(scheds)
        per = [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after2, after)]
        after = after2
        prof = {name: dk.counts.get(name, 0) for name in
                ("paged_prefill_kernel", "paged_decode_split_kernel")}
        want = {"paged_prefill": layers * sum(c for c, _ in per),
                "paged_decode": layers * sum(n for _, n in per)}
        expect_launches("serve_fleet thread, profiled", prof_launches, want)
        for name, n in want.items():
            launches[name] += n
        chunks += sum(c for c, _ in per)
        steps += sum(n for _, n in per)
        seen = (prof["paged_prefill_kernel"],
                prof["paged_decode_split_kernel"])
        wanted = (want["paged_prefill"], want["paged_decode"])
        if min(n for _, n in per) and seen == wanted:
            break
        if (min(n for _, n in per) == 0 or attempt == PROFILE_ATTEMPTS - 1
                or any(a > b for a, b in zip(seen, wanted))):
            fail(f"serve_fleet thread: the profiler saw {prof}; the "
                 f"engines ran (chunks, steps) {per} (earlier attempts "
                 f"{retakes})")
        retakes.append({"profiler": prof, "engines": per})
    answers = {}
    for (code, ans) in first + s0 + rest + pairs:
        if code != 200 or ans.get("finish_reason") not in ("length", "eos"):
            fail(f"serve_fleet thread: a request answered {code} {ans}")
        answers[ans["id"]] = ans
    stats = fleet_stats(port)
    router = fleet_router_counts(stats)
    tokens = sum(len(a["tokens"]) for a in answers.values())
    served = stats["fleet"]["counters"].get("serve.tokens_total")
    if served != tokens:
        fail(f"serve_fleet thread: /stats counts {served} tokens, the "
             f"answers hold {tokens}")
    if (router["retries"], router["failovers"],
            router["replica_restarts"]) != (0, 0, 0):
        fail(f"serve_fleet thread: router counts {router}")
    if router["affinity_wins"] < 1:
        fail(f"serve_fleet thread: no affinity win ({router})")
    hits_after = [s.engine.pool.prefix_hits for s in scheds]
    if len(holder) != 1 or hits_after[holder[0]] <= hits_before[holder[0]]:
        fail(f"serve_fleet thread: the prefix holder {holder} took no hit "
             f"({hits_before} -> {hits_after})")
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    exposed = metric_value(parse_prometheus(text),
                           "nezha_serve_tokens_total")
    if exposed != tokens:
        fail(f"serve_fleet thread: /metrics exposes {exposed} tokens, the "
             f"answers hold {tokens}")
    for s in scheds:
        with s._lock:
            s.engine.pool.leak_check()
    drain.set()
    th.join(120)
    if th.is_alive() or box.get("rc") != 0:
        fail(f"serve_fleet thread: the front end ended {box.get('rc')}")
    view, reqs = fleet_view(model, "bf16", answers, prompts)
    cross_check(model, view, reqs, SERVE_LOGIT_ATOL)
    out = {"start_s": start_s, "traffic_s": traffic_s, "tokens": tokens,
           "prefill_chunks": chunks, "decode_steps": steps,
           "launches": launches, "profiled": {"engines": per,
                                              "kernels": prof,
                                              "retakes": retakes},
           "router": router,
           "route_s": fleet_route_s(stats), "holder": holder,
           "prefix_hits": hits_after, "card": card}
    return out, launches


def card_used_mib() -> float:
    """The card's used memory, as ``nvidia-smi`` reads it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(smi.stdout.strip().splitlines()[0])


def card_files(pid: int) -> list:
    """The ``/dev/nvidia*`` files process ``pid`` holds open: the
    driver opens them when a process initializes CUDA and makes its
    context (``nvidia-smi``'s per-process list does not resolve pids
    across a pid namespace, so the process's own descriptors are read).
    None when the process is gone."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return None
    out = []
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return sorted(set(out))


def fleet_top(port: int) -> dict:
    """``nezha-top`` (``cli/top.py``'s ``main``) polling the front end's
    ``/metrics`` twice, half a second apart: it exits 0 and each frame
    shows ``replicas live 2`` and a ``tokens/s`` row. -> the frames'
    rows."""
    from nezha_tpu_torch.cli import top as top_cli

    t0 = time.perf_counter()
    rc, out = cli_stdout(top_cli.main, [
        f"http://127.0.0.1:{port}", "--iterations", "2", "--interval",
        "0.5", "--no-clear"])
    wall = time.perf_counter() - t0
    frames = [[]]
    for line in out:
        if line.startswith("nezha-top") and frames[-1]:
            frames.append([])
        frames[-1].append(line)
    rows = [{line[2:22].strip(): line[22:].split() for line in f[2:]}
            for f in frames]
    if rc != 0 or len(rows) != 2 or not all(
            r.get("replicas live") == ["2"] and "tokens/s" in r
            for r in rows):
        fail(f"serve_fleet process: nezha-top exited {rc}: {out}")
    return {"frames": rows, "wall_s": wall}


def fleet_process(model, card: str, tmp: str):
    """(b) ``python -m nezha_tpu_torch.cli.serve --random-init --replicas
    2 --http 0`` as a subprocess, no ``--device``: the replicas hold the
    card and the front end does not; SIGKILL of replica 0 with four
    requests in flight; the restart; SIGTERM's rolling drain."""
    import signal
    import threading

    run_dir = os.path.join(tmp, "process")
    cmd = [sys.executable, "-m", "nezha_tpu_torch.cli.serve"] + [
        a for a in FLEET_ARGV] + ["--replicas", "2", "--run-dir", run_dir]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdin=subprocess.DEVNULL,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    lines, got_port = [], threading.Event()
    box = {}
    mib_idle = card_used_mib()

    def read():
        for line in proc.stderr:
            lines.append(line)
            m = re.search(r"router listening on http://127\.0\.0\.1:(\d+)",
                          line)
            if m:
                box["port"] = int(m.group(1))
                got_port.set()

    threading.Thread(target=read, daemon=True).start()
    try:
        if not got_port.wait(FLEET_START_S):
            fail(f"serve_fleet process: no front end ({''.join(lines)})")
        port = box["port"]
        health = fleet_wait_live(port, 2, "serve_fleet process")
        start_s = time.perf_counter() - t0
        pids = {r["rid"]: r["pid"] for r in health["replicas"]}
        plain, shared = fleet_prompts(model.cfg.vocab_size)
        prompts = {f"p{i}": p for i, p in enumerate(plain)}
        warm = fleet_post_all(port, [
            {"id": rid, "prompt_tokens": p, "max_new_tokens": FLEET_NEW}
            for rid, p in prompts.items()])
        files = {"front_end": card_files(proc.pid),
                 **{f"replica{rid}": card_files(pid)
                    for rid, pid in pids.items()}}
        if files["front_end"] != [] or not all(
                files[f"replica{rid}"] for rid in pids):
            fail(f"serve_fleet process: the card files held: {files} "
                 f"(front end {proc.pid}, replicas {pids})")
        top = fleet_top(port)
        mem_before = card_used_mib()
        # Fresh prompts: no digest covers them, so least-loaded routing
        # spreads the four over both replicas.
        g = torch.Generator().manual_seed(11)
        kill_ids = [f"k{i}" for i in range(4)]
        for rid in kill_ids:
            prompts[rid] = torch.randint(0, model.cfg.vocab_size, (300,),
                                         generator=g).tolist()
        answers = [None]
        killer = threading.Thread(target=lambda: answers.__setitem__(
            0, fleet_post_all(port, [
                {"id": rid, "prompt_tokens": prompts[rid],
                 "max_new_tokens": FLEET_KILL_NEW} for rid in kill_ids])),
            daemon=True)
        killer.start()
        t_end = time.monotonic() + 120
        while True:
            _, h = http_call(port, "GET", "/healthz")
            flights = [r["in_flight"] for r in h["replicas"]]
            if sum(flights) == len(kill_ids) and flights[0] > 0:
                break
            if time.monotonic() > t_end:
                fail(f"serve_fleet process: the four requests never were "
                     f"in flight on both replicas ({flights})")
            time.sleep(0.01)
        before_kill = fleet_router_counts(fleet_stats(port))
        os.kill(pids[0], signal.SIGKILL)
        t_kill = time.perf_counter()
        killer.join(300)
        killed = answers[0]
        outcomes = {}
        for rid, (code, ans) in zip(kill_ids, killed):
            if code == 200 and ans.get("finish_reason") in ("length",
                                                            "eos"):
                outcomes[rid] = "served"
            elif code == 502 and ans.get("error_type") == "replica_lost":
                outcomes[rid] = "replica_lost"
            else:
                fail(f"serve_fleet process: {rid} answered {code} {ans}")
        health = fleet_wait_live(port, 2, "serve_fleet process restart")
        restart_s = time.perf_counter() - t_kill
        new_pid = health["replicas"][0]["pid"]
        if new_pid == pids[0]:
            fail("serve_fleet process: replica 0 kept its killed pid")
        stats = fleet_stats(port)
        router = fleet_router_counts(stats)
        # What the kill explains: each request replica 0 held is sent
        # once more, to replica 1, and replica 0 restarts once; nothing
        # before the kill.
        explained = {"retries": flights[0], "failovers": flights[0],
                     "replica_restarts": 1}
        if any(before_kill[k] for k in explained) or any(
                router[k] != n for k, n in explained.items()):
            fail(f"serve_fleet process: router counts {before_kill} before "
                 f"the kill, {router} after it; the kill explains "
                 f"{explained}")
        # The restarted replica serves, directly, what the first served.
        rport = health["replicas"][0]["port"]
        direct = {}
        warm_ids = list(prompts)[:len(plain)]
        for rid, (code, ans) in zip(warm_ids, fleet_post_all(rport, [
                {"id": f"d{rid}", "prompt_tokens": prompts[rid],
                 "max_new_tokens": FLEET_NEW} for rid in warm_ids])):
            if code != 200:
                fail(f"serve_fleet process: the restarted replica "
                     f"answered {code} {ans}")
            direct[f"d{rid}"] = ans
            prompts[f"d{rid}"] = prompts[rid]
        pids_after = {0: new_pid, 1: pids[1]}
        if card_files(proc.pid) != [] or not card_files(new_pid) \
                or card_files(pids[0]):
            fail(f"serve_fleet process: after the restart the front end "
                 f"holds {card_files(proc.pid)}, the new replica "
                 f"{card_files(new_pid)}, the killed one "
                 f"{card_files(pids[0])}")
        mem_after = card_used_mib()
        if abs(mem_after - mem_before) > FLEET_MEM_RTOL * mem_before:
            fail(f"serve_fleet process: the card used {mem_before} MiB "
                 f"before the kill, {mem_after} MiB after the restart")
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(180)
        except subprocess.TimeoutExpired:
            fail("serve_fleet process: SIGTERM did not end the front end")
        drain_s = time.perf_counter() - t_term
        if rc != 0:
            fail(f"serve_fleet process: the front end exited {rc}: "
                 f"{''.join(lines[-20:])}")
        left = [pid for pid in pids_after.values() if card_files(pid)]
        if left:
            fail(f"serve_fleet process: replicas {left} outlived the drain")
        mib_drained = card_used_mib()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    answers = {}
    for code, ans in warm:
        if code != 200:
            fail(f"serve_fleet process: a request answered {code} {ans}")
        answers[ans["id"]] = ans
    for rid, (code, ans) in zip(kill_ids, killed):
        if code == 200:
            answers[rid] = ans
    answers.update(direct)
    view, reqs = fleet_view(model, "bf16", answers, prompts)
    cross_check(model, view, reqs, SERVE_LOGIT_ATOL)
    return {"start_s": start_s, "restart_s": restart_s, "drain_s": drain_s,
            "kill_outcomes": outcomes, "in_flight_at_kill": flights,
            "router": router,
            "route_s": fleet_route_s(stats),
            "card_mib_idle": mib_idle, "card_mib_before_kill": mem_before,
            "card_mib_after_restart": mem_after,
            "card_mib_after_drain": mib_drained, "card_files": files,
            "front_end_pid": proc.pid, "top": top,
            "replica_pids": pids, "restarted_pid": new_pid, "card": card}


def fleet_disagg(model, card: str, tmp: str):
    """(c) ``--prefill-replicas 1 --decode-replicas 1 --kv-dtype int8``,
    thread backend."""
    run_dir = os.path.join(tmp, "disagg")
    srv, drain, th, box, start_s = fleet_cli(
        ["--prefill-replicas", "1", "--decode-replicas", "1", "--kv-dtype",
         "int8", "--replica-backend", "thread"], run_dir)
    port = srv.server_address[1]
    scheds = fleet_engines(srv)
    roles = [r.role for r in srv.supervisor.replicas()]
    pre, dec = scheds[roles.index("prefill")], scheds[roles.index("decode")]
    plain, _ = fleet_prompts(model.cfg.vocab_size)
    prompts = {f"m{i}": p for i, p in enumerate(plain)}
    torch.cuda.synchronize()
    before = fleet_engine_counts([pre, dec])
    zero_serve_launches()
    t0 = time.perf_counter()
    got = fleet_post_all(port, [
        {"id": rid, "prompt_tokens": p, "max_new_tokens": FLEET_NEW}
        for rid, p in prompts.items()])
    traffic_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = pre.engine.kernel_launches()
    after = fleet_engine_counts([pre, dec])
    (pc, ps), (dc, ds) = [(a[0] - b[0], a[1] - b[1])
                          for a, b in zip(after, before)]
    answers = {}
    migrated = 0
    for code, ans in got:
        if code != 200 or ans.get("finish_reason") not in ("length", "eos"):
            fail(f"serve_fleet disagg: a request answered {code} {ans}")
        mig = ans.get("migration") or {}
        if "fallback" in mig:
            fail(f"serve_fleet disagg: {ans['id']} fell back: {mig}")
        migrated += int(mig.get("installed", 0) > 0)
        answers[ans["id"]] = ans
    layers = model.cfg.num_layers
    if ps != 0:
        fail(f"serve_fleet disagg: the prefill replica decoded {ps} steps")
    expect_launches("serve_fleet disagg", launches, {
        "paged_quant_prefill": layers * (pc + dc),
        "paged_quant_decode": layers * ds})
    stats = fleet_stats(port)
    router = fleet_router_counts(stats)
    if (router["retries"], router["failovers"], router["replica_restarts"],
            router["migrate_fallbacks"]) != (0, 0, 0, 0):
        fail(f"serve_fleet disagg: router counts {router}")
    with pre._lock:
        parked = pre.parked_count
        pre.engine.pool.leak_check()
    with dec._lock:
        dec.engine.pool.leak_check()
    if parked:
        fail(f"serve_fleet disagg: {parked} parks left after the ACKs")
    drain.set()
    th.join(120)
    if th.is_alive() or box.get("rc") != 0:
        fail(f"serve_fleet disagg: the front end ended {box.get('rc')}")
    with open(os.path.join(run_dir, "spans.jsonl")) as f:
        spans = [json.loads(line) for line in f if line.strip()]
    n_migrate = sum(1 for s in spans if s["name"] == "router.migrate")
    if n_migrate != len(prompts):
        fail(f"serve_fleet disagg: {n_migrate} router.migrate spans for "
             f"{len(prompts)} requests")
    view, reqs = fleet_view(model, "int8", answers, prompts)
    cross_check(model, view, reqs, INT8_SERVE_LOGIT_ATOL)
    return {"start_s": start_s, "traffic_s": traffic_s,
            "prefill_chunks": {"prefill": pc, "decode": dc},
            "decode_steps": ds, "migrated": migrated,
            "router_migrate_spans": n_migrate, "launches": launches,
            "router": router, "route_s": fleet_route_s(stats),
            "card": card}, launches


def serve_fleet(card: str) -> dict:
    """Phase 5d: the multi-replica fleet through the serve CLI, GPT-2 124M
    at full width. -> the launches of the thread fleets' paths."""
    import tempfile

    from nezha_tpu_torch.cli.common import gpt2_for_preset

    t0 = time.perf_counter()
    model = gpt2_for_preset("full", seed=0, device="cuda")
    model.eval()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        stats, paths["serve_fleet_thread"] = fleet_thread(model, card, tmp)
        print(json.dumps({"serve_fleet": {"thread": stats}}), flush=True)
        stats = fleet_process(model, card, tmp)
        print(json.dumps({"serve_fleet": {"process": stats}}), flush=True)
        stats, paths["serve_fleet_disagg_int8"] = fleet_disagg(model, card,
                                                               tmp)
        print(json.dumps({"serve_fleet": {"disagg_int8": stats}}),
              flush=True)
    print(json.dumps({"serve_fleet_wall_s": time.perf_counter() - t0}),
          flush=True)
    return paths


_REFERENCES = None


def xla_reference(model):
    """A copy of ``model`` with ``attn_impl="xla"`` (so it runs no
    kernel) in eval mode, built once per model object: the no-cache
    reference of cross_check and the margin rule."""
    import weakref

    from nezha_tpu_torch.models.gpt2 import GPT2

    global _REFERENCES
    if _REFERENCES is None:
        _REFERENCES = weakref.WeakKeyDictionary()
    ref = _REFERENCES.get(model)
    if ref is None:
        ref = GPT2(dataclasses.replace(model.cfg, attn_impl="xla"),
                   policy=model.policy, device="cuda")
        ref.load_state_dict(model.state_dict())
        ref.eval()
        _REFERENCES[model] = ref
    return ref


@torch.no_grad()
def cross_check(model, sched, reqs, atol: float) -> None:
    """Every request against the no-cache causal forward with composed
    attention (a copy of the model with ``attn_impl="xla"``, so the
    reference runs no kernel) over prompt + generated tokens
    (teacher-forced): the prompt's last-position logits from a fresh
    paged prefill must lie within ``atol``, and each generated token must
    be the reference argmax wherever the reference's top-2 margin exceeds
    it."""
    engine = sched.engine
    reference = xla_reference(model)
    worst = 0.0
    checked = 0
    for r in reqs:
        res = sched.results[r.request_id]
        seq = list(r.prompt) + res.tokens[:-1]
        ref = reference(torch.tensor([seq], device="cuda"))[0]  # [T, V]
        n = len(r.prompt)
        slot = engine.pool.alloc()
        try:
            engine.prefill(slot, r.prompt, max_new_tokens=1)
            got = engine.last_logits[slot].clone()
        finally:
            engine.pool.free(slot)
        err = (got - ref[n - 1]).abs().max().item()
        worst = max(worst, err)
        if not math.isfinite(err) or err > atol:
            fail(f"{r.request_id}: last-position logits differ by {err} > "
                 f"{atol}")
        steps = ref[n - 1:n - 1 + len(res.tokens)]
        top2 = steps.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        want = steps.argmax(dim=-1).tolist()
        for i, tok in enumerate(res.tokens):
            if margin[i].item() > atol:
                checked += 1
                if tok != want[i]:
                    fail(f"{r.request_id} token {i}: served {tok}, "
                         f"reference {want[i]} (margin "
                         f"{margin[i].item():.4f})")
    engine.pool.leak_check()
    print(json.dumps({"kv_dtype": engine.cfg.kv_dtype,
                      "cross_check_max_logit_err": worst,
                      "tolerance": atol, "tokens_checked": checked}),
          flush=True)


@torch.no_grad()
def generate_phase(card: str):
    """KV-cache generation of GPT-2 124M with the LayerNorm kernels:
    greedy, timed, launch-counted and cross-checked, then one sampled
    call; -> the greedy run's launches, and its LayerNorm forward
    launches by row count (the prefill's GEN_B x GEN_PROMPT rows once,
    then GEN_B rows a decode step)."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.models import GPT2, generate, init_cache
    from nezha_tpu_torch.ops.cuda import flash_decode_attention
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.ops.cuda.layer_norm import (FWD_LAUNCHES_BY_ROWS,
                                                     LAUNCHES as LN_LAUNCHES)

    model = gpt2_for_preset("full", seed=0, device="cuda", ln_impl="pallas")
    model.eval()
    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, vocab, (GEN_B, GEN_PROMPT), generator=g).cuda()
    generate(model, prompt[:, :16], 4)          # warm-up
    torch.cuda.synchronize()
    for c in (LAUNCHES, LN_LAUNCHES):
        for name in c:
            c[name] = 0
    flash_decode_attention.launches = 0
    FWD_LAUNCHES_BY_ROWS.clear()
    t0 = time.perf_counter()
    out = generate(model, prompt, GEN_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**LAUNCHES, **LN_LAUNCHES,
                "flash_decode": flash_decode_attention.launches}
    want = {"flash_fwd": layers, "flash_bwd_dq": 0, "flash_bwd_delta": 0,
            "flash_bwd_dkv": 0, "flash_decode": (GEN_NEW - 1) * layers,
            "layer_norm_fwd": GEN_NEW * (2 * layers + 1),
            "layer_norm_bwd": 0, "layer_norm_bwd_sums": 0}
    if launches != want:
        fail(f"generate: launches {launches}, expected {want}")
    ln_rows = dict(FWD_LAUNCHES_BY_ROWS)
    per_fwd = 2 * layers + 1
    if ln_rows != {GEN_B * GEN_PROMPT: per_fwd,
                   GEN_B: (GEN_NEW - 1) * per_fwd}:
        fail(f"generate: LayerNorm forward launches by rows {ln_rows}")
    t0 = time.perf_counter()
    generate(model, prompt, 1)                  # prefill + first token
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    print(json.dumps({"generate": {
        "B": GEN_B, "prompt_len": GEN_PROMPT, "new_tokens": GEN_NEW,
        "ln_impl": "pallas", "wall_s": wall, "ttft_s": ttft,
        "decode_ms_per_step": (wall - ttft) / (GEN_NEW - 1) * 1e3,
        "tokens_per_s": GEN_B * GEN_NEW / wall, "launches": launches,
        "layer_norm_fwd_by_rows": ln_rows, "card": card}}), flush=True)

    # Cross-check, teacher-forced, against the no-cache forward of a copy
    # that runs no kernel.
    reference = GPT2(dataclasses.replace(model.cfg, attn_impl="xla",
                                         ln_impl="xla"),
                     policy=model.policy, device="cuda")
    reference.load_state_dict(model.state_dict())
    reference.eval()
    first = model(prompt, cache=init_cache(model, GEN_B, GEN_PROMPT),
                  pos=0, prefill=True)[:, -1]     # generate's own prefill
    ref = reference(out[:, :-1])[:, GEN_PROMPT - 1:]    # [B, N, V]
    err = (first - ref[:, 0]).abs().max().item()
    if not math.isfinite(err) or err > SERVE_LOGIT_ATOL:
        fail(f"generate: prompt's last logits differ by {err} > "
             f"{SERVE_LOGIT_ATOL}")
    top2 = ref.topk(2, dim=-1).values
    checked = (top2[..., 0] - top2[..., 1]) > SERVE_LOGIT_ATOL
    wrong = (out[:, GEN_PROMPT:] != ref.argmax(dim=-1)) & checked
    if wrong.any():
        b, i = map(int, wrong.nonzero()[0])
        fail(f"generate: row {b} token {i} is {int(out[b, GEN_PROMPT + i])}"
             f", reference {int(ref[b, i].argmax())}")
    del ref, top2

    # One sampled call: it finishes, and each token lies in its step's
    # top 40 by the same weights' teacher-forced logits (which differ
    # from the step's own by rounding only: SERVE_LOGIT_ATOL).
    gen = torch.Generator(device="cuda").manual_seed(0)
    sampled = generate(model, prompt, GEN_NEW, temperature=0.8, top_k=40,
                       top_p=0.95, generator=gen)
    own = model(sampled[:, :-1])[:, GEN_PROMPT - 1:]
    kth = own.topk(40, dim=-1).values[..., -1]
    picked = own.gather(-1, sampled[:, GEN_PROMPT:, None])[..., 0]
    outside = int((picked < kth - SERVE_LOGIT_ATOL).sum())
    if sampled.shape != out.shape or outside:
        fail(f"generate: sampled {tuple(sampled.shape)}, {outside} tokens "
             f"outside their step's top 40")
    print(json.dumps({"generate_cross_check": {
        "prompt_logit_err": err, "tokens_checked": int(checked.sum()),
        "tokens": GEN_B * GEN_NEW,
        "sampled_distinct_tokens": int(sampled[:, GEN_PROMPT:].unique()
                                       .numel())}}), flush=True)
    return launches, {"generate": ln_rows}


# The run whose launch count each kernel reports: the path it serves.
# train_dist: the dp and ZeRO-1 steps through NCCL at world 1 against
# the single-device step from the same init and batches. On one rank the
# mean of the gradients (and of the loss and BatchNorm buffers) is x / 1,
# a copy, and ZeRO-1 updates flat chunks of the parameters with the same
# elementwise AdamW formulas (no clip runs here, whose norm alone sums in
# another order), so the weights must be bitwise equal: DIST_WEIGHT_ATOL
# is 0 for both.
DIST_STEPS = 4
DIST_WEIGHT_ATOL = 0.0
# Timed in ABBA rounds of two DIST_STEPS-step windows each: single
# windows of the host clock swing by several ms from call to call.
DIST_ROUNDS = 1
# The int8 wire at world 1: a fixed batch, a constant lr, DIST_INT8_STEPS
# steps; the loss must stay finite and end below the first step's.
DIST_INT8_STEPS = 6
# The CLI: bert_base_zero1 for DIST_CLI_STEPS with a per-shard save every
# DIST_CLI_EVERY, then DIST_CLI_MORE resumed from the last save.
DIST_CLI_STEPS, DIST_CLI_EVERY, DIST_CLI_MORE = 10, 5, 2
# Two ranks on the one card (gloo over CUDA tensors when NCCL refuses):
# GPT-2 124M dp, 4 rows of 1024 tokens a rank, DIST_TWO_STEPS AdamW steps
# at TRAIN_LR. Both ranks must hold bitwise the same weights, and so must
# one process that takes the same two half-batch gradients and averages
# them as the step does (a sum of two addends has one rounding, then the
# division by 2). Against one process over the concatenated 8 rows: every
# row has 1024 tokens, so the mean of the two halves' losses and
# gradients is the batch's, but the half-batch bf16 GEMMs accumulate in
# other orders. So the loss is held to TRAIN_LOSS_ATOL each step, and the
# first step's mean gradient to DIST_TWO_GRAD_RTOL of the 8 rows'
# gradient norm: TRAIN_GRAD_RTOL, the train phase's bound for GPT-2's
# bf16 gradients computed two ways; a dropped or doubled half reads
# about 0.5 and more.
DIST_TWO_STEPS = 2
DIST_TWO_GRAD_RTOL = TRAIN_GRAD_RTOL
DIST_TWO_TIMEOUT_S = {"probe": 90, "train": 240}
# The backends' refusals of two ranks on one device, the only errors the
# two-rank part passes (printed): NCCL's check for ranks sharing a GPU,
# and gloo's for a collective or device type it does not take.
DIST_NCCL_REFUSAL = r"Duplicate GPU detected"
DIST_GLOO_REFUSAL = (r"(?i)unsupported device|device type .* not supported"
                     r"|does not support|not supported for|no backend type "
                     r"associated with device type")


def profile_nccl(step_fn, batches, steps: int) -> dict:
    """``steps`` calls of ``step_fn`` under torch.profiler: a step's NCCL
    device kernels (``ncclDevKernel_*``/``ncclKernel_*``), the spans the
    profiler marks for each NCCL op on the device timeline (``nccl:<op>``)
    and device-to-device copies, each with its launches and device ms;
    and the device's busy ms a step (every kernel, copy and memset; the
    step runs on one stream, so they do not overlap), also by kernel
    (``by_kernel``: name -> ms a step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step_fn(next(batches))
        torch.cuda.synchronize()
    kinds = {"nccl_kernels": {}, "nccl_op_spans": {}, "dtod_copies": {}}
    busy_us, by_kernel = 0.0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name, us = e.name, e.time_range.elapsed_us()
        if name.startswith("nccl:"):
            kind = "nccl_op_spans"   # a span around device work
        elif getattr(e, "is_user_annotation", False):
            continue
        else:
            busy_us += us
            short = kernel_name(name)
            by_kernel[short] = by_kernel.get(short, 0.0) + us / 1e3 / steps
            if name.startswith(("ncclDevKernel", "ncclKernel")):
                kind, name = "nccl_kernels", kernel_name(name)
            elif "dtod" in name.lower():
                kind = "dtod_copies"
            else:
                continue
        n, t = kinds[kind].get(name, (0, 0.0))
        kinds[kind][name] = (n + 1, t + us)
    out = {}
    for kind, d in kinds.items():
        out[kind] = {k: {"per_step": n / steps, "ms_per_step": us / 1e3
                         / steps} for k, (n, us) in d.items()}
        out[f"{kind}_per_step"] = sum(n for n, _ in d.values()) / steps
        out[f"{kind}_ms_per_step"] = sum(us for _, us in d.values()) \
            / 1e3 / steps
    out["device_busy_ms_per_step"] = busy_us / 1e3 / steps
    out["by_kernel"] = by_kernel
    return out


def event_ms(fn, iters: int) -> float:
    """ms a call of ``fn`` between CUDA events around ``iters`` calls,
    after two warm-up calls (the device's time unless the host falls
    behind it)."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_steps(step_fn, batches, steps: int) -> float:
    """ms a step of ``steps`` calls on the host clock, ended by a
    sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step_fn(next(batches))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def dist_config(name: str):
    """(model builder, loss, optimizer builder, batches, the config's
    mode, rows, units a row, unit) at the phase's batch: GPT-2 124M B=8
    S=1024, BERT-base B=16 S=512, ResNet-50 batch IMG_B at IMG_SIZE."""
    from nezha_tpu_torch.cli.train import build_config

    rows = {"gpt2_124m": TRAIN_B, "bert_base_zero1": BERT_B,
            "resnet50_imagenet": IMG_B}[name]

    def build():
        return build_config(name, steps=100, seed=0, device="cuda")

    cfg = build()
    per_row = {"gpt2_124m": TRAIN_S, "bert_base_zero1": BERT_S,
               "resnet50_imagenet": 1}[name]
    unit = "images" if name == "resnet50_imagenet" else "tokens"
    return build, cfg.batches(rows), cfg.parallel_mode, rows, per_row, unit


def compare_weights(what: str, a, b, atol: float) -> float:
    """Every parameter and buffer of ``a`` against ``b``'s; -> the largest
    difference, failing past ``atol``."""
    worst = 0.0
    sb = b.state_dict()
    for k, t in a.state_dict().items():
        if t.is_floating_point():
            worst = max(worst, (t.float() - sb[k].float()).abs().max().item())
        elif not torch.equal(t, sb[k]):
            worst = math.inf
    if not worst <= atol:
        fail(f"train_dist {what}: weights differ by {worst} (bound {atol})")
    return worst


def dist_world1_runs(card: str) -> dict:
    """Part 1: each config's mode (dp, or zero1 for BERT) through NCCL at
    world 1 against the single-device step, from the same init and
    batches. Both steps live at once and take turns in windows of
    DIST_STEPS steps, ABBA over DIST_ROUNDS rounds (window 1 single then
    parallel, window 2 parallel then single, each window's batches the
    same for both), so a drift of the host's clock falls on both sides
    alike; then 2 profiled steps each. Prints ms a step and rate, the
    paired overhead of each round, the device's busy ms a step, the NCCL
    kernels, B1-B3 launches a step and the optimizer state's bytes. ->
    the flash launches of the dp/zero1 runs, by config."""
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.parallel.data_parallel import DPTrainStep
    from nezha_tpu_torch.parallel.zero1 import Zero1TrainStep
    from nezha_tpu_torch.train import make_train_step

    launches = {}
    for name in ("gpt2_124m", "bert_base_zero1", "resnet50_imagenet"):
        build, batches, mode, rows, per_row, unit = dist_config(name)
        windows = 2 * DIST_ROUNDS
        # 2 warm-up steps, the timed windows, 2 profiled: both sides take
        # all of them in the same order, so their weights stay comparable.
        fixed = [next(batches) for _ in range(windows * DIST_STEPS + 4)]
        out = {"mode": mode, "rows": rows, "card": card,
               "steps_per_window": DIST_STEPS, "abba_rounds": DIST_ROUNDS}
        steps, models = {}, {}
        for side in ("single", mode):
            cfg = build()
            if side == "single":
                step = make_train_step(cfg.model, cfg.optimizer, cfg.loss_fn)
            else:
                kind = Zero1TrainStep if mode == "zero1" else DPTrainStep
                step = kind(cfg.model, cfg.optimizer, cfg.loss_fn)
            for b in fixed[:2]:
                step(b)
            steps[side], models[side] = step, cfg.model
        layers = getattr(cfg.model.cfg, "num_layers", 0) \
            if name != "resnet50_imagenet" else 0
        window_ms = {side: [] for side in steps}
        got = {side: {k: 0 for k in LAUNCHES} for side in steps}
        for w in range(windows):
            chunk = fixed[2 + w * DIST_STEPS:2 + (w + 1) * DIST_STEPS]
            order = ("single", mode) if w % 2 == 0 else (mode, "single")
            for side in order:
                for k in LAUNCHES:
                    LAUNCHES[k] = 0
                window_ms[side].append(
                    time_steps(steps[side], iter(chunk), DIST_STEPS))
                for k, n in LAUNCHES.items():
                    if n != layers * DIST_STEPS:
                        fail(f"train_dist {name} {side}: {k} launched {n} "
                             f"times in {DIST_STEPS} steps, not {layers} a "
                             f"step")
                    got[side][k] += n
        total = windows * DIST_STEPS
        for side in steps:
            ms = sum(window_ms[side]) / windows
            out[side] = {"ms_per_step": ms, "window_ms": window_ms[side],
                         f"{unit}_per_s": rows * per_row / ms * 1e3,
                         "flash_launches_per_step": {
                             k: n / total for k, n in got[side].items()},
                         "opt_state_bytes": steps[side].opt_state_bytes(),
                         **profile_nccl(steps[side],
                                        iter(fixed[-2:]), 2)}
        launches[name] = got[mode]
        # Paired: each window's parallel ms less the single side's in the
        # same window.
        paired = [p - s for p, s in zip(window_ms[mode], window_ms["single"])]
        out["extra_ms_per_step"] = sum(paired) / windows
        out["extra_ms_per_window"] = paired
        out["extra_device_busy_ms_per_step"] = \
            out[mode]["device_busy_ms_per_step"] \
            - out["single"]["device_busy_ms_per_step"]
        # The kernels whose device ms a step differ most between the
        # sides: [name, single's, the parallel side's].
        a, b = out["single"].pop("by_kernel"), out[mode].pop("by_kernel")
        out["device_ms_by_kernel_most_apart"] = [
            [k, a.get(k, 0.0), b.get(k, 0.0)] for k in sorted(
                set(a) | set(b),
                key=lambda k: -abs(b.get(k, 0.0) - a.get(k, 0.0)))[:8]]
        out["max_weight_diff"] = compare_weights(
            f"{name} {mode} vs single", models[mode], models["single"],
            DIST_WEIGHT_ATOL)
        out["opt_state_bytes_over_single"] = \
            out[mode]["opt_state_bytes"] / out["single"]["opt_state_bytes"]
        print(json.dumps({f"train_dist_{name}": out}), flush=True)
        del models, steps, cfg, step
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def dist_int8_runs(card: str) -> dict:
    """Part 2: ``grad_reduce="int8"`` for GPT-2 dp and BERT zero1 on a
    fixed batch at a constant lr; the wire's device ms a step against
    fp32's (CUDA events around the reduction of the step's own
    gradients) and its payload bytes. The steps run inside a telemetry
    run, whose collective rows for GPT-2 count the int8 leaves at the
    wire's width and the others at fp32, one record an op a step."""
    import tempfile

    from nezha_tpu_torch import obs
    from nezha_tpu_torch.models.bert import mlm_loss
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.parallel import quantized
    from nezha_tpu_torch.parallel.data_parallel import (DPTrainStep,
                                                        mean_over_group)
    from nezha_tpu_torch.parallel.zero1 import Zero1TrainStep

    res = {}
    for name, kind, loss_fn, lr in (
            ("gpt2_124m", DPTrainStep, lm_loss, TRAIN_LR),
            ("bert_base_zero1", Zero1TrainStep, mlm_loss, BERT_LR)):
        build, batches, _, rows, per_row, unit = dist_config(name)
        batch = next(batches)
        cfg = build()
        step = kind(cfg.model, adamw(lr, weight_decay=0.01), loss_fn,
                    grad_reduce="int8")
        with tempfile.TemporaryDirectory(prefix="nezha_int8_run_") as run:
            obs.start_run(run)
            try:
                losses = [step(batch)["loss"].item()
                          for _ in range(DIST_INT8_STEPS)]
            finally:
                obs.end_run()
            with open(os.path.join(run, "summary.json")) as f:
                coll = {op: row for op, row in
                        json.load(f)["collectives"].items() if row["calls"]}
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            fail(f"train_dist int8 {name}: the loss did not fall: {losses}")
        _, grads = step.loss_and_grads(batch)
        wire = {}
        for reduce in ("fp32", "int8"):
            wire[f"{reduce}_wire_ms"] = event_ms(
                lambda: mean_over_group(grads, {}, None, reduce,
                                        quantized.DEFAULT_MIN_NUMEL), 5)
        quant, exact = quantized.split_quantized_leaves(
            grads, quantized.DEFAULT_MIN_NUMEL)
        if kind is DPTrainStep:
            # The registry's rows: one record an op a step, the int8
            # leaves at the wire's width, the others at fp32.
            want = {"all_reduce_int8": sum(quantized.wire_payload_bytes(
                        g.numel()) for g in quant),
                    "all_reduce": sum(g.numel() * 4 for g in exact)}
            if coll != {op: {"calls": DIST_INT8_STEPS,
                             "payload_bytes": DIST_INT8_STEPS * n}
                        for op, n in want.items()}:
                fail(f"train_dist int8 {name}: collective rows {coll}, "
                     f"expected {DIST_INT8_STEPS} calls of {want}")
        res[name] = {"mode": kind.__name__, "losses": losses,
                     "collective_rows": coll,
                     "ms_per_step": time_steps(step, iter([batch] * 3), 3),
                     **wire,
                     "int8_payload_bytes": sum(
                         quantized.wire_payload_bytes(g.numel())
                         for g in quant)
                     + sum(g.numel() * 4 for g in exact),
                     "fp32_payload_bytes": sum(g.numel() * 4
                                               for g in grads.values()),
                     "card": card}
        del step, cfg, grads
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"train_dist_int8": res}), flush=True)
    return res


def dist_cli() -> dict:
    """Part 3: bert_base_zero1 through the coordinator (port 0, served by
    the run) at world 1 with per-shard saves, then resumed."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="nezha_train_dist_") as tmp:
        common = ["--config", "bert_base_zero1", "--coordinator",
                  "127.0.0.1:0", "--serve-coordinator", "--world-size",
                  "1", "--mesh", "dp=1", "--ckpt-dir", tmp]
        first = cli_run(*common, "--steps", str(DIST_CLI_STEPS),
                        "--ckpt-every", str(DIST_CLI_EVERY))
        names = sorted(os.listdir(tmp))
        want = [f"step_{s:08d}.sharded" for s in
                range(DIST_CLI_EVERY, DIST_CLI_STEPS + 1, DIST_CLI_EVERY)]
        if names != want:
            fail(f"train_dist CLI: saves {names}, not {want}")
        second = cli_run(*common, "--steps", str(DIST_CLI_MORE))
        if not any(f"resumed from step {DIST_CLI_STEPS} (sharded)" in line
                   for line in second["stderr"]):
            fail("train_dist CLI: the rerun did not resume from "
                 f"step_{DIST_CLI_STEPS}.sharded")
        if second["final"]["step"] != DIST_CLI_STEPS + DIST_CLI_MORE:
            fail(f"train_dist CLI: final {second['final']}")
        par = json_lines(first["stderr"], "parallel")
        out = {"parallel": par[0] if par else None,
               "first": {k: first[k] for k in ("wall_s", "final", "saves")},
               "second": {k: second[k] for k in ("wall_s", "final",
                                                 "saves", "restores")}}
    print(json.dumps({"train_dist_cli": out}), flush=True)
    return out


def dist_rank_worker(rank_hint: int, port: int, backend: str, out: str,
                     steps: int) -> None:
    """One of two ranks on the one card (a spawned process): join, start
    the group over ``backend``; ``steps`` 0: one all-reduce; else GPT-2
    124M dp on its 4 rows of each batch for ``steps`` steps, then its
    weights to ``out``, inside a telemetry run whose directory is
    ``out.run/rank<R>`` (the train CLI's ``--run-dir`` layout)."""
    from nezha_tpu_torch import dist as nzdist
    from nezha_tpu_torch import obs
    from nezha_tpu_torch.cli.train import build_config
    from nezha_tpu_torch.parallel.data_parallel import (DPTrainStep,
                                                        local_rows,
                                                        replicate)
    import torch.distributed as tdist

    torch.cuda.set_device(0)
    if steps:
        obs.start_run(f"{out}.run/rank{rank_hint}", meta={
            "config": "gpt2_124m", "steps": steps, "engine": "eager",
            "parallel": "dp", "model_preset": "full"})
    group = nzdist.join("127.0.0.1", port, rank_hint=rank_hint,
                        timeout_s=60)
    result = {"rank": group.rank}
    try:
        nzdist.init_torch_distributed(group, backend, timeout_s=60)
        if not steps:
            x = torch.ones(4, device="cuda")
            tdist.all_reduce(x)
            torch.cuda.synchronize()
            result["all_reduce"] = x.tolist()
        else:
            cfg = build_config("gpt2_124m", steps=100, seed=0,
                               device="cuda")
            from nezha_tpu_torch.models.gpt2 import lm_loss
            from nezha_tpu_torch.optim import adamw
            replicate(cfg.model)
            step = DPTrainStep(cfg.model, adamw(TRAIN_LR, weight_decay=0.1),
                               lm_loss)
            batches = cfg.batches(TRAIN_B)
            losses, t0 = [], time.perf_counter()
            for _ in range(steps):
                losses.append(step(local_rows(next(batches), group.rank,
                                              group.world_size))
                              ["loss"].item())
            result.update(losses=losses, ms_per_step=(
                time.perf_counter() - t0) / steps * 1e3)
            torch.save({k: v.cpu() for k, v in
                        cfg.model.state_dict().items()},
                       f"{out}.rank{group.rank}.pt")
    except Exception as e:
        result["error"] = f"{type(e).__name__}: {e}"[:2000]
    finally:
        with open(f"{out}.rank{group.rank}.json", "w") as f:
            json.dump(result, f)
        if tdist.is_initialized():
            try:
                tdist.destroy_process_group()
            except Exception:
                pass
        group.leave()
        obs.end_run()


def two_ranks(backend: str, tmp: str, steps: int) -> list:
    """Two spawned ranks on cuda:0 over ``backend`` (``steps`` as in
    ``dist_rank_worker``); -> their results, a missing one (a rank that
    crashed, or hung and was killed at DIST_TWO_TIMEOUT_S) as an
    ``error``."""
    import multiprocessing as mp

    from nezha_tpu_torch import dist as nzdist

    ctx = mp.get_context("spawn")
    kind = "probe" if not steps else "train"
    out = os.path.join(tmp, f"{backend}_{kind}")
    with nzdist.Coordinator(world_size=2) as coord:
        procs = [ctx.Process(target=dist_rank_worker,
                             args=(r, coord.port, backend, out, steps))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_TWO_TIMEOUT_S[kind]
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r in range(2):
        path = f"{out}.rank{r}.json"
        results.append(json.load(open(path)) if os.path.exists(path) else
                       {"rank": r, "error": "no result: the rank crashed, "
                        "or hung and was killed"})
    return results


def refusals(results: list, pattern: str) -> bool:
    """True when every rank's error is the backend's refusal of two ranks
    on one device (``pattern``); False when every rank succeeded. Any
    other outcome (another error, a missing result, one rank refused and
    one not) fails the phase."""
    errors = [r.get("error") for r in results]
    if not any(errors):
        return False
    if all(e and re.search(pattern, e) for e in errors):
        return True
    fail(f"train_dist two ranks: {json.dumps(results)[:4000]}")


def adam_move_bound(steps: int, lr: float, b1: float = 0.9,
                    b2: float = 0.999) -> float:
    """The most ``steps`` AdamW updates can move a weight (weight decay
    aside): step t's is lr |m_hat| / sqrt(v_hat), and by Cauchy-Schwarz
    over the gradients so far |m_hat| / sqrt(v_hat) <= sqrt(sum_i a_i^2 /
    c_i), with a_i = (1 - b1) b1^(t-i) / (1 - b1^t) and c_i = (1 - b2)
    b2^(t-i) / (1 - b2^t) (1, 1.0013, 1.0036 for t = 1, 2, 3)."""
    total = 0.0
    for t in range(1, steps + 1):
        total += math.sqrt(sum(
            ((1 - b1) * b1 ** (t - i) / (1 - b1 ** t)) ** 2
            / ((1 - b2) * b2 ** (t - i) / (1 - b2 ** t))
            for i in range(1, t + 1)))
    return lr * total


def grads_rel_err(got: dict, want: dict) -> float:
    """|got - want| / |want| over every leaf together (fp32 norms)."""
    num = sum(float((g.float() - want[k].float()).pow(2).sum())
              for k, g in got.items())
    den = sum(float(w.float().pow(2).sum()) for w in want.values())
    return math.sqrt(num / den)


def two_rank_run_dirs(root: str, grad_bytes: int) -> dict:
    """The two ranks' run dirs: ``rank0/`` and ``rank1/`` each pass the
    port's ``nezha-telemetry --check``, and each counts one
    ``all_reduce`` a step of the gradients' ``grad_bytes``. -> their
    rows."""
    from nezha_tpu_torch.cli import telemetry as telemetry_cli

    rows = {}
    for r in range(2):
        d = os.path.join(root, f"rank{r}")
        rc, _ = cli_stdout(telemetry_cli.main, [d, "--check"])
        if rc != 0:
            fail(f"train_dist two ranks: rank{r}'s run dir fails --check")
        with open(os.path.join(d, "summary.json")) as f:
            row = json.load(f)["collectives"]["all_reduce"]
        if row != {"calls": DIST_TWO_STEPS,
                   "payload_bytes": DIST_TWO_STEPS * grad_bytes}:
            fail(f"train_dist two ranks: rank{r} counted all_reduce {row}, "
                 f"expected {DIST_TWO_STEPS} calls of {grad_bytes} bytes")
        rows[f"rank{r}"] = row
    return {"all_reduce": rows, "grad_bytes": grad_bytes}


def dist_two_ranks(card: str) -> dict:
    """Part 4: NCCL with two ranks on the one card, tried once and its
    answer printed. GPT-2 124M dp at full width then runs over NCCL if it
    took the two ranks, else over gloo on the card's tensors. Only the
    backends' own refusals of two ranks on one device (DIST_NCCL_REFUSAL,
    DIST_GLOO_REFUSAL) are printed and passed; any other error fails."""
    import tempfile

    from nezha_tpu_torch.cli.train import build_config
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.parallel.data_parallel import local_rows
    from nezha_tpu_torch.train import make_train_step

    res = {"card": card}
    with tempfile.TemporaryDirectory(prefix="nezha_two_ranks_") as tmp:
        nccl = two_ranks("nccl", tmp, 0)
        res["nccl"] = nccl
        res["nccl_refused"] = refusals(nccl, DIST_NCCL_REFUSAL)
        if not res["nccl_refused"] and any(r["all_reduce"] != [2.0] * 4
                                           for r in nccl):
            fail(f"train_dist two ranks: NCCL's all-reduce of ones gave "
                 f"{nccl}")
        backend = "gloo" if res["nccl_refused"] else "nccl"
        ranks = two_ranks(backend, tmp, DIST_TWO_STEPS)
        res[backend] = ranks
        if backend == "gloo" and refusals(ranks, DIST_GLOO_REFUSAL):
            # Neither backend carries two ranks on one device: the
            # two-rank evidence stays the CPU tests'.
            res["two_rank_backend"] = None
            print(json.dumps({"train_dist_two_ranks": res}), flush=True)
            return res
        res["two_rank_backend"] = backend + (
            " (CUDA tensors)" if backend == "gloo" else "")
        prefix = f"{tmp}/{backend}_train"
        w = [torch.load(f"{prefix}.rank{r}.pt") for r in range(2)]
        for k, t in w[0].items():
            if not torch.equal(t, w[1][k]):
                fail(f"train_dist two ranks: {k} differs between ranks")
        # One process, the same two halves, averaged as the step does; at
        # the first step (the same weights) also the concatenated batch's
        # gradients.
        cfg = build_config("gpt2_124m", steps=100, seed=0, device="cuda")
        res["run_dirs"] = two_rank_run_dirs(f"{prefix}.run", sum(
            p.numel() * p.element_size() for p in cfg.model.parameters()))
        step = make_train_step(cfg.model, adamw(TRAIN_LR, weight_decay=0.1),
                               lm_loss)
        batches = cfg.batches(TRAIN_B)
        for i in range(DIST_TWO_STEPS):
            b = next(batches)
            halves = [step.loss_and_grads(local_rows(b, r, 2))[1]
                      for r in range(2)]
            mean = {k: (g + halves[1][k]) / torch.full_like(g, 2)
                    for k, g in halves[0].items()}
            del halves
            if i == 0:
                res["first_step_grad_rel_err"] = grads_rel_err(
                    mean, step.loss_and_grads(b)[1])
                if not res["first_step_grad_rel_err"] <= DIST_TWO_GRAD_RTOL:
                    fail(f"train_dist two ranks: the halves' mean gradient "
                         f"is {res['first_step_grad_rel_err']} of the norm "
                         f"from the 8 rows' (bound {DIST_TWO_GRAD_RTOL})")
            step.apply_gradients(mean)
            del mean
        for k, t in cfg.model.state_dict().items():
            if not torch.equal(t.cpu(), w[0][k]):
                fail(f"train_dist two ranks: {k} differs from one process "
                     f"averaging the same two halves")
        del cfg, step
        gc.collect()
        # One process over the concatenated batch.
        cfg = build_config("gpt2_124m", steps=100, seed=0, device="cuda")
        step = make_train_step(cfg.model, adamw(TRAIN_LR, weight_decay=0.1),
                               lm_loss)
        batches = cfg.batches(TRAIN_B)
        losses = [step(next(batches))["loss"].item()
                  for _ in range(DIST_TWO_STEPS)]
        loss_err = max(abs(a - b) for a, b in zip(losses,
                                                  ranks[0]["losses"]))
        if not loss_err <= TRAIN_LOSS_ATOL:
            fail(f"train_dist two ranks: losses {ranks[0]['losses']} vs one "
                 f"process {losses}")
        # Informational: AdamW's update is near its largest wherever a
        # gradient is near zero, so the weights can sit up to this bound
        # apart however close the gradients are; the gradient check above
        # and the loss are the checks.
        worst = max((t.cuda().float() - cfg.model.state_dict()[k].float())
                    .abs().max().item() for k, t in w[0].items())
        res.update(world1_losses=losses, max_loss_err=loss_err,
                   max_weight_diff_vs_world1=worst,
                   adam_move_bound_x2=2 * adam_move_bound(DIST_TWO_STEPS,
                                                          TRAIN_LR),
                   ranks_bitwise_equal=True,
                   halves_averaged_bitwise_equal=True)
        del cfg, step, w
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"train_dist_two_ranks": res}), flush=True)
    return res


def train_dist(card: str) -> dict:
    """Phase 4e (see the module docstring). -> the flash launches of its
    dp and zero1 runs, by config."""
    from nezha_tpu_torch import dist as nzdist
    import torch.distributed as tdist

    t0 = time.perf_counter()
    coord = nzdist.Coordinator(world_size=1)
    group = nzdist.join("127.0.0.1", coord.port)
    try:
        nzdist.init_torch_distributed(group, "nccl")
        print(json.dumps({"train_dist_group": {
            "backend": tdist.get_backend(), "world": tdist.get_world_size(),
            "rank": tdist.get_rank()}}), flush=True)
        launches = dist_world1_runs(card)
        dist_int8_runs(card)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        group.leave()
        coord.stop()
    dist_cli()
    dist_two_ranks(card)
    print(json.dumps({"train_dist_wall_s": time.perf_counter() - t0}),
          flush=True)
    return launches


# ------------------------------------------------------------- train_tp
TP_STEPS = 3        # Trainer.fit steps of the tensor-parallel GPT-2
TP_CLI_STEPS = 2    # the CLI's --parallel gspmd run
TP_GEN_NEW = 8      # greedy tokens of the generate CLI from its save


def tp_first_step(what: str, model, ref, step, batch, loss_fn,
                  loss_atol: float, grad_rtol: float) -> dict:
    """The tensor-parallel step's first loss and gradients against the
    single-device step's from the same weights and batch (``ref`` holds
    a copy): the loss within ``loss_atol``, each gradient, gathered from
    its shards, within ``grad_rtol`` of its norm; B1-B3 and the delta
    pre-pass MESH_M x layers each, for one forward and backward."""
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.train import make_train_step

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    loss, grads = step.loss_and_grads(batch)
    launches = dict(LAUNCHES)
    per = MESH_M * model.cfg.num_layers
    if launches != {k: per for k in launches}:
        fail(f"train_tp {what}: launches {launches}, expected {per} each "
             f"for one step")
    grads = step._logical(grads)
    single = make_train_step(ref, adamw(0.0), loss_fn)
    loss_r, grads_r = single.loss_and_grads(batch)
    loss_err = abs(loss.item() - loss_r.item())
    if not math.isfinite(loss.item()) or loss_err > loss_atol:
        fail(f"train_tp {what}: loss {loss.item()} vs single-device "
             f"{loss_r.item()} (tolerance {loss_atol})")
    worst, worst_name = 0.0, None
    for name, gr in grads_r.items():
        rel = ((grads[name] - gr).norm() / gr.norm().clamp_min(1e-30)).item()
        if rel >= worst:
            worst, worst_name = rel, name
        if not rel <= grad_rtol:
            fail(f"train_tp {what}: gradient of {name} differs by {rel} of "
                 f"its norm (tolerance {grad_rtol})")
    return {"loss": loss.item(), "loss_single": loss_r.item(),
            "loss_err": loss_err, "loss_atol": loss_atol,
            "max_grad_rel_err": worst, "worst_param": worst_name,
            "grad_rtol": grad_rtol, "launches": launches}


def train_tp(card: str):
    """Phase 4i: tensor-parallel training (``parallel/gspmd.py``) at
    ``dp=1,tp=MESH_M`` on the one card. (a) GPT-2 124M (bf16, B=8,
    S=1024, the fused head): the first step against the single-device
    step (TRAIN_* tolerances), B1-B3 MESH_M x 12 each; (b) TP_STEPS
    steps through ``Trainer.fit`` (AdamW, weight decay 0.1): ms a step
    (one card repeated: it says nothing about two cards), B1-B3 and the
    pre-pass MESH_M x 12 a step; (c) its per-shard save (JAX's shards and
    keys) restored onto one device bitwise equal to the gathered
    tensor-parallel state; (d) BERT-base (bf16, B=16, S=512): the first
    step's loss within BERT_LOSS_ATOL of the single-device step's; (e)
    the train CLI in-process, ``--parallel gspmd --mesh dp=1,tp=MESH_M
    --shard-device cuda:0`` for TP_CLI_STEPS steps with ``--ckpt-dir``
    (B1-B3 MESH_M x 12 a step), and the generate CLI from its save
    (``step_<N>.sharded``) on one device: its greedy tokens those of
    ``models.generate`` on the save restored in this process. -> (the
    launches of (b), of (e))."""
    import tempfile

    from nezha_tpu_torch.cli import generate as gen_cli
    from nezha_tpu_torch.cli import train as train_cli_mod
    from nezha_tpu_torch.cli.common import (gpt2_for_preset,
                                            restore_variables_any)
    from nezha_tpu_torch.data import (synthetic_mlm_batches,
                                      synthetic_token_batches)
    from nezha_tpu_torch.models import generate
    from nezha_tpu_torch.models.bert import mlm_loss
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.parallel.gspmd import (GSPMDTrainStep,
                                                make_gspmd_mesh)
    from nezha_tpu_torch.train import Trainer

    t_phase = time.perf_counter()
    mesh = make_gspmd_mesh({"dp": 1, "tp": MESH_M},
                           [torch.device("cuda", 0)] * MESH_M)
    batches = synthetic_token_batches(TRAIN_B, seq_len=TRAIN_S, seed=0)
    batch = next(batches)
    per = MESH_M * 12

    def fresh():
        return gpt2_for_preset("full", seed=0, device="cuda",
                               fused_loss_chunk=-1)

    model, ref = fresh(), fresh()
    step = GSPMDTrainStep(model, adamw(TRAIN_LR, weight_decay=0.1),
                          lm_loss, mesh)
    first = tp_first_step("gpt2", model, ref, step, batch, lm_loss,
                          TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL)
    del ref
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="nezha_train_tp_") as tmp:
        trainer = Trainer(model, step.optimizer, lm_loss, step_fn=step,
                          log_every=0, checkpoint_dir=f"{tmp}/fit")
        trainer.fit(batches, 1)                  # warm-up
        torch.cuda.synchronize()
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        t0 = time.perf_counter()
        last = trainer.fit(batches, TP_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fit_launches = dict(LAUNCHES)
        if fit_launches != {k: per * TP_STEPS for k in fit_launches}:
            fail(f"train_tp: launches {fit_launches} in {TP_STEPS} steps, "
                 f"not {per} each a step")
        if not math.isfinite(last["loss"]):
            fail(f"train_tp: loss {last['loss']}")
        trainer.save()
        trainer.wait_saves()
        gathered = step.gathered_variables()
        one = fresh()
        restore_variables_any(f"{tmp}/fit", one)
        for name, p in one.named_parameters():
            if not torch.equal(p.detach(), gathered[name].to(p.device)):
                fail(f"train_tp: {name} restored onto one device differs "
                     f"from the gathered tensor-parallel state")
        stats = {"mesh": mesh.shape,
                 "devices": [str(d) for d in mesh.devices],
                 "note": MESH_NOTE, "first_step": first, "steps": TP_STEPS,
                 "ms_per_step": wall / TP_STEPS * 1e3,
                 "tokens_per_s": TRAIN_B * TRAIN_S * TP_STEPS / wall,
                 "last_loss": last["loss"], "launches": fit_launches,
                 "save": trainer.saves[-1],
                 "restored_bitwise": len(gathered), "card": card}
        print(json.dumps({"train_tp": stats}), flush=True)
        del trainer, step, model, one, gathered
        torch.cuda.empty_cache()

        bert, bref = bert_models(), bert_models()
        bstep = GSPMDTrainStep(bert, adamw(BERT_LR, weight_decay=BERT_WD),
                               mlm_loss, mesh)
        bbatch = next(synthetic_mlm_batches(BERT_B, seq_len=BERT_S))
        bfirst = tp_first_step("bert", bert, bref, bstep, bbatch, mlm_loss,
                               BERT_LOSS_ATOL, BERT_GRAD_RTOL)
        print(json.dumps({"train_tp_bert": {**bfirst, "B": BERT_B,
                                            "S": BERT_S, "card": card}}),
              flush=True)
        del bert, bref, bstep
        torch.cuda.empty_cache()

        ck = f"{tmp}/cli"
        argv = ["--config", "gpt2_124m", "--parallel", "gspmd", "--mesh",
                f"dp=1,tp={MESH_M}", "--shard-device", "cuda:0", "--steps",
                str(TP_CLI_STEPS), "--ckpt-dir", ck, "--log-every", "0"]
        zero_counts()
        t0 = time.perf_counter()
        _, lines = cli_stdout(train_cli_mod.main, argv)
        torch.cuda.synchronize()
        cli_wall = time.perf_counter() - t0
        cli_launches = {k: v for k, v in read_counts().items()
                        if k.startswith("flash_")}
        want = {"flash_fwd": per * TP_CLI_STEPS,
                "flash_bwd_dq": per * TP_CLI_STEPS,
                "flash_bwd_dkv": per * TP_CLI_STEPS,
                "flash_bwd_delta": per * TP_CLI_STEPS, "flash_decode": 0}
        if cli_launches != want:
            fail(f"train_tp CLI: launches {cli_launches}, expected {want}")
        final = json.loads(lines[-1])["final"]
        if final["step"] != TP_CLI_STEPS or not math.isfinite(
                final["loss"]):
            fail(f"train_tp CLI: final {final}")
        prompt = [464, 2068, 7586, 21831]
        result, _ = cli_stdout(gen_cli.run, gen_cli.build_parser()
                               .parse_args([
                                   "--ckpt-dir", ck, "--prompt-tokens",
                                   ",".join(map(str, prompt)),
                                   "--max-new-tokens", str(TP_GEN_NEW),
                                   "--temperature", "0", "--eos-id",
                                   "-1"]))
        got = result["tokens"]
        one = gpt2_for_preset("full", seed=1, device="cuda")
        if restore_variables_any(ck, one) != TP_CLI_STEPS:
            fail("train_tp: the CLI's save restored another step")
        with torch.no_grad():
            want_toks = generate(one, torch.tensor([prompt], device="cuda"),
                                 max_new_tokens=TP_GEN_NEW)[0, len(prompt):]
        if got != want_toks.tolist():
            fail(f"train_tp: the generate CLI's tokens {got}, "
                 f"models.generate's {want_toks.tolist()}")
    print(json.dumps({"train_tp_cli": {
        "argv": argv, "wall_s": cli_wall, "final": final,
        "launches": cli_launches, "generate_tokens": got,
        "note": MESH_NOTE, "card": card}}), flush=True)
    print(json.dumps({"train_tp_wall_s": time.perf_counter() - t_phase}),
          flush=True)
    return {"train_tp": fit_launches, "train_tp_cli": cli_launches}


PP_M = 4            # the pipeline's microbatches a step
PP_STEPS = 3        # timed Trainer.fit steps of the pipelined GPT-2
PP_LOSS_ATOL = 0.005   # pp and ep first steps against one device's
MOE_E = 8           # experts of the MoE GPT-2 (blocks 1, 3, ..., 11)
MOE_STEPS = 2       # timed Trainer.fit steps of the MoE GPT-2
PP_CLI_STEPS, PP_CLI_MORE = 3, 2   # the pp CLI run and its resume
MOE_CLI_STEPS = 2   # the MoE CLI run under gspmd with an ep axis


def pp_fresh(**kw):
    """train's GPT-2 124M (bf16, the fused head) from seed 0."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    return gpt2_for_preset("full", seed=0, device="cuda",
                           fused_loss_chunk=-1, **kw)


def peak_step(fn):
    """``fn()`` with the card's peak allocation tracked: -> (its return,
    {"peak_gb": the peak, "step_peak_gb": the peak over what was
    allocated before it})."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, {"peak_gb": peak / 2 ** 30,
                 "step_peak_gb": (peak - base) / 2 ** 30}


def counted(what: str, fn, want: dict):
    """``fn()`` with the flash counts set to 0 just before; each count in
    ``want`` must equal it exactly. -> (its return, the counts)."""
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    out = fn()
    got = dict(LAUNCHES)
    if any(got[k] != v for k, v in want.items()):
        fail(f"{_PHASE.get('name')} {what}: launches {got}, expected {want}")
    return out, got


def flash_want(fwd: int, bwd: int) -> dict:
    return {"flash_fwd": fwd, "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd,
            "flash_bwd_delta": bwd}


def grads_within(what: str, grads: dict, ref: dict, rtol: float) -> dict:
    """Each gradient within ``rtol`` of its reference's norm; -> the
    worst."""
    worst, worst_name = 0.0, None
    for name, gr in ref.items():
        rel = ((grads[name].float() - gr.float()).norm()
               / gr.float().norm().clamp_min(1e-30)).item()
        if rel >= worst:
            worst, worst_name = rel, name
        if not rel <= rtol:
            fail(f"{_PHASE.get('name')} {what}: gradient of {name} differs by {rel} "
                 f"of its norm (tolerance {rtol})")
    return {"max_grad_rel_err": worst, "worst_param": worst_name,
            "grad_rtol": rtol}


def loss_within(what: str, loss, ref, atol: float) -> dict:
    err = abs(float(loss) - float(ref))
    if not math.isfinite(float(loss)) or err > atol:
        fail(f"{_PHASE.get('name')} {what}: loss {float(loss)} vs {float(ref)} "
             f"(tolerance {atol})")
    return {"loss": float(loss), "loss_ref": float(ref), "loss_err": err,
            "loss_atol": atol}


def fit_ms(step, batches, steps: int, want: dict) -> dict:
    """One warm-up step, then ``steps`` through ``Trainer.fit`` with the
    flash counts at 0 just before (each ``want`` a step, exactly): ms a
    step on the host clock, ended by a sync."""
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.train import Trainer

    trainer = Trainer(step.model, step.optimizer, lm_loss, step_fn=step,
                      log_every=0)
    trainer.fit(batches, 1)
    torch.cuda.synchronize()

    def run():
        t0 = time.perf_counter()
        last = trainer.fit(batches, steps)
        torch.cuda.synchronize()
        return last, time.perf_counter() - t0

    (last, wall), launches = counted(
        "fit", run, {k: v * steps for k, v in want.items()})
    if not math.isfinite(last["loss"]):
        fail(f"train_pp_moe: loss {last['loss']}")
    return {"steps": steps, "ms_per_step": wall / steps * 1e3,
            "tokens_per_s": TRAIN_B * TRAIN_S * steps / wall,
            "last_loss": last["loss"], "launches": launches}


def pp_parts(card: str, batches, batch) -> dict:
    """(a) the pipeline at dp=1,pp=MESH_M on the card repeated, PP_M
    microbatches, against one device; (b) its remat, and the
    single-device step's."""
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.parallel.pipeline import (PipelineTrainStep,
                                                   gpt2_pipeline_spec,
                                                   make_pipeline_mesh)
    from nezha_tpu_torch.train import make_train_step

    layers = 12
    mesh = make_pipeline_mesh({"dp": 1, "pp": MESH_M},
                              [torch.device("cuda", 0)] * MESH_M)
    model, ref = pp_fresh(), pp_fresh()
    step = PipelineTrainStep(model, gpt2_pipeline_spec(model),
                             adamw(TRAIN_LR, weight_decay=0.1), lm_loss, mesh,
                             PP_M)
    per = layers * PP_M
    ((loss, grads), mem), launches = counted(
        "pp", lambda: peak_step(lambda: step.loss_and_grads(batch)),
        flash_want(per, per))
    grads = step.merged_variables(grads)
    loss_r, grads_r = make_train_step(ref, adamw(0.0), lm_loss) \
        .loss_and_grads(batch)
    first = {**loss_within("pp", loss, loss_r, PP_LOSS_ATOL),
             **grads_within("pp", grads, grads_r, TRAIN_GRAD_RTOL),
             "launches": launches, **mem}
    del grads_r, loss_r
    # (b): the same step rematerialized, per stage application.
    step.remat = True
    ((loss_b, grads_b), mem_b), launches_b = counted(
        "pp remat", lambda: peak_step(lambda: step.loss_and_grads(batch)),
        {"flash_fwd": 2 * per, "flash_bwd_dq": per, "flash_bwd_dkv": per,
         "flash_bwd_delta": per})
    remat = {**loss_within("pp remat", loss_b, loss, PP_LOSS_ATOL),
             **grads_within("pp remat", step.merged_variables(grads_b),
                            grads, TRAIN_GRAD_RTOL),
             "launches": launches_b, **mem_b}
    if not mem_b["step_peak_gb"] < mem["step_peak_gb"]:
        fail(f"train_pp_moe pp remat: the step's peak {mem_b} is not below "
             f"the plain pipeline's {mem}")
    del grads, grads_b
    step.remat = False
    fit = fit_ms(step, batches, PP_STEPS, flash_want(per, per))
    print(json.dumps({"train_pp": {
        "mesh": mesh.shape, "devices": [str(d) for d in mesh.devices],
        "microbatches": PP_M, "note": MESH_NOTE, "first_step": first,
        "fit": fit, "card": card}}), flush=True)
    print(json.dumps({"train_pp_remat": {"first_step": remat,
                                         "card": card}}), flush=True)
    del step, model, ref
    gc.collect()
    torch.cuda.empty_cache()
    # The single-device step with remat: B1 twice a layer.
    single = pp_fresh(remat=True)
    (_, launches_1), mem_1 = peak_step(lambda: counted(
        "single remat", lambda: make_train_step(
            single, adamw(0.0), lm_loss).loss_and_grads(batch),
        flash_want(2 * layers, layers)))
    del single
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"train_remat_single": {"launches": launches_1,
                                             **mem_1, "card": card}}),
          flush=True)
    return {"train_pp": fit["launches"], "train_pp_remat": launches_b,
            "train_remat_single": launches_1}


def moe_dropped(model, batch) -> list:
    """Per MoE layer of one eval-mode forward: its aux loss, the tokens
    routed (T x top-k) and those dropped over capacity."""
    from nezha_tpu_torch.parallel.expert import MoE

    rows = []

    def hook(mod, args, out):
        with torch.no_grad():
            tokens, dispatch, _, aux = mod.route(args[0])
        routed = tokens.shape[0] * mod.cfg.top_k
        rows.append({"aux": aux.item(), "capacity": dispatch.shape[-1],
                     "routed": routed,
                     "dropped": routed - int(dispatch.sum().item())})

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, MoE)]
    try:
        model.eval()
        with torch.no_grad():
            model(batch_to_cuda(batch))
    finally:
        for h in handles:
            h.remove()
        model.train()
    return rows


def batch_to_cuda(batch: dict) -> dict:
    from nezha_tpu_torch.train.loop import batch_to_device
    return batch_to_device(batch, torch.device("cuda", 0))


def routing_flips(a, b) -> list:
    """Per MoE layer, the share of tokens whose top-k choices differ
    between two routing tapes' records."""
    out = []
    for x, y in zip(a, b):
        differ = torch.zeros_like(x[0], dtype=torch.bool)
        for xi, yi in zip(x, y):
            differ |= xi.to(yi.device) != yi
        out.append(differ.float().mean().item())
    return out


def replayed_check(what: str, step, ref_step, batch, loss_atol: float
                   ) -> dict:
    """``step``'s loss and gradients against ``ref_step``'s from the same
    weights, the reference routed as ``step`` routed (``routing_tape``):
    the loss within ``loss_atol``, each gradient within TRAIN_GRAD_RTOL
    of its norm. The reference's own routing (no replay) is run too, and
    its share of tokens routed otherwise, its loss and its worst gradient
    are printed beside (argmax routing amplifies rounding: not held)."""
    from nezha_tpu_torch.parallel.expert import routing_tape

    def logical(st, grads):
        return st._logical(grads) if hasattr(st, "_logical") else grads

    with routing_tape() as tape:
        loss, grads = step.loss_and_grads(batch)
    grads = logical(step, grads)
    with routing_tape(tape.choices):
        loss_r, grads_r = ref_step.loss_and_grads(batch)
    out = {**loss_within(what, loss, loss_r, loss_atol),
           **grads_within(what, grads, logical(ref_step, grads_r),
                          TRAIN_GRAD_RTOL)}
    del grads_r
    with routing_tape() as own:
        loss_o, grads_o = ref_step.loss_and_grads(batch)
    grads_o = logical(ref_step, grads_o)
    worst = max((((grads[n].float() - g.float()).norm()
                  / g.float().norm().clamp_min(1e-30)).item(), n)
                for n, g in grads_o.items())
    out["own_routing"] = {"tokens_routed_otherwise": routing_flips(
        tape.choices, own.choices), "loss": float(loss_o),
        "max_grad_rel_err": list(worst)}
    return out


def moe_parts(card: str, batches, batch) -> dict:
    """(c) the MoE GPT-2 on one device against its composed-attention
    twin; (d) its experts over ep=MESH_M on the card repeated against one
    device. Each reference routes as the checked step routed
    (:func:`replayed_check`)."""
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.parallel.gspmd import (GSPMDTrainStep,
                                                make_gspmd_mesh)
    from nezha_tpu_torch.parallel.expert import ShardedMoE
    from nezha_tpu_torch.train import make_train_step

    model, ref = pp_fresh(moe_experts=MOE_E), \
        pp_fresh(moe_experts=MOE_E, attn_impl="xla")
    step = make_train_step(model, adamw(TRAIN_LR, weight_decay=0.1),
                           lm_loss)
    check = replayed_check("moe", step,
                           make_train_step(ref, adamw(0.0), lm_loss), batch,
                           TRAIN_LOSS_ATOL)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    layers = moe_dropped(model, batch)
    (_, launches), mem = peak_step(lambda: counted(
        "moe", lambda: step.loss_and_grads(batch), flash_want(12, 12)))
    fit = fit_ms(step, batches, MOE_STEPS, flash_want(12, 12))
    print(json.dumps({"train_moe": {
        "experts": MOE_E, "top_k": model.cfg.moe_top_k,
        "moe_layers": len(layers), "check_against_xla": check,
        "layers": layers, "launches": launches, **mem, "fit": fit,
        "card": card}}), flush=True)
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    # (d): the ep mesh's step against one device's, same weights.
    single, ep_model = pp_fresh(moe_experts=MOE_E), pp_fresh(
        moe_experts=MOE_E)
    mesh = make_gspmd_mesh({"dp": 1, "tp": 1, "ep": MESH_M},
                           [torch.device("cuda", 0)] * MESH_M)
    ep = GSPMDTrainStep(ep_model, adamw(TRAIN_LR, weight_decay=0.1), lm_loss,
                        mesh)
    if not any(isinstance(b.mlp, ShardedMoE) for b in ep.tp_model.h):
        fail("train_pp_moe ep: no expert layer split over ep")
    first = replayed_check("ep", ep, make_train_step(single, adamw(0.0),
                                                      lm_loss), batch,
                           PP_LOSS_ATOL)
    (_, launches_ep), mem_ep = peak_step(lambda: counted(
        "ep", lambda: ep.loss_and_grads(batch), flash_want(12, 12)))
    print(json.dumps({"train_ep": {
        "mesh": mesh.shape, "devices": [str(d) for d in mesh.devices],
        "note": MESH_NOTE, "first_step": first, "launches": launches_ep,
        **mem_ep, "card": card}}), flush=True)
    del ep, ep_model, single
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_moe": fit["launches"], "train_ep": launches_ep}


def image_remat(card: str) -> None:
    """(e) ResNet-50 (bf16, batch IMG_B) one step with remat against one
    without, from the same weights and BatchNorm buffers: gradients within
    compare_image_steps' limits, the buffers bitwise (updated once), the
    step's peak below."""
    from nezha_tpu_torch.cli.train import build_config, image_ce
    from nezha_tpu_torch.data import synthetic_image_batches
    from nezha_tpu_torch.optim import sgd
    from nezha_tpu_torch.train import make_train_step

    batch = next(synthetic_image_batches(IMG_B))
    plain, _ = image_check_models(0)
    rm = build_config("resnet50_imagenet", seed=0, device="cuda",
                      remat=True).model
    rm.load_state_dict(plain.state_dict())
    out = {}
    for name, m in (("plain", plain), ("remat", rm)):
        (loss, grads), mem = peak_step(lambda m=m: make_train_step(
            m, sgd(0.0), image_ce).loss_and_grads(batch))
        out[name] = (loss, grads, mem)
        gc.collect()
        torch.cuda.empty_cache()
    (loss_p, g_p, mem_p), (loss_r, g_r, mem_r) = out["plain"], out["remat"]
    diff_sq = norm_sq = 0.0
    worst_cos = (1.0, "")
    for name, gp in g_p.items():
        gr = g_r[name].float()
        gp = gp.float()
        diff_sq += (gr - gp).square().sum().item()
        norm_sq += gp.square().sum().item()
        cos = torch.nn.functional.cosine_similarity(
            gr.flatten(), gp.flatten(), dim=0).item() \
            if gp.norm() > 0 else 1.0
        worst_cos = min(worst_cos, (cos, name))
    whole = math.sqrt(diff_sq / norm_sq)
    if not whole <= IMAGE_GRAD_RTOL or not worst_cos[0] >= IMAGE_GRAD_COS:
        fail(f"train_pp_moe image remat: gradients {whole} of the norm, "
             f"worst cosine {worst_cos}")
    if not abs(loss_r.item() - loss_p.item()) <= IMAGE_LOSS_RTOL * abs(
            loss_p.item()):
        fail(f"train_pp_moe image remat: loss {loss_r.item()} vs "
             f"{loss_p.item()}")
    stats = 0
    for (name, a), (_, b) in zip(plain.named_buffers(), rm.named_buffers()):
        if not torch.equal(a, b):
            fail(f"train_pp_moe image remat: buffer {name} differs from "
                 f"the plain step's (updated twice?)")
        stats += 1
    if not mem_r["step_peak_gb"] < mem_p["step_peak_gb"]:
        fail(f"train_pp_moe image remat: peak {mem_r} not below {mem_p}")
    print(json.dumps({"train_image_remat": {
        "B": IMG_B, "loss": loss_r.item(), "loss_plain": loss_p.item(),
        "grad_rel_err_whole": whole, "grad_cos_worst_tensor":
        list(worst_cos), "buffers_bitwise": stats, "remat": mem_r,
        "plain": mem_p, "card": card}}), flush=True)
    del plain, rm, out, g_p, g_r
    gc.collect()
    torch.cuda.empty_cache()


def pp_moe_cli(card: str) -> dict:
    """(f) the train CLI in process: ``--parallel pp`` with a save, the
    save restored into a fresh pipeline step bitwise, a resume; then
    ``--moe-experts`` under gspmd with an ep axis."""
    import tempfile

    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.parallel.pipeline import (PipelineTrainStep,
                                                   gpt2_pipeline_spec,
                                                   make_pipeline_mesh)
    from nezha_tpu_torch.train import sharded_checkpoint as sck

    per = 12 * PP_M
    with tempfile.TemporaryDirectory(prefix="nezha_train_pp_") as tmp:
        base = ["--config", "gpt2_124m", "--parallel", "pp", "--mesh",
                f"dp=1,pp={MESH_M}", "--shard-device", "cuda:0",
                "--microbatches", str(PP_M), "--ckpt-dir", tmp,
                "--log-every", "0"]
        run1 = cli_run(*base, "--steps", str(PP_CLI_STEPS),
                       in_process=True)
        run2 = None
        want = {"flash_fwd": per * PP_CLI_STEPS,
                "flash_bwd_dq": per * PP_CLI_STEPS,
                "flash_bwd_dkv": per * PP_CLI_STEPS,
                "flash_bwd_delta": per * PP_CLI_STEPS, "flash_decode": 0}
        got = {k: run1["launches"][k] for k in want}
        if got != want or run1["final"]["step"] != PP_CLI_STEPS:
            fail(f"train_pp_moe CLI pp: launches {got} (expected {want}), "
                 f"final {run1['final']}")
        # The save installed into a fresh step as a resume installs it
        # (Trainer.initialize): every leaf read back as saved.
        model = pp_fresh()
        mesh = make_pipeline_mesh({"dp": 1, "pp": MESH_M},
                                  [torch.device("cuda", 0)] * MESH_M)
        step = PipelineTrainStep(model, gpt2_pipeline_spec(model),
                                 adamw(TRAIN_LR, weight_decay=0.1), lm_loss,
                                 mesh, PP_M)
        saved, at = sck.try_restore_sharded(tmp, step.restore_request())
        if at != PP_CLI_STEPS:
            fail("train_pp_moe CLI pp: its save did not restore")
        step.load_restored({k: a for k, (a, _) in saved.items()})
        leaves = step.shard_leaves(saved["rng"][0])
        for key, (arr, _) in saved.items():
            whole = np.zeros(leaves[key].shape, arr.dtype)
            for idx, piece in leaves[key].shards:
                whole[tuple(slice(lo, hi) for lo, hi in idx)] = piece
            if not np.array_equal(whole, arr):
                fail(f"train_pp_moe CLI pp: resumed leaf {key} differs from "
                     f"the saved one")
        n_leaves = len(saved)
        del step, model, saved, leaves
        gc.collect()
        torch.cuda.empty_cache()
        run2 = cli_run(*base, "--steps", str(PP_CLI_MORE), in_process=True)
        want2 = {k: (per * PP_CLI_MORE if k != "flash_decode" else 0)
                 for k in want}
        got2 = {k: run2["launches"][k] for k in want2}
        if (got2 != want2
                or run2["final"]["step"] != PP_CLI_STEPS + PP_CLI_MORE
                or not any("resumed from step" in line
                           for line in run2["stderr"])):
            fail(f"train_pp_moe CLI pp resume: launches {got2} (expected "
                 f"{want2}), final {run2['final']}")
    moe = cli_run("--config", "gpt2_124m", "--moe-experts", str(MOE_E),
                  "--parallel", "gspmd", "--mesh",
                  f"dp=1,tp=1,ep={MESH_M}", "--shard-device", "cuda:0",
                  "--steps", str(MOE_CLI_STEPS), "--log-every", "0",
                  in_process=True)
    want3 = {"flash_fwd": 12 * MOE_CLI_STEPS,
             "flash_bwd_dq": 12 * MOE_CLI_STEPS,
             "flash_bwd_dkv": 12 * MOE_CLI_STEPS,
             "flash_bwd_delta": 12 * MOE_CLI_STEPS}
    got3 = {k: moe["launches"][k] for k in want3}
    if got3 != want3 or moe["final"]["step"] != MOE_CLI_STEPS:
        fail(f"train_pp_moe CLI moe: launches {got3} (expected {want3}), "
             f"final {moe['final']}")
    print(json.dumps({"train_pp_moe_cli": {
        "pp": {"argv": run1["argv"], "wall_s": run1["wall_s"],
               "final": run1["final"], "launches": got,
               "saves": run1["saves"]},
        "resumed_leaves_bitwise": n_leaves,
        "pp_resume": {"wall_s": run2["wall_s"], "final": run2["final"],
                      "launches": got2, "restores": run2["restores"]},
        "moe_ep": {"argv": moe["argv"], "wall_s": moe["wall_s"],
                   "final": moe["final"], "launches": got3},
        "note": MESH_NOTE, "card": card}}), flush=True)
    return {"train_pp_cli": {k: got[k] + got2[k] for k in got},
            "train_moe_cli": got3}


def train_pp_moe(card: str) -> dict:
    """Phase 4j: pipeline parallelism, the MoE GPT-2 and remat, at GPT-2
    124M's full width (bf16, B=TRAIN_B, S=TRAIN_S, AdamW, the fused head;
    every mesh one card repeated, ``[cuda:0] * MESH_M``: its times say
    nothing about two cards). (a) ``--parallel pp`` at dp=1,pp=MESH_M,
    PP_M microbatches: the first step's loss within PP_LOSS_ATOL of one
    device's and its gradients within TRAIN_GRAD_RTOL, B1-B3 and the
    pre-pass 12 x PP_M a step (no bubble launch), ms a step; (b) the same
    step rematerialized: B1 2 x 12 x PP_M, B2 and B3 12 x PP_M, the
    gradients (a)'s, the step's peak below (a)'s; one device with remat:
    B1 24; (c) the MoE GPT-2 (MOE_E experts, top-2) against its
    composed-attention twin (the train check), its aux loss and dropped
    tokens per MoE layer, B1-B3 12 a step, ms a step and the peak; (d) its
    experts over ep=MESH_M against one device (PP_LOSS_ATOL, the
    gradients' TRAIN_GRAD_RTOL), B1-B3 12; (e) ResNet-50 with remat
    against without (image_remat); (f) the CLI (pp_moe_cli). -> the
    launches by path."""
    from nezha_tpu_torch.data import synthetic_token_batches

    t_phase = time.perf_counter()
    batches = synthetic_token_batches(TRAIN_B, seq_len=TRAIN_S, seed=0)
    batch = next(batches)
    paths, walls = {}, {}
    for part, run in (("pp", lambda: pp_parts(card, batches, batch)),
                      ("moe", lambda: moe_parts(card, batches, batch)),
                      ("image", lambda: image_remat(card)),
                      ("cli", lambda: pp_moe_cli(card))):
        t0 = time.perf_counter()
        paths.update(run() or {})
        walls[part] = time.perf_counter() - t0
    print(json.dumps({"train_pp_moe_wall_s": time.perf_counter() - t_phase,
                      "parts_s": walls}), flush=True)
    return paths


SP_M = 2            # train_sp's sequence shards, all on the one card
# The sp steps' gradients against one device's flash step, per tensor:
# ||g_sp - g_one|| <= SP_GRAD_RTOL ||g_one||: twice the largest spread
# tools/grad_spread.py --sp measured on the H100 over six seeds (ring,
# flash hops: 0.0358, ln_f.bias; the composed ring and Ulysses, whose
# attention is one device's arithmetic, the same: 0.0358), as
# TRAIN_GRAD_RTOL is set. The spread is the shards' partial gradients of
# the replicated parameters (bf16 products over S/sp rows, added in
# fp32), not the hops; its control, each hop's backward on its own
# block's lse and output, reads 1.87.
SP_GRAD_RTOL = 0.072
SP_STEPS = 2        # timed Trainer.fit steps of the ring-flash GPT-2
SP_CHUNK = 128      # (d)'s fused_loss_chunk
SP_LONG_S = 8192    # (e)'s --seq-len, batch 1, --remat
SP_LONG_STEPS = 3   # (e)'s steps at sp=SP_M
SP_LONG_M = 4       # (e)'s resumed step runs at sp=4
SP_GEN_NEW = 8      # greedy tokens of the generate CLI from (e)'s save


def ring_hops(m: int) -> int:
    """Flash hops a causal ring of ``m`` shards runs a layer: shard r
    attends the blocks of shards 0..r (the later ones are skipped)."""
    return m * (m + 1) // 2


def sp_kernel_case(g, b: int, s_loc: int) -> dict:
    """B1 non-causal, and B2/B3 (with the pre-pass) on the diagonal and a
    past block reading the GLOBAL row lse and output of a two-block ring,
    at the shard length ``s_loc`` (bf16, H=12, D=64), against their plain
    versions within the kernels phase's bounds."""
    from nezha_tpu_torch.ops.cuda.flash_attention import (
        flash_block_bwd, flash_block_bwd_plain, flash_block_fwd,
        flash_block_fwd_plain, flash_bwd_error_bound)

    bf = torch.bfloat16
    tag = f"train_sp kernels B={b} S_loc={s_loc}"
    q, k0, v0, k1, v1, do = (torch.randn(b, H, s_loc, D, generator=g)
                             .to("cuda", bf) for _ in range(6))
    out, lse = flash_block_fwd(q, k1, v1, False)
    torch.cuda.synchronize()
    want, want_lse = flash_block_fwd_plain(q, k1, v1, False)
    abs_v = flash_block_fwd_plain(q, k1, v1.abs(), False)[0]
    res = {"fwd_full": within_bound(f"{tag} fwd", out, want, abs_v)}
    lse_err = (lse - want_lse).abs().max().item()
    if not lse_err <= LSE_ATOL:
        fail(f"{tag}: lse differs by {lse_err} > {LSE_ATOL}")
    # The ring's merge of the diagonal hop (k0, causal) and the past one.
    o_d, lse_d = flash_block_fwd_plain(q, k0, v0, True)
    glse = torch.logaddexp(lse_d, want_lse)
    gout = (o_d.float() * torch.exp(lse_d - glse)[..., None]
            + want.float() * torch.exp(want_lse - glse)[..., None]).to(bf)
    for hop, (kk, vv, causal) in (("diagonal", (k0, v0, True)),
                                  ("past", (k1, v1, False))):
        args = (q, kk, vv, gout, glse, do, causal)
        grads = flash_block_bwd(*args)
        torch.cuda.synchronize()
        plain = flash_block_bwd_plain(*args)
        bounds = flash_bwd_error_bound(*args)
        res[hop] = {name: within(f"{tag} {hop} {name}", got, w, bd)[1]
                    for name, got, w, bd in zip(("dq", "dk", "dv"), grads,
                                                plain, bounds)}
    res["lse_err"] = lse_err
    return res


def sp_step_parts(card: str, batches, batch) -> dict:
    """(a)-(d) on train's GPT-2 124M and batch: the sp steps at
    dp=1,sp=SP_M on the card repeated against one device's flash step."""
    from nezha_tpu_torch.models.gpt2 import lm_loss, with_overrides
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.parallel.mesh import make_sp_mesh
    from nezha_tpu_torch.parallel.sequence_parallel import SPTrainStep
    from nezha_tpu_torch.train import make_train_step

    layers = 12
    model = pp_fresh()
    mesh = make_sp_mesh({"dp": 1, "sp": SP_M},
                        [torch.device("cuda", 0)] * SP_M)
    ((loss_1, grads_1), mem_1), launches_1 = counted(
        "one device", lambda: peak_step(lambda: make_train_step(
            model, adamw(0.0), lm_loss).loss_and_grads(batch)),
        flash_want(layers, layers))
    rows = {"one_device": {"loss": float(loss_1), "launches": launches_1,
                           **mem_1}}
    steps = {}

    def case(tag, impl, flash, want, ref_loss, ref_grads, keep=False):
        step = SPTrainStep(with_overrides(model, attn_impl=impl,
                                          sp_use_flash=flash),
                           adamw(0.0), mesh)
        ((loss, grads), mem), launches = counted(
            f"sp {tag}", lambda: peak_step(
                lambda: step.loss_and_grads(batch)), want)
        rows[tag] = {**loss_within(tag, loss, ref_loss, TRAIN_LOSS_ATOL),
                     **grads_within(tag, grads, ref_grads, SP_GRAD_RTOL),
                     "launches": launches, **mem}
        steps[tag] = step
        return loss, grads

    hops = layers * ring_hops(SP_M)
    loss_a, grads_a = case("ring_flash", "ring", None,
                           flash_want(hops, hops), loss_1, grads_1)
    case("ring_composed", "ring", False, flash_want(0, 0), loss_a, grads_a)
    del grads_a
    case("ulysses_flash", "ulysses", None,
         flash_want(layers * SP_M, layers * SP_M), loss_1, grads_1)
    fit = fit_ms(steps["ring_flash"], batches, SP_STEPS,
                 flash_want(hops, hops))
    rows["ring_flash"]["fit"] = fit
    steps.clear()
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the chunked loss on one device against the -1 path's step.
    chunked = with_overrides(model, fused_loss_chunk=SP_CHUNK)
    ((loss_d, grads_d), mem_d), launches_d = counted(
        "chunked loss", lambda: peak_step(lambda: make_train_step(
            chunked, adamw(0.0), lm_loss).loss_and_grads(batch)),
        flash_want(layers, layers))
    rows["chunked_loss"] = {
        "chunk": SP_CHUNK,
        **loss_within("chunked loss", loss_d, loss_1, TRAIN_LOSS_ATOL),
        **grads_within("chunked loss", grads_d, grads_1, TRAIN_GRAD_RTOL),
        "launches": launches_d, **mem_d,
        "peak_drop_gb": mem_1["step_peak_gb"] - mem_d["step_peak_gb"]}
    if not mem_d["step_peak_gb"] < mem_1["step_peak_gb"]:
        fail(f"train_sp chunked loss: the step's peak {mem_d} is not below "
             f"the fused -1 path's {mem_1}")
    del model, chunked, grads_1, grads_d
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"train_sp": {
        "mesh": mesh.shape, "devices": [str(d) for d in mesh.devices],
        "batch": [TRAIN_B, TRAIN_S], "note": MESH_NOTE, **rows,
        "card": card}}), flush=True)
    return {"train_sp": fit["launches"],
            "train_sp_composed": rows["ring_composed"]["launches"],
            "train_sp_ulysses": rows["ulysses_flash"]["launches"],
            "train_chunked_loss": launches_d}


def sp_long_cli(card: str) -> dict:
    """(e) the train CLI in process at SP_LONG_S tokens, batch 1, remat,
    sp=SP_M: tokens/s, ms a step, the HBM peak, exact launches; one step
    resumed from its save at sp=SP_LONG_M, the state its restore installed
    (``Trainer.initialize``) read back against the save, every leaf
    bitwise; the generate CLI from the resumed run's save."""
    import tempfile

    from nezha_tpu_torch.cli import generate as gen_cli
    from nezha_tpu_torch.train import Trainer
    from nezha_tpu_torch.train import checkpoint as ckpt

    def want(m: int, steps: int) -> dict:
        hops = 12 * ring_hops(m) * steps
        return {**flash_want(2 * hops, hops), "flash_decode": 0}

    def run(m: int, steps: int, tmp: str) -> dict:
        torch.cuda.reset_peak_memory_stats()
        r = cli_run("--config", "gpt2_124m", "--parallel", "sp", "--mesh",
                    f"dp=1,sp={m}", "--shard-device", "cuda:0", "--seq-len",
                    str(SP_LONG_S), "--batch-size", "1", "--remat",
                    "--steps", str(steps), "--ckpt-dir", tmp,
                    "--log-every", "1", in_process=True)
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        w = want(m, steps)
        got = {k: r["launches"][k] for k in w}
        if got != w:
            fail(f"train_sp CLI sp={m}: launches {got}, expected {w}")
        r["launches"] = got
        last = r["logs"][-1]
        r["ms_per_step"] = 1e3 / last["steps_per_sec"]
        r["tokens_per_s"] = last["tokens_per_sec"]
        return r

    restored = {}
    initialize = Trainer.initialize

    def recording(self, resume=True):
        step = initialize(self, resume)
        restored[step] = self.state_dict()
        return step

    with tempfile.TemporaryDirectory(prefix="nezha_train_sp_") as tmp:
        run1 = run(SP_M, SP_LONG_STEPS, tmp)
        Trainer.initialize = recording
        try:
            run2 = run(SP_LONG_M, 1, tmp)
        finally:
            Trainer.initialize = initialize
        if (run2["final"]["step"] != SP_LONG_STEPS + 1
                or list(restored) != [SP_LONG_STEPS]):
            fail(f"train_sp CLI resume at sp={SP_LONG_M}: final "
                 f"{run2['final']}, restored {list(restored)}")
        state = restored.pop(SP_LONG_STEPS)
        with np.load(ckpt.checkpoint_path(tmp, SP_LONG_STEPS)) as z:
            for key, arr in state.items():
                if not np.array_equal(np.asarray(arr), z[key]):
                    fail(f"train_sp CLI: resumed leaf {key} differs from "
                         f"the saved one")
        n_leaves = len(state)
        del state
        result, _ = cli_stdout(gen_cli.run, gen_cli.build_parser()
                               .parse_args([
                                   "--ckpt-dir", tmp, "--prompt-tokens",
                                   "464,2068,7586,21831",
                                   "--max-new-tokens", str(SP_GEN_NEW),
                                   "--temperature", "0", "--eos-id",
                                   "-1"]))
        toks = result["tokens"]
        if len(toks) != SP_GEN_NEW or not all(0 <= t < 50257 for t in toks):
            fail(f"train_sp: the generate CLI's tokens {toks}")
    row = lambda r: {k: r[k] for k in ("argv", "wall_s", "final",
                                       "launches", "saves", "restores",
                                       "peak_gb", "ms_per_step",
                                       "tokens_per_s")}
    print(json.dumps({"train_sp_cli": {
        "long": row(run1), "resumed_leaves_bitwise": n_leaves,
        "resumed_sp4": row(run2), "generate_tokens": toks,
        "note": MESH_NOTE, "card": card}}), flush=True)
    return {"train_sp_cli": run1["launches"],
            "train_sp_cli_sp4": run2["launches"]}


def train_sp(card: str) -> dict:
    """Phase 4k: sequence-parallel training and the chunked LM loss at
    GPT-2 124M's width (bf16, AdamW, the fused head; every mesh one card
    repeated, ``[cuda:0] * m``: its times say nothing about m cards).
    The kernels where this path meets new shapes: B1 non-causal and
    B2/B3 on a two-block ring's global lse and output at S_loc 512 (B=8)
    and 4096 (B=1), against their plain versions. At B=TRAIN_B,
    S=TRAIN_S: (a) the ring at dp=1,sp=SP_M with the flash hops against
    one device's flash step (TRAIN_* tolerances), B1, the pre-pass, B2
    and B3 12 x ring_hops(SP_M) each, exactly; ms a step and the step's
    HBM peak; (b) the composed ring (``sp_use_flash=False``): no launch,
    against (a); (c) Ulysses with the flash kernels against one device,
    12 x SP_M each; (d) ``fused_loss_chunk=SP_CHUNK`` on one device
    against the ``-1`` path: the step's peak below it; (e) the CLI
    (sp_long_cli). -> the launches by path."""
    from nezha_tpu_torch.data import synthetic_token_batches

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(24)
    kernels = {s: sp_kernel_case(g, b, s)
               for b, s in ((TRAIN_B, TRAIN_S // SP_M), (1, SP_LONG_S // 2))}
    print(json.dumps({"train_sp_kernels": {
        "err_over_tolerance": kernels, "card": card}}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    batches = synthetic_token_batches(TRAIN_B, seq_len=TRAIN_S, seed=0)
    batch = next(batches)
    paths, walls = {}, {}
    for part, fn in (("steps", lambda: sp_step_parts(card, batches, batch)),
                     ("cli", lambda: sp_long_cli(card))):
        t0 = time.perf_counter()
        paths.update(fn())
        walls[part] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"train_sp_wall_s": time.perf_counter() - t_phase,
                      "parts_s": walls}), flush=True)
    return paths


# train_graph: the graph-IR engine and the layer-stacked trunk.
# (a) The graph GPT-2's first step (--graph-bf16) against the module
# engine's first step from the same weights: per tensor ||g_graph -
# g_module|| <= GRAPH_GRAD_RTOL ||g_module||, and the loss within
# GRAPH_LOSS_ATOL: twice the largest spreads tools/grad_spread.py --graph
# measured on the H100 over six seeds (PERF.md: 0.0140, wpe/embedding or
# an LN scale, the median tensor ~0.0095; the loss 1.65e-4 of ~10.98), as
# TRAIN_GRAD_RTOL is set. Both sides run the same bf16 policy in another
# op order (the graph's residual adds, casts and fp32 logits are nodes of
# their own). The weights after the step within 2 * lr + 1e-6 (AdamW's
# first move is ~lr sign(g)).
GRAPH_GRAD_RTOL = 0.028
GRAPH_LOSS_ATOL = 0.00033
GRAPH_STEPS = 3           # (a)'s timed steps through Trainer.fit
GRAPH_MLP_STEPS = 3       # (e)'s steps in each mode
GRAPH_MLP_RTOL = 1e-5     # (e): tests/test_torch_graph_programs.py's
GRAPH_SCAN_STEPS = 3      # (f)'s CLI steps
GRAPH_GEN_NEW = 8         # (f)'s greedy tokens a request
GRAPH_PROMPTS = [[464, 2068, 7586, 21831], [15496, 995, 11, 314]]
GRAPH_IMG_B = 256         # resnet50_imagenet's batch


def graph_grads(program_cfg, params: dict, batch: dict, dtype: str):
    """The graph GPT-2 loss graph's loss and gradients (``torch.autograd
    .grad`` over its placeholders) on ``params`` -> (loss, {JAX path:
    gradient})."""
    from nezha_tpu_torch.graph.lower import value_and_grad_callable
    from nezha_tpu_torch.graph.programs import (gpt2_loss_graph,
                                                tree_flatten_with_path)

    b, s = batch["inputs"].shape
    g = gpt2_loss_graph(program_cfg, params, b, s, compute_dtype=dtype)
    pairs = tree_flatten_with_path(params)[0]
    vg = value_and_grad_callable(g, tuple(range(len(pairs))))
    loss, grads = vg(*[leaf for _, leaf in pairs],
                     *[torch.as_tensor(batch[k]).cuda()
                       for k in ("inputs", "targets")])
    return loss, {"/".join(p): gr for (p, _), gr in zip(pairs, grads)}


def module_grads(model, batch: dict, lr_schedule):
    """The module engine's first step's loss and gradients on ``batch``
    ({"tokens"}) -> (loss, {parameter name: gradient}, the step)."""
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.train import make_train_step

    step = make_train_step(model, adamw(lr_schedule, weight_decay=0.1),
                           lm_loss)
    loss, grads = step.loss_and_grads(batch)
    return loss, grads, step


def grads_rel(what: str, got: dict, want: dict, rtol: float) -> dict:
    """Per tensor ||got - want|| / ||want||, each within ``rtol``."""
    worst, name = 0.0, None
    for k, w in want.items():
        rel = ((got[k].float() - w.float()).norm()
               / w.float().norm().clamp_min(1e-30)).item()
        if rel >= worst:
            worst, name = rel, k
    if not worst <= rtol:
        fail(f"{what}: gradient of {name} differs by {worst} of its norm "
             f"(tolerance {rtol})")
    return {"max_grad_rel_err": worst, "worst_param": name,
            "grad_rtol": rtol}


def graph_gpt2_parts(card: str) -> dict:
    """(a)-(c): GPT-2 124M through the graph engine at B=TRAIN_B,
    S=TRAIN_S. -> {"train_graph": (a)'s launches}."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.cli.train import GPT2_SCHEDULE
    from nezha_tpu_torch.data import synthetic_token_batches
    from nezha_tpu_torch.graph import programs
    from nezha_tpu_torch.graph.step import GraphTrainStep
    from nezha_tpu_torch.models.convert import _to_jax_path
    from nezha_tpu_torch.models.gpt2 import with_overrides
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.train import Trainer

    layers = 12
    sched = GPT2_SCHEDULE(GRAPH_STEPS)
    lr0 = sched(0)
    model = gpt2_for_preset("full", seed=0, device="cuda",
                            fused_loss_chunk=-1)
    batches = synthetic_token_batches(TRAIN_B, seq_len=TRAIN_S, seed=0)
    raw = next(batches)
    shard = programs.lm_shard_fn()
    feed = shard(raw)
    out = {}

    def one_step(cfg, dtype, state, want_flash: int):
        """One graph step from ``state``: -> (loss, new state, launches)."""
        prog = programs.make_gpt2_graph_train_step(
            with_overrides(model, **cfg) if cfg else model, sched,
            weight_decay=0.1, compute_dtype=dtype)
        zero_counts()
        new, m = prog(state, feed)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        launches = {k: LAUNCHES[k] for k in LAUNCHES}
        if launches != {k: want_flash for k in LAUNCHES}:
            fail(f"train_graph {cfg or 'flash'} {dtype}: launches "
                 f"{launches}, expected {want_flash} each")
        if not math.isfinite(loss):
            fail(f"train_graph {cfg or 'flash'} {dtype}: loss {loss}")
        return loss, new, launches

    # (a) the first step against the module engine's.
    state0 = programs.init_graph_gpt2_state(model)
    g_loss, g_grads = graph_grads(model.cfg, state0["params"], feed,
                                  "bfloat16")
    m_loss, by_name, m_step = module_grads(model, raw, sched)
    m_grads = {_to_jax_path(n): g for n, g in by_name.items()}
    loss_err = abs(g_loss.item() - m_loss.item())
    if not loss_err <= GRAPH_LOSS_ATOL:
        fail(f"train_graph: graph loss {g_loss.item()} vs module "
             f"{m_loss.item()} (tolerance {GRAPH_LOSS_ATOL})")
    first = {"loss": g_loss.item(), "module_loss": m_loss.item(),
             "loss_err": loss_err, "loss_atol": GRAPH_LOSS_ATOL,
             **grads_rel("train_graph vs module", g_grads, m_grads,
                         GRAPH_GRAD_RTOL)}
    del m_grads
    loss_a, state1, _ = one_step({}, "bfloat16", state0, layers)
    m_step.apply_gradients(by_name)
    del by_name
    module_after = programs.module_param_tree(model)
    worst_w = max((a - b).abs().max().item() for a, b in zip(
        programs.tree_leaves(state1["params"]),
        programs.tree_leaves(module_after)))
    if not worst_w <= 2 * lr0 + 1e-6:
        fail(f"train_graph: weights after one step differ from the module "
             f"engine's by {worst_w} > 2 * lr ({lr0})")
    first.update(step_loss=loss_a, max_weight_err_after_step=worst_w,
                 lr=lr0)
    del module_after, state1, m_step
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the IR's composed attention: no flash launch; the loss and the
    # gradients within the train check's flash-against-composed limits,
    # the weights after the step within 2 * lr.
    x_loss, x_grads = graph_grads(with_overrides(model, attn_impl="xla").cfg,
                                  state0["params"], feed, "bfloat16")
    if not abs(x_loss.item() - g_loss.item()) <= TRAIN_LOSS_ATOL:
        fail(f"train_graph xla: loss {x_loss.item()} vs flash "
             f"{g_loss.item()}")
    composed = {"loss": x_loss.item(),
                "loss_err": abs(x_loss.item() - g_loss.item()),
                **grads_rel("train_graph xla vs flash", x_grads, g_grads,
                            TRAIN_GRAD_RTOL)}
    del x_grads, g_grads
    _, sx, _ = one_step({"attn_impl": "xla"}, "bfloat16", state0, 0)
    _, sf, _ = one_step({}, "bfloat16", state0, layers)
    composed["max_weight_err_after_step"] = max(
        (a - b).abs().max().item() for a, b in zip(
            programs.tree_leaves(sx["params"]),
            programs.tree_leaves(sf["params"])))
    if not composed["max_weight_err_after_step"] <= 2 * lr0 + 1e-6:
        fail(f"train_graph xla: weights after one step {composed}")
    del sx, sf
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the fp32 IR: B1-B3 on fp32 q, k, v.
    fp32_loss, _, fp32_launches = one_step({}, "float32", state0, layers)
    gc.collect()
    torch.cuda.empty_cache()

    # The main path: the graph step in Trainer.fit, GRAPH_STEPS steps.
    prog = programs.make_gpt2_graph_train_step(
        model, sched, weight_decay=0.1, compute_dtype="bfloat16")
    step = GraphTrainStep(prog, state0, shard)
    trainer = Trainer(model, None, None, log_every=0, step_fn=step)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    last = trainer.fit(batches, GRAPH_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    for name in LAUNCHES:
        if launches[name] != layers * GRAPH_STEPS:
            fail(f"train_graph: {name} launched {launches[name]} times in "
                 f"{GRAPH_STEPS} steps, not {layers} a step")
    stats = prog.executor.stats()
    if stats != {"entries": 1, "hits": GRAPH_STEPS - 1, "misses": 1}:
        fail(f"train_graph: executor stats {stats}")
    busy = profiled_busy_share(trainer, batches, 2)
    out["train_graph"] = {k: launches[k] for k in LAUNCHES}
    print(json.dumps({"train_graph": {
        "first_step_vs_module": first, "composed_vs_flash": composed,
        "fp32": {"loss": fp32_loss, "launches": fp32_launches},
        "B": TRAIN_B, "S": TRAIN_S, "steps": GRAPH_STEPS,
        "ms_per_step": wall / GRAPH_STEPS * 1e3,
        "tokens_per_s": TRAIN_B * TRAIN_S * GRAPH_STEPS / wall,
        "last_loss": last["loss"], "executor": stats, **busy,
        "launches": out["train_graph"], "card": card}}), flush=True)
    del trainer, step, prog, state0, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def graph_bert_resnet_mlp(card: str) -> dict:
    """(d) BERT-base and ResNet-50 through the graph engine, (e) the MLP
    single, dp and ZeRO-1 on ``[cuda:0] * 2``."""
    from nezha_tpu_torch.cli.train import BERT_SCHEDULE, MLP_DIMS
    from nezha_tpu_torch.data import (mnist_batches, synthetic_image_batches,
                                      synthetic_mlm_batches)
    from nezha_tpu_torch.graph import programs
    from nezha_tpu_torch.models import MLP
    from nezha_tpu_torch.models.bert import bert_base
    from nezha_tpu_torch.models.resnet import resnet50
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.parallel.mesh import make_mesh
    from nezha_tpu_torch.tensor import bf16_policy

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    bert = bert_base(fused_loss_chunk=-1, generator=gen)
    prog = programs.make_bert_graph_train_step(bert, BERT_SCHEDULE(1),
                                               weight_decay=0.01)
    feed = programs.bert_shard_fn()(next(synthetic_mlm_batches(
        BERT_B, seq_len=BERT_S, seed=0)))
    zero_counts()
    _, m = prog(programs.init_graph_bert_state(bert), feed)
    loss = float(m["loss"])
    launches = {k: LAUNCHES[k] for k in LAUNCHES}
    if launches != {k: 12 for k in LAUNCHES} or not math.isfinite(loss):
        fail(f"train_graph bert: loss {loss}, launches {launches}")
    out["bert"] = {"loss": loss, "launches": launches, "B": BERT_B,
                   "S": BERT_S}
    del bert, prog, feed
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = resnet50(stem="s2d", policy=bf16_policy(), generator=gen)
    prog = programs.make_resnet_graph_train_step(rn, lr=0.1)
    state = programs.init_graph_resnet_state(rn)
    feed = programs.image_shard_fn()(next(synthetic_image_batches(
        GRAPH_IMG_B)))
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(2):   # the same batch twice: the loss must fall
        state, m = prog(state, feed)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if any(counts.values()) or not (all(map(math.isfinite, losses))
                                    and losses[1] < losses[0]):
        fail(f"train_graph resnet: losses {losses}, launches {counts}")
    out["resnet50"] = {"batch": GRAPH_IMG_B, "losses": losses,
                       "ms_per_step": wall / 2 * 1e3,
                       "peak_mem_gb": torch.cuda.max_memory_allocated()
                       / 2 ** 30}
    del rn, prog, state, feed
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(0)
    mlp = MLP(generator=gen)
    onehot = programs.onehot_shard_fn(MLP_DIMS[-1])
    feeds = [onehot(b) for b, _ in zip(mnist_batches(128),
                                       range(GRAPH_MLP_STEPS))]
    mesh = make_mesh({"dp": 2}, [torch.device("cuda", 0)] * 2)
    runs = {
        "single": (programs.init_graph_mlp_state(MLP_DIMS, mlp),
                   programs.make_mlp_graph_train_step(MLP_DIMS, 128, 0.1)),
        "dp": (programs.init_graph_mlp_state(MLP_DIMS, mlp),
               programs.make_mlp_graph_dp_train_step(MLP_DIMS, 128, 0.1,
                                                     mesh)),
        "zero1": (programs.init_graph_mlp_zero1_state(MLP_DIMS, mesh, mlp),
                  programs.make_mlp_graph_zero1_train_step(
                      MLP_DIMS, 128, 0.1, mesh))}
    mlp_losses = {}
    for name, (state, step) in runs.items():
        ls = []
        for f in feeds:
            state, m = step(state, f)
            ls.append(float(m["loss"]))
        mlp_losses[name] = ls
    for name in ("dp", "zero1"):
        if not np.allclose(mlp_losses[name], mlp_losses["single"],
                           rtol=GRAPH_MLP_RTOL, atol=0):
            fail(f"train_graph mlp {name}: losses {mlp_losses}")
    out["mlp"] = {"losses": mlp_losses, "rtol": GRAPH_MLP_RTOL,
                  "mesh": [str(d) for d in mesh.devices]}
    print(json.dumps({"train_graph_models": {**out, "card": card}}),
          flush=True)
    return out


def graph_scan_cli(card: str) -> dict:
    """(f) ``--scan-layers`` through the train CLI in process: GPT-2 124M,
    GRAPH_SCAN_STEPS steps with a save, against the unrolled module run
    twice (the first with a save); the save restored into the unrolled
    model; the generate and serve CLIs from it against the unrolled
    model's save of the same weights (the unrolled run's when the runs
    repeat bitwise, else the restored model saved); one BERT step of a
    scan model. -> {"train_graph_scan": its launches}."""
    import io
    import tempfile

    from nezha_tpu_torch.cli import generate as gen_cli
    from nezha_tpu_torch.cli import serve as serve_cli
    from nezha_tpu_torch.cli.common import (gpt2_for_preset,
                                            restore_variables_any)
    from nezha_tpu_torch.data import synthetic_mlm_batches
    from nezha_tpu_torch.models.bert import bert_base, mlm_loss
    from nezha_tpu_torch.models.convert import train_state_to_jax
    from nezha_tpu_torch.nn.scan import unstack_flat_keys
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.train import checkpoint as ckpt
    from nezha_tpu_torch.train import make_train_step

    layers = 12
    base = ["--config", "gpt2_124m", "--parallel", "single", "--steps",
            str(GRAPH_SCAN_STEPS), "--log-every", "1"]
    with tempfile.TemporaryDirectory(prefix="nezha_graph_scan_") as tmp:
        runs = {}
        for tag, extra in (
                ("scan", ["--scan-layers", "--ckpt-dir", f"{tmp}/scan"]),
                ("unrolled", ["--ckpt-dir", f"{tmp}/unrolled"]),
                ("unrolled_again", [])):
            runs[tag] = cli_run(*base, *extra, in_process=True)
        want = {k: GRAPH_SCAN_STEPS * layers for k in
                ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq",
                 "flash_bwd_dkv")}
        got = {k: runs["scan"]["launches"][k] for k in want}
        if got != want:
            fail(f"train_graph scan CLI: launches {got}, expected {want}")
        losses = {t: [lg["loss"] for lg in r["logs"]]
                  for t, r in runs.items()}
        repeat = losses["unrolled"] == losses["unrolled_again"]
        spread = max(abs(a - b) for a, b in zip(losses["unrolled"],
                                                losses["unrolled_again"]))
        diff = max(abs(a - b) for a, b in zip(losses["scan"],
                                              losses["unrolled"]))
        if (repeat and losses["scan"] != losses["unrolled"]) or \
                diff > spread:
            fail(f"train_graph scan CLI: losses {losses}")
        # The save restores into the unrolled model leaf for leaf.
        model = gpt2_for_preset("full", seed=0, device="cuda")
        restore_variables_any(f"{tmp}/scan", model)
        step = ckpt.latest_step(f"{tmp}/scan")
        with np.load(ckpt.checkpoint_path(f"{tmp}/scan", step)) as z:
            saved = unstack_flat_keys(
                {k: z[k] for k in z.files
                 if k.startswith("variables/params/")}, "h", layers,
                "h_scan")
        mine = train_state_to_jax(model)
        for k, v in saved.items():
            if mine[k].tobytes() != np.asarray(v).tobytes():
                fail(f"train_graph scan: restored leaf {k} differs")
        same = f"{tmp}/unrolled"
        if repeat:   # the unrolled run's save holds the same weights
            with np.load(ckpt.checkpoint_path(same, step)) as z:
                for k, v in mine.items():
                    if z[k].tobytes() != v.tobytes():
                        fail(f"train_graph scan: leaf {k} differs from the "
                             f"unrolled run's save")
        else:
            same = f"{tmp}/same"
            ckpt.save_checkpoint(same, mine, step)
        del model
        gc.collect()
        inference = {}
        for tag, ck in (("scan", f"{tmp}/scan"), ("same", same)):
            argv = ["--ckpt-dir", ck, "--prompt-tokens",
                    ",".join(map(str, GRAPH_PROMPTS[0])),
                    "--max-new-tokens", str(GRAPH_GEN_NEW), "--temperature",
                    "0", "--ln-impl", "pallas", "--eos-id", "-1"]
            zero_counts()
            g, _ = cli_stdout(gen_cli.run,
                              gen_cli.build_parser().parse_args(argv))
            torch.cuda.synchronize()
            gl = read_counts()
            args = serve_cli.build_parser().parse_args([
                "--ckpt-dir", ck, "--max-len", "64",
                "--max-prefill-len", "16", "--eos-id", "-1"])
            sched = serve_cli.build_scheduler(args)
            outbuf = io.StringIO()
            zero_counts()
            serve_cli.run_stdio(sched, args, stdin=io.StringIO("".join(
                json.dumps({"id": f"p{i}", "prompt_tokens": p,
                            "max_new_tokens": GRAPH_GEN_NEW}) + "\n"
                for i, p in enumerate(GRAPH_PROMPTS))), stdout=outbuf)
            torch.cuda.synchronize()
            sl = read_counts()
            del sched
            gc.collect()
            inference[tag] = {
                "generate": g["tokens"],
                "serve": [json.loads(line)["tokens"] for line in
                          outbuf.getvalue().splitlines()],
                "generate_launches": {k: gl[k] for k in (
                    "flash_fwd", "flash_decode", "layer_norm_fwd")},
                "serve_launches": {k: sl[k] for k in (
                    "paged_prefill", "paged_decode")}}
        n = GRAPH_GEN_NEW
        want_gen = {"flash_fwd": layers, "flash_decode": layers * (n - 1),
                    "layer_norm_fwd": (2 * layers + 1) * n}
        if inference["scan"] != inference["same"] or \
                inference["scan"]["generate_launches"] != want_gen or \
                min(inference["scan"]["serve_launches"].values()) <= 0:
            fail(f"train_graph scan inference: {inference} (generate "
                 f"launches expected {want_gen})")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bert = bert_base(fused_loss_chunk=-1, scan_layers=True, generator=gen)
    step_fn = make_train_step(bert, adamw(BERT_LR, weight_decay=BERT_WD),
                              mlm_loss)
    zero_counts()
    bert_loss = float(step_fn(next(synthetic_mlm_batches(
        BERT_B, seq_len=BERT_S, seed=0)))["loss"])
    bert_l = {k: read_counts()[k] for k in want}
    if bert_l != {k: layers for k in want} or not math.isfinite(bert_loss):
        fail(f"train_graph scan bert: loss {bert_loss}, launches {bert_l}")
    del bert, step_fn
    print(json.dumps({"train_graph_scan": {
        "losses": losses, "unrolled_repeats_bitwise": repeat,
        "unrolled_spread": spread, "scan_vs_unrolled": diff,
        "wall_s": {t: r["wall_s"] for t, r in runs.items()},
        "inference": inference["scan"], "bert_loss": bert_loss,
        "bert_launches": bert_l, "card": card}}), flush=True)
    return {"train_graph_scan": runs["scan"]["launches"]}


def train_graph(card: str) -> dict:
    """Phase 4l: the graph-IR engine and ``--scan-layers``. -> the
    launches by path."""
    t_phase = time.perf_counter()
    paths, walls = {}, {}
    for part, fn in (("gpt2", graph_gpt2_parts),
                     ("models", graph_bert_resnet_mlp),
                     ("scan", graph_scan_cli)):
        t0 = time.perf_counter()
        got = fn(card)
        if part != "models":
            paths.update(got)
        walls[part] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"train_graph_wall_s": time.perf_counter() - t_phase,
                      "parts_s": walls}), flush=True)
    return paths


REJOIN_B = 4              # GPT-2 124M rows a rank: two trainers on the card
REJOIN_STEPS = 80         # rank 0's horizon
REJOIN_MORE = 5           # the replacement's steps after its resume
REJOIN_EVERY = 5          # --failure-check-every and --log-every
REJOIN_TIMEOUT_S = 300    # the healed world's --rejoin-timeout
REJOIN_GIVE_UP_S = 3      # the world with no replacement
REJOIN_WAIT_S = 600       # the longest a rank's line or exit is awaited


def train_rank_main(out: str, argv) -> int:
    """One rank of the rejoin phase, a process of its own (``python3
    chip_smoke.py --train-rank OUT -- ARGV``): the train CLI's ``main``
    on ARGV, its kernel counts set to 0 just before and written to OUT as
    JSON just after, also when it raises."""
    from nezha_tpu_torch.cli import train as train_cli

    zero_counts()
    try:
        return train_cli.main(argv)
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        with open(out, "w") as f:
            json.dump(read_counts(), f)


class RejoinWorld:
    """Two ranks of the train CLI on the card under ``--on-failure
    rejoin`` (``--parallel single``, one ``--ckpt-dir``, the coordinator
    served by rank 0 on a free port): per-rank stderr and count files,
    polling for a line, every rank stopped at the end."""

    def __init__(self, tmp: str, tag: str, timeout_s: float):
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        self.root = os.path.dirname(os.path.abspath(__file__))
        self.dir = f"{tmp}/{tag}"
        os.makedirs(self.dir)
        self.ck = f"{self.dir}/ck"
        self.argv = ["--config", "gpt2_124m", "--parallel", "single",
                     "--batch-size", str(REJOIN_B), "--coordinator",
                     f"127.0.0.1:{port}", "--on-failure", "rejoin",
                     "--rejoin-timeout", str(timeout_s),
                     "--failure-check-every", str(REJOIN_EVERY),
                     "--log-every", str(REJOIN_EVERY), "--ckpt-dir",
                     self.ck]
        self.procs = []

    def launch(self, name: str, *extra):
        env = dict(os.environ, PYTHONPATH=self.root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        with open(f"{self.dir}/{name}.err", "w") as err:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--train-rank",
                 f"{self.dir}/{name}.counts.json", "--", *self.argv,
                 *extra], stdout=subprocess.DEVNULL, stderr=err,
                cwd=self.root, env=env)
        self.procs.append(proc)
        return proc

    def err(self, name: str) -> str:
        with open(f"{self.dir}/{name}.err") as f:
            return f.read()

    def counts(self, name: str) -> dict:
        with open(f"{self.dir}/{name}.counts.json") as f:
            return json.load(f)

    def wait_for(self, name: str, needle: str, proc) -> float:
        """Poll the rank's stderr for ``needle`` while it runs; -> the
        wall clock when it was seen."""
        deadline = time.monotonic() + REJOIN_WAIT_S
        while needle not in self.err(name):
            if proc.poll() is not None:
                fail(f"rejoin: {name} exited {proc.returncode} before "
                     f"{needle!r}: {self.err(name)[-3000:]}")
            if time.monotonic() > deadline:
                fail(f"rejoin: {name} printed no {needle!r} in "
                     f"{REJOIN_WAIT_S} s")
            time.sleep(0.05)
        return time.time()

    def wait(self, name: str, proc) -> int:
        try:
            return proc.wait(timeout=REJOIN_WAIT_S)
        except subprocess.TimeoutExpired:
            fail(f"rejoin: {name} did not exit in {REJOIN_WAIT_S} s: "
                 f"{self.err(name)[-3000:]}")

    def stop(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def rank_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def rejoin(card: str) -> dict:
    """Phase 4g (see the module docstring). -> the survivor's kernel
    counts over its whole run."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="nezha_rejoin_") as tmp:
        w = RejoinWorld(tmp, "heal", REJOIN_TIMEOUT_S)
        try:
            r0 = w.launch("r0", "--steps", str(REJOIN_STEPS),
                          "--serve-coordinator", "--world-size", "2")
            r1 = w.launch("r1", "--steps", str(REJOIN_STEPS),
                          "--rank-hint", "1")
            w.wait_for("r1", '"step"', r1)
            r1.kill()
            killed = time.time()
            r1.wait()
            waiting = w.wait_for("r0", "waiting for rejoin", r0)
            r1b = w.launch("r1b", "--steps", str(REJOIN_MORE),
                           "--rank-hint", "1")
            rc0, rc1 = w.wait("r0", r0), w.wait("r1b", r1b)
        finally:
            w.stop()
        e0, e1 = w.err("r0"), w.err("r1b")
        if rc0 or rc1:
            fail(f"rejoin: rank 0 exited {rc0}, the replacement {rc1}: "
                 f"{e0[-2000:]} {e1[-2000:]}")
        lines = rank_lines(e0)
        steps = [m["step"] for m in lines if "loss" in m]
        records = [m["rejoin"] for m in lines if "rejoin" in m]
        healed = re.search(r"world healed; resumed from step (\d+)", e0)
        if not (healed and len(records) == 1 and steps
                and steps[-1] == REJOIN_STEPS
                and all(a < b for a, b in zip(steps, steps[1:]))):
            fail(f"rejoin: rank 0's steps {steps}, records {records}: "
                 f"{e0[-3000:]}")
        step = int(healed.group(1))
        rescue = [m["save"] for m in lines
                  if "save" in m and m["save"]["step"] == step]
        resumed = re.search(r"resumed from step (\d+)", e1)
        if not (rescue and resumed and int(resumed.group(1)) == step):
            fail(f"rejoin: rescue save {rescue}, the replacement: "
                 f"{e1[-3000:]}")
        survivor = w.counts("r0")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            if survivor[name] <= 0:
                fail(f"rejoin: {name} not launched on rank 0")
        record = records[0]
        r1_steps = [m["step"] for m in rank_lines(w.err("r1"))
                    if "loss" in m]
        heal = {"killed_at_rank1_step": r1_steps[-1], "heal_step": step,
                "kill_to_detect_s": record["detected_at"] - killed,
                "kill_to_waiting_line_s": waiting - killed,
                "rescue_save_s": rescue[0]["seconds"],
                "rescue_save_bytes": rescue[0]["bytes"],
                "heal_wait_s": record["wait_s"],
                "reload_s": record["reload_s"],
                "rank0_steps_logged": len(steps),
                "replacement_launches": {
                    k: v for k, v in w.counts("r1b").items() if v},
                "rank0_launches": {k: v for k, v in survivor.items() if v}}

        # No replacement: the survivor gives up, loudly, once the rescue
        # checkpoint is on disk.
        w = RejoinWorld(tmp, "give_up", REJOIN_GIVE_UP_S)
        try:
            r0 = w.launch("r0", "--steps", str(REJOIN_STEPS),
                          "--serve-coordinator", "--world-size", "2")
            r1 = w.launch("r1", "--steps", str(REJOIN_STEPS),
                          "--rank-hint", "1")
            w.wait_for("r1", '"step"', r1)
            r1.kill()
            r1.wait()
            rc0 = w.wait("r0", r0)
        finally:
            w.stop()
        want = f"no replacement rejoined within {REJOIN_GIVE_UP_S}s"
        npz = [n for n in os.listdir(w.ck) if n.endswith(".npz")]
        if rc0 == 0 or want not in w.err("r0") or not npz:
            fail(f"rejoin without a replacement: rc {rc0}, checkpoints "
                 f"{npz}: {w.err('r0')[-3000:]}")
        heal["give_up"] = {"rc": rc0, "rescue": npz}
    heal.update(card=card, wall_s=time.perf_counter() - t0)
    print(json.dumps({"rejoin": heal}), flush=True)
    return survivor


HF_LOGIT_ATOL = 2e-3      # fp32 port against fp32 transformers, the card
HF_PROMPT = 64            # prompt tokens of the interop checks
HF_NEW = 32               # greedy tokens of the --hf-dir generate
RESHARD_MESH = 4          # the serve mesh, all on the one card
IMG_CLASSES, IMG_PER_CLASS = 4, 8


def hf_logits_check(what: str, port, hf_model, ids) -> float:
    """The prompt's last logits of ``port`` against ``hf_model``'s (both
    fp32 on the card) within HF_LOGIT_ATOL; -> the largest error."""
    with torch.no_grad():
        want = hf_model(ids).logits[:, -1].float()
        got = port(ids)[:, -1].float()
    err = float((got - want).abs().max())
    if not err <= HF_LOGIT_ATOL:
        fail(f"{what}: last logits {err} from transformers' "
             f"(bound {HF_LOGIT_ATOL})")
    return err


def serve_tokens(argv, prompts, counts: bool = False):
    """The serve CLI in-process on ``argv``, one greedy request a
    prompt; -> ({id: tokens}, the kernel counts of its run or None)."""
    import io

    from nezha_tpu_torch.cli import serve as serve_cli

    args = serve_cli.build_parser().parse_args(argv)
    sched = serve_cli.build_scheduler(args)
    out = io.StringIO()
    reqs = "".join(json.dumps({"id": f"p{i}", "prompt_tokens": p,
                               "max_new_tokens": SH_NEW}) + "\n"
                   for i, p in enumerate(prompts))
    zero_counts()
    serve_cli.run_stdio(sched, args, stdin=io.StringIO(reqs), stdout=out)
    torch.cuda.synchronize()
    launches = read_counts() if counts else None
    res = {r["id"]: r for r in map(json.loads, out.getvalue().splitlines())}
    if len(res) != len(prompts) or any(r["event"] != "done"
                                       for r in res.values()):
        fail(f"interop serve {argv}: {res}")
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    return {k: r["tokens"] for k, r in res.items()}, launches


def hf_interop(tmp: str, card: str):
    """(1)-(2): a random GPT-2 124M saved by transformers, generated from
    through ``--hf-dir``. -> (the generate run's counts, a summary)."""
    from nezha_tpu_torch.cli import generate as gen_cli
    from nezha_tpu_torch.models import hf

    d = f"{tmp}/hf_gpt2"
    hf_model = hf.random_hf_model("gpt2", seed=0, device="cuda")
    t0 = time.perf_counter()
    hf_model.save_pretrained(d)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    port = hf.load_gpt2(d, device="cuda", ln_impl="pallas")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, port.cfg.vocab_size, (1, HF_PROMPT), generator=g)
    err = hf_logits_check("hf_generate", port, hf_model, ids.cuda())
    argv = ["--hf-dir", d, "--prompt-tokens",
            ",".join(map(str, ids[0].tolist())), "--max-new-tokens",
            str(HF_NEW), "--temperature", "0", "--ln-impl", "pallas",
            "--eos-id", "-1"]
    zero_counts()
    got, _ = cli_stdout(gen_cli.run, gen_cli.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    launches = read_counts()
    for name in ("flash_fwd", "flash_decode", "layer_norm_fwd"):
        if launches[name] <= 0:
            fail(f"hf_generate: {name} not launched ({launches})")
    # Each greedy token against transformers' forward over the prompt and
    # the port's tokens, wherever its top-2 margin exceeds the bound the
    # generate path's bf16 cache allows.
    toks = got["tokens"]
    with torch.no_grad():
        seq = torch.tensor([ids[0].tolist() + toks[:-1]], device="cuda")
        ref = hf_model(seq).logits[0, HF_PROMPT - 1:].float()
    top2 = ref.topk(2, dim=-1)
    held = 0
    for j, t in enumerate(toks):
        margin = float(top2.values[j, 0] - top2.values[j, 1])
        if margin > SERVE_LOGIT_ATOL:
            if int(top2.indices[j, 0]) != t:
                fail(f"hf_generate: token {j} {t}, transformers "
                     f"{int(top2.indices[j, 0])}, margin {margin}")
            held += 1
    del port, hf_model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"save_pretrained_s": save_s, "hf_dir_load_s": load_s,
                      "last_logits_max_abs_err": err,
                      "tokens": len(toks), "tokens_held": held,
                      "files": sorted(os.listdir(d))}


def export_check(dirs: dict, tmp: str) -> dict:
    """(3): the export CLI in both formats from the dense save; each is
    taken by ``GPT2LMHeadModel.load_state_dict(strict=True)``, both hold
    the same bits, and the loaded model's logits match the port's fp32
    forward of the checkpoint."""
    from nezha_tpu_torch.cli import export as export_cli
    from nezha_tpu_torch.cli.common import restore_variables_any
    from nezha_tpu_torch.models import GPT2, GPT2Config, hf

    port = GPT2(GPT2Config(), device="cuda")     # fp32, as transformers
    restore_variables_any(dirs["dense"], port)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 50257, (1, HF_PROMPT), generator=g).cuda()
    out, states = {}, {}
    for fmt in ("npz", "torch"):
        t0 = time.perf_counter()
        res, _ = cli_stdout(export_cli.run, export_cli.build_parser()
                            .parse_args(["--config", "gpt2_124m",
                                         "--ckpt-dir", dirs["dense"],
                                         "--out", f"{tmp}/export_{fmt}",
                                         "--format", fmt]))
        wall = time.perf_counter() - t0
        if fmt == "npz":
            with np.load(res["out"]) as z:
                sd = {k: torch.from_numpy(z[k]) for k in z.files}
        else:
            sd = torch.load(res["out"])
        model = hf.random_hf_model("gpt2", seed=5, device="cuda")
        model.load_state_dict(sd, strict=True)
        err = hf_logits_check(f"export {fmt}", port, model, ids)
        states[fmt] = sd
        out[fmt] = {"keys": res["keys"], "seconds": wall,
                    "bytes": os.path.getsize(res["out"]),
                    "logits_max_abs_err": err}
        del model
    if sorted(states["npz"]) != sorted(states["torch"]) or any(
            not torch.equal(states["npz"][k], states["torch"][k])
            for k in states["npz"]):
        fail("export: the npz and torch exports differ")
    del port, states
    gc.collect()
    torch.cuda.empty_cache()
    return out


def reshard_check(dirs: dict, tmp: str) -> dict:
    """(4): the reshard CLI, a process of its own (its seconds and peak
    resident memory are its own), from the dense and the per-shard save
    onto RESHARD_MESH shards of the card, written out and verified."""
    out = {}
    for name, d in dirs.items():
        lines, _, wall = module_run(
            "reshard", "--ckpt-dir", d, "--mesh", str(RESHARD_MESH),
            "--shard-device", "cuda:0", "--out", f"{tmp}/serve_{name}",
            "--verify", "--json")
        report = json.loads("\n".join(lines))
        if not (report.get("roundtrip_ok") and report["step"] == 2):
            fail(f"reshard from {name}: {report}")
        out[name] = {k: report[k] for k in (
            "seconds", "peak_host_rss_bytes", "host_rss_before_bytes",
            "params_bytes", "params_bytes_per_device")}
        out[name]["process_wall_s"] = wall
    return out


def mesh_serve_check(dirs: dict) -> tuple:
    """(5): serve ``--mesh RESHARD_MESH --ckpt-dir`` (the checkpoint
    streamed onto the card's shards) against the single-device serve of
    the same checkpoint, token by token to the first divergence, which
    must fall where the no-cache reference's top-2 margin is within
    SERVE_LOGIT_ATOL. -> (the mesh run's counts, a summary)."""
    from nezha_tpu_torch.cli import generate as gen_cli
    from nezha_tpu_torch.cli.common import load_gpt2_for_inference

    common = ["--ckpt-dir", dirs["dense"], "--max-len", "128",
              "--max-prefill-len", "32", "--eos-id", "-1"]
    mesh, launches = serve_tokens(common + [
        "--mesh", str(RESHARD_MESH), "--shard-device", "cuda:0"],
        SH_PROMPTS, counts=True)
    for name in ("paged_decode", "paged_prefill"):
        if launches[name] <= 0:
            fail(f"resharded serve: {name} not launched ({launches})")
    single, _ = serve_tokens(common, SH_PROMPTS)
    model = load_gpt2_for_inference(gen_cli.build_parser().parse_args(
        ["--ckpt-dir", dirs["dense"], "--prompt-tokens", "1"])).eval()
    reference = xla_reference(model)
    compared = checked = equal = 0
    with torch.no_grad():
        for i, p in enumerate(SH_PROMPTS):
            n, k = agree_to_divergence(
                f"resharded serve against one device, prompt {i}",
                reference, p, single[f"p{i}"], mesh[f"p{i}"])
            compared, checked = compared + n, checked + k
            equal += single[f"p{i}"] == mesh[f"p{i}"]
    del model, reference
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"requests": len(SH_PROMPTS), "requests_equal": equal,
                      "tokens_compared": compared,
                      "tokens_checked": checked}


def pack_images_check(tmp: str) -> dict:
    """(6): JPEGs and PNGs written here, packed by the pack_images CLI,
    then the tiny ResNet trained and evaluated from the records through
    the train CLI (both in-process)."""
    from PIL import Image

    from nezha_tpu_torch.cli import pack_images as pack_cli
    from nezha_tpu_torch.cli import train as train_cli

    src, data = f"{tmp}/images", f"{tmp}/image_records"
    r = np.random.RandomState(0)
    for c in range(IMG_CLASSES):
        os.makedirs(f"{src}/c{c}")
        for i in range(IMG_PER_CLASS):
            fmt = "png" if i % 2 == 0 else "jpg"
            Image.fromarray(r.randint(0, 256, (40, 44, 3), dtype=np.uint8)
                            ).save(f"{src}/c{c}/img{i}.{fmt}")
    t0 = time.perf_counter()
    summary = pack_cli.run(pack_cli.build_parser().parse_args(
        [src, "--out-dir", data, "--size", "36", "--val-fraction", "0.25"]))
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    final = train_cli.run(train_cli.parse_args(
        ["--config", "resnet50_imagenet", "--model-preset", "tiny",
         "--data-dir", data, "--crop", "32", "--batch-size", "8",
         "--steps", "4", "--log-every", "2", "--eval"]))
    n_val = IMG_CLASSES * IMG_PER_CLASS // 4
    if not (summary["num_val"] == n_val and math.isfinite(final["loss"])
            and final.get("eval_count") == n_val):
        fail(f"pack_images: {summary}, train {final}, want {n_val} val "
             f"records")
    return {"pack_s": pack_s, "records": [summary["num_train"], n_val],
            "train_final": final, "train_wall_s": time.perf_counter() - t0}


def interop(card: str) -> dict:
    """Phase 4h (see the module docstring). -> the counts of its
    ``--hf-dir`` generate and resharded serve runs."""
    import tempfile

    t0 = time.perf_counter()
    os.environ["HF_HUB_OFFLINE"] = "1"   # every directory here is local
    out = {"card": card}
    with tempfile.TemporaryDirectory(prefix="nezha_interop_") as tmp:
        gen_launches, out["hf_generate"] = hf_interop(tmp, card)
        print(json.dumps({"interop_hf_generate": out["hf_generate"]}),
              flush=True)
        dirs = {"dense": f"{tmp}/gpt2_dense",
                "sharded": f"{tmp}/gpt2_sharded"}
        gpt2_saves(dirs, "interop")
        out["export"] = export_check(dirs, tmp)
        print(json.dumps({"interop_export": out["export"]}), flush=True)
        out["reshard"] = reshard_check(dirs, tmp)
        print(json.dumps({"interop_reshard": out["reshard"]}), flush=True)
        serve_launches, out["mesh_serve"] = mesh_serve_check(dirs)
        print(json.dumps({"interop_mesh_serve": out["mesh_serve"]}),
              flush=True)
        out["pack_images"] = pack_images_check(tmp)
        print(json.dumps({"interop_pack_images": out["pack_images"]}),
              flush=True)
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"interop_wall_s": out["wall_s"]}), flush=True)
    return {"hf_generate": gen_launches, "resharded_serve": serve_launches}


HOME_PATH = {"paged_decode": "serve", "paged_prefill": "serve",
             "paged_prefill_qoff": "serve_seq",
             "paged_quant_decode": "serve_int8",
             "paged_quant_prefill": "serve_int8",
             "flash_fwd": "train", "flash_bwd_dq": "train",
             "flash_bwd_dkv": "train", "flash_decode": "generate",
             "layer_norm_fwd": "generate", "layer_norm_bwd": "train_ln"}


def clear_kernel_switches() -> list:
    """Delete every ``NEZHA_NO_*`` variable from this process's
    environment (and so from its children's), so that no phase runs a
    composed path in place of a kernel by accident; -> the names
    removed."""
    removed = sorted(k for k in os.environ if k.startswith("NEZHA_NO_"))
    for name in removed:
        del os.environ[name]
    return removed


def main() -> int:
    t_main = time.perf_counter()
    removed = clear_kernel_switches()
    phase("device")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the card")
    print(json.dumps({"kernel_switches_removed": removed}), flush=True)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"{card}, power limit unknown"
    print(f"card: {card}; nvidia-smi: {card_line}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    phase("build")
    from nezha_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    times = build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "per_kernel_s": times}), flush=True)

    phase("kernels")
    print(json.dumps({"timer_zero": {"call": "torch.cuda._sleep(0)",
                                     **empty_row()}}), flush=True)
    g = torch.Generator().manual_seed(0)
    kernels = ([check_decode(g), check_prefill(g)] + check_flash(g)
               + [check_flash_decode(g)] + check_layer_norm(g)
               + [check_quant_decode(g), check_quant_prefill(g),
                  check_prefill_qoff(g)])
    ln = next(k for k in kernels if k["name"] == "layer_norm_fwd")
    print(json.dumps({"layer_norm_fwd_by_rows": {
        rows: {f: r[f] for f in ("ms", "profiler_us", "library_ms",
                                 "library_profiler_us", "plain_ms",
                                 "bound_ms")}
        for rows, r in ln["by_rows"].items()}}), flush=True)
    print(json.dumps({"timer": {
        "rows": len(TIMED_ROWS), "host_late": 0,
        "profiler_disagrees": [
            {"row": label, "ms": ms, "profiler_us": prof}
            for label, ms, prof, flag in TIMED_ROWS if flag]}}), flush=True)
    phase("train")
    paths, ln_rows = train(card)
    phase("train_bert")
    paths["train_bert"], bert = train_bert(card)
    phase("train_image")
    image = train_image(card)
    phase("train_cli")
    train_cli()
    phase("train_flags")
    paths.update(train_flags(card))
    phase("train_tp")
    paths.update(train_tp(card))
    phase("train_pp_moe")
    paths.update(train_pp_moe(card))
    gc.collect()
    torch.cuda.empty_cache()
    phase("train_sp")
    paths.update(train_sp(card))
    gc.collect()
    torch.cuda.empty_cache()
    phase("train_graph")
    paths.update(train_graph(card))
    phase("train_dist")
    dist_paths = train_dist(card)
    paths["train_dist_gpt2"] = dist_paths["gpt2_124m"]
    paths["train_dist_bert"] = dist_paths["bert_base_zero1"]
    gc.collect()
    torch.cuda.empty_cache()   # the two ranks share the card
    phase("rejoin")
    paths["rejoin"] = rejoin(card)
    phase("interop")
    paths.update(interop(card))
    phase("data_ckpt")
    dc_launches, dc = data_ckpt(card)
    paths["data_ckpt_train"] = dc_launches["train"]
    paths["data_ckpt_generate"] = dc_launches["generate"]
    paths["data_ckpt_serve"] = dc_launches["serve"]
    phase("serve")
    paths["serve"] = serve(card)
    paths["serve_int8"] = serve(card, "int8")
    phase("serve_modes")
    paths.update(serve_modes(card))
    phase("serve_wire")
    paths.update(serve_wire(card))
    phase("serve_fleet")
    paths.update(serve_fleet(card))
    phase("serve_seq")
    seq = serve_seq(card)
    paths["serve_seq"] = seq["ring_bf16"]
    paths["serve_seq_ulysses"] = seq["ulysses_bf16"]
    paths["serve_seq_int8"] = seq["ulysses_int8"]
    phase("serve_mesh")
    paths.update(serve_mesh(card))
    phase("generate")
    paths["generate"], gen_rows = generate_phase(card)
    ln_rows.update(gen_rows)
    for k in kernels:
        home = HOME_PATH[k["name"]]
        k["launches"] = paths[home][k["name"]]
        k["launches_path"] = home
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()
                                 if k["name"] in c}
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on the {home} path")
        if k["name"] == "layer_norm_fwd":
            # By row count, as each path's wrapper counted them.
            k["launches_by_rows"] = ln_rows
        if k["name"] == "layer_norm_bwd":
            # B5's column sums run once after each of its launches.
            k["sums_launches"] = paths[home]["layer_norm_bwd_sums"]
            if k["sums_launches"] != k["launches"]:
                fail(f"layer_norm_bwd_sums launched {k['sums_launches']} "
                     f"times for {k['launches']} backward launches")
        if k["name"] == "flash_bwd_dkv":
            # B3's delta pre-pass runs before each dK/dV launch.
            k["pre_pass_launches"] = paths[home]["flash_bwd_delta"]
            if k["pre_pass_launches"] != k["launches"]:
                fail(f"flash_bwd_delta launched {k['pre_pass_launches']} "
                     f"times for {k['launches']} dK/dV launches")
    phase()
    print(f"train_bert: {bert['tokens_per_s']:.1f} tokens/s, "
          f"{bert['ms_per_step']:.2f} ms/step, MFU {bert['mfu']:.4f}, busy "
          f"{bert['device_busy_share']:.3f} (BERT-base bf16, B={BERT_B}, "
          f"S={BERT_S}) on {card_line}", flush=True)
    print(f"train_image: {image['images_per_s']:.1f} images/s, "
          f"{image['ms_per_step']:.2f} ms/step, MFU {image['mfu']:.4f} "
          f"(ResNet-50 bf16, batch {IMG_B}, {IMG_SIZE} px); WRN-101-2 "
          f"{image['wrn101_images_per_s']:.1f} images/s, MFU "
          f"{image['wrn101_mfu']:.4f} (batch {WRN_B}) on {card_line}",
          flush=True)
    print(json.dumps({"smoke_wall_s": time.perf_counter() - t_main}),
          flush=True)
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-rank"] and sys.argv[3:4] == ["--"]:
        sys.exit(train_rank_main(sys.argv[2], sys.argv[4:]))
    sys.exit(main())
