#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (singa_tpu_torch) on one card.

Run from the repository root on a host with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in the order they run (any failure raises and exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from the sources in the checkout (one nvcc per
   source, all started together) and print each kernel's registers and
   spills; then a census of the kernels' SASS (`cuobjdump -sass`):
   tensor-core products (HMMA, HGMMA), asynchronous or 16-byte global
   loads (LDGSTS, UTMALDG, LDG.E.128) and ldmatrix (LDSM) per kernel
   instantiation; every instantiation of the forward, the dQ and the
   dK/dV kernel must have products and such loads, and the max-pool
   backward's 16-byte vector instantiations such loads;
3. hold the flash-attention forward kernel against its plain PyTorch
   version: the fused layout at gpt_medium's shape (fp32, fp32 with
   mxu_bf16, bf16), the head-split layout with Tq != Tk (causal and
   not), head dims 32 and 64, causal rows with no key (Tq > Tk, exact 0),
   and BERT-base's fused shape (16 x 512, 12 heads of hd 64, non-causal)
   in fp32 and bf16;
   print max|d|, the kernel's, the plain version's and
   F.scaled_dot_product_attention's times (the last as a yardstick only,
   where its masking is the same) and the data-sheet bound at the rate of
   the kernel's arithmetic (fp32: three TF32 passes, 165 TFLOP/s; bf16:
   989), with the fp32 FMA figure (67 TFLOP/s) beside it;
4. the same for the dQ and dK/dV backward kernels (11 cases, with
   bitwise repeats, exact-zero empty rows, an lse cotangent and the two
   BERT-base cases);
5. hold the max-pool backward kernel (K2a) against its plain version on
   ReLU-clamped inputs (exact-zero ties): the reference's eight cases,
   the ResNet-50 stem shape in fp32 and bf16, and in fp32 at the
   DistOpt phase's 32 images (which must take the kernel's 16-byte
   vector route), the pools of vgg16_cifar,
   alexnet_cifar and the ImageNet AlexNet's first pool at batch 128,
   its other two k3 s2 pools ((27, 27, 192), (13, 13, 256)), a plateau of
   tied values (x rounded to a few levels) under overlapping k3 s1 p1
   windows at batch 128, x in channels-first memory (which must take
   the kernel's one-channel route, in fp32 and bf16), k7 s1 windows
   (taken in chunks), and Xception's four k3 s2 p1 pools at batch 128
   ((112, 112, 128), (56, 56, 256), (28, 28, 728), (14, 14, 1024)) in
   fp32 and bf16, which must take the 16-byte vector route;
   the same selected positions, max|d| within 1e-6 (fp32) or 1e-2 (bf16)
   of max(1, max|plain|), a bitwise repeat; and the default route
   (PyTorch's max-pool backward) must pick the same positions; print the
   kernel's, the plain version's and that library backward's times and
   the bytes bound;
6. gpt_medium at full width (seeded random weights carried in through
   load_singa_tpu_params) scores 4 x 1024 tokens with `model(ids)`,
   which must launch the forward kernel exactly 12 times, then
   `generate` answers 4 prompts of 224 tokens (48 new, window 256); the
   logits equal the same model with the kernel off, greedy tokens
   repeat, the prefill's logits equal `model(ctx)`; print tokens/s;
7. gpt_medium serves through `ServingEngine` (slots 8, block 16,
   window 1024, prefill batch 2, an fp32 pool of 513 blocks): 16
   seeded requests (prompts 64-768, max_new 32-128, half greedy, half
   sampled at 0.8) admitted as slots free. The decode step must be one
   captured CUDA Graph (`decode_compiles == 1`), every request must end
   with exactly max_new tokens and the allocator drain; `peek_logits`
   rows must equal the dense `decode_step` (teacher-forced on each
   stream) within 2e-3, every token must equal the dense pick wherever
   the top-2 margin is at least 2e-3, and each sampled stream solo
   `generate` up to its first near-tie. Prints the step's device time
   captured and uncaptured (in turns), the paged gathers' share, decode
   tokens/s, the per-token p50/p95 of `serve_token_ms`, prefill ms per
   batch and the pool's bytes; then the same short mix on fp32, bf16
   and int8 pools of one pool_bytes (capacity, step time, logit gap to
   fp32 within 0.15), and 8 requests on a 512-token shared prefix cold
   and warm (suffix-only prefill, warm streams equal cold ones up to
   the first near-tie, prefill ms of each);
   then the serving stack around the engine, each phase with the launch
   counts set to 0 before it and printed after (none reaches a kernel):
   `serve spec`, `SpeculativeEngine(spec_k=4)` on 8 requests (prompts
   64-512, max_new 32-64, half sampled at 0.8) with the target as its
   own draft and with `gpt_draft(target)` (seed-1 weights), and the
   plain engine on the same mix, in turns (plain, self, tiny, tiny,
   self, plain): propose and verify each one captured graph, exact
   max_new, the allocator drains, greedy streams equal the dense picks
   outside near-ties, the self draft accepts >= 0.9, a second run
   repeats every stream; prints propose and verify ms (CUDA events),
   tokens per round, decode tokens/s and the round's bound. `serve
   frontend`: `Frontend` over the engine with the serve mix
   (priorities high/normal/background, tenants a/b), FIFO, overlapped
   and chunk-scheduled (budget 2) in turns, each stream equal to FIFO's
   up to its first near-tie (FIFO's to the dense picks); per-token
   p50/p95 and the decode-stall p95; then a SIGTERM the process sends
   itself at a stream's 64th token, with a drain budget of 32 tokens.
   `serve router`: `ReplicaRouter` over two engines (prefix cache,
   parallel pump), 16 requests on 4 shared 256-token prefixes, replica
   0 killed mid-stream (affinity hits, requeued streams equal to the
   dense picks, each token delivered once, the quorum in healthz), and
   a serial pump on two fresh engines giving the same streams; then
   one `ProcessReplica` child (`python -m singa_tpu_torch.serving.router
   --gpt-medium`) serves 4 requests equal to the in-process engine's and
   exits 0 on stop;
8. the training phases run their steps through `compile(...,
   use_graph=True)`, which on the card captures each training step
   (forward, backward, clipping, the optimizer update) as one CUDA
   Graph: a phase's step 1 runs uncaptured and is counted alone, step 2
   captures the step (the kernel wrappers count the launches they record
   into the graph, once per capture) and replays it, steps 3-6 replay it
   (no wrapper runs, so no launch is counted: the replays are counted
   instead). Each phase holds its 6 captured steps against an uncaptured
   twin (`graph(False)`, the same starting state and batches): the
   losses and every parameter and buffer after the steps within 1e-6 of
   their size in fp32 and 2e-3 in bf16, said whether bitwise equal, and
   prints both step times.
   gpt_medium trains on 4 x 1024 with AdamW: kernel-on against
   kernel-off gradients, 6 steps (12 launches of each flash kernel in
   the counted step and 12 recorded by the capture) whose loss must
   fall, and the same in bf16 (kernels on bf16 operands); then
   `gpt_medium(scan_blocks=False, dropout=0.0)`, the reference's
   default unrolled decoder, on the scanned model's seeded weights
   (`unstack_params`): scoring 4 x 1024 (12 forward launches) and one
   training step's gradients (12 launches of each kernel) equal the
   scanned model's, 6 captured AdamW steps against the twin, cached
   `generate` gives the scanned model's tokens, and
   `generate(use_cache=False)` (4 prompts filling the window of 256, 8
   new; 96 forward launches) equals the cached tokens up to the first
   near-tie;
   then BERT-base at full width (`BertForClassification(2)`, vocab
   30522, 12 layers, d 768, 12 heads, max_len 512) trains at bench.py's
   chip shape, 16 x 512, with seeded weights, `AdamW(lr=1e-4)`,
   `compile(..., precision=...)` and `model(ids, y)`: a dropout-0 twin's
   logits and gradients with the kernels on against off, its 6 captured
   steps against the uncaptured twin in fp32 and in bf16, a batch
   padded with a key mask (0 launches, logits equal to the kernel-off
   model's), the bench's dropout-0.1 model for 6 captured steps whose
   loss must fall, tokens/s and TFLOP/s (bench.py's analytic count) of
   captured steps with the kernels on and off in turns (each switch
   state's first step and capture untimed, then windows of replays
   only), 4 steps at lr 0 whose losses must all differ (dropout draws
   new masks on every replay), and the same in bf16 (kernels on bf16
   operands, a finite loss that falls);
9. ResNet-50 at full width trains on a seeded (128, 3, 224, 224) batch
   through the reference's entry points (`resnet50`, seeded states
   through load_singa_tpu_states, `set_image_layout("NHWC")`, SGD(lr
   0.05, momentum 0.9), `compile(..., precision="fp32")`, `model(x, y)`)
   with the max-pool kernel switched on: kernel-on against kernel-off
   gradients, 6 captured steps (exactly 1 K2a launch in the counted step
   and 1 recorded by the capture) whose loss must fall, moved and
   finite BatchNorm statistics, a finite eval-mode forward, the 6 steps
   against the uncaptured twin in fp32 and bf16 (K2a on bf16 operands)
   with cuDNN's deterministic algorithms (its default backward ones sum
   with atomics in a run-dependent order), then images/s of captured
   steps with cuDNN's default algorithms and the switch on and off in
   turns;
9b. Char-RNN (`CharRNN(64, hidden_size=512, embed_dim=64)`, one LSTM
   layer, bench.py's `--model rnn` row: batch 64 x 256 seeded ids, Adam
   lr 1e-3, fp32, seeded weights through load_singa_tpu_params): the
   LSTM layer's output and its input and weight gradients against
   `torch.nn.LSTM` (cuDNN) on the same weights within 1e-4 of their
   size, and a bidirectional `GRU` and a relu `RNN` against
   `torch.nn.GRU` and `torch.nn.RNN`; 6 captured steps (one
   `graph_compiles`) against the uncaptured twin; tokens/s captured and
   uncaptured in turns, the captured step's device ms (CUDA events)
   beside its bound (the products' FLOPs at the fp32 FMA rate, and the
   bytes) and cuDNN's LSTM forward+backward at the same shape (a
   yardstick off the port's path); 30 captured steps on the built-in
   corpus whose loss must fall; then the trainer
   `python -m singa_tpu_torch.examples.char_rnn --steps 60` at its own
   defaults, whose loss must fall and which must print a sample. No
   kernel of the port runs (the reference's recurrence is a
   `lax.scan`);
9c. the judged eager MLP (`MLP(100, 10)`, seeded weights through
   load_singa_tpu_params, SGD(lr 0.05, momentum 0.9, weight decay
   1e-5), batch 64 on the synthetic MNIST set, `compile(...,
   use_graph=False)`): eager epochs and captured ones (`graph(True)`)
   in turns, steps/s and images/s of each, the captured step's device
   ms (CUDA events over its graph's replays) beside its bound; 6
   captured steps against the eager twin at dropout 0 (1e-6); then
   `python -m singa_tpu_torch.examples.mlp_mnist --epochs 3` at its
   defaults, whose loss must fall and whose last validation accuracy
   must be at least 0.5. No kernel launches;
9d. sonnx at full width: ResNet-50 (seeded states, `set_image_layout(
   "NHWC")`, its BatchNorm statistics set to a seeded (8, 3, 224, 224)
   batch's, eval mode) exported with `sonnx.to_onnx` and imported on
   the card (`sonnx.prepare`, run twice: the first run reads the statics),
   its logits within 1e-3 of max|logit| of the source's eval forward;
   3 SGD(lr 1e-3) steps of the imported model through `compile(...,
   use_graph=True)` (step 1 uncaptured, then one capture and its
   replays): the loss falls, every parameter moves and the BatchNorm
   buffers stay bitwise; then BERT-base at 2 x 512 in eval mode
   (seeded weights), whose export trace must launch the fused flash
   forward kernel exactly 12 times (and the ResNet-50 export none), the
   imported (seq, pooled) within 2e-3 absolute and relative of the
   source's. Prints each export's seconds, bytes and nodes, the
   imported model's first and second run ms, and its forward's device
   ms against the source model's;
9e. DistOpt ResNet-50 (judged configuration 5) over a world-1 NCCL
   group (`distributed.init`), with the max-pool kernel on: every
   `Communicator` method at world 1 (its input back, bf16-rounded on the
   half wire); `python -m singa_tpu_torch.examples.dist_imagenet` at its
   defaults with `--loader sync` (resnet50, batch 32 at 224 x 224, NHWC,
   SGD with warmup and clip 10, buffSize 2**21, the step captured)
   through `run`, 6 steps
   under each --dist-option (plain, half, sparse-topk, sparse-thresh):
   each passes the loss-sanity check, launches K2a once uncaptured and
   once in its capture, then replays 5 times; prints losses and
   images/s/chip. Then a seeded (32, 3, 224, 224) batch: 3 captured
   steps of the plain DistOpt step against the wrapped SGD's from the
   same states (bitwise or within 1e-6 of each tensor's size, and says
   which; then 4 replays of each timed), 6 captured DistOpt steps
   counted (1 K2a launch in the counted step and 1 in the capture)
   against their uncaptured twin (1e-6, deterministic cuDNN), the
   step's ms captured and uncaptured beside the plain SGD's uncaptured;
   and the sync's device work on ResNet-50's 25.6M-element fp32
   gradient set, each captured alone and timed over replays by CUDA
   events, beside its bytes bound at 3.35 TB/s and the step: bucket
   packing and unpacking, the NCCL all-reduce at world 1,
   `fused_all_reduce`, the bf16 cast round trip and `all_reduce_half`,
   top-k at spars 0.05 and `sparse_all_reduce`. All-reduce bandwidth
   needs more than one card and is not measured;
9f. ZeRO-1 (`DistOpt(shard_states=True)`) over a world-1 NCCL group
   trains gpt_medium's unrolled decoder (`gpt_medium(scan_blocks=False)`,
   seeded weights through load_singa_tpu_params, AdamW(lr 3e-4), 4 x
   1024, every step captured): from one state and batch, 3 captured
   steps of ZeRO-1 against plain `DistOpt(AdamW)` and bare AdamW, of
   `overlap=True` (buffSize 2**21) against both, and of `half_wire=True`
   against plain DistOpt's `half` step, at dropout 0 and 0.1, each
   within 1e-6 of each parameter's max|p| and each loss (printed:
   bitwise or not); `gather_half=True`: every parameter equals its fp32
   master shard rounded to bf16, exactly, and the loss falls. ZeRO-1's
   first step launches each flash kernel 12 times uncaptured and 12 in
   its capture. Rank 1's dropout stream (`autograd.rank_draws(1)`, 4
   captured steps at lr 0): 4 different losses, none of rank 0's. 6
   captured ZeRO-1 steps against their uncaptured twin, 1e-6 in fp32
   and 2e-3 in bf16, the loss falling; the captured step's ms of AdamW,
   DistOpt and ZeRO-1 in turns, fp32 and bf16; the slot bytes; the
   sync's parts (gradient flatten and pad, parameter flatten, NCCL's
   `reduce_scatter_tensor` and the mean, the flat and the per-parameter
   AdamW update, NCCL's `all_gather_into_tensor`, the write-back), each
   captured alone and timed over replays by CUDA events beside its bytes
   bound at 3.35 TB/s; then `python -m singa_tpu_torch.examples.gpt_lm
   --shard-states` at its defaults and at gpt_medium's widths (d 1024,
   12 layers, 8 heads, seq 1024, batch 4, 20 steps at lr 3e-4: the flash
   kernels),
   each of whose loss must fall and which must print a sample. At world
   1 no byte crosses cards and no slot memory is saved;
9g. F7 on the card: the MLP (seeded weights, SGD with momentum, batch
   64) takes 3 captured steps, then `fc2.W` is replaced by a new
   `nn.Parameter` and 2 more steps run: the new tensor must move, the
   old one stay bitwise, and `graph_compiles` and the captures rise by
   one. The layers this slice adds (`LeakyReLU`, `Sigmoid`, `SoftMax`,
   `Cat`, `Add`, a stride-2 `SeparableConv2d(padding="same")`) on the
   card against their CPU outputs within 1e-5 of their size. Then
   `mobilenet_v1(1000)` and `xception(1000)` (8 middle blocks) train at
   (128, 3, 224, 224) through ResNet-50's sequence (`cnn_path`:
   kernel-on against kernel-off gradients, 6 captured steps with 0 and
   4 K2a launches in the counted step and 4 and 0 in the capture, loss,
   BatchNorm statistics, an eval forward, the uncaptured twins in fp32
   and bf16, images/s, Xception's with the pool switch on and off in
   turns), print the peak memory, the captured step's device ms (CUDA
   events over replays) beside its bound (3 passes of 2 x MACs at 67
   TFLOP/s fp32 or 989 bf16, or the conv and fc layers' activations read
   and written in each pass at 3.35 TB/s, the larger), and one
   uncaptured step's device time by kernel family (`torch.profiler`
   with shapes: depthwise forward, backward-data and backward-weight,
   dense and 1x1 convs and fc, batch norm and elementwise, layout
   copies, K2a; idle); `python -m singa_tpu_torch.examples.cnn_cifar10
   --model mobilenet|xception --epochs 2 --loader sync` as child
   processes, each of
   which must print "loss sanity: ... ok"; and `mobilenet_v1(1000)`
   NHWC at batch 8 in eval mode (calibrated BatchNorm statistics)
   exported and imported on the card, its logits within 1e-3 of
   max|logit| of the source's (grouped `Conv` in the importer);
9h. the captured eval step: gpt_medium (seeded weights, 4 x 1024, fp32
   then bf16) compiled with use_graph=True and scored in eval mode: the
   eval step's first call runs uncaptured and launches the flash forward
   12 times (and makes the step's native memory plan, 0 < peak <=
   naive), the second captures (12 launches recorded, one more
   `graph_compiles`), the third replays; the captured and replayed
   logits must equal the uncaptured `forward`'s bitwise; print the
   replay's device ms (CUDA events over the graph's replays), the
   uncaptured forward's host ms and the idle share of each
   (`torch.profiler`). ResNet-50 and MobileNetV1 at (128, 3, 224, 224)
   NHWC fp32 the same way (no kernel), with images/s of eval-step calls
   and of the uncaptured forward in turns, and the training step's
   memory plan; `cnn_cifar10 --model resnet --epochs 1 --loader sync` in
   this process,
   whose validation loop must replay the eval step; gpt_medium's
   training step's plan, and `step_memory_analysis` under remat "none"
   and "per_block" (per_block's `temp_bytes` below none's); a user
   `autograd.Function` with its own backward and one with the default
   VJP in an MLP trained 6 captured steps, equal to the same steps on
   the CPU within 1e-5 and bitwise to the uncaptured twin; and the 40
   functional ops, forward and gradient, against the CPU within 1e-5;
9i. the Device classes on the card (`create_cuda_gpu().device_info()`
   names it, `memory_stats()`'s bytes in use above 0, `TpuDevice`,
   `OpenclGPU` and `RunConfig(device="tpu")` are `cuda:0`, `op_count`
   grows on an uncaptured step and on the capture, not on 3 replays, of
   the MLP at batch 64); then sequence parallelism over a world-1 NCCL
   group and the mesh (data 1, sp 1), each model's steps captured and
   counted (`captured_steps`) and its losses held to the same model
   without `seq_axis` from the same seeded weights, `DistOpt(SGD)`:
   gpt_medium's widths unrolled at 1 x 8192 with `seq_axis`,
   `remat=True` and `ring_flash=True` (one causal flash block a layer:
   12 launches of the head-split forward with its lse, of dQ and of
   dK/dV a step), then `seq_impl="ulysses"` (24 forward launches: the
   remat recomputes them), each loss within 1e-5 of its twin's (said
   whether bitwise), 5 steps; BERT-base at 16 x 512 with `seq_axis` and
   `ring_flash` (the bidirectional block, 12 of each), 5 steps within
   1e-5; the scanned gpt_medium at 4 x 2048 with `seq_axis` and
   `overlap=True` (the pipelined plain ring, no kernel), 3 steps within
   1e-3 of its fused-kernel twin; step ms, tokens/s and peak memory of
   each. The head-split kernels are held to their plain versions at
   these shapes in phases 3-4 (`sp_*` cases). At world 1 no NCCL
   point-to-point op or all-to-all is issued;
9j. tensor parallelism over a world-1 NCCL group on `get_mesh_3d(1, 1,
   1)` (`tp_path`): the scanned and unrolled gpt_medium and BERT-base
   with `tp_axis`, captured, against their twins without it, with the
   flash launches by layout; then `serve_gpt --tp 1` against the serve
   without `--tp`, in turns;
9k. ZeRO-3 and the MoE FFN over a world-1 NCCL group (`zero3_path`),
   every step captured: the scanned gpt_medium at 4 x 1024 fp32 with
   `zero3_axis="data"`, serial (12 launches of each fused kernel a step)
   and with `overlap=True` (24 forward launches: its backward recomputes
   each block), each within 1e-6 of the twin without zero3_axis, with
   peak memory and `gathered_block_bytes` (two blocks overlapped, one
   serial); with `tp_axis="model"` beside it (12 of each head-split
   kernel); bench.py's 3-D recipe (tp x zero3 x seq, bf16, AdamW(1e-4),
   8 x 1024) with overlap and serial back to back, tokens/s each (no
   flash kernel: at world 1 the seq axis takes the plain ring); the
   unrolled gpt_medium with 8 experts a block and `moe_axis="expert"` on
   (data 1, expert 1) within 1e-6 of its dense-formulation twin (12 of
   each fused kernel); one MoEFFN forward and backward at the step's
   shapes, through `moe_ffn` and `moe_ffn_dense`, at capacity factors
   1.25 and 0.5, against `plain_moe` (written apart from parallel/
   moe.py) within 1e-4 of each tensor's largest entry; then the device
   ms of the MoE step's families (gate, dispatch and combine, expert
   products, attention) at its shapes;
9l. GPipe over a world-1 NCCL group (`pp_path`): gpt_medium's widths
   with `pp_axis="pipe"` and `pp_micro=4` (a `PipelineTransformerStack`
   decoder, dropout 0) at 4 x 1024 fp32 with DistOpt(SGD) on (data 1,
   pipe 1), every step captured, within 1e-6 of its twin on a (data 1)
   mesh (the stack's loop over the whole batch); 48 launches of each
   head-split kernel a step (12 blocks x 4 microbatches), the twin 12;
   device ms and peak memory of both; then every entry of
   `examples.parallel_strategies` a world of one admits, uncaptured,
   each line with its wall time. The head-split kernels are held to
   their plain versions at the microbatch's shape in phases 3-4
   (`pp_gpt_medium_microbatch_t1024`);
9m. the rest of the serving stack over a world-1 NCCL group
   (`disagg_path`), gpt_medium at window 1024 with 8 slots: the engine
   with `prefill_mesh` on a (data 1) mesh, with a single-device decode
   and with a (model 1) tp decode, in turns with the plain engine on the
   serve mix (equal streams, no point-to-point call, one capture, prefill
   ms a batch of 2 and the decode step's device ms); the sharded
   speculative round (`mesh=(model 1)`, spec_k 4) with the self and the
   tiny draft in turns with the single-device one on the spec mix (equal
   streams, one capture each of propose and verify, self acceptance at
   least 0.9, propose and verify ms); `serve_gpt --gpt-medium --tp 1
   --draft tiny` against `--draft tiny`; `serve_gpt --gpt-medium
   --metrics-port 0` scraped during the serve (the serving gauges and
   `serve_token_ms` on `/metrics`, `/healthz` 200). No flash or K2a
   launch in any part;
9n. the checkpoint (`ckpt_path`): `gpt_lm` as a child at gpt_medium's
   widths (scanned, 4 x 1024, fp32) 6 steps unbroken (A), 4 steps with
   `--checkpoint build/chip_smoke_ckpt/... --save-every 2` (B) and B's
   command with `--steps 6` (C), which says it resumed at step 4 and
   whose losses are bitwise A's steps 4-5 (12 launches of each fused
   kernel a step), and the same with `--shard-states` (the four A and B
   children at once, then the two C); the
   API in one process on the captured fp32 gpt_medium step with AdamW:
   a sync save at step 3 and an async save of the same step followed at
   once by 3 replays, their shard files and crcs identical; a fresh
   model whose step is captured takes the restore in place and its
   next 3 replays are bitwise the unbroken run's, no new capture;
   the state bytes, the save, snapshot and restore seconds; a flipped
   byte refused (`CorruptCheckpointError`); phase 9k's world-1 tp x
   zero3 stack saved and restored into the unplaced stack, parameters
   equal and the next loss bitwise; the bf16 captured step with a
   `GradSentinel` and `nonfinite_grad_at(2)`: step 2 leaves the state
   bitwise and halves the scale, one capture. The directories are
   deleted at the end;
9o. the self-healing layer (`heal_path`): phase 9n's gpt_medium
   (scanned, 4 x 1024, fp32, AdamW, captured) through `Supervisor.run`
   at checkpoint_every 2 and keep_checkpoints 2: 6 steps unbroken give
   U, bitwise a plain loop's 6 (ms a step supervised, with its
   `float(loss)` read, and plain); `stall_at(3)` under a watchdog
   deadline of max(15 s, 3x the first steps), alone on the card: one
   hang and one restart, the `StepHangError` naming step 3, losses
   bitwise U, the seconds from the expiry to the next step;
   `crash_at(3)`: one restart, losses bitwise U, one capture after the
   rebuild, 12 launches of each fused kernel an uncaptured or capturing
   step, the memory allocated after the rebuild within 2% of the first
   build's; the ImageNet AlexNet (batch 128, SGD, NHWC: no batch norm,
   so a scaled image spikes the loss) with `poison_batch_at(3, 1e4)`
   (or the largest power of ten below with a finite loss) and
   `SpikeDetector(8, 6, 2)`: one rollback, skipped [[2, 3]], finite
   losses, K2a 3 times a step (its three pool shapes are K2a cases of
   step 5); and, beside the last two, `python -m
   singa_tpu_torch.resilience.babysit --stale-after 30 --max-restarts 2
   -- python -c <child>` over the gpt_medium child at 6 of its 12 blocks
   (`babysat_child`: a Watchdog and a save each step, SIGSTOP at step 1
   on its first incarnation) with the same child run unbroken without
   it; the longest stretch between two beats of each, outside the
   SIGSTOP's, under the stale window: healed
   with one restart and one stale kill, the final checkpoints
   sha256-identical file by file, the killed incarnation gone (its
   /proc entry, and nvidia-smi's compute pids where they are of this
   namespace), the babysitter never with a /dev/nvidia* file open (read
   every 2 s of its life), the seconds from the kill to the respawn's
   first step. The directories are deleted at the end;
9p. the babysitter fleet (`fleet_path`), started beside 9o's
   babysitter: `python -m singa_tpu_torch.resilience.babysit --fleet DIR
   --fleet-rank 0 --fleet-world 1 --stale-after 30 -- python -c <child>`
   over `fleet_child` (9o's child, gpt_medium at 6 of its 12 blocks,
   under `DistOpt(AdamW)` over a
   world-1 NCCL group formed at the agent's brokered coordinator,
   `Supervisor(mesh_fn=default_mesh_fn(1))`, a save each step,
   `stale_host_at(1, rank=0)` on epoch 0), with the same child run
   unbroken with the same topology env and no agent: healed at epoch 1
   with one election and one stale trainer, DONE written, each epoch's
   coordinator the one the agent brokered, 6 launches of each fused
   kernel (one a block) in every uncaptured or capturing step of each
   incarnation, the longest stretch between beats under the window,
   the final checkpoints sha256-identical file by file, the killed
   incarnation gone from /proc, the agent never with a /dev/nvidia*
   file open; the seconds from the SIGSTOP to the epoch bump and from
   the bump to the respawn's first step. The native bucket planner
   (`native/comm_core.cc`) is checked on the DistOpt (9e) and ZeRO-1
   (9f) paths: called there, its buckets over the model's parameter
   sizes equal the plain planner's, one plan timed native and in
   Python. The directories are deleted at the end;
9q. item 20's utils and item 13's mesh (`utils_path`): over a world-1
   NCCL group, `dist_imagenet.run` at its defaults (ResNet-50, 32 images
   a chip at 224 x 224, the captured step, K2a on) for 6 steps under
   cuDNN's deterministic algorithms with `--loader sync`, `--loader
   prefetch` (zero-copy views into the native prefetcher's ring) and
   `--loader prefetch` fed the loader's owned copies: each passes the
   loss-sanity check and launches K2a once uncaptured and once in its
   capture, the views' losses equal the copies' bitwise, the prefetch
   run makes one C++ loader (`native_call_count`) more than the sync
   run; the host ms each step waits on the loader and images/s of each;
   `global_mesh(dcn_mesh_shape=(1,))` equals `global_mesh()`. Then
   gpt_medium (seeded weights, 4 x 1024, fp32, AdamW, use_graph=True):
   its uncaptured first step under `profiler.xla_trace` launches 12 of
   each fused flash kernel and its trace file holds 12 kernel events of
   each under its symbol; the five device-kernel families with the most
   time; one captured replay traced (its kernel events printed); one
   replay timed by `StepTimer(sync=)` and by CUDA events. The trace
   directory is deleted at the end;
9r. item 21's shardlint (`lint_path`): gpt_medium with
   `zero3_axis="data"` (seeded weights, 4 x 1024, fp32, SGD with
   momentum, use_graph=True) over a world-1 NCCL group.
   `analysis.trace_step` records one uncaptured step (12 launches of
   each fused flash kernel), then captures and replays it (12 recorded
   in the capture), and puts every state back; R1, R2, R4 and R5 lint
   it clean: R2 finds `all_gather@data` = 12 (len(STACKED)) in each of
   the 12 blocks, R5 every state tensor at its address across the
   capture and the replay. Two captured steps after the lint give the
   losses of an unlinted twin's two steps bitwise. The twin then takes
   a planted step that re-binds `decoder.w_o.data` after the update:
   its lint fails R5, against a real CUDA Graph;
9s. item 22's native training step (`native_path`): phase 9c's judged
   MLP (`MLP(100, 10)`, seeded weights, dropout inactive, batch 64 of the
   synthetic MNIST set) lowered by `hlo_bridge.lower_train_step` into one
   StableHLO module of its plain-SGD step (lr 0.05), written by the
   unedited `native/hlo_core.cc` (6 `dot_general`; census {} against the
   declared {"all_reduce": 0}, R7 clean); the runtime runs it 200 steps on
   the card (the first op by op, the second captured as one CUDA Graph,
   198 replays), its losses and final parameters within rtol 2e-4, atol
   2e-5 of the port's eager plain-SGD loop on the same weights and
   batches; the first step's ms, the replays' steps/s and device ms
   beside phase 9c's eager and captured figures, and the step's bound;
   then over a world-1 NCCL group `run_replicated` (the bitwise replica
   check) gives the run's first four losses, and a module of 2 replicas
   is refused, naming 2 and 1. At most 30 s;
10. print the `kernels` line (gpt_medium's fused fp32 shape, with the
   bf16 figures, the BERT-base shape's figures and launches per step,
   and the SASS census beside; a training step's launches are the ones
   its capture recorded, which every replay runs again; the ZeRO-1
   step's beside the others; K2a's at Xception's four pool shapes and
   its 4 launches a step; the sequence-, tensor-parallel, ZeRO-3, MoE
   and pipelined steps' launches and the head-split figures at their
   shapes; phase 9q's traced step's and prefetched step's launches;
   phase 9r's linted step's, uncaptured and in the capture apart),
   then the result line.

fp32 products run in full fp32: TF32 is off for matmuls and cuDNN.
"""

import gc
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_S = 3.35e12  # H100 SXM data sheet, HBM3
# H100 SXM data sheet, dense: fp32 outside the tensor cores; fp32 as three
# TF32 passes on the tensor cores (495 / 3); bf16
PEAK_FLOPS = {"fp32": 67e12, "tf32x3": 495e12 / 3, "bf16": 989e12}
#: SASS opcodes counted per kernel: tensor-core products, asynchronous or
#: 16-byte global loads, and ldmatrix
SASS_OPS = ("HMMA", "HGMMA", "LDGSTS", "UTMALDG", "LDG.E.128", "LDSM")
SEED = 0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
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


def attention_bound(b, h, tq, tk, d, causal, elem_bytes, kind):
    """Least time (ms) for one attention forward: the larger of bytes
    (q, k, v read once, O and lse written once) over the memory rate and
    the two products' operations on the (q, k) pairs this mask keeps
    over the peak rate of `kind` (a key of PEAK_FLOPS)."""
    flops = 4.0 * b * h * kept_pairs(tq, tk, causal) * d
    nbytes = elem_bytes * b * h * d * (2 * tq + 2 * tk) + 4 * b * h * tq
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


CASES = [
    # name, layout, B, H, Tq, Tk, hd, causal, dtype, mxu_bf16, tolerance
    ("gpt_medium_fused_fp32", "fused", 4, 8, 1024, 1024, 128, True,
     "float32", False, 1e-4),
    ("gpt_medium_fused_fp32_mxu_bf16", "fused", 4, 8, 1024, 1024, 128,
     True, "float32", True, 2e-2),
    ("gpt_medium_fused_bf16", "fused", 4, 8, 1024, 1024, 128, True,
     "bfloat16", False, 2e-2),
    ("split_causal_tq384_tk1000", "split", 2, 8, 384, 1000, 128, True,
     "float32", False, 1e-4),
    ("split_noncausal_tq384_tk1000", "split", 2, 8, 384, 1000, 128, False,
     "float32", False, 1e-4),
    ("fused_hd64_t1000", "fused", 4, 16, 1000, 1000, 64, True, "float32",
     False, 1e-4),
    ("split_hd32_t500", "split", 4, 32, 500, 500, 32, True, "float32",
     False, 1e-4),
    # Tq > Tk causal: the first Tq - Tk rows see no key and must be 0
    ("split_empty_rows_tq200_tk70", "split", 2, 4, 200, 70, 64, True,
     "float32", False, 1e-4),
    # BERT-base at bench.py's chip shape: non-causal, 12 heads of hd 64
    ("bert_base_fused_fp32", "fused", 16, 12, 512, 512, 64, False,
     "float32", False, 1e-4),
    ("bert_base_fused_bf16", "fused", 16, 12, 512, 512, 64, False,
     "bfloat16", False, 2e-2),
    # the sequence-parallel path (phase 9i): head-split q, k, v (views of
    # the fused projection) into a (B, H, T, D) output, with lse
    ("sp_gpt_medium_causal_t8192", "sp", 1, 8, 8192, 8192, 128, True,
     "float32", False, 1e-4),
    ("sp_bert_base_bidir_t512", "sp", 16, 12, 512, 512, 64, False,
     "float32", False, 1e-4),
    # the tensor-parallel paths (phase 9j) at gpt_medium's step shape: the
    # scanned stack's views of the head-interleaved projection (head
    # stride 3 * hd), and the unrolled MHA's per-projection tensors
    ("tp_gpt_medium_interleaved_t1024", "tp_interleaved", 4, 8, 1024, 1024,
     128, True, "float32", False, 1e-4),
    ("tp_gpt_medium_projections_t1024", "tp_projections", 4, 8, 1024, 1024,
     128, True, "float32", False, 1e-4),
    # the pipelined GPT (phase 9l): one microbatch of gpt_medium's 4 x
    # 1024 step, head-split views of its [q | k | v] projection
    ("pp_gpt_medium_microbatch_t1024", "sp", 1, 8, 1024, 1024, 128, True,
     "float32", False, 1e-4),
]
# Tolerances: fp32 kernel and plain version differ only in summation
# order (1e-4 on values of order 1); where operands or O are bf16, one
# bf16 rounding step of O (2^-9 relative) and p rounded at another
# running max than the plain version's whole-row max (2e-2).


def head_split_operands(torch, fa, layout, randn, b, h, t, d):
    """Head-split (B, H, T, hd) q, k, v with the strides a path hands the
    kernels: "sp" views of the [q | k | v] projection, "tp_interleaved"
    views of the scanned tp stack's head-interleaved one
    (`tp.split_interleaved_qkv`), "tp_projections" the unrolled tp MHA's
    three (B, T, H*hd) projections seen per head."""
    from singa_tpu_torch.parallel import tp as tp_module

    if layout == "sp":
        return fa._split_qkv(randn(b, t, 3 * h * d), h)
    if layout == "tp_interleaved":
        return tp_module.split_interleaved_qkv(randn(b, t, 3 * h * d), d)
    return tuple(fa._heads(randn(b, t, h * d), h) for _ in range(3))


def run_case(torch, fa, case):
    import torch.nn.functional as F

    name, layout, b, h, tq, tk, d, causal, dt, mxu, tol = case
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    if layout == "fused":
        qkv = randn(b, tq, 3 * h * d)
        q, k, v = fa._split_qkv(qkv, h)
        out = torch.empty((b, tq, h * d), dtype=dtype, device="cuda")
        o = fa._heads(out, h)
    elif layout in ("sp", "tp_interleaved", "tp_projections"):
        q, k, v = head_split_operands(torch, fa, layout, randn, b, h, tq, d)
        o = torch.empty((b, h, tq, d), dtype=dtype, device="cuda")
    else:
        q, k, v = randn(b, h, tq, d), randn(b, h, tk, d), randn(b, h, tk, d)
        o = torch.empty_like(q)
    scale = d ** -0.5
    lse = fa._flash_fwd(q, k, v, o, causal, scale, mxu)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, causal, scale, mxu)
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    empty = max(0, tq - tk) if causal else 0
    zero_rows = bool((o[:, :, :empty] == 0).all())
    ms = cuda_ms(torch, lambda: fa._flash_fwd(q, k, v, o, causal, scale,
                                              mxu))
    plain_ms = cuda_ms(torch, lambda: fa._flash_fwd_plain(
        q, k, v, causal, scale, mxu), iters=5)
    library_ms = library_err = None
    if not causal or tq <= tk:  # with Tq > Tk a row is empty: SDPA's NaN
        # SDPA's is_causal is top-left: give it the bottom-right mask
        mask = bottom_right(torch, tq, tk) if causal and tq != tk else None

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale,
                is_causal=causal and mask is None)

        library_err = (sdpa().float() - o_ref.float()).abs().max().item()
        library_ms = cuda_ms(torch, sdpa)
    bf16 = mxu or dtype == torch.bfloat16
    # fp32 products run as three TF32 passes; the FMA figure stays beside
    bound_ms, bound_by = attention_bound(b, h, tq, tk, d, causal,
                                         q.element_size(),
                                         "bf16" if bf16 else "tf32x3")
    bound_fma_ms = attention_bound(b, h, tq, tk, d, causal,
                                   q.element_size(),
                                   "bf16" if bf16 else "fp32")[0]
    row = dict(case=name, layout=layout, shape=[b, h, tq, tk, d],
               causal=causal, dtype=dt, mxu_bf16=mxu, max_abs_err=err_o,
               lse_max_abs_err=err_lse, tolerance=tol, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library_max_abs_err=library_err, bound_ms=bound_ms,
               bound_fma_ms=bound_fma_ms,
               bound_by=bound_by, empty_rows=empty, empty_rows_zero=zero_rows,
               ok=err_o <= tol and err_lse <= tol and zero_rows)
    print("case " + json.dumps(row), flush=True)
    return row


def backward_bounds(b, h, tq, tk, d, causal, elem_bytes, kind):
    """Least times (ms, bound_by) for the attention backward, from this
    mask's kept (q, k) pairs: each kernel's own products and bytes (dQ:
    S, dP, dQ; dK/dV: S, dP, dV, dK; each reads q, k, v, dO, lse and
    delta once and writes its gradients once) and the whole backward
    (the five products; q, k, v, O, dO, lse, delta read, dq, dk, dv
    written). `kind` is a key of PEAK_FLOPS."""
    pairs = kept_pairs(tq, tk, causal)
    rows = 4 * b * h * tq * 2  # lse and delta, fp32
    q_b, kv_b = elem_bytes * b * h * tq * d, elem_bytes * b * h * tk * d
    reads = 2 * q_b + 2 * kv_b + rows  # q, dO, k, v, lse, delta
    out = {}
    for name, n_products, nbytes in (
            ("dq", 3, reads + q_b), ("dkv", 4, reads + 2 * kv_b),
            ("total", 5, reads + q_b + q_b + 2 * kv_b)):  # + O; dq dk dv
        flops = 2.0 * n_products * b * h * pairs * d
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[kind]
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes > t_ops else "operations")
    return out


def kept_pairs(tq, tk, causal):
    """(q, k) pairs the mask keeps: all, or k <= q + (Tk - Tq)."""
    if not causal:
        return tq * tk
    i = np.arange(tq)
    return int(np.clip(i + (tk - tq) + 1, 0, tk).sum())


def bottom_right(torch, tq, tk):
    """The bottom-right causal mask as SDPA's boolean attn_mask."""
    return torch.ones(tq, tk, dtype=torch.bool, device="cuda").tril(tk - tq)


BWD_CASES = [
    # name, layout, B, H, Tq, Tk, hd, causal, dtype, mxu_bf16,
    # lse cotangent, tolerance
    ("gpt_medium_fused_fp32", "fused", 4, 8, 1024, 1024, 128, True,
     "float32", False, False, 1e-4),
    ("gpt_medium_fused_fp32_mxu_bf16", "fused", 4, 8, 1024, 1024, 128,
     True, "float32", True, False, 2e-2),
    ("gpt_medium_fused_bf16", "fused", 4, 8, 1024, 1024, 128, True,
     "bfloat16", False, False, 2e-2),
    ("split_causal_tq384_tk1000", "split", 2, 8, 384, 1000, 128, True,
     "float32", False, False, 1e-4),
    ("split_noncausal_tq384_tk1000", "split", 2, 8, 384, 1000, 128, False,
     "float32", False, False, 1e-4),
    ("fused_hd64_t1000", "fused", 4, 16, 1000, 1000, 64, True, "float32",
     False, False, 1e-4),
    ("split_hd32_t500", "split", 4, 32, 500, 500, 32, True, "float32",
     False, False, 1e-4),
    # Tq > Tk causal: the first Tq - Tk rows see no key; their dq is 0
    ("split_empty_rows_tq200_tk70", "split", 2, 4, 200, 70, 64, True,
     "float32", False, False, 1e-4),
    ("split_lse_cotangent_tq384_tk1000", "split", 2, 8, 384, 1000, 128,
     True, "float32", False, True, 1e-4),
    ("bert_base_fused_fp32", "fused", 16, 12, 512, 512, 64, False,
     "float32", False, False, 1e-4),
    ("bert_base_fused_bf16", "fused", 16, 12, 512, 512, 64, False,
     "bfloat16", False, False, 2e-2),
    ("sp_gpt_medium_causal_t8192", "sp", 1, 8, 8192, 8192, 128, True,
     "float32", False, False, 1e-4),
    ("sp_bert_base_bidir_t512", "sp", 16, 12, 512, 512, 64, False,
     "float32", False, False, 1e-4),
    ("tp_gpt_medium_interleaved_t1024", "tp_interleaved", 4, 8, 1024, 1024,
     128, True, "float32", False, False, 1e-4),
    ("tp_gpt_medium_projections_t1024", "tp_projections", 4, 8, 1024, 1024,
     128, True, "float32", False, False, 1e-4),
    ("pp_gpt_medium_microbatch_t1024", "sp", 1, 8, 1024, 1024, 128, True,
     "float32", False, False, 1e-4),
]
# Tolerances are on max|d| / max(1, max|plain|) per gradient. fp32: the
# kernel and the plain version differ only in summation order (1e-4).
# bf16 inputs: each gradient is written in bf16 (2^-9 relative); with
# mxu_bf16, p and dS round to bf16 at scores that differ in the last bit
# from the plain version's (2e-2).


def run_bwd_case(torch, fa, case):
    """Hold the dQ and dK/dV kernels against `_flash_bwd_plain` on one
    case; time both kernels, the plain version, SDPA's backward (where
    its masking is the same) and give the bounds."""
    import torch.nn.functional as F

    (name, layout, b, h, tq, tk, d, causal, dt, mxu, with_glse,
     tol) = case
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def grads_like():
        """Fresh (dq, dk, dv): views into one (B, T, 3d) gradient of qkv
        in the fused layout."""
        if layout == "fused":
            return fa._split_qkv(torch.empty(
                (b, tq, 3 * h * d), dtype=dtype, device="cuda"), h)
        dq = torch.empty((b, h, tq, d), dtype=dtype, device="cuda")
        dk = torch.empty((b, h, tk, d), dtype=dtype, device="cuda")
        return dq, dk, torch.empty_like(dk)

    if layout == "fused":
        q, k, v = fa._split_qkv(randn(b, tq, 3 * h * d), h)
        out = torch.empty((b, tq, h * d), dtype=dtype, device="cuda")
        o = fa._heads(out, h)
        do = fa._heads(randn(b, tq, h * d), h)
    elif layout == "sp":
        q, k, v = fa._split_qkv(randn(b, tq, 3 * h * d), h)
        o = torch.empty((b, h, tq, d), dtype=dtype, device="cuda")
        do = randn(b, h, tq, d)
    elif layout in ("tp_interleaved", "tp_projections"):
        q, k, v = head_split_operands(torch, fa, layout, randn, b, h, tq, d)
        o = torch.empty((b, h, tq, d), dtype=dtype, device="cuda")
        # the context's gradient as autograd hands it back through
        # o.transpose(1, 2).reshape(B, T, d): a (B, T, H, hd) layout
        do = fa._heads(randn(b, tq, h * d), h)
    else:
        q, k, v = randn(b, h, tq, d), randn(b, h, tk, d), randn(b, h, tk, d)
        o = torch.empty_like(q)
        do = randn(b, h, tq, d)
    scale = d ** -0.5
    lse = fa._flash_fwd(q, k, v, o, causal, scale, mxu)
    delta = (do.float() * o.float()).sum(-1)
    if with_glse:
        delta = delta - torch.randn(b, h, tq, generator=gen, device="cuda")

    def kernel():
        grads = grads_like()
        fa._flash_bwd(q, k, v, do, lse, delta, *grads, causal, scale, mxu)
        return grads

    before = (fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES)
    got = kernel()
    torch.cuda.synchronize()
    check((fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES)
          == (before[0] + 1, before[1] + 1),
          f"{name}: _flash_bwd did not launch both kernels once")
    again = kernel()
    torch.cuda.synchronize()
    bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
    want = fa._flash_bwd_plain(q, k, v, do, lse, delta, causal, scale, mxu)
    errs, rel = {}, {}
    for gname, x, y in zip(("dq", "dk", "dv"), got, want):
        diff = (x.float() - y.float()).abs().max().item()
        errs[gname] = diff
        rel[gname] = diff / max(1.0, y.float().abs().max().item())
    empty = max(0, tq - tk) if causal else 0
    zero_rows = bool((got[0][:, :, :empty] == 0).all())

    dq_out, dk_out, dv_out = grads_like()
    ms_dq = cuda_ms(torch, lambda: fa._flash_bwd_dq(
        q, k, v, do, lse, delta, dq_out, causal, scale, mxu))
    ms_dkv = cuda_ms(torch, lambda: fa._flash_bwd_dkv(
        q, k, v, do, lse, delta, dk_out, dv_out, causal, scale, mxu))
    ms = cuda_ms(torch, kernel)
    plain_ms = cuda_ms(torch, lambda: fa._flash_bwd_plain(
        q, k, v, do, lse, delta, causal, scale, mxu), iters=5)

    library_ms = None
    if not with_glse and (not causal or tq <= tk):
        # SDPA's is_causal is top-left: give it the bottom-right mask
        mask = bottom_right(torch, tq, tk) if causal and tq != tk else None
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        ref_o = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale,
            is_causal=causal and mask is None)
        library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            ref_o, (qs, ks, vs), do, retain_graph=True))
        del ref_o
    bf16 = mxu or dtype == torch.bfloat16
    fma = backward_bounds(b, h, tq, tk, d, causal, q.element_size(),
                          "bf16" if bf16 else "fp32")
    tc = backward_bounds(b, h, tq, tk, d, causal, q.element_size(),
                         "bf16" if bf16 else "tf32x3")
    # both kernels run on the tensor cores (three TF32 passes in fp32):
    # their bounds at that rate, the FMA figures beside
    bounds = tc
    row = dict(case=name, layout=layout, shape=[b, h, tq, tk, d],
               causal=causal, dtype=dt, mxu_bf16=mxu, lse_cotangent=with_glse,
               max_abs_err=errs, rel_err=rel, tolerance=tol, ms=ms,
               ms_dq=ms_dq, ms_dkv=ms_dkv, plain_ms=plain_ms,
               library_ms=library_ms,
               bound_ms={k: v[0] for k, v in bounds.items()},
               bound_by={k: v[1] for k, v in bounds.items()},
               bound_fma_ms={k: v[0] for k, v in fma.items()},
               empty_rows=empty, empty_rows_zero=zero_rows,
               bitwise_repeat=bitwise,
               ok=max(rel.values()) <= tol and zero_rows and bitwise)
    print("bwd_case " + json.dumps(row), flush=True)
    return row


#: phase 9g: the batch of the full-width MobileNetV1 and Xception steps
#: (ResNet-50's)
MOBILE_BATCH = 128
XCEPTION_BATCH = 128
#: Xception's four max-pools (k3 s2 p1, NHWC) at 224 px: the three entry
#: blocks' and the exit block's inputs
XCEPTION_POOLS = [(112, 128), (56, 256), (28, 728), (14, 1024)]

POOL_CASES = [
    # name, x (N, H, W, C), window, strides, pads, dtype, options
    # ("levels": x rounded to multiples of 1/levels, plateaus of ties;
    # "channels_first": x in NCHW memory, the kernel's scalar route); the
    # first eight are the reference's (tests/test_max_pool_kernel.py)
    ("ref_stem_like", (2, 16, 16, 8), (3, 3), (2, 2), (1, 1), "float32",
     {}),
    ("ref_odd_hw", (2, 15, 17, 8), (3, 3), (2, 2), (1, 1), "float32", {}),
    ("ref_k2s2_bf16", (2, 16, 16, 8), (2, 2), (2, 2), (0, 0), "bfloat16",
     {}),
    ("ref_asymmetric", (1, 9, 11, 4), (3, 2), (1, 2), (1, 0), "float32",
     {}),
    ("ref_stride1", (2, 12, 12, 8), (3, 3), (1, 1), (1, 1), "float32",
     {}),
    ("ref_c16", (2, 16, 16, 16), (3, 3), (2, 2), (1, 1), "float32", {}),
    ("ref_odd_h_bf16", (1, 14, 16, 8), (3, 3), (2, 2), (1, 1), "bfloat16",
     {}),
    ("ref_c64_bf16", (2, 16, 16, 64), (3, 3), (2, 2), (1, 1), "bfloat16",
     {}),
    # the main path's shape first: ResNet-50's stem max-pool at batch 128
    ("resnet50_stem_fp32", (128, 112, 112, 64), (3, 3), (2, 2), (1, 1),
     "float32", {}),
    ("resnet50_stem_bf16", (128, 112, 112, 64), (3, 3), (2, 2), (1, 1),
     "bfloat16", {}),
    # the DistOpt path's: the stem at dist_imagenet's 32 images a chip
    ("resnet50_stem_fp32_b32", (32, 112, 112, 64), (3, 3), (2, 2),
     (1, 1), "float32", {}),
    ("vgg16_cifar_first_pool", (128, 32, 32, 64), (2, 2), (2, 2), (0, 0),
     "float32", {}),
    ("alexnet_cifar_first_pool", (128, 16, 16, 64), (2, 2), (2, 2), (0, 0),
     "float32", {}),
    ("alexnet_first_pool", (128, 55, 55, 64), (3, 3), (2, 2), (0, 0),
     "float32", {}),
    # phase 9o's: the ImageNet AlexNet's other two pools at batch 128
    ("alexnet_pool2", (128, 27, 27, 192), (3, 3), (2, 2), (0, 0),
     "float32", {}),
    ("alexnet_pool3", (128, 13, 13, 256), (3, 3), (2, 2), (0, 0),
     "float32", {}),
    # first-match ties at size: x in {0, 0.5, 1, ...}, overlapping windows
    ("plateau_k3s1p1", (128, 56, 56, 64), (3, 3), (1, 1), (1, 1),
     "float32", {"levels": 2}),
    # the kernel's other routes: one channel per item, windows in chunks
    ("channels_first_scalar_route", (16, 28, 28, 64), (3, 3), (2, 2),
     (1, 1), "float32", {"channels_first": True}),
    ("k7_s1_chunked", (16, 28, 28, 64), (7, 7), (1, 1), (3, 3),
     "float32", {}),
    ("channels_first_scalar_route_bf16", (16, 28, 28, 64), (3, 3), (2, 2),
     (1, 1), "bfloat16", {"channels_first": True}),
] + [
    # phase 9g's: Xception's four pools at its batch, fp32 and bf16
    (f"xception_pool{i}_{short}", (XCEPTION_BATCH, hw, hw, c), (3, 3),
     (2, 2), (1, 1), dt, {})
    for dt, short in (("float32", "fp32"), ("bfloat16", "bf16"))
    for i, (hw, c) in enumerate(XCEPTION_POOLS)]
POOL_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
# Tolerances are on max|d| / max(1, max|plain|): both sum at most
# ceil(k/s)^2 values of dy in fp32, in another order (fp32: 1e-6); in bf16
# dx is rounded once to bf16 from sums that may differ in the last fp32
# bit (1e-2, as the reference's own test holds its kernel).


def run_pool_case(torch, mp, case):
    """Hold the max-pool backward kernel against `_max_pool_bwd_plain`
    and PyTorch's default route (its max-pool backward) on one case; time
    the kernel, the plain version and that library backward."""
    name, shape, win, strd, pad, dt, opts = case
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.randn(shape, generator=gen, device="cuda").clamp_min(0)
    if "levels" in opts:
        x = (x * opts["levels"]).round() / opts["levels"]
    x = x.to(dtype)
    if opts.get("channels_first"):
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    y = mp._fwd(x, win, strd, pad)
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
    # the kernel's route for these operands (dx as the wrapper makes it)
    vector_width = mp._vector_width(x, y, dy, torch.empty(
        shape, dtype=dtype, device="cuda"))

    before = mp.MAX_POOL_BWD_LAUNCHES
    got = mp._max_pool_bwd(x, y, dy, win, strd, pad)
    torch.cuda.synchronize()
    check(mp.MAX_POOL_BWD_LAUNCHES == before + 1,
          f"{name}: _max_pool_bwd did not launch the kernel once")
    bitwise = torch.equal(got, mp._max_pool_bwd(x, y, dy, win, strd, pad))
    want = mp._max_pool_bwd_plain(x, y, dy, win, strd, pad)
    same = torch.equal(got != 0, want != 0)
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(1.0, want.float().abs().max().item())

    # the default route: PyTorch's max-pool and its autograd backward
    xg = x.detach().requires_grad_()
    mp.set_pool_kernel_enabled(False)
    (default,) = torch.autograd.grad(mp.maxpool2d_nhwc(xg, win, strd, pad),
                                     xg, dy)
    default_same = torch.equal(default != 0, want != 0)
    default_rel = ((default.float() - want.float()).abs().max().item()
                   / max(1.0, want.float().abs().max().item()))

    xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    _, idx = torch.ops.aten.max_pool2d_with_indices(xn, win, strd, pad)

    def library():
        return torch.ops.aten.max_pool2d_with_indices_backward(
            dyn, xn, win, strd, pad, (1, 1), False, idx)

    ms = cuda_ms(torch, lambda: mp._max_pool_bwd(x, y, dy, win, strd, pad))
    plain_ms = cuda_ms(torch, lambda: mp._max_pool_bwd_plain(
        x, y, dy, win, strd, pad), iters=5)
    library_ms = cuda_ms(torch, library)
    nbytes = x.element_size() * 2 * (x.numel() + y.numel())
    row = dict(case=name, shape=list(shape), window=list(win),
               strides=list(strd), pads=list(pad), dtype=dt, options=opts,
               vector_width=vector_width, max_abs_err=err, rel_err=rel,
               tolerance=POOL_TOL[dt],
               same_positions=same, bitwise_repeat=bitwise,
               default_route_same_positions=default_same,
               default_route_rel_err=default_rel, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=nbytes / PEAK_BYTES_S * 1e3,
               bound_by="bytes",
               ok=(same and bitwise and rel <= POOL_TOL[dt] and default_same
                   and default_rel <= POOL_TOL[dt]))
    print("pool_case " + json.dumps(row), flush=True)
    return row


def cnn_states(shapes, seed):
    """Seeded values, from numpy, for a CNN's parameters and buffers given
    as {name: shape}: He-scaled OIHW conv weights, (in, out) Linear
    weights at 1/sqrt(in), BatchNorm scales near 1, small offsets and
    biases, running statistics near (0, 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        shape = tuple(shape)
        a = rng.standard_normal(shape, dtype=np.float32)
        if name.endswith("running_var"):
            a = 1.0 + 0.2 * rng.random(shape, dtype=np.float32)
        elif name.endswith("scale"):
            a = 1.0 + 0.1 * a
        elif len(shape) == 4:
            a *= np.float32(np.sqrt(2.0 / np.prod(shape[1:])))
        elif len(shape) == 2:
            a *= np.float32(shape[0] ** -0.5)
        else:  # biases, offsets, running means
            a *= np.float32(0.1)
        out[name] = a
    return out


def named_grads(model, loss):
    """{name: grad} of every parameter of `model` that `loss` reaches."""
    from singa_tpu_torch import autograd

    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: g for p, g in autograd.grad_pairs(loss)}


def worst_rel(a, b):
    """max over the names of b of max|a - b| / max|b|."""
    return max((a[n] - b[n]).abs().max().item()
               / max(b[n].abs().max().item(), 1e-30) for n in b)


def cnn_grads(model, x, y):
    """{name: grad} of the mean cross-entropy at the current weights, in
    training mode; the BatchNorm running statistics are put back."""
    import torch

    from singa_tpu_torch import autograd

    buffers = {k: b.clone() for k, b in model.named_buffers()}
    grads = named_grads(model, autograd.softmax_cross_entropy(
        model.forward(x), y))
    with torch.no_grad():
        for k, b in model.named_buffers():
            b.copy_(buffers[k])
    return grads


def cnn_macs(torch, m, size):
    """(multiply-adds, activation elements) of one image through `m`'s
    convolutions and fc layers at `size` x `size`: each conv's output
    elements times its (in/group) * kh * kw, each fc's in * out; and
    the elements those layers read and write. Counted from forward hooks
    on a batch-1 eval forward (BatchNorm, ReLU and the pools are not
    counted)."""
    from singa_tpu_torch import layer

    macs, elems, hooks = [0], [0], []

    def hook(mod, inputs, out):
        x = inputs[0]
        if isinstance(mod, layer.Conv2d):
            kh, kw = mod.W.shape[2:]
            macs[0] += out.numel() * mod.W.shape[1] * kh * kw
        else:
            macs[0] += out.numel() * mod.W.shape[0]
        elems[0] += x.numel() + out.numel()

    for mod in m.modules():
        if isinstance(mod, (layer.Conv2d, layer.Linear)):
            hooks.append(mod.register_forward_hook(hook))
    was = m.training
    m.eval()
    with torch.no_grad():
        m(torch.zeros((1, 3, size, size), device="cuda"))
    m.train(was)
    for h in hooks:
        h.remove()
    return macs[0], elems[0]


def step_bound_ms(macs, elems, n_params, batch, prec):
    """Least ms of one training step: the larger of its products'
    operations (3 passes of 2 * MACs an image: forward, backward-data,
    backward-weight) at the card's peak rate for `prec`, and its bytes
    at the memory rate: each counted layer's input and output read or
    written once in each of the 3 passes, and the parameters read,
    their gradients written and the momentum slot read and written."""
    elem = 2 if prec == "bf16" else 4
    flops = 3 * 2 * macs * batch
    nbytes = 3 * elems * batch * elem + 5 * 4 * n_params
    return max(flops / PEAK_FLOPS[prec], nbytes / PEAK_BYTES_S) * 1e3, dict(
        flops=flops, bytes=nbytes,
        bound_by="operations" if flops / PEAK_FLOPS[prec]
        > nbytes / PEAK_BYTES_S else "bytes")


#: the kernel families of a CNN step's breakdown
CNN_FAMILIES = ("depthwise_fwd", "depthwise_bwd_data",
                "depthwise_bwd_weight", "dense_and_1x1_conv_and_fc",
                "batchnorm_and_elementwise", "layout_copies",
                "max_pool_bwd")
_CONV_OPS = ("aten::cudnn_convolution", "aten::_convolution",
             "aten::convolution", "aten::_conv_depthwise2d",
             "aten::conv_depthwise2d", "aten::_slow_conv2d_forward")
_LAYOUT = ("nchwtonhwc", "nhwctonchw", "transpose", "copy_kernel",
           "nchw_to_nhwc", "nhwc_to_nchw")
_WEIGHT_GRAD = ("wgrad", "grad_weight", "gradweight", "filter", "dw_")


def _cnn_family(torch, evt, kernel_name):
    """The family of a kernel launched under the CPU op `evt`: K2a and
    layout conversions by name; the convolutions by the op above the
    launch (a depthwise one has an (C, 1, kh, kw) weight; in a
    backward, a weight-gradient kernel by name); the fc products by
    name; the rest is batch norm and elementwise work."""
    n = kernel_name.lower()
    if "max_pool_bwd" in n:
        return "max_pool_bwd"
    if any(s in n for s in _LAYOUT):
        return "layout_copies"
    e = evt
    while e is not None:
        shapes = getattr(e, "input_shapes", None) or []
        if e.name == "aten::convolution_backward" and len(shapes) > 2:
            if len(shapes[2]) == 4 and shapes[2][1] == 1:
                return ("depthwise_bwd_weight"
                        if any(s in n for s in _WEIGHT_GRAD)
                        else "depthwise_bwd_data")
            return "dense_and_1x1_conv_and_fc"
        if e.name in _CONV_OPS and len(shapes) > 1 and shapes[1]:
            if len(shapes[1]) == 4 and shapes[1][1] == 1:
                return "depthwise_fwd"
            return "dense_and_1x1_conv_and_fc"
        if e.name in ("aten::copy_", "aten::contiguous", "aten::clone"):
            return "layout_copies"
        e = e.cpu_parent
    if any(s in n for s in ("gemm", "gemv", "cutlass", "xmma", "cublas",
                            "sm90_", "sm80_")):
        return "dense_and_1x1_conv_and_fc"
    return "batchnorm_and_elementwise"


def cnn_breakdown(torch, m, x, y, name):
    """Device ms of one uncaptured training step by kernel family
    (`torch.profiler`, CPU ops with their input shapes), the idle share
    of the step's wall time, and the top kernels of each family."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    m(x, y)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t = time.perf_counter()
        m(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_family = dict.fromkeys(CNN_FAMILIES, 0.0)
    names = defaultdict(lambda: defaultdict(float))
    n_kernels = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in e.kernels:
            fam = _cnn_family(torch, e, k.name)
            by_family[fam] += k.duration / 1e3
            names[fam][k.name[:80]] += k.duration / 1e3
            n_kernels += 1
    busy = sum(by_family.values())
    check(busy > 0, f"{name}: the profiler saw no device time")
    row = dict(wall_ms=wall_ms, device_busy_ms=busy,
               idle_share=max(0.0, 1.0 - busy / wall_ms),
               n_kernels=n_kernels, by_family_ms=by_family,
               share={k: v / busy for k, v in by_family.items()},
               top={f: sorted(d.items(), key=lambda kv: -kv[1])[:3]
                    for f, d in names.items()})
    print(f"{name} breakdown of one uncaptured fp32 step: "
          + json.dumps(row), flush=True)
    return row


def cnn_path(torch, fa, mp, name, ctor, per_step, batch, card=None,
             window=5):
    """A CNN at full width trains on one seeded ImageNet-shape batch
    with the max-pool kernel on (the sequence of bench.py's
    bench_framework), each step captured: kernel-on against kernel-off
    gradients, 6 captured steps counted (`per_step` launches in the
    uncaptured step and in the capture), BatchNorm statistics, an eval
    forward, the captured steps against the uncaptured twin in fp32 and
    bf16 (deterministic cuDNN), then images/s of captured steps in
    windows of `window` (with the kernel switch on and off in turns
    where the model max-pools).
    With `card` given, also the peak memory, the captured step's device
    ms beside its bound and the step's kernel-family breakdown. Returns
    the counted step's launches and the numbers."""
    from singa_tpu_torch import autograd, opt
    from singa_tpu_torch.model import load_singa_tpu_states

    pools = per_step["max_pool_bwd"]
    torch.cuda.reset_peak_memory_stats()
    m = ctor(num_classes=1000, device="cuda")
    states = cnn_states({n: t.shape for n, t in [*m.named_parameters(),
                                                 *m.named_buffers()]}, SEED)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.randn((batch, 3, 224, 224), generator=gen, device="cuda")
    y = torch.arange(batch, device="cuda") % 1000

    def restore(precision, use_graph):
        def put(model):
            load_singa_tpu_states(model, states)
            model.set_optimizer(opt.SGD(lr=0.05, momentum=0.9))
            model.compile([x], is_train=True, use_graph=use_graph,
                          precision=precision)
        return put

    m.set_image_layout("NHWC")
    mp.set_pool_kernel_enabled(True)
    t = time.perf_counter()
    restore("fp32", True)(m)
    # cuDNN's default backward algorithms sum with atomics in an order
    # that changes from run to run; the captured steps and their twin
    # run its deterministic ones, so that what differs is the capture
    torch.backends.cudnn.deterministic = True
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in m.parameters())
    print(f"{name}: {n_params} parameters, "
          f"compile {time.perf_counter() - t:.3f} s", flush=True)

    # gradients with the kernel on and off, at the seeded weights
    on = cnn_grads(m, x, y)
    mp.set_pool_kernel_enabled(False)
    off = cnn_grads(m, x, y)
    mp.set_pool_kernel_enabled(True)
    check(sorted(on) == sorted(off) == sorted(
        n for n, _ in m.named_parameters()),
        f"{name} gradients not complete")
    grad_tol = 1e-3  # of each parameter's max|grad|: cuDNN's order only
    worst = worst_rel(on, off)
    print(f"{name} grads, max-pool kernel on vs off: worst max|d| / "
          f"max|grad| {worst:.3e} over {len(on)} parameters (tol "
          f"{grad_tol})", flush=True)
    check(worst <= grad_tol, f"kernel-path {name} gradients disagree")
    del on, off

    # 6 steps: the first uncaptured and counted alone, then captured
    losses, first_s, step_ms = captured_steps(
        torch, fa, mp, m, x, y, per_step, f"{name} fp32 (deterministic)")
    print(f"{name} losses {losses}", flush=True)
    check(all(np.isfinite(losses)), f"non-finite {name} loss")
    check(losses[-1] < losses[0], f"the {name} loss did not fall")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if card is not None:
        free, total = torch.cuda.mem_get_info()
        print(f"{name} at batch {batch}: peak allocated {peak_gb:.2f} GiB "
              f"of {total / 2**30:.1f} GiB ({card})", flush=True)

    # BatchNorm: the running statistics moved and are finite
    moved = finite = 0
    for k, b in m.named_buffers():
        finite += int(bool(torch.isfinite(b).all()))
        moved += int(not np.array_equal(b.cpu().numpy(), states[k]))
    n_buf = len(list(m.named_buffers()))
    print(f"{name} BatchNorm buffers: {moved}/{n_buf} moved, "
          f"{finite}/{n_buf} finite", flush=True)
    check(moved == finite == n_buf, "BatchNorm statistics did not move or "
                                    "are not finite")
    captured = (losses, state_of(m), step_ms)
    m.eval()
    with torch.inference_mode():
        scores = m(x)
    m.train()
    check(tuple(scores.shape) == (batch, 1000)
          and bool(torch.isfinite(scores).all()),
          f"eval-mode {name} scores are not finite ({batch}, 1000)")
    del scores

    twin = {"fp32": hold_twin(torch, f"{name} (deterministic cuDNN)",
                              "fp32", captured,
                              eager_twin(torch, m, restore("fp32", False),
                                         x, y))}
    del captured
    drop_graphs(torch)

    # bf16 from the seeded states: autocast on, so the kernel gets bf16
    # operands (in the uncaptured first step and in the capture)
    seen = []
    real = mp._max_pool_bwd
    mp._max_pool_bwd = lambda x_, *a: seen.append(x_.dtype) or real(x_, *a)
    try:
        restore("bf16", True)(m)
        losses_bf16, _, ms = captured_steps(
            torch, fa, mp, m, x, y, per_step,
            f"{name} bf16 (deterministic)")
        twin["bf16"] = hold_twin(
            torch, f"{name} (deterministic cuDNN)", "bf16",
            (losses_bf16, state_of(m), ms),
            eager_twin(torch, m, restore("bf16", False), x, y))
    finally:
        mp._max_pool_bwd = real
        autograd.set_autocast(False)
        torch.backends.cudnn.deterministic = False
    drop_graphs(torch)

    # throughput with cuDNN's default algorithms, captured: with the
    # switch on and off in turns (on, off, off, on) where the model
    # max-pools, else two windows
    restore("fp32", True)(m)
    if pools:
        rates = switch_turns(torch, m, x, y, mp.set_pool_kernel_enabled,
                             lambda: mp.MAX_POOL_BWD_LAUNCHES, pools, name,
                             window)
    else:
        rates = switch_turns(torch, m, x, y, lambda on: None,
                             lambda: 0, 0, name, window)
        rates = {True: rates[True] + rates[False], False: []}
    on_rate = float(np.mean(rates[True]))
    off_rate = float(np.mean(rates[False])) if rates[False] else None
    if pools:
        print(f"{name} fp32 training: {on_rate:.1f} images/s with the "
              f"max-pool kernel, {off_rate:.1f} without (captured steps, "
              f"windows of {window}, on/off/off/on: {rates[True]} / "
              f"{rates[False]})", flush=True)
    else:
        print(f"{name} fp32 training: {on_rate:.1f} images/s (captured "
              f"steps, 4 windows of {window}: {rates[True]})", flush=True)
    print(f"{name} bf16 losses {losses_bf16}, kernel operand dtypes "
          f"{sorted(set(map(str, seen)))}", flush=True)
    check(all(np.isfinite(losses_bf16)), f"non-finite bf16 {name} loss")
    check(set(seen) == ({torch.bfloat16} if pools else set()),
          f"the bf16 {name} step did not run the max-pool kernel on bf16 "
          f"operands")
    out = dict(images_per_s_kernel_on=on_rate,
               images_per_s_kernel_off=off_rate,
               rates=[rates[True], rates[False]], losses=losses,
               grad_rel_err=worst, losses_bf16=losses_bf16,
               first_step_s=first_s, step_ms=step_ms, twin=twin)
    if card is not None:
        # the captured step's device time, by CUDA events over replays
        gs = m._train_step
        entry = next(e for e in gs._cache.values() if hasattr(e, "graph"))
        dev = torch.device("cuda")
        device_ms = cuda_ms(torch, lambda: gs._on_stream(
            dev, entry.graph.replay), iters=10, warmup=2)
        del gs, entry
        m.graph(False)  # the breakdown's steps run uncaptured
        drop_graphs(torch)  # the captured steps' memory pools
        macs, elems = cnn_macs(torch, m, 224)
        bound, parts = step_bound_ms(macs, elems, n_params, batch, "fp32")
        bound16, _ = step_bound_ms(macs, elems, n_params, batch, "bf16")
        print(f"{name} ({card}): captured fp32 step {device_ms:.3f} device "
              f"ms at batch {batch} ({batch / device_ms * 1e3:.1f} "
              f"images/s); bound {bound:.3f} ms by {parts['bound_by']} "
              f"({macs / 1e9:.3f} GMAC an image, {parts['flops'] / 1e12:.3f}"
              f" TFLOP, {parts['bytes'] / 1e9:.2f} GB a step); the bf16 "
              f"bound {bound16:.3f} ms", flush=True)
        out.update(peak_allocated_gib=peak_gb, batch=batch,
                   captured_step_device_ms=device_ms, step_bound_ms=bound,
                   step_bound_bf16_ms=bound16, gmac_per_image=macs / 1e9,
                   step_flops=parts["flops"], step_bytes=parts["bytes"],
                   bound_by=parts["bound_by"],
                   breakdown=cnn_breakdown(torch, m, x, y, name))
    mp.set_pool_kernel_enabled(False)
    m.graph(False)
    del m
    drop_graphs(torch)
    return per_step, out


def resnet_path(torch, fa, mp):
    """ResNet-50 at full width (`cnn_path`): one K2a launch a step."""
    from singa_tpu_torch.models.resnet import resnet50

    return cnn_path(torch, fa, mp, "resnet50", resnet50,
                    dict(NO_LAUNCH, max_pool_bwd=1), 128)


def seeded_params(model, seed):
    """Random weights for every parameter, from numpy with `seed`, with
    the scales of the reference's initialisers: `serve_gpt.seeded_weights`,
    which the spool server's process entry uses too, so a process
    replica serves the same weights as this process."""
    from singa_tpu_torch.examples.serve_gpt import seeded_weights

    return seeded_weights(model, seed)


def kernel_name(mangled):
    """`flash_fwd_kernel<128, float, 0>` for a mangled kernel
    instantiation in `mangled`, or None."""
    import re

    m = re.search(
        r"([a-z_]+_kernel)I((?:Li-?\d+E|Lb[01]E|f|13__nv_bfloat16)+)E",
        mangled)
    if not m:
        return None
    names = {"f": "float", "13__nv_bfloat16": "bf16", "0": "false",
             "1": "true"}
    args = re.findall(r"Li(-?\d+)E|Lb([01])E|(f|13__nv_bfloat16)",
                      m.group(2))
    return f"{m.group(1)}<" + ", ".join(num or names[flag or typ]
                                        for num, flag, typ in args) + ">"


def ptxas_summary(log):
    """One line per kernel from nvcc's -Xptxas -v report: registers and
    spill bytes."""
    import re

    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
    return out


def sass_census(lib_path, cuobjdump):
    """{kernel instantiation: {opcode: count}} of SASS_OPS in a built
    library, from `cuobjdump -sass`."""
    import re

    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    census, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = kernel_name(line)
            if name:
                census[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            op = m.group(1)
            base = op.split(".")[0]
            if base in census[name]:
                census[name][base] += 1
            elif base == "LDG" and ".128" in op:
                census[name]["LDG.E.128"] += 1
    return census


def counts(fa, mp):
    """Every kernel's launch count."""
    return {"flash_fwd": fa.FLASH_FWD_LAUNCHES,
            "flash_bwd_dq": fa.FLASH_BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.FLASH_BWD_DKV_LAUNCHES,
            "max_pool_bwd": mp.MAX_POOL_BWD_LAUNCHES}


def reset_counts(fa, mp):
    fa.FLASH_FWD_LAUNCHES = 0
    fa.FLASH_BWD_DQ_LAUNCHES = 0
    fa.FLASH_BWD_DKV_LAUNCHES = 0
    for k in fa.FUSED_LAUNCHES:
        fa.FUSED_LAUNCHES[k] = 0
    mp.MAX_POOL_BWD_LAUNCHES = 0


def split_counts(fa, mp):
    """Each flash kernel's launches by layout since the last reset:
    {"head_split": {...}, "fused": {...}}."""
    total = counts(fa, mp)
    fused = dict(fa.FUSED_LAUNCHES)
    return {"head_split": {k: total[k] - v for k, v in fused.items()},
            "fused": fused}


def main_grads(torch, model, x, y):
    """{name: grad} of the mean next-token loss at the current weights."""
    from singa_tpu_torch import autograd

    return named_grads(model, autograd.softmax_cross_entropy(
        model.forward(x).reshape(-1, model.vocab_size), y.reshape(-1)))


# -- captured training steps --------------------------------------------------

#: the captured steps against their uncaptured twin (`graph(False)`, the
#: same state, the same batches): each loss within TWIN_TOL of |loss|,
#: each parameter and buffer after the steps within TWIN_TOL of its
#: max|p|. The same kernels run on the same values either way; bf16 is
#: allowed the rounding of a product whose cuBLAS algorithm may differ
TWIN_TOL = {"fp32": 1e-6, "bf16": 2e-3}
NO_LAUNCH = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
             "max_pool_bwd": 0}


def state_of(model):
    """Clones of every parameter and buffer, by name."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    return {n: t.detach().clone() for n, t in own.items()}


def run_steps(torch, m, x, y, steps, skip=0):
    """`steps` calls of m(x, y): their losses, and the mean host ms of
    the calls after the first `skip` (each ended by reading its loss)."""
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, loss = m(x, y)
        losses.append(loss.item())
        ms.append(1e3 * (time.perf_counter() - t))
    return losses, float(np.mean(ms[skip:])) if ms[skip:] else None


def captured_steps(torch, fa, mp, m, x, y, per_step, what, steps=6,
                   layouts=None):
    """`steps` training steps of a model compiled with use_graph=True,
    from its compiled state. Step 1 runs uncaptured and launches
    `per_step` kernels; step 2 captures the whole step (the wrappers
    count the launches they record into the graph: `per_step` again)
    and replays it; steps 3 on replay it, and no wrapper runs. Returns
    the losses, step 1's seconds and the mean ms of steps 3 on. A dict
    `layouts` receives the flash launches by layout (`split_counts`) of
    step 1 ("first") and of the capture ("capture")."""
    reset_counts(fa, mp)
    t = time.perf_counter()
    losses, _ = run_steps(torch, m, x, y, 1)
    first_s = time.perf_counter() - t
    launches = counts(fa, mp)
    if layouts is not None:
        layouts["first"] = split_counts(fa, mp)
    gs = m._train_step
    check(launches == per_step, f"{what}: the uncaptured first step "
                                f"launched {launches}, not {per_step}")
    check(gs is not None and (gs.captures, gs.replays) == (0, 0),
          f"{what}: the first step did not run uncaptured")
    reset_counts(fa, mp)
    losses += run_steps(torch, m, x, y, 1)[0]
    captured = counts(fa, mp)
    if layouts is not None:
        layouts["capture"] = split_counts(fa, mp)
    check(captured == per_step and (gs.captures, gs.replays) == (1, 1),
          f"{what}: the capture recorded {captured} launches (not "
          f"{per_step}), or made {gs.captures} captures and "
          f"{gs.replays} replays (not 1 and 1)")
    reset_counts(fa, mp)
    rest, ms = run_steps(torch, m, x, y, steps - 2)
    losses += rest
    check(counts(fa, mp) == NO_LAUNCH and gs.captures == 1
          and gs.replays == steps - 1,
          f"{what}: steps 3-{steps} launched {counts(fa, mp)} from Python "
          f"or replayed {gs.replays - 1} times, not {steps - 2}")
    print(f"{what}: step 1 uncaptured {first_s:.3f} s, launches "
          f"{launches}; step 2 captured ({captured} launches recorded); "
          f"steps 3-{steps} {gs.replays - 1} replays, {ms:.2f} ms a step",
          flush=True)
    return losses, first_s, ms


def eager_twin(torch, m, restore, x, y, steps=6):
    """The uncaptured twin: `restore(m)` puts back the starting state and
    optimizer and compiles with use_graph=False; then `steps` eager
    steps. Returns the losses, the state after them and the mean ms of
    steps 3 on."""
    restore(m)
    check(not m._use_graph, "the twin is not uncaptured")
    losses, ms = run_steps(torch, m, x, y, steps, skip=2)
    check(m._train_step is None, "the uncaptured twin made a graph step")
    return losses, state_of(m), ms


def hold_twin(torch, what, prec, captured, twin):
    """Hold (losses, state, ms) of the captured steps against the twin's
    within TWIN_TOL[prec]; print and return the gaps and both step
    times."""
    (lc, sc, ms_c), (le, se, ms_e) = captured, twin
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lc, le))
    state_gap = max((sc[n].float() - se[n].float()).abs().max().item()
                    / max(se[n].float().abs().max().item(), 1e-30)
                    for n in se)
    bitwise = lc == le and all(torch.equal(sc[n], se[n]) for n in se)
    tol = TWIN_TOL[prec]
    print(f"{what} {prec}: captured vs uncaptured twin over {len(lc)} "
          f"steps: losses max rel {loss_gap:.3e}, state max|d|/max|p| "
          f"{state_gap:.3e} over {len(se)} tensors (tol {tol}), bitwise "
          f"equal: {bitwise}; step ms captured {ms_c:.2f} vs uncaptured "
          f"{ms_e:.2f}", flush=True)
    check(sorted(sc) == sorted(se) and len(lc) == len(le),
          f"{what}: the twins differ in shape")
    check(loss_gap <= tol and state_gap <= tol,
          f"{what} {prec}: the captured steps differ from the uncaptured "
          f"twin")
    return dict(loss_gap=loss_gap, state_gap=state_gap, bitwise=bitwise,
                step_ms_captured=ms_c, step_ms_uncaptured=ms_e)


def drop_graphs(torch):
    """Free what dropped models and graph steps hold on the card."""
    gc.collect()
    torch.cuda.empty_cache()


def train_path(torch, fa, mp, model, rng):
    """The training path: gpt_medium, AdamW(lr=3e-4), compile, kernel-on
    against kernel-off gradients, 6 steps (the first uncaptured and
    counted, the second captured, then replays) against the uncaptured
    twin, and the same in bf16. Returns the launches of the counted step
    and the numbers."""
    from singa_tpu_torch import autograd, opt

    seq = torch.from_numpy(rng.integers(0, model.vocab_size,
                                        (4, 1025))).cuda()
    x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
    start = state_of(model)

    def restore(precision, use_graph):
        def put(m):
            with torch.no_grad():
                for n, p in m.named_parameters():
                    p.copy_(start[n])
            m.set_optimizer(opt.AdamW(lr=3e-4))
            m.compile([x], is_train=True, use_graph=use_graph,
                      precision=precision)
        return put

    restore("fp32", True)(model)

    # gradients with the kernels on and off, at the seeded weights
    on = main_grads(torch, model, x, y)
    fa.set_flash_enabled(False)
    try:
        off = main_grads(torch, model, x, y)
    finally:
        fa.set_flash_enabled(True)
    check(sorted(on) == sorted(off) == sorted(
        n for n, _ in model.named_parameters()), "gradients not complete")
    grad_tol = 1e-3  # of each parameter's max|grad|; summation order only
    worst = worst_rel(on, off)
    print(f"train grads, kernels on vs off: worst max|d| / max|grad| "
          f"{worst:.3e} over {len(on)} parameters (tol {grad_tol})",
          flush=True)
    check(worst <= grad_tol, "kernel-path gradients disagree")
    del on, off

    per_step = dict(NO_LAUNCH, flash_fwd=12, flash_bwd_dq=12,
                    flash_bwd_dkv=12)
    losses, first_s, step_ms = captured_steps(
        torch, fa, mp, model, x, y, per_step, "train fp32")
    launches = per_step
    print(f"train losses {losses}", flush=True)
    print(f"train: {step_ms:.2f} ms per 4x1024 captured step (mean of "
          f"steps 3-6), {4 * 1024 / step_ms * 1e3:.1f} tokens/s",
          flush=True)
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "the loss did not fall over 6 steps")
    twin = {"fp32": hold_twin(torch, "train", "fp32",
                              (losses, state_of(model), step_ms),
                              eager_twin(torch, model,
                                         restore("fp32", False), x, y))}

    # bf16: autocast on, so the kernels get bf16 operands
    seen = []
    real_fwd, real_bwd = fa._flash_fwd, fa._flash_bwd
    fa._flash_fwd = lambda q, *a: seen.append(("fwd", q.dtype)) or real_fwd(
        q, *a)
    fa._flash_bwd = lambda q, *a: seen.append(("bwd", q.dtype)) or real_bwd(
        q, *a)
    try:
        drop_graphs(torch)
        restore("bf16", True)(model)
        losses_bf16, bf16_s, bf16_ms = captured_steps(
            torch, fa, mp, model, x, y, per_step, "train bf16")
        twin["bf16"] = hold_twin(
            torch, "train", "bf16",
            (losses_bf16, state_of(model), bf16_ms),
            eager_twin(torch, model, restore("bf16", False), x, y))
    finally:
        fa._flash_fwd, fa._flash_bwd = real_fwd, real_bwd
        autograd.set_autocast(False)
    print(f"train bf16 losses {losses_bf16}, {bf16_s:.3f} s (first bf16 "
          f"step), kernel operand dtypes "
          f"{sorted(set(str(d) for _, d in seen))}", flush=True)
    check(all(np.isfinite(losses_bf16)), "non-finite bf16 loss")
    check({d for _, d in seen} == {torch.bfloat16} and
          {k for k, _ in seen} == {"fwd", "bwd"},
          "the bf16 step did not run the kernels on bf16 operands")
    model.graph(False)
    model.eval()
    drop_graphs(torch)
    return launches, dict(step_ms=step_ms, tokens_per_s=4 * 1024 / step_ms
                          * 1e3, losses=losses, grad_rel_err=worst,
                          first_step_s=first_s, losses_bf16=losses_bf16,
                          step_ms_bf16=bf16_ms, twin=twin)


# -- BERT-base and the unrolled GPT ------------------------------------------

BERT_BATCH, BERT_SEQ = 16, 512  # bench.py's chip shape for --model bert


def bert_train_flops(batch, seq, d_model=768, n_layers=12, ffn_mult=4):
    """Analytic FLOPs of one BERT training step, as bench.py's
    `_bert_train_flops` counts them (matrix products only, backward ~ 2x
    forward): per layer forward, QKV and output projections 8*B*T*d^2,
    the FFN 4*B*T*d*(ffn_mult*d), attention scores and context
    4*B*T^2*d."""
    proj = 8 * batch * seq * d_model * d_model
    ffn = 4 * batch * seq * d_model * (ffn_mult * d_model)
    attn = 4 * batch * seq * seq * d_model
    return 3 * n_layers * (proj + ffn + attn)


def switch_turns(torch, m, x, y, switch, launched, per_step, what,
                 steps):
    """Samples/s of captured steps `m(x, y)` with a kernel switch on and
    off, in turns (on, off, off, on). After each switch two untimed
    steps: for a switch state seen for the first time they are its
    uncaptured first step and its capture (`per_step` launches each when
    on, none when off); then a window of `steps` steps that must all be
    replays, with no launch counted. `launched()` reads the switched
    kernel's counter."""
    rates = {True: [], False: []}
    for enabled in (True, False, False, True):
        switch(enabled)
        before = launched()
        m(x, y)
        m(x, y)
        warm = launched() - before
        check(warm in ((0, 2 * per_step) if enabled else (0,)),
              f"{what}: switch {enabled}: {warm} launches in the first "
              f"step and the capture")
        gs = m._train_step
        replays, before = gs.replays, launched()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            _, loss = m(x, y)
        loss.item()
        dt = time.perf_counter() - t
        check(launched() == before and gs.replays - replays == steps,
              f"{what}: switch {enabled}: {launched() - before} launches "
              f"counted and {gs.replays - replays} replays in {steps} "
              f"steps")
        rates[enabled].append(steps * x.shape[0] / dt)
    switch(True)
    return rates


def bert_path(torch, fa, mp):
    """BERT-base at full width trains at bench.py's chip shape (16 x 512)
    through `BertForClassification`, `AdamW(lr=1e-4)`, `compile` and
    `model(ids, y)`, each step captured: the fused flash kernels run
    non-causally at hd 64 with 12 heads inside a CUDA Graph. Returns the
    counted fp32 step's launches and the numbers."""
    from singa_tpu_torch import autograd, opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.transformer import BertForClassification

    rng = np.random.default_rng(SEED + 1)
    ids = torch.from_numpy(rng.integers(0, 30522, (BERT_BATCH, BERT_SEQ)))
    ids = ids.cuda()
    y = torch.arange(BERT_BATCH, device="cuda") % 2
    flops = bert_train_flops(BERT_BATCH, BERT_SEQ)
    per_step = dict(NO_LAUNCH, flash_fwd=12, flash_bwd_dq=12,
                    flash_bwd_dkv=12)

    def restore(precision, use_graph, lr=1e-4):
        def put(model):
            load_singa_tpu_params(model, weights)
            model.set_optimizer(opt.AdamW(lr=lr))
            model.compile([ids], is_train=True, use_graph=use_graph,
                          precision=precision)
        return put

    # the dropout-0 twin: kernel on against kernel off
    m = BertForClassification(2, max_len=BERT_SEQ, dropout=0.0,
                              device="cuda")
    weights = seeded_params(m, SEED)
    restore("fp32", True)(m)
    print(f"bert_base: {sum(p.numel() for p in m.parameters())} "
          f"parameters", flush=True)
    sides = {}
    for enabled in (True, False):
        fa.set_flash_enabled(enabled)
        logits = m.forward(ids)
        loss = autograd.softmax_cross_entropy(logits, y)
        sides[enabled] = (logits.detach(), named_grads(m, loss))
    fa.set_flash_enabled(True)
    (l_on, g_on), (l_off, g_off) = sides[True], sides[False]
    check(sorted(g_on) == sorted(g_off) == sorted(
        n for n, _ in m.named_parameters() if n != "bert.seg.table"),
        "BERT gradients not complete (every parameter but the segment "
        "table, which no seg_ids reach)")
    logit_err = (l_on - l_off).abs().max().item()
    worst = worst_rel(g_on, g_off)
    tol = 1e-3  # of each max|grad| (logits: absolute); summation order
    print(f"bert kernel on vs off: logits max|d| {logit_err:.3e}, grads "
          f"worst max|d| / max|grad| {worst:.3e} over {len(g_on)} "
          f"parameters (tol {tol})", flush=True)
    check(logit_err <= tol and worst <= tol, "BERT kernel path disagrees")
    # the last loss's tape holds the parameters' gradient accumulators,
    # made on this stream: a capture on the step's stream cannot use them
    del sides, g_on, g_off, logits, loss

    # 6 captured fp32 steps (the first uncaptured and counted) against
    # the uncaptured twin, then the same in bf16
    launches = per_step
    losses0, first_s, ms0 = captured_steps(torch, fa, mp, m, ids, y,
                                           per_step, "bert fp32 dropout 0")
    twin = {"fp32": hold_twin(torch, "bert dropout 0", "fp32",
                              (losses0, state_of(m), ms0),
                              eager_twin(torch, m, restore("fp32", False),
                                         ids, y))}
    drop_graphs(torch)
    try:
        restore("bf16", True)(m)
        losses0_bf16, _, ms = captured_steps(
            torch, fa, mp, m, ids, y, per_step, "bert bf16 dropout 0")
        twin["bf16"] = hold_twin(
            torch, "bert dropout 0", "bf16",
            (losses0_bf16, state_of(m), ms),
            eager_twin(torch, m, restore("bf16", False), ids, y))
    finally:
        autograd.set_autocast(False)
    m.graph(False)

    # a padded batch with a key mask: the plain attention, no kernel
    lengths = rng.integers(BERT_SEQ // 4, BERT_SEQ + 1, BERT_BATCH)
    mask = (torch.arange(BERT_SEQ, device="cuda")[None]
            < torch.from_numpy(lengths).cuda()[:, None])[:, None, None]
    m.eval()
    with torch.inference_mode():
        reset_counts(fa, mp)
        masked = m(ids, None, mask)
        masked_launches = counts(fa, mp)
        fa.set_flash_enabled(False)
        masked_off = m(ids, None, mask)
        fa.set_flash_enabled(True)
    m.train()
    print(f"bert masked batch (lengths {lengths.min()}-{lengths.max()}): "
          f"launches {masked_launches}, logits equal to the kernel-off "
          f"model's: {bool(torch.equal(masked, masked_off))}", flush=True)
    check(sum(masked_launches.values()) == 0,
          f"a masked BERT batch launched {masked_launches}")
    check(torch.equal(masked, masked_off) and bool(
        torch.isfinite(masked).all()), "masked BERT logits differ")
    del m, masked, masked_off
    drop_graphs(torch)

    # the bench's model (dropout 0.1): 6 captured steps, then tokens/s
    # on and off
    m = BertForClassification(2, max_len=BERT_SEQ, device="cuda")
    restore("fp32", True)(m)
    losses, _, _ = captured_steps(torch, fa, mp, m, ids, y, per_step,
                                  "bert fp32 dropout 0.1")
    print(f"bert fp32 losses (dropout 0.1) {losses}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "the BERT fp32 loss did not fall over 6 steps")

    def turns():
        return switch_turns(torch, m, ids, y, fa.set_flash_enabled,
                            lambda: fa.FLASH_FWD_LAUNCHES, 12, "bert", 3)

    rates = {"fp32": turns()}

    # dropout under capture: at lr 0 the weights stay, so two replays
    # of one batch give two losses only if they draw two masks
    before = state_of(m)
    m.set_optimizer(opt.AdamW(lr=0.0))
    m.graph(True)
    drawn = run_steps(torch, m, ids, y, 4)[0]
    check(m._train_step.replays == 3 and all(
        torch.equal(before[n], t) for n, t in state_of(m).items()),
        "the lr-0 dropout steps did not replay twice or moved the weights")
    print(f"bert dropout 0.1 at lr 0: losses {drawn} (uncaptured, capture, "
          f"replay, replay): the two replays draw different masks: "
          f"{drawn[2] != drawn[3]}", flush=True)
    check(len(set(drawn)) == 4, "dropout drew the same masks twice")
    del before
    drop_graphs(torch)

    # bf16: autocast on, so the kernels get bf16 operands
    seen = []
    real_fwd, real_bwd = fa._flash_fwd, fa._flash_bwd
    fa._flash_fwd = lambda q, *a: seen.append(q.dtype) or real_fwd(q, *a)
    fa._flash_bwd = lambda q, *a: seen.append(q.dtype) or real_bwd(q, *a)
    try:
        restore("bf16", True)(m)
        losses_bf16, _, _ = captured_steps(
            torch, fa, mp, m, ids, y, per_step, "bert bf16 dropout 0.1")
        rates["bf16"] = turns()
    finally:
        fa._flash_fwd, fa._flash_bwd = real_fwd, real_bwd
        autograd.set_autocast(False)
    print(f"bert bf16: losses {losses_bf16}, kernel operand dtypes "
          f"{sorted(set(map(str, seen)))}", flush=True)
    check(set(seen) == {torch.bfloat16},
          "the bf16 BERT step did not run the kernels on bf16 operands")
    check(all(np.isfinite(losses_bf16)) and losses_bf16[-1] < losses_bf16[0],
          "the BERT bf16 loss is not finite or did not fall")
    out = dict(first_step_s=first_s, losses=losses, losses_bf16=losses_bf16,
               logit_err=logit_err, grad_rel_err=worst,
               masked_launches=masked_launches, flops_per_step=flops,
               twin=twin, dropout_lr0_losses=drawn)
    for prec, r in rates.items():
        for enabled, key in ((True, "on"), (False, "off")):
            tok_s = float(np.mean(r[enabled])) * BERT_SEQ
            step_ms = BERT_BATCH * BERT_SEQ / tok_s * 1e3
            windows = [w * BERT_SEQ for w in r[enabled]]
            out[f"{prec}_kernel_{key}"] = dict(
                tokens_per_s=tok_s, step_ms=step_ms,
                tflops=flops / step_ms * 1e-9, windows=windows)
            print(f"bert {prec} kernel {key}: {step_ms:.2f} ms per "
                  f"{BERT_BATCH}x{BERT_SEQ} captured step, {tok_s:.1f} "
                  f"tokens/s, {flops / step_ms * 1e-9:.1f} TFLOP/s "
                  f"(windows {windows})", flush=True)
    m.graph(False)
    del m
    drop_graphs(torch)
    return launches, out


def gpt_unrolled_path(torch, fa, mp, scanned, ids, prompts):
    """`gpt_medium(scan_blocks=False, dropout=0.0)`, the reference's
    default unrolled decoder at gpt_medium's width, on the scanned
    model's seeded weights carried to its blocks' names: scoring, one
    training step's gradients, cached and eager `generate`, each
    against the scanned model. Returns the launches of each part."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium, unstack_params

    weights = seeded_params(scanned, SEED)
    load_singa_tpu_params(scanned, weights)
    m = gpt_medium(scan_blocks=False, dropout=0.0, device="cuda")
    load_singa_tpu_params(m, unstack_params(weights))
    scanned.eval()
    m.eval()
    launches, out = {}, {}

    with torch.inference_mode():
        reset_counts(fa, mp)
        logits = m(ids)
        launches["score"] = counts(fa, mp)
        err = (logits - scanned(ids)).abs().max().item()
    print(f"gpt unrolled scoring: launches {launches['score']}, logits vs "
          f"the scanned model max|d| {err:.3e}", flush=True)
    check(launches["score"]["flash_fwd"] == 12,
          f"unrolled scoring launched {launches['score']}")
    check(err <= 2e-3, "unrolled logits differ from the scanned model's")
    out["score_err"] = err
    del logits

    x, y = ids, torch.roll(ids, -1, dims=1)
    m.train()
    scanned.train()

    def restore(use_graph):
        def put(model):
            load_singa_tpu_params(model, unstack_params(weights))
            model.set_optimizer(opt.AdamW(lr=3e-4))
            model.compile([x], is_train=True, use_graph=use_graph)
        return put

    restore(True)(m)
    g_s = main_grads(torch, scanned, x, y)
    reset_counts(fa, mp)
    g_u = main_grads(torch, m, x, y)
    launches["grads"] = counts(fa, mp)
    worst = worst_rel(g_u, unstack_params(g_s))
    print(f"gpt unrolled gradients: launches {launches['grads']}, worst "
          f"max|d| / max|grad| against the scanned model {worst:.3e} over "
          f"{len(g_u)} parameters", flush=True)
    check(sorted(g_u) == sorted(n for n, _ in m.named_parameters()),
          "unrolled gradients not complete")
    check(launches["grads"] == {"flash_fwd": 12, "flash_bwd_dq": 12,
                                "flash_bwd_dkv": 12, "max_pool_bwd": 0},
          f"the unrolled gradients launched {launches['grads']}")
    check(worst <= 1e-3, "unrolled gradients differ from the scanned ones")
    out["grad_rel_err"] = worst
    del g_s, g_u
    losses, _, step_ms = captured_steps(torch, fa, mp, m, x, y,
                                        launches["grads"], "gpt unrolled")
    launches["train_step"] = launches["grads"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "the unrolled GPT's loss is not finite or did not fall")
    out["losses"] = losses
    out["twin"] = hold_twin(torch, "gpt unrolled", "fp32",
                            (losses, state_of(m), step_ms),
                            eager_twin(torch, m, restore(False), x, y))
    scanned.eval()
    m.eval()
    m.graph(False)
    load_singa_tpu_params(m, unstack_params(weights))
    drop_graphs(torch)

    toks = m.generate(prompts, n_new=48, window=256)
    check(np.array_equal(toks, scanned.generate(prompts, n_new=48,
                                                window=256)),
          "unrolled cached generate differs from the scanned model's")

    # the eager loop from full windows: cached slides recompute the
    # window with plain attention, eager runs the forward (the kernel)
    full = toks[:, :256]
    reset_counts(fa, mp)
    t = time.perf_counter()
    eager = m.generate(full, n_new=8, window=256, use_cache=False)
    eager_s = time.perf_counter() - t
    launches["eager_generate"] = counts(fa, mp)
    cached = m.generate(full, n_new=8, window=256)
    margins = []
    with torch.inference_mode():
        for j in range(8):
            ctx = torch.from_numpy(cached[:, j:j + 256]).cuda()
            top = m(ctx)[:, -1].float().topk(2, dim=-1).values
            margins.append((top[:, 0] - top[:, 1]).cpu().numpy())
    margins = np.stack(margins, axis=1)
    agree = all(same_until_near_tie(a, b, mg) for a, b, mg in zip(
        eager[:, 256:], cached[:, 256:], margins))
    print(f"gpt unrolled generate: cached equals the scanned model's; eager "
          f"(4 x 8 new, window 256) {eager_s:.3f} s, launches "
          f"{launches['eager_generate']}, equals cached up to the first "
          f"near-tie: {agree} (min margin {margins.min():.3e})", flush=True)
    check(launches["eager_generate"]["flash_fwd"] == 8 * 12,
          f"eager generate launched {launches['eager_generate']}")
    check(agree, "eager generate differs from the cached path")
    out["eager_min_margin"] = float(margins.min())
    del m
    torch.cuda.empty_cache()
    return launches, out


# -- Char-RNN ------------------------------------------------------------------

#: bench.py's `--model rnn` row (bench.py:360-437): Char-RNN at batch 64,
#: sequence 256, hidden 512, embed 64, vocab 64, one layer, Adam(lr 1e-3)
RNN_BATCH, RNN_SEQ, RNN_HIDDEN, RNN_EMBED, RNN_VOCAB = 64, 256, 512, 64, 64
#: the layers against PyTorch's cuDNN ones: max|d| / max|ref| of the
#: output and of every gradient (fp32, TF32 off; summation order only)
RNN_LAYER_TOL = 1e-4


def char_rnn_weights(model, seed):
    """Seeded weights at the reference's initialisers' scales: the
    recurrent layer's uniform(-1/sqrt(H), 1/sqrt(H)), the rest as
    `seeded_params` makes them."""
    rng = np.random.default_rng(seed + 7)
    out = seeded_params(model, seed)
    k = model.lstm.hidden_size ** -0.5
    for name in out:
        if name.startswith("lstm."):
            out[name] = rng.uniform(-k, k, out[name].shape).astype(
                np.float32)
    return out


def cudnn_twin(torch, port_layer, cls):
    """torch.nn.LSTM/GRU/RNN (cuDNN) carrying a port layer's weights:
    the port's (in, G*H) layouts transposed; a port bias `b` becomes
    cuDNN's input bias beside a zero hidden bias."""
    kw = dict(num_layers=port_layer.num_layers,
              bidirectional=port_layer.bidirectional, batch_first=True)
    if cls is torch.nn.RNN:
        kw["nonlinearity"] = port_layer.nonlinearity
    ref = cls(port_layer.input_size, port_layer.hidden_size, **kw).cuda()
    own = dict(port_layer.named_parameters())
    with torch.no_grad():
        for l in range(port_layer.num_layers):
            for d in range(2 if port_layer.bidirectional else 1):
                mine = f"_l{l}" + ("_r" if d else "")
                theirs = f"_l{l}" + ("_reverse" if d else "")
                getattr(ref, f"weight_ih{theirs}").copy_(
                    own["w_ih" + mine].t())
                getattr(ref, f"weight_hh{theirs}").copy_(
                    own["w_hh" + mine].t())
                if "b" + mine in own:
                    getattr(ref, f"bias_ih{theirs}").copy_(own["b" + mine])
                    getattr(ref, f"bias_hh{theirs}").zero_()
                else:
                    getattr(ref, f"bias_ih{theirs}").copy_(
                        own["b_ih" + mine])
                    getattr(ref, f"bias_hh{theirs}").copy_(
                        own["b_hh" + mine])
    return ref


def layer_vs_cudnn(torch, name, port_layer, cls, seed):
    """The port layer's output and input and weight gradients against
    cuDNN's layer on the same weights and a seeded input and cotangent
    (RNN_BATCH x RNN_SEQ); returns the worst gap, relative to each
    reference tensor's max, and cuDNN's and the port's forward+backward
    ms."""
    ref = cudnn_twin(torch, port_layer, cls)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((RNN_BATCH, RNN_SEQ, port_layer.input_size),
                    generator=gen, device="cuda")
    dirs = 2 if port_layer.bidirectional else 1
    dy = torch.randn((RNN_BATCH, RNN_SEQ, dirs * port_layer.hidden_size),
                     generator=gen, device="cuda")

    def fwd_bwd(layer, params):
        xi = x.clone().requires_grad_()
        out = layer(xi)
        out = out[0] if isinstance(out, tuple) else out
        return out, torch.autograd.grad(out, [xi, *params], dy)

    mine = list(port_layer.parameters())
    out, grads = fwd_bwd(port_layer, mine)
    ref_out, ref_grads = fwd_bwd(ref, list(ref.parameters()))
    own = dict(zip([n for n, _ in port_layer.named_parameters()], grads[1:]))
    theirs = dict(zip([n for n, _ in ref.named_parameters()],
                      ref_grads[1:]))
    pairs = [("out", out, ref_out), ("dx", grads[0], ref_grads[0])]
    for l in range(port_layer.num_layers):
        for d in range(dirs):
            sm, st = f"_l{l}" + ("_r" if d else ""), \
                f"_l{l}" + ("_reverse" if d else "")
            pairs += [("dw_ih" + sm, own["w_ih" + sm],
                       theirs["weight_ih" + st].t()),
                      ("dw_hh" + sm, own["w_hh" + sm],
                       theirs["weight_hh" + st].t())]
            if "b" + sm in own:  # one port bias feeds both cuDNN biases
                pairs.append(("db" + sm, own["b" + sm],
                              theirs["bias_ih" + st]))
            else:
                pairs += [("db_ih" + sm, own["b_ih" + sm],
                           theirs["bias_ih" + st]),
                          ("db_hh" + sm, own["b_hh" + sm],
                           theirs["bias_hh" + st])]
    gaps = {k: (a - b).abs().max().item() / max(b.abs().max().item(),
                                                 1e-30)
            for k, a, b in pairs}
    worst = max(gaps.values())
    ms = cuda_ms(torch, lambda: fwd_bwd(port_layer, mine), iters=3,
                 warmup=1)
    cudnn = cuda_ms(torch, lambda: fwd_bwd(ref, list(ref.parameters())),
                    iters=10, warmup=2)
    print(f"char_rnn {name} vs torch.nn.{cls.__name__} (cuDNN), "
          f"{RNN_BATCH}x{RNN_SEQ}, in {port_layer.input_size}, hidden "
          f"{port_layer.hidden_size}: worst max|d|/max|ref| {worst:.3e} "
          f"(tol {RNN_LAYER_TOL}; {gaps}); forward+backward ms: the "
          f"port's layer {ms:.2f} (uncaptured), cuDNN {cudnn:.3f}",
          flush=True)
    check(worst <= RNN_LAYER_TOL,
          f"char_rnn: the port's {name} differs from cuDNN's")
    return dict(worst=worst, port_ms=ms, cudnn_ms=cudnn)


def char_rnn_step_bound():
    """Least time (ms) of one training step: the matrix products' FLOPs
    (forward, and the backward's two products per product) at the fp32
    FMA rate, against the bytes (the ids in, the logits out, and the
    parameters and both Adam slots each read and written once)."""
    bt, h, e, v = RNN_BATCH * RNN_SEQ, RNN_HIDDEN, RNN_EMBED, RNN_VOCAB
    flops = 3 * (2 * bt * e * 4 * h + 2 * bt * h * 4 * h + 2 * bt * h * v)
    n_params = v * e + (e + h + 1) * 4 * h + h * v + v
    nbytes = 4 * (3 * 2 * n_params + bt * v) + 8 * 2 * bt
    t_ops, t_bytes = flops / PEAK_FLOPS["fp32"], nbytes / PEAK_BYTES_S
    return dict(flops=flops, bytes=nbytes, bound_ms=1e3 * max(t_ops,
                                                              t_bytes),
                bound_by="operations" if t_ops > t_bytes else "bytes")


def char_rnn_path(torch, fa, mp, card):
    """Char-RNN, the reference's judged LSTM configuration, at bench.py's
    full shape: the layers against cuDNN's, 6 captured Adam steps
    against the uncaptured twin (one capture), tokens/s captured and
    uncaptured in turns, the captured step's device ms beside its bound
    and cuDNN's LSTM, 30 steps on the built-in corpus, then the trainer
    at its own defaults. Reaches no kernel of the port (the reference's
    recurrence is a `lax.scan`, no Pallas site)."""
    from singa_tpu_torch import layer, opt
    from singa_tpu_torch.examples import char_rnn as trainer
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models import CharRNN
    from singa_tpu_torch.observability import metrics

    out = {}
    m = CharRNN(RNN_VOCAB, hidden_size=RNN_HIDDEN, embed_dim=RNN_EMBED,
                device="cuda")
    weights = char_rnn_weights(m, SEED)
    load_singa_tpu_params(m, weights)

    # the layers against cuDNN's (the path the original SINGA's CudnnRNN
    # took; a yardstick only, never called by the port)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    out["lstm_vs_cudnn"] = layer_vs_cudnn(torch, "LSTM", m.lstm,
                                          torch.nn.LSTM, SEED)
    gru = layer.GRU(RNN_HIDDEN, bidirectional=True, input_size=RNN_EMBED,
                    device="cuda", generator=gen)
    out["gru_bidir_vs_cudnn"] = layer_vs_cudnn(torch, "bidirectional GRU",
                                               gru, torch.nn.GRU, SEED + 1)
    rnn = layer.RNN(RNN_HIDDEN, nonlinearity="relu", input_size=RNN_EMBED,
                    device="cuda", generator=gen)
    out["rnn_relu_vs_cudnn"] = layer_vs_cudnn(torch, "relu RNN", rnn,
                                              torch.nn.RNN, SEED + 2)
    del gru, rnn

    # 6 captured steps against the uncaptured twin
    rng = np.random.default_rng(SEED + 2)
    seq = torch.from_numpy(rng.integers(0, RNN_VOCAB,
                                        (RNN_BATCH, RNN_SEQ + 1))).cuda()
    x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()

    def restore(use_graph):
        def put(model):
            load_singa_tpu_params(model, weights)
            model.set_optimizer(opt.Adam(lr=1e-3))
            model.compile([x], is_train=True, use_graph=use_graph)
        return put

    restore(True)(m)
    compiles = metrics.snapshot().get("graph_compiles", 0)
    losses, first_s, step_ms = captured_steps(torch, fa, mp, m, x, y,
                                              NO_LAUNCH, "char_rnn")
    compiles = metrics.snapshot()["graph_compiles"] - compiles
    check(compiles == 1 and m._train_step.captures == 1,
          f"char_rnn: {compiles} graph compiles over 6 steps, not 1")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "char_rnn: the loss is not finite or did not fall")
    twin_model = CharRNN(RNN_VOCAB, hidden_size=RNN_HIDDEN,
                         embed_dim=RNN_EMBED, device="cuda")
    out["twin"] = hold_twin(torch, "char_rnn", "fp32",
                            (losses, state_of(m), step_ms),
                            eager_twin(torch, twin_model, restore(False),
                                       x, y))
    out.update(losses=losses, first_step_s=first_s, graph_compiles=compiles)

    # tokens/s captured and uncaptured, in turns
    tokens = RNN_BATCH * RNN_SEQ
    rates = {True: [], False: []}
    for captured in (True, False, False, True):
        model = m if captured else twin_model
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            _, loss = model(x, y)
        loss.item()
        rates[captured].append(5 * tokens / (time.perf_counter() - t))
    on, off = (float(np.mean(rates[k])) for k in (True, False))
    step = cuda_ms(torch, lambda: m(x, y), iters=10, warmup=1)
    bound = char_rnn_step_bound()
    print(f"char_rnn {RNN_BATCH}x{RNN_SEQ}, hidden {RNN_HIDDEN}, Adam: "
          f"{on:.1f} tokens/s captured, {off:.1f} uncaptured (windows of "
          f"5 steps, in turns: {rates[True]} / {rates[False]}); captured "
          f"step {step:.3f} device ms (CUDA events), bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}: "
          f"{bound['flops'] / 1e9:.1f} GFLOP at the fp32 FMA rate, "
          f"{bound['bytes'] / 1e6:.1f} MB); cuDNN's LSTM forward+backward "
          f"{out['lstm_vs_cudnn']['cudnn_ms']:.3f} ms ({card})", flush=True)
    out.update(tokens_per_s_captured=on, tokens_per_s_uncaptured=off,
               windows=[rates[True], rates[False]], step_device_ms=step,
               cudnn_lstm_fwd_bwd_ms=out["lstm_vs_cudnn"]["cudnn_ms"],
               **bound)
    del twin_model

    # 30 captured steps on the built-in corpus: the loss falls
    text = trainer.load_corpus(None)
    chars = sorted(set(text))
    data = np.array([chars.index(c) for c in text])
    restore(True)(m)
    corpus_losses = []
    for _ in range(30):
        starts = rng.integers(0, len(data) - RNN_SEQ - 1, RNN_BATCH)
        xs = np.stack([data[s:s + RNN_SEQ + 1] for s in starts])
        xc = torch.from_numpy(xs).cuda()
        corpus_losses.append(m(xc[:, :-1], xc[:, 1:])[1].item())
    print(f"char_rnn on the built-in corpus (vocab {len(chars)} of "
          f"{RNN_VOCAB}): loss {corpus_losses[0]:.4f} -> "
          f"{corpus_losses[-1]:.4f} over 30 captured steps "
          f"({m._train_step.replays} replays)", flush=True)
    check(m._train_step.captures == 1 and m._train_step.replays == 29,
          "char_rnn: the corpus steps did not replay one graph")
    check(corpus_losses[-1] < corpus_losses[0],
          "char_rnn: the corpus loss did not fall")
    out["corpus_losses"] = corpus_losses
    m.graph(False)
    del m
    drop_graphs(torch)

    # the trainer at its own defaults (2 layers, hidden 256, seq 64,
    # batch 32), captured
    t = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.examples.char_rnn",
         "--steps", "60"], capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    print(run.stdout, flush=True)
    check(run.returncode == 0, f"the Char-RNN trainer failed: "
                               f"{run.stderr[-2000:]}")
    trained = [float(line.split("loss")[1]) for line in
               run.stdout.splitlines() if line.startswith("step")]
    sample = run.stdout.split("--- sample ---\n")[1]
    check(len(trained) == 3 and trained[-1] < trained[0] and len(
        sample) == len("the ") + 200 + 1,
        "the Char-RNN trainer's loss did not fall or it sampled no text")
    out["trainer"] = dict(losses=trained, wall_s=wall)
    return out


# -- the judged eager MLP, and sonnx ------------------------------------------

#: the MLP trainer's defaults (examples/mlp_mnist.py): batch 64, hidden 100
MLP_BATCH, MLP_HIDDEN = 64, 100
#: the reference's round-trip tolerances: ResNet-50's logits within 1e-3
#: of max|logit| (examples/onnx_zoo.py), BERT's outputs within 2e-3
#: absolute and relative (tests/test_sonnx.py)
RESNET_ONNX_TOL, BERT_ONNX_TOL = 1e-3, 2e-3
#: the imported ResNet-50's fine-tuning rate: ONNX's BatchNormalization
#: is the inference form, which leaves the random-weight net's gradient
#: unnormalised (a norm near 1e3), and SGD at 1e-2 or 3e-3 diverges
#: within 3 steps on the CPU at (8, 3, 224, 224); 1e-3 falls
SONNX_FINETUNE_LR = 1e-3


def mlp_epoch(torch, m, tx, ty, seed):
    """One epoch of m(x, y) steps over (tx, ty) on the card, the loss
    summed on the device; returns (steps, seconds, mean loss)."""
    from singa_tpu_torch.utils import data

    loss_sum = torch.zeros((), device="cuda")
    n = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    for bx, by in data.device_batches(tx, ty, MLP_BATCH, seed=seed):
        loss_sum += m(bx, by)[1]
        n += 1
    torch.cuda.synchronize()
    return n, time.perf_counter() - t, loss_sum.item() / n


def mlp_path(torch, fa, mp, card):
    """The judged eager MLP (`MLP(100, 10)`, SGD(lr 0.05, momentum 0.9,
    weight decay 1e-5), batch 64 on the synthetic MNIST set, seeded
    weights): eager epochs against captured ones in turns (steps/s,
    images/s, the captured step's device ms and its bound), 6 captured
    steps against the uncaptured twin at dropout 0, then the trainer at
    its defaults. Reaches no kernel of the port."""
    from singa_tpu_torch import opt, tensor
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models import MLP
    from singa_tpu_torch.utils import data

    xt, yt, _, _ = data.load_mnist()
    tx, ty = tensor.from_numpy(xt, "cuda"), tensor.from_numpy(yt, "cuda")
    weights = seeded_params(MLP(MLP_HIDDEN, 10, device="cuda"), SEED)

    def restore(use_graph, p=0.2):
        def put(m):
            load_singa_tpu_params(m, weights)
            m.dropout.p = p
            m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9,
                                    weight_decay=1e-5))
            m.compile([tx[:MLP_BATCH]], is_train=True, use_graph=use_graph)
        return put

    # eager (the judged mode) and captured, in turns after a warm epoch
    models = {}
    for mode in ("eager", "captured"):
        models[mode] = MLP(MLP_HIDDEN, 10, device="cuda")
        restore(mode == "captured")(models[mode])
        mlp_epoch(torch, models[mode], tx, ty, seed=0)
    rates = {"eager": [], "captured": []}
    losses = {"eager": [], "captured": []}
    for i, mode in enumerate(("eager", "captured", "captured", "eager")):
        n, s, loss = mlp_epoch(torch, models[mode], tx, ty, seed=i + 1)
        rates[mode].append(n / s)
        losses[mode].append(loss)
    check(all(np.isfinite(v) for vs in losses.values() for v in vs),
          f"mlp: a non-finite epoch loss {losses}")
    gs = models["captured"]._train_step
    check(gs is not None and gs.captures == 1,
          "mlp: the captured model did not capture its step once")
    entry = next(e for e in gs._cache.values() if hasattr(e, "graph"))
    dev = torch.device("cuda")
    step_ms = cuda_ms(torch, lambda: gs._on_stream(dev, entry.graph.replay),
                      iters=200, warmup=10)
    n_par = sum(p.numel() for p in models["eager"].parameters())
    flops = 6.0 * MLP_BATCH * n_par  # forward and backward products
    nbytes = 4.0 * (MLP_BATCH * (784 + 1) + 5 * n_par)  # batch; p, g, m
    bound_ms = max(flops / PEAK_FLOPS["fp32"], nbytes / PEAK_BYTES_S) * 1e3
    eager_sps = float(np.mean(rates["eager"]))
    captured_sps = float(np.mean(rates["captured"]))
    print(f"mlp ({card}): eager {eager_sps:.1f} steps/s "
          f"({eager_sps * MLP_BATCH:.0f} images/s), captured "
          f"{captured_sps:.1f} steps/s ({captured_sps * MLP_BATCH:.0f} "
          f"images/s) in turns {rates}; the captured step "
          f"{step_ms:.4f} device ms, bound {bound_ms:.5f} ms", flush=True)
    del models, gs, entry

    # 6 captured steps against the uncaptured twin, dropout 0
    m = MLP(MLP_HIDDEN, 10, device="cuda")
    restore(True, 0.0)(m)
    x, y = tx[:MLP_BATCH], ty[:MLP_BATCH]
    lc, _, ms_c = captured_steps(torch, fa, mp, m, x, y, NO_LAUNCH, "mlp")
    twin = hold_twin(torch, "mlp", "fp32", (lc, state_of(m), ms_c),
                     eager_twin(torch, m, restore(False, 0.0), x, y))
    del m
    drop_graphs(torch)

    # the trainer at its defaults (3 epochs, batch 64, eager)
    t = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.examples.mlp_mnist",
         "--epochs", "3"], capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t
    print(run.stdout, flush=True)
    check(run.returncode == 0, f"the MLP trainer failed: "
                               f"{run.stderr[-2000:]}")
    epochs = [line for line in run.stdout.splitlines()
              if line.startswith("epoch")]
    trained = [float(line.split("loss ")[1].split()[0]) for line in epochs]
    accs = [float(line.split("val_acc ")[1].split()[0]) for line in epochs]
    check(len(epochs) == 3 and trained[-1] < trained[0] and accs[-1] >= 0.5,
          f"the MLP trainer's loss did not fall or its last validation "
          f"accuracy is below 0.5: {trained} {accs}")
    return dict(eager_steps_s=eager_sps, captured_steps_s=captured_sps,
                eager_images_s=eager_sps * MLP_BATCH,
                captured_images_s=captured_sps * MLP_BATCH,
                rates=rates, epoch_losses=losses,
                captured_step_device_ms=step_ms, step_bound_ms=bound_ms,
                twin=twin, trainer=dict(losses=trained, val_acc=accs,
                                        wall_s=wall))


def f7_path(torch, card):
    """F7: a parameter object replaced between captured steps. The MLP
    (seeded weights, SGD with momentum, batch 64) takes 3 captured
    steps (uncaptured, capture, replay); then `fc2.W` is replaced by a
    new `nn.Parameter` of other values and 2 more steps run. Returns
    whether the new tensor moved, whether the old one stayed bitwise,
    and the `graph_compiles` and captures those 2 steps added; the
    caller holds them."""
    from torch import nn

    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models import MLP
    from singa_tpu_torch.observability import metrics

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.randn((MLP_BATCH, 784), generator=gen, device="cuda")
    y = torch.arange(MLP_BATCH, device="cuda") % 10
    m = MLP(MLP_HIDDEN, 10, device="cuda")
    load_singa_tpu_params(m, seeded_params(m, SEED))
    m.dropout.p = 0.0
    m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9))
    m.compile([x], is_train=True, use_graph=True)
    for _ in range(3):
        m(x, y)
    gs = m._train_step
    old = m.fc2.W
    new = nn.Parameter(torch.randn(old.shape, generator=gen,
                                   device="cuda") * 0.1)
    old0, new0 = old.detach().clone(), new.detach().clone()
    compiles = metrics.snapshot().get("graph_compiles", 0)
    captures = gs.captures
    m.fc2.W = new
    for _ in range(2):
        m(x, y)
    torch.cuda.synchronize()
    out = dict(new_moved=not torch.equal(m.fc2.W, new0),
               new_is_the_layers=m.fc2.W is new,
               old_bitwise=torch.equal(old, old0),
               graph_compiles_added=metrics.snapshot().get(
                   "graph_compiles", 0) - compiles,
               captures_added=gs.captures - captures,
               replays=gs.replays)
    print(f"f7 ({card}): after fc2.W is replaced, 2 captured steps: "
          f"{out}", flush=True)
    del m, gs
    drop_graphs(torch)
    return out


#: phase 9g: the new layers' limit against their CPU outputs
LAYER_TOL = 1e-5


def layers_path(torch, card):
    """The layers this slice adds run on the card and equal their CPU
    outputs on the same seeded weights and inputs within LAYER_TOL of
    each output's max|value| (TF32 off; only the summation order
    differs): `LeakyReLU`, `Sigmoid`, `SoftMax`, `Cat`, `Add` and a
    stride-2 `SeparableConv2d(padding="same")`, in NHWC."""
    import copy

    from singa_tpu_torch import layer, layout

    gen = torch.Generator().manual_seed(SEED)
    a = torch.randn((8, 32, 57, 57), generator=gen)
    b = torch.randn((8, 32, 57, 57), generator=gen)
    cases = {
        "leakyrelu": (layer.LeakyReLU(0.1), (a,)),
        "sigmoid": (layer.Sigmoid(), (a,)),
        "softmax": (layer.SoftMax(1), (a,)),
        "cat": (layer.Cat(1), (a, b)),
        "add": (layer.Add(), (a, b)),
        "separable_same_s2": (layer.SeparableConv2d(
            64, 3, stride=2, padding="same", in_channels=32, device="cpu",
            generator=torch.Generator().manual_seed(SEED)), (a,)),
    }
    out = {}
    with layout.use_image_layout("NHWC"), torch.no_grad():
        for name, (lyr, xs) in cases.items():
            xs = [layout.from_nchw(v) for v in xs]
            want = lyr(*xs)
            got = copy.deepcopy(lyr).to("cuda")(*[v.cuda() for v in xs])
            err = (got.cpu() - want).abs().max().item()
            rel = err / max(want.abs().max().item(), 1e-30)
            out[name] = dict(shape=list(got.shape), max_abs_err=err,
                             rel_err=rel)
            check(tuple(got.shape) == tuple(want.shape) and rel <= LAYER_TOL,
                  f"layer {name} on the card differs from its CPU output: "
                  f"{out[name]}")
    print(f"new layers on the card vs the CPU ({card}, tol {LAYER_TOL}): "
          + json.dumps(out), flush=True)
    return out


def cifar_trainer(torch, model, card):
    """`python -m singa_tpu_torch.examples.cnn_cifar10 --model <model>
    --epochs 2 --loader sync` at its defaults (NHWC, batch 128, the
    synthetic CIFAR set of 2048 images when none is on disk; the sync
    loader's order, as before the prefetcher became the default): exit 0
    and "loss sanity: ... ok"."""
    t = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.examples.cnn_cifar10",
         "--model", model, "--epochs", "2", "--loader", "sync"],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    print(run.stdout, flush=True)
    check(run.returncode == 0, f"cnn_cifar10 --model {model} failed: "
                               f"{run.stderr[-2000:]}")
    sanity = [line for line in run.stdout.splitlines()
              if line.startswith("loss sanity:")]
    check(len(sanity) == 1 and sanity[0].endswith("ok"),
          f"cnn_cifar10 --model {model}: no 'loss sanity: ... ok' line")
    epochs = [line for line in run.stdout.splitlines()
              if line.startswith("epoch")]
    print(f"cnn_cifar10 --model {model} ({card}): {wall:.1f} s", flush=True)
    return dict(wall_s=wall, sanity=sanity[0], epochs=epochs)


def mobile_path(torch, fa, mp, card):
    """Phase 9g: F7 on the card, the new layers, MobileNetV1 and Xception
    at full width (`cnn_path`), both CIFAR trainers, and MobileNetV1's
    ONNX round trip on the card. Returns Xception's counted-step
    launches and the numbers."""
    from singa_tpu_torch.models.mobilenet import mobilenet_v1
    from singa_tpu_torch.models.xception import xception

    out = {}
    f7 = out["f7"] = f7_path(torch, card)
    check(f7["new_moved"] and f7["new_is_the_layers"] and f7["old_bitwise"]
          and f7["graph_compiles_added"] == 1 and f7["captures_added"] == 1,
          f"F7: after a parameter object was replaced, the captured steps "
          f"did not train the new tensor alone in one new capture: {f7}")
    out["layers"] = layers_path(torch, card)

    reset_counts(fa, mp)
    launches, out["mobilenet_v1"] = cnn_path(
        torch, fa, mp, "mobilenet_v1", mobilenet_v1, NO_LAUNCH,
        MOBILE_BATCH, card)
    check(launches == NO_LAUNCH, f"mobilenet_v1 launched {launches}")
    reset_counts(fa, mp)
    xception_launches, out["xception"] = cnn_path(
        torch, fa, mp, "xception", xception,
        dict(NO_LAUNCH, max_pool_bwd=4), XCEPTION_BATCH, card, window=3)

    out["trainers"] = {name: cifar_trainer(torch, name, card)
                       for name in ("mobilenet", "xception")}

    # sonnx: MobileNetV1 (grouped Convs) exported and imported on the card
    from singa_tpu_torch.model import load_singa_tpu_states

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    src = mobilenet_v1(1000, device="cuda")
    load_singa_tpu_states(src, cnn_states(
        {n: t.shape for n, t in [*src.named_parameters(),
                                 *src.named_buffers()]}, SEED))
    src.set_image_layout("NHWC")
    x = torch.randn((8, 3, 224, 224), generator=gen, device="cuda")
    calibrate_bn(torch, src, x)
    with torch.no_grad():
        want = src(x)
    _, got, nums = onnx_round_trip(torch, fa, mp, src, [x], "mobilenet_v1")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    nums.update(max_abs_err=err, max_abs_logit=scale)
    print(f"sonnx mobilenet_v1: imported vs source logits max|d| "
          f"{err:.3e}, max|logit| {scale:.3e} (tol {RESNET_ONNX_TOL} of "
          f"it)", flush=True)
    check(tuple(got.shape) == (8, 1000) and bool(torch.isfinite(got).all())
          and err <= RESNET_ONNX_TOL * scale,
          "the imported MobileNetV1 disagrees with its source")
    out["sonnx_mobilenet_v1"] = nums
    del src, want, got
    drop_graphs(torch)
    return xception_launches, out


def calibrate_bn(torch, m, x):
    """Set every BatchNorm's running statistics to the batch statistics
    of its input on `x` (one forward in training mode at momentum 0), as
    a trained model's match its data; then eval mode."""
    from singa_tpu_torch import layer

    bns = [b for b in m.modules() if isinstance(b, layer.BatchNorm2d)]
    saved = [b.momentum for b in bns]
    for b in bns:
        b.momentum = 0.0
    m.train()
    with torch.no_grad():
        m.forward(x)
    for b, mom in zip(bns, saved):
        b.momentum = mom
    m.eval()


def onnx_round_trip(torch, fa, mp, src, inputs, what):
    """Export `src` on `inputs` (the export's kernel launches counted
    alone), encode, import on the card (`sonnx.prepare`), and run the
    imported graph twice; returns (the imported SONNXModel, its
    outputs, the numbers)."""
    from singa_tpu_torch import sonnx

    torch.cuda.synchronize()
    reset_counts(fa, mp)
    t = time.perf_counter()
    pb = sonnx.to_onnx(src, inputs)
    export_launches = counts(fa, mp)
    blob = sonnx.proto.encode_model(pb)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    imported = sonnx.prepare(blob, device="cuda").model
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    run_ms = []
    with torch.no_grad():
        for _ in range(2):  # the first run reads the statics
            t = time.perf_counter()
            got = imported(*inputs)
            torch.cuda.synchronize()
            run_ms.append(1e3 * (time.perf_counter() - t))
        imported_ms = cuda_ms(torch, lambda: imported(*inputs), iters=5,
                              warmup=1)
        source_ms = cuda_ms(torch, lambda: src(*inputs), iters=5, warmup=1)
    nums = dict(export_s=export_s, export_launches=export_launches,
                bytes=len(blob),
                nodes=len(pb.graph.node),
                initializers=len(pb.graph.initializer), load_s=load_s,
                first_run_ms=run_ms[0], second_run_ms=run_ms[1],
                imported_forward_ms=imported_ms,
                source_forward_ms=source_ms)
    print(f"sonnx {what}: export {export_s:.2f} s, {len(blob)} bytes, "
          f"{nums['nodes']} nodes, launches {export_launches}; load "
          f"{load_s:.2f} s; runs "
          f"{run_ms[0]:.1f} ms (records statics), {run_ms[1]:.1f} ms; "
          f"forward imported {imported_ms:.2f} ms vs source "
          f"{source_ms:.2f} ms", flush=True)
    return imported, got, nums


def sonnx_path(torch, fa, mp, card):
    """sonnx at full width: ResNet-50 (NHWC, seeded states with
    calibrated BatchNorm statistics, batch 8 at 224^2) exported, imported
    on the card and held to the source's eval forward within 1e-3 of
    max|logit|, then 3 captured SGD steps of the imported model (loss
    falls, BatchNorm buffers bitwise unmoved); BERT-base at 2 x 512 in
    eval mode, whose export trace must launch the fused forward kernel
    12 times, held within 2e-3. Returns the export's launches and the
    numbers."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import (load_singa_tpu_params,
                                       load_singa_tpu_states)
    from singa_tpu_torch.models.resnet import resnet50
    from singa_tpu_torch.models.transformer import bert_base

    out = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    src = resnet50(num_classes=1000, device="cuda")
    load_singa_tpu_states(src, cnn_states(
        {n: t.shape for n, t in [*src.named_parameters(),
                                 *src.named_buffers()]}, SEED))
    src.set_image_layout("NHWC")
    x = torch.randn((8, 3, 224, 224), generator=gen, device="cuda")
    calibrate_bn(torch, src, x)
    with torch.no_grad():
        want = src(x)
    imported, got, out["resnet50"] = onnx_round_trip(torch, fa, mp, src,
                                                     [x], "resnet50")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    out["resnet50"].update(max_abs_err=err, max_abs_logit=scale)
    print(f"sonnx resnet50: imported vs source logits max|d| {err:.3e}, "
          f"max|logit| {scale:.3e} (tol {RESNET_ONNX_TOL} of it)",
          flush=True)
    check(tuple(got.shape) == (8, 1000) and bool(torch.isfinite(got).all())
          and err <= RESNET_ONNX_TOL * scale,
          "the imported ResNet-50 disagrees with its source")
    del src, want, got

    # fine-tune the imported graph, captured: step 1 uncaptured
    y = torch.randint(0, 1000, (8,), generator=gen, device="cuda")
    buffers = {k: v.clone() for k, v in imported.get_buffers().items()}
    params = {k: v.detach().clone()
              for k, v in imported.get_params().items()}
    imported.set_optimizer(opt.SGD(lr=SONNX_FINETUNE_LR))
    imported.compile([x], is_train=True, use_graph=True)
    losses, _ = run_steps(torch, imported, x, y, 3)
    gs = imported._train_step
    moved = sum(not torch.equal(imported.get_params()[k], v)
                for k, v in params.items())
    still = all(torch.equal(imported.get_buffers()[k], v)
                for k, v in buffers.items())
    print(f"sonnx resnet50 fine-tune: losses {losses}, {gs.captures} "
          f"capture, {gs.replays} replays, {moved} of {len(params)} "
          f"parameters moved, {len(buffers)} buffers bitwise unmoved: "
          f"{still}", flush=True)
    check(gs.captures == 1 and gs.replays == 2,
          "sonnx: the imported model's steps were not captured once")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "sonnx: the imported ResNet-50's loss did not fall")
    check(still and moved == len(params),
          "sonnx: fine-tuning moved a buffer or left a parameter")
    out["resnet50"].update(finetune_losses=losses, params_moved=moved,
                           buffers=len(buffers), buffers_unmoved=still)
    del imported, gs, buffers, params
    drop_graphs(torch)

    # BERT-base, eval mode: the export trace runs the fused kernel
    bert = bert_base(device="cuda")
    load_singa_tpu_params(bert, seeded_params(bert, SEED))
    bert.eval()
    ids = torch.randint(0, bert.tok.table.shape[0], (2, 512), generator=gen,
                        device="cuda")
    with torch.no_grad():
        want = bert(ids)
    imported, got, out["bert_base"] = onnx_round_trip(
        torch, fa, mp, bert, [ids], "bert_base")
    launches = out["bert_base"]["export_launches"]
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    ok = all(bool(((g - w).abs() <= BERT_ONNX_TOL * (1 + w.abs())).all())
             for g, w in zip(got, want))
    out["bert_base"].update(max_abs_err_seq=errs[0],
                            max_abs_err_pooled=errs[1])
    print(f"sonnx bert_base: imported vs source max|d| seq {errs[0]:.3e}, "
          f"pooled {errs[1]:.3e} (tol {BERT_ONNX_TOL} abs and rel)",
          flush=True)
    check(ok, "the imported BERT-base disagrees with its source")
    check(launches == dict(NO_LAUNCH, flash_fwd=12)
          and out["resnet50"]["export_launches"] == NO_LAUNCH,
          f"sonnx: the BERT-base export launched {launches}, not the "
          f"fused forward kernel 12 times (ResNet-50's: "
          f"{out['resnet50']['export_launches']})")
    del bert, imported, got, want
    drop_graphs(torch)
    return launches, out


# -- 9e. DistOpt ResNet-50 over a world-1 NCCL group ---------------------------

DIST_OPTIONS = ("plain", "half", "sparse-topk", "sparse-thresh")
DIST_BATCH = 32  # dist_imagenet's --batch-per-chip default
#: the world-1 DistOpt step against the wrapped SGD's: bitwise, or within
#: this of each tensor's size when only the BN moments' reduction differs
DIST_VS_SGD_TOL = 1e-6


def graph_ms(torch, fn, iters=20):
    """Device ms of fn()'s work alone: fn is run once uncaptured (its
    warm-up, NCCL's communicator included), captured as one CUDA Graph on
    a private stream, and the graph's replays are timed by CUDA events,
    so the host's launches between its kernels do not count."""
    from singa_tpu_torch.graph import private_stream

    side = private_stream(fn, torch.device("cuda"))
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side, capture_error_mode="thread_local"):
        fn()
    return cuda_ms(torch, g.replay, iters=iters, warmup=2)


def sync_timings(torch, comm, grads, step_ms, card):
    """Device ms of the DistOpt sync's device work on `grads` (ResNet-50's
    gradient set, fp32), each captured alone and timed over its replays
    (`graph_ms`), beside its bytes bound at PEAK_BYTES_S (each input
    read once, each output written once) and the captured step's ms."""
    import torch.distributed as tdist

    from singa_tpu_torch.communicator import plan_buckets

    n = sum(g.numel() for g in grads)
    sizes = [g.numel() for g in grads]
    buckets = plan_buckets(sizes, 2 ** 21)
    flats = [torch.cat([grads[i].reshape(-1) for i in b]) for b in buckets]
    out = {"elements": n, "buckets": len(buckets), "step_ms": step_ms}

    def row(name, fn, nbytes, iters=20):
        ms = graph_ms(torch, fn, iters=iters)
        bound = nbytes / PEAK_BYTES_S * 1e3
        out[name] = dict(ms=ms, bound_ms=bound, bytes=nbytes,
                         share_of_step=ms / step_ms if step_ms else None)
        print(f"dist sync {name}: {ms:.3f} ms, bytes bound {bound:.3f} ms "
              f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), {ms / step_ms:.1%} of "
              f"the {step_ms:.2f} ms captured step ({card})", flush=True)

    def pack():
        for b in buckets:
            torch.cat([grads[i].reshape(-1) for i in b])

    def unpack():
        for b, flat in zip(buckets, flats):
            for i, part in zip(b, flat.split([sizes[i] for i in b])):
                grads[i].copy_(part.view(grads[i].shape))

    def nccl():
        for flat in flats:
            tdist.all_reduce(flat, group=comm.group)

    row("bucket_pack", pack, 8 * n)
    row("bucket_unpack_copy", unpack, 8 * n)
    row("nccl_all_reduce_world1", nccl, 8 * n)
    row("fused_all_reduce", lambda: comm.fused_all_reduce(grads), 16 * n)
    row("bf16_cast_round_trip", lambda: [g.to(torch.bfloat16).to(g.dtype)
                                         for g in grads], 12 * n)
    row("all_reduce_half", lambda: [comm.all_reduce_half(g) for g in grads],
        12 * n)
    k = sum(max(1, -(-s * 5 // 100)) for s in sizes)
    row("topk_spars_0.05", lambda: [torch.topk(g.reshape(-1).abs(),
                                               max(1, -(-g.numel() * 5
                                                          // 100)))
                                    for g in grads], 4 * n + 12 * k, 5)
    row("sparse_all_reduce_topk_0.05",
        lambda: [comm.sparse_all_reduce(g, spars=0.05, return_local=True)
                 for g in grads], 12 * n, 5)
    return out


def planner_check(what, sizes, cap, calls_before, card):
    """The native bucket planner (`native/comm_core.cc`) on a phase's
    path: the phase called into it since `calls_before`, and its buckets
    over the model's parameter sizes at `cap` elements equal the plain
    planner's. Times one plan, native and Python, in turns (host
    microseconds: the planner runs on the host)."""
    from singa_tpu_torch import native
    from singa_tpu_torch.communicator import plan_buckets, plan_buckets_plain

    calls = native.native_call_count() - calls_before
    buckets = plan_buckets(sizes, cap)
    check(calls > 0, f"{what}: no call into the native bucket planner")
    check(buckets == plan_buckets_plain(sizes, cap),
          f"{what}: the native buckets differ from the plain planner's")

    def us(fn, n=500):
        t = time.perf_counter()
        for _ in range(n):
            fn(sizes, cap)
        return 1e6 * (time.perf_counter() - t) / n

    turns = [us(plan_buckets), us(plan_buckets_plain),
             us(plan_buckets_plain), us(plan_buckets)]
    native_us, plain_us = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    print(f"{what}: the native bucket planner ran {calls} time(s) on the "
          f"phase's path; {len(buckets)} buckets over {len(sizes)} "
          f"parameters ({sum(sizes)} elements) at {cap} elements, equal to "
          f"the plain planner's; one plan {native_us:.1f} us native, "
          f"{plain_us:.1f} us Python (host clock, in turns; {card})",
          flush=True)
    return dict(calls=calls, buckets=len(buckets), params=len(sizes),
                native_us=native_us, plain_us=plain_us)


def comm_world1(torch, comm):
    """Every Communicator method over the world-1 NCCL group gives what a
    world of one must: its input (bf16-rounded on the half wire), and
    for the sparse sync its own selection."""
    x = torch.linspace(-2.0, 2.0, 48, device="cuda").reshape(12, 4)
    half = x.to(torch.bfloat16).to(x.dtype)
    dense, local, dropped = comm.sparse_all_reduce(
        x, spars=0.25, return_local=True, return_stats=True)
    got = {
        "all_reduce": (comm.all_reduce(x), x),
        "all_reduce_sum": (comm.all_reduce(x, average=False), x),
        "all_reduce_half": (comm.all_reduce_half(x), half),
        "all_gather": (comm.all_gather(x), x),
        "reduce_scatter": (comm.reduce_scatter(x), x),
        "reduce_scatter_half": (comm.reduce_scatter_half(x), half),
        "all_gather_half": (comm.all_gather_half(x), half),
        "broadcast": (comm.broadcast(x), x),
        "fused_all_reduce": (torch.cat([t.reshape(-1) for t in
                                        comm.fused_all_reduce(
                                            [x, x[:3]], bucket_elems=20)]),
                             torch.cat([x.reshape(-1), x[:3].reshape(-1)])),
        "reduce_scatter_buckets": (comm.reduce_scatter_buckets([x])[0], x),
        "all_gather_buckets": (comm.all_gather_buckets([x])[0], x),
        "sparse_all_reduce": (dense, local),
    }
    bad = [k for k, (g, w) in got.items() if not torch.equal(g, w)]
    kept = int((local != 0).sum())
    print(f"dist communicator over NCCL at world 1: {len(got)} methods, "
          f"mismatched {bad}; the top-k kept {kept} of 48 (12 expected), "
          f"dropped {float(dropped)}", flush=True)
    check(not bad and kept == 12 and float(dropped) == 0.0,
          f"Communicator methods over NCCL at world 1 gave {bad}")
    return sorted(got)


def dist_path(torch, fa, mp, card):
    """DistOpt ResNet-50 (judged configuration 5) on one card over a
    world-1 NCCL group, with the max-pool kernel switched on: the
    trainer at its defaults under every --dist-option, the world-1 plain
    step against the wrapped SGD's, 6 captured DistOpt steps counted and
    held against their uncaptured twin, and the sync's device work
    timed. Returns the counted step's launches and the numbers."""
    import torch.distributed as tdist

    from singa_tpu_torch import distributed, native, opt
    from singa_tpu_torch.communicator import Communicator
    from singa_tpu_torch.examples import dist_imagenet
    from singa_tpu_torch.model import load_singa_tpu_states
    from singa_tpu_torch.models.resnet import resnet50

    distributed.init(device="cuda")
    check(tdist.get_backend() == "nccl" and tdist.get_world_size() == 1,
          f"the group is {tdist.get_backend()} at world "
          f"{tdist.get_world_size()}, not NCCL at 1")
    mp.set_pool_kernel_enabled(True)
    out = {"card": card, "trainer": {}}
    calls0 = native.native_call_count()
    try:
        out["communicator_methods"] = comm_world1(
            torch, Communicator(distributed.global_mesh()))

        # the trainer at its defaults (batch 32 a chip at 224 x 224,
        # resnet50(1000), NHWC, fp32, SGD + Warmup + clip 10,
        # buffSize 2**21, use_graph), 6 steps under each option
        for option in DIST_OPTIONS:
            reset_counts(fa, mp)
            t = time.perf_counter()
            res = dist_imagenet.run(dist_imagenet.parser().parse_args(
                ["--steps", "6", "--dist-option", option,
                 "--loader", "sync", "--device", "cuda"]))
            launched = counts(fa, mp)
            gs = res["model"]._train_step
            print(f"dist_imagenet --dist-option {option}: losses "
                  f"{[round(v, 4) for v in res['losses']]}, "
                  f"{res['img_s_chip']:.1f} images/s/chip ({card}), "
                  f"{time.perf_counter() - t:.1f} s; launches {launched}, "
                  f"captures {gs.captures}, replays {gs.replays}",
                  flush=True)
            check(res["ok"] is True, f"dist_imagenet {option}: the loss "
                                     f"sanity check failed")
            check(launched == dict(NO_LAUNCH, max_pool_bwd=2)
                  and (gs.captures, gs.replays) == (1, 5),
                  f"dist_imagenet {option}: K2a was not launched once in "
                  f"the uncaptured step and once in the capture, or the "
                  f"step was not captured once and replayed 5 times")
            out["trainer"][option] = dict(
                losses=res["losses"], images_per_s_chip=res["img_s_chip"],
                launches=launched)
            del res, gs
            drop_graphs(torch)

        # the same model, seeded, stepped by DistOpt and by its SGD
        m = resnet50(num_classes=1000, device="cuda")
        m.set_image_layout("NHWC")
        states = cnn_states({n: t.shape for n, t in m.get_states().items()},
                            SEED)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        x = torch.randn((DIST_BATCH, 3, 224, 224), generator=gen,
                        device="cuda")
        y = torch.arange(DIST_BATCH, device="cuda") % 1000
        mesh = distributed.global_mesh()

        def restore(kind, use_graph):
            def put(model):
                load_singa_tpu_states(model, states)
                sgd = opt.SGD(lr=opt.Warmup(0.0125, 10), momentum=0.9,
                              weight_decay=1e-4, clip_norm=10.0)
                model.set_optimizer(opt.DistOpt(sgd, mesh=mesh)
                                    if kind == "dist" else sgd)
                model.compile([x], is_train=True, use_graph=use_graph)
            return put

        torch.backends.cudnn.deterministic = True
        after, replay_ms = {}, {}
        for kind in ("sgd", "dist"):
            restore(kind, True)(m)
            run_steps(torch, m, x, y, 3)
            after[kind] = state_of(m)
            replay_ms[kind] = run_steps(torch, m, x, y, 4)[1]
            drop_graphs(torch)
        print(f"dist resnet50 captured step ms ({card}), 4 replays: "
              f"DistOpt {replay_ms['dist']:.2f}, plain SGD "
              f"{replay_ms['sgd']:.2f}", flush=True)
        out["replay_ms"] = replay_ms
        gap = max((after["dist"][n] - after["sgd"][n]).abs().max().item()
                  / max(after["sgd"][n].abs().max().item(), 1e-30)
                  for n in after["sgd"])
        bitwise = all(torch.equal(after["dist"][n], after["sgd"][n])
                      for n in after["sgd"])
        print(f"dist resnet50: world-1 DistOpt plain vs SGD after 3 "
              f"captured steps: bitwise equal {bitwise}, max|d|/max|p| "
              f"{gap:.3e} over {len(after['sgd'])} tensors (tol "
              f"{DIST_VS_SGD_TOL} if not bitwise)", flush=True)
        check(bitwise or gap <= DIST_VS_SGD_TOL,
              "the world-1 DistOpt step differs from the plain SGD step")
        out["vs_sgd"] = dict(bitwise=bitwise, max_rel=gap)
        del after

        # 6 captured DistOpt steps, counted, against the uncaptured twin
        launches = dict(NO_LAUNCH, max_pool_bwd=1)
        restore("dist", True)(m)
        losses, first_s, step_ms = captured_steps(
            torch, fa, mp, m, x, y, launches,
            "dist resnet50 fp32 (deterministic)")
        check(all(np.isfinite(losses)), "non-finite DistOpt loss")
        out["twin"] = hold_twin(
            torch, "dist resnet50 (deterministic cuDNN)", "fp32",
            (losses, state_of(m), step_ms),
            eager_twin(torch, m, restore("dist", False), x, y))
        sgd_eager = eager_twin(torch, m, restore("sgd", False), x, y)[2]
        print(f"dist resnet50 step ms ({card}): DistOpt captured "
              f"{step_ms:.2f}, uncaptured {out['twin']['step_ms_uncaptured']:.2f}"
              f" (about 160 small NCCL calls a step: 53 BatchNorm moments "
              f"forward and back, the gradient buckets, the buffers); "
              f"plain SGD uncaptured {sgd_eager:.2f}", flush=True)
        torch.backends.cudnn.deterministic = False
        out.update(losses=losses, first_step_s=first_s, step_ms=step_ms,
                   sgd_step_ms_uncaptured=sgd_eager)

        # the sync's device work on the real gradient set
        grads = [torch.randn(p.shape, generator=gen, device="cuda")
                 for p in m.parameters()]
        out["sync"] = sync_timings(torch, Communicator(mesh), grads,
                                   step_ms, card)
        out["planner"] = planner_check(
            "dist resnet50", [p.numel() for p in m.parameters()], 2 ** 21,
            calls0, card)
        m.graph(False)
        del m, grads
    finally:
        torch.backends.cudnn.deterministic = False
        mp.set_pool_kernel_enabled(False)
        distributed.shutdown()
        drop_graphs(torch)
    return launches, out


# -- 9f. ZeRO-1 gpt_medium over a world-1 NCCL group ---------------------------

#: the equality runs: name -> (DistOpt keywords, None for the bare AdamW;
#: the dist_option the step takes)
ZERO1_RUNS = {
    "adamw": (None, "plain"),
    "distopt": ({}, "plain"),
    "zero1": (dict(shard_states=True), "plain"),
    "overlap": (dict(shard_states=True, overlap=True, buffSize=2 ** 21),
                "plain"),
    "distopt_half": ({}, "half"),
    "half_wire": (dict(shard_states=True, half_wire=True), "plain"),
    "gather_half": (dict(shard_states=True, gather_half=True), "plain"),
}
#: (run, the run it is held to): after 3 captured steps, each parameter
#: within TWIN_TOL["fp32"] of its max|p| (bitwise is expected at world 1:
#: the same elementwise update on the same gradients), each loss alike
ZERO1_PAIRS = (("zero1", "distopt"), ("zero1", "adamw"),
               ("overlap", "distopt"), ("overlap", "adamw"),
               ("half_wire", "distopt_half"))
ZERO1_LR = 3e-4
ZERO1_DROPOUT = (0.0, 0.1)
#: gpt_lm --shard-states at gpt_medium's widths (the flash kernels run),
#: at the phase's AdamW lr (the trainer's default 3e-3 suits its small
#: default model)
ZERO1_TRAINER_WIDE = ["--d-model", "1024", "--layers", "12", "--heads",
                      "8", "--seq", "1024", "--batch", "4", "--steps", "20",
                      "--lr", "3e-4"]


def set_dropout(model, p):
    """Every dropout layer of `model` at rate p."""
    from singa_tpu_torch import layer

    for mod in model.modules():
        if isinstance(mod, layer.Dropout):
            mod.p = p


def params_gap(torch, a, b):
    """max over tensors of max|a - b| / max|b|, and whether all equal."""
    gap = max((a[n].float() - b[n].float()).abs().max().item()
              / max(b[n].float().abs().max().item(), 1e-30) for n in b)
    return gap, all(torch.equal(a[n], b[n]) for n in b)


def zero1_sync_timings(torch, comm, model, step_ms, card):
    """Device ms of the ZeRO-1 sync's parts on gpt_medium's parameter
    and gradient set (seeded scratch tensors of the parameters' shapes,
    fp32), each captured alone and timed over replays (`graph_ms`),
    beside its bytes bound at PEAK_BYTES_S (each input read once, each
    output written once) and the captured ZeRO-1 step."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.communicator import (_all_gather_into_tensor,
                                              _reduce_scatter_tensor)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = {n: torch.randn(p.shape, generator=gen, device="cuda")
              for n, p in model.named_parameters()}
    grads = [torch.randn(p.shape, generator=gen, device="cuda")
             for p in params.values()]
    d = opt.DistOpt(opt.AdamW(lr=ZERO1_LR), mesh=comm.mesh,
                    shard_states=True)
    d.prepare(params)
    bare = opt.AdamW(lr=ZERO1_LR)
    bare.prepare(params)
    dev, sizes = torch.device("cuda"), d._z_sizes
    n = sum(sizes)
    flat = d._z_segments(d._z_flat(grads, dev, sizes), 1)[0]
    shard, full = torch.empty_like(flat), torch.empty_like(flat)
    out = {"elements": n, "step_ms": step_ms}

    def row(name, fn, nbytes):
        ms = graph_ms(torch, fn)
        bound = nbytes / PEAK_BYTES_S * 1e3
        out[name] = dict(ms=ms, bound_ms=bound, bytes=nbytes,
                         share_of_step=ms / step_ms)
        print(f"zero1 sync {name}: {ms:.3f} ms, bytes bound {bound:.3f} ms "
              f"({nbytes / 1e9:.2f} GB at 3.35 TB/s), {ms / step_ms:.1%} of "
              f"the {step_ms:.2f} ms captured ZeRO-1 step ({card})",
              flush=True)

    def write_back():
        off = 0
        for p, k in zip(params.values(), sizes):
            p.copy_(full[off:off + k].view(p.shape))
            off += k

    def per_param_update():
        for p, g in zip(params.values(), grads):
            bare.update(p, g)

    row("grad_flatten_pad",
        lambda: d._z_segments(d._z_flat(grads, dev, sizes), 1), 8 * n)
    row("param_flatten", lambda: d._z_shard(
        d._z_flat(list(params.values()), dev), 1, 0), 8 * n)
    row("nccl_reduce_scatter_tensor_world1",
        lambda: _reduce_scatter_tensor(shard, flat, group=comm.group), 8 * n)
    row("reduce_scatter_mean", lambda: comm.reduce_scatter(flat), 8 * n)
    # AdamW reads p, g, m, v and writes p, m, v
    row("flat_adamw_update", lambda: d.opt.update(d._z_proxy, flat[None]),
        28 * n)
    row("per_parameter_adamw_update", per_param_update, 28 * n)
    row("nccl_all_gather_into_tensor_world1",
        lambda: _all_gather_into_tensor(full, shard, group=comm.group),
        8 * n)
    row("write_back", write_back, 8 * n)
    return out


def zero1_path(torch, fa, mp, card):
    """ZeRO-1 (`DistOpt(shard_states=True)`) trains gpt_medium's unrolled
    decoder over a world-1 NCCL group: the equalities against plain
    DistOpt and bare AdamW (and of each wire option) over 3 captured
    steps at dropout 0 and 0.1, 6 captured steps counted and held
    against their uncaptured twin in fp32 and bf16, rank 1's dropout
    stream under capture, the steps' times in turns, the sync's parts
    timed, the slot bytes, and `gpt_lm --shard-states` twice. Returns
    the counted step's launches and the numbers."""
    import torch.distributed as tdist

    from singa_tpu_torch import autograd, distributed, native, opt
    from singa_tpu_torch.communicator import Communicator
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium

    calls0 = native.native_call_count()
    distributed.init(device="cuda")
    check(tdist.get_backend() == "nccl" and tdist.get_world_size() == 1,
          f"the group is {tdist.get_backend()} at world "
          f"{tdist.get_world_size()}, not NCCL at 1")
    out = {"card": card, "equalities": {}}
    per_step = dict(NO_LAUNCH, flash_fwd=12, flash_bwd_dq=12,
                    flash_bwd_dkv=12)
    try:
        m = gpt_medium(scan_blocks=False, dropout=0.0, device="cuda")
        load_singa_tpu_params(m, seeded_params(m, SEED))
        start = state_of(m)
        rng = np.random.default_rng(SEED)
        seq = torch.from_numpy(rng.integers(0, m.vocab_size,
                                            (4, 1025))).cuda()
        x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
        mesh = distributed.global_mesh()

        def restore(kw, p=0.0, precision="fp32", use_graph=True,
                    lr=ZERO1_LR):
            def put(model):
                with torch.no_grad():
                    for name, t in model.named_parameters():
                        t.copy_(start[name])
                set_dropout(model, p)
                torch.manual_seed(SEED)  # the same dropout draws each run
                base = opt.AdamW(lr=lr)
                model.set_optimizer(base if kw is None else opt.DistOpt(
                    base, mesh=mesh, **kw))
                model.compile([x], is_train=True, use_graph=use_graph,
                              precision=precision)
            return put

        # the equalities: 3 captured steps of each run from one state
        launches = None
        for p in ZERO1_DROPOUT:
            runs = {}
            for name, (kw, option) in ZERO1_RUNS.items():
                drop_graphs(torch)
                restore(kw, p)(m)
                if name == "zero1" and p == 0.0:  # the counted step
                    reset_counts(fa, mp)
                    losses = captured_steps(torch, fa, mp, m, x, y,
                                            per_step, "zero1 fp32",
                                            steps=3)[0]
                    launches = per_step
                else:
                    args = () if option == "plain" else (option,)
                    losses = [m(x, y, *args)[1].item() for _ in range(3)]
                gs = m._train_step
                check(all(np.isfinite(losses)) and (gs.captures,
                                                    gs.replays) == (1, 2),
                      f"zero1 {name} at dropout {p}: non-finite losses "
                      f"{losses} or not one capture and 2 replays")
                runs[name] = (losses, state_of(m))
                if name == "gather_half":
                    d = m.optimizer
                    flat = torch.cat([t.detach().reshape(-1)
                                      for t in m.parameters()])
                    master = d._z_master[0, :flat.numel()]
                    exact = torch.equal(
                        flat, master.to(torch.bfloat16).float())
                    print(f"zero1 gather_half at dropout {p}: losses "
                          f"{losses}; every parameter its fp32 master "
                          f"rounded to bf16: {exact}", flush=True)
                    check(exact and losses[-1] < losses[0],
                          f"gather_half at dropout {p}: a parameter is "
                          f"not its master rounded to bf16, or the loss "
                          f"did not fall")
            for a, b in ZERO1_PAIRS:
                gap, bitwise = params_gap(torch, runs[a][1], runs[b][1])
                lgap = max(abs(u - v) / max(abs(v), 1e-30)
                           for u, v in zip(runs[a][0], runs[b][0]))
                print(f"zero1 {a} vs {b} at dropout {p}, 3 captured steps: "
                      f"losses {runs[a][0]} vs {runs[b][0]}, bitwise "
                      f"{bitwise and runs[a][0] == runs[b][0]}, parameters "
                      f"max|d|/max|p| {gap:.3e}, losses max rel {lgap:.3e} "
                      f"(tol {TWIN_TOL['fp32']})", flush=True)
                check(gap <= TWIN_TOL["fp32"] and lgap <= TWIN_TOL["fp32"],
                      f"zero1 {a} differs from {b} at dropout {p}")
                out["equalities"][f"{a}_vs_{b}_dropout_{p}"] = dict(
                    bitwise=bitwise and runs[a][0] == runs[b][0],
                    max_rel=gap, loss_max_rel=lgap)
            del runs

        # rank 1's dropout stream through the capture: fresh masks on
        # every replay, none of rank 0's (4 steps at lr 0)
        rank_losses = {}
        for rank in (0, 1):
            drop_graphs(torch)
            restore(None, 0.1, lr=0.0)(m)
            autograd.reset_rank_draws()
            with autograd.rank_draws(rank):
                rank_losses[rank] = [m(x, y)[1].item() for _ in range(4)]
            check(m._train_step.replays == 3, "the rank steps were not "
                                              "captured")
        print(f"zero1 dropout streams at lr 0, 4 captured steps: rank 0 "
              f"{rank_losses[0]}, rank 1 {rank_losses[1]}", flush=True)
        check(len(set(rank_losses[1])) == 4
              and not set(rank_losses[0]) & set(rank_losses[1]),
              "rank 1's captured steps repeat their masks or draw rank 0's")
        out["rank_dropout_losses"] = rank_losses

        # 6 captured steps, counted, against the uncaptured twin
        twin = {}
        for prec in ("fp32", "bf16"):
            drop_graphs(torch)
            restore(ZERO1_RUNS["zero1"][0], 0.0, prec)(m)
            try:
                losses, first_s, ms = captured_steps(
                    torch, fa, mp, m, x, y, per_step, f"zero1 {prec}")
                check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                      f"zero1 {prec}: the loss did not fall over 6 steps")
                twin[prec] = hold_twin(
                    torch, "zero1", prec, (losses, state_of(m), ms),
                    eager_twin(torch, m, restore(
                        ZERO1_RUNS["zero1"][0], 0.0, prec, False), x, y))
                twin[prec]["losses"] = losses
            finally:
                autograd.set_autocast(False)
        out["twin"] = twin

        # the captured steps' ms in turns, and the slot bytes
        times, slots = {}, {}
        for prec in ("fp32", "bf16"):
            for name in ("adamw", "distopt", "zero1", "zero1", "distopt",
                         "adamw"):
                drop_graphs(torch)
                restore(ZERO1_RUNS[name][0], 0.0, prec)(m)
                try:
                    run_steps(torch, m, x, y, 2)  # uncaptured, capture
                    times.setdefault(f"{name}_{prec}", []).append(
                        run_steps(torch, m, x, y, 4)[1])
                finally:
                    autograd.set_autocast(False)
                slots[name] = sum(
                    t.numel() * t.element_size() for k, t in
                    m.optimizer.dump_states().items() if k != "__step__")
        for prec in ("fp32", "bf16"):
            print(f"zero1 captured step ms ({card}), {prec}, 4 replays each "
                  f"in turns (AdamW, DistOpt, ZeRO-1, ZeRO-1, DistOpt, "
                  f"AdamW): " + ", ".join(
                      f"{n} {times[f'{n}_{prec}']}" for n in
                      ("adamw", "distopt", "zero1")), flush=True)
        print(f"zero1 optimizer slot bytes: ZeRO-1 {slots['zero1']}, "
              f"plain DistOpt {slots['distopt']}, AdamW {slots['adamw']} "
              f"(world 1: the shard is the whole vector)", flush=True)
        out.update(step_ms=times, slot_bytes=slots)
        zero_ms = float(np.mean(times["zero1_fp32"]))
        drop_graphs(torch)
        out["sync"] = zero1_sync_timings(torch, Communicator(mesh), m,
                                         zero_ms, card)
        out["planner"] = planner_check(
            "zero1 gpt_medium", [p.numel() for p in m.parameters()], 2 ** 21,
            calls0, card)
        m.graph(False)
        del m, start
        drop_graphs(torch)

        # the trainer, at its defaults and at gpt_medium's widths
        out["trainer"] = {}
        for label, argv in (("defaults", []),
                            ("gpt_medium", ZERO1_TRAINER_WIDE)):
            t = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "singa_tpu_torch.examples.gpt_lm",
                 "--shard-states", *argv], capture_output=True, text=True,
                timeout=600)
            wall = time.perf_counter() - t
            print(run.stdout, flush=True)
            check(run.returncode == 0, f"gpt_lm --shard-states {argv} "
                                       f"failed: {run.stderr[-2000:]}")
            trained = [float(line.split("loss ")[1].split()[0]) for line in
                       run.stdout.splitlines() if line.startswith("step ")]
            check(len(trained) >= 2 and trained[-1] < trained[0]
                  and "--- sample ---" in run.stdout
                  and "(ZeRO-1 sharded slots)" in run.stdout,
                  f"gpt_lm --shard-states {argv}: the loss did not fall, "
                  f"no sample, or no ZeRO-1")
            print(f"gpt_lm --shard-states {label}: losses {trained}, "
                  f"{wall:.1f} s ({card})", flush=True)
            out["trainer"][label] = dict(losses=trained, wall_s=wall)
    finally:
        autograd.set_autocast(False)
        distributed.shutdown()
        drop_graphs(torch)
    return launches, out


# -- the serving path ---------------------------------------------------------

#: the serve phase's tolerance for logits against the dense decode path:
#: fp32 through 12 post-LN blocks, products of another batch width (as
#: the scoring check's)
SERVE_LOGIT_TOL = 2e-3
#: the quantized pools' logit gap to the fp32 engine
#: (tests/test_serving_int8.py's bound)
KV_GAP_TOL = 0.15
SERVE_WINDOW = 1024


def serve_requests(rng, vocab, n, lo, hi, new_lo, new_hi, window):
    """n requests from `rng`: prompt lengths in [lo, hi], max_new in
    [new_lo, new_hi], prompt + max_new <= window; even ones greedy, odd
    ones sampled at temperature 0.8."""
    from singa_tpu_torch.serving import Request

    out = []
    for i in range(n):
        max_new = int(rng.integers(new_lo, new_hi + 1))
        t0 = int(rng.integers(lo, min(hi, window - max_new) + 1))
        out.append(Request(i, rng.integers(0, vocab, t0).astype(np.int32),
                           max_new, temperature=0.0 if i % 2 == 0 else 0.8,
                           seed=SEED + i))
    return out


def dense_logits(torch, model, prompt, tokens, window):
    """The dense cached path's logits for every token of a stream,
    teacher-forced on `tokens`: row j scores token j (row 0 from the
    prefill at t0 - 1, row j from `decode_step` on token j - 1)."""
    prefill, decode_step = model._decode_fns(window)[:2]
    pv = model._functional_params()
    t0 = len(prompt)
    ctx = torch.zeros((1, window), dtype=torch.long, device="cuda")
    ctx[0, :t0] = torch.from_numpy(prompt).cuda()
    toks = torch.tensor(tokens, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        logits, kc, vc = prefill(pv, ctx)
        rows = [logits[0, t0 - 1]]
        for j in range(len(tokens) - 1):
            rows.append(decode_step(pv, kc, vc, toks[j:j + 1], t0 + j)[0])
    return torch.stack(rows)


def dense_picks(torch, req, dense):
    """(tokens, margins) the dense logits give a request: argmax for a
    greedy one; for a sampled one the Gumbel-max of `pick_rows` with the
    request's seed at each token's index, its margin scaled back to
    logit units."""
    from singa_tpu_torch.models.gpt import gumbel_noise

    n = dense.shape[0]
    scores, unit = dense.float(), 1.0
    if req.temperature > 0:
        temps = torch.full((n,), max(req.temperature, 1e-6),
                           device=dense.device)
        seeds = torch.full((n,), req.seed, dtype=torch.long,
                           device=dense.device)
        idx = torch.arange(n, device=dense.device)
        scores = scores / temps[:, None] + gumbel_noise(seeds, idx,
                                                        dense.shape[1])
        unit = req.temperature
    top = scores.topk(2, dim=-1)
    margin = (top.values[:, 0] - top.values[:, 1]) * unit
    return top.indices[:, 0].cpu().numpy(), margin.cpu().numpy()


def first_near_tie(margins, tol):
    near = np.flatnonzero(margins < tol)
    return int(near[0]) if near.size else len(margins)


def step_bound(model, eng, lengths):
    """Least time (ms) of one decode step: the larger of the bytes it
    must move (every weight once, the live K/V rows read once, one new
    K/V row per slot and layer written) over the memory rate, and its
    fp32 operations (the weight products for every slot, QK and PV over
    the live rows) over the FMA rate."""
    n_w = sum(p.numel() for p in model.parameters())
    n_emb = model.tok.table.numel() + model.pos.table.numel()
    row = 2 * eng._n_layers * eng.heads * eng.hd  # K and V, every layer
    live = int(sum(lengths)) + len(lengths)
    nbytes = 4 * (n_w + row * live + row * len(lengths))
    flops = (2.0 * (n_w - n_emb) * eng.slots
             + 2.0 * eng._n_layers * eng.heads * eng.hd * 2 * live)
    t_b, t_o = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS["fp32"]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b > t_o else "operations")


def time_decode_step(torch, eng):
    """Device ms of the decode step captured (a graph replay) and
    uncaptured (the same function launched from Python), in turns in
    this process (captured, uncaptured, uncaptured, captured), and of
    the paged gathers alone: every layer's K and V, each made the
    contiguous (S, H, W, hd) tensor the step's einsums copy it into."""
    with torch.inference_mode():
        eng._upload()
        cap, unc = [], []
        for captured in (True, False, False, True):
            fn = eng._run_step if captured else eng._step_fn
            (cap if captured else unc).append(
                cuda_ms(torch, fn, iters=30, warmup=3))
        pt = eng._step_inputs()[0]

        def gathers():
            for pools in (eng.kpools, eng.vpools):
                for pool in pools:
                    eng._kv.gather(pool, pt).contiguous()

        gather = cuda_ms(torch, gathers, iters=30, warmup=3)
    return cap, unc, gather


def serve_path(torch, model):
    """The serving path: gpt_medium through `ServingEngine` (8 slots,
    block 16, window 1024, prefill batch 2, fp32 pool), 16 requests
    admitted as slots free; the oracle against the dense cached path;
    the bf16 and int8 pools at one pool_bytes; the prefix cache."""
    from singa_tpu_torch.observability import metrics
    from singa_tpu_torch.serving import Request, ServingEngine

    W = SERVE_WINDOW
    vocab = model.vocab_size
    rng = np.random.default_rng(SEED)
    eng = ServingEngine(model, slots=8, block_size=16, window=W,
                        prefill_batch=2)
    check(eng._graph is not None and eng.decode_compiles == 1,
          "the decode step was not captured as a CUDA Graph")
    reqs = serve_requests(rng, vocab, 16, 64, 768, 32, 128, W)
    print(f"serve: {len(reqs)} requests, prompts "
          f"{sorted(len(r.prompt) for r in reqs)}, max_new "
          f"{sorted(r.max_new for r in reqs)}; pool {eng.pool_bytes} "
          f"bytes, {eng.allocator.capacity} blocks", flush=True)

    queue, snaps, prefill, step_s, timed = list(reqs), [], [], [], None
    metrics.reset()
    metrics.enable()
    t_all = time.perf_counter()
    while queue or eng.n_active:
        batch = []
        while queue and len(batch) < eng.free_slots:
            batch.append(queue.pop(0))
        if batch:
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.admit_many(batch)  # reads the first tokens back: synced
            prefill.append(((time.perf_counter() - t) * 1e3,
                            -(-len(batch) // eng.prefill_batch)))
        if timed is None and eng.n_active == eng.slots:
            timed = time_decode_step(torch, eng)
            bound = step_bound(model, eng, eng.lengths)
        if eng.steps % 20 == 0:
            logits = eng.peek_logits()
            for s in np.flatnonzero(eng.active):
                r = eng._reqs[s]
                snaps.append((r.rid, len(r.tokens), logits[s].copy()))
        t = time.perf_counter()
        eng.step()
        step_s.append(time.perf_counter() - t)
    wall_s = time.perf_counter() - t_all
    hist = metrics.histogram("serve_token_ms")
    p50, p95 = hist.percentile(0.5), hist.percentile(0.95)
    metrics.disable()

    n_decode = sum(len(r.tokens) - 1 for r in reqs)
    cap, unc, gather_ms = timed
    batch_ms = [ms / n for ms, n in prefill]
    stats = dict(
        requests=len(reqs), decode_tokens=n_decode, steps=eng.steps,
        wall_s=wall_s, decode_tokens_per_s=n_decode / sum(step_s),
        step_ms_host_mean=1e3 * sum(step_s) / len(step_s),
        token_ms_p50=p50, token_ms_p95=p95,
        step_ms_captured=cap, step_ms_uncaptured=unc,
        gather_ms=gather_ms, gather_share=gather_ms / min(cap),
        step_bound_ms=bound[0], step_bound_by=bound[1],
        prefill_ms_per_batch=batch_ms, pool_bytes=eng.pool_bytes,
        decode_compiles=eng.decode_compiles)
    print(f"serve: decode step {min(cap):.3f} ms captured, {min(unc):.3f} "
          f"ms uncaptured (in turns: {cap[0]:.3f} {unc[0]:.3f} "
          f"{unc[1]:.3f} {cap[1]:.3f}); paged gathers {gather_ms:.3f} ms "
          f"({100 * stats['gather_share']:.1f}% of the captured step); "
          f"bound {bound[0]:.3f} ms ({bound[1]})", flush=True)
    print(f"serve: {n_decode} decode tokens in {eng.steps} steps, "
          f"{stats['decode_tokens_per_s']:.1f} decode tokens/s, host step "
          f"{stats['step_ms_host_mean']:.3f} ms mean; per-token p50 "
          f"{p50:.3f} ms, p95 {p95:.3f} ms (serve_token_ms); prefill "
          f"{np.mean(batch_ms):.3f} ms per batch of 2 (mean of "
          f"{len(batch_ms)} admissions); {wall_s:.3f} s in all", flush=True)
    check(eng.decode_compiles == 1,
          f"{eng.decode_compiles} decode captures, not 1")
    check(all(r.done and len(r.tokens) == r.max_new for r in reqs),
          "a request did not finish with exactly max_new tokens")
    check(eng.allocator.used_blocks == 0 and not eng.allocator._ref,
          "the allocator did not drain")
    del eng
    torch.cuda.empty_cache()

    # the oracle: the engine's logits against the dense cached path, its
    # tokens against the dense picks wherever the top-2 margin clears
    # the tolerance, and the sampled streams against solo generate
    dense = {r.rid: dense_logits(torch, model, r.prompt, r.tokens, W)
             for r in reqs}
    err = max(float(np.abs(row - dense[rid][m].cpu().numpy()).max())
              for rid, m, row in snaps)
    print(f"serve oracle: peek_logits vs dense decode_step over "
          f"{len(snaps)} slot rows: max|d| {err:.3e} (tol "
          f"{SERVE_LOGIT_TOL})", flush=True)
    check(err <= SERVE_LOGIT_TOL, "engine logits disagree with the dense "
                                  "decode path")
    near_streams, skipped, gen_checked = 0, 0, 0
    for r in reqs:
        want, margin = dense_picks(torch, r, dense[r.rid])
        got = np.asarray(r.tokens)
        clear = margin >= SERVE_LOGIT_TOL
        bad = np.flatnonzero(clear & (got != want))
        check(bad.size == 0, f"request {r.rid} ({'sampled' if r.temperature
              else 'greedy'}) differs from the dense path at clear "
              f"positions {bad[:5]}")
        near_streams += int(not clear.all())
        skipped += int((~clear).sum())
        if r.temperature > 0:
            f = first_near_tie(margin, SERVE_LOGIT_TOL)
            solo = model.generate(r.prompt, r.max_new, window=W,
                                  temperature=r.temperature,
                                  seed=r.seed)[0, len(r.prompt):]
            check(np.array_equal(solo[:f], got[:f]),
                  f"sampled request {r.rid} differs from solo generate "
                  f"before its first near-tie ({f})")
            gen_checked += f
    print(f"serve oracle: every stream equals the dense picks at every "
          f"position whose top-2 margin is >= {SERVE_LOGIT_TOL}; "
          f"{near_streams} streams had a near-tie ({skipped} positions "
          f"skipped); the 8 sampled streams equal solo generate over "
          f"{gen_checked} tokens, up to their first near-tie", flush=True)
    stats.update(logit_err=err, near_tie_streams=near_streams,
                 near_tie_positions=skipped)
    del dense
    torch.cuda.empty_cache()

    stats["kv_formats"] = serve_kv_formats(torch, model, rng)
    stats["prefix_cache"] = serve_prefix(torch, model, rng)
    return stats


def serve_kv_formats(torch, model, rng):
    """The same short mix on fp32, bf16 and int8 pools of one
    pool_bytes: capacity, step time and the logit gap to fp32."""
    from singa_tpu_torch.serving import Request, ServingEngine, \
        kv_block_bytes

    W = SERVE_WINDOW
    dec = model.decoder
    budget = 256 * kv_block_bytes(dec.n_blocks, dec.num_heads,
                                  model.d_model // dec.num_heads, 16, "fp32")
    mix = serve_requests(rng, model.vocab_size, 8, 64, 256, 16, 16, W)
    out, ref = {}, None
    for kv in ("fp32", "bf16", "int8"):
        eng = ServingEngine(model, slots=8, block_size=16, window=W,
                            prefill_batch=2, kv_dtype=kv,
                            pool_bytes=budget)
        reqs = [Request(r.rid, r.prompt, r.max_new, 0.0, r.seed)
                for r in mix]
        eng.admit_many(reqs)
        used = eng.allocator.used_blocks
        logits = eng.peek_logits()
        ref = logits if ref is None else ref
        gap = float(np.abs(logits - ref).max())
        step_s = []
        while eng.n_active:
            t = time.perf_counter()
            eng.step()
            step_s.append(time.perf_counter() - t)
        cap = eng.allocator.capacity
        out[kv] = dict(pool_bytes=eng.pool_bytes, blocks=cap,
                       requests_of_256_tokens=cap // 16, blocks_used=used,
                       step_ms=1e3 * float(np.mean(step_s)),
                       logit_gap_to_fp32=gap)
        print(f"serve kv {kv}: pool {eng.pool_bytes} bytes holds {cap} "
              f"blocks ({cap // 16} requests of 256 tokens); the mix "
              f"took {used}; step {out[kv]['step_ms']:.3f} ms; logit gap "
              f"to fp32 {gap:.3e} (tol {KV_GAP_TOL})", flush=True)
        check(gap <= KV_GAP_TOL, f"{kv} pool logits diverge from fp32")
        check(eng.decode_compiles == 1, f"{kv}: decode recaptured")
        del eng
        torch.cuda.empty_cache()
    check(out["int8"]["blocks"] >= 1.9 * out["fp32"]["blocks"]
          and out["bf16"]["blocks"] >= 1.9 * out["fp32"]["blocks"],
          "the quantized pools do not multiply capacity")
    return out


def serve_prefix(torch, model, rng):
    """8 requests share a 512-token prefix: cold (no prefix cache) and
    warm (the cache on) admissions, greedy streams compared up to the
    first near-tie of the dense path."""
    from singa_tpu_torch.serving import Request, ServingEngine

    W = SERVE_WINDOW
    shared = rng.integers(0, model.vocab_size, 512).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, model.vocab_size, int(rng.integers(16, 65))).astype(np.int32)])
        for _ in range(8)]
    runs = {}
    for warm in (False, True):
        eng = ServingEngine(model, slots=8, block_size=16, window=W,
                            prefill_batch=2, prefix_cache=warm)
        rounds = []
        for _ in range(2):  # the second round is timed: warm, captured
            reqs = [Request(i, p, 32) for i, p in enumerate(prompts)]
            eng.admit(reqs[0])
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.admit_many(reqs[1:])
            ms = (time.perf_counter() - t) * 1e3 / (len(reqs) - 1)
            while eng.n_active:
                eng.step()
            rounds.append((reqs, ms, dict(eng.prefix_stats)))
        runs[warm] = rounds
        check(eng.decode_compiles == 1, "prefix run recaptured the step")
        del eng
        torch.cuda.empty_cache()
    (cold, _, _), (_, cold_ms, _) = runs[False]
    (hot, hot_first_ms, st), (_, hot_ms, _) = runs[True]
    check(st["hits"] == 7 and st["misses"] == 1
          and all(r.cached_tokens == 512 for r in hot[1:]),
          f"warm admissions did not map the shared prefix: {st}")
    same = 0
    for c, h in zip(cold, hot):
        _, margin = dense_picks(torch, c, dense_logits(
            torch, model, c.prompt, c.tokens, W))
        f = first_near_tie(margin, SERVE_LOGIT_TOL)
        check(np.array_equal(np.asarray(c.tokens[:f]),
                             np.asarray(h.tokens[:f])),
              f"warm stream {h.rid} differs from cold before position {f}")
        same += f
    print(f"serve prefix: {st}; admission ms per request of the 7 on "
          f"the shared prefix (second round): cold {cold_ms:.3f} (full "
          f"prefill, batches of 2), warm {hot_ms:.3f} (suffix only; "
          f"{hot_first_ms:.3f} in the first round, its captures "
          f"included); warm streams equal cold over {same} tokens, up to "
          f"each first near-tie", flush=True)
    return dict(cold_prefill_ms=cold_ms, warm_prefill_ms=hot_ms,
                warm_first_round_ms=hot_first_ms, stats=st,
                tokens_compared=same)


# -- the serving stack around the engine ---------------------------------------

SPEC_K = 4
#: priority lanes and tenants cycled over the frontend and router mixes
LANES = ("high", "normal", "background")
TENANTS = ("a", "b")


def fresh(reqs):
    """Unserved copies of `reqs` (a Request accumulates its tokens)."""
    from singa_tpu_torch.serving import Request

    return [Request(r.rid, r.prompt, r.max_new, r.temperature, r.seed)
            for r in reqs]


def oracle(torch, model, reqs, what):
    """{rid: dense margins}, after holding every stream to the dense
    picks wherever the top-2 margin clears SERVE_LOGIT_TOL; returns the
    margins and the number of positions skipped as near-ties."""
    margins, skipped = {}, 0
    for r in reqs:
        want, margin = dense_picks(torch, r, dense_logits(
            torch, model, r.prompt, r.tokens, SERVE_WINDOW))
        got = np.asarray(r.tokens)
        clear = margin >= SERVE_LOGIT_TOL
        bad = np.flatnonzero(clear & (got != want))
        check(bad.size == 0, f"{what}: request {r.rid} differs from the "
                             f"dense path at clear positions {bad[:5]}")
        margins[r.rid] = margin
        skipped += int((~clear).sum())
    torch.cuda.empty_cache()
    return margins, skipped


def same_until_near_tie(a, b, margin):
    """Whether token lists a and b agree up to the first near-tie of
    the dense path (exact where the margins clear the tolerance)."""
    f = first_near_tie(margin, SERVE_LOGIT_TOL)
    return list(a[:f]) == list(b[:f]) and len(a) == len(b)


def round_bound(model, draft, eng, lengths):
    """Least time (ms) of one speculative round: the larger of the bytes
    it must move (the target's weights once, the draft's once per
    micro-step, the live K/V rows of each cache once per pass over it,
    K+1 new rows per slot and layer in each) over the memory rate, and
    its fp32 operations over the FMA rate."""
    kp1 = eng.spec_k + 1
    s = len(lengths)
    n_w = sum(p.numel() for p in model.parameters())
    n_e = model.tok.table.numel() + model.pos.table.numel()
    d_w = sum(p.numel() for p in draft.parameters())
    d_e = draft.tok.table.numel() + draft.pos.table.numel()
    row_t = 2 * eng._n_layers * eng.heads * eng.hd
    row_d = 2 * eng._d_layers * eng.d_heads * eng.d_hd
    live = int(sum(lengths)) + s * kp1
    nbytes = 4 * (n_w + kp1 * d_w + row_t * (live + s * kp1)
                  + row_d * (kp1 * live + s * kp1))
    flops = (2.0 * (n_w - n_e) * s * kp1 + 2.0 * (d_w - d_e) * s * kp1
             + 2.0 * row_t * live * kp1 + 2.0 * row_d * live * kp1)
    t_b, t_o = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS["fp32"]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b > t_o else "operations")


def drive(eng, reqs):
    """Admit the requests of `reqs` not admitted yet (those without a
    first token) as slots free, and step until every stream ends:
    (decode tokens from step(), summed step walls in s, the streams
    stepped summed over steps)."""
    queue = [r for r in reqs if not r.tokens]
    step_s, streams = [], 0
    while queue or eng.n_active:
        batch = []
        while queue and len(batch) < eng.free_slots:
            batch.append(queue.pop(0))
        if batch:
            eng.admit_many(batch)
        streams += eng.n_active
        t = time.perf_counter()
        eng.step()
        step_s.append(time.perf_counter() - t)
    n_dec = sum(len(r.tokens) - 1 for r in reqs)
    return n_dec, sum(step_s), streams


def serve_spec(torch, model, card):
    """`SpeculativeEngine(spec_k=4)` at gpt_medium's width on 8
    requests (prompts 64-512, max_new 32-64, half sampled at 0.8),
    with the target as its own draft and with `gpt_draft(target)`
    (seed-1 weights), against the plain engine on the same mix, in
    turns."""
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_draft
    from singa_tpu_torch.serving import ServingEngine, SpeculativeEngine

    W = SERVE_WINDOW
    tiny = gpt_draft(model)
    load_singa_tpu_params(tiny, seeded_params(tiny, SEED + 1))
    tiny.eval()
    mix = serve_requests(np.random.default_rng(SEED + 7), model.vocab_size,
                         8, 64, 512, 32, 64, W)
    kw = dict(slots=8, block_size=16, window=W)
    runs, out = {}, {}
    for which in ("plain", "self", "tiny", "tiny", "self", "plain"):
        if which == "plain":
            eng = ServingEngine(model, **kw)
        else:
            eng = SpeculativeEngine(model, model if which == "self" else tiny,
                                    spec_k=SPEC_K, **kw)
            check(eng._propose_graph is not None
                  and eng._verify_graph is not None,
                  "propose or verify was not captured as a CUDA Graph")
        reqs = fresh(mix)
        timed = None
        if which != "plain":
            # propose and verify replayed alone, with every slot live;
            # their writes land in rows the next round rewrites first
            eng.admit_many(reqs)
            with torch.inference_mode():
                eng._upload()
                proposed = eng._run_propose()
                timed = (cuda_ms(torch, eng._run_propose, iters=10),
                         cuda_ms(torch, lambda: eng._run_verify(proposed),
                                 iters=10),
                         round_bound(model, eng.draft_model, eng,
                                     eng.lengths))
        n_dec, wall, streams = drive(eng, reqs)
        check(all(r.done and len(r.tokens) == r.max_new for r in reqs),
              f"{which}: a request did not end with exactly max_new tokens")
        check(eng.allocator.used_blocks == 0 and not eng.allocator._ref,
              f"{which}: the allocator did not drain")
        check(eng.decode_compiles == 1, f"{which}: decode recaptured")
        row = dict(decode_tokens_per_s=n_dec / wall, decode_tokens=n_dec,
                   steps=eng.steps)
        if which != "plain":
            check(eng.verify_compiles == 1, f"{which}: verify recaptured")
            row.update(propose_ms=timed[0], verify_ms=timed[1],
                       round_bound_ms=timed[2][0], round_bound_by=timed[2][1],
                       acceptance=eng.acceptance_rate,
                       tokens_per_round=n_dec / streams, rounds=eng.steps)
        runs.setdefault(which, []).append((reqs, row))
        print(f"serve spec [{which}]: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()) + f" ({card})", flush=True)
        del eng
        torch.cuda.empty_cache()
    for which in ("self", "tiny"):
        (a, _), (b, _) = runs[which]
        check([r.tokens for r in a] == [r.tokens for r in b],
              f"{which} draft: a second run gave other streams")
    check(runs["self"][0][1]["acceptance"] >= 0.9,
          f"self draft acceptance {runs['self'][0][1]['acceptance']:.3f} "
          f"< 0.9")
    plain = runs["plain"][0][0]
    margins, skipped = oracle(torch, model, [r for r in plain
                                             if r.temperature == 0],
                              "serve spec plain")
    for which in ("self", "tiny"):
        for r in runs[which][0][0]:
            if r.temperature == 0:
                want, margin = dense_picks(torch, r, dense_logits(
                    torch, model, r.prompt, r.tokens, W))
                clear = margin >= SERVE_LOGIT_TOL
                bad = np.flatnonzero(clear & (np.asarray(r.tokens) != want))
                check(bad.size == 0, f"{which} draft: greedy request "
                                     f"{r.rid} differs from the dense "
                                     f"picks at {bad[:5]}")
                skipped += int((~clear).sum())
    torch.cuda.empty_cache()
    for which in ("plain", "self", "tiny"):
        out[which] = [row for _, row in runs[which]]
    out["near_tie_positions"] = skipped
    print(f"serve spec: greedy streams of both drafts equal the dense "
          f"picks at every clear position ({skipped} near-tie positions "
          f"skipped); sampled streams repeat; tokens/s in turns: " +
          ", ".join(f"{w} " + "/".join(f"{r['decode_tokens_per_s']:.1f}"
                                       for r in out[w])
                    for w in ("plain", "self", "tiny")) + f" ({card})",
          flush=True)
    return out


def serve_frontend(torch, model, card):
    """`Frontend` over one plain engine with the serve mix (16 requests,
    priorities cycled high/normal/background, tenants a/b), FIFO,
    `overlap_prefill=True` and `ChunkedScheduler(chunk_budget=2)` in
    turns; then one SIGTERM drain with `drain_token_budget=32`, the
    process signalling itself at the 64th token of a stream."""
    import os
    import signal

    from singa_tpu_torch.observability import metrics
    from singa_tpu_torch.serving import (
        ChunkedScheduler, Frontend, ServingEngine)

    W = SERVE_WINDOW
    mix = serve_requests(np.random.default_rng(SEED), model.vocab_size, 16,
                         64, 768, 32, 128, W)
    eng = ServingEngine(model, slots=8, block_size=16, window=W)

    # the drain's trigger: the 64th token of the longest of the streams
    # admitted first (shorter ones have finished by then, and queued
    # requests wait for their slots)
    longest = max(mix[:8], key=lambda r: r.max_new).rid

    def serve(mode, budget=None, on_64=None):
        fe = Frontend(eng, drain_token_budget=budget,
                      overlap_prefill=mode == "overlap",
                      sched=(ChunkedScheduler(chunk_budget=2)
                             if mode == "chunked" else None))
        seen = {"n": 0}

        def cb(tok, done, rid):
            if rid == longest:
                seen["n"] += 1
                if on_64 is not None and seen["n"] == 64:
                    on_64()

        hs = [fe.submit(r.prompt, r.max_new, temperature=r.temperature,
                        seed=r.seed, rid=r.rid,
                        on_token=lambda t, d, rid=r.rid: cb(t, d, rid),
                        priority=LANES[i % 3], tenant=TENANTS[i % 2])
              for i, r in enumerate(mix)]
        metrics.reset()
        metrics.enable()
        t = time.perf_counter()
        report = fe.run()
        wall = time.perf_counter() - t
        tok, stall = (metrics.histogram("serve_token_ms"),
                      metrics.histogram("serve_decode_stall_ms"))
        metrics.disable()
        row = dict(token_ms_p50=tok.percentile(0.5),
                   token_ms_p95=tok.percentile(0.95),
                   stall_ms_p95=stall.percentile(0.95),
                   stall_ms_max=stall.percentile(1.0),
                   wall_s=wall, steps=eng.steps)
        return hs, report, row

    runs = {}
    for mode in ("fifo", "overlap", "chunked", "chunked", "overlap", "fifo"):
        steps0 = eng.steps
        hs, report, row = serve(mode)
        row["steps"] = eng.steps - steps0
        check(all(h.status == "done" and len(h.tokens) == h.request.max_new
                  for h in hs), f"frontend {mode}: a stream did not finish "
                                f"with exactly max_new tokens")
        check(eng.allocator.used_blocks == 0 and eng.decode_compiles == 1,
              f"frontend {mode}: pool not drained or step recaptured")
        runs.setdefault(mode, []).append((hs, row))
        print(f"serve frontend [{mode}]: per-token p50 "
              f"{row['token_ms_p50']:.3f} ms, p95 {row['token_ms_p95']:.3f}"
              f" ms; decode stall p95 {row['stall_ms_p95']:.3f} ms (max "
              f"{row['stall_ms_max']:.3f}); {row['wall_s']:.3f} s, "
              f"{row['steps']} steps ({card})", flush=True)
    fifo = [h.request for h in runs["fifo"][0][0]]
    margins, skipped = oracle(torch, model, fifo, "frontend fifo")
    for mode in ("overlap", "chunked"):
        for hs, _ in runs[mode]:
            for h in hs:
                check(same_until_near_tie(h.tokens, runs["fifo"][0][0][
                    h.rid].tokens, margins[h.rid]),
                    f"frontend {mode}: stream {h.rid} differs from FIFO "
                    f"before its first near-tie")

    # the drain: the process signals itself after 64 streamed tokens
    hs, report, row = serve("fifo", budget=32, on_64=lambda: os.kill(
        os.getpid(), signal.SIGTERM))
    done = [h for h in hs if h.status == "done"]
    queued_back = [h for h in hs if h.status == "preempted"
                   and not h.tokens]
    check(report["drained"], "the SIGTERM did not drain the frontend")
    check(queued_back and all(h.rid in report["preempted"]
                              for h in queued_back),
          "no queued request was handed back without tokens")
    check(report["drain_tokens"] <= 32 + eng.slots,
          f"drain_tokens {report['drain_tokens']} > budget + slots")
    for h in done:
        check(len(h.tokens) == h.request.max_new and same_until_near_tie(
            h.tokens, runs["fifo"][0][0][h.rid].tokens, margins[h.rid]),
            f"drained stream {h.rid} is not intact")
    check(done, "no stream completed across the drain")
    check(eng.allocator.used_blocks == 0, "the drain leaked blocks")
    drain = dict(drained=report["drained"],
                 drain_tokens=report["drain_tokens"],
                 completed=len(done), preempted=len(report["preempted"]),
                 queued_back_without_tokens=len(queued_back))
    print(f"serve frontend drain: {drain} (budget 32, slots {eng.slots})",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    return dict(runs={m: [row for _, row in v] for m, v in runs.items()},
                near_tie_positions=skipped, drain=drain)


def serve_router(torch, model, card):
    """`ReplicaRouter` over two local gpt_medium engines (one model, a
    pool and graphs each, prefix cache on, parallel pump): 4 openers,
    then 16 requests on their 4 shared 256-token prefixes; replica 0 is
    killed mid-stream. The same requests through a serial pump on two
    fresh engines, without the kill, give the same streams. Then one
    `ProcessReplica` child through the port's spool-server entry serves
    4 requests."""
    import json as json_module
    import os
    import shutil
    from pathlib import Path

    from singa_tpu_torch.serving import (
        Frontend, ProcessReplica, ReplicaRouter, Request, ServingEngine)

    W = SERVE_WINDOW
    vocab = model.vocab_size
    rng = np.random.default_rng(SEED + 11)
    prefixes = [rng.integers(0, vocab, 256).astype(np.int32)
                for _ in range(4)]
    openers = [np.concatenate([p, rng.integers(0, vocab, 16)])
               for p in prefixes]
    reqs = []
    for i in range(16):
        prompt = np.concatenate([prefixes[i % 4], rng.integers(
            0, vocab, int(rng.integers(16, 65)))]).astype(np.int32)
        reqs.append(Request(i, prompt, int(rng.integers(32, 49)),
                            0.0 if i % 2 == 0 else 0.8, SEED + i))

    def route(parallel, kill):
        engines = [ServingEngine(model, slots=8, block_size=16, window=W,
                                 prefix_cache=True) for _ in range(2)]
        router = ReplicaRouter(engines, parallel_pump=parallel)
        t = time.perf_counter()
        for i, p in enumerate(openers):
            router.submit(p, 8, rid=f"open{i}")
        router.run()
        seen = {r.rid: [] for r in reqs}
        handles = [router.submit(
            r.prompt, r.max_new, temperature=r.temperature, seed=r.seed,
            rid=r.rid, on_token=lambda tok, done, rid=r.rid:
            seen[rid].append(tok), priority=LANES[i % 3],
            tenant=TENANTS[i % 2]) for i, r in enumerate(reqs)]
        health = None
        if kill:
            for _ in range(10000):
                if sum(len(v) for v in seen.values()) >= 96:
                    break
                router.pump()
            router.kill_replica(0)
            health = router.healthz()
        router.run()
        wall = time.perf_counter() - t
        router.close()
        check(all(e.decode_compiles == 1 for e in engines),
              "a replica recaptured its decode step")
        return router, engines, handles, seen, health, wall

    router, engines, handles, seen, health_killed, wall = route(True, True)
    check(router.parallel_pump, "the parallel pump is off")
    st = dict(router.stats)
    busy = dict(router.replica_busy_s)
    print(f"serve router: {st}; healthz after the kill: status "
          f"{health_killed['status']}, live {health_killed['live']} of "
          f"{health_killed['replicas']}, quorum {health_killed['quorum']}; "
          f"{wall:.3f} s in all; replica busy s {busy} ({card})",
          flush=True)
    check(st["affinity_hits"] > 0, "no affinity hit")
    check(st["replica_deaths"] == 1 and st["requeued"] > 0,
          "the kill requeued nothing")
    check(health_killed["status"] == "degraded"
          and health_killed["live"] == 1 and health_killed["quorum"] == 2,
          f"healthz after the kill: {health_killed}")
    for h in handles:
        check(h.status == "done" and len(h.tokens) == h.max_new,
              f"routed stream {h.rid} did not finish with max_new tokens")
        check(seen[h.rid] == h.tokens,
              f"routed stream {h.rid}: a token was delivered twice or lost")
    for r, h in zip(reqs, handles):
        r.tokens = list(h.tokens)
    requeued = [r for r, h in zip(reqs, handles) if h.attempts > 1]
    margins, skipped = oracle(torch, model, reqs, "router")
    hits = [e.prefix_hits for e in engines]
    router.revive_replica(0)
    check(router.healthz()["status"] == "ok", "revive did not restore ok")
    del router, engines
    torch.cuda.empty_cache()
    serial = route(False, False)
    for r, h in zip(reqs, serial[2]):
        check(h.status == "done" and same_until_near_tie(
            h.tokens, r.tokens, margins[r.rid]),
            f"stream {r.rid}: the serial pump differs from the parallel "
            f"one before its first near-tie")
    same = sum(h.tokens == r.tokens for r, h in zip(reqs, serial[2]))
    print(f"serve router: the serial pump without the kill gives the "
          f"parallel run's streams ({same}/16 exactly; {serial[5]:.3f} s, "
          f"busy s {dict(serial[0].replica_busy_s)}) ({card})", flush=True)
    del serial
    torch.cuda.empty_cache()

    # one process replica, started as a fresh interpreter
    spool = Path(__file__).resolve().parent / "build" / "chip_smoke_spool"
    shutil.rmtree(spool, ignore_errors=True)
    rep = ProcessReplica(str(spool), block_size=16, stale_after_s=300.0)
    prouter = ReplicaRouter([rep])
    root = str(Path(__file__).resolve().parent)
    proc = subprocess.Popen(
        [sys.executable, "-m", "singa_tpu_torch.serving.router",
         "--spool", str(spool), "--gpt-medium"],
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        four = fresh(reqs[:4])
        t = time.perf_counter()
        phs = [prouter.submit(r.prompt, r.max_new, temperature=r.temperature,
                              seed=r.seed, rid=r.rid) for r in four]
        while not all(h.done for h in phs):
            check(proc.poll() is None and time.perf_counter() - t < 600,
                  f"the process replica died or stalled: "
                  f"{proc.poll()} {proc.stderr.read() if proc.poll() else ''}")
            prouter.pump()
            time.sleep(0.05)
        proc_s = time.perf_counter() - t
        status = rep.status()
        rep.stop()
        rc = proc.wait(timeout=120)
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    check(rc == 0, f"the process replica exited {rc}: {err[-2000:]}")
    check(status.get("decode_compiles") == 1,
          f"the process replica's status: {status}")
    eng = ServingEngine(model, slots=8, block_size=16, window=W)
    local = Frontend(eng)
    lhs = [local.submit(r.prompt, r.max_new, temperature=r.temperature,
                        seed=r.seed, rid=r.rid) for r in four]
    local.run()
    margins, _ = oracle(torch, model, [h.request for h in lhs],
                        "in-process twin")
    exact = 0
    for h, lh in zip(phs, lhs):
        check(h.status == "done" and same_until_near_tie(
            h.tokens, lh.tokens, margins[h.rid]),
            f"process replica stream {h.rid} differs from the in-process "
            f"engine's before its first near-tie")
        exact += int(h.tokens == lh.tokens)
    del eng, local
    torch.cuda.empty_cache()
    print(f"serve router process replica: 4 streams in {proc_s:.3f} s "
          f"(child start, gpt_medium build and capture included); "
          f"{exact}/4 equal the in-process engine's exactly; status "
          f"{json_module.dumps(status)}; exit 0 on stop ({card})",
          flush=True)
    return dict(stats=st, prefix_hits=hits, requeued=len(requeued),
                near_tie_positions=skipped, wall_s=wall,
                replica_busy_s=busy, serial_exact=same,
                process_replica=dict(seconds=proc_s, exact=exact,
                                     status=status))


# -- 9h. the captured eval step, the memory plan, Operator / Function and
# the functional ops --------------------------------------------------------------

EVAL_BATCH = 128
#: the functional ops' tolerance on the card against the CPU, as the
#: CPU tests hold them against the reference (relative and absolute)
OPS_TOL = 1e-5
FUNCTION_STEPS = 6


def profiled(torch, fn):
    """fn() once under `torch.profiler`: its wall ms (ending in a
    synchronize), the device's kernel ms and the idle share (None where
    the profiler saw no kernel)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return dict(wall_ms=wall, device_busy_ms=busy,
                idle_share=max(0.0, 1.0 - busy / wall) if busy > 0 else None)


def host_ms(torch, fn, iters=5):
    """Mean host ms of fn() calls each ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def graph_compiles():
    from singa_tpu_torch.observability import metrics

    return metrics.snapshot().get("graph_compiles", 0)


def held_plan(what, plan, native_before, mem_bytes):
    """Check a step's native memory plan and print it beside the card's
    allocator peak."""
    from singa_tpu_torch import native

    moved = native.native_call_count() - native_before
    print(f"{what} memory plan: {plan}; native calls +{moved}; "
          f"max_memory_allocated {mem_bytes / 2**30:.2f} GiB", flush=True)
    check(plan is not None and 0 < plan["peak_bytes"] <= plan["naive_bytes"]
          and moved > 0,
          f"{what}: no native plan with 0 < peak <= naive ({plan}), or the "
          f"native count did not move ({moved})")
    return dict(plan, native_calls=moved, max_memory_allocated=mem_bytes)


def eval_calls(torch, fa, mp, m, args, what, per_call):
    """The eval step's sequence: the key's first call (uncaptured, the
    plan; `per_call` launches), the second (a capture: `per_call`
    launches recorded, one more graph compile), the third (a replay: no
    launch); each equal bitwise to the uncaptured `forward` on the same
    inputs. Returns the plain output and the numbers."""
    from singa_tpu_torch import native

    native_before = native.native_call_count()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, mp)
    with torch.no_grad():
        t = time.perf_counter()
        first = m(*args)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        first_launches = counts(fa, mp)
        step = m._eval_step
        check(step is not None and (step.captures, step.replays) == (0, 0)
              and first_launches == per_call,
              f"{what}: the first eval call did not run uncaptured through "
              f"the eval step with {per_call} launches ({first_launches})")
        plan = held_plan(f"{what} eval step", m.memory_estimate,
                         native_before, torch.cuda.max_memory_allocated())
        reset_counts(fa, mp)
        compiles = graph_compiles()
        second = m(*args)
        recorded = counts(fa, mp)
        check(graph_compiles() - compiles == 1 and step.captures == 1
              and step.replays == 1 and recorded == per_call,
              f"{what}: the second eval call did not capture once with "
              f"{per_call} launches recorded ({recorded}, "
              f"{graph_compiles() - compiles} compiles)")
        reset_counts(fa, mp)
        third = m(*args)
        check(counts(fa, mp) == NO_LAUNCH and step.replays == 2,
              f"{what}: a replay launched {counts(fa, mp)}")
        plain = m.forward(*args)
    bitwise = [torch.equal(o, plain) for o in (first, second, third)]
    print(f"{what} eval: first call {first_s:.3f} s ({first_launches}), "
          f"capture recorded {recorded}; first / captured / replayed "
          f"output bitwise the uncaptured forward: {bitwise}", flush=True)
    check(bitwise[1] and bitwise[2], f"{what}: the captured eval step's "
                                     f"output is not bitwise the "
                                     f"uncaptured forward's")
    return plain, dict(first_call_s=first_s, launches_first=first_launches,
                       launches_recorded=recorded, bitwise=bitwise,
                       plan=plan)


def gpt_eval(torch, fa, mp, card, precision):
    """gpt_medium scoring 4 x 1024 tokens through the captured eval step
    in `precision`: `eval_calls` (12 flash forward launches), then the
    replay's device ms (CUDA events over the graph's replays), the
    uncaptured forward's host ms, and the idle share of a captured and
    an uncaptured call (`torch.profiler`)."""
    from singa_tpu_torch import autograd
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium

    m = gpt_medium(device="cuda")
    load_singa_tpu_params(m, seeded_params(m, SEED))
    ids = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, m.vocab_size, (4, 1024))).cuda()
    m.compile([ids], is_train=False, use_graph=True, precision=precision)
    try:
        what = f"gpt_medium {precision}"
        plain, out = eval_calls(torch, fa, mp, m, (ids,), what,
                                dict(NO_LAUNCH, flash_fwd=12))
        check(tuple(plain.shape) == (4, 1024, m.vocab_size)
              and bool(torch.isfinite(plain).all()),
              f"{what}: eval logits not finite of (4, 1024, vocab)")
        (graph,) = [e.graph for e in m._eval_step._cache.values()
                    if hasattr(e, "graph")]
        del plain
        with torch.no_grad():
            replay_ms = cuda_ms(torch, graph.replay, iters=10, warmup=2)
            eager_ms = host_ms(torch, lambda: m.forward(ids))
            captured = profiled(torch, lambda: m(ids))
            uncaptured = profiled(torch, lambda: m.forward(ids))
        out.update(replay_device_ms=replay_ms, uncaptured_host_ms=eager_ms,
                   speedup=eager_ms / replay_ms, captured_call=captured,
                   uncaptured_call=uncaptured)
        print(f"{what} eval ({card}): replay {replay_ms:.3f} device ms, "
              f"uncaptured forward {eager_ms:.3f} host ms "
              f"({eager_ms / replay_ms:.2f}x); idle share captured call "
              f"{captured['idle_share']}, uncaptured "
              f"{uncaptured['idle_share']}", flush=True)
    finally:
        autograd.set_autocast(False)
    del m
    drop_graphs(torch)
    return out


def cnn_eval(torch, fa, mp, card, name, ctor):
    """A CNN at full width in eval mode (batch 128, NHWC, fp32, seeded
    states, cuDNN's deterministic algorithms) through the captured eval
    step: `eval_calls`, then images/s of eval-step calls and of the
    uncaptured forward in turns; then the training step's memory plan
    (one uncaptured SGD step)."""
    from singa_tpu_torch import native, opt
    from singa_tpu_torch.model import load_singa_tpu_states

    m = ctor(num_classes=1000, device="cuda")
    load_singa_tpu_states(m, cnn_states(
        {n: t.shape for n, t in [*m.named_parameters(),
                                 *m.named_buffers()]}, SEED))
    m.set_image_layout("NHWC")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.randn((EVAL_BATCH, 3, 224, 224), generator=gen, device="cuda")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        m.compile([x], is_train=False, use_graph=True)
        plain, out = eval_calls(torch, fa, mp, m, (x,), name, NO_LAUNCH)
        check(tuple(plain.shape) == (EVAL_BATCH, 1000)
              and bool(torch.isfinite(plain).all()),
              f"{name}: eval scores not finite")
        del plain
        rates = {"captured": [], "uncaptured": []}
        with torch.no_grad():
            for which in ("captured", "uncaptured", "uncaptured",
                          "captured"):
                fn = (lambda: m(x)) if which == "captured" else (
                    lambda: m.forward(x))
                rates[which].append(EVAL_BATCH / cuda_ms(
                    torch, fn, iters=10, warmup=2) * 1e3)
        out["images_per_s"] = {k: float(np.mean(v))
                               for k, v in rates.items()}
        print(f"{name} eval ({card}): images/s {out['images_per_s']} "
              f"(turns: captured, uncaptured, uncaptured, captured)",
              flush=True)
        # the training step's plan: its first, uncaptured call
        y = torch.arange(EVAL_BATCH, device="cuda") % 1000
        m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9))
        m.compile([x], is_train=True, use_graph=True)
        before = native.native_call_count()
        torch.cuda.reset_peak_memory_stats()
        m(x, y)
        torch.cuda.synchronize()
        out["train_plan"] = held_plan(f"{name} training step",
                                      m._train_step.memory_plan, before,
                                      torch.cuda.max_memory_allocated())
    finally:
        torch.backends.cudnn.deterministic = det
    del m
    drop_graphs(torch)
    return out


def cifar_eval_trainer(torch, card):
    """`cnn_cifar10 --model resnet --epochs 1` in this process (the
    synthetic CIFAR set when none is on disk; batch 128): its validation
    loop takes the captured eval step, which replays."""
    from singa_tpu_torch.examples import cnn_cifar10

    built, ctor = [], cnn_cifar10.MODELS["resnet"]

    def keep(**kw):
        built.append(ctor(**kw))
        return built[-1]

    cnn_cifar10.MODELS["resnet"] = keep
    t = time.perf_counter()
    try:
        rc = cnn_cifar10.main(["--model", "resnet", "--epochs", "1",
                               "--loader", "sync"])
    finally:
        cnn_cifar10.MODELS["resnet"] = ctor
    step = built[0]._eval_step
    out = dict(exit=rc, wall_s=time.perf_counter() - t,
               eval_captures=step.captures if step else 0,
               eval_replays=step.replays if step else 0)
    print(f"cnn_cifar10 --model resnet --epochs 1 ({card}): {out}",
          flush=True)
    check(rc == 0 and step is not None and step.replays > 0,
          f"cnn_cifar10's validation did not replay the eval step: {out}")
    del built
    drop_graphs(torch)
    return out


def gpt_train_memory(torch, card):
    """gpt_medium's training step (AdamW, 4 x 1024): the native plan of
    its first, uncaptured call; then `step_memory_analysis` of the
    scanned stack under remat "none" and "per_block", whose saved bytes
    (the remat floor) must be lower under per_block."""
    from singa_tpu_torch import native, opt
    from singa_tpu_torch.graph import step_memory_analysis
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium

    out = {}
    rng = np.random.default_rng(SEED)
    for policy in ("none", "per_block"):
        m = gpt_medium(remat_policy=policy, device="cuda")
        load_singa_tpu_params(m, seeded_params(m, SEED))
        x, y = (torch.from_numpy(rng.integers(0, m.vocab_size, (4, 1024)))
                .cuda() for _ in range(2))
        m.set_optimizer(opt.AdamW(lr=3e-4))
        m.compile([x], is_train=True, use_graph=True)
        if policy == "none":
            before = native.native_call_count()
            torch.cuda.reset_peak_memory_stats()
            m(x, y)
            torch.cuda.synchronize()
            out["train_plan"] = held_plan(
                "gpt_medium training step", m._train_step.memory_plan,
                before, torch.cuda.max_memory_allocated())
        out[policy] = step_memory_analysis(m, x, y)
        print(f"gpt_medium remat {policy} step_memory_analysis ({card}): "
              f"{out[policy]}", flush=True)
        del m
        drop_graphs(torch)
    check(out["per_block"]["temp_bytes"] < out["none"]["temp_bytes"],
          f"remat floor: per_block saves {out['per_block']['temp_bytes']} "
          f"bytes, not below none's {out['none']['temp_bytes']}")
    return out


def functions_on_card(torch, card):
    """A user `autograd.Function` with its own backward (softsign) and
    one with the default VJP, inside an MLP's training step: 6 captured
    steps on the card (step 1 uncaptured, step 2 the capture) against
    the same 6 steps on the CPU (within 1e-5 of each tensor's max) and
    against their uncaptured twin on the card (bitwise)."""
    from singa_tpu_torch import autograd, opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.mlp import MLP

    class Softsign(autograd.Function):
        def __init__(self):
            super().__init__(lambda v: v / (1.0 + v.abs()), name="Softsign")

        def backward(self, dy):
            (v,) = self.inputs
            return (dy / (1.0 + v.abs()).square(),)

    class SquashMLP(MLP):
        def forward(self, x):
            h = Softsign()(self.fc1(x))
            return self.fc2(autograd.Function(
                lambda v: v * 0.5 + v.sin(), name="HalfSin")(h))

    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((64, 784)).astype(np.float32)
    y = rng.integers(0, 10, 64)
    ref = SquashMLP(128, 10, in_features=784, device="cpu")
    weights = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
               * 0.05 for k, v in ref.named_parameters()}

    def train(dev, use_graph):
        m = SquashMLP(128, 10, in_features=784, device=dev)
        m.dropout.p = 0.0
        load_singa_tpu_params(m, weights)
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
        tx, ty = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        m.compile([tx], is_train=True, use_graph=use_graph)
        losses = [m(tx, ty)[1].item() for _ in range(FUNCTION_STEPS)]
        step = m._train_step
        return losses, {k: v.detach().cpu() for k, v in
                        m.get_params().items()}, step

    lc, pc, step = train("cuda", True)
    lt, pt, _ = train("cuda", False)
    lh, ph, _ = train("cpu", False)
    check(step.captures == 1 and step.replays == FUNCTION_STEPS - 1,
          f"Function MLP: {step.captures} captures, {step.replays} replays")
    bitwise = lc == lt and all(torch.equal(pc[k], pt[k]) for k in pc)
    gap = max(max(abs(a - b) for a, b in zip(lc, lh)),
              max((pc[k] - ph[k]).abs().max().item()
                  / max(ph[k].abs().max().item(), 1e-30) for k in pc))
    out = dict(losses=lc, bitwise_twin=bitwise, cpu_gap=gap)
    print(f"Function MLP ({card}): losses {lc}; captured bitwise its "
          f"uncaptured twin: {bitwise}; vs the CPU max gap {gap:.3e} "
          f"(tol {OPS_TOL})", flush=True)
    check(bitwise, "the captured Function MLP is not bitwise its twin")
    check(gap <= OPS_TOL and lc[-1] < lc[0],
          "the Function MLP on the card differs from the CPU's, or its "
          "loss did not fall")
    return out


def _ops_cases(torch, A):
    """The 40 functional ops as (name, fn(*xs), inputs (shape, kind))."""
    idx = torch.tensor([[2, 0], [1, 2]])
    labels = np.array([0, 3, 1, -1, 4])
    cond = np.random.default_rng(99).standard_normal((3, 4)) > 0
    target = np.random.default_rng(7).standard_normal((3, 4)).astype(
        np.float32)
    a34, pos, small = ((3, 4), "any"), ((3, 4), "pos"), ((3, 4), "small")
    return [
        ("sub", A.sub, [a34, a34]), ("mul", A.mul, [a34, a34]),
        ("div", A.div, [a34, pos]), ("pow", A.pow, [pos, small]),
        ("matmul", A.matmul, [((2, 3, 4), "any"), ((4, 5), "any")]),
        ("squeeze", lambda a: A.squeeze(a, 1), [((3, 1, 4), "any")]),
        ("unsqueeze", lambda a: A.unsqueeze(a, (0, 2)), [a34]),
        ("split", lambda a: A.mul(*A.split(a, [1, 3], axis=1)[1:]),
         [((3, 5), "any")]),
        ("gather", lambda a: A.gather(a, idx.to(a.device), axis=1), [a34]),
        ("stack", lambda a, b: A.stack([a, b], axis=1), [a34, a34]),
        ("where", lambda a, b: A.where(cond, a, b), [a34, a34]),
        ("clip", lambda a: A.clip(a, -0.5, 0.5), [a34]),
        ("abs", A.abs, [a34]), ("exp", A.exp, [a34]), ("log", A.log, [pos]),
        ("sqrt", A.sqrt, [pos]), ("square", A.square, [a34]),
        ("maximum", A.maximum, [a34, a34]), ("minimum", A.minimum,
                                             [a34, a34]),
        ("max", lambda a: A.max(a, axis=1, keepdims=True), [a34]),
        ("min", lambda a: A.min(a, axis=(0, 2)), [((3, 4, 2), "any")]),
        ("prod", lambda a: A.prod(a, axis=1), [a34]),
        ("var", lambda a: A.var(a, axis=0, ddof=1), [((5, 4), "any")]),
        ("std", lambda a: A.std(a, axis=1, keepdims=True),
         [((3, 6), "any")]),
        ("cumsum", lambda a: A.cumsum(a, axis=1), [a34]),
        ("cumprod", lambda a: A.cumprod(a, axis=0), [((4, 3), "any")]),
        ("norm", lambda a: A.norm(a, ord=3.0, axis=1), [a34]),
        ("sort", lambda a: A.sort(a, axis=0, descending=True),
         [((4, 3), "any")]),
        ("argsort", lambda a: A.argsort(a, descending=True),
         [((3, 5), "any")]),
        ("topk", lambda a: A.topk(a, 2, axis=0)[0], [((5, 3), "any")]),
        ("one_hot", lambda a: A.one_hot(torch.from_numpy(labels).to(
            a.device), 4), [((1,), "any")]),
        ("einsum", lambda a, b: A.einsum("bij,jk->bik", a, b),
         [((2, 3, 4), "any"), ((4, 5), "any")]),
        ("pad", lambda a: A.pad(a, ((1, 0), (2, 1)), value=0.5), [a34]),
        ("elu", lambda a: A.elu(a, alpha=0.7), [a34]), ("erf", A.erf, [a34]),
        ("softplus", A.softplus, [a34]),
        ("log_softmax", lambda a: A.log_softmax(a, axis=0), [a34]),
        ("sum", lambda a: A.sum(a, axis=(0, 1)), [((3, 4, 2), "any")]),
        ("mean", lambda a: A.mean(a, axis=-1, keepdims=True), [a34]),
        ("mse_loss", lambda a: A.mse_loss(a, target), [a34]),
    ]


def ops_on_card(torch, card):
    """The 40 functional ops on the card: forward and the gradient of
    sum(op(x) * w) against the same on the CPU, within 1e-5 relative and
    absolute; `argsort` and `one_hot` (no gradient) equal."""
    from singa_tpu_torch import autograd as A

    cases = _ops_cases(torch, A)
    check(len(cases) == 40, f"{len(cases)} op cases, not 40")
    prev = A.training
    A.training = True
    worst, bad = {}, []
    try:
        for i, (name, fn, specs) in enumerate(cases):
            rng = np.random.default_rng(100 + i)
            arrays = []
            for shape, kind in specs:
                a = rng.standard_normal(shape).astype(np.float32)
                arrays.append(np.abs(a) + 0.5 if kind == "pos" else
                              0.5 * a if kind == "small" else a)
            res = {}
            for dev in ("cpu", "cuda"):
                xs = [torch.from_numpy(a).to(dev).requires_grad_()
                      for a in arrays]
                v = fn(*xs)
                grads = []
                if v.requires_grad:
                    w = torch.from_numpy(np.random.default_rng(1)
                                         .standard_normal(tuple(v.shape))
                                         .astype(np.float32)).to(dev)
                    got = dict((id(p), g) for p, g in A.backward(
                        A.sum(A.mul(v, w))))
                    grads = [got[id(t)].cpu() for t in xs if id(t) in got]
                res[dev] = (v.detach().cpu(), grads)
            (vh, gh), (vd, gd) = res["cpu"], res["cuda"]
            gaps = [(vd.double() - vh.double()).abs().max().item()
                    if vh.numel() else 0.0]
            ok = vd.shape == vh.shape and len(gd) == len(gh)
            if ok and not vh.is_floating_point():
                ok = torch.equal(vd, vh)
            for a, b in [(vd, vh)] + list(zip(gd, gh)):
                ok = ok and bool(torch.allclose(a.double(), b.double(),
                                                rtol=OPS_TOL, atol=OPS_TOL))
            gaps += [(a - b).abs().max().item() for a, b in zip(gd, gh)]
            worst[name] = max(gaps)
            if not ok:
                bad.append(name)
    finally:
        A.training = prev
    print(f"functional ops on the card ({card}) vs the CPU: max|d| "
          f"{max(worst.values()):.3e} over {len(worst)} ops (tol {OPS_TOL} "
          f"rel and abs); disagreeing: {bad}", flush=True)
    check(not bad, f"functional ops disagree with the CPU: {bad}")
    return dict(max_abs_err=worst)


def eval_path(torch, fa, mp, card):
    """Phase 9h. Returns the launches of gpt_medium's uncaptured eval
    call (fp32) and the numbers."""
    from singa_tpu_torch.models.mobilenet import mobilenet_v1
    from singa_tpu_torch.models.resnet import resnet50

    out = {f"gpt_medium_{p}": gpt_eval(torch, fa, mp, card, p)
           for p in ("fp32", "bf16")}
    out["resnet50"] = cnn_eval(torch, fa, mp, card, "resnet50", resnet50)
    out["mobilenet_v1"] = cnn_eval(torch, fa, mp, card, "mobilenet_v1",
                                   mobilenet_v1)
    out["cifar_trainer"] = cifar_eval_trainer(torch, card)
    out["gpt_medium_memory"] = gpt_train_memory(torch, card)
    out["functions"] = functions_on_card(torch, card)
    out["ops"] = ops_on_card(torch, card)
    return out["gpt_medium_fp32"]["launches_first"], out


# -- phase 9i: the Device classes and sequence parallelism -------------------

#: the sequence-parallel phases: gpt_medium's widths, unrolled, at one
#: sequence of 8192 tokens; BERT-base at bench.py's 16 x 512; the scanned
#: stack's plain ring at 4 x 2048 (it builds (B, H, T, T) scores)
SP_SEQ, SP_STEPS = 8192, 5
SP_SCAN_BATCH, SP_SCAN_SEQ, SP_SCAN_STEPS = 4, 2048, 3
SP_LR, SP_BERT_LR = 0.05, 1e-3
#: the flash paths against their twin without seq_axis: at world 1 the
#: ring is one flash block merged with weight exactly 1, and Ulysses
#: moves nothing, so the same kernels run on the same values (the
#: head-split tensors are the fused projection's own views); each loss
#: is held to 1e-5 of its size over the 5 SGD steps, and whether the
#: losses are bitwise equal is printed
SP_TWIN_TOL = 1e-5
#: the scanned stack's plain ring against the fused flash kernel of its
#: twin: the two sum in other orders (phase 6 holds logits to 2e-3); the
#: mean loss over 3 SGD steps is held to 1e-3 of its size
SP_PLAIN_TOL = 1e-3


def devices_path(torch, card):
    """The Device classes on the card: `create_cuda_gpu().device_info()`
    names the card, `memory_stats()` sees the allocator, TpuDevice and
    RunConfig("tpu") are the card, and `op_count` grows on an eager step
    and on the capture, not on the replays (the MLP, batch 64)."""
    from singa_tpu_torch import device as device_module
    from singa_tpu_torch import opt
    from singa_tpu_torch.config import RunConfig
    from singa_tpu_torch.models import MLP

    d = device_module.create_cuda_gpu()
    info = d.device_info()
    name = torch.cuda.get_device_name(0)
    check(info["device_kind"] == name and info["platform"] == "gpu"
          and d.platform == "gpu",
          f"device_info {info} does not name the card {name!r}")
    for alias in (device_module.create_tpu_device(),
                  device_module.create_opencl_device(),
                  RunConfig(device="tpu").make_device()):
        check(isinstance(alias, device_module.CudaGPU)
              and alias.torch_device == torch.device("cuda", 0),
              f"{alias!r} is not the card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.randn(64, 784, device="cuda", generator=gen)
    y = torch.randint(0, 10, (64,), device="cuda", generator=gen)
    m = MLP(100, 10, device=d)
    m.dropout.p = 0.0
    m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9))
    m.compile([x], is_train=True, use_graph=True)
    stats = d.memory_stats()
    check(stats["bytes_in_use"] > 0 and stats["bytes_limit"] > 0
          and stats["peak_bytes_in_use"] >= stats["bytes_in_use"],
          f"memory_stats {stats}")
    grown = []
    for _ in range(5):
        before = d.op_count
        m(x, y)[1].item()
        grown.append(d.op_count - before)
    gs = m._train_step
    m.graph(False)
    before = d.op_count
    m(x, y)[1].item()
    eager = d.op_count - before
    print(f"devices ({card}): {info}; memory_stats {stats}; op_count "
          f"growth per step: uncaptured {grown[0]}, capture {grown[1]}, "
          f"replays {grown[2:]} ({gs.replays - 1} replays), eager "
          f"{eager}", flush=True)
    check(grown[0] > 0 and grown[1] > 0 and grown[2:] == [0, 0, 0]
          and eager > 0 and (gs.captures, gs.replays) == (1, 4),
          f"op_count grew {grown} over the uncaptured step, the capture "
          f"and 3 replays, and {eager} on an eager step")
    return dict(device_info=info, memory_stats=stats, op_count_growth=dict(
        uncaptured=grown[0], capture=grown[1], replays=grown[2:],
        eager=eager))


def sp_path(torch, fa, mp, card):
    """Sequence parallelism over a world-1 NCCL group, the mesh (data 1,
    sp 1), every step captured: gpt_medium's unrolled decoder at 1 x
    8192 with `seq_axis`, `remat=True` and `ring_flash=True` (one
    diagonal flash block a layer), then with `seq_impl="ulysses"` (the
    head-split flash kernels over the whole sequence, recomputed in the
    backward); BERT-base at 16 x 512 with `seq_axis` and `ring_flash`
    (the bidirectional block); the scanned gpt_medium at 4 x 2048 with
    `seq_axis` and `overlap=True` (the pipelined plain ring). Each runs
    `DistOpt(SGD)` captured steps, counted, and is held to the same
    model without `seq_axis` from the same weights. Returns each
    phase's counted launches and the numbers."""
    import torch.distributed as tdist

    from singa_tpu_torch import distributed, opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.models.transformer import BertForClassification
    from singa_tpu_torch.parallel import mesh as mesh_module

    distributed.init(device="cuda")
    check(tdist.get_backend() == "nccl" and tdist.get_world_size() == 1,
          f"the group is {tdist.get_backend()} at world "
          f"{tdist.get_world_size()}, not NCCL at 1")
    mesh = mesh_module.get_mesh((1, 1), ("data", "sp"))
    check(mesh.shape == {"data": 1, "sp": 1}, f"mesh {mesh.shape}")
    flash = dict(NO_LAUNCH, flash_fwd=12, flash_bwd_dq=12,
                 flash_bwd_dkv=12)
    launches, out = {}, {"card": card, "mesh": mesh.shape}

    def train(make, params, x, y, per_step, what, steps, lr=SP_LR):
        m = make()
        load_singa_tpu_params(m, params)
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=lr, momentum=0.9),
                                    mesh=mesh, axis_name="data"))
        m.compile([x], is_train=True, use_graph=True)
        torch.cuda.reset_peak_memory_stats()
        losses, first_s, ms = captured_steps(torch, fa, mp, m, x, y,
                                             per_step, what, steps=steps)
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{what}: losses {losses} are not finite or did not fall")
        grad_axes = list(m.optimizer.grad_axes)
        m.graph(False)
        del m
        drop_graphs(torch)
        return dict(losses=losses, first_step_s=first_s, step_ms=ms,
                    peak_bytes=peak, grad_axes=grad_axes)

    def held(what, got, twin, tol):
        gap = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(got["losses"], twin["losses"]))
        bitwise = got["losses"] == twin["losses"]
        print(f"{what} ({card}): losses {got['losses']} vs the model "
              f"without seq_axis {twin['losses']}: max rel {gap:.3e} (tol "
              f"{tol}), bitwise {bitwise}", flush=True)
        check(gap <= tol, f"{what}: the losses differ from the model "
                          f"without seq_axis")
        return dict(got, twin_losses=twin["losses"],
                    twin_step_ms=twin["step_ms"], loss_max_rel=gap,
                    bitwise=bitwise, tolerance=tol)

    try:
        rng = np.random.default_rng(SEED)

        # gpt_medium's widths, unrolled, one sequence of 8192 tokens
        def gpt(**kw):
            return lambda: gpt_medium(scan_blocks=False, max_len=SP_SEQ,
                                      device="cuda", **kw)

        probe = gpt()()
        params, vocab = seeded_params(probe, SEED), probe.vocab_size
        del probe
        drop_graphs(torch)
        seq = torch.from_numpy(rng.integers(0, vocab,
                                            (1, SP_SEQ + 1))).cuda()
        x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
        twin = train(gpt(), params, x, y, flash, "sp twin gpt 1x8192",
                     SP_STEPS)
        # ring_flash at world 1: one causal flash block a layer, once in
        # the forward and once in the backward
        ring = train(gpt(seq_axis="sp", ring_flash=True, remat=True),
                     params, x, y, flash, "sp-ring-flash", SP_STEPS)
        launches["ring_flash"] = flash
        out["ring_flash"] = held("sp-ring-flash", ring, twin, SP_TWIN_TOL)
        # Ulysses with remat: the checkpointed attention's forward runs
        # again in the backward, 24 forward launches a step
        uly_step = dict(flash, flash_fwd=24)
        uly = train(gpt(seq_axis="sp", seq_impl="ulysses", ring_flash=True,
                        remat=True), params, x, y, uly_step,
                    "sp-ulysses-flash", SP_STEPS)
        launches["ulysses_flash"] = uly_step
        out["ulysses_flash"] = held("sp-ulysses-flash", uly, twin,
                                    SP_TWIN_TOL)
        for key in ("ring_flash", "ulysses_flash"):
            r = out[key]
            r["tokens_per_s"] = SP_SEQ / (r["step_ms"] / 1e3)
            print(f"{key} ({card}): {r['step_ms']:.2f} ms a captured step, "
                  f"{r['tokens_per_s']:.1f} tokens/s (the twin "
                  f"{r['twin_step_ms']:.2f} ms), peak "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        del params, seq, x, y
        drop_graphs(torch)

        # BERT-base, non-causal: the bidirectional block
        def bert(**kw):
            return lambda: BertForClassification(
                2, vocab_size=30522, max_len=BERT_SEQ, dropout=0.0,
                device="cuda", **kw)

        probe = bert()()
        params = seeded_params(probe, SEED)
        vocab = probe.bert.tok.table.shape[0]
        del probe
        bx = torch.from_numpy(rng.integers(0, vocab,
                                           (BERT_BATCH, BERT_SEQ))).cuda()
        by = torch.from_numpy(rng.integers(0, 2, (BERT_BATCH,))).cuda()
        btwin = train(bert(), params, bx, by, flash, "sp twin bert",
                      SP_STEPS, SP_BERT_LR)
        sb = train(bert(seq_axis="sp", ring_flash=True), params, bx, by,
                   flash, "sp-bert", SP_STEPS, SP_BERT_LR)
        launches["bert"] = flash
        out["bert"] = held("sp-bert", sb, btwin, SP_TWIN_TOL)
        out["bert"]["tokens_per_s"] = BERT_BATCH * BERT_SEQ / (
            sb["step_ms"] / 1e3)
        del params, bx, by
        drop_graphs(torch)

        # the scanned stack's pipelined plain ring: no kernel
        def scan(**kw):
            return lambda: gpt_medium(max_len=SP_SCAN_SEQ, device="cuda",
                                      **kw)

        probe = scan()()
        params, vocab = seeded_params(probe, SEED), probe.vocab_size
        del probe
        seq = torch.from_numpy(rng.integers(
            0, vocab, (SP_SCAN_BATCH, SP_SCAN_SEQ + 1))).cuda()
        x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
        stwin = train(scan(), params, x, y, flash, "sp twin scan",
                      SP_SCAN_STEPS)
        ss = train(scan(seq_axis="sp", overlap=True), params, x, y,
                   NO_LAUNCH, "sp-scan", SP_SCAN_STEPS)
        launches["scan"] = NO_LAUNCH
        out["scan"] = held("sp-scan", ss, stwin, SP_PLAIN_TOL)
        out["scan"]["tokens_per_s"] = SP_SCAN_BATCH * SP_SCAN_SEQ / (
            ss["step_ms"] / 1e3)
        for key in ("bert", "scan"):
            r = out[key]
            print(f"sp-{key} ({card}): {r['step_ms']:.2f} ms a captured "
                  f"step, {r['tokens_per_s']:.1f} tokens/s (the twin "
                  f"{r['twin_step_ms']:.2f} ms)", flush=True)
        del params, seq, x, y
    finally:
        distributed.shutdown()
        drop_graphs(torch)
    return launches, out


# -- phase 9j: tensor parallelism -----------------------------------------------

#: the tp phases: gpt_medium's full width at phase 9i's scanned batch and
#: T 1024, scanned and unrolled; BERT-base at bench.py's 16 x 512
TP_BATCH, TP_SEQ, TP_STEPS, TP_LR = SP_SCAN_BATCH, 1024, 6, SP_LR
#: each tp step against its twin without tp_axis, on one rank: the same
#: weights, the model axis of size 1 (its all-reduces sum one operand).
#: The scanned stack differs from its twin only in the column order of
#: the fused QKV product and in the route (the head-split flash kernels
#: on views of the interleaved projection, where the twin's fused kernel
#: reads the [q|k|v] one); the unrolled MHA in three (d, d) products in
#: place of one (d, 3d) and the same route. Both are fp32 rounding: each
#: loss over the 6 SGD steps is held to 1e-4 of its size (phase 9i
#: holds its same-kernel twins to 1e-5). BERT's tp attention at T 512
#: non-causal takes the plain attention (the head-split threshold is
#: 1024) where its twin takes the fused kernel, another summation
#: order: 1e-3, phase 9i's plain-ring limit
TP_TWIN_TOL, TP_BERT_TOL = 1e-4, 1e-3
#: serve_gpt on gpt_medium with and without --tp 1: 48 requests of 128
#: new tokens, a window of several seconds a serve, in TP_SERVE_PAIRS
#: alternating pairs, so a difference is read against the serves' spread
TP_SERVE_ARGV = ["--gpt-medium", "--window", "1024", "--slots", "8",
                 "--requests", "48", "--max-new", "128"]
TP_SERVE_PAIRS = 3


def tp_path(torch, fa, mp, card):
    """Tensor parallelism over a world-1 NCCL group, the mesh
    `get_mesh_3d(1, 1, 1)`, every step captured: the scanned gpt_medium
    with `tp_axis="model"` (the head-interleaved stack through the
    head-split flash kernels), the same unrolled (head-parallel MHA),
    BERT-base with `tp_axis`; each `DistOpt(SGD)` over the data axis,
    held to its twin without tp_axis from the same weights, with the
    flash launches by layout. Then `serve_gpt --tp 1` on gpt_medium
    against the same serve without --tp. Returns each step's launches
    by layout and the numbers."""
    import contextlib
    import io
    import re

    import torch.distributed as tdist

    from singa_tpu_torch import distributed, opt
    from singa_tpu_torch.examples import serve_gpt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.models.transformer import (BertForClassification,
                                                    states_to_tp)
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.parallel import tp as tp_module

    flash = dict(NO_LAUNCH, flash_fwd=12, flash_bwd_dq=12,
                 flash_bwd_dkv=12)
    split_12 = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
    zero = {k: 0 for k in split_12}
    launches, out = {}, {"card": card}

    distributed.init(device="cuda")
    try:
        check(tdist.get_backend() == "nccl" and tdist.get_world_size() == 1,
              f"the group is {tdist.get_backend()} at world "
              f"{tdist.get_world_size()}, not NCCL at 1")
        mesh = mesh_module.get_mesh_3d(1, 1, 1)
        check(mesh.shape == {"data": 1, "model": 1, "sp": 1},
              f"mesh {mesh.shape}")
        out["mesh"] = mesh.shape

        def train(make, states, x, y, per_step, layout, what, lr=TP_LR):
            m = make()
            m.set_optimizer(opt.DistOpt(opt.SGD(lr=lr, momentum=0.9),
                                        mesh=mesh, axis_name="data"))
            m.compile([x], is_train=True, use_graph=True)
            m.set_states(states)
            g0 = tp_module.COUNTS["g", "model"]
            got = {}
            losses, first_s, ms = captured_steps(
                torch, fa, mp, m, x, y, per_step, what, steps=TP_STEPS,
                layouts=got)
            check(got["first"] == layout and got["capture"] == layout,
                  f"{what}: flash launches by layout {got}, not {layout} "
                  f"in the first step and in the capture")
            check(all(np.isfinite(losses)), f"{what}: losses {losses}")
            psums = tp_module.COUNTS["g", "model"] - g0
            m.graph(False)
            del m
            drop_graphs(torch)
            return dict(losses=losses, first_step_s=first_s, step_ms=ms,
                        layouts=got, model_axis_psums=psums)

        def held(what, got, twin, tol):
            gap = max(abs(a - b) / max(abs(b), 1e-30)
                      for a, b in zip(got["losses"], twin["losses"]))
            bitwise = got["losses"] == twin["losses"]
            print(f"{what} ({card}): losses {got['losses']} vs the twin "
                  f"without tp_axis {twin['losses']}: max rel {gap:.3e} "
                  f"(tol {tol}), bitwise {bitwise}; {got['step_ms']:.2f} ms "
                  f"a captured step, the twin {twin['step_ms']:.2f} ms "
                  f"({100 * (got['step_ms'] / twin['step_ms'] - 1):+.1f}%)",
                  flush=True)
            check(gap <= tol, f"{what}: the losses differ from the twin")
            return dict(got, twin_losses=twin["losses"],
                        twin_step_ms=twin["step_ms"],
                        twin_layouts=twin["layouts"], loss_max_rel=gap,
                        bitwise=bitwise, tolerance=tol)

        rng = np.random.default_rng(SEED)
        for key, scan in (("scan", True), ("unrolled", False)):
            def gpt(tp_axis=None, scan=scan):
                return lambda: gpt_medium(scan_blocks=scan, dropout=0.0,
                                          tp_axis=tp_axis, device="cuda")

            probe = gpt()()
            load_singa_tpu_params(probe, seeded_params(probe, SEED))
            states = {k: v.detach().clone()
                      for k, v in probe.get_states().items()}
            vocab, heads = probe.vocab_size, probe.decoder.num_heads
            del probe
            drop_graphs(torch)
            if scan:
                # the tp stack stores its QKV head-interleaved
                tp_states = dict(states)
                for k in ("decoder.w_qkv", "decoder.b_qkv"):
                    tp_states[k] = tp_module.interleave_qkv_shards(
                        states[k], heads)
            else:
                tp_states = states_to_tp(
                    {k: v.cpu().numpy() for k, v in states.items()})
            seq = torch.from_numpy(rng.integers(
                0, vocab, (TP_BATCH, TP_SEQ + 1))).cuda()
            x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
            twin = train(gpt(), states, x, y, flash,
                         {"head_split": zero, "fused": split_12},
                         f"tp twin {key}")
            got = train(gpt("model"), tp_states, x, y, flash,
                        {"head_split": split_12, "fused": zero},
                        f"tp-{key}")
            # PSUMS_PER_BLOCK "g" a block in each forward Python runs:
            # step 1's and the capture's (the replays run none)
            check(got["model_axis_psums"] == 2 * 12 * tp_module.PSUMS_PER_BLOCK,
                  f"tp-{key}: {got['model_axis_psums']} model-axis "
                  f"all-reduces run from Python")
            launches[key] = got["layouts"]["first"]
            out[key] = held(f"tp-{key}", got, twin, TP_TWIN_TOL)
            out[key]["tokens_per_s"] = TP_BATCH * TP_SEQ / (
                got["step_ms"] / 1e3)
            del seq, x, y, states, tp_states
            drop_graphs(torch)

        # BERT-base: T 512 non-causal takes the plain attention on the tp
        # path (head-split threshold 1024), the fused kernel on the twin's
        def bert(tp_axis=None):
            return lambda: BertForClassification(
                2, vocab_size=30522, max_len=BERT_SEQ, dropout=0.0,
                tp_axis=tp_axis, device="cuda")

        probe = bert()()
        load_singa_tpu_params(probe, seeded_params(probe, SEED))
        states = {k: v.detach().clone() for k, v in probe.get_states().items()}
        vocab = probe.bert.tok.table.shape[0]
        del probe
        bx = torch.from_numpy(rng.integers(0, vocab,
                                           (BERT_BATCH, BERT_SEQ))).cuda()
        by = torch.from_numpy(rng.integers(0, 2, (BERT_BATCH,))).cuda()
        btwin = train(bert(), states, bx, by, flash,
                      {"head_split": zero, "fused": split_12},
                      "tp twin bert", SP_BERT_LR)
        bt = train(bert("model"), states_to_tp(
            {k: v.cpu().numpy() for k, v in states.items()}), bx, by,
            NO_LAUNCH, {"head_split": zero, "fused": zero}, "tp-bert",
            SP_BERT_LR)
        launches["bert"] = bt["layouts"]["first"]
        out["bert"] = held("tp-bert", bt, btwin, TP_BERT_TOL)
        out["bert"]["route"] = "plain attention (full_attention)"
        out["bert"]["tokens_per_s"] = BERT_BATCH * BERT_SEQ / (
            bt["step_ms"] / 1e3)
        del states, bx, by
        drop_graphs(torch)
    finally:
        distributed.shutdown()
        drop_graphs(torch)

    # serve_gpt --tp 1 against the same serve without --tp
    serves = {}
    for key, extra in [(f"{kind}_{i}", argv) for i in range(TP_SERVE_PAIRS)
                       for kind, argv in (("plain", []),
                                          ("tp1", ["--tp", "1"]))]:
        buf = io.StringIO()
        reset_counts(fa, mp)
        with contextlib.redirect_stdout(buf):
            handles = serve_gpt.main(TP_SERVE_ARGV + extra)
        text = buf.getvalue()
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("served "))
        num = re.search(r"(\d+) tokens in ([\d.]+) s .*p50 ([\d.]+) ms, "
                        r"p95 ([\d.]+) ms", line)
        n_tok, wall = int(num.group(1)), float(num.group(2))
        serves[key] = dict(
            tokens={h.rid: list(h.tokens) for h in handles},
            tokens_per_s=n_tok / wall, wall_s=wall,
            token_ms_p50=float(num.group(3)),
            token_ms_p95=float(num.group(4)), launches=counts(fa, mp),
            captures=[ln for ln in text.splitlines()
                      if ln.startswith("decode executables")])
        print(f"serve {key} ({card}): {line}", flush=True)
        drop_graphs(torch)
    for key in serves:
        check(serves[key]["tokens"] == serves["plain_0"]["tokens"],
              f"serve {key}: token streams differ from the serve without "
              f"--tp")
    out["serve"] = {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                    for k, v in serves.items()}
    spread = {}
    for kind in ("plain", "tp1"):
        for metric in ("tokens_per_s", "token_ms_p50", "token_ms_p95"):
            vals = [serves[f"{kind}_{i}"][metric]
                    for i in range(TP_SERVE_PAIRS)]
            spread[f"{kind}_{metric}"] = dict(
                min=min(vals), max=max(vals), mean=float(np.mean(vals)),
                spread_rel=(max(vals) - min(vals)) / float(np.mean(vals)))
    # each pair's ratio, tp over plain, run back to back
    spread["tp1_over_plain_tokens_per_s"] = [
        serves[f"tp1_{i}"]["tokens_per_s"] / serves[f"plain_{i}"][
            "tokens_per_s"] for i in range(TP_SERVE_PAIRS)]
    spread["tp1_over_plain_p50"] = [
        serves[f"tp1_{i}"]["token_ms_p50"] / serves[f"plain_{i}"][
            "token_ms_p50"] for i in range(TP_SERVE_PAIRS)]
    print(f"serve spread ({card}): " + json.dumps(spread), flush=True)
    out["serve"]["spread"] = spread
    out["serve"]["streams_equal"] = True
    out["serve"]["streams"] = len(serves["plain_0"]["tokens"])
    return launches, out


# -- phase 9k: ZeRO-3 on the scanned stack, the 3-D recipe, the MoE FFN ---------

#: the zero3 and tp x zero3 steps: gpt_medium's full width at phase 9j's
#: batch and T, fp32; each against its twin without zero3_axis (the
#: zero3 steps within 1e-6 of the loss: the same kernels on the same
#: values, the weights gathered by one-rank copies; the tp x zero3 step
#: at phase 9j's TP_TWIN_TOL, its twin being the stack without tp)
Z3_BATCH, Z3_SEQ, Z3_STEPS, Z3_LR, Z3_TWIN_TOL = 4, 1024, 4, SP_LR, 1e-6
#: bench.py's 3-D recipe (bench.py:1276-1277, :1690-1718): batch 8 x 1024,
#: bf16, DistOpt(AdamW(1e-4)); overlap and serial back to back
RECIPE_BATCH, RECIPE_LR = 8, 1e-4
#: the MoE GPT: gpt_medium unrolled with 8 experts a block (capacity
#: factor 1.25, ceil(4096 / 8 * 1.25) = 640 slots an expert), fp32
MOE_EXPERTS, MOE_TWIN_TOL = 8, 1e-6
#: MoEFFN against `plain_moe`, fp32 (TF32 off): max |Δ| of the output
#: and of every gradient over that tensor's largest entry. Both sides
#: compute the same gate logits with the same product, so they route
#: alike; one token in a wrong slot, or weighed by a wrong probability,
#: moves a row by the order of the row itself
MOE_PLAIN_TOL = 1e-4
#: the step's capacity factor, then a tight one that drops tokens
MOE_PLAIN_CFS = (1.25, 0.5)


def plain_moe(torch, h, w_gate, w1, b1, w2, b2, cf, act):
    """Switch top-1 MoE written apart from parallel/moe.py: softmax and
    argmax, each expert's queue by a cumulative sum of its token mask and
    the capacity drop, a Python loop over the experts each running its
    FFN on every token, and a dense masked combine. Returns (y, aux,
    tokens dropped)."""
    n, e = h.shape[0], w_gate.shape[1]
    cap = int(np.ceil(n / e * cf))
    probs = torch.softmax(h @ w_gate, dim=-1)
    mask = torch.nn.functional.one_hot(probs.argmax(dim=-1), e).to(h.dtype)
    kept = mask * (torch.cumsum(mask, dim=0) <= cap).to(h.dtype)
    gate = (probs * mask).sum(dim=-1)
    y = torch.zeros_like(h)
    for i in range(e):
        out = act(h @ w1[i] + b1[i]) @ w2[i] + b2[i]
        y = y + (kept[:, i] * gate)[:, None] * out
    aux = e * (mask.mean(dim=0) * probs.mean(dim=0)).sum()
    return y, aux, int(n - kept.sum().item())


def moe_vs_plain(torch, ffn, mesh):
    """One MoEFFN forward and backward at the MoE step's shapes (4096
    tokens of d 1024, the layer's 8 experts), inside the expert axis
    (`moe_ffn`, the step's path) and outside it (`moe_ffn_dense`, the
    twin's), at each of MOE_PLAIN_CFS, against `plain_moe` on the same
    seeded inputs: y, aux and the gradients of sum(y * r) + aux for the
    tokens and all five weights."""
    from singa_tpu_torch.parallel import mesh as mesh_module

    F = torch.nn.functional
    acts = {"relu": F.relu, "tanh": torch.tanh,
            "gelu": lambda a: F.gelu(a, approximate="tanh")}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n, d = Z3_BATCH * Z3_SEQ, ffn.w_gate.shape[0]
    h = torch.randn(n, d, device="cuda", generator=gen)
    r = torch.randn(n, d, device="cuda", generator=gen)
    names = ("w_gate", "w1", "b1", "w2", "b2")
    weights = [getattr(ffn, k).detach() for k in names]

    def fwd_bwd(fn, ws):
        leaves = [h.clone().requires_grad_(True)] + ws
        y, aux, *rest = fn(*leaves)
        grads = torch.autograd.grad((y * r).sum() + aux, leaves)
        return [y.detach(), aux.detach()] + list(grads), rest

    def layer_fn(ep):
        def run(hh, *_):  # the weights are the layer's own parameters
            if not ep:
                return ffn(hh), ffn.aux
            with mesh_module.axis_context(ffn.moe_axis, mesh=mesh):
                return ffn(hh), ffn.aux
        return run

    out, cf0 = {}, ffn.capacity_factor
    try:
        for cf in MOE_PLAIN_CFS:
            ffn.capacity_factor = cf
            want, (dropped,) = fwd_bwd(lambda *a: plain_moe(
                torch, *a, cf, acts[ffn.activation]),
                [w.clone().requires_grad_(True) for w in weights])
            for path, ep in (("moe_ffn", True), ("moe_ffn_dense", False)):
                got, _ = fwd_bwd(layer_fn(ep),
                                 [getattr(ffn, k) for k in names])
                errs = {}
                for k, a, b in zip(("y", "aux", "d_x") + tuple(
                        f"d_{k}" for k in names), got, want):
                    errs[k] = float((a - b).abs().max() / b.abs().max()
                                    .clamp(min=1e-30))
                worst = max(errs.values())
                print(f"moe vs plain, {path}, capacity factor {cf} "
                      f"({dropped} of {n} tokens dropped): max |Δ| / max "
                      f"|ref| {worst:.3e} (tol {MOE_PLAIN_TOL}) {errs}",
                      flush=True)
                check(worst <= MOE_PLAIN_TOL,
                      f"MoEFFN ({path}, capacity factor {cf}) disagrees "
                      f"with the plain MoE: {errs}")
                out[f"{path}_cf{cf}"] = dict(rel_err=errs, dropped=dropped)
    finally:
        ffn.capacity_factor = cf0
    return dict(out, tolerance=MOE_PLAIN_TOL)


def moe_families(torch, fa, m, x):
    """Device ms of one fp32 forward and backward of each family of the
    MoE step at its shapes (one block's input, taken from `x`), by CUDA
    events, and that times the blocks: the gate (`route_top1`), dispatch
    and combine (the index_add and the row gather), the expert products
    (the batched FFNs at 640 slots an expert) and attention (the fused
    flash kernels)."""
    from singa_tpu_torch import autograd
    from singa_tpu_torch.parallel import moe

    blk = m.decoder.blocks[0]
    ffn = blk.ffn
    n_blocks = len(m.decoder.blocks)
    with torch.no_grad():
        h = m.tok(x).reshape(-1, m.d_model).contiguous()
    e = ffn.n_experts
    cap = int(np.ceil(h.shape[0] / e * ffn.capacity_factor))
    slot, weight, _ = moe.route_top1(h, ffn.w_gate, e, cap)
    slot, weight = slot.detach(), weight.detach()
    q = moe._dispatch(h, slot, e * cap).reshape(e, cap, -1).detach()
    qkv = torch.randn(x.shape[0], x.shape[1], 3 * m.d_model,
                      device=x.device) * 0.5
    w = [t.detach().requires_grad_(True) for t in (
        ffn.w_gate, ffn.w1, ffn.b1, ffn.w2, ffn.b2)]

    def fb(fn, *leaves):
        leaves = [t.detach().requires_grad_(True) for t in leaves]

        def run():
            out = fn(*leaves)
            outs = out if isinstance(out, tuple) else (out,)
            torch.autograd.grad(sum(o.float().sum() for o in outs), leaves,
                                allow_unused=True)
        return run

    fams = {
        "gate": fb(lambda a, g: moe.route_top1(a, g, e, cap)[1:], h, w[0]),
        "dispatch_combine": fb(lambda a, wt: moe._combine(
            moe._dispatch(a, slot, e * cap), slot, wt), h, weight),
        "expert_products": fb(lambda a, *ws: moe._experts(
            a, *ws, autograd.gelu), q, *w[1:]),
        "attention": fb(lambda a: fa.attention_qkv(a, m.decoder.num_heads,
                                                   causal=True), qkv),
    }
    out = {}
    for k, fn in fams.items():
        ms = cuda_ms(torch, fn, iters=10, warmup=2)
        out[k] = dict(ms_a_block=ms, ms_a_step=ms * n_blocks)
    return out


def zero3_path(torch, fa, mp, card):
    """ZeRO-3 and the MoE FFN over a world-1 NCCL group, every step
    captured: the scanned gpt_medium with `zero3_axis="data"` serial and
    with `overlap=True`, each against its twin without zero3_axis; with
    `tp_axis="model"` beside it (the head-split kernels); bench.py's 3-D
    recipe (tp x zero3 x seq, bf16, AdamW) with overlap and serial back
    to back (at world 1 the seq axis takes the plain ring: no flash
    kernel); and the unrolled gpt_medium with 8 experts a block and
    `moe_axis="expert"` on a (data 1, expert 1) mesh against its twin
    without moe_axis (the dense formulation, the same capacity at world
    1). Returns each step's launches by layout and the numbers."""
    from singa_tpu_torch import autograd, distributed, graph, opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.parallel import tp as tp_module

    fused_12 = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
    zero = {k: 0 for k in fused_12}
    flash = dict(NO_LAUNCH, **fused_12)
    # overlap's backward recomputes each block's forward: 24 forward
    # launches a step
    flash_overlap = dict(flash, flash_fwd=24)
    launches, out = {}, {"card": card}
    distributed.init(device="cuda")
    try:
        mesh = mesh_module.get_mesh_3d(1, 1, 1)
        ep_mesh = mesh_module.get_mesh((1, 1), ("data", "expert"))
        check(mesh.shape == {"data": 1, "model": 1, "sp": 1},
              f"mesh {mesh.shape}")

        def train(make, states, x, y, per_step, layout, what, mesh=mesh,
                  optimizer=None, precision=None, steps=Z3_STEPS):
            m = make()
            m.set_optimizer(opt.DistOpt(
                optimizer() if optimizer else opt.SGD(lr=Z3_LR,
                                                      momentum=0.9),
                mesh=mesh, axis_name="data"))
            m.compile([x], is_train=True, use_graph=True,
                      precision=precision)
            m.set_states(states)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            got = {}
            try:
                losses, first_s, ms = captured_steps(
                    torch, fa, mp, m, x, y, per_step, what, steps=steps,
                    layouts=got)
            finally:
                autograd.set_autocast(False)
            peak = torch.cuda.max_memory_allocated()
            check(got["first"] == layout and got["capture"] == layout,
                  f"{what}: flash launches by layout {got}, not {layout} "
                  f"in the first step and in the capture")
            check(all(np.isfinite(losses)), f"{what}: losses {losses}")
            gathered = graph._step_for(m, True)._gathered_block_bytes()
            params = sum(p.numel() for p in m.parameters())
            m.graph(False)
            del m
            drop_graphs(torch)
            return dict(losses=losses, first_step_s=first_s, step_ms=ms,
                        layouts=got, peak_bytes=peak,
                        gathered_block_bytes=gathered,
                        params_on_rank=params,
                        tokens_per_s=x.numel() / (ms / 1e3))

        def held(what, got, twin, tol):
            gap = max(abs(a - b) / max(abs(b), 1e-30)
                      for a, b in zip(got["losses"], twin["losses"]))
            print(f"{what} ({card}): losses {got['losses']} vs the twin "
                  f"{twin['losses']}: max rel {gap:.3e} (tol {tol}); "
                  f"{got['step_ms']:.2f} ms a captured step, the twin "
                  f"{twin['step_ms']:.2f} ms "
                  f"({100 * (got['step_ms'] / twin['step_ms'] - 1):+.1f}%); "
                  f"peak {got['peak_bytes'] / 2**30:.2f} GiB (twin "
                  f"{twin['peak_bytes'] / 2**30:.2f}); gathered block "
                  f"bytes {got['gathered_block_bytes']}", flush=True)
            check(gap <= tol, f"{what}: the losses differ from the twin")
            return dict(got, twin_losses=twin["losses"],
                        twin_step_ms=twin["step_ms"],
                        twin_peak_bytes=twin["peak_bytes"],
                        loss_max_rel=gap, tolerance=tol)

        rng = np.random.default_rng(SEED)

        def gpt(**kw):
            return lambda: gpt_medium(device="cuda", **kw)

        probe = gpt()()
        load_singa_tpu_params(probe, seeded_params(probe, SEED))
        states = {k: v.detach().clone() for k, v in probe.get_states().items()}
        vocab, heads = probe.vocab_size, probe.decoder.num_heads
        del probe
        drop_graphs(torch)
        tp_states = dict(states)
        for k in ("decoder.w_qkv", "decoder.b_qkv"):
            tp_states[k] = tp_module.interleave_qkv_shards(states[k], heads)
        seq = torch.from_numpy(rng.integers(
            0, vocab, (Z3_BATCH, Z3_SEQ + 1))).cuda()
        x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()

        # 1. zero3 alone, serial and overlapped, against the twin
        fused = {"head_split": zero, "fused": fused_12}
        twin = train(gpt(), states, x, y, flash, fused, "zero3 twin")
        z3 = train(gpt(zero3_axis="data"), states, x, y, flash, fused,
                   "zero3")
        out["zero3"] = held("zero3", z3, twin, Z3_TWIN_TOL)
        launches["zero3"] = z3["layouts"]["first"]
        ov = train(gpt(zero3_axis="data", overlap=True), states, x, y,
                   flash_overlap, {"head_split": zero,
                                   "fused": dict(fused_12, flash_fwd=24)},
                   "zero3 overlap")
        out["zero3_overlap"] = held("zero3 overlap", ov, twin, Z3_TWIN_TOL)
        launches["zero3_overlap"] = ov["layouts"]["first"]
        check(ov["gathered_block_bytes"] == 2 * z3["gathered_block_bytes"]
              > 0, "gathered_block_bytes: not one block serial, two "
                   "overlapped")

        # 2. tp x zero3: the head-split kernels
        split = {"head_split": fused_12, "fused": zero}
        tz = train(gpt(tp_axis="model", zero3_axis="data"), tp_states, x, y,
                   flash, split, "tp x zero3")
        out["tp_zero3"] = held("tp x zero3", tz, twin, TP_TWIN_TOL)
        launches["tp_zero3"] = tz["layouts"]["first"]
        del seq, x, y

        # 3. bench.py's 3-D recipe, overlap then serial, bf16, AdamW
        seq = torch.from_numpy(rng.integers(
            0, vocab, (RECIPE_BATCH, Z3_SEQ + 1))).cuda()
        x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
        recipe = {}
        none = {"head_split": zero, "fused": zero}
        for key, overlap in (("overlap", True), ("serial", False)):
            recipe[key] = train(
                gpt(tp_axis="model", zero3_axis="data", seq_axis="sp",
                    overlap=overlap), tp_states, x, y, NO_LAUNCH, none,
                f"3-D recipe {key}",
                optimizer=lambda: opt.AdamW(lr=RECIPE_LR), precision="bf16")
            print(f"3-D recipe {key} ({card}): "
                  f"{recipe[key]['tokens_per_s']:.1f} tokens/s, "
                  f"{recipe[key]['step_ms']:.2f} ms a captured step, peak "
                  f"{recipe[key]['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
            recipe["overlap"]["losses"], recipe["serial"]["losses"]))
        check(gap <= TWIN_TOL["bf16"],
              f"3-D recipe: overlap and serial losses differ by {gap:.3e}")
        recipe["overlap_vs_serial_loss_max_rel"] = gap
        out["recipe_3d"] = recipe
        launches["recipe_3d"] = recipe["overlap"]["layouts"]["first"]
        del seq, x, y, states, tp_states
        drop_graphs(torch)

        # 4. the MoE GPT (unrolled, 8 experts a block) against its twin
        def moe(moe_axis):
            return lambda: gpt_medium(
                device="cuda", scan_blocks=False, moe_experts=MOE_EXPERTS,
                moe_axis=moe_axis)

        probe = moe(None)()
        mstates = seeded_params(probe, SEED)
        for k in mstates:  # the expert biases at a bias's scale
            if k.endswith(("ffn.b1", "ffn.b2")):
                mstates[k] = 0.02 * mstates[k] / np.float32(
                    MOE_EXPERTS ** -0.5)
        n_params = sum(p.numel() for p in probe.parameters())
        del probe
        drop_graphs(torch)
        seq = torch.from_numpy(rng.integers(
            0, vocab, (Z3_BATCH, Z3_SEQ + 1))).cuda()
        x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
        mtwin = train(moe(None), mstates, x, y, flash, fused, "moe twin",
                      mesh=ep_mesh)
        mo = train(moe("expert"), mstates, x, y, flash, fused, "moe",
                   mesh=ep_mesh)
        out["moe"] = held("moe", mo, mtwin, MOE_TWIN_TOL)
        out["moe"]["n_params"] = n_params
        launches["moe"] = mo["layouts"]["first"]
        m = moe("expert")()
        load_singa_tpu_params(m, mstates)
        out["moe"]["vs_plain"] = moe_vs_plain(
            torch, m.decoder.blocks[0].ffn, ep_mesh)
        out["moe"]["families"] = moe_families(torch, fa, m, x)
        print(f"moe families ({card}): " + json.dumps(
            out["moe"]["families"]), flush=True)
        del m, seq, x, y, mstates
        drop_graphs(torch)
    finally:
        autograd.set_autocast(False)
        distributed.shutdown()
        drop_graphs(torch)
    return launches, out


PP_BATCH, PP_SEQ, PP_MICRO, PP_STEPS, PP_LR, PP_TWIN_TOL = (
    4, 1024, 4, 4, SP_LR, 1e-6)


class _Stamped:
    """A stdout that prints each line with the seconds since the line
    before it (an entry of the strategies runner: its wall time)."""

    def __init__(self, out):
        self.out, self.buf, self.last = out, "", time.perf_counter()
        self.lines = []

    def write(self, text):
        self.buf += text
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            now = time.perf_counter()
            self.lines.append((line, now - self.last))
            self.out.write(f"{line}  [{now - self.last:.2f} s]\n")
            self.last = now
        return len(text)

    def flush(self):
        self.out.flush()


def pp_path(torch, fa, mp, card):
    """GPipe over a world-1 NCCL group (`pp_path`): gpt_medium's widths
    with `pp_axis="pipe"`, `pp_micro=4` (the unrolled-width decoder as a
    `PipelineTransformerStack`, dropout 0) at 4 x 1024 fp32 with
    DistOpt(SGD) on a (data 1, pipe 1) mesh, every step captured,
    against its twin: the same model and states trained on a (data 1)
    mesh, where the pipe axis is not live and the stack loops over its
    blocks on the whole batch. Each block of each microbatch runs the
    head-split flash kernels: 48 launches of each a step, the twin 12.
    Then every entry of `examples.parallel_strategies` that a world of
    one admits, uncaptured, each line with its wall time. Returns the
    pp step's and the twin's launches by layout and the numbers."""
    from singa_tpu_torch import distributed, opt
    from singa_tpu_torch.examples import parallel_strategies
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.parallel import mesh as mesh_module

    split_48 = {"flash_fwd": 48, "flash_bwd_dq": 48, "flash_bwd_dkv": 48}
    zero = {k: 0 for k in split_48}
    launches, out = {}, {"card": card}
    distributed.init(device="cuda")
    try:
        pp_mesh = mesh_module.get_mesh((1, 1), ("data", "pipe"))
        dp_mesh = mesh_module.get_mesh((1,), ("data",))

        def make():
            return gpt_medium(device="cuda", scan_blocks=False,
                              pp_axis="pipe", pp_micro=PP_MICRO)

        probe = make()
        load_singa_tpu_params(probe, seeded_params(probe, SEED))
        states = {k: v.detach().clone() for k, v in probe.get_states().items()}
        n_params = sum(p.numel() for p in probe.parameters())
        vocab = probe.vocab_size
        del probe
        drop_graphs(torch)
        rng = np.random.default_rng(SEED)
        seq = torch.from_numpy(rng.integers(
            0, vocab, (PP_BATCH, PP_SEQ + 1))).cuda()
        x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()

        def train(mesh, per_block, what):
            m = make()
            m.set_optimizer(opt.DistOpt(opt.SGD(lr=PP_LR), mesh=mesh,
                                        axis_name="data"))
            m.compile([x], is_train=True, use_graph=True)
            m.set_states(states)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            layout = {"head_split": per_block, "fused": zero}
            got = {}
            losses, first_s, ms = captured_steps(
                torch, fa, mp, m, x, y, dict(NO_LAUNCH, **per_block), what,
                steps=PP_STEPS, layouts=got)
            peak = torch.cuda.max_memory_allocated()
            check(got["first"] == layout and got["capture"] == layout,
                  f"{what}: flash launches by layout {got}, not {layout} "
                  f"in the first step and in the capture")
            check(all(np.isfinite(losses)), f"{what}: losses {losses}")
            device_ms = cuda_ms(torch, lambda: m(x, y), iters=5, warmup=1)
            placed = tuple(m.decoder.w_qkv.placed[1])
            m.graph(False)
            del m
            drop_graphs(torch)
            return dict(losses=losses, first_step_s=first_s,
                        step_ms=ms, device_ms=device_ms, peak_bytes=peak,
                        layouts=got, w_qkv_spec=placed,
                        tokens_per_s=x.numel() / (device_ms / 1e3))

        t = time.perf_counter()
        twin = train(dp_mesh, {k: 12 for k in split_48}, "pp twin")
        pp = train(pp_mesh, split_48, "pp")
        check(pp["w_qkv_spec"] == ("pipe", None, None)
              and twin["w_qkv_spec"] == (None, None, None),
              f"pipe specs {pp['w_qkv_spec']}, {twin['w_qkv_spec']}")
        gap = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(pp["losses"], twin["losses"]))
        print(f"pp ({card}): gpt_medium widths, pp_micro {PP_MICRO}, "
              f"{n_params} parameters; losses {pp['losses']} vs the twin "
              f"{twin['losses']}: max rel {gap:.3e} (tol {PP_TWIN_TOL}); "
              f"{pp['device_ms']:.2f} device ms a captured step, the twin "
              f"{twin['device_ms']:.2f} "
              f"({100 * (pp['device_ms'] / twin['device_ms'] - 1):+.1f}%); "
              f"peak {pp['peak_bytes'] / 2**30:.2f} GiB (twin "
              f"{twin['peak_bytes'] / 2**30:.2f}); "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        check(gap <= PP_TWIN_TOL, "pp: the losses differ from the twin")
        out["pp_gpt_medium"] = dict(
            pp, twin_losses=twin["losses"], twin_step_ms=twin["step_ms"],
            twin_device_ms=twin["device_ms"],
            twin_peak_bytes=twin["peak_bytes"], loss_max_rel=gap,
            tolerance=PP_TWIN_TOL, n_params=n_params, n_micro=PP_MICRO,
            bubble=0.0)
        launches["pp"] = pp["layouts"]["first"]
        launches["pp_twin"] = twin["layouts"]["first"]
        del seq, x, y, states
        drop_graphs(torch)

        # every strategy a world of one admits, uncaptured
        reset_counts(fa, mp)
        t = time.perf_counter()
        stamped = _Stamped(sys.stdout)
        real, sys.stdout = sys.stdout, stamped
        try:
            parallel_strategies.run([0])
        finally:
            sys.stdout = real
        lines = stamped.lines
        check(lines and lines[-1][0].endswith(": OK"),
              "parallel_strategies did not print its closing line")
        out["strategies"] = dict(
            seconds=time.perf_counter() - t, launches=counts(fa, mp),
            entries=[dict(line=ln, s=s) for ln, s in lines])
        print(f"parallel_strategies ({card}): {len(lines)} lines in "
              f"{out['strategies']['seconds']:.1f} s; launches "
              f"{out['strategies']['launches']}", flush=True)
    finally:
        distributed.shutdown()
        drop_graphs(torch)
    return launches, out


# -- phase 9m: the disaggregated prefill, the sharded speculative round, the
# metrics endpoint -------------------------------------------------------------

#: serve_gpt with the tiny draft, with and without --tp 1, and with the
#: metrics endpoint: gpt_medium, window 1024, 8 slots
DISAGG_SPEC_ARGV = ["--gpt-medium", "--window", "1024", "--slots", "8",
                    "--requests", "8", "--max-new", "64", "--draft", "tiny"]
DISAGG_METRICS_ARGV = ["--gpt-medium", "--window", "1024", "--slots", "8",
                       "--requests", "16", "--max-new", "64",
                       "--metrics-port", "0"]
#: the serving gauges and histogram the metrics page must carry
SERVE_PAGE_NAMES = ("serve_queue_depth", "serve_slot_occupancy",
                    "serve_kv_utilization", "serve_kv_blocks_used",
                    "serve_token_ms_bucket", "serve_token_ms_count",
                    "serve_tokens")


def admit_ms(torch, eng, reqs, reps=5):
    """Host ms of admitting `reqs` (one prefill batch) on an idle engine,
    synchronized before and after: the prefill, its K/V's way into the
    pools and the first-token pick; the slots are evicted after each."""
    out = []
    for _ in range(reps):
        batch = fresh(reqs)
        torch.cuda.synchronize()
        t = time.perf_counter()
        slots = eng.admit_many(batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
        for slot in slots:
            eng.evict(slot)
    return out


def step_ms_live(torch, eng, reqs):
    """Device ms of the captured decode step (a graph replay) with
    `reqs` admitted; they are evicted after (the replays' writes land
    in rows the next admission rewrites first)."""
    slots = eng.admit_many(fresh(reqs))
    with torch.inference_mode():
        eng._upload()
        ms = cuda_ms(torch, eng._run_step, iters=20, warmup=3)
    for slot in slots:
        eng.evict(slot)
    return ms


class _P2PCount:
    """Counts the point-to-point calls of torch.distributed while
    entered (the disaggregated prefill at world 1 must issue none)."""

    NAMES = ("send", "recv", "isend", "irecv", "batch_isend_irecv")

    def __init__(self, dist):
        self.dist, self.calls, self.saved = dist, 0, {}

    def __enter__(self):
        for name in self.NAMES:
            fn = self.saved[name] = getattr(self.dist, name)

            def counted(*a, _fn=fn, **k):
                self.calls += 1
                return _fn(*a, **k)

            setattr(self.dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def _serve_lines(torch, serve_gpt, argv, card, what):
    """serve_gpt.main(argv) with its output captured: (handles, text,
    the "served" line's tokens/s)."""
    import contextlib
    import io
    import re

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        handles = serve_gpt.main(argv)
    text = buf.getvalue()
    line = next(ln for ln in text.splitlines() if ln.startswith("served "))
    num = re.search(r"(\d+) tokens in ([\d.]+) s", line)
    print(f"disagg {what} ({card}): {line}", flush=True)
    drop_graphs(torch)
    return handles, text, int(num.group(1)) / float(num.group(2))


def disagg_path(torch, fa, mp, card):
    """Phase 9m over a world-1 NCCL group, gpt_medium at full width with
    seeded weights, window 1024, 8 slots:

    1. the engine with `prefill_mesh` on a (data 1) mesh, with a
       single-device decode and with a (model 1) tp decode, in turns
       with the plain engine, twice each, on the serve mix (prefill
       batch 2): equal streams, no point-to-point call (both meshes are
       the one rank), one decode capture; prefill ms a batch of 2 and
       the decode step's device ms;
    2. `SpeculativeEngine(mesh=(model 1), tp_axis="model", spec_k=4)` on
       the spec mix, with the target as its own draft and with
       `gpt_draft(target)`, in turns with the single-device speculative
       engine: equal streams, one capture each of propose and verify,
       the self draft accepting at least 0.9; propose and verify ms,
       tokens a round, decode tokens/s;
    3. `serve_gpt --gpt-medium --tp 1 --draft tiny` against `--draft
       tiny` without `--tp`: equal streams;
    4. `serve_gpt --gpt-medium --metrics-port 0`, a thread scraping
       `/metrics` and `/healthz` during the serve.

    Each part is counted alone and launches no flash or K2a kernel.
    Returns the numbers."""
    import re
    import threading
    import urllib.error
    import urllib.request

    import torch.distributed as tdist

    from singa_tpu_torch import distributed
    from singa_tpu_torch.examples import serve_gpt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_draft, gpt_medium
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.serving import ServingEngine, SpeculativeEngine

    W = SERVE_WINDOW
    t_phase = time.perf_counter()
    out = {"card": card}
    model = gpt_medium(device="cuda")
    load_singa_tpu_params(model, seeded_params(model, SEED))
    model.eval()
    tiny = gpt_draft(model)
    load_singa_tpu_params(tiny, seeded_params(tiny, SEED + 1))
    tiny.eval()
    vocab = model.vocab_size
    mix = serve_requests(np.random.default_rng(SEED), vocab, 16, 64, 768,
                         32, 128, W)
    spec_mix = serve_requests(np.random.default_rng(SEED + 7), vocab, 8,
                              64, 512, 32, 64, W)
    long2 = serve_requests(np.random.default_rng(SEED + 9), vocab, 2, 512,
                           512, 64, 64, W)

    distributed.init(device="cuda")
    try:
        check(tdist.get_backend() == "nccl" and tdist.get_world_size() == 1,
              f"the group is {tdist.get_backend()} at world "
              f"{tdist.get_world_size()}, not NCCL at 1")
        pmesh = mesh_module.get_mesh((1,), ("data",))
        dmesh = mesh_module.get_mesh((1,), ("model",))

        # 1. the disaggregated prefill against the plain engine
        reset_counts(fa, mp)
        t = time.perf_counter()
        runs = {}
        for which in ("plain", "single", "tp", "tp", "single", "plain"):
            kw = dict(slots=8, block_size=16, window=W, prefill_batch=2)
            if which != "plain":
                kw["prefill_mesh"] = pmesh
            if which == "tp":
                kw.update(mesh=dmesh, tp_axis="model")
            eng = ServingEngine(model, **kw)
            check(eng._graph is not None and eng.decode_compiles == 1,
                  f"{which}: the decode step was not captured")
            if which != "plain":
                check(eng._plan.decode == (0,) and eng._plan.owners == (0,),
                      f"{which}: the plan is {eng._plan.decode} <- "
                      f"{eng._plan.owners}, not rank 0 <- rank 0")
            reqs = fresh(mix)
            with _P2PCount(tdist) as p2p:
                n_dec, wall, _ = drive(eng, reqs)
                prefill = admit_ms(torch, eng, long2)
                step = step_ms_live(torch, eng, mix[:8])
                eng.close()
            check(p2p.calls == 0, f"{which}: {p2p.calls} point-to-point "
                                  f"calls at world 1")
            check(all(r.done and len(r.tokens) == r.max_new for r in reqs),
                  f"{which}: a request did not end with max_new tokens")
            check(eng.allocator.used_blocks == 0 and not eng.allocator._ref,
                  f"{which}: the allocator did not drain")
            check(eng.decode_compiles == 1, f"{which}: decode recaptured")
            row = dict(decode_tokens_per_s=n_dec / wall,
                       decode_tokens=n_dec, steps=eng.steps,
                       prefill_batch2_ms=float(np.median(prefill)),
                       prefill_batch2_ms_min=min(prefill),
                       decode_step_ms=step,
                       decode_compiles=eng.decode_compiles)
            runs.setdefault(which, []).append(([r.tokens for r in reqs],
                                               row))
            print(f"disagg [{which}]: " + ", ".join(
                f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()) + f" ({card})", flush=True)
            del eng
            torch.cuda.empty_cache()
        for which in ("plain", "single", "tp"):
            for toks, _ in runs[which]:
                check(toks == runs["plain"][0][0],
                      f"disagg {which}: streams differ from the plain "
                      f"engine's")
        out["disaggregated"] = {w: [row for _, row in runs[w]]
                                for w in runs}
        launched = counts(fa, mp)
        check(launched == NO_LAUNCH,
              f"the disaggregated prefill launched {launched}")
        out["disaggregated_s"] = time.perf_counter() - t

        # 2. the sharded speculative round against the single-device one
        reset_counts(fa, mp)
        t = time.perf_counter()
        spec = {}
        for which, dname in (("single", "self"), ("tp", "self"),
                             ("tp", "tiny"), ("single", "tiny")):
            kw = dict(slots=8, block_size=16, window=W)
            if which == "tp":
                kw.update(mesh=dmesh, tp_axis="model")
            eng = SpeculativeEngine(model, model if dname == "self"
                                    else tiny, spec_k=SPEC_K, **kw)
            check(eng._propose_graph is not None
                  and eng._verify_graph is not None,
                  f"{which} {dname}: propose or verify not captured")
            reqs = fresh(spec_mix)
            eng.admit_many(reqs)
            with torch.inference_mode():
                eng._upload()
                proposed = eng._run_propose()
                prop_ms = cuda_ms(torch, eng._run_propose, iters=10)
                ver_ms = cuda_ms(torch, lambda: eng._run_verify(proposed),
                                 iters=10)
            n_dec, wall, streams = drive(eng, reqs)
            check(all(r.done and len(r.tokens) == r.max_new for r in reqs),
                  f"{which} {dname}: a request did not end with max_new")
            check(eng.decode_compiles == 1 and eng.verify_compiles == 1,
                  f"{which} {dname}: propose {eng.decode_compiles}, verify "
                  f"{eng.verify_compiles} captures")
            row = dict(propose_ms=prop_ms, verify_ms=ver_ms,
                       tokens_per_round=n_dec / streams, rounds=eng.steps,
                       decode_tokens_per_s=n_dec / wall,
                       acceptance=eng.acceptance_rate,
                       captures=(eng.decode_compiles, eng.verify_compiles))
            spec[f"{which}_{dname}"] = ([r.tokens for r in reqs], row)
            print(f"disagg spec [{which} {dname}]: " + ", ".join(
                f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()) + f" ({card})", flush=True)
            del eng
            torch.cuda.empty_cache()
        for dname in ("self", "tiny"):
            check(spec[f"tp_{dname}"][0] == spec[f"single_{dname}"][0],
                  f"the sharded round with the {dname} draft streams other "
                  f"tokens than the single-device one")
        for which in ("single", "tp"):
            acc = spec[f"{which}_self"][1]["acceptance"]
            check(acc >= 0.9, f"{which} self draft acceptance {acc:.3f}")
        out["speculative"] = {k: row for k, (_, row) in spec.items()}
        launched = counts(fa, mp)
        check(launched == NO_LAUNCH,
              f"the sharded speculative round launched {launched}")
        out["speculative_s"] = time.perf_counter() - t
    finally:
        distributed.shutdown()
        del model, tiny
        drop_graphs(torch)

    # 3. serve_gpt --tp 1 --draft tiny against --draft tiny
    reset_counts(fa, mp)
    t = time.perf_counter()
    plain, _, plain_tps = _serve_lines(torch, serve_gpt, DISAGG_SPEC_ARGV,
                                       card, "draft tiny")
    sharded, text, tp_tps = _serve_lines(
        torch, serve_gpt, DISAGG_SPEC_ARGV + ["--tp", "1"], card,
        "draft tiny --tp 1")
    check([list(h.tokens) for h in sharded]
          == [list(h.tokens) for h in plain],
          "serve_gpt --tp 1 --draft tiny streams differ from --draft tiny")
    check("verify executables: 1" in text, "--tp 1 --draft: verify "
                                           "recaptured")
    launched = counts(fa, mp)
    check(launched == NO_LAUNCH, f"serve_gpt --draft launched {launched}")
    out["serve_gpt_draft"] = dict(tokens_per_s=plain_tps,
                                  tp1_tokens_per_s=tp_tps,
                                  streams=len(plain), s=time.perf_counter()
                                  - t)

    # 4. serve_gpt --metrics-port 0, scraped during the serve
    reset_counts(fa, mp)
    t = time.perf_counter()
    import contextlib
    import io

    buf = io.StringIO()
    seen = {"scrapes": 0, "page": None, "healthz": None}
    stop = threading.Event()

    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def scrape():
        url = None
        while not stop.is_set():
            if url is None:
                m = re.search(r"metrics: (http://\S+)", buf.getvalue())
                url = m.group(1) if m else None
            else:
                try:
                    page, hz = get(url + "/metrics"), get(url + "/healthz")
                except (urllib.error.URLError, ConnectionError):
                    break   # the serve ended and stopped its server
                seen["scrapes"] += 1
                if "serve_token_ms_count" in page[1]:
                    seen["page"], seen["healthz"] = page, hz
            stop.wait(0.05)

    th = threading.Thread(target=scrape, daemon=True)
    th.start()
    with contextlib.redirect_stdout(buf):
        handles = serve_gpt.main(DISAGG_METRICS_ARGV)
    stop.set()
    th.join(10)
    drop_graphs(torch)
    check(all(len(h.tokens) == 64 for h in handles),
          "the metrics serve did not serve every request")
    check(seen["page"] is not None, f"no /metrics page with the serving "
                                    f"histogram in {seen['scrapes']} "
                                    f"scrapes during the serve")
    code, page = seen["page"]
    missing = [n for n in SERVE_PAGE_NAMES if n not in page]
    check(code == 200 and not missing, f"/metrics {code}, missing {missing}")
    check(seen["healthz"][0] == 200, f"/healthz {seen['healthz']}")
    launched = counts(fa, mp)
    check(launched == NO_LAUNCH, f"the metrics serve launched {launched}")
    out["metrics_serve"] = dict(scrapes=seen["scrapes"],
                                page_lines=page.count("\n"),
                                healthz=json.loads(seen["healthz"][1]),
                                s=time.perf_counter() - t)
    print(f"disagg metrics ({card}): {seen['scrapes']} scrapes during the "
          f"serve, /metrics 200 with {page.count(chr(10))} lines, /healthz "
          f"{seen['healthz'][0]}", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- phase 9n: the checkpointed trainer, the API, elastic, the sentinel --------

#: where phase 9n writes its checkpoints (deleted at the phase's end)
CKPT_ROOT = "build/chip_smoke_ckpt"
#: gpt_lm at gpt_medium's widths, as phase 9f's `--shard-states` runs
CKPT_TRAINER = ["--d-model", "1024", "--layers", "12", "--heads", "8",
                "--seq", "1024", "--batch", "4", "--scan-blocks",
                "--lr", "3e-4", "--sample-chars", "0"]
#: the trainer child: gpt_lm's own `run`, its losses in full and the
#: flash launches it made, as JSON on its last line
CKPT_CHILD = (
    "import json, sys\n"
    "from singa_tpu_torch import distributed\n"
    "from singa_tpu_torch.examples import gpt_lm\n"
    "from singa_tpu_torch.ops import flash_attention as fa\n"
    "try:\n"
    "    r = gpt_lm.run(gpt_lm.parser().parse_args(sys.argv[1:]))\n"
    "    gs = r['model']._train_step\n"
    "    out = dict(losses=r['losses'], start=r['start'],\n"
    "               launches=dict(flash_fwd=fa.FLASH_FWD_LAUNCHES,\n"
    "                             flash_bwd_dq=fa.FLASH_BWD_DQ_LAUNCHES,\n"
    "                             flash_bwd_dkv=fa.FLASH_BWD_DKV_LAUNCHES,\n"
    "                             fused=dict(fa.FUSED_LAUNCHES)),\n"
    "               captures=gs.captures, replays=gs.replays)\n"
    "finally:\n"
    "    distributed.shutdown()\n"
    "print('CKPT_CHILD ' + json.dumps(out), flush=True)\n")
#: the API part's steps before the save and after it
CKPT_STEPS = 3
#: the sentinel's injected step (0-based: the second replay)
SENTINEL_AT = 2


def trainer_runs(runs):
    """Run each (label, argv) as a gpt_lm child, all at once on the card
    (each holds one gpt_medium step's memory); returns {label:
    (result, stdout, seconds)} and fails on any child's failure."""
    procs = {}
    for label, argv in runs:
        procs[label] = (subprocess.Popen(
            [sys.executable, "-c", CKPT_CHILD, *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            time.perf_counter())
    out = {}
    for label, (p, t) in procs.items():
        so, se = p.communicate(timeout=600)
        wall = time.perf_counter() - t
        check(p.returncode == 0,
              f"gpt_lm {label} failed: {se[-3000:]}")
        line = [ln for ln in so.splitlines() if ln.startswith("CKPT_CHILD ")]
        check(len(line) == 1, f"gpt_lm {label}: no result line")
        out[label] = (json.loads(line[0][len("CKPT_CHILD "):]), so, wall)
    return out


def resumed_trainers(card):
    """For the plain AdamW and `--shard-states` (ZeRO-1) each: run A (6
    steps, no checkpoint), B (4 steps, --save-every 2) and C (B's
    command with --steps 6): C resumes at step 4, its losses are bitwise
    A's steps 4-5 (B's, A's steps 0-3), and it launches 12 of each fused
    kernel a step. The four A and B runs go at once, then the two C."""
    import shutil

    tags = {"plain": [], "zero1": ["--shard-states"]}
    dirs = {tag: f"{CKPT_ROOT}/trainer_{tag}" for tag in tags}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    t = time.perf_counter()
    first = trainer_runs(
        [(f"A {tag}", CKPT_TRAINER + extra + ["--steps", "6"])
         for tag, extra in tags.items()]
        + [(f"B {tag}", CKPT_TRAINER + extra + [
            "--steps", "4", "--checkpoint", dirs[tag], "--save-every", "2"])
           for tag, extra in tags.items()])
    first_s = time.perf_counter() - t
    second = trainer_runs(
        [(f"C {tag}", CKPT_TRAINER + extra + [
            "--steps", "6", "--checkpoint", dirs[tag], "--save-every", "2"])
         for tag, extra in tags.items()])
    wall = time.perf_counter() - t
    # C's launches: compile's forward (12 forward), step 4 uncaptured (12
    # of each) and step 5 captured (12 of each recorded)
    want = {"flash_fwd": 36, "flash_bwd_dq": 24, "flash_bwd_dkv": 24}
    per_step = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
    out = {"wall_s": wall, "first_round_s": first_s,
           "second_round_s": wall - first_s,
           "launches_per_step": per_step}
    for tag in tags:
        (a, _, _), (b, _, _) = first[f"A {tag}"], first[f"B {tag}"]
        c, c_out, c_s = second[f"C {tag}"]
        check(f"resumed from {dirs[tag]} at step 4" in c_out
              and c["start"] == 4,
              f"gpt_lm {tag}: run C did not say it resumed at step 4")
        check(len(a["losses"]) == 6 and b["losses"] == a["losses"][:4],
              f"gpt_lm {tag}: run B's losses {b['losses']} are not A's "
              f"{a['losses'][:4]}")
        check(c["losses"] == a["losses"][4:],
              f"gpt_lm {tag}: the resumed losses {c['losses']} are not "
              f"bitwise the unbroken run's {a['losses'][4:]}")
        check({k: c["launches"][k] for k in want} == want
              and c["launches"]["fused"] == want
              and (c["captures"], c["replays"]) == (1, 1),
              f"gpt_lm {tag}: the resumed run's launches {c['launches']}, "
              f"captures {c['captures']}, replays {c['replays']}")
        print(f"gpt_lm {tag} resumed ({card}): A {a['losses']}; B "
              f"{b['losses']}; C from step {c['start']} {c['losses']}: "
              f"bitwise A's steps 4-5; C's flash launches a step "
              f"{per_step} (fused layout), C alone {c_s:.1f} s", flush=True)
        out[tag] = dict(losses_a=a["losses"], losses_b=b["losses"],
                        losses_c=c["losses"], start_c=c["start"],
                        launches_c=c["launches"], wall_c_s=c_s)
        shutil.rmtree(dirs[tag], ignore_errors=True)
    print(f"gpt_lm resumed ({card}): the four A and B runs at once "
          f"{first_s:.1f} s, the two C {wall - first_s:.1f} s", flush=True)
    return out


def manifest_shards(ckpt, step_dir):
    """{leaf name: [(file, nbytes, crc32s)]} of a committed step dir."""
    from singa_tpu_torch import storage

    man = json.loads(storage.get_driver(step_dir).read(
        storage.join(step_dir, ckpt.MANIFEST)).decode())
    return {lf["name"]: [(s["file"], s["nbytes"], s["crc32"])
                         for s in lf["shards"]] for lf in man["leaves"]}


def ckpt_api(torch, fa, mp, card):
    """The API in one process, the captured fp32 gpt_medium step (scanned,
    AdamW, 4 x 1024): 3 steps, a sync save, an async save of the same
    step followed at once by 3 more replays (the snapshot must not see
    them), the two step dirs' shard files and crcs identical; a fresh
    model whose step is already captured takes the restore in place,
    and its next 3 replays are bitwise the unbroken run's, with no new
    capture; the launches across the restore; a flipped byte refused."""
    import shutil

    from singa_tpu_torch import opt, resilience
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.resilience import checkpoint as ckpt
    from singa_tpu_torch.resilience import faults

    sync_dir, async_dir = f"{CKPT_ROOT}/api_sync", f"{CKPT_ROOT}/api_async"
    for d in (sync_dir, async_dir):
        shutil.rmtree(d, ignore_errors=True)
    rng = np.random.default_rng(SEED)

    def build():
        m = gpt_medium(device="cuda")
        load_singa_tpu_params(m, seeded_params(m, SEED))
        m.set_optimizer(opt.AdamW(lr=3e-4))
        return m

    m = build()
    vocab = m.vocab_size
    seq = torch.from_numpy(rng.integers(
        0, vocab, (2 * CKPT_STEPS, 4, 1025))).cuda()
    batches = [(s[:, :-1].contiguous(), s[:, 1:].contiguous()) for s in seq]
    m.compile([batches[0][0]], is_train=True, use_graph=True)
    losses = [m(x, y)[1].item() for x, y in batches[:CKPT_STEPS]]
    gs = m._train_step
    check((gs.captures, gs.replays) == (1, CKPT_STEPS - 1),
          f"api: {gs.captures} captures, {gs.replays} replays")

    torch.cuda.synchronize()
    t = time.perf_counter()
    sync_step = resilience.save(sync_dir, m, m.optimizer, step=CKPT_STEPS)
    save_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    handle = resilience.save(async_dir, m, m.optimizer, step=CKPT_STEPS,
                             async_=True)
    snapshot_s = time.perf_counter() - t
    # the replays start at once and update the states in place
    after = [m(x, y)[1].item() for x, y in batches[CKPT_STEPS:]]
    t = time.perf_counter()
    async_step = handle.result(timeout=600)
    commit_wait_s = time.perf_counter() - t
    check(gs.captures == 1, "api: the saves made the step recapture")
    a, b = manifest_shards(ckpt, sync_step), manifest_shards(ckpt, async_step)
    check(a == b, "api: the async save's shard files or crcs differ from "
                  "the sync save's of the same step")
    state_bytes = sum(n for shards in a.values() for _, n, _ in shards)

    # a fresh model whose step is captured takes the restore in place
    m2 = build()
    m2.compile([batches[0][0]], is_train=True, use_graph=True)
    reset_counts(fa, mp)
    for x, y in batches[:2]:
        m2(x, y)
    before = counts(fa, mp)
    gs2 = m2._train_step
    check(before == dict(NO_LAUNCH, flash_fwd=24, flash_bwd_dq=24,
                         flash_bwd_dkv=24) and gs2.captures == 1,
          f"api: the fresh model's first and captured steps launched "
          f"{before}, captures {gs2.captures}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    meta = resilience.restore(sync_dir, m2, m2.optimizer)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    check(meta["step"] == CKPT_STEPS and m2.optimizer.step_counter
          == CKPT_STEPS, f"api: restored step {meta['step']}")
    reset_counts(fa, mp)
    resumed = [m2(x, y)[1].item() for x, y in batches[CKPT_STEPS:]]
    check(counts(fa, mp) == NO_LAUNCH and gs2.captures == 1
          and gs2.replays == 1 + CKPT_STEPS,
          f"api: after the restore {counts(fa, mp)} launches from Python, "
          f"{gs2.captures} captures, {gs2.replays} replays: the capture "
          f"was not kept")
    check(resumed == after, f"api: the replays after the restore "
                            f"{resumed} are not bitwise the unbroken "
                            f"run's {after}")

    # a flipped byte in a committed shard is refused
    path, off = faults.flip_checkpoint_byte(sync_dir, byte_offset=4096)
    try:
        resilience.restore(sync_dir, m2, m2.optimizer)
        refused = None
    except resilience.CorruptCheckpointError as e:
        refused = str(e)
    check(refused is not None and path in refused,
          "api: a flipped checkpoint byte was not refused")
    print(f"ckpt api ({card}): {state_bytes} state bytes a save "
          f"({state_bytes / 2**30:.3f} GiB, {len(a)} leaves); sync save "
          f"{save_s:.3f} s, async snapshot {snapshot_s:.3f} s (the step's "
          f"stall) + commit waited {commit_wait_s:.3f} s after 3 replays; "
          f"restore {restore_s:.3f} s; async files == sync files; the "
          f"restored captured step's replays {resumed} bitwise the "
          f"unbroken {after}; flipped byte refused: {refused[:90]}",
          flush=True)
    del m, m2, gs, gs2
    drop_graphs(torch)
    for d in (sync_dir, async_dir):
        shutil.rmtree(d, ignore_errors=True)
    return dict(losses=losses + after, resumed=resumed,
                state_bytes=state_bytes, leaves=len(a), save_s=save_s,
                snapshot_s=snapshot_s, commit_wait_s=commit_wait_s,
                restore_s=restore_s,
                launches_before_restore=before, refused=refused)


def ckpt_elastic(torch, fa, mp, card):
    """Elastic at world 1: the tp x zero3 stack of phase 9k (a world-1
    NCCL group, a (1, 1, 1) mesh, DistOpt(AdamW)), 2 steps, saved; then
    the scanned gpt_medium with the same axes declared but no mesh (the
    dense path reads the head-interleaved QKV) and a plain AdamW takes
    the restore: its parameters equal the saved ones, and its next step's
    loss is bitwise the tp x zero3 model's."""
    import shutil

    from singa_tpu_torch import distributed, opt, resilience
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.parallel import tp as tp_module

    d = f"{CKPT_ROOT}/elastic"
    shutil.rmtree(d, ignore_errors=True)
    rng = np.random.default_rng(SEED + 1)
    distributed.init(device="cuda")
    try:
        mesh = mesh_module.get_mesh_3d(1, 1, 1)
        probe = gpt_medium(device="cuda")
        load_singa_tpu_params(probe, seeded_params(probe, SEED))
        heads = probe.decoder.num_heads
        states = {k: v.detach().clone() for k, v in
                  probe.get_states().items()}
        for k in ("decoder.w_qkv", "decoder.b_qkv"):
            states[k] = tp_module.interleave_qkv_shards(states[k], heads)
        seq = torch.from_numpy(rng.integers(
            0, probe.vocab_size, (3, 4, 1025))).cuda()
        del probe
        batches = [(s[:, :-1].contiguous(), s[:, 1:].contiguous())
                   for s in seq]
        src = gpt_medium(device="cuda", tp_axis="model", zero3_axis="data")
        src.set_optimizer(opt.DistOpt(opt.AdamW(lr=3e-4), mesh=mesh,
                                      axis_name="data"))
        src.compile([batches[0][0]], is_train=True, use_graph=True)
        src.set_states(states)
        for x, y in batches[:2]:
            src(x, y)
        t = time.perf_counter()
        resilience.save(d, src, src.optimizer, step=2)
        save_s = time.perf_counter() - t
        saved = {k: v.detach().clone() for k, v in src.get_states().items()}
        src_next = src(*batches[2])[1].item()

        dst = gpt_medium(device="cuda", tp_axis="model", zero3_axis="data")
        dst.set_optimizer(opt.AdamW(lr=3e-4))
        dst.compile([batches[0][0]], is_train=True, use_graph=True)
        t = time.perf_counter()
        resilience.restore(d, dst, dst.optimizer)
        restore_s = time.perf_counter() - t
        got = dst.get_states()
        equal = all(torch.equal(got[k], saved[k]) for k in saved)
        check(sorted(got) == sorted(saved) and equal,
              "elastic: the restored parameters differ from the saved ones")
        reset_counts(fa, mp)
        dst_next = dst(*batches[2])[1].item()
        layouts = split_counts(fa, mp)
        print(f"ckpt elastic ({card}): tp x zero3 on (1, 1, 1) saved in "
              f"{save_s:.3f} s, restored into the unplaced stack in "
              f"{restore_s:.3f} s, parameters equal; next loss {dst_next!r}"
              f" vs the source's {src_next!r} (bitwise: "
              f"{dst_next == src_next}); the target's flash launches by "
              f"layout {layouts}", flush=True)
        check(dst_next == src_next, "elastic: the next step's loss is not "
                                    "bitwise the source model's")
        del src, dst
    finally:
        distributed.shutdown()
        drop_graphs(torch)
        shutil.rmtree(d, ignore_errors=True)
    return dict(save_s=save_s, restore_s=restore_s, next_loss=dst_next,
                source_next_loss=src_next, layouts=layouts)


def ckpt_sentinel(torch, fa, mp, card):
    """The sentinel on the card: the bf16 captured gpt_medium step with a
    `GradSentinel` and `nonfinite_grad_at(SENTINEL_AT)`; the injected
    step leaves every parameter, slot and the step counter bitwise and
    halves the scale, the graph is captured once (a capture refuses a
    host read, so the replay reads none), and the next step trains."""
    from singa_tpu_torch import autograd, opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.resilience import GradSentinel, faults

    rng = np.random.default_rng(SEED + 2)
    m = gpt_medium(device="cuda")
    load_singa_tpu_params(m, seeded_params(m, SEED))
    base = opt.AdamW(lr=3e-4)
    base.set_sentinel(GradSentinel(
        init_scale=2.0 ** 15, fault_plan=faults.nonfinite_grad_at(
            SENTINEL_AT)))
    m.set_optimizer(base)
    seq = torch.from_numpy(rng.integers(0, m.vocab_size, (4, 1025))).cuda()
    x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
    try:
        m.compile([x], is_train=True, use_graph=True, precision="bf16")
        losses, scales = [], []
        for i in range(SENTINEL_AT + 2):
            if i == SENTINEL_AT:
                before = {k: v.clone() for k, v in
                          m.optimizer.dump_states().items()
                          if not k.startswith("//")}
                before.update(state_of(m))
            losses.append(m(x, y)[1].item())
            scales.append(m.fault_counters["loss_scale"])
            if i == SENTINEL_AT:
                now = dict(state_of(m))
                now.update({k: v for k, v in
                            m.optimizer.dump_states().items()
                            if not k.startswith("//")})
                unmoved = all(torch.equal(now[k], before[k]) for k in before)
        fc = m.fault_counters
        gs = m._train_step
    finally:
        autograd.set_autocast(False)
    print(f"sentinel bf16 ({card}): losses {losses}, scales {scales}; the "
          f"injected step {SENTINEL_AT} left {len(before)} parameters, "
          f"slots and the step counter bitwise: {unmoved}; counters {fc}; "
          f"{gs.captures} capture, {gs.replays} replays", flush=True)
    check(unmoved, "sentinel: the skipped step moved the state")
    check(scales[SENTINEL_AT] == scales[SENTINEL_AT - 1] / 2
          and fc["nonfinite_skips"] == 1
          and fc["steps_seen"] == SENTINEL_AT + 2,
          f"sentinel: scales {scales}, counters {fc}")
    check(gs.captures == 1 and gs.replays == SENTINEL_AT + 1,
          f"sentinel: {gs.captures} captures, {gs.replays} replays")
    check(all(np.isfinite(losses)), f"sentinel: losses {losses}")
    del m, gs
    drop_graphs(torch)
    return dict(losses=losses, scales=scales, counters=fc)


def ckpt_path(torch, fa, mp, card):
    """Phase 9n: the trainer resumed (plain and --shard-states), the API
    in one process, elastic at world 1, the sentinel, each timed; the
    checkpoint directories are deleted at the end."""
    import shutil

    out = {"card": card}
    try:
        out["trainer"] = resumed_trainers(card)
        for key, part in (("api", ckpt_api), ("elastic", ckpt_elastic),
                          ("sentinel", ckpt_sentinel)):
            t = time.perf_counter()
            out[key] = part(torch, fa, mp, card)
            out[key]["wall_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    return out["trainer"]["launches_per_step"], out


# -- phase 9o: the self-healing layer ------------------------------------------

#: where phase 9o writes its checkpoints (deleted at the phase's end)
HEAL_ROOT = "build/chip_smoke_heal"
#: the supervised gpt_medium's steps (Supervisor.run over 6 batches)
HEAL_STEPS = 6
#: the supervised AlexNet's batch (ImageNet 224 x 224) and SGD step
HEAL_ALEXNET_BATCH = 128
HEAL_ALEXNET_LR = 1e-3
#: the depth of 9o's babysat child and 9p's fleet child: gpt_medium's
#: widths at half its 12 blocks, which the two phases' wait fits in the
#: script's time limit (their checkpoints, saves and restores halve)
CHILD_LAYERS = 6
#: the babysat child's steps and the babysitter's staleness window: twice
#: the longest stretch between two beats phase 9o measures (the child's
#: start: import, CUDA, the model's build; 11.3 s at `CHILD_LAYERS`
#: blocks, 17.6 s at 12, on an NVIDIA H100 80GB HBM3 at 700 W), and no
#: less than 30 s
BABYSAT_STEPS = 3
BABYSAT_STALE_S = 30.0
#: gpt_medium's vocabulary (the batches are made before the model)
GPT_MEDIUM_VOCAB = 32768
#: the babysat child: `babysat_child` of this file, run by the babysitter
#: (and once more without it) as `python -c`
BABYSAT_CHILD = (
    "import sys\n"
    "import chip_smoke\n"
    "chip_smoke.babysat_child(sys.argv[1], int(sys.argv[2]),\n"
    "                         '--hang' in sys.argv[3:])\n")


def heal_batches(torch, vocab, n):
    """n seeded (ids, labels) batches of 4 x 1024 on the card."""
    rng = np.random.default_rng(SEED + 9)
    seq = torch.from_numpy(rng.integers(0, vocab, (n, 4, 1025))).cuda()
    return [(s[:, :-1].contiguous(), s[:, 1:].contiguous()) for s in seq]


def heal_gpt(x0, num_layers=12):
    """Phase 9n's gpt_medium (scanned, d 1024, 8 heads, fp32; 12 layers
    unless `num_layers` cuts the depth) from the seeded weights,
    AdamW(3e-4), compiled for captured steps on a batch like `x0`: every
    build the same."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium

    m = gpt_medium(device="cuda", num_layers=num_layers)
    load_singa_tpu_params(m, seeded_params(m, SEED))
    m.set_optimizer(opt.AdamW(lr=3e-4))
    m.compile([x0], is_train=True, use_graph=True)
    return m


class StepLog:
    """A supervisor fault hook that records, as each step starts, the
    step, the host clock and every kernel's launch count (fused-layout
    share beside), then calls `inner`. `deltas()` pairs each row with
    the next: what ran between two step starts."""

    def __init__(self, fa, mp, inner=None):
        self.fa, self.mp, self.inner = fa, mp, inner
        self.rows = []

    def mark(self, step):
        self.rows.append((step, time.perf_counter(),
                          counts(self.fa, self.mp),
                          dict(self.fa.FUSED_LAUNCHES)))

    def __call__(self, step, batch):
        self.mark(step)
        return self.inner(step, batch) if self.inner is not None else None

    def deltas(self):
        out = []
        for (s, t, c, f), (_, t2, c2, f2) in zip(self.rows, self.rows[1:]):
            out.append(dict(step=s, s=t2 - t,
                            launches={k: c2[k] - c[k] for k in c},
                            fused={k: f2[k] - f[k] for k in f}))
        return out


def launch_pattern(deltas, per_step):
    """Each interval as "step" (per_step launches, all fused), "none" or
    the launches themselves."""
    out = []
    for d in deltas:
        if d["launches"] == per_step and all(
                d["fused"][k] == per_step[k] for k in d["fused"]):
            out.append("step")
        elif all(v == 0 for v in d["launches"].values()):
            out.append("none")
        else:
            out.append({k: v for k, v in d["launches"].items() if v})
    return out


def card_pids():
    """The pids `nvidia-smi` lists with a context on the card."""
    got = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return {int(t) for t in got.stdout.split() if t.strip().isdigit()}


def holds_card(pid):
    """True when process `pid` has a /dev/nvidia* device open (a CUDA
    context does)."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            pass
    return False


def babysat_child(ckpt_dir, n_steps, hang):
    """The babysat gpt_medium trainer at `CHILD_LAYERS` blocks
    (`BABYSAT_CHILD`): the generators seeded, `heal_gpt`, a beat after
    the build, a resume from the latest
    committed step, a `Watchdog` around each step (its heartbeat from
    the babysitter's env), a save after each step (the newest two kept);
    with `hang`, a SIGSTOP at step 1 on the first incarnation only.
    Prints its pid, each step's wall clock and a JSON summary with the
    losses."""
    import torch

    from singa_tpu_torch import resilience
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.ops import max_pool as mp
    from singa_tpu_torch.resilience import counters, faults

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a trainer seeds its generators at start-up: the manifest carries
    # their states, so two runs' final checkpoints are comparable
    torch.manual_seed(SEED)
    print(f"BABYSAT pid {os.getpid()} restarts_external "
          f"{counters.snapshot().get('restarts_external', 0)}", flush=True)
    batches = heal_batches(torch, GPT_MEDIUM_VOCAB, n_steps)
    m = heal_gpt(batches[0][0], CHILD_LAYERS)
    resilience.touch_heartbeat(os.environ.get(resilience.HEARTBEAT_ENV))
    start = 0
    try:
        start = int(resilience.restore(ckpt_dir, m, m.optimizer)["step"])
    except resilience.CheckpointError:
        pass  # the first incarnation: nothing committed yet
    wd = resilience.Watchdog(timeout_s=3600.0)  # heartbeat from the env
    stop = (faults.hard_hang_at(1)
            if hang and counters.snapshot().get("restarts_external", 0) == 0
            else None)
    reset_counts(fa, mp)
    losses = []
    for step in range(start, n_steps):
        with wd.guard(step):
            if stop is not None:
                stop(step, None)
            losses.append(float(m(*batches[step])[1]))
        print(f"BABYSAT step {step} t {time.time():.6f}", flush=True)
        resilience.save(ckpt_dir, m, m.optimizer, step=step + 1,
                        data_cursor=step + 1)
        resilience.prune(ckpt_dir, keep=2)
    gs = m._train_step
    print("BABYSAT done " + json.dumps(dict(
        pid=os.getpid(), start=start, losses=losses, captures=gs.captures,
        replays=gs.replays, launches=counts(fa, mp),
        fused=dict(fa.FUSED_LAUNCHES))), flush=True)


def _sha_step_dir(step_dir):
    """{file name: sha256} of a committed step dir."""
    import hashlib

    out = {}
    for name in sorted(os.listdir(step_dir)):
        with open(os.path.join(step_dir, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


class BeatWatch:
    """A thread that reads heartbeat files' mtimes every 0.25 s, each
    while its process runs. `gaps(holes)`: the longest stretch each file
    went without a new beat, from its process's spawn (where a
    babysitter primes its file) to the process's exit, leaving out a
    stretch that holds a host time of `holes` (a deliberate hang's)."""

    def __init__(self, watched):
        import threading

        t0 = time.time()
        self.watched = list(watched)  # (name, path, process)
        self.seen = {name: [t0] for name, _, _ in self.watched}
        self.end = {}
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while len(self.end) < len(self.watched):
            for name, path, proc in self.watched:
                if name in self.end:
                    continue
                try:
                    m = os.stat(path).st_mtime
                except OSError:
                    m = 0.0
                if m > self.seen[name][-1]:
                    self.seen[name].append(m)
                if proc.poll() is not None:
                    self.end[name] = time.time()
            time.sleep(0.25)

    def gaps(self, holes=()):
        self.thread.join(30)
        out = {}
        for name, ts in self.seen.items():
            pts = ts + [self.end.get(name, time.time())]
            out[name] = max((b - a for a, b in zip(pts, pts[1:])
                             if not any(a <= h <= b for h in holes)),
                            default=0.0)
        return out


def start_babysat(root):
    """Start the babysitter over the hanging child and, beside it, the
    same child unbroken without a babysitter. Returns the two processes,
    their stdout lines with the host clock (a reader thread each) and
    the samples of a thread that reads, every 2 s of the babysitter's
    life, whether it has a /dev/nvidia* device open."""
    import threading

    os.makedirs(root, exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    sitter = subprocess.Popen(
        [sys.executable, "-m", "singa_tpu_torch.resilience.babysit",
         "--stale-after", str(BABYSAT_STALE_S), "--max-restarts", "2",
         "--heartbeat", f"{root}/heartbeat",
         "--", sys.executable, "-c", BABYSAT_CHILD, f"{root}/babysat",
         str(BABYSAT_STEPS), "--hang"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    unbroken = subprocess.Popen(
        [sys.executable, "-c", BABYSAT_CHILD, f"{root}/unbroken",
         str(BABYSAT_STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(env, SINGA_HEARTBEAT_FILE=f"{root}/unbroken_heartbeat"))
    lines = {"sitter": [], "unbroken": [], "samples": [],
             "beats": BeatWatch([
                 ("babysat", f"{root}/heartbeat", sitter),
                 ("unbroken", f"{root}/unbroken_heartbeat", unbroken)])}

    def read(name, proc):
        for ln in proc.stdout:
            lines[name].append((time.time(), ln.rstrip("\n")))

    def sample():
        while sitter.poll() is None:
            lines["samples"].append(holds_card(sitter.pid))
            time.sleep(2.0)

    threads = [threading.Thread(target=read, args=(k, p), daemon=True)
               for k, p in (("sitter", sitter), ("unbroken", unbroken))]
    threads.append(threading.Thread(target=sample, daemon=True))
    for th in threads:
        th.start()
    return sitter, unbroken, lines, threads


def stop_babysat(sitter, unbroken, lines):
    """SIGKILL the babysitter, the unbroken child and every incarnation
    the babysitter started (each leads a session of its own), then reap
    the two."""
    pids = [int(ln.split()[2]) for _, ln in lines["sitter"]
            if ln.startswith("BABYSAT pid ")]
    for pid in pids:
        try:
            os.killpg(pid, signal.SIGKILL)
        except OSError:
            pass
    for p in (sitter, unbroken):
        if p.poll() is None:
            p.kill()
        p.wait()


def finish_babysat(root, sitter, unbroken, lines, threads, card):
    """Wait for the babysitter and the unbroken child, sampling the
    babysitter's open devices meanwhile; hold the heal (one restart, one
    stale kill), the final checkpoints sha256-identical file by file, no
    process of the killed incarnation left and the babysitter never on
    the card."""
    t = time.perf_counter()
    while sitter.poll() is None or unbroken.poll() is None:
        check(time.perf_counter() - t < 900, "the babysitter overran")
        time.sleep(1.0)
    for th in threads:
        th.join(30)
    samples = lines["samples"]
    text = {k: "\n".join(ln for _, ln in lines[k])
            for k in ("sitter", "unbroken")}
    check(sitter.returncode == 0 and unbroken.returncode == 0,
          f"babysat gpt_medium: babysitter rc {sitter.returncode}, unbroken "
          f"child rc {unbroken.returncode}:\n{text['sitter'][-3000:]}\n"
          f"{text['unbroken'][-3000:]}")
    check("trainer completed (restarts=1, stale_kills=1)" in text["sitter"],
          f"babysat gpt_medium: not healed with one restart and one stale "
          f"kill:\n{text['sitter'][-3000:]}")
    kill = [(ts, ln) for ts, ln in lines["sitter"] if "SIGKILLing" in ln]
    check(len(kill) == 1, "babysat gpt_medium: no single stale kill line")
    # the longest stretch between beats outside the SIGSTOP's: what the
    # stale window must cover
    gaps = lines["beats"].gaps(holes=[kill[0][0]])
    check(max(gaps.values()) < BABYSAT_STALE_S,
          f"babysat gpt_medium: a stretch between beats {gaps} reached the "
          f"{BABYSAT_STALE_S:.0f} s stale window")
    killed_pid = int(kill[0][1].rsplit("pid ", 1)[1].rstrip(")"))
    pids = [int(ln.split()[2]) for _, ln in lines["sitter"]
            if ln.startswith("BABYSAT pid ")]
    check(len(pids) == 2 and pids[0] == killed_pid,
          f"babysat gpt_medium: incarnations {pids}, killed {killed_pid}")
    # the child prints each step's wall clock as it completes
    after = [float(ln.split()[-1]) for ts, ln in lines["sitter"]
             if ts > kill[0][0] and ln.startswith("BABYSAT step ")]
    check(bool(after), "babysat gpt_medium: the respawn took no step")
    kill_to_step_s = after[0] - kill[0][0]
    done = [json.loads(ln[len("BABYSAT done "):]) for _, ln in
            lines["sitter"] if ln.startswith("BABYSAT done ")]
    ref = [json.loads(ln[len("BABYSAT done "):]) for _, ln in
           lines["unbroken"] if ln.startswith("BABYSAT done ")]
    check(len(done) == 1 and len(ref) == 1 and done[0]["start"] == 1
          and done[0]["losses"] == ref[0]["losses"][1:],
          f"babysat gpt_medium: the respawn {done} did not resume at step 1 "
          f"with the unbroken run's losses {ref}")
    from singa_tpu_torch import resilience

    healed_dir = resilience.latest_step_dir(f"{root}/babysat")
    ref_dir = resilience.latest_step_dir(f"{root}/unbroken")
    healed, want = _sha_step_dir(healed_dir), _sha_step_dir(ref_dir)
    check(os.path.basename(healed_dir) == os.path.basename(ref_dir)
          == f"step-{BABYSAT_STEPS:08d}" and healed == want,
          f"babysat gpt_medium: the healed final checkpoint {healed_dir} is "
          f"not sha256-identical to the unbroken one's {ref_dir}")
    # no process of the killed incarnation, and never the babysitter:
    # /proc decides (nvidia-smi may list the pids of another namespace;
    # where it lists this process, its list must not hold the two)
    final = card_pids()
    own = os.getpid() in final
    check(holds_card(os.getpid()),
          "/proc shows no /dev/nvidia* open in this process")
    check(not os.path.exists(f"/proc/{killed_pid}")
          and not (own and killed_pid in final),
          f"babysat gpt_medium: the killed incarnation {killed_pid} is "
          f"still there ({final})")
    check(bool(samples) and not any(samples)
          and not (own and sitter.pid in final),
          f"babysat gpt_medium: the babysitter {sitter.pid} held the card "
          f"({len(samples)} samples)")
    print(f"babysat gpt_medium ({card}): healed, restarts 1, stale kills 1 "
          f"(stale window {BABYSAT_STALE_S:.0f} s, the longest stretch "
          f"between beats {gaps}); incarnations {pids}, "
          f"killed {killed_pid}; final {os.path.basename(healed_dir)} "
          f"sha256-identical to the unbroken run's over {len(healed)} "
          f"files; kill to the respawn's first step {kill_to_step_s:.1f} s "
          f"(backoff 5 s included); /proc: the killed pid gone, the "
          f"babysitter {sitter.pid} with no /dev/nvidia* open in any of "
          f"{len(samples)} samples, this process with one; nvidia-smi's "
          f"compute pids {sorted(final)} (this process among them: {own}); "
          f"respawn "
          f"launches {done[0]['launches']}, captures "
          f"{done[0]['captures']}", flush=True)
    return dict(restarts=1, stale_kills=1, killed_pid=killed_pid,
                incarnations=pids, files=len(healed),
                stale_window_s=BABYSAT_STALE_S, beat_gaps_s=gaps,
                kill_to_first_step_s=kill_to_step_s,
                losses=ref[0]["losses"], respawn=done[0],
                card_pids=sorted(final), own_pid_listed=own,
                samples=len(samples))


def supervised(torch, fa, mp, build, batches, what, per_step, **kw):
    """One `Supervisor.run` at checkpoint_every 2 and keep_checkpoints 2
    under `HEAL_ROOT/what`, with a `StepLog` around `kw`'s fault hook and
    `build` wrapped to record the memory allocated after each build.
    Returns the result (the model dropped), the log, the memories and
    the watchdog's expiry times."""
    import shutil

    from singa_tpu_torch.resilience import Supervisor

    d = f"{HEAL_ROOT}/{what}"
    shutil.rmtree(d, ignore_errors=True)
    log = StepLog(fa, mp, kw.pop("fault_hook", None))
    mem = []

    def build_fn():
        m = build()
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
        return m

    sup = Supervisor(build_fn, d, checkpoint_every=2, keep_checkpoints=2,
                     fault_hook=log, restart_backoff_s=0.0, **kw)
    fired = []  # the host clock at each watchdog expiry
    if sup.watchdog is not None:
        sup.watchdog.on_hang = lambda s, e: fired.append(time.perf_counter())
    t = time.perf_counter()
    res = sup.run(batches)
    wall = time.perf_counter() - t
    log.mark(None)
    model = res.pop("model")
    res["captures"] = model._train_step.captures
    res["replays"] = model._train_step.replays
    res["history"] = sup.restart_history
    res["pattern"] = launch_pattern(log.deltas(), per_step)
    res["wall_s"] = wall
    del model, sup
    drop_graphs(torch)
    shutil.rmtree(d, ignore_errors=True)
    return res, log, mem, fired


def heal_alexnet(torch, fa, mp, card):
    """The spike case on the ImageNet AlexNet (batch 128, SGD with
    momentum, NHWC, K2a on; no batch norm and ReLU layers, so a scaled
    image scales the logits): `poison_batch_at(3, factor)` with factor
    1e4 or the largest power of ten below it whose loss is finite, under
    `SpikeDetector(window=8, zmax=6, min_history=2)`. The max-pool
    kernel is switched on for the case (it is off by default)."""
    was_on = mp.pool_kernel_enabled()
    mp.set_pool_kernel_enabled(True)
    try:
        return _heal_alexnet(torch, fa, mp, card)
    finally:
        mp.set_pool_kernel_enabled(was_on)


def _heal_alexnet(torch, fa, mp, card):
    from singa_tpu_torch import autograd, opt
    from singa_tpu_torch.model import load_singa_tpu_states
    from singa_tpu_torch.models.alexnet import alexnet
    from singa_tpu_torch.resilience import SpikeDetector, faults

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    b = HEAL_ALEXNET_BATCH
    batches = [(torch.randn((b, 3, 224, 224), generator=gen, device="cuda"),
                torch.randint(0, 1000, (b,), generator=gen, device="cuda"))
               for _ in range(HEAL_STEPS)]
    states = None

    def build():
        nonlocal states
        m = alexnet(1000, device="cuda")
        if states is None:
            states = cnn_states({n: t.shape for n, t in [
                *m.named_parameters(), *m.named_buffers()]}, SEED)
        load_singa_tpu_states(m, states)
        m.set_image_layout("NHWC")
        m.set_optimizer(opt.SGD(lr=HEAL_ALEXNET_LR, momentum=0.9))
        m.compile([batches[0][0]], is_train=True, use_graph=True)
        return m

    # the factor: the largest power of ten up to 1e4 with a finite loss
    probe = build()
    probe.eval()
    factor = None
    with torch.no_grad():
        for f in (1e4, 1e3, 1e2, 1e1):
            logits = probe.forward(batches[3][0] * f)
            loss = autograd.softmax_cross_entropy(logits, batches[3][1])
            if bool(torch.isfinite(loss)):
                factor = f
                break
    check(factor is not None, "alexnet: no poison factor leaves the loss "
                              "finite")
    del probe, logits, loss
    drop_graphs(torch)
    per_step = dict(NO_LAUNCH, max_pool_bwd=3)
    res, log, _, _ = supervised(
        torch, fa, mp, build, batches, "alexnet", per_step,
        fault_hook=faults.poison_batch_at(3, factor=factor),
        spike_detector=SpikeDetector(window=8, zmax=6.0, min_history=2))
    check(res["rollbacks"] == 1 and res["restarts"] == 0
          and res["skipped"] == [[2, 3]] and res["steps"] == HEAL_STEPS - 2
          and all(np.isfinite(res["losses"])),
          f"alexnet spike: rollbacks {res['rollbacks']}, skipped "
          f"{res['skipped']}, steps {res['steps']}, losses {res['losses']}")
    # steps 0-1 launch K2a 3 times each (uncaptured, then the capture);
    # the rest replay, the rollback's restore keeping the capture
    check(res["pattern"] == ["step", "step"] + ["none"] * 4
          and res["captures"] == 1,
          f"alexnet spike: launches by step {res['pattern']}, captures "
          f"{res['captures']}")
    print(f"supervised alexnet spike ({card}): factor {factor:g}, "
          f"rollbacks 1, skipped {res['skipped']}, steps {res['steps']}, "
          f"losses {res['losses']}; K2a launches a step "
          f"{per_step['max_pool_bwd']} (steps 0-1: uncaptured, capture; "
          f"then replays), captures {res['captures']}; {res['wall_s']:.1f} "
          f"s", flush=True)
    return dict(factor=factor, rollbacks=1, skipped=res["skipped"],
                steps=res["steps"], losses=res["losses"],
                launches_per_step=per_step, pattern=res["pattern"],
                wall_s=res["wall_s"])


def heal_path(torch, fa, mp, card, beside=None):
    """Phase 9o: the self-healing layer on the card (module docstring).
    `beside()`, when given, is called as the babysitter starts: what it
    starts runs beside cases 3 to 5."""
    import shutil

    from singa_tpu_torch.resilience import faults

    out = {"card": card}
    t_phase = time.perf_counter()
    shutil.rmtree(HEAL_ROOT, ignore_errors=True)
    per_step = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                "max_pool_bwd": 0}
    sitter = None
    try:
        batches = heal_batches(torch, GPT_MEDIUM_VOCAB, HEAL_STEPS)

        def build():
            return heal_gpt(batches[0][0])

        # 1. unbroken: U, and the plain loop's losses bitwise U
        unbroken, log, _, _ = supervised(torch, fa, mp, build, batches,
                                         "unbroken", per_step)
        u = unbroken["losses"]
        check(unbroken["steps"] == HEAL_STEPS and unbroken["restarts"] == 0
              and unbroken["pattern"] == ["step", "step"] + ["none"] * 4,
              f"supervised gpt_medium: steps {unbroken['steps']}, launches "
              f"by step {unbroken['pattern']}")
        d = log.deltas()
        sup_ms = 1e3 * (d[2]["s"] + d[4]["s"]) / 2  # steps without a save
        first_s = max(d[0]["s"], d[1]["s"])
        # the plain loop: the same steps, each loss kept and read at the
        # end; the replays (steps 2-5) timed between two synchronizes
        m = build()
        kept = [m(x, y)[1] for x, y in batches[:2]]
        torch.cuda.synchronize()
        t = time.perf_counter()
        kept += [m(x, y)[1] for x, y in batches[2:]]
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t) / (HEAL_STEPS - 2)
        plain_losses = [float(v) for v in kept]
        del m, kept
        drop_graphs(torch)
        check(plain_losses == u, f"supervised gpt_medium: U {u} is not "
                                 f"the plain loop's {plain_losses}")
        print(f"supervised gpt_medium unbroken ({card}): U {u} bitwise the "
              f"plain loop's; {sup_ms:.2f} ms a supervised step (replay, "
              f"float(loss) read, no save) vs {plain_ms:.2f} ms a plain "
              f"replay (no read); steps 0-1 {d[0]['s']:.3f} s, "
              f"{d[1]['s']:.3f} s (capture and a save)", flush=True)
        out["unbroken"] = dict(losses=u, supervised_step_ms=sup_ms,
                               plain_step_ms=plain_ms,
                               first_steps_s=[d[0]["s"], d[1]["s"]],
                               wall_s=unbroken["wall_s"],
                               pattern=unbroken["pattern"])

        # 2. hang at step 3: the watchdog's deadline, then a restart
        timeout = max(15.0, 3 * first_s)
        hang, log, _, fired = supervised(
            torch, fa, mp, build, batches, "hang", per_step,
            fault_hook=faults.stall_at(3, seconds=3600.0),
            step_timeout_s=timeout)
        hist = hang["history"]
        check(hang["hangs"] == 1 and hang["restarts"] == 1
              and hang["losses"] == u and len(hist) == 1
              and "training step 3 hung" in hist[0]["error"]
              and len(fired) == 1,
              f"supervised hang: hangs {hang['hangs']}, restarts "
              f"{hang['restarts']}, losses {hang['losses']}, history {hist}")
        after = [t for s, t, _, _ in log.rows if t > fired[0]]
        expiry_to_step_s = after[0] - fired[0]
        print(f"supervised gpt_medium stall_at(3) ({card}): deadline "
              f"{timeout:.1f} s, hangs 1, restarts 1, '{hist[0]['error'][:60]}"
              f"...', losses bitwise U; {expiry_to_step_s:.2f} s from the "
              f"expiry to the next step (rebuild and restore); "
              f"{hang['wall_s']:.1f} s (before the babysitter started: "
              f"the card and host to itself)", flush=True)
        out["hang"] = dict(timeout_s=timeout, hangs=1, restarts=1,
                           error=hist[0]["error"],
                           expiry_to_next_step_s=expiry_to_step_s,
                           wall_s=hang["wall_s"])

        # the babysitter runs beside cases 3 and 4 from here (their walls
        # are taken with its two gpt_medium children building and
        # training on the same card); case 2 ran before it, alone
        sitter, unbroken_child, lines, threads = start_babysat(HEAL_ROOT)
        if beside is not None:
            beside()

        # 3. crash at step 3
        crash, _, mem, _ = supervised(torch, fa, mp, build, batches,
                                      "crash", per_step,
                                      fault_hook=faults.crash_at(3))
        want = ["step", "step", "none", {"flash_fwd": 12}, "step", "step",
                "none", "none"]
        check(crash["restarts"] == 1 and crash["steps"] == HEAL_STEPS
              and crash["losses"] == u and crash["captures"] == 1
              and crash["pattern"] == want,
              f"supervised crash: restarts {crash['restarts']}, steps "
              f"{crash['steps']}, losses {crash['losses']} vs U {u}, "
              f"captures {crash['captures']}, launches by step "
              f"{crash['pattern']} (want {want})")
        check(len(mem) == 2 and mem[1] <= 1.02 * mem[0],
              f"supervised crash: memory after the rebuild {mem} grew more "
              f"than 2% over the first build's")
        print(f"supervised gpt_medium crash_at(3) ({card}): restarts 1, "
              f"steps 6, losses bitwise U, one capture after the rebuild, "
              f"launches by step {crash['pattern']}; memory allocated after "
              f"the first build {mem[0]} B, after the rebuild {mem[1]} B "
              f"({100 * (mem[1] / mem[0] - 1):+.3f}%); {crash['wall_s']:.1f}"
              f" s (beside the babysat children)", flush=True)
        out["crash"] = dict(restarts=1, losses_bitwise_u=True,
                            memory_first_build=mem[0],
                            memory_rebuild=mem[1], pattern=crash["pattern"],
                            wall_s=crash["wall_s"])

        # 4. the spike case on AlexNet
        out["spike"] = heal_alexnet(torch, fa, mp, card)

        # 5. the babysitter's heal of the SIGSTOPped gpt_medium child
        out["babysitter"] = finish_babysat(HEAL_ROOT, sitter,
                                           unbroken_child, lines, threads,
                                           card)
        sitter = None
    finally:
        if sitter is not None:  # a failure above: stop what was started
            stop_babysat(sitter, unbroken_child, lines)
        shutil.rmtree(HEAL_ROOT, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"heal: phase 9o {out['wall_s']:.1f} s ({card})", flush=True)
    return {"gpt_medium": per_step,
            "alexnet": out["spike"]["launches_per_step"]}, out


# -- 9p. the babysitter fleet heals gpt_medium ---------------------------------

FLEET_ROOT = "build/chip_smoke_fleet"
#: the fleet child's steps: step 0, the SIGSTOP at step 1 on epoch 0, then
#: the respawn's steps 1 and 2 (uncaptured, then the capture)
FLEET_STEPS = 3
#: the agent's trainer staleness window (--stale-after): twice the
#: longest stretch between two beats phase 9p measures (the child's
#: import, NCCL init, build and capture; 7.8 s at `CHILD_LAYERS` blocks,
#: 11.5 s at 12, on an NVIDIA H100 80GB HBM3 at 700 W), and no less than
#: 30 s
FLEET_STALE_S = 30.0
#: the fleet child: `fleet_child` of this file, run by the agent (and once
#: more without it) as `python -c`
FLEET_CHILD = (
    "import sys\n"
    "import chip_smoke\n"
    "chip_smoke.fleet_child(sys.argv[1], int(sys.argv[2]),\n"
    "                       '--stale-at' in sys.argv[3:])\n")


def fleet_child(ckpt_dir, n_steps, inject):
    """The fleet's gpt_medium trainer (`FLEET_CHILD`): it joins a group of
    ``SINGA_FLEET_WORLD`` NCCL ranks at the agent's brokered
    ``SINGA_COORDINATOR`` and trains phase 9o's gpt_medium at
    `CHILD_LAYERS` blocks (scanned, 4 x 1024, fp32, AdamW under DistOpt
    over the group's mesh, captured)
    under `Supervisor(mesh_fn=default_mesh_fn(1))`, a save after each
    step; with `inject`, `faults.stale_host_at(1, rank=0)` on epoch 0
    only. Prints its pid, epoch and coordinator, each step's start with
    the host clock and the launches so far, and a JSON summary."""
    import torch

    from singa_tpu_torch import distributed, opt, resilience
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.ops import max_pool as mp
    from singa_tpu_torch.resilience import (Supervisor, counters,
                                            default_mesh_fn, faults)
    from singa_tpu_torch.resilience.fleet import (COORD_ENV, RANK_ENV,
                                                  WORLD_ENV)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    world = int(os.environ[WORLD_ENV])
    rank = int(os.environ[RANK_ENV])
    coord = os.environ.get(COORD_ENV)
    epoch = counters.snapshot().get("fleet_epochs", 0)
    print(f"FLEET pid {os.getpid()} epoch {epoch} coord {coord}", flush=True)
    distributed.init(coordinator_address=coord, num_processes=world,
                     process_id=rank)
    batches = heal_batches(torch, GPT_MEDIUM_VOCAB, n_steps)

    def build(mesh):
        m = gpt_medium(device="cuda", num_layers=CHILD_LAYERS)
        load_singa_tpu_params(m, seeded_params(m, SEED))
        m.set_optimizer(opt.DistOpt(opt.AdamW(lr=3e-4), mesh=mesh))
        m.compile([batches[0][0]], is_train=True, use_graph=True)
        resilience.touch_heartbeat(os.environ.get(resilience.HEARTBEAT_ENV))
        return m

    stop = (faults.stale_host_at(1, rank=0) if inject and epoch == 0
            else None)
    reset_counts(fa, mp)
    steps = []

    def hook(step, batch):
        c, f = counts(fa, mp), dict(fa.FUSED_LAUNCHES)
        steps.append(dict(step=step, launches=c, fused=f))
        print(f"FLEET step {step} t {time.time():.6f} launches "
              f"{json.dumps(c)} fused {json.dumps(f)}", flush=True)
        return stop(step, batch) if stop is not None else None

    sup = Supervisor(build, ckpt_dir, mesh_fn=default_mesh_fn(1),
                     step_timeout_s=3600.0, fault_hook=hook,
                     restart_backoff_s=0.0, keep_checkpoints=2)
    res = sup.run(batches)
    steps.append(dict(step=None, launches=counts(fa, mp),
                      fused=dict(fa.FUSED_LAUNCHES)))
    gs = res["model"]._train_step
    c = counters.supervisor_snapshot()
    distributed.shutdown()
    print(f"fleet trainer done rank={rank} world={world} "
          f"mesh={res['mesh_extents']} steps={res['steps']} "
          f"fleet={c['fleet']} fleet_epochs={c['fleet_epochs']} "
          f"elections={c['elections']} coord={coord or '-'}", flush=True)
    deltas = [dict(step=a["step"],
                   launches={k: b["launches"][k] - a["launches"][k]
                             for k in a["launches"]},
                   fused={k: b["fused"][k] - a["fused"][k]
                          for k in a["fused"]})
              for a, b in zip(steps, steps[1:])]
    print("FLEET done " + json.dumps(dict(
        pid=os.getpid(), epoch=epoch, start=steps[0]["step"],
        losses=res["losses"], captures=gs.captures, replays=gs.replays,
        deltas=deltas)), flush=True)


def start_fleet(root=FLEET_ROOT):
    """Start phase 9p in a fresh `root`: the fleet agent over the hanging
    child and, beside it, the same child unbroken with the same topology
    env and no agent. Returns the run: the two processes, their stdout
    lines with the host clock, the samples of the agent's open devices
    (every 2 s of its life), the reader threads and the start time."""
    import shutil
    import socket
    import threading

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    for k in [k for k in env if k.startswith(("SINGA_FLEET", "SINGA_BABY",
                                              "SINGA_COORD"))]:
        env.pop(k)
    agent = subprocess.Popen(
        [sys.executable, "-m", "singa_tpu_torch.resilience.babysit",
         "--fleet", f"{root}/rdv", "--fleet-rank", "0", "--fleet-world",
         "1", "--stale-after", str(FLEET_STALE_S), "--heartbeat",
         f"{root}/heartbeat", "--",
         sys.executable, "-c", FLEET_CHILD, f"{root}/fleet",
         str(FLEET_STEPS), "--stale-at"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    with socket.socket() as s:
        s.bind(("", 0))
        coord = f"{socket.gethostname()}:{s.getsockname()[1]}"
    twin_env = dict(env, SINGA_FLEET_WORLD="1", SINGA_FLEET_RANK="0",
                    SINGA_COORDINATOR=coord,
                    SINGA_HEARTBEAT_FILE=f"{root}/twin_heartbeat")
    twin = subprocess.Popen(
        [sys.executable, "-c", FLEET_CHILD, f"{root}/unbroken",
         str(FLEET_STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=twin_env)
    lines = {"agent": [], "twin": [], "samples": [],
             "beats": BeatWatch([
                 ("agent", f"{root}/heartbeat", agent),
                 ("twin", f"{root}/twin_heartbeat", twin)])}

    def read(name, proc):
        for ln in proc.stdout:
            lines[name].append((time.time(), ln.rstrip("\n")))

    def sample():
        while agent.poll() is None:
            lines["samples"].append(holds_card(agent.pid))
            time.sleep(2.0)

    threads = [threading.Thread(target=read, args=(k, p), daemon=True)
               for k, p in (("agent", agent), ("twin", twin))]
    threads.append(threading.Thread(target=sample, daemon=True))
    for th in threads:
        th.start()
    return dict(agent=agent, twin=twin, lines=lines, threads=threads, t0=t0)


def stop_fleet(run):
    """SIGKILL the agent, the twin and every incarnation the agent started
    (each leads a session of its own), then reap the two."""
    agent, twin, lines = run["agent"], run["twin"], run["lines"]
    for _, ln in lines["agent"]:
        if ln.startswith("FLEET pid "):
            try:
                os.killpg(int(ln.split()[2]), signal.SIGKILL)
            except OSError:
                pass
    for p in (agent, twin):
        if p.poll() is None:
            p.kill()
        p.wait()


def fleet_path(torch, fa, mp, card, run=None):
    """Phase 9p: the babysitter fleet on the card (world 1: NCCL takes one
    rank a card). `python -m singa_tpu_torch.resilience.babysit --fleet`
    runs `fleet_child`, which SIGSTOPs itself at step 1 on epoch 0; the
    agent reports the stale trainer, leads the epoch bump, SIGKILLs the
    tree and respawns it at epoch 1 with a re-brokered coordinator; the
    respawn resumes from the committed step 1 and finishes. Held: the
    agent healed with one epoch, one election and one stale trainer and
    wrote DONE; the child's counters and coordinators; `CHILD_LAYERS`
    launches of each fused flash kernel (one a block) in every counted
    step of each incarnation;
    the final checkpoint sha256-identical, file by file, to the unbroken
    twin's; the killed incarnation gone from /proc; the agent never with
    a /dev/nvidia* file open. `run` is the phase as `start_fleet`
    started it (`main` starts it beside phase 9o's babysitter); None
    starts it here. Returns the launches a counted step and the
    numbers."""
    import shutil

    from singa_tpu_torch import resilience

    root = FLEET_ROOT
    per_step = {"flash_fwd": CHILD_LAYERS, "flash_bwd_dq": CHILD_LAYERS,
                "flash_bwd_dkv": CHILD_LAYERS, "max_pool_bwd": 0}
    run = start_fleet(root) if run is None else run
    agent, twin, lines, threads, t0 = (run[k] for k in (
        "agent", "twin", "lines", "threads", "t0"))
    try:
        t = time.perf_counter()
        while agent.poll() is None or twin.poll() is None:
            check(time.perf_counter() - t < 600, "the fleet agent overran")
            time.sleep(1.0)
        for th in threads:
            th.join(30)
        text = {k: "\n".join(ln for _, ln in lines[k])
                for k in ("agent", "twin")}
        check(agent.returncode == 0 and twin.returncode == 0,
              f"fleet gpt_medium: agent rc {agent.returncode}, twin rc "
              f"{twin.returncode}:\n{text['agent'][-4000:]}\n"
              f"{text['twin'][-3000:]}")
        check("# fleet agent: job completed (epochs=1, elections won=1, "
              "led=True)" in text["agent"]
              and os.path.exists(f"{root}/rdv/DONE"),
              f"fleet gpt_medium: not healed at epoch 1 with one election, "
              f"or no DONE:\n{text['agent'][-3000:]}")
        stale = [(ts, ln) for ts, ln in lines["agent"]
                 if "hard hang; reporting to the leader" in ln]
        bump = [ln for _, ln in lines["agent"] if "epoch 0 -> 1" in ln]
        check(len(stale) == 1 and len(bump) == 1,
              f"fleet gpt_medium: stale trainer reports {stale}, bumps "
              f"{bump}")
        # the longest stretch between beats outside the SIGSTOP's
        gaps = lines["beats"].gaps(holes=[stale[0][0]])
        check(max(gaps.values()) < FLEET_STALE_S,
              f"fleet gpt_medium: a stretch between beats {gaps} reached "
              f"the {FLEET_STALE_S:.0f} s stale window")
        pids = [int(ln.split()[2]) for _, ln in lines["agent"]
                if ln.startswith("FLEET pid ")]
        coords = [ln.split()[-1] for _, ln in lines["agent"]
                  if ln.startswith("FLEET pid ")]
        adverts = []
        for e in (0, 1):
            with open(f"{root}/rdv/coord/epoch-{e:06d}.json") as f:
                adverts.append(json.load(f)["address"])
        check(len(pids) == 2 and coords == adverts
              and adverts[0] != adverts[1],
              f"fleet gpt_medium: incarnations {pids}, their coordinators "
              f"{coords}, the brokered ones {adverts}")
        done_line = [ln for _, ln in lines["agent"]
                     if ln.startswith("fleet trainer done")]
        check(len(done_line) == 1 and "mesh=(1, 1, 1)" in done_line[0]
              and "fleet=1 fleet_epochs=1 elections=1" in done_line[0]
              and done_line[0].endswith(f"coord={adverts[1]}"),
              f"fleet gpt_medium: the respawn's summary {done_line}")
        done = [json.loads(ln[len("FLEET done "):])
                for _, ln in lines["agent"] if ln.startswith("FLEET done ")]
        ref = [json.loads(ln[len("FLEET done "):])
               for _, ln in lines["twin"] if ln.startswith("FLEET done ")]
        check(len(done) == 1 and len(ref) == 1 and done[0]["start"] == 1
              and done[0]["epoch"] == 1
              and done[0]["losses"] == ref[0]["losses"][1:],
              f"fleet gpt_medium: the respawn {done} did not resume at step "
              f"1 with the unbroken twin's losses {ref}")
        # each incarnation's step starts: (step, host clock, launches so
        # far, fused so far); the killed one's step 0 ran before step 1's
        # SIGSTOP
        rows, inc = [[], []], -1
        for _, ln in lines["agent"]:
            if ln.startswith("FLEET pid "):
                inc += 1
            elif ln.startswith("FLEET step "):
                w = ln.split(" ", 6)
                rest = w[6].split(" fused ")
                rows[inc].append((int(w[2]), float(w[4]),
                                  json.loads(rest[0]),
                                  json.loads(rest[1])))
        check([r[0] for r in rows[0]] == [0, 1]
              and [r[0] for r in rows[1]] == [1, 2],
              f"fleet gpt_medium: steps started by incarnation {rows}")
        (_, _, c0, f0), (_, stop_t, c1, f1) = rows[0]
        killed = [dict(launches={k: c1[k] - c0[k] for k in c0},
                       fused={k: f1[k] - f0[k] for k in f0})]
        patterns = {"killed": launch_pattern(killed, per_step),
                    "respawn": launch_pattern(done[0]["deltas"], per_step),
                    "twin": launch_pattern(ref[0]["deltas"], per_step)}
        check(patterns["killed"] == ["step"]
              and patterns["respawn"] == ["step", "step"]
              and patterns["twin"] == ["step", "step", "none"],
              f"fleet gpt_medium: launches by step {patterns} (want "
              f"{CHILD_LAYERS} of "
              f"each fused kernel in every uncaptured or capturing step, "
              f"none in a replay)")
        healed_dir = resilience.latest_step_dir(f"{root}/fleet")
        ref_dir = resilience.latest_step_dir(f"{root}/unbroken")
        healed, want = _sha_step_dir(healed_dir), _sha_step_dir(ref_dir)
        check(os.path.basename(healed_dir) == os.path.basename(ref_dir)
              == f"step-{FLEET_STEPS:08d}" and healed == want,
              f"fleet gpt_medium: the healed final checkpoint {healed_dir} "
              f"is not sha256-identical to the twin's {ref_dir}")
        samples = lines["samples"]
        check(not os.path.exists(f"/proc/{pids[0]}"),
              f"fleet gpt_medium: the killed incarnation {pids[0]} is still "
              f"there")
        check(bool(samples) and not any(samples),
              f"fleet gpt_medium: the agent {agent.pid} held the card "
              f"({len(samples)} samples)")
        # the bump's wall clock is the leader's stamp in the EPOCH record
        # (one host, one clock)
        with open(f"{root}/rdv/EPOCH") as f:
            bump_t = float(json.load(f)["time"])
        stale_to_bump_s = bump_t - stop_t
        bump_to_step_s = rows[1][0][1] - bump_t
        out = dict(card=card, healed=True, epochs=1, elections=1,
                   stale_kills=1, incarnations=pids, coords=adverts,
                   stale_window_s=FLEET_STALE_S, beat_gaps_s=gaps,
                   files=len(healed), losses=ref[0]["losses"],
                   stale_to_bump_s=stale_to_bump_s,
                   bump_to_first_step_s=bump_to_step_s,
                   patterns=patterns, respawn_captures=done[0]["captures"],
                   respawn_replays=done[0]["replays"],
                   samples=len(samples))
        print(f"fleet gpt_medium ({card}): healed at epoch 1, elections 1, "
              f"one stale trainer (window {FLEET_STALE_S:.0f} s, the "
              f"longest stretch between beats {gaps}); "
              f"incarnations {pids}, coordinators {adverts}; final "
              f"{os.path.basename(healed_dir)} sha256-identical to the "
              f"twin's over {len(healed)} files; SIGSTOP to the epoch bump "
              f"{stale_to_bump_s:.1f} s, the bump to the respawn's first "
              f"step {bump_to_step_s:.1f} s (backoff included); launches "
              f"by step {patterns}; /proc: the killed pid gone, the agent "
              f"{agent.pid} with no /dev/nvidia* open in any of "
              f"{len(samples)} samples", flush=True)
        run = None
    finally:
        if run is not None:  # a failure above: stop what was started
            stop_fleet(run)
        shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    print(f"fleet: phase 9p {out['wall_s']:.1f} s ({card})", flush=True)
    return per_step, out


# -- 9q. item 20's utils (the prefetch loader, the profiler), item 13's mesh ---

PREFETCH_STEPS = 6
TRACE_ROOT = "build/chip_smoke_trace"
#: each fused flash kernel's symbol, as the trace names its launches
FLASH_SYMBOLS = {"flash_fwd": "flash_fwd_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_kernel"}


def trace_kernels(path):
    """The device-kernel events of a Chrome trace `profiler.xla_trace`
    wrote, its pre-roll left out: (name, microseconds)."""
    from singa_tpu_torch.utils.profiler import PREROLL_KERNEL

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e.get("dur", 0.0))) for e in events
            if e.get("cat") == "kernel" and PREROLL_KERNEL not in e["name"]]


def kernel_family(name):
    """A kernel's family: its symbol without `void `, anonymous
    namespaces, template arguments or parameters (a CUTLASS wrapper's
    first template argument kept: it names the kernel)."""
    import re

    base = name[5:] if name.startswith("void ") else name
    base = base.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", base, maxsplit=1)[0].strip()
    if head.startswith("cutlass::Kernel") and "<" in base:
        inner = re.split(r"[<>(,]", base.split("<", 1)[1], maxsplit=1)[0]
        head = f"{head}<{inner.strip()}>"
    return head[:80] or base[:80]


def loader_runs(torch, fa, mp, card):
    """dist_imagenet at its defaults through `run` (ResNet-50, 32 images
    a chip at 224 x 224, the captured step, K2a on, cuDNN's deterministic
    algorithms), PREFETCH_STEPS steps each: `--loader sync`, `--loader
    prefetch` (views into the C++ ring) and `--loader prefetch` fed the
    loader's owned copies. Each passes the loss-sanity check and launches
    K2a once uncaptured and once in its capture: a prefetch run's counts
    are read each time the trainer asks for a batch, so each step's
    launches are held apart. The views' losses equal the copies'
    bitwise; the prefetch run makes one C++ loader more than the sync
    run's native calls. Then `global_mesh(dcn_mesh_shape=(1,))` on the
    world-1 NCCL group against `global_mesh()`. Returns the views' run's
    launches in its uncaptured step and the numbers."""
    import torch.distributed as tdist

    from singa_tpu_torch import distributed, native
    from singa_tpu_torch.examples import dist_imagenet

    real = dist_imagenet.data.prefetch_batches
    snaps = []

    def counted(copy):
        """The loader, with every kernel's count read each time the
        trainer asks for a batch (its last step done) and at the end."""
        def feed(*args, **kwargs):
            if copy:
                kwargs = dict(kwargs, copy=True)
            for batch in real(*args, **kwargs):
                snaps.append(counts(fa, mp))
                yield batch
            snaps.append(counts(fa, mp))
        return feed

    distributed.init(device="cuda")
    check(tdist.get_backend() == "nccl" and tdist.get_world_size() == 1,
          f"the group is {tdist.get_backend()} at world "
          f"{tdist.get_world_size()}, not NCCL at 1")
    mp.set_pool_kernel_enabled(True)
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for name, loader, feed in (
                ("sync", "sync", real),
                ("prefetch", "prefetch", counted(copy=False)),
                ("prefetch_copies", "prefetch", counted(copy=True))):
            dist_imagenet.data.prefetch_batches = feed
            snaps.clear()
            reset_counts(fa, mp)
            calls0 = native.native_call_count()
            t = time.perf_counter()
            res = dist_imagenet.run(dist_imagenet.parser().parse_args(
                ["--steps", str(PREFETCH_STEPS), "--loader", loader,
                 "--device", "cuda"]))
            wall = time.perf_counter() - t
            launched = counts(fa, mp)
            gs = res["model"]._train_step
            waits = [1e3 * w for w in res["loader_wait_s"]]
            runs[name] = dict(
                losses=res["losses"], images_per_s_chip=res["img_s_chip"],
                loader_wait_ms=waits,
                loader_wait_ms_steady=float(np.mean(waits[2:])),
                launches=launched, wall_s=wall,
                native_calls=native.native_call_count() - calls0)
            print(f"dist_imagenet --loader {loader} ({name}, {card}, "
                  f"deterministic cuDNN): losses {res['losses']}, "
                  f"{res['img_s_chip']:.1f} images/s/chip, host ms waiting "
                  f"on the loader a step {[round(w, 3) for w in waits]} "
                  f"(steps 3-{PREFETCH_STEPS}: "
                  f"{runs[name]['loader_wait_ms_steady']:.3f}), native calls "
                  f"{runs[name]['native_calls']}, {wall:.1f} s; launches "
                  f"{launched}, captures {gs.captures}, replays {gs.replays}",
                  flush=True)
            check(res["ok"] is True,
                  f"dist_imagenet --loader {loader}: the loss sanity check "
                  f"failed")
            check(launched == dict(NO_LAUNCH, max_pool_bwd=2)
                  and (gs.captures, gs.replays) == (1, PREFETCH_STEPS - 1),
                  f"dist_imagenet --loader {loader}: K2a was not launched "
                  f"once in the uncaptured step and once in the capture, or "
                  f"the step was not captured once and replayed "
                  f"{PREFETCH_STEPS - 1} times")
            if loader == "prefetch":
                steps = [{k: b[k] - a[k] for k in b}
                         for a, b in zip(snaps, snaps[1:])]
                runs[name]["launches_by_step"] = steps
                print(f"dist_imagenet --loader prefetch ({name}): launches "
                      f"by step {[s['max_pool_bwd'] for s in steps]} (K2a)",
                      flush=True)
                check(len(steps) == PREFETCH_STEPS
                      and steps[0] == steps[1] == dict(NO_LAUNCH,
                                                       max_pool_bwd=1)
                      and all(s == NO_LAUNCH for s in steps[2:]),
                      f"dist_imagenet --loader prefetch ({name}): K2a's "
                      f"launches by step are {steps}, not 1 uncaptured, 1 "
                      f"in the capture and none in the replays")
            del res, gs
            drop_graphs(torch)
        one = distributed.global_mesh(dcn_mesh_shape=(1,))
        flat = distributed.global_mesh()
        mesh = dict(ranks=list(one.ranks), dims=list(one.dims),
                    axis_names=list(one.axis_names))
        print(f"global_mesh(dcn_mesh_shape=(1,)) on the world-1 NCCL group: "
              f"{mesh}, global_mesh(): ranks {list(flat.ranks)}, dims "
              f"{list(flat.dims)}", flush=True)
        check((one.ranks, one.dims, one.axis_names, one.axis_index("data"))
              == (flat.ranks, flat.dims, flat.axis_names,
                  flat.axis_index("data")),
              "global_mesh(dcn_mesh_shape=(1,)) differs from global_mesh()")
    finally:
        dist_imagenet.data.prefetch_batches = real
        torch.backends.cudnn.deterministic = False
        mp.set_pool_kernel_enabled(False)
        distributed.shutdown()
        drop_graphs(torch)
    loaders = runs["prefetch"]["native_calls"] - runs["sync"]["native_calls"]
    bitwise = runs["prefetch"]["losses"] == runs["prefetch_copies"]["losses"]
    print(f"prefetch ({card}): the views' losses bitwise the owned copies' "
          f"{bitwise}; C++ loaders made {loaders}; images/s/chip sync "
          f"{runs['sync']['images_per_s_chip']:.1f}, prefetch "
          f"{runs['prefetch']['images_per_s_chip']:.1f}", flush=True)
    check(bitwise, "the prefetch run fed views did not give the losses of "
                   "the run fed owned copies, bitwise")
    check(loaders == 1, f"the prefetch run made {loaders} C++ loaders "
                        f"beyond the sync run's native calls, not 1")
    return runs["prefetch"]["launches_by_step"][0], dict(runs=runs,
                                                         mesh=mesh)


def trace_path(torch, fa, mp, card):
    """gpt_medium (seeded weights, 4 x 1024, fp32, AdamW, compile(...,
    use_graph=True)): the uncaptured first step under
    `profiler.xla_trace` (12 events of each fused flash kernel in the
    trace file, 12 launches of each counted), the top five device-kernel
    families; the capture, then one replay traced (its kernel events
    printed, unchecked); one replay timed by `StepTimer(sync=)` and one
    by CUDA events. Returns the traced step's launches and the
    numbers."""
    import shutil

    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.utils import profiler

    m = gpt_medium(device="cuda")
    load_singa_tpu_params(m, seeded_params(m, SEED))
    seq = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, m.vocab_size, (4, 1025))).cuda()
    x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
    m.set_optimizer(opt.AdamW(lr=3e-4))
    m.compile([x], is_train=True, use_graph=True)
    torch.cuda.synchronize()
    out = {"card": card}
    try:
        reset_counts(fa, mp)
        t = time.perf_counter()
        with profiler.xla_trace(TRACE_ROOT) as tr:
            _, loss = m(x, y)
        traced_s = time.perf_counter() - t
        launched = counts(fa, mp)
        fused = dict(fa.FUSED_LAUNCHES)
        gs = m._train_step
        check((gs.captures, gs.replays) == (0, 0),
              "the traced step was not the uncaptured first call")
        check(launched == dict(NO_LAUNCH, flash_fwd=12, flash_bwd_dq=12,
                               flash_bwd_dkv=12)
              and fused == {k: 12 for k in FLASH_SYMBOLS},
              f"the traced gpt_medium step launched {launched} (fused "
              f"{fused}), not 12 of each fused flash kernel")
        kernels = trace_kernels(tr.path)
        events = {k: sum(1 for n, _ in kernels if sym in n)
                  for k, sym in FLASH_SYMBOLS.items()}
        fams = {}
        for n, us in kernels:
            f = kernel_family(n)
            fams[f] = fams.get(f, 0.0) + us / 1e3
        top = sorted(fams.items(), key=lambda kv: -kv[1])[:5]
        busy = sum(us for _, us in kernels) / 1e3
        out.update(trace_file_bytes=os.path.getsize(tr.path),
                   traced_step_s=traced_s, kernel_events=len(kernels),
                   flash_events=events, busy_ms=busy,
                   top_families=[dict(family=f, ms=ms) for f, ms in top])
        print(f"trace ({card}): uncaptured gpt_medium step under xla_trace "
              f"{traced_s:.2f} s, {os.path.getsize(tr.path)} bytes, "
              f"{len(kernels)} kernel events, {busy:.2f} busy ms; flash "
              f"events {events}; top families "
              + "; ".join(f"{f} {ms:.2f} ms" for f, ms in top), flush=True)
        check(events == {k: 12 for k in FLASH_SYMBOLS},
              f"the trace shows flash kernel events {events}, not 12 of "
              f"each")
        m(x, y)  # the capture, and its first replay
        check((gs.captures, gs.replays) == (1, 1), "the step did not capture")
        with profiler.xla_trace(TRACE_ROOT) as tr:
            m(x, y)
        replay = trace_kernels(tr.path)
        out.update(replay_kernel_events=len(replay),
                   replay_busy_ms=sum(us for _, us in replay) / 1e3)
        print(f"trace ({card}): one captured replay, {len(replay)} kernel "
              f"events, {out['replay_busy_ms']:.2f} busy ms", flush=True)
        timer = profiler.StepTimer()
        for _ in range(2):
            with timer.step(sync=x):
                m(x, y)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m(x, y)
        end.record()
        end.synchronize()
        out.update(step_timer_ms=1e3 * timer.times[-1],
                   cuda_event_ms=start.elapsed_time(end))
        print(f"trace ({card}): one replay, StepTimer(sync=) "
              f"{out['step_timer_ms']:.2f} ms, CUDA events "
              f"{out['cuda_event_ms']:.2f} ms", flush=True)
    finally:
        shutil.rmtree(TRACE_ROOT, ignore_errors=True)
        del m
        drop_graphs(torch)
    return launched, out


def utils_path(torch, fa, mp, card):
    """Phase 9q: `loader_runs` (the prefetch loader feeding K2a's step,
    the one-slice mesh), then `trace_path` (the profiler over the flash
    kernels). Returns each part's launches and the numbers."""
    t0 = time.perf_counter()
    k2a, loader_out = loader_runs(torch, fa, mp, card)
    flash, trace_out = trace_path(torch, fa, mp, card)
    out = dict(loader=loader_out, trace=trace_out,
               wall_s=time.perf_counter() - t0)
    print(f"utils: phase 9q {out['wall_s']:.1f} s ({card})", flush=True)
    return dict(prefetch=k2a, trace=flash), out


# -- 9r. item 21's shardlint over the captured ZeRO-3 gpt_medium step --------

#: every per-step launch count of a gpt_medium training step
FUSED_12 = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
            "max_pool_bwd": 0}


def lint_path(torch, fa, mp, card):
    """Phase 9r (module docstring): shardlint over the captured ZeRO-3
    gpt_medium step at full width. Returns the linted step's launches
    ({"uncaptured": ..., "capture": ...}) and the numbers."""
    from singa_tpu_torch import analysis, distributed, opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.parallel import mesh as mesh_module

    t0 = time.perf_counter()
    distributed.init(device="cuda")
    try:
        check(torch.distributed.get_backend() == "nccl",
              "phase 9r: the world-1 group is not NCCL")
        mesh = mesh_module.get_mesh((1,), ("data",))
        rng = np.random.default_rng(SEED)
        seq = torch.from_numpy(rng.integers(
            0, GPT_MEDIUM_VOCAB, (Z3_BATCH, Z3_SEQ + 1))).cuda()
        x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
        states = None

        def build():
            nonlocal states
            m = gpt_medium(device="cuda", zero3_axis="data")
            if states is None:
                load_singa_tpu_params(m, seeded_params(m, SEED))
            m.set_optimizer(opt.DistOpt(opt.SGD(lr=Z3_LR, momentum=0.9),
                                        mesh=mesh, axis_name="data"))
            m.compile([x], is_train=True, use_graph=True)
            if states is None:
                states = {k: v.detach().clone()
                          for k, v in m.get_states().items()}
            else:
                m.set_states(states)
            return m

        def two_steps(m):
            losses = []
            for _ in range(2):
                losses.append(m(x, y)[1].item())
            gs = m._train_step
            check((gs.captures, gs.replays) == (1, 1),
                  f"phase 9r: {gs.captures} captures and {gs.replays} "
                  f"replays in two steps, not 1 and 1")
            return losses

        # 1. the lint: one uncaptured step recorded, a capture, a replay
        m = build()
        reset_counts(fa, mp)
        t = time.perf_counter()
        tr = analysis.trace_step(m, x, y, target="zero3_gpt_medium")
        rep = analysis.run_rules(tr, target="zero3_gpt_medium")
        lint_s = time.perf_counter() - t
        total = counts(fa, mp)
        print(rep.summary(), flush=True)
        launches = {"uncaptured": tr.launches["recorded"],
                    "capture": tr.launches["again"]}
        blocks = {}
        label = tr.scopes.get(id(m.decoder))
        for r in tr.local_records():
            if r.phase == "forward" and r.block and r.block[0] == label:
                key = f"{r.op}@{r.axis}"
                blocks.setdefault(r.block[1], {}).setdefault(key, 0)
                blocks[r.block[1]][key] += 1
        print(f"lint ({card}): {lint_s:.1f} s; found schedule "
              f"{rep.schedule}; per block {blocks}; across "
              f"{tr.state['across']}: {len(tr.state['snapshots'][0])} "
              f"state tensors; launches {launches}; census "
              f"{rep.collectives}", flush=True)
        check(rep.ok, f"phase 9r: the ZeRO-3 gpt_medium step does not "
                      f"lint clean:\n{rep.summary()}")
        want = {"all_gather@data": len(m.decoder.STACKED)}
        check(rep.schedule == {"expected": want, "found": want}
              and sorted(blocks) == list(range(12))
              and all(b == want for b in blocks.values()),
              f"phase 9r: R2's schedule {rep.schedule}, blocks {blocks}")
        check(tr.state["across"] == "the capture and a replay of the step"
              and tr.state["snapshots"][0] == tr.state["snapshots"][1],
              "phase 9r: R5 did not read the capture and a replay")
        check(launches == {"uncaptured": FUSED_12, "capture": FUSED_12}
              and total == {k: 2 * v for k, v in FUSED_12.items()},
              f"phase 9r: the linted step launched {launches} (total "
              f"{total}), not 12 of each fused kernel uncaptured and 12 "
              f"in the capture")

        # 2. training goes on bitwise where it was
        linted = two_steps(m)
        del m, tr
        drop_graphs(torch)
        twin = build()
        unlinted = two_steps(twin)
        print(f"lint ({card}): two steps after the lint {linted}, an "
              f"unlinted twin's {unlinted}", flush=True)
        check(linted == unlinted, "phase 9r: the losses after the lint "
                                  "differ from the unlinted twin's")

        # 3. the planted re-bind fails R5 against a real CUDA Graph
        step = twin._user_train_one_batch

        def rebinding(*a, **kw):
            out = step(*a, **kw)
            twin.decoder.w_o.data = twin.decoder.w_o.data.clone()
            return out

        twin._user_train_one_batch = rebinding
        bad = analysis.lint_step(twin, x, y, target="planted_rebind")
        print(bad.summary(), flush=True)
        check([v.rule for v in bad.violations] == ["R5"]
              and bad.violations[0].subject == "param:decoder.w_o",
              f"phase 9r: the planted re-bind was not flagged by R5 "
              f"alone:\n{bad.summary()}")
        del twin, step, rebinding
    finally:
        distributed.shutdown()
    drop_graphs(torch)
    out = dict(ok=rep.ok, schedule=rep.schedule, blocks=len(blocks),
               collectives=rep.collectives, launches=launches,
               lint_s=lint_s, losses_after_lint=linted,
               twin_losses=unlinted, planted=bad.summary(), card=card,
               wall_s=time.perf_counter() - t0)
    print(f"lint: phase 9r {out['wall_s']:.1f} s ({card})", flush=True)
    return launches, out


# -- 9s. item 22: the native training step -------------------------------------

#: the native step's run: steps, plain SGD's rate, and the tolerance of its
#: losses and final parameters against the eager loop (the reference's,
#: tests/test_hlo_native.py:300)
NATIVE_STEPS, NATIVE_LR = 200, 0.05
NATIVE_RTOL, NATIVE_ATOL = 2e-4, 2e-5
#: the phase's budget
NATIVE_BUDGET_S = 30.0


def native_path(torch, fa, mp, card, mlp):
    """Phase 9s: the judged eager MLP of phase 9c (`MLP(100, 10)`, seeded
    weights, dropout inactive) on the synthetic MNIST set, batch 64 (an
    epoch a seed, from 0),
    lowered by `hlo_bridge.lower_train_step` to one StableHLO module of
    its plain-SGD step (lr 0.05) that `native/hlo_core.cc` emits, run by
    `run_steps`' runtime on the card for 200 steps (the first op by op,
    the second captured as one CUDA Graph, the rest replays) and held to
    the port's eager plain-SGD loop on the same weights and batches. The
    module's lines and products, its census against the declared one
    (R7 clean), the first step's ms, the replays' steps/s and device ms
    beside `mlp`'s (phase 9c's) eager and captured figures, and the
    step's bound. Then over a world-1 NCCL group: `run_replicated` on the
    one-replica module (the bitwise replica check), and a module of 2
    replicas refused, naming 2 and 1. Reaches no kernel of the port."""
    import itertools

    from singa_tpu_torch import autograd, distributed, opt, tensor
    from singa_tpu_torch.analysis import HLO_RULES, hlo, run_rules
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models import MLP
    from singa_tpu_torch.native import hlo_bridge
    from singa_tpu_torch.utils import data

    t0 = time.perf_counter()
    xt, yt, _, _ = data.load_mnist()
    tx, ty = tensor.from_numpy(xt, "cuda"), tensor.from_numpy(yt, "cuda")
    epochs = itertools.chain.from_iterable(
        data.device_batches(tx, ty, MLP_BATCH, seed=e)
        for e in itertools.count())
    batches = [(bx, torch.nn.functional.one_hot(by.long(), 10).float())
               for bx, by in itertools.islice(epochs, NATIVE_STEPS)]
    check(len(batches) == NATIVE_STEPS, f"phase 9s: {len(batches)} batches")
    weights = seeded_params(MLP(MLP_HIDDEN, 10, device="cuda"), SEED)

    def mlp_at_weights():
        m = MLP(MLP_HIDDEN, 10, device="cuda")
        load_singa_tpu_params(m, weights)
        m.dropout.training = False
        return m

    # 1. lower the step, its text linted by R7
    m = mlp_at_weights()
    x0, oh0 = batches[0]
    t = time.perf_counter()
    with autograd.TapeRecorder():
        loss = autograd.softmax_cross_entropy(m.forward(x0), oh0)
    step = hlo_bridge.lower_train_step(loss, list(m.get_params().values()),
                                       NATIVE_LR, inputs=[x0])
    lower_ms = (time.perf_counter() - t) * 1e3
    del m, loss
    lines = len(step.text.splitlines())
    dots = step.text.count("stablehlo.dot_general")
    census = hlo.hlo_census(step.text)
    rep = run_rules(hlo.trace_native_module(step, "native_mlp"),
                    rules=HLO_RULES)
    print(f"native ({card}): lowered in {lower_ms:.1f} ms, {lines} lines, "
          f"{dots} dot_general, census {census}, declared "
          f"{step.declared_hlo_census()}, R7 {'clean' if rep.ok else 'FAIL'}"
          f"; args {[tuple(a.shape) for a in step.args]}", flush=True)
    check(dots == 6 and census == {}
          and step.declared_hlo_census() == {"all_reduce": 0} and rep.ok,
          f"phase 9s: the module has {dots} dot_general, census {census}, "
          f"declared {step.declared_hlo_census()}:\n{rep.summary()}")

    # 2. the native run: the first step op by op, the capture, replays
    run = step.runner("cuda")
    timings = []
    for i, (bx, oh) in enumerate(batches):
        if i < 3:
            torch.cuda.synchronize()
            timings.append(time.perf_counter())
        run.step([bx], oh)
    torch.cuda.synchronize()
    timings.append(time.perf_counter())
    first_ms = (timings[1] - timings[0]) * 1e3
    capture_ms = (timings[2] - timings[1]) * 1e3
    replay_steps_s = (NATIVE_STEPS - 2) / (timings[3] - timings[2])
    native_losses = run.losses()
    exe = run.exe
    check((exe.runs, exe.captures, exe.replays)
          == (NATIVE_STEPS, 1, NATIVE_STEPS - 1),
          f"phase 9s: runs {exe.runs}, captures {exe.captures}, replays "
          f"{exe.replays}")
    replay_ms = cuda_ms(torch, lambda: exe._on_stream(exe._graph.replay),
                        iters=200, warmup=10)

    # 3. the port's eager plain-SGD loop on the same weights and batches
    m = mlp_at_weights()
    m.set_optimizer(opt.SGD(lr=NATIVE_LR))
    m.compile([x0], is_train=True, use_graph=False)
    m.dropout.training = False  # compile(is_train=True) turns it on
    eager = torch.stack([m(bx, oh)[1].detach() for bx, oh in batches])
    eager_losses = eager.tolist()
    got, want = np.asarray(native_losses), np.asarray(eager_losses)
    loss_err = float(np.max(np.abs(got - want)))
    params_ok, param_err = True, 0.0
    for (name, p), q in zip(m.get_params().items(), run.params()):
        a, b = p.detach(), q.detach()
        param_err = max(param_err, float((a - b).abs().max()))
        params_ok &= bool(torch.allclose(b, a, rtol=NATIVE_RTOL,
                                         atol=NATIVE_ATOL))
    print(f"native ({card}): {NATIVE_STEPS} steps, losses "
          f"{got[0]:.6f} -> {got[-1]:.6f} (eager {want[0]:.6f} -> "
          f"{want[-1]:.6f}), max|d| losses {loss_err:.3e}, final params "
          f"{param_err:.3e} (rtol {NATIVE_RTOL}, atol {NATIVE_ATOL})",
          flush=True)
    check(bool(np.allclose(got, want, rtol=NATIVE_RTOL, atol=NATIVE_ATOL))
          and params_ok and bool(np.isfinite(got).all())
          and got[-1] < got[0],
          f"phase 9s: the native losses or final parameters differ from "
          f"the eager loop's (losses max|d| {loss_err}, params max|d| "
          f"{param_err}), or the loss did not fall")
    del m

    # the step's bound: its products (2 forward, 4 backward) and its
    # bytes (the batch, the one-hot and the parameters read, the loss and
    # the parameters written)
    n_par = sum(int(np.prod(a.shape)) for i, a in enumerate(step.args)
                if i in step.param_idx)
    flops = 6.0 * MLP_BATCH * sum(int(np.prod(step.args[i].shape))
                                  for i in step.param_idx
                                  if step.args[i].ndim == 2)
    nbytes = 4.0 * (MLP_BATCH * (784 + 10) + 2 * n_par + 1)
    bound_ms = max(flops / PEAK_FLOPS["fp32"], nbytes / PEAK_BYTES_S) * 1e3
    print(f"native ({card}): first step {first_ms:.2f} ms (op by op), the "
          f"capture step {capture_ms:.2f} ms, replays {replay_steps_s:.1f} "
          f"steps/s, {replay_ms:.4f} device ms a replay, bound "
          f"{bound_ms:.5f} ms ({flops:.3e} FLOP, {nbytes:.3e} B); phase "
          f"9c's eager {mlp['eager_steps_s']:.1f} steps/s, captured "
          f"{mlp['captured_steps_s']:.1f} steps/s, its captured step "
          f"{mlp['captured_step_device_ms']:.4f} device ms", flush=True)

    # 4. over a world-1 NCCL group: the replica check, and 2 replicas
    # refused
    distributed.init(device="cuda")
    try:
        check(torch.distributed.get_backend() == "nccl",
              "phase 9s: the world-1 group is not NCCL")
        rows = hlo_bridge.run_replicated(step, [([bx], oh) for bx, oh in
                                                batches[:4]], device="cuda")
        check(bool(np.allclose([r[0] for r in rows], native_losses[:4],
                               rtol=NATIVE_RTOL, atol=NATIVE_ATOL)),
              f"phase 9s: run_replicated's losses {rows} are not the "
              f"native run's first four {native_losses[:4]}")
        m = mlp_at_weights()
        with autograd.TapeRecorder():
            loss = autograd.softmax_cross_entropy(m.forward(x0), oh0)
        two = hlo_bridge.lower_train_step(
            loss, list(m.get_params().values()), NATIVE_LR, inputs=[x0],
            n_replicas=2)
        refused = None
        try:
            hlo_bridge.compile_stablehlo(two.text, "cuda")
        except ValueError as e:
            refused = str(e)
        print(f"native ({card}): run_replicated over the world-1 NCCL group "
              f"{[r[0] for r in rows]} (bitwise the run's: "
              f"{[r[0] for r in rows] == native_losses[:4]}); 2 replicas: "
              f"{refused}", flush=True)
        check(refused is not None and "num_replicas = 2" in refused
              and "has 1 rank" in refused,
              f"phase 9s: the 2-replica module was not refused: {refused}")
    finally:
        distributed.shutdown()
    wall = time.perf_counter() - t0
    out = dict(card=card, lines=lines, dot_general=dots, census=census,
               declared=step.declared_hlo_census(), r7_ok=rep.ok,
               steps=NATIVE_STEPS, lr=NATIVE_LR,
               losses_first_last=[float(got[0]), float(got[-1])],
               eager_first_last=[float(want[0]), float(want[-1])],
               loss_max_abs_err=loss_err, param_max_abs_err=param_err,
               rtol=NATIVE_RTOL, atol=NATIVE_ATOL, runs=exe.runs,
               captures=exe.captures, replays=exe.replays,
               lower_ms=lower_ms, first_step_ms=first_ms,
               capture_step_ms=capture_ms, replay_steps_s=replay_steps_s,
               replay_device_ms=replay_ms, bound_ms=bound_ms, flops=flops,
               bytes=nbytes, mlp_eager_steps_s=mlp["eager_steps_s"],
               mlp_captured_steps_s=mlp["captured_steps_s"],
               mlp_captured_device_ms=mlp["captured_step_device_ms"],
               replicated_losses=[r[0] for r in rows],
               two_replicas_refused=refused, wall_s=wall)
    print(f"native: phase 9s {wall:.1f} s ({card})", flush=True)
    check(wall <= NATIVE_BUDGET_S,
          f"phase 9s took {wall:.1f} s, over its {NATIVE_BUDGET_S:.0f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.ops import _build
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.ops import max_pool as mp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build, one nvcc per source, all started together
    t = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t:.1f} s",
          flush=True)
    for name in sorted(libs):
        for line in ptxas_summary(_build.build_log(name)):
            print(f"ptxas {line}", flush=True)
    # the SASS of the tensor-core kernels: their products and copies
    from pathlib import Path

    cuobjdump = str(Path(_build._find_nvcc()).parent / "cuobjdump")
    sass = {}
    for name in ("flash_fwd", "flash_bwd", "max_pool_bwd"):
        for fn, ops in sass_census(libs[name], cuobjdump).items():
            sass[fn] = ops
            print(f"sass {fn}: " + ", ".join(f"{k} {v}" for k, v in
                                             ops.items()), flush=True)

    def wide_loads(ops):
        return ops["LDGSTS"] + ops["UTMALDG"] + ops["LDG.E.128"] > 0

    for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                   "flash_bwd_dkv_kernel"):
        insts = {fn: ops for fn, ops in sass.items()
                 if fn.startswith(kernel + "<")}
        check(insts and all(ops["HMMA"] + ops["HGMMA"] > 0
                            and wide_loads(ops) for ops in insts.values()),
              f"{kernel}: an instantiation without tensor-core products or "
              f"asynchronous / 16-byte loads in its SASS: {insts}")
    # the max-pool backward's 16-byte channel-vector instantiations
    insts = {fn: ops for fn, ops in sass.items() if fn.startswith((
        "max_pool_bwd_kernel<float, 4,", "max_pool_bwd_kernel<bf16, 8,"))}
    check(len(insts) == 4 and all(wide_loads(o) for o in insts.values()),
          f"max_pool_bwd_kernel: a vector instantiation without 16-byte or "
          f"asynchronous loads in its SASS: {insts}")

    # 3-5. the kernels against their plain versions
    rows = [run_case(torch, fa, c) for c in CASES]
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"forward kernel disagrees with its plain version: {bad}")
    bwd_rows = [run_bwd_case(torch, fa, c) for c in BWD_CASES]
    bad = [r["case"] for r in bwd_rows if not r["ok"]]
    check(not bad, f"backward kernels disagree with their plain version, "
                   f"repeat or leave an empty row non-zero: {bad}")
    pool_rows = [run_pool_case(torch, mp, c) for c in POOL_CASES]
    bad = [r["case"] for r in pool_rows if not r["ok"]]
    check(not bad, f"max-pool kernel or default route disagrees with the "
                   f"plain version, or does not repeat: {bad}")
    routes = {r["case"]: r["vector_width"] for r in pool_rows}
    check(routes["resnet50_stem_fp32"] == 4
          and routes["resnet50_stem_fp32_b32"] == 4
          and routes["resnet50_stem_bf16"] == 8
          and routes["channels_first_scalar_route"] == 1
          and routes["channels_first_scalar_route_bf16"] == 1
          and all(routes[f"xception_pool{i}_{dt}"] == w
                  for i in range(len(XCEPTION_POOLS))
                  for dt, w in (("fp32", 4), ("bf16", 8))),
          f"the stem cases did not take the 16-byte vector route, or the "
          f"channels-first case not the scalar one: {routes}")

    # 6. the scoring and generate paths, counted
    model = gpt_medium(device="cuda")
    load_singa_tpu_params(model, seeded_params(model, SEED))
    model.eval()
    rng = np.random.default_rng(SEED)
    vocab = model.vocab_size
    ids = torch.from_numpy(rng.integers(0, vocab, (4, 1024))).cuda()
    prompts = rng.integers(0, vocab, (4, 224))
    torch.cuda.synchronize()

    reset_counts(fa, mp)
    with torch.inference_mode():
        t = time.perf_counter()
        logits = model(ids)
        torch.cuda.synchronize()
        fwd_first_s = time.perf_counter() - t
    fwd_launches = fa.FLASH_FWD_LAUNCHES
    t = time.perf_counter()
    toks = model.generate(prompts, n_new=48, window=256)
    gen_first_s = time.perf_counter() - t
    serve_launches = counts(fa, mp)
    print(f"serve path: forward {fwd_first_s:.3f} s ({fwd_launches} kernel "
          f"launches), generate {gen_first_s:.3f} s; launches "
          f"{serve_launches}", flush=True)
    check(fwd_launches == 12,
          f"model(ids) launched the kernel {fwd_launches} times, not 12")
    check(serve_launches["flash_bwd_dq"] == 0, "scoring ran a backward")

    # results of the serving path
    check(tuple(logits.shape) == (4, 1024, vocab), f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    with torch.inference_mode():
        fa.set_flash_enabled(False)
        try:
            logits_plain = model(ids)
        finally:
            fa.set_flash_enabled(True)
    err = (logits - logits_plain).abs().max().item()
    tol = 2e-3  # fp32 through 12 post-LN blocks; summation order differs
    print(f"forward logits vs kernel off: max|d| {err:.3e} (tol {tol})",
          flush=True)
    check(err <= tol, "forward logits disagree with the plain attention")
    del logits_plain

    with torch.inference_mode():
        fwd_ms = cuda_ms(torch, lambda: model(ids), iters=5, warmup=1)
    print(f"forward: {fwd_ms:.3f} ms per 4x1024 batch, "
          f"{4 * 1024 / fwd_ms * 1e3:.1f} tokens/s", flush=True)

    check(toks.shape == (4, 272), f"generate shape {toks.shape}")
    check(np.array_equal(toks[:, :224], prompts), "prompt not preserved")
    check(bool(((toks >= 0) & (toks < vocab)).all()), "token out of range")
    t = time.perf_counter()
    toks2 = model.generate(prompts, n_new=48, window=256)
    gen_s = time.perf_counter() - t
    check(np.array_equal(toks, toks2), "greedy generate is not deterministic")
    print(f"generate: {gen_s:.3f} s for 4 x 48 new tokens, "
          f"{4 * 48 / gen_s:.1f} tokens/s (32 grow + 16 slide steps)",
          flush=True)

    prefill = model._decode_fns(256)[0]
    ctx = torch.zeros((4, 256), dtype=torch.long, device="cuda")
    ctx[:, :224] = torch.from_numpy(prompts).cuda()
    with torch.inference_mode():
        logits_prefill, _, _ = prefill(model._functional_params(), ctx)
        logits_kernel = model(ctx)
    err_p = (logits_prefill[:, :224] - logits_kernel[:, :224]).abs().max()
    err_p = err_p.item()
    print(f"prefill (plain) vs model(ctx) (kernel): max|d| {err_p:.3e} "
          f"(tol {tol})", flush=True)
    check(err_p <= tol, "prefill logits disagree with the kernel path")
    del logits, logits_kernel, logits_prefill

    # 7. the serving path, counted: the engine reaches no kernel (its
    # prefill is the plain one, its decode step a captured CUDA Graph)
    reset_counts(fa, mp)
    serve = serve_path(torch, model)
    serve_launches = counts(fa, mp)
    print(f"serve path launches {serve_launches}", flush=True)
    torch.cuda.empty_cache()

    # 7b. the serving stack around the engine, each phase counted alone:
    # none reaches a kernel (the reference's reaches no Pallas)
    stack = {}
    for name, phase in (("spec", serve_spec), ("frontend", serve_frontend),
                        ("router", serve_router)):
        reset_counts(fa, mp)
        t = time.perf_counter()
        stack[name] = phase(torch, model, card)
        print(f"serve {name}: {time.perf_counter() - t:.1f} s ({card}); "
              f"launches {counts(fa, mp)}", flush=True)
    torch.cuda.empty_cache()

    # 8. the GPT training path, counted around one step
    train_launches, train = train_path(torch, fa, mp, model, rng)

    # 8b. the reference's default decoder, unrolled, against the scanned
    unrolled_launches, unrolled = gpt_unrolled_path(torch, fa, mp, model,
                                                    ids, prompts)
    del model
    torch.cuda.empty_cache()

    # 8c. BERT-base training: the fused kernels non-causally at hd 64
    bert_launches, bert = bert_path(torch, fa, mp)

    # 9. the CNN training path: ResNet-50, counted around one step
    resnet_launches, resnet = resnet_path(torch, fa, mp)

    # 9b. Char-RNN at bench.py's shape, captured: it reaches no kernel
    reset_counts(fa, mp)
    t = time.perf_counter()
    char_rnn = char_rnn_path(torch, fa, mp, card)
    char_rnn_launches = counts(fa, mp)
    print(f"char_rnn: {time.perf_counter() - t:.1f} s ({card}); launches "
          f"{char_rnn_launches}", flush=True)
    check(char_rnn_launches == NO_LAUNCH,
          f"the Char-RNN phase launched {char_rnn_launches}")

    # 9c. the judged eager MLP: it reaches no kernel
    reset_counts(fa, mp)
    t = time.perf_counter()
    mlp = mlp_path(torch, fa, mp, card)
    mlp_launches = counts(fa, mp)
    print(f"mlp: {time.perf_counter() - t:.1f} s ({card}); launches "
          f"{mlp_launches}", flush=True)
    check(mlp_launches == NO_LAUNCH, f"the MLP phase launched {mlp_launches}")

    # 9d. sonnx: ResNet-50 and BERT-base exported, imported, fine-tuned;
    # the BERT export trace runs the fused forward kernel
    reset_counts(fa, mp)
    t = time.perf_counter()
    sonnx_export_launches, sonnx_out = sonnx_path(torch, fa, mp, card)
    print(f"sonnx: {time.perf_counter() - t:.1f} s ({card}); launches "
          f"{counts(fa, mp)} (the BERT-base export's alone: "
          f"{sonnx_export_launches})", flush=True)

    # 9e. DistOpt ResNet-50 over a world-1 NCCL group: K2a once a step
    reset_counts(fa, mp)
    t = time.perf_counter()
    dist_launches, dist_out = dist_path(torch, fa, mp, card)
    print(f"dist: {time.perf_counter() - t:.1f} s ({card}); the counted "
          f"step's launches {dist_launches}", flush=True)

    # 9f. ZeRO-1 gpt_medium over a world-1 NCCL group: 12 launches of
    # each flash kernel a step
    reset_counts(fa, mp)
    t = time.perf_counter()
    zero1_launches, zero1_out = zero1_path(torch, fa, mp, card)
    print(f"zero1: {time.perf_counter() - t:.1f} s ({card}); the counted "
          f"step's launches {zero1_launches}", flush=True)

    # 9g. F7, the new layers, MobileNetV1 and Xception at full width (K2a
    # 4 times an Xception step), their trainers, MobileNetV1's ONNX
    reset_counts(fa, mp)
    t = time.perf_counter()
    xception_launches, mobile_out = mobile_path(torch, fa, mp, card)
    print(f"mobile: {time.perf_counter() - t:.1f} s ({card}); Xception's "
          f"counted step's launches {xception_launches}", flush=True)

    # 9h. the captured eval step (gpt_medium's uncaptured eval call
    # launches the flash forward 12 times, its capture records 12), the
    # memory plans, Operator / Function and the functional ops
    reset_counts(fa, mp)
    t = time.perf_counter()
    eval_launches, eval_out = eval_path(torch, fa, mp, card)
    print(f"eval: {time.perf_counter() - t:.1f} s ({card}); gpt_medium's "
          f"uncaptured eval call's launches {eval_launches}", flush=True)

    # 9i. the Device classes, then sequence parallelism over a world-1
    # NCCL group: the head-split flash kernels on a main path
    reset_counts(fa, mp)
    devices_out = devices_path(torch, card)
    check(counts(fa, mp) == NO_LAUNCH, "the devices phase launched a kernel")
    reset_counts(fa, mp)
    t = time.perf_counter()
    sp_launches, sp_out = sp_path(torch, fa, mp, card)
    print(f"sp: {time.perf_counter() - t:.1f} s ({card}); each phase's "
          f"counted step's launches {sp_launches}", flush=True)

    # 9j. tensor parallelism over a world-1 NCCL group: the head-split
    # flash kernels under the tp stacks, then serve_gpt --tp 1
    reset_counts(fa, mp)
    t = time.perf_counter()
    tp_launches, tp_out = tp_path(torch, fa, mp, card)
    print(f"tp: {time.perf_counter() - t:.1f} s ({card}); each phase's "
          f"counted step's launches by layout {tp_launches}", flush=True)

    # 9k. ZeRO-3 (serial, overlapped, beside tp), bench.py's 3-D recipe
    # and the MoE GPT over a world-1 NCCL group
    reset_counts(fa, mp)
    t = time.perf_counter()
    z3_launches, z3_out = zero3_path(torch, fa, mp, card)
    print(f"zero3: {time.perf_counter() - t:.1f} s ({card}); each phase's "
          f"counted step's launches by layout {z3_launches}", flush=True)

    # 9l. GPipe over a world-1 NCCL group: the pipelined gpt_medium
    # launches each head-split kernel 48 times a step; then the
    # strategies runner at world 1
    reset_counts(fa, mp)
    t = time.perf_counter()
    pp_launches, pp_out = pp_path(torch, fa, mp, card)
    print(f"pp: {time.perf_counter() - t:.1f} s ({card}); the counted "
          f"steps' launches by layout {pp_launches}", flush=True)

    # 9m. the disaggregated prefill, the sharded speculative round and
    # serve_gpt's --tp --draft and --metrics-port over a world-1 NCCL
    # group: none reaches a kernel
    t = time.perf_counter()
    disagg_out = disagg_path(torch, fa, mp, card)
    print(f"disagg: {time.perf_counter() - t:.1f} s ({card}); each part "
          f"launched no kernel", flush=True)

    # 9n. the checkpointed gpt_lm resumed bitwise (plain and ZeRO-1), the
    # async save against the sync one under replays, a restore that keeps
    # the capture, elastic at world 1, the bf16 sentinel, a flipped byte
    reset_counts(fa, mp)
    t = time.perf_counter()
    ckpt_launches, ckpt_out = ckpt_path(torch, fa, mp, card)
    ckpt_out["wall_s"] = time.perf_counter() - t
    print(f"ckpt: {ckpt_out['wall_s']:.1f} s ({card}); the resumed "
          f"trainer's launches a step {ckpt_launches}", flush=True)

    # 9o. the self-healing layer: the supervised gpt_medium unbroken, after
    # a crash and after a hang (bitwise U, 12 launches of each fused
    # kernel a step), AlexNet's spike rollback (K2a 3 times a step), and
    # the babysitter's heal of a SIGSTOPped gpt_medium child
    reset_counts(fa, mp)
    fleet_run = []
    try:
        heal_launches, heal_out = heal_path(
            torch, fa, mp, card,
            beside=lambda: fleet_run.append(start_fleet()))
    except BaseException:
        for run in fleet_run:
            stop_fleet(run)
        raise

    # 9p. the babysitter fleet: `babysit --fleet` heals a SIGSTOPped
    # gpt_medium child of a world-1 NCCL group by an epoch bump, the final
    # checkpoint sha256-identical to an unbroken twin's. It starts beside
    # phase 9o's babysitter (its children count their own launches)
    fleet_launches, fleet_out = fleet_path(torch, fa, mp, card,
                                           fleet_run[0] if fleet_run
                                           else None)

    # 9q. item 20's utils and item 13's mesh: dist_imagenet fed by the
    # native prefetcher (K2a once uncaptured and once in the capture, the
    # views' losses bitwise the copies'), gpt_medium's step under
    # profiler.xla_trace (12 trace events of each fused flash kernel),
    # the one-slice mesh
    reset_counts(fa, mp)
    utils_launches, utils_out = utils_path(torch, fa, mp, card)

    # 9r. item 21's shardlint: the captured ZeRO-3 gpt_medium step lints
    # clean (12 launches of each fused kernel uncaptured, 12 in the
    # capture), training goes on bitwise, a planted re-bind fails R5
    reset_counts(fa, mp)
    lint_launches, lint_out = lint_path(torch, fa, mp, card)

    # 9s. item 22: the judged MLP's SGD step as one C++-emitted StableHLO
    # module, run by the runtime on the card (captured), held to the eager
    # loop; it reaches no kernel
    reset_counts(fa, mp)
    native_out = native_path(torch, fa, mp, card, mlp)
    check(counts(fa, mp) == NO_LAUNCH,
          f"the native phase launched {counts(fa, mp)}")

    # 10. report: the fused fp32 shape, with the bf16 figures beside
    fwd, bwd, pool, pool16 = rows[0], bwd_rows[0], *pool_rows[8:10]
    fwd16, bwd16 = rows[2], bwd_rows[2]
    (pool32,) = [r for r in pool_rows if r["case"] == "resnet50_stem_fp32_b32"]
    common = dict(route="cuda", shape=fwd["shape"], card=card)
    fwd_by = {r["case"]: r for r in rows}
    bwd_by = {r["case"]: r for r in bwd_rows}

    def at_bert(name, key, grads):
        """A flash kernel's figures at BERT-base's shape, fp32 and bf16,
        beside its launches per BERT step."""
        out = dict(shape=fwd_by["bert_base_fused_fp32"]["shape"],
                   causal=False, launches_per_step=bert_launches[name])
        for dt in ("fp32", "bf16"):
            if key is None:
                r = fwd_by[f"bert_base_fused_{dt}"]
                fig = dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                           bound_ms=r["bound_ms"], bound_by=r["bound_by"])
            else:
                r = bwd_by[f"bert_base_fused_{dt}"]
                fig = dict(max_abs_err=max(r["max_abs_err"][g]
                                           for g in grads),
                           ms=r[f"ms_{key}"], bound_ms=r["bound_ms"][key],
                           bound_by=r["bound_by"][key])
            out[dt] = dict(fig, plain_ms=r["plain_ms"],
                           library_ms=r["library_ms"])
        return out

    sp_cases = ("sp_gpt_medium_causal_t8192", "sp_bert_base_bidir_t512")
    tp_cases = ("tp_gpt_medium_interleaved_t1024",
                "tp_gpt_medium_projections_t1024")
    pp_cases = ("pp_gpt_medium_microbatch_t1024",)

    def at_cases(key, grads, cases):
        """A flash kernel's figures at a parallel path's head-split shapes
        and strides (fp32)."""
        out = {}
        for case in cases:
            if key is None:
                r = fwd_by[case]
                fig = dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                           bound_ms=r["bound_ms"], bound_by=r["bound_by"])
            else:
                r = bwd_by[case]
                fig = dict(max_abs_err=max(r["max_abs_err"][g]
                                           for g in grads),
                           ms=r[f"ms_{key}"], bound_ms=r["bound_ms"][key],
                           bound_by=r["bound_by"][key])
            out[case] = dict(fig, shape=r["shape"], causal=r["causal"],
                             plain_ms=r["plain_ms"],
                             library_ms=r["library_ms"])
        return out

    def sp_counts(name):
        return {"sp_ring_flash_step": sp_launches["ring_flash"][name],
                "sp_ulysses_flash_step": sp_launches["ulysses_flash"][name],
                "sp_bert_step": sp_launches["bert"][name],
                "sp_scan_step": sp_launches["scan"][name],
                **{f"tp_{k}_step_{layout}": tp_launches[k][layout][name]
                   for k in ("scan", "unrolled", "bert")
                   for layout in ("head_split", "fused")},
                **{f"{k}_step_{layout}": z3_launches[k][layout][name]
                   for k in ("zero3", "zero3_overlap", "tp_zero3",
                             "recipe_3d", "moe")
                   for layout in ("head_split", "fused")},
                **{f"{k}_gpt_medium_step_{layout}":
                   pp_launches[k][layout][name]
                   for k in ("pp", "pp_twin")
                   for layout in ("head_split", "fused")}}

    def sass_of(kernel):
        return {fn: ops for fn, ops in sass.items()
                if fn.startswith(kernel + "<")}

    kernels = [
        dict(name="flash_fwd", source="singa_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="singa_tpu/ops/flash_attention.py:829",
             also_replaces="singa_tpu/ops/flash_attention.py:263",
             launches=train_launches["flash_fwd"],
             launches_by_path={
                 "score": fwd_launches,
                 "train_step": train_launches["flash_fwd"],
                 "unrolled_train_step":
                     unrolled_launches["train_step"]["flash_fwd"],
                 "bert_step": bert_launches["flash_fwd"],
                 "sonnx_bert_export": sonnx_export_launches["flash_fwd"],
                 "zero1_gpt_medium_step": zero1_launches["flash_fwd"],
                 "eval_step": eval_launches["flash_fwd"],
                 "ckpt_gpt_lm_step_across_restore":
                     ckpt_launches["flash_fwd"],
                 "heal_supervised_gpt_medium_step":
                     heal_launches["gpt_medium"]["flash_fwd"],
                 "fleet_gpt_medium_6_block_step":
                     fleet_launches["flash_fwd"],
                 "traced_gpt_medium_step":
                     utils_launches["trace"]["flash_fwd"],
                 "lint_zero3_gpt_medium_step": {
                     k: v["flash_fwd"] for k, v in lint_launches.items()},
                 **sp_counts("flash_fwd")},
             bert_base=at_bert("flash_fwd", None, ()),
             head_split_sp=at_cases(None, (), sp_cases),
             head_split_tp=at_cases(None, (), tp_cases),
             head_split_pp=at_cases(None, (), pp_cases),
             max_abs_err=fwd["max_abs_err"], ms=fwd["ms"],
             plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
             bound_fma_ms=fwd["bound_fma_ms"],
             bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
             bf16=dict(max_abs_err=fwd16["max_abs_err"], ms=fwd16["ms"],
                       plain_ms=fwd16["plain_ms"],
                       bound_ms=fwd16["bound_ms"],
                       bound_by=fwd16["bound_by"],
                       library_ms=fwd16["library_ms"]),
             sass=sass_of("flash_fwd_kernel"), **common)]
    for name, key, sites in (
            ("flash_bwd_dq", "dq", (":872", ":426")),
            ("flash_bwd_dkv", "dkv", (":911", ":449"))):
        grads = ("dq",) if key == "dq" else ("dk", "dv")
        kernels.append(dict(
            name=name, source="singa_tpu_torch/ops/csrc/flash_bwd.cu",
            replaces=f"singa_tpu/ops/flash_attention.py{sites[0]}",
            also_replaces=f"singa_tpu/ops/flash_attention.py{sites[1]}",
            launches=train_launches[name],
            launches_by_path={
                "train_step": train_launches[name],
                "unrolled_train_step": unrolled_launches["train_step"][name],
                "bert_step": bert_launches[name],
                "zero1_gpt_medium_step": zero1_launches[name],
                "ckpt_gpt_lm_step_across_restore": ckpt_launches[name],
                "heal_supervised_gpt_medium_step":
                    heal_launches["gpt_medium"][name],
                "fleet_gpt_medium_6_block_step": fleet_launches[name],
                "traced_gpt_medium_step": utils_launches["trace"][name],
                "lint_zero3_gpt_medium_step": {
                    k: v[name] for k, v in lint_launches.items()},
                **sp_counts(name)},
            bert_base=at_bert(name, key, grads),
            head_split_sp=at_cases(key, grads, sp_cases),
            head_split_tp=at_cases(key, grads, tp_cases),
            head_split_pp=at_cases(key, grads, pp_cases),
            max_abs_err=max(bwd["max_abs_err"][g] for g in grads),
            ms=bwd[f"ms_{key}"], plain_ms=bwd["plain_ms"],
            bound_ms=bwd["bound_ms"][key], bound_by=bwd["bound_by"][key],
            bound_fma_ms=bwd["bound_fma_ms"][key],
            library_ms=bwd["library_ms"],
            plain_and_library_compute="dq, dk and dv together",
            bf16=dict(max_abs_err=max(bwd16["max_abs_err"][g]
                                      for g in grads),
                      ms=bwd16[f"ms_{key}"], plain_ms=bwd16["plain_ms"],
                      bound_ms=bwd16["bound_ms"][key],
                      bound_by=bwd16["bound_by"][key],
                      library_ms=bwd16["library_ms"]),
            sass=sass_of(f"{name}_kernel"), **common))
    kernels.append(dict(
        name="max_pool_bwd", route="cuda",
        source="singa_tpu_torch/ops/csrc/max_pool_bwd.cu",
        replaces="singa_tpu/ops/max_pool.py:287",
        launches=resnet_launches["max_pool_bwd"],
        launches_by_path={
            "resnet50_step": resnet_launches["max_pool_bwd"],
            "dist_resnet50_step": dist_launches["max_pool_bwd"],
            "xception_step": xception_launches["max_pool_bwd"],
            "heal_supervised_alexnet_step":
                heal_launches["alexnet"]["max_pool_bwd"],
            "prefetch_dist_resnet50_step":
                utils_launches["prefetch"]["max_pool_bwd"]},
        max_abs_err=pool["max_abs_err"], ms=pool["ms"],
        plain_ms=pool["plain_ms"], bound_ms=pool["bound_ms"],
        bound_by=pool["bound_by"], library_ms=pool["library_ms"],
        library="aten max_pool2d_with_indices_backward", shape=pool["shape"],
        dtype=pool["dtype"], vector_width=pool["vector_width"],
        bf16=dict(max_abs_err=pool16["max_abs_err"], ms=pool16["ms"],
                  plain_ms=pool16["plain_ms"], bound_ms=pool16["bound_ms"],
                  bound_by=pool16["bound_by"],
                  library_ms=pool16["library_ms"],
                  vector_width=pool16["vector_width"]),
        dist_resnet50_b32={k: pool32[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "vector_width")},
        xception_pools=[{k: r[k] for k in (
            "shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "vector_width")} for r in pool_rows
            if r["case"].startswith("xception_pool")],
        sass=sass_of("max_pool_bwd_kernel"), card=card))
    print("serve " + json.dumps(serve), flush=True)
    print("serve_stack " + json.dumps(stack), flush=True)
    print("train " + json.dumps(train), flush=True)
    print("gpt_unrolled " + json.dumps(dict(unrolled,
                                            launches=unrolled_launches)),
          flush=True)
    print("bert_train " + json.dumps(bert), flush=True)
    print("resnet50_train " + json.dumps(resnet), flush=True)
    print("char_rnn " + json.dumps(char_rnn), flush=True)
    print("mlp " + json.dumps(mlp), flush=True)
    print("sonnx " + json.dumps(sonnx_out), flush=True)
    print("dist_resnet50 " + json.dumps(dist_out), flush=True)
    print("zero1_gpt_medium " + json.dumps(zero1_out), flush=True)
    print("mobile " + json.dumps(mobile_out), flush=True)
    print("eval " + json.dumps(eval_out), flush=True)
    print("devices " + json.dumps(devices_out), flush=True)
    print("sp " + json.dumps(sp_out), flush=True)
    print("tp " + json.dumps(tp_out), flush=True)
    print("zero3 " + json.dumps(z3_out), flush=True)
    print("pp " + json.dumps(pp_out), flush=True)
    print("disagg " + json.dumps(disagg_out), flush=True)
    print("ckpt " + json.dumps(ckpt_out), flush=True)
    print("heal " + json.dumps(heal_out), flush=True)
    print("fleet " + json.dumps(fleet_out), flush=True)
    print("utils " + json.dumps(utils_out), flush=True)
    print("lint " + json.dumps(lint_out), flush=True)
    print("native " + json.dumps(native_out), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
